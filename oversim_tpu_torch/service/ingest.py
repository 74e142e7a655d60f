"""Request sources for the serving loop (PyTorch).

Counterpart of ``oversim_tpu/service/ingest.py``.  The protocol the loop
drives (service/loop.py):

    before_window(state, target_ns) -> state'
        at the window boundary, BEFORE dispatch: inject every pending
        request as ONE batched ``EXT_IN`` pool write
        (gateway.inject_ext_batch), delivered as the window starts.
    after_window(state) -> state'
        after the window's drain: collect the ``EXT_OUT`` answers
        (gateway.drain_ext_out, a host read of the pool, which is why
        ingest runs single-buffered).

The served Simulation MUST be built with ``EngineParams(ext_hold_slot=
<gw_slot>)``: a window runs many ticks between drains, and without the
hold the engine delivers each ``EXT_OUT`` into the gateway node's inbox
on the tick after it is sent, long before the boundary drain.  With the
hold, answers stay in the pool until ``after_window`` frees them.

``InProcessIngest`` is the in-program source (a ``submit`` queue);
``GatewayIngest`` serves a RealtimeGateway's UDP/TCP clients at window
granularity.  Both serve a SOLO Simulation state.
"""

from __future__ import annotations

from oversim_tpu_torch import gateway as gateway_mod


class InProcessIngest:
    """In-process request queue.

    ``submit`` assigns a session id and buffers the frame;
    ``responses[sid]`` holds the drained ``(b, c)`` answer after the
    window that served it.  ``tracer`` is duck-typed (``mint(sid,
    window=)`` / ``settle(sid, window=)`` / ``nack(sid, window=)``);
    ``windows`` counts completed drains.  ``max_pending`` is the
    admission bound: past that many waiting frames ``submit`` SHEDS the
    frame (its sid lands in ``nacked``, it never enters the pool), so a
    refusal is told apart from an answer not yet arrived.  None:
    unbounded."""

    def __init__(self, gw_slot: int = 0, tracer=None,
                 max_pending: int | None = None):
        self.gw = gw_slot
        self.tracer = tracer
        self.max_pending = max_pending
        self.windows = 0              # after_window drains completed
        self.responses: dict = {}     # sid -> (b, c)
        self.nacked: dict = {}        # sid -> (b, c) refused on submit
        self.rx_shed = 0
        self.num_batches = 0          # batched pool writes performed
        self.num_injected = 0         # frames injected across batches
        self._pending: list = []
        self._overflow: list = []     # device scalars (no hot-path wait)
        self._next_sid = 1

    def submit(self, b: int = 0, c: int = 0, *,
               kind: int = gateway_mod.EXT_IN,
               dst: int | None = None, key=None) -> int:
        sid = self._next_sid
        self._next_sid += 1
        if self.tracer is not None:
            self.tracer.mint(sid, window=self.windows)
        if (self.max_pending is not None
                and len(self._pending) >= self.max_pending):
            # an explicit NACK, never a silent drop
            self.rx_shed += 1
            self.nacked[sid] = (b, c)
            if self.tracer is not None and hasattr(self.tracer, "nack"):
                self.tracer.nack(sid, window=self.windows)
            return sid
        self._pending.append(gateway_mod.ExtFrame(
            a=sid, b=b, c=c, kind=kind, dst=dst, key=key))
        return sid

    def overflow(self) -> int:
        """Frames lost to pool overflow so far (reads the counts back)."""
        total = sum(int(h) for h in self._overflow)
        self._overflow = []
        return total

    def before_window(self, state, target_ns: int):
        if not self._pending:
            return state
        frames, self._pending = self._pending, []
        state, overflow = gateway_mod.inject_ext_batch(state, frames,
                                                       self.gw)
        self._overflow.append(overflow)
        self.num_batches += 1
        self.num_injected += len(frames)
        return state

    def after_window(self, state):
        def handler(sid, b, c):
            self.responses[sid] = (b, c)
            if self.tracer is not None:
                self.tracer.settle(sid, window=self.windows)
            return True

        state = gateway_mod.drain_ext_out(state, self.gw, handler)
        self.windows += 1
        return state


class GatewayIngest:
    """Serve a RealtimeGateway's sockets at window granularity: the
    gateway keeps its sockets, sessions and crypto; this adapter moves
    its poll -> batched inject -> drain cycle onto the loop's window
    boundaries (``gateway.state`` is kept in step with the loop's)."""

    def __init__(self, gateway):
        self.gateway = gateway
        self.windows = 0              # after_window drains completed

    def before_window(self, state, target_ns: int):
        gw = self.gateway
        gw.state = state
        # sids minted this boundary trace latency in window units
        gw._window = self.windows
        gw._poll_udp()
        gw._poll_tcp()
        gw.flush_rx()
        return gw.state

    def after_window(self, state):
        gw = self.gateway
        gw.state = state
        gw._window = self.windows
        gw._drain_ext_out()
        self.windows += 1
        return gw.state
