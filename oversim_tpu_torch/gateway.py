"""Real-network gateway: the SingleHostUnderlay equivalent (PyTorch).

Counterpart of ``oversim_tpu/gateway.py``.  The whole overlay stays
simulated and one *gateway node slot* is bridged to real sockets:

  * inbound datagrams and TCP frames are parsed into ``EXT_IN`` frames
    addressed to the gateway slot and written into the message pool as
    ONE batched allocation per flush (``inject_ext_batch``; on the card
    the slots are placed by the ``alloc_dest`` kernel);
  * ``EXT_OUT`` messages a node sends to the gateway slot are drained
    from the pool (``drain_ext_out``: one host read of the pool's
    fields), serialized and sent to the real peer they answer, matched
    by the session id in ``a``;
  * ``pump`` steps the simulation tick by tick and drains between ticks,
    and ``run_realtime`` keeps simulated time from running ahead of the
    wall clock (realtimescheduler.cc).  That path reads the clock back
    every tick by design; the service loop's window-boundary serving
    (``service/ingest.py GatewayIngest``) does not.

UDP datagrams map 1:1 onto messages; TCP streams carry frames behind a
4-byte big-endian length prefix.  Wire format of a frame (network byte
order): ``u32 kind | u32 a | u32 b | u32 c``.  STUN discovery
(``singlehost.py``) is not ported yet (ROADMAP Queue A item 12a).
"""

from __future__ import annotations

import dataclasses
import errno
import socket
import struct
import sys
import time

import numpy as np
import torch

from oversim_tpu_torch import tree
from oversim_tpu_torch.engine import pool as pool_mod

I32 = torch.int32
I64 = torch.int64
NS = 1_000_000_000
NO_NODE = -1

EXT_IN = 150    # real network -> gateway node (a=session, b=tag, c=word)
EXT_OUT = 151   # gateway node -> real network (same fields echoed)
EXT_NACK = 152  # gateway -> real network: frame SHED by admission control

_HDR = struct.Struct("!IIII")

# a 4-byte length prefix larger than this means the TCP byte stream is
# desynced (garbage where a prefix should be): the connection can never
# produce a complete frame again and is dropped
_MAX_TCP_FRAME = 1 << 20
_I32_MIN, _I32_MAX = -(1 << 31), (1 << 31) - 1


class GenericPacketParser:
    """Pluggable wire codec between real packets and sim messages
    (the reference's GenericPacketParser, ``parserType``).  The gateway
    calls ``decapsulate`` on every received datagram or TCP frame and
    ``encapsulate`` on every outbound ``EXT_OUT``; subclass both to speak
    another protocol (the default is the native ``u32 kind | a | b | c``
    header)."""

    def decapsulate(self, data: bytes):
        """bytes -> (b, c) payload words, or None to drop the packet."""
        if len(data) < _HDR.size:
            return None
        _, _, b, c = _HDR.unpack_from(data)
        return b, c

    def encapsulate(self, sid: int, b: int, c: int) -> bytes:
        """EXT_OUT message fields -> wire bytes."""
        return _HDR.pack(EXT_OUT, sid & 0xFFFFFFFF, b & 0xFFFFFFFF,
                         c & 0xFFFFFFFF)

    def nack(self, sid: int, b: int, c: int) -> bytes:
        """Explicit shed notice: the frame was received, parsed and
        refused by admission control, so the peer can retry."""
        return _HDR.pack(EXT_NACK, sid & 0xFFFFFFFF, b & 0xFFFFFFFF,
                         c & 0xFFFFFFFF)


def drain_ext_out(state, gw_slot: int, handler):
    """Offer every ``EXT_OUT`` in the pool addressed to ``gw_slot`` to
    ``handler(sid, b, c) -> consumed`` and free exactly the consumed
    slots in one masked ``pool.free``.  The pool's ``valid``, ``kind``,
    ``dst``, ``a``, ``b`` and ``c`` come to the host in ONE read: the
    serving sync."""
    pool = state.pool
    col = pool_mod._COL
    cols = torch.stack([pool.valid.to(I32), pool.blk[:, col["kind"]],
                        pool.blk[:, col["dst"]], pool.blk[:, col["a"]],
                        pool.blk[:, col["b"]], pool.blk[:, col["c"]]])
    valid, kind, dst, a, b, c = tree.to_host(cols).numpy()
    hits = np.nonzero((valid != 0) & (kind == EXT_OUT) & (dst == gw_slot))[0]
    if len(hits) == 0:
        return state
    done = [int(i) for i in hits
            if handler(int(a[i]), int(b[i]), int(c[i]))]
    if not done:
        return state
    mask = np.zeros(valid.shape, bool)
    mask[done] = True
    dev = pool.valid.device
    return dataclasses.replace(state, pool=pool_mod.free(
        pool, _to_device(torch.from_numpy(mask), dev)))


def _to_device(host, device):
    """A host tensor onto ``device`` without making the host wait: card
    copies go through a pinned buffer, which the caching host allocator
    keeps until the copy has run."""
    if device.type != "cuda":
        return host
    return host.pin_memory().to(device, non_blocking=True)


@dataclasses.dataclass
class ExtFrame:
    """One externally arriving frame awaiting batched injection."""

    a: int = 0
    b: int = 0
    c: int = 0
    kind: int = EXT_IN
    dst: int | None = None
    src: int | None = None
    key: object = None       # uint32 key lanes, or None for zeros


def inject_ext_batch(state, frames, gw_slot: int, t_deliver=None):
    """Write ``frames`` into the pool as ONE batched allocation.

    Every frame is delivered at ``max(t_deliver, t_now + 1)`` (the next
    tick when ``t_deliver`` is None; absolute ns otherwise), stamped
    ``t_now``, 16 bytes, no node list, zero key lanes unless the frame
    carries a key; list order is slot order among equal deliver times.
    The slots come from ``pool.alloc(..., impl="pallas")``: the
    ``alloc_dest`` kernel on a card pool, its plain version on a host
    pool (the same placement).  Frame fields are int32: a value outside
    int32 raises ``OverflowError``, as the JAX package's does.

    Returns ``(state', overflow)``, ``overflow`` the device scalar of
    frames that did not fit (no host sync), None when ``frames`` is
    empty (state returned unchanged)."""
    if not frames:
        return state, None
    n = len(frames)
    pool = state.pool
    dev = pool.valid.device
    words = np.array([[gw_slot if f.src is None else f.src,
                       gw_slot if f.dst is None else f.dst,
                       f.kind, f.a, f.b, f.c] for f in frames],
                     dtype=object)
    if words.size and (min(words.flat) < _I32_MIN
                       or max(words.flat) > _I32_MAX):
        raise OverflowError("inject_ext_batch: a frame field does not "
                            "fit int32")
    host = torch.from_numpy(words.astype(np.int32))
    keyed = [i for i, f in enumerate(frames) if f.key is not None]
    if keyed:
        key_rows = np.zeros((n, pool.kl), np.int64)
        for i in keyed:
            key_rows[i] = np.asarray(frames[i].key, np.uint32)
        key = _to_device(torch.from_numpy(key_rows), dev)
    else:
        key = torch.zeros((n, pool.kl), dtype=I64, device=dev)
    cols = _to_device(host, dev)
    when = state.t_now + 1
    if t_deliver is not None:
        when = torch.clamp(when, min=int(t_deliver))
    zeros = torch.zeros((n,), dtype=I32, device=dev)
    out = dict(
        t_deliver=when.to(I64).expand(n), src=cols[:, 0], dst=cols[:, 1],
        kind=cols[:, 2], key=key, nonce=zeros, hops=zeros, a=cols[:, 3],
        b=cols[:, 4], c=cols[:, 5], d=zeros,
        nodes=torch.full((n, pool.rmax), NO_NODE, dtype=I32, device=dev),
        size_b=torch.full((n,), _HDR.size, dtype=I32, device=dev),
        stamp=state.t_now.to(I64).expand(n))
    new_pool, overflow = pool_mod.alloc(
        pool, out, torch.ones((n,), dtype=torch.bool, device=dev),
        impl="pallas")
    return dataclasses.replace(state, pool=new_pool), overflow


class RealtimeGateway:
    """Bridges one simulation node slot to real UDP/TCP sockets."""

    def __init__(self, sim, state, gw_slot: int = 0,
                 udp_port: int = 0, tcp_port: int | None = None,
                 host: str = "127.0.0.1",
                 stun_server: tuple | None = None,
                 crypto=None, parser: GenericPacketParser | None = None,
                 tracer=None, max_rx_backlog: int | None = None):
        if stun_server is not None:
            raise NotImplementedError(
                "stun_server needs singlehost.py (STUN discovery), which is "
                "not ported yet (ROADMAP Queue A item 12a)")
        self.sim = sim
        self.state = state
        self.gw = gw_slot
        # request tracing (duck-typed: mint/settle/nack per sid)
        self.tracer = tracer
        self.parser = parser or GenericPacketParser()
        # every outbound frame is signed, every inbound one must carry a
        # valid auth block (common/crypto.py CryptoModule)
        self.crypto = crypto
        self.udp = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        self.udp.bind((host, udp_port))
        self.udp.setblocking(False)
        self.udp_port = self.udp.getsockname()[1]
        self.tcp = None
        self.tcp_port = None
        self._tcp_conns: dict = {}      # session id -> (sock, rx buffer)
        # per-connection WRITE buffers: a frame is appended whole and
        # drained by non-blocking sends, so a partial write never cuts
        # the length-prefixed stream mid-frame
        self._tcp_tx: dict = {}         # session id -> tx bytearray
        self.tx_partial_writes = 0
        if tcp_port is not None:
            self.tcp = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
            self.tcp.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
            self.tcp.bind((host, tcp_port))
            self.tcp.listen(8)
            self.tcp.setblocking(False)
            self.tcp_port = self.tcp.getsockname()[1]
        self._sessions: dict = {}       # session id -> ("udp", addr) | ...
        self._next_session = 1
        # frames wait host-side in _rx and enter the pool as ONE
        # allocation per flush_rx (per window boundary, or per pump)
        self._rx: list = []
        self._rx_overflow: list = []    # device scalars, see rx_overflow
        self.rx_frames = 0
        self.rx_batches = 0
        self.rx_dropped = 0             # malformed/unauthenticated frames
        self.rx_socket_errors = 0
        # admission control: past this many pending frames, well-formed
        # frames are SHED (counted, NACKed, never queued); None: unbounded
        self.max_rx_backlog = max_rx_backlog
        self.rx_shed = 0
        self._warned: set = set()
        # serving-window index (set by GatewayIngest per boundary) so
        # traced latencies carry window units; None on the pump path
        self._window = None

    # ------------------------------------------------ injection --------
    def flush_rx(self, t_deliver=None):
        """Inject every pending RX frame as ONE batched pool write."""
        if not self._rx:
            return
        frames, self._rx = self._rx, []
        self.state, overflow = inject_ext_batch(self.state, frames, self.gw,
                                                t_deliver=t_deliver)
        self._rx_overflow.append(overflow)
        self.rx_batches += 1
        self.rx_frames += len(frames)

    def rx_overflow(self) -> int:
        """Frames lost to pool overflow across the flushed batches; the
        per-batch counts stay device scalars until this reads them."""
        total = sum(int(h) for h in self._rx_overflow)
        self._rx_overflow = [total] if total else []
        return total

    # ------------------------------------------------ socket pumps -----
    def _rx_warn(self, category: str, detail: str):
        """One stderr warning per category; the counters count all."""
        if category not in self._warned:
            self._warned.add(category)
            print(f"oversim-tpu-torch gateway: dropping {category} "
                  f"({detail}); counted in rx_dropped/rx_socket_errors, "
                  "further occurrences silent", file=sys.stderr)

    def _shed_frame(self, sid: int, b: int, c: int, transmit) -> None:
        """Refuse one admitted frame: count it, settle its trace as
        NACKed and send the NACK back through ``transmit``."""
        self.rx_shed += 1
        self._rx_warn(
            "shed frame (admission control)",
            f"rx backlog at max_rx_backlog={self.max_rx_backlog}")
        self._trace("nack", sid)
        payload = self.parser.nack(sid, b, c)
        if self.crypto is not None:
            payload = self.crypto.sign_frame(payload)
        try:
            transmit(payload)
        except OSError:
            pass

    def _decode_frame(self, data: bytes, what: str):
        """Verify and parse one frame; None (counted, warned) on any
        failure: a malformed packet never unwinds the poll loop."""
        try:
            if self.crypto is not None:
                data = self.crypto.verify_frame(data)
                if data is None:
                    self.rx_dropped += 1
                    self._rx_warn(f"unauthenticated {what}",
                                  "bad auth block")
                    return None
            parsed = self.parser.decapsulate(data)
            if parsed is None:
                self.rx_dropped += 1
                self._rx_warn(f"rejected {what}", "parser returned None")
                return None
            return parsed
        except Exception as e:  # noqa: BLE001 — any parser/crypto crash
            self.rx_dropped += 1
            self._rx_warn(f"malformed {what}", repr(e))
            return None

    def _trace(self, event: str, sid: int):
        if self.tracer is None:
            return
        fn = getattr(self.tracer, event, None)
        if fn is None:
            return
        if self._window is not None:
            fn(sid, window=self._window)
        else:
            fn(sid)

    def _send_tcp(self, sid: int, payload: bytes):
        """Queue one length-prefixed frame on the session's write buffer
        and drain what the socket takes now."""
        if sid not in self._tcp_conns:
            return
        buf = self._tcp_tx.setdefault(sid, bytearray())
        buf += len(payload).to_bytes(4, "big") + payload
        self._pump_tx(sid)

    def _pump_tx(self, only_sid=None):
        """Drain the write buffers with non-blocking sends; what the
        kernel refuses stays queued for the next poll."""
        sids = ((only_sid,) if only_sid is not None
                else tuple(self._tcp_tx))
        for sid in sids:
            buf = self._tcp_tx.get(sid)
            entry = self._tcp_conns.get(sid)
            if not buf or entry is None:
                if entry is None:
                    self._tcp_tx.pop(sid, None)
                continue
            conn = entry[0]
            while buf:
                try:
                    n = conn.send(buf)
                except BlockingIOError:
                    break
                except OSError:
                    self._tcp_tx.pop(sid, None)
                    break
                if n < len(buf):
                    self.tx_partial_writes += 1
                del buf[:n]

    def _poll_udp(self):
        socket_errs = 0
        while True:
            try:
                data, addr = self.udp.recvfrom(65536)
            except BlockingIOError:
                return
            except InterruptedError:
                continue
            except OSError as e:
                # an earlier sendto to a dead peer surfaces here as
                # ECONNREFUSED/ECONNRESET: count it and keep draining,
                # boundedly
                self.rx_socket_errors += 1
                self._rx_warn("udp socket error", repr(e))
                socket_errs += 1
                if (e.errno in (errno.ECONNREFUSED, errno.ECONNRESET)
                        and socket_errs < 64):
                    continue
                return
            parsed = self._decode_frame(data, "udp datagram")
            if parsed is None:
                continue
            b, c = parsed
            sid = self._next_session
            self._next_session += 1
            self._trace("mint", sid)
            if (self.max_rx_backlog is not None
                    and len(self._rx) >= self.max_rx_backlog):
                # no session entry: a shed frame never gets an EXT_OUT
                self._shed_frame(
                    sid, b, c, lambda p: self.udp.sendto(p, addr))
                continue
            self._sessions[sid] = ("udp", addr)
            self._rx.append(ExtFrame(a=sid, b=b, c=c))

    def _poll_tcp(self):
        if self.tcp is None:
            return
        while True:
            try:
                conn, _ = self.tcp.accept()
            except (BlockingIOError, OSError):
                break
            conn.setblocking(False)
            sid = self._next_session
            self._next_session += 1
            self._tcp_conns[sid] = (conn, bytearray())
            self._sessions[sid] = ("tcp", sid)
        dead = []
        for sid, (conn, buf) in self._tcp_conns.items():
            try:
                chunk = conn.recv(65536)
                if chunk == b"":
                    dead.append(sid)
                    continue
                buf.extend(chunk)
            except BlockingIOError:
                pass
            except OSError as e:
                self.rx_socket_errors += 1
                self._rx_warn("tcp socket error", repr(e))
                dead.append(sid)
                continue
            while len(buf) >= 4:
                ln = int.from_bytes(buf[:4], "big")
                if ln > _MAX_TCP_FRAME:
                    # garbage where the prefix should be: unrecoverable
                    self.rx_dropped += 1
                    self._rx_warn("desynced tcp stream",
                                  f"length prefix {ln}")
                    dead.append(sid)
                    break
                if len(buf) < 4 + ln:
                    break             # incomplete frame: wait for more
                frame = bytes(buf[4:4 + ln])
                del buf[:4 + ln]
                parsed = self._decode_frame(frame, "tcp frame")
                if parsed is None:
                    continue
                b, c = parsed
                # per-FRAME mint on the per-connection sid
                self._trace("mint", sid)
                if (self.max_rx_backlog is not None
                        and len(self._rx) >= self.max_rx_backlog):
                    # the connection survives: only this frame is refused
                    self._shed_frame(
                        sid, b, c,
                        lambda p, _sid=sid: self._send_tcp(_sid, p))
                    continue
                self._rx.append(ExtFrame(a=sid, b=b, c=c))
        for sid in dead:
            self._tcp_conns.pop(sid, None)
            self._tcp_tx.pop(sid, None)
            self._sessions.pop(sid, None)
        self._pump_tx()

    def _drain_ext_out(self):
        """Transmit the socket sessions' EXT_OUT messages (orphans are
        freed with nothing to send)."""

        def handler(sid, b, c):
            sess = self._sessions.get(sid)
            if sess is None:
                return True
            self._trace("settle", sid)
            payload = self.parser.encapsulate(sid, b, c)
            if self.crypto is not None:
                payload = self.crypto.sign_frame(payload)
            if sess[0] == "udp":
                try:
                    self.udp.sendto(payload, sess[1])
                except OSError:
                    pass
            else:
                self._send_tcp(sid, payload)
            return True

        self.state = drain_ext_out(self.state, self.gw, handler)

    # ------------------------------------------------ the loop ---------
    def pump(self, sim_seconds: float = 0.1):
        """Poll sockets, inject, advance the simulation, transmit.

        Steps tick by tick and drains EXT_OUT between ticks (an EXT_OUT
        self-send would otherwise be delivered back into the gateway
        node's inbox on the next tick).  Reads the clock back every tick:
        the realtime path's syncs, by design."""
        self._poll_udp()
        self._poll_tcp()
        self.flush_rx()
        target = int(self.state.t_now) + int(sim_seconds * NS)
        while int(self.state.t_now) < target:
            prev = int(self.state.t_now)
            self.state = self.sim.step(self.state)
            self._drain_ext_out()
            if int(self.state.t_now) == prev and not bool(
                    torch.any(self.state.pool.valid).item()):
                break   # nothing scheduled anywhere: idle sim

    def run_realtime(self, duration_s: float, slice_s: float = 0.05):
        """Pace the simulation so simulated time tracks the wall clock."""
        t0_wall = time.monotonic()
        t0_sim = int(self.state.t_now) / NS
        while True:
            elapsed = time.monotonic() - t0_wall
            if elapsed >= duration_s:
                return
            ahead = (int(self.state.t_now) / NS - t0_sim) - elapsed
            if ahead > slice_s:
                time.sleep(min(ahead, slice_s))
                continue
            self.pump(slice_s)

    def close(self):
        self.udp.close()
        if self.tcp is not None:
            self.tcp.close()
        for conn, _ in self._tcp_conns.values():
            try:
                conn.close()
            except OSError:
                pass
