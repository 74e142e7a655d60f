"""Real-network test apps served through the gateway (PyTorch, batched).

Counterpart of ``oversim_tpu/apps/realworld.py`` (rebuilds of
src/applications/realworldtestapp/ and src/applications/tcpexampleapp/).
The gateway (``gateway.py``) turns UDP datagrams and TCP frames alike
into ``EXT_IN`` messages, so both apps answer every ``EXT_IN`` with an
``EXT_OUT`` carrying the payload word plus ``transform``, back to the
sender slot; the gateway's session table routes it to the real peer.
"""

from __future__ import annotations

from oversim_tpu_torch.apps.dummy import TierDummyApp
from oversim_tpu_torch.gateway import EXT_IN, EXT_OUT


class RealworldEchoApp(TierDummyApp):
    """EXT_IN -> EXT_OUT responder (RealWorldTestApp::handleRealworld
    Packet: answer the real peer with a transformed payload)."""

    def __init__(self, transform: int = 1):
        self.transform = transform

    def on_msgs(self, app, msgs, ctx, ob, ev, is_sib, node_idx=None):
        """One send over the whole ``[N, R]`` inbox.  Its R lanes enter
        the outbox in slot order, as the JAX overlay's per-slot
        ``on_msg`` calls do, so the pool slots match."""
        en = msgs.valid & (msgs.kind == EXT_IN)
        ob.send(en, msgs.t_deliver, msgs.src, EXT_OUT, a=msgs.a, b=msgs.b,
                c=msgs.c + self.transform, size_b=16)
        return app


class TcpEchoApp(RealworldEchoApp):
    """TCPExampleApp equivalent: the same sim-side logic; pair it with a
    gateway built with ``tcp_port`` so frames arrive over TCP."""
