"""The port's gateway (oversim_tpu_torch/gateway.py) and echo apps.

Loopback sockets on 127.0.0.1, port 0: a real UDP datagram or TCP frame
traverses a simulated node (Kademlia + ``RealworldEchoApp``, 4 nodes on
the CPU) and comes back on the wire; hostile input is dropped and
counted; admission control sheds with a NACK; a custom parser and a
signed gateway drive the same path.  ``inject_ext_batch`` writes the
same pool leaves as the JAX package's (its JAX half in a fresh
interpreter, test_torch_engine.py ``fresh_jax_call`` says why) and
``drain_ext_out`` frees only what its handler consumed.  The engine's
``ext_hold_slot`` is held in test_torch_ext_hold.py.
"""

import dataclasses
import functools
import socket
import time

import numpy as np
import pytest
import torch

from oversim_tpu_torch import churn as tchurn
from oversim_tpu_torch import interop
from oversim_tpu_torch.apps.realworld import RealworldEchoApp, TcpEchoApp
from oversim_tpu_torch.common.crypto import CryptoModule
from oversim_tpu_torch.engine import pool as pool_mod
from oversim_tpu_torch.engine import sim as tsim
from oversim_tpu_torch.gateway import (EXT_IN, EXT_NACK, EXT_OUT, ExtFrame,
                                       GenericPacketParser, RealtimeGateway,
                                       _HDR, drain_ext_out, inject_ext_batch)
from oversim_tpu_torch.overlay.kademlia import KademliaLogic
from oversim_tpu_torch.service import GatewayIngest
from oversim_tpu_torch.underlay import simple as tul
from test_torch_engine import JaxCall, first_difference

# tiny tensors: one intra-op thread keeps parallel test workers from
# oversubscribing the host
torch.set_num_threads(1)

# (frames, gw_slot, t_deliver) per batch: a key with the top bit set,
# src/dst overrides, an EXT_OUT, a later delivery time, then a batch
# that overflows the pool
KEY = (0xFFFFFFFF, 7)
BATCHES = (
    ([dict(a=1, b=7, c=70), dict(a=2, b=8, c=80, dst=3, src=2, key=KEY),
      dict(a=3, b=9, c=90, kind=EXT_OUT)], 0, None),
    ([dict(a=4, b=-5, c=2 ** 31 - 1), dict(a=5, b=1, c=1, dst=1)], 1, 5000),
    ([dict(a=6 + i, b=i, c=i) for i in range(14)], 0, 500),
)


@dataclasses.dataclass
class PoolState:
    pool: pool_mod.MsgPool
    t_now: torch.Tensor


def _pool_state(p=16):
    return PoolState(pool=pool_mod.empty(p, 2, 2, "cpu"),
                     t_now=torch.tensor(1000))


def jax_injections():
    """``{batch|path: leaf}`` after each batch and ``overflow`` counts."""
    import jax
    import jax.numpy as jnp

    from oversim_tpu import gateway as jgw
    from oversim_tpu.engine import pool as jpool

    @jax.tree_util.register_dataclass
    @dataclasses.dataclass
    class JState:
        pool: jpool.MsgPool
        t_now: jnp.ndarray

    st = JState(pool=jpool.empty(16, key_lanes=2, rmax=2),
                t_now=jnp.int64(1000))
    out, over = {}, []
    for i, (frames, gw, when) in enumerate(BATCHES):
        st, o = jgw.inject_ext_batch(st, [jgw.ExtFrame(**f) for f in frames],
                                     gw, t_deliver=when)
        over.append(int(o))
        for p, v in jax.tree_util.tree_flatten_with_path(st)[0]:
            out[f"{i}|{jax.tree_util.keystr(p)}"] = np.array(v)
    out["overflow"] = np.array(over)
    return out


@functools.lru_cache(maxsize=None)
def jax_ref():
    return JaxCall("test_torch_gateway", "jax_injections")


def test_inject_ext_batch_matches_jax():
    """Every pool leaf after each batch equals JAX's (the CPU pool takes
    ``alloc_dest``'s plain version); a field outside int32 raises as
    JAX's does; an empty batch changes nothing."""
    call = jax_ref()
    st, over = _pool_state(), []
    for frames, gw, when in BATCHES:
        st, o = inject_ext_batch(st, [ExtFrame(**f) for f in frames], gw,
                                 t_deliver=when)
        over.append(int(o))
    with pytest.raises(OverflowError):
        inject_ext_batch(st, [ExtFrame(a=2 ** 31)], 0)
    assert inject_ext_batch(st, [], 0) == (st, None)
    ref = call.result()
    assert over == ref["overflow"].tolist() == [0, 0, 3]
    st = _pool_state()
    for i, (frames, gw, when) in enumerate(BATCHES):
        st, _ = inject_ext_batch(st, [ExtFrame(**f) for f in frames], gw,
                                 t_deliver=when)
        want = {k.split("|", 1)[1]: v for k, v in ref.items()
                if k.startswith(f"{i}|")}
        assert first_difference(want, st) is None, i


def test_drain_frees_only_consumed():
    st, _ = inject_ext_batch(_pool_state(), [
        ExtFrame(a=1, b=1, c=10, kind=EXT_OUT),
        ExtFrame(a=2, b=2, c=20, kind=EXT_OUT),
        ExtFrame(a=3, b=3, c=30, kind=EXT_OUT, dst=1),   # another slot
        ExtFrame(a=4, b=4, c=40)], 0)                    # EXT_IN
    seen = []

    def handler(sid, b, c):
        seen.append((sid, b, c))
        return sid % 2 == 0

    out = drain_ext_out(st, 0, handler)
    assert sorted(seen) == [(1, 1, 10), (2, 2, 20)]
    left = sorted(interop.state_to_numpy(out)[".pool.blk"][
        out.pool.valid.numpy()][:, pool_mod._COL["a"]].tolist())
    assert left == [1, 3, 4]
    assert drain_ext_out(out, 0, lambda *a: False) is out


def _echo_sim(app, n=4, inbox_impl="scatter", hold=False):
    return tsim.Simulation(
        KademliaLogic(app=app),
        tchurn.ChurnParams(model="none", target_num=n, init_interval=0.2,
                           init_deviation=0.0),
        tul.UnderlayParams(jitter=0.0),
        tsim.EngineParams(window=0.1, inbox_impl=inbox_impl,
                          ext_hold_slot=0 if hold else -1), device="cpu")


def _ring(app, seed=9):
    sim = _echo_sim(app)
    return sim, sim.run_until(sim.init(seed=seed), 2.0, chunk=10)


def _pump_until_reply(gw, recv):
    for _ in range(50):
        gw.pump(0.2)
        try:
            return recv()
        except socket.timeout:
            continue
    raise AssertionError("no reply from the gateway")


def test_udp_and_tcp_echo_through_sim():
    """A datagram and a TCP frame each traverse the simulated node (the
    payload word comes back incremented by the app's transform)."""
    sim, st = _ring(RealworldEchoApp(transform=5))
    gw = RealtimeGateway(sim, st, gw_slot=0)
    client = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    client.settimeout(0.3)
    try:
        client.sendto(_HDR.pack(EXT_IN, 0, 42, 1000),
                      ("127.0.0.1", gw.udp_port))
        data, _ = _pump_until_reply(gw, lambda: client.recvfrom(4096))
        kind, _, b, c = _HDR.unpack_from(data)
        assert (kind, b, c) == (EXT_OUT, 42, 1005)
        assert gw.rx_batches == 1 and gw.rx_overflow() == 0
    finally:
        client.close()
        gw.close()

    sim, st = _ring(TcpEchoApp(transform=7), seed=10)
    gw = RealtimeGateway(sim, st, gw_slot=0, tcp_port=0)
    client = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    client.settimeout(0.3)
    try:
        client.connect(("127.0.0.1", gw.tcp_port))
        frame = _HDR.pack(EXT_IN, 0, 7, 100)
        client.sendall(len(frame).to_bytes(4, "big") + frame)
        buf = _pump_until_reply(gw, lambda: client.recv(4096))
        while len(buf) < 4 + _HDR.size:
            buf += client.recv(4096)
        assert int.from_bytes(buf[:4], "big") == _HDR.size
        assert _HDR.unpack_from(buf, 4)[2:] == (7, 107)
    finally:
        client.close()
        gw.close()


def _poll_until(gw, cond, timeout_s=3.0):
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        gw._poll_udp()
        gw._poll_tcp()
        if cond():
            return True
        time.sleep(0.01)
    return False


def test_garbage_datagram_and_raising_parser_are_dropped():
    gw = RealtimeGateway(None, None)   # sockets only
    client = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    try:
        client.sendto(b"\x01", ("127.0.0.1", gw.udp_port))
        assert _poll_until(gw, lambda: gw.rx_dropped == 1)
        client.sendto(_HDR.pack(EXT_IN, 0, 5, 500),
                      ("127.0.0.1", gw.udp_port))
        assert _poll_until(gw, lambda: len(gw._rx) == 1)
        assert (gw._rx[0].b, gw._rx[0].c) == (5, 500)
    finally:
        client.close()
        gw.close()

    class BoomParser(GenericPacketParser):
        def decapsulate(self, data):
            raise RuntimeError("boom")

    gw = RealtimeGateway(None, None, parser=BoomParser())
    client = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    try:
        for _ in range(2):
            client.sendto(b"hostile", ("127.0.0.1", gw.udp_port))
        assert _poll_until(gw, lambda: gw.rx_dropped == 2)
        assert gw._rx == []
    finally:
        client.close()
        gw.close()


def test_desynced_tcp_stream_is_dropped():
    gw = RealtimeGateway(None, None, tcp_port=0)
    client = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    try:
        client.connect(("127.0.0.1", gw.tcp_port))
        client.sendall(b"\xff\xff\xff\xffgarbage")   # prefix ~4 GiB
        assert _poll_until(gw, lambda: gw.rx_dropped >= 1)
        assert gw._tcp_conns == {}
    finally:
        client.close()
        gw.close()


class _Tracer:
    def __init__(self):
        self.events = []

    def mint(self, sid, window=None):
        self.events.append(("mint", sid, window))

    def settle(self, sid, window=None):
        self.events.append(("settle", sid, window))

    def nack(self, sid, window=None):
        self.events.append(("nack", sid, window))


def test_admission_shedding_nacks_udp_and_tcp():
    """Past ``max_rx_backlog`` a frame is refused with an explicit NACK
    carrying its own words: no session entry for UDP, the connection
    survives for TCP."""
    tr = _Tracer()
    gw = RealtimeGateway(None, None, max_rx_backlog=2, tracer=tr)
    client = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    client.settimeout(3.0)
    try:
        for i in range(3):
            client.sendto(_HDR.pack(EXT_IN, 0, i, 100 + i),
                          ("127.0.0.1", gw.udp_port))
        assert _poll_until(gw, lambda: gw.rx_shed == 1)
        assert [(f.b, f.c) for f in gw._rx] == [(0, 100), (1, 101)]
        kind, sid, b, c = _HDR.unpack(client.recv(65536))
        assert kind == EXT_NACK and (b, c) == (2, 102)
        assert ("nack", sid, None) in tr.events and sid not in gw._sessions
    finally:
        client.close()
        gw.close()

    gw = RealtimeGateway(None, None, tcp_port=0, max_rx_backlog=1)
    client = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    client.settimeout(3.0)
    try:
        client.connect(("127.0.0.1", gw.tcp_port))
        for i in range(2):
            frame = _HDR.pack(EXT_IN, 0, i, 200 + i)
            client.sendall(len(frame).to_bytes(4, "big") + frame)
        assert _poll_until(gw, lambda: gw.rx_shed == 1)
        ln = int.from_bytes(client.recv(4), "big")
        kind, _, b, c = _HDR.unpack(client.recv(ln))
        assert kind == EXT_NACK and (b, c) == (1, 201)
        assert len(gw._tcp_conns) == 1
    finally:
        client.close()
        gw.close()


def test_pluggable_packet_parser():
    class AsciiParser(GenericPacketParser):
        def decapsulate(self, data):
            try:
                b, c = data.decode("ascii").strip().split(":")
                return int(b), int(c)
            except (ValueError, UnicodeDecodeError):
                return None

        def encapsulate(self, sid, b, c):
            return f"{b}:{c}".encode("ascii")

    sim, st = _ring(RealworldEchoApp(transform=11), seed=13)
    gw = RealtimeGateway(sim, st, gw_slot=0, parser=AsciiParser())
    client = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    client.settimeout(0.25)
    try:
        client.sendto(b"\x00\x01garbage", ("127.0.0.1", gw.udp_port))
        client.sendto(b"6:900", ("127.0.0.1", gw.udp_port))
        data, _ = _pump_until_reply(gw, lambda: client.recvfrom(4096))
        assert data == b"6:911" and gw.rx_dropped == 1
    finally:
        client.close()
        gw.close()


def test_signed_gateway_rejects_unsigned(tmp_path):
    kf = str(tmp_path / "node.key")
    cm, cm2 = CryptoModule(key_file=kf), CryptoModule(key_file=kf)
    assert cm.key == cm2.key
    sim, st = _ring(RealworldEchoApp(transform=3), seed=12)
    gw = RealtimeGateway(sim, st, gw_slot=0, crypto=cm)
    client = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    client.settimeout(0.25)
    try:
        client.sendto(_HDR.pack(EXT_IN, 0, 1, 50),
                      ("127.0.0.1", gw.udp_port))
        gw.pump(0.3)
        assert gw.crypto.num_verify_failed >= 1
        client.sendto(cm2.sign_frame(_HDR.pack(EXT_IN, 0, 9, 500)),
                      ("127.0.0.1", gw.udp_port))
        data, _ = _pump_until_reply(gw, lambda: client.recvfrom(4096))
        stripped = cm2.verify_frame(data)
        assert stripped is not None
        assert _HDR.unpack_from(stripped)[2:] == (9, 503)
        forged = bytearray(cm2.sign_frame(_HDR.pack(EXT_IN, 0, 2, 60)))
        forged[8] ^= 0xFF
        assert cm2.verify_frame(bytes(forged)) is None
    finally:
        client.close()
        gw.close()


def test_gateway_ingest_batches_and_counts_windows():
    """``GatewayIngest`` flushes a boundary's frames as ONE pool write,
    mints and settles in window units, and counts drains; the
    ``EXT_OUT_KIND`` mirror equals ``gateway.EXT_OUT``; STUN raises
    naming ROADMAP."""
    assert tsim.EXT_OUT_KIND == EXT_OUT
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        RealtimeGateway(None, None, stun_server=("127.0.0.1", 3478))
    tr = _Tracer()
    gw = RealtimeGateway(None, _pool_state(), tracer=tr)
    ing = GatewayIngest(gw)
    client = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    try:
        for i in range(3):
            client.sendto(_HDR.pack(EXT_IN, 0, i, 100 + i),
                          ("127.0.0.1", gw.udp_port))
        assert _poll_until(gw, lambda: len(gw._rx) == 3)
        st = ing.before_window(_pool_state(), target_ns=0)
        assert gw.rx_batches == 1 and gw.rx_frames == 3
        assert int(st.pool.valid.sum()) == 3
        sid = tr.events[0][1]
        assert tr.events[0] == ("mint", sid, None)
        st, _ = inject_ext_batch(st, [ExtFrame(a=sid, b=0, c=101,
                                               kind=EXT_OUT)], 0)
        st = ing.after_window(st)
        assert ("settle", sid, 0) in tr.events and ing.windows == 1
        data, _ = client.recvfrom(4096)
        assert _HDR.unpack_from(data)[1:] == (sid, 0, 101)
        client.sendto(_HDR.pack(EXT_IN, 0, 6, 600),
                      ("127.0.0.1", gw.udp_port))
        deadline = time.monotonic() + 3.0
        while len(tr.events) < 5 and time.monotonic() < deadline:
            st = ing.before_window(st, target_ns=0)
            time.sleep(0.01)
        assert tr.events[-1] == ("mint", sid + 3, 1)
    finally:
        client.close()
        gw.close()
