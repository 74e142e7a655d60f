"""The dense tick engine: a ping/pong logic on both engines, leaf-exact.

The JAX side of every parity run here (and in test_torch_kademlia*.py and
test_torch_underlay.py) runs in a fresh interpreter (``fresh_jax_call``):
the JAX package's own tests donate simulation states that hold the module
constant ``oversim_tpu.churn.T_INF`` and so delete it for every later
test in their worker process.

``PingLogic`` is a copy of the one in tests/test_engine.py:180, once for
the JAX engine (written per node, vmapped) and once for the port
(batched over the node axis).  With ``init_deviation=0`` and
``jitter=0`` (the two places the engine draws ``jax.random.normal``,
whose erfinv the port cannot match bit for bit) every ``SimState`` leaf
is equal after 64 ticks, for both ``inbox_impl`` values.  The rtt
statistic divides by ``NS`` the way XLA compiles it, as a multiply by
the float32 reciprocal.
"""

import dataclasses
import json
import os
import pathlib
import subprocess
import sys
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from oversim_tpu import churn as jchurn
from oversim_tpu import stats as jstats
from oversim_tpu.core import keys as jkeys
from oversim_tpu.engine import logic as jlogic
from oversim_tpu.engine import sim as jsim
from oversim_tpu.underlay import simple as jul
from oversim_tpu_torch import churn as tchurn
from oversim_tpu_torch import interop
from oversim_tpu_torch import rng as R
from oversim_tpu_torch import stats as tstats
from oversim_tpu_torch import tree
from oversim_tpu_torch.core import keys as tkeys
from oversim_tpu_torch.engine import logic as tlogic
from oversim_tpu_torch.engine import sim as tsim
from oversim_tpu_torch.underlay import simple as tul

# tiny tensors: one intra-op thread keeps parallel test workers from
# oversubscribing the host
torch.set_num_threads(1)

NS = 1_000_000_000
T_INF = 2**62
KIND_PING, KIND_PONG = 100, 101


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class JPingState:
    t_ping: jnp.ndarray
    t_sent: jnp.ndarray
    ready: jnp.ndarray


class JPingLogic:
    key_spec = jkeys.KeySpec(160)
    interval_ns = 1 * NS

    def stat_spec(self):
        return jstats.StatSpec(scalars=("ping.rtt",),
                               hists=(("ping.rttBins", 8),),
                               counters=("ping.sent", "pong.received"))

    def init(self, rng, n):
        return JPingState(t_ping=jnp.full((n,), T_INF, jnp.int64),
                          t_sent=jnp.zeros((n,), jnp.int64),
                          ready=jnp.zeros((n,), bool))

    def reset(self, state, clear, join, t_now, rng):
        jitter = jax.random.randint(rng, clear.shape, 0, self.interval_ns,
                                    dtype=jnp.int64)
        return JPingState(
            t_ping=jnp.where(join, t_now + jitter,
                             jnp.where(clear, T_INF, state.t_ping)),
            t_sent=jnp.where(clear, 0, state.t_sent),
            ready=jnp.where(clear, join, state.ready))

    def ready_mask(self, state):
        return state.ready

    def next_event(self, state):
        return state.t_ping

    def step(self, ctx, st, msgs, rng, node_idx, *, outbox_slots, rmax):
        out = jlogic.Outbox(outbox_slots, self.key_spec.lanes, rmax)
        r_in = msgs.valid.shape[0]
        rtt_vals = jnp.zeros((r_in,), jnp.float32)
        rtt_mask = jnp.zeros((r_in,), bool)
        pongs = jnp.int32(0)
        for r in range(r_in):
            m = msgs.slot(r)
            is_ping = m.valid & (m.kind == KIND_PING)
            out.send(is_ping, m.t_deliver, m.src, KIND_PONG, nonce=m.nonce,
                     size_b=40)
            is_pong = m.valid & (m.kind == KIND_PONG)
            rtt = (m.t_deliver - st.t_sent).astype(jnp.float32) / NS
            rtt_vals = rtt_vals.at[r].set(rtt)
            rtt_mask = rtt_mask.at[r].set(is_pong)
            pongs += is_pong.astype(jnp.int32)
        due = st.t_ping < ctx.t_end
        dst = ctx.sample_ready(rng)
        fire = due & (dst >= 0) & (dst != node_idx)
        out.send(fire, st.t_ping, dst, KIND_PING, nonce=node_idx, size_b=40)
        st = dataclasses.replace(
            st, t_ping=jnp.where(due, st.t_ping + self.interval_ns,
                                 st.t_ping),
            t_sent=jnp.where(fire, st.t_ping, st.t_sent))
        events = {"s:ping.rtt": (rtt_vals, rtt_mask),
                  "h:ping.rttBins": ((rtt_vals * 20).astype(jnp.int32),
                                     rtt_mask),
                  "c:ping.sent": fire.astype(jnp.int32),
                  "c:pong.received": pongs}
        return st, out, events


@dataclasses.dataclass
class TPingState:
    t_ping: torch.Tensor
    t_sent: torch.Tensor
    ready: torch.Tensor


class TPingLogic:
    key_spec = tkeys.KeySpec(160)
    interval_ns = 1 * NS

    def stat_spec(self):
        return tstats.StatSpec(scalars=("ping.rtt",),
                               hists=(("ping.rttBins", 8),),
                               counters=("ping.sent", "pong.received"))

    def init(self, rng, n):
        dev = rng.device
        return TPingState(
            t_ping=torch.full((n,), T_INF, dtype=torch.int64, device=dev),
            t_sent=torch.zeros((n,), dtype=torch.int64, device=dev),
            ready=torch.zeros((n,), dtype=torch.bool, device=dev))

    def reset(self, state, clear, join, t_now, rng):
        jitter = R.randint(rng, clear.shape, 0, self.interval_ns,
                           torch.int64)
        return TPingState(
            t_ping=torch.where(join, t_now + jitter,
                               torch.where(clear, T_INF, state.t_ping)),
            t_sent=torch.where(clear, 0, state.t_sent),
            ready=torch.where(clear, join, state.ready))

    def ready_mask(self, state):
        return state.ready

    def next_event(self, state):
        return state.t_ping

    def step(self, ctx, st, msgs, rng, node_idx, *, outbox_slots, rmax):
        n, r_in = msgs.valid.shape
        out = tlogic.Outbox(n, outbox_slots, self.key_spec.lanes, rmax,
                            node_idx.device)
        inv_ns = torch.tensor(1.0 / NS, dtype=torch.float32)
        rtt_vals, rtt_mask, pongs = [], [], torch.zeros(n, dtype=torch.int32)
        for r in range(r_in):
            m = msgs.slot(r)
            is_ping = m.valid & (m.kind == KIND_PING)
            out.send(is_ping, m.t_deliver, m.src, KIND_PONG, nonce=m.nonce,
                     size_b=40)
            is_pong = m.valid & (m.kind == KIND_PONG)
            rtt_vals.append((m.t_deliver - st.t_sent).to(torch.float32)
                            * inv_ns)
            rtt_mask.append(is_pong)
            pongs = pongs + is_pong.to(torch.int32)
        rtt_vals = torch.stack(rtt_vals, 1)
        rtt_mask = torch.stack(rtt_mask, 1)
        due = st.t_ping < ctx.t_end
        dst = ctx.sample_ready(rng)
        fire = due & (dst >= 0) & (dst != node_idx)
        out.send(fire, st.t_ping, dst, KIND_PING, nonce=node_idx, size_b=40)
        st = TPingState(
            t_ping=torch.where(due, st.t_ping + self.interval_ns, st.t_ping),
            t_sent=torch.where(fire, st.t_ping, st.t_sent), ready=st.ready)
        events = {"s:ping.rtt": (rtt_vals, rtt_mask),
                  "h:ping.rttBins": ((rtt_vals * 20).to(torch.int32),
                                     rtt_mask),
                  "c:ping.sent": fire.to(torch.int32),
                  "c:pong.received": pongs}
        return st, out, events


TESTS_DIR = pathlib.Path(__file__).resolve().parent

# The interpreter lowers its own CPU priority: the suite is
# throughput-bound and its longest file is the JAX package's
# tests/test_pastry.py, so a reference run takes the cores that the
# workers leave (it costs the same CPU, and its caller waits for it)
_RUNNER = """
import importlib, json, os, sys
os.nice(10)
sys.path[:0] = [sys.argv[3], sys.argv[4]]
import conftest  # the suite's XLA flags, x64, CPU
import numpy as np
res = getattr(importlib.import_module(sys.argv[1]), sys.argv[2])(
    **json.loads(sys.argv[5]))
keys = sorted(res)
np.savez(sys.argv[6], __keys__=np.array(json.dumps(keys)),
         **{"a%d" % i: np.asarray(res[k]) for i, k in enumerate(keys)})
"""


# XLA-CPU's older elemental IR emitters in place of its fusion emitters:
# the same leaves, bit for bit, for less CPU on the port tests' tick
# programs (scripts/torch_tier1_profile.py jax-cost: Pastry's
# semi-recursive tick 186.7 -> 107.4 CPU seconds, NTree over Chord 40.3
# -> 32.6); tests/conftest.py adds the suite's flags after these
JAX_XLA_FLAGS = "--xla_cpu_use_fusion_emitters=false"


class JaxCall:
    """``module.func(**kw)`` started in a fresh interpreter; ``func``
    returns ``{name: array}``, which ``result()`` waits for.  A caller can
    step the port while the JAX side runs."""

    def __init__(self, module, func, **kw):
        self._dir = tempfile.TemporaryDirectory()
        self._out = os.path.join(self._dir.name, "out.npz")
        env = dict(os.environ, XLA_FLAGS=" ".join(
            filter(None, (os.environ.get("XLA_FLAGS", ""), JAX_XLA_FLAGS))))
        self._proc = subprocess.Popen(
            [sys.executable, "-c", _RUNNER, module, func, str(TESTS_DIR),
             str(TESTS_DIR.parent), json.dumps(kw), self._out],
            stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True,
            env=env)

    def result(self):
        try:
            _, err = self._proc.communicate(timeout=900)
            assert self._proc.returncode == 0, err[-3000:]
            z = np.load(self._out)
            keys = json.loads(str(z["__keys__"]))
            return {k: z[f"a{i}"] for i, k in enumerate(keys)}
        finally:
            self._proc.kill()
            self._dir.cleanup()


def fresh_jax_call(module, func, **kw):
    """``module.func(**kw)`` in a fresh interpreter, waited for."""
    return JaxCall(module, func, **kw).result()


def own(state):
    """A JAX state with its own buffers: ``run_chunk`` donates its input,
    and an init state may hold module-level constants (churn's T_INF)."""
    return jax.tree_util.tree_map(lambda x: jnp.array(x, copy=True), state)


def jax_leaves(state, prefix=""):
    return {prefix + jax.tree_util.keystr(p): np.array(v) for p, v in
            jax.tree_util.tree_flatten_with_path(state)[0]}


def at(flat, tick):
    """The leaves of tick ``tick`` from a ``jax_*_states`` result."""
    head = f"{tick}|"
    return {k[len(head):]: v for k, v in flat.items() if k.startswith(head)}


def jax_states(sim, seed, ticks):
    """JAX leaves after each tick count in ``ticks`` (0 = the init state),
    stepping one tick at a time."""
    a, out, t = own(sim.init(seed=seed)), {}, 0
    for want in sorted(ticks):
        while t < want:
            a = sim.run_chunk(a, 1)
            t += 1
        out.update(jax_leaves(a, f"{t}|"))
    return out


def first_difference(fa, tb):
    """Name of the first leaf where the JAX leaves ``fa`` and the port
    state ``tb`` differ (None when equal)."""
    fb = interop.state_to_numpy(tb)
    if sorted(fa) != sorted(fb):
        return f"layout: {sorted(set(fa) ^ set(fb))}"
    for k in sorted(fa):
        x, y = fa[k], fb[k]
        if x.dtype != y.dtype or x.shape != y.shape or \
                not np.array_equal(x, y):
            return k
    return None


def _cfg(impl, n=16):
    return (dict(model="none", target_num=n, init_interval=0.1,
                 init_deviation=0.0),
            dict(window=0.010, inbox_slots=4, outbox_slots=8, pool_factor=8,
                 rmax=4, inbox_impl=impl))


def jax_ping_states(impl, seed, ticks):
    kw, ep = _cfg(impl)
    sim = jsim.Simulation(JPingLogic(), jchurn.ChurnParams(**kw),
                          jul.UnderlayParams(jitter=0.0),
                          jsim.EngineParams(**ep))
    return jax_states(sim, seed, ticks)


def port_sim(impl):
    kw, ep = _cfg(impl)
    return tsim.Simulation(TPingLogic(), tchurn.ChurnParams(**kw),
                           tul.UnderlayParams(jitter=0.0),
                           tsim.EngineParams(**ep), device="cpu")


@pytest.mark.parametrize("impl", ["scatter", "pallas"])
def test_ping_leaf_exact_64_ticks(impl):
    ref = fresh_jax_call("test_torch_engine", "jax_ping_states", impl=impl,
                         seed=3, ticks=[0, 64])
    ts = port_sim(impl)
    b = ts.init(seed=3)
    assert first_difference(at(ref, 0), b) is None
    b = ts.run_chunk(b, 64)
    assert first_difference(at(ref, 64), b) is None
    out = ts.summary(b)
    assert out["ping.sent"] > 0 and out["pong.received"] > 0


def test_run_until_device_matches_run_until():
    ts = port_sim("scatter")
    a = ts.run_until(ts.init(seed=5), 1.0, chunk=8)
    b = ts.run_until_device(ts.init(seed=5), 1.0, chunk=8)
    fa, fb = interop.state_to_numpy(a), interop.state_to_numpy(b)
    assert all(np.array_equal(fa[k], fb[k]) for k in fa)
    assert int(a.t_now) >= NS


def test_state_carry_round_trip():
    ref = fresh_jax_call("test_torch_engine", "jax_ping_states",
                         impl="scatter", seed=4, ticks=[20, 28])
    ts = port_sim("scatter")
    b = interop.state_from_numpy(at(ref, 20), ts)
    assert first_difference(at(ref, 20), b) is None
    b = ts.run_chunk(b, 8)
    assert first_difference(at(ref, 28), b) is None


def test_state_from_numpy_defaults_to_the_sim_device():
    """Without ``device`` the carried state lands on the simulation's own
    device (the CPU here), and ``state_to_numpy`` → ``state_from_numpy``
    gives back every leaf exactly, dtypes included."""
    ts = port_sim("scatter")
    a = ts.run_chunk(ts.init(seed=6), 4)
    flat = interop.state_to_numpy(a)
    b = interop.state_from_numpy(flat, ts)
    la, lb = tree.leaves_with_path(a), tree.leaves_with_path(b)
    assert [p for p, _ in la] == [p for p, _ in lb]
    for (path, x), (_, y) in zip(la, lb):
        assert y.device == ts.device, path
        assert x.dtype == y.dtype and torch.equal(x, y), path
    fb = interop.state_to_numpy(b)
    assert all(np.array_equal(flat[k], fb[k]) for k in flat)
