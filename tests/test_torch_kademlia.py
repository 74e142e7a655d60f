"""The slice as a whole: Kademlia + KBRTest on both packages, leaf-exact.

bench.py's configuration at N=16 — ``LookupConfig(slots=8, merge=True)``,
``KbrTestParams(test_interval=0.2)``, NoChurn over a 20 s join ramp,
``EngineParams(window=0.2, inbox_slots=8, pool_factor=8)`` — with
``init_deviation=0`` and ``jitter=0`` (the engine's two normal draws,
where PyTorch's erfinv cannot match XLA's bit for bit).

(a) 128 ticks (25.6 simulated s, past the ramp, lookups flowing) from a
    fresh start: every SimState leaf equal, ``inbox_impl="scatter"``
    here and ``"pallas"`` in test_torch_kademlia_pallas.py;
(b) carried state: the JAX state after 100 ticks is loaded into the port
    (``interop.state_from_numpy``) and both engines step 8 more ticks:
    every leaf equal.

The JAX side runs in a fresh interpreter (test_torch_engine.py
``fresh_jax_call`` says why).
"""

import pytest
import torch

from oversim_tpu import churn as jchurn
from oversim_tpu.apps import kbrtest as jkbr
from oversim_tpu.common import lookup as jlk
from oversim_tpu.engine import sim as jsim
from oversim_tpu.overlay.kademlia import KademliaLogic as JKademlia
from oversim_tpu.underlay import simple as jul
from oversim_tpu_torch import churn as tchurn
from oversim_tpu_torch import interop
from oversim_tpu_torch.apps import kbrtest as tkbr
from oversim_tpu_torch.common import lookup as tlk
from oversim_tpu_torch.engine import sim as tsim
from oversim_tpu_torch.overlay.kademlia import KademliaLogic as TKademlia
from oversim_tpu_torch.underlay import simple as tul
from test_torch_engine import (JaxCall, at, first_difference, jax_states,
                               own)

# tiny tensors: one intra-op thread keeps parallel test workers from
# oversubscribing the host
torch.set_num_threads(1)

N = 16
SEED = 3


def bench_sims(impl, n=N, deviation=0.0, jitter=0.0):
    cp = dict(model="none", target_num=n, init_interval=20.0 / n,
              init_deviation=deviation)
    ep = dict(window=0.2, inbox_slots=8, pool_factor=8, inbox_impl=impl)
    js = jsim.Simulation(
        JKademlia(app=jkbr.KbrTestApp(jkbr.KbrTestParams(test_interval=0.2)),
                  lcfg=jlk.LookupConfig(slots=8, merge=True)),
        jchurn.ChurnParams(**cp), jul.UnderlayParams(jitter=jitter),
        jsim.EngineParams(**ep))
    ts = tsim.Simulation(
        TKademlia(app=tkbr.KbrTestApp(tkbr.KbrTestParams(test_interval=0.2)),
                  lcfg=tlk.LookupConfig(slots=8, merge=True)),
        tchurn.ChurnParams(**cp), tul.UnderlayParams(jitter=jitter),
        tsim.EngineParams(**ep), device="cpu")
    return js, ts


def jax_bench_states(impl, seed, ticks, n=N, deviation=0.0, jitter=0.0):
    js, _ = bench_sims(impl, n, deviation, jitter)
    return jax_states(js, seed, ticks)


def jax_bench_summary(seed, t_end_ns, deviation, jitter):
    js, _ = bench_sims("scatter", N, deviation, jitter)
    a = own(js.init(seed=seed))
    while int(a.t_now) < t_end_ns:
        a = js.run_chunk(a, 1)
    out = js.summary(a)
    return {"alive": out["_alive"], "kbr_sent": out["kbr_sent"],
            "kbr_delivered": out["kbr_delivered"],
            "lookup_hops": out["lookup_hops"]["mean"]}


@pytest.fixture(scope="module")
def scatter_run():
    """JAX leaves at 0, 100, 108 and 128 ticks; the port stepped tick by
    tick to 128."""
    call = JaxCall("test_torch_kademlia", "jax_bench_states",
                   impl="scatter", seed=SEED, ticks=[0, 100, 108, 128])
    _, ts = bench_sims("scatter")
    b0 = b = ts.init(seed=SEED)
    for _ in range(128):
        b = ts.step(b)
    ref = call.result()
    return dict(ts=ts, init_diff=first_difference(at(ref, 0), b0), ref=ref,
                port=b)


def test_fresh_start_leaf_exact_128_ticks(scatter_run):
    assert scatter_run["init_diff"] is None
    assert first_difference(at(scatter_run["ref"], 128),
                            scatter_run["port"]) is None
    out = scatter_run["ts"].summary(scatter_run["port"])
    assert out["_ticks"] == 128 and out["_t_sim"] > 25.0
    assert out["_alive"] == N and out["kbr_sent"] > 100
    assert out["kbr_delivered"] > 0.8 * out["kbr_sent"]


def test_carried_state_leaf_exact(scatter_run):
    ts, ref = scatter_run["ts"], scatter_run["ref"]
    b = interop.state_from_numpy(at(ref, 100), ts, "cpu")
    assert first_difference(at(ref, 100), b) is None
    b = ts.run_chunk(b, 8)
    assert first_difference(at(ref, 108), b) is None
