"""Chord + KBRTest on both packages, leaf-exact.

bench.py's Chord configuration at N=16 — ``ChordLogic(lcfg=
LookupConfig(slots=8))`` (replace-mode lookups, Vivaldi coordinates,
the NeighborCache RTT estimator with adaptive RPC timeouts),
``KbrTestParams(test_interval=0.2)``, NoChurn over a 20 s join ramp,
``EngineParams(window=0.2, inbox_slots=8, pool_factor=8)`` — with
``init_deviation=0`` and ``jitter=0`` (the engine's two normal draws,
where PyTorch's erfinv cannot match XLA's bit for bit):

(a) 128 ticks (past the ramp, lookups flowing) from a fresh start: every
    SimState leaf equal, float32 coordinates and RTT estimates
    included, with ``inbox_impl="scatter"`` and with ``"pallas"`` (the
    JAX package's Pallas kernels in interpret mode against the port's
    plain kernel versions);
(b) carried state: the JAX state after 100 ticks is loaded into the port
    and both engines step 8 more ticks: every leaf equal;
(c) the sparse tick under lifetime churn, in test_torch_chord_sparse.py;
(d) the default deviation and jitter, in test_torch_chord_floats.py.

The three files split the JAX runs (about 25 s each after an 8 s start)
so that none takes much over a minute and a half; each file's JAX runs
happen in one fresh interpreter (test_torch_engine.py ``fresh_jax_call``
says why).  The helpers here serve all three.
"""

import numpy as np
import pytest
import torch

from oversim_tpu_torch import churn as tchurn
from oversim_tpu_torch import interop
from oversim_tpu_torch.apps import kbrtest as tkbr
from oversim_tpu_torch.common import lookup as tlk
from oversim_tpu_torch.engine import sim as tsim
from oversim_tpu_torch.overlay.chord import ChordLogic as TChord
from oversim_tpu_torch.underlay import simple as tul
from test_torch_engine import first_difference, fresh_jax_call, own

# tiny tensors: one intra-op thread keeps parallel test workers from
# oversubscribing the host
torch.set_num_threads(1)

N = 16
SEED = 3
TICKS = 128
CARRY = 100
SPARSE_TICKS = 64
SPARSE_CP = dict(model="lifetime", target_num=12, init_interval=0.2,
                 init_deviation=0.0, lifetime_mean=8.0,
                 graceful_leave_delay=1.0)
# run name -> (configuration, inbox_impl, tick_impl, active_cap, ticks)
RUNS = {"scatter": ("bench", "scatter", "dense", 0, (0, CARRY, CARRY + 8,
                                                     TICKS)),
        "pallas": ("bench", "pallas", "dense", 0, (TICKS,)),
        "sparse": ("churn", "scatter", "sparse", 0, (0, SPARSE_TICKS)),
        "cap2": ("churn", "scatter", "sparse", 2, (SPARSE_TICKS,))}


def _params(cfg, impl, tick_impl, cap, deviation=0.0, jitter=0.0):
    """(KBRTest interval, churn, underlay and engine keyword dicts)."""
    if cfg == "bench":
        cp = dict(model="none", target_num=N, init_interval=20.0 / N,
                  init_deviation=deviation)
        ep = dict(window=0.2, inbox_slots=8, pool_factor=8)
        interval = 0.2
    else:
        cp, ep, interval = dict(SPARSE_CP), dict(window=0.1, inbox_slots=4,
                                                 pool_factor=4), 1.0
    ep.update(inbox_impl=impl, tick_impl=tick_impl, active_cap=cap)
    return interval, cp, dict(jitter=jitter), ep


def port_sim(cfg="bench", impl="scatter", tick_impl="dense", cap=0,
             deviation=0.0, jitter=0.0, device="cpu"):
    interval, cp, up, ep = _params(cfg, impl, tick_impl, cap, deviation,
                                   jitter)
    return tsim.Simulation(
        TChord(app=tkbr.KbrTestApp(tkbr.KbrTestParams(test_interval=interval)),
               lcfg=tlk.LookupConfig(slots=8)),
        tchurn.ChurnParams(**cp), tul.UnderlayParams(**up),
        tsim.EngineParams(**ep), device=device)


def jax_sim(cfg="bench", impl="scatter", tick_impl="dense", cap=0,
            deviation=0.0, jitter=0.0):
    from oversim_tpu import churn as jchurn
    from oversim_tpu.apps import kbrtest as jkbr
    from oversim_tpu.common import lookup as jlk
    from oversim_tpu.engine import sim as jsim
    from oversim_tpu.overlay.chord import ChordLogic as JChord
    from oversim_tpu.underlay import simple as jul
    interval, cp, up, ep = _params(cfg, impl, tick_impl, cap, deviation,
                                   jitter)
    return jsim.Simulation(
        JChord(app=jkbr.KbrTestApp(jkbr.KbrTestParams(test_interval=interval)),
               lcfg=jlk.LookupConfig(slots=8)),
        jchurn.ChurnParams(**cp), jul.UnderlayParams(**up),
        jsim.EngineParams(**ep))


def jax_chord_runs(seed, runs):
    """``{run/tick|path: leaf}`` for each run of ``runs`` (names of RUNS)
    stepped one tick at a time."""
    import jax
    out = {}
    for name in runs:
        cfg, impl, tick_impl, cap, ticks = RUNS[name]
        sim = jax_sim(cfg, impl, tick_impl, cap)
        a, t = own(sim.init(seed=seed)), 0
        for want in ticks:
            while t < want:
                a = sim.run_chunk(a, 1)
                t += 1
            for p, v in jax.tree_util.tree_flatten_with_path(a)[0]:
                out[f"{name}/{t}|{jax.tree_util.keystr(p)}"] = np.array(v)
    return out


def jax_chord_summary(seed, t_end_ns):
    """End-of-run statistics with the default deviation and jitter."""
    sim = jax_sim(deviation=2.0 / N, jitter=0.1)
    a = own(sim.init(seed=seed))
    while int(a.t_now) < t_end_ns:
        a = sim.run_chunk(a, 1)
    out = sim.summary(a)
    return {"alive": out["_alive"], "kbr_sent": out["kbr_sent"],
            "kbr_delivered": out["kbr_delivered"],
            "lookup_hops": out["lookup_hops"]["mean"]}


def at(flat, name, tick):
    head = f"{name}/{tick}|"
    return {k[len(head):]: v for k, v in flat.items() if k.startswith(head)}


@pytest.fixture(scope="module")
def ref():
    return fresh_jax_call("test_torch_chord", "jax_chord_runs", seed=SEED,
                          runs=["scatter", "pallas"])


def port_run(name):
    cfg, impl, tick_impl, cap, ticks = RUNS[name]
    sim = port_sim(cfg, impl, tick_impl, cap)
    return sim, sim.run_chunk(sim.init(SEED), max(ticks))


def test_fresh_start_leaf_exact_128_ticks(ref):
    sim, b = port_run("scatter")
    assert first_difference(at(ref, "scatter", 0), sim.init(SEED)) is None
    assert first_difference(at(ref, "scatter", TICKS), b) is None
    out = sim.summary(b)
    assert out["_ticks"] == TICKS and out["_alive"] == N
    assert bool((b.logic.state == 2).all()) and out["kbr_delivered"] > 0
    # the predecessor pings moved the coordinates and filled the cache
    assert bool((b.logic.nc.rtt_mean > 0).any())
    assert bool((b.logic.ncs.error < 1.0).any())


def test_fresh_start_leaf_exact_128_ticks_pallas(ref):
    sim, b = port_run("pallas")
    assert first_difference(at(ref, "pallas", TICKS), b) is None


def test_carried_state_leaf_exact(ref):
    sim = port_sim()
    b = interop.state_from_numpy(at(ref, "scatter", CARRY), sim, "cpu")
    assert first_difference(at(ref, "scatter", CARRY), b) is None
    b = sim.run_chunk(b, 8)
    assert first_difference(at(ref, "scatter", CARRY + 8), b) is None
