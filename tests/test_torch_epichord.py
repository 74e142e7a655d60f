"""EpiChord + KBRTest on both packages, leaf-exact at 64-bit keys.

The runs (every SimState leaf compared, float32 included, tolerance 0)
use 12 target nodes under LifetimeChurn (24 slots, lifetime mean 20 s),
``EngineParams(window=0.1, inbox_slots=4, pool_factor=4)``, KBRTest's
one-way and RPC tests every 1 s and ``init_deviation = jitter = 0`` (the
engine's normal draws, where PyTorch's erfinv cannot match XLA's bit for
bit).  EpiChord's eight parameters are off their defaults (``FAST``:
3 successors, joinDelay 2 s, stabilizeDelay 2 s, cacheFlushDelay 1 s,
a slice check every third flush, cacheTTL 4 s, 3 nodes per slice, 2
redundant nodes) so that stabilize, cache expiry and the slice check all
run inside 12 s:

(a) iterative lookups (merge mode) from a fresh start, 120 ticks, on the
    scatter inbox and on the kernels' plain versions
    (``inbox_impl="pallas"`` on CPU tensors), both against the JAX
    package's scatter run; and the JAX state at 40 ticks carried into the
    port for 80 more;
(b) the sparse tick at the auto cap, 120 ticks;
(c) semi-recursive routing with per-hop ACKs, and the full and source
    modes, 120 ticks each;
(d) (a)'s scenario built from an ini by config/scenario.py (the eight
    ``overlay.epichord.*`` keys at ``FAST``'s values), against (a)'s JAX
    run.

Inside the compared ticks each run shows, on the port's side, joins,
slice lookups, KBRTest deliveries and no wrong-node delivery.  The JAX
programs run one after another in one fresh interpreter (``JaxCall``;
test_torch_engine.py says why) while the port steps.
"""

import textwrap

import pytest
import torch

import chip_smoke
from oversim_tpu_torch import churn as tchurn
from oversim_tpu_torch import interop
from oversim_tpu_torch.engine import sim as tsim
from oversim_tpu_torch.overlay import epichord as tep
from oversim_tpu_torch.underlay import simple as tul
from test_torch_engine import first_difference
from test_torch_ini_run import zero_normals
from test_torch_pastry import EP, SEED, at, finish, jax_leaves_at, start_jax

torch.set_num_threads(1)

TICKS = 120
CARRY = 40
SPEC_BITS = 64
# EpiChord's eight ini parameters, none at its default, and the ini's
# churn (LifetimeChurn, graceful leave at its 15 s default)
FAST = chip_smoke.EPI_FAST
CP = dict(model="lifetime", target_num=12, init_interval=0.2,
          init_deviation=0.0, lifetime_mean=chip_smoke.EPI_LIFETIME_S)
# run name -> (routing mode, tick impl, ticks kept)
RUNS = {"iter": (None, "dense", (0, CARRY, TICKS)),
        "sparse": (None, "sparse", (0, TICKS)),
        "semi": ("semi", "dense", (TICKS,)),
        "full": ("full", "dense", (TICKS,)),
        "source": ("source", "dense", (TICKS,))}

INI = textwrap.dedent("""\
    [General]
    network = oversim.underlay.simpleunderlay.SimpleUnderlayNetwork
    **.overlayType = "oversim.overlay.epichord.EpiChordModules"
    **.tier1Type = "oversim.applications.kbrtestapp.KBRTestAppModules"
    **.keyLength = 64
    **.targetOverlayTerminalNum = 12
    **.initPhaseCreationInterval = 0.2
    **.churnGeneratorTypes = "oversim.common.LifetimeChurn"
    **.lifetimeMean = 20
    **.overlay.epichord.successorListSize = 3
    **.overlay.epichord.joinDelay = 2
    **.overlay.epichord.stabilizeDelay = 2
    **.overlay.epichord.cacheFlushDelay = 1
    **.overlay.epichord.cacheCheckMultiplier = 2
    **.overlay.epichord.cacheTTL = 4
    **.overlay.epichord.nodesPerSlice = 3
    **.overlay.epichord.lookupRedundantNodes = 2
    **.tier1.kbrTestApp.testMsgInterval = 1
    **.tier1.kbrTestApp.kbrRpcTest = true
    """)


def _logic(pkg, name):
    mode = RUNS[name][0]
    if pkg == "jax":
        from oversim_tpu.apps import kbrtest as kb
        from oversim_tpu.common import route as rt
        from oversim_tpu.core import keys as keys
        from oversim_tpu.overlay import epichord as ep
    else:
        from oversim_tpu_torch.apps import kbrtest as kb
        from oversim_tpu_torch.common import route as rt
        from oversim_tpu_torch.core import keys as keys
        ep = tep
    rcfg = rt.RouteConfig(mode=mode) if mode else None
    app = kb.KbrTestApp(kb.KbrTestParams(test_interval=1.0, rpc_test=True),
                        rcfg=rcfg)
    return ep.EpiChordLogic(keys.KeySpec(SPEC_BITS),
                            ep.EpiChordParams(**FAST), app=app, rcfg=rcfg)


def _ep(name, impl="scatter"):
    return dict(EP, tick_impl=RUNS[name][1], inbox_impl=impl)


def port_sim(name, device="cpu", impl="scatter"):
    return tsim.Simulation(_logic("torch", name), tchurn.ChurnParams(**CP),
                           tul.UnderlayParams(jitter=0.0),
                           tsim.EngineParams(**_ep(name, impl)),
                           device=device)


def ini_sim():
    """The iterative run's scenario built from ``INI`` by the port's
    ``build_simulation``, with the runs' engine parameters (the JAX
    package's ``build_simulation`` tests ``"chord" in overlayType``
    before EpiChord's branch, so an EpiChord module type reaches its
    Chord branch: ROADMAP Queue C)."""
    from oversim_tpu_torch.config import ini as tini
    from oversim_tpu_torch.config import scenario as tsc
    return zero_normals(tsc.build_simulation(
        tini.IniFile.loads(INI), "General",
        engine_params=tsim.EngineParams(**_ep("iter")), device="cpu"))


def jax_sim(name):
    from oversim_tpu import churn as jchurn
    from oversim_tpu.engine import sim as jsim
    from oversim_tpu.underlay import simple as jul
    return jsim.Simulation(_logic("jax", name), jchurn.ChurnParams(**CP),
                           jul.UnderlayParams(jitter=0.0),
                           jsim.EngineParams(**_ep(name)))


def jax_epichord_runs(seed, names):
    out = {}
    for name in names:
        out.update(jax_leaves_at(jax_sim(name), seed, RUNS[name][2], name))
    return out


def stepped(sim, s, ticks):
    for _ in range(ticks):
        s = sim.run_chunk(s, 1)
    return s


@pytest.fixture(scope="module")
def runs():
    calls = start_jax("test_torch_epichord", RUNS, func="jax_epichord_runs")
    port = {}
    for name, (_, _, ticks) in RUNS.items():
        sim = port_sim(name)
        s0 = sim.init(SEED)
        port[name] = (sim, s0, stepped(sim, s0, max(ticks)))
    return finish(calls, port)


def assert_epichord_worked(sim, state):
    out = sim.summary(state)
    assert out["epi_joins"] > 0 and out["epi_slice_lookups"] > 0, out
    assert out["kbr_delivered"] > 0 and out["kbr_wrong_node"] == 0, out
    assert out["lookup_success"] > 0, out
    return out


def test_iterative_fresh_start_and_carried_state_leaf_exact(runs):
    ref, port = runs
    sim, s0, b = port["iter"]
    assert first_difference(at(ref, "iter", 0), s0) is None
    assert first_difference(at(ref, "iter", TICKS), b) is None
    assert_epichord_worked(sim, b)
    assert not bool(b.logic.rr.active.any())
    # the JAX state at CARRY ticks, carried into the port
    c = interop.state_from_numpy(at(ref, "iter", CARRY), sim, "cpu")
    assert first_difference(at(ref, "iter", CARRY), c) is None
    c = stepped(sim, c, TICKS - CARRY)
    assert first_difference(at(ref, "iter", TICKS), c) is None


def test_kernel_plain_versions_leaf_exact(runs):
    ref, _ = runs
    sim = port_sim("iter", impl="pallas")
    b = stepped(sim, sim.init(SEED), TICKS)
    assert first_difference(at(ref, "iter", TICKS), b) is None
    assert_epichord_worked(sim, b)


def test_sparse_tick_leaf_exact(runs):
    ref, port = runs
    sim, s0, b = port["sparse"]
    assert first_difference(at(ref, "sparse", 0), s0) is None
    assert first_difference(at(ref, "sparse", TICKS), b) is None
    out = assert_epichord_worked(sim, b)
    assert 0 < out["_engine"]["awake_nodes"] < TICKS * sim.n


def test_semi_recursive_leaf_exact(runs):
    ref, port = runs
    sim, _, b = port["semi"]
    assert first_difference(at(ref, "semi", TICKS), b) is None
    assert_epichord_worked(sim, b)
    # routed payloads were parked for their ACKs
    assert int(b.logic.rr.gen.sum()) > 0


def test_full_and_source_recursive_leaf_exact(runs):
    ref, port = runs
    for name in ("full", "source"):
        sim, _, b = port[name]
        assert first_difference(at(ref, name, TICKS), b) is None, name
        assert_epichord_worked(sim, b)
        assert sim.summary(b)["kbr_rpc_success"] > 0, name


def test_ini_built_leaf_exact(runs):
    ref, _ = runs
    sim = ini_sim()
    assert sim.logic.p == tep.EpiChordParams(**FAST)
    assert sim.logic.lcfg.merge and sim.logic.rcfg is None
    b = stepped(sim, sim.init(SEED), TICKS)
    assert first_difference(at(ref, "iter", TICKS), b) is None
    assert_epichord_worked(sim, b)
