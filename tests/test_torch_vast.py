"""Vast and Quon on both packages, leaf-exact, from fresh starts and
carried states.

The runs (every SimState leaf compared, float32 included, tolerance 0)
use 16 target nodes over an 8 s ramp, ``EngineParams(window=0.1,
inbox_slots=4, pool_factor=4)``, ``init_deviation = jitter = 0`` (the
engine's normal draws, where PyTorch's erfinv cannot match XLA's bit for
bit) and shorter timers than the defaults (``VP``: moves every 2 s, a
6 s soft-state timeout), so that the prune runs inside the ticks:

(a) each overlay under NoChurn on the dense tick and under
    LifetimeChurn (mean 20 s) on the sparse tick (held against the JAX
    package's sparse tick), 160 ticks from a fresh start;
(b) the JAX state at 60 ticks carried into the port for 100 more, with
    BYE notices put into both packages' pools first (nothing in either
    package sends one: the reference's graceful leave does), held
    against the JAX package's run from the same state;
(c) both overlays built from an ini by both packages' builders (the
    AOI width off its default);
(d) the kernels' plain versions (``inbox_impl="pallas"`` on the CPU)
    against the scatter inbox on the sparse tick.

Inside the compared ticks the port's side counts, and each run requires,
a JOIN forwarded greedily, a HINT received and a neighbor pruned for its
silence; the carried runs also a BYE that removed a neighbor.  The JAX
runs go one after another in one fresh interpreter (``JaxCall``;
test_torch_engine.py says why) while the port steps.
"""

import contextlib
import textwrap

import numpy as np
import pytest
import torch

from oversim_tpu_torch import churn as tchurn
from oversim_tpu_torch import interop
from oversim_tpu_torch.engine import pool as tpool
from oversim_tpu_torch.engine import sim as tsim
from oversim_tpu_torch.overlay import quon as tquon
from oversim_tpu_torch.overlay import vast as tvast
from oversim_tpu_torch.underlay import simple as tul
from test_torch_engine import first_difference
from test_torch_ini_run import zero_normals
from test_torch_pastry import SEED, at, finish, start_jax

torch.set_num_threads(1)

TICKS = 160
CARRY = 60
VP = dict(move_interval=2.0, join_delay=2.0, nbr_timeout=6.0, hint_prob=0.5)
NOCHURN = dict(model="none", target_num=16, init_interval=0.5,
               init_deviation=0.0)
LIFETIME = dict(model="lifetime", target_num=16, init_interval=0.5,
                init_deviation=0.0, lifetime_mean=20.0,
                graceful_leave_delay=1.0)
EP = dict(window=0.1, inbox_slots=4, pool_factor=4)
# run name -> (overlay, churn, tick impl, ticks kept)
RUNS = {f"{ov}_{impl}": (ov, cp, impl, (0, CARRY, TICKS))
        for ov in ("vast", "quon")
        for cp, impl in ((NOCHURN, "dense"), (LIFETIME, "sparse"))}
RUNS.update({f"{ov}_ini": (ov, None, "dense", (TICKS,))
             for ov in ("vast", "quon")})
BYE_NODES = 4


def ini_text(ov):
    return textwrap.dedent(f"""\
        [General]
        **.overlayType = "oversim.overlay.{ov}.{ov.capitalize()}Modules"
        **.targetOverlayTerminalNum = 16
        **.initPhaseCreationInterval = 0.5
        **.overlay.{ov}.AOIWidth = 80
        """)


def _ep(name, impl="scatter"):
    return dict(EP, tick_impl=RUNS[name][2], inbox_impl=impl)


def ini_sim(pkg, name):
    if pkg == "jax":
        from oversim_tpu.config import ini, scenario
        from oversim_tpu.engine import sim
    else:
        from oversim_tpu_torch.config import ini, scenario
        sim = tsim
    kw = {} if pkg == "jax" else {"device": "cpu"}
    return zero_normals(scenario.build_simulation(
        ini.IniFile.loads(ini_text(RUNS[name][0])), "General",
        engine_params=sim.EngineParams(**_ep(name)), **kw))


def port_sim(name, impl="scatter"):
    ov, cp, _, _ = RUNS[name]
    cls = tvast.VastLogic if ov == "vast" else tquon.QuonLogic
    params = (tvast.VastParams if ov == "vast" else tquon.QuonParams)(**VP)
    return tsim.Simulation(cls(params=params), tchurn.ChurnParams(**cp),
                           tul.UnderlayParams(jitter=0.0),
                           tsim.EngineParams(**_ep(name, impl)),
                           device="cpu")


def jax_sim(name):
    from oversim_tpu import churn as jchurn
    from oversim_tpu.engine import sim as jsim
    from oversim_tpu.overlay import quon as jquon
    from oversim_tpu.overlay import vast as jvast
    from oversim_tpu.underlay import simple as jul
    ov, cp, _, _ = RUNS[name]
    if cp is None:
        return ini_sim("jax", name)
    cls = jvast.VastLogic if ov == "vast" else jquon.QuonLogic
    params = (jvast.VastParams if ov == "vast" else jquon.QuonParams)(**VP)
    return jsim.Simulation(cls(params=params), jchurn.ChurnParams(**cp),
                           jul.UnderlayParams(jitter=0.0),
                           jsim.EngineParams(**_ep(name)))


def with_byes(flat):
    """``flat`` with a BYE from a neighbor to each of the first
    ``BYE_NODES`` READY nodes that have one, in the pool's first free
    slots, due 1 ms after the state's time."""
    flat = {k: np.array(v) for k, v in flat.items()}
    valid, blk = flat[".pool.valid"], flat[".pool.blk"]
    col = {n: i for i, n in enumerate(tpool.SCAL_COLS)}
    free = np.nonzero(~valid)[0]
    ready = np.nonzero((flat[".logic.state"] == tvast.READY)
                       & flat[".alive"])[0]
    k = 0
    for i in ready:
        nbrs = flat[".logic.nbr"][i]
        if k == BYE_NODES or not (nbrs >= 0).any():
            continue
        slot = free[k]
        valid[slot] = True
        flat[".pool.t_deliver"][slot] = flat[".t_now"] + 1_000_000
        flat[".pool.stamp"][slot] = flat[".t_now"]
        blk[slot, :len(tpool.SCAL_COLS)] = 0
        blk[slot, col["src"]] = nbrs[nbrs >= 0][0]
        blk[slot, col["dst"]] = i
        blk[slot, col["kind"]] = tvast.V_BYE
        k += 1
    assert k == BYE_NODES
    return flat


def jax_vast_runs(seed, names):
    """Each run's leaves at its kept ticks, and for the runs kept at
    ``CARRY`` the state there with ``with_byes``' notices (``carry``)
    and that state stepped to ``TICKS`` (``bye``)."""
    import jax
    import jax.numpy as jnp
    from test_torch_engine import jax_leaves, own
    out = {}
    for name in names:
        sim = jax_sim(name)
        a, t = own(sim.init(seed=seed)), 0
        carried = None
        for want in RUNS[name][3]:
            while t < want:
                a = sim.run_chunk(a, 1)
                t += 1
            flat = jax_leaves(a)
            out.update({f"{name}/{t}|{k}": v for k, v in flat.items()})
            if t == CARRY:
                carried = with_byes(flat)
        if carried is None:
            continue
        paths, treedef = jax.tree_util.tree_flatten_with_path(a)
        b = jax.tree_util.tree_unflatten(treedef, [
            jnp.array(carried[jax.tree_util.keystr(p)]) for p, _ in paths])
        for _ in range(TICKS - CARRY):
            b = sim.run_chunk(b, 1)     # the one-tick program, compiled
        out.update({f"{name}/carry|{k}": v for k, v in carried.items()})
        out.update({f"{name}/bye|{k}": v for k, v in jax_leaves(b).items()})
    return out


BRANCHES = ("join_forwarded", "hint_received", "pruned")


@contextlib.contextmanager
def spies():
    """Count, while the port steps, JOINs forwarded, HINTs received at
    READY nodes, neighbors pruned and neighbors removed by a BYE."""
    seen = dict.fromkeys(BRANCHES + ("bye_removed",), 0)
    step, prune = tvast.VastLogic.step, tvast.VastLogic._prune

    def spy_step(self, ctx, st, msgs, rng, node_idx, **kw):
        out = step(self, ctx, st, msgs, rng, node_idx, **kw)
        seen["join_forwarded"] += int(out[2][
            f"c:{self.PREFIX}_join_fwd"].sum())
        ready = (st.state == tvast.READY)[:, None]
        seen["hint_received"] += int((msgs.valid & ready & (
            msgs.kind == tvast.V_HINT)).sum())
        bye = msgs.valid & (msgs.kind == tvast.V_BYE)
        gone = ~torch.any(out[0].nbr[:, None, :] == msgs.src[:, :, None], -1)
        was = torch.any(st.nbr[:, None, :] == msgs.src[:, :, None], -1)
        seen["bye_removed"] += int((bye & was & gone).sum())
        return out

    def spy_prune(self, ctx, st, t0, t_end):
        out = prune(self, ctx, st, t0, t_end)
        seen["pruned"] += int(((st.nbr >= 0) & (out.nbr < 0)).sum())
        return out

    tvast.VastLogic.step, tvast.VastLogic._prune = spy_step, spy_prune
    try:
        yield seen
    finally:
        tvast.VastLogic.step, tvast.VastLogic._prune = step, prune


def stepped(sim, s, ticks):
    with spies() as seen:
        for _ in range(ticks):
            s = sim.run_chunk(s, 1)
    return s, seen


def assert_worked(sim, state, seen, bye=False):
    missing = [k for k in BRANCHES if seen[k] <= 0]
    assert not missing, seen
    if bye:
        assert seen["bye_removed"] > 0, seen
    out = sim.summary(state)
    x = sim.logic.PREFIX
    assert out[f"{x}_moves"] > 0 and out[f"{x}_updates"] > 0, out
    eng = out["_engine"]
    assert eng["pool_overflow"] == 0 and eng["outbox_overflow"] == 0, eng


@pytest.fixture(scope="module")
def runs():
    calls = start_jax("test_torch_vast", RUNS, func="jax_vast_runs")
    port = {}
    for name, (_, cp, _, _) in RUNS.items():
        if cp is not None:
            sim = port_sim(name)
            s0 = sim.init(SEED)
            port[name] = (sim, s0) + stepped(sim, s0, TICKS)
    return finish(calls, port)


@pytest.mark.parametrize("ov", ["vast", "quon"])
def test_fresh_start_leaf_exact(runs, ov):
    ref, port = runs
    for impl in ("dense", "sparse"):
        name = f"{ov}_{impl}"
        sim, s0, b, seen = port[name]
        assert first_difference(at(ref, name, 0), s0) is None, name
        assert first_difference(at(ref, name, TICKS), b) is None, name
        assert_worked(sim, b, seen)


@pytest.mark.parametrize("ov", ["vast", "quon"])
def test_carried_state_leaf_exact_with_byes(runs, ov):
    ref, _ = runs
    for impl in ("dense", "sparse"):
        name = f"{ov}_{impl}"
        sim = port_sim(name)
        b = interop.state_from_numpy(at(ref, name, "carry"), sim, "cpu")
        assert int((b.pool.kind == tvast.V_BYE).sum()) == BYE_NODES
        b, seen = stepped(sim, b, TICKS - CARRY)
        assert first_difference(at(ref, name, "bye"), b) is None, name
        assert_worked(sim, b, seen, bye=True)


def test_ini_built_leaf_exact(runs):
    ref, _ = runs
    for ov, cls in (("vast", tvast.VastLogic), ("quon", tquon.QuonLogic)):
        sim = ini_sim("torch", f"{ov}_ini")
        assert type(sim.logic) is cls and sim.logic.p.aoi == 80.0
        b = sim.run_chunk(sim.init(SEED), TICKS)
        assert first_difference(at(ref, f"{ov}_ini", TICKS), b) is None, ov
        assert sim.summary(b)[f"{ov}_updates"] > 0


def test_kernel_plain_versions_match_scatter(runs):
    """The kernels' plain versions (inbox selection, pool allocation and
    the active-set compaction) step every leaf as the scatter inbox
    does, on the sparse tick."""
    _, port = runs
    for ov in ("vast", "quon"):
        _, s0, b, _ = port[f"{ov}_sparse"]
        c = port_sim(f"{ov}_sparse", impl="pallas").run_chunk(s0, TICKS)
        fb, fc = interop.state_to_numpy(b), interop.state_to_numpy(c)
        bad = [k for k in fb if not np.array_equal(fb[k], fc[k])]
        assert not bad, (ov, bad[:5])
