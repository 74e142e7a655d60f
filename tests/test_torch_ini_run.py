"""Ini-built runs and the three CLIs with ``--ini``: the port against the
JAX package on the CPU.

Each scenario is built from one ini text by both packages' builders
(``config/scenario.py build_simulation``).  The ini has no key for the
engine's two normal draws (the creation stagger's ``init_deviation`` and
the underlay's ``jitter``), whose erfinv the port matches only to a few
ulp (ROADMAP Queue C), so both packages' built simulations get them set
to 0 the same way (``zero_normals``; for the CLIs, a wrapper around each
package's ``build_simulation``).  Then:

(a) Kademlia under ParetoChurn (dense tick, scatter inbox) and
    RandomChurn (sparse tick, the kernels' plain versions), Chord under
    NoChurn (dense, the kernels' plain versions) and pareto_shifted
    LifetimeChurn (sparse, scatter): 48 ticks, every SimState leaf equal;
(b) ``python -m oversim_tpu_torch -f x.ini -c C --device cpu --json``
    against ``python -m oversim_tpu --platform cpu --json`` on the same
    ini, a ``${...}`` study expanded with ``--all-runs``: integer scalars
    equal, float scalars within 1e-12 relative (the port's statistics
    sums are sequential where XLA's tree differs, ROADMAP Queue C);
(c) ``python -m oversim_tpu_torch.campaign --ini`` against the JAX
    package's ``build_campaign`` run: the report, ints equal and floats
    within 1e-12 relative;
(d) ``python -m oversim_tpu_torch.service --ini`` (the ini's
    ``**.service.*`` keys, a final checkpoint) against the JAX package's
    ``build_simulation`` + ``build_service`` ``ServiceLoop``: every leaf
    of the checkpointed state equal.

The JAX side runs in one fresh interpreter (test_torch_engine.py says
why), started before the port's runs.
"""

import contextlib
import dataclasses
import io
import json
import textwrap

import numpy as np
import pytest
import torch

from oversim_tpu_torch.config import ini as tini
from oversim_tpu_torch.config import scenario as tsc
from test_torch_campaign import assert_json_close
from test_torch_engine import JaxCall, first_difference

torch.set_num_threads(1)

TICKS = 48
SEED = 3
KAD = '"oversim.overlay.kademlia.KademliaModules"'
CHORD = '"oversim.overlay.chord.ChordModules"'
INI = textwrap.dedent(f"""
    [General]
    **.overlayType = {KAD}
    **.tier1Type = "oversim.applications.kbrtestapp.KBRTestAppModules"
    **.tier1*.kbrTestApp.testMsgInterval = 0.5s
    **.targetOverlayTerminalNum = 8
    **.initPhaseCreationInterval = 0.1s
    **.lifetimeMean = 60s
    **.deadtimeMean = 40s

    [Config KadPareto]
    **.churnGeneratorTypes = "oversim.common.ParetoChurn"

    [Config KadRandom]
    **.churnGeneratorTypes = "oversim.common.RandomChurn"
    **.tickImpl = "sparse"
    **.inboxImpl = "pallas"

    [Config Chord]
    **.overlayType = {CHORD}
    **.inboxImpl = "pallas"

    [Config ChordShifted]
    **.overlayType = {CHORD}
    **.overlay*.chord.joinDelay = 1s
    **.churnGeneratorTypes = "oversim.common.LifetimeChurn"
    **.lifetimeDistName = "pareto_shifted"
    **.lifetimeDistPar1 = 3
    **.tickImpl = "sparse"

    [Config Cli]
    **.tier1*.kbrTestApp.testMsgInterval = ${{iv=0.5,1}}
    **.transitionTime = 1s

    [Config Camp]
    **.churnGeneratorTypes = "oversim.common.LifetimeChurn"
    **.campaign.replicas = 2
    **.campaign.baseSeed = 7
    **.campaign.sweep.lifetimeMean = "5, 50"

    [Config Svc]
    **.churnGeneratorTypes = "oversim.common.ParetoChurn"
    **.service.windowSimS = 0.5
    **.service.chunk = 8
    **.service.checkpointEvery = 2
    **.service.checkpointPath = "svc.npz"
""")
RUNS = ("KadPareto", "KadRandom", "Chord", "ChordShifted")
CLI = ["-c", "Cli", "--all-runs", "--until", "2.0", "--seed", "5", "--json"]
CAMP = dict(t=2.0, chunk=16)
SVC_WINDOWS = 4


def zero_normals(sim):
    """The two normal draws off (see the module docstring)."""
    sim.cp = dataclasses.replace(sim.cp, init_deviation=0.0)
    sim.up = dataclasses.replace(sim.up, jitter=0.0)
    return sim


def write_ini(path):
    path.write_text(INI)
    return str(path)


@contextlib.contextmanager
def normals_off(scenario, fresh_t_inf=False):
    """Every simulation ``scenario`` builds gets ``zero_normals``.  With
    ``fresh_t_inf`` (the JAX side) each build also gives the JAX churn
    module a fresh ``T_INF``: a JAX init state holds that constant and
    ``run_until`` donates it (ROADMAP Queue C), so the JAX CLI's second
    ``--all-runs`` run would otherwise start from a deleted buffer."""
    orig = scenario.build_simulation

    def build(*a, **kw):
        if fresh_t_inf:
            import jax.numpy as jnp
            from oversim_tpu import churn
            churn.T_INF = jnp.int64(2 ** 62)
        return zero_normals(orig(*a, **kw))

    scenario.build_simulation = build
    try:
        yield
    finally:
        scenario.build_simulation = orig


# -- the JAX side (one fresh interpreter) -------------------------------------

def jax_side(ini_path, part):
    """``part`` "runs": the four runs' leaves; "clis": the CLI, campaign
    and service references (two interpreters, run side by side)."""
    import jax
    from oversim_tpu import __main__ as jmain
    from oversim_tpu.config import ini as jini
    from oversim_tpu.config import scenario as jsc
    from oversim_tpu.service import ServiceLoop
    from test_torch_engine import own
    ini = jini.IniFile.load(ini_path)
    out = {}
    with normals_off(jsc, fresh_t_inf=True):
        for name in RUNS if part == "runs" else ():
            sim = jsc.build_simulation(ini, name)
            a = sim.run_chunk(own(sim.init(seed=SEED)), TICKS)
            for p, v in jax.tree_util.tree_flatten_with_path(a)[0]:
                out[f"{name}|{jax.tree_util.keystr(p)}"] = np.array(v)
        if part == "runs":
            return out
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            assert jmain.main(["-f", ini_path, *CLI,
                               "--platform", "cpu"]) == 0
        out["cli"] = np.array(buf.getvalue())
        camp = jsc.build_campaign(ini, "Camp")
        cs = camp.run_until_device(own(camp.init()), CAMP["t"],
                                   chunk=CAMP["chunk"])
        out["camp"] = np.array(json.dumps(camp.report(cs)))
        sim = jsc.build_simulation(ini, "Svc")
        params = dataclasses.replace(jsc.build_service(ini, "Svc"),
                                     checkpoint_every=0)
        final, done = ServiceLoop(sim, own(sim.init(seed=SEED)),
                                  params).run(n_windows=SVC_WINDOWS)
        assert done == SVC_WINDOWS
        for p, v in jax.tree_util.tree_flatten_with_path(final)[0]:
            out[f"svc|{jax.tree_util.keystr(p)}"] = np.array(v)
    return out


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    path = write_ini(tmp_path_factory.mktemp("ini") / "runs.ini")
    return path, [JaxCall("test_torch_ini_run", "jax_side", ini_path=path,
                          part=part) for part in ("runs", "clis")]


def at(flat, head):
    head += "|"
    return {k[len(head):]: v for k, v in flat.items() if k.startswith(head)}


@pytest.fixture(scope="module")
def jax_out(ref, port_runs):
    del port_runs           # stepped while the JAX side ran
    out = {}
    for call in ref[1]:
        out.update(call.result())
    return out


@pytest.fixture(scope="module")
def port_runs(ref):
    ini = tini.IniFile.load(ref[0])
    out = {}
    for name in RUNS:
        sim = zero_normals(tsc.build_simulation(ini, name, device="cpu"))
        out[name] = (sim, sim.run_chunk(sim.init(seed=SEED), TICKS))
    return out


@pytest.mark.parametrize("name", RUNS)
def test_ini_built_run_leaf_exact(jax_out, port_runs, name):
    sim, st = port_runs[name]
    assert first_difference(at(jax_out, name), st) is None
    out = sim.summary(st)
    assert out["kbr_sent"] > 0, out
    # the churn model's schedule is live: pending (re)births for Pareto
    # and the lifetime model, the next change tick for RandomChurn
    t_inf = tsc.churn_mod.T_INF
    if name == "KadRandom":
        assert int(st.churn.t_tick) < t_inf
    elif name != "Chord":
        assert int(st.churn.t_create.lt(t_inf).sum()) > 0


def test_cli_json_matches_jax_cli(ref, jax_out, capsys):
    from oversim_tpu_torch.__main__ import main
    with normals_off(tsc):
        assert main(["-f", ref[0], *CLI, "--device", "cpu"]) == 0
    got = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    want = [json.loads(x) for x in str(jax_out["cli"]).splitlines()]
    assert len(got) == len(want) == 2
    assert [r["run"] for r in got] == ["iv=0.5", "iv=1"]
    for g, w in zip(got, want):
        assert_json_close(g, w)
        assert g["_t_sim"] >= 2.0 and g["kbr_delivered"] > 0


def test_campaign_cli_ini_matches_jax_campaign(ref, jax_out, capsys):
    from oversim_tpu_torch.campaign.__main__ import main
    with normals_off(tsc):
        assert main(["--ini", ref[0], "--config", "Camp", "--device", "cpu",
                     "--t", str(CAMP["t"]),
                     "--chunk", str(CAMP["chunk"])]) == 0
    got = json.loads(capsys.readouterr().out.splitlines()[-1])
    want = json.loads(str(jax_out["camp"]))
    camp = got.pop("_campaign")
    w_camp = want.pop("_campaign")
    assert camp["s"] == w_camp["s"] == 4
    assert camp["grid"] == w_camp["grid"]
    assert_json_close(got, want)


def test_service_cli_ini_matches_jax_loop(ref, jax_out, tmp_path, capsys):
    from oversim_tpu_torch import checkpoint
    from oversim_tpu_torch.service.__main__ import main
    import os
    cwd = os.getcwd()
    os.chdir(tmp_path)
    try:
        with normals_off(tsc):
            assert main(["--ini", ref[0], "--config", "Svc", "--device",
                         "cpu", "--windows", str(SVC_WINDOWS),
                         "--seed", str(SEED)]) == 0
    finally:
        os.chdir(cwd)
    recs = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    assert recs[-1]["windows_done"] == SVC_WINDOWS
    assert recs[-1]["last_checkpoint"] == SVC_WINDOWS
    flat, meta = checkpoint.load_raw(str(tmp_path / "svc.npz"))
    want = at(jax_out, "svc")
    assert sorted(flat) == sorted(want)
    bad = [k for k in want if not (flat[k].dtype == want[k].dtype
                                   and np.array_equal(flat[k], want[k]))]
    assert not bad, bad[:5]
    assert meta["tick"] == int(want[".tick"])
