"""The telemetry rings and the campaign CLI against the JAX package.

- ``fold`` on the same inputs as JAX's ``telemetry.fold``: the sampling
  cadence, the ring wrap and a non-sample tick, every ring equal;
- telemetry on against off for Kademlia and Chord under lifetime churn
  (tests/test_zz_telemetry_identity.py's scenario, the port alone):
  every non-telemetry leaf identical, one sample per cadence hit;
- Chord + KBRTest with telemetry every 3 ticks into a ring of 5, 40
  ticks on both packages: every leaf equal, the rings included (the
  JAX side in a fresh interpreter, test_torch_engine.py
  ``fresh_jax_call`` says why);
- ``kpi_series``, ``series_report`` and ``ensemble_series`` on the same
  rings as JAX's;
- ``python -m oversim_tpu_torch.campaign --device cpu``, two replicas
  of 12 slots,
  and its refusals (no card, ``--ini``).
"""

import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from oversim_tpu_torch import churn as tchurn
from oversim_tpu_torch import telemetry as ttel
from oversim_tpu_torch import tree
from oversim_tpu_torch.apps.kbrtest import KbrTestApp, KbrTestParams
from oversim_tpu_torch.common import lookup as tlk
from oversim_tpu_torch.engine import sim as tsim
from oversim_tpu_torch.overlay.chord import ChordLogic
from oversim_tpu_torch.overlay.kademlia import KademliaLogic
from oversim_tpu_torch.underlay import simple as tul
from test_torch_campaign import assert_json_close
from test_torch_engine import TESTS_DIR, JaxCall, first_difference

# tiny tensors: one intra-op thread keeps parallel test workers from
# oversubscribing the host
torch.set_num_threads(1)

JAX_TICKS = 40
CP = dict(model="lifetime", target_num=6, init_interval=0.2,
          init_deviation=0.0, lifetime_mean=8.0, graceful_leave_delay=1.0)
EP = dict(window=0.1, inbox_slots=4, pool_factor=4)


def jax_chord_telemetry():
    """JAX leaves of Chord + KBRTest with telemetry after JAX_TICKS."""
    import jax

    from oversim_tpu import churn as jchurn
    from oversim_tpu import telemetry as jtel
    from oversim_tpu.apps.kbrtest import KbrTestApp as JApp
    from oversim_tpu.apps.kbrtest import KbrTestParams as JParams
    from oversim_tpu.common import lookup as jlk
    from oversim_tpu.engine import sim as jsim
    from oversim_tpu.overlay.chord import ChordLogic as JChord
    from oversim_tpu.underlay import simple as jul
    from test_torch_engine import jax_leaves, own
    sim = jsim.Simulation(
        JChord(app=JApp(JParams(test_interval=0.5)),
               lcfg=jlk.LookupConfig(slots=8)),
        jchurn.ChurnParams(**CP), jul.UnderlayParams(jitter=0.0),
        jsim.EngineParams(**EP, telemetry=jtel.TelemetryParams(
            sample_ticks=3, window=5)))
    s = sim.run_chunk(own(sim.init(seed=5)), JAX_TICKS)
    jax.block_until_ready(s.t_now)
    return jax_leaves(s)


_REF = {}


def jax_ref():
    """The JAX run, started at the first call and waited for at the
    first ``result``."""
    if "call" not in _REF:
        _REF["call"] = JaxCall("test_torch_telemetry", "jax_chord_telemetry")
    return _REF["call"]


def port_sim(overlay, sample_ticks=0, window=8, target=6, interval=0.5):
    app = KbrTestApp(KbrTestParams(test_interval=interval))
    logic = (KademliaLogic(app=app, lcfg=tlk.LookupConfig(slots=8,
                                                          merge=True))
             if overlay == "kademlia"
             else ChordLogic(app=app, lcfg=tlk.LookupConfig(slots=8)))
    ep = tsim.EngineParams(**EP, telemetry=ttel.TelemetryParams(
        sample_ticks=sample_ticks, window=window))
    return tsim.Simulation(logic, tchurn.ChurnParams(
        **dict(CP, target_num=target)), tul.UnderlayParams(jitter=0.0),
        ep, device="cpu")


def test_fold_matches_jax_cadence_wrap_and_idle_ticks():
    """11 folds at cadence 2 into a ring of 3 (five samples, wrapped),
    stats of every class: the port's rings equal JAX's after each."""
    import jax.numpy as jnp

    from oversim_tpu import telemetry as jtel
    rs = np.random.default_rng(2)
    tp = dict(sample_ticks=2, window=3)
    stats0 = {"s:lat": np.array([0.0, 0.0, 0.0, np.inf, -np.inf]),
              "h:hops": np.zeros(4, np.int64), "c:sent": np.int64(0)}
    names = ("queue_lost", "pool_overflow")
    jt = jtel.init({k: jnp.asarray(v) for k, v in stats0.items()}, names,
                   jtel.TelemetryParams(**tp))
    tt = ttel.init({k: torch.as_tensor(v) for k, v in stats0.items()},
                   names, ttel.TelemetryParams(**tp))
    for tick in range(1, 12):
        alive = rs.random(7) < 0.6
        st = {"s:lat": rs.normal(size=5), "h:hops": rs.integers(0, 9, 4),
              "c:sent": np.int64(tick * 10)}
        cn = {k: np.int64(rs.integers(0, 5)) for k in names}
        jt = jtel.fold(jt, jtel.TelemetryParams(**tp),
                       t_end=jnp.int64(tick * 100), tick=jnp.int64(tick),
                       alive=jnp.asarray(alive),
                       stats={k: jnp.asarray(v) for k, v in st.items()},
                       counters={k: jnp.asarray(v) for k, v in cn.items()})
        tt = ttel.fold(tt, ttel.TelemetryParams(**tp),
                       t_end=torch.tensor(tick * 100),
                       tick=torch.tensor(tick), alive=torch.as_tensor(alive),
                       stats={k: torch.as_tensor(v) for k, v in st.items()},
                       counters={k: torch.as_tensor(v)
                                 for k, v in cn.items()})
        want = ttel._map(lambda x: torch.as_tensor(np.array(x)), jt)
        for (p, a), (_, b) in zip(tree.leaves_with_path(tt),
                                  tree.leaves_with_path(want)):
            assert a.dtype == b.dtype and torch.equal(a, b), (tick, p)
    u = ttel.unwrap(tt)
    assert u["n"] == 5 and u["k"] == 3
    assert u["tick"].tolist() == [6, 8, 10]
    assert ttel._ring_order(6, 4).tolist() == [2, 3, 0, 1]


def test_taps_and_disabled_init():
    stats = {"s:kbr_hopcount": torch.zeros(5, dtype=torch.float64),
             "h:kbr_hop_hist": torch.zeros(8, dtype=torch.int64),
             "c:kbr_sent": torch.zeros((), dtype=torch.int64),
             "s:kbr_rpc_rtt_s": torch.zeros(5, dtype=torch.float64)}
    tp = ttel.TelemetryParams(sample_ticks=1)
    app = KbrTestApp()
    assert set(ttel.resolve_taps(stats, tp)) == set(stats)
    assert set(ttel.resolve_taps(stats, tp, app=app)) == {
        "s:kbr_hopcount", "h:kbr_hop_hist", "c:kbr_sent"}
    inc = ttel.TelemetryParams(sample_ticks=1, include=("rpc",))
    assert ttel.resolve_taps(stats, inc, app=app) == ("s:kbr_rpc_rtt_s",)
    none = ttel.TelemetryParams(sample_ticks=1, include=("zzz",))
    assert set(ttel.resolve_taps(stats, none)) == set(stats)
    assert ttel.init(stats, ("queue_lost",), ttel.TelemetryParams()) is None
    assert ttel.init(stats, (), None) is None
    with pytest.raises(ValueError):
        ttel.init(stats, (), ttel.TelemetryParams(sample_ticks=1, window=0))
    # off, the state has no telemetry leaf at all
    assert port_sim("kademlia").init(1).telemetry is None


@pytest.mark.parametrize("overlay", ["kademlia", "chord"])
def test_telemetry_leaves_the_tick_alone(overlay, ticks=64, every=4, w=8):
    """Telemetry on against off under lifetime churn: every
    non-telemetry leaf identical; the rings took one sample per cadence
    hit, wrapped, in time order, the last one the final alive count."""
    jax_ref()       # the JAX run of the next test starts meanwhile
    off, on = port_sim(overlay, target=12), port_sim(overlay, every, w, 12)
    a = off.run_chunk(off.init(3), ticks)
    b = on.run_chunk(on.init(3), ticks)
    assert a.telemetry is None
    la = tree.leaves_with_path(a)
    lb = tree.leaves_with_path(dataclasses.replace(b, telemetry=None))
    assert [p for p, _ in la] == [p for p, _ in lb]
    bad = [p for (p, x), (_, y) in zip(la, lb) if not torch.equal(x, y)]
    assert not bad, bad
    assert int(torch.sum(a.alive ^ off.init(3).alive)) > 0
    assert int(b.telemetry.n) == ticks // every
    u = ttel.unwrap(b.telemetry)
    assert u["k"] == w
    assert (np.diff(u["tick"]) == every).all()
    assert (np.diff(u["t_ns"]) > 0).all()
    assert u["alive"][-1] == int(torch.sum(b.alive))
    assert b.telemetry.series and set(b.telemetry.counters) == set(
        on.counter_names)


def test_chord_telemetry_leaves_match_jax():
    ref = jax_ref().result()
    sim = port_sim("chord", 3, 5)
    s = sim.run_chunk(sim.init(5), JAX_TICKS)
    assert first_difference(ref, s) is None
    assert int(s.telemetry.n) == JAX_TICKS // 3
    assert any(k.startswith(".telemetry.series") for k in ref)


def _fake_rings(rs, s=3, w=4):
    """Stacked KBRTest-shaped rings: replica r took 2 + 2r samples."""
    acc = np.cumsum(np.abs(rs.normal(2.0, 1.0, (s, w, 5))), axis=1)
    acc[:, 0] = [0.0, 0.0, 0.0, np.inf, -np.inf]
    sent = np.cumsum(rs.integers(0, 9, (s, w)), axis=1)
    return ttel.TelemetryState(
        n=np.array([2 + 2 * r for r in range(s)], np.int64),
        t_ns=np.cumsum(rs.integers(1, 10**9, (s, w)), axis=1),
        tick=np.tile(np.arange(1, w + 1, dtype=np.int64) * 5, (s, 1)),
        alive=rs.integers(5, 20, (s, w)),
        series={"s:kbr_hopcount": acc,
                "h:kbr_hop_hist": rs.integers(0, 5, (s, w, 6)),
                "c:kbr_sent": sent,
                "c:kbr_delivered": sent - rs.integers(0, 2, (s, w))},
        counters={"queue_lost": rs.integers(0, 3, (s, w))})


def test_series_exporters_match_jax():
    from oversim_tpu import telemetry as jtel
    rings = _fake_rings(np.random.default_rng(8))

    def as_jax(t):
        return jtel.TelemetryState(n=t.n, t_ns=t.t_ns, tick=t.tick,
                                   alive=t.alive, series=t.series,
                                   counters=t.counters)

    for r in range(3):
        row = ttel._map(lambda x, r=r: x[r], rings)
        got, want = ttel.kpi_series(row), jtel.kpi_series(as_jax(row))
        assert sorted(got["series"]) == sorted(want["series"])
        for k, v in want["series"].items():
            np.testing.assert_array_equal(got["series"][k], v)
        for k, v in want["hists"].items():
            np.testing.assert_array_equal(got["hists"][k], v)
        np.testing.assert_array_equal(got["t_s"], want["t_s"])
        assert_json_close(ttel.series_report(row),
                          jtel.series_report(as_jax(row)))
    got = ttel.ensemble_series(rings, 0.99)
    assert got["samples"] == 2 and got["replicas"] == 3
    assert_json_close(json.loads(json.dumps(got)), json.loads(json.dumps(
        jtel.ensemble_series(as_jax(rings), 0.99))))


CLI = ["--replicas", "1", "--sweep", "churn.lifetimeMean=60,600", "--n",
       "6", "--churn", "lifetime", "--t", "12", "--window", "0.2",
       "--interval", "0.5", "--chunk", "16", "--telemetry", "4",
       "--telemetry-window", "8"]


def test_campaign_cli_on_the_cpu(tmp_path):
    out = tmp_path / "c.json"
    env = dict(os.environ, OMP_NUM_THREADS="1")
    res = subprocess.run(
        [sys.executable, "-m", "oversim_tpu_torch.campaign", "--device",
         "cpu", *CLI, "--out", str(out)], capture_output=True, text=True,
        cwd=str(TESTS_DIR.parent), env=env, timeout=600)
    assert res.returncode == 0, res.stderr[-3000:]
    lines = res.stdout.strip().splitlines()
    report = json.loads(lines[-1])
    camp = report["_campaign"]
    assert camp["s"] == 2 and camp["device"] == "cpu"
    assert min(camp["t_sim"]) >= 12.0
    assert camp["engine"]["pool_overflow"] == 0
    assert report["kbr_sent"]["total"] > 0
    assert report["kbr_delivery_ratio"]["k"] == 2
    tel = json.loads(lines[-2])
    assert tel["metric"] == "telemetry_series" and tel["replicas"] == 2
    assert tel["samples"] == 8
    doc = json.loads(out.read_text())
    assert doc["complete"] and doc["final"] == tel
    assert [r.get("phase") for r in doc["records"][:2]] == ["init", "run"]
    assert doc["records"][2]["_campaign"]["s"] == 2


def test_campaign_cli_refuses(monkeypatch, tmp_path):
    """No card: the CLI raises instead of running on the CPU; an ini
    naming a tier app the port lacks (I3 over NICE) and ``--trace``
    name the roadmap items they wait for."""
    from oversim_tpu_torch.campaign.__main__ import main
    ini = tmp_path / "x.ini"
    ini.write_text('**.overlayType = "oversim.overlay.nice.NiceModules"\n'
                   '**.tier1Type = "oversim.applications.i3.OverlayI3"\n')
    with pytest.raises(NotImplementedError, match="ROADMAP Queue A"):
        main(["--ini", str(ini), "--device", "cpu"])
    with pytest.raises(NotImplementedError, match="ROADMAP Queue A item 15"):
        main(["--trace", "t.json"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        main(CLI)
