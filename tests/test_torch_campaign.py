"""The campaign runner and its ensemble statistics on both packages.

Three campaigns of ``ChurnParams(model="lifetime", target_num=6)`` (12
slots, lifetime mean 8 s, 1 s graceful leave) with ``init_deviation =
jitter = 0`` (the engine's two normal draws, where PyTorch's erfinv
cannot match XLA's bit for bit), each stepped 48 ticks by JAX's
``Campaign.run_chunk`` and by the port's, every leaf of the stacked
``[S, ...]`` states equal:

- ``sweep``: Kademlia + KBRTest with all three test modes, a grid over
  all three sweep keys (S = 4) and telemetry every 4 ticks into a ring of
  8 (so it wraps).  With three modes the swept re-arm interval is a
  traced ``iv / 3 * NS``, which the JAX tick keeps a true float64
  division (a small jit of the same expression alone folds it into
  ``iv * fl(NS / 3)``).  At 0.417 s the fold, and at 0.471 s both the
  fold and a multiply by ``fl(1 / 3)``, truncate to another nanosecond
  count, so only the true division passes;
- ``chord``: Chord + KBRTest, four seed replicas;
- ``sparse``: Kademlia on the sparse tick with ``inbox_impl="pallas"``,
  S = 2: the JAX package's Pallas kernels (select-only inbox and
  compaction, and the outbox allocator) in interpret mode against the
  port's plain kernel versions.

The ``sweep`` campaign then runs on to 9 s by ``run_until_device`` on
both (per-row simulated time and tick equal), and both reports agree:
the same keys, integers exact, floats within 1e-12 relative.  The JAX
side runs in one fresh interpreter (test_torch_engine.py
``fresh_jax_call`` says why), started before the port's runs so the two
overlap.
"""

import functools
import json
import math

import numpy as np
import pytest
import torch

from oversim_tpu_torch import churn as tchurn
from oversim_tpu_torch import stats as tstats
from oversim_tpu_torch import tree
from oversim_tpu_torch.apps.kbrtest import KbrTestApp, KbrTestParams
from oversim_tpu_torch.campaign import Campaign, CampaignParams, expand_grid
from oversim_tpu_torch.common import lookup as tlk
from oversim_tpu_torch.engine import sim as tsim
from oversim_tpu_torch.overlay.chord import ChordLogic
from oversim_tpu_torch.overlay.kademlia import KademliaLogic
from oversim_tpu_torch.telemetry import TelemetryParams
from oversim_tpu_torch.underlay import simple as tul
from test_torch_engine import JaxCall, first_difference

# tiny tensors: one intra-op thread keeps parallel test workers from
# oversubscribing the host
torch.set_num_threads(1)

SEED = 3
TICKS = 48
T_UNTIL = 9.0
UNTIL_CHUNK = 8
CP = dict(model="lifetime", target_num=6, init_interval=0.2,
          init_deviation=0.0, lifetime_mean=8.0, graceful_leave_delay=1.0)
EP = dict(window=0.1, inbox_slots=4, pool_factor=4)
SWEEP = (("churn.lifetimeMean", (8.0, 20.0)), ("engine.window", (0.15,)),
         ("app.testMsgInterval", (0.417, 0.471)))
# name -> (overlay, KbrTestParams extras, EngineParams extras, telemetry
# (sample_ticks, window) or None, CampaignParams extras)
RUNS = {
    "sweep": ("kad", dict(rpc_test=True, lookup_test=True), {}, (4, 8),
              dict(replicas=1, sweep=SWEEP)),
    "chord": ("chord", {}, {}, None, dict(replicas=4)),
    "sparse": ("kad", {}, dict(tick_impl="sparse", inbox_impl="pallas"),
               None, dict(replicas=2)),
}
RTOL = 1e-12


def _parts(name):
    ov, kp, ep, tel, camp = RUNS[name]
    return ov, dict(test_interval=0.5, **kp), dict(EP, **ep), tel, camp


def port_campaign(name, device="cpu", **camp_kw):
    ov, kp, ep, tel, camp = _parts(name)
    app = KbrTestApp(KbrTestParams(**kp))
    if ov == "kad":
        logic = KademliaLogic(app=app,
                              lcfg=tlk.LookupConfig(slots=8, merge=True))
    else:
        logic = ChordLogic(app=app, lcfg=tlk.LookupConfig(slots=8))
    if tel:
        ep["telemetry"] = TelemetryParams(sample_ticks=tel[0], window=tel[1])
    sim = tsim.Simulation(logic, tchurn.ChurnParams(**CP),
                          tul.UnderlayParams(jitter=0.0),
                          tsim.EngineParams(**ep), device=device)
    return Campaign(sim, CampaignParams(base_seed=SEED,
                                        **dict(camp, **camp_kw)))


def jax_campaign(name):
    from oversim_tpu import churn as jchurn
    from oversim_tpu import telemetry as jtel
    from oversim_tpu.apps.kbrtest import KbrTestApp as JApp
    from oversim_tpu.apps.kbrtest import KbrTestParams as JParams
    from oversim_tpu.campaign import Campaign as JCampaign
    from oversim_tpu.campaign import CampaignParams as JCampaignParams
    from oversim_tpu.common import lookup as jlk
    from oversim_tpu.engine import sim as jsim
    from oversim_tpu.overlay.chord import ChordLogic as JChord
    from oversim_tpu.overlay.kademlia import KademliaLogic as JKademlia
    from oversim_tpu.underlay import simple as jul
    ov, kp, ep, tel, camp = _parts(name)
    app = JApp(JParams(**kp))
    if ov == "kad":
        logic = JKademlia(app=app, lcfg=jlk.LookupConfig(slots=8, merge=True))
    else:
        logic = JChord(app=app, lcfg=jlk.LookupConfig(slots=8))
    if tel:
        ep["telemetry"] = jtel.TelemetryParams(sample_ticks=tel[0],
                                               window=tel[1])
    sim = jsim.Simulation(logic, jchurn.ChurnParams(**CP),
                          jul.UnderlayParams(jitter=0.0),
                          jsim.EngineParams(**ep))
    return JCampaign(sim, JCampaignParams(base_seed=SEED, **camp))


def jax_campaign_runs():
    """``{run|path: leaf}`` of every campaign of RUNS after TICKS ticks,
    ``until|path`` of the sweep campaign after ``run_until_device``, and
    its report as JSON."""
    import jax
    out = {}

    def keep(cs, head):
        for p, v in jax.tree_util.tree_flatten_with_path(cs)[0]:
            out[f"{head}|{jax.tree_util.keystr(p)}"] = np.array(v)

    for name in RUNS:
        camp = jax_campaign(name)
        cs = camp.run_chunk(camp.init(), TICKS)
        keep(cs, name)
        if name == "sweep":
            cs = camp.run_until_device(cs, T_UNTIL, chunk=UNTIL_CHUNK)
            keep(cs, "until")
            out["report"] = np.array(json.dumps(camp.report(cs)))
    return out


def at(flat, head):
    head += "|"
    return {k[len(head):]: v for k, v in flat.items() if k.startswith(head)}


@functools.lru_cache(maxsize=None)
def runs():
    """(JAX leaves, {run: (campaign, rows)}) with the port's ``until``
    rows of the sweep campaign."""
    ref = JaxCall("test_torch_campaign", "jax_campaign_runs")
    out = {}
    for name in RUNS:
        camp = port_campaign(name)
        out[name] = (camp, camp.run_chunk(camp.init(), TICKS))
    camp, cs = out["sweep"]
    out["until"] = (camp, camp.run_until_device(cs, T_UNTIL,
                                                chunk=UNTIL_CHUNK))
    return ref.result(), out


@pytest.mark.parametrize("name", list(RUNS))
def test_campaign_leaf_exact(name):
    ref, port = runs()
    camp, cs = port[name]
    assert camp.s == (4 if name in ("sweep", "chord") else 2)
    stacked = tree.stack(cs)
    assert first_difference(at(ref, name), stacked) is None
    rows = tree.unstack(stacked)
    assert len(rows) == camp.s and all(
        torch.equal(a, b) for row, r in zip(rows, cs) for (_, a), (_, b)
        in zip(tree.leaves_with_path(row), tree.leaves_with_path(r)))
    if name == "sweep":
        # the grid reached the rows: the interval points sent at
        # different rates, and the ring wrapped (12 samples, 8 kept)
        assert camp.grid == expand_grid(SWEEP)
        assert torch.all(stacked.telemetry.n == TICKS // 4)
        sent = stacked.stats["c:kbr_sent"] + stacked.stats["c:kbr_rpc_sent"]
        assert int(sent[0]) != int(sent[1])


def test_run_until_device_rows():
    """Every row past the target, gated as one: per-row time and tick
    equal to JAX's, and every leaf."""
    ref, port = runs()
    camp, cs = port["until"]
    until = at(ref, "until")
    got = tree.stack(cs)
    assert np.array_equal(got.t_now.numpy(), until[".t_now"])
    assert np.array_equal(got.tick.numpy(), until[".tick"])
    assert bool(torch.all(got.t_now >= int(T_UNTIL * tsim.NS)))
    assert first_difference(until, got) is None


def assert_json_close(a, b, path=""):
    """Same structure; ints exact, floats within RTOL relative (NaN and
    None equal)."""
    if isinstance(a, dict):
        assert isinstance(b, dict) and sorted(a) == sorted(b), path
        for k in a:
            assert_json_close(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, list):
        assert isinstance(b, list) and len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            assert_json_close(x, y, f"{path}[{i}]")
    elif isinstance(a, float) or isinstance(b, float):
        x, y = float(a), float(b)
        if math.isnan(x) or math.isnan(y):
            assert math.isnan(x) and math.isnan(y), path
        else:
            assert abs(x - y) <= RTOL * max(abs(x), abs(y)), (path, x, y)
    else:
        assert a == b and type(a) is type(b), (path, a, b)


def test_report_matches_jax():
    ref, port = runs()
    camp, cs = port["until"]
    got = json.loads(json.dumps(camp.report(cs)))
    want = json.loads(str(ref["report"]))
    assert_json_close(got, want)
    assert got["kbr_delivery_ratio"]["k"] == 4
    assert got["kbr_hop_hist"]["kind"] == "hist"


def test_replica_ids_subset_rows():
    """A subset campaign's row k is global replica ``ids[k]`` of the full
    campaign: its rng and its grid point."""
    _, port = runs()
    full, cs = port["sweep"]
    sub = port_campaign("sweep", replica_ids=(3, 1))
    assert sub.s == 2 and sub.replica_ov(0) == full.replica_ov(3)
    rows = sub.run_chunk(sub.init(), TICKS)
    for k, r in enumerate((3, 1)):
        want = {p: v for p, v in tree.leaves_with_path(cs[r])}
        for p, v in tree.leaves_with_path(rows[k]):
            assert torch.equal(v, want[p]), (r, p)
    with pytest.raises(ValueError, match="outside"):
        port_campaign("sweep", replica_ids=(4,))
    desc = sub.describe()
    assert desc["replica_ids"] == [3, 1] and desc["total"] == 4


def _random_stacked(rs, s=5, bins=6):
    """Stacked accumulators: scalar, histogram and counter, with a
    replica that recorded nothing."""
    n = rs.integers(1, 40, s).astype(float)
    n[1] = 0.0
    vals = [rs.normal(3.0, 1.5, int(c)) for c in n]
    acc = np.array([[len(v), v.sum(), (v * v).sum(),
                     v.min() if len(v) else np.inf,
                     v.max() if len(v) else -np.inf] for v in vals])
    hist = rs.integers(0, 30, (s, bins))
    hist[2] = 0
    return {"s:lat": acc, "h:hops": hist.astype(np.int64),
            "c:sent": rs.integers(0, 1000, s).astype(np.int64)}


@pytest.mark.parametrize("seed", [0, 1])
def test_ensemble_reduce_and_summary_match_jax(seed):
    import jax
    import jax.numpy as jnp

    from oversim_tpu import stats as jstats
    acc = _random_stacked(np.random.default_rng(seed))
    want = jax.device_get(jax.jit(jstats.ensemble_reduce)(
        {k: jnp.asarray(v) for k, v in acc.items()}))
    got = tstats.ensemble_reduce({k: torch.as_tensor(v)
                                  for k, v in acc.items()})
    for key, fields in want.items():
        for f, w in fields.items():
            g = got[key][f].numpy()
            assert g.dtype == np.asarray(w).dtype, (key, f)
            np.testing.assert_allclose(g, w, rtol=RTOL, atol=0,
                                       err_msg=f"{key}.{f}")
    for conf in (0.95, 0.99):
        assert_json_close(tstats.ensemble_summary(got, conf),
                          jstats.ensemble_summary(want, conf))


def test_t_critical_and_series_summary_match_jax():
    from oversim_tpu import stats as jstats
    for conf in (0.95, 0.99):
        for df in range(-1, 40):
            a, b = tstats.t_critical(df, conf), jstats.t_critical(df, conf)
            assert (math.isnan(a) and math.isnan(b)) or a == b
    with pytest.raises(ValueError):
        tstats.t_critical(3, 0.9)
    rs = np.random.default_rng(4)
    v = rs.normal(0.0, 1.0, (6, 9))
    v[rs.random((6, 9)) < 0.3] = np.nan
    v[:, 0] = np.nan
    v[1:, 1] = np.nan
    assert_json_close(tstats.series_summary(v), jstats.series_summary(v))
    with pytest.raises(ValueError, match=r"\[S, K\]"):
        tstats.series_summary(v[0])
