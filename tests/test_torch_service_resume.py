"""The port's serving loop held to the JAX package's, leaf for leaf.

tests/test_zz_service_resume.py's configurations — Kademlia and Chord +
KBRTest (``LookupConfig(slots=4)``) under lifetime churn at 24 slots
(target 12, mean 8 s), engine window 0.1 s, 4 inbox slots, pool factor 4
— with ``init_deviation = jitter = 0`` (the engine's two normal draws,
where PyTorch's erfinv cannot match XLA's bit for bit), served in
windows of 1 simulated s (KBRTest measures from 2.4 s), solo (seed 5)
and as a 2-row campaign (base seed 7):

- the port's run served 3 windows with a checkpoint every 2, abandoned,
  and resumed from the file to window 4 equals the port's uninterrupted
  run and the JAX package's uninterrupted run in every leaf;
- every window's summary (``summarize_counter_leaves``,
  ``campaign_summarize_leaves``) equals JAX's: integers exact, floats
  within 1e-12 relative;
- the serving path: Kademlia + ``RealworldEchoApp(transform=5)`` with
  ``ext_hold_slot=0`` (8 nodes, NoChurn, warmed to 3 s), served through
  ``InProcessIngest`` (3 requests, 2 windows, 1 more request, 2
  windows): the same answers as JAX's, ``(b, c + 5)`` each, and every
  leaf equal.

The JAX runs happen in two fresh interpreters, started before the port's
runs so that they overlap (test_torch_engine.py ``fresh_jax_call`` says
why).
"""

import functools
import json

import numpy as np
import pytest
import torch

from oversim_tpu_torch import churn as tchurn
from oversim_tpu_torch import tree
from oversim_tpu_torch.apps.kbrtest import KbrTestApp, KbrTestParams
from oversim_tpu_torch.apps.realworld import RealworldEchoApp
from oversim_tpu_torch.campaign import Campaign, CampaignParams
from oversim_tpu_torch.common.lookup import LookupConfig
from oversim_tpu_torch.engine import sim as tsim
from oversim_tpu_torch.overlay.chord import ChordLogic
from oversim_tpu_torch.overlay.kademlia import KademliaLogic
from oversim_tpu_torch.service import (InProcessIngest, ServiceLoop,
                                       ServiceParams,
                                       campaign_summarize_leaves)
from oversim_tpu_torch.underlay import simple as tul
from test_torch_campaign import assert_json_close
from test_torch_engine import JaxCall, first_difference, own

# tiny tensors: one intra-op thread keeps parallel test workers from
# oversubscribing the host
torch.set_num_threads(1)

OVERLAYS = ("kademlia", "chord")
WINDOWS = 4
CKPT_AT = 2
WINDOW_S = 1.0
CHUNK = 10
CP = dict(model="lifetime", target_num=12, init_interval=0.2,
          init_deviation=0.0, lifetime_mean=8.0)
EP = dict(window=0.1, inbox_slots=4, pool_factor=4)
ECHO_CP = dict(model="none", target_num=8, init_interval=0.2,
               init_deviation=0.0)
ECHO_EP = dict(window=0.1, ext_hold_slot=0)
ECHO_WARM_S = 3.0
ECHO_CHUNK = 10
REQUESTS = ((0, 100), (1, 101), (2, 102))
LATE = (9, 900)


def port_sim(overlay):
    app = KbrTestApp(KbrTestParams(test_interval=0.5))
    lcfg = LookupConfig(slots=4, merge=overlay == "kademlia")
    logic = (KademliaLogic(app=app, lcfg=lcfg) if overlay == "kademlia"
             else ChordLogic(app=app, lcfg=lcfg))
    return tsim.Simulation(logic, tchurn.ChurnParams(**CP),
                           tul.UnderlayParams(jitter=0.0),
                           tsim.EngineParams(**EP), device="cpu")


def port_echo_sim():
    return tsim.Simulation(KademliaLogic(app=RealworldEchoApp(transform=5)),
                           tchurn.ChurnParams(**ECHO_CP),
                           tul.UnderlayParams(jitter=0.0),
                           tsim.EngineParams(**ECHO_EP), device="cpu")


def _jax_sim(overlay):
    from oversim_tpu import churn as jchurn
    from oversim_tpu.apps.kbrtest import KbrTestApp as JApp
    from oversim_tpu.apps.kbrtest import KbrTestParams as JParams
    from oversim_tpu.common import lookup as jlk
    from oversim_tpu.engine import sim as jsim
    from oversim_tpu.overlay.chord import ChordLogic as JChord
    from oversim_tpu.overlay.kademlia import KademliaLogic as JKademlia
    from oversim_tpu.underlay import simple as jul
    app = JApp(JParams(test_interval=0.5))
    lcfg = jlk.LookupConfig(slots=4, merge=overlay == "kademlia")
    logic = (JKademlia(app=app, lcfg=lcfg) if overlay == "kademlia"
             else JChord(app=app, lcfg=lcfg))
    return jsim.Simulation(logic, jchurn.ChurnParams(**CP),
                           jul.UnderlayParams(jitter=0.0),
                           jsim.EngineParams(**EP))


def _keep(out, head, state):
    import jax
    for p, v in jax.tree_util.tree_flatten_with_path(state)[0]:
        out[f"{head}|{jax.tree_util.keystr(p)}"] = np.array(v)


def jax_service_runs(kind):
    """``{overlay|path: leaf}`` of the JAX package's uninterrupted
    WINDOWS-window service run of every overlay (``kind``: "solo" or
    "campaign") and ``summaries|overlay``: its window summaries as JSON."""
    from oversim_tpu.campaign import Campaign as JCampaign
    from oversim_tpu.campaign import CampaignParams as JCampaignParams
    from oversim_tpu.service import ServiceLoop as JLoop
    from oversim_tpu.service import ServiceParams as JParams
    from oversim_tpu.service import campaign_summarize_leaves as jcsum
    out = {}
    for overlay in OVERLAYS:
        sim = _jax_sim(overlay)
        kw = {}
        if kind == "solo":
            runner, st = sim, own(sim.init(seed=5))
        else:
            runner = JCampaign(sim, JCampaignParams(replicas=2, base_seed=7))
            st, kw["summarize"] = own(runner.init()), jcsum
        summaries = []
        final, done = JLoop(
            runner, st, JParams(window_sim_s=WINDOW_S, chunk=CHUNK),
            on_window=lambda w, s, t: summaries.append(s), **kw).run(
                n_windows=WINDOWS)
        assert done == WINDOWS
        _keep(out, overlay, final)
        out[f"summaries|{overlay}"] = np.array(json.dumps(summaries))
    return out


def jax_echo_run():
    """The JAX package's echo-over-Kademlia ingest run: its final leaves
    and ``responses`` rows ``[sid, b, c]``."""
    from oversim_tpu import churn as jchurn
    from oversim_tpu.apps.realworld import RealworldEchoApp as JEcho
    from oversim_tpu.engine import sim as jsim
    from oversim_tpu.overlay.kademlia import KademliaLogic as JKademlia
    from oversim_tpu.service import InProcessIngest as JIngest
    from oversim_tpu.service import ServiceLoop as JLoop
    from oversim_tpu.service import ServiceParams as JParams
    from oversim_tpu.underlay import simple as jul
    sim = jsim.Simulation(JKademlia(app=JEcho(transform=5)),
                          jchurn.ChurnParams(**ECHO_CP),
                          jul.UnderlayParams(jitter=0.0),
                          jsim.EngineParams(**ECHO_EP))
    st = sim.run_until(own(sim.init(seed=9)), ECHO_WARM_S, chunk=ECHO_CHUNK)
    final, ing = _serve_echo(JLoop, JParams, JIngest, sim, st)
    out = {}
    _keep(out, "echo", final)
    out["responses"] = np.array(sorted([sid, *bc] for sid, bc in
                                       ing.responses.items()), np.int64)
    out["meta"] = np.array([ing.num_batches, ing.num_injected,
                            ing.overflow()], np.int64)
    return out


def _serve_echo(loop_cls, params_cls, ingest_cls, sim, st):
    ing = ingest_cls(gw_slot=0)
    loop = loop_cls(sim, st, params_cls(window_sim_s=1.0, chunk=ECHO_CHUNK),
                    ingest=ing)
    for b, c in REQUESTS:
        ing.submit(b=b, c=c)
    loop.run(n_windows=2)
    ing.submit(b=LATE[0], c=LATE[1])
    final, _ = loop.run(n_windows=2)
    return final, ing


@functools.lru_cache(maxsize=None)
def jax_refs():
    return {"solo": JaxCall("test_torch_service_resume", "jax_service_runs",
                            kind="solo"),
            "campaign": JaxCall("test_torch_service_resume",
                                "jax_service_runs", kind="campaign"),
            "echo": JaxCall("test_torch_service_resume", "jax_echo_run")}


@functools.lru_cache(maxsize=None)
def jax_result(name):
    return jax_refs()[name].result()


def at(flat, head):
    head += "|"
    return {k[len(head):]: v for k, v in flat.items() if k.startswith(head)}


def _runner(overlay, kind):
    sim = port_sim(overlay)
    if kind == "solo":
        return sim, (lambda: sim.init(seed=5)), {}
    camp = Campaign(sim, CampaignParams(replicas=2, base_seed=7))
    return camp, camp.init, {"summarize": campaign_summarize_leaves}


@functools.lru_cache(maxsize=None)
def port_runs(overlay, kind, tmp):
    """The port's uninterrupted run (final state, window summaries) and
    its interrupted-and-resumed run's final state."""
    jax_refs()
    runner, init, kw = _runner(overlay, kind)
    summaries = []
    ref, done = ServiceLoop(
        runner, init(), ServiceParams(window_sim_s=WINDOW_S, chunk=CHUNK),
        on_window=lambda w, s, t: summaries.append(s), **kw).run(
            n_windows=WINDOWS)
    assert done == WINDOWS
    cfg = {"overlay": overlay, "kind": kind, "n": 12}
    params = ServiceParams(window_sim_s=WINDOW_S, chunk=CHUNK,
                           checkpoint_every=CKPT_AT,
                           checkpoint_path=f"{tmp}/{overlay}_{kind}.npz")
    loop = ServiceLoop(runner, init(), params, config=cfg, **kw)
    loop.run(n_windows=CKPT_AT + 1)
    assert loop.last_checkpoint == CKPT_AT
    del loop                       # the "kill": resume sees only the file
    resumed = ServiceLoop.resume(runner, init(), params, config=cfg, **kw)
    assert resumed.windows_done == CKPT_AT
    state, done = resumed.run(n_windows=WINDOWS - CKPT_AT)
    assert done == WINDOWS
    return ref, summaries, state


@pytest.fixture(scope="module")
def tmp(tmp_path_factory):
    return str(tmp_path_factory.mktemp("svc"))


def _stacked(state):
    return tree.stack(state) if isinstance(state, list) else state


@pytest.mark.parametrize("kind", ["solo", "campaign"])
@pytest.mark.parametrize("overlay", OVERLAYS)
def test_resumed_run_leaf_exact(overlay, kind, tmp):
    ref, _, resumed = port_runs(overlay, kind, tmp)
    want = at(jax_result(kind), overlay)
    assert first_difference(want, _stacked(ref)) is None
    assert first_difference(want, _stacked(resumed)) is None
    alive = want[".alive"]
    assert 0 < alive.sum() < alive.size, "lifetime churn left no trace"


def test_window_summaries_match_jax(tmp):
    for kind in ("solo", "campaign"):
        for overlay in OVERLAYS:
            _, got, _ = port_runs(overlay, kind, tmp)
            want = json.loads(str(jax_result(kind)[f"summaries|{overlay}"]))
            assert len(got) == len(want) == WINDOWS
            assert_json_close(json.loads(json.dumps(got)), want)
            assert want[-1]["kbr_sent"] > 0


def test_ingest_echo_over_kademlia():
    """One batched pool write per boundary with requests; every request
    answered ``(b, c + 5)``; answers and final leaves equal to JAX's."""
    jax_refs()
    sim = port_echo_sim()
    st = sim.run_until(sim.init(seed=9), ECHO_WARM_S, chunk=ECHO_CHUNK)
    final, ing = _serve_echo(ServiceLoop, ServiceParams, InProcessIngest,
                             sim, st)
    ref = jax_result("echo")
    got = np.array(sorted([sid, *bc] for sid, bc in ing.responses.items()),
                   np.int64)
    assert np.array_equal(got, ref["responses"])
    assert [tuple(r[1:]) for r in got] == [
        (b, c + 5) for b, c in REQUESTS + (LATE,)]
    assert [ing.num_batches, ing.num_injected, ing.overflow()] == \
        ref["meta"].tolist() == [2, 4, 0]
    assert first_difference(at(ref, "echo"), final) is None
