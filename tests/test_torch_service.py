"""The port's serving loop (oversim_tpu_torch/service/loop.py) on fakes.

The fake-timer pins of tests/test_service.py, held on the port: with
double-buffering window k+1 is dispatched STRICTLY BEFORE window k's
fetch, and the loop waits on the host exactly once per window (the fetch
of the copied counter leaves) — shown on a fake runner and clock where
every dispatch and fetch is an event.  Then the cadence checkpoints and
resume on a tiny tensor state, ingest's single-buffering and clock
tracking (the service CLI: test_torch_service_cli.py).  No simulation
runs here.
"""

import dataclasses

import numpy as np
import pytest
import torch

from oversim_tpu_torch import checkpoint as ckpt_mod
from oversim_tpu_torch.service import ServiceLoop, ServiceParams

# tiny tensors: one intra-op thread keeps parallel test workers from
# oversubscribing the host
torch.set_num_threads(1)

NS = 1_000_000_000


class FakeClock:
    """Deterministic monotone host clock (1 ms per reading)."""

    def __init__(self):
        self.t = 0.0

    def __call__(self):
        self.t += 1e-3
        return self.t


@dataclasses.dataclass
class FakeSvcState:
    """Duck-typed state: only the attributes counter_leaf_refs reads."""

    t_now: int
    tick: int                 # carries the last-dispatched window index
    stats: dict
    counters: dict
    alive: np.ndarray


class FakeRunner:
    """run_until_device contract: logs the dispatch, returns at once."""

    def __init__(self, events):
        self.events = events
        self.n = 0

    def run_until_device(self, s, t_sim, chunk=32):
        self.events.append(("dispatch", self.n, t_sim))
        s = dataclasses.replace(s, t_now=int(t_sim * NS), tick=self.n)
        self.n += 1
        return s


class FakeTrace:
    def __init__(self):
        self.spans = []

    def span(self, name, t0, dur, tid=0, args=None):
        self.spans.append((name, t0, dur, args or {}))


def _fake_state():
    return FakeSvcState(t_now=0, tick=-1, stats={}, counters={},
                        alive=np.ones((2,), bool))


def _fake_loop(events, params, runner=None, **kw):
    def fetch(snap):
        # the ONE host wait of a window, tagged with its window index
        events.append(("fetch", snap["tick"]))
        return snap

    kw.setdefault("fetch", fetch)
    return ServiceLoop(runner or FakeRunner(events), _fake_state(), params,
                       start_sim_t=0.0, copy=lambda tree: dict(tree),
                       summarize=lambda lv: {"_t_sim": lv["t_now"] / NS},
                       now=FakeClock(), **kw)


def test_double_buffer_dispatches_ahead_of_fetch():
    """Dispatch k+1 strictly before fetch k; one fetch per window; the
    trailing window drains on exit."""
    events = []
    loop = _fake_loop(events, ServiceParams(window_sim_s=1.0, chunk=4))
    state, done = loop.run(n_windows=3)
    assert done == 3
    assert events == [
        ("dispatch", 0, 1.0),
        ("dispatch", 1, 2.0), ("fetch", 0),
        ("dispatch", 2, 3.0), ("fetch", 1),
        ("fetch", 2),
    ]
    assert state.t_now == 3 * NS


def test_window_grid_continues_and_single_buffer_interleaves():
    """Targets are start + (k+1)*w from the origin, so a second run()
    continues the exact grid; single-buffered, each dispatch is followed
    by its own fetch."""
    events = []
    loop = _fake_loop(events, ServiceParams(window_sim_s=0.5, chunk=4))
    loop.run(n_windows=2)
    loop.run(n_windows=2)
    assert [e[2] for e in events if e[0] == "dispatch"] == \
        [0.5, 1.0, 1.5, 2.0]
    assert loop.windows_done == 4

    events = []
    loop = _fake_loop(events, ServiceParams(window_sim_s=1.0, chunk=4,
                                            double_buffer=False))
    assert loop.run(n_windows=2)[1] == 2
    assert events == [("dispatch", 0, 1.0), ("fetch", 0),
                      ("dispatch", 1, 2.0), ("fetch", 1)]


def test_trace_spans_show_overlap_limits_and_stop():
    """Window k+1's dispatch span starts before window k's fetch span;
    ``max_windows`` is absolute and ``stop()`` ends a run early with
    every dispatched window drained."""
    events, trace = [], FakeTrace()
    loop = _fake_loop(events, ServiceParams(window_sim_s=1.0, chunk=4),
                      trace=trace)
    loop.run(n_windows=3)
    d = {s[3]["window"]: s[1] for s in trace.spans
         if s[0] == "window_dispatch"}
    f = {s[3]["window"]: s[1] for s in trace.spans if s[0] == "window_fetch"}
    assert set(d) == set(f) == {0, 1, 2}
    assert d[1] < f[0] and d[2] < f[1]

    loop = _fake_loop([], ServiceParams(window_sim_s=1.0, chunk=4,
                                        max_windows=2))
    assert loop.run()[1] == 2

    events = []
    loop = _fake_loop(events, ServiceParams(window_sim_s=1.0, chunk=4))
    loop.on_window = lambda w, s, t: loop.stop()
    done = loop.run(n_windows=10)[1]
    assert done < 10
    assert not any(e[0] == "dispatch" and e[1] >= done for e in events)


# -- checkpoint cadence and resume on a tensor state ---------------------------

@dataclasses.dataclass
class TinyState:
    t_now: torch.Tensor
    tick: torch.Tensor
    alive: torch.Tensor
    stats: dict
    counters: dict


class TinyRunner:
    def __init__(self):
        self.targets = []

    def run_until_device(self, s, t_sim, chunk=32):
        self.targets.append(float(t_sim))
        return dataclasses.replace(
            s, t_now=torch.tensor(int(t_sim * NS)), tick=s.tick + chunk)


def _tiny_state():
    return TinyState(t_now=torch.tensor(0), tick=torch.tensor(0),
                     alive=torch.ones((2,), dtype=torch.bool),
                     stats={"c:x": torch.tensor(0)},
                     counters={"ticks": torch.tensor(0)})


CFG = {"scenario": "tiny", "n": 2}


@pytest.mark.parametrize("write_behind", [True, False])
def test_checkpoint_cadence_resume_and_refusals(tmp_path, write_behind):
    path = str(tmp_path / "svc.npz")
    p = ServiceParams(window_sim_s=0.5, chunk=4,
                      checkpoint_every=2, checkpoint_path=path)
    loop = ServiceLoop(TinyRunner(), _tiny_state(), p, config=CFG,
                       write_behind=write_behind)
    state, done = loop.run(n_windows=5)
    assert done == 5
    assert loop.checkpoints_written == 2 and loop.last_checkpoint == 4
    assert loop.last_checkpoint_bytes == (tmp_path / "svc.npz").stat().st_size
    assert not (tmp_path / "svc.npz.tmp").exists()

    meta = ckpt_mod.read_meta(path)
    assert meta["format"] == ckpt_mod.FORMAT and meta["config_hash"]
    assert meta["service"] == {
        "windows_done": 4, "start_sim_t": 0.0, "window_sim_s": 0.5,
        "chunk": 4, "checkpoint_every": 2}
    assert meta["tick"] == 16   # read off the snapshotted state

    r = ServiceLoop.resume(TinyRunner(), _tiny_state(), p, config=CFG)
    assert r.windows_done == 4 and r.start_sim_t == 0.0
    assert int(r.state.tick) == 16
    state2, done2 = r.run(n_windows=1)
    assert done2 == 5 and int(state2.t_now) == int(state.t_now)

    with pytest.raises(ValueError, match="scenario mismatch"):
        ServiceLoop.resume(TinyRunner(), _tiny_state(), p,
                           config={"scenario": "other", "n": 2})
    with pytest.raises(ValueError, match="cadence mismatch"):
        ServiceLoop.resume(TinyRunner(), _tiny_state(),
                           dataclasses.replace(p, window_sim_s=1.0),
                           config=CFG)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        ServiceLoop.resume(TinyRunner(), _tiny_state(), p, config=CFG,
                           reshard=True)


def test_override_cadence_reanchors_window_origin(tmp_path):
    """``override_cadence=True`` re-anchors the origin so the NEXT target
    is the restored clock plus one NEW window, later targets recomputed
    as ``start + (k+1)*w`` from it."""
    path = str(tmp_path / "svc.npz")
    p = ServiceParams(window_sim_s=0.5, chunk=4,
                      checkpoint_every=2, checkpoint_path=path)
    ServiceLoop(TinyRunner(), _tiny_state(), p, config=CFG).run(n_windows=5)
    p2 = dataclasses.replace(p, window_sim_s=1.25)
    with pytest.raises(ValueError, match="override_cadence"):
        ServiceLoop.resume(TinyRunner(), _tiny_state(), p2, config=CFG)
    same = ServiceLoop.resume(TinyRunner(), _tiny_state(), p, config=CFG,
                              override_cadence=True)
    assert same.start_sim_t == 0.0 and same.windows_done == 4

    rec = TinyRunner()
    r = ServiceLoop.resume(rec, _tiny_state(), p2, config=CFG,
                           override_cadence=True)
    assert r.windows_done == 4
    assert r.start_sim_t == pytest.approx(2.0 - 4 * 1.25)
    assert r.run(n_windows=2)[1] == 6
    assert rec.targets == [pytest.approx(2.0 + 1.25),
                           pytest.approx(2.0 + 2 * 1.25)]
    assert rec.targets == [pytest.approx(r.start_sim_t + k * 1.25)
                           for k in (5, 6)]


def test_checkpoint_now_graceful_shutdown(tmp_path):
    """The SIGTERM path: after the run, ``checkpoint_now`` snapshots the
    CURRENT state though no cadence checkpoint is due, and it resumes;
    without a path it reports False."""
    path = str(tmp_path / "svc.npz")
    p = ServiceParams(window_sim_s=0.5, chunk=4,
                      checkpoint_every=100, checkpoint_path=path)
    loop = ServiceLoop(TinyRunner(), _tiny_state(), p, config=CFG)
    loop.run(n_windows=3)
    assert loop.checkpoints_written == 0
    assert loop.checkpoint_now() is True
    assert ckpt_mod.read_meta(path)["service"]["windows_done"] == 3
    r = ServiceLoop.resume(TinyRunner(), _tiny_state(), p, config=CFG)
    assert r.windows_done == 3 and int(r.state.tick) == 12

    free = ServiceLoop(TinyRunner(), _tiny_state(),
                       ServiceParams(window_sim_s=0.5, chunk=4))
    free.run(n_windows=1)
    assert free.checkpoint_now() is False


# -- ingest: single-buffering, clock tracking, one fetch per window ------------

class _Ingest:
    def __init__(self, events):
        self.events = events

    def before_window(self, state, target_ns):
        self.events.append(("inject", target_ns))
        return state

    def after_window(self, state):
        self.events.append(("drain",))
        return state


def test_ingest_forces_single_buffer_and_tracks_clock():
    """With ingest the loop single-buffers (inject -> dispatch -> fetch
    -> drain per window), and a window's target tracks the ACTUAL clock
    when a chunk has overshot the grid."""
    events = []

    class OvershootRunner(FakeRunner):
        def run_until_device(self, s, t_sim, chunk=32):
            s = super().run_until_device(s, t_sim, chunk)
            return dataclasses.replace(s, t_now=int((t_sim + 5.0) * NS))

    loop = _fake_loop(events, ServiceParams(window_sim_s=1.0, chunk=4),
                      runner=OvershootRunner(events), ingest=_Ingest(events),
                      fetch=lambda snap: snap)
    loop.run(n_windows=2)
    assert [e[0] for e in events] == ["inject", "dispatch", "drain",
                                      "inject", "dispatch", "drain"]
    # the clock sits at 6.0 after the overshoot: the target is 7.0, not
    # the grid's 2.0 (which would run zero ticks)
    assert [e[2] for e in events if e[0] == "dispatch"] == [1.0, 7.0]
    assert events[3] == ("inject", 7 * NS)


def test_ingest_one_fetch_per_window_after_first():
    """Serving windows reuse the drained snapshot's clock: after window
    0's fresh clock read, every window costs exactly ONE fetch."""
    events, clock_reads, drains = [], [], []

    def fetch(snap):
        (drains if isinstance(snap, dict) else clock_reads).append(snap)
        return snap

    loop = _fake_loop(events, ServiceParams(window_sim_s=1.0, chunk=4),
                      ingest=_Ingest([]), fetch=fetch)
    loop.run(n_windows=4)
    assert len(drains) == 4 and len(clock_reads) == 1
    loop.run(n_windows=2)
    assert len(drains) == 6 and len(clock_reads) == 1
