"""The double-buffered serving loop with preemption-safe checkpoints.

Counterpart of ``oversim_tpu/service/loop.py``.  Windows of
``window_sim_s`` simulated seconds are dispatched through the runner's
``run_until_device``, and window k's host side (the fetch of its counter
snapshot, its summary, its checkpoint) runs after window k+1 has been
dispatched:

      device   |  win k   |  win k+1  |  win k+2  |
      host          | fetch k-1 | fetch k  | fetch k+1 |

  * dispatch window k+1, THEN block on window k's fetch: exactly ONE
    fetch (one host wait) per window, visible as ``window_dispatch`` /
    ``window_fetch`` spans in a ``telemetry.PerfettoTrace``.  The port
    issues every launch from the host, and its ``run_until_device``
    returns once the window's last chunk has run, so the overlap is the
    host's: window k's drain runs while nothing of k+1 is left to issue;
  * the snapshots are real copies (``clone`` on the stream, enqueued
    before the next dispatch), so no later phase can change them; the
    fetch copies them into pinned host memory and waits on one CUDA
    event (``tree.to_host``);
  * every ``checkpoint_every`` windows the full state is copied with the
    counters and written through ``checkpoint.py`` (tmp + rename, so a
    SIGKILL at any instant leaves a complete checkpoint).  With
    ``write_behind`` (the default) the write runs on a writer thread
    while the next windows are issued (zlib and file writes release the
    GIL); the next checkpoint, ``checkpoint_now`` and the end of ``run``
    wait for it.  ``resume`` restores the last checkpoint and continues
    BIT-IDENTICALLY: window targets are ``start + (k + 1) * window_sim_s``
    from the checkpointed origin, recomputed and never accumulated.

``runner`` is anything with ``run_until_device(state, t_sim, chunk=)``:
a Simulation (solo SimState) or a Campaign (a list of S rows, summarized
and checkpointed in the stacked ``[S, ...]`` layout).

With an ``ingest`` source (service/ingest.py) the loop runs
single-buffered: the requests enter as one batched ``EXT_IN`` pool write
at the window boundary, are served inside the window, and their
``EXT_OUT`` answers (parked in the pool by ``EngineParams.ext_hold_slot``)
are drained after it: a host read of the pool, which forces the wait the
double-buffered mode avoids.
"""

from __future__ import annotations

import dataclasses
import threading
import time

import numpy as np
import torch

from oversim_tpu_torch import checkpoint as ckpt_mod
from oversim_tpu_torch import stats as stats_mod
from oversim_tpu_torch import telemetry as telemetry_mod
from oversim_tpu_torch import tree

NS = 1_000_000_000


@dataclasses.dataclass(frozen=True)
class ServiceParams:
    """Knobs of the serving loop (the JAX package's ``**.service.*``)."""

    window_sim_s: float = 1.0     # simulated seconds per window
    chunk: int = 32               # ticks per enqueued chunk
    checkpoint_every: int = 0     # windows between checkpoints (0 = off)
    checkpoint_path: str | None = None
    max_windows: int = 0          # absolute window count to serve (0 = ∞)
    max_wall_s: float = 0.0       # wall-clock budget per run() (0 = ∞)
    double_buffer: bool = True    # fetch k after dispatching k+1
    realtime: bool = False        # pace windows to the wall clock


@dataclasses.dataclass
class _Pending:
    """An in-flight window: dispatched, not yet drained."""

    window: int                   # 0-based window index
    target_sim_t: float
    t_d0: float                   # dispatch span (host clock)
    t_d1: float
    snap: dict                    # COPIES of the counter leaves (and of
                                  # the full state under "state")


def _rows(s) -> bool:
    return isinstance(s, list)


def state_t_now(s):
    """A solo state's clock, or the ``[S]`` clocks of a campaign's rows."""
    return torch.stack([r.t_now for r in s]) if _rows(s) else s.t_now


def counter_leaf_refs(s) -> dict:
    """The per-window counter leaves: stats accumulators, engine
    counters, clock, tick, alive mask, telemetry rings when present
    (stacked ``[S, ...]`` for a campaign's rows)."""
    if _rows(s):
        out = {name: tree.stack([getattr(r, name) for r in s])
               for name in ("stats", "counters", "t_now", "tick", "alive")}
        if s[0].telemetry is not None:
            out["telemetry"] = tree.stack([r.telemetry for r in s])
        return out
    leaves = {"stats": s.stats, "counters": s.counters,
              "t_now": s.t_now, "tick": s.tick, "alive": s.alive}
    tel = getattr(s, "telemetry", None)
    if tel is not None:
        leaves["telemetry"] = tel
    return leaves


def _np(x):
    """A fetched leaf as numpy (a card tensor raises: summaries read only
    what the window's fetch brought over)."""
    return x.detach().numpy() if torch.is_tensor(x) else np.asarray(x)


def _summarize_stats(stats: dict) -> dict:
    return stats_mod.summarize({k: torch.as_tensor(_np(v))
                                for k, v in stats.items()})


def summarize_counter_leaves(leaves) -> dict:
    """Host-side summary of fetched leaves (no device access: the
    window's one wait stays the loop's fetch)."""
    out = _summarize_stats(leaves["stats"])
    out["_engine"] = {k: int(_np(v)) for k, v in leaves["counters"].items()}
    out["_t_sim"] = float(_np(leaves["t_now"])) / 1e9
    out["_ticks"] = int(_np(leaves["tick"]))
    out["_alive"] = int(_np(leaves["alive"]).sum())
    return out


def campaign_summarize_leaves(leaves) -> dict:
    """Campaign leaves carry a leading ``[S]`` axis: aggregate across
    replicas first (scalar accumulators merge exactly: sums of
    n/sum/sumsq, min of mins, max of maxes; histograms and counters
    sum), then the solo summary, so a record keeps the solo schema."""
    agg = {}
    for key, v in leaves["stats"].items():
        v = _np(v)
        if key.startswith("s:"):
            agg[key] = np.concatenate(
                [v[:, :3].sum(axis=0), [v[:, 3].min()], [v[:, 4].max()]])
        else:
            agg[key] = v.sum(axis=0)
    out = _summarize_stats(agg)
    out["_engine"] = {k: int(_np(v).sum())
                      for k, v in leaves["counters"].items()}
    # replicas advance on their own event horizons: report the LAGGING
    # clock, so the simulated time covered is never overstated
    out["_t_sim"] = float(_np(leaves["t_now"]).min()) / 1e9
    out["_ticks"] = int(_np(leaves["tick"]).sum())
    out["_alive"] = int(_np(leaves["alive"]).sum())
    return out


def _default_copy(t):
    """Stream-ordered device copies: enqueued behind the dispatch and
    ahead of the next one, so they hold this window's values."""
    return tree.tree_map(lambda x: x.clone(), t)


def _min_sim_t(t_now) -> float:
    # solo: a scalar; campaign: the [S] clocks, the lagging one counts
    return float(_np(t_now).min()) / NS


class ServiceLoop:
    """Resident serving loop over a Simulation or a Campaign.

    Parameters beyond ``(runner, state, params)``:

    config          scenario description; its ``telemetry.config_hash``
                    goes into every checkpoint and is enforced on resume
    on_window       ``f(window, summary, wall_s)`` per drained window
    ingest          request source (service/ingest.py:
                    ``before_window(state, target_ns)`` /
                    ``after_window(state)``); forces single-buffering
    trace           telemetry.PerfettoTrace: window_dispatch /
                    window_fetch / checkpoint_write spans
    events          ``f(kind, **fields)`` lifecycle sink, fired at the
                    loop's host waits only (``window_dispatched`` /
                    ``window_fetched`` / ``checkpoint_written``)
    summarize       fetched leaves -> dict (campaign_summarize_leaves
                    for a Campaign)
    fetch / copy    host-wait and device-copy hooks (fake harnesses)
    now             host clock (fake-timer tests)
    write_behind    write checkpoints on a writer thread (default)
    windows_done / start_sim_t
                    resume bookkeeping: use :meth:`resume` instead
    """

    def __init__(self, runner, state, params: ServiceParams, *,
                 config=None, on_window=None, ingest=None, trace=None,
                 events=None, summarize=None, fetch=None, copy=None,
                 now=time.perf_counter, write_behind: bool = True,
                 windows_done: int = 0, start_sim_t: float | None = None):
        self.runner = runner
        self.state = state
        self.p = params
        self.config_hash = (None if config is None
                            else telemetry_mod.config_hash(config))
        self.on_window = on_window
        self.ingest = ingest
        self.trace = trace
        self.events = events
        self.now = now
        self.summarize = summarize or summarize_counter_leaves
        self.fetch = fetch or tree.to_host
        self.copy = copy or _default_copy
        self.write_behind = write_behind
        self.windows_done = windows_done
        self.checkpoints_written = 0
        self.last_checkpoint = None   # windows_done of the newest ckpt
        self.last_checkpoint_bytes = None
        self._writing = None          # (thread, result box, windows_done)
        if start_sim_t is None:
            # fresh start: the window origin is the state's clock (resume
            # takes the ORIGINAL origin from the checkpoint manifest)
            start_sim_t = _min_sim_t(self.fetch(state_t_now(state)))
        self.start_sim_t = float(start_sim_t)
        self._launched = windows_done  # next window index to dispatch
        self._pending: _Pending | None = None
        self._last_sim_t = None       # clock of the last drained window
        self._stop = False
        self._t0 = None

    # ---------------------------------------------------- lifecycle ----
    @classmethod
    def resume(cls, runner, example_state, params: ServiceParams, *,
               path: str | None = None, config=None,
               override_cadence: bool = False, reshard: bool = False,
               **kw):
        """Restore the last checkpoint and continue bit-identically.

        ``example_state`` gives the structure (``sim.init()`` /
        ``campaign.init()``), on the device the run continues on;
        ``config`` (when given) must hash to the checkpoint's
        ``config_hash``.  The checkpointed cadence (``window_sim_s``,
        ``chunk``) must match ``params``, since a change moves every later
        window target; ``override_cadence=True`` accepts it and
        RE-ANCHORS the origin at the restored clock (next target =
        restored t_now + the new window).  ``reshard`` (restoring at
        another replica count) needs the elastic plane, ROADMAP Queue A
        item 15."""
        if reshard:
            raise NotImplementedError(
                "resume(reshard=True) needs the elastic plane (elastic/), "
                "which is not ported yet (ROADMAP Queue A item 15)")
        path = path or params.checkpoint_path
        if path is None:
            raise ValueError("resume needs a checkpoint path")
        expect = (None if config is None
                  else telemetry_mod.config_hash(config))
        state = ckpt_mod.load(path, example_state, expect_config=expect)
        svc = ckpt_mod.read_meta(path).get("service") or {}
        mismatch = [name for name in ("window_sim_s", "chunk")
                    if svc.get(name) is not None
                    and svc.get(name) != getattr(params, name)]
        windows_done = int(svc.get("windows_done", 0))
        start_sim_t = svc.get("start_sim_t")
        if mismatch and not override_cadence:
            name = mismatch[0]
            raise ValueError(
                f"resume cadence mismatch: checkpoint ran with "
                f"{name}={svc.get(name)} but params say "
                f"{getattr(params, name)}"
                " — window targets would diverge from the uninterrupted"
                " run (pass override_cadence=True / --override-cadence"
                " to re-anchor the window origin at the restored clock"
                " instead)")
        if mismatch:
            # the origin that puts the NEXT target one new window past the
            # restored clock; later targets are recomputed from it
            fetch = kw.get("fetch") or tree.to_host
            start_sim_t = (_min_sim_t(fetch(state_t_now(state)))
                           - windows_done * params.window_sim_s)
        return cls(runner, state, params, config=config,
                   windows_done=windows_done,
                   start_sim_t=start_sim_t, **kw)

    def stop(self):
        """Request a graceful stop after the current window drains."""
        self._stop = True

    def checkpoint_now(self) -> bool:
        """Write a checkpoint of the CURRENT state now (the graceful
        shutdown path: ``stop``, let ``run`` drain, then this).  False
        when no checkpoint path is configured."""
        if not self.p.checkpoint_path:
            return False
        self._join_write()
        self._write_checkpoint(self.copy(self.state), behind=False)
        return True

    # ---------------------------------------------------- the loop -----
    def run(self, n_windows: int | None = None):
        """Serve windows until a limit hits: ``n_windows`` more from
        here, the absolute ``params.max_windows``, the per-call
        ``params.max_wall_s`` budget, or :meth:`stop`.  Returns
        ``(state, windows_done)`` after draining the in-flight window and
        finishing any checkpoint write."""
        p = self.p
        limit = None
        if n_windows is not None:
            limit = self.windows_done + n_windows
        elif p.max_windows:
            limit = p.max_windows
        self._t0 = self.now()
        self._stop = False
        rt0 = time.monotonic()
        # realtime pacing origin: sim offset of this run()'s first window
        self._rt_sim0 = self.start_sim_t + self._launched * p.window_sim_s
        while not self._stop:
            if limit is not None and self._launched >= limit:
                break
            if p.max_wall_s and self.now() - self._t0 >= p.max_wall_s:
                break
            self._step_window(rt0)
        if self._pending is not None:
            rec, self._pending = self._pending, None
            self._drain(rec)
        self._join_write()
        return self.state, self.windows_done

    def _step_window(self, rt0):
        p = self.p
        k = self._launched
        target = self.start_sim_t + (k + 1) * p.window_sim_s
        if self.ingest is not None:
            # serving windows track the ACTUAL clock (a grid target below
            # t_now would run zero ticks and strand the injected
            # requests); the clock comes from the previous window's
            # drained snapshot, so only the first window pays a read
            if self._pending is None and self._last_sim_t is not None:
                cur = self._last_sim_t
            else:
                cur = _min_sim_t(self.fetch(state_t_now(self.state)))
            target = max(target, cur + p.window_sim_s)
        if p.realtime:
            ahead = target - self._rt_sim0 - (time.monotonic() - rt0)
            if ahead > 0:
                time.sleep(ahead)
        if self.ingest is not None:
            # one batched pool write, delivered as the window starts
            s = self.ingest.before_window(self.state, int(target * NS))
            if s is not None:
                self.state = s
        t_d0 = self.now()
        self.state = self.runner.run_until_device(self.state, target,
                                                  chunk=p.chunk)
        t_d1 = self.now()
        self._launched = k + 1
        # copies enqueued behind the dispatch, ahead of the next one
        snap = self.copy(counter_leaf_refs(self.state))
        if (p.checkpoint_every and p.checkpoint_path
                and (k + 1) % p.checkpoint_every == 0):
            snap["state"] = self.copy(self.state)
        rec = _Pending(window=k, target_sim_t=target, t_d0=t_d0,
                       t_d1=t_d1, snap=snap)
        if self.events is not None:
            self.events("window_dispatched", window=k, target_sim_t=target)
        if p.double_buffer and self.ingest is None:
            prev, self._pending = self._pending, rec
            if prev is not None:
                self._drain(prev)     # fetch k-1 AFTER dispatching k
        else:
            self._drain(rec)
            if self.ingest is not None:
                s = self.ingest.after_window(self.state)
                if s is not None:
                    self.state = s

    def _drain(self, rec: _Pending):
        """Window k's host side: the ONE wait (the fetch of its copies),
        trace spans, its checkpoint and the report callback."""
        t_f0 = self.now()
        leaves = self.fetch(rec.snap)
        t_f1 = self.now()
        snapshot = leaves.pop("state", None)
        if "t_now" in leaves:
            # the next ingest boundary reuses the drained clock
            self._last_sim_t = _min_sim_t(leaves["t_now"])
        if self.trace is not None:
            self.trace.span("window_dispatch", rec.t_d0,
                            rec.t_d1 - rec.t_d0,
                            args={"window": rec.window,
                                  "target_sim_t": rec.target_sim_t})
            self.trace.span("window_fetch", t_f0, t_f1 - t_f0,
                            args={"window": rec.window})
        summary = self.summarize(leaves)
        self.windows_done = rec.window + 1
        if self.events is not None:
            self.events("window_fetched", window=rec.window,
                        fetch_s=t_f1 - t_f0)
        if snapshot is not None:
            self._write_checkpoint(snapshot, behind=self.write_behind)
        if self.on_window is not None:
            self.on_window(rec.window, summary, self.now() - self._t0)

    # ---------------------------------------------------- checkpoints --
    def _meta(self) -> dict:
        p = self.p
        meta = {}
        if self.config_hash is not None:
            meta["config_hash"] = self.config_hash
        # a Campaign records its identity (base seed, grid, rows)
        if hasattr(self.runner, "describe"):
            meta["campaign"] = self.runner.describe()
        meta["service"] = {
            "windows_done": self.windows_done,
            "start_sim_t": self.start_sim_t,
            "window_sim_s": p.window_sim_s,
            "chunk": p.chunk,
            "checkpoint_every": p.checkpoint_every,
        }
        return meta

    def _write_checkpoint(self, snapshot, behind: bool):
        """Write ``snapshot`` (host copies, or device copies for
        ``checkpoint_now``) with this moment's bookkeeping; ``behind``
        hands the write to a writer thread after the previous one ends."""
        self._join_write()
        meta, done = self._meta(), self.windows_done
        box = {}

        def work():
            t0 = self.now()
            try:
                box["bytes"] = ckpt_mod.save(self.p.checkpoint_path,
                                             snapshot, meta=meta)
            except BaseException as e:  # noqa: BLE001 — re-raised on join
                box["error"] = e
            box["span"] = (t0, self.now() - t0)

        if behind:
            th = threading.Thread(target=work, name="checkpoint-writer",
                                  daemon=True)
            th.start()
            self._writing = (th, box, done)
        else:
            work()
            self._writing = (None, box, done)
            self._join_write()

    def _join_write(self):
        """Wait for the checkpoint being written (if any) and book it."""
        if self._writing is None:
            return
        th, box, done = self._writing
        self._writing = None
        if th is not None:
            th.join()
        if "error" in box:
            raise box["error"]
        self.checkpoints_written += 1
        self.last_checkpoint = done
        self.last_checkpoint_bytes = box["bytes"]
        if self.trace is not None:
            t0, dur = box["span"]
            self.trace.span("checkpoint_write", t0, dur, tid=1,
                            args={"windows_done": done,
                                  "bytes": box["bytes"]})
        if self.events is not None:
            self.events("checkpoint_written", windows_done=done,
                        path=self.p.checkpoint_path)
