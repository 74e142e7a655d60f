"""Campaign runner: S replicas of one simulation (PyTorch).

Counterpart of ``oversim_tpu/campaign/runner.py``.  Replicas are seed
replicas (``CampaignParams.replicas`` per grid point; replica r starts
from ``fold_in(PRNGKey(base_seed), r)``) or a grid sweep: ``sweep`` maps
dotted parameter names (``churn.lifetimeMean``, ``engine.window``,
``app.testMsgInterval``) to value lists, and each row of the cartesian
product reaches ``Simulation.step(s, ov=...)`` as float64 scalars on the
card.  ``report`` gives every statistic as a cross-replica mean, stddev
and Student-t confidence interval.

Layout: a campaign state is a list of S solo ``SimState`` rows, and a
campaign tick steps every row with its own overrides.  A row therefore
issues exactly the launches of a solo run, and ``run_chunk`` over S rows
equals S solo runs leaf for leaf.  The JAX package's ``[S, ...]`` layout
(``tree.stack``) is built only for the report, the telemetry bands and
comparisons.

Time: each row's horizon is its own earliest event.  ``run_until_device``
gates every chunk of every row on one device bool, ``any(t_now <
target)`` over the rows, as the JAX package's while loop does: rows past
the target keep ticking until the slowest one crosses.
"""

from __future__ import annotations

import dataclasses
import itertools
import math

import numpy as np
import torch

from oversim_tpu_torch import rng as rng_mod
from oversim_tpu_torch import stats as stats_mod
from oversim_tpu_torch import telemetry as telemetry_mod
from oversim_tpu_torch import tree
from oversim_tpu_torch.engine.sim import NS


@dataclasses.dataclass(frozen=True)
class CampaignParams:
    """``replicas``: seed replicas per grid point (S = replicas x
    points); ``base_seed``: replica r starts from ``fold_in(PRNGKey(
    base_seed), r)``; ``sweep``: ((dotted name, (v0, v1, ...)), ...)
    grid axes, empty for a pure seed sweep; ``replica_ids``: a subset of
    the full campaign's global replica ids to run (row k is replica
    ``replica_ids[k]``, with its rng and grid point), None for all."""

    replicas: int = 4
    base_seed: int = 1
    sweep: tuple = ()
    replica_ids: tuple | None = None


def expand_grid(sweep) -> list:
    """Cartesian product of the sweep axes -> one {name: value} dict per
    grid point, row-major in declaration order."""
    sweep = tuple(sweep)
    if not sweep:
        return [{}]
    names = [name for name, _ in sweep]
    axes = [tuple(vals) for _, vals in sweep]
    return [dict(zip(names, combo)) for combo in itertools.product(*axes)]


def _host(x):
    return tree.tree_map(lambda t: t.detach().cpu(), x)


class Campaign:
    """S replicas of ``sim``::

        camp = Campaign(sim, CampaignParams(replicas=8))
        cs = camp.init()                        # S solo SimState rows
        cs = camp.run_until_device(cs, 600.0)
        report = camp.report(cs)
    """

    def __init__(self, sim, params: CampaignParams | None = None):
        self.sim = sim
        self.p = params or CampaignParams()
        if self.p.replicas < 1:
            raise ValueError("campaign needs at least one replica")
        self.grid = expand_grid(self.p.sweep)
        self.total = self.p.replicas * len(self.grid)
        if self.p.replica_ids is None:
            self.ids = tuple(range(self.total))
        else:
            self.ids = tuple(int(i) for i in self.p.replica_ids)
            if not self.ids:
                raise ValueError("campaign needs at least one replica id")
            bad = [i for i in self.ids if i < 0 or i >= self.total]
            if bad:
                raise ValueError(
                    f"replica_ids {bad} outside the campaign's "
                    f"0..{self.total - 1} id space")
        self.s = len(self.ids)
        # each row's overrides as float64 scalars on the card, made once
        self._ov = [sim.device_ov(self.replica_ov(r)) for r in range(self.s)]

    # -- per-replica identities ---------------------------------------------

    def replica_rng(self, r: int) -> torch.Tensor:
        """The key global replica r starts from: a solo
        ``sim.init_from_rng(camp.replica_rng(r))`` run is replica r."""
        return rng_mod.fold_in(
            rng_mod.PRNGKey(self.p.base_seed, self.sim.device), r)

    def replica_ov(self, r: int):
        """Row r's sweep overrides (None for a pure seed sweep): pass
        them to ``sim.step(s, ov=...)`` to step that row solo."""
        pt = self.grid[self.ids[r] // self.p.replicas]
        return dict(pt) if pt else None

    def describe(self) -> dict:
        """The campaign's identity as JSON-able values."""
        return {
            "replicas": self.p.replicas,
            "base_seed": self.p.base_seed,
            "sweep": [[name, list(vals)] for name, vals in self.p.sweep],
            "replica_ids": list(self.ids),
            "s": self.s,
            "total": self.total,
            "inbox_impl": (self.sim.ep.inbox_impl
                           if self.sim is not None else None),
        }

    # -- init and stepping ----------------------------------------------------

    def init(self) -> list:
        """One solo state per row; row r is global replica ``ids[r]``."""
        return [self.sim.init_from_rng(self.replica_rng(i), ov=self._ov[r])
                for r, i in enumerate(self.ids)]

    def run_chunk(self, cs: list, n_ticks: int) -> list:
        """``n_ticks`` ticks of every row, nothing read back."""
        return [self.sim.run_chunk(row, n_ticks, ov=self._ov[r])
                for r, row in enumerate(cs)]

    def _more(self, cs, target):
        return torch.any(torch.stack([row.t_now for row in cs]) < target)

    def run_until_device(self, cs: list, t_sim: float,
                         chunk: int = 256) -> list:
        """Every row past ``t_sim`` seconds.  Each chunk of every row is
        gated on the device by ``any(t_now < target)`` over the rows (a
        chunk enqueued after the last row crossed leaves every row as it
        was), and the host decides whether to enqueue another from the
        previous chunk's flag, copied back asynchronously."""
        target = int(t_sim * NS)
        cuda = self.sim.device.type == "cuda"
        seen = None
        while True:
            if seen is not None:
                ev, more = seen
                if cuda:
                    ev.synchronize()
                if not bool(more):
                    return cs
            active = self._more(cs, target)
            new = self.run_chunk(cs, chunk)
            cs = [tree.tree_map(lambda a, b: torch.where(active, a, b), n, o)
                  for n, o in zip(new, cs)]
            more = self._more(cs, target)
            if cuda:
                host = torch.empty((), dtype=torch.bool, pin_memory=True)
                host.copy_(more, non_blocking=True)
                ev = torch.cuda.Event()
                ev.record()
                seen = (ev, host)
            else:
                seen = (None, more)

    # -- rows and reports -----------------------------------------------------

    def replica_state(self, cs: list, r: int):
        """A copy of row r's state."""
        return tree.tree_map(lambda x: x.clone(), cs[r])

    def report(self, cs: list, confidence: float = 0.95) -> dict:
        """Every statistic as a cross-replica mean, stddev and Student-t
        CI with its per-replica values (``stats.ensemble_summary``), the
        derived ``kbr_delivery_ratio`` where KBRTest's counters exist,
        and ``_campaign``: the grid, per-row simulated time, ticks and
        alive nodes, engine counters summed over rows.  The reduce runs
        on the rows' device; one transfer brings it back."""
        reduced = stats_mod.ensemble_reduce(tree.stack([r.stats for r in cs]))
        meta = {"t_now": torch.stack([r.t_now for r in cs]),
                "tick": torch.stack([r.tick for r in cs]),
                "alive": torch.stack([torch.sum(r.alive) for r in cs]),
                "counters": tree.stack([r.counters for r in cs])}
        reduced, meta = _host((reduced, meta))
        out = stats_mod.ensemble_summary(reduced, confidence)

        if "kbr_sent" in out and "kbr_delivered" in out:
            sent = np.asarray(out["kbr_sent"]["per_replica"], float)
            deliv = np.asarray(out["kbr_delivered"]["per_replica"], float)
            has = sent > 0
            ratio = np.where(has, deliv / np.maximum(sent, 1.0), np.nan)
            k = int(has.sum())
            mean = float(ratio[has].mean()) if k else math.nan
            stddev = float(ratio[has].std(ddof=1)) if k > 1 else 0.0
            sem = stddev / math.sqrt(k) if k else math.nan
            t = stats_mod.t_critical(k - 1, confidence) if k > 1 else math.nan
            out["kbr_delivery_ratio"] = {
                "kind": "derived", "k": k, "mean": mean, "stddev": stddev,
                "sem": sem, "ci": t * sem if k > 1 else math.nan,
                "confidence": confidence,
                "per_replica": [None if math.isnan(x) else float(x)
                                for x in ratio]}

        out["_campaign"] = {
            "replicas": self.p.replicas,
            "grid": self.grid,
            "s": self.s,
            "inbox_impl": self.sim.ep.inbox_impl,
            "replica_ids": list(self.ids),
            "base_seed": self.p.base_seed,
            "confidence": confidence,
            "t_sim": (meta["t_now"].numpy() / NS).tolist(),
            "ticks": meta["tick"].numpy().tolist(),
            "alive": meta["alive"].numpy().tolist(),
            "engine": {k: int(v.sum()) for k, v in meta["counters"].items()},
        }
        return out

    def telemetry_report(self, cs: list, confidence: float = 0.95) -> dict:
        """Per-replica KPI series and cross-replica CI bands of the
        telemetry rings (``telemetry.ensemble_series``); {"enabled":
        False} when the simulation samples none."""
        if cs[0].telemetry is None:
            return {"enabled": False}
        return telemetry_mod.ensemble_series(
            _host(tree.stack([r.telemetry for r in cs])),
            confidence=confidence)
