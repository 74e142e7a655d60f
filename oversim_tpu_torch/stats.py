"""Global statistics with measurement-phase gating (PyTorch).

Counterpart of ``oversim_tpu/stats.py``: scalar accumulators keep
``(n, sum, sumsq, min, max)`` in float64, histograms and counters int64.
Handlers emit ``(values, mask)`` event arrays over the node axis and the
engine folds them in each tick.  Float sums are taken in row-major
order, one element after another (the last element of a cumulative
sum): that is how XLA-CPU reduces the small event arrays of the parity
tests (a few hundred elements), so those sums are bit-equal.  Larger
reductions XLA splits by shape; there the sums agree to about 1e-15
relative (measured at N=1,000).  On the card the sum is ``torch.sum``:
a CUDA cumsum is a parallel scan whose float64 result changes from run
to run (``scripts/torch_cumsum_probe.py``), and the card's identity
checks hold two runs to every bit.

The ensemble layer (``ensemble_reduce``) reduces a campaign's stacked
``[S, ...]`` accumulators on their device under the same rule; the CI
half-widths (Student-t, no scipy) attach host-side in numpy
(``ensemble_summary``, ``series_summary``).
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

F64 = torch.float64
I64 = torch.int64


@dataclasses.dataclass(frozen=True)
class StatSpec:
    scalars: tuple = ()
    hists: tuple = ()
    counters: tuple = ()


def init_stats(spec: StatSpec, device="cpu") -> dict:
    s = {}
    for name in spec.scalars:
        s["s:" + name] = torch.tensor([0.0, 0.0, 0.0, math.inf, -math.inf],
                                      dtype=F64, device=device)
    for name, bins in spec.hists:
        s["h:" + name] = torch.zeros((bins,), dtype=I64, device=device)
    for name in spec.counters:
        s["c:" + name] = torch.zeros((), dtype=I64, device=device)
    return s


def _seq_sum(x):
    flat = x.reshape(-1)
    if flat.is_cuda:
        return torch.sum(flat)
    if flat.numel() == 0:
        return torch.zeros((), dtype=x.dtype, device=x.device)
    return torch.cumsum(flat, 0)[-1]


def _seq_sum0(x):
    """Sum over the leading axis under ``_seq_sum``'s order rule."""
    if x.is_cuda:
        return torch.sum(x, 0)
    if x.shape[0] == 0:
        return x.new_zeros(tuple(x.shape[1:]))
    return torch.cumsum(x, 0)[-1]


def record(stats: dict, events: dict, gate) -> dict:
    """Fold one tick's events; ``gate`` is the measurement flag."""
    out = dict(stats)
    for key, ev in events.items():
        if key.startswith("s:"):
            vals, mask = ev
            vals = vals.to(F64)
            m = (mask & gate).to(F64)
            acc = out[key]
            out[key] = torch.stack([
                acc[0] + _seq_sum(m),
                acc[1] + _seq_sum(vals * m),
                acc[2] + _seq_sum(vals * vals * m),
                torch.minimum(acc[3], torch.min(
                    torch.where(m > 0, vals, math.inf))),
                torch.maximum(acc[4], torch.max(
                    torch.where(m > 0, vals, -math.inf))),
            ])
        elif key.startswith("h:"):
            idx, mask = ev
            acc = out[key]
            bins = acc.shape[0]
            idx = torch.clamp(idx, 0, bins - 1).reshape(-1).long()
            add = (mask & gate).to(I64).reshape(-1)
            out[key] = acc.index_add(0, idx, add)
        elif key.startswith("c:"):
            out[key] = out[key] + torch.sum(torch.as_tensor(
                ev, device=gate.device).to(I64)) * gate.to(I64)
        elif key.startswith("g:"):
            pass
        else:
            raise KeyError(f"unknown stat class: {key}")
    return out


def summarize(stats: dict) -> dict:
    """Host-side: accumulators → {name: {mean, stddev, min, max, count}},
    histograms → list, counters → int."""
    out = {}
    for key, val in stats.items():
        v = val.detach().cpu().numpy()
        name = key[2:]
        if key.startswith("s:"):
            n, s, s2 = float(v[0]), float(v[1]), float(v[2])
            mean = s / n if n else math.nan
            var = max(s2 / n - mean * mean, 0.0) if n else math.nan
            out[name] = {
                "count": int(n), "mean": mean,
                "stddev": math.sqrt(var) if n else math.nan,
                "min": float(v[3]) if n else math.nan,
                "max": float(v[4]) if n else math.nan,
            }
        elif key.startswith("h:"):
            out[name] = v.tolist()
        else:
            out[name] = int(v)
    return out


# -- cross-replica ensemble layer (oversim_tpu_torch/campaign/) -------------
#
# A stacked campaign state holds "s:name" -> [S, 5], "h:name" -> [S, B]
# and "c:name" -> [S]; the reduce runs on the state's device and returns
# small tensors, one transfer away from ``ensemble_summary``.

def ensemble_reduce(stats: dict) -> dict:
    """Stacked accumulators -> per-replica and cross-replica moments.

    Scalars ("s:") -> {per_count, per_mean, per_stddev [S], mean,
    stddev, sem, k}, the cross-replica moments over the k replicas that
    recorded data (sample stddev, /(k-1)).  Histograms ("h:") ->
    per-replica probability mass functions and their per-bin
    cross-replica mean/stddev/sem, raw counts and their sums.  Counters
    ("c:") -> per-replica values, total, mean, stddev, sem."""
    out = {}
    for key, acc in stats.items():
        if key.startswith("s:"):
            n = acc[:, 0]
            has = n > 0
            safe_n = torch.clamp(n, min=1.0)
            per_mean = acc[:, 1] / safe_n
            per_var = torch.clamp(acc[:, 2] / safe_n - per_mean * per_mean,
                                  min=0.0)
            k = _seq_sum(has.to(F64))
            safe_k = torch.clamp(k, min=1.0)
            mean = _seq_sum(torch.where(has, per_mean, 0.0)) / safe_k
            dev2 = torch.where(has, (per_mean - mean) ** 2, 0.0)
            stddev = torch.sqrt(_seq_sum(dev2)
                                / torch.clamp(k - 1.0, min=1.0))
            out[key] = dict(per_count=n, per_mean=per_mean,
                            per_stddev=torch.sqrt(per_var), mean=mean,
                            stddev=stddev, sem=stddev / torch.sqrt(safe_k),
                            k=k)
        elif key.startswith("h:"):
            counts = acc.to(F64)
            tot = torch.sum(counts, 1)       # integers: exact in any order
            has = tot > 0
            pmf = counts / torch.clamp(tot, min=1.0)[:, None]
            k = _seq_sum(has.to(F64))
            safe_k = torch.clamp(k, min=1.0)
            mean = _seq_sum0(torch.where(has[:, None], pmf, 0.0)) / safe_k
            dev2 = torch.where(has[:, None], (pmf - mean[None, :]) ** 2, 0.0)
            stddev = torch.sqrt(_seq_sum0(dev2)
                                / torch.clamp(k - 1.0, min=1.0))
            out[key] = dict(per_counts=acc, per_total=tot, per_pmf=pmf,
                            mean=mean, stddev=stddev,
                            sem=stddev / torch.sqrt(safe_k), k=k,
                            total=torch.sum(acc, 0))
        elif key.startswith("c:"):
            v = acc.to(F64)
            s = v.shape[0]
            mean = _seq_sum(v) / s
            var = (_seq_sum((v - mean) ** 2) / (s - 1.0) if s > 1
                   else torch.zeros((), dtype=F64, device=v.device))
            out[key] = dict(per_replica=acc, total=torch.sum(acc),
                            mean=mean, stddev=torch.sqrt(var),
                            sem=torch.sqrt(var) / math.sqrt(s))
    return out


# two-sided Student-t critical values, t_{df, 1-alpha/2}; the normal
# quantile past 30 degrees of freedom
_T_TABLE = {
    0.95: (12.706, 4.303, 3.182, 2.776, 2.571, 2.447, 2.365, 2.306, 2.262,
           2.228, 2.201, 2.179, 2.160, 2.145, 2.131, 2.120, 2.110, 2.101,
           2.093, 2.086, 2.080, 2.074, 2.069, 2.064, 2.060, 2.056, 2.052,
           2.048, 2.045, 2.042),
    0.99: (63.657, 9.925, 5.841, 4.604, 4.032, 3.707, 3.499, 3.355, 3.250,
           3.169, 3.106, 3.055, 3.012, 2.977, 2.947, 2.921, 2.898, 2.878,
           2.861, 2.845, 2.831, 2.819, 2.807, 2.797, 2.787, 2.779, 2.771,
           2.763, 2.756, 2.750),
}
_T_NORMAL = {0.95: 1.960, 0.99: 2.576}


def t_critical(df: int, confidence: float = 0.95) -> float:
    """Two-sided Student-t critical value (table lookup)."""
    if confidence not in _T_TABLE:
        raise ValueError(f"confidence must be one of {sorted(_T_TABLE)}")
    if df < 1:
        return math.nan
    tab = _T_TABLE[confidence]
    return tab[df - 1] if df <= len(tab) else _T_NORMAL[confidence]


def _clean(a):
    return [None if x != x else float(x) for x in np.asarray(a, float)]


def series_summary(values, confidence: float = 0.95) -> dict:
    """Cross-replica CI bands of a ``[S, K]`` series (host-side numpy):
    per sample point, the mean, stddev, sem and Student-t half-width
    over the replicas that carry data there (NaN entries excluded; None
    where fewer than two do)."""
    v = np.asarray(values, float)
    if v.ndim != 2:
        raise ValueError(f"series_summary wants [S, K], got {v.shape}")
    s, _ = v.shape
    has = ~np.isnan(v)
    k = has.sum(axis=0)
    safe_k = np.maximum(k, 1)
    mean = np.where(k > 0, np.nansum(v, axis=0) / safe_k, np.nan)
    dev2 = np.where(has, (v - mean[None, :]) ** 2, 0.0)
    var = dev2.sum(axis=0) / np.maximum(k - 1, 1)
    stddev = np.sqrt(var)
    sem = stddev / np.sqrt(safe_k)
    t = np.array([t_critical(int(ki) - 1, confidence) if ki > 1
                  else math.nan for ki in k])
    return {"kind": "series", "replicas": s, "k": k.astype(int).tolist(),
            "mean": _clean(mean), "stddev": _clean(stddev),
            "sem": _clean(sem), "ci": _clean(t * sem),
            "confidence": confidence}


def ensemble_summary(reduced: dict, confidence: float = 0.95) -> dict:
    """Host-side: Student-t CI half-widths (ci = t_{k-1} * sem) on an
    ``ensemble_reduce`` result (tensors or arrays), leaves as plain
    python.  Per metric — scalar: {kind, k, mean, stddev, sem, ci,
    confidence, per_replica: {count, mean, stddev}}; hist: the same per
    bin plus raw counts; counter: {kind, total, mean, stddev, sem, ci,
    confidence, per_replica}."""
    def a(x):
        return x.detach().cpu().numpy() if torch.is_tensor(x) \
            else np.asarray(x)

    out = {}
    for key, r in reduced.items():
        name = key[2:]
        if key.startswith("s:"):
            k = int(a(r["k"]))
            t = t_critical(k - 1, confidence) if k > 1 else math.nan
            sem = float(a(r["sem"]))
            out[name] = {
                "kind": "scalar", "k": k, "mean": float(a(r["mean"])),
                "stddev": float(a(r["stddev"])), "sem": sem,
                "ci": t * sem if k > 1 else math.nan,
                "confidence": confidence,
                "per_replica": {
                    "count": a(r["per_count"]).astype(int).tolist(),
                    "mean": a(r["per_mean"]).tolist(),
                    "stddev": a(r["per_stddev"]).tolist()}}
        elif key.startswith("h:"):
            k = int(a(r["k"]))
            t = t_critical(k - 1, confidence) if k > 1 else math.nan
            sem = a(r["sem"])
            out[name] = {
                "kind": "hist", "k": k, "mean": a(r["mean"]).tolist(),
                "stddev": a(r["stddev"]).tolist(), "sem": sem.tolist(),
                "ci": (t * sem).tolist() if k > 1
                else [math.nan] * sem.shape[0],
                "confidence": confidence,
                "total": a(r["total"]).astype(int).tolist(),
                "per_replica": {
                    "counts": a(r["per_counts"]).astype(int).tolist(),
                    "total": a(r["per_total"]).astype(int).tolist()}}
        else:
            pr = a(r["per_replica"])
            s = pr.shape[0]
            t = t_critical(s - 1, confidence) if s > 1 else math.nan
            sem = float(a(r["sem"]))
            out[name] = {
                "kind": "counter", "total": int(a(r["total"])),
                "mean": float(a(r["mean"])), "stddev": float(a(r["stddev"])),
                "sem": sem, "ci": t * sem if s > 1 else math.nan,
                "confidence": confidence,
                "per_replica": pr.astype(int).tolist()}
    return out
