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
"""

from __future__ import annotations

import dataclasses
import math

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
