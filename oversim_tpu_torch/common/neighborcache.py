"""Per-node RTT cache (NeighborCache), PyTorch.

Counterpart of ``oversim_tpu/common/neighborcache.py``.  The main path
(Kademlia without ``adaptive_timeouts`` or proximity-aware routing)
carries the cache in its state but never reads it, so the port has the
state and its init; the RTT estimator and the timeout / proximity hooks
are still to be ported (ROADMAP Queue A) and Kademlia raises when they
are asked for.
"""

from __future__ import annotations

import dataclasses

import torch

I32 = torch.int32
I64 = torch.int64
F32 = torch.float32
NO_NODE = -1


@dataclasses.dataclass(frozen=True)
class NcParams:
    capacity: int = 16


@dataclasses.dataclass
class NcState:
    peer: torch.Tensor       # [N, C] i32
    rtt_mean: torch.Tensor   # [N, C] f32 seconds (-1 = no sample)
    rtt_var: torch.Tensor    # [N, C] f32
    last: torch.Tensor       # [N, C] i64
    live: torch.Tensor       # [N, C] i32 S_*


def init(n: int, p: NcParams, device="cpu") -> NcState:
    c = p.capacity
    return NcState(
        peer=torch.full((n, c), NO_NODE, dtype=I32, device=device),
        rtt_mean=torch.full((n, c), -1.0, dtype=F32, device=device),
        rtt_var=torch.zeros((n, c), dtype=F32, device=device),
        last=torch.zeros((n, c), dtype=I64, device=device),
        live=torch.zeros((n, c), dtype=I32, device=device))
