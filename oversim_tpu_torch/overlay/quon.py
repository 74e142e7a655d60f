"""Quon: quadrant-based spatial AOI overlay (QuON) (PyTorch).

Counterpart of ``oversim_tpu/overlay/quon.py`` (reference Quon.{h,cc},
default.ini:338-348).  The whole Vast machinery (``overlay/vast.py``:
greedy point-query join, MOVE multicast with HINT discovery, soft-state
pruning) with QuON's neighbor admission: the plane around the node is
split into four quadrants, the nearest candidate of each is a binding
neighbor and sorts ahead of every other (first index on equal
distances, as JAX's ``argmin``), and the remaining slots fill with the
nearest direct neighbors (a stable sort).
"""

from __future__ import annotations

import dataclasses

import torch

from oversim_tpu_torch.overlay.vast import (FAR, NO_NODE, VastLogic,
                                            VastParams, move_mod,
                                            nearest_first)

I32 = torch.int32
F32 = torch.float32


@dataclasses.dataclass(frozen=True)
class QuonParams(VastParams):
    """default.ini:338-348 (AOI + softstate timeouts)."""


class QuonLogic(VastLogic):
    """Vast machinery with QuON quadrant-binding neighbor admission."""

    PREFIX = "quon"

    def _nbr_put(self, st, cands, cand_pos, now, me_pos, node_idx):
        d = self.p.max_nbr
        aug, augp, augs = self._merged(st, cands, cand_pos, now, node_idx)
        delta = augp - me_pos[:, None]
        used = aug != NO_NODE
        dist = torch.where(used, move_mod.norm(delta), FAR)
        quad = (delta[..., 0] > 0).to(I32) * 2 + (delta[..., 1] > 0).to(I32)
        cols = torch.arange(aug.shape[1], device=aug.device)
        binding = torch.zeros_like(used)
        for q in range(4):
            inq = (quad == q) & used
            jmin = torch.argmin(torch.where(inq, dist, FAR), 1)
            binding = binding | ((cols[None, :] == jmin[:, None])
                                 & torch.any(inq, 1)[:, None])
        sortkey = torch.where(binding, dist,
                              dist + torch.full((), 1e9, dtype=F32,
                                                device=dist.device))
        aug, augp, augs = nearest_first(sortkey, aug, augp, augs)
        return dataclasses.replace(st, nbr=aug[:, :d], nbr_pos=augp[:, :d],
                                   nbr_seen=augs[:, :d])
