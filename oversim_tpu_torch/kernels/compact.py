"""Active-set compaction: CUDA kernel and its plain version.

Replaces the TPU kernel ``oversim_tpu/kernels/outbox.py:_compact_kernel``
(the sparse tick's awake-node compaction): lane k receives ``vals[i]``
of the k-th set ``mask`` bit in index order, lanes past the set count
hold ``sentinel``, set bits past ``cap`` are dropped, and the TRUE set
count comes back as a device scalar (no host sync).  The caller rotates
the walk (``engine/sim.py``).  ``csrc/compact.cu`` runs it as a
multi-block stream compaction (a decoupled look-back scan, one
4,096-byte tile per block): one memset and one kernel per call.

The wrapper takes the plain version only for tensors on the CPU; on the
card it launches the kernel or raises.
"""

from __future__ import annotations

import torch

from oversim_tpu_torch import kernels

I32 = torch.int32
TILE = 4096        # mask bytes per block (csrc/compact.cu COMPACT_TILE)


def scratch_words(m: int) -> int:
    """int32 words of scratch for ``csrc/compact.cu`` (its head comment):
    the tile counter, a pad word and one 64-bit status word per tile."""
    return 2 + 2 * max(1, -(-m // TILE))


def compact_indices_plain(mask, vals, cap: int, sentinel: int):
    """Plain PyTorch version: each set bit's rank by an exclusive prefix
    sum, then one scatter (bits past ``cap`` land in a spare lane)."""
    m_i = mask.to(I32)
    rank = torch.cumsum(m_i, 0, dtype=I32) - m_i
    tgt = torch.where(mask & (rank < cap), rank, cap).long()
    lanes = torch.full((cap + 1,), sentinel, dtype=I32,
                       device=mask.device).scatter(0, tgt, vals.to(I32))
    return lanes[:cap], torch.sum(m_i, dtype=I32)


def compact_indices(mask, vals, cap: int, sentinel: int):
    """``(lanes [cap] i32, count i32 scalar)`` for ``mask`` [M] bool and
    ``vals`` [M] i32."""
    if not mask.is_cuda:
        return compact_indices_plain(mask, vals, cap, sentinel)
    m = mask.shape[0]
    if cap < 1:
        raise ValueError(f"compact_indices: cap={cap} must be positive")
    kernels.require(mask, torch.bool, (m,), "mask")
    kernels.require(vals, I32, (m,), "vals")
    dev = mask.device
    lanes = torch.empty((cap,), dtype=I32, device=dev)
    count = torch.empty((1,), dtype=I32, device=dev)
    scratch = torch.empty((scratch_words(m),), dtype=I32, device=dev)
    lib = kernels.library("compact")
    code = lib.compact_indices(mask.data_ptr(), vals.data_ptr(),
                               lanes.data_ptr(), count.data_ptr(),
                               scratch.data_ptr(), m, cap, sentinel,
                               kernels.stream_ptr(dev))
    kernels.check(code, "compact_indices")
    kernels.LAUNCHES["compact_indices"] += 1
    return lanes, count[0]
