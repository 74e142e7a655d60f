"""Outbox slot allocation: CUDA kernel and its plain version.

Replaces the TPU kernel ``oversim_tpu/kernels/outbox.py:_dest_kernel``:
the j-th wanted outbox message (index order) takes the j-th free pool
slot (``valid == 0``, index order); unwanted messages and wanted ones
past the free supply get the sentinel P; ``overflow = max(wanted -
free, 0)``.  ``csrc/outbox.cu`` runs it as two multi-block stream
compactions (a decoupled look-back scan, one 4,096-byte tile per block);
at the main paths' shapes it is bound by launch and look-back latency,
not by its bytes.

The wrapper takes the plain version only for tensors on the CPU; on the
card it launches the kernel or raises.
"""

from __future__ import annotations

import torch

from oversim_tpu_torch import kernels

I32 = torch.int32
I64 = torch.int64
TILE = 4096        # mask bytes per block of each scan (csrc/outbox.cu TILE)


def alloc_dest_plain(valid, want):
    """Plain PyTorch version: the free-slot list by ``nonzero`` and each
    wanted message's rank by a prefix sum."""
    p = valid.shape[0]
    fslot = torch.nonzero(~valid).reshape(-1)
    n_free = fslot.shape[0]
    w = want.to(I64)
    rank = torch.cumsum(w, 0) - w
    got = want & (rank < n_free)
    padded = torch.cat([fslot, torch.full((1,), p, dtype=fslot.dtype,
                                          device=valid.device)])
    dest = torch.where(got, padded[torch.clamp(rank, max=n_free)], p)
    overflow = torch.clamp(torch.sum(w) - n_free, min=0)
    return dest.to(I32), overflow


def scratch_words(p: int, q: int) -> int:
    """int32 words of scratch for ``csrc/outbox.cu`` (its head comment):
    two tile counters, ``n_free`` and a pad word, one 64-bit status word
    per tile of each scan, and the free-slot list."""
    def tiles(x):
        return max(1, -(-x // TILE))
    return 4 + 2 * (tiles(p) + tiles(q)) + p


def alloc_dest(valid, want):
    """``(dest [Q] i32, overflow i64 scalar)`` for ``valid`` [P] bool and
    ``want`` [Q] bool."""
    if not valid.is_cuda:
        return alloc_dest_plain(valid, want)
    p, q = valid.shape[0], want.shape[0]
    kernels.require(valid, torch.bool, (p,), "valid")
    kernels.require(want, torch.bool, (q,), "want")
    dev = valid.device
    dest = torch.empty((q,), dtype=I32, device=dev)
    overflow = torch.empty((), dtype=I64, device=dev)
    scratch = torch.empty((scratch_words(p, q),), dtype=I32, device=dev)
    lib = kernels.library("outbox")
    code = lib.alloc_dest(valid.data_ptr(), want.data_ptr(),
                          dest.data_ptr(), overflow.data_ptr(),
                          scratch.data_ptr(), p, q, kernels.stream_ptr(dev))
    kernels.check(code, "alloc_dest")
    kernels.LAUNCHES["alloc_dest"] += 1
    return dest, overflow
