"""Inbox selection (+ payload gather): CUDA kernels and plain versions.

Replaces the TPU kernel ``oversim_tpu/kernels/inbox.py:_inbox_kernel``
in both its modes.  For every destination it picks the R earliest due
messages by ``(t_deliver, pool index)`` and marks them delivered;
``inbox_select_gather`` (the dense tick) also gathers their ``[W]``
payload rows (row 0 for empty entries, masked by ``inbox < 0``
downstream), ``inbox_select`` (the sparse tick) does not;
``inbox_gather`` is the gather alone (its own entry, for checks and
timing; ``inbox_select_gather`` runs the same kernel).  The source
(``csrc/inbox.cu``) says how the serial TPU walk became a bucketed
parallel selection (one memset and four kernels, a warp or a block per
destination), what bounds it on the card and why its result is
independent of the order of work.  ``t_deliver`` is taken as int64: the
hi/lo int32 split and the occupancy early-out of the TPU kernel are
gone.

The wrapper takes the plain version only for tensors on the CPU; on the
card it launches the kernel or raises.
"""

from __future__ import annotations

import torch

from oversim_tpu_torch import kernels
from oversim_tpu_torch.engine import pool as pool_mod

I32 = torch.int32
I64 = torch.int64
MAX_R = 32
SCAN_TILE = 1024   # counts per block of the offset scan (csrc/inbox.cu)


def scratch_words(n: int, p: int) -> int:
    """int32 words of scratch for ``csrc/inbox.cu`` (its head comment):
    counts, fill cursors, the scan's counter and tile status words,
    bucket offsets and the buckets."""
    n4 = (n + 4) // 4 * 4
    return 3 * n4 + 4 * (-(-n // SCAN_TILE) + 1) + p


def inbox_select_plain(due, dst, t_deliver, n: int, r: int):
    """Plain PyTorch version: a stable (dst, t_deliver, index) sort and
    the rank inside each destination's run."""
    p = due.shape[0]
    dev = due.device
    idx = torch.arange(p, device=dev)
    dst_k = torch.where(due, dst.to(I64), n)
    t_k = torch.where(due, t_deliver, pool_mod.T_INF)
    o1 = torch.sort(t_k, stable=True).indices
    o2 = torch.sort(dst_k[o1], stable=True).indices
    idx_s = idx[o1][o2]
    dst_s = dst_k[idx_s]
    rank = idx - torch.searchsorted(dst_s, dst_s, side="left")
    take = (dst_s < n) & (rank < r)
    flat = torch.where(take, dst_s * r + rank, n * r)
    inbox = torch.full((n * r + 1,), -1, dtype=I64, device=dev)
    inbox = inbox.scatter_reduce(0, flat, torch.where(take, idx_s, -1),
                                 reduce="amax")[:n * r].reshape(n, r)
    delivered = torch.zeros((p,), dtype=torch.bool, device=dev)
    delivered = delivered.scatter(0, idx_s, take)
    return inbox.to(I32), delivered


def inbox_gather_plain(inbox, blk):
    """Plain PyTorch version of the gather: row ``max(inbox[d, k], 0)``
    of ``blk``."""
    return blk[torch.clamp(inbox, min=0).long()]


def inbox_select_gather_plain(due, dst, t_deliver, blk, n: int, r: int):
    """``inbox_select_plain`` and a row gather."""
    inbox, delivered = inbox_select_plain(due, dst, t_deliver, n, r)
    return inbox, delivered, inbox_gather_plain(inbox, blk)


def _check_select_args(due, dst, t_deliver, r: int, what: str):
    p = due.shape[0]
    if not 1 <= r <= MAX_R:
        raise ValueError(f"{what}: R={r} outside [1, {MAX_R}]")
    kernels.require(due, torch.bool, (p,), "due")
    kernels.require(dst, I32, (p,), "dst")
    kernels.require(t_deliver, I64, (p,), "t_deliver")


def _check_gather_size(n: int, r: int, w: int, what: str):
    if n * r * w >= 2**31:
        raise ValueError(f"{what}: N*R*W = {n * r * w} words, the kernel "
                         "takes fewer than 2^31")


def inbox_select(due, dst, t_deliver, n: int, r: int):
    """``(inbox [N, R] i32, delivered [P] bool)`` for ``due`` [P] bool,
    ``dst`` [P] i32 already clipped to ``[0, N)`` and ``t_deliver`` [P]
    i64."""
    if not due.is_cuda:
        return inbox_select_plain(due, dst, t_deliver, n, r)
    _check_select_args(due, dst, t_deliver, r, "inbox_select")
    p = due.shape[0]
    dev = due.device
    inbox = torch.empty((n, r), dtype=I32, device=dev)
    delivered = torch.empty((p,), dtype=torch.bool, device=dev)
    scratch = torch.empty((scratch_words(n, p),), dtype=I32, device=dev)
    lib = kernels.library("inbox")
    code = lib.inbox_select(
        due.data_ptr(), dst.data_ptr(), t_deliver.data_ptr(),
        inbox.data_ptr(), delivered.data_ptr(), scratch.data_ptr(), n, r, p,
        kernels.stream_ptr(dev))
    kernels.check(code, "inbox_select")
    kernels.LAUNCHES["inbox_select"] += 1
    return inbox, delivered


def inbox_select_gather(due, dst, t_deliver, blk, n: int, r: int):
    """``(inbox [N, R] i32, delivered [P] bool, gblk [N, R, W] i32)``.

    ``due`` [P] bool, ``dst`` [P] i32 already clipped to ``[0, N)``,
    ``t_deliver`` [P] i64, ``blk`` [P, W] i32."""
    if not due.is_cuda:
        return inbox_select_gather_plain(due, dst, t_deliver, blk, n, r)
    p, w = blk.shape
    _check_select_args(due, dst, t_deliver, r, "inbox_select_gather")
    kernels.require(blk, I32, (p, w), "blk")
    _check_gather_size(n, r, w, "inbox_select_gather")
    dev = due.device
    inbox = torch.empty((n, r), dtype=I32, device=dev)
    delivered = torch.empty((p,), dtype=torch.bool, device=dev)
    gblk = torch.empty((n, r, w), dtype=I32, device=dev)
    scratch = torch.empty((scratch_words(n, p),), dtype=I32, device=dev)
    lib = kernels.library("inbox")
    code = lib.inbox_select_gather(
        due.data_ptr(), dst.data_ptr(), t_deliver.data_ptr(),
        blk.data_ptr(), inbox.data_ptr(), delivered.data_ptr(),
        gblk.data_ptr(), scratch.data_ptr(), n, r, p, w,
        kernels.stream_ptr(dev))
    kernels.check(code, "inbox_select_gather")
    kernels.LAUNCHES["inbox_select_gather"] += 1
    return inbox, delivered, gblk


def inbox_gather(inbox, blk):
    """``gblk [N, R, W] i32``, row ``max(inbox[d, k], 0)`` of ``blk`` [P,
    W] i32 for ``inbox`` [N, R] i32 (entries below P)."""
    if not inbox.is_cuda:
        return inbox_gather_plain(inbox, blk)
    n, r = inbox.shape
    p, w = blk.shape
    kernels.require(inbox, I32, (n, r), "inbox")
    kernels.require(blk, I32, (p, w), "blk")
    _check_gather_size(n, r, w, "inbox_gather")
    gblk = torch.empty((n, r, w), dtype=I32, device=inbox.device)
    lib = kernels.library("inbox")
    code = lib.inbox_gather(inbox.data_ptr(), blk.data_ptr(),
                            gblk.data_ptr(), n, r, w,
                            kernels.stream_ptr(inbox.device))
    kernels.check(code, "inbox_gather")
    kernels.LAUNCHES["inbox_gather"] += 1
    return gblk


def fused_inbox(pool, n: int, r: int, t_end, alive, hold=None):
    """``pool.build_inbox`` plus the gathered payload:
    ``(inbox, delivered, to_dead, gblk)``."""
    due, to_dead = pool_mod.due_masks(pool, n, t_end, alive, hold)
    dstc = torch.clamp(pool.dst, 0, n - 1).contiguous()
    inbox, delivered, gblk = inbox_select_gather(
        due.contiguous(), dstc, pool.t_deliver.contiguous(),
        pool.blk.contiguous(), n, r)
    return inbox, delivered, to_dead, gblk


def fused_select(pool, n: int, r: int, t_end, alive, hold=None):
    """``pool.build_inbox`` through ``inbox_select``: ``(inbox,
    delivered, to_dead)``."""
    due, to_dead = pool_mod.due_masks(pool, n, t_end, alive, hold)
    dstc = torch.clamp(pool.dst, 0, n - 1).contiguous()
    inbox, delivered = inbox_select(due.contiguous(), dstc,
                                    pool.t_deliver.contiguous(), n, r)
    return inbox, delivered, to_dead
