#!/usr/bin/env python3
"""Time design alternatives of two of the port's kernels on one CUDA card.

    python3 scripts/torch_kernel_variants.py

- ``compact_indices`` at the sparse path's shape (m = 65,536, cap =
  8,192, 2,818 set bits: the sparse path's 4.3% awake share) with
  1,024- and 4,096-byte tiles: ``csrc/compact.cu`` built with
  ``-DCOMPACT_THREADS=64`` and ``256``.
- The gather step of ``inbox_select_gather`` at the dense path's shape
  (N = 10,000, R = 16, W = 31, P = 80,000, 46,777 of the 160,000
  entries selected, the rest empty): the committed flat design
  (``kernels/inbox.py inbox_gather``, 4 output words per thread) and one
  warp per gathered row (``WARP_GATHER`` below).

Every variant launches on the current stream (a CUDA graph captures it),
is first checked against its plain version, then timed as
``chip_smoke.py``'s ``device_ms`` (a CUDA graph of 20 calls replayed
between CUDA events), the variants in turns A B B A.  Prints one JSON
line, then the card's nvidia-smi name and power limit.
"""

from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

WARP_GATHER = r"""
#include <cuda_runtime.h>
#include <stdint.h>

__global__ void gather_warp_rows(const int32_t* __restrict__ inbox,
                                 const int32_t* __restrict__ blk,
                                 int32_t* __restrict__ gblk, int rows,
                                 int w) {
  const int row = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;
  const int32_t* src = blk + (size_t)max(inbox[row], 0) * w;
  int32_t* dst = gblk + (size_t)row * w;
  for (int c = lane; c < w; c += 32) dst[c] = src[c];
}

extern "C" int gather_warp(const int32_t* inbox, const int32_t* blk,
                           int32_t* gblk, int n, int r, int w,
                           void* stream) {
  const int rows = n * r;
  gather_warp_rows<<<(rows + 7) / 8, 256, 0, (cudaStream_t)stream>>>(
      inbox, blk, gblk, rows, w);
  return (int)cudaGetLastError();
}
"""

M, CAP, AWAKE = 65_536, 8_192, 2_818
N, R, W, P, SELECTED = 10_000, 16, 31, 80_000, 46_777


def build(out_dir, name, source, defines=()):
    """nvcc ``source`` into ``out_dir/lib<name>.so``; returns (library,
    ptxas summary)."""
    import chip_smoke
    from oversim_tpu_torch import kernels
    lib = os.path.join(out_dir, f"lib{name}.so")
    cmd = [kernels._nvcc(), *kernels.NVCC_FLAGS, "-Xptxas", "-v",
           *[f"-D{d}" for d in defines], "-o", lib, source]
    log = subprocess.run(cmd, check=True, capture_output=True, text=True)
    return ctypes.CDLL(lib), chip_smoke.ptxas_summary(log.stdout + log.stderr)


def main() -> int:
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        sys.stderr.write("torch_kernel_variants: needs a CUDA card\n")
        return 2
    import chip_smoke
    from oversim_tpu_torch import kernels
    from oversim_tpu_torch.kernels import compact as compact_k
    from oversim_tpu_torch.kernels import inbox as inbox_k
    dev = torch.device("cuda", 0)
    out_dir = os.path.join(ROOT, "build", "variants")
    os.makedirs(out_dir, exist_ok=True)
    vp, ci = ctypes.c_void_p, ctypes.c_int
    rng = np.random.default_rng(5)
    variants, ptxas = {}, {}

    # compact_indices: tile size
    mask = torch.as_tensor(chip_smoke.exact_mask(rng, M, AWAKE), device=dev)
    vals = torch.as_tensor(rng.permutation(M).astype(np.int32), device=dev)
    for threads in (64, 256):
        tile = threads * 16
        lib, ptxas[f"compact_tile_{tile}"] = build(
            out_dir, f"compact_t{tile}",
            os.path.join(kernels.CSRC, "compact.cu"),
            (f"COMPACT_THREADS={threads}",))
        lib.compact_indices.argtypes = [vp] * 5 + [ci] * 3 + [vp]
        words = 2 + 2 * max(1, -(-M // tile))

        def call(lib=lib, words=words):
            lanes = torch.empty((CAP,), dtype=torch.int32, device=dev)
            count = torch.empty((1,), dtype=torch.int32, device=dev)
            scratch = torch.empty((words,), dtype=torch.int32, device=dev)
            kernels.check(lib.compact_indices(
                mask.data_ptr(), vals.data_ptr(), lanes.data_ptr(),
                count.data_ptr(), scratch.data_ptr(), M, CAP, M,
                kernels.stream_ptr(dev)),
                "compact variant")
            return lanes, count
        variants[f"compact_tile_{tile}"] = (
            call, compact_k.compact_indices_plain(mask, vals, CAP, M))

    # gather step: flat vs warp per row
    inbox = np.full(N * R, -1, np.int32)
    inbox[rng.choice(N * R, SELECTED, replace=False)] = rng.choice(
        P, SELECTED, replace=False)
    inbox = torch.as_tensor(inbox.reshape(N, R), device=dev)
    blk = torch.as_tensor(rng.integers(-2**31, 2**31 - 1, size=(P, W),
                                       dtype=np.int64).astype(np.int32),
                          device=dev)
    want = inbox_k.inbox_gather_plain(inbox, blk)
    variants["gather_flat4"] = (lambda: inbox_k.inbox_gather(inbox, blk),
                                want)
    src = os.path.join(out_dir, "gather_warp.cu")
    with open(src, "w") as f:
        f.write(WARP_GATHER)
    warp_lib, ptxas["gather_warp_per_row"] = build(out_dir, "gather_warp",
                                                   src)
    warp_lib.gather_warp.argtypes = [vp] * 3 + [ci] * 3 + [vp]

    def warp_call():
        gblk = torch.empty((N, R, W), dtype=torch.int32, device=dev)
        kernels.check(warp_lib.gather_warp(inbox.data_ptr(), blk.data_ptr(),
                                           gblk.data_ptr(), N, R, W,
                                           kernels.stream_ptr(dev)),
                      "gather variant")
        return gblk
    variants["gather_warp_per_row"] = (warp_call, want)

    for name, (fn, ref) in variants.items():
        got = fn()
        torch.cuda.synchronize()
        same = (torch.equal(got[0], ref[0]) and int(got[1][0]) == int(ref[1])
                if name.startswith("compact") else torch.equal(got, ref))
        if not same:
            raise AssertionError(f"{name} differs from its plain version")

    order = list(variants) + list(reversed(list(variants)))
    times = {name: [] for name in variants}
    for name in order:
        times[name].append(chip_smoke.time_graph(variants[name][0])[0])
    print(json.dumps({"compact": {"m": M, "cap": CAP, "set": AWAKE},
                      "gather": {"n": N, "r": R, "w": W, "p": P,
                                 "selected": SELECTED},
                      "device_ms": times, "ptxas": ptxas,
                      "timing": "CUDA graph of 20 calls, median of 5 "
                                "replays; order A B B A"}), flush=True)
    print(chip_smoke.nvidia_smi_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
