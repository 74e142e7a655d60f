#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one NVIDIA card.

    python3 chip_smoke.py

Needs one CUDA card, ``nvcc`` and the checkout (it imports the port from
the directory it lives in; it imports nothing of JAX).  Every phase
prints one JSON line; any failure raises, exits non-zero and prints no
``ok`` line.  Phases:

  device        card name, count, and the nvidia-smi name/power line;
  build         nvcc builds of the CUDA kernels from csrc/ (in parallel);
  kernel_check  each kernel against its plain PyTorch version at the main
                path's shapes (N=10,000, R=16, P=80,000, W=31, Q=320,000)
                on random, empty, full, R-overflow and hold-mask pools:
                exact equality required;
  reference     the bench configuration at N=16 for 128 ticks on the card
                (kernels) and on the CPU (torch-ops oracle, held leaf-exact
                to the JAX package by tests/test_torch_kademlia.py):
                integer leaves equal, float leaves within 1e-12 relative;
  identity      50 ticks at N=10,000 from one state with
                inbox_impl="scatter" and "pallas": every leaf equal;
  main_path     Kademlia + KBRTest at N=10,000 (bench.py's configuration
                with 16 inbox and 32 outbox slots — with bench.py's 8 and
                16 the hot destinations' backlog grows without bound at
                this size, see PERF.md) on the kernels: warm-up to 45
                simulated s, a measured
                10 s window, the health gate (delivery >= 0.95, no pool or
                outbox overflow), each kernel's launch count (> 0);
  timing        each kernel and its plain version on the inputs of one
                more main-path tick (CUDA events, median of repeats);
  profile       torch.profiler over a few more main-path ticks: wall and
                device time per tick, device idle share, kernel launches
                per tick, the device ops that take the most time;
  kernels       one line listing the ported kernels;
then the nvidia-smi line and, last, ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))

N_MAIN = 10_000
R = 16
POOL_FACTOR = 8
MOUT = 32
SEED = 1
WARM_S = 45.0
MEASURE_S = 10.0
CHUNK = 25

KERNELS = {
    "inbox_select_gather": {
        "source": "oversim_tpu_torch/csrc/inbox.cu",
        "replaces": "oversim_tpu/kernels/inbox.py:53 (_inbox_kernel, "
                    "gather=True; pallas_call at :157)"},
    "alloc_dest": {
        "source": "oversim_tpu_torch/csrc/outbox.cu",
        "replaces": "oversim_tpu/kernels/outbox.py:34 (_dest_kernel; "
                    "pallas_call at :80)"},
}
HBM_BYTES_PER_S = 3.35e12     # H100 SXM data sheet


def emit(obj):
    print(json.dumps(obj), flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True, timeout=60).stdout.strip().splitlines()
    return out[0].strip()


# -- configurations ---------------------------------------------------------

def bench_sim(n, device, inbox_impl, *, deviation=None, jitter=0.1,
              inbox=None, outbox=None):
    """bench.py's Kademlia + KBRTest configuration at ``n`` nodes (inbox
    and outbox slots default to this script's R and MOUT)."""
    from oversim_tpu_torch import churn
    from oversim_tpu_torch.apps.kbrtest import KbrTestApp, KbrTestParams
    from oversim_tpu_torch.common.lookup import LookupConfig
    from oversim_tpu_torch.engine.sim import EngineParams, Simulation
    from oversim_tpu_torch.overlay.kademlia import KademliaLogic
    from oversim_tpu_torch.underlay.simple import UnderlayParams
    logic = KademliaLogic(app=KbrTestApp(KbrTestParams(test_interval=0.2)),
                          lcfg=LookupConfig(slots=8, merge=True))
    cp = churn.ChurnParams(
        model="none", target_num=n, init_interval=20.0 / n,
        init_deviation=2.0 / n if deviation is None else deviation)
    ep = EngineParams(window=0.2, inbox_slots=inbox or R,
                      pool_factor=POOL_FACTOR, outbox_slots=outbox or MOUT,
                      inbox_impl=inbox_impl)
    return Simulation(logic, cp, UnderlayParams(jitter=jitter), ep,
                      device=device)


# -- kernel checks ----------------------------------------------------------

def inbox_cases(n, p, r, w, device, seed=7):
    """(name, pool, t_end, alive, hold) cases with tie pressure."""
    import numpy as np
    import torch
    from oversim_tpu_torch.engine import pool as pool_mod
    rng = np.random.default_rng(seed)
    base = pool_mod.empty(p, 5, w - len(pool_mod.SCAL_COLS) - 5, device)
    cases = []

    def make(valid, dst, t):
        blk = torch.as_tensor(rng.integers(-2**31, 2**31 - 1, size=(p, w),
                                           dtype=np.int64).astype(np.int32),
                              device=device)
        blk[:, pool_mod._COL["dst"]] = torch.as_tensor(dst, device=device)
        v = torch.as_tensor(valid, device=device)
        return pool_mod.MsgPool(
            valid=v,
            t_deliver=torch.where(v, torch.as_tensor(t, device=device),
                                  pool_mod.T_INF),
            stamp=base.stamp, blk=blk, kl=base.kl, rmax=base.rmax)

    for occ in (0.0, 0.15, 0.5, 0.85, 1.0):
        pool = make(rng.random(p) < occ,
                    rng.integers(0, n, size=p).astype(np.int32),
                    rng.integers(0, 6, size=p).astype(np.int64))
        alive = torch.as_tensor(rng.random(n) < 0.8, device=device)
        cases.append((f"occupancy_{occ}", pool,
                      int(rng.integers(1, 8)), alive, None))
    hot = rng.integers(0, n, size=10)
    dst = np.where(rng.random(p) < 0.5, hot[rng.integers(0, 10, size=p)],
                   rng.integers(0, n, size=p)).astype(np.int32)
    pool = make(np.ones(p, bool), dst,
                rng.integers(0, 4, size=p).astype(np.int64))
    cases.append(("r_overflow_hot", pool, 10,
                  torch.ones(n, dtype=torch.bool, device=device), None))
    pool = make(rng.random(p) < 0.7,
                rng.integers(0, n, size=p).astype(np.int32),
                rng.integers(0, 6, size=p).astype(np.int64))
    cases.append(("hold_mask", pool, 6,
                  torch.as_tensor(rng.random(n) < 0.8, device=device),
                  torch.as_tensor(rng.random(p) < 0.3, device=device)))
    return cases


def check_inbox(n, device):
    import torch
    from oversim_tpu_torch.engine import pool as pool_mod
    from oversim_tpu_torch.kernels import inbox as inbox_k
    p, w = POOL_FACTOR * n, 10 + 5 + 16
    worst = 0
    for name, pool, t_end, alive, hold in inbox_cases(n, p, R, w, device):
        t_end = torch.tensor(t_end, dtype=torch.int64, device=device)
        due, to_dead = pool_mod.due_masks(pool, n, t_end, alive, hold)
        dstc = torch.clamp(pool.dst, 0, n - 1).contiguous()
        got = inbox_k.inbox_select_gather(due, dstc, pool.t_deliver,
                                          pool.blk, n, R)
        want = inbox_k.inbox_select_gather_plain(due, dstc, pool.t_deliver,
                                                 pool.blk, n, R)
        oracle = pool_mod.build_inbox_scatter(pool, n, R, t_end, alive, hold)
        torch.cuda.synchronize(device) if device.type == "cuda" else None
        for a, b, what in zip(got, want, ("inbox", "delivered", "gblk")):
            if not torch.equal(a, b):
                raise AssertionError(f"inbox_select_gather {name}: {what} "
                                     "differs from the plain version")
            worst = max(worst, int((a.long() - b.long()).abs().max())
                        if a.numel() else 0)
        if not (torch.equal(got[0], oracle[0])
                and torch.equal(got[1], oracle[1])):
            raise AssertionError(f"inbox_select_gather {name}: differs from "
                                 "build_inbox_scatter")
    return worst


def check_alloc(n, device, draws=20):
    import numpy as np
    import torch
    from oversim_tpu_torch.engine import pool as pool_mod
    from oversim_tpu_torch.kernels import outbox as outbox_k
    rng = np.random.default_rng(17)
    p, q = POOL_FACTOR * n, MOUT * n
    cases = [(np.zeros(p, bool), np.ones(q, bool)),
             (np.ones(p, bool), rng.random(q) < 0.6)]
    cases += [(rng.random(p) < rng.random(), rng.random(q) < 0.6)
              for _ in range(draws)]
    worst = 0
    for valid, want in cases:
        v = torch.as_tensor(valid, device=device)
        wt = torch.as_tensor(want, device=device)
        d1, o1 = outbox_k.alloc_dest(v, wt)
        d2, o2 = outbox_k.alloc_dest_plain(v, wt)
        d3, o3 = pool_mod.alloc_dest_cumsum(v, wt)
        if not (torch.equal(d1, d2) and int(o1) == int(o2)
                and torch.equal(d1, d3) and int(o1) == int(o3)):
            raise AssertionError("alloc_dest differs from its plain version")
        worst = max(worst, int((d1.long() - d2.long()).abs().max()))
    return worst, len(cases)


# -- state comparison ---------------------------------------------------------

def compare_states(a, b, float_rtol=0.0):
    """Leaf-by-leaf comparison of two port states; returns the number of
    leaves, raises naming the first leaf that differs."""
    import numpy as np
    from oversim_tpu_torch import interop
    fa, fb = interop.state_to_numpy(a), interop.state_to_numpy(b)
    if sorted(fa) != sorted(fb):
        raise AssertionError("state layouts differ")
    for k in sorted(fa):
        x, y = fa[k], fb[k]
        if x.dtype != y.dtype or x.shape != y.shape:
            raise AssertionError(f"{k}: dtype/shape differ")
        if float_rtol and x.dtype.kind == "f":
            ok = np.allclose(x, y, rtol=float_rtol, atol=0.0, equal_nan=True)
        else:
            ok = np.array_equal(x, y)
        if not ok:
            raise AssertionError(f"first differing leaf: {k}")
    return len(fa)


# -- timing -------------------------------------------------------------------

def time_cuda(fn, iters=20, repeats=5):
    """Median ms per call over ``repeats`` CUDA-event-timed runs."""
    import torch
    fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        out.append(start.elapsed_time(end) / iters)
    return statistics.median(out)


def capture_tick_inputs(sim, s):
    """Run one more tick with the kernel wrappers wrapped to keep their
    inputs; returns ({kernel: args}, state)."""
    from oversim_tpu_torch.kernels import inbox as inbox_k
    from oversim_tpu_torch.kernels import outbox as outbox_k
    seen = {}
    orig_in, orig_out = inbox_k.inbox_select_gather, outbox_k.alloc_dest

    def cap_in(*args):
        seen["inbox_select_gather"] = args
        return orig_in(*args)

    def cap_out(*args):
        seen["alloc_dest"] = args
        return orig_out(*args)

    inbox_k.inbox_select_gather, outbox_k.alloc_dest = cap_in, cap_out
    try:
        s = sim.step(s)
    finally:
        inbox_k.inbox_select_gather, outbox_k.alloc_dest = orig_in, orig_out
    return seen, s


def bounds(seen):
    """Least time for each kernel's work on these inputs: every input byte
    read once, every output byte written once, over the HBM rate.  For
    the gather only the selected rows (and row 0 for empty entries) are
    read."""
    import torch
    due, dst, t, blk, n, r = seen["inbox_select_gather"]
    p, w = blk.shape
    n_due = int(torch.sum(due))
    rows = min(n_due, n * r)
    b_in = p * (1 + 4 + 8) + rows * w * 4 + n * r * 4 + p + n * r * w * 4
    valid, want = seen["alloc_dest"]
    q = want.shape[0]
    b_al = valid.shape[0] + q + q * 4 + 4
    return ({"inbox_select_gather": b_in / HBM_BYTES_PER_S * 1e3,
             "alloc_dest": b_al / HBM_BYTES_PER_S * 1e3},
            {"inbox_select_gather": {"due": n_due, "bytes": b_in},
             "alloc_dest": {"wanted": int(torch.sum(want)), "bytes": b_al}})


# -- phases -------------------------------------------------------------------

def phase_reference(device, n=16, ticks=128):
    import torch
    t0 = time.perf_counter()
    a = bench_sim(n, device, "pallas", deviation=0.0, jitter=0.0, inbox=8,
                  outbox=16)
    b = bench_sim(n, torch.device("cpu"), "scatter", deviation=0.0,
                  jitter=0.0, inbox=8, outbox=16)
    sa = a.run_chunk(a.init(SEED), ticks)
    sb = b.run_chunk(b.init(SEED), ticks)
    leaves = compare_states(sa, sb, float_rtol=1e-12)
    out = a.summary(sa)
    if out["kbr_sent"] <= 0 or out["_alive"] != n:
        raise AssertionError(f"reference run carried no traffic: {out}")
    return {"phase": "reference", "n": n, "ticks": ticks, "leaves": leaves,
            "kbr_sent": out["kbr_sent"], "kbr_delivered": out["kbr_delivered"],
            "seconds": round(time.perf_counter() - t0, 3)}


def phase_identity(device, n, ticks=50):
    from oversim_tpu_torch import tree
    t0 = time.perf_counter()
    a = bench_sim(n, device, "scatter")
    b = bench_sim(n, device, "pallas")
    s0 = a.init(SEED)
    sa = a.run_chunk(tree.tree_map(lambda x: x.clone(), s0), ticks)
    sb = b.run_chunk(tree.tree_map(lambda x: x.clone(), s0), ticks)
    leaves = compare_states(sa, sb)
    return {"phase": "identity", "n": n, "ticks": ticks, "leaves": leaves,
            "alive": int(sa.alive.sum()), "pool_valid": int(sa.pool.valid.sum()),
            "seconds": round(time.perf_counter() - t0, 3)}


def phase_main_path(device, n):
    import math
    import torch
    from oversim_tpu_torch import kernels
    sim = bench_sim(n, device, "pallas")
    t0 = time.perf_counter()
    s = sim.init(SEED)
    kernels.reset_launches()
    s = sim.run_until_device(s, WARM_S, chunk=CHUNK)
    torch.cuda.synchronize(device) if device.type == "cuda" else None
    base = sim.summary(s)
    warm_wall = time.perf_counter() - t0
    t1 = time.perf_counter()
    s = sim.run_until_device(s, WARM_S + MEASURE_S, chunk=CHUNK)
    torch.cuda.synchronize(device) if device.type == "cuda" else None
    wall = time.perf_counter() - t1
    launches = dict(kernels.LAUNCHES)
    out = sim.summary(s)
    sent = out["kbr_sent"] - base["kbr_sent"]
    delivered = out["kbr_delivered"] - base["kbr_delivered"]
    delivery = delivered / sent if sent else 0.0
    eng = out["_engine"]
    hops = out["lookup_hops"]["mean"]
    finite = all(math.isfinite(v) for k in ("kbr_latency_s", "lookup_hops")
                 for v in (out[k]["mean"], out[k]["stddev"]))
    line = {"phase": "main_path", "n": n, "inbox_impl": "pallas",
            "ticks": out["_ticks"], "ticks_measured":
                out["_ticks"] - base["_ticks"],
            "t_sim": out["_t_sim"], "alive": out["_alive"],
            "warm_wall_s": round(warm_wall, 3), "wall_s": round(wall, 3),
            "lookups_per_s": delivered / wall if wall > 0 else 0.0,
            "kbr_sent": sent, "kbr_delivered": delivered,
            "delivery": delivery, "lookup_hops_mean": hops,
            "engine": eng, "launches": launches}
    emit(line)
    if not (sent > 0 and delivery >= 0.95 and eng["pool_overflow"] == 0
            and eng["outbox_overflow"] == 0):
        raise AssertionError("main path failed the health gate")
    if out["_alive"] != n or not finite:
        raise AssertionError("main path state is not as expected")
    missing = [k for k, v in launches.items() if v <= 0]
    if missing:
        raise AssertionError(f"main path never launched {missing}")
    return sim, s, launches


def phase_timing(sim, s):
    from oversim_tpu_torch.kernels import inbox as inbox_k
    from oversim_tpu_torch.kernels import outbox as outbox_k
    seen, _ = capture_tick_inputs(sim, s)
    bound_ms, work = bounds(seen)
    a_in, a_al = seen["inbox_select_gather"], seen["alloc_dest"]
    res = {
        "inbox_select_gather": (
            time_cuda(lambda: inbox_k.inbox_select_gather(*a_in)),
            time_cuda(lambda: inbox_k.inbox_select_gather_plain(*a_in))),
        "alloc_dest": (
            time_cuda(lambda: outbox_k.alloc_dest(*a_al)),
            time_cuda(lambda: outbox_k.alloc_dest_plain(*a_al))),
    }
    emit({"phase": "timing", "work": work,
          "ms": {k: v[0] for k, v in res.items()},
          "plain_ms": {k: v[1] for k, v in res.items()},
          "bound_ms": bound_ms})
    return res, bound_ms


def phase_profile(sim, s, ticks=5):
    import torch
    from torch.profiler import ProfilerActivity, profile
    s = sim.run_chunk(s, 1)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    plain = sim.run_chunk(s, ticks)
    torch.cuda.synchronize()
    wall_plain = (time.perf_counter() - t0) / ticks
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        sim.run_chunk(s, ticks)
        torch.cuda.synchronize()
    wall_prof = (time.perf_counter() - t0) / ticks
    del plain

    def dev_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0))

    from torch.autograd import DeviceType
    ka = prof.key_averages()
    # device-side rows (kernels, memcpy, memset) carry the device time
    # once; operator rows repeat it as their self device time
    on_dev = [e for e in ka if e.device_type == DeviceType.CUDA]
    ops = [e for e in ka if e.device_type != DeviceType.CUDA]
    dev = sum(dev_us(e) for e in on_dev) / 1e3 / ticks
    launches = sum(e.count for e in ka if e.key == "cudaLaunchKernel")
    top = sorted(ops, key=dev_us, reverse=True)[:10]
    return {"phase": "profile", "ticks": ticks,
            "wall_ms_per_tick": wall_plain * 1e3,
            "wall_ms_per_tick_profiled": wall_prof * 1e3,
            "device_ms_per_tick": dev if dev > 0 else "not measured",
            "device_idle_share": (1.0 - dev / (wall_plain * 1e3))
            if dev > 0 else "not measured",
            "launches_per_tick": launches / ticks,
            "top_device_ops_ms_per_tick": [
                [e.key[:60], dev_us(e) / 1e3 / ticks, e.count // ticks]
                for e in top]}


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        sys.stderr.write("chip_smoke: CUDA is not available; the port's "
                         "main path runs on the card only\n")
        return 2
    sys.path.insert(0, HERE)
    from oversim_tpu_torch import kernels
    t_all = time.perf_counter()
    device = torch.device("cuda", 0)
    smi = nvidia_smi_line()
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    emit({"phase": "device", "kind": kind, "count": count,
          "nvidia_smi": smi, "torch": torch.__version__,
          "cuda": torch.version.cuda})

    t0 = time.perf_counter()
    logs = kernels.build_all(verbose=True)
    for name in kernels.SOURCES:
        kernels.library(name)
    emit({"phase": "build", "seconds": round(time.perf_counter() - t0, 3),
          "ptxas": {k: [ln.strip() for ln in v.splitlines()
                        if "registers" in ln or "spill" in ln][:6]
                    for k, v in logs.items()}})

    t0 = time.perf_counter()
    err_in = check_inbox(N_MAIN, device)
    err_al, n_al = check_alloc(N_MAIN, device)
    emit({"phase": "kernel_check", "n": N_MAIN, "r": R,
          "p": POOL_FACTOR * N_MAIN, "q": MOUT * N_MAIN,
          "inbox_select_gather": {"cases": 7, "max_abs_err": err_in},
          "alloc_dest": {"cases": n_al, "max_abs_err": err_al},
          "tolerance": "exact", "seconds": round(time.perf_counter() - t0, 3)})

    emit(phase_reference(device))
    emit(phase_identity(device, N_MAIN))
    sim, s, launches = phase_main_path(device, N_MAIN)
    res, bound_ms = phase_timing(sim, s)
    emit(phase_profile(sim, s))
    emit({"phase": "total", "seconds": round(time.perf_counter() - t_all, 3)})
    errs = {"inbox_select_gather": err_in, "alloc_dest": err_al}
    emit({"kernels": [dict(
        name=name, route="cuda", source=meta["source"],
        replaces=meta["replaces"], launches=launches[name],
        max_abs_err=errs[name], ms=res[name][0], plain_ms=res[name][1],
        bound_ms=bound_ms[name], bound_by="bytes", library_ms=None)
        for name, meta in KERNELS.items()]})
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": count}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
