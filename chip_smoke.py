#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's two paths on one NVIDIA card.

    python3 chip_smoke.py [--phases kernel_check,sparse_reference,...]

Needs one CUDA card, ``nvcc`` and the checkout (it imports the port from
the directory it lives in; it imports nothing of JAX).  Every phase
prints one JSON line; any failure raises, exits non-zero and prints no
``ok`` line.  ``--phases`` runs only the named phases (device, build and
the last lines always run); the default is all of them.  Two paths: the
dense main path (Kademlia + KBRTest under NoChurn at N=10,000) and the
sparse path (the active-set tick under lifetime churn at 65,536 slots).
Phases:

  device        card name, count, and the nvidia-smi name/power line;
  build         nvcc builds of the CUDA kernels from csrc/ (in parallel);
  kernel_check  each kernel against its plain PyTorch version at its
                path's shapes — the dense kernels at N=10,000, R=16,
                P=80,000, W=31, Q=320,000 and ``inbox_select`` at the
                sparse path's N=65,536, P=524,288 on random, empty, full,
                R-overflow and hold-mask pools; ``compact_indices`` at
                m=65,536, cap=8,192 on random, empty and full masks and
                counts past the cap: exact equality required;
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
  timing        each dense kernel and its plain version on the inputs of
                one more main-path tick (CUDA events, median of repeats);
  profile       torch.profiler over a few more main-path ticks: wall and
                device time per tick, device idle share, kernel launches
                per tick, the device ops that take the most time;
  sparse_reference  the sparse tick under lifetime churn at 24 slots for
                128 ticks on the card (kernels) and on the CPU (torch-ops
                oracle, held leaf-exact to the JAX package by
                tests/test_torch_sparse.py): integer leaves equal, float
                leaves within 1e-12 relative;
  sparse_identity  20,000 slots (lifetime mean 100 s) warmed to 25
                simulated s, then 50 ticks of sparse kernels vs sparse
                torch ops at the auto cap, and of sparse kernels at
                ``active_cap = n`` vs the dense kernel tick: every leaf
                equal, with churn firing inside the 50 ticks;
  sparse_path   the sparse tick at 65,536 slots (32,768 target, lifetime
                mean 1000 s, 1% activity: test interval 20 s over a
                0.2 s window) on the kernels: warm-up to 45 simulated s,
                a measured 10 s window, the health gate, the awake share
                and each sparse-path kernel's launch count (> 0);
  sparse_timing each sparse kernel and its plain version (and
                ``torch.masked_select`` for the compaction) on the inputs
                of one more sparse tick;
  sparse_profile  torch.profiler over a few more sparse ticks;
  kernels       one line listing the four ported kernels;
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
TGT_SPARSE = 32_768          # 65,536 lifetime-churn slots
ACT_SPARSE = 0.01            # KBRTest test interval = window / activity
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
    "inbox_select": {
        "source": "oversim_tpu_torch/csrc/inbox.cu",
        "replaces": "oversim_tpu/kernels/inbox.py:53 (_inbox_kernel, "
                    "gather=False via fused_select :203; pallas_call at "
                    ":157)"},
    "compact_indices": {
        "source": "oversim_tpu_torch/csrc/compact.cu",
        "replaces": "oversim_tpu/kernels/outbox.py:108 (_compact_kernel; "
                    "pallas_call at :140)"},
}
DENSE_KERNELS = ("inbox_select_gather", "alloc_dest")
SPARSE_KERNELS = ("inbox_select", "compact_indices", "alloc_dest")
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


def sparse_sim(target, device, inbox_impl, *, tick_impl="sparse",
               active_cap=0, life=1000.0, rejoin=False):
    """The sparse path: Kademlia + KBRTest at 1% activity under lifetime
    churn (2 * ``target`` slots); ``rejoin`` keeps a slot's nodeId across
    its rebirths (LifetimeChurn context slots)."""
    from oversim_tpu_torch import churn
    from oversim_tpu_torch.apps.kbrtest import KbrTestApp, KbrTestParams
    from oversim_tpu_torch.common.lookup import LookupConfig
    from oversim_tpu_torch.engine.sim import EngineParams, Simulation
    from oversim_tpu_torch.overlay.kademlia import KademliaLogic
    from oversim_tpu_torch.underlay.simple import UnderlayParams
    window = 0.2
    logic = KademliaLogic(
        app=KbrTestApp(KbrTestParams(test_interval=window / ACT_SPARSE)),
        lcfg=LookupConfig(slots=8, merge=True))
    cp = churn.ChurnParams(
        model="lifetime", target_num=target, init_interval=20.0 / target,
        init_deviation=2.0 / target, lifetime_mean=life,
        lifetime_dist="weibull", lifetime_par1=1.0, rejoin_context=rejoin)
    ep = EngineParams(window=window, inbox_slots=R, outbox_slots=MOUT,
                      pool_factor=POOL_FACTOR, inbox_impl=inbox_impl,
                      tick_impl=tick_impl, active_cap=active_cap)
    return Simulation(logic, cp, UnderlayParams(jitter=0.1), ep,
                      device=device)


def tiny_sparse_sim(device, inbox_impl):
    """tests/test_torch_sparse.py's configuration: 12 target (24 slots),
    lifetime mean 8 s, normal draws off (init_deviation = jitter = 0)."""
    from oversim_tpu_torch import churn
    from oversim_tpu_torch.apps.kbrtest import KbrTestApp, KbrTestParams
    from oversim_tpu_torch.engine.sim import EngineParams, Simulation
    from oversim_tpu_torch.overlay.kademlia import KademliaLogic
    from oversim_tpu_torch.underlay.simple import UnderlayParams
    cp = churn.ChurnParams(model="lifetime", target_num=12,
                           init_interval=0.2, init_deviation=0.0,
                           lifetime_mean=8.0, graceful_leave_delay=1.0)
    ep = EngineParams(window=0.1, inbox_slots=4, pool_factor=4,
                      inbox_impl=inbox_impl, tick_impl="sparse")
    return Simulation(
        KademliaLogic(app=KbrTestApp(KbrTestParams(test_interval=1.0))), cp,
        UnderlayParams(jitter=0.0), ep, device=device)


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


def check_inbox_select(n, device):
    """``inbox_select`` against its plain version and the scatter-min
    oracle on ``inbox_cases`` pools at P = POOL_FACTOR * n."""
    import torch
    from oversim_tpu_torch.engine import pool as pool_mod
    from oversim_tpu_torch.kernels import inbox as inbox_k
    p, w = POOL_FACTOR * n, 10 + 5 + 16
    worst, cases = 0, 0
    for name, pool, t_end, alive, hold in inbox_cases(n, p, R, w, device,
                                                      seed=29):
        t_end = torch.tensor(t_end, dtype=torch.int64, device=device)
        due, to_dead = pool_mod.due_masks(pool, n, t_end, alive, hold)
        dstc = torch.clamp(pool.dst, 0, n - 1).contiguous()
        got = inbox_k.inbox_select(due, dstc, pool.t_deliver, n, R)
        want = inbox_k.inbox_select_plain(due, dstc, pool.t_deliver, n, R)
        oracle = pool_mod.build_inbox_scatter(pool, n, R, t_end, alive, hold)
        for a, b, c, what in zip(got, want, oracle, ("inbox", "delivered")):
            if not (torch.equal(a, b) and torch.equal(a, c)):
                raise AssertionError(f"inbox_select {name}: {what} differs "
                                     "from the plain version or the oracle")
            worst = max(worst, int((a.long() - b.long()).abs().max()))
        cases += 1
    return worst, cases


def check_compact(m, cap, device):
    """``compact_indices`` against its plain version: random masks at
    several densities, empty, full, and set counts above the cap."""
    import numpy as np
    import torch
    from oversim_tpu_torch.kernels import compact as compact_k
    rng = np.random.default_rng(31)
    masks = [np.zeros(m, bool), np.ones(m, bool)]
    masks += [rng.random(m) < f for f in (0.001, 0.01, 0.05, 0.125, 0.124,
                                          0.2, 0.5)]
    worst = 0
    for i, mask in enumerate(masks):
        off = int(rng.integers(0, m))
        vals = torch.as_tensor((np.arange(m) + off) % m, dtype=torch.int32,
                               device=device)
        mk = torch.as_tensor(mask, device=device)
        la, ca = compact_k.compact_indices(mk, vals, cap, m)
        lb, cb = compact_k.compact_indices_plain(mk, vals, cap, m)
        if not (torch.equal(la, lb) and int(ca) == int(cb)
                and int(ca) == int(mask.sum())):
            raise AssertionError(f"compact_indices case {i}: differs from "
                                 "the plain version")
        worst = max(worst, int((la.long() - lb.long()).abs().max()))
    return worst, len(masks)


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


def _kernel_modules():
    from oversim_tpu_torch.kernels import compact as compact_k
    from oversim_tpu_torch.kernels import inbox as inbox_k
    from oversim_tpu_torch.kernels import outbox as outbox_k
    return {"inbox_select_gather": inbox_k, "inbox_select": inbox_k,
            "alloc_dest": outbox_k, "compact_indices": compact_k}


def capture_tick_inputs(sim, s, names):
    """Run one more tick with the wrappers of ``names`` wrapped to keep
    their inputs; returns ({kernel: args}, state)."""
    mods = _kernel_modules()
    seen, orig = {}, {name: getattr(mods[name], name) for name in names}

    def keep(name):
        def fn(*args):
            seen[name] = args
            return orig[name](*args)
        return fn

    for name in names:
        setattr(mods[name], name, keep(name))
    try:
        s = sim.step(s)
    finally:
        for name in names:
            setattr(mods[name], name, orig[name])
    return seen, s


def bounds(seen):
    """Least time for each kernel's work on these inputs: every input byte
    the work needs read once, every output byte written once, over the
    HBM rate.  Selection reads the due mask and, for the due messages
    only, their destination and time; the gather reads only the selected
    rows (and row 0 for empty entries); compaction reads the mask and
    the values of the set bits."""
    import torch
    ms, work = {}, {}
    if "inbox_select_gather" in seen:
        due, dst, t, blk, n, r = seen["inbox_select_gather"]
        p, w = blk.shape
        n_due = int(torch.sum(due))
        rows = min(n_due, n * r)
        b = p * (1 + 4 + 8) + rows * w * 4 + n * r * 4 + p + n * r * w * 4
        work["inbox_select_gather"] = {"due": n_due, "bytes": b}
    if "inbox_select" in seen:
        due, dst, t, n, r = seen["inbox_select"]
        p = due.shape[0]
        n_due = int(torch.sum(due))
        b = p + n_due * (4 + 8) + n * r * 4 + p
        work["inbox_select"] = {"due": n_due, "bytes": b}
    if "alloc_dest" in seen:
        valid, want = seen["alloc_dest"]
        q = want.shape[0]
        b = valid.shape[0] + q + q * 4 + 4
        work["alloc_dest"] = {"wanted": int(torch.sum(want)), "bytes": b}
    if "compact_indices" in seen:
        mask, vals, cap, _ = seen["compact_indices"]
        cnt = int(torch.sum(mask))
        b = mask.shape[0] + min(cnt, cap) * 4 + cap * 4 + 4
        work["compact_indices"] = {"set": cnt, "cap": cap, "bytes": b}
    for name, wk in work.items():
        ms[name] = wk["bytes"] / HBM_BYTES_PER_S * 1e3
    return ms, work


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


def run_window(sim, s, device, kernel_names):
    """Warm-up to WARM_S, then the measured window to WARM_S + MEASURE_S,
    with the launch counts set to 0 just before and read just after.
    Returns (state, summary at the window start, summary at its end,
    warm-up wall s, window wall s, {kernel: launches})."""
    import torch
    from oversim_tpu_torch import kernels
    t0 = time.perf_counter()
    kernels.reset_launches()
    s = sim.run_until_device(s, WARM_S, chunk=CHUNK)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    base = sim.summary(s)
    warm_wall = time.perf_counter() - t0
    t1 = time.perf_counter()
    s = sim.run_until_device(s, WARM_S + MEASURE_S, chunk=CHUNK)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    wall = time.perf_counter() - t1
    launches = {k: kernels.LAUNCHES[k] for k in kernel_names}
    return s, base, sim.summary(s), warm_wall, wall, launches


def sync_free_step(sim, s):
    """One more tick with every host synchronisation turned into an error
    (``torch.cuda.set_sync_debug_mode``): the tick must never make the
    host wait for the card."""
    import torch
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        s = sim.step(s)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    return s


def window_line(phase, sim, base, out, warm_wall, wall, launches):
    """The path line's common fields and the health gate's inputs."""
    import math
    sent = out["kbr_sent"] - base["kbr_sent"]
    delivered = out["kbr_delivered"] - base["kbr_delivered"]
    ticks = out["_ticks"] - base["_ticks"]
    finite = all(math.isfinite(v) for k in ("kbr_latency_s", "lookup_hops")
                 for v in (out[k]["mean"], out[k]["stddev"]))
    line = {"phase": phase, "n": sim.n, "inbox_impl": sim.ep.inbox_impl,
            "tick_impl": sim.ep.tick_impl,
            "ticks": out["_ticks"], "ticks_measured": ticks,
            "t_sim": out["_t_sim"], "alive": out["_alive"],
            "warm_wall_s": round(warm_wall, 3), "wall_s": round(wall, 3),
            "lookups_per_s": delivered / wall if wall > 0 else 0.0,
            "sim_s_per_wall_s": (out["_t_sim"] - base["_t_sim"]) / wall
            if wall > 0 else 0.0,
            "wall_ms_per_tick": wall * 1e3 / ticks if ticks else 0.0,
            "kbr_sent": sent, "kbr_delivered": delivered,
            "delivery": delivered / sent if sent else 0.0,
            "lookup_hops_mean": out["lookup_hops"]["mean"],
            "engine": out["_engine"], "launches": launches}
    healthy = (sent > 0 and line["delivery"] >= 0.95
               and out["_engine"]["pool_overflow"] == 0
               and out["_engine"]["outbox_overflow"] == 0)
    return line, healthy, finite


def phase_main_path(device, n):
    sim = bench_sim(n, device, "pallas")
    s, base, out, warm_wall, wall, launches = run_window(
        sim, sim.init(SEED), device, DENSE_KERNELS)
    line, healthy, finite = window_line("main_path", sim, base, out,
                                        warm_wall, wall, launches)
    emit(line)
    if not healthy:
        raise AssertionError("main path failed the health gate")
    if out["_alive"] != n or not finite:
        raise AssertionError("main path state is not as expected")
    missing = [k for k, v in launches.items() if v <= 0]
    if missing:
        raise AssertionError(f"main path never launched {missing}")
    s = sync_free_step(sim, s)
    emit({"phase": "main_path_sync_check", "host_syncs_in_tick": 0})
    return sim, s, launches


PLAIN = {"inbox_select_gather": "inbox_select_gather_plain",
         "inbox_select": "inbox_select_plain",
         "alloc_dest": "alloc_dest_plain",
         "compact_indices": "compact_indices_plain"}


def phase_timing(sim, s, names, phase="timing"):
    """Each kernel of ``names`` and its plain version (and the nearest
    single library call, where there is one) on the inputs of one more
    tick; returns ({kernel: (ms, plain_ms, library_ms)}, bound_ms)."""
    import torch
    mods = _kernel_modules()
    seen, _ = capture_tick_inputs(sim, s, names)
    bound_ms, work = bounds(seen)
    res, lib_call = {}, {}
    for name in names:
        args = seen[name]
        kern, plain = getattr(mods[name], name), getattr(mods[name],
                                                         PLAIN[name])
        lib = None
        if name == "compact_indices":
            mask, vals = args[0], args[1]
            lib = time_cuda(lambda: torch.masked_select(vals, mask))
            lib_call[name] = ("torch.masked_select (uncapped, synchronises "
                              "with the host)")
        res[name] = (time_cuda(lambda: kern(*args)),
                     time_cuda(lambda: plain(*args)), lib)
    emit({"phase": phase, "work": work,
          "ms": {k: v[0] for k, v in res.items()},
          "plain_ms": {k: v[1] for k, v in res.items()},
          "library_ms": {k: v[2] for k, v in res.items()},
          "library_call": lib_call, "bound_ms": bound_ms})
    return res, bound_ms


def phase_profile(sim, s, ticks=5, phase="profile"):
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
    return {"phase": phase, "ticks": ticks,
            "wall_ms_per_tick": wall_plain * 1e3,
            "wall_ms_per_tick_profiled": wall_prof * 1e3,
            "device_ms_per_tick": dev if dev > 0 else "not measured",
            "device_idle_share": (1.0 - dev / (wall_plain * 1e3))
            if dev > 0 else "not measured",
            "launches_per_tick": launches / ticks,
            "top_device_ops_ms_per_tick": [
                [e.key[:60], dev_us(e) / 1e3 / ticks, e.count // ticks]
                for e in top]}


def strip_sparse(state):
    """A sparse-tick state in the dense tick's layout (the sparse lane
    tallies dropped from the counters)."""
    import dataclasses
    from oversim_tpu_torch.engine.sim import SPARSE_COUNTERS
    return dataclasses.replace(state, counters={
        k: v for k, v in state.counters.items() if k not in SPARSE_COUNTERS})


def phase_sparse_reference(device, ticks=128):
    import torch
    t0 = time.perf_counter()
    a = tiny_sparse_sim(device, "pallas")
    b = tiny_sparse_sim(torch.device("cpu"), "scatter")
    sa = a.run_chunk(a.init(SEED), ticks)
    sb = b.run_chunk(b.init(SEED), ticks)
    leaves = compare_states(sa, sb, float_rtol=1e-12)
    out = a.summary(sa)
    eng = out["_engine"]
    if out["kbr_sent"] <= 0 or eng["dest_unavailable_lost"] <= 0:
        raise AssertionError(f"sparse reference saw no traffic or churn: "
                             f"{out}")
    return {"phase": "sparse_reference", "n": a.n, "ticks": ticks,
            "leaves": leaves, "kbr_sent": out["kbr_sent"],
            "kbr_delivered": out["kbr_delivered"], "alive": out["_alive"],
            "awake_nodes": eng["awake_nodes"],
            "dest_unavailable_lost": eng["dest_unavailable_lost"],
            "seconds": round(time.perf_counter() - t0, 3)}


def phase_sparse_identity(device, target=10_000, warm_s=25.0, ticks=50):
    import torch
    from oversim_tpu_torch import tree
    t0 = time.perf_counter()
    warm = sparse_sim(target, device, "pallas", life=100.0)
    s0 = warm.run_until_device(warm.init(SEED), warm_s, chunk=CHUNK)

    def run(sim, state):
        return sim.run_chunk(tree.tree_map(lambda x: x.clone(), state),
                             ticks)

    kern = run(warm, s0)
    ops = run(sparse_sim(target, device, "scatter", life=100.0), s0)
    leaves_auto = compare_states(kern, ops)
    # sparse at a full cap vs dense needs slots that keep their nodeId on
    # rebirth: the dense tick re-sorts every sibling list by the current
    # keys each tick, the sparse tick only the awake nodes' lists, so a
    # sleeping node whose sibling slot is reborn under a fresh key keeps
    # the old order (the JAX package does the same; ROADMAP Queue C)
    rj = sparse_sim(target, device, "pallas", life=100.0, rejoin=True)
    s1 = rj.run_until_device(rj.init(SEED), warm_s, chunk=CHUNK)
    full = sparse_sim(target, device, "pallas", life=100.0, rejoin=True,
                      active_cap=warm.n)
    dense = sparse_sim(target, device, "pallas", life=100.0, rejoin=True,
                       tick_impl="dense")
    leaves_full = compare_states(strip_sparse(run(full, s1)),
                                 run(dense, strip_sparse(s1)))
    flips = int(torch.sum(kern.alive != s0.alive))
    rebirths = int(torch.sum(kern.churn.t_create != s0.churn.t_create))
    if flips == 0 or rebirths == 0:
        raise AssertionError("no churn fired inside the compared ticks")
    eng = warm.summary(kern)["_engine"]
    return {"phase": "sparse_identity", "n": warm.n, "acap": warm.acap,
            "t_start": float(s0.t_now) / 1e9, "ticks": ticks,
            "leaves_kernels_vs_ops": leaves_auto,
            "leaves_full_cap_vs_dense": leaves_full,
            "alive_flips": flips, "create_schedule_changes": rebirths,
            "awake_nodes": eng["awake_nodes"],
            "active_deferred": eng["active_deferred"],
            "seconds": round(time.perf_counter() - t0, 3)}


def phase_sparse_path(device, target=TGT_SPARSE):
    sim = sparse_sim(target, device, "pallas")
    s, base, out, warm_wall, wall, launches = run_window(
        sim, sim.init(SEED), device, SPARSE_KERNELS)
    line, healthy, finite = window_line("sparse_path", sim, base, out,
                                        warm_wall, wall, launches)
    eng, eng0 = out["_engine"], base["_engine"]
    ticks = line["ticks_measured"]
    line.update({
        "acap": sim.acap,
        "awake_share": (eng["awake_nodes"] - eng0["awake_nodes"])
        / max(ticks, 1) / sim.n,
        "active_dst_per_tick": (eng["active_dst"] - eng0["active_dst"])
        / max(ticks, 1),
        "active_deferred": eng["active_deferred"] - eng0["active_deferred"],
        "active_deferred_total": eng["active_deferred"]})
    emit(line)
    if not healthy:
        raise AssertionError("sparse path failed the health gate")
    if out["_alive"] <= 0 or not finite:
        raise AssertionError("sparse path state is not as expected")
    missing = [k for k, v in launches.items() if v <= 0]
    if missing:
        raise AssertionError(f"sparse path never launched {missing}")
    s = sync_free_step(sim, s)
    emit({"phase": "sparse_path_sync_check", "host_syncs_in_tick": 0})
    return sim, s, launches


PHASES = ("kernel_check", "reference", "identity", "main_path", "timing",
          "profile", "sparse_reference", "sparse_identity", "sparse_path",
          "sparse_timing", "sparse_profile")


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        sys.stderr.write("chip_smoke: CUDA is not available; the port's "
                         "main path runs on the card only\n")
        return 2
    sys.path.insert(0, HERE)
    from oversim_tpu_torch import kernels
    want = set(PHASES)
    if "--phases" in sys.argv:
        want = set(sys.argv[sys.argv.index("--phases") + 1].split(","))
        if want - set(PHASES):
            raise SystemExit(f"unknown phases {sorted(want - set(PHASES))}")
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

    errs, launches, res, bound_ms = {}, {}, {}, {}
    if "kernel_check" in want:
        t0 = time.perf_counter()
        n_sp = 2 * TGT_SPARSE
        cap_sp = max(64, n_sp // 8)
        errs["inbox_select_gather"] = check_inbox(N_MAIN, device)
        errs["alloc_dest"], n_al = check_alloc(N_MAIN, device)
        errs["inbox_select"], n_sel = check_inbox_select(n_sp, device)
        errs["compact_indices"], n_cp = check_compact(n_sp, cap_sp, device)
        emit({"phase": "kernel_check",
              "dense": {"n": N_MAIN, "r": R, "p": POOL_FACTOR * N_MAIN,
                        "q": MOUT * N_MAIN},
              "sparse": {"n": n_sp, "r": R, "p": POOL_FACTOR * n_sp,
                         "m": n_sp, "cap": cap_sp},
              "inbox_select_gather": {"cases": 7,
                                      "max_abs_err": errs["inbox_select_gather"]},
              "alloc_dest": {"cases": n_al, "max_abs_err": errs["alloc_dest"]},
              "inbox_select": {"cases": n_sel,
                               "max_abs_err": errs["inbox_select"]},
              "compact_indices": {"cases": n_cp,
                                  "max_abs_err": errs["compact_indices"]},
              "tolerance": "exact",
              "seconds": round(time.perf_counter() - t0, 3)})

    if "reference" in want:
        emit(phase_reference(device))
    if "identity" in want:
        emit(phase_identity(device, N_MAIN))
    if want & {"main_path", "timing", "profile"}:
        sim, s, got = phase_main_path(device, N_MAIN)
        launches.update({k: got[k] for k in DENSE_KERNELS})
        if "timing" in want:
            got, bms = phase_timing(sim, s, DENSE_KERNELS)
            res.update(got)
            bound_ms.update(bms)
        if "profile" in want:
            emit(phase_profile(sim, s))
        del sim, s
    if "sparse_reference" in want:
        emit(phase_sparse_reference(device))
    if "sparse_identity" in want:
        emit(phase_sparse_identity(device))
    if want & {"sparse_path", "sparse_timing", "sparse_profile"}:
        sim, s, got = phase_sparse_path(device)
        # alloc_dest runs on both paths: the kernels line keeps the dense
        # path's count, the sparse_path line shows its own
        launches.update({k: v for k, v in got.items() if k not in launches})
        if "sparse_timing" in want:
            # alloc_dest is timed here at the sparse path's Q too; the
            # kernels line keeps its dense-path numbers when it has them
            got, bms = phase_timing(sim, s, SPARSE_KERNELS,
                                    phase="sparse_timing")
            res.update({k: v for k, v in got.items() if k not in res})
            bound_ms.update({k: v for k, v in bms.items()
                             if k not in bound_ms})
        if "sparse_profile" in want:
            emit(phase_profile(sim, s, phase="sparse_profile"))
        del sim, s
    emit({"phase": "total", "seconds": round(time.perf_counter() - t_all, 3)})
    emit({"kernels": [dict(
        name=name, route="cuda", source=meta["source"],
        replaces=meta["replaces"], launches=launches.get(name),
        max_abs_err=errs.get(name),
        ms=res[name][0] if name in res else None,
        plain_ms=res[name][1] if name in res else None,
        bound_ms=bound_ms.get(name), bound_by="bytes",
        library_ms=res[name][2] if name in res else None)
        for name, meta in KERNELS.items()]})
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": count}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
