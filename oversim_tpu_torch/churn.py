"""Churn generators as scheduled slot events (PyTorch).

Counterpart of ``oversim_tpu/churn.py``.  Every slot carries its next
create / pre-kill / final-kill time; the engine flips the alive mask for
the slots whose event falls inside the tick window.  The models:

* ``"none"`` (NoChurn): one node created every
  ~truncnormal(initPhaseCreationInterval, dev) until the target count;
* ``"lifetime"`` (LifetimeChurn): 2x target context slots, the first
  half created during the init phase and killed a lifetime after it, the
  second half born a lifetime after it; every final kill schedules the
  slot's rebirth a dead time after its pre-kill, with a fresh lifetime;
* ``"pareto"`` (ParetoChurn): 3x target slots, per-slot mean life and
  dead times from a shifted Pareto (alpha 3), an equilibrium start
  (alive with probability l/(l+d)) over the slots drawn until ``target``
  come up alive, a stretch of every mean so the population's mean
  session is ``lifetimeMean``, and residual (alpha 2) first sessions;
* ``"random"`` (RandomChurn): ``target`` nodes started, then every
  ``churnChangeInterval`` one random dead slot created and one random
  live node removed, each with its probability (``rng.categorical``);
* ``"trace"`` (TraceChurn): the per-slot join and leave times of a trace
  (``trace.churn_from_trace``).

All share the graceful-leave machinery of ``step``.  The lifetime
distributions are Weibull (``rng.weibull_min``, bit-exact at
``lifetime_par1 = 1``), ``pareto_shifted`` (``xlamath.pow``, bit-exact)
and ``truncnormal`` (the normal draw's erfinv gap, ROADMAP Queue C).
ParetoChurn's float64 sums over the slots use XLA-CPU's summation tree
(``xlamath.xla_sum``) on every device.  A campaign's
``churn.lifetimeMean`` sweep passes its mean to ``init`` and ``step`` as
a float64 tensor (``life_mean``).

Draws that the JAX package makes in its default float (float64 under
its x64 mode) are made in float64 here.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from oversim_tpu_torch import rng as rng_mod
from oversim_tpu_torch import xlamath

I64 = torch.int64
F64 = torch.float64
NS = 1_000_000_000
T_INF = 2 ** 62


def _truncnormal(rng, mean, stddev, shape=()):
    """|mean + stddev * N(0, 1)| (the JAX package's truncnormal fold)."""
    x = mean + stddev * rng_mod.normal(rng, shape, F64)
    return torch.abs(x)


def _blocked_cumsum(x, block: int = 16):
    """Inclusive float cumsum in XLA-CPU's summation order: sequential
    inside blocks of 16, plus the (recursively blocked) prefix of the
    block totals.  The join schedule is a float64 cumsum whose terms are
    inexact (``init_interval = 20/N``), so the order decides the last
    bits of every creation time."""
    n = x.shape[0]
    nb = -(-n // block)
    xp = torch.cat([x, x.new_zeros(nb * block - n)]).reshape(nb, block)
    cols = [xp[:, 0]]
    for k in range(1, block):
        cols.append(cols[-1] + xp[:, k])
    inner = torch.stack(cols, 1)
    if nb == 1:
        return inner.reshape(-1)[:n]
    pre = _blocked_cumsum(inner[:, -1], block)
    out = torch.cat([inner[:1], inner[1:] + pre[:-1, None]])
    return out.reshape(-1)[:n]


@dataclasses.dataclass(frozen=True)
class ChurnParams:
    """default.ini:498-506 + ChurnGenerator.ned (JAX field names)."""

    model: str = "none"
    target_num: int = 10
    init_interval: float = 1.0
    init_deviation: float = 0.1
    lifetime_mean: float = 10000.0
    deadtime_mean: float | None = None
    lifetime_dist: str = "weibull"
    lifetime_par1: float = 1.0
    graceful_leave_delay: float = 15.0
    graceful_leave_probability: float = 0.5
    rejoin_context: bool = False
    churn_change_interval: float = 10.0
    creation_probability: float = 0.5
    removal_probability: float = 0.5
    trace_create: tuple = ()
    trace_kill: tuple = ()

    @property
    def num_slots(self) -> int:
        if self.model == "trace":
            return len(self.trace_create)
        if self.model == "none":
            return self.target_num
        if self.model == "pareto":
            return 3 * self.target_num
        return 2 * self.target_num

    @property
    def init_finished_time(self) -> float:
        if self.model == "trace":
            return 0.0
        return self.init_interval * self.target_num


@dataclasses.dataclass
class ChurnState:
    t_create: torch.Tensor  # [N] i64
    t_kill: torch.Tensor    # [N] i64
    t_dead: torch.Tensor    # [N] i64
    graceful: torch.Tensor  # [N] bool
    l_mean: torch.Tensor    # [N] f32
    d_mean: torch.Tensor    # [N] f32
    t_tick: torch.Tensor    # [] i64


MODELS = ("none", "lifetime", "pareto", "random", "trace")


def _draw_lifetime(rng, p: ChurnParams, shape, mean=None):
    """Session / dead-time draw in seconds (float64) with mean
    ``lifetime_mean``, or ``mean`` (a swept float64 tensor)."""
    mean = p.lifetime_mean if mean is None else mean
    k = p.lifetime_par1
    if p.lifetime_dist == "weibull":
        scale = mean / math.gamma(1.0 + 1.0 / k)
        return rng_mod.weibull_min(rng, scale, k, shape, F64)
    if p.lifetime_dist == "pareto_shifted":
        scale = mean * (k - 1.0) / k
        u = rng_mod.uniform(rng, shape, F64)
        return scale * (xlamath.pow(u, -1.0 / k) - 1.0)
    if p.lifetime_dist == "truncnormal":
        return _truncnormal(rng, mean, mean / 3.0, shape)
    raise ValueError(f"unknown lifetime distribution {p.lifetime_dist}")


def _shifted_pareto(rng, alpha: float, mean, shape=()):
    """ParetoChurn::shiftedPareto with betaByMean folded in:
    ``mean * 2 * (u^(-1/alpha) - 1)``, ``u`` uniform in [1e-12, 1); the
    factor 2 = alpha - 1 of the schedule's alpha 3, also for the residual
    draws (alpha 2)."""
    u = rng_mod.uniform(rng, shape, F64, 1e-12, 1.0)
    return mean * 2.0 * (xlamath.pow(u, -1.0 / alpha) - 1.0)


def _ns(seconds):
    """float64 seconds -> int64 ns (the JAX ``(t * NS).astype(I64)``)."""
    return (seconds * NS).to(I64)


def _state(t_create, t_kill, n, dev, l_mean=None, d_mean=None,
           t_tick=T_INF):
    """A ChurnState from int64 ns schedules; no grace windows open."""
    def zeros():
        return torch.zeros((n,), dtype=torch.float32, device=dev)

    return ChurnState(
        t_create=t_create, t_kill=t_kill,
        t_dead=torch.full((n,), T_INF, dtype=I64, device=dev),
        graceful=torch.zeros((n,), dtype=torch.bool, device=dev),
        l_mean=zeros() if l_mean is None else l_mean,
        d_mean=zeros() if d_mean is None else d_mean,
        t_tick=torch.full((), t_tick, dtype=I64, device=dev))


def _init_pareto(rng, p: ChurnParams, n, dev):
    """ParetoChurn.cc:66-126: per-slot means, equilibrium start over the
    slots up to the target-th alive draw, the stretch to the configured
    mean, residual first sessions."""
    tgt = p.target_num
    fin = p.init_finished_time
    dmean = p.deadtime_mean if p.deadtime_mean is not None \
        else p.lifetime_mean
    ra, rb, rc, rd, re, rf, rg = rng_mod.split(rng, 7)
    l_i = _shifted_pareto(ra, 3.0, p.lifetime_mean, (n,))
    d_i = _shifted_pareto(rb, 3.0, dmean, (n,))
    avail = l_i / (l_i + d_i)
    alive0 = rng_mod.uniform(rc, (n,), F64) < avail
    alive_rank = torch.cumsum(alive0.to(torch.int32), 0, dtype=torch.int32)
    is_init_alive = alive0 & (alive_rank <= tgt)
    participating = alive_rank <= tgt
    sum_li = xlamath.xla_sum(torch.where(participating, 1.0 / (l_i + d_i),
                                         0.0))
    mean_life = xlamath.xla_sum(torch.where(
        participating, l_i / ((l_i + d_i) * sum_li), 0.0))
    stretch = p.lifetime_mean / mean_life
    l_i = l_i * stretch
    d_i = d_i * stretch
    live_idx = torch.where(is_init_alive, alive_rank - 1, 0)
    stagger = _truncnormal(rd, p.init_interval * live_idx.to(F64),
                           p.init_deviation, (n,))
    res_l = _shifted_pareto(re, 2.0, l_i, (n,))
    res_d = _shifted_pareto(rf, 2.0, d_i, (n,))
    t_create = torch.where(is_init_alive, stagger, fin + res_d)
    first_life = torch.where(is_init_alive, (fin - stagger) + res_l,
                             _shifted_pareto(rg, 3.0, l_i, (n,)))
    t_kill = torch.maximum(t_create + first_life - p.graceful_leave_delay,
                           t_create)
    never = T_INF / NS     # the JAX int64 / int true division, in float64
    t_create = torch.where(participating, t_create, never)
    t_kill = torch.where(participating, t_kill, never)
    return _state(_ns(t_create), _ns(t_kill), n, dev,
                  l_mean=l_i.to(torch.float32), d_mean=d_i.to(torch.float32))


def _trace_times(ts, dev):
    """Seconds (None = never) -> int64 ns, as ``jnp.asarray(..., I64)``
    converts ``t * NS`` (truncation)."""
    vals = np.asarray([t * NS if t is not None else T_INF for t in ts],
                      dtype=np.float64).astype(np.int64)
    return torch.from_numpy(vals).to(dev)


def init(rng, p: ChurnParams, life_mean=None) -> ChurnState:
    """``life_mean`` (a float64 tensor) overrides ``p.lifetime_mean`` in
    the lifetime model's session draws."""
    if p.model not in MODELS:
        raise ValueError(f"unknown churn model {p.model}")
    n = p.num_slots
    dev = rng.device
    if p.model == "trace":
        return _state(_trace_times(p.trace_create, dev),
                      _trace_times(p.trace_kill, dev), n, dev)
    if p.model == "pareto":
        return _init_pareto(rng, p, n, dev)
    r1, r2, r3, r4 = rng_mod.split(rng, 4)
    if p.model in ("none", "random"):
        stagger = _truncnormal(r1, p.init_interval, p.init_deviation, (n,))
        t_create = _blocked_cumsum(stagger)
        never = torch.full((n,), T_INF, dtype=I64, device=dev)
        if p.model == "none":
            return _state(_ns(t_create), never, n, dev)
        t_create = torch.where(torch.arange(n, device=dev) < p.target_num,
                               t_create, T_INF / NS)
        return _state(_ns(t_create), never, n, dev,
                      t_tick=int((p.init_finished_time
                                  + p.churn_change_interval) * NS))
    tgt = p.target_num
    fin = p.init_finished_time
    i = torch.arange(tgt, dtype=F64, device=dev)
    first_create = _truncnormal(r1, p.init_interval * i,
                                p.init_deviation, (tgt,))
    first_kill = fin + _draw_lifetime(r2, p, (tgt,), life_mean)
    second_create = fin + _draw_lifetime(r3, p, (tgt,), life_mean)
    second_kill = second_create + _draw_lifetime(r4, p, (tgt,), life_mean)
    t_create = torch.cat([first_create, second_create])
    t_kill = torch.cat([first_kill, second_kill])
    # the pre-kill fires gracefulLeaveDelay before the session ends
    t_kill = torch.maximum(t_kill - p.graceful_leave_delay, t_create)
    return _state(_ns(t_create), _ns(t_kill), n, dev)


def next_event(state: ChurnState):
    kill_eff = torch.where(state.t_dead < T_INF, T_INF, state.t_kill)
    t = torch.minimum(state.t_tick, torch.minimum(
        torch.min(state.t_create), torch.min(kill_eff)))
    return torch.minimum(t, torch.min(state.t_dead))


def _random_step(p: ChurnParams, rng, alive, created, killed, t_create,
                 t_kill, t_tick, t_end):
    """RandomChurn::handleMessage: at each churnChangeInterval tick, one
    create (a random dead slot, now) and one removal (a random live node,
    now), each with its probability."""
    tick = t_tick < t_end
    r1, r2, r3, r4 = rng_mod.split(rng, 4)
    do_create = tick & (rng_mod.uniform(r1, (), F64)
                        < p.creation_probability)
    do_remove = tick & (rng_mod.uniform(r2, (), F64)
                        < p.removal_probability)
    cur_alive = (alive | created) & ~killed
    dead_w = torch.where(~cur_alive & (t_create >= T_INF), 1.0, 0.0).to(F64)
    alive_w = torch.where(cur_alive, 1.0, 0.0).to(F64)
    has_dead = torch.sum(dead_w) > 0
    has_alive = torch.sum(alive_w) > 0
    di = rng_mod.categorical(r3, torch.log(torch.clamp(dead_w, min=1e-30)))
    ai = rng_mod.categorical(r4, torch.log(torch.clamp(alive_w, min=1e-30)))
    t_create = t_create.index_put(
        (di,), torch.where(do_create & has_dead, t_end, t_create[di]))
    t_kill = t_kill.index_put(
        (ai,), torch.where(do_remove & has_alive, t_end, t_kill[ai]))
    t_tick = torch.where(tick, t_tick + int(p.churn_change_interval * NS),
                         t_tick)
    return t_create, t_kill, t_tick


def step(state: ChurnState, p: ChurnParams, alive, t_start, t_end, rng,
         life_mean=None):
    """Fire create / pre-kill / kill events inside [t_start, t_end);
    returns (state', created, killed, leaving), all [N] bool;
    ``life_mean`` as in ``init``."""
    del t_start
    n = p.num_slots
    created = (state.t_create < t_end) & ~alive
    leaving = (state.t_kill < t_end) & alive & ~created & (
        state.t_dead >= T_INF)
    killed = (state.t_dead < t_end) & alive & ~created
    r_grace, rng = rng_mod.split(rng)
    grace_ns = int(p.graceful_leave_delay * NS)
    coin = rng_mod.uniform(r_grace, (n,), F64) \
        < p.graceful_leave_probability
    t_dead = torch.where(leaving, state.t_kill + grace_ns, state.t_dead)
    graceful = torch.where(leaving, coin, state.graceful)
    t_dead = torch.where(killed, T_INF, t_dead)
    graceful = graceful & ~killed
    t_create = torch.where(created, T_INF, state.t_create)
    t_tick = state.t_tick
    if p.model in ("lifetime", "pareto"):
        # rebirth a dead time after the pre-kill (t_kill still holds it),
        # then a fresh session (LifetimeChurn / ParetoChurn::deleteNode)
        r1, r2 = rng_mod.split(rng)
        if p.model == "lifetime":
            dead = _draw_lifetime(r1, p, (n,), life_mean)
            life = _draw_lifetime(r2, p, (n,), life_mean)
        else:
            dead = _shifted_pareto(r1, 3.0, state.d_mean.to(F64), (n,))
            life = _shifted_pareto(r2, 3.0, state.l_mean.to(F64), (n,))
        next_create = state.t_kill + _ns(dead)
        next_kill = torch.maximum(next_create + _ns(life) - grace_ns,
                                  next_create)
        t_create = torch.where(killed, next_create, t_create)
        t_kill = torch.where(killed, next_kill, state.t_kill)
    else:
        t_kill = torch.where(killed, T_INF, state.t_kill)
        if p.model == "random":
            t_create, t_kill, t_tick = _random_step(
                p, rng, alive, created, killed, t_create, t_kill, t_tick,
                t_end)
    # a next-incarnation pre-kill drawn inside the current window is
    # deferred past it
    t_kill = torch.where(killed & (t_kill <= t_end), t_end + 1, t_kill)
    return ChurnState(
        t_create=t_create, t_kill=t_kill, t_dead=t_dead, graceful=graceful,
        l_mean=state.l_mean, d_mean=state.d_mean,
        t_tick=t_tick), created, killed, leaving
