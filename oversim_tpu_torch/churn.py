"""Churn generators as scheduled slot events (PyTorch).

Counterpart of ``oversim_tpu/churn.py``.  Every slot carries its next
create / pre-kill / final-kill time; the engine flips the alive mask for
the slots whose event falls inside the tick window.  Ported: the
``"none"`` model (NoChurn: one node created every
~truncnormal(initPhaseCreationInterval, dev) until the target count) and
the ``"lifetime"`` model (LifetimeChurn: 2x target context slots, the
first half created during the init phase and killed a lifetime after
it, the second half born a lifetime after it; every final kill schedules
the slot's rebirth a dead time after its pre-kill, with a fresh
lifetime), both with the graceful-leave machinery of ``step``.  The
lifetime distribution is the Weibull one (``rng.weibull_min``, bit-exact
at ``lifetime_par1 = 1``); a campaign's ``churn.lifetimeMean`` sweep
passes its mean to ``init`` and ``step`` as a float64 tensor
(``life_mean``).  The pareto, random and trace models and the
``pareto_shifted`` and ``truncnormal`` lifetime distributions are still
to be ported (ROADMAP Queue A) and raise.

Draws that the JAX package makes in its default float (float64 under
its x64 mode) are made in float64 here.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from oversim_tpu_torch import rng as rng_mod

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


PORTED_MODELS = ("none", "lifetime")


def _check_ported(p: ChurnParams):
    if p.model not in PORTED_MODELS:
        raise NotImplementedError(
            f"churn model {p.model!r} is not ported yet (ROADMAP Queue A); "
            f"the port runs {PORTED_MODELS}")
    if p.model == "lifetime" and p.lifetime_dist != "weibull":
        raise NotImplementedError(
            f"lifetime distribution {p.lifetime_dist!r} is not ported yet "
            "(ROADMAP Queue A); the port draws 'weibull'")


def _draw_lifetime(rng, p: ChurnParams, shape, mean=None):
    """Session / dead-time draw in seconds (float64): Weibull with the
    scale that makes its mean ``lifetime_mean``, or ``mean`` (a swept
    float64 tensor)."""
    k = p.lifetime_par1
    mean = p.lifetime_mean if mean is None else mean
    scale = mean / math.gamma(1.0 + 1.0 / k)
    return rng_mod.weibull_min(rng, scale, k, shape, F64)


def init(rng, p: ChurnParams, life_mean=None) -> ChurnState:
    """``life_mean`` (a float64 tensor) overrides ``p.lifetime_mean`` in
    the lifetime model's session draws."""
    _check_ported(p)
    n = p.num_slots
    dev = rng.device
    r1, r2, r3, r4 = rng_mod.split(rng, 4)
    if p.model == "none":
        stagger = _truncnormal(r1, p.init_interval, p.init_deviation, (n,))
        t_create = _blocked_cumsum(stagger)
        t_kill = torch.full((n,), T_INF, dtype=I64, device=dev)
    else:
        tgt = p.target_num
        fin = p.init_finished_time
        i = torch.arange(tgt, dtype=F64, device=dev)
        first_create = _truncnormal(r1, p.init_interval * i,
                                    p.init_deviation, (tgt,))
        first_kill = fin + _draw_lifetime(r2, p, (tgt,), life_mean)
        second_create = fin + _draw_lifetime(r3, p, (tgt,), life_mean)
        second_kill = second_create + _draw_lifetime(r4, p, (tgt,),
                                                     life_mean)
        t_create = torch.cat([first_create, second_create])
        t_kill = torch.cat([first_kill, second_kill])
        # the pre-kill fires gracefulLeaveDelay before the session ends
        t_kill = torch.maximum(t_kill - p.graceful_leave_delay, t_create)
        t_kill = (t_kill * NS).to(I64)
    return ChurnState(
        t_create=(t_create * NS).to(I64),
        t_kill=t_kill,
        t_dead=torch.full((n,), T_INF, dtype=I64, device=dev),
        graceful=torch.zeros((n,), dtype=torch.bool, device=dev),
        l_mean=torch.zeros((n,), dtype=torch.float32, device=dev),
        d_mean=torch.zeros((n,), dtype=torch.float32, device=dev),
        t_tick=torch.tensor(T_INF, dtype=I64, device=dev))


def next_event(state: ChurnState):
    kill_eff = torch.where(state.t_dead < T_INF, T_INF, state.t_kill)
    t = torch.minimum(state.t_tick, torch.minimum(
        torch.min(state.t_create), torch.min(kill_eff)))
    return torch.minimum(t, torch.min(state.t_dead))


def step(state: ChurnState, p: ChurnParams, alive, t_start, t_end, rng,
         life_mean=None):
    """Fire create / pre-kill / kill events inside [t_start, t_end);
    returns (state', created, killed, leaving), all [N] bool;
    ``life_mean`` as in ``init``."""
    _check_ported(p)
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
    if p.model == "lifetime":
        # LifetimeChurn::deleteNode: rebirth a dead time after the
        # pre-kill (t_kill still holds it), then a fresh session
        r1, r2 = rng_mod.split(rng)
        dead_time = (_draw_lifetime(r1, p, (n,), life_mean) * NS).to(I64)
        lifetime = (_draw_lifetime(r2, p, (n,), life_mean) * NS).to(I64)
        next_create = state.t_kill + dead_time
        next_kill = torch.maximum(next_create + lifetime - grace_ns,
                                  next_create)
        t_create = torch.where(killed, next_create, t_create)
        t_kill = torch.where(killed, next_kill, state.t_kill)
    else:
        t_kill = torch.where(killed, T_INF, state.t_kill)
    # a next-incarnation pre-kill drawn inside the current window is
    # deferred past it
    t_kill = torch.where(killed & (t_kill <= t_end), t_end + 1, t_kill)
    return ChurnState(
        t_create=t_create, t_kill=t_kill, t_dead=t_dead, graceful=graceful,
        l_mean=state.l_mean, d_mean=state.d_mean,
        t_tick=state.t_tick), created, killed, leaving
