"""Churn generators as scheduled slot events (PyTorch).

Counterpart of ``oversim_tpu/churn.py``.  Every slot carries its next
create / pre-kill / final-kill time; the engine flips the alive mask for
the slots whose event falls inside the tick window.  Ported: the
``"none"`` model (NoChurn: one node created every
~truncnormal(initPhaseCreationInterval, dev) until the target count) with
the graceful-leave machinery of ``step``.  The lifetime, pareto, random
and trace models are still to be ported (ROADMAP Queue A) and raise.

Draws that the JAX package makes in its default float (float64 under
its x64 mode) are made in float64 here.
"""

from __future__ import annotations

import dataclasses

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


def _unported(p: ChurnParams):
    return NotImplementedError(
        f"churn model {p.model!r} is not ported yet (ROADMAP Queue A); "
        "the port runs model='none'")


def init(rng, p: ChurnParams, life_mean=None) -> ChurnState:
    if p.model != "none":
        raise _unported(p)
    del life_mean
    n = p.num_slots
    dev = rng.device
    r1 = rng_mod.split(rng, 4)[0]
    stagger = _truncnormal(r1, p.init_interval, p.init_deviation, (n,))
    t_create = _blocked_cumsum(stagger)
    return ChurnState(
        t_create=(t_create * NS).to(I64),
        t_kill=torch.full((n,), T_INF, dtype=I64, device=dev),
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
    returns (state', created, killed, leaving), all [N] bool."""
    if p.model != "none":
        raise _unported(p)
    del t_start, life_mean
    created = (state.t_create < t_end) & ~alive
    leaving = (state.t_kill < t_end) & alive & ~created & (
        state.t_dead >= T_INF)
    killed = (state.t_dead < t_end) & alive & ~created
    r_grace = rng_mod.split(rng)[0]
    grace_ns = int(p.graceful_leave_delay * NS)
    coin = rng_mod.uniform(r_grace, (p.num_slots,), F64) \
        < p.graceful_leave_probability
    t_dead = torch.where(leaving, state.t_kill + grace_ns, state.t_dead)
    graceful = torch.where(leaving, coin, state.graceful)
    t_dead = torch.where(killed, T_INF, t_dead)
    graceful = graceful & ~killed
    t_create = torch.where(created, T_INF, state.t_create)
    t_kill = torch.where(killed, T_INF, state.t_kill)
    t_kill = torch.where(killed & (t_kill <= t_end), t_end + 1, t_kill)
    return ChurnState(
        t_create=t_create, t_kill=t_kill, t_dead=t_dead, graceful=graceful,
        l_mean=state.l_mean, d_mean=state.d_mean,
        t_tick=state.t_tick), created, killed, leaving
