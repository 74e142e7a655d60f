"""Recursive KBR routing state (PyTorch).

Counterpart of ``oversim_tpu/common/route.py``.  The main path routes
iteratively (Kademlia with ``rcfg=None``): the route slot table is part
of the state and of the event horizon, but never filled.  Ported: the
config, the state, ``init`` and ``next_event``; the per-hop forwarding
machinery (forward/ACK/reroute) is still to be ported (ROADMAP Queue A)
and Kademlia raises when ``rcfg`` is given.
"""

from __future__ import annotations

import dataclasses

import torch

I32 = torch.int32
I64 = torch.int64
NO_NODE = -1
T_INF = 2 ** 62


@dataclasses.dataclass(frozen=True)
class RouteConfig:
    slots: int = 4
    max_retries: int = 2
    hop_max: int = 32
    ack_timeout_ns: int = 1_500_000_000
    route_acks: bool = True
    overhead_b: int = 28
    mode: str = "semi"
    record_route: bool = False
    ext_words: int = 0


@dataclasses.dataclass
class RouteState:
    """``[N, Q, ...]`` pending-ACK route slots."""

    active: torch.Tensor
    gen: torch.Tensor
    dst: torch.Tensor
    t_to: torch.Tensor
    retries: torch.Tensor
    key: torch.Tensor        # [N, Q, KL] u32 lanes in int64
    inner: torch.Tensor
    a: torch.Tensor
    b: torch.Tensor
    c: torch.Tensor
    hops: torch.Tensor
    stamp: torch.Tensor
    size_b: torch.Tensor
    visited: torch.Tensor    # [N, Q, V]


def init(cfg: RouteConfig, kl: int, visited_cap: int, n: int,
         device="cpu") -> RouteState:
    q = cfg.slots

    def full(shape, v, dt):
        return torch.full((n,) + shape, v, dtype=dt, device=device)

    return RouteState(
        active=full((q,), False, torch.bool), gen=full((q,), 0, I32),
        dst=full((q,), NO_NODE, I32), t_to=full((q,), T_INF, I64),
        retries=full((q,), 0, I32), key=full((q, kl), 0, I64),
        inner=full((q,), 0, I32), a=full((q,), 0, I32),
        b=full((q,), 0, I32), c=full((q,), 0, I32),
        hops=full((q,), 0, I32), stamp=full((q,), 0, I64),
        size_b=full((q,), 0, I32),
        visited=full((q, visited_cap), NO_NODE, I32))


def next_event(rt: RouteState):
    """[N] earliest ACK timeout."""
    return torch.min(torch.where(rt.active, rt.t_to, T_INF), 1).values
