"""Movement generators for game workloads (PyTorch).

Counterpart of ``oversim_tpu/apps/movement.py`` (reference
SimpleGameClient's MovementGenerator family, selected by
``movementGenerator``).  Every generator advances float32 positions by
``speed * dt`` toward a per-node waypoint and redraws the waypoint when
reached: randomRoaming (uniform in the field), hotspotRoaming (inside a
disc at a quarter of the field), traverseRoaming (the field's corners),
greatGathering (the centre), groupRoaming (a target shared by each group
of ``group_size`` slots, drawn from ``group_seed``, the group and the
epoch ``t / period``) and realWorldRoaming (a waypoint script played
back with a per-slot phase).

Two call forms, as the JAX package's: the all-[N] form (one key, ``pos``
[N, 2]) and the per-node form the game overlays' vmapped steps use,
batched here as a key per node (``rng`` [N, 2], ``pos`` [N, 2]: each
node's draw comes from its own key).  groupRoaming and realWorldRoaming
take node identity from the slot and need the all-[N] form; the per-node
form raises for them, as the JAX package's vmapped call does.

Float work stays float32 in the JAX package's order: sums are explicit
adds, roots are taken in float64 and rounded once, the hotspot's
``sin``/``cos`` are glibc's (``xlamath``), and ``t / period`` is a
multiply by the float32 reciprocal, as XLA compiles a division by a
constant.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from oversim_tpu_torch import rng as rng_mod
from oversim_tpu_torch import xlamath

F32 = torch.float32
F64 = torch.float64
I32 = torch.int32

(GEN_RANDOM, GEN_HOTSPOT, GEN_TRAVERSE, GEN_GATHER, GEN_GROUP,
 GEN_REALWORLD) = 0, 1, 2, 3, 4, 5

GENERATORS = {
    "randomRoaming": GEN_RANDOM,
    "hotspotRoaming": GEN_HOTSPOT,
    "traverseRoaming": GEN_TRAVERSE,
    "greatGathering": GEN_GATHER,
    "groupRoaming": GEN_GROUP,
    "realWorldRoaming": GEN_REALWORLD,
}


@dataclasses.dataclass(frozen=True)
class MoveParams:
    """JAX field names and defaults."""

    generator: str = "randomRoaming"
    field: float = 1000.0
    speed: float = 5.0
    hotspot_radius: float = 100.0
    group_size: int = 8
    group_seed: int = 7
    script: tuple = ((0.0, 0.0), (500.0, 500.0), (1000.0, 0.0))


def norm(d):
    """float32 ``sqrt(sum(d * d, -1))`` as XLA computes it: the squares
    added left to right, the root correctly rounded."""
    sq = d * d
    acc = sq[..., 0]
    for k in range(1, sq.shape[-1]):
        acc = acc + sq[..., k]
    return torch.sqrt(acc.to(F64)).to(F32)


def _f32(v, device):
    return torch.full((), v, dtype=F32, device=device)


def _epoch(t_s, p: MoveParams, device):
    """int32(t_s / period): a python ``t_s`` divides on the host, a
    float32 tensor multiplies by the reciprocal."""
    period = p.field / max(p.speed, 1e-6)
    if isinstance(t_s, torch.Tensor):
        return (t_s.to(F32) * _f32(1.0 / period, device)).to(I32)
    return torch.full((), int(t_s / period), dtype=I32, device=device)


def init_positions(rng, n: int, p: MoveParams):
    """(pos [N, 2], waypoint [N, 2]) uniform in the field (one key)."""
    r1, r2 = rng_mod.split(rng).unbind(-2)
    pos = rng_mod.uniform(r1, (n, 2), F32, 0.0, p.field)
    return pos, draw_waypoints(r2, pos, p)


def draw_waypoints(rng, pos, p: MoveParams, t_s=0.0):
    """Per-generator waypoint draw for ``pos`` ([N, 2] with one key, or
    ``rng`` [N, 2] with a key per node); ``t_s`` (sim seconds) drives the
    time-sliced generators' epoch."""
    dev = pos.device
    kb = rng.dim() - 1                      # key batch dims
    shape = tuple(pos.shape[kb:])           # each key's draw
    batch = shape[:-1]
    g = GENERATORS[p.generator]
    if g in (GEN_GROUP, GEN_REALWORLD):
        if kb or not batch:
            raise ValueError(
                f"{p.generator} requires the all-[N] form (node identity is "
                "positional); call with the full position batch")
        n = batch[0]
        epoch = _epoch(t_s, p, dev)
        if g == GEN_GROUP:
            gid = torch.arange(n, dtype=torch.int64, device=dev) \
                // p.group_size
            base = rng_mod.PRNGKey(p.group_seed, dev)
            k = rng_mod.fold_in(rng_mod.fold_in(base, gid), epoch)
            return rng_mod.uniform(k, (2,), F32, 0.0, p.field)
        script = torch.tensor(p.script, dtype=F32, device=dev)
        idx = torch.remainder(torch.arange(n, dtype=torch.int64, device=dev)
                              + epoch, script.shape[0])
        return script[idx]
    if g == GEN_RANDOM:
        return rng_mod.uniform(rng, shape, F32, 0.0, p.field)
    if g == GEN_HOTSPOT:
        r1, r2 = rng_mod.split(rng).unbind(-2)
        center = _f32(p.field / 4, dev)
        ang = rng_mod.uniform(r1, batch, F32, 0.0, 2 * math.pi)
        rad = torch.sqrt(rng_mod.uniform(r2, batch, F32).to(F64)).to(F32) \
            * _f32(p.hotspot_radius, dev)
        return center + torch.stack(
            [rad * xlamath.cosf(ang), rad * xlamath.sinf(ang)], -1)
    if g == GEN_TRAVERSE:
        corner = rng_mod.randint(rng, batch, 0, 4, dtype=torch.int64)
        cx = torch.where((corner == 1) | (corner == 3), p.field, 0.0)
        cy = torch.where(corner >= 2, p.field, 0.0)
        return torch.stack([cx, cy], -1).to(F32)
    if g == GEN_GATHER:
        return torch.full(tuple(pos.shape), p.field / 2, dtype=F32,
                          device=dev)
    raise ValueError(p.generator)


def step(pos, wp, dt_s, rng, p: MoveParams, t_s=0.0):
    """Advance toward the waypoint by ``speed * dt_s``; redraw reached
    waypoints (the time-sliced generators retarget every call)."""
    dev = pos.device
    d = wp - pos
    dist = norm(d)[..., None]
    if isinstance(dt_s, torch.Tensor):
        stepv = _f32(p.speed, dev) * dt_s.to(F32)
    else:
        stepv = _f32(p.speed * dt_s, dev)
    reach = dist[..., 0] <= stepv
    unit = d / torch.clamp(dist, min=1e-6)
    new_pos = torch.where(reach[..., None], wp, pos + unit * stepv)
    drawn = draw_waypoints(rng, pos, p, t_s)
    if GENERATORS[p.generator] in (GEN_GROUP, GEN_REALWORLD):
        return new_pos, drawn
    return new_pos, torch.where(reach[..., None], drawn, wp)
