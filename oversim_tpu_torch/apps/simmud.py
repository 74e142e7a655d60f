"""SimMud: a region-based MMOG over Scribe multicast (PyTorch).

Counterpart of ``oversim_tpu/apps/simmud.py`` (reference
src/tier2/simmud/SimMud.{h,cc}): the map is divided into ``grid`` x
``grid`` square regions, each a Scribe group (region = group id);
players multicast their position updates to the region under their
feet and re-join a region's group when they cross a border
(SimMud.h:33-46 regionSize/playerMoveMessages).

It extends ``apps/scribe.py`` with a movement layer
(``apps/movement.py``): every ``move_interval`` the position advances;
a region change re-targets ``group`` and forces an immediate
re-subscribe, and the Scribe publish is the position update.  The
region of a position multiplies by the region width's float32
reciprocal, as XLA compiles the JAX package's division by that
constant.
"""

from __future__ import annotations

import dataclasses

import torch

from oversim_tpu_torch import rng as rng_mod
from oversim_tpu_torch.apps import base
from oversim_tpu_torch.apps import movement as move_mod
from oversim_tpu_torch.apps.scribe import ScribeApp, ScribeParams, ScribeState
from oversim_tpu_torch.core import keys as keys_mod

I32 = torch.int32
I64 = torch.int64
F32 = torch.float32
NS = 1_000_000_000
T_INF = 2 ** 62
NO_NODE = -1


@dataclasses.dataclass(frozen=True)
class SimMudParams(ScribeParams):
    """JAX field names and defaults; ``num_groups`` is ``grid ** 2``."""

    grid: int = 2                 # regions per axis
    move_interval: float = 5.0    # movementDelay
    move: move_mod.MoveParams = move_mod.MoveParams(field=1000.0)

    def __post_init__(self):
        object.__setattr__(self, "num_groups", self.grid * self.grid)


@dataclasses.dataclass
class SimMudState(ScribeState):
    pos: torch.Tensor           # [N, 2] f32
    wp: torch.Tensor            # [N, 2] f32 movement waypoint
    t_move: torch.Tensor        # [N] i64
    region_moves: torch.Tensor  # [N] i32 border crossings


def region_of(pos, p: SimMudParams):
    """Region id of positions ``pos`` [..., 2]."""
    dev = pos.device
    inv = torch.full((), 1.0, dtype=F32, device=dev) / torch.full(
        (), p.move.field / p.grid, dtype=F32, device=dev)
    cell = torch.clamp((pos * inv).to(I32), 0, p.grid - 1)
    return cell[..., 0] * p.grid + cell[..., 1]


class SimMudApp(ScribeApp):
    """Tier-2 game app (interface: apps/base.py docstring)."""

    def __init__(self, params: SimMudParams = SimMudParams(),
                 spec: keys_mod.KeySpec = keys_mod.DEFAULT_SPEC):
        super().__init__(params, spec)

    def init(self, n: int, device="cpu") -> SimMudState:
        pos, wp = move_mod.init_positions(rng_mod.PRNGKey(97, device), n,
                                          self.p.move)
        return SimMudState(
            **self._base_fields(n, device), pos=pos, wp=wp,
            t_move=torch.full((n,), T_INF, dtype=I64, device=device),
            region_moves=torch.zeros((n,), dtype=I32, device=device))

    def on_ready(self, app, en, now, rng):
        app = super().on_ready(app, en, now, rng)
        # the joined group is the region under our feet, not a draw
        return dataclasses.replace(
            app, group=torch.where(en, region_of(app.pos, self.p), app.group),
            t_move=torch.where(en, now + int(self.p.move_interval * NS),
                               app.t_move))

    def on_stop(self, app, en):
        app = super().on_stop(app, en)
        return dataclasses.replace(
            app, t_move=torch.where(en, T_INF, app.t_move))

    def next_event(self, app):
        return torch.minimum(super().next_event(app), app.t_move)

    def on_timer(self, app, en, ctx, now, rng, ev, node_idx):
        p: SimMudParams = self.p
        # movement tick (SimMud::handleMove): advance, and on a border
        # crossing re-target the group and re-subscribe at once
        mv = en & (app.t_move < ctx.t_end)
        r = rng_mod.split(rng)
        new_pos, new_wp = move_mod.step(
            app.pos, app.wp, torch.full((), p.move_interval, dtype=F32,
                                        device=app.pos.device),
            r[:, 0], p.move, t_s=base.seconds(ctx.t_start))
        new_pos = torch.where(mv[:, None], new_pos, app.pos)
        new_wp = torch.where(mv[:, None], new_wp, app.wp)
        new_region = region_of(new_pos, p)
        crossed = mv & (app.group >= 0) & (new_region != app.group)
        app = dataclasses.replace(
            app, pos=new_pos, wp=new_wp,
            group=torch.where(crossed, new_region, app.group),
            parent=torch.where(crossed, NO_NODE, app.parent),
            is_root=torch.where(crossed, False, app.is_root),
            region_moves=app.region_moves + crossed.to(I32),
            t_sub=torch.where(crossed, now, app.t_sub),
            t_move=torch.where(mv, now + int(p.move_interval * NS),
                               app.t_move))
        return super().on_timer(app, en, ctx, now, r[:, 1], ev, node_idx)
