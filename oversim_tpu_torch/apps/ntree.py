"""NTree — server-less quadtree game overlay as a tier app (PyTorch).

Counterpart of ``oversim_tpu/apps/ntree.py`` (reference
src/overlay/ntree/NTree.{h,cc}: the game world is a quadtree of groups
that divide past ``maxChildren`` members and collapse when they shrink,
NTree.h:124-137).  The leader of quadtree cell c is the node
responsible for the cell's rendezvous key (``NTreeGlobal.cell_keys``)
on the KBR overlay underneath, so NTree runs over any KBR logic (the
builder puts it over Chord):

  * every player registers with the leader of its cell at its depth,
    refreshing periodically (soft state);
  * a leader whose cell holds more than ``max_children`` fresh members
    answers DIVIDE (descend one level), one holding at most
    ``collapse_below`` below the root answers COLLAPSE (ascend);
  * game events go to the cell leader, which fans them out to the
    registered members.

Every hook runs over the whole node axis.  The app has only the
one-slot ``on_msg``, as the JAX package's: an overlay hands it its inbox
slot by slot (``apps/base.py on_msgs_fold``), so its sends enter the
outbox in slot order.  The quadtree cell of a position multiplies by
the cell width's float32 reciprocal, as XLA compiles the JAX package's
division (``cell_of``, ``cell_of_dyn``).
"""

from __future__ import annotations

import dataclasses

import torch

from oversim_tpu_torch import rng as rng_mod
from oversim_tpu_torch.apps import base
from oversim_tpu_torch.apps import movement as move_mod
from oversim_tpu_torch.core import keys as keys_mod
from oversim_tpu_torch.engine.logic import first_true, one_hot

I32 = torch.int32
I64 = torch.int64
F32 = torch.float32
F64 = torch.float64
NS = 1_000_000_000
T_INF = 2 ** 62
NO_NODE = -1

# wire kinds (NTree family: 120+)
NT_JOIN = 120       # register at cell leader: a=cell id, b=depth
NT_JOIN_ACK = 121   # b=1 → DIVIDE (descend), b=2 → COLLAPSE (ascend)
NT_EVENT = 122      # game event to leader: a=cell id, stamp=t0
NT_EVENT_FWD = 123  # leader → member fan-out

M_REG, M_EVENT = 0, 1


@dataclasses.dataclass(frozen=True)
class NTreeParams:
    """JAX field names and defaults."""

    max_depth: int = 3            # static quadtree depth bound
    max_children: int = 5         # divide threshold (maxChildren)
    collapse_below: int = 2       # collapse threshold
    member_slots: int = 8         # per-led-cell member table
    led_cells: int = 4            # cells one node can lead
    move_interval: float = 5.0
    refresh: float = 10.0         # registration refresh
    event_interval: float = 10.0
    move: move_mod.MoveParams = move_mod.MoveParams(field=1000.0, speed=20.0)

    @property
    def num_cells(self) -> int:
        # 1 + 4 + 16 + ... = (4^(L+1) - 1) / 3
        return (4 ** (self.max_depth + 1) - 1) // 3


def cell_of(pos, depth: int, p: NTreeParams):
    """Quadtree cell id for positions ``pos`` [..., 2] at static
    ``depth`` (row-major per level, levels packed: offset(l) =
    (4^l - 1)/3).  The cell width is a constant here, so the division
    is XLA's multiply by its float32 reciprocal."""
    side = 1 << depth
    dev = pos.device
    inv = torch.full((), 1.0, dtype=F32, device=dev) / torch.full(
        (), p.move.field / side, dtype=F32, device=dev)
    c = torch.clamp((pos * inv).to(I32), 0, side - 1)
    return ((4 ** depth) - 1) // 3 + c[..., 0] * side + c[..., 1]


def cell_of_dyn(pos, depth, p: NTreeParams):
    """Per-position depth (``depth`` an i32 tensor of ``pos``'s batch
    shape).  XLA rewrites ``pos / (field / side)`` into ``pos * side``
    times the float32 reciprocal of the constant field (exact
    reassociation here: ``side`` is a power of two), so the port
    multiplies too; the true division puts about 4% of positions near a
    cell border into the neighbouring cell."""
    one = torch.ones_like(depth)
    side = torch.bitwise_left_shift(one, depth).to(I32)
    dev = pos.device
    inv = torch.full((), 1.0, dtype=F32, device=dev) / torch.full(
        (), p.move.field, dtype=F32, device=dev)
    c = torch.clamp(torch.minimum((pos * (side.to(F32) * inv)[..., None])
                                  .to(I32), (side - 1)[..., None]), min=0)
    offset = torch.div(torch.bitwise_left_shift(one, 2 * depth) - 1, 3,
                       rounding_mode="floor").to(I32)
    return offset + c[..., 0] * side + c[..., 1]


@dataclasses.dataclass
class NTreeState:
    pos: torch.Tensor       # [N, 2] f32
    wp: torch.Tensor        # [N, 2] f32
    depth: torch.Tensor     # [N] i32 current subscription depth
    cell: torch.Tensor      # [N] i32 registered cell (-1 none)
    led_cell: torch.Tensor  # [N, C] i32 led cell ids (-1 free)
    led_mem: torch.Tensor   # [N, C, M] i32
    led_seen: torch.Tensor  # [N, C, M] i64
    t_move: torch.Tensor    # [N] i64
    t_reg: torch.Tensor     # [N] i64
    t_evt: torch.Tensor     # [N] i64
    seq: torch.Tensor       # [N] i32


@dataclasses.dataclass
class NTreeGlobal:
    cell_keys: torch.Tensor   # [num_cells, KL] u32 rendezvous keys


class NTreeApp:
    """Tier app (interface: apps/base.py docstring)."""

    def __init__(self, params: NTreeParams = NTreeParams(),
                 spec: keys_mod.KeySpec = keys_mod.DEFAULT_SPEC):
        self.p = params
        self.spec = spec

    def stat_spec(self):
        return dict(
            scalars=("ntree_event_latency_s", "ntree_group_size"),
            hists=(),
            counters=("ntree_registers", "ntree_divides",
                      "ntree_collapses", "ntree_events",
                      "ntree_event_delivered", "ntree_lookup_failed"))

    def init(self, n: int, device="cpu") -> NTreeState:
        p = self.p
        pos, wp = move_mod.init_positions(rng_mod.PRNGKey(131, device), n,
                                          p.move)
        c, m = p.led_cells, p.member_slots

        def full(shape, v, dt):
            return torch.full((n,) + shape, v, dtype=dt, device=device)

        return NTreeState(
            pos=pos, wp=wp, depth=full((), 0, I32), cell=full((), -1, I32),
            led_cell=full((c,), -1, I32), led_mem=full((c, m), NO_NODE, I32),
            led_seen=full((c, m), 0, I64), t_move=full((), T_INF, I64),
            t_reg=full((), T_INF, I64), t_evt=full((), T_INF, I64),
            seq=full((), 0, I32))

    def glob_init(self, rng) -> NTreeGlobal:
        return NTreeGlobal(cell_keys=keys_mod.random_keys(
            rng, (self.p.num_cells,), self.spec))

    def post_step(self, ctx, state, glob, events):
        return state, glob

    def on_ready(self, app, en, now, rng):
        """``rng`` is one key per node ([N, 2])."""
        off = (rng_mod.uniform(rng, (), F64) * self.p.event_interval
               * NS).to(I64)
        return dataclasses.replace(
            app,
            t_move=torch.where(en, now + int(self.p.move_interval * NS),
                               app.t_move),
            t_reg=torch.where(en, now, app.t_reg),
            t_evt=torch.where(en, now + off, app.t_evt))

    def on_stop(self, app, en):
        return dataclasses.replace(
            app, t_move=torch.where(en, T_INF, app.t_move),
            t_reg=torch.where(en, T_INF, app.t_reg),
            t_evt=torch.where(en, T_INF, app.t_evt))

    def on_leave(self, app, en, ctx, ob, ev, now, node_idx, handover):
        return app    # tree state is soft (refresh-rebuilt)

    def next_event(self, app):
        return torch.minimum(app.t_move, torch.minimum(app.t_reg, app.t_evt))

    def on_timer(self, app, en, ctx, now, rng, ev, node_idx):
        p = self.p
        glob: NTreeGlobal = ctx.glob

        # movement
        mv = en & (app.t_move < ctx.t_end)
        r_mv = rng_mod.split(rng)[:, 0]
        npos, nwp = move_mod.step(
            app.pos, app.wp, torch.full((), p.move_interval, dtype=F32,
                                        device=app.pos.device),
            r_mv, p.move, t_s=base.seconds(ctx.t_start))
        app = dataclasses.replace(
            app, pos=torch.where(mv[:, None], npos, app.pos),
            wp=torch.where(mv[:, None], nwp, app.wp),
            t_move=torch.where(mv, now + int(p.move_interval * NS),
                               app.t_move))

        # registration refresh / event: one lookup per fire
        reg_due = en & (app.t_reg < ctx.t_end)
        evt_hit = en & (app.t_evt < ctx.t_end)
        evt_due = evt_hit & ~reg_due
        tgt_cell = torch.clamp(cell_of_dyn(app.pos, app.depth, p), 0,
                               p.num_cells - 1)
        key = glob.cell_keys[tgt_cell.long()]
        ev.count("ntree_registers", reg_due)
        ev.count("ntree_events", evt_due & ctx.measuring)
        app = dataclasses.replace(
            app,
            t_reg=torch.where(reg_due, now + int(p.refresh * NS), app.t_reg),
            t_evt=torch.where(evt_hit, now + int(p.event_interval * NS),
                              app.t_evt),
            seq=app.seq + (reg_due | evt_due).to(I32))
        mode = torch.where(reg_due, M_REG, M_EVENT)
        return app, base.LookupReq(want=reg_due | evt_due, key=key,
                                   tag=(tgt_cell * 4 + mode).to(I32))

    def on_lookup_done(self, app, done, ctx, ob, ev, now, node_idx):
        en = done.en
        mode = done.tag % 4
        cell = torch.div(done.tag, 4, rounding_mode="floor")
        leader = done.results[:, 0]
        suc = done.success & (leader != NO_NODE)
        ev.count("ntree_lookup_failed", en & ~suc)
        ob.send(en & suc & (mode == M_REG), now, leader, NT_JOIN, a=cell,
                b=app.depth, size_b=24)
        ob.send(en & suc & (mode == M_EVENT), now, leader, NT_EVENT, a=cell,
                stamp=now, size_b=64)
        return app

    def _led_row(self, app, cell):
        """(row index for ``cell`` [N] in the led-cell table, have_row)."""
        hit = app.led_cell == cell[:, None]
        free = app.led_cell < 0
        have = torch.any(hit, 1)
        row = torch.where(have, first_true(hit), first_true(free)).to(I32)
        return row, have | torch.any(free, 1)

    def on_msg(self, app, m, ctx, ob, ev, is_sib):
        """One inbox slot (fields [N])."""
        p = self.p
        now = m.t_deliver
        c_n, m_n = p.led_cells, p.member_slots
        fresh_ns = int(3 * p.refresh * NS)

        def row_of(x, row):
            return x.gather(1, row.long()[:, None, None].expand(
                -1, 1, x.shape[2]))[:, 0]

        # member registration at the leader (NTree join/divide logic)
        en = m.valid & (m.kind == NT_JOIN)
        row, ok = self._led_row(app, m.a)
        row_ok = en & ok
        mem, seen = row_of(app.led_mem, row), row_of(app.led_seen, row)
        # refresh or insert the member (LRU slot on overflow)
        mh = mem == m.src[:, None]
        col = torch.where(torch.any(mh, 1), first_true(mh),
                          torch.argmin(seen, 1)).to(I32)
        at_r = one_hot(row, c_n) & row_ok[:, None]
        at_rc = at_r[:, :, None] & one_hot(col, m_n)[:, None, :]
        app = dataclasses.replace(
            app, led_cell=torch.where(at_r, m.a[:, None], app.led_cell),
            led_mem=torch.where(at_rc, m.src[:, None, None], app.led_mem),
            led_seen=torch.where(at_rc, now[:, None, None], app.led_seen))
        # census after the insert (fresh members)
        row_c = torch.clamp(row, 0, c_n - 1)
        mem2, seen2 = row_of(app.led_mem, row_c), row_of(app.led_seen, row_c)
        fresh = (mem2 != NO_NODE) & (seen2 + fresh_ns > now[:, None])
        n_mem = torch.sum(fresh.to(I32), 1, dtype=I32)
        ev.value("ntree_group_size", n_mem.to(F32), row_ok & ctx.measuring)
        # divide when too big and not at max depth; collapse when too
        # small and below the root
        divide = row_ok & (n_mem > p.max_children) & (m.b < p.max_depth)
        collapse = row_ok & ~divide & (n_mem <= p.collapse_below) & (m.b > 0)
        ev.count("ntree_divides", divide)
        ev.count("ntree_collapses", collapse)
        code = torch.where(divide, 1, torch.where(collapse, 2, 0))
        ob.send(row_ok, now, m.src, NT_JOIN_ACK, a=m.a, b=code, size_b=16)

        # registration answer at the member
        en = m.valid & (m.kind == NT_JOIN_ACK)
        descend = en & (m.b == 1)
        ascend = en & (m.b == 2)
        app = dataclasses.replace(
            app, cell=torch.where(en, m.a, app.cell),
            depth=torch.clamp(app.depth + descend.to(I32) - ascend.to(I32),
                              0, p.max_depth),
            # re-register right away after a depth change
            t_reg=torch.where(descend | ascend, now, app.t_reg))

        # event at the leader → fan out to the cell's members
        en = m.valid & (m.kind == NT_EVENT)
        row, ok = self._led_row(app, m.a)
        row = torch.clamp(row, 0, c_n - 1)
        mem, seen = row_of(app.led_mem, row), row_of(app.led_seen, row)
        fresh = (mem != NO_NODE) & (seen + fresh_ns > now[:, None])
        ob.send((en & ok)[:, None] & fresh & (mem != m.src[:, None]), now,
                torch.clamp(mem, min=0), NT_EVENT_FWD, a=m.a, stamp=m.stamp,
                size_b=64)

        # event delivery at members
        en = m.valid & (m.kind == NT_EVENT_FWD)
        ev.count("ntree_event_delivered", en & ctx.measuring)
        ev.value("ntree_event_latency_s", base.seconds(now - m.stamp),
                 en & ctx.measuring)
        return app

    @property
    def hist_map(self):
        return {}
