"""PubSubMMOG — grid-subspace publish/subscribe game overlay (PyTorch).

Counterpart of ``oversim_tpu/overlay/pubsubmmog.py`` (reference
src/overlay/pubsubmmog/ PubSubMMOG.{h,cc} + PubSubLobby.{h,cc}): the
play field is a ``grid x grid`` array of subspaces; a lobby assigns one
responsible node per active subspace, players subscribe to every
subspace their AOI square overlaps, send each timeslot's move to the
current subspace's responsible node, which sends the slot's mover list
to its subscribers.

* The lobby is the logic's glob part (``PubSubGlob``: the responsible
  node and its age per subspace), kept by ``post_step`` from the nodes'
  ``"g:ps_want"`` events: dead responsibles and unadopted duties past a
  grace are cleared, and a vacant subspace goes to its last requester
  (the JAX package's scatter, where the highest node index wins, as one
  ``amax`` scatter of the node index).
* A responsible node serves at most ``max_children`` subscribers and
  rejects the rest.

The step runs over the leading ``[N]`` axis with the JAX package's
operations, its inbox slots one after another.  A subspace id is
``int32(pos / sub_size)`` per axis, where XLA multiplies by the float32
reciprocal of the constant width; the port multiplies too (a true
division puts a position on a cell border one cell off).  Every
``argmax`` of a bool goes through int32 (the first True index).
"""

from __future__ import annotations

import dataclasses

import torch

from oversim_tpu_torch import rng as rng_mod
from oversim_tpu_torch import stats as stats_mod
from oversim_tpu_torch.apps import base as app_base
from oversim_tpu_torch.apps import movement as move_mod
from oversim_tpu_torch.core import keys as K
from oversim_tpu_torch.engine.logic import (Outbox, first_true, one_hot,
                                          select_tree, take)

I32 = torch.int32
I64 = torch.int64
F32 = torch.float32
F64 = torch.float64
NS = 1_000_000_000
T_INF = 2 ** 62
NO_NODE = -1

DEAD, JOINING, READY = 0, 1, 2

PS_SUB_CALL = 125    # a=subspace: subscribe me
PS_SUB_RES = 126     # a=subspace, c=1 ok / 0 rejected (children full)
PS_UNSUB = 127       # a=subspace
PS_MOVE = 128        # a=subspace, b=timeslot, stamp=send time
PS_MOVELIST = 129    # a=subspace, b=timeslot, nodes=movers, stamp=slot t0


@dataclasses.dataclass(frozen=True)
class PubSubParams:
    """JAX field names and defaults (PubSubMMOG.ned:30-39,
    default.ini:321-326)."""

    field: float = 1000.0        # areaDimension
    grid: int = 4                # numSubspaces (per direction)
    aoi: float = 100.0           # AOIWidth
    move_rate: float = 2.0       # movementRate (timeslots per second)
    speed: float = 5.0           # movementSpeed (units/s)
    join_delay: float = 1.0      # joinDelay
    parent_timeout: float = 2.0  # parentTimeout
    max_move_delay: float = 1.0  # maxMoveDelay
    max_children: int = 12       # maxChildren (also the CH array cap)
    duties: int = 4              # subspace duties one node may hold
    subs: int = 4                # subscription slots
    generator: str = "randomRoaming"

    @property
    def nsub(self) -> int:
        return self.grid * self.grid

    @property
    def sub_size(self) -> float:
        return self.field / self.grid


@dataclasses.dataclass
class PubSubGlob:
    resp: torch.Tensor       # [S] i32 responsible node per subspace
    age: torch.Tensor        # [S] i32 ticks since assignment


@dataclasses.dataclass
class PubSubState:
    state: torch.Tensor      # [N] i32
    pos: torch.Tensor        # [N, 2] f32
    wp: torch.Tensor         # [N, 2] f32 waypoint
    sub_id: torch.Tensor     # [N, SB] i32 subspace ids (-1 free)
    sub_ok: torch.Tensor     # [N, SB] bool: subscription confirmed
    sub_seen: torch.Tensor   # [N, SB] i64: last move list from the parent
    want: torch.Tensor       # [N] i32
    duty: torch.Tensor       # [N, D] i32 subspace ids (-1 free)
    child: torch.Tensor      # [N, D, CH] i32 subscribers
    mover: torch.Tensor      # [N, D, CH] i32 this slot's movers
    mv_n: torch.Tensor       # [N, D] i32
    t_join: torch.Tensor     # [N] i64
    t_slot: torch.Tensor     # [N] i64 next timeslot boundary
    slot_no: torch.Tensor    # [N] i32
    glob: object             # PubSubGlob


class PubSubMMOGLogic:
    """Engine logic interface (see engine/logic.py)."""

    def __init__(self, spec: K.KeySpec = K.DEFAULT_SPEC,
                 params: PubSubParams = PubSubParams()):
        self.key_spec = spec
        self.p = params
        self.mp = move_mod.MoveParams(generator=params.generator,
                                      field=params.field, speed=params.speed)

    def stat_spec(self):
        return stats_mod.StatSpec(
            scalars=("ps_children",), hists=(),
            counters=("ps_joins", "ps_moves", "ps_lists_sent",
                      "ps_lists_recv", "ps_events_ok", "ps_events_late",
                      "ps_lost_lists", "ps_rejects"))

    def split(self, st):
        return dataclasses.replace(st, glob=None), st.glob

    def merge(self, node_part, glob):
        return dataclasses.replace(node_part, glob=glob)

    def post_step(self, ctx, st, events):
        """The lobby: clear dead responsibles and duties never adopted,
        then give each vacant wanted subspace to its last requester
        (PubSubLobby::handleRespCall, failedNode)."""
        g: PubSubGlob = st.glob
        s = g.resp.shape[0]
        dev = g.resp.device
        rc = torch.clamp(g.resp, min=0).long()
        alive_resp = (g.resp != NO_NODE) & ctx.alive[rc]
        held = torch.any(st.duty[rc] == torch.arange(
            s, dtype=I32, device=dev)[:, None], -1)
        keep = alive_resp & (held | (g.age < 100))
        resp = torch.where(keep, g.resp, NO_NODE)
        age = torch.where(keep, g.age + 1, 0)
        want = events.get("g:ps_want")
        if want is not None:
            n = want.shape[0]
            idx = torch.where(want >= 0, torch.clamp(want, 0, s - 1),
                              s).long()
            cand = torch.full((s + 1,), NO_NODE, dtype=I64,
                              device=dev).scatter_reduce(
                0, idx, torch.arange(n, dtype=I64, device=dev),
                reduce="amax")[:s].to(I32)
            assign = (resp == NO_NODE) & (cand != NO_NODE)
            resp = torch.where(assign, cand, resp)
            age = torch.where(assign, 0, age)
        return dataclasses.replace(st, glob=PubSubGlob(resp=resp, age=age))

    def init(self, rng, n: int) -> PubSubState:
        p = self.p
        dev = rng.device
        pos, wp = move_mod.init_positions(rng, n, self.mp)

        def full(shape, v, dt):
            return torch.full((n,) + shape, v, dtype=dt, device=dev)

        d, ch, sb = p.duties, p.max_children, p.subs
        return PubSubState(
            state=full((), DEAD, I32), pos=pos, wp=wp,
            sub_id=full((sb,), NO_NODE, I32),
            sub_ok=full((sb,), False, torch.bool),
            sub_seen=full((sb,), 0, I64), want=full((), NO_NODE, I32),
            duty=full((d,), NO_NODE, I32), child=full((d, ch), NO_NODE, I32),
            mover=full((d, ch), NO_NODE, I32), mv_n=full((d,), 0, I32),
            t_join=full((), T_INF, I64), t_slot=full((), T_INF, I64),
            slot_no=full((), 0, I32),
            glob=PubSubGlob(
                resp=torch.full((p.nsub,), NO_NODE, dtype=I32, device=dev),
                age=torch.zeros((p.nsub,), dtype=I32, device=dev)))

    def reset(self, st, clear, join, t_now, rng):
        n = st.state.shape[0]
        glob = st.glob
        st = dataclasses.replace(st, glob=None)
        fresh = dataclasses.replace(self.init(rng, n), glob=None)
        st = select_tree(clear, fresh, st)
        st = dataclasses.replace(st, glob=glob)
        jitter = (rng_mod.uniform(rng, (n,), F64) * self.p.join_delay
                  * NS).to(I64)
        return dataclasses.replace(
            st, state=torch.where(join, JOINING, st.state),
            t_join=torch.where(join, t_now + jitter, st.t_join))

    def ready_mask(self, st):
        return st.state == READY

    def next_event(self, st):
        t = torch.where(st.state == JOINING, st.t_join, T_INF)
        return torch.minimum(t, torch.where(st.state == READY, st.t_slot,
                                            T_INF))

    # -- helpers --------------------------------------------------------------

    def _cell(self, pos):
        """[..., 2] f32 positions → i32 grid cell ids (XLA's reciprocal
        multiply for the constant width)."""
        p = self.p
        dev = pos.device
        inv = torch.full((), 1.0, dtype=F32, device=dev) / torch.full(
            (), p.sub_size, dtype=F32, device=dev)
        c = torch.clamp((pos * inv).to(I32), 0, p.grid - 1)
        return c[..., 0] * p.grid + c[..., 1]

    def _aoi_subspaces(self, pos):
        """[N, 4] i32: the ids of the ≤4 subspaces the AOI square
        overlaps, a later duplicate -1 (the reference scans
        currentRegion ± AOIWidth)."""
        p = self.p
        dev = pos.device
        # the corners (-1, -1), (-1, 1), (1, -1), (1, 1) times AOI / 2,
        # made on the device (a host tensor's copy would synchronise)
        c = torch.arange(4, device=dev)
        sign = torch.stack([torch.div(c, 2, rounding_mode="floor"), c % 2],
                           -1) * 2 - 1
        corners = sign.to(F32) * torch.full((), p.aoi / 2.0, dtype=F32,
                                            device=dev)
        hi = torch.full((), p.field - 1e-3, dtype=F32, device=dev)
        q = torch.minimum(torch.clamp(pos[:, None, :] + corners, min=0.0),
                          hi)
        out = self._cell(q)
        dup = torch.zeros_like(out, dtype=torch.bool)
        for i in range(1, 4):
            dup[:, i] = torch.any(out[:, :i] == out[:, i:i + 1], 1)
        return torch.where(dup, NO_NODE, out)

    # -- the batched step -----------------------------------------------------

    def step(self, ctx, st, msgs, rng, node_idx, *, outbox_slots, rmax):
        p, spec = self.p, self.key_spec
        n = st.state.shape[0]
        dev = st.state.device
        d_max, ch, sb = p.duties, p.max_children, p.subs
        ob = Outbox(n, outbox_slots, spec.lanes, rmax, dev)
        t0, t_end = ctx.t_start, ctx.t_end
        ev = app_base.AppEvents(n, dev)
        glob: PubSubGlob = ctx.glob
        slot_ns = int(NS / p.move_rate)
        zero = torch.zeros((n,), dtype=I32, device=dev)
        c_joins = c_moves = c_sent = c_recv = c_ok = c_late = c_rej = zero
        late_ns = int(p.max_move_delay * NS)

        def resp_of(sid):
            return glob.resp[torch.clamp(sid, 0, p.nsub - 1).long()]

        # ------------------------------------------------------- inbox -----
        for r in range(msgs.valid.shape[1]):
            m = msgs.slot(r)
            now = m.t_deliver
            v = m.valid
            is_ready = st.state == READY

            # SUB_CALL: adopt a child for subspace a
            di_ok = st.duty == m.a[:, None]
            di = first_true(di_ok)
            en = v & (m.kind == PS_SUB_CALL) & is_ready & torch.any(di_ok, 1)
            crow = take(st.child, di)
            mine = crow == m.src[:, None]
            have = torch.any(mine, 1)
            free = torch.any(crow == NO_NODE, 1)
            slot = torch.where(have, first_true(mine),
                               first_true(crow == NO_NODE))
            adopt = en & (have | free)
            c_rej = c_rej + (en & ~have & ~free).to(I32)
            at = (one_hot(di, d_max) & adopt[:, None])[:, :, None] \
                & one_hot(slot, ch)[:, None, :]
            st = dataclasses.replace(st, child=torch.where(
                at, m.src[:, None, None], st.child))
            ob.send(en, now, m.src, PS_SUB_RES, a=m.a, c=adopt.to(I32),
                    size_b=16)

            # SUB_RES: subscription outcome
            si_ok = st.sub_id == m.a[:, None]
            si = one_hot(first_true(si_ok), sb)
            en = v & (m.kind == PS_SUB_RES) & torch.any(si_ok, 1)
            ok = si & (en & (m.c != 0))[:, None]
            fail = si & (en & (m.c == 0))[:, None]
            st = dataclasses.replace(
                st, sub_ok=st.sub_ok | ok,
                sub_seen=torch.where(ok, now[:, None], st.sub_seen),
                # rejected: drop the slot; the AOI scan re-requests later
                sub_id=torch.where(fail, NO_NODE, st.sub_id))

            # UNSUB: drop the child
            di_ok = st.duty == m.a[:, None]
            di = first_true(di_ok)
            en = v & (m.kind == PS_UNSUB) & torch.any(di_ok, 1)
            crow = take(st.child, di)
            mine = crow == m.src[:, None]
            hit = en & torch.any(mine, 1)
            at = (one_hot(di, d_max) & hit[:, None])[:, :, None] \
                & one_hot(first_true(mine), ch)[:, None, :]
            st = dataclasses.replace(st, child=torch.where(at, NO_NODE,
                                                           st.child))

            # MOVE: collect the mover into this timeslot
            di_ok = st.duty == m.a[:, None]
            di = first_true(di_ok)
            en = v & (m.kind == PS_MOVE) & is_ready & torch.any(di_ok, 1)
            c_moves = c_moves + en.to(I32)
            mrow = take(st.mover, di)
            mine = mrow == m.src[:, None]
            have = torch.any(mine, 1)
            slot = torch.where(have, first_true(mine),
                               first_true(mrow == NO_NODE))
            put = en & (have | torch.any(mrow == NO_NODE, 1))
            at_d = one_hot(di, d_max)
            at = (at_d & put[:, None])[:, :, None] \
                & one_hot(slot, ch)[:, None, :]
            st = dataclasses.replace(
                st, mover=torch.where(at, m.src[:, None, None], st.mover),
                mv_n=st.mv_n + (at_d & (put & ~have)[:, None]).to(I32))

            # MOVELIST: the subspace's slot digest
            si_ok = st.sub_id == m.a[:, None]
            en = v & (m.kind == PS_MOVELIST) & is_ready & torch.any(si_ok, 1)
            c_recv = c_recv + en.to(I32)
            nmv = torch.sum((m.nodes[:, :ch] != NO_NODE).to(I32), 1,
                            dtype=I32)
            late = now - m.stamp > late_ns
            c_ok = c_ok + torch.where(en & ~late, nmv, 0)
            c_late = c_late + torch.where(en & late, nmv, 0)
            st = dataclasses.replace(st, sub_seen=torch.where(
                one_hot(first_true(si_ok), sb) & en[:, None], now[:, None],
                st.sub_seen))

        # ------------------------------------------------------- timers ----
        # join: enter the field at the next slot boundary
        en_j = (st.state == JOINING) & (st.t_join < t_end)
        now_j = torch.maximum(st.t_join, t0)
        c_joins = c_joins + en_j.to(I32)
        st = dataclasses.replace(
            st, state=torch.where(en_j, READY, st.state),
            t_slot=torch.where(en_j, now_j + slot_ns, st.t_slot))

        # timeslot: move, publish, AOI upkeep, duty digest
        is_ready = st.state == READY
        en_s = is_ready & (st.t_slot < t_end)
        now_s = torch.maximum(st.t_slot, t0)
        rng_wp = rng_mod.split(rng)[:, 0]

        # advance the position toward the waypoint (movement.py family)
        dt = torch.where(en_s, 1.0 / p.move_rate, 0.0).to(F32)
        spd_dt = torch.full((), p.speed, dtype=F32, device=dev) * dt
        delta = st.wp - st.pos
        dist = torch.clamp(move_mod.norm(delta), min=1e-6)
        step_len = torch.minimum(dist, spd_dt)
        pos = st.pos + delta / dist[:, None] * step_len[:, None]
        arrived = en_s & (dist <= spd_dt)
        wp = torch.where(arrived[:, None], move_mod.draw_waypoints(
            rng_wp, pos, self.mp, t_s=app_base.seconds(ctx.t_start)), st.wp)
        st = dataclasses.replace(st, pos=pos, wp=wp)

        cur = self._cell(st.pos)
        aoi = self._aoi_subspaces(st.pos)                      # [N, 4]

        # publish my move to the current subspace's responsible node
        resp_cur = resp_of(cur)
        ob.send(en_s & (resp_cur != NO_NODE) & ctx.measuring, now_s,
                torch.clamp(resp_cur, min=0), PS_MOVE, a=cur, b=st.slot_no,
                stamp=now_s, size_b=40)

        # subscription upkeep: unsubscribe subspaces that left the AOI
        in_aoi = torch.any(st.sub_id[:, :, None] == aoi[:, None, :], -1)
        go = en_s[:, None] & (st.sub_id != NO_NODE) & ~in_aoi
        rs = resp_of(st.sub_id)
        ob.send(go & (rs != NO_NODE), now_s, torch.clamp(rs, min=0),
                PS_UNSUB, a=st.sub_id, size_b=16)
        st = dataclasses.replace(
            st, sub_id=torch.where(go, NO_NODE, st.sub_id),
            sub_ok=st.sub_ok & ~go)
        # parent timeout: a confirmed subspace gone silent → re-request
        stale = (en_s[:, None] & st.sub_ok & (st.sub_id != NO_NODE)
                 & (now_s[:, None] - st.sub_seen > int(p.parent_timeout
                                                       * NS)))
        st = dataclasses.replace(st, sub_ok=st.sub_ok & ~stale)
        # adopt one missing AOI subspace into a free slot
        missing = torch.full((n,), NO_NODE, dtype=I32, device=dev)
        for ai in range(4):
            a_i = aoi[:, ai]
            known = torch.any(st.sub_id == a_i[:, None], 1)
            missing = torch.where((missing == NO_NODE) & (a_i >= 0) & ~known,
                                  a_i, missing)
        free_sb = st.sub_id == NO_NODE
        put = en_s & (missing != NO_NODE) & torch.any(free_sb, 1)
        st = dataclasses.replace(st, sub_id=torch.where(
            one_hot(first_true(free_sb), sb) & put[:, None], missing[:, None],
            st.sub_id))
        # (re)subscribe one unconfirmed slot: to the responsible node if
        # the lobby has one, else raise a want-event for post_step
        need = (st.sub_id != NO_NODE) & ~st.sub_ok
        ni = first_true(need)
        has_need = en_s & torch.any(need, 1)
        ns_id = st.sub_id.gather(1, ni[:, None])[:, 0]
        rs = resp_of(ns_id)
        ob.send(has_need & (rs != NO_NODE), now_s, torch.clamp(rs, min=0),
                PS_SUB_CALL, a=ns_id, size_b=16)
        want_out = torch.where(has_need & (rs == NO_NODE), ns_id, NO_NODE)
        st = dataclasses.replace(st, sub_seen=torch.where(
            one_hot(ni, sb) & (has_need & (rs != NO_NODE))[:, None],
            now_s[:, None], st.sub_seen))

        # duty upkeep: drop duties the lobby reassigned away
        lost = en_s[:, None] & (st.duty != NO_NODE) & (
            resp_of(st.duty) != node_idx[:, None])
        st = dataclasses.replace(
            st, duty=torch.where(lost, NO_NODE, st.duty),
            child=torch.where(lost[:, :, None], NO_NODE, st.child),
            mover=torch.where(lost[:, :, None], NO_NODE, st.mover))
        # adopt duties the lobby handed me among the AOI subspaces and
        # the current one
        cand_ids = torch.cat([aoi, cur[:, None]], 1)
        for k in range(5):
            sid = cand_ids[:, k]
            mine = is_ready & (sid >= 0) & (resp_of(sid) == node_idx)
            known = torch.any(st.duty == sid[:, None], 1)
            free_d = st.duty == NO_NODE
            put = mine & ~known & torch.any(free_d, 1)
            st = dataclasses.replace(st, duty=torch.where(
                one_hot(first_true(free_d), d_max) & put[:, None],
                sid[:, None], st.duty))

        # duty digest: flush each duty's mover list to its children
        act = en_s[:, None] & (st.duty != NO_NODE) & ctx.measuring  # [N, D]
        nch = torch.sum((st.child != NO_NODE).to(I32), 2, dtype=I32)
        for di in range(d_max):
            ev.value("ps_children", nch[:, di].to(F32), act[:, di])
        snd = (act & (st.mv_n > 0))[:, :, None] & (st.child != NO_NODE)
        c_sent = c_sent + torch.sum(snd.reshape(n, -1).to(I32), 1,
                                    dtype=I32)
        ob.send(snd.reshape(n, -1), now_s,
                torch.clamp(st.child, min=0).reshape(n, -1), PS_MOVELIST,
                a=st.duty.repeat_interleave(ch, 1), b=st.slot_no,
                nodes=st.mover.repeat_interleave(ch, 1), stamp=now_s,
                size_b=16 + 4 * ch)
        st = dataclasses.replace(
            st, mover=torch.where(en_s[:, None, None], NO_NODE, st.mover),
            mv_n=torch.where(en_s[:, None], 0, st.mv_n),
            slot_no=st.slot_no + en_s.to(I32),
            t_slot=torch.where(en_s, now_s + slot_ns, st.t_slot))

        events = {"c:ps_joins": c_joins, "c:ps_moves": c_moves,
                  "c:ps_lists_sent": c_sent, "c:ps_lists_recv": c_recv,
                  "c:ps_events_ok": c_ok, "c:ps_events_late": c_late,
                  "c:ps_lost_lists": zero, "c:ps_rejects": c_rej,
                  "g:ps_want": want_out}
        ev.finish(events, {})
        return st, ob, events
