"""Vast: spatial AOI overlay (VON) for games (PyTorch).

Counterpart of ``oversim_tpu/overlay/vast.py`` (reference Vast.{h,cc}:
Voronoi neighbor discovery with an AOI radius) driving the
SimpleGameClient movement workload (``apps/movement.py``).  No KBR, no
lookup engine and no app object: the neighbor logic is spatial.

* Positions travel on the wire: two float32 words bitcast into the key
  lanes (``_pack_pos``/``_unpack_pos``, a float32 to uint32 view).
* Join: a JOIN carrying the joiner's position greedy-forwards to the
  neighbor closest to it until no neighbor is closer than the current
  node, which adopts the joiner and ACKs with its neighbor list; the
  joiner HELLOs the listed nodes.
* Move: every ``move_interval`` the position advances and a MOVE goes to
  every neighbor; a receiver refreshes the mover, drops it beyond 1.5
  AOI, and with ``hint_prob`` answers with a HINT of its neighbors
  nearest the mover; a hinted node it does not know gets a HELLO.
* Neighbors are soft state, pruned after ``nbr_timeout`` of silence; a
  READY node left without neighbors rejoins.

The neighbor set is the nearest D of the known nodes (``_nbr_put``: a
re-announced node keeps its last occurrence, a stable sort by distance),
Quon's (``overlay/quon.py``) binds the nearest node of each quadrant
first.  The step runs over the leading ``[N]`` axis with the JAX
package's operations, its inbox slots one after another.  A slot holds
one message kind, so its four kind-exclusive neighbor puts (JOIN's
acceptor, JOIN_ACK, HELLO, MOVE) are one put, and its two drops (MOVE
past the AOI, BYE) one drop: every other branch leaves the state alone
for that slot, so the state each reads is the JAX package's.  Each
slot's per-neighbor HELLO or MOVE sends are one send of D lanes, in the
JAX package's order.  Distances are float32 squares added left to right
with the root taken in float64 and rounded once.
"""

from __future__ import annotations

import dataclasses

import torch

from oversim_tpu_torch import rng as rng_mod
from oversim_tpu_torch import stats as stats_mod
from oversim_tpu_torch.apps import movement as move_mod
from oversim_tpu_torch.apps.base import seconds
from oversim_tpu_torch.core import keys as K
from oversim_tpu_torch.engine.logic import Outbox, select_tree

I32 = torch.int32
I64 = torch.int64
F32 = torch.float32
F64 = torch.float64
NS = 1_000_000_000
T_INF = 2 ** 62
NO_NODE = -1
M32 = 0xFFFFFFFF
FAR = 1e30                 # a free slot's distance

DEAD, JOINING, READY = 0, 1, 2

# wire kinds (spatial family: 110+)
V_JOIN = 110        # key=joiner pos, a=joiner slot, hops=greedy hops
V_JOIN_ACK = 111    # key=acceptor pos, nodes=its neighbors
V_MOVE = 112        # key=new pos
V_HINT = 113        # nodes=neighbors near the target
V_HELLO = 114       # key=pos, a=1 → ack requested
V_BYE = 115         # graceful neighbor removal


@dataclasses.dataclass(frozen=True)
class VastParams:
    """JAX field names and defaults (AOIWidth from Vast.ned)."""

    aoi: float = 100.0
    max_nbr: int = 8
    move_interval: float = 5.0
    join_delay: float = 10.0
    nbr_timeout: float = 30.0
    hint_prob: float = 0.25
    join_ttl: int = 16
    move: move_mod.MoveParams = move_mod.MoveParams(field=300.0, speed=5.0)


@dataclasses.dataclass
class VastState:
    state: torch.Tensor     # [N] i32
    pos: torch.Tensor       # [N, 2] f32
    wp: torch.Tensor        # [N, 2] f32
    nbr: torch.Tensor       # [N, D] i32
    nbr_pos: torch.Tensor   # [N, D, 2] f32
    nbr_seen: torch.Tensor  # [N, D] i64
    t_join: torch.Tensor    # [N] i64
    t_move: torch.Tensor    # [N] i64
    t_prune: torch.Tensor   # [N] i64
    seq: torch.Tensor       # [N] i32


def _pack_pos(pos, lanes: int):
    """[N, 2] float32 → [N, lanes] u32 key lanes (in int64), the two
    position words first."""
    words = pos.contiguous().view(I32).to(I64) & M32
    pad = torch.zeros(pos.shape[:-1] + (lanes - 2,), dtype=I64,
                      device=pos.device)
    return torch.cat([words, pad], -1)


def _unpack_pos(key):
    return key[..., :2].to(I32).contiguous().view(F32)


def nearest_first(dist, *payload):
    """``payload`` ([N, C, ...] each) in ascending ``dist`` [N, C]
    order, ties by index (JAX's stable argsort)."""
    order = torch.sort(dist, dim=1, stable=True).indices
    out = []
    for x in payload:
        ix = order.reshape(order.shape + (1,) * (x.dim() - 2))
        out.append(torch.gather(x, 1, ix.expand(order.shape + x.shape[2:])))
    return out


class VastLogic:
    """Engine logic interface (see engine/logic.py)."""

    PREFIX = "vast"    # stat prefix (subclasses: quon)

    def __init__(self, spec: K.KeySpec = K.DEFAULT_SPEC,
                 params: VastParams = VastParams()):
        self.key_spec = spec
        self.p = params

    def stat_spec(self) -> stats_mod.StatSpec:
        x = self.PREFIX
        return stats_mod.StatSpec(
            scalars=(f"{x}_nbr_count", f"{x}_pos_err"),
            hists=(),
            counters=(f"{x}_joins", f"{x}_moves", f"{x}_updates",
                      f"{x}_hints", f"{x}_join_fwd"))

    def init(self, rng, n: int) -> VastState:
        d = self.p.max_nbr
        dev = rng.device
        pos, wp = move_mod.init_positions(rng, n, self.p.move)

        def full(shape, v, dt):
            return torch.full((n,) + shape, v, dtype=dt, device=dev)

        return VastState(
            state=full((), DEAD, I32), pos=pos, wp=wp,
            nbr=full((d,), NO_NODE, I32), nbr_pos=full((d, 2), 0.0, F32),
            nbr_seen=full((d,), 0, I64), t_join=full((), T_INF, I64),
            t_move=full((), T_INF, I64), t_prune=full((), T_INF, I64),
            seq=full((), 0, I32))

    def split(self, st):
        return st, None

    def merge(self, node_part, glob):
        return node_part

    def post_step(self, ctx, st, events):
        return st

    def reset(self, st: VastState, clear, join, t_now, rng):
        n = st.state.shape[0]
        r_i, r_j = rng_mod.split(rng).unbind(-2)
        st = select_tree(clear, self.init(r_i, n), st)
        jitter = (rng_mod.uniform(r_j, (n,), F64) * 0.1 * NS).to(I64)
        return dataclasses.replace(
            st, state=torch.where(join, JOINING, st.state),
            t_join=torch.where(join, t_now + jitter, st.t_join))

    def ready_mask(self, st: VastState):
        return st.state == READY

    def next_event(self, st: VastState):
        ready = st.state == READY
        t = torch.where(st.state == JOINING, st.t_join, T_INF)
        t = torch.minimum(t, torch.where(ready, st.t_move, T_INF))
        return torch.minimum(t, torch.where(ready, st.t_prune, T_INF))

    # -- neighbor set ---------------------------------------------------------

    def _merged(self, st, cands, cand_pos, now, node_idx):
        """The known set plus the candidates ([N, C]), a re-announced
        node keeping only its last occurrence: (nodes, positions, seen)."""
        cands = torch.where(cands == node_idx[:, None], NO_NODE, cands)
        aug = torch.cat([st.nbr, cands], 1)
        augp = torch.cat([st.nbr_pos, cand_pos], 1)
        augs = torch.cat([st.nbr_seen, torch.where(
            cands != NO_NODE, now[:, None], 0)], 1)
        dup = K.dup_mask(aug.flip(1)).flip(1)
        return torch.where(dup, NO_NODE, aug), augp, augs

    def _nbr_put(self, st, cands, cand_pos, now, me_pos, node_idx):
        """Merge candidates into the nearest-D neighbor set."""
        d = self.p.max_nbr
        aug, augp, augs = self._merged(st, cands, cand_pos, now, node_idx)
        dist = torch.where(aug == NO_NODE, FAR,
                           move_mod.norm(augp - me_pos[:, None]))
        aug, augp, augs = nearest_first(dist, aug, augp, augs)
        return dataclasses.replace(st, nbr=aug[:, :d], nbr_pos=augp[:, :d],
                                   nbr_seen=augs[:, :d])

    @staticmethod
    def _nbr_drop(st, bad, en):
        hit = (st.nbr == bad[:, None]) & (st.nbr != NO_NODE) & en[:, None]
        return dataclasses.replace(
            st, nbr=torch.where(hit, NO_NODE, st.nbr),
            nbr_seen=torch.where(hit, 0, st.nbr_seen))

    @staticmethod
    def _closest_to(st, target_pos):
        """(the neighbor closest to ``target_pos``, its distance)."""
        dist = torch.where(st.nbr == NO_NODE, FAR,
                           move_mod.norm(st.nbr_pos - target_pos[:, None]))
        j = torch.argmin(dist, 1)[:, None]
        return st.nbr.gather(1, j)[:, 0], dist.gather(1, j)[:, 0]

    def _prune(self, ctx, st, t0, t_end):
        """Drop the neighbors silent for ``nbr_timeout`` at each due prune
        timer (soft state); a READY node left with none rejoins."""
        p = self.p
        half_ns = int(p.nbr_timeout / 2 * NS)
        en_p = (st.state == READY) & (st.t_prune < t_end)
        now_p = torch.maximum(st.t_prune, t0)
        stale = en_p[:, None] & (st.nbr != NO_NODE) & (
            st.nbr_seen + int(p.nbr_timeout * NS) < now_p[:, None])
        st = dataclasses.replace(
            st, nbr=torch.where(stale, NO_NODE, st.nbr),
            nbr_seen=torch.where(stale, 0, st.nbr_seen),
            t_prune=torch.where(en_p, now_p + half_ns, st.t_prune))
        lost = (st.state == READY) & en_p & ~torch.any(
            st.nbr != NO_NODE, 1) & (ctx.n_ready > 1)
        return dataclasses.replace(
            st, state=torch.where(lost, JOINING, st.state),
            t_join=torch.where(lost, now_p, st.t_join),
            t_move=torch.where(lost, T_INF, st.t_move),
            t_prune=torch.where(lost, T_INF, st.t_prune))

    # -- the batched step -----------------------------------------------------

    def step(self, ctx, st, msgs, rng, node_idx, *, outbox_slots, rmax):
        p, spec = self.p, self.key_spec
        n = st.state.shape[0]
        dev = st.state.device
        d = p.max_nbr
        ob = Outbox(n, outbox_slots, spec.lanes, rmax, dev)
        rngs = rng_mod.split(rng, 6)                              # [N, 6, 2]
        t0 = ctx.t_start
        t_end = ctx.t_end
        me = node_idx[:, None]
        zero = torch.zeros((n,), dtype=I32, device=dev)
        joins_cnt, moves_cnt, upd_cnt, hint_cnt, fwd_cnt = (zero,) * 5
        move_ns = int(p.move_interval * NS)
        half_ns = int(p.nbr_timeout / 2 * NS)

        def put(st, en, who, where_, now):
            return select_tree(en, self._nbr_put(
                st, who[:, None], where_[:, None], now, st.pos, node_idx), st)

        # ------------------------------------------------------- inbox -----
        # the position does not move inside the loop: its key lanes once
        my_key = _pack_pos(st.pos, spec.lanes)
        for r in range(msgs.valid.shape[1]):
            m = msgs.slot(r)
            now = m.t_deliver
            v = m.valid
            mpos = _unpack_pos(m.key)
            ready = st.state == READY
            my_d = move_mod.norm(st.pos - mpos)

            # JOIN: greedy point query (Vast::handleJoinRequest)
            en = v & (m.kind == V_JOIN) & ready
            cn, cd = self._closest_to(st, mpos)
            fwd = en & (cn != NO_NODE) & (cd < my_d) & (
                m.hops < p.join_ttl) & (cn != m.a)
            ob.send(fwd, now, cn, V_JOIN, key=m.key, a=m.a, hops=m.hops + 1,
                    size_b=24)
            fwd_cnt = fwd_cnt + fwd.to(I32)
            acc = en & ~fwd
            ob.send(acc, now, m.a, V_JOIN_ACK, key=my_key,
                    nodes=st.nbr[:, :min(d, rmax)], size_b=24 + 6 * d)

            # the slot's one neighbor put: the acceptor adopts the joiner,
            # a JOIN_ACK the acceptor, a HELLO or a MOVE kept in the AOI
            # (+50% hysteresis) the sender
            en_ack = v & (m.kind == V_JOIN_ACK) & (st.state == JOINING)
            en_hello = v & (m.kind == V_HELLO) & ready
            en_move = v & (m.kind == V_MOVE) & ready
            keep = en_move & (my_d <= 1.5 * p.aoi)
            st = put(st, acc | en_ack | en_hello | keep,
                     torch.where(acc, m.a, m.src), mpos, now)

            # JOIN_ACK: HELLO the acceptor's neighbors
            cand = m.nodes[:, :d]
            ob.send(en_ack[:, None] & (cand != NO_NODE) & (cand != me), now,
                    torch.clamp(cand, min=0), V_HELLO, key=my_key, a=1,
                    size_b=24)
            joins_cnt = joins_cnt + en_ack.to(I32)
            st = dataclasses.replace(
                st, state=torch.where(en_ack, READY, st.state),
                t_join=torch.where(en_ack, T_INF, st.t_join),
                t_move=torch.where(en_ack, now + move_ns, st.t_move),
                t_prune=torch.where(en_ack, now + half_ns, st.t_prune))

            # HELLO: answer a request
            ob.send(en_hello & (m.a != 0), now, m.src, V_HELLO, key=my_key,
                    a=0, size_b=24)

            # MOVE past the AOI, or BYE (graceful removal): drop the sender
            st = self._nbr_drop(st, m.src, (en_move & ~keep) | (
                v & (m.kind == V_BYE)))
            # MOVE: now and then HINT our neighbors nearest to the mover
            upd_cnt = upd_cnt + keep.to(I32)
            u = rng_mod.uniform(rng_mod.fold_in(rngs[:, 4], r), (), F64)
            do_hint = keep & (u < p.hint_prob)
            hd = torch.where((st.nbr == NO_NODE) | (st.nbr == m.src[:, None]),
                             FAR, move_mod.norm(st.nbr_pos - mpos[:, None]))
            hd_s, nb_s = nearest_first(hd, hd, st.nbr)
            hint_nodes = torch.where(hd_s < p.aoi, nb_s, NO_NODE)[:, :4]
            ob.send(do_hint & torch.any(hint_nodes != NO_NODE, 1), now,
                    m.src, V_HINT, nodes=hint_nodes, size_b=6 * 4)
            hint_cnt = hint_cnt + do_hint.to(I32)

            # HINT: HELLO the hinted nodes we do not know
            en = v & (m.kind == V_HINT) & ready
            cand = m.nodes[:, :4]
            known = torch.any(st.nbr[:, None, :] == cand[:, :, None], -1)
            ob.send(en[:, None] & (cand != NO_NODE) & (cand != me) & ~known,
                    now, torch.clamp(cand, min=0), V_HELLO, key=my_key, a=1,
                    size_b=24)

        # ------------------------------------------------------- timers ----
        # join: a greedy point query seeded at a bootstrap node
        en_j = (st.state == JOINING) & (st.t_join < t_end)
        now_j = torch.maximum(st.t_join, t0)
        boot = ctx.sample_ready(rngs[:, 1], node_idx)
        alone = en_j & (boot == NO_NODE)
        joins_cnt = joins_cnt + alone.to(I32)
        st = dataclasses.replace(
            st, state=torch.where(alone, READY, st.state),
            t_move=torch.where(alone, now_j + move_ns, st.t_move),
            t_prune=torch.where(alone, now_j + half_ns, st.t_prune),
            t_join=torch.where(alone, T_INF, torch.where(
                en_j, now_j + int(p.join_delay * NS), st.t_join)))
        ob.send(en_j & ~alone, now_j, torch.clamp(boot, min=0), V_JOIN,
                key=_pack_pos(st.pos, spec.lanes), a=node_idx, hops=0,
                size_b=24)

        # move + update multicast (Vast::handleMove + movement generator)
        due_m = (st.state == READY) & (st.t_move < t_end)
        en_m = due_m & ~ctx.leaving[node_idx.long()]
        now_m = torch.maximum(st.t_move, t0)
        new_pos, new_wp = move_mod.step(
            st.pos, st.wp, torch.full((), p.move_interval, dtype=F32,
                                      device=dev),
            rngs[:, 2], p.move, t_s=seconds(t0))
        st = dataclasses.replace(
            st, pos=torch.where(en_m[:, None], new_pos, st.pos),
            wp=torch.where(en_m[:, None], new_wp, st.wp),
            t_move=torch.where(due_m, now_m + move_ns, st.t_move))
        moves_cnt = moves_cnt + en_m.to(I32)
        ob.send(en_m[:, None] & (st.nbr != NO_NODE), now_m,
                torch.clamp(st.nbr, min=0), V_MOVE,
                key=_pack_pos(st.pos, spec.lanes), size_b=24)

        st = self._prune(ctx, st, t0, t_end)

        # ------------------------------------------------------ events -----
        nbr_n = torch.sum((st.nbr != NO_NODE).to(I32), 1, dtype=I32)
        x = self.PREFIX
        events = {
            f"c:{x}_joins": joins_cnt,
            f"c:{x}_moves": moves_cnt,
            f"c:{x}_updates": upd_cnt,
            f"c:{x}_hints": hint_cnt,
            f"c:{x}_join_fwd": fwd_cnt,
            f"s:{x}_nbr_count": (nbr_n.to(F32)[:, None],
                                 (st.state == READY)[:, None]),
            f"s:{x}_pos_err": (torch.zeros((n, 1), dtype=F32, device=dev),
                               torch.zeros((n, 1), dtype=torch.bool,
                                           device=dev)),
        }
        return st, ob, events
