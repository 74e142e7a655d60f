"""Chord ring DHT as batched per-node logic (PyTorch).

Counterpart of ``oversim_tpu/overlay/chord.py`` (reference Chord.cc,
ChordSuccessorList, ChordFingerTable; default.ini:167-183): a successor
list ``[N, S]`` kept sorted by clockwise distance from the own key, a
predecessor, a finger table ``[N, B]`` with dirty marks repaired one
lookup at a time, aggressive join, stabilize / notify, fix-fingers,
predecessor pings carrying Vivaldi coordinates (common/ncs.py), the
NeighborCache RTT estimator feeding adaptive lookup timeouts
(common/neighborcache.py), iterative lookups in replace mode
(common/lookup.py, ``merge=False``) and the KBRTest or DHT app (the
Common API update() hook reports successor-list and predecessor deltas;
an app without a batched completion hook gets the per-slot fold).

The JAX package writes ``step`` for one node and vmaps it; here it runs
over the leading ``[N]`` axis (or the sparse tick's lanes), operation for
operation, so the two packages stay leaf-exact.  The findNode of every
inbox slot compares each slot's key with the 168 finger and successor
candidates: instead of ``[N, R, 168, KL]`` lane tensors it folds the
ring offsets of keys and candidates from the own key into int64 words
(each at its own shape) and forms only the top two lanes of the
candidate-to-key distance with their borrow at ``[N, R, 168]``, which is
what the approximate sort reads; the closest candidate is the first
minimum (``torch.argmin`` returns the first index), element 0 of the
stable sort.

``rcfg`` (a ``common/route.py`` RouteConfig) switches the app's data
path to recursive routing in the config's mode: semi-recursive,
full-recursive or source routing (verify.ini's ChordSource).  The inbox
pre-pass (``route.prepass``) ACKs, forwards or decapsulates KBR_ROUTE
messages with every slot's findNode result, the app timer originates the
routable payloads (``route.originate``) and an ACK timeout reroutes the
parked copy around the failed hop (``route.reroute``).  App lookups stay
on the iterative engine either way, as in the JAX package.

Still to be ported, and refused in ``__init__`` (ROADMAP Queue A 7a):
partition merging, GNP/NPS coordinates, malicious nodes and
proximity-aware lookups.
"""

from __future__ import annotations

import dataclasses

import torch

from oversim_tpu_torch import rng as rng_mod
from oversim_tpu_torch import stats as stats_mod
from oversim_tpu_torch.apps import base as app_base
from oversim_tpu_torch.apps.kbrtest import KbrTestApp
from oversim_tpu_torch.common import lookup as lk_mod
from oversim_tpu_torch.common import malicious as mal_mod
from oversim_tpu_torch.common import ncs as ncs_mod
from oversim_tpu_torch.common import neighborcache as nc_mod
from oversim_tpu_torch.common import route as rt_mod
from oversim_tpu_torch.common import wire
from oversim_tpu_torch.core import keys as K
from oversim_tpu_torch.engine.logic import (Outbox, keys_of, put,
                                           select_tree, take)

I32 = torch.int32
I64 = torch.int64
F32 = torch.float32
F64 = torch.float64
NS = 1_000_000_000
T_INF = 2 ** 62
NO_NODE = -1
UMAX = K.UMAX
M32 = K.M32
I64_MAX = 2 ** 63 - 1          # the top key of a UMAX distance
I64_MIN = -2 ** 63             # the top key of a zero distance

DEAD, JOINING, READY = 0, 1, 2
P_JOIN, P_FINGER, P_APP, P_MERGE = 1, 2, 3, 4
BCAST_FANOUT = 8


@dataclasses.dataclass(frozen=True)
class ChordParams:
    """default.ini:167-183 (JAX field names and defaults)."""

    join_delay: float = 10.0
    stabilize_delay: float = 20.0
    fixfingers_delay: float = 120.0
    check_pred_delay: float = 5.0
    succ_size: int = 8
    aggressive_join: bool = True
    rpc_timeout: float = 1.5
    merge_partitions: bool = False
    merge_interval: float = 20.0


@dataclasses.dataclass
class ChordState:
    state: torch.Tensor         # [N] i32 DEAD/JOINING/READY
    pred: torch.Tensor          # [N] i32
    succ: torch.Tensor          # [N, S] i32 ring-sorted, NO_NODE padded
    finger: torch.Tensor        # [N, B] i32
    finger_dirty: torch.Tensor  # [N, B] bool
    t_join: torch.Tensor        # [N] i64
    t_stab: torch.Tensor        # [N] i64
    t_fix: torch.Tensor         # [N] i64
    t_cp: torch.Tensor          # [N] i64
    stab_op: torch.Tensor       # [N] i32 0 idle, 1 stabilize, 2 notify
    stab_dst: torch.Tensor      # [N] i32
    stab_to: torch.Tensor       # [N] i64
    cp_to: torch.Tensor         # [N] i64
    cp_dst: torch.Tensor        # [N] i32
    lk: lk_mod.LookupState
    rr: rt_mod.RouteState
    cp_sent: torch.Tensor       # [N] i64
    t_merge: torch.Tensor       # [N] i64
    t_nps: torch.Tensor         # [N] i64
    nps_dst: torch.Tensor       # [N] i32
    nps_sent: torch.Tensor      # [N] i64
    ncs: ncs_mod.NcsState
    nc: nc_mod.NcState
    app: object
    app_glob: object


def _ns(seconds: float) -> int:
    return int(seconds * NS)


def _secs(dt):
    """ns interval → float32 seconds as XLA compiles ``x / NS``: a
    multiply by the float32 reciprocal."""
    return dt.to(F32) * torch.full((), 1.0 / NS, dtype=F32, device=dt.device)


def _top_key(d):
    """[..., KL] distance lanes → [...] int64 in the order of the
    approximate sort (the top two u32 lanes, folded)."""
    if d.shape[-1] >= 2:
        return ((d[..., 0] - (1 << 31)) << 32) | d[..., 1]
    return d[..., 0]


def _sub_top_key(a, b, spec: K.KeySpec):
    """``_top_key(K.sub(a, b))`` for broadcastable ``a``, ``b`` [..., KL]:
    the lower lanes only decide the borrow (compared folded, at their own
    shapes), so only the top two lanes are formed at the broadcast
    shape."""
    kl = a.shape[-1]
    top = min(2, kl)
    borrow = 0
    if kl > top:
        borrow = K.lex_lt_eq(K.fold_lanes(a[..., top:]),
                             K.fold_lanes(b[..., top:]))[0].to(I64)
    lanes = []
    for i in range(top - 1, -1, -1):
        s = a[..., i] - b[..., i] - borrow
        borrow = (s < 0).to(I64)
        lanes.append(s & M32)
    lanes = lanes[::-1]
    lanes[0] = lanes[0] & spec.top_lane_mask
    if top == 2:
        return ((lanes[0] - (1 << 31)) << 32) | lanes[1]
    return lanes[0]


def _lex_argmin(dist):
    """[..., C, KL] → [...] i32 index of the first smallest row by the
    top two lanes: element 0 of the stable approximate sort."""
    return torch.argmin(_top_key(dist), -1).to(I32)


def _pad(vec, width: int):
    """[N, k] node slots → [N, width]: cut, or padded with NO_NODE."""
    k = vec.shape[1]
    if k >= width:
        return vec[:, :width]
    return torch.cat([vec, torch.full((vec.shape[0], width - k), NO_NODE,
                                      dtype=vec.dtype, device=vec.device)], 1)


def _sort_order(key):
    """Stable ascending order of int64 sort keys along the last axis."""
    return torch.sort(key, dim=-1, stable=True).indices


def far_key(spec: K.KeySpec):
    """``_sub_top_key``'s value for an all-ones distance (the approximate
    sort's key of a masked candidate)."""
    return I64_MAX if spec.lanes >= 2 else K.M32


def ring_sorted(ctx, me_key, node_idx, cands, width: int, spec: K.KeySpec,
                clockwise: bool = True):
    """The first ``width`` unique candidates [N, width] of ``cands``
    [N, C] by clockwise (successor list) or counter-clockwise
    (predecessor list) ring distance from the own key ``me_key`` [N, KL];
    NO_NODE, the node itself and repeats are dropped, the rest padded
    with NO_NODE (a stable sort: ties keep candidate order)."""
    ck = keys_of(ctx, cands)
    bad = (cands == NO_NODE) | (cands == node_idx[:, None]) | \
        K.dup_mask(cands)
    me = me_key[:, None]
    d = (_sub_top_key(ck, me, spec) if clockwise
         else _sub_top_key(me, ck, spec))
    order = _sort_order(torch.where(bad, far_key(spec), d))[:, :width]
    out = torch.where(torch.gather(bad, 1, order), NO_NODE,
                      torch.gather(cands, 1, order))
    return _pad(out, width)


class ChordLogic:
    """Engine logic interface (see engine/logic.py)."""

    def __init__(self, spec: K.KeySpec = K.DEFAULT_SPEC,
                 params: ChordParams = ChordParams(),
                 lcfg: lk_mod.LookupConfig = lk_mod.LookupConfig(),
                 app=None,
                 mparams: mal_mod.MaliciousParams = mal_mod.MaliciousParams(),
                 ncs_params: ncs_mod.NcsParams = ncs_mod.NcsParams(),
                 nc_params: nc_mod.NcParams = nc_mod.NcParams(),
                 rcfg: rt_mod.RouteConfig | None = None):
        app = app or KbrTestApp()
        if (params.merge_partitions or ncs_params.is_landmark_type
                or mparams.active or lcfg.prox_aware):
            raise NotImplementedError(
                "Chord options beyond the default configuration and "
                "recursive routing (partition merging, GNP/NPS "
                "coordinates, malicious nodes, proximity routing) are not "
                "ported yet (ROADMAP Queue A 7a)")
        lcfg.check_ported()
        if spec.lanes < ncs_params.dims + 1:
            raise ValueError("key lanes too narrow for the NCS piggyback")
        self.key_spec = spec
        self.p = params
        self.lcfg = lcfg
        self.app = app
        # the routing mode reaches the app's RPC-reply transport and its
        # duplicate ring (bound before the app sizes its state)
        if rcfg is not None and getattr(self.app, "rcfg", "no") is None:
            self.app.rcfg = rcfg
        # overlay->distance for the DHT's maintenance responsibility
        # filter: Chord's responsibility is the clockwise distance from
        # the key to the node (Chord::distance, Chord.cc:1403)
        if getattr(self.app, "dist_fn", "no") is None:
            self.app.dist_fn = (
                lambda nk, rk: K.ring_distance(rk, nk, spec))
        self.mp = mparams
        self.ncs = ncs_params
        self.ncp = nc_params
        self.rcfg = rcfg
        self._pow2 = {}

    def pow2(self, device):
        key = str(device)
        if key not in self._pow2:
            self._pow2[key] = K.pow2_table(self.key_spec, device)
        return self._pow2[key]

    # -- engine interface ---------------------------------------------------

    def stat_spec(self) -> stats_mod.StatSpec:
        app = self.app.stat_spec()
        return stats_mod.StatSpec(
            scalars=tuple(app["scalars"]) + ("lookup_hops",),
            hists=tuple(app["hists"]),
            counters=tuple(app["counters"]) + (
                "chord_joins", "lookup_success", "lookup_failed",
                "route_dropped"))

    def split(self, st: ChordState):
        return dataclasses.replace(st, app_glob=None), st.app_glob

    def merge(self, node_part: ChordState, glob):
        return dataclasses.replace(node_part, app_glob=glob)

    def post_step(self, ctx, st: ChordState, events):
        app, glob = self.app.post_step(ctx, st.app, st.app_glob, events)
        return dataclasses.replace(st, app=app, app_glob=glob)

    def init(self, rng, n: int) -> ChordState:
        s, b = self.p.succ_size, self.key_spec.bits
        dev = rng.device

        def full(shape, v, dt):
            return torch.full((n,) + shape, v, dtype=dt, device=dev)

        return ChordState(
            state=full((), 0, I32), pred=full((), NO_NODE, I32),
            succ=full((s,), NO_NODE, I32), finger=full((b,), NO_NODE, I32),
            finger_dirty=full((b,), False, torch.bool),
            t_join=full((), T_INF, I64), t_stab=full((), T_INF, I64),
            t_fix=full((), T_INF, I64), t_cp=full((), T_INF, I64),
            stab_op=full((), 0, I32), stab_dst=full((), NO_NODE, I32),
            stab_to=full((), T_INF, I64), cp_to=full((), T_INF, I64),
            cp_dst=full((), NO_NODE, I32),
            lk=lk_mod.init(self.lcfg, self.key_spec.lanes, n, dev),
            rr=rt_mod.init(self.rcfg or rt_mod.RouteConfig(),
                           self.key_spec.lanes, 16, n, dev),
            cp_sent=full((), 0, I64), t_merge=full((), T_INF, I64),
            t_nps=full((), T_INF, I64), nps_dst=full((), NO_NODE, I32),
            nps_sent=full((), 0, I64),
            ncs=ncs_mod.init(rng, n, self.ncs),
            nc=nc_mod.init(n, self.ncp, dev),
            app=self.app.init(n, dev),
            app_glob=self.app.glob_init(rng))

    def reset(self, st: ChordState, clear, join, t_now, rng) -> ChordState:
        n = st.state.shape[0]
        glob = st.app_glob
        st = dataclasses.replace(st, app_glob=None)
        fresh = dataclasses.replace(self.init(rng, n), app_glob=None)
        st = select_tree(clear, fresh, st)
        st = dataclasses.replace(st, app_glob=glob)
        jitter = (rng_mod.uniform(rng, (n,), F64) * 0.1 * NS).to(I64)
        return dataclasses.replace(
            st, state=torch.where(join, JOINING, st.state),
            t_join=torch.where(join, t_now + jitter, st.t_join))

    def ready_mask(self, st: ChordState):
        return st.state == READY

    def next_event(self, st: ChordState):
        joining = st.state == JOINING
        ready = st.state == READY
        t = torch.where(joining, st.t_join, T_INF)
        for timer in (st.t_stab, st.t_fix, st.t_cp):
            t = torch.minimum(t, torch.where(ready, timer, T_INF))
        t = torch.minimum(t, st.stab_to)
        t = torch.minimum(t, st.cp_to)
        t = torch.minimum(t, torch.where(ready, self.app.next_event(st.app),
                                         T_INF))
        t = torch.minimum(t, lk_mod.next_event(st.lk))
        if self.rcfg is not None:
            t = torch.minimum(t, rt_mod.next_event(st.rr))
        return t

    # -- internals ------------------------------------------------------------

    def _find_node(self, ctx, st, me_key, node_idx, keys):
        """Chord::findNode (Chord.cc:548) for T keys per node: ``keys``
        [N, T, KL] → (next hop [N, T] i32, is_sibling [N, T]); NO_NODE
        when not READY."""
        spec = self.key_spec
        ready = (st.state == READY)[:, None]
        pred_ok = (st.pred != NO_NODE)[:, None]
        pk = keys_of(ctx, st.pred)[:, None]
        succ0 = st.succ[:, 0]
        has_succ = (succ0 != NO_NODE)[:, None]
        s0k = keys_of(ctx, succ0)[:, None]
        me = me_key[:, None]

        alone = ~pred_ok & ~has_succ
        is_sib = ready & (alone | (~pred_ok & K.eq(keys, me))
                          | (pred_ok & K.is_between_r(keys, pk, me, spec)))
        succ_case = ready & has_succ & ~is_sib & K.is_between_r(
            keys, me, s0k, spec)

        # closest preceding node over fingers + successor list: with the
        # ring offsets from the own key, off_c = cand - me and off_k =
        # key - me, "cand in (me, key]" is 0 < off_c < off_k (any off_c
        # != 0 when key == me) or off_c == off_k, and key - cand is
        # off_k - off_c
        cands = torch.cat([st.finger, st.succ], 1)                # [N, C]
        cks = keys_of(ctx, cands)
        off_c = K.sub(cks, me, spec)                               # [N, C, KL]
        off_k = K.sub(keys, me, spec)                              # [N, T, KL]
        c_lt_k, c_eq_k = K.lex_lt_eq(K.fold_lanes(off_c)[:, None],
                                     K.fold_lanes(off_k)[:, :, None])
        c_nz = torch.any(off_c != 0, -1)[:, None]
        k_zero = torch.all(off_k == 0, -1)[..., None]
        usable = ((cands != NO_NODE) & (cands != node_idx[:, None]))[:, None] \
            & ((c_nz & (k_zero | c_lt_k)) | c_eq_k)                # [N, T, C]
        d = _sub_top_key(off_k[:, :, None], off_c[:, None], spec)
        d = torch.where(usable, d, I64_MAX)
        best = take(cands, torch.argmin(d, -1))
        best = torch.where(torch.any(usable, -1), best, succ0[:, None])

        nxt = torch.where(is_sib, node_idx[:, None],
                          torch.where(succ_case, succ0[:, None], best))
        return torch.where(ready, nxt, NO_NODE), is_sib

    def _find_node1(self, ctx, st, me_key, node_idx, key):
        nxt, sib = self._find_node(ctx, st, me_key, node_idx, key[:, None])
        return nxt[:, 0], sib[:, 0]

    def _respond_find(self, ctx, st, me_key, node_idx, msgs, rmax):
        """FindNode RPC payloads for every inbox slot: ([N, R, rmax]
        result slots, [N, R] sibling flag)."""
        nxt, sib = self._find_node(ctx, st, me_key, node_idx, msgs.key)
        n, r_in = nxt.shape
        sib_set = _pad(torch.cat([node_idx[:, None], st.succ], 1), rmax)
        hop = torch.cat([nxt[..., None], torch.full(
            (n, r_in, rmax - 1), NO_NODE, dtype=I32, device=nxt.device)], -1)
        return torch.where(sib[..., None], sib_set[:, None], hop), sib

    def _extra_timers(self, ctx, st, me_key, node_idx, t0, t_end, rng):
        """Subclass timer hook (Koorde's de Bruijn timer), after
        fix-fingers with the step's ``rngs[:, 5]``."""
        return st

    def _on_completion(self, ctx, st, comp, taken, suc_l):
        """Subclass hook over the tick's harvested lookups (``comp``
        fields [N, L, ...]; Koorde's de Bruijn resolution), after the
        app's completions."""
        return st

    def _succ_sorted(self, ctx, me_key, node_idx, c):
        """Ring-distance-sorted unique successor list [N, S] from the
        candidate slots ``c`` [N, C] (excludes self, capacity S)."""
        return ring_sorted(ctx, me_key, node_idx, c, self.p.succ_size,
                           self.key_spec)

    def _succ_add(self, ctx, me_key, node_idx, succ, node, en):
        node = torch.where(en, node, NO_NODE)
        return self._succ_sorted(ctx, me_key, node_idx,
                                 torch.cat([succ, node[:, None]], 1))

    def _handle_failed(self, ctx, st, me_key, node_idx, failed, now):
        """Chord::handleFailedNode (Chord.cc:502) for the tick's failure
        list ``failed`` [N, F] (NO_NODE entries ignored)."""
        n = failed.shape[0]
        failed = torch.where(failed == node_idx[:, None], NO_NODE, failed)
        en = torch.any(failed != NO_NODE, 1)

        def hit(x):
            xf = x.reshape(n, -1)
            h = torch.any(xf[:, :, None] == failed[:, None, :], -1)
            return h.reshape(x.shape) & (x != NO_NODE)

        pred = torch.where(hit(st.pred), NO_NODE, st.pred)
        was_succ0 = hit(st.succ[:, 0])
        succ_masked = torch.where(hit(st.succ), NO_NODE, st.succ)
        succ = self._succ_sorted(ctx, me_key, node_idx, succ_masked)
        succ = torch.where(en[:, None], succ, st.succ)
        fhit = hit(st.finger)
        st = dataclasses.replace(
            st, pred=pred, succ=succ,
            finger=torch.where(fhit, NO_NODE, st.finger),
            finger_dirty=st.finger_dirty | fhit,
            t_stab=torch.where(was_succ0, now, st.t_stab))

        # lost the last successor while READY → rejoin
        rejoin = en & (st.state == READY) & (succ[:, 0] == NO_NODE)
        fresh_lk = lk_mod.init(self.lcfg, self.key_spec.lanes, n,
                               failed.device)
        return dataclasses.replace(
            st,
            state=torch.where(rejoin, JOINING, st.state),
            t_join=torch.where(rejoin, now, st.t_join),
            t_stab=torch.where(rejoin, T_INF, st.t_stab),
            t_fix=torch.where(rejoin, T_INF, st.t_fix),
            t_cp=torch.where(rejoin, T_INF, st.t_cp),
            stab_op=torch.where(rejoin, 0, st.stab_op),
            stab_to=torch.where(rejoin, T_INF, st.stab_to),
            cp_to=torch.where(rejoin, T_INF, st.cp_to),
            cp_dst=torch.where(rejoin, NO_NODE, st.cp_dst),
            lk=select_tree(rejoin, fresh_lk, st.lk),
            app=self.app.on_stop(st.app, rejoin))

    def _become_ready(self, ctx, st, en, now, rng):
        """Enter READY: immediate stabilize and fix-fingers, the
        predecessor check after its delay (handleRpcJoinResponse)."""
        return dataclasses.replace(
            st,
            state=torch.where(en, READY, st.state),
            t_join=torch.where(en, T_INF, st.t_join),
            t_stab=torch.where(en, now, st.t_stab),
            t_fix=torch.where(en, now, st.t_fix),
            t_cp=torch.where(en, now + _ns(self.p.check_pred_delay),
                             st.t_cp),
            app=self.app.on_ready(st.app, en, now, rng))

    def _broadcast(self, ctx, st, me_key, node_idx, msgs, ob, ready):
        """KBR broadcast (Chord::forwardBroadcast, Chord.cc:1410-1446):
        per inbox slot, the fingers and successors inside (me, limit)
        sorted by clockwise distance get up to BCAST_FANOUT copies, far to
        near, each limited by the previous target; past the cap one more
        copy goes to the nearest.  Every slot is computed, the sends are
        masked to BROADCAST messages."""
        spec = self.key_spec
        n, r_in = msgs.valid.shape
        dev = node_idx.device
        en_b = msgs.valid & (msgs.kind == wire.BROADCAST) & ready[:, None]
        bc = torch.cat([st.finger, st.succ], 1)                   # [N, C]
        cdim = bc.shape[1]
        bck = keys_of(ctx, bc)
        me = me_key[:, None]
        d_bc = K.sub(bck, me, spec)             # cw distance me → cand
        off_lim = K.sub(msgs.key, me, spec)                        # [N, R, KL]
        c_lt_l, _ = K.lex_lt_eq(K.fold_lanes(d_bc)[:, None],
                                K.fold_lanes(off_lim)[:, :, None])
        c_nz = torch.any(d_bc != 0, -1)[:, None]
        l_zero = torch.all(off_lim == 0, -1)[..., None]
        base_ok = (bc != NO_NODE) & (bc != node_idx[:, None]) & ~K.dup_mask(bc)
        ok_b = base_ok[:, None] & c_nz & (l_zero | c_lt_l)        # [N, R, C]
        key_b = torch.where(ok_b, _top_key(d_bc)[:, None], I64_MIN)
        bc_s = torch.gather(torch.where(ok_b, bc[:, None], NO_NODE), -1,
                            _sort_order(key_b))
        n_ok = torch.sum(ok_b, -1, dtype=I32)                      # [N, R]
        j = torch.arange(BCAST_FANOUT, device=dev)
        idx_j = torch.clamp(cdim - 1 - j, 0, cdim - 1)
        tgt = torch.where(j < n_ok[..., None], bc_s[..., idx_j], NO_NODE)
        tk = keys_of(ctx, tgt)        # [N, R, F, KL]
        lim = torch.cat([msgs.key[:, :, None], tk[:, :, :-1]], 2)
        fire = en_b[..., None] & (tgt != NO_NODE)
        near = torch.gather(bc_s, -1, torch.clamp(
            cdim - n_ok, 0, cdim - 1)[..., None].long())[..., 0]
        fire_n = en_b & (n_ok > BCAST_FANOUT) & (near != NO_NODE)
        lim_n = tk[:, :, BCAST_FANOUT - 1]
        fan = r_in * BCAST_FANOUT

        def per_copy(x):
            return x[..., None].expand(n, r_in, BCAST_FANOUT).reshape(n, fan)

        ob.send(fire.reshape(n, fan), per_copy(msgs.t_deliver),
                tgt.reshape(n, fan), wire.BROADCAST,
                key=lim.reshape(n, fan, -1), a=per_copy(msgs.a),
                b=per_copy(msgs.b), hops=per_copy(msgs.hops + 1),
                size_b=wire.BASE_CALL_B + 20)
        ob.send(fire_n, msgs.t_deliver, torch.clamp(near, min=0),
                wire.BROADCAST, key=lim_n, a=msgs.a, b=msgs.b,
                hops=msgs.hops + 1, size_b=wire.BASE_CALL_B + 20)

    # -- the batched step -----------------------------------------------------

    def step(self, ctx, st, msgs, rng, node_idx, *, outbox_slots, rmax):
        p, lcfg, spec = self.p, self.lcfg, self.key_spec
        n = node_idx.shape[0]
        dev = node_idx.device
        ob = Outbox(n, outbox_slots, spec.lanes, rmax, dev)
        me_key = ctx.keys[node_idx.long()]
        rpc_to_ns = _ns(p.rpc_timeout)
        rngs = rng_mod.split(rng, 7)                              # [N, 7, 2]
        t0, t_end = ctx.t_start, ctx.t_end
        f = lcfg.frontier
        s_sz = p.succ_size

        def metric_fn(cand, target):
            ck = keys_of(ctx, cand)
            return K.sub(target[:, :, None, :], ck, spec)

        def with_first(vec, first):
            return torch.cat([first[:, None], vec[:, 1:]], 1)

        def last_index(mask):
            r = mask.shape[1]
            return torch.clamp(r - 1 - torch.argmax(
                torch.flip(mask, [1]).to(I32), 1), 0, r - 1)

        def first_index(mask):
            return torch.clamp(torch.argmax(mask.to(I32), 1), 0,
                               mask.shape[1] - 1)

        ev = app_base.AppEvents(n, dev)
        zeros_n = torch.zeros((n,), dtype=I32, device=dev)
        joins_cnt, anyfail_cnt, lksucc_cnt = zeros_n, zeros_n, zeros_n
        routedrop_cnt = zeros_n
        v_r, now_r = msgs.valid, msgs.t_deliver
        r_in = v_r.shape[1]
        old_succ, old_pred = st.succ, st.pred     # update() delta base

        # ------------------------------------------- inbox (batched) -----
        res_b, sib_b = self._respond_find(ctx, st, me_key, node_idx, msgs,
                                          rmax)
        if self.rcfg is not None:
            # recursive route pre-pass: ACKs, source-routed replies, then
            # ACK + forward or decapsulate each KBR_ROUTE with the slot's
            # findNode result (decapsulation keeps msgs.key, so sib_b
            # stays right for the inner kinds below)
            rr, msgs, dropped = rt_mod.prepass(
                st.rr, ob, msgs, res_b, sib_b, st.state == READY, node_idx,
                self.rcfg,
                forward_veto=app_base.app_veto(self.app, st.app, ctx))
            st = dataclasses.replace(st, rr=rr)
            routedrop_cnt = routedrop_cnt + dropped
            v_r = msgs.valid
        en_call = v_r & (msgs.kind == wire.FINDNODE_CALL)
        n_res = torch.sum(res_b != NO_NODE, -1, dtype=I32)
        ob.send(en_call, now_r, msgs.src, wire.FINDNODE_RES, key=msgs.key,
                a=msgs.a, b=msgs.b, c=sib_b.to(I32), nodes=res_b,
                size_b=wire.BASE_CALL_B + 1 + wire.NODEHANDLE_B * n_res)

        en_res = v_r & (msgs.kind == wire.FINDNODE_RES)
        st = dataclasses.replace(st, lk=lk_mod.on_responses(
            st.lk, dataclasses.replace(msgs, valid=en_res), metric_fn, lcfg))

        # JoinCall (rpcJoin, Chord.cc:917): answered only when this node
        # is responsible for the joiner's key
        en = v_r & (msgs.kind == wire.CHORD_JOIN_CALL) & (
            st.state == READY)[:, None]
        no_pred = st.pred == NO_NODE
        alone = no_pred & (st.succ[:, 0] == NO_NODE)
        jk = keys_of(ctx, msgs.src)
        pk_j = keys_of(ctx, st.pred)[:, None]
        responsible = (alone | no_pred)[:, None] | K.is_between(
            jk, pk_j, me_key[:, None], spec)
        en = en & responsible
        pred_hint = torch.where(alone, node_idx, st.pred)
        ob.send(en, now_r, msgs.src, wire.CHORD_JOIN_RES, a=pred_hint,
                nodes=_pad(st.succ, rmax),
                size_b=wire.BASE_CALL_B + wire.NODEHANDLE_B * (s_sz + 1))
        any_en = torch.any(en, 1)
        if p.aggressive_join:
            # joiner k's hint goes to the previous enabled joiner (k = 0:
            # the pre-tick predecessor); the last joiner becomes pred
            idxs = torch.arange(r_in, dtype=I32, device=dev)
            cm = torch.cummax(torch.where(en, idxs, -1), 1).values
            prev = torch.cat([torch.full((n, 1), -1, dtype=cm.dtype,
                                         device=dev), cm[:, :-1]], 1)
            hint_dst = torch.where(prev >= 0,
                                   take(msgs.src, torch.clamp(prev, min=0)),
                                   st.pred[:, None])
            ob.send(en & (hint_dst != NO_NODE), now_r, hint_dst,
                    wire.CHORD_SUCC_HINT, a=msgs.src,
                    size_b=wire.BASE_CALL_B + wire.NODEHANDLE_B)
            pred2 = torch.where(any_en, take(msgs.src, last_index(en)),
                                st.pred)
        else:
            pred2 = st.pred
        succ2 = torch.where(
            (any_en & (st.succ[:, 0] == NO_NODE))[:, None],
            with_first(st.succ, take(msgs.src, first_index(en))), st.succ)
        st = dataclasses.replace(st, pred=pred2, succ=succ2)

        # JoinResponse (handleRpcJoinResponse): every enabled response's
        # successor candidates merged in one sorted pass
        en = v_r & (msgs.kind == wire.CHORD_JOIN_RES) & (
            st.state == JOINING)[:, None]
        cand_jr = torch.where(
            en[..., None],
            torch.cat([msgs.nodes[:, :, :s_sz], msgs.src[..., None]], 2),
            NO_NODE).reshape(n, -1)
        succ3 = self._succ_sorted(ctx, me_key, node_idx, cand_jr)
        got_succ = torch.any(en, 1) & (succ3[:, 0] != NO_NODE)
        joins_cnt = joins_cnt + got_succ.to(I32)
        hint_ok = en & (msgs.a != NO_NODE)
        st = dataclasses.replace(st, succ=torch.where(got_succ[:, None],
                                                      succ3, st.succ))
        if p.aggressive_join:
            st = dataclasses.replace(st, pred=torch.where(
                got_succ & torch.any(hint_ok, 1),
                take(msgs.a, last_index(hint_ok)), st.pred))
        st = self._become_ready(
            ctx, st, got_succ,
            torch.max(torch.where(en, now_r, 0), 1).values, rngs[:, 0])

        # StabilizeCall → reply with the predecessor (rpcStabilize)
        en = v_r & (msgs.kind == wire.CHORD_STABILIZE_CALL) & (
            st.state == READY)[:, None]
        ob.send(en, now_r, msgs.src, wire.CHORD_STABILIZE_RES, a=st.pred,
                size_b=wire.BASE_CALL_B + wire.NODEHANDLE_B)

        # StabilizeResponse: at most one slot matches the stabilize RPC
        en_sr = v_r & (msgs.kind == wire.CHORD_STABILIZE_RES) & (
            (st.state == READY) & (st.stab_op == 1))[:, None] & (
            msgs.src == st.stab_dst[:, None])
        any_sr = torch.any(en_sr, 1)
        r_sr = first_index(en_sr)
        src_sr = take(msgs.src, r_sr)
        now_sr = take(msgs.t_deliver, r_sr)
        cand = take(msgs.a, r_sr)
        s0 = st.succ[:, 0]
        succ_empty = s0 == NO_NODE
        adopt = (cand != NO_NODE) & (succ_empty | K.is_between(
            keys_of(ctx, cand), me_key, keys_of(ctx, s0), spec))
        new_node = torch.where(adopt, cand,
                               torch.where(succ_empty, src_sr, NO_NODE))
        succ4 = self._succ_add(ctx, me_key, node_idx, st.succ, new_node,
                               any_sr)
        succ4 = torch.where(any_sr[:, None], succ4, st.succ)
        ob.send(any_sr & (succ4[:, 0] != NO_NODE), now_sr, succ4[:, 0],
                wire.CHORD_NOTIFY_CALL,
                size_b=wire.BASE_CALL_B + wire.NODEHANDLE_B)
        st = dataclasses.replace(
            st, succ=succ4,
            stab_op=torch.where(any_sr, 2, st.stab_op),
            stab_dst=torch.where(any_sr, succ4[:, 0], st.stab_dst),
            stab_to=torch.where(any_sr, now_sr + rpc_to_ns, st.stab_to))

        # NotifyCall (rpcNotify): adopt the clockwise-closest closer
        # notifier as predecessor, reply with the successor list
        en = v_r & (msgs.kind == wire.CHORD_NOTIFY_CALL) & (
            st.state == READY)[:, None]
        sk = keys_of(ctx, msgs.src)
        closer = en & ((st.pred == NO_NODE)[:, None] | K.is_between(
            sk, keys_of(ctx, st.pred)[:, None], me_key[:, None], spec))
        d_nc = K.sub(me_key[:, None], sk, spec)
        d_nc = torch.where(closer[..., None], d_nc, UMAX)
        newpred_src = take(msgs.src, _lex_argmin(d_nc))
        any_nc = torch.any(closer, 1)
        succ5 = torch.where((any_nc & (st.succ[:, 0] == NO_NODE))[:, None],
                            with_first(st.succ, newpred_src), st.succ)
        st = dataclasses.replace(
            st, pred=torch.where(any_nc, newpred_src, st.pred), succ=succ5)
        ob.send(en, now_r, msgs.src, wire.CHORD_NOTIFY_RES,
                nodes=_pad(st.succ, rmax),
                size_b=wire.BASE_CALL_B + wire.NODEHANDLE_B * (s_sz + 1))

        # NotifyResponse: the successor's list replaces ours
        fin_m = v_r & (msgs.kind == wire.CHORD_NOTIFY_RES) & (
            st.stab_op == 2)[:, None] & (msgs.src == st.stab_dst[:, None])
        any_fin = torch.any(fin_m, 1)
        r_nr = first_index(fin_m)
        src_nr = take(msgs.src, r_nr)
        take_nr = any_fin & (st.state == READY) & (src_nr == st.succ[:, 0])
        succ6 = self._succ_sorted(
            ctx, me_key, node_idx,
            torch.cat([take(msgs.nodes, r_nr)[:, :s_sz], src_nr[:, None]], 1))
        st = dataclasses.replace(
            st, succ=torch.where(take_nr[:, None], succ6, st.succ),
            stab_op=torch.where(any_fin, 0, st.stab_op),
            stab_to=torch.where(any_fin, T_INF, st.stab_to))

        # NewSuccessorHint: hinted nodes inside (me, succ0), one merge
        en = v_r & (msgs.kind == wire.CHORD_SUCC_HINT) & (
            st.state == READY)[:, None]
        take_h = en & (msgs.a != NO_NODE) & (
            (st.succ[:, 0] == NO_NODE)[:, None]
            | K.is_between(keys_of(ctx, msgs.a), me_key[:, None],
                           keys_of(ctx, st.succ[:, 0])[:, None], spec))
        succ7 = self._succ_sorted(
            ctx, me_key, node_idx,
            torch.cat([st.succ, torch.where(take_h, msgs.a, NO_NODE)], 1))
        st = dataclasses.replace(st, succ=torch.where(
            torch.any(take_h, 1)[:, None], succ7, st.succ))

        self._broadcast(ctx, st, me_key, node_idx, msgs, ob,
                        st.state == READY)

        st = dataclasses.replace(st, app=app_base.on_msgs_fold(
            self.app, st.app, msgs, ctx, ob, ev, sib_b, node_idx))

        # ping: the response piggybacks this node's coordinates
        ping_key = ncs_mod.pack_wire(st.ncs.coords, st.ncs.error, spec.lanes)
        ob.send(v_r & (msgs.kind == wire.PING_CALL), now_r, msgs.src,
                wire.PING_RES, a=msgs.a, key=ping_key,
                size_b=wire.BASE_CALL_B + 4 * (self.ncs.dims + 1))
        en_p = v_r & (msgs.kind == wire.PING_RES) & (
            msgs.src == st.cp_dst[:, None]) & (msgs.a != -3)
        any_p = torch.any(en_p, 1)
        r_p = first_index(en_p)
        now_p = take(msgs.t_deliver, r_p)
        rtt_s = _secs(now_p - st.cp_sent)
        st = dataclasses.replace(st, nc=nc_mod.insert_rtt(
            st.nc, take(msgs.src, r_p), rtt_s, now_p, any_p))
        if self.ncs.ncs_type in ("vivaldi", "svivaldi"):
            xj, ej = ncs_mod.unpack_wire(take(msgs.key, r_p), self.ncs.dims)
            me_ncs = dict(coords=st.ncs.coords, height=st.ncs.height,
                          error=st.ncs.error, loss=st.ncs.loss)
            upd = ncs_mod.update(
                me_ncs, torch.where(any_p, rtt_s, -1.0), xj, ej,
                torch.zeros((), dtype=F32, device=dev), self.ncs)
            st = dataclasses.replace(
                st, ncs=dataclasses.replace(st.ncs, **upd))
        st = dataclasses.replace(
            st, cp_to=torch.where(any_p, T_INF, st.cp_to),
            cp_dst=torch.where(any_p, NO_NODE, st.cp_dst))

        # ------------------------------------------------------- timers ----
        # join (joinOverlay / handleJoinTimerExpired Chord.cc:758)
        en_j = (st.state == JOINING) & (st.t_join < t_end)
        now_j = torch.maximum(st.t_join, t0)
        boot = ctx.sample_ready(rngs[:, 1], node_idx)
        no_join_lk = ~torch.any(st.lk.active & (st.lk.purpose == P_JOIN), 1)
        alone_start = en_j & (boot == NO_NODE)
        st = self._become_ready(ctx, st, alone_start, now_j, rngs[:, 2])
        joins_cnt = joins_cnt + alone_start.to(I32)
        slot, have = lk_mod.free_slot(st.lk)
        start_join = en_j & (boot != NO_NODE) & no_join_lk & have
        st = dataclasses.replace(st, lk=lk_mod.start(
            st.lk, start_join, slot, P_JOIN, 0, me_key, _pad(boot[:, None], f),
            now_j, lcfg))
        st = dataclasses.replace(st, t_join=torch.where(
            en_j & ~alone_start, now_j + _ns(p.join_delay), st.t_join))

        # stabilize (handleStabilizeTimerExpired)
        ready = st.state == READY
        en_s = ready & (st.t_stab < t_end)
        now_s = torch.maximum(st.t_stab, t0)
        s0 = st.succ[:, 0]
        has_succ = s0 != NO_NODE
        fire_s = en_s & has_succ
        ob.send(fire_s, now_s, s0, wire.CHORD_STABILIZE_CALL,
                size_b=wire.BASE_CALL_B)
        st = dataclasses.replace(
            st,
            stab_op=torch.where(fire_s, 1, st.stab_op),
            stab_dst=torch.where(fire_s, s0, st.stab_dst),
            stab_to=torch.where(fire_s, now_s + rpc_to_ns, st.stab_to),
            t_stab=torch.where(en_s, now_s + _ns(p.stabilize_delay),
                               st.t_stab))

        # fixfingers: mark non-trivial fingers dirty, drop trivial ones
        fix_due = ready & (st.t_fix < t_end)
        en_f = fix_due & has_succ
        pow2 = self.pow2(dev)
        sdist = K.sub(keys_of(ctx, s0), me_key, spec)         # me → succ
        nontrivial = K.gt(pow2[None].expand(n, -1, -1),
                          sdist[:, None].expand(n, pow2.shape[0], -1))
        st = dataclasses.replace(
            st,
            finger_dirty=torch.where(en_f[:, None], nontrivial,
                                     st.finger_dirty),
            finger=torch.where(en_f[:, None] & ~nontrivial, NO_NODE,
                               st.finger),
            t_fix=torch.where(fix_due, torch.maximum(st.t_fix, t0)
                              + _ns(p.fixfingers_delay), st.t_fix))
        st = self._extra_timers(ctx, st, me_key, node_idx, t0, t_end,
                                rngs[:, 5])

        # predecessor check (handleCheckPredecessorTimerExpired)
        en_c = ready & (st.t_cp < t_end)
        now_c = torch.maximum(st.t_cp, t0)
        fire_c = en_c & (st.pred != NO_NODE) & (st.cp_to == T_INF)
        ob.send(fire_c, now_c, st.pred, wire.PING_CALL,
                size_b=wire.BASE_CALL_B)
        st = dataclasses.replace(
            st,
            cp_to=torch.where(fire_c, now_c + rpc_to_ns, st.cp_to),
            cp_dst=torch.where(fire_c, st.pred, st.cp_dst),
            cp_sent=torch.where(fire_c, now_c, st.cp_sent),
            t_cp=torch.where(en_c, now_c + _ns(p.check_pred_delay),
                             st.t_cp))

        # app timer → an app lookup (KBRTestApp::handleTimerEvent)
        st = dataclasses.replace(st, app=app_base.leave_protocol(
            self.app, st.app, ctx, ob, ev, t0, node_idx, st.succ[:, 0],
            st.state == READY))
        t_app = self.app.next_event(st.app)
        en_a = (st.state == READY) & (t_app < t_end)
        now_a = torch.maximum(t_app, t0)
        app, req = self.app.on_timer(st.app, en_a, ctx, now_a, rngs[:, 3],
                                     ev, node_idx)
        st = dataclasses.replace(st, app=app)
        nxt_a, sib_a = self._find_node1(ctx, st, me_key, node_idx, req.key)
        # locally responsible → immediate completion with the full
        # sibling set (self + successor list), hop count 0
        local = req.want & sib_a
        res_local = _pad(torch.cat([node_idx[:, None], st.succ], 1), f)
        slot, have = lk_mod.free_slot(st.lk)
        route_fire = torch.zeros_like(req.want)
        if self.rcfg is not None and hasattr(self.app, "route_policy"):
            # recursive data path at the originator: routable payloads
            # hop by hop, the rest on the iterative engine
            rr, app, route_fire, start_app = rt_mod.originate(
                st.rr, ob, self.app, st.app, req, nxt_a, sib_a, have, now_a,
                node_idx, rmax, self.rcfg, ctx.measuring)
            st = dataclasses.replace(st, rr=rr, app=app)
        else:
            start_app = req.want & ~sib_a & have & (nxt_a != NO_NODE)
        insta_fail = req.want & ~sib_a & ~start_app & ~route_fire
        st = dataclasses.replace(st, app=self.app.on_lookup_done(
            st.app, app_base.LookupDone(
                en=local | insta_fail, success=local, tag=req.tag,
                target=req.key,
                results=torch.where(local[:, None], res_local, NO_NODE),
                hops=zeros_n, t0=now_a),
            ctx, ob, ev, now_a, node_idx))
        st = dataclasses.replace(st, lk=lk_mod.start(
            st.lk, start_app, slot, P_APP, req.tag, req.key,
            _pad(nxt_a[:, None], f), now_a, lcfg))

        # ------------------------------------------------ timeouts ---------
        new_lk, failed_nodes, _ = lk_mod.on_timeouts(st.lk, t_end, t0, lcfg)
        st = dataclasses.replace(st, lk=new_lk)
        en = (st.stab_op != 0) & (st.stab_to < t_end)
        stab_failed = torch.where(en, st.stab_dst, NO_NODE)
        st = dataclasses.replace(
            st, stab_op=torch.where(en, 0, st.stab_op),
            stab_to=torch.where(en, T_INF, st.stab_to))
        en = st.cp_to < t_end
        cp_failed = torch.where(en, st.cp_dst, NO_NODE)
        st = dataclasses.replace(
            st, cp_to=torch.where(en, T_INF, st.cp_to),
            cp_dst=torch.where(en, NO_NODE, st.cp_dst))
        failed = [failed_nodes, stab_failed[:, None], cp_failed[:, None]]
        if self.rcfg is not None:
            # route-hop ACK timeouts: unresponsive next hops failed too
            rr, rt_failed, rt_retry = rt_mod.on_timeouts(st.rr, t_end,
                                                         self.rcfg)
            st = dataclasses.replace(st, rr=rr)
            failed.append(rt_failed)
        st = self._handle_failed(ctx, st, me_key, node_idx,
                                 torch.cat(failed, 1), t0)
        if self.rcfg is not None:
            # reroute the parked messages around their failed hops: the
            # hop is out of the tables now, so findNode picks another
            nxt_q, sib_q = self._find_node(ctx, st, me_key, node_idx,
                                           st.rr.key)
            rr, gave_up = rt_mod.reroute(st.rr, ob, nxt_q, sib_q, rt_failed,
                                         rt_retry, t0, node_idx, self.rcfg)
            st = dataclasses.replace(st, rr=rr)
            routedrop_cnt = routedrop_cnt + gave_up

        # ------------------------------------------------- completions -----
        new_lk, comp = lk_mod.take_completions(st.lk, t_end)
        st = dataclasses.replace(st, lk=new_lk)
        taken = comp["taken"]                                      # [N, L]
        suc_l = comp["success"] & (comp["result"] != NO_NODE)
        pur_l, res_l = comp["purpose"], comp["result"]
        comp_hops_ev = (comp["hops"].to(F32), taken & comp["success"])
        lksucc_cnt = lksucc_cnt + torch.sum(taken & suc_l, 1, dtype=I32)
        anyfail_cnt = anyfail_cnt + torch.sum(taken & ~suc_l, 1, dtype=I32)

        # join: contact the successor directly
        ob.send(taken & suc_l & (pur_l == P_JOIN), t0, res_l,
                wire.CHORD_JOIN_CALL,
                size_b=wire.BASE_CALL_B + wire.NODEHANDLE_B)

        # finger repair results
        enf = taken & (pur_l == P_FINGER)
        fi_l = torch.clamp(comp["aux"], 0, spec.bits - 1)
        st = dataclasses.replace(
            st, finger=put(st.finger, fi_l, res_l, enf & suc_l),
            finger_dirty=put(st.finger_dirty, fi_l, False, enf))

        ena_l = taken & (pur_l == P_APP)
        st = dataclasses.replace(st, app=app_base.lookup_done_fold(
            self.app, st.app, app_base.LookupDone(
                en=ena_l, success=ena_l & suc_l, tag=comp["aux"],
                target=comp["target"], results=comp["results"],
                hops=comp["hops"], t0=comp["t0"]),
            ctx, ob, ev, t0, node_idx))
        st = self._on_completion(ctx, st, comp, taken, suc_l)

        # -------------------------------------------- finger repair pump ---
        dirty_any = (st.state == READY) & torch.any(st.finger_dirty, 1)
        no_finger_lk = ~torch.any(st.lk.active & (st.lk.purpose == P_FINGER),
                                  1)
        fi = torch.argmax(st.finger_dirty.to(I32), 1)
        target = K.add(me_key, pow2[fi], spec)
        nxt_f, sib_f = self._find_node1(ctx, st, me_key, node_idx, target)
        self_fix = dirty_any & no_finger_lk & sib_f
        at_fi = torch.arange(spec.bits, device=dev)[None, :] == fi[:, None]
        st = dataclasses.replace(st, finger_dirty=st.finger_dirty & ~(
            self_fix[:, None] & at_fi))
        slot, have = lk_mod.free_slot(st.lk)
        start_fix = dirty_any & no_finger_lk & ~sib_f & have & (
            nxt_f != NO_NODE)
        st = dataclasses.replace(st, lk=lk_mod.start(
            st.lk, start_fix, slot, P_FINGER, fi, target,
            _pad(nxt_f[:, None], f), t0, lcfg))

        # ------------------------------------------------------- pump ------
        # adaptive per-destination RPC timeouts from the RTT cache
        # (NeighborCache::getNodeTimeout, NeighborCache.cc:802)
        st = dataclasses.replace(st, lk=lk_mod.pump(
            st.lk, ob, ctx, node_idx, t0, lcfg,
            timeout_fn=nc_mod.adaptive_timeout_fn(st.nc, lcfg.rpc_timeout_ns)))

        # Common API update() (BaseOverlay::callUpdate → BaseApp::update,
        # BaseApp.h:223): the nodes that entered the successor list, with
        # a new predecessor listed first and marked urgent — the joiner
        # inherits keyspace and must receive its records (DHT.cc:779-797)
        if hasattr(self.app, "on_update"):
            new_in = torch.where(
                (st.succ != NO_NODE) & ~torch.any(
                    st.succ[:, :, None] == old_succ[:, None, :], -1),
                st.succ, NO_NODE)
            new_pred = torch.where(
                (st.pred != NO_NODE) & (st.pred != old_pred)
                & (st.pred != node_idx), st.pred, NO_NODE)
            st = dataclasses.replace(st, app=self.app.on_update(
                st.app, st.state == READY, ctx, ob, ev, t0, node_idx,
                torch.cat([new_pred[:, None], new_in], 1),
                sib_keys=keys_of(ctx, st.succ),
                sib_valid=st.succ != NO_NODE,
                urgent=new_pred != NO_NODE))

        events = {
            "c:chord_joins": joins_cnt,
            "c:lookup_success": lksucc_cnt,
            "c:lookup_failed": anyfail_cnt,
            "c:route_dropped": routedrop_cnt,
            "s:lookup_hops": comp_hops_ev,
        }
        ev.finish(events, self.app.hist_map)
        return st, ob, events
