"""DHT storage tier + DHTTestApp workload + GlobalDhtTestMap oracle (PyTorch).

Counterpart of ``oversim_tpu/apps/dht.py`` (reference DHT.{h,cc},
DHTDataStorage, DHTTestApp.{h,cc}, GlobalDhtTestMap.{h,cc}):

  * tier 1 — DHT: a PUT is a sibling lookup, then a ``DHTPutCall`` to up
    to numReplica replicas, complete on a majority of acks; a GET is a
    lookup, then numGetRequests ``DHTGetCall``s whose answers are voted
    with ratioIdentical; per-node storage of ``storage_slots`` records
    with TTL eviction; values travel as 32-bit ids;
  * tier 2 — DHTTestApp: one timer round-robins PUT (a fresh random key),
    GET (a known key) and MOD (a re-put of a known key) every
    testInterval / 3, each GET validated against the global truth;
  * GlobalDhtTestMap: the truth map, a ring of ``num_test_keys`` slots
    that commits staged by the nodes are folded into after the node
    sweep (``post_step``);
  * maintenance: graceful-leave handover (``on_leave``) and the Common
    API update() hook (``on_update``), which stages re-replication of
    the stored records to a node that entered the replica set, pumped
    two records per tick (``on_tick``).

The JAX package writes each hook for one node and vmaps it; here every
hook runs over the whole node axis, operation for operation, so the two
packages stay leaf-exact.  Where a JAX hook reduces over the shared
truth map, the port computes the shared part once (``_known_key_draw``).
Trace-driven mode (``trace=``, a ``trace.TraceWorkload``) replaces the
random test workload with the trace's per-node command queues ``tr_*``
(copied to the device once; ``next_event`` exposes each node's next
command) and the truth ring with the trace's key pool:
DHTTestApp::handleTraceMessage's PUT and GET at their absolute times, a
command due while an operation is in flight retried a second later.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from oversim_tpu_torch import rng as rng_mod
from oversim_tpu_torch.apps import base
from oversim_tpu_torch.common import wire
from oversim_tpu_torch.core import keys as keys_mod
from oversim_tpu_torch.engine.logic import put, take

I32 = torch.int32
I64 = torch.int64
F32 = torch.float32
F64 = torch.float64
NS = 1_000_000_000
T_INF = 2 ** 62
NO_NODE = -1
NO_VAL = -1
I64_MAX = 2 ** 63 - 1

OP_NONE, OP_PUT, OP_GET = 0, 1, 2

# append-to-pool marker for op_g / commit_g (fresh-key put; mods address
# an existing slot >= 0)
G_APPEND = -2

PUT_B = wire.BASE_CALL_B + 20 + 8
GET_B = wire.BASE_CALL_B + 20


def _dist64(d):
    """The top 64 bits of a key-shaped distance ``[..., KL]`` (its two
    most-significant lanes) as one int64 whose signed order is their
    unsigned order.

    Parity: the JAX package packs ``hi << 32 | lo`` into a uint64 and
    sorts those; the port's lanes are zero-extended int64, where
    ``hi << 32`` turns negative for ``hi >= 2^31``, and PyTorch's uint64
    sort support is thin.  So the sign bit is flipped (``(hi - 2^31) <<
    32 | lo``, the same word as ``keys.fold_lanes``) and the uint64
    sentinel ``2^64 - 1`` becomes ``I64_MAX``."""
    hi = d[..., 0]
    lo = d[..., 1] if d.shape[-1] > 1 else torch.zeros_like(hi)
    return ((hi - (1 << 31)) << 32) | lo


def _first_index(mask):
    """``jnp.argmax`` of a bool mask along the last axis: the first set
    index, 0 when none (torch has no bool argmax; both return the first
    index of the maximum)."""
    return torch.argmax(mask.to(I32), -1).to(I32)


def _set_col(x, col, val, en):
    """``x[n, col[n]] = val[n]`` where ``en[n]`` (one column per node;
    ``x`` [N, D, *rest]): a compare and a select, where
    ``engine.logic.put``'s general K-lane scatter takes several more
    launches, and storage takes 64 such writes a tick."""
    hit = (torch.arange(x.shape[1], device=x.device)[None, :]
           == col[:, None].long()) & en[:, None]
    hit = hit.reshape(hit.shape + (1,) * (x.dim() - 2))
    if isinstance(val, torch.Tensor) and val.dim():
        val = val[:, None]
    return torch.where(hit, val, x)


def _scatter_rows(base_t, rows, vals):
    """``base.at[rows].set(vals, mode="drop")`` on a ``[G, ...]`` table,
    rows ``>= G`` dropped.

    Parity: two rows to one slot resolve as XLA-CPU's scatter does, the
    later update winning; the inverse map slot -> update is one ``amax``
    scatter of the update index (deterministic on the card, where a
    plain ``index_put_`` with repeated rows is not)."""
    g = base_t.shape[0]
    k = rows.shape[0]
    lanes = torch.arange(k, device=rows.device)
    inv = torch.full((g + 1,), -1, dtype=I64, device=rows.device)
    inv = inv.scatter_reduce(0, torch.clamp(rows.long(), 0, g), lanes,
                             reduce="amax")[:g]
    hit = (inv >= 0).reshape((g,) + (1,) * (base_t.dim() - 1))
    return torch.where(hit, vals[torch.clamp(inv, min=0)], base_t)


@dataclasses.dataclass(frozen=True)
class DhtParams:
    """default.ini:67-77 + the dhtTestApp namespace (JAX field names and
    defaults)."""

    num_replica: int = 4
    num_get_requests: int = 4
    ratio_identical: float = 0.5
    test_interval: float = 60.0
    test_ttl: float = 300.0
    storage_slots: int = 32
    num_test_keys: int = 1024
    op_timeout: float = 10.0
    mod_test: bool = True
    variant: str = "plain"
    num_replica_teams: int = 1


@dataclasses.dataclass
class DhtState:
    """Per-node storage and test-workload state ([N, ...]; JAX field
    names)."""

    s_key: torch.Tensor      # [N, D, KL] u32 lanes in int64
    s_val: torch.Tensor      # [N, D] i32 (NO_VAL = empty)
    s_expire: torch.Tensor   # [N, D] i64
    t_test: torch.Tensor     # [N] i64
    seq: torch.Tensor        # [N] i32
    tr_t: torch.Tensor       # [N, Q] i64 trace command times ([N, 0]
    tr_kind: torch.Tensor    # [N, Q] i32     when not tracing)
    tr_key: torch.Tensor     # [N, Q, KL]
    tr_val: torch.Tensor     # [N, Q] i32
    tr_g: torch.Tensor       # [N, Q] i32 truth-pool slot
    tr_cur: torch.Tensor     # [N] i32
    op: torch.Tensor         # [N] i32 OP_*
    op_seq: torch.Tensor     # [N] i32 op nonce
    op_g: torch.Tensor       # [N] i32 truth slot (G_APPEND = fresh key)
    op_key: torch.Tensor     # [N, KL] the op's base key
    op_team: torch.Tensor    # [N] i32 replica-team cursor
    op_cont: torch.Tensor    # [N] bool next team's lookup pending
    op_val: torch.Tensor     # [N] i32
    op_pending: torch.Tensor  # [N] i32 replica responses awaited
    op_acks: torch.Tensor    # [N] i32
    op_votes: torch.Tensor   # [N, Q] i32 GET quorum answers
    op_to: torch.Tensor      # [N] i64 op timeout
    op_t0: torch.Tensor      # [N] i64 op start
    commit_g: torch.Tensor   # [N] i32 staged truth commit (-1 = none)
    commit_key: torch.Tensor  # [N, KL]
    commit_val: torch.Tensor  # [N] i32
    commit_expire: torch.Tensor  # [N] i64
    mnt_dst: torch.Tensor    # [N] i32 replication target (NO_NODE idle)
    mnt_pos: torch.Tensor    # [N] i32 next storage slot to push
    mnt_resp: torch.Tensor   # [N, D] bool per-record responsibility


@dataclasses.dataclass
class DhtGlobal:
    """GlobalDhtTestMap: the known-key ring and its current truth."""

    keys: torch.Tensor       # [G, KL]
    val: torch.Tensor        # [G] i32 (-1 = never put)
    expire: torch.Tensor     # [G] i64
    cursor: torch.Tensor     # i32 scalar: next append slot


def _known_key_draw(glob: DhtGlobal, now, r_g):
    """DHTTestApp's known-key draw (``getRandomKey``): per node, a
    uniform draw over the truth entries live at that node's ``now``.
    Returns (slot [N] i32, live count [N] i32).

    The JAX hook forms ``vcum = cumsum(val != -1 & expire > now)`` over
    the ``[G]`` ring for each node and searchsorts its draw into it.
    The live set is not quite the same for every node: ``now`` is each
    node's own timer time inside the window, so an entry that expires
    inside the window is live for some nodes only, and one cumsum would
    not be exact.  With the ring sorted by expiry (latest first), the
    entries live at ``now`` are a prefix of that order whose length is
    one ``searchsorted``; the draw's slot is then the k-th smallest
    ring index in that prefix, read from a wavelet matrix of the sorted
    order (ceil(log2 G) levels of ``[G + 1]`` zero counts, built once
    per tick).  Nothing of size ``[N, G]`` is formed."""
    g_n = glob.val.shape[0]
    dev = glob.val.device
    ekey = torch.where(glob.val != NO_VAL, glob.expire, -I64_MAX - 1)
    asc = torch.sort(ekey).values
    n_live = (g_n - torch.searchsorted(asc, now.contiguous(),
                                       side="right")).to(I32)
    # a per-node tensor maxval: the port's randint takes one (as
    # jax.random.randint does), its span under 2^31
    k = rng_mod.randint(r_g, (), 0, torch.clamp(n_live, min=1), dtype=I32)
    seq = torch.sort(ekey, descending=True, stable=True).indices
    levels = max(1, (g_n - 1).bit_length())
    pos = torch.arange(g_n, device=dev)
    zc_rows, nz_rows = [], []
    cur = seq
    for lev in range(levels):
        zero = ((cur >> (levels - 1 - lev)) & 1) == 0
        zc = torch.cat([torch.zeros((1,), dtype=I64, device=dev),
                        torch.cumsum(zero.to(I64), 0)])
        nz = zc[-1]
        dest = torch.where(zero, zc[:-1], nz + pos - zc[:-1])
        cur = torch.empty_like(cur).index_copy_(0, dest, cur)
        zc_rows.append(zc)
        nz_rows.append(nz)
    lo = torch.zeros_like(now)
    hi = n_live.to(I64)
    kk = k.to(I64)
    slot = torch.zeros_like(now)
    for lev in range(levels):
        zc = zc_rows[lev]
        zl, zr = zc[lo], zc[hi]
        z = zr - zl
        left = kk < z
        slot = slot * 2 + (~left).to(I64)
        kk = torch.where(left, kk, kk - z)
        lo = torch.where(left, zl, nz_rows[lev] + lo - zl)
        hi = torch.where(left, zr, nz_rows[lev] + hi - zr)
    # no live entry: JAX's searchsorted past the end, clipped to G - 1
    slot = torch.where(n_live > 0, slot, g_n - 1)
    return torch.clamp(slot, 0, g_n - 1).to(I32), n_live


class DhtApp:
    """Tier app (interface: apps/base.py).  ``dist_fn(node_key,
    record_key)`` is the overlay's distance for the maintenance
    responsibility filter; None means XOR (the Kademlia family).  Ring
    overlays bind theirs when it is None (``overlay/chord.py``).

    ``tally``, when set to a dict, counts how often each hook acted, as
    device scalars (no host read): ``put_sends`` and ``get_sends`` (the
    replica fan-out), ``handover_sends`` (graceful leave),
    ``update_staged`` and ``update_urgent`` (update() stagings, and
    those forced by an urgent delta), ``team_lookups`` (a replica
    team's continuation lookup).  On the sparse tick a sentinel
    lane repeats node N-1's step, so the tally may count it twice."""

    def __init__(self, params: DhtParams = DhtParams(),
                 spec: keys_mod.KeySpec = keys_mod.DEFAULT_SPEC,
                 trace=None, dist_fn=None):
        self.p = params
        self.spec = spec
        self.trace = trace
        self.dist_fn = dist_fn
        t = max(1, params.num_replica_teams)
        if params.variant != "plain" and params.num_replica % t:
            raise ValueError("numReplica must be a multiple of "
                             "numReplicaTeams (initializeDHT)")
        if params.variant != "plain" and trace is not None:
            raise ValueError("trace workloads drive the plain DHT")
        self.teams = t if params.variant != "plain" else 1
        self.per_team = params.num_replica // self.teams
        self._team_mix = None
        if params.variant == "repeated":
            r = np.random.RandomState(0xD47)
            consts = r.randint(0, 2 ** 32, size=(self.teams, spec.lanes),
                               dtype=np.uint32)
            consts[0] = 0          # team 0 = the base key itself
            self._team_mix = consts.astype(np.int64)
        self._consts = {}
        self.tally = None

    def _count(self, name, mask):
        if self.tally is not None:
            v = torch.sum(mask.to(I64))
            prev = self.tally.get(name)
            self.tally[name] = v if prev is None else prev + v

    def _team_table(self, device):
        """[T, KL] per-team offsets (symmetric) or mixes (repeated) on
        ``device``, made once per device from fills."""
        key = str(device)
        if key not in self._consts:
            spec = self.spec
            if self.p.variant == "symmetric":
                step = (2 ** spec.bits) // self.teams
                tab = torch.stack([keys_mod.from_int(
                    (step * i) % (2 ** spec.bits), spec, device)
                    for i in range(self.teams)])
            else:
                tab = torch.stack([torch.stack([
                    torch.full((), int(v), dtype=I64, device=device)
                    for v in row]) for row in self._team_mix])
            self._consts[key] = tab
        return self._consts[key]

    def _team_key(self, base_k, t):
        """Team ``t`` [N]'s wire key for base keys ``base_k`` [N, KL]
        (SymmetricDHT's additive offsets; RepeatedHashingDHT's chain as
        the JAX package's lane rotation + xor mix)."""
        if self.teams == 1:
            return base_k
        tab = self._team_table(base_k.device)
        row = tab[torch.clamp(t, 0, self.teams - 1).long()]      # [N, KL]
        if self.p.variant == "symmetric":
            return keys_mod.add(base_k, row, self.spec)
        kl = base_k.shape[-1]
        lane = (torch.arange(kl, device=base_k.device)[None, :]
                + t[:, None].long()) % kl
        rot = torch.gather(base_k, 1, lane)
        return torch.where((t == 0)[:, None], base_k, rot ^ row)

    @property
    def dist(self):
        return self.dist_fn or keys_mod.xor_metric

    def stat_spec(self):
        return dict(
            scalars=("dht_put_latency_s", "dht_get_latency_s"),
            hists=(),
            counters=("dht_put_attempts", "dht_put_success",
                      "dht_get_attempts", "dht_get_success",
                      "dht_get_wrong", "dht_get_notfound",
                      "dht_lookup_failed", "dht_stored",
                      "dht_mnt_puts"))

    def _trace_queues(self, n, device):
        """The trace's [N, Q] queues on ``device``, copied once (the
        engine's reset asks for a fresh state every tick); the JAX
        conversion of seconds: ``where(inf, T_INF, t * NS)`` in float64,
        truncated to int64."""
        key = f"trace:{device}"
        if key not in self._consts:
            tr = self.trace
            if tr.t.shape[0] != n:
                raise ValueError("trace workload slot count != num nodes")
            t_ns = np.where(np.isinf(tr.t), float(T_INF), tr.t * NS)
            self._consts[key] = tuple(
                torch.from_numpy(np.ascontiguousarray(a)).to(device)
                for a in (t_ns.astype(np.int64), tr.kind.astype(np.int32),
                          tr.key.astype(np.int64), tr.value.astype(np.int32),
                          tr.g.astype(np.int32)))
        return tuple(x.clone() for x in self._consts[key])

    def init(self, n: int, device="cpu") -> DhtState:
        p, kl, d = self.p, self.spec.lanes, self.p.storage_slots

        def full(shape, v, dt):
            return torch.full((n,) + shape, v, dtype=dt, device=device)

        if self.trace is not None:
            tr_t, tr_kind, tr_key, tr_val, tr_g = self._trace_queues(n,
                                                                     device)
        else:
            tr_t, tr_kind = full((0,), T_INF, I64), full((0,), 0, I32)
            tr_key = full((0, kl), 0, I64)
            tr_val, tr_g = full((0,), 0, I32), full((0,), 0, I32)
        return DhtState(
            s_key=full((d, kl), 0, I64), s_val=full((d,), NO_VAL, I32),
            s_expire=full((d,), 0, I64),
            t_test=full((), T_INF, I64), seq=full((), 0, I32),
            tr_t=tr_t, tr_kind=tr_kind, tr_key=tr_key, tr_val=tr_val,
            tr_g=tr_g, tr_cur=full((), 0, I32),
            op=full((), 0, I32), op_seq=full((), 0, I32),
            op_g=full((), 0, I32), op_key=full((kl,), 0, I64),
            op_team=full((), 0, I32), op_cont=full((), False, torch.bool),
            op_val=full((), NO_VAL, I32), op_pending=full((), 0, I32),
            op_acks=full((), 0, I32),
            op_votes=full((p.num_get_requests,), NO_VAL - 1, I32),
            op_to=full((), T_INF, I64), op_t0=full((), 0, I64),
            commit_g=full((), -1, I32), commit_key=full((kl,), 0, I64),
            commit_val=full((), NO_VAL, I32),
            commit_expire=full((), 0, I64),
            mnt_dst=full((), NO_NODE, I32), mnt_pos=full((), 0, I32),
            mnt_resp=full((d,), False, torch.bool))

    def glob_init(self, rng) -> DhtGlobal:
        """The truth map starts empty and grows as puts complete, like
        GlobalDhtTestMap (DHTTestApp.cc:356-363 "No key available"); a
        trace's map is its key pool, no value put yet."""
        g, dev = self.p.num_test_keys, rng.device
        if self.trace is not None:
            pool = torch.from_numpy(
                self.trace.key_pool.astype(np.int64)).to(dev)
            g = pool.shape[0]
            return DhtGlobal(
                keys=pool, val=torch.full((g,), NO_VAL, dtype=I32, device=dev),
                expire=torch.zeros((g,), dtype=I64, device=dev),
                cursor=torch.zeros((), dtype=I32, device=dev))
        return DhtGlobal(
            keys=torch.zeros((g, self.spec.lanes), dtype=I64, device=dev),
            val=torch.full((g,), NO_VAL, dtype=I32, device=dev),
            expire=torch.zeros((g,), dtype=I64, device=dev),
            cursor=torch.zeros((), dtype=I32, device=dev))

    def post_step(self, ctx, state: DhtState, glob: DhtGlobal, events):
        """Fold the staged commits into the truth map: mods overwrite
        their slot while it still holds the op's key, then fresh-key
        puts append at the ring cursor in node order."""
        del ctx, events
        g_n = glob.val.shape[0]
        slot_w = state.commit_g >= 0
        gs = torch.clamp(state.commit_g, 0, g_n - 1).long()
        still = torch.all(glob.keys[gs] == state.commit_key, -1)
        rows = torch.where(slot_w & still, gs, g_n)
        val = _scatter_rows(glob.val, rows, state.commit_val)
        expire = _scatter_rows(glob.expire, rows, state.commit_expire)
        app_w = (state.commit_g == G_APPEND).to(I32)
        rank = torch.cumsum(app_w, 0, dtype=I32) - app_w
        pos = torch.where(app_w > 0, (glob.cursor + rank) % g_n, g_n)
        glob = dataclasses.replace(
            glob,
            keys=_scatter_rows(glob.keys, pos, state.commit_key),
            val=_scatter_rows(val, pos, state.commit_val),
            expire=_scatter_rows(expire, pos, state.commit_expire),
            cursor=(glob.cursor + torch.sum(app_w, dtype=I32)) % g_n)
        state = dataclasses.replace(
            state, commit_g=torch.full_like(state.commit_g, -1))
        return state, glob

    def on_ready(self, app, en, now, rng):
        """First test after a uniform float64 offset in [0, interval)
        (the JAX draw is float64 under x64); ``rng`` [N, 2].  A trace
        node's timer is its next queued command's time."""
        if self.trace is not None:
            qn = app.tr_t.shape[1]
            q = torch.clamp(app.tr_cur, 0, max(qn - 1, 0))
            nxt = take(app.tr_t, q) if qn else torch.full_like(app.t_test,
                                                               T_INF)
            return dataclasses.replace(
                app, t_test=torch.where(en, nxt, app.t_test))
        off = rng_mod.uniform(rng, (), F64, 0.0, self.p.test_interval)
        t = now + (off * NS).to(I64)
        return dataclasses.replace(app, t_test=torch.where(en, t, app.t_test))

    def on_stop(self, app, en):
        return dataclasses.replace(
            app, t_test=torch.where(en, T_INF, app.t_test),
            op=torch.where(en, OP_NONE, app.op),
            op_cont=app.op_cont & ~en,
            op_to=torch.where(en, T_INF, app.op_to),
            mnt_dst=torch.where(en, NO_NODE, app.mnt_dst))

    def next_event(self, app):
        """A pending next-team lookup and an active maintenance pump
        fire on the next tick (0), which keeps the node awake on the
        sparse tick."""
        t = self.timer_event(app)
        return torch.where(app.mnt_dst != NO_NODE, 0, t)

    def timer_event(self, app):
        t = torch.minimum(app.t_test, app.op_to)
        return torch.where(app.op_cont, 0, t)

    def _vote_winner(self, votes, n_acks):
        """Per-value counts over each node's filled vote prefix and the
        data-preferring winner (a value beats an equal count of notfound
        votes; ties go to the first slot, as ``jnp.argmax``'s do);
        ``votes`` [N, Q], ``n_acks`` [N]."""
        q = self.p.num_get_requests
        filled = (torch.arange(q, device=votes.device)[None, :]
                  < torch.clamp(n_acks, 0, q)[:, None])
        counts = torch.sum((votes[:, :, None] == votes[:, None, :])
                           & filled[:, None, :], -1, dtype=I32)
        counts = torch.where(filled, counts, 0)
        score = counts * 2 + (votes != NO_VAL).to(I32)
        return counts, take(votes, torch.argmax(score, -1))

    def _truth_outcomes(self, glob, op_g, op_key, winner, now, final):
        """(slot_ok, expired, has_val, good, wrong, notfound) [N] against
        the truth map (DHTTestApp::handleGetResponse)."""
        g_n = glob.val.shape[0]
        gslot = torch.clamp(op_g, 0, g_n - 1).long()
        slot_ok = torch.all(glob.keys[gslot] == op_key, -1) & (op_g >= 0)
        expired = now > glob.expire[gslot]
        has_val = winner != NO_VAL
        tv = glob.val[gslot]
        good = final & slot_ok & torch.where(expired, ~has_val,
                                             has_val & (winner == tv))
        wrong = final & slot_ok & has_val & (expired | (winner != tv))
        notfound = final & ((slot_ok & ~expired & ~has_val) | ~slot_ok)
        return slot_ok, expired, has_val, good, wrong, notfound

    def _stage_commit(self, app, en):
        """Stage the op's (key, value, expiry) for ``post_step``: every
        put response path inserts into GlobalDhtTestMap
        (DHTTestApp.cc:151-153)."""
        return dataclasses.replace(
            app,
            commit_g=torch.where(en, app.op_g, app.commit_g),
            commit_key=torch.where(en[:, None], app.op_key, app.commit_key),
            commit_val=torch.where(en, app.op_val, app.commit_val),
            commit_expire=torch.where(
                en, app.op_t0 + int(self.p.test_ttl * NS),
                app.commit_expire))

    def on_update(self, app, en, ctx, ob, ev, now, node_idx, added,
                  sib_keys=None, sib_valid=None, urgent=None):
        """Common API update(): stage re-replication of the stored
        records to the first node of ``added`` [N, A] that entered the
        replica set, unless a pump is active (an ``urgent`` delta
        restarts it).  A record is pushed only if the target falls within
        its numReplica closest of {me} ∪ the sibling view (DHT.cc:777
        isSiblingFor); with a short view every record is admitted."""
        first = take(added, _first_index(added != NO_NODE))
        idle = app.mnt_dst == NO_NODE
        if urgent is not None:
            idle = idle | urgent
        en = en & (first != NO_NODE) & (first != node_idx) & torch.any(
            app.s_val != NO_VAL, -1) & idle
        tgt_key = ctx.keys[torch.clamp(first, min=0).long()]
        d_tgt = _dist64(self.dist(tgt_key[:, None, :], app.s_key))   # [N, D]
        if sib_keys is None:
            resp = torch.ones_like(app.mnt_resp)
        else:
            me_key = ctx.keys[node_idx.long()]
            d_me = _dist64(self.dist(me_key[:, None, :], app.s_key))
            d_sib = _dist64(self.dist(sib_keys[:, :, None, :],
                                      app.s_key[:, None, :, :]))  # [N, S, D]
            # invalid members sort last (the JAX uint64 sentinel)
            d_sib = torch.where(sib_valid[:, :, None], d_sib, I64_MAX)
            all_d = torch.cat([d_me[:, None, :], d_sib], 1)
            kth = torch.sort(all_d, 1).values[
                :, min(self.p.num_replica, all_d.shape[1]) - 1]
            resp = d_tgt <= kth
        self._count("update_staged", en)
        if urgent is not None:
            self._count("update_urgent", en & urgent)
        return dataclasses.replace(
            app,
            mnt_dst=torch.where(en, first, app.mnt_dst),
            mnt_resp=torch.where(en[:, None], resp, app.mnt_resp),
            mnt_pos=torch.where(en, 0, app.mnt_pos))

    def on_tick(self, app, ctx, ob, ev, node_idx):
        """The maintenance pump: two admitted records per tick to the
        staged target, skipping empty slots."""
        d = app.s_val.shape[1]
        idx = torch.arange(d, dtype=I32, device=app.s_val.device)[None, :]
        resp = app.mnt_resp
        for _ in range(2):
            cand = (app.s_val != NO_VAL) & (idx >= app.mnt_pos[:, None]) \
                & resp
            m_en = (app.mnt_dst != NO_NODE) & torch.any(cand, -1)
            col = _first_index(cand)
            ob.send(m_en, ctx.t_start, app.mnt_dst, wire.DHT_PUT_CALL,
                    key=take(app.s_key, col), a=take(app.s_val, col), b=-1,
                    stamp=take(app.s_expire, col), size_b=PUT_B)
            ev.count("dht_mnt_puts", m_en)
            app = dataclasses.replace(
                app, mnt_pos=torch.where(m_en, col + 1, app.mnt_pos))
        done = ~torch.any((app.s_val != NO_VAL)
                          & (idx >= app.mnt_pos[:, None]) & resp, -1)
        return dataclasses.replace(
            app, mnt_dst=torch.where(done, NO_NODE, app.mnt_dst))

    # -- timers --------------------------------------------------------------

    def on_timer(self, app, en, ctx, now, rng, ev, node_idx):
        p = self.p
        glob: DhtGlobal = ctx.glob
        to_ns = int(p.op_timeout * NS)

        # op timeout → failed operation; a timed-out PUT still records
        # its value as the truth (DHTTestApp.cc:151-153), and a timed-out
        # GET with answers in hand is judged on them without the
        # ratioIdentical bar (DHT::handleRpcTimeout)
        to = (app.op != OP_NONE) & (app.op_to < ctx.t_end)
        to_get = to & (app.op == OP_GET) & (app.op_acks > 0)
        _, winner_t = self._vote_winner(app.op_votes, app.op_acks)
        _, _, _, good_t, wrong_t, nf_t = self._truth_outcomes(
            glob, app.op_g, app.op_key, winner_t, now, to_get)
        ev.count("dht_get_success", good_t)
        ev.count("dht_get_wrong", wrong_t)
        ev.count("dht_get_notfound", nf_t)
        ev.count("dht_lookup_failed", to & ~to_get)
        app = self._stage_commit(app, to & (app.op == OP_PUT))
        app = dataclasses.replace(
            app, op=torch.where(to, OP_NONE, app.op),
            op_cont=app.op_cont & ~to,
            op_to=torch.where(to, T_INF, app.op_to))
        if self.trace is not None:
            return self._trace_commands(app, en, ctx, now, ev)

        # the periodic test: PUT (fresh key) / GET (known key) / MOD
        # (re-put of a known key), round-robin at interval / modes
        fire = en & (app.t_test < ctx.t_end) & (app.op == OP_NONE)
        due = en & (app.t_test < ctx.t_end)
        rs = rng_mod.split(rng, 3)
        r_g, r_v, r_k = rs[:, 0], rs[:, 1], rs[:, 2]
        n_modes = 3 if p.mod_test else 2
        mode = app.seq % n_modes
        g, n_valid = _known_key_draw(glob, now, r_g)
        have_known = n_valid > 0
        do_put = fire & (mode == 0)
        do_get = fire & (mode == 1) & have_known
        do_mod = fire & (mode == 2) & have_known
        ev.count("dht_put_attempts", do_put | do_mod)
        ev.count("dht_get_attempts", do_get)
        # a fresh value id: 30 bits of rng per (node, seq)
        val = torch.abs(rng_mod.randint(r_v, (), 0, 2 ** 30, dtype=I32))
        key = torch.where(do_put[:, None],
                          keys_mod.random_keys(r_k, (), self.spec),
                          glob.keys[g.long()])
        put_like = do_put | do_mod
        any_op = put_like | do_get
        app = dataclasses.replace(
            app,
            t_test=torch.where(due, torch.maximum(app.t_test, now)
                               + int(p.test_interval / n_modes * NS),
                               app.t_test),
            seq=app.seq + due.to(I32),
            op=torch.where(put_like, OP_PUT,
                           torch.where(do_get, OP_GET, app.op)),
            op_seq=torch.where(any_op, app.seq, app.op_seq),
            op_g=torch.where(do_put, G_APPEND,
                             torch.where(any_op, g, app.op_g)),
            op_key=torch.where(any_op[:, None], key, app.op_key),
            op_team=torch.where(any_op, 0, app.op_team),
            op_val=torch.where(put_like, val, app.op_val),
            op_pending=torch.where(any_op, 0, app.op_pending),
            op_acks=torch.where(any_op, 0, app.op_acks),
            op_to=torch.where(any_op, now + to_ns, app.op_to),
            op_t0=torch.where(any_op, now, app.op_t0))
        # the next team's lookup of an active multi-team op (variants)
        cont = en & app.op_cont & (app.op != OP_NONE)
        self._count("team_lookups", cont)
        if self.teams > 1:
            ckey = self._team_key(app.op_key, app.op_team)
            key = torch.where(cont[:, None], ckey, key)
        app = dataclasses.replace(app, op_cont=app.op_cont & ~cont)
        return app, base.LookupReq(want=any_op | cont, key=key,
                                   tag=app.op_seq)

    def _trace_commands(self, app, en, ctx, now, ev):
        """DHTTestApp::handleTraceMessage: each node's due queued command
        (PUT or GET of a pool key) starts an operation; one due while an
        operation is in flight retries a second later."""
        qn = app.tr_t.shape[1]
        q = torch.clamp(app.tr_cur, 0, max(qn - 1, 0))
        due = en & (app.t_test < ctx.t_end) & (app.tr_cur < qn)
        fire = due & (app.op == OP_NONE)
        blocked = due & ~fire
        kind = take(app.tr_kind, q)
        do_put = fire & (kind == 1)
        do_get = fire & (kind == 2)
        ev.count("dht_put_attempts", do_put)
        ev.count("dht_get_attempts", do_get)
        key = take(app.tr_key, q)
        cur2 = app.tr_cur + fire.to(I32)
        q2 = torch.clamp(cur2, 0, max(qn - 1, 0))
        nxt_t = torch.where(cur2 < qn, take(app.tr_t, q2), T_INF)
        nxt_t = torch.where(blocked, now + NS, nxt_t)
        app = dataclasses.replace(
            app, tr_cur=cur2,
            t_test=torch.where(due, nxt_t, app.t_test),
            seq=app.seq + fire.to(I32),
            op=torch.where(do_put, OP_PUT,
                           torch.where(do_get, OP_GET, app.op)),
            op_seq=torch.where(fire, app.seq, app.op_seq),
            op_g=torch.where(fire, take(app.tr_g, q), app.op_g),
            op_key=torch.where(fire[:, None], key, app.op_key),
            op_val=torch.where(do_put, take(app.tr_val, q), app.op_val),
            op_pending=torch.where(fire, 0, app.op_pending),
            op_acks=torch.where(fire, 0, app.op_acks),
            op_to=torch.where(fire, now + int(self.p.op_timeout * NS),
                              app.op_to),
            op_t0=torch.where(fire, now, app.op_t0))
        return app, base.LookupReq(want=do_put | do_get, key=key,
                                   tag=app.op_seq)

    # -- lookup completion → replica fan-out --------------------------------

    def on_lookup_done(self, app, done: base.LookupDone, ctx, ob, ev, now,
                       node_idx):
        """One completion per node (``done`` fields [N, ...]); the
        overlays fold their completion slots through this in slot order
        (``base.lookup_done_fold``)."""
        p = self.p
        # the op nonce rejects completions of an op that timed out
        en = done.en & (app.op != OP_NONE) & (done.tag == app.op_seq)
        suc = done.success & (done.results[:, 0] != NO_NODE)
        ev.count("dht_lookup_failed", en & ~suc)
        app = self._stage_commit(app, en & ~suc & (app.op == OP_PUT))
        app = dataclasses.replace(
            app, op=torch.where(en & ~suc, OP_NONE, app.op),
            op_to=torch.where(en & ~suc, T_INF, app.op_to))

        # PUT: DHTPutCall to up to numReplica (per team) siblings; the
        # expiry rides the stamp, the op nonce rides b
        is_put = en & suc & (app.op == OP_PUT)
        nrep = torch.zeros_like(app.op_pending)
        expire = app.op_t0 + int(p.test_ttl * NS)
        for i in range(min(self.per_team, done.results.shape[1])):
            tgt = done.results[:, i]
            send = is_put & (tgt != NO_NODE)
            ob.send(send, now, tgt, wire.DHT_PUT_CALL, key=done.target,
                    a=app.op_val, b=app.op_seq, stamp=expire, size_b=PUT_B)
            nrep = nrep + send.to(I32)
            self._count("put_sends", send)
        app = dataclasses.replace(
            app, op_pending=torch.where(is_put, nrep, app.op_pending))

        # GET: DHTGetCall to numGetRequests siblings (capped at the
        # team's replica count with replica teams)
        is_get = en & suc & (app.op == OP_GET)
        nget = torch.zeros_like(app.op_pending)
        get_w = (min(p.num_get_requests, self.per_team)
                 if self.teams > 1 else p.num_get_requests)
        for i in range(min(get_w, done.results.shape[1])):
            tgt = done.results[:, i]
            send = is_get & (tgt != NO_NODE)
            ob.send(send, now, tgt, wire.DHT_GET_CALL, key=done.target,
                    b=app.op_seq, size_b=GET_B)
            nget = nget + send.to(I32)
            self._count("get_sends", send)
        return dataclasses.replace(
            app,
            op_pending=torch.where(is_get, nget, app.op_pending),
            op_acks=torch.where(is_get, 0, app.op_acks),
            op_votes=torch.where(is_get[:, None], NO_VAL - 1, app.op_votes))

    # -- inbound messages ----------------------------------------------------

    def _store(self, app, en, key, val, expire, maintenance=None):
        """DHTDataStorage::addData for one record per node: overwrite the
        same key, else a free slot, else evict the earliest-expiring
        (the first on ties, as ``jnp.argmin``).  A replication copy
        (``maintenance``) never rolls a record back and never evicts.
        Returns (app, stored [N])."""
        same_mask = torch.all(app.s_key == key[:, None, :], -1) & (
            app.s_val != NO_VAL)
        same = en & torch.any(same_mask, -1)
        col_same = _first_index(same_mask)
        free = app.s_val == NO_VAL
        any_free = torch.any(free, -1)
        if maintenance is not None:
            stale = maintenance & same & (take(app.s_expire, col_same)
                                          >= expire)
            en = en & ~stale
            en = en & (same | any_free | ~maintenance)
        col_free = _first_index(free)
        col_evict = torch.argmin(app.s_expire, -1).to(I32)
        col = torch.where(same, col_same,
                          torch.where(any_free, col_free, col_evict))
        # the pump's frozen responsibility bit was judged for the slot's
        # previous record: clear it
        return dataclasses.replace(
            app,
            s_key=_set_col(app.s_key, col, key, en),
            s_val=_set_col(app.s_val, col, val, en),
            s_expire=_set_col(app.s_expire, col, expire, en),
            mnt_resp=_set_col(app.mnt_resp, col, False, en)), en

    def on_leave(self, app, en, ctx, ob, ev, now, node_idx, handover):
        """Graceful-leave handover: two stored records per tick to the
        overlay's succession candidate, cleared locally."""
        en = en & (handover != NO_NODE) & (handover != node_idx)
        valid = app.s_val != NO_VAL
        for _ in range(2):
            has = en & torch.any(valid, -1)
            col = _first_index(valid)
            ob.send(has, now, handover, wire.DHT_PUT_CALL,
                    key=take(app.s_key, col), a=take(app.s_val, col), b=-1,
                    stamp=take(app.s_expire, col), size_b=PUT_B)
            self._count("handover_sends", has)
            app = dataclasses.replace(
                app, s_val=_set_col(app.s_val, col, NO_VAL, has))
            valid = _set_col(valid, col, False, has)
        return app

    def on_msgs(self, app, msgs, ctx, ob, ev, is_sib, node_idx=None):
        """The [N, R] inbox in one pass per message kind (the JAX
        package's batched form): puts store slot by slot, then acks,
        get probes and get answers, whose quorum is judged once."""
        del is_sib, node_idx
        p = self.p
        now = msgs.t_deliver                                   # [N, R]
        r_in = msgs.valid.shape[1]
        to_ns = int(p.op_timeout * NS)

        # DHTPutCall → store + ack; b == -1 marks replication copies
        en_put = msgs.valid & (msgs.kind == wire.DHT_PUT_CALL)
        stored = []
        for r in range(r_in):
            app, did = self._store(app, en_put[:, r], msgs.key[:, r],
                                   msgs.a[:, r], msgs.stamp[:, r],
                                   maintenance=msgs.b[:, r] == -1)
            stored.append(did)
        ev.count("dht_stored", torch.stack(stored, 1))
        ob.send(en_put, now, msgs.src, wire.DHT_PUT_RES, key=msgs.key,
                b=msgs.b, size_b=wire.BASE_CALL_B)

        # DHTPutResponse → ack count; a majority completes the team's
        # put.  The echoed nonce and the team key reject stragglers
        cur_key = (self._team_key(app.op_key, app.op_team)
                   if self.teams > 1 else app.op_key)
        en_ack = (msgs.valid & (msgs.kind == wire.DHT_PUT_RES)
                  & (app.op == OP_PUT)[:, None]
                  & (msgs.b == app.op_seq[:, None])
                  & torch.all(msgs.key == cur_key[:, None, :], -1))
        en = torch.any(en_ack, 1)
        now_s = torch.max(torch.where(en_ack, now, 0), 1).values
        acks = app.op_acks + torch.sum(en_ack, 1, dtype=I32)
        team_done = en & (2 * acks > app.op_pending) & (app.op_pending > 0)
        more = app.op_team + 1 < self.teams
        complete = team_done & ~more
        next_team = team_done & more
        ev.count("dht_put_success", complete)
        ev.value("dht_put_latency_s", base.seconds(now_s - app.op_t0),
                 complete)
        app = self._stage_commit(app, complete)
        app = dataclasses.replace(
            app,
            op_acks=torch.where(next_team, 0, acks),
            op_pending=torch.where(next_team, 0, app.op_pending),
            op_team=app.op_team + next_team.to(I32),
            op_cont=app.op_cont | next_team,
            op=torch.where(complete, OP_NONE, app.op),
            op_to=torch.where(complete, T_INF, torch.where(
                next_team, now_s + to_ns, app.op_to)))

        # DHTGetCall → one [N, R, D] storage probe + reply
        en_get = msgs.valid & (msgs.kind == wire.DHT_GET_CALL)
        hit = (torch.all(app.s_key[:, None, :, :] == msgs.key[:, :, None, :],
                         -1)
               & (app.s_val != NO_VAL)[:, None, :]
               & (app.s_expire[:, None, :] > now[:, :, None]))
        found = torch.any(hit, -1)
        val = torch.where(found, take(app.s_val, _first_index(hit)), NO_VAL)
        ob.send(en_get, now, msgs.src, wire.DHT_GET_RES, key=msgs.key,
                a=val, b=msgs.b, size_b=wire.BASE_CALL_B + 8)

        # DHTGetResponse → the batch's votes in one scatter (a later lane
        # wins a clipped slot, as the JAX scatter), then the quorum
        q = p.num_get_requests
        cur_key = (self._team_key(app.op_key, app.op_team)
                   if self.teams > 1 else app.op_key)
        en_v = (msgs.valid & (msgs.kind == wire.DHT_GET_RES)
                & (app.op == OP_GET)[:, None]
                & (msgs.b == app.op_seq[:, None])
                & torch.all(msgs.key == cur_key[:, None, :], -1))
        en = torch.any(en_v, 1)
        now_g = torch.max(torch.where(en_v, now, 0), 1).values
        v32 = en_v.to(I32)
        rank = torch.cumsum(v32, 1, dtype=I32) - v32
        slot = torch.clamp(app.op_acks[:, None] + rank, 0, q - 1)
        votes = put(app.op_votes, slot, msgs.a, en_v)
        n_acks = app.op_acks + torch.sum(v32, 1, dtype=I32)
        counts, winner = self._vote_winner(votes, n_acks)
        need = torch.ceil(p.ratio_identical
                          * app.op_pending.to(F32)).to(I32)
        need = torch.clamp(need, min=1)
        win = en & torch.any(counts >= need[:, None], -1)
        exhausted = en & ~win & (n_acks >= app.op_pending)
        slot_ok, expired, has_val, good, wrong, nf = self._truth_outcomes(
            ctx.glob, app.op_g, app.op_key, winner, now_g, True)
        # a live-truth team miss tries the next replica team (variants)
        want_retry = (((win & ~has_val) | exhausted) & slot_ok & ~expired)
        retry_team = want_retry & (app.op_team + 1 < self.teams)
        final = (win | exhausted) & ~retry_team
        good = good & final & win
        wrong = wrong & final & win
        ev.count("dht_get_success", good)
        ev.count("dht_get_wrong", wrong)
        ev.count("dht_get_notfound", nf & final & win)
        ev.value("dht_get_latency_s", base.seconds(now_g - app.op_t0), good)
        return dataclasses.replace(
            app,
            op_votes=votes, op_acks=n_acks,
            op_team=app.op_team + retry_team.to(I32),
            op_cont=app.op_cont | retry_team,
            op=torch.where(final, OP_NONE, app.op),
            op_to=torch.where(final, T_INF, torch.where(
                retry_team, now_g + to_ns, app.op_to)))

    @property
    def hist_map(self):
        return {}
