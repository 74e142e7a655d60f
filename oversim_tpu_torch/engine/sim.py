"""The simulation engine: event-horizon tick loop (PyTorch).

Counterpart of ``oversim_tpu/engine/sim.py``.  Every tick

  1. advances simulated time to the earliest pending event (message
     deliveries, per-node timers, churn) and opens a window of
     ``window`` seconds;
  2. applies churn create/kill events (alive flips + state resets);
  3. groups the due messages by destination into an ``[N, R]`` inbox
     (``inbox_impl``: "scatter", the torch-ops oracle, or "pallas", the
     hand-written CUDA kernels) and gathers their payloads;
  4. runs the logic's batched step over all N nodes;
  5. sends the outbox through the underlay into free pool slots and
     folds the tick's stat events.

``tick_impl="sparse"`` (the active-set plane) replaces steps 3-4: the
inbox is selected without the payload gather, the awake nodes (inbox
traffic, due timers, churn) are compacted into ``acap`` lanes, and only
those lanes run the logic's step, whose results are scattered back into
full-width state.  Awake nodes past the cap defer to a later tick.

``step(s, ov=...)`` takes a campaign row's sweep overrides
(``engine.window``, ``churn.lifetimeMean`` and the ``app.*`` keys a
handler reads through ``Ctx.ov_get``), each a float64 scalar;
``ov=None`` is the static-parameter tick.  With
``EngineParams.telemetry.sample_ticks > 0`` the alloc phase folds a KPI
sample into the ``SimState.telemetry`` rings (``telemetry.py``).

The port runs on the card unless the caller asks for the CPU
(``device="cpu"``, as the tests do); asking for CUDA where there is none
raises.  Meshes are still to be ported (ROADMAP Queue A).
"""

from __future__ import annotations

import dataclasses

import torch

from oversim_tpu_torch import churn as churn_mod
from oversim_tpu_torch import rng as rng_mod
from oversim_tpu_torch import stats as stats_mod
from oversim_tpu_torch import telemetry as telemetry_mod
from oversim_tpu_torch import tree
from oversim_tpu_torch.common.malicious import MaliciousParams
from oversim_tpu_torch.core import keys as keys_mod
from oversim_tpu_torch.engine import pool as pool_mod
from oversim_tpu_torch.engine.logic import Ctx, Msg
from oversim_tpu_torch.underlay import simple as underlay_mod

I32 = torch.int32
I64 = torch.int64
F64 = torch.float64
NS = 1_000_000_000
T_INF = pool_mod.T_INF
EXT_OUT_KIND = 151
INBOX_IMPLS = ("scatter", "pallas", "sort")
TICK_IMPLS = ("dense", "sparse")


@dataclasses.dataclass(frozen=True)
class EngineParams:
    """Engine knobs (JAX field names and defaults; times in seconds).

    ``inbox_impl``: "scatter" (default; the torch-ops scatter-min
    oracle), "pallas" (the port's hand-written CUDA kernels
    ``kernels.inbox.inbox_select_gather`` and ``kernels.outbox.
    alloc_dest`` — the name is the JAX package's, so a configuration
    carries over; on a CUDA device they are built and launched, or the
    tick raises) or "sort" (oracle only).  Under ``tick_impl="sparse"``
    "pallas" launches the select-only inbox kernel and the active-set
    compaction kernel instead of the gathering inbox kernel.

    ``active_cap``: the sparse tick's lane count A; 0 picks
    ``min(n, max(64, n // 8))``."""

    window: float = 0.010
    inbox_slots: int = 8
    inbox_impl: str = "scatter"
    tick_impl: str = "dense"
    active_cap: int = 0
    outbox_slots: int = 16
    pool_factor: int = 8
    rmax: int = 16
    transition_time: float = 0.0
    measurement_time: float = -1.0
    malicious: MaliciousParams = MaliciousParams()
    telemetry: telemetry_mod.TelemetryParams = \
        telemetry_mod.TelemetryParams()
    ext_hold_slot: int = -1


@dataclasses.dataclass
class SimState:
    t_now: torch.Tensor       # i64 scalar ns
    tick: torch.Tensor        # i64 scalar
    rng: torch.Tensor         # [2] key
    alive: torch.Tensor       # [N] bool
    node_keys: torch.Tensor   # [N, KL] u32 lanes in int64
    underlay: underlay_mod.UnderlayState
    pool: pool_mod.MsgPool
    churn: churn_mod.ChurnState
    malicious: torch.Tensor   # [N] bool
    logic: object
    stats: dict
    counters: dict
    telemetry: object = None


ENGINE_COUNTERS = ("queue_lost", "bit_error_lost", "dest_unavailable_lost",
                   "partition_lost", "pool_overflow", "outbox_overflow",
                   "inbox_deferred")
# carried only under tick_impl="sparse": cumulative awake-node and
# inbox-destination lane counts, and awake nodes deferred past the cap
SPARSE_COUNTERS = ("awake_nodes", "active_dst", "active_deferred")


def resolve_device(device):
    """The device a simulation runs on; CUDA unless the caller asks for
    something else, and never a silent move to the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "Simulation: CUDA is not available; pass device='cpu' to run "
            "on the host")
    return dev


class Simulation:
    """Host-side driver binding logic + underlay + churn params."""

    def __init__(self, logic, churn_params: churn_mod.ChurnParams,
                 underlay_params=None, engine_params=None,
                 underlay_module=None, device="cuda"):
        self.device = resolve_device(device)
        self.ul = underlay_module or underlay_mod
        self.logic = logic
        self.cp = churn_params
        self.up = (self.ul.UnderlayParams() if underlay_params is None
                   else underlay_params)
        self.ep = engine_params or EngineParams()
        if self.ep.tick_impl not in TICK_IMPLS:
            raise ValueError(f"unknown tick_impl {self.ep.tick_impl!r}")
        if self.ep.inbox_impl not in INBOX_IMPLS:
            raise ValueError(f"unknown inbox_impl {self.ep.inbox_impl!r}")
        self.n = churn_params.num_slots
        self.spec = logic.key_spec

    @property
    def counter_names(self) -> tuple:
        if self.ep.tick_impl == "sparse":
            return ENGINE_COUNTERS + SPARSE_COUNTERS
        return ENGINE_COUNTERS

    @property
    def acap(self) -> int:
        """A, the sparse tick's lane count."""
        if self.ep.active_cap > 0:
            return min(self.ep.active_cap, self.n)
        return min(self.n, max(64, self.n // 8))

    # -- init ---------------------------------------------------------------

    def init(self, seed: int = 1, ov=None) -> SimState:
        return self.init_from_rng(rng_mod.PRNGKey(seed, self.device), ov=ov)

    def device_ov(self, ov):
        """Sweep overrides as float64 scalars on the simulation's device
        (made by fills, so a python value costs no host sync)."""
        if ov is None:
            return None
        return {k: rng_mod.device_scalar(v, F64, self.device)
                for k, v in ov.items()}

    @torch.no_grad()
    def init_from_rng(self, rng, ov=None) -> SimState:
        """Init from an explicit key; ``ov`` as in ``step`` (only
        ``churn.lifetimeMean`` acts here)."""
        r_keys, r_ul, r_churn, r_logic, r_run, r_mal = rng_mod.split(rng, 6)
        n, dev = self.n, self.device
        ov = self.device_ov(ov)
        life_mean = None if ov is None else ov.get("churn.lifetimeMean")
        stats = stats_mod.init_stats(self.logic.stat_spec(), dev)
        return SimState(
            t_now=torch.tensor(0, dtype=I64, device=dev),
            tick=torch.tensor(0, dtype=I64, device=dev),
            rng=r_run,
            alive=torch.zeros((n,), dtype=torch.bool, device=dev),
            node_keys=keys_mod.random_keys(r_keys, (n,), self.spec),
            underlay=self.ul.init(r_ul, n, self.up),
            pool=pool_mod.empty(self.ep.pool_factor * n, self.spec.lanes,
                                self.ep.rmax, dev),
            churn=churn_mod.init(r_churn, self.cp, life_mean=life_mean),
            malicious=(rng_mod.uniform(r_mal, (n,), F64)
                       < self.ep.malicious.probability),
            logic=self.logic.init(r_logic, n),
            stats=stats,
            counters={name: torch.zeros((), dtype=I64, device=dev)
                      for name in self.counter_names},
            telemetry=telemetry_mod.init(
                stats, self.counter_names, self.ep.telemetry,
                app=getattr(self.logic, "app", None)))

    # -- one tick: the five phases -------------------------------------------

    def _phase_horizon(self, s: SimState, ov=None):
        w = None if ov is None else ov.get("engine.window")
        window_ns = int(self.ep.window * NS) if w is None \
            else (w * NS).to(I64)
        t_next = torch.minimum(
            pool_mod.next_deliver_time(s.pool),
            torch.minimum(
                torch.min(torch.where(s.alive, self.logic.next_event(s.logic),
                                      T_INF)),
                churn_mod.next_event(s.churn)))
        t_next = torch.maximum(t_next, s.t_now)
        t_end = torch.where(t_next >= T_INF, t_next, t_next + window_ns)
        return t_next, t_end, rng_mod.split(s.rng, 7)

    def _phase_churn(self, s: SimState, t_next, t_end, r_churn, r_keys,
                     r_reset, r_mig, ov=None):
        life_mean = None if ov is None else ov.get("churn.lifetimeMean")
        churn_state, created, killed, _ = churn_mod.step(
            s.churn, self.cp, s.alive, t_next, t_end, r_churn,
            life_mean=life_mean)
        alive = (s.alive | created) & ~killed
        pre_killed = churn_state.t_dead < T_INF
        if self.cp.rejoin_context:
            node_keys = s.node_keys
        else:
            node_keys = torch.where(
                created[:, None],
                keys_mod.random_keys(r_keys, (self.n,), self.spec),
                s.node_keys)
        ul_state = self.ul.migrate(s.underlay, created, r_mig, self.up)
        logic_state = self.logic.reset(s.logic, created | killed, created,
                                       t_next, r_reset)
        return churn_state, alive, pre_killed, node_keys, ul_state, logic_state

    def _hold_mask(self, s: SimState):
        if self.ep.ext_hold_slot < 0:
            return None
        return (s.pool.kind == EXT_OUT_KIND) & (
            s.pool.dst == self.ep.ext_hold_slot)

    def _msgs_from_block(self, s: SimState, t_next, inbox, blk):
        """[N, R] index table + gathered [N, R, W] block → the Msg view."""
        safe = torch.clamp(inbox, min=0).long()
        ncol = len(pool_mod.SCAL_COLS)
        kl = s.pool.kl

        def col(name):
            return blk[..., pool_mod._COL[name]]

        return Msg(
            valid=inbox >= 0,
            t_deliver=torch.maximum(s.pool.t_deliver[safe], t_next),
            src=col("src"), dst=col("dst"), kind=col("kind"),
            key=pool_mod.key_from_i32(blk[..., ncol:ncol + kl]),
            nonce=col("nonce"), hops=col("hops"), a=col("a"), b=col("b"),
            c=col("c"), d=col("d"), nodes=blk[..., ncol + kl:],
            size_b=col("size_b"), stamp=s.pool.stamp[safe])

    def _phase_inbox(self, s: SimState, t_next, t_end, alive):
        """Select each destination's R earliest due messages and gather
        their payload rows (one CUDA kernel under ``"pallas"``)."""
        hold = self._hold_mask(s)
        if self.ep.inbox_impl == "pallas":
            from oversim_tpu_torch.kernels import inbox as inbox_k
            inbox, delivered, to_dead, gblk = inbox_k.fused_inbox(
                s.pool, self.n, self.ep.inbox_slots, t_end, alive, hold)
        else:
            inbox, delivered, to_dead = pool_mod.build_inbox(
                s.pool, self.n, self.ep.inbox_slots, t_end, alive,
                impl=self.ep.inbox_impl, hold=hold)
            gblk = s.pool.blk[torch.clamp(inbox, min=0).long()]
        return self._msgs_from_block(s, t_next, inbox, gblk), delivered, \
            to_dead

    def _make_ctx(self, s, t_next, t_end, alive, pre_killed, churn_state,
                  node_keys, logic_state, ul_state, ov=None):
        ep, cp, logic = self.ep, self.cp, self.logic
        ready = logic.ready_mask(logic_state) & alive & ~pre_killed
        ready_cumsum = torch.cumsum(ready.to(I32), 0, dtype=I32)
        measure_start = int((cp.init_finished_time + ep.transition_time) * NS)
        measuring = t_next >= measure_start
        if ep.measurement_time >= 0:
            measuring = measuring & (
                t_next < measure_start + int(ep.measurement_time * NS))
        node_part, glob = (logic.split(logic_state)
                           if hasattr(logic, "split") else (logic_state, None))
        part_kw = {}
        if self.up.num_node_types > 1:
            # per-type ready cumsums + the live connection matrix
            # (GlobalNodeList's per-type bootstrap vectors)
            nt = self.up.num_node_types
            tmask = ul_state.node_type[None, :] == torch.arange(
                nt, dtype=I32, device=self.device)[:, None]
            part_kw = dict(
                node_type=ul_state.node_type,
                conn=self.ul.connection_matrix(self.up, t_next),
                ready_cum_t=torch.cumsum((ready[None, :] & tmask).to(I32),
                                         1, dtype=I32))
        ctx = Ctx(t_start=t_next, t_end=t_end, keys=node_keys, alive=alive,
                  ready=ready, ready_cumsum=ready_cumsum,
                  n_ready=ready_cumsum[-1], measuring=measuring, glob=glob,
                  leaving=pre_killed & alive,
                  graceful=pre_killed & alive & churn_state.graceful,
                  malicious=s.malicious, ov=ov, **part_kw)
        return ctx, node_part, glob, measuring

    def _lanes_step(self, ctx, part, msgs, r_nodes, tick, node_idx):
        """The logic's batched step over the lanes ``node_idx`` (true
        node indices; each lane's rng stream folds the tick, then its
        node index)."""
        node_rngs = rng_mod.fold_in(rng_mod.fold_in(r_nodes, tick),
                                    node_idx.to(I64))
        part, ob, events = self.logic.step(
            ctx, part, msgs, node_rngs, node_idx,
            outbox_slots=self.ep.outbox_slots, rmax=self.ep.rmax)
        return (part, *ob.finish(), events)

    def _finish_logic(self, ctx, node_part, glob, events):
        logic = self.logic
        logic_state = (logic.merge(node_part, glob)
                       if hasattr(logic, "merge") else node_part)
        if hasattr(logic, "post_step"):
            logic_state = logic.post_step(ctx, logic_state, events)
        return logic_state

    def _phase_node_step(self, s, t_next, t_end, alive, pre_killed,
                         churn_state, node_keys, ul_state, logic_state, msgs,
                         r_nodes, ov=None):
        """Tick context + the logic's batched step over all nodes."""
        ctx, node_part, glob, measuring = self._make_ctx(
            s, t_next, t_end, alive, pre_killed, churn_state, node_keys,
            logic_state, ul_state, ov)
        node_idx = torch.arange(self.n, dtype=I32, device=self.device)
        node_part, out_fields, out_valid, out_overflow, events = \
            self._lanes_step(ctx, node_part, msgs, r_nodes, s.tick, node_idx)
        logic_state = self._finish_logic(ctx, node_part, glob, events)
        return (logic_state, out_fields, out_valid, out_overflow, events,
                measuring)

    # -- the sparse active-set plane (tick_impl="sparse") ---------------------

    def _phase_inbox_select_sparse(self, s: SimState, t_end, alive):
        """Inbox selection without the payload gather: the sparse step
        gathers only its lanes' rows.  ``"pallas"`` launches the
        select-only CUDA kernel."""
        hold = self._hold_mask(s)
        if self.ep.inbox_impl == "pallas":
            from oversim_tpu_torch.kernels import inbox as inbox_k
            return inbox_k.fused_select(s.pool, self.n, self.ep.inbox_slots,
                                        t_end, alive, hold)
        return pool_mod.build_inbox(s.pool, self.n, self.ep.inbox_slots,
                                    t_end, alive, impl=self.ep.inbox_impl,
                                    hold=hold)

    def _phase_active_compact(self, s: SimState, t_end, alive, pre_killed,
                              logic_state, inbox, delivered):
        """Compact the awake nodes into A lanes.

        A node is awake when it has inbox traffic this window, a due
        timer, or churn touched its slot this tick; every other node is a
        fixed point of the step.  The walk starts at ``tick % n`` so that
        awake nodes past the cap (which defer: their timers stay due and
        their selected messages stay pooled) take turns.  Returns ``(act
        [A] i32 lane -> node, sentinel n; delivered trimmed to the
        stepped destinations; (awake, active_dst, deferred) i64)``."""
        n, cap, dev = self.n, self.acap, self.device
        has_msg = inbox[:, 0] >= 0
        timer_due = alive & (self.logic.next_event(logic_state) < t_end)
        churned = (alive ^ s.alive) | (pre_killed & alive)
        awake = has_msg | timer_due | churned
        n_awake = torch.sum(awake.to(I32))
        off = (s.tick % n).to(I32)
        perm = (torch.arange(n, dtype=I32, device=dev) + off) % n
        aw_r = awake[perm.long()]
        from oversim_tpu_torch.kernels import compact as compact_k
        compact = (compact_k.compact_indices if self.ep.inbox_impl == "pallas"
                   else compact_k.compact_indices_plain)
        act, _ = compact(aw_r, perm, cap, n)
        taken = torch.zeros((n + 1,), dtype=torch.bool, device=dev).index_fill(
            0, act.long(), True)[:n]
        delivered = delivered & taken[torch.clamp(s.pool.dst, 0, n - 1).long()]
        active = (n_awake.to(I64), torch.sum(has_msg.to(I32)).to(I64),
                  (n_awake - torch.clamp(n_awake, max=cap)).to(I64))
        return act, delivered, active

    def _phase_sparse_step(self, s: SimState, t_next, t_end, alive,
                           pre_killed, churn_state, node_keys, ul_state,
                           logic_state, inbox, act, r_nodes, ov=None):
        """The logic's step over the A compacted lanes only, scattered
        back into full-width state.  Sentinel lanes (``act == n``) compute
        node n-1 and are dropped at every scatter; the outbox and event
        bases are zeros, which every consumer masks."""
        n = self.n
        ctx, node_part, glob, measuring = self._make_ctx(
            s, t_next, t_end, alive, pre_killed, churn_state, node_keys,
            logic_state, ul_state, ov)
        lane_ok = act < n
        act_c = torch.clamp(act, max=n - 1)
        rows = act_c.long()
        inbox_act = torch.where(lane_ok[:, None], inbox[rows], -1)
        gblk = s.pool.blk[torch.clamp(inbox_act, min=0).long()]
        msgs = self._msgs_from_block(s, t_next, inbox_act, gblk)
        part_act = tree.tree_map(lambda x: x[rows], node_part)
        part_act, out_f, out_v, out_o, ev = self._lanes_step(
            ctx, part_act, msgs, r_nodes, s.tick, act_c)

        dst = act.long()      # sentinel lanes land in the spare row n

        def scatter(base, upd):
            pad = base.new_zeros((1,) + tuple(base.shape[1:]))
            return torch.cat([base, pad]).index_copy_(0, dst, upd)[:n]

        def scatter_zeros(upd):
            return upd.new_zeros((n + 1,) + tuple(upd.shape[1:])).index_copy_(
                0, dst, upd)[:n]

        node_part = tree.tree_map(scatter, node_part, part_act)
        out_fields = tree.tree_map(scatter_zeros, out_f)
        events = tree.tree_map(scatter_zeros, ev)
        logic_state = self._finish_logic(ctx, node_part, glob, events)
        return (logic_state, out_fields, scatter_zeros(out_v),
                scatter_zeros(out_o), events, measuring)

    def _phase_alloc_stats(self, s, t_end, rng, r_send, alive, node_keys,
                           ul_state, churn_state, logic_state, delivered,
                           to_dead, out_fields, out_valid, out_overflow,
                           events, measuring, active=None):
        """Free delivered slots, send the outbox through the underlay into
        free pool slots, fold stats and engine counters (and the sparse
        tick's lane tallies ``active``), then the telemetry sample of the
        end-of-tick values."""
        n = self.n
        node_idx = torch.arange(n, dtype=I32, device=self.device)
        new_pool = pool_mod.free(s.pool, delivered | to_dead)
        src = node_idx[:, None].expand_as(out_valid)
        t_del, ok, ul_state, drops = self.ul.send_batch(
            ul_state, self.up, r_send, src, out_fields["dst"],
            out_fields["size_b"], out_fields["t_send"], out_valid, alive,
            kind=out_fields["kind"])
        flat = {k: v.reshape((-1,) + tuple(v.shape[2:]))
                for k, v in out_fields.items() if k != "t_send"}
        flat["t_deliver"] = t_del.reshape(-1)
        flat["src"] = src.reshape(-1)
        new_pool, pool_overflow = pool_mod.alloc(
            new_pool, flat, (out_valid & ok).reshape(-1),
            impl="pallas" if self.ep.inbox_impl == "pallas" else "scatter")

        new_stats = stats_mod.record(s.stats, events, measuring)
        c = dict(s.counters)
        c["queue_lost"] = c["queue_lost"] + drops["queue_lost"]
        c["bit_error_lost"] = c["bit_error_lost"] + drops["bit_error_lost"]
        c["partition_lost"] = c["partition_lost"] + drops["partition_lost"]
        c["dest_unavailable_lost"] = c["dest_unavailable_lost"] + (
            drops["dest_unavailable_lost"] + torch.sum(to_dead))
        c["pool_overflow"] = c["pool_overflow"] + pool_overflow
        c["outbox_overflow"] = c["outbox_overflow"] + torch.sum(
            out_overflow.to(I64))
        c["inbox_deferred"] = torch.maximum(
            c["inbox_deferred"],
            torch.sum(s.pool.valid & (s.pool.t_deliver < t_end))
            - torch.sum(delivered | to_dead))
        if active is not None:
            for name, v in zip(SPARSE_COUNTERS, active):
                c[name] = c[name] + v
        tel = telemetry_mod.fold(
            s.telemetry, self.ep.telemetry, t_end=t_end, tick=s.tick + 1,
            alive=alive, stats=new_stats, counters=c)
        return SimState(t_now=t_end, tick=s.tick + 1, rng=rng, alive=alive,
                        node_keys=node_keys, underlay=ul_state,
                        pool=new_pool, churn=churn_state,
                        malicious=s.malicious, logic=logic_state,
                        stats=new_stats, counters=c, telemetry=tel)

    @torch.no_grad()
    def step(self, s: SimState, ov=None) -> SimState:
        """One tick: the five phases composed.  ``ov``: a campaign row's
        sweep overrides ({dotted name: value}, see the module
        docstring), None for the static parameters.  Nothing here needs
        gradients, and without autograd's bookkeeping each of the tick's
        small ops costs the host less."""
        ov = self.device_ov(ov)
        if self.ep.tick_impl == "sparse":
            return self._step_sparse(s, ov)
        t_next, t_end, rngs = self._phase_horizon(s, ov)
        rng, r_churn, r_keys, r_reset, r_nodes, r_mig, r_send = rngs
        (churn_state, alive, pre_killed, node_keys, ul_state,
         logic_state) = self._phase_churn(s, t_next, t_end, r_churn, r_keys,
                                          r_reset, r_mig, ov)
        msgs, delivered, to_dead = self._phase_inbox(s, t_next, t_end, alive)
        (logic_state, out_fields, out_valid, out_overflow, events,
         measuring) = self._phase_node_step(
            s, t_next, t_end, alive, pre_killed, churn_state, node_keys,
            ul_state, logic_state, msgs, r_nodes, ov)
        return self._phase_alloc_stats(
            s, t_end, rng, r_send, alive, node_keys, ul_state, churn_state,
            logic_state, delivered, to_dead, out_fields, out_valid,
            out_overflow, events, measuring)

    def _step_sparse(self, s: SimState, ov=None) -> SimState:
        """One sparse tick: horizon, churn and alloc phases are the dense
        tick's; only the awake lanes step.  Leaf-equal to ``step`` when
        the awake count fits the cap (always at the auto cap for n <=
        64).  ``ov`` as ``step`` passes it (on the device already)."""
        t_next, t_end, rngs = self._phase_horizon(s, ov)
        rng, r_churn, r_keys, r_reset, r_nodes, r_mig, r_send = rngs
        (churn_state, alive, pre_killed, node_keys, ul_state,
         logic_state) = self._phase_churn(s, t_next, t_end, r_churn, r_keys,
                                          r_reset, r_mig, ov)
        inbox, delivered, to_dead = self._phase_inbox_select_sparse(
            s, t_end, alive)
        act, delivered, active = self._phase_active_compact(
            s, t_end, alive, pre_killed, logic_state, inbox, delivered)
        (logic_state, out_fields, out_valid, out_overflow, events,
         measuring) = self._phase_sparse_step(
            s, t_next, t_end, alive, pre_killed, churn_state, node_keys,
            ul_state, logic_state, inbox, act, r_nodes, ov)
        return self._phase_alloc_stats(
            s, t_end, rng, r_send, alive, node_keys, ul_state, churn_state,
            logic_state, delivered, to_dead, out_fields, out_valid,
            out_overflow, events, measuring, active=active)

    # -- run ----------------------------------------------------------------

    def run_chunk(self, s: SimState, n_ticks: int, ov=None) -> SimState:
        """``n_ticks`` ticks, enqueued without reading anything back."""
        ov = self.device_ov(ov)
        for _ in range(n_ticks):
            s = self.step(s, ov)
        return s

    def run_until(self, s: SimState, t_sim: float,
                  chunk: int = 256) -> SimState:
        """Whole chunks until simulated time reaches ``t_sim`` seconds;
        reads ``t_now`` back after every chunk."""
        target = int(t_sim * NS)
        while int(s.t_now) < target:
            s = self.run_chunk(s, chunk)
        return s

    def run_until_device(self, s: SimState, t_sim: float,
                         chunk: int = 256) -> SimState:
        """Same result as ``run_until`` at equal ``chunk``, without making
        the host wait on the chunk it just enqueued.

        Each chunk is gated on the device by ``t_now < target`` (a chunk
        that starts past the target leaves the state as it was), and the
        host decides whether to enqueue another chunk from the previous
        chunk's ``t_now``, copied back asynchronously — so the queue
        never drains between chunks; at most one gated chunk runs past
        the end."""
        target = int(t_sim * NS)
        cuda = self.device.type == "cuda"
        seen = None
        while True:
            if seen is not None:
                ev, t_host = seen
                if cuda:
                    ev.synchronize()
                if int(t_host) >= target:
                    return s
            active = s.t_now < target
            new = self.run_chunk(s, chunk)
            s = tree.tree_map(lambda a, b: torch.where(active, a, b), new, s)
            if cuda:
                t_host = torch.empty((), dtype=I64, pin_memory=True)
                t_host.copy_(s.t_now, non_blocking=True)
                ev = torch.cuda.Event()
                ev.record()
                seen = (ev, t_host)
            else:
                seen = (None, s.t_now.clone())

    def summary(self, s: SimState) -> dict:
        """Host-side end-of-run report, its statistics and counters in
        key order (the JAX package's pytree order, which its ``.vec`` and
        JSON outputs follow)."""
        out = stats_mod.summarize({k: s.stats[k] for k in sorted(s.stats)})
        out["_engine"] = {k: int(s.counters[k]) for k in sorted(s.counters)}
        out["_t_sim"] = float(s.t_now) / NS
        out["_ticks"] = int(s.tick)
        out["_alive"] = int(torch.sum(s.alive))
        return out
