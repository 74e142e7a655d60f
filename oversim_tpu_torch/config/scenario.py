"""Scenario builder: resolved .ini parameters -> a runnable Simulation.

Counterpart of ``oversim_tpu/config/scenario.py`` for everything the port
has.  The reference wires a simulation from string-configured module
types (``**.overlayType``, ``**.tier1Type``, ``churnGeneratorTypes`` —
simulations/default.ini:622-628) plus per-module parameter namespaces;
this module reads the same namespaces off an ``IniFile`` and builds the
port's typed params and logic objects, with the JAX package's defaults:

* churn: NoChurn, LifetimeChurn, ParetoChurn, RandomChurn, and a trace
  (``trace_events``) in place of the ini's generator;
* underlay: SimpleUnderlay and InetUnderlay / ReaSE (the ``network``
  line), with the trace's node-type partitions;
* apps: KBRTestApp, DHT / DHTTestApp (also forced by a trace), NTree,
  TierDummy / MyApplication, Scribe / ALMTest, SimMud, P2PNS and
  BroadcastTestApp, several of them as a TierStack;
* overlays: Chord, Kademlia, Pastry, Bamboo, Koorde, Broose, EpiChord,
  GIA, NICE, Quon, Vast, NTree (NTreeApp over Chord) and PubSubMMOG
  (picked by substring, as the JAX package's scenario.py does, EpiChord
  tested before Chord);
* the framework's ini extensions ``**.inboxImpl``, ``**.tickImpl``,
  ``**.activeCap``, ``**.telemetry.*``, ``**.campaign.*`` and
  ``**.service.*``.

What the port has not ported raises ``NotImplementedError`` naming
ROADMAP: the i3 tier apps, ``**.nodeCoordinateSource`` and malicious
nodes (the overlays refuse them).  ``**.routingType`` builds what the JAX
builder builds: it picks the lookup's exhaustive and proximity-aware
modes, and a recursive value maps to no RouteConfig (Chord, Kademlia
and EpiChord then look up iteratively; Pastry keeps its own
semi-recursive default).  There is
no fallback: ``**.inboxImpl = "pallas"`` builds a simulation that
launches the CUDA kernels on a CUDA device, or raises; on the CPU it
runs their plain versions.  ``device`` says where the simulation runs:
the card unless the caller asks for the CPU.
"""

from __future__ import annotations

import dataclasses

from oversim_tpu_torch import churn as churn_mod
from oversim_tpu_torch.apps import kbrtest
from oversim_tpu_torch.common import lookup as lk_mod
from oversim_tpu_torch.config.ini import IniFile, Study
from oversim_tpu_torch.core import keys as K
from oversim_tpu_torch.engine import sim as sim_mod
from oversim_tpu_torch.underlay import simple as underlay_mod

HOST = "OverSim.overlayTerminal[0]"   # representative node path
ROADMAP = "not ported yet (ROADMAP Queue A)"


def _value(x, default=None):
    if isinstance(x, Study):
        x = x.default()
    return default if x is None else x


class ScenarioError(ValueError):
    pass


def resolve_inbox_impl(value: str) -> str:
    """A raw ``**.inboxImpl`` string -> the impl the engine runs:
    ``"scatter"`` (torch ops, the default), ``"pallas"`` (the hand-written
    CUDA kernels; the name is the JAX package's, and it never falls back
    to ``"scatter"``) or ``"sort"`` (oracle only: a stderr note outside
    pytest).  Anything else raises :class:`ScenarioError`."""
    import os
    import sys

    impl = str(value).strip().strip('"')
    if impl not in ("scatter", "sort", "pallas"):
        raise ScenarioError(f"unsupported inboxImpl: {impl!r} "
                            "(expected \"scatter\", \"pallas\" or "
                            "\"sort\")")
    if impl == "sort" and "PYTEST_CURRENT_TEST" not in os.environ:
        print("oversim-tpu-torch: inboxImpl \"sort\" is oracle-only; use "
              "\"scatter\" (default) or \"pallas\" (the CUDA kernels)",
              file=sys.stderr)
    return impl


def resolve_tick_impl(value: str) -> str:
    """A raw ``**.tickImpl`` string -> ``"dense"`` or ``"sparse"``;
    anything else raises :class:`ScenarioError`."""
    impl = str(value).strip().strip('"')
    if impl not in ("dense", "sparse"):
        raise ScenarioError(f"unsupported tickImpl: {impl!r} "
                            "(expected \"dense\" or \"sparse\")")
    return impl


def _get(ini, config, suffix, default=None):
    return _value(ini.get(f"{HOST}.{suffix}", config), default)


def build_churn(ini: IniFile, config: str) -> churn_mod.ChurnParams:
    gen = str(ini.get("OverSim.churnGenerator[0].__type__", config)
              or _value(ini.get("**.churnGeneratorTypes", config),
                        "oversim.common.NoChurn"))
    target = int(_value(ini.get("**.targetOverlayTerminalNum", config), 10))
    init_interval = float(_value(
        ini.get("**.initPhaseCreationInterval", config), 0.1))
    model = ("lifetime" if "LifetimeChurn" in gen
             else "pareto" if "ParetoChurn" in gen
             else "random" if "RandomChurn" in gen
             else "none")
    kw = {}
    if model in ("lifetime", "pareto"):
        kw["lifetime_mean"] = float(_value(
            ini.get("**.lifetimeMean", config), 10000.0))
        kw["lifetime_dist"] = str(_value(
            ini.get("**.lifetimeDistName", config), "weibull"))
        kw["lifetime_par1"] = float(_value(
            ini.get("**.lifetimeDistPar1", config), 1.0))
    if model == "pareto":
        dm = ini.get("**.deadtimeMean", config)
        if dm is not None:
            kw["deadtime_mean"] = float(_value(dm))
    return churn_mod.ChurnParams(
        model=model, target_num=target, init_interval=init_interval, **kw)


def build_underlay(ini: IniFile, config: str):
    """(params, module): the ``network`` line picks the underlay family,
    SimpleUnderlay or the router topology of InetUnderlay / ReaSE
    (``underlay/inet.py``, with ``**.accessRouterNum`` routers);
    ``**.nodeCoordinateSource`` raises."""
    net = str(_value(ini.get("network", config), "")).lower()
    if "inet" in net or "rease" in net:
        from oversim_tpu_torch.underlay import inet as inet_mod
        params = inet_mod.InetUnderlayParams(
            topology="rease" if "rease" in net else "inet",
            routers=int(_value(
                ini.get("**.accessRouterNum", config), 16)),
            send_queue_bytes=int(_value(
                ini.get("**.sendQueueLength", config), 1_000_000)),
        )
        return params, inet_mod
    coord_src = str(_value(
        ini.get("**.nodeCoordinateSource", config), "")).strip('"')
    if coord_src:
        raise NotImplementedError(
            f"**.nodeCoordinateSource = {coord_src!r}: coordinate pools are "
            f"{ROADMAP}")
    params = underlay_mod.UnderlayParams(
        field_size=float(_value(ini.get("**.fieldSize", config), 150.0)),
        send_queue_bytes=int(_value(
            ini.get("**.sendQueueLength", config), 1_000_000)),
        constant_delay=float(_value(
            ini.get("**.constantDelay", config), 0.050)),
        use_coordinate_based_delay=bool(_value(
            ini.get("**.useCoordinateBasedDelay", config), True)),
    )
    return params, underlay_mod


def _build_dht(ini, config, spec, trace, num_slots=0):
    from oversim_tpu_torch.apps.dht import DhtApp, DhtParams
    return DhtApp(DhtParams(
        num_replica=int(_get(ini, config, "tier1.dht.numReplica", 4)),
        num_get_requests=int(_get(
            ini, config, "tier1.dht.numGetRequests", 4)),
        ratio_identical=float(_get(
            ini, config, "tier1.dht.ratioIdentical", 0.5)),
        test_interval=float(_get(
            ini, config, "tier2.dhtTestApp.testInterval", 60.0)),
        test_ttl=float(_get(
            ini, config, "tier2.dhtTestApp.testTtl", 300.0)),
    ), spec, trace=trace)


def _build_kbrtest(ini, config, spec, trace, num_slots=0):
    from oversim_tpu_torch.apps.kbrtest import KbrTestApp
    return KbrTestApp(kbrtest.KbrTestParams(
        test_interval=float(_get(
            ini, config, "tier1.kbrTestApp.testMsgInterval", 60.0)),
        test_msg_bytes=int(_get(
            ini, config, "tier1.kbrTestApp.testMsgSize", 100)),
        oneway_test=bool(_get(
            ini, config, "tier1.kbrTestApp.kbrOneWayTest", True)),
        rpc_test=bool(_get(
            ini, config, "tier1.kbrTestApp.kbrRpcTest", False)),
        lookup_test=bool(_get(
            ini, config, "tier1.kbrTestApp.kbrLookupTest", False)),
    ))


def _build_scribe(ini, config, spec, trace, num_slots):
    from oversim_tpu_torch.apps.scribe import ScribeApp, ScribeParams
    return ScribeApp(ScribeParams(
        num_groups=int(_get(ini, config, "tier2.almTest.groupNum", 4)),
    ), spec)


def _build_simmud(ini, config, spec, trace, num_slots):
    from oversim_tpu_torch.apps.simmud import SimMudApp, SimMudParams
    return SimMudApp(SimMudParams(), spec)


def _build_p2pns(ini, config, spec, trace, num_slots):
    # the JAX builder passes no num_slots, so P2pnsApp raises there
    # (ROADMAP Queue C); the port sizes the name table to the slots
    from oversim_tpu_torch.apps.p2pns import P2pnsApp
    return P2pnsApp(spec=spec, num_slots=num_slots)


def _build_ntree_app(ini, config, spec, trace, num_slots):
    from oversim_tpu_torch.apps.ntree import NTreeApp
    return NTreeApp(spec=spec)


def _build_broadcast(ini, config, spec, trace, num_slots):
    from oversim_tpu_torch.apps.broadcast import BroadcastTestApp
    return BroadcastTestApp()


def _build_dummy(ini, config, spec, trace, num_slots):
    from oversim_tpu_torch.apps.dummy import TierDummyApp
    return TierDummyApp()


def _not_ported(name):
    def build(ini, config, spec, trace, num_slots):
        raise NotImplementedError(f"tier app {name}: {ROADMAP} 14(e)'")
    return build


# substring -> factory, first match wins; entries absorbing a second
# tier list the partner substrings they consume (the JAX table)
_TIER_FACTORIES = (
    ("KBRTestApp", _build_kbrtest, ()),
    ("DHTTestApp", _build_dht, ("DHT",)),      # tier2 naming the pair
    ("DHT", _build_dht, ("DHTTestApp",)),      # tier1 DHT + tier2 tester
    ("SimMud", _build_simmud, ("Scribe",)),
    ("Scribe", _build_scribe, ("ALMTest",)),
    ("ALMTest", _build_scribe, ("Scribe",)),
    ("I3", _not_ported("I3"), ()),
    ("P2pns", _build_p2pns, ()),
    ("P2PNS", _build_p2pns, ()),
    ("NTree", _build_ntree_app, ()),
    ("Broadcast", _build_broadcast, ()),
    ("TierDummy", _build_dummy, ()),
    ("MyApplication", _build_dummy, ()),
)


def build_app(ini: IniFile, config: str, spec: K.KeySpec, trace=None,
              num_slots: int = 0):
    """tier1Type/tier2Type/tier3Type strings -> one app object (the JAX
    package's matching: every tier scanned before fused pairs such as DHT
    + DHTTestApp or Scribe + ALMTest collapse to one).  Several distinct
    apps compose into an ``apps/stack.py`` TierStack.  ``trace`` (a
    trace.TraceWorkload) forces a DHT tier, as the reference's trace
    manager does; ``num_slots`` sizes P2PNS's name table."""
    tiers = [str(_value(ini.get(f"**.tier{i}Type", config), ""))
             for i in (1, 2, 3)]
    matched = []
    for tname in tiers:
        if not tname or tname in ("\"\"",):
            continue
        for sub, factory, absorbs in _TIER_FACTORIES:
            if sub in tname:
                matched.append((sub, factory, absorbs))
                break
    uniq, seen_fac = [], set()
    for sub, factory, absorbs in matched:
        if factory not in seen_fac:
            uniq.append((sub, factory, absorbs))
            seen_fac.add(factory)
    # an entry another surviving entry absorbs is that entry's lower
    # half (Scribe under SimMud): drop it
    apps = [factory(ini, config, spec, trace, num_slots)
            for sub, factory, absorbs in uniq
            if not any(sub in o[2] for o in uniq if o[1] is not factory)]
    if trace is not None and not any(
            type(a).__name__ == "DhtApp" for a in apps):
        apps.insert(0, _build_dht(ini, config, spec, trace, num_slots))
    if not apps:
        return _build_kbrtest(ini, config, spec, trace, num_slots)
    if len(apps) == 1:
        return apps[0]
    from oversim_tpu_torch.apps.stack import TierStack
    return TierStack(apps)


def build_malicious(ini: IniFile, config: str):
    """maliciousNodeProbability + attack switches -> MaliciousParams (the
    port's overlays refuse a probability above 0)."""
    from oversim_tpu_torch.common.malicious import MaliciousParams
    return MaliciousParams(
        probability=float(_value(
            ini.get("**.maliciousNodeProbability", config), 0.0)),
        drop_find_node=bool(_get(
            ini, config, "overlay.dropFindNodeAttack", False)),
        is_sibling=bool(_get(
            ini, config, "overlay.isSiblingAttack", False)),
        invalid_nodes=bool(_get(
            ini, config, "overlay.invalidNodesAttack", False)),
    )


def build_lookup_config(ini: IniFile, config: str, proto: str,
                        merge_default: bool) -> lk_mod.LookupConfig:
    ns = f"overlay.{proto}"
    paths = int(_get(ini, config, f"{ns}.lookupParallelPaths", 1))
    rpcs = int(_get(ini, config, f"{ns}.lookupParallelRpcs", 1))
    # a recursive routingType builds no RouteConfig, as in the JAX
    # builder (ROADMAP Queue C)
    rt = str(_value(ini.get("**.routingType", config),
                    "iterative")).strip('"')
    return lk_mod.LookupConfig(
        merge=bool(_get(ini, config, f"{ns}.lookupMerge", merge_default)),
        parallel_rpcs=max(1, paths * rpcs),
        retries=int(_get(ini, config, f"{ns}.lookupRetries", 0)),
        exhaustive=rt == "exhaustive-iterative",
        prox_aware=rt == "prox-aware-iterative",
        rpc_timeout_ns=int(float(_value(
            ini.get("**.rpcUdpTimeout", config), 1.5)) * 1e9),
    )


def build_telemetry(ini: IniFile, config: str):
    """``**.telemetry.sampleTicks`` (0 = off), ``.window`` and
    ``.include`` -> TelemetryParams."""
    from oversim_tpu_torch import telemetry as telemetry_mod
    sample_ticks = int(_value(
        ini.get("**.telemetry.sampleTicks", config), 0))
    if sample_ticks < 0:
        raise ScenarioError(f"**.telemetry.sampleTicks must be >= 0, "
                            f"got {sample_ticks}")
    window = int(_value(ini.get("**.telemetry.window", config), 256))
    if sample_ticks > 0 and window < 1:
        raise ScenarioError(f"**.telemetry.window must be >= 1, "
                            f"got {window}")
    raw = _value(ini.get("**.telemetry.include", config), "")
    include = tuple(str(raw).strip().strip('"').replace(",", " ").split())
    return telemetry_mod.TelemetryParams(
        sample_ticks=sample_ticks, window=window, include=include)


def _trace_parts(trace_events, up, spec):
    """(churn params, workload, underlay params with the partitions) of
    a parsed trace: the slots split evenly into max(type) + 1 types."""
    from oversim_tpu_torch import trace as trace_mod
    cp = trace_mod.churn_from_trace(trace_events)
    workload = trace_mod.workload_from_trace(trace_events, cp.num_slots,
                                             spec)
    ps = trace_mod.partitions_from_trace(trace_events)
    if len(ps.t):
        ntypes = int(max(ps.a.max(), ps.b.max())) + 1
        bounds = tuple(cp.num_slots * i // ntypes for i in range(1, ntypes))
        up = dataclasses.replace(
            up, num_node_types=ntypes, type_boundaries=bounds,
            partition_events=tuple(
                (float(t), int(a), int(b), bool(c))
                for t, a, b, c in zip(ps.t, ps.a, ps.b, ps.connect)))
    return cp, workload, up


def build_engine_params(ini: IniFile, config: str, mp=None):
    """The engine knobs the ini sets (the rest keep EngineParams'
    defaults: window 0.01 s, 8 inbox and 16 outbox slots)."""
    return sim_mod.EngineParams(
        transition_time=float(_value(
            ini.get("**.transitionTime", config), 0.0)),
        measurement_time=float(_value(
            ini.get("**.measurementTime", config), -1.0)),
        inbox_impl=resolve_inbox_impl(_value(
            ini.get("**.inboxImpl", config), "scatter")),
        tick_impl=resolve_tick_impl(_value(
            ini.get("**.tickImpl", config), "dense")),
        active_cap=int(_value(ini.get("**.activeCap", config), 0)),
        malicious=mp if mp is not None else build_malicious(ini, config),
        telemetry=build_telemetry(ini, config),
    )


def build_simulation(ini: IniFile, config: str = "General",
                     engine_params: sim_mod.EngineParams | None = None,
                     trace_events=None, device="cuda"):
    """The Simulation of one [Config ...] section on ``device``.

    ``trace_events`` (parsed ``trace.TraceEvent`` list) replaces the churn
    model with the trace's schedule, drives a DHT from its PUT/GET
    commands and applies its CONNECT/DISCONNECT_NODETYPES partitions.
    ``engine_params`` replaces the ini's engine knobs whole."""
    overlay_type = str(_value(ini.get("**.overlayType", config), ""))
    spec = K.KeySpec(int(_value(ini.get("**.keyLength", config), 160)))
    up, ul_mod = build_underlay(ini, config)
    workload = None
    if trace_events is not None:
        cp, workload, up = _trace_parts(trace_events, up, spec)
    else:
        cp = build_churn(ini, config)
    ap = build_app(ini, config, spec, trace=workload,
                   num_slots=cp.num_slots)
    mp = build_malicious(ini, config)
    # bad impl values are refused even when engine_params replaces the
    # ini's knobs, as in the JAX builder
    resolve_inbox_impl(_value(ini.get("**.inboxImpl", config), "scatter"))
    resolve_tick_impl(_value(ini.get("**.tickImpl", config), "dense"))
    ep = engine_params or build_engine_params(ini, config, mp)
    kind = overlay_type.lower()
    if "epichord" in kind:
        from oversim_tpu_torch.overlay.epichord import (EpiChordLogic,
                                                        EpiChordParams)
        params = EpiChordParams(
            succ_size=int(_get(
                ini, config, "overlay.epichord.successorListSize", 4)),
            join_delay=float(_get(
                ini, config, "overlay.epichord.joinDelay", 10.0)),
            stabilize_delay=float(_get(
                ini, config, "overlay.epichord.stabilizeDelay", 20.0)),
            cache_flush_delay=float(_get(
                ini, config, "overlay.epichord.cacheFlushDelay", 20.0)),
            cache_check_mult=int(_get(
                ini, config, "overlay.epichord.cacheCheckMultiplier", 3)),
            cache_ttl=float(_get(
                ini, config, "overlay.epichord.cacheTTL", 120.0)),
            nodes_per_slice=int(_get(
                ini, config, "overlay.epichord.nodesPerSlice", 2)),
            redundant_nodes=int(_get(
                ini, config, "overlay.epichord.lookupRedundantNodes", 3)),
        )
        logic = EpiChordLogic(spec, params,
                              build_lookup_config(ini, config, "epichord",
                                                  True), ap)
    elif "chord" in kind:
        from oversim_tpu_torch.overlay.chord import ChordLogic, ChordParams
        params = ChordParams(
            join_delay=float(_get(ini, config, "overlay.chord.joinDelay",
                                  10.0)),
            stabilize_delay=float(_get(
                ini, config, "overlay.chord.stabilizeDelay", 20.0)),
            fixfingers_delay=float(_get(
                ini, config, "overlay.chord.fixfingersDelay", 120.0)),
            check_pred_delay=float(_get(
                ini, config, "overlay.chord.checkPredecessorDelay", 5.0)),
            succ_size=int(_get(
                ini, config, "overlay.chord.successorListSize", 8)),
            aggressive_join=bool(_get(
                ini, config, "overlay.chord.aggressiveJoinMode", True)),
        )
        logic = ChordLogic(spec, params,
                           build_lookup_config(ini, config, "chord", False),
                           ap, mparams=mp)
    elif "kademlia" in kind:
        from oversim_tpu_torch.overlay.kademlia import (KademliaLogic,
                                                        KademliaParams)
        params = KademliaParams(
            k=int(_get(ini, config, "overlay.kademlia.k", 8)),
            s=int(_get(ini, config, "overlay.kademlia.s", 8)),
            max_stale=int(_get(
                ini, config, "overlay.kademlia.maxStaleCount", 0)),
            sibling_refresh=float(_get(
                ini, config,
                "overlay.kademlia.minSiblingTableRefreshInterval", 1000.0)),
            bucket_refresh=float(_get(
                ini, config,
                "overlay.kademlia.minBucketRefreshInterval", 1000.0)),
            redundant_nodes=int(_get(
                ini, config, "overlay.kademlia.lookupRedundantNodes", 8)),
        )
        logic = KademliaLogic(spec, params,
                              build_lookup_config(ini, config, "kademlia",
                                                  True), ap, mparams=mp)
    elif "pastry" in kind or "bamboo" in kind:
        from oversim_tpu_torch.overlay.pastry import (BambooLogic,
                                                      PastryLogic,
                                                      PastryParams)
        proto = "bamboo" if "bamboo" in kind else "pastry"
        params = PastryParams(
            bits_per_digit=int(_get(
                ini, config, f"overlay.{proto}.bitsPerDigit", 4)),
            num_leaves=int(_get(
                ini, config, f"overlay.{proto}.numberOfLeaves",
                8 if proto == "bamboo" else 16)),
            join_delay=int(_get(
                ini, config, f"overlay.{proto}.joinTimeout", 20)),
        )
        cls = BambooLogic if proto == "bamboo" else PastryLogic
        logic = cls(spec, params,
                    build_lookup_config(ini, config, proto, False), ap)
    elif "koorde" in kind:
        from oversim_tpu_torch.overlay.koorde import KoordeLogic, KoordeParams
        params = KoordeParams(
            stabilize_delay=float(_get(
                ini, config, "overlay.koorde.stabilizeDelay", 10.0)),
            succ_size=int(_get(
                ini, config, "overlay.koorde.successorListSize", 16)),
            de_bruijn_delay=float(_get(
                ini, config, "overlay.koorde.deBruijnDelay", 30.0)),
            de_bruijn_size=int(_get(
                ini, config, "overlay.koorde.deBruijnListSize", 16)),
            shifting_bits=int(_get(
                ini, config, "overlay.koorde.shiftingBits", 4)),
        )
        logic = KoordeLogic(spec, params, app=ap)
    elif "broose" in kind:
        from oversim_tpu_torch.overlay.broose import BrooseLogic, BrooseParams
        params = BrooseParams(
            bucket_size=int(_get(
                ini, config, "overlay.broose.bucketSize", 8)),
            r_bucket_size=int(_get(
                ini, config, "overlay.broose.rBucketSize", 8)),
            # the reference's odd key for Broose's shifting bits
            shifting_bits=int(_value(
                ini.get("**.brooseShiftingBits", config), 2)),
            join_delay=float(_get(
                ini, config, "overlay.broose.joinDelay", 10.0)),
            refresh_time=float(_get(
                ini, config, "overlay.broose.refreshTime", 180.0)),
        )
        logic = BrooseLogic(spec, params, app=ap)
    elif "gia" in kind:
        from oversim_tpu_torch.overlay.gia import GiaLogic, GiaParams
        params = GiaParams(
            min_neighbors=int(_get(
                ini, config, "overlay.gia.minNeighbors", 3)),
            max_neighbors=int(_get(
                ini, config, "overlay.gia.maxNeighbors", 10)),
            adapt_interval=float(_get(
                ini, config, "overlay.gia.maxTopAdaptionInterval", 10.0)),
            search_ttl=int(_get(
                ini, config, "overlay.gia.maxHopCount", 20)),
            max_responses=int(_get(
                ini, config, "overlay.gia.maxResponses", 1)),
            token_wait=float(_get(
                ini, config, "overlay.gia.tokenWaitTime", 1.0)),
        )
        logic = GiaLogic(spec, params)
    elif "nice" in kind:
        from oversim_tpu_torch.overlay.nice import NiceLogic, NiceParams
        logic = NiceLogic(spec, NiceParams(
            k=int(_get(ini, config, "overlay.nice.k", 3)),
            hb_interval=float(_get(
                ini, config, "overlay.nice.heartbeatInterval", 5.0)),
            maint_interval=float(_get(
                ini, config, "overlay.nice.maintenanceInterval", 3.3)),
            query_interval=float(_get(
                ini, config, "overlay.nice.queryInterval", 2.0)),
            peer_timeout_hbs=float(_get(
                ini, config, "overlay.nice.peerTimeoutHeartbeats", 3.0))))
    elif "quon" in kind:
        from oversim_tpu_torch.overlay.quon import QuonLogic, QuonParams
        logic = QuonLogic(spec, QuonParams(
            aoi=float(_get(ini, config, "overlay.quon.AOIWidth", 100.0))))
    elif "vast" in kind:
        from oversim_tpu_torch.overlay.vast import VastLogic, VastParams
        logic = VastLogic(spec, VastParams(
            aoi=float(_get(ini, config, "overlay.vast.AOIWidth", 100.0))))
    elif "ntree" in kind:
        # NTree runs as a tier app over Chord (rendezvous-hashed cell
        # leadership, apps/ntree.py): the reference's NTreeModules
        from oversim_tpu_torch.apps.ntree import NTreeApp, NTreeParams
        from oversim_tpu_torch.overlay.chord import ChordLogic
        logic = ChordLogic(spec, app=NTreeApp(NTreeParams(
            max_children=int(_value(ini.get("**.maxChildren", config), 5))),
            spec=spec))
    elif "pubsub" in kind:
        from oversim_tpu_torch.overlay.pubsubmmog import (PubSubMMOGLogic,
                                                          PubSubParams)
        logic = PubSubMMOGLogic(spec, PubSubParams(
            field=float(_get(
                ini, config, "overlay.pubsubmmog.areaDimension", 1000.0)),
            grid=int(_get(
                ini, config, "overlay.pubsubmmog.numSubspaces", 4)),
            aoi=float(_get(ini, config, "overlay.pubsubmmog.AOIWidth", 100.0)),
            move_rate=float(_get(
                ini, config, "overlay.pubsubmmog.movementRate", 2.0)),
            parent_timeout=float(_get(
                ini, config, "overlay.pubsubmmog.parentTimeout", 2.0)),
            max_move_delay=float(_get(
                ini, config, "overlay.pubsubmmog.maxMoveDelay", 1.0)),
            max_children=int(_get(
                ini, config, "overlay.pubsubmmog.maxChildren", 12))))
    else:
        raise ScenarioError(f"unsupported overlayType: {overlay_type!r}")
    return sim_mod.Simulation(logic, cp, up, ep, underlay_module=ul_mod,
                              device=device)


# -- campaign (multi-replica) configuration ----------------------------------
#
#   **.campaign.replicas  = 8            seed replicas per grid point
#   **.campaign.baseSeed  = 1            replica r rng = fold_in(seed, r)
#   **.campaign.sweep.lifetimeMean    = "5000 10000 20000"
#   **.campaign.sweep.testMsgInterval = "10, 60"
#   **.campaign.sweep.window          = "0.05 0.1"

_SWEEP_KEYS = (
    ("**.campaign.sweep.lifetimeMean", "churn.lifetimeMean"),
    ("**.campaign.sweep.testMsgInterval", "app.testMsgInterval"),
    ("**.campaign.sweep.window", "engine.window"),
)


def _sweep_values(raw, key):
    s = str(raw).strip().strip('"')
    try:
        vals = tuple(float(x) for x in s.replace(",", " ").split())
    except ValueError:
        vals = ()
    if not vals:
        raise ScenarioError(f"bad sweep value list for {key}: {raw!r}")
    return vals


def build_campaign_params(ini: IniFile, config: str = "General"):
    """``**.campaign.*`` keys -> CampaignParams."""
    from oversim_tpu_torch.campaign import CampaignParams
    replicas = int(_value(ini.get("**.campaign.replicas", config), 1))
    if replicas < 1:
        raise ScenarioError(f"**.campaign.replicas must be >= 1, "
                            f"got {replicas}")
    base_seed = int(_value(ini.get("**.campaign.baseSeed", config), 1))
    sweep = []
    for ini_key, ov_name in _SWEEP_KEYS:
        raw = _value(ini.get(ini_key, config))
        if raw is None:
            continue
        sweep.append((ov_name, _sweep_values(raw, ini_key)))
    return CampaignParams(replicas=replicas, base_seed=base_seed,
                          sweep=tuple(sweep))


def build_campaign(ini: IniFile, config: str = "General",
                   engine_params: sim_mod.EngineParams | None = None,
                   trace_events=None, device="cuda"):
    """build_simulation + ``**.campaign.*`` keys -> a Campaign."""
    from oversim_tpu_torch.campaign import Campaign
    sim = build_simulation(ini, config, engine_params=engine_params,
                           trace_events=trace_events, device=device)
    return Campaign(sim, build_campaign_params(ini, config))


def build_service(ini: IniFile, config: str = "General"):
    """``**.service.*`` keys -> ServiceParams (windowSimS, chunk,
    checkpointEvery, checkpointPath, maxWindows, maxWallS, doubleBuffer,
    realtime)."""
    from oversim_tpu_torch.service import ServiceParams
    window_sim_s = float(_value(
        ini.get("**.service.windowSimS", config), 1.0))
    if window_sim_s <= 0:
        raise ScenarioError(f"**.service.windowSimS must be > 0, "
                            f"got {window_sim_s}")
    chunk = int(_value(ini.get("**.service.chunk", config), 32))
    if chunk < 1:
        raise ScenarioError(f"**.service.chunk must be >= 1, got {chunk}")
    ckpt_every = int(_value(
        ini.get("**.service.checkpointEvery", config), 0))
    if ckpt_every < 0:
        raise ScenarioError(f"**.service.checkpointEvery must be >= 0, "
                            f"got {ckpt_every}")
    raw_path = _value(ini.get("**.service.checkpointPath", config))
    ckpt_path = (None if raw_path is None
                 else str(raw_path).strip().strip('"') or None)
    if ckpt_every > 0 and ckpt_path is None:
        raise ScenarioError("**.service.checkpointEvery set without a "
                            "**.service.checkpointPath")
    max_windows = int(_value(ini.get("**.service.maxWindows", config), 0))
    if max_windows < 0:
        raise ScenarioError(f"**.service.maxWindows must be >= 0, "
                            f"got {max_windows}")
    max_wall_s = float(_value(ini.get("**.service.maxWallS", config), 0.0))
    dbuf = bool(_value(ini.get("**.service.doubleBuffer", config), True))
    realtime = bool(_value(ini.get("**.service.realtime", config), False))
    return ServiceParams(
        window_sim_s=window_sim_s, chunk=chunk,
        checkpoint_every=ckpt_every, checkpoint_path=ckpt_path,
        max_windows=max_windows, max_wall_s=max_wall_s,
        double_buffer=dbuf, realtime=realtime)
