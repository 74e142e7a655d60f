"""The ini front end: ``config/ini.py`` and ``config/scenario.py`` of the
port against the JAX package's, on the same ini texts.

(a) ``parse_value`` literals (units, booleans, quoted strings, ``${...}``
    studies) and ``IniFile`` resolution — ``include``, ``extends`` chains,
    ``*`` vs ``**``, ``configs``, ``study_variables``,
    ``expand_study_runs`` — give equal values;
(b) the built parameters are equal field for field: ``ChurnParams``
    (NoChurn, LifetimeChurn with pareto_shifted, ParetoChurn,
    RandomChurn), ``UnderlayParams``, ``EngineParams`` (impls, active cap,
    telemetry, malicious), the overlay's params and ``LookupConfig``, the
    app's params, ``CampaignParams`` and ``ServiceParams``;
(c) the same bad ``inboxImpl`` / ``tickImpl`` / telemetry / campaign /
    service values raise ``ScenarioError`` in both;
(d) ``resolve_inbox_impl("pallas")`` is ``"pallas"`` whatever the host
    has: the port has no fallback to ``"scatter"``;
(e) what the port has not ported (other overlays and apps, coordinate
    pools, exhaustive routing, a tier stack) raises naming ROADMAP.

Building a JAX Simulation compiles nothing, so both packages run in this
process.
"""

import dataclasses
import textwrap

import pytest
import torch

from oversim_tpu.config import ini as jini
from oversim_tpu.config import scenario as jsc
from oversim_tpu_torch.config import ini as tini
from oversim_tpu_torch.config import scenario as tsc
from test_config import INI

torch.set_num_threads(1)

KAD = '"oversim.overlay.kademlia.KademliaModules"'
EXTRA = textwrap.dedent(f"""
    include ./base.ini
    [Config Pareto]
    **.overlayType = {KAD}
    **.churnGeneratorTypes = "oversim.common.ParetoChurn"
    **.targetOverlayTerminalNum = 40
    **.initPhaseCreationInterval = 20ms
    **.lifetimeMean = 1000s
    **.deadtimeMean = 0.5h
    **.tier1Type = "oversim.applications.kbrtestapp.KBRTestAppModules"
    **.tier1*.kbrTestApp.testMsgInterval = 0.2s
    **.tier1*.kbrTestApp.kbrRpcTest = true
    **.inboxImpl = "pallas"
    **.telemetry.sampleTicks = 4
    **.telemetry.include = "kbr_hopcount, kbr_delivery"
    **.transitionTime = 100s
    **.measurementTime = 1000s

    [Config Random]
    extends = Pareto
    **.churnGeneratorTypes = "oversim.common.RandomChurn"
    **.inboxImpl = "scatter"
    **.tickImpl = "sparse"

    [Config Shifted]
    extends = Pareto
    **.churnGeneratorTypes = "oversim.common.LifetimeChurn"
    **.lifetimeDistName = "pareto_shifted"
    **.lifetimeDistPar1 = 3
    **.overlay*.kademlia.lookupParallelRpcs = ${{rpcs=1,3}}
    **.overlay*.kademlia.s = ${{4..8 step 4}}
    **.campaign.replicas = 3
    **.campaign.baseSeed = 7
    **.campaign.sweep.lifetimeMean = "100, 1000"
    **.campaign.sweep.window = "0.05 0.1"
    **.service.windowSimS = 0.5
    **.service.chunk = 5
    **.service.checkpointEvery = 2
    **.service.checkpointPath = "ck.npz"

    [Config Dht]
    **.overlayType = "oversim.overlay.chord.ChordModules"
    **.tier1Type = "oversim.applications.dht.DHTModules"
    **.tier2Type = "oversim.tier2.dhttestapp.DHTTestAppModules"
    **.tier1*.dht.numReplica = 3
    **.tier2*.dhtTestApp.testInterval = 20s
    **.keyLength = 100
    **.fieldSize = 200
    **.sendQueueLength = 500KB
    **.rpcUdpTimeout = 2s

    [Config Dummy]
    extends = Dht
    **.tier1Type = "oversim.applications.myapplication.MyApplication"
    **.tier2Type = ""
""")
BASE = "**.overlay*.chord.joinDelay = 7s\n**.constantDelay = 30ms\n"
BAD = textwrap.dedent("""
    [Config NegTel]
    **.overlayType = "oversim.overlay.kademlia.KademliaModules"
    **.telemetry.sampleTicks = -1
    [Config Zero]
    **.campaign.replicas = 0
    **.service.windowSimS = 0
    [Config NoPath]
    **.service.checkpointEvery = 2
    [Config BadSweep]
    **.campaign.sweep.window = "fast"
""")


def load(pkg, tmp_path):
    (tmp_path / "base.ini").write_text(BASE)
    (tmp_path / "main.ini").write_text(INI + EXTRA + BAD)
    return pkg.IniFile.load(tmp_path / "main.ini")


def same(a, b, what):
    """Equal field for field (the port's fields, each also JAX's)."""
    if dataclasses.is_dataclass(a):
        for f in dataclasses.fields(b):
            same(getattr(a, f.name), getattr(b, f.name), f"{what}.{f.name}")
        return
    assert type(a) is type(b) and a == b, (what, a, b)


def test_parse_value_literals_and_studies():
    for raw in ("true", "FALSE", "42", "-7", "0.5", "1e-3", '"iterative"',
                '"a#b"', "60s", "20ms", "3us", "2m", "1h", "100B", "2KiB",
                "500KB", "10Mbps", "7foo", "bare.Name", "${50,100,200}",
                "${N=1..5 step 2}", "${x=0.1..0.3 step 0.1}", "${a,b}"):
        a, b = jini.parse_value(raw), tini.parse_value(raw)
        if isinstance(a, jini.Study):
            assert (a.name, a.values) == (b.name, b.values), raw
        else:
            assert type(a) is type(b) and a == b, raw


def test_resolution_includes_extends_and_studies(tmp_path):
    a, b = load(jini, tmp_path), load(tini, tmp_path)
    assert a.configs() == b.configs()
    paths = ["OverSim.overlayTerminal[3].overlay.chord.stabilizeDelay",
             "OverSim.overlayTerminal[0].overlay.chord.joinDelay",
             "OverSim.targetOverlayTerminalNum", "a.b.constantDelay",
             "OverSim.overlayTerminal[0].overlay.kademlia.s",
             "OverSim.x.overlay.chord.successorListSize", "x.inboxImpl",
             "x.lifetimeMean", "x.deadtimeMean", "x.service.checkpointPath"]
    for config in ["General"] + a.configs():
        for path in paths:
            va, vb = a.get(path, config), b.get(path, config)
            if isinstance(va, jini.Study):
                va, vb = (va.name, va.values), (vb.name, vb.values)
            assert va == vb, (config, path)
        sa, sb = a.study_variables(config), b.study_variables(config)
        assert {k: v.values for k, v in sa.items()} == \
            {k: v.values for k, v in sb.items()}
    runs_a = list(a.expand_study_runs("Shifted"))
    runs_b = list(b.expand_study_runs("Shifted"))
    assert [r[0] for r in runs_a] == [r[0] for r in runs_b]
    assert len(runs_a) == 4
    key = "OverSim.overlayTerminal[0].overlay.kademlia.s"
    assert [a.get(key, c) for _, c in runs_a] == \
        [b.get(key, c) for _, c in runs_b] == [4, 8, 4, 8]


@pytest.mark.parametrize("configs", [("Pareto", "Dummy"),
                                     ("Random", "ChordFaster"),
                                     ("Shifted#1", "KadSparseTick"),
                                     ("Dht",)])
def test_built_parameters_equal(tmp_path, configs):
    a, b = load(jini, tmp_path), load(tini, tmp_path)
    for config in configs:
        if "#" in config:       # a study run: pin it in both
            config = [c for _, c in a.expand_study_runs("Shifted")][1]
            assert [c for _, c in b.expand_study_runs("Shifted")][1] == \
                config
        ja = jsc.build_simulation(a, config)
        tb = tsc.build_simulation(b, config, device="cpu")
        same(ja.cp, tb.cp, "churn")
        same(ja.up, tb.up, "underlay")
        same(ja.ep, tb.ep, "engine")
        same(ja.logic.p, tb.logic.p, "overlay")
        same(ja.logic.lcfg, tb.logic.lcfg, "lookup")
        assert type(ja.logic).__name__ == type(tb.logic).__name__
        assert type(ja.logic.app).__name__ == type(tb.logic.app).__name__
        if hasattr(tb.logic.app, "p"):
            same(ja.logic.app.p, tb.logic.app.p, "app")
        assert ja.n == tb.n and ja.spec.bits == tb.spec.bits
        same(jsc.build_campaign_params(a, config),
             tsc.build_campaign_params(b, config), "campaign")
        same(jsc.build_service(a, config), tsc.build_service(b, config),
             "service")


def test_scenario_errors_match(tmp_path):
    a, b = load(jini, tmp_path), load(tini, tmp_path)
    for config, build in (("KadBadInbox", "sim"), ("KadBadTick", "sim"),
                          ("NegTel", "sim"), ("Zero", "campaign"),
                          ("Zero", "service"), ("NoPath", "service"),
                          ("BadSweep", "campaign")):
        for pkg, ini in ((jsc, a), (tsc, b)):
            fn = {"sim": pkg.build_simulation,
                  "campaign": pkg.build_campaign_params,
                  "service": pkg.build_service}[build]
            kw = {"device": "cpu"} if pkg is tsc and build == "sim" else {}
            with pytest.raises(pkg.ScenarioError):
                fn(ini, config, **kw)
    for v in ("quantum", "", "Scatter"):
        with pytest.raises(tsc.ScenarioError):
            tsc.resolve_inbox_impl(v)
        with pytest.raises(jsc.ScenarioError):
            jsc.resolve_inbox_impl(v)
    with pytest.raises(tsc.ScenarioError):
        tsc.resolve_tick_impl("eager")


def test_pallas_never_resolves_to_scatter(monkeypatch, tmp_path):
    """The JAX resolver falls back to "scatter" where its kernel plane is
    missing; the port's has no such branch: "pallas" stays "pallas" on a
    host without a card, and the built simulation keeps it.  Without
    ``--device cpu`` the CLI asks for the card, and raises without one."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert jsc.resolve_inbox_impl("pallas", available=False,
                                  warn=False) == "scatter"
    for v in ("pallas", '"pallas"', " pallas "):
        assert tsc.resolve_inbox_impl(v) == "pallas"
    sim = tsc.build_simulation(load(tini, tmp_path), "Pareto", device="cpu")
    assert sim.ep.inbox_impl == "pallas"
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tsc.build_simulation(load(tini, tmp_path), "Pareto")
    from oversim_tpu_torch.__main__ import main
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        main(["-f", str(tmp_path / "main.ini"), "-c", "Pareto"])


def test_unported_modules_raise_naming_roadmap():
    lines = {
        # a tier app the port lacks over an overlay it has
        "overlay": '**.overlayType = "oversim.overlay.nice.NiceModules"\n'
                   '**.tier1Type = "oversim.applications.i3.OverlayI3"',
        "coords": '**.nodeCoordinateSource = "nodes.xml"',
        "app": '**.tier1Type = "oversim.applications.i3.OverlayI3"',
        "routing": '**.routingType = "exhaustive-iterative"',
        # a stack with an unported member
        "stack": '**.tier1Type = "oversim.applications.kbrtestapp.'
                 'KBRTestAppModules"\n**.tier2Type = "oversim.applications.'
                 'i3.OverlayI3"',
    }
    for what, line in lines.items():
        text = f"**.overlayType = {KAD}\n{line}\n" if what != "overlay" \
            else line + "\n"
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            tsc.build_simulation(tini.IniFile.loads(text), device="cpu")
