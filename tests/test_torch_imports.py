"""The port stands alone: no JAX, no oversim_tpu, no quiet CPU fallback."""

import ast
import os
import pathlib
import subprocess
import sys

import pytest
import torch

# tiny tensors: one intra-op thread keeps parallel test workers from
# oversubscribing the host
torch.set_num_threads(1)

PKG = pathlib.Path(__file__).resolve().parent.parent / "oversim_tpu_torch"

_PROBE = r"""
import importlib, pkgutil, sys
import oversim_tpu_torch as pkg
mods = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in mods:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.") or m.startswith("jaxlib")
             or m == "oversim_tpu" or m.startswith("oversim_tpu."))
print(len(mods), ",".join(bad))
"""


def test_import_leaves_jax_and_reference_out():
    env = dict(os.environ)
    out = subprocess.run([sys.executable, "-c", _PROBE], check=True,
                         capture_output=True, text=True, env=env,
                         cwd=str(PKG.parent), timeout=300).stdout.split()
    assert int(out[0]) >= 45
    assert len(out) == 1, f"imported: {out[1]}"


def test_new_modules_are_in_the_package():
    for rel in ("xlamath.py", "kernels/compact.py", "csrc/compact.cu",
                "common/ncs.py", "overlay/chord.py", "apps/dht.py",
                "telemetry.py", "campaign/runner.py", "campaign/__main__.py",
                "checkpoint.py", "common/crypto.py", "gateway.py",
                "apps/dummy.py", "apps/realworld.py", "service/__init__.py",
                "service/ingest.py", "service/loop.py",
                "service/__main__.py", "config/ini.py", "config/scenario.py",
                "trace.py", "native.py", "recorder.py", "__main__.py",
                "common/route.py", "overlay/pastry.py", "overlay/koorde.py",
                "overlay/broose.py", "overlay/epichord.py",
                "underlay/inet.py", "overlay/gia.py", "overlay/vast.py",
                "overlay/quon.py", "apps/movement.py", "overlay/nice.py",
                "overlay/pubsubmmog.py", "overlay/myoverlay.py",
                "apps/ntree.py", "apps/stack.py", "apps/scribe.py",
                "apps/simmud.py", "apps/p2pns.py", "apps/broadcast.py",
                "apps/probe.py"):
        assert (PKG / rel).exists(), rel


TICK_METHODS = ("step", "_step_sparse", "_lanes_step", "_finish_logic",
                "_make_ctx", "_msgs_from_block", "_hold_mask")
HOST_READS = {"item", "nonzero", "tolist", "masked_select", "cpu", "numpy"}


def test_tick_code_reads_nothing_back():
    """The tick (dense and sparse phases) and the churn and draw code it
    calls use no operation that reads a value back to the host; the card
    run (chip_smoke.py) also steps a tick with every synchronisation
    turned into an error."""
    def calls(node):
        for n in ast.walk(node):
            if isinstance(n, ast.Attribute) and n.attr in HOST_READS:
                yield n.attr
    tree = ast.parse((PKG / "engine" / "sim.py").read_text())
    sim_cls = next(n for n in tree.body if isinstance(n, ast.ClassDef)
                   and n.name == "Simulation")
    for fn in sim_cls.body:
        if isinstance(fn, ast.FunctionDef) and (
                fn.name.startswith("_phase") or fn.name in TICK_METHODS):
            assert not list(calls(fn)), fn.name
    for rel in ("churn.py", "xlamath.py", "rng.py", "kernels/compact.py",
                "overlay/chord.py", "common/ncs.py",
                "common/neighborcache.py", "common/lookup.py",
                "overlay/kademlia.py", "overlay/epichord.py", "apps/base.py",
                "apps/dht.py", "apps/dummy.py", "apps/realworld.py",
                "overlay/gia.py", "overlay/vast.py", "overlay/quon.py",
                "apps/movement.py", "overlay/nice.py",
                "overlay/pubsubmmog.py", "overlay/myoverlay.py",
                "apps/ntree.py", "apps/stack.py", "apps/scribe.py",
                "apps/simmud.py", "apps/p2pns.py", "apps/broadcast.py"):
        tree = ast.parse((PKG / rel).read_text())
        assert not list(calls(tree)), rel
    # the telemetry sample point runs inside the tick; the module's
    # host-side series readers do not
    tree = ast.parse((PKG / "telemetry.py").read_text())
    for fn in tree.body:
        if isinstance(fn, ast.FunctionDef) and fn.name in ("init", "fold"):
            assert not list(calls(fn)), fn.name


def test_sources_mention_no_jax_or_reference_imports():
    for path in [*PKG.rglob("*.py"), PKG.parent / "chip_smoke.py"]:
        text = path.read_text()
        assert "import jax" not in text, path
        assert "oversim_tpu." not in text, path
        for node in ast.walk(ast.parse(text)):
            if isinstance(node, ast.ImportFrom) and node.module:
                assert not node.module.startswith(("jax", "oversim_tpu.")), \
                    path
                assert node.module != "oversim_tpu", path


def test_simulation_defaults_to_the_card(monkeypatch):
    """Without ``device=`` the entry point asks for CUDA; where there is
    none it raises instead of moving to the CPU."""
    from oversim_tpu_torch import churn
    from oversim_tpu_torch.engine.sim import Simulation
    from oversim_tpu_torch.overlay.kademlia import KademliaLogic
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Simulation(KademliaLogic(), churn.ChurnParams(target_num=4))
    sim = Simulation(KademliaLogic(), churn.ChurnParams(target_num=4),
                     device="cpu")
    assert sim.device.type == "cpu"


def test_no_fallback_branch():
    """CUDA availability is consulted in one place (the entry point,
    which raises); kernel wrappers choose the plain version only for
    CPU tensors and catch nothing."""
    users = []
    for path in PKG.rglob("*.py"):
        text = path.read_text()
        if "is_available" in text:
            users.append(path.relative_to(PKG).as_posix())
        if path.parent.name == "kernels" or path.name == "sim.py":
            tree = ast.parse(text)
            assert not any(isinstance(n, ast.Try) for n in ast.walk(tree)), \
                path
    assert users == ["engine/sim.py"]


def test_chord_simulation_defaults_to_the_card(monkeypatch):
    from oversim_tpu_torch import churn
    from oversim_tpu_torch.engine.sim import Simulation
    from oversim_tpu_torch.overlay.chord import ChordLogic
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Simulation(ChordLogic(), churn.ChurnParams(target_num=4))
    sim = Simulation(ChordLogic(), churn.ChurnParams(target_num=4),
                     device="cpu")
    assert sim.device.type == "cpu"


def test_dht_trace_mode_raises_naming_the_roadmap():
    """Trace-driven DHT workloads run on the plain DHT (trace.py, ported;
    tests/test_torch_trace.py); a trace whose ini also names another tier
    app builds a tier stack with the DHT first, as the JAX builder does,
    and one naming an unported app (I3) raises naming ROADMAP instead of
    dropping a tier; the replica-team variants refuse a trace as the JAX
    package's do."""
    from oversim_tpu_torch.apps.kbrtest import KbrTestApp
    from oversim_tpu_torch.apps.stack import TierStack
    from oversim_tpu_torch import trace as ttrace
    from oversim_tpu_torch.apps.dht import DhtApp, DhtParams
    from oversim_tpu_torch.config.ini import IniFile
    from oversim_tpu_torch.config.scenario import build_app
    from oversim_tpu_torch.core import keys
    ev = ttrace.parse_text("0 1 JOIN\n1 1 PUT k v\n")
    wl = ttrace.workload_from_trace(ev, 1)
    assert DhtApp(trace=wl).trace is wl
    ini = IniFile.loads('**.tier1Type = "oversim.applications.kbrtestapp.'
                        'KBRTestAppModules"\n')
    stack = build_app(ini, "General", keys.DEFAULT_SPEC, trace=wl)
    assert isinstance(stack, TierStack)
    assert [type(a) for a in stack.apps] == [DhtApp, KbrTestApp]
    assert stack.apps[0].trace is wl
    ini = IniFile.loads('**.tier1Type = "oversim.applications.i3.'
                        'OverlayI3"\n')
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        build_app(ini, "General", keys.DEFAULT_SPEC, trace=wl)
    with pytest.raises(ValueError, match="plain DHT"):
        DhtApp(DhtParams(variant="repeated", num_replica_teams=2), trace=wl)


def test_service_entry_points_default_to_the_card(monkeypatch):
    """The service CLI asks for CUDA unless ``--device cpu`` and raises
    where there is none; the loop and the gateway run on the device of
    the state they are given and move nothing to the host on their own
    (their only host copies are the fetch and the pool drain)."""
    from oversim_tpu_torch.service.__main__ import main
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        main(["--n", "4", "--windows", "1"])
    for rel in ("service/loop.py", "gateway.py", "service/ingest.py"):
        text = (PKG / rel).read_text()
        assert "device=\"cpu\"" not in text and ".cpu()" not in text, rel
