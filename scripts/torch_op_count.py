#!/usr/bin/env python3
"""PyTorch operations per tick of the port's overlays, counted on the CPU.

    python3 scripts/torch_op_count.py [--ticks 4] [--only epichord,inet]

Steps Kademlia + KBRTest and Chord + KBRTest (the parity tests'
bench.py configurations at N=16, tests/test_torch_kademlia.py and
tests/test_torch_chord.py), Kademlia + DHT under lifetime churn (16
slots, tests/test_torch_dht.py), ``chip_smoke.py``'s Pastry path at
100 target nodes (300 slots, 16 inbox slots), its Koorde, Broose and
EpiChord paths at 100 nodes (``db_sim``, 16 inbox slots), its main
path over InetUnderlay at 100 nodes (``inet``), its GIA path at 100
nodes (``chip_smoke.game_sim``, 40 s: past the ramp, searches running)
and its Vast and Quon scenario at 100 nodes (the same helper), its
PubSubMMOG and MyOverlay scenario at 100 nodes (``game_sim``), NTree over
its Chord path's scenario at 100 nodes (``ntree_sim``), its NICE path
at 100 nodes (``nice_sim``, 20 s: past the ramp, publishing), its
Scribe path at 100 nodes (``scribe_sim``, 30 s: every group rooted,
publishing) and its ``app_identity`` cases (SimMud, P2PNS,
BroadcastTestApp and TierStack(KBRTest, DHT) over Chord, ``app_sim``)
at 100 nodes past their join ramps (or 30 ticks; Broose 150, its join
machine settled), then
counts the ``aten::`` operations of a few more ticks under
torch.profiler, views and allocations left out.  Then the same per row of ``chip_smoke.py``'s
campaign path at 16 slots (Kademlia + KBRTest under lifetime churn,
four rows, a telemetry fold every tick) and of that path with telemetry
off.  A count, not a time: it predicts how the
card's launches per tick (``chip_smoke.py`` ``profile``) of one overlay
scale to another's.
"""

import argparse
import json
import os
import sys

import torch
from torch.profiler import ProfilerActivity, profile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [os.path.join(ROOT, "tests"), ROOT]

NOT_COMPUTE = {
    "aten::empty", "aten::view", "aten::as_strided", "aten::reshape",
    "aten::expand", "aten::select", "aten::slice", "aten::unsqueeze",
    "aten::squeeze", "aten::transpose", "aten::permute", "aten::alias",
    "aten::t", "aten::detach", "aten::resolve_conj", "aten::resolve_neg",
    "aten::result_type", "aten::_local_scalar_dense", "aten::empty_like",
    "aten::empty_strided", "aten::_unsafe_view", "aten::lift_fresh",
    "aten::item", "aten::is_nonzero", "aten::to", "aten::_to_copy",
    "aten::contiguous", "aten::broadcast_to", "aten::expand_as",
    "aten::flatten", "aten::split", "aten::unbind", "aten::chunk",
    "aten::narrow", "aten::view_as", "aten::squeeze_", "aten::unsqueeze_"}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--ticks", type=int, default=4)
    ap.add_argument("--only", default=None,
                    help="comma-separated overlays (default: all)")
    a = ap.parse_args()
    only = None if a.only is None else set(a.only.split(","))
    # the parity tests' configurations (their modules import JAX)
    import test_torch_chord
    import test_torch_dht
    import test_torch_kademlia
    sims = {"kademlia": test_torch_kademlia.bench_sims("scatter")[1],
            "chord": test_torch_chord.port_sim(),
            "kademlia_dht": test_torch_dht.port_sim("scatter")}
    import chip_smoke
    from oversim_tpu_torch.config.ini import IniFile
    from oversim_tpu_torch.config.scenario import build_simulation
    sims["pastry"] = build_simulation(
        IniFile.loads(chip_smoke.pastry_ini(100)), "Pastry",
        engine_params=chip_smoke.main_engine_params("scatter"), device="cpu")
    cpu = torch.device("cpu")
    for overlay in ("koorde", "broose", "epichord"):
        sims[overlay] = chip_smoke.db_sim(overlay, 100, cpu, "scatter")
    sims["inet"] = chip_smoke.bench_sim(100, cpu, "scatter", underlay="inet")
    for overlay in ("gia", "vast", "quon"):
        sims[overlay] = chip_smoke.game_sim(chip_smoke.game_logic(overlay),
                                            100, cpu, "scatter")
    for overlay in ("pubsub", "my"):
        sims[{"my": "myoverlay"}.get(overlay, overlay)] = chip_smoke.game_sim(
            chip_smoke.alm_logic(overlay), 100, cpu, "scatter")
    sims["ntree"] = chip_smoke.ntree_sim(100, cpu, "scatter")
    sims["nice"] = chip_smoke.nice_sim(100, cpu, "scatter")
    sims["scribe"] = chip_smoke.scribe_sim(100, cpu, "scatter")
    for app in ("simmud", "p2pns", "broadcast", "stack"):
        sims[app] = chip_smoke.app_sim(app, 100, cpu, "scatter")
    warm = {"pastry": 30, "broose": 150, "gia": 200, "nice": 400,
            "scribe": 150}
    for name, sim in sims.items():
        if only is not None and name not in only:
            continue
        s = sim.run_chunk(sim.init(3), warm.get(name, 120))
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            s = sim.run_chunk(s, a.ticks)
        ops = sum(e.count for e in prof.key_averages()
                  if e.key.startswith("aten::") and e.key not in NOT_COMPUTE)
        print(json.dumps({"overlay": name, "n": sim.n,
                          "aten_ops_per_tick": ops / a.ticks}), flush=True)
    for name, every in (("campaign_row_telemetry_off", 0),
                        ("campaign_row", chip_smoke.CAMP_TEL[0])):
        if only is not None and name not in only:
            continue
        camp = chip_smoke.campaign_of(chip_smoke.campaign_sim(
            8, cpu, "scatter", sample_ticks=every))
        cs = camp.run_chunk(camp.init(), 120)
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            cs = camp.run_chunk(cs, a.ticks)
        ops = sum(e.count for e in prof.key_averages()
                  if e.key.startswith("aten::") and e.key not in NOT_COMPUTE)
        print(json.dumps({"overlay": name, "n": camp.sim.n, "s": camp.s,
                          "aten_ops_per_tick_per_row":
                              ops / a.ticks / camp.s}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
