"""Run a campaign from flags: S replicas of Kademlia or Chord + KBRTest.

    python -m oversim_tpu_torch.campaign --replicas 2 \\
        --sweep churn.lifetimeMean=60,600 --n 12 --churn lifetime --t 25

Counterpart of the flag-built path of ``scripts/campaign_run.py``.  It
prints a record after init, one after the run, the telemetry record
(``--telemetry K``: a KPI sample every K ticks) and, as the last line,
the ensemble report (``Campaign.report``).  ``--out`` keeps the records
in one JSON file, rewritten atomically after each.  The run is on the
card unless ``--device cpu``; where there is no card it raises.  With
``--inbox-impl pallas`` the tick launches the CUDA kernels or raises:
there is no fallback to the scatter inbox.  ``--ini`` and ``--trace``
need the host planes of ROADMAP Queue A item 15 and raise.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time


def parse_sweep(specs) -> tuple:
    """``NAME=V1,V2,...`` specs -> ``CampaignParams.sweep``."""
    out = []
    for spec in specs or ():
        name, _, vals = spec.partition("=")
        vals = tuple(float(x) for x in vals.replace(",", " ").split())
        if not name or not vals:
            raise SystemExit(f"bad --sweep spec: {spec!r}")
        out.append((name, vals))
    return tuple(out)


def build(args):
    """The flag-built campaign (``scripts/campaign_run.py``'s shape)."""
    from oversim_tpu_torch import churn
    from oversim_tpu_torch.apps.kbrtest import KbrTestApp, KbrTestParams
    from oversim_tpu_torch.campaign import Campaign, CampaignParams
    from oversim_tpu_torch.common.lookup import LookupConfig
    from oversim_tpu_torch.engine.sim import EngineParams, Simulation
    from oversim_tpu_torch.telemetry import TelemetryParams

    app = KbrTestApp(KbrTestParams(test_interval=args.interval))
    if args.overlay == "chord":
        from oversim_tpu_torch.overlay.chord import ChordLogic
        logic = ChordLogic(app=app, lcfg=LookupConfig(slots=8))
    else:
        from oversim_tpu_torch.overlay.kademlia import KademliaLogic
        logic = KademliaLogic(app=app, lcfg=LookupConfig(slots=8, merge=True))
    cp = churn.ChurnParams(model=args.churn, target_num=args.n,
                           lifetime_mean=args.lifetime,
                           init_interval=10.0 / args.n)
    ep = EngineParams(window=args.window, inbox_slots=8, pool_factor=8,
                      inbox_impl=args.inbox_impl,
                      telemetry=TelemetryParams(
                          sample_ticks=args.telemetry,
                          window=args.telemetry_window))
    sim = Simulation(logic, cp, engine_params=ep, device=args.device)
    return Campaign(sim, CampaignParams(replicas=args.replicas,
                                        base_seed=args.seed,
                                        sweep=parse_sweep(args.sweep)))


class Artifact:
    """The records so far as ``{"records", "final", "complete"}``,
    rewritten through a temporary file and a rename after each record."""

    def __init__(self, path):
        self.path = path
        self.records = []
        self._flush(False)

    def add(self, rec):
        self.records.append(rec)
        self._flush(False)

    def finish(self):
        self._flush(True)

    def _flush(self, complete):
        if not self.path:
            return
        tmp = f"{self.path}.tmp"
        with open(tmp, "w") as f:
            json.dump({"records": self.records,
                       "final": self.records[-1] if self.records else None,
                       "complete": complete}, f)
        os.replace(tmp, self.path)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m oversim_tpu_torch.campaign")
    ap.add_argument("--ini", default=None,
                    help="build the campaign from this ini file")
    ap.add_argument("--config", default="General",
                    help="the ini's [Config X] section")
    ap.add_argument("--replicas", type=int, default=4)
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--sweep", action="append", default=[],
                    metavar="NAME=V1,V2", help="grid axis (repeatable): "
                    "churn.lifetimeMean, app.testMsgInterval, engine.window")
    ap.add_argument("--n", type=int, default=256)
    ap.add_argument("--overlay", default="kademlia",
                    choices=["kademlia", "chord"])
    ap.add_argument("--churn", default="none")
    ap.add_argument("--lifetime", type=float, default=10_000.0)
    ap.add_argument("--interval", type=float, default=0.2)
    ap.add_argument("--window", type=float, default=0.2)
    ap.add_argument("--t", type=float, default=120.0)
    ap.add_argument("--chunk", type=int, default=64)
    ap.add_argument("--confidence", type=float, default=0.95)
    ap.add_argument("--inbox-impl", default="scatter",
                    choices=["scatter", "pallas"],
                    help="pallas: the CUDA kernels, which launch or raise")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--out", default=None)
    ap.add_argument("--telemetry", type=int, default=0, metavar="K",
                    help="a KPI sample every K ticks (0: off)")
    ap.add_argument("--telemetry-window", type=int, default=256,
                    metavar="W", help="telemetry ring capacity")
    ap.add_argument("--trace", default=None, metavar="PATH")
    args = ap.parse_args(argv)
    if args.trace:
        raise NotImplementedError(
            "--trace needs telemetry.run_manifest (ROADMAP Queue A item "
            "15), which is not ported yet")

    import torch
    artifact = Artifact(args.out)
    t0 = time.perf_counter()
    if args.ini:
        from oversim_tpu_torch.config.ini import IniFile
        from oversim_tpu_torch.config.scenario import build_campaign
        camp = build_campaign(IniFile.load(args.ini), args.config,
                              device=args.device)
    else:
        camp = build(args)
    cs = camp.init()
    init_rec = {"phase": "init", "replicas": camp.p.replicas,
                "grid": camp.grid, "s": camp.s,
                "device": str(camp.sim.device),
                "init_wall_s": round(time.perf_counter() - t0, 2)}
    print(json.dumps(init_rec), flush=True)
    artifact.add(init_rec)

    t0 = time.perf_counter()
    cs = camp.run_until_device(cs, args.t, chunk=args.chunk)
    if camp.sim.device.type == "cuda":
        torch.cuda.synchronize(camp.sim.device)
    run_rec = {"phase": "run", "target_t_sim": args.t,
               "run_wall_s": round(time.perf_counter() - t0, 2)}
    print(json.dumps(run_rec), flush=True)
    artifact.add(run_rec)

    report = camp.report(cs, confidence=args.confidence)
    report["_campaign"].update(init_rec, **run_rec)
    report["_campaign"].pop("phase", None)
    artifact.add(report)
    tel = camp.telemetry_report(cs, confidence=args.confidence)
    if tel.get("enabled", True):
        tel["metric"] = "telemetry_series"
        artifact.add(tel)
        print(json.dumps(tel), flush=True)
    artifact.finish()
    print(json.dumps(report), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
