"""Run the resident serving loop from flags.

    python -m oversim_tpu_torch.service --windows 8 --n 256 \\
        --checkpoint ck.npz --checkpoint-every 2 [--resume]

Counterpart of the flag-built path of ``scripts/service_run.py``: a
Kademlia or Chord + KBRTest scenario (``--replicas S``: a campaign of S
seed replicas) served window by window, double-buffered unless
``--single-buffer``, with a checkpoint every ``--checkpoint-every``
windows; ``--resume`` continues a killed run bit-identically from its
last checkpoint (``--override-cadence`` accepts a changed
``--window-sim-s``/``--chunk`` and re-anchors the window origin).
``--ingest-rate R`` switches to the serving scenario (Kademlia +
``RealworldEchoApp``, ``ext_hold_slot=0``) and submits R requests per
window from ``--ingest-clients`` synthetic clients.  It prints one JSON
record per window and a final record (``--out`` keeps them in one file,
rewritten atomically; ``--trace`` writes the loop's Perfetto spans).  A
SIGTERM stops after the in-flight window and writes a final checkpoint.

``--ini F --config C`` builds the scenario from an ini instead
(``config/scenario.py``: ``build_simulation`` and the ``**.service.*``
keys of ``build_service``; ``--windows``, ``--replicas``, ``--seed``,
``--resume`` and ``--device`` still apply, and the ini and config names
join the checkpoint's config hash).

The run is on the card unless ``--device cpu``; where there is no card
it raises.  ``--inbox-impl pallas`` launches the CUDA kernels or raises.
``--metrics-port``, ``--flight``, ``--reshard`` and ``--daemon`` need
modules that are not ported yet (ROADMAP Queue A) and raise.
"""

from __future__ import annotations

import argparse
import json
import signal
import sys
import time

# flag -> the module it needs (ROADMAP Queue A)
NOT_PORTED = {
    "metrics_port": "the observability plane obs/ (item 15)",
    "flight": "the observability plane obs/ (item 15)",
    "reshard": "the elastic plane elastic/ (item 15)",
    "daemon": "service/mux.py, service/tenant.py and service/daemon.py "
              "(the service front door)",
}


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m oversim_tpu_torch.service")
    ap.add_argument("--ini", default=None,
                    help="build the scenario from this ini file")
    ap.add_argument("--config", default="General",
                    help="the ini's [Config X] section")
    ap.add_argument("--windows", type=int, default=10, metavar="W",
                    help="windows to serve this invocation")
    ap.add_argument("--window-sim-s", type=float, default=1.0)
    ap.add_argument("--chunk", type=int, default=32)
    ap.add_argument("--checkpoint", default=None, metavar="PATH")
    ap.add_argument("--checkpoint-every", type=int, default=0, metavar="C")
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--override-cadence", action="store_true")
    ap.add_argument("--reshard", action="store_true")
    ap.add_argument("--single-buffer", action="store_true")
    ap.add_argument("--replicas", type=int, default=0, metavar="S")
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--n", type=int, default=256)
    ap.add_argument("--overlay", default="kademlia",
                    choices=["kademlia", "chord"])
    ap.add_argument("--churn", default="none")
    ap.add_argument("--lifetime", type=float, default=10_000.0)
    ap.add_argument("--interval", type=float, default=0.2,
                    help="KBRTest test interval (s)")
    ap.add_argument("--engine-window", type=float, default=0.2)
    ap.add_argument("--inbox-slots", type=int, default=8)
    ap.add_argument("--outbox-slots", type=int, default=16)
    ap.add_argument("--init-interval", type=float, default=None,
                    help="churn init interval (default 10 / n)")
    ap.add_argument("--init-deviation", type=float, default=0.1)
    ap.add_argument("--inbox-impl", default="scatter",
                    choices=["scatter", "pallas"],
                    help="pallas: the CUDA kernels, which launch or raise")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--telemetry", type=int, default=0, metavar="K")
    ap.add_argument("--telemetry-window", type=int, default=256)
    ap.add_argument("--out", default=None)
    ap.add_argument("--trace", default=None, metavar="PATH")
    ap.add_argument("--ingest-rate", type=int, default=0, metavar="R")
    ap.add_argument("--ingest-clients", type=int, default=4)
    ap.add_argument("--metrics-port", type=int, default=None)
    ap.add_argument("--flight", default=None)
    ap.add_argument("--daemon", action="store_true")
    return ap


def init_interval(args) -> float:
    return 10.0 / args.n if args.init_interval is None else args.init_interval


def build_sim(args):
    """The flag-built Simulation: Kademlia (``LookupConfig(slots=8,
    merge=True)``) or Chord (``slots=8``) + KBRTest, or with
    ``--ingest-rate`` Kademlia + ``RealworldEchoApp`` holding EXT_OUT
    for the gateway slot 0."""
    from oversim_tpu_torch import churn
    from oversim_tpu_torch.common.lookup import LookupConfig
    from oversim_tpu_torch.engine.sim import EngineParams, Simulation
    from oversim_tpu_torch.telemetry import TelemetryParams

    if args.ingest_rate:
        from oversim_tpu_torch.apps.realworld import RealworldEchoApp
        app = RealworldEchoApp(transform=1)
    else:
        from oversim_tpu_torch.apps.kbrtest import KbrTestApp, KbrTestParams
        app = KbrTestApp(KbrTestParams(test_interval=args.interval))
    if args.overlay == "chord" and not args.ingest_rate:
        from oversim_tpu_torch.overlay.chord import ChordLogic
        logic = ChordLogic(app=app, lcfg=LookupConfig(slots=8))
    else:
        from oversim_tpu_torch.overlay.kademlia import KademliaLogic
        logic = KademliaLogic(app=app, lcfg=LookupConfig(slots=8, merge=True))
    cp = churn.ChurnParams(model=args.churn, target_num=args.n,
                           lifetime_mean=args.lifetime,
                           init_interval=init_interval(args),
                           init_deviation=args.init_deviation)
    ep = EngineParams(window=args.engine_window,
                      inbox_slots=args.inbox_slots,
                      outbox_slots=args.outbox_slots, pool_factor=8,
                      inbox_impl=args.inbox_impl,
                      ext_hold_slot=0 if args.ingest_rate else -1,
                      telemetry=TelemetryParams(
                          sample_ticks=args.telemetry,
                          window=args.telemetry_window))
    return Simulation(logic, cp, engine_params=ep, device=args.device)


def scenario_config(args) -> dict:
    """The scenario-defining flags, hashed into every checkpoint (resume
    refuses another hash).  Run-shape flags (``--windows``, ``--out``,
    ``--resume``, ``--replicas``, ``--device``) stay out."""
    config = {"overlay": "kademlia" if args.ingest_rate else args.overlay,
              "n": args.n, "seed": args.seed,
              "churn": args.churn, "lifetime": args.lifetime,
              "interval": args.interval,
              "engine_window": args.engine_window,
              "inbox_slots": args.inbox_slots,
              "outbox_slots": args.outbox_slots,
              "init_interval": init_interval(args),
              "init_deviation": args.init_deviation,
              "inbox_impl": args.inbox_impl,
              "telemetry": {"sampleTicks": args.telemetry,
                            "window": args.telemetry_window}}
    if args.ingest_rate:
        config["app"] = "echo"
    return config


class SyntheticLoad:
    """``per_window`` requests before every window boundary, round-robin
    over ``clients`` client ids (``b`` = client, ``c`` = serial; the echo
    app answers ``c + transform``), delegated to an InProcessIngest."""

    def __init__(self, inner, *, clients: int = 4, per_window: int = 8):
        if clients < 1 or per_window < 0:
            raise ValueError("need clients >= 1 and per_window >= 0")
        self.inner = inner
        self.clients = clients
        self.per_window = per_window
        self.sent = {}                # sid -> (b, c)

    def before_window(self, state, target_ns: int):
        for _ in range(self.per_window):
            k = len(self.sent)
            b, c = k % self.clients, k
            self.sent[self.inner.submit(b=b, c=c)] = (b, c)
        return self.inner.before_window(state, target_ns)

    def after_window(self, state):
        return self.inner.after_window(state)


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    for flag, needs in NOT_PORTED.items():
        if getattr(args, flag) is not None and getattr(args, flag) is not False:
            raise NotImplementedError(
                f"--{flag.replace('_', '-')} needs {needs}, which is not "
                "ported yet (ROADMAP Queue A)")
    if args.ingest_rate and args.replicas:
        raise SystemExit("--ingest-rate serves a solo state")

    from oversim_tpu_torch import telemetry as telemetry_mod
    from oversim_tpu_torch.campaign.__main__ import Artifact
    from oversim_tpu_torch.service import (InProcessIngest, ServiceLoop,
                                           ServiceParams,
                                           campaign_summarize_leaves)

    if args.ini:
        if args.ingest_rate:
            raise SystemExit("--ingest-rate builds its own scenario; it "
                             "does not take --ini")
        from oversim_tpu_torch.config.ini import IniFile
        from oversim_tpu_torch.config.scenario import (build_service,
                                                       build_simulation)
        ini = IniFile.load(args.ini)
        sim = build_simulation(ini, args.config, device=args.device)
        ini_params = build_service(ini, args.config)
        config = {"ini": args.ini, "config": args.config,
                  "seed": args.seed, "inbox_impl": sim.ep.inbox_impl}
    else:
        sim = build_sim(args)
        config = scenario_config(args)
        ini_params = None
    summarize = None
    if args.replicas:
        from oversim_tpu_torch.campaign import Campaign, CampaignParams
        runner = Campaign(sim, CampaignParams(replicas=args.replicas,
                                              base_seed=args.seed))
        summarize = campaign_summarize_leaves
    else:
        runner = sim
    params = ini_params or ServiceParams(
        window_sim_s=args.window_sim_s, chunk=args.chunk,
        checkpoint_every=args.checkpoint_every,
        checkpoint_path=args.checkpoint,
        double_buffer=not args.single_buffer)
    artifact = Artifact(args.out)
    trace = telemetry_mod.PerfettoTrace("service_run") if args.trace else None
    load = None
    if args.ingest_rate:
        load = SyntheticLoad(InProcessIngest(gw_slot=0),
                             clients=args.ingest_clients,
                             per_window=args.ingest_rate)

    t0 = time.perf_counter()
    example = runner.init() if args.replicas else runner.init(seed=args.seed)
    if args.ingest_rate and not args.resume:
        # warm until every node has joined, so the echo app answers
        # from the first served window
        example = runner.run_until(
            example, init_interval(args) * args.n + args.engine_window,
            chunk=params.chunk)
    init_rec = {"phase": "init", "resume": bool(args.resume),
                "replicas": args.replicas, "device": str(sim.device),
                "init_wall_s": round(time.perf_counter() - t0, 2)}
    print(json.dumps(init_rec), flush=True)
    artifact.add(init_rec)

    def on_window(window, summary, wall):
        rec = {"window": window, "wall_s": round(wall, 3), **summary}
        print(json.dumps(rec), flush=True)
        artifact.add(rec)
        if trace is not None:
            trace.write(args.trace)

    kw = dict(config=config, on_window=on_window, trace=trace,
              summarize=summarize, ingest=load)
    if args.resume:
        loop = ServiceLoop.resume(runner, example, params,
                                  override_cadence=args.override_cadence,
                                  **kw)
        print(json.dumps({"phase": "resume",
                          "windows_done": loop.windows_done,
                          "start_sim_t": loop.start_sim_t,
                          "override_cadence": args.override_cadence}),
              flush=True)
    else:
        loop = ServiceLoop(runner, example, params, **kw)

    got_term = []

    def on_sigterm(signum, frame):
        got_term.append(signum)
        loop.stop()

    signal.signal(signal.SIGTERM, on_sigterm)
    _, done = loop.run(n_windows=args.windows)
    final = {"phase": "final", "windows_done": done,
             "checkpoints_written": loop.checkpoints_written,
             "last_checkpoint": loop.last_checkpoint,
             "wall_s": round(time.perf_counter() - t0, 2)}
    if got_term:
        final["sigterm"] = True
        final["final_checkpoint"] = loop.checkpoint_now()
    if load is not None:
        got = load.inner.responses
        final["requests"] = {
            "submitted": len(load.sent), "answered": len(got),
            "exact": sum(got.get(sid) == (b, c + 1)
                         for sid, (b, c) in load.sent.items()),
            "overflow": load.inner.overflow()}
    artifact.add(final)
    if trace is not None:
        trace.write(args.trace)
    artifact.finish()
    print(json.dumps(final), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
