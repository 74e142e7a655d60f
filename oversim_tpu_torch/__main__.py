"""Command-line entry point: ``python -m oversim_tpu_torch -f x.ini -c Config``.

Counterpart of ``python -m oversim_tpu`` (the reference's ``OverSim -f
omnetpp.ini -cConfigName``): loads an OMNeT++-style ini, builds the
scenario (``config/scenario.py``), runs it for the configured init +
transition + measurement phases (or ``--until``) and prints
GlobalStatistics-style scalars (``name.mean/.stddev/.min/.max``), the
same lines as the JAX package's CLI.  ``${...}`` parameter studies
expand into runs: ``-r N`` picks one, ``--all-runs`` sweeps them.
``--trace`` drives joins, leaves, PUT/GET and partitions from a
``dht.trace``-format file.  The run is on the card unless ``--device
cpu``; where there is no card it raises.  ``**.inboxImpl = "pallas"``
launches the CUDA kernels or raises.
"""

from __future__ import annotations

import argparse
import json
import sys


def _fmt_scalars(label: str, out: dict) -> str:
    lines = []
    if label:
        lines.append(f"# run {label}")
    for name, v in sorted(out.items()):
        if name.startswith("_"):
            continue
        if isinstance(v, dict):
            for k in ("mean", "stddev", "min", "max", "count"):
                lines.append(f"scalar {name}.{k}\t{v[k]}")
        elif isinstance(v, list):
            lines.append(f"histogram {name}\t{v}")
        else:
            lines.append(f"scalar {name}\t{v}")
    for k, v in sorted(out.get("_engine", {}).items()):
        lines.append(f"scalar engine.{k}\t{v}")
    lines.append(f"scalar sim.time\t{out.get('_t_sim', 0.0)}")
    lines.append(f"scalar sim.ticks\t{out.get('_ticks', 0)}")
    lines.append(f"scalar sim.aliveNodes\t{out.get('_alive', 0)}")
    return "\n".join(lines)


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m oversim_tpu_torch",
        description="OverSim on PyTorch/CUDA: run a .ini scenario")
    ap.add_argument("-f", "--ini", required=True, help="ini file path")
    ap.add_argument("-c", "--config", default="General",
                    help="[Config X] section name")
    ap.add_argument("-r", "--run", type=int, default=None,
                    help="parameter-study run number")
    ap.add_argument("--all-runs", action="store_true",
                    help="sweep the whole parameter-study matrix")
    ap.add_argument("--until", type=float, default=None,
                    help="simulated seconds to run (default: init + "
                         "transition + measurement, or 600)")
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--trace", default=None,
                    help="trace file driving joins/leaves + PUT/GET + "
                         "partitions (simulations/dht.trace format)")
    ap.add_argument("--json", action="store_true",
                    help="print one JSON object per run instead of scalars")
    ap.add_argument("--output-vectors", default=None, metavar="FILE.vec",
                    help="record counter time series into an OMNeT++ .vec")
    ap.add_argument("--output-scalars", default=None, metavar="FILE.sca",
                    help="write finish()-time scalars into an OMNeT++ .sca")
    ap.add_argument("--vector-interval", type=float, default=10.0,
                    help="sampling period for --output-vectors (sim s)")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    return ap


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    from oversim_tpu_torch.config.ini import IniFile
    from oversim_tpu_torch.config.scenario import build_simulation

    trace_events = None
    if args.trace:
        from oversim_tpu_torch.trace import parse_trace
        trace_events = parse_trace(args.trace)

    ini = IniFile.load(args.ini)
    runs = list(ini.expand_study_runs(args.config))
    if args.run is not None:
        if not 0 <= args.run < len(runs):
            print(f"run {args.run} out of range (0..{len(runs) - 1})",
                  file=sys.stderr)
            return 2
        runs = [runs[args.run]]
    elif not args.all_runs:
        runs = runs[:1]

    for label, config in runs:
        sim = build_simulation(ini, config, trace_events=trace_events,
                               device=args.device)
        state = sim.init(seed=args.seed)
        horizon = args.until
        if horizon is None:
            meas = sim.ep.measurement_time
            horizon = (sim.cp.init_finished_time + sim.ep.transition_time
                       + (meas if meas and meas > 0 else 600.0))
        if args.output_vectors:
            from oversim_tpu_torch.recorder import VectorRecorder
            rec = VectorRecorder(sim, args.output_vectors,
                                 run_id=f"{config}-{label}")
            state = rec.run(state, horizon,
                            sample_every=args.vector_interval)
            rec.close()
        else:
            state = sim.run_until(state, horizon)
        out = sim.summary(state)
        if args.output_scalars:
            from oversim_tpu_torch.recorder import write_scalars
            write_scalars(sim, state, args.output_scalars,
                          run_id=f"{config}-{label}")
        if args.json:
            print(json.dumps({"run": label, **out}), flush=True)
        else:
            print(_fmt_scalars(label, out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
