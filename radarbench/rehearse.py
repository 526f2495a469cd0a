"""Rehearse a cell on the CPU at a small size: the runner's whole run on the
port's plain paths, then the output check against the reference.  Prints
the check's numbers and no metric: a CPU run measures nothing of the card.

    python -m radarbench.rehearse --workload odo_fleet_b512 --seed 7 --seconds 2 \\
        --set traffic.streams=4 --set traffic.lap_scans=8 \\
        --set config.features.max_features=256

``--set`` replaces one value of the traffic file (``traffic.<key>``) or of
the configuration file (``config.<section>.<key>``), as JSON.
"""

from __future__ import annotations

import argparse
import copy
import json
import sys
import time

from radarbench import harness


def override(ctx_part: dict, dotted: str, value) -> None:
    *path, last = dotted.split(".")
    for k in path:
        ctx_part = ctx_part[k]
    if last not in ctx_part:
        raise SystemExit(f"rehearse: no key {dotted!r} to set")
    ctx_part[last] = value


def context(workload: str, seed: int, sets=(), device: str = "cpu", spec=None,
            here=harness.HERE) -> harness.Context:
    """The cell's context on ``device`` with ``sets`` ([(dotted, value)])
    applied; ``spec`` and ``here`` stand for BENCHMARK.json and the
    benchmark's folder."""
    spec = spec or harness.load_spec()
    cell = harness.workload(spec, workload)
    parts = {"traffic": copy.deepcopy(harness.traffic(cell["traffic"], here)),
             "config": harness.slam_sections(harness.config(cell["config"], here))}
    for dotted, value in sets:
        head, rest = dotted.split(".", 1)
        override(parts[head], rest, value)
    return harness.Context(workload=workload, config=parts["config"],
                           traffic=parts["traffic"], seed=seed, device=device,
                           limits=harness.limits(workload, here),
                           clock=harness.SetupClock(time.perf_counter()))


def rehearse(ctx: harness.Context, seconds: float, trace: bool = False):
    """(correct, checks, outcome) of one run of the cell's runner."""
    drv = harness.runner(ctx.traffic["runner"])
    out = drv.run(ctx, seconds, trace)
    drv.release(out.state)
    correct, checks = harness.judge(drv.readings(out.state), ctx.limits)
    return correct, checks, out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=1.0)
    ap.add_argument("--set", action="append", default=[], metavar="KEY=JSON")
    args = ap.parse_args(argv)
    sets = [(k, json.loads(v)) for k, v in (s.split("=", 1) for s in args.set)]
    ctx = context(args.workload, args.seed, sets)
    correct, checks, out = rehearse(ctx, args.seconds)
    print(f"rehearsal on the CPU (no metric): attempted {out.attempted}, "
          f"failed {out.failed}, correct {correct}")
    for line in harness.check_lines(checks):
        print(line)
    return 0 if correct else 1


if __name__ == "__main__":
    sys.exit(main())
