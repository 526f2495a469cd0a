"""The readings the output check's limits are set from, for several seeds in
one process on the card: for each seed a short run of the cell at its own
traffic and configuration, then the program's numbers against the
reference (the lower readings) and the control's (the upper readings: the
reference in the next precision down, TF32, put in the program's place).
One JSON line per seed; the benchmark's own runs never run the control.

    python -m radarbench.control --workload odo_fleet_b512 --seconds 3 --seeds 11 12 13
"""

from __future__ import annotations

import argparse
import json
import sys

from radarbench import harness
from radarbench.rehearse import context


def readings(ctx: harness.Context, seconds: float) -> dict:
    drv = harness.runner(ctx.traffic["runner"])
    out = drv.run(ctx, seconds, False)
    drv.release(out.state)
    return {"seed": ctx.seed, "attempted": out.attempted, "failed": out.failed,
            "program": drv.readings(out.state), "control": drv.control_readings(out.state)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("radarbench.control: no CUDA device", file=sys.stderr)
        return 2
    harness.use_cache_dirs()
    for seed in args.seeds:
        r = readings(context(args.workload, seed, (), "cuda:0"), args.seconds)
        print(json.dumps(r), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
