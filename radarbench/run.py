"""Run one cell of ``BENCHMARK.json`` once, on the card.

    python -m radarbench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

Prints the set-up split, the output check's numbers beside their limits
(the last lines on standard error) and, as the last line of standard
output, one JSON object: ``correct``, ``attempted``, ``failed``,
``metrics`` (the cell's end-to-end metrics with ``--trace 0``, its
per-layer metrics with ``--trace 1``), ``device`` and, traced,
``breakdown``; last, ``checks``, each number with its limit.

Exits non-zero with no result where there is no card or fewer than the
cell asks for, and where a module of JAX or of the JAX package is loaded
once the window has closed.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402


def _card_line() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "nvidia-smi gave nothing"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from radarbench import harness, tracing

    spec = harness.load_spec()
    cell = harness.workload(spec, args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"radarbench: {args.workload} needs {cell['chips']} CUDA device(s); "
              f"this machine has {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    harness.use_cache_dirs()
    cfg_file = harness.config(cell["config"])
    traffic = harness.traffic(cell["traffic"])
    clock = harness.SetupClock(T0)
    ctx = harness.Context(workload=args.workload, config=harness.slam_sections(cfg_file),
                          traffic=traffic, seed=args.seed, device="cuda:0",
                          limits=harness.limits(args.workload), clock=clock)
    drv = harness.runner(traffic["runner"])
    out = drv.run(ctx, args.seconds, bool(args.trace))
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    drv.release(out.state)

    metrics = {}
    if args.trace:
        for m in harness.per_layer_of(spec, args.workload):
            v = harness.reader(m["name"]).read(out.records)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        values = dict(out.end_to_end, setup_s=clock.total())
        for m in harness.end_to_end_of(spec, args.workload):
            metrics[m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}

    t_ref = time.perf_counter()
    readings = drv.readings(out.state)
    correct, checks = harness.judge(readings, ctx.limits)
    print(clock.line(), file=sys.stderr)
    for line in out.notes:
        print(line, file=sys.stderr)
    print(f"card: {_card_line()}; reference and check {time.perf_counter() - t_ref:.3f} s",
          file=sys.stderr)

    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": cell["chips"], "memory_peak_bytes": peak}
    result = {"correct": correct, "attempted": out.attempted, "failed": out.failed,
              "metrics": metrics, "device": device}
    tr = out.records.trace
    if args.trace:
        if tr is None:
            print("radarbench: the profiler kept no trace of the traced steps", file=sys.stderr)
            return 3
        device.update(busy_s=tr.busy_s, window_s=tr.window_s)
        result["breakdown"] = {"device_ops": tr.device_ops, "idle_gaps": tr.idle_gaps}
        print(f"trace: marker kernels kept {tr.markers_kept} of {tracing.MARKERS}",
              file=sys.stderr)
    result["checks"] = checks
    bad = harness.forbidden_loaded()
    if bad:
        print(f"radarbench: forbidden modules loaded: {bad}", file=sys.stderr)
        return 4
    for line in harness.check_lines(checks):
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
