"""No run and no reference loads JAX or the JAX package, compared by whole
top-level module names; the reference loads nothing of the port; nothing in
the benchmark reads the JAX benchmark's files."""

import json
import subprocess
import sys

from radarbench import harness

PROBE = """
import json, sys
{body}
print(json.dumps(sorted({{m.split('.')[0] for m in sys.modules}})))
"""


def _top_level(body: str) -> set:
    out = subprocess.run([sys.executable, "-c", PROBE.format(body=body)], cwd=harness.ROOT,
                         capture_output=True, text=True, timeout=600, check=True)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_the_reference_loads_neither_jax_nor_the_port():
    mods = _top_level("import radarbench.reference.odometry, radarbench.reference.precision")
    assert not mods & {"jax", "jaxlib", "flax", "navtech_radar_slam_tpu",
                       "navtech_radar_slam_torch"}


def test_a_run_loads_no_jax():
    sets = ("['traffic.streams=2', 'traffic.lap_scans=4', 'config.features.max_features=128',"
            " 'config.features.max_matches=64', 'config.registration.spectral_top_k=64']")
    mods = _top_level(
        "from radarbench import rehearse\n"
        f"rehearse.main(['--workload', 'odo_fleet_b512', '--seed', '3', '--seconds', '0.2']"
        f" + [a for s in {sets} for a in ('--set', s)])")
    assert "navtech_radar_slam_torch" in mods
    assert not mods & set(harness.FORBIDDEN)
    assert harness.forbidden_loaded() == sorted(
        {m.split(".")[0] for m in sys.modules} & set(harness.FORBIDDEN))


def test_the_forbidden_names_are_compared_whole():
    assert "navtech_radar_slam_torch" not in harness.FORBIDDEN
    assert "navtech_radar_slam_tpu" in harness.FORBIDDEN


def test_nothing_reads_the_jax_benchmarks_files():
    for path in harness.HERE.rglob("*.py"):
        if "tests" in path.parts:
            continue
        text = path.read_text()
        for name in ("bench.py", "bench_scaling", "artifacts/", "BENCH_", "MULTICHIP_"):
            assert name not in text, (path, name)
