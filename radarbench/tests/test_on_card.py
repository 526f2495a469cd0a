"""The cell on the card, briefly: a traced run prints the contract's last
line, correct, with every per-layer metric of the cell and the device's
trace numbers."""

import json
import subprocess
import sys

import pytest

from radarbench import harness


@pytest.mark.cuda
def test_a_traced_run_prints_the_result_line(card):
    spec = harness.load_spec()
    cell = spec["workloads"][0]["name"]
    out = subprocess.run([sys.executable, "-m", "radarbench.run", "--workload", cell,
                          "--seed", str(2**31 + 11), "--seconds", "2", "--trace", "1"],
                         cwd=harness.ROOT, capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-3000:]
    r = json.loads(out.stdout.strip().splitlines()[-1])
    assert r["correct"] is True and r["attempted"] > 0
    assert set(r["metrics"]) == {m["name"] for m in harness.per_layer_of(spec, cell)}
    dev = r["device"]
    assert dev["platform"] == "gpu" and dev["count"] == 1
    assert 0 < dev["busy_s"] <= dev["window_s"]
    assert list(r)[-1] == "checks"
