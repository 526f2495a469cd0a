"""Every piece of a cell is found by its name, and a new configuration,
traffic mix, cell and per-layer metric are taken from new files and new
entries alone."""

import copy
import json
import shutil

import pytest

from radarbench import harness, rehearse
from radarbench.tests.small import FLEET


def test_every_workload_finds_its_pieces():
    spec = harness.load_spec()
    names = {c["name"] for c in spec["configs"]}
    for cell in spec["workloads"]:
        assert cell["config"] in names
        cfg = harness.config(cell["config"])
        assert cfg["name"] == cell["config"]
        assert isinstance(cfg["reduced"], list) and "assumed" in cfg and cfg["deployment"]
        traffic = harness.traffic(cell["traffic"])
        assert harness.runner(traffic["runner"]).run
        assert harness.limits(cell["name"])
        e2e = [m["name"] for m in harness.end_to_end_of(spec, cell["name"])]
        assert "setup_s" in e2e and len(e2e) >= 2
        layer = harness.per_layer_of(spec, cell["name"])
        assert layer
        for m in layer:
            assert m["moves"] in e2e
            assert callable(harness.reader(m["name"]).read)
    for c in spec["configs"]:
        assert (harness.ROOT / c["file"]).is_file()


def test_per_layer_readers_find_nothing_to_read_without_a_trace():
    spec = harness.load_spec()
    rec = harness.Records()
    for m in spec["per_layer"]:
        assert harness.reader(m["name"]).read(rec) is None


def test_a_new_cell_is_taken_from_new_files_and_entries(tmp_path):
    """A copy of the benchmark's folder plus a new configuration, traffic
    mix, limits and per-layer metric, each a new file, and new entries in a
    copy of BENCHMARK.json: the cell runs (on the CPU, small) and its new
    metric is read, with no existing file edited."""
    here = tmp_path / "radarbench"
    shutil.copytree(harness.HERE, here, ignore=shutil.ignore_patterns("__pycache__"))
    before = {p.relative_to(here): p.read_bytes() for p in here.rglob("*") if p.is_file()}
    spec = copy.deepcopy(harness.load_spec())
    cfg = json.loads((here / "configs" / "mulran_kaist_odometry.json").read_text())
    cfg["name"] = "new_config"
    (here / "configs" / "new_config.json").write_text(json.dumps(cfg))
    traffic = json.loads((here / "traffic" / "fleet_lap512.json").read_text())
    traffic["streams"] = 3
    (here / "traffic" / "new_traffic.json").write_text(json.dumps(traffic))
    (here / "checks" / "new_cell.json").write_text(json.dumps(
        json.loads((here / "checks" / "odo_fleet_b512.json").read_text())))
    (here / "metrics" / "new_metric.py").write_text(
        "def read(rec):\n    return float(rec.counts['steps'])\n")
    spec["configs"].append(dict(spec["configs"][0], name="new_config",
                                file="radarbench/configs/new_config.json"))
    spec["workloads"].append({"name": "new_cell", "config": "new_config",
                              "traffic": "new_traffic", "chips": 1, "why": "a test"})
    spec["end_to_end"][0]["workloads"].append("new_cell")
    spec["per_layer"].append({"name": "new_metric", "unit": "steps", "better": "higher",
                              "source": "host_clock", "layer": "batched odometry",
                              "moves": spec["end_to_end"][0]["name"],
                              "workloads": ["new_cell"]})
    assert "new_metric" in [m["name"] for m in harness.per_layer_of(spec, "new_cell")]
    sets = [s for s in FLEET if s[0] != "traffic.streams"]
    ctx = rehearse.context("new_cell", 5, sets, spec=spec, here=here)
    assert ctx.traffic["streams"] == 3
    correct, _, out = rehearse.rehearse(ctx, 0.5)
    assert correct and out.attempted >= 3
    assert harness.reader("new_metric", here).read(out.records) == out.records.counts["steps"]
    after = {p.relative_to(here): p.read_bytes() for p in here.rglob("*")
             if p.is_file() and "__pycache__" not in p.parts}
    assert all(after[k] == v for k, v in before.items() if "__pycache__" not in k.parts)


def test_a_missing_piece_is_named():
    with pytest.raises(SystemExit, match="no_such_traffic"):
        harness.traffic("no_such_traffic")
