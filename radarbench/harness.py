"""What every cell shares: finding its pieces by name, the set-up clock,
the device checks, the per-layer readers and the result line.

A cell of ``BENCHMARK.json`` names a configuration and a traffic mix.  The
configuration is ``configs/<config>.json`` (the port's ``SlamConfig``
sections, beside its ``source``, ``reduced``, ``assumed`` and
``deployment``); the traffic mix is ``traffic/<traffic>.json``, whose
``runner`` names the general runner in ``runners/`` that reads it; the
limits of the cell's output check are ``checks/<workload>.json``; each
per-layer metric is read by ``metrics/<metric>.py``.  Adding any of them
takes new files and new entries, and no edit.
"""

from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
import math
import os
import sys
import time
from pathlib import Path
from types import ModuleType
from typing import Dict, List, Optional, Tuple

HERE = Path(__file__).resolve().parent
#: the checkout: BENCHMARK.json beside the benchmark's folder
ROOT = HERE.parent
#: modules no run may hold once its window has closed, by top-level name
FORBIDDEN = ("jax", "jaxlib", "flax", "navtech_radar_slam_tpu")
#: the build and kernel caches, at fixed paths inside the checkout
CACHE_DIRS = {"TORCH_EXTENSIONS_DIR": ".radarbench_cache/torch_extensions",
              "TRITON_CACHE_DIR": ".radarbench_cache/triton"}


def load_spec(root: Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def _by_name(entries: List[dict], name: str, what: str) -> dict:
    for e in entries:
        if e["name"] == name:
            return e
    raise SystemExit(f"radarbench: no {what} named {name!r} in BENCHMARK.json")


def workload(spec: dict, name: str) -> dict:
    return _by_name(spec["workloads"], name, "workload")


def _json(sub: str, name: str, here: Path = HERE) -> dict:
    path = here / sub / f"{name}.json"
    if not path.is_file():
        raise SystemExit(f"radarbench: {path} is missing")
    with open(path) as f:
        return json.load(f)


def config(name: str, here: Path = HERE) -> dict:
    """The configuration file of ``name``."""
    return _json("configs", name, here)


def slam_sections(cfg_file: dict) -> dict:
    """The configuration file's ``SlamConfig`` sections (and ``do_slam``):
    every key but the file's own notes."""
    notes = {"name", "source", "reduced", "assumed", "deployment"}
    return {k: v for k, v in cfg_file.items() if k not in notes}


def traffic(name: str, here: Path = HERE) -> dict:
    return _json("traffic", name, here)


def limits(workload_name: str, here: Path = HERE) -> dict:
    """The limits of the cell's output check: {number: limit}."""
    return _json("checks", workload_name, here)["limits"]


def runner(name: str) -> ModuleType:
    return importlib.import_module(f"radarbench.runners.{name}")


def reader(metric: str, here: Path = HERE) -> ModuleType:
    """``metrics/<metric>.py`` (a metric's name may hold dots, so the file
    is loaded by its path)."""
    path = here / "metrics" / f"{metric}.py"
    if not path.is_file():
        raise SystemExit(f"radarbench: {path} is missing")
    spec = importlib.util.spec_from_file_location(
        "radarbench.metrics." + metric.replace(".", "__"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _for_cell(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def end_to_end_of(spec: dict, cell: str) -> List[dict]:
    return [m for m in spec["end_to_end"] if _for_cell(m, cell)]


def per_layer_of(spec: dict, cell: str) -> List[dict]:
    """The cell's per-layer metrics: those whose ``workloads`` list it."""
    return [m for m in spec["per_layer"] if cell in m["workloads"]]


def use_cache_dirs(root: Path = ROOT) -> None:
    """Point the build caches at fixed directories in the checkout, so a
    kernel a later change builds with them is built once per checkout (the
    port's own nvcc builds go to ``navtech_radar_slam_torch/_build/``,
    inside the checkout too)."""
    for var, rel in CACHE_DIRS.items():
        path = root / rel
        path.mkdir(parents=True, exist_ok=True)
        os.environ[var] = str(path)


def forbidden_loaded() -> List[str]:
    """Loaded modules whose top-level name, compared whole, is forbidden."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


class SetupClock:
    """Set-up time from the process's start, split into named phases."""

    def __init__(self, t0: float):
        self.t0 = self._last = t0
        self.phases: Dict[str, float] = {}

    def mark(self, phase: str) -> None:
        now = time.perf_counter()
        self.phases[phase] = self.phases.get(phase, 0.0) + now - self._last
        self._last = now

    def total(self) -> float:
        return self._last - self.t0

    def line(self) -> str:
        parts = ", ".join(f"{k} {v:.3f} s" for k, v in self.phases.items())
        return f"setup_s {self.total():.3f}: {parts}"


@dataclasses.dataclass
class Context:
    """What a runner is handed for one run."""

    workload: str
    config: dict          # the SlamConfig sections of the configuration file
    traffic: dict
    seed: int
    device: str
    limits: dict
    clock: SetupClock


@dataclasses.dataclass
class Records:
    """What the per-layer readers read: the benchmark's own spans (name,
    start s, end s), counts of the work, the shapes the counts of a kernel
    need, and the device trace's summary (``tracing.TraceSummary``) of the
    traced steps."""

    spans: List[Tuple[str, float, float]] = dataclasses.field(default_factory=list)
    counts: Dict[str, float] = dataclasses.field(default_factory=dict)
    shapes: Dict[str, int] = dataclasses.field(default_factory=dict)
    trace: Optional[object] = None


@dataclasses.dataclass
class Outcome:
    """A runner's run: the end-to-end values by metric name, the work
    attempted and failed, the records the readers take, and the runner's
    state, which its ``readings`` judge."""

    end_to_end: Dict[str, float]
    attempted: int
    failed: int
    records: Records
    state: object = None
    #: lines for standard error (what a reader of the run's log wants)
    notes: List[str] = dataclasses.field(default_factory=list)


def judge(readings: Dict[str, float], lims: Dict[str, float]) -> Tuple[bool, dict]:
    """Each number against its limit: correct when every number has one and
    none passes it (a missing or non-finite number fails)."""
    checks = {}
    ok = True
    for name, limit in lims.items():
        v = readings.get(name)
        good = v is not None and math.isfinite(v) and v <= limit
        ok &= good
        checks[name] = {"value": v, "limit": limit}
    return ok, checks


def check_lines(checks: dict) -> List[str]:
    return [f"check {name}: {c['value']!r} (limit {c['limit']!r})"
            for name, c in checks.items()]
