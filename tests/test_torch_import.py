"""The port imports torch, never jax, nothing of the JAX package, and
neither OpenCV nor matplotlib."""

import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]

MODULES = [
    "navtech_radar_slam_torch",
    "navtech_radar_slam_torch.config",
    "navtech_radar_slam_torch.data",
    "navtech_radar_slam_torch.data.packing",
    "navtech_radar_slam_torch.data.png",
    "navtech_radar_slam_torch.data.mulran",
    "navtech_radar_slam_torch.data.make_sequence",
    "navtech_radar_slam_torch.data.synthetic",
    "navtech_radar_slam_torch.utils.device",
    "navtech_radar_slam_torch.utils.geometry",
    "navtech_radar_slam_torch.utils.checkpoint",
    "navtech_radar_slam_torch.utils.metrics",
    "navtech_radar_slam_torch.utils.profiling",
    "navtech_radar_slam_torch.utils.viz",
    "navtech_radar_slam_torch.ops.cen2019",
    "navtech_radar_slam_torch.ops.features",
    "navtech_radar_slam_torch.ops.registration",
    "navtech_radar_slam_torch.ops.kernels.cen_peaks",
    "navtech_radar_slam_torch.ops.kernels.sc_corr",
    "navtech_radar_slam_torch.ops.kernels.nn_dist",
    "navtech_radar_slam_torch.ops.kernels.build",
    "navtech_radar_slam_torch.ops.voxel",
    "navtech_radar_slam_torch.ops.scancontext",
    "navtech_radar_slam_torch.ops.icp",
    "navtech_radar_slam_torch.models.odometry",
    "navtech_radar_slam_torch.models.posegraph",
    "navtech_radar_slam_torch.models.slam",
    "navtech_radar_slam_torch.state",
    "navtech_radar_slam_torch.entry",
    "navtech_radar_slam_torch.eval",
    "navtech_radar_slam_torch.cli",
    "navtech_radar_slam_torch.runtime",
    "navtech_radar_slam_torch.runtime.loader",
    "navtech_radar_slam_torch.parallel",
    "navtech_radar_slam_torch.parallel.mesh",
    "navtech_radar_slam_torch.parallel.launch",
    "navtech_radar_slam_torch.parallel.sharded_bank",
    "navtech_radar_slam_torch.parallel.dist_pgo",
    "navtech_radar_slam_torch.parallel.sharded_odometry",
]


def _run(code: str) -> str:
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    return proc.stdout


def test_import_leaves_jax_out():
    """A fresh interpreter that imports every module of the port has no jax
    module loaded, no module of the JAX package, and neither cv2 nor
    matplotlib."""
    out = _run(
        "import importlib, sys\n"
        f"for m in {MODULES!r}: importlib.import_module(m)\n"
        "print(sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m.startswith('jaxlib')))\n"
        "print(sorted(m for m in sys.modules if m.startswith('navtech_radar_slam_tpu')))\n"
        "print(sorted(m for m in sys.modules if m.split('.')[0] in ('cv2', 'matplotlib')))\n"
    )
    jax_mods, tpu_mods, image_mods = out.strip().splitlines()
    assert jax_mods == "[]", jax_mods
    assert tpu_mods == "[]", tpu_mods
    assert image_mods == "[]", image_mods


def test_import_turns_tf32_off():
    """Importing the package sets true-fp32 matmuls and convolutions."""
    out = _run(
        "import torch\n"
        "torch.backends.cuda.matmul.allow_tf32 = True\n"
        "torch.backends.cudnn.allow_tf32 = True\n"
        "import navtech_radar_slam_torch\n"
        "print(torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)\n"
    )
    assert out.split() == ["False", "False"]
