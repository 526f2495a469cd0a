"""navtech_radar_slam_torch — the radar SLAM system in PyTorch and CUDA.

A port of ``navtech_radar_slam_tpu`` (JAX on a TPU) to PyTorch on an
NVIDIA Hopper GPU.  The JAX package stays the reference: every module here
carries the name of its JAX counterpart, and the tests hold each against it
on the same numpy inputs.

Ported so far: the radar-odometry front-end (``models.odometry``), one
stream or B streams in one call (``make_batched_odometry_step``), and the
full-SLAM engine (``models.slam.SlamEngine``), per scan and streamed:

  polar scan -> cen2019 peaks  (ops.cen2019; CUDA kernel ops.kernels.cen_peaks)
             -> constellation descriptors + matching   (ops.features)
             -> ORORA-style robust registration        (ops.registration)
             -> two de-skew re-registrations, host pose in f64
  keyframe   -> voxel filter, ScanContext descriptor, bank insert
             -> loop search  (ops.scancontext; CUDA kernel ops.kernels.sc_corr)
             -> submap ICP   (ops.icp; CUDA kernel ops.kernels.nn_dist)
             -> robust pose-graph refine               (models.posegraph)
  B streams  -> one K1 x B launch for the B scans, one top-k for the batch,
                the registration under torch.func.vmap
  chunk      -> odometry of S scans on the device, keyframes in segments of
                up to 16 slots: one T-slot search (K2-T) per segment and one
                T-slot nearest-neighbour launch (K3-T) per ICP iteration

and the command line around them (``cli``: MulRan PNG sequences read by
``data.mulran`` on the port's own PNG decoder, checkpoint / resume with
``utils.checkpoint``, multi-session, loop-debug dumps, ``StageTimers``,
``prewarm``, and the evaluation in ``eval`` and ``utils.metrics``), and
the multi-device layer on ``torch.distributed`` (``parallel``: the
descriptor bank split over the ranks, the distributed pose-graph solve,
data-parallel odometry, and the engine's and the command line's mesh).
Outside the engine: the reference's SCManager interface
(``ops.scancontext.ScanContextManager``: one K2 launch a detect) and the
multi-session query ``detect_loop_between_sessions``, the Cartesian
utilities of ``ops.features`` (``polar_to_cartesian``,
``patch_descriptors``), and ``models.odometry.make_odometry_step``.

The package stands alone: it keeps its own copies of the configuration
(``config``) and of the data helpers it uses (``data``: the simulator, the
4-bit packing, the MulRan reader and writer), and imports nothing of the
JAX package, nor jax or OpenCV.

The entry points (``entry``, ``RadarOdometry``, ``SlamEngine``,
``PoseGraph``, ``empty_graph``, ``ScanContextManager``, the step factories)
run on the card unless the caller passes ``device="cpu"``, and raise when
no card is there.  Functions take tensors
on an explicit device; a CUDA tensor always runs the hand-written kernels
(there is no fallback), a CPU tensor their plain PyTorch twins.
"""

import torch

# True float32 matmuls.  The JAX code asks for full fp32 precision in the
# descriptor contraction (ops/features.py: constellation_descriptors), the
# correlation matmul of the matcher and the Gauss-Newton normal equations of
# the registration (ops/registration.py: anisotropic_refine), which contract
# metric coordinates of up to ~200 m: TF32's 10-bit mantissa there biases the
# solve by centimetres per frame.  TF32 on those paths is a fault, not noise.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

__version__ = "0.1.0"
