"""Configuration system of the PyTorch port.

A copy of the JAX package's ``config.py`` (the same dataclass names, fields,
defaults and JSON loading), so the port imports nothing of that package and
the files in ``configs/`` load the same in both.

The reference exposes only two roslaunch params (`keyframe_meter_gap`,
`sc_dist_thres`, sc_pgo.launch:3-4) and hard-codes every other knob
(SURVEY §5.6 inventory).  Here every constant is a typed dataclass field;
defaults reproduce the reference's *effective* launch configuration
(i.e. launch overrides applied, not the in-code defaults they shadow).

Configs are immutable (frozen dataclasses) so they can be closed over by
jitted functions; anything that must be traced is an explicit argument.
Serialization: `to_dict`/`from_dict` + JSON round-trip for checkpointing.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import Any, Dict


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclass(frozen=True)
class RadarConfig:
    """Navtech CIR204-H polar scan geometry (MulRan "polar oxford form",
    README.md:70-71)."""

    num_azimuths: int = 400
    num_range_bins: int = 3360
    range_resolution: float = 0.059576  # m / bin (MulRan Navtech)
    #: leading image columns that hold per-ray metadata, not power returns:
    #: 8 bytes UNIX timestamp + 2 bytes azimuth encoder + 1 byte validity
    #: (oxford radar robotcar format)
    meta_columns: int = 11
    scan_rate_hz: float = 4.0

    @property
    def padded_range_bins(self) -> int:
        """Range bins padded to a lane multiple for TPU tiling."""
        return _round_up(self.num_range_bins, 128)

    @property
    def max_range(self) -> float:
        return self.num_range_bins * self.range_resolution


@dataclass(frozen=True)
class FeatureConfig:
    """cen2019 polar peak detector + patch descriptors.

    The reference's front-end (ORORA submodule, absent; SURVEY §1 L1) uses
    cen2019 feature extraction and ORB+Hamming matching on the Cartesian
    image.  TPU-first redesign: cen2019 as vectorized/Pallas image ops,
    descriptors as normalized Cartesian patches matched with one MXU matmul.
    """

    detector: str = "cen2019"  # or "cen2018"
    #: zero out returns closer than this many bins (sensor ringing)
    min_range_bins: int = 58
    #: gaussian smoothing sigma along range (bins) before gradient
    smooth_sigma_bins: float = 2.0
    #: cen2018 threshold: mean + zq * std per azimuth
    cen2018_zq: float = 3.0
    #: cen2019 additional noise gate: peaks must exceed mean + peak_zq * std
    #: of their azimuth's power distribution (rejects noise-floor regions).
    #: An implementation addition over the paper's pure h > mean(h)
    #: statistic (FIDELITY.md); <= 0 disables it (paper-pure mask)
    peak_zq: float = 3.0
    #: static feature capacity (padded; validity-masked)
    max_features: int = 1024
    #: peak selection recall target: < 1.0 uses the TPU-native tiled
    #: approximate top-k (lax.approx_max_k; exact on CPU) — the weakest
    #: ~2-5 % of peaks may be dropped; 1.0 forces the exact global sort
    topk_recall: float = 0.95
    #: Cartesian image used for descriptors
    cart_size: int = 512
    cart_resolution: float = 0.5  # m / pixel  (512 px -> 256 m square)
    #: descriptor patch edge (pixels); descriptor dim = patch_size**2
    patch_size: int = 8
    #: constellation descriptor: window edge (m) and grid cells per edge
    #: (descriptor dim = desc_grid**2); see ops.features.constellation_descriptors
    desc_window: float = 64.0
    desc_grid: int = 16
    #: matching: take top-k mutual matches by descriptor correlation
    max_matches: int = 512
    #: Lowe-style ratio test threshold on correlation distance
    ratio_test: float = 0.95
    #: de-skew features for platform motion during the scan sweep using the
    #: previous frame's velocity estimate (yeti capability, README.md:100-111)
    motion_compensation: bool = True
    #: correct the FMCW Doppler range shift Δr = beta * (range rate) induced
    #: by platform motion (the second yeti capability the reference inherits,
    #: README.md:100-111).  Off by default, matching the upstream default.
    doppler_compensation: bool = False
    #: Doppler coupling beta = f_carrier / chirp_slope (seconds); 0.049 s is
    #: the published value for the Navtech CIR204-H family (yeti).
    doppler_beta: float = 0.049


@dataclass(frozen=True)
class RegistrationConfig:
    """ORORA-style outlier-robust SE(2) estimation (arXiv:2303.01876;
    SURVEY §1 L1 step 4).  Anisotropic uncertainty + GNC-TLS rotation +
    decoupled component-wise translation."""

    #: measurement noise: along-range and tangential (azimuth) sigma in m.
    sigma_range: float = 0.25
    sigma_azimuth_rad: float = 0.01745  # ~1 deg; tangential sigma = r * this
    #: pairwise-consistency gate (m) for spectral/max-clique pruning
    consistency_gate: float = 1.0
    #: power-iteration steps for spectral inlier selection
    spectral_iters: int = 20
    #: keep top-k correspondences by spectral score
    spectral_top_k: int = 256
    #: GNC-TLS schedule
    gnc_max_iters: int = 32
    gnc_div_factor: float = 1.4
    #: TLS inlier cost threshold (squared Mahalanobis)
    gnc_barc2: float = 1.0
    #: translation: iterations of IRLS component-wise robust estimation
    cote_iters: int = 10
    #: joint anisotropic GN refinement iterations over the inlier set
    refine_iters: int = 8
    #: minimum final inliers to trust a registration result
    min_inliers: int = 8
    #: after this many consecutive failed registrations, stop extrapolating
    #: the constant-velocity fallback (coast guard)
    max_coast_frames: int = 5


@dataclass(frozen=True)
class KeyframeConfig:
    """Keyframe gating (laserPosegraphOptimization.cpp:455-470)."""

    #: translation accumulator gate; launch override 0.2 (sc_pgo.launch:3)
    keyframe_meter_gap: float = 0.2
    #: keyframe cloud voxel size (laserPosegraphOptimization.cpp:687-689)
    keyframe_voxel_size: float = 0.4
    #: static keyframe capacity of the device-resident bank (ring of blocks).
    #: Per-keyframe stored points are features.max_features (the odometry
    #: front-end's padded cloud is stored as-is); the ICP problem sizes are
    #: bounded separately by icp.max_query_points / max_target_points.
    max_keyframes: int = 4096


@dataclass(frozen=True)
class ScanContextConfig:
    """ScanContext descriptor + search (Scancontext.h:83-103).

    The KD-tree/ring-key machinery of the reference exists because it is
    scalar C++; here the bank search is one batched correlation, but the
    ring-key prefilter is kept as an optional cheap first stage for the
    sharded multi-host path."""

    num_ring: int = 20          # PC_NUM_RING (h:85)
    num_sector: int = 60        # PC_NUM_SECTOR (h:86)
    max_radius: float = 80.0    # PC_MAX_RADIUS (h:87)
    lidar_height: float = 2.0   # z lift added before binning (h:83)
    #: build the descriptor from only the strongest K features (the caller's
    #: cloud is in detector-power order — slot index IS the strength rank).
    #: The weak tail of a large feature budget is speckle-unstable and
    #: scrambles the occupancy image: measured same-pose SC distance 0.62
    #: with the full 1024-feature budget vs 0.00 with the strongest 512
    #: (true one-lap revisit 0.09, unrelated pose 0.74 — the 0.45 gate only
    #: works below the cap).  <= 0 uses every valid feature.
    max_desc_features: int = 512
    num_exclude_recent: int = 30    # NUM_EXCLUDE_RECENT (h:92)
    num_candidates: int = 10        # NUM_CANDIDATES_FROM_TREE (h:93) is 3 on
    # 20-dim ring keys; batched search makes a larger candidate set free.
    #: SEARCH_RATIO (h:96): in search_mode="ringkey" the column-shift search
    #: is restricted to ± num_sector * search_ratio shifts around the
    #: sector-key alignment (fastAlignUsingVkey + distanceBtnScanContext,
    #: Scancontext.cpp:93-148).  <= 0 searches all shifts exhaustively (the
    #: "full" mode always does — the whole shift axis is one matmul there).
    search_ratio: float = 0.1
    sc_dist_thres: float = 0.45     # launch override (sc_pgo.launch:4)
    #: reference rebuilds its KD-tree every 30 inserts (h:103, cpp:347-360),
    #: so ring-key queries between rebuilds search a STALE candidate set.
    #: search_mode="ringkey" reproduces that staleness deterministically:
    #: the searchable bank is the largest multiple of this period <=
    #: num_keyframes (staleness bound <= period inserts, same as the
    #: reference; the schedule is keyframe-count- rather than
    #: call-count-based).  <= 1 disables (always-fresh bank — what the
    #: batched "full" search gives for free, no tree to rebuild).
    tree_making_period: int = 30
    #: loop-detection cadence in keyframes (reference: 1 Hz thread,
    #: laserPosegraphOptimization.cpp:575-585; radar keyframes ~4 Hz)
    detect_every_n_keyframes: int = 1
    #: "full" = whole-bank all-shift correlation (TPU-native default);
    #: "ringkey" = ring-key KNN prefilter then per-candidate distance
    #: (the reference's two-stage pipeline, Scancontext.cpp:331-422)
    search_mode: str = "full"


@dataclass(frozen=True)
class IcpConfig:
    """Submap-to-scan ICP loop verification
    (laserPosegraphOptimization.cpp:330-406).

    Fitness-gate semantics: the reference accepts a loop iff PCL's fitness
    (mean squared NN distance) <= 0.3 after voxelizing the stacked submap at
    0.4 m (cpp:347-351, 389).  That absolute gate assumes a particular
    feature-noise scale; radar feature localization error grows with range
    (tangential sigma ~ r * sigma_azimuth), so a fixed m² threshold is
    either too strict at long range or too lax up close.  The TPU-native
    default is therefore ``fitness_metric="whitened"``: each correspondence's
    squared distance is normalized by its expected variance
    2*(sigma_range² + (r * sigma_azimuth)²) from the same anisotropic noise
    model the ORORA registration uses, making the gate scale-free (≈1.0 for
    a perfectly aligned loop, >> 1 for a false one).  Set
    ``fitness_metric="pcl"`` + ``fitness_thresh=0.3`` for reference-parity
    gating."""

    submap_half_size: int = 25      # ±25 keyframes (line 358)
    max_corr_dist: float = 150.0    # setMaxCorrespondenceDistance (377)
    max_iters: int = 100            # setMaximumIterations (378)
    #: transformation epsilon (379). The reference's 1e-6 assumes double
    #: precision; in f32 the per-iteration step floor is ~1e-5, so the
    #: TPU default is 1e-4 (still far below any meaningful motion).
    epsilon: float = 1e-4
    #: euclidean fitness epsilon (setEuclideanFitnessEpsilon, line 381):
    #: converged when the mean-squared correspondence error changes by less
    #: than this between iterations (PCL DefaultConvergenceCriteria)
    euclidean_fitness_eps: float = 1e-6
    #: RELATIVE fitness-plateau exit (TPU-native addition, no PCL analogue):
    #: also converged when |Δmse| < rel_fitness_eps * mse.  With speckle
    #: noise the NN assignments oscillate forever at the optimum — the step
    #: never falls below epsilon and the ABSOLUTE 1e-6 m² criterion never
    #: fires at mse ~1e-2 m², so every verification ground the full
    #: max_iters (~100 x 1.5 ms on chip) for a pose already jittering
    #: within noise.  0.1 %/iteration improvement is far inside the gate's
    #: margin; <= 0 disables (strict PCL criteria only).
    rel_fitness_eps: float = 1e-3
    #: "whitened" (default): noise-normalized mean squared NN error, gate is
    #: scale-free (see class docstring); "pcl": raw mean squared NN distance
    #: in m² (reference getFitnessScore semantics, gate 0.3 at cpp:389)
    fitness_metric: str = "whitened"
    #: acceptance gate.  Whitened metric calibration: unit-test planted
    #: pairs separate at 0.002-0.01 (true) vs 36-42 (false); the r5
    #: 1600-scan perceptual-aliasing hardware run
    #: (artifacts/run1600_alias_r5) showed the REAL true-loop band tops out
    #: at 0.63 (median 0.40 — stacked submaps give a min-of-many-
    #: observations NN bias that sits true loops ~2-3x below the
    #: single-observation expectation of ~1.0), while near-clone FALSE
    #: matches (1.25 m geometric offset) measured 0.56-1.0.  0.75 keeps the
    #: whole measured true band with ~20 % margin and rejects the upper
    #: half of the clone band; clones below it are killed by the odometry
    #: consistency gate (below).  For fitness_metric="pcl" use the
    #: reference's 0.3 (cpp:389).
    fitness_thresh: float = 0.75
    #: odometry-consistency gate (TPU-native addition; no reference
    #: analogue — its absolute 0.3 m² gate implicitly rejects gross
    #: mismatches): accept a loop only if the ICP relative pose agrees
    #: with the graph-predicted relative pose within
    #: odom_consistency_abs + odom_consistency_frac * (odometry path
    #: length between the two keyframes).  A genuine closure disagrees by
    #: accumulated drift (radar odometry ~1-2 % of path); a perceptual-
    #: alias match claims two nodes hundreds of metres of path apart
    #: coincide — far outside any drift budget (the r5 aliasing run's 116
    #: false accepts all fail this gate; every true loop passes at <= 2 %
    #: of path).  Inter-session loops (no odometry path between sessions)
    #: are exempt.  frac <= 0 disables.
    odom_consistency_frac: float = 0.05
    odom_consistency_abs: float = 5.0
    #: noise model for the whitened metric (matches RegistrationConfig)
    whiten_sigma_range: float = 0.25
    whiten_sigma_azimuth_rad: float = 0.01745
    #: stacked-submap voxel filter (cpp:347-351); <= 0 disables
    submap_voxel_size: float = 0.4
    #: padded point capacities for the static-shape ICP problem
    max_query_points: int = 1024
    max_target_points: int = 8192
    #: use ScanContext yaw estimate to initialize ICP (the reference computes
    #: it and throws it away, laserPosegraphOptimization.cpp:561-562 — we use it)
    use_yaw_init: bool = True


@dataclass(frozen=True)
class PgoConfig:
    """Robust pose-graph optimization.

    Reference: GTSAM iSAM2, relinearizeThreshold 0.01, skip 1
    (laserPosegraphOptimization.cpp:679-682); noise models at 147-171.
    Here: full-graph robust Gauss-Newton/LM re-solved incrementally with
    warm starts; normal equations solved by preconditioned CG so the solve
    is matvec-only (TPU-friendly, shardable)."""

    # noise sigmas (stddev), matching reference variances.  The reference's
    # node-0 prior (variance 1e-12, cpp:149-151) has no sigma knob here: it
    # is realized as an EXACT gauge freeze (models/posegraph.residuals zeroes
    # node 0's tangent update), which is the 1e-12-variance limit without the
    # 1e6 whitening that would wreck f32 conditioning.
    odom_sigma_rot: float = 1e-3        # variance 1e-6 rad (153-156)
    odom_sigma_trans: float = 1e-2      # variance 1e-4 m
    loop_sigma: float = 0.5             # robustLoopNoise score 0.5 (158-163)
    loop_cauchy_k: float = 1.0          # Cauchy(1) (161)
    gps_sigma_xy: float = 31622.7766    # variance 1e9 (166-169)
    gps_sigma_alt: float = 15.8114      # variance 250
    gps_cauchy_k: float = 1.0
    # solver
    gn_iters: int = 8
    cg_iters: int = 64
    cg_tol: float = 1e-6
    #: max keyframes a verified loop decision may sit in the host's deferred
    #: queue before it is fetched and committed (the analogue of the
    #: reference's asynchronous scLoopICPBuf, unbounded with a backlog
    #: warning at 30, cpp:593-595).  1 = commit at the very next keyframe;
    #: larger values amortize the host<->device decision fetch over many
    #: keyframes AND widen the fused segment (deeper MXU batching of the
    #: per-keyframe detect+ICP).  16 keeps the commit lag at 4 s of sensor
    #: time — well under the reference's 30-entry backlog warning.  Output
    #: consumers (current_pose/trajectory/map/checkpoint) always drain.
    loop_commit_defer: int = 16
    lm_lambda0: float = 1e-6
    #: CG preconditioner: "chain" inverts the odometry-chain Hessian exactly
    #: via prefix/suffix scans (information crosses the whole graph each CG
    #: iteration); "jacobi" is the diagonal fallback
    preconditioner: str = "chain"
    #: graph capacities (padded static shapes).  GPS factors are stored
    #: densely per node (one optional factor per keyframe, exactly the
    #: reference's hasGPSforThisKF association, cpp:439-451), so their
    #: capacity IS max_nodes — there is no separate gps capacity knob.
    max_nodes: int = 4096
    max_loop_edges: int = 1024
    #: GPS<->odom association window (laserPosegraphOptimization.cpp:439)
    gps_time_window: float = 0.1
    use_gps: bool = False


@dataclass(frozen=True)
class MapConfig:
    """Aggregated map output (laserPosegraphOptimization.cpp:632-668)."""

    map_voxel_size: float = 0.2     # (691-692)
    keyframe_stride: int = 2        # every-2nd keyframe (634)
    path_rate_hz: float = 5.0       # (622)
    map_rate_hz: float = 0.1        # (659)


@dataclass(frozen=True)
class ParallelConfig:
    """Mesh sharding of the descriptor bank / keyframe map / PGO.

    The mesh itself is passed to SlamEngine (a parallel.mesh.Mesh, one
    rank's view of a torch.distributed process group) and the bank axis
    name is parallel.mesh.BANK_AXIS — neither is a config field."""

    #: sharded ring-key prefilter width: with scancontext.search_mode=
    #: "ringkey" each shard runs the full shift-correlation only on its
    #: shard_top_k best ring-key candidates (the reference's KD-tree k=3
    #: stage, Scancontext.cpp:367-374, done shard-locally); the global
    #: candidate set is the union over shards
    shard_top_k: int = 4


@dataclass(frozen=True)
class SlamConfig:
    radar: RadarConfig = field(default_factory=RadarConfig)
    features: FeatureConfig = field(default_factory=FeatureConfig)
    registration: RegistrationConfig = field(default_factory=RegistrationConfig)
    keyframes: KeyframeConfig = field(default_factory=KeyframeConfig)
    scancontext: ScanContextConfig = field(default_factory=ScanContextConfig)
    icp: IcpConfig = field(default_factory=IcpConfig)
    pgo: PgoConfig = field(default_factory=PgoConfig)
    map: MapConfig = field(default_factory=MapConfig)
    parallel: ParallelConfig = field(default_factory=ParallelConfig)
    #: run loop closure + PGO (launch arg `do_slam`,
    #: navtech_radar_slam_mulran.launch:3,7); False = odometry only
    do_slam: bool = True

    # -- serialization ------------------------------------------------------

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)

    def to_json(self) -> str:
        return json.dumps(self.to_dict(), indent=2)

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "SlamConfig":
        kwargs: Dict[str, Any] = {}
        for f in dataclasses.fields(cls):
            if f.name not in d:
                continue
            v = d[f.name]
            if dataclasses.is_dataclass(f.type) or f.name in _SUBCONFIGS:
                sub_cls = _SUBCONFIGS[f.name]
                known = {sf.name for sf in dataclasses.fields(sub_cls)}
                unknown = set(v) - known
                if unknown:
                    # configs/checkpoints written by older versions may carry
                    # knobs that were since removed (e.g. pgo.prior_sigma,
                    # pgo.max_gps_factors); ignore them rather than refusing
                    # to load the whole file, but say so
                    import warnings

                    warnings.warn(
                        f"config: ignoring unknown {f.name} field(s) "
                        f"{sorted(unknown)}", stacklevel=2,
                    )
                v = sub_cls(**{
                    k: tuple(x) if isinstance(x, list) else x
                    for k, x in v.items() if k in known
                })
            kwargs[f.name] = v
        return cls(**kwargs)

    @classmethod
    def from_json(cls, s: str) -> "SlamConfig":
        return cls.from_dict(json.loads(s))

    def replace(self, **kwargs) -> "SlamConfig":
        return dataclasses.replace(self, **kwargs)


_SUBCONFIGS = {
    "radar": RadarConfig,
    "features": FeatureConfig,
    "registration": RegistrationConfig,
    "keyframes": KeyframeConfig,
    "scancontext": ScanContextConfig,
    "icp": IcpConfig,
    "pgo": PgoConfig,
    "map": MapConfig,
    "parallel": ParallelConfig,
}
