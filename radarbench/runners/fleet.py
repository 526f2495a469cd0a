"""Runner ``fleet``: B scan streams through one batched odometry step.

The entry the window drives is the step that the port's
``models.odometry.make_batched_odometry_step(cfg)`` returns.  The traffic
file gives B (``streams``), the pool (one closed circuit lap of
``lap_scans`` motion-distorted scans at ``speed_mps``, radius lap length /
2 pi, in a world drawn from the seed: ``world``), the warm-up and the
traced steps.  Stream b at step t takes scan (b + t) mod ``lap_scans``, so
each stream drives a continuous loop; the twists carry as the caller of
the step carries them (``torch.where(ok, rel_pose, twists)``).

Each step's relative poses, ``ok`` flags and inlier counts are read back
to the host: that read ends the step.  ``odo_scans_per_s`` is all scans of
all steps whose poses reached the host in the window over the window.

The output check compares against the plain reference
(``reference/odometry.py``): the last step's carried features of every
stream (K1 x B, the top-k, the descriptors), and for every stream one step
drawn from the seed among the window's steps, its relative pose and
``ok`` (matching and ORORA registration), registered again by the
reference with the twist the reference carries itself (``reference_chain``;
``compare`` says how the two are judged).
"""

from __future__ import annotations

import dataclasses
import math
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from radarbench import harness, render, tracing
from radarbench.reference import odometry as ref_odo
from radarbench.reference.precision import FP32, TF32, Precision, true_fp32


@dataclasses.dataclass
class State:
    ctx: harness.Context
    pool: torch.Tensor          # (L, NA, NBp) uint8
    step: object
    az: torch.Tensor
    carry: object
    twists: torch.Tensor
    #: per step t (from 1): host copies of its rel (B, 3) and ok (B,)
    rel: List[np.ndarray] = dataclasses.field(default_factory=list)
    ok: List[np.ndarray] = dataclasses.field(default_factory=list)
    spans: List[tuple] = dataclasses.field(default_factory=list)
    #: steps of the measured window: t in [first, last]
    window: tuple = (0, -1)

    @property
    def streams(self) -> int:
        return self.twists.shape[0]

    @property
    def lap(self) -> int:
        return self.pool.shape[0]


def scan_index(b: np.ndarray, t: int, lap: int) -> np.ndarray:
    """The pool scan stream(s) ``b`` take at step ``t``."""
    return (b + t) % lap


def lap_poses(traffic: dict, rate_hz: float, device) -> torch.Tensor:
    """(L + 1, 3) poses of one lap: the pool's sweep starts and, last, the
    lap's start again (the last sweep's end)."""
    lap = traffic["lap_scans"]
    step_m = traffic["speed_mps"] / rate_hz
    return render.circuit(lap + 1, lap * step_m / (2 * math.pi), traffic["speed_mps"],
                          rate_hz, device)


def make_pool(ctx: harness.Context, device) -> torch.Tensor:
    radar = ctx.config["radar"]
    poses = lap_poses(ctx.traffic, radar["scan_rate_hz"], device)
    return render.render_pool(ctx.seed, poses[:-1], poses[1:].clone(), radar,
                              ctx.traffic["world"])


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def setup(ctx: harness.Context) -> State:
    """Import the port, load K1 x B, render the pool, seed the carry and run
    the warm-up steps."""
    from navtech_radar_slam_torch.config import SlamConfig
    from navtech_radar_slam_torch.models import odometry

    dev = ctx.device
    clock = ctx.clock
    clock.mark("import")
    if torch.device(dev).type == "cuda":
        from navtech_radar_slam_torch.ops.kernels import cen_peaks
        cen_peaks.LIBRARY.load()
        clock.mark("library")
    cfg = SlamConfig.from_dict(ctx.config)
    pool = make_pool(ctx, dev)
    _sync(dev)
    clock.mark("render")
    n = ctx.traffic["streams"]
    az = torch.as_tensor(odometry.default_azimuths(cfg), device=dev)
    b = np.arange(n)
    carry = odometry.extract_scan_features_batched(
        pool[torch.as_tensor(scan_index(b, 0, pool.shape[0]), device=dev)], az, cfg)
    st = State(ctx=ctx, pool=pool, az=az, carry=carry,
               step=odometry.make_batched_odometry_step(cfg, device=dev),
               twists=torch.zeros((n, 3), device=dev))
    for _ in range(ctx.traffic["warm_steps"]):
        one_step(st)
    _sync(dev)
    clock.mark("warm")
    return st


def one_step(st: State) -> None:
    """Step t = len(st.rel) + 1 of every stream, its results read back."""
    t0 = time.perf_counter()
    t = len(st.rel) + 1
    idx = scan_index(np.arange(st.streams), t, st.lap)
    powers = st.pool[torch.as_tensor(idx, device=st.pool.device)]
    tw_in = st.twists
    st.carry, res, _ = st.step(powers, st.az, st.carry, tw_in)
    st.twists = torch.where(res.ok[:, None], res.rel_pose, tw_in)
    host = torch.cat([res.rel_pose, res.ok[:, None].to(torch.float32),
                      res.num_inliers[:, None].to(torch.float32)], dim=1).cpu().numpy()
    st.rel.append(host[:, :3].copy())
    st.ok.append(host[:, 3] > 0.5)
    st.spans.append(("fleet.step", t0, time.perf_counter()))


def measure(st: State, seconds: float) -> Dict[str, float]:
    """The measured window: whole steps until ``seconds`` have passed."""
    first = len(st.rel) + 1
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        one_step(st)
    elapsed = time.perf_counter() - t0
    st.window = (first, len(st.rel))
    steps = st.window[1] - first + 1
    return {"steps": steps, "scans": steps * st.streams, "elapsed_s": elapsed}


# -- the output check ------------------------------------------------------


@dataclasses.dataclass
class Answers:
    """What is judged: the peaks and descriptors of each scan the last
    step's carry holds (``carried_scans``); per sampled step its relative
    pose and ``ok``."""

    xy: torch.Tensor
    desc: torch.Tensor
    power: torch.Tensor
    valid: torch.Tensor
    ray_frac: torch.Tensor
    rel: np.ndarray
    ok: np.ndarray


def sample(st: State) -> tuple:
    """One window step per stream, drawn from the seed: (steps, prev
    scans, curr scans)."""
    rng = np.random.default_rng([st.ctx.seed, 1])
    b = np.arange(st.streams)
    ts = rng.integers(st.window[0], st.window[1] + 1, size=st.streams)
    return ts, scan_index(b, ts - 1, st.lap), scan_index(b, ts, st.lap)


def carried_scans(st: State) -> np.ndarray:
    """The scans the last step's carry holds, stream by stream."""
    return scan_index(np.arange(st.streams), len(st.rel), st.lap)


def program_answers(st: State) -> Answers:
    b = np.arange(st.streams)
    ts = sample(st)[0]
    c = st.carry
    return Answers(xy=c.xy, desc=c.desc, power=c.power, valid=c.valid, ray_frac=c.ray_frac,
                   rel=np.stack([st.rel[t - 1][i] for i, t in zip(b, ts)]),
                   ok=np.array([st.ok[t - 1][i] for i, t in zip(b, ts)]))


def reference_chain(register, steps: np.ndarray, lap: int) -> tuple:
    """Each stream b's (rel, ok) at step ``steps[b]``, registered with the
    twist the reference carries into that step itself, as ``one_step``
    carries the program's: zeros into step 1, then ``where(ok, rel,
    twist)``.

    ``register(prev scans, curr scans, twists)`` gives (rel, ok,
    first_ok) on the host; an answer whose first registration is ok does
    not depend on its twist.  So each stream is walked back from its step,
    registering with zero twists, to the latest step whose answer is exact
    so (first_ok, and ok or the stream's own step) or to step 1; then
    forward again, registering with the carried twist where the walk's
    answer was not exact.  (rel (B, 3), ok (B,))."""
    n = len(steps)
    streams = np.arange(n)
    zero = np.zeros((n, 3), np.float32)
    got = {}                       # (stream, step) -> (rel, ok, exact)
    j = steps.copy()
    open_ = np.ones(n, bool)
    while open_.any():
        at = np.flatnonzero(open_)
        rel, ok, first = register(scan_index(at, j[at] - 1, lap), scan_index(at, j[at], lap),
                                  zero[at])
        for k, b in enumerate(at):
            got[b, j[b]] = (rel[k], ok[k], first[k] or j[b] == 1)
        stop = (first & (ok | (j[at] == steps[at]))) | (j[at] == 1)
        open_[at[stop]] = False
        j[at[~stop]] -= 1
    # forward from each stream's anchor j: the twist into j + 1
    twist = np.stack([np.where(got[b, j[b]][1], got[b, j[b]][0], 0.0) for b in streams])
    out_rel = np.stack([got[b, j[b]][0] for b in streams]).astype(np.float32)
    out_ok = np.array([got[b, j[b]][1] for b in streams])
    s = j + 1
    while (s <= steps).any():
        live = np.flatnonzero(s <= steps)
        redo = np.array([b for b in live if not got.get((b, s[b]), (0, 0, False))[2]], int)
        if redo.size:
            rel, ok, _ = register(scan_index(redo, s[redo] - 1, lap),
                                  scan_index(redo, s[redo], lap), twist[redo].astype(np.float32))
            for k, b in enumerate(redo):
                got[b, s[b]] = (rel[k], ok[k], True)
        for b in live:
            r, o, _ = got[b, s[b]]
            out_rel[b], out_ok[b] = r, o
            twist[b] = r if o else twist[b]
        s[live] += 1
    return out_rel, out_ok


class Extracted:
    """The reference's features of pool scans, each extracted once."""

    def __init__(self, pool: torch.Tensor, cfg, prec: Precision):
        self.pool, self.cfg, self.prec = pool, cfg, prec
        self.row: Dict[int, int] = {}
        self.feats: Optional[ref_odo.Feats] = None

    def rows(self, scans) -> np.ndarray:
        new = [int(s) for s in np.unique(scans) if int(s) not in self.row]
        if new:
            f = ref_odo.extract(self.pool[torch.as_tensor(new, device=self.pool.device)],
                                self.cfg, self.prec)
            self.row.update({s: len(self.row) + i for i, s in enumerate(new)})
            self.feats = f if self.feats is None else ref_odo.Feats(
                *(torch.cat([a, b]) for a, b in zip(self.feats, f)))
        return np.array([self.row[int(s)] for s in scans], np.int64)

    def take(self, scans) -> ref_odo.Feats:
        at = torch.as_tensor(self.rows(scans), device=self.pool.device)
        return ref_odo.Feats(*(f[at] for f in self.feats))

    def adopt(self, scans, xy, power, valid, ray_frac) -> None:
        """Take the program's peaks of ``scans`` in place of the
        reference's, and describe them."""
        at = torch.as_tensor(self.rows(scans), device=self.pool.device)
        desc = ref_odo.describe(xy, power, valid, self.cfg, self.prec)
        for dst, src in zip(self.feats, ref_odo.Feats(xy, desc, power, valid, ray_frac)):
            dst[at] = src

    def register(self, prev, curr, twists) -> tuple:
        out = ref_odo.register_pairs(self.feats, self.rows(prev), self.rows(curr),
                                     torch.as_tensor(twists, device=self.pool.device),
                                     self.cfg, self.prec)
        return tuple(x.cpu().numpy() for x in out)


def _extracted(st: State, prec: Precision) -> Extracted:
    true_fp32()
    ex = Extracted(st.pool, ref_odo.sections(st.ctx.config), prec)
    _, prev, curr = sample(st)
    ex.rows(np.concatenate([carried_scans(st), prev, curr]))
    return ex


def reference_answers(st: State, prec: Precision) -> Answers:
    """The plain reference's own answers to the questions, from the pool's
    scans alone (the control's side, in ``prec``)."""
    ex = _extracted(st, prec)
    rel, ok = reference_chain(ex.register, sample(st)[0], st.lap)
    f = ex.take(carried_scans(st))
    return Answers(xy=f.xy, desc=f.desc, power=f.power, valid=f.valid, ray_frac=f.ray_frac,
                   rel=rel, ok=ok)


def _peaks(xy: np.ndarray, power: np.ndarray, valid: np.ndarray) -> Dict[tuple, float]:
    """A scan's valid peaks: {position's float32 bits: power}."""
    return dict(zip(map(tuple, xy.view(np.int32)[valid].tolist()), power[valid].tolist()))


def compare(st: State, got: Answers, prec: Precision = FP32) -> Dict[str, float]:
    """The numbers the limits hold, ``got`` against the reference in
    ``prec``.

    A scan's peaks can differ from the reference's by a gate flipped at one
    ulp: K1 x B and the plain path take the row sums behind the gates'
    means and variances in other orders, so now and then one weak peak is
    kept by one side only (PERF.md §2).  That changes the scan's
    descriptors and the poses of the pairs that hold it by as much as the
    control does.  So each carried scan's peak positions are compared as a
    set: ``scans_differing_share`` is the share of scans whose sets differ
    at all, ``scans_beyond_one_flip`` the number whose sets differ by more
    than one peak in and one out.  Where a scan's set is within that, the
    reference takes the program's peaks of that scan and works out their
    descriptors and every registration that holds the scan itself.  Then,
    over every scan not beyond it, the powers of the peaks both sides hold
    (``power_gap``, the widest gap) and the descriptors slot by slot
    (``descriptor_gap``); ``ok`` and the poses at every sampled step
    (``ok_differing``; the widest pose gap where both are ok)."""
    ex = _extracted(st, prec)
    scans = carried_scans(st)
    want = ex.take(scans)
    gv, rv = got.valid, want.valid
    slot_equal = ((gv == rv) & ~(gv & (got.xy != want.xy).any(-1))).all(-1)
    power_gaps = [float(torch.where(gv & rv & slot_equal[:, None], got.power - want.power,
                                    torch.zeros_like(got.power)).abs().max().item())]
    slot_equal = slot_equal.cpu().numpy()
    differing = np.zeros(st.streams, bool)
    beyond = np.zeros(st.streams, bool)
    for s in np.flatnonzero(~slot_equal):
        g = _peaks(got.xy[s].cpu().numpy(), got.power[s].cpu().numpy(), gv[s].cpu().numpy())
        r = _peaks(want.xy[s].cpu().numpy(), want.power[s].cpu().numpy(), rv[s].cpu().numpy())
        differing[s] = g.keys() != r.keys()
        beyond[s] = len(g.keys() - r.keys()) > 1 or len(r.keys() - g.keys()) > 1
        if not beyond[s]:
            power_gaps += [abs(g[k] - r[k]) for k in g.keys() & r.keys()]
    adopt = np.flatnonzero(~slot_equal & ~beyond)
    if adopt.size:
        at = torch.as_tensor(adopt, device=gv.device)
        ex.adopt(scans[adopt], got.xy[at], got.power[at], gv[at], got.ray_frac[at])
        want = ex.take(scans)
    judged = (gv & want.valid & torch.as_tensor(~beyond, device=gv.device)[:, None])
    gap = torch.where(judged[..., None], (got.desc - want.desc).abs(),
                      torch.zeros_like(got.desc)).max()
    rel, ok = reference_chain(ex.register, sample(st)[0], st.lap)
    both = got.ok & ok
    d = got.rel.astype(np.float64) - rel.astype(np.float64)
    dth = np.abs(np.arctan2(np.sin(d[:, 2]), np.cos(d[:, 2])))
    return {
        "scans_differing_share": 100.0 * float(differing.mean()),
        "scans_beyond_one_flip": float(beyond.sum()),
        "power_gap": max(power_gaps),
        "descriptor_gap": float(gap.item()),
        "ok_differing": float((got.ok != ok).sum()),
        "rel_gap_m": float(np.abs(d[both, :2]).max()) if both.any() else 0.0,
        "rel_gap_rad": float(dth[both].max()) if both.any() else 0.0,
    }


def readings(st: State) -> Dict[str, float]:
    """The program's numbers against the reference."""
    return compare(st, program_answers(st))


def control_readings(st: State) -> Dict[str, float]:
    """The control's numbers: the reference at TF32 in the program's place."""
    return compare(st, reference_answers(st, TF32))


# -- one run ---------------------------------------------------------------


def run(ctx: harness.Context, seconds: float, trace: bool) -> harness.Outcome:
    st = setup(ctx)
    win = measure(st, seconds)
    rec = harness.Records(
        spans=list(st.spans[-win["steps"]:]),
        counts={"steps": win["steps"], "streams": st.streams},
        shapes={"streams": st.streams, "na": int(st.pool.shape[1]),
                "nbp": int(st.pool.shape[2])})
    if trace:
        n = ctx.traffic["traced_steps"]
        with tracing.DeviceTrace(ctx.device) as tr:
            for _ in range(n):
                one_step(st)
        rec.trace = tr.summary
        rec.counts["traced_steps"] = n
    lo, hi = st.window
    failed = int(sum((~st.ok[t - 1]).sum() for t in range(lo, hi + 1)))
    ms = sorted(1e3 * (b - a) for _, a, b in rec.spans)
    note = (f"window: {win['steps']} steps of {st.streams} streams in {win['elapsed_s']:.3f} s; "
            f"step ms min {ms[0]:.1f} median {ms[len(ms) // 2]:.1f} max {ms[-1]:.1f}")
    return harness.Outcome(end_to_end={"odo_scans_per_s": win["scans"] / win["elapsed_s"]},
                           attempted=win["scans"], failed=failed, records=rec, state=st,
                           notes=[note])


def release(st: State) -> None:
    """Drop what only the program needs, once the window has closed."""
    st.step = None
