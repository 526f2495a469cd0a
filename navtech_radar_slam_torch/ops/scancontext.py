"""ScanContext place recognition in PyTorch.

Counterpart of ``navtech_radar_slam_tpu.ops.scancontext``: the 20-ring x
60-sector polar occupancy descriptor (one scatter-max over the feature
cloud), ring and sector keys, the distance of a query against the whole
bank at every circular column shift, and the full-bank and ring-key loop
detectors.

``sc_shift_distance_matrix`` is the dispatch point of kernel K2: a CUDA
tensor launches ``ops.kernels.sc_corr`` (no fallback), a CPU tensor runs the
plain PyTorch version below.  ``sc_shift_distance_matrix_multi`` is that of
K2-T, T queries in one launch, which the streaming segment's T-slot
detectors (``detect_loop_multi``, ``detect_loop_ringkey_multi``) call.

The multi-session API: ``detect_loop_between_sessions`` (one query against
another session's bank, one K2 launch on the card) and
``ScanContextManager``, the reference's SCManager interface over one bank
on the device.  A detector's candidate is picked with ``gather``, not by
indexing with a 0-d tensor (which reads the index back to the host), so a
detect on the card waits for the device only where its caller reads the
candidate.
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple, Tuple

import torch

from navtech_radar_slam_torch.config import ScanContextConfig
from navtech_radar_slam_torch.ops.kernels import sc_corr
from navtech_radar_slam_torch.utils.device import DEFAULT_DEVICE, resolve_device
from navtech_radar_slam_torch.utils.ordered import halving_sum

_TWO_PI = 2.0 * math.pi


def make_scancontext(xy: torch.Tensor, z: torch.Tensor, valid: torch.Tensor,
                     cfg: ScanContextConfig) -> torch.Tensor:
    """Feature cloud -> (num_ring, num_sector) descriptor via scatter-max.

    xy: (..., K, 2) sensor-frame meters; z: (..., K) heights (0 for radar
    features); leading dims are independent clouds (the segment's T slots),
    each giving the descriptor it would give alone.
    With cfg.max_desc_features > 0 only the first that many slots (the
    strongest features: clouds come in detector-power order) contribute."""
    r = torch.sqrt(torch.sum(xy * xy, dim=-1))
    theta = torch.fmod(torch.atan2(xy[..., 1], xy[..., 0]), _TWO_PI)
    theta = torch.where(theta < 0, theta + _TWO_PI, theta)   # jnp.mod's sign rule

    in_range = valid & (r < cfg.max_radius) & (r > 1e-3)
    k = xy.shape[-2]
    if 0 < cfg.max_desc_features < k:
        in_range = in_range & (torch.arange(k, device=xy.device) < cfg.max_desc_features)
    ring = torch.clamp((r / cfg.max_radius * cfg.num_ring).to(torch.int64),
                       0, cfg.num_ring - 1)
    sector = torch.clamp((theta / _TWO_PI * cfg.num_sector).to(torch.int64),
                         0, cfg.num_sector - 1)
    val = torch.where(in_range, z + cfg.lidar_height,
                      torch.full_like(r, float("-inf")))

    lead = xy.shape[:-2]
    cells = cfg.num_ring * cfg.num_sector
    clouds = val.numel() // k if k else 0
    # one scatter-max for every cloud: cloud b owns cells b * cells ...
    cell = (ring * cfg.num_sector + sector).reshape(clouds, k)
    cell = cell + (torch.arange(clouds, device=xy.device) * cells)[:, None]
    desc = torch.full((clouds * cells,), float("-inf"), dtype=val.dtype, device=xy.device)
    desc = desc.scatter_reduce(0, cell.reshape(-1), val.reshape(-1), "amax")
    desc = desc.reshape(lead + (cfg.num_ring, cfg.num_sector))
    return torch.where(torch.isfinite(desc), desc, torch.zeros_like(desc))


def _ordered_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum over the last axis in float64, with the adds in one order on
    every device (``halving_sum``).  The ring-key prefilter and the
    sector-key alignment pick a minimum among values that tie, or nearly
    tie, for sparse descriptors.  A float32 sum breaks such ties by its
    order of adds, which differs between the card and the CPU, and between
    both and XLA; in float64 the sums of float32 terms are all but exact,
    so the pick is the exact arithmetic's on every device, which XLA's
    float32 sums also give wherever their rounding is below the gap."""
    return halving_sum(x.to(torch.float64))


def _mean_last(x: torch.Tensor) -> torch.Tensor:
    """Mean over the last axis, the same bits on every device: the sum
    (``_ordered_sum``, rounded once to float32) times the float32 reciprocal
    of the count, as XLA computes ``jnp.mean``.  ``torch.mean`` divides on
    the CPU and multiplies by the reciprocal on the card, an ulp apart, and
    the key searches turn such ulps into other candidates."""
    inv = torch.full((), 1.0 / x.shape[-1], dtype=x.dtype, device=x.device)
    return _ordered_sum(x).to(x.dtype) * inv


def ring_key(desc: torch.Tensor) -> torch.Tensor:
    """Rotation-invariant row means."""
    return _mean_last(desc)


def sector_key(desc: torch.Tensor) -> torch.Tensor:
    """Column means."""
    return _mean_last(desc.transpose(-1, -2))


def _normalize_columns(desc: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Unit-normalize descriptor columns; returns (normalized, nonzero mask)."""
    norm = torch.linalg.norm(desc, dim=-2, keepdim=True)
    return desc / torch.clamp(norm, min=1e-9), norm[..., 0, :] > 1e-9


def _roll_index(s: int, device) -> torch.Tensor:
    """(shift, column) -> query column (shift + column) mod S."""
    a = torch.arange(s, device=device)
    return (a[:, None] + a[None, :]) % s


def sc_shift_distance_matrix_plain(query: torch.Tensor, bank: torch.Tensor
                                   ) -> torch.Tensor:
    """The plain PyTorch version of kernel K2 (any device): one true-fp32
    matmul for the cosine mass of the rolled query against the bank, one for
    the column counts, then the masked normalisation."""
    n, nr, ns = bank.shape
    qn, qnz = _normalize_columns(query)
    bn, bnz = _normalize_columns(bank)
    col = _roll_index(ns, query.device)
    q_rolled = qn[:, col].permute(1, 0, 2).reshape(ns, nr * ns)   # (Z, R*C)
    C = bn.reshape(n, nr * ns) @ q_rolled.T
    counts = bnz.to(torch.float32) @ qnz[col].to(torch.float32).T
    dist = 1.0 - C / torch.clamp(counts, min=1.0)
    return torch.where(counts > 0, dist, torch.ones_like(dist))


def sc_shift_distance_matrix(query: torch.Tensor, bank: torch.Tensor) -> torch.Tensor:
    """distDirectSC at every circular column shift, batched over the bank.

    query: (R, S); bank: (N, R, S).  Returns (N, S): entry [n, z] is the mean
    over columns non-zero in both of (1 - cosine similarity), with the query
    rolled by z columns; 1.0 where no column is non-zero in both.

    A CUDA tensor runs kernel K2, a CPU tensor the plain version."""
    if query.device.type == "cuda":
        return sc_corr.sc_shift_distances_cuda(query.contiguous(), bank.contiguous())
    if query.device.type != "cpu":
        raise ValueError(f"sc_shift_distance_matrix: unsupported device {query.device}")
    return sc_shift_distance_matrix_plain(query, bank)


def sc_shift_distance_matrix_multi_plain(queries: torch.Tensor, bank: torch.Tensor
                                         ) -> torch.Tensor:
    """The plain PyTorch version of K2-T (any device): T queries (T, R, S)
    against one bank (N, R, S) or per-slot banks (T, N, R, S) -> (T, N, S),
    slot t being ``sc_shift_distance_matrix_plain(queries[t], bank[t])``."""
    t, nr, ns = queries.shape
    n = bank.shape[-3]
    qn, qnz = _normalize_columns(queries)                           # (T, R, S), (T, S)
    bn, bnz = _normalize_columns(bank)
    col = _roll_index(ns, queries.device)
    q_rolled = qn[:, :, col].permute(0, 2, 1, 3).reshape(t, ns, nr * ns)   # (T, Z, R*C)
    C = bn.reshape(bank.shape[:-2] + (nr * ns,)) @ q_rolled.transpose(-1, -2)
    counts = bnz.to(torch.float32) @ qnz[:, col].to(torch.float32).transpose(-1, -2)
    dist = 1.0 - C / torch.clamp(counts, min=1.0)
    return torch.where(counts > 0, dist, torch.ones_like(dist)).reshape(t, n, ns)


def sc_shift_distance_matrix_multi(queries: torch.Tensor, bank: torch.Tensor
                                   ) -> torch.Tensor:
    """``sc_shift_distance_matrix`` for T query slots at once: queries
    (T, R, S) against one bank (N, R, S) or per-slot banks (T, N, R, S) ->
    (T, N, S).  A CUDA tensor runs kernel K2-T (one launch for every slot),
    a CPU tensor the plain version."""
    if queries.device.type == "cuda":
        return sc_corr.sc_shift_distances_multi_cuda(queries.contiguous(), bank.contiguous())
    if queries.device.type != "cpu":
        raise ValueError(f"sc_shift_distance_matrix_multi: unsupported device "
                         f"{queries.device}")
    return sc_shift_distance_matrix_multi_plain(queries, bank)


def _best_shift(dist: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Best distance over the shifts (last axis) and its argmin shift."""
    # clamp f32 rounding: a perfect self-match can land slightly below 0
    return torch.clamp(torch.min(dist, dim=-1).values, min=0.0), torch.argmin(dist, dim=-1)


def _pick(x: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
    """``x[i]`` for a 0-d index tensor, on the device: ``x[i]`` itself would
    read ``i`` back to the host."""
    return torch.gather(x, 0, i.reshape(1))[0]


def sc_distance_all_shifts(query: torch.Tensor, bank: torch.Tensor
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Best distance over all shifts: (dist (N,), argmin shift (N,))."""
    return _best_shift(sc_shift_distance_matrix(query, bank))


def _ratio_window(dist: torch.Tensor, query: torch.Tensor, bank: torch.Tensor,
                  cfg: ScanContextConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """The best of ``dist`` (..., N, S) inside the sector-key-aligned window
    of each row; query (..., R, S), bank (..., N, R, S)."""
    ns = query.shape[-1]
    vq = sector_key(query).to(torch.float64)                        # (..., S)
    vb = sector_key(bank).to(torch.float64)                         # (..., N, S)
    col = _roll_index(ns, query.device)
    corr = _ordered_sum(vb[..., :, None, :] * vq[..., col][..., None, :, :])   # (..., N, Z)
    align = torch.argmin(_ordered_sum(vb * vb)[..., None] - 2.0 * corr, dim=-1)
    radius = max(1, int(round(0.5 * cfg.search_ratio * ns)))
    shifts = torch.arange(ns, device=query.device)
    circ = torch.abs((shifts - align[..., None] + ns // 2) % ns - ns // 2)
    dist = torch.where(circ <= radius, dist, torch.full_like(dist, float("inf")))
    return _best_shift(dist)


def sc_distance_ratio_shifts(query: torch.Tensor, bank: torch.Tensor,
                             cfg: ScanContextConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """Best distance over the reference's restricted shift search: align by
    sector key, then search only ± round(0.5 * search_ratio * S) shifts
    around that alignment."""
    return _ratio_window(sc_shift_distance_matrix(query, bank), query, bank, cfg)


def shift_to_yaw(shift: torch.Tensor, cfg: ScanContextConfig) -> torch.Tensor:
    """Column shift -> yaw offset (rad)."""
    s = shift.to(torch.float32)
    s = torch.where(s > cfg.num_sector / 2, s - cfg.num_sector, s)
    return s * (_TWO_PI / cfg.num_sector)


def top_k(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``jax.lax.top_k`` along the last axis: the k largest, equal values
    lowest index first (``torch.topk`` promises no tie order)."""
    vals, idx = torch.sort(x, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def ring_key_candidates(query_key: torch.Tensor, bank_keys: torch.Tensor, k: int
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k nearest ring keys by L2: (indices, squared distances)."""
    d2 = torch.sum((bank_keys - query_key[None, :]) ** 2, dim=-1)
    neg_d2, idx = top_k(-d2, k)
    return idx, -neg_d2


def ringkey_searchable_bound(num_valid: int, cfg: ScanContextConfig) -> int:
    """Upper bound (exclusive) of bank indices the ring-key path may search:
    the recency exclusion, and the KD-tree staleness emulation (the
    searchable bank freezes between rebuilds every tree_making_period)."""
    bound = num_valid - cfg.num_exclude_recent
    if cfg.tree_making_period > 1:
        p = cfg.tree_making_period
        e1 = cfg.num_exclude_recent + 1
        v_last = e1 + (max(num_valid - e1, 0) // p) * p
        bound = min(bound, v_last - cfg.num_exclude_recent)
    return bound


def ringkey_two_stage_best(query_desc: torch.Tensor, bank_desc: torch.Tensor,
                           bank_ring_keys: torch.Tensor, searchable: torch.Tensor,
                           k: int, cfg: ScanContextConfig
                           ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Ring-key KNN prefilter of ``k`` candidates over the ``searchable``
    rows, then shift-distance scoring on those candidates only.  Returns
    (best row index, best distance (+inf if nothing searchable), best shift)."""
    qkey = ring_key(query_desc)
    d2 = _ordered_sum((bank_ring_keys.to(torch.float64) - qkey[None, :].to(torch.float64)) ** 2)
    d2 = torch.where(searchable, d2, torch.full_like(d2, float("inf")))
    _, cand = top_k(-d2, k)
    cand_desc = bank_desc[cand]
    if cfg.search_ratio > 0:
        dist, shift = sc_distance_ratio_shifts(query_desc, cand_desc, cfg)
    else:
        dist, shift = sc_distance_all_shifts(query_desc, cand_desc)
    dist = torch.where(torch.isfinite(d2[cand]), dist, torch.full_like(dist, float("inf")))
    j = torch.argmin(dist)
    return _pick(cand, j), _pick(dist, j), _pick(shift, j)


class LoopCandidate(NamedTuple):
    idx: torch.Tensor        # () int64 matched keyframe index (-1 if none)
    dist: torch.Tensor       # () float32 best SC distance
    yaw: torch.Tensor        # () float32 yaw offset estimate (rad)
    found: torch.Tensor      # () bool


def _candidate(best, best_dist, shift, cfg: ScanContextConfig) -> LoopCandidate:
    found = best_dist < cfg.sc_dist_thres
    return LoopCandidate(idx=torch.where(found, best, torch.full_like(best, -1)),
                         dist=best_dist, yaw=shift_to_yaw(shift, cfg), found=found)


def detect_loop(query_desc: torch.Tensor, bank_desc: torch.Tensor, num_valid: int,
                cfg: ScanContextConfig) -> LoopCandidate:
    """Full-bank loop detection.  bank_desc: (N_max, R, S) padded bank;
    num_valid: stored keyframes (the query is keyframe num_valid - 1; the
    most recent num_exclude_recent are excluded).

    Only the searchable prefix is scored: rows at or past num_valid -
    num_exclude_recent could never win.  One row is kept when none is
    searchable, so the candidate (idx -1, dist +inf, yaw of row 0's best
    shift) is the one the full padded bank gives."""
    bound = num_valid - cfg.num_exclude_recent
    n = max(bound, 1)
    dist, shift = sc_distance_all_shifts(query_desc, bank_desc[:n])
    searchable = torch.arange(dist.shape[0], device=bank_desc.device) < bound
    dist = torch.where(searchable, dist, torch.full_like(dist, float("inf")))
    best = torch.argmin(dist)
    return _candidate(best, _pick(dist, best), _pick(shift, best), cfg)


def detect_loop_ringkey(query_desc: torch.Tensor, bank_desc: torch.Tensor,
                        bank_ring_keys: torch.Tensor, num_valid: int,
                        cfg: ScanContextConfig) -> LoopCandidate:
    """Two-stage path: ring-key KNN prefilter (k = num_candidates), then the
    shift distance on the candidates only, with the reference's KD-tree
    staleness (tree_making_period) and restricted shift window
    (search_ratio)."""
    n = bank_desc.shape[0]
    searchable = (torch.arange(n, device=bank_desc.device)
                  < ringkey_searchable_bound(num_valid, cfg))
    best, best_dist, best_shift = ringkey_two_stage_best(
        query_desc, bank_desc, bank_ring_keys, searchable, cfg.num_candidates, cfg)
    return _candidate(best, best_dist, best_shift, cfg)


def detect_loop_multi(queries: torch.Tensor, bank_desc: torch.Tensor, k0: int, m: int,
                      cfg: ScanContextConfig) -> LoopCandidate:
    """``detect_loop`` for the T keyframes k0 .. k0 + T - 1 of a segment, all
    against the final bank: slot t sees num_valid = k0 + t + 1 (the
    ``jax.vmap(detect_one)`` of the JAX segment).  ``m`` of the T slots are
    active.  One K2-T call scores the prefix that the last active slot may
    search, max(k0 + m - num_exclude_recent, 1) rows, for every slot; row n
    of slot t is then masked at n >= k0 + t + 1 - num_exclude_recent, so
    each active slot's candidate is the one ``detect_loop`` gives it alone.
    Returns a LoopCandidate of (T,) leaves."""
    t = queries.shape[0]
    dev = bank_desc.device
    n = max(k0 + m - cfg.num_exclude_recent, 1)
    dist, shift = _best_shift(sc_shift_distance_matrix_multi(queries, bank_desc[:n]))
    bound = k0 + 1 - cfg.num_exclude_recent + torch.arange(t, device=dev)
    searchable = torch.arange(n, device=dev)[None, :] < bound[:, None]
    dist = torch.where(searchable, dist, torch.full_like(dist, float("inf")))
    best = torch.argmin(dist, dim=-1)
    pick = best[:, None]
    return _candidate(best, torch.gather(dist, 1, pick)[:, 0],
                      torch.gather(shift, 1, pick)[:, 0], cfg)


def ringkey_two_stage_best_multi(queries: torch.Tensor, bank_desc: torch.Tensor,
                                 bank_ring_keys: torch.Tensor, searchable: torch.Tensor,
                                 k: int, cfg: ScanContextConfig
                                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``ringkey_two_stage_best`` for T queries (T, R, S) with per-slot
    searchable masks (T, N): each slot's ring-key prefilter gathers its own
    ``k`` rows, so the shift distances are one K2-T call on a (T, k, R, S)
    bank, and the ratio window (``search_ratio``) is taken per slot.
    Returns (best row index, best distance, best shift), each (T,)."""
    qkey = ring_key(queries).to(torch.float64)                      # (T, R)
    d2 = _ordered_sum((bank_ring_keys[None].to(torch.float64) - qkey[:, None, :]) ** 2)  # (T, N)
    d2 = torch.where(searchable, d2, torch.full_like(d2, float("inf")))
    _, cand = top_k(-d2, k)                                         # (T, k)
    cand_desc = bank_desc[cand]                                     # (T, k, R, S)
    dist = sc_shift_distance_matrix_multi(queries, cand_desc)
    if cfg.search_ratio > 0:
        dist, shift = _ratio_window(dist, queries, cand_desc, cfg)
    else:
        dist, shift = _best_shift(dist)
    dist = torch.where(torch.isfinite(torch.gather(d2, 1, cand)), dist,
                       torch.full_like(dist, float("inf")))
    j = torch.argmin(dist, dim=-1)[:, None]
    return (torch.gather(cand, 1, j)[:, 0], torch.gather(dist, 1, j)[:, 0],
            torch.gather(shift, 1, j)[:, 0])


def detect_loop_ringkey_multi(queries: torch.Tensor, bank_desc: torch.Tensor,
                              bank_ring_keys: torch.Tensor, k0: int,
                              cfg: ScanContextConfig) -> LoopCandidate:
    """``detect_loop_ringkey`` for the T keyframes k0 .. k0 + T - 1 of a
    segment against the final bank (slot t sees num_valid = k0 + t + 1),
    through ``ringkey_two_stage_best_multi``: one K2-T call for every slot.
    Returns a LoopCandidate of (T,) leaves."""
    t = queries.shape[0]
    dev = bank_desc.device
    bounds = torch.as_tensor([ringkey_searchable_bound(k0 + s + 1, cfg) for s in range(t)],
                             device=dev)
    searchable = torch.arange(bank_desc.shape[0], device=dev)[None, :] < bounds[:, None]
    return _candidate(*ringkey_two_stage_best_multi(
        queries, bank_desc, bank_ring_keys, searchable, cfg.num_candidates, cfg), cfg)


# -- the multi-session API and the reference's SCManager interface ---------

def detect_loop_between_sessions(query_desc: torch.Tensor, other_bank_desc: torch.Tensor,
                                 other_num_valid: int, cfg: ScanContextConfig
                                 ) -> LoopCandidate:
    """Query one session's descriptor against another session's bank (no
    recency exclusion: the sessions are distinct trajectories).

    Only the first other_num_valid rows are scored, one row when the bank
    is empty, so the candidate (idx -1, dist +inf, yaw of row 0's best shift
    at other_num_valid = 0) is the one the full padded bank gives.  One K2
    launch on the card."""
    n = max(other_num_valid, 1)
    dist, shift = sc_distance_all_shifts(query_desc, other_bank_desc[:n])
    searchable = torch.arange(dist.shape[0], device=other_bank_desc.device) < other_num_valid
    dist = torch.where(searchable, dist, torch.full_like(dist, float("inf")))
    best = torch.argmin(dist)
    return _candidate(best, _pick(dist, best), _pick(shift, best), cfg)


class ScanContextManager:
    """The reference's SCManager interface (Scancontext.h:57-122, method
    names kept) over one padded bank on the device.

    ``bank`` (capacity, R, S) and ``ring_keys`` (capacity, R) stay on
    ``device`` (the card unless the caller names the CPU); ``num`` is a host
    int.  An insert writes its row in place and reads nothing back; a detect
    is one K2 launch on the card (``detect_loop`` in "full" mode,
    ``detect_loop_ringkey`` in "ringkey" mode) and one read of the (index,
    yaw) pair the interface returns."""

    def __init__(self, cfg: ScanContextConfig, capacity: int = 4096,
                 device: torch.device | str = DEFAULT_DEVICE):
        self.cfg = cfg
        self.capacity = capacity
        self.device = resolve_device(device)
        self.bank = torch.zeros((capacity, cfg.num_ring, cfg.num_sector),
                                dtype=torch.float32, device=self.device)
        self.ring_keys = torch.zeros((capacity, cfg.num_ring), dtype=torch.float32,
                                     device=self.device)
        self.num = 0

    def setSCdistThres(self, thres: float) -> None:  # noqa: N802 (the reference's name)
        self.cfg = dataclasses.replace(self.cfg, sc_dist_thres=thres)

    def _tensor(self, x, dtype: torch.dtype) -> torch.Tensor:
        return torch.as_tensor(x, dtype=dtype, device=self.device)

    def _append(self, desc: torch.Tensor) -> None:
        if self.num >= self.capacity:
            raise RuntimeError("ScanContext bank capacity exceeded")
        self.bank[self.num] = desc
        self.ring_keys[self.num] = ring_key(desc)
        self.num += 1

    def makeAndSaveScancontextAndKeys(self, xy, z=None, valid=None  # noqa: N802
                                      ) -> torch.Tensor:
        """Build the descriptor of a (K, 2) cloud (heights ``z`` default 0,
        every point valid by default) and append it with its ring key."""
        xy = self._tensor(xy, torch.float32)
        k = xy.shape[0]
        z = (torch.zeros(k, device=self.device) if z is None
             else self._tensor(z, torch.float32))
        valid = (torch.ones(k, dtype=torch.bool, device=self.device) if valid is None
                 else self._tensor(valid, torch.bool))
        desc = make_scancontext(xy, z, valid, self.cfg)
        self._append(desc)
        return desc

    def saveScancontextAndKeys(self, desc) -> None:  # noqa: N802
        """Append an externally built (R, S) descriptor and its ring key."""
        self._append(self._tensor(desc, torch.float32))

    @staticmethod
    def _read(res: LoopCandidate) -> Tuple[int, float]:
        idx, yaw = torch.stack([res.idx.to(torch.float64), res.yaw.to(torch.float64)]).tolist()
        return int(idx), yaw

    def detectLoopClosureID(self) -> Tuple[int, float]:  # noqa: N802
        """Query the newest descriptor against the bank: (index, yaw), index
        -1 when there is no loop, (-1, 0.0) on an empty bank."""
        if self.num == 0:
            return -1, 0.0
        query = self.bank[self.num - 1]
        if self.cfg.search_mode == "ringkey":
            res = detect_loop_ringkey(query, self.bank, self.ring_keys, self.num, self.cfg)
        else:
            res = detect_loop(query, self.bank, self.num, self.cfg)
        return self._read(res)

    def detectLoopClosureIDBetweenSession(self, query_desc  # noqa: N802
                                          ) -> Tuple[int, float]:
        """Query another session's (R, S) descriptor against this bank."""
        return self._read(detect_loop_between_sessions(
            self._tensor(query_desc, torch.float32), self.bank, self.num, self.cfg))
