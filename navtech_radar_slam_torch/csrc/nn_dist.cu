// Brute-force 2-D nearest neighbour for ICP, for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel
//   navtech_radar_slam_tpu/ops/pallas/nn_dist.py::nearest_neighbors_pallas
// and keeps its contract: for each query point the minimum squared distance
// d2 = dx*dx + dy*dy (the subtract-square form) over the valid targets, and
// the first target index attaining it; a query with no valid target gets
// +inf and index 0 (what argmin of an all-inf row gives).  Shapes on the
// ICP path: src (Nq = 1024, 2), tgt (Nt = 8192, 2), valid (Nt,) bool.
//
// d2 is formed with __fsub_rn / __fmul_rn / __fadd_rn, so no multiply-add is
// contracted and every d2 is bit-equal to the plain PyTorch version's
// (ops/icp.py::nearest_neighbors_plain); the minimum and its index are then
// exact too.  No tensor cores: the |a|^2 + |b|^2 - 2ab form a matrix product
// would need is off by ~1e-2 m^2 at 150 m and breaks the bit-equal d2 and
// the index ties, so the pairs run on the fp32 units.
//
// K3-T, T problems in one launch (nn_dist_multi_launch), replaces the
// jax.vmap of the same TPU kernel through the streaming segment's T-slot
// ICP (navtech_radar_slam_tpu/models/slam.py, _make_kf_segment: vmap of
// detect_one -> _verify_candidate -> ops/icp.py::icp_se2): src (T, Nq, 2),
// tgt (T, Nt, 2), valid (T, Nt) into (T, Nq) d2 and index, and an optional
// slot mask (T,): a masked slot computes nothing and gets what a query with
// no valid target gets (+inf, index 0).  The single-problem entry point
// (K3, nn_dist_launch) is the T = 1 case without a mask, bit for bit.
//
// What bounds it on the card: operations.  Each valid pair costs 5 fp32
// instructions by design (2 FSUB, 2 FMUL, 1 FADD: separate, never an FMA),
// which the 67 TFLOP/s peak (an FMA counted as two) issues at half rate,
// plus a compare and two selects for the running (d2, index) minimum; at
// 16 slots of (1024, 8192) the bytes are ~1.6 MB (0.5 us at 3.35 TB/s).
// The work is what this launch's data needs, and the design computes only
// that:
//
//   * a slot the caller masks off (an ICP slot without a candidate, or one
//     that converged; the mask stays on the device) returns at once: its
//     blocks are whole clusters, since a cluster runs along one slot's
//     targets;
//   * only valid targets are paired.  Each block compacts its chunk of the
//     targets while it stages it into shared memory, in steps of kStage:
//     pass r of kRun reads targets r * kThreads + tid (coalesced), each
//     warp's ballot of the valid ones gives their order within the warp,
//     one warp scans the kRun x kWarps counts, and every valid target is
//     stored with its original index at its place, so the compacted list
//     keeps ascending target order.  A step with no invalid target skips
//     the index list (its index is its position).  Compacted per launch and
//     not once per ICP call in a kernel of its own: the targets and mask do
//     not change across an ICP call's iterations, but staging reads them
//     anyway, the compaction adds 8 ballots and a 32-count scan a block
//     (small beside its 32 x ~1024 pairs), and no second launch, scratch
//     buffer or host-side state per call is needed.  The ICP submaps of
//     the streamed and CLI runs have every target valid in every computed
//     slot, and a variant without the compaction (invalid targets staged
//     as +inf, a step with no valid target skipped) measured slower there
//     as well as on scattered invalid targets.  Submaps pack their
//     valid targets first, so a chunk past them leaves at once and its
//     cluster waits on the chunks that hold them; sharing a cluster's valid
//     targets out evenly through distributed shared memory was tried on the
//     card, and its copy and two more cluster barriers cost more than the
//     wait saved on the streamed run's shapes, whose submaps are full;
//   * the grid splits the targets as well as the queries: blockIdx.y is a
//     tile of kTileQ = 32 queries, blockIdx.x one of up to kMaxChunks = 8
//     contiguous target chunks (the host picks the chunk count, fewer when
//     Nt is small), blockIdx.z the slot.  At 16 x (1024, 8192): 8 x 32 x 16
//     = 4,096 blocks of 128 threads;
//   * each thread keeps kQpt = 8 queries in registers with independent
//     running minima (one staged target, read once from shared memory,
//     serves eight pairs, and the eight compare chains overlap); the 32
//     target slices of a block are interleaved (slice s takes compacted
//     targets s, s + 32, ...), so a warp reads 8 consecutive targets per
//     step, each a broadcast to 4 lanes, with no bank conflict.  Of the
//     tiles tried on the card (16, 32 and 64 queries a block; 4, 8 and 16
//     a thread), this one was the fastest where the streamed run's launches
//     are: one to four slots computed, every target valid.
//
// Merging, first index on ties: a thread scans its compacted targets in
// ascending original order with a strict <, so it keeps its first minimum;
// every merge after that takes the lexicographic minimum of (d2, index),
// which is the same in any order.  Lanes merge by shuffles, warps through
// shared memory, and the blocks of one query tile form a thread block
// cluster along the targets: each writes its 32 (d2, index) pairs to its
// shared memory, and cluster rank 0 reads the others through distributed
// shared memory in rank order and writes the result.  Chosen over a 64-bit
// atomicMin on (d2 bits << 32 | index): the cluster merge needs no
// initialised output, no memset launch and no global atomics, and is
// deterministic.  ptxas (-Xptxas -v, which chip_smoke.py prints) gives the
// registers, shared memory and spills.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kQpt = 8;                        // queries per thread
constexpr int kQGroups = 4;                    // query groups per block
constexpr int kTileQ = kQpt * kQGroups;        // queries per block
constexpr int kSlices = 32;                    // target slices per block
constexpr int kThreads = kQGroups * kSlices;   // 128
constexpr int kWarps = kThreads / 32;
constexpr int kStage = 1024;                   // targets per shared-memory step
constexpr int kRun = kStage / kThreads;        // staging passes per step
constexpr int kMaxChunks = 8;                  // portable cluster size limit
constexpr int kMaxTiles = 65535;               // gridDim.y limit
constexpr int kMaxSlots = 65535;               // gridDim.z limit

static_assert(kRun * kWarps == 32, "one warp scans the staging passes' counts");
static_assert(32 % kQGroups == 0, "the query groups tile a warp");

__device__ __forceinline__ float pos_inf() { return __int_as_float(0x7f800000); }

// (d, i) before (bd, bi) in the lexicographic order of (d2, index)
__device__ __forceinline__ bool before(float d, int i, float bd, int bi) {
  return d < bd || (d == bd && i < bi);
}

// Pair this thread's slice of a step's compacted targets (j = slice, slice
// + kSlices, ...) with its kQpt queries, keeping each query's first
// minimum (strict <, ascending j).  kDense: the step had no invalid
// target, so target j's index is base + j and the index list is not read.
template <bool kDense>
__device__ __forceinline__ void pair_step(const float2* own, const int* own_i, int count,
                                          int slice, int base, const float (&sx)[kQpt],
                                          const float (&sy)[kQpt], float (&best)[kQpt],
                                          int (&bi)[kQpt]) {
#pragma unroll 4
  for (int j = slice; j < count; j += kSlices) {
    const float2 t = own[j];
    const int ti = kDense ? base + j : own_i[j];
#pragma unroll
    for (int k = 0; k < kQpt; ++k) {
      const float dx = __fsub_rn(sx[k], t.x);
      const float dy = __fsub_rn(sy[k], t.y);
      const float d2 = __fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy));
      if (d2 < best[k]) {
        best[k] = d2;
        bi[k] = ti;
      }
    }
  }
}

__global__ void __launch_bounds__(kThreads)
nn_dist_kernel(const float2* __restrict__ src, const float2* __restrict__ tgt,
               const unsigned char* __restrict__ valid,
               const unsigned char* __restrict__ slot_mask, float* __restrict__ dmin,
               long long* __restrict__ idx, int nq, int nt, int chunk_len) {
  __shared__ float2 own[kStage];      // this step's valid targets, in order
  __shared__ int own_i[kStage];       // and their indices
  __shared__ int pass_count[kRun][kWarps];
  __shared__ int pass_start[kRun][kWarps];
  __shared__ int stage_count;
  __shared__ float part_d[kWarps][kTileQ];
  __shared__ int part_i[kWarps][kTileQ];
  __shared__ float blk_d[kTileQ];
  __shared__ int blk_i[kTileQ];

  // slot blockIdx.z: its queries, targets, mask and outputs; slot 0 reads
  // and writes what a single problem does
  const size_t slot = blockIdx.z;
  src += slot * nq;
  tgt += slot * nt;
  valid += slot * nt;
  dmin += slot * nq;
  idx += slot * nq;

  cg::cluster_group cluster = cg::this_cluster();
  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;
  const int q0 = blockIdx.y * kTileQ;

  if (slot_mask != nullptr && !slot_mask[slot]) {
    // every block of this cluster sees the same slot and leaves here, so
    // none waits at a cluster barrier; rank 0 writes the defined value
    if (cluster.block_rank() == 0 && tid < kTileQ && q0 + tid < nq) {
      dmin[q0 + tid] = pos_inf();
      idx[q0 + tid] = 0;
    }
    return;
  }

  const int qg = tid % kQGroups;
  const int slice = tid / kQGroups;
  float sx[kQpt], sy[kQpt], best[kQpt];
  int bi[kQpt];
#pragma unroll
  for (int k = 0; k < kQpt; ++k) {
    const float2 s = src[min(q0 + qg * kQpt + k, nq - 1)];
    sx[k] = s.x;
    sy[k] = s.y;
    best[k] = pos_inf();
    bi[k] = 0;
  }

  // this block's chunk of the targets: [lo, hi)
  const int lo = blockIdx.x * chunk_len;
  const int hi = min(lo + chunk_len, nt);
  for (int base = lo; base < hi; base += kStage) {
    const int len = min(kStage, hi - base);
    __syncthreads();   // the previous step's targets are consumed
    // pass r reads targets r * kThreads + tid (coalesced); the valid ones
    // go to the compacted list in ascending order: pass, then warp, then
    // lane, placed by the warp's ballot
    unsigned ballots[kRun];
#pragma unroll
    for (int r = 0; r < kRun; ++r) {
      const int e = r * kThreads + tid;
      ballots[r] = __ballot_sync(0xffffffffu, e < len && valid[base + e]);
      if (lane == 0) pass_count[r][warp] = __popc(ballots[r]);
    }
    __syncthreads();
    if (warp == 0) {
      // exclusive scan of the kRun x kWarps counts (32 of them), r-major
      const int c = pass_count[lane / kWarps][lane % kWarps];
      int incl = c;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const int o = __shfl_up_sync(0xffffffffu, incl, off);
        if (lane >= off) incl += o;
      }
      pass_start[lane / kWarps][lane % kWarps] = incl - c;
      if (lane == 31) stage_count = incl;
    }
    __syncthreads();
    const unsigned below = (1u << lane) - 1u;
#pragma unroll
    for (int r = 0; r < kRun; ++r) {
      if (ballots[r] & (1u << lane)) {
        const int e = r * kThreads + tid;
        const int at = pass_start[r][warp] + __popc(ballots[r] & below);
        own[at] = tgt[base + e];
        own_i[at] = base + e;
      }
    }
    const int count = stage_count;
    __syncthreads();
    if (count == len)   // every target of the step valid: the list is the step
      pair_step<true>(own, own_i, count, slice, base, sx, sy, best, bi);
    else
      pair_step<false>(own, own_i, count, slice, base, sx, sy, best, bi);
  }

  // the 8 slices of a warp that share a query group: lanes qg, qg + 4, ...
#pragma unroll
  for (int k = 0; k < kQpt; ++k) {
#pragma unroll
    for (int off = kQGroups; off < 32; off <<= 1) {
      const float d = __shfl_xor_sync(0xffffffffu, best[k], off);
      const int i = __shfl_xor_sync(0xffffffffu, bi[k], off);
      if (before(d, i, best[k], bi[k])) {
        best[k] = d;
        bi[k] = i;
      }
    }
  }
  if (lane < kQGroups) {
#pragma unroll
    for (int k = 0; k < kQpt; ++k) {
      part_d[warp][lane * kQpt + k] = best[k];
      part_i[warp][lane * kQpt + k] = bi[k];
    }
  }
  __syncthreads();
  if (tid < kTileQ) {
    float d = part_d[0][tid];
    int i = part_i[0][tid];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) {
      if (before(part_d[w][tid], part_i[w][tid], d, i)) {
        d = part_d[w][tid];
        i = part_i[w][tid];
      }
    }
    blk_d[tid] = d;
    blk_i[tid] = i;
  }

  // the blocks of this query tile, one per chunk, are one cluster
  cluster.sync();
  if (cluster.block_rank() == 0 && tid < kTileQ) {
    float d = blk_d[tid];
    int i = blk_i[tid];
    const int n = static_cast<int>(cluster.num_blocks());
    for (int r = 1; r < n; ++r) {
      const float od = cluster.map_shared_rank(&blk_d[0], r)[tid];
      const int oi = cluster.map_shared_rank(&blk_i[0], r)[tid];
      if (before(od, oi, d, i)) {
        d = od;
        i = oi;
      }
    }
    const int q = q0 + tid;
    if (q < nq) {
      dmin[q] = d;
      idx[q] = i;
    }
  }
  // keep every block's shared memory alive until rank 0 has read it
  cluster.sync();
}

int launch(const float* src, const float* tgt, const unsigned char* valid,
           const unsigned char* slot_mask, float* dmin, long long* idx, int slots, int nq,
           int nt, int chunks, int chunk_len, void* stream) {
  if (nq <= 0 || slots <= 0) return 0;
  const int tiles = (nq + kTileQ - 1) / kTileQ;
  if (nt < 0 || chunks < 1 || chunks > kMaxChunks || chunk_len < 1 ||
      static_cast<long long>(chunks) * chunk_len < nt || tiles > kMaxTiles ||
      slots > kMaxSlots)
    return static_cast<int>(cudaErrorInvalidValue);

  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(chunks, tiles, slots);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = chunks;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(
      &cfg, nn_dist_kernel, reinterpret_cast<const float2*>(src),
      reinterpret_cast<const float2*>(tgt), valid, slot_mask, dmin, idx, nq, nt, chunk_len);
  const cudaError_t last = cudaGetLastError();  // clears a refused launch
  return static_cast<int>(e != cudaSuccess ? e : last);
}

}  // namespace

// Launch constants the Python wrapper mirrors (ops/kernels/nn_dist.py).
extern "C" int nn_dist_query_tile() { return kTileQ; }
extern "C" int nn_dist_max_chunks() { return kMaxChunks; }
extern "C" int nn_dist_max_slots() { return kMaxSlots; }

// src (Nq, 2) and tgt (Nt, 2) contiguous float32, valid (Nt,) bool (one byte
// each), outputs dmin (Nq,) float32 and idx (Nq,) int64, all on the device.
// The targets are cut into `chunks` (1..8) contiguous chunks of `chunk_len`;
// the grid is (chunks, ceil(Nq / 32)) with clusters of (chunks, 1, 1).
// Returns the CUDA error (0 = cudaSuccess) and leaves no error pending.
extern "C" int nn_dist_launch(const float* src, const float* tgt,
                              const unsigned char* valid, float* dmin,
                              long long* idx, int nq, int nt, int chunks,
                              int chunk_len, void* stream) {
  return launch(src, tgt, valid, nullptr, dmin, idx, 1, nq, nt, chunks, chunk_len, stream);
}

// The T-slot form: src (T, Nq, 2), tgt (T, Nt, 2), valid (T, Nt), dmin and
// idx (T, Nq), slot t's problem at offset t of each; slot_mask (T,) bool,
// or null for every slot.  One launch, the slots on grid axis z (clusters
// stay along the target chunks); slot t's output is what nn_dist_launch
// gives for problem t, bit for bit, where slot_mask[t] holds, and (+inf, 0)
// for every query where it does not.
extern "C" int nn_dist_multi_launch(const float* src, const float* tgt,
                                    const unsigned char* valid,
                                    const unsigned char* slot_mask, float* dmin,
                                    long long* idx, int slots, int nq, int nt,
                                    int chunks, int chunk_len, void* stream) {
  return launch(src, tgt, valid, slot_mask, dmin, idx, slots, nq, nt, chunks, chunk_len,
                stream);
}
