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
// What bounds it on the card: operations, ~5 per pair (8.4 M pairs: 0.63 us
// at the fp32 peak), against ~0.1 MB moved.  One launch's fixed cost (a few
// us) is far above that, so the design aims to fill every SM at once and
// keep the inner loop issue-bound:
//
//   * the grid splits the targets as well as the queries: blockIdx.y is a
//     tile of kTileQ = 16 queries, blockIdx.x one of up to kMaxChunks = 8
//     contiguous target chunks (the host picks the chunk count, fewer when
//     Nt is small).  At (1024, 8192): 64 x 8 = 512 blocks of 128 threads,
//     about four on each of the 132 SMs;
//   * each thread keeps kQpt = 4 queries in registers with independent
//     running minima, so one target read from shared memory serves four
//     pairs and the four compare chains overlap;
//   * the block stages its chunk through shared memory in steps of kStage
//     targets with plain coalesced loads: each target is read once per
//     block, and an invalid target is stored as (+inf, +inf) on the way in,
//     so its d2 is +inf and never wins a strict <, and the inner loop has no
//     mask test.  TMA would copy the tile but not fold the mask, and for an
//     8 KB tile read once its descriptor and barrier buy nothing;
//   * the 32 target slices of a block are interleaved (slice s takes
//     targets s, s + 32, ...), so a warp reads 8 consecutive targets per
//     step, each a broadcast to 4 lanes, with no bank conflict.
//
// Merging, first index on ties: a thread scans its targets in ascending
// order with a strict <, so it keeps its first minimum; every merge after
// that takes the lexicographic minimum of (d2, index), which is the same in
// any order.  Lanes merge by shuffles, warps through shared memory, and the
// blocks of one query tile form a thread block cluster along the targets:
// each writes its 16 (d2, index) pairs to its shared memory, and cluster
// rank 0 reads the others through distributed shared memory in rank order
// and writes the result.  Chosen over a 64-bit atomicMin on
// (d2 bits << 32 | index): the cluster merge needs no initialised output,
// no memset launch and no global atomics, and is deterministic.
//
// K3-T, T problems in one launch (nn_dist_multi_launch), replaces the
// jax.vmap of the same TPU kernel through the streaming segment's T-slot
// ICP (navtech_radar_slam_tpu/models/slam.py, _make_kf_segment: vmap of
// detect_one -> _verify_candidate -> ops/icp.py::icp_se2): src (T, Nq, 2),
// tgt (T, Nt, 2), valid (T, Nt) into (T, Nq) d2 and index.  At the main
// path's shapes, T = 16 slots at (1024, 8192), it reads 1.4 MB and writes
// 0.2 MB (0.45 us at 3.35 TB/s) and does up to 16 x 1024 x 8192 x 5 = 671
// Mop of fp32 (10.0 us at 67 TFLOP/s with every target valid): operations
// bound it.  What the design does: the slots are grid axis z, each block
// offsetting its queries, targets, mask and outputs by its slot and then
// running K3's block as it is (clusters stay along the target chunks, one
// cluster per query tile of one slot), so slot t's result is K3's for
// problem t bit for bit and T = 1 is K3.  At 16 slots the grid is 8 x 64 x
// 16 = 8,192 blocks of 128 threads, several waves over the 132 SMs, so the
// launch's fixed cost, which sets K3's time at one problem (~9.8 us against
// a 0.5 us bound), is paid once for 16 problems.  ptxas (-Xptxas -v, which
// chip_smoke.py prints): 40 registers, 8,832 bytes of shared memory, no
// spills, no stack.  Measured (chip_smoke.py, PERF.md): about 71 us at 16
// slots, 4.5 us a problem.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kQpt = 4;                        // queries per thread
constexpr int kQGroups = 4;                    // query groups per block
constexpr int kTileQ = kQpt * kQGroups;        // queries per block
constexpr int kSlices = 32;                    // target slices per block
constexpr int kThreads = kQGroups * kSlices;   // 128
constexpr int kWarps = kThreads / 32;
constexpr int kStage = 1024;                   // targets per shared-memory step
constexpr int kMaxChunks = 8;                  // portable cluster size limit
constexpr int kMaxTiles = 65535;               // gridDim.y limit
constexpr int kMaxSlots = 65535;               // gridDim.z limit

__device__ __forceinline__ float pos_inf() { return __int_as_float(0x7f800000); }

// (d, i) before (bd, bi) in the lexicographic order of (d2, index)
__device__ __forceinline__ bool before(float d, int i, float bd, int bi) {
  return d < bd || (d == bd && i < bi);
}

__global__ void __launch_bounds__(kThreads)
nn_dist_kernel(const float2* __restrict__ src, const float2* __restrict__ tgt,
               const unsigned char* __restrict__ valid, float* __restrict__ dmin,
               long long* __restrict__ idx, int nq, int nt, int chunk_len) {
  __shared__ float2 stage[kStage];
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
  const int qg = tid % kQGroups;
  const int slice = tid / kQGroups;
  const int q0 = blockIdx.y * kTileQ;

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
    __syncthreads();
    for (int i = tid; i < len; i += kThreads)
      stage[i] = valid[base + i] ? tgt[base + i] : make_float2(pos_inf(), pos_inf());
    __syncthreads();
#pragma unroll 4
    for (int j = slice; j < len; j += kSlices) {
      const float2 t = stage[j];
#pragma unroll
      for (int k = 0; k < kQpt; ++k) {
        const float dx = __fsub_rn(sx[k], t.x);
        const float dy = __fsub_rn(sy[k], t.y);
        const float d2 = __fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy));
        if (d2 < best[k]) {
          best[k] = d2;
          bi[k] = base + j;
        }
      }
    }
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

int launch(const float* src, const float* tgt, const unsigned char* valid, float* dmin,
           long long* idx, int slots, int nq, int nt, int chunks, int chunk_len,
           void* stream) {
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
      reinterpret_cast<const float2*>(tgt), valid, dmin, idx, nq, nt, chunk_len);
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
// the grid is (chunks, ceil(Nq / 16)) with clusters of (chunks, 1, 1).
// Returns the CUDA error (0 = cudaSuccess) and leaves no error pending.
extern "C" int nn_dist_launch(const float* src, const float* tgt,
                              const unsigned char* valid, float* dmin,
                              long long* idx, int nq, int nt, int chunks,
                              int chunk_len, void* stream) {
  return launch(src, tgt, valid, dmin, idx, 1, nq, nt, chunks, chunk_len, stream);
}

// The T-slot form: src (T, Nq, 2), tgt (T, Nt, 2), valid (T, Nt), dmin and
// idx (T, Nq), slot t's problem at offset t of each.  One launch, the slots
// on grid axis z (clusters stay along the target chunks); slot t's output is
// what nn_dist_launch gives for problem t, bit for bit.
extern "C" int nn_dist_multi_launch(const float* src, const float* tgt,
                                    const unsigned char* valid, float* dmin,
                                    long long* idx, int slots, int nq, int nt,
                                    int chunks, int chunk_len, void* stream) {
  return launch(src, tgt, valid, dmin, idx, slots, nq, nt, chunks, chunk_len, stream);
}
