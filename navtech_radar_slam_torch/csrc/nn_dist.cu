// Brute-force 2-D nearest neighbour for ICP, for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel
//   navtech_radar_slam_tpu/ops/pallas/nn_dist.py::nearest_neighbors_pallas
// and keeps its contract: for each query point the minimum squared distance
// d2 = dx*dx + dy*dy (the subtract-square form) over the valid targets, and
// the first target index attaining it; a query with no valid target gets
// +inf and index 0 (what argmin of an all-inf row gives).  Shapes on the
// ICP path: src (Nq <= 1024, 2), tgt (Nt <= 8192, 2), valid (Nt,) bool.
//
// d2 is formed with __fsub_rn / __fmul_rn / __fadd_rn, so no multiply-add is
// contracted and every d2 is bit-equal to the plain PyTorch version's
// (ops/icp.py::nearest_neighbors on elementwise ops); the minimum and its
// index are then exact too.
//
// What bounds it on the card: issue rate, not memory.  A call reads
// 8192 x 9 bytes of targets and does ~8 instructions for each of the
// 1024 x 8192 pairs; one thread per query alone would put only 1024 threads
// (8 SMs' worth of warps) on 132 SMs, each walking all 8192 targets.  So a
// block takes 32 queries (one per lane) and its 8 warps split every target
// tile eight ways: 32 blocks x 8 warps, each warp walking 1/8 of the
// targets.  Target tiles of 2048 points pass through shared memory (all
// lanes of a warp read the same target: a broadcast).  Each warp keeps a
// running minimum with a strict < over ascending indices; the eight partial
// minima of a query are merged with the index as tie-break, so the first
// index wins as in argmin.  A batch axis over ICP problems (the segment
// slots of the streaming engine) is later work.

#include <cuda_runtime.h>

namespace {

constexpr int kLanes = 32;          // queries per block
constexpr int kWarps = 8;           // target slices per block
constexpr int kThreads = kLanes * kWarps;
constexpr int kTile = 2048;         // targets per shared-memory tile

__global__ void __launch_bounds__(kThreads)
nn_dist_kernel(const float2* __restrict__ src, const float2* __restrict__ tgt,
               const unsigned char* __restrict__ valid, float* __restrict__ dmin,
               long long* __restrict__ idx, int nq, int nt) {
  __shared__ float tx[kTile];
  __shared__ float ty[kTile];
  __shared__ unsigned char tv[kTile];
  __shared__ float part_d[kWarps][kLanes];
  __shared__ int part_i[kWarps][kLanes];

  const int lane = threadIdx.x % kLanes;
  const int warp = threadIdx.x / kLanes;
  const int q = blockIdx.x * kLanes + lane;
  const float2 s = q < nq ? src[q] : make_float2(0.f, 0.f);

  float best = __int_as_float(0x7f800000);   // +inf
  int best_i = 0;
  constexpr int kSlice = kTile / kWarps;
  for (int base = 0; base < nt; base += kTile) {
    const int len = min(kTile, nt - base);
    __syncthreads();
    for (int i = threadIdx.x; i < len; i += kThreads) {
      const float2 t = tgt[base + i];
      tx[i] = t.x;
      ty[i] = t.y;
      tv[i] = valid[base + i];
    }
    __syncthreads();
    const int lo = warp * kSlice;
    const int hi = min(lo + kSlice, len);
    for (int j = lo; j < hi; ++j) {
      if (!tv[j]) continue;
      const float dx = __fsub_rn(s.x, tx[j]);
      const float dy = __fsub_rn(s.y, ty[j]);
      const float d2 = __fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy));
      if (d2 < best) {
        best = d2;
        best_i = base + j;
      }
    }
  }
  part_d[warp][lane] = best;
  part_i[warp][lane] = best_i;
  __syncthreads();
  if (warp != 0 || q >= nq) return;
  for (int w = 1; w < kWarps; ++w) {
    const float d = part_d[w][lane];
    const int i = part_i[w][lane];
    // a slice with no valid target holds (+inf, 0) and never wins
    if (d < best || (d == best && i < best_i)) {
      best = d;
      best_i = i;
    }
  }
  dmin[q] = best;
  idx[q] = best_i;
}

}  // namespace

// src (Nq, 2) and tgt (Nt, 2) contiguous float32, valid (Nt,) bool (one byte
// each), outputs dmin (Nq,) float32 and idx (Nq,) int64, all on the device.
extern "C" int nn_dist_launch(const float* src, const float* tgt,
                              const unsigned char* valid, float* dmin,
                              long long* idx, int nq, int nt, void* stream) {
  if (nq <= 0) return 0;
  const int blocks = (nq + kLanes - 1) / kLanes;
  nn_dist_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const float2*>(src), reinterpret_cast<const float2*>(tgt),
      valid, dmin, idx, nq, nt);
  return static_cast<int>(cudaGetLastError());
}
