// Constellation descriptors of a batch of B scans' features, for NVIDIA
// Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package computes the descriptors
// (navtech_radar_slam_tpu/ops/features.py::constellation_descriptors) as a
// jnp einsum over a separable hat basis, and the port's plain twin
// (navtech_radar_slam_torch/ops/features.py::constellation_descriptors) does
// the same with one batched matmul.  On the card that form materialises two
// (K, K, P) float32 hat tensors a scan, which the batched odometry step took
// in vmapped calls of 32 scans: two (32, 1024, 1024, 16) tensors of 2 GB
// each, ~25-50 elementwise launches a call, 16 calls a step at B = 512, and
// 71 % of the step's device time.  This kernel computes, for each valid
// centre i of each scan b,
//
//   dx, dy   = (xy_j - xy_i) rotated into i's radial frame (c_i, s_i)
//   gx, gy   = dx / cell + P / 2 - 0.5   (and so for dy)
//   w_ij     = power_j exp(-0.5 (dx^2 + dy^2) / (window / 2)^2)
//   desc[y, x] = sum over valid j of (hat(gy - y) w_ij) hat(gx - x),
//                hat(t) = max(0, 1 - |t|)
//
// then centres the P^2 cells, divides by max(norm, 1e-6), and writes the
// (B, K, P^2) float32 rows; an invalid centre gets a row of zeros.
//
// What bounds it on the card: operations, and they are few.  At B = 512,
// K = 1024 there are 5.4e8 (centre, neighbour) pairs, ~20 fp32 operations
// each to rotate, scale and test the pair, and up to one expf each:
// ~1.1e10 operations, 0.16 ms at 67 TFLOP/s.  The bytes are the features in
// (12 B each, read once) and 1 KB of descriptor out per feature: ~0.55 GB,
// 0.16 ms at 3.35 TB/s.  The splat itself is sparse: a 64 m window (16
// cells of 4 m) over features spread across a 180 m disc holds ~50 of a
// centre's 1,024 neighbours (median 50-51, at most ~140, on simulator
// scans), each with at most 4 bilinear taps.  So the design tests every pair
// and splats only the pairs inside the hat's support, -1 < gx < P and
// -1 < gy < P (outside it every tap weight is exactly 0 in the plain form
// too), and the expf runs only for those pairs.
//
// How work maps to the card: one warp per centre, kWarps = 8 centres of one
// scan per block of 256 threads, B * ceil(K / 8) blocks in one launch.  The
// block stages its scan's neighbours (x, y, power, valid) through shared
// memory in tiles of kTile in ascending index j; a warp walks a tile 32
// neighbours at a time, a lane per pair.  Each in-support lane writes its
// record (the cell of its lower-left tap, by(y0) w, by(y0 + 1) w, bx(x0),
// bx(x0 + 1)) to the warp's staging slots at its rank among the warp's
// in-support lanes (a ballot and a popcount), so the records stay in
// ascending j; then lanes 0-3 take one tap each of every record in turn and
// add it into the warp's P^2 cells in shared memory.  After the last tile
// the warp centres and normalises the cells (the epilogue, fused) and writes
// its row coalesced.
//
// Why the sum runs in ascending j with no atomics: each cell has one writer
// at a time (tap t of a record goes to lane t, a warp barrier between
// records), and it adds its terms in the order of j.  So a row's arithmetic
// depends on nothing but its own scan's features: not on B, not on the
// scan's position in the batch, not on what else the launch holds.  The
// batched step's rule (ROADMAP.md: a sum whose order a CUDA kernel picks by
// the batch shape must not enter the step) holds without the fixed-shape
// calls of 32 scans and the padding the matmul form needed, and the
// per-scan call (B = 1) gives each scan the bits the batched call gives it.
//
// The rows are the plain form's bits on the card, not only close to them:
// an output check that compares poses downstream of a mutual-nearest match
// and a ratio test moves a pose by ~1e-3 m when one descriptor's last bit
// flips a near-tie (1.2e-7 of descriptor difference did that on an H100).
// So every pair's operations are the plain form's, in its order, each
// rounded once (the _rn intrinsics, so nothing is contracted into a
// multiply-add): the divisions by cell and by (window / 2)^2 are
// multiplications by the float32 reciprocal, as PyTorch's CUDA division by
// a Python scalar is (both are exact at the configured 4 m and 1024 m^2),
// and the exponential is the full-precision expf.  Each term is
// (hat_y w) hat_x added by an FMA in ascending j from 0, which is the order
// of cuBLAS's FFMA GEMM for the plain form's (P, K) x (K, P) products (a
// skipped pair's term is an exact zero).  The epilogue reduces in ATen's
// order for a row reduction (aten_row_sum): the mean as the row's sum times
// float32(1 / P^2), the norm as NormTwoOps' sum of squares, its sqrt, and
// max(norm, 1e-6).  On an H100 with PyTorch 2.11 every row equals the
// twin's bit for bit at P = 5, 6, 8, 12, 16; at an odd P of 13 or more
// ATen's reduction depends on the row's address (its 16-byte alignment) and
// cuBLAS takes another kernel, so the rows agree to a few ulp there.  These
// two orders are copied from the libraries of one PyTorch release, and only
// because the odometry benchmark's pose limits (radarbench/checks/
// odo_fleet_b512.json) sit below what a sound reordering reads: a first
// version of this kernel, with its own order for the sum and the epilogue
// (descriptor gap 1.2e-7 - 1.8e-7), failed 8 of its 10 runs there on the
// pose limits (PERF.md §7).  Once the benchmark's limits hold a reordered
// float32 program, aten_row_sum goes, and the epilogue reduces in the
// simplest fixed order.  No fast math, no TF32, no tensor cores: the
// configuration states float32.
// ptxas (-Xptxas -v) gives the registers and shared memory: 48 registers,
// 18 KB static shared memory, no spills.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;                  // centres per block, a warp each
constexpr int kThreads = 32 * kWarps;
constexpr int kTile = 1024;                // neighbours staged per step
constexpr int kMaxCells = 1024;            // most cells P * P (P <= 32)

// One in-support neighbour's splat: the cell of its lower-left tap (row
// y0 = floor(gy), column x0 = floor(gx); either may be -1) and the factors
// of its four taps as the plain form rounds them.
struct Record {
  float by0w, by1w, bx0, bx1;
};

// max(0, 1 - |g - p|): the plain form's hat basis at cell centre p
__device__ __forceinline__ float hat(float g, float p) {
  return fmaxf(0.f, __fsub_rn(1.f, fabsf(__fsub_rn(g, p))));
}

// cos / sin of the bearing of (x, y) from the sensor, (1, 0) within 1e-6 m
// of it: the plain form's _radial_frame, its range a correctly rounded
// sqrt of x^2 + y^2 with each square rounded
__device__ __forceinline__ void radial_frame(float x, float y, float& c, float& s) {
  const float r = __fsqrt_rn(__fadd_rn(__fmul_rn(x, x), __fmul_rn(y, y)));
  const float safe = fmaxf(r, 1e-6f);
  const bool far = r > 1e-6f;
  c = far ? __fdiv_rn(x, safe) : 1.f;
  s = far ? __fdiv_rn(y, safe) : 0.f;
}

// The reduction of a contiguous row x[0, n) in shared memory as PyTorch's
// CUDA reduction of a (rows, n) tensor over its last dim orders it (ATen's
// ReduceOp: one warp per row; from 128 elements each lane loads 4-wide
// vectors into 4 accumulators, a lane's vectors 32 apart, and the tail goes
// to accumulator 0; up to 128, the lanes of the block width (the largest
// power of two <= n, at most 32) keep 4 accumulators strided by that width;
// then the accumulators in order, then a shfl_down tree of the lanes at
// offsets width / 2, ..., 2, 1), so the
// epilogue's mean and norm are the plain form's bits.  kSquares sums v * v as
// NormTwoOps does (acc + v * v, contracted into an FMA), else v.  Every lane
// gets lane 0's result.
template <bool kSquares>
__device__ __forceinline__ float aten_row_sum(const float* x, int n, int lane) {
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  auto add = [](float a, float v) { return kSquares ? __fmaf_rn(v, v, a) : __fadd_rn(a, v); };
  int width = 32;
  if (n >= 128) {
    for (int idx = lane; 4 * idx + 3 < n; idx += 32) {
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[i] = add(acc[i], x[4 * idx + i]);
    }
    const int tail = n - n % 4 + lane;
    if (tail < n) acc[0] = add(acc[0], x[tail]);
  } else {
    while (width > n) width >>= 1;
    if (lane < width) {
      int idx = lane;
      for (; idx + 3 * width < n; idx += 4 * width) {
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i] = add(acc[i], x[idx + i * width]);
      }
      for (int i = 0; i < 4 && idx < n; ++i, idx += width) acc[i] = add(acc[i], x[idx]);
    }
  }
  float v = __fadd_rn(__fadd_rn(__fadd_rn(acc[0], acc[1]), acc[2]), acc[3]);
  for (int o = width >> 1; o > 0; o >>= 1) v = __fadd_rn(v, __shfl_down_sync(0xffffffffu, v, o));
  return __shfl_sync(0xffffffffu, v, 0);
}

__global__ void __launch_bounds__(kThreads)
constellation_descriptors_kernel(const float* __restrict__ xy, const float* __restrict__ power,
                                 const uint8_t* __restrict__ valid, float* __restrict__ out,
                                 int k, int p, int groups, float inv_cell, float inv_r2) {
  extern __shared__ float s_cells[];       // kWarps x p * p
  __shared__ float s_x[kTile], s_y[kTile], s_pw[kTile];
  __shared__ uint8_t s_ok[kTile];
  __shared__ Record s_rec[kWarps][32];
  __shared__ int s_at[kWarps][32];

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const long long b = blockIdx.x / groups;
  const int i = (blockIdx.x % groups) * kWarps + warp;     // this warp's centre
  const long long base = b * k;
  const int n = p * p;
  float* cells = s_cells + warp * n;
  const bool live = i < k && valid[base + i];

  float xi = 0.f, yi = 0.f, cs = 1.f, sn = 0.f;
  if (live) {
    xi = xy[2 * (base + i)];
    yi = xy[2 * (base + i) + 1];
    radial_frame(xi, yi, cs, sn);
    for (int c = lane; c < n; c += 32) cells[c] = 0.f;
  }
  const float fp = static_cast<float>(p);
  const float half_p = 0.5f * fp;                          // P / 2
  // the taps a lane of 0-3 adds: tap (dy, dx) = (lane >> 1, lane & 1)
  const int tdy = (lane >> 1) & 1, tdx = lane & 1;

  for (int t0 = 0; t0 < k; t0 += kTile) {
    const int m = min(kTile, k - t0);
    __syncthreads();                       // every warp is done with the last tile
    for (int j = threadIdx.x; j < m; j += kThreads) {
      const long long g = base + t0 + j;
      s_x[j] = xy[2 * g];
      s_y[j] = xy[2 * g + 1];
      s_pw[j] = power[g];
      s_ok[j] = valid[g];
    }
    __syncthreads();
    if (!live) continue;
    for (int j0 = 0; j0 < m; j0 += 32) {
      const int j = j0 + lane;
      bool in = false;
      Record rec;
      int at = 0;
      if (j < m && s_ok[j]) {
        const float ddx = __fsub_rn(s_x[j], xi);
        const float ddy = __fsub_rn(s_y[j], yi);
        const float dx = __fadd_rn(__fmul_rn(cs, ddx), __fmul_rn(sn, ddy));
        const float dy = __fadd_rn(__fmul_rn(-sn, ddx), __fmul_rn(cs, ddy));
        const float gx = __fsub_rn(__fadd_rn(__fmul_rn(dx, inv_cell), half_p), 0.5f);
        const float gy = __fsub_rn(__fadd_rn(__fmul_rn(dy, inv_cell), half_p), 0.5f);
        in = gx > -1.f && gx < fp && gy > -1.f && gy < fp;
        if (in) {
          const float r2 = __fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy));
          const float w = __fmul_rn(s_pw[j], expf(__fmul_rn(__fmul_rn(r2, -0.5f), inv_r2)));
          const float x0 = floorf(gx), y0 = floorf(gy);
          rec.bx0 = hat(gx, x0);
          rec.bx1 = hat(gx, x0 + 1.f);
          rec.by0w = __fmul_rn(hat(gy, y0), w);
          rec.by1w = __fmul_rn(hat(gy, y0 + 1.f), w);
          at = ((static_cast<int>(y0) + 1) << 16) | (static_cast<int>(x0) + 1);
        }
      }
      const unsigned mask = __ballot_sync(0xffffffffu, in);
      if (in) {
        const int r = __popc(mask & ((1u << lane) - 1u));
        s_rec[warp][r] = rec;
        s_at[warp][r] = at;
      }
      __syncwarp();
      if (lane < 4) {
        const int count = __popc(mask);
        for (int r = 0; r < count; ++r) {
          const Record q = s_rec[warp][r];
          const int a = s_at[warp][r];
          const int yy = (a >> 16) - 1 + tdy, xx = (a & 0xffff) - 1 + tdx;
          if (yy >= 0 && yy < p && xx >= 0 && xx < p) {
            float* cell = cells + yy * p + xx;
            *cell = fmaf(tdy ? q.by1w : q.by0w, tdx ? q.bx1 : q.bx0, *cell);
          }
          __syncwarp(0xfu);                // the next record may share this cell
        }
      }
      __syncwarp();                        // the slots are free again
    }
  }
  if (i >= k) return;
  float* row = out + (base + i) * n;
  if (!live) {
    for (int c = lane; c < n; c += 32) row[c] = 0.f;
    return;
  }
  __syncwarp();                            // every tap is in the cells
  const float mean = __fmul_rn(aten_row_sum<false>(cells, n, lane),
                               __fdiv_rn(1.f, static_cast<float>(n)));
  for (int c = lane; c < n; c += 32) cells[c] = __fsub_rn(cells[c], mean);
  __syncwarp();
  const float den = fmaxf(__fsqrt_rn(aten_row_sum<true>(cells, n, lane)), 1e-6f);
  for (int c = lane; c < n; c += 32) row[c] = __fdiv_rn(cells[c], den);
}

}  // namespace

extern "C" int descriptors_max_cells() { return kMaxCells; }

// xy (B, K, 2), power (B, K) float32 and valid (B, K) bool (one byte each),
// out (B, K, p * p) float32, all contiguous on the device; inv_cell and
// inv_r2 the float32 reciprocals of the cell size and of (window / 2)^2.
// One launch of B * ceil(K / kWarps) blocks on `stream`; the host checks
// p * p <= kMaxCells.  Returns the CUDA error (0 =
// cudaSuccess) and leaves no error pending.
extern "C" int descriptors_launch(const float* xy, const float* power, const uint8_t* valid,
                                  float* out, int nscans, int k, int p, float inv_cell,
                                  float inv_r2, void* stream) {
  const int groups = (k + kWarps - 1) / kWarps;
  const size_t smem = sizeof(float) * kWarps * p * p;
  cudaError_t err = cudaFuncSetAttribute(constellation_descriptors_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err == cudaSuccess) {
    constellation_descriptors_kernel<<<static_cast<unsigned>(nscans) * groups, kThreads, smem,
                                       static_cast<cudaStream_t>(stream)>>>(
        xy, power, valid, out, k, p, groups, inv_cell, inv_r2);
    err = cudaGetLastError();
  }
  cudaGetLastError();
  return static_cast<int>(err);
}
