// cen2019 score map of one polar radar scan, or of a batch of B scans, for
// NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel
//   navtech_radar_slam_tpu/ops/pallas/cen_peaks.py::cen2019_scores_pallas
// and computes what its body (_kernel) computes, for one (NA, NBp) float32
// scan (400 x 3456 for the Navtech CIR204-H), and for each scan of a
// (B, NA, NBp) batch what it computes for that scan alone (the JAX package's
// jax.vmap of it in make_batched_odometry_step):
//
//   s      = power inside the range band [min_bin, nb_valid), 0 outside
//   sm     = s convolved along range with the Gaussian taps (zero padding)
//   ga     = |0.5 sm[c-1] - 0.5 sm[c+1]| (zero padding)
//   gs     = 0.25 ga[r-1] + 0.5 ga[r] + 0.25 ga[r+1] (azimuth wraps)
//   g      = gs / max(max over the scan of gs, 1e-9)
//   mean_r, var_r = per-azimuth mean / variance of sm over the band
//   h      = max(sm - mean_r, 0) * (1 - g)
//   mask   = band & h > mean of h over the band [& sm > mean_r + zq sqrt(var_r)]
//   out    = sm at the first position attaining each contiguous mask run's
//            max, -inf elsewhere.
//
// Every arithmetic step uses the _rn intrinsics in the order of the plain
// PyTorch twin (ops/cen2019.py::cen2019_scores), so no multiply-add is
// contracted and sm, ga, gs and h round exactly as the twin's do; only the
// sums behind mean_r, var_r and mean(h) are taken in another order.
//
// What bounds it on the card: memory.  The arithmetic is ~43 flops/px, far
// below the ~20 flop/byte balance point of the card's fp32 units, and the
// scan is 1.38 M px: 5.5 MB read and 5.5 MB written, 3.3 us at 3.35 TB/s.
// The TPU kernel holds the whole scan in VMEM and takes two whole-scan
// reductions (max g, mean h) inside one kernel.  A Hopper block has at most
// 227 KB of shared memory, but the grid as a whole has 132 x 228 KB, and a
// cooperative launch guarantees that all its blocks are resident at once.
// So the design is ONE cooperative launch with one block of 256 threads per
// azimuth row (400 blocks, four on each SM), whose four phases are
// separated by grid-wide barriers (cooperative_groups::this_grid().sync()):
//
//   A  smooth:  band mask, Gaussian, |grad|; per-row mean and variance.
//   B  gsmooth: the [1/4, 1/2, 1/4] azimuth smoothing (rows r-1, r, r+1);
//               per-row max.
//   C  h:       scan max from the 400 row maxima; h; per-row sum of h.
//   D  peaks:   mean h from the 400 row sums; mask; one thread per run start
//               walks its run and marks the first maximum.
//
// A row stays in dynamic shared memory across the phases as two float
// arrays: `a` holds sm (in phase D, the peak flags) and `w` the working row
// (s, then gs, then h, then sm under the mask and -inf off it): 8 bytes per
// bin, 27.7 KB at 3456 bins with the zeros that pad `w`, plus the 1 KB
// reduction scratch.  Only the per-row max of gs and sum of h, and the
// |grad| rows that the azimuth neighbours read, cross blocks through device
// memory; the |grad| rows go to the output buffer, which phase D overwrites
// with the map once every block has read them, so the kernel needs no
// scratch plane.  The scan is read once and the map written once.  The
// whole-scan values are the 400 row partials reduced by every block in the
// same fixed order (no float atomics), so two runs give the same map, and it
// equals the four-launch design's bit for bit.  In phase D each position has
// one writer: the thread that owns a run's first column walks the run (runs
// are short, a blob is a few bins) and flags its first maximum in `a`; the
// map is then written coalesced.
//
// Where the time goes, by per-block clock64 stamps on an H100: the range
// smoothing took the largest share until its taps became compile-time
// registers over a zero-padded row; the rest is the three grid barriers and
// short elementwise phases whose __fdiv_rn and row reductions are
// issue-bound at three to four blocks per SM.
//
// A batch (K1 x B) is the same grid of NA resident row blocks, looping
// over the B scans: each scan's four phases and three barriers run inside
// the loop (3B grid barriers in one launch), each scan has its own 2 * NA
// row statistics, and the rows in shared memory are refilled per scan.  A
// scan's whole-scan values are reduced in the fixed order of one scan, so
// scan b's map is the one-scan launch's map of scan b bit for bit.  One
// scan (K1) is this loop at B = 1: one entry point, cen2019_scores_launch,
// takes both.  Why not one grid over all B x NA rows: a grid barrier needs
// every block resident, and at 400 rows an H100 holds 528 row blocks (four
// on each SM), so the scans cannot all be resident at once; block groups of
// one scan each, with barriers of their own, would hold at most one 400-row
// scan on the card too.  The cost is B times the one-scan chain of phases
// and barriers: the launch moves 11 MB a scan, but its time is B times K1's,
// far above what the bytes bound (PERF.md has both).
//
// Co-residency is the risk: the host checks cudaDevAttrCooperativeLaunch
// and that cudaOccupancyMaxActiveBlocksPerMultiprocessor x SMs covers every
// row, and returns an error otherwise; there is no multi-launch fallback.
// The rows' shared memory sets the longest row: at 400 rows an H100 must
// hold four blocks on an SM, 57 KB each with the 1 KB the system reserves,
// so a row may have up to 7,034 bins with 13 taps (the wrapper's
// max_row_bins; the four-launch design took 6,144).

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;  // a power of two: block_reduce halves it
constexpr int kMinBlocksPerSm = 4;  // 400 rows on 132 SMs: <= 64 registers
constexpr int kMaxTaps = 63;

struct Taps {
  int n;
  float w[kMaxTaps];
};

__device__ __forceinline__ float neg_inf() { return __int_as_float(0xff800000); }

struct AddOp {
  __device__ float operator()(float a, float b) const { return __fadd_rn(a, b); }
};
struct MaxOp {
  __device__ float operator()(float a, float b) const { return fmaxf(a, b); }
};

// Tree reduction over the block in a fixed pattern: the same inputs give the
// same result on every run.  Element i takes i + s for s = 128, 64, ..., 1;
// the last five levels run in warp 0 as shuffles, with the same pairs.
template <typename Op>
__device__ float block_reduce(float v, float* red, Op op) {
  const int tid = threadIdx.x;
  red[tid] = v;
  __syncthreads();
  for (int s = kThreads / 2; s >= 32; s >>= 1) {
    if (tid < s) red[tid] = op(red[tid], red[tid + s]);
    __syncthreads();
  }
  if (tid < 32) {
    float x = red[tid];
#pragma unroll
    for (int s = 16; s > 0; s >>= 1) x = op(x, __shfl_down_sync(0xffffffffu, x, s));
    if (tid == 0) red[0] = x;
  }
  __syncthreads();
  const float out = red[0];
  __syncthreads();
  return out;
}

__device__ __forceinline__ bool in_band(int c, int min_bin, int nb_valid) {
  return c >= min_bin && c < nb_valid;
}

__device__ __forceinline__ int band_width(int nbp, int min_bin, int nb_valid) {
  return max(min(nb_valid, nbp) - max(min_bin, 0), 0);
}

// Dynamic shared memory of one block: the rows `a` and `w`, and ntaps / 2
// zeros on each side of `w` for the range smoothing.
__host__ __device__ constexpr size_t row_smem_bytes(int nbp, int ntaps) {
  return sizeof(float) * (2 * static_cast<size_t>(nbp) + ntaps - 1);
}

// The map of one scan.  Block r owns azimuth row r; all na blocks are
// resident (cooperative launch).  N is the number of smoothing taps when
// known at compile time (13, for the 2-bin sigma of every shipped config:
// the taps sit in registers and the loop unrolls), 0 to take taps.n at run
// time.  stats holds 2 * na floats: the row maxima of gs, then the row sums
// of h.  `out` is read by other blocks in phase B, so it is neither const
// nor __restrict__, and those reads go through L2 (__ldcg), never the
// non-coherent read-only path.  smem holds the rows, red the reduction
// scratch.
template <int N>
__device__ __forceinline__ void score_scan(const float* __restrict__ power, float* out,
                                           float* stats, int na, int nbp, int min_bin,
                                           int nb_valid, Taps taps, float zq,
                                           float* smem, float* red, cg::grid_group& grid) {
  const int ntaps = N > 0 ? N : taps.n;
  const int rad = ntaps / 2;
  float* a = smem;
  float* w = smem + nbp + rad;   // w[-rad, nbp + rad) is in shared memory
  const int tid = threadIdx.x;
  const int r = blockIdx.x;
  const size_t row = static_cast<size_t>(r) * nbp;
  float* row_gmax = stats;
  float* row_hsum = stats + na;

  // A: range smoothing, |range gradient| (to `out`), row mean and variance.
  // The zeros around s are the twin's zero padding, so the taps need no
  // bounds test.
  for (int c = tid; c < rad; c += kThreads) {
    w[-1 - c] = 0.f;
    w[nbp + c] = 0.f;
  }
  for (int c = tid; c < nbp; c += kThreads)
    w[c] = in_band(c, min_bin, nb_valid) ? power[row + c] : 0.f;
  __syncthreads();
  float tw[N > 0 ? N : 1];
#pragma unroll
  for (int t = 0; t < N; ++t) tw[t] = taps.w[t];
  float part = 0.f;
  for (int c = tid; c < nbp; c += kThreads) {
    const float* x = w + c - rad;
    float acc = 0.f;
    if constexpr (N > 0) {
#pragma unroll
      for (int t = 0; t < N; ++t) acc = __fadd_rn(acc, __fmul_rn(tw[t], x[t]));
    } else {
#pragma unroll 4
      for (int t = 0; t < ntaps; ++t) acc = __fadd_rn(acc, __fmul_rn(taps.w[t], x[t]));
    }
    a[c] = acc;
    if (in_band(c, min_bin, nb_valid)) part = __fadd_rn(part, acc);
  }
  const float denom = fmaxf(static_cast<float>(band_width(nbp, min_bin, nb_valid)), 1.f);
  const float mean = __fdiv_rn(block_reduce(part, red, AddOp()), denom);  // syncs a too

  part = 0.f;
  for (int c = tid; c < nbp; c += kThreads) {
    const float xl = c > 0 ? a[c - 1] : 0.f;
    const float xr = c + 1 < nbp ? a[c + 1] : 0.f;
    out[row + c] = fabsf(__fadd_rn(__fmul_rn(0.5f, xl), __fmul_rn(-0.5f, xr)));
    if (in_band(c, min_bin, nb_valid)) {
      const float d = __fsub_rn(a[c], mean);
      part = __fadd_rn(part, __fmul_rn(d, d));
    }
  }
  const float var = __fdiv_rn(block_reduce(part, red, AddOp()), denom);
  grid.sync();

  // B: azimuth smoothing of |grad| with wrap, into w; row max.
  const float* up = out + static_cast<size_t>((r + na - 1) % na) * nbp;
  const float* mid = out + row;
  const float* dn = out + static_cast<size_t>((r + 1) % na) * nbp;
  float m = neg_inf();
  for (int c = tid; c < nbp; c += kThreads) {
    const float v = __fadd_rn(__fadd_rn(__fmul_rn(0.25f, __ldcg(up + c)),
                                        __fmul_rn(0.5f, __ldcg(mid + c))),
                              __fmul_rn(0.25f, __ldcg(dn + c)));
    w[c] = v;
    m = fmaxf(m, v);
  }
  m = block_reduce(m, red, MaxOp());
  if (tid == 0) row_gmax[r] = m;
  grid.sync();

  // C: scan max from the row maxima; h = max(sm - mean, 0) * (1 - gs / max),
  // into w; row sum of h over the band.
  float gm = neg_inf();
  for (int i = tid; i < na; i += kThreads) gm = fmaxf(gm, __ldcg(row_gmax + i));
  gm = fmaxf(block_reduce(gm, red, MaxOp()), 1e-9f);
  part = 0.f;
  for (int c = tid; c < nbp; c += kThreads) {
    const float g = __fdiv_rn(w[c], gm);
    const float sp = fmaxf(__fsub_rn(a[c], mean), 0.f);
    const float h = __fmul_rn(sp, __fsub_rn(1.f, g));
    w[c] = h;
    if (in_band(c, min_bin, nb_valid)) part = __fadd_rn(part, h);
  }
  part = block_reduce(part, red, AddOp());
  if (tid == 0) row_hsum[r] = part;
  grid.sync();

  // D: mean h from the row sums; the mask (w = sm on it, -inf off it; sm is
  // finite for a finite scan); one peak per contiguous run, flagged in a.
  float hs = 0.f;
  for (int i = tid; i < na; i += kThreads) hs = __fadd_rn(hs, __ldcg(row_hsum + i));
  hs = block_reduce(hs, red, AddOp());
  const float n_band = static_cast<float>(na) * band_width(nbp, min_bin, nb_valid);
  const float h_mean = __fdiv_rn(hs, fmaxf(n_band, 1.f));
  const float gate = __fadd_rn(mean, __fmul_rn(zq, __fsqrt_rn(var)));
  for (int c = tid; c < nbp; c += kThreads) {
    const float x = a[c];
    const bool on = in_band(c, min_bin, nb_valid) && w[c] > h_mean && (zq <= 0.f || x > gate);
    w[c] = on ? x : neg_inf();
    a[c] = 0.f;
  }
  __syncthreads();

  // the thread that owns a run's first column walks the run; runs are
  // disjoint, so each flag has one writer
  for (int c = tid; c < nbp; c += kThreads) {
    if (w[c] == neg_inf() || (c > 0 && w[c - 1] != neg_inf())) continue;
    int best = c;
    float bv = w[c];
    for (int j = c + 1; j < nbp && w[j] != neg_inf(); ++j) {
      if (w[j] > bv) {
        bv = w[j];
        best = j;
      }
    }
    a[best] = 1.f;
  }
  __syncthreads();

  for (int c = tid; c < nbp; c += kThreads) out[row + c] = a[c] != 0.f ? w[c] : neg_inf();
}

// The maps of nscans scans of na x nbp, one after another (one scan: K1; a
// batch: K1 x B).  Scan b reads power + b * na * nbp, writes the same plane
// of out and keeps its row statistics at stats + 2 * na * b.
template <int N>
__global__ void __launch_bounds__(kThreads, kMinBlocksPerSm)
cen2019_kernel(const float* __restrict__ power, float* out, float* stats, int nscans,
               int na, int nbp, int min_bin, int nb_valid, Taps taps, float zq) {
  extern __shared__ float smem[];
  __shared__ float red[kThreads];
  cg::grid_group grid = cg::this_grid();
  const size_t plane = static_cast<size_t>(na) * nbp;
  for (int b = 0; b < nscans; ++b) {
    // the last phase of scan b - 1 still reads the rows this one refills
    if (b > 0) __syncthreads();
    score_scan<N>(power + b * plane, out + b * plane, stats + 2 * static_cast<size_t>(na) * b,
                  na, nbp, min_bin, nb_valid, taps, zq, smem, red, grid);
  }
}

}  // namespace

// The launch constants the Python wrapper mirrors (ops/kernels/cen_peaks.py).
extern "C" int cen2019_threads() { return kThreads; }
extern "C" long long cen2019_smem_bytes(int nbp, int ntaps) {
  return static_cast<long long>(row_smem_bytes(nbp, ntaps) + sizeof(float) * kThreads);
}

// The current device's limits on co-resident blocks, in `out`: SMs, shared
// memory per SM, shared memory the system reserves per block, the most
// shared memory one block may opt in to, threads per SM.  Returns the CUDA
// error (0 = cudaSuccess).
extern "C" int cen2019_device_limits(int* out) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  const cudaDeviceAttr attrs[5] = {
      cudaDevAttrMultiProcessorCount, cudaDevAttrMaxSharedMemoryPerMultiprocessor,
      cudaDevAttrReservedSharedMemoryPerBlock, cudaDevAttrMaxSharedMemoryPerBlockOptin,
      cudaDevAttrMaxThreadsPerMultiProcessor};
  for (int i = 0; i < 5 && e == cudaSuccess; ++i) e = cudaDeviceGetAttribute(out + i, attrs[i], dev);
  return static_cast<int>(e);
}

// The one cooperative launch of nscans scans on `stream` (K1 is nscans = 1,
// K1 x B a (nscans, na, nbp) batch).  `stats` holds
// 2 * na * nscans floats; the caller allocates it and the output.  Returns
// the CUDA error (0 = cudaSuccess), cudaErrorCooperativeLaunchTooLarge when
// the card cannot hold all na blocks at once, and leaves no error pending.
// There is no multi-launch fallback.  Does not synchronise.
extern "C" int cen2019_scores_launch(const float* power, float* out, float* stats, int nscans,
                                     int na, int nbp, int min_bin, int nb_valid,
                                     const float* taps, int ntaps, float zq, void* stream) {
  if (nscans < 1 || na < 1 || nbp < 1 || ntaps < 1 || ntaps > kMaxTaps || ntaps % 2 == 0)
    return static_cast<int>(cudaErrorInvalidValue);
  Taps t;
  t.n = ntaps;
  for (int i = 0; i < ntaps; ++i) t.w[i] = taps[i];

  const auto kernel = ntaps == 13 ? cen2019_kernel<13> : cen2019_kernel<0>;
  int dev = 0, coop = 0, sms = 0, per_sm = 0;
  const size_t smem = row_smem_bytes(nbp, ntaps);
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (e == cudaSuccess && !coop) e = cudaErrorNotSupported;
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                             static_cast<int>(cudaSharedmemCarveoutMaxShared));
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem);
  if (e == cudaSuccess && static_cast<long long>(per_sm) * sms < na)
    e = cudaErrorCooperativeLaunchTooLarge;
  if (e == cudaSuccess) {
    void* args[] = {&power, &out, &stats, &nscans, &na, &nbp, &min_bin, &nb_valid, &t, &zq};
    e = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(kernel), dim3(na),
                                    dim3(kThreads), args, smem,
                                    static_cast<cudaStream_t>(stream));
  }
  const cudaError_t last = cudaGetLastError();  // clears a refused call
  return static_cast<int>(e != cudaSuccess ? e : last);
}

