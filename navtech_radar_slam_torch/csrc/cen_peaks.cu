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
// K1 x B, a batch of B scans, takes one of two designs, chosen by the host
// (ops/kernels/cen_peaks.py::design_for) at a crossover of B = 8 that an
// H100 fixed (PERF.md):
//
//   * resident (B < 8; K1 is B = 1): the grid above, looping over the scans:
//     each scan's four phases and three barriers run inside the loop, each
//     scan has its own 2 * NA row statistics, and the rows are refilled per
//     scan.  Its cost is B times K1's chain of phases and barriers, since a
//     scan's rows must all be resident across its two whole-scan reductions
//     and the card holds only one 400-row scan that way.
//   * streamed (B >= 8): no scan is resident.  The two whole-scan values are
//     reductions of 2 * NA row partials, and everything else is local to a
//     row but for gs reading the |grad| rows r +- 1; so a row does not need
//     to stay on chip across a reduction: it is carried through planes in
//     L2 instead.  Four stages, each a task of one row:
//       A  power -> sm (to a T plane) and |grad| (to a G plane); the row's
//          mean and variance;
//       B  gs from the G rows r - 1, r, r + 1 (to the output plane); its max;
//       C  the scan max from the NA row maxima; h (over gs); its band sum;
//       D  mean h from the NA row sums; the mask, one peak a run, the map.
//     A co-resident grid (a cooperative launch, 128-thread blocks, seven on
//     each SM) walks one task list, phase g holding C of scan g - 1, then A
//     and B of scan g, then D of scan g - 1.  Tasks wait on counts and flags
//     that earlier tasks raise (B on the three A rows it reads, C on every B
//     row of its scan, D on every C row, A on D of the scan that last used
//     its scratch slot, kRingScans scans back), each block takes its tasks
//     in list order, and every wait is on an earlier task, so the grid always
//     progresses.  The T and G planes are a ring of 3 scans of slots, not B.
//     A block of 128 threads keeps the partial sums of K1's threads t and
//     t + 128 in thread t, in K1's column order, and pair_reduce is
//     block_reduce's tree with its first level in registers; the scan values
//     are the same reductions of the same row values; every step is the same
//     _rn intrinsic: so scan b's map is K1's map of scan b bit for bit, at
//     any B.
//
// What bounds the streamed design: the latency of its row tasks.  Each is a
// chain of dependent L2 round trips (the wait, the row's loads, the block
// reductions, the stores, the fence before its count) with seven tasks an
// SM in flight, so at B = 64 it takes 1.28 ms against 0.211 ms for the
// bytes (share 0.165), 0.88 of the resident design's 1.46 ms.  The designs
// tried, device ms at B = 64 beside the resident design in the same run
// (H100; PERF.md has B = 8 and 32 too):
//   * earlier designs that overlapped scans inside the resident layout:
//     six, all slower, not recorded;
//   * streamed, 256-thread blocks, 4 an SM, one global load at a time in
//     each strided loop (a store to the same plane kept the compiler from
//     hoisting the next load), every thread fencing: 1.951 (resident 1.462);
//   * the same, loads batched 8 a thread, one fence a task: 1.468 (1.460);
//   * 128-thread blocks, 7 an SM (shipped): 1.310 (1.459);
//   * a deeper task list (A, B, C, D of scans g .. g - 3; 5 scans of slots):
//     1.656 against 1.446 for the shipped list in the same build (the
//     planes of four scans in flight overflow L2);
//   * the whole-scan values reduced once, by the block whose count finishes
//     a stage, instead of in every C and D task: 1.340 (1.464);
//   * a warp per row task (16-byte I/O, neighbours and K1's tree by
//     shuffles, the run walk in shared memory; 116 registers, 16 warps an
//     SM): 3.261 (1.454);
//   * the segments in the order A, C, B, D: 1.593 (1.462);
//   * waves of 2 and 4 scans a phase (a wave of one is shipped, its ring of
//     slots 3 scans): 1.396 and 1.555 (1.459);
//   * no task list, one ordinary launch a pass over every row of the batch,
//     a 256-thread block a row (gs from the power rows r - 1, r, r + 1, sm
//     recomputed in the h and map passes, no scratch plane, no flags): three
//     launches, 2.068 (streamed 1.340, resident 1.470); 1.058 at B = 32
//     (0.680, 0.736).  Each pass is a chain of block barriers a row with
//     five blocks an SM, and the three passes smooth each row five times.
// ptxas (-Xptxas -v, which chip_smoke.py prints): the streamed kernel 72
// registers, 8 bytes of spill with 13 taps and none with run-time taps; the
// resident kernel 64, none.
//
// Co-residency is the risk of the resident design: the host checks
// cudaDevAttrCooperativeLaunch and that
// cudaOccupancyMaxActiveBlocksPerMultiprocessor x SMs covers every row, and
// returns an error otherwise; there is no multi-launch fallback (the
// streamed design's grid is sized from the same occupancy query).  Either
// design takes the rows K1 takes.
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

// ---------------------------------------------------------------------------
// K1 x B, the streamed design: no scan is held on the card.  See the note
// at the top; this is its device side.

// Threads of a streamed block: thread t keeps the partial sums of K1's
// threads t and t + 128, so every row and scan sum is K1's to the bit.
constexpr int kSThreads = kThreads / 2;
constexpr int kStreamBlocksPerSm = 7;  // 7 x 30 KB of shared memory, <= 72 registers
constexpr int kStages = 4;             // segments of a phase
// scratch slots (sm and |grad| planes of a scan): scan s takes slot s % 3,
// which scan s + 3 refills only once scan s's D tasks are done
constexpr int kRingScans = 3;
// per scan: the row statistics (mean, variance, gs max, h sum: 4 * na
// floats), then, as ints: a flag per row for stage A, and the rows that
// stages B, C and D have finished
constexpr int kStatsPerRow = 4;
constexpr int kDoneCounts = 3;
// The strided loops over a row load kBatch columns of a thread at once, so
// that their latencies overlap (a store to the plane a loop also reads would
// otherwise keep the compiler from moving the next load ahead of it).  Even,
// so that batch column j belongs to K1's thread tid + 128 * (j % 2).
constexpr int kBatch = 8;

// K1's block_reduce of its 256 partials, of which thread t holds p0 (K1's
// thread t) and p1 (K1's thread t + 128): its first level pairs exactly
// these, the rest is the same tree.
template <typename Op>
__device__ float pair_reduce(float p0, float p1, float* red, Op op) {
  const int tid = threadIdx.x;
  red[tid] = op(p0, p1);
  __syncthreads();
  for (int s = kSThreads / 2; s >= 32; s >>= 1) {
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

// add x to the partial of K1's thread that owns column (or row) c
__device__ __forceinline__ void add_part(float& p0, float& p1, int c, float x) {
  if ((c >> 7) & 1) p1 = __fadd_rn(p1, x);
  else p0 = __fadd_rn(p0, x);
}

struct StreamArgs {
  const float* power;
  float* out;
  float* tplane;   // sm, kRingScans slots of na * nbp floats
  float* gplane;   // |grad|, the same slots
  float* stats;    // nscans * kStatsPerRow * na floats
  int* sync;       // nscans * (na + kDoneCounts) ints
  int nscans, na, nbp, min_bin, nb_valid;
  Taps taps;
  float zq;
};

__device__ __forceinline__ int ld_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.s32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}

// thread 0 waits until *p >= target; then the whole block goes on.  What the
// producers wrote is read through L2 (__ldcg), never from a stale L1 line.
__device__ __forceinline__ void wait_for(const int* p, int target) {
  if (threadIdx.x == 0)
    while (ld_acquire(p) < target) __nanosleep(32);
  __syncthreads();
}

// the block's writes of this task, then one count: the barrier orders every
// thread's writes before thread 0's fence and count (as a grid barrier of
// cooperative_groups does)
__device__ __forceinline__ void signal_done(int* p) {
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    atomicAdd(p, 1);
  }
}

// Rows of smem for one task: w (the band-masked row with its zero pads; in
// stage D the masked sm) and a (sm; in stage D the peak flags).  w[-pad, 0)
// and w[nbp, ...) are zeros; pad is rad rounded up to 4 so that w[c - pad]
// is 16-byte aligned for every c that is a multiple of 4.
__host__ __device__ constexpr int stream_pad(int ntaps) { return (ntaps / 2 + 3) & ~3; }
__host__ __device__ constexpr int stream_w_floats(int nbp, int ntaps) {
  return stream_pad(ntaps) + ((nbp + 3) & ~3) + stream_pad(ntaps) + 8;
}
__host__ __device__ constexpr size_t stream_smem_bytes(int nbp, int ntaps) {
  return sizeof(float) * (static_cast<size_t>(stream_w_floats(nbp, ntaps)) + nbp);
}

__device__ __forceinline__ size_t slot_offset(const StreamArgs& p, int s) {
  return static_cast<size_t>(s % kRingScans) * p.na * p.nbp;
}
__device__ __forceinline__ int* done_counts(const StreamArgs& p, int s) {
  return p.sync + static_cast<size_t>(p.nscans) * p.na + static_cast<size_t>(s) * kDoneCounts;
}
__device__ __forceinline__ float* scan_stats(const StreamArgs& p, int s) {
  return p.stats + static_cast<size_t>(s) * kStatsPerRow * p.na;
}

// Stage A of (scan s, row r): sm (to the T plane) and |grad| (to the G
// plane), the row's mean and variance.  Arithmetic and order as score_scan's
// phase A; the Gaussian takes four neighbouring columns a thread from five
// 16-byte loads when its tap count is known at compile time.
template <int N>
__device__ __forceinline__ void stage_a(const StreamArgs& p, int s, int r, float* smem,
                                        float* red) {
  const int ntaps = N > 0 ? N : p.taps.n;
  const int pad = stream_pad(ntaps);
  const int nbp = p.nbp, tid = threadIdx.x;
  const int min_bin = p.min_bin, nb_valid = p.nb_valid;
  float* w = smem + pad;
  float* a = smem + stream_w_floats(nbp, ntaps);
  const size_t row = static_cast<size_t>(r) * nbp;
  float* tp = p.tplane + slot_offset(p, s) + row;
  float* gp = p.gplane + slot_offset(p, s) + row;
  const float* pw = p.power + static_cast<size_t>(s) * p.na * nbp + row;

  // the slot's previous scan must be done with it
  if (s >= kRingScans) wait_for(done_counts(p, s - kRingScans) + 2, p.na);

  const int wn = stream_w_floats(nbp, ntaps);
  for (int i0 = tid; i0 < wn; i0 += kBatch * kSThreads) {
    float v[kBatch];
#pragma unroll
    for (int j = 0; j < kBatch; ++j) {
      const int c = i0 + j * kSThreads - pad;
      v[j] = c >= 0 && c < nbp && in_band(c, min_bin, nb_valid) ? pw[c] : 0.f;
    }
#pragma unroll
    for (int j = 0; j < kBatch; ++j)
      if (i0 + j * kSThreads < wn) smem[i0 + j * kSThreads] = v[j];
  }
  __syncthreads();

  if constexpr (N > 0) {
    constexpr int kPad = stream_pad(N);
    constexpr int kVec = (kPad + 4 + N / 2 + 3) / 4;   // float4s a group reads
    for (int c0 = 4 * tid; c0 < nbp; c0 += 4 * kSThreads) {
      float x[4 * kVec];
#pragma unroll
      for (int v = 0; v < kVec; ++v) {
        const float4 q = *reinterpret_cast<const float4*>(w + c0 - kPad + 4 * v);
        x[4 * v] = q.x;
        x[4 * v + 1] = q.y;
        x[4 * v + 2] = q.z;
        x[4 * v + 3] = q.w;
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float acc = 0.f;
#pragma unroll
        for (int t = 0; t < N; ++t)
          acc = __fadd_rn(acc, __fmul_rn(p.taps.w[t], x[kPad - N / 2 + j + t]));
        if (c0 + j < nbp) a[c0 + j] = acc;
      }
    }
  } else {
    const int rad = ntaps / 2;
    for (int c = tid; c < nbp; c += kSThreads) {
      const float* x = w + c - rad;
      float acc = 0.f;
#pragma unroll 4
      for (int t = 0; t < ntaps; ++t) acc = __fadd_rn(acc, __fmul_rn(p.taps.w[t], x[t]));
      a[c] = acc;
    }
  }
  __syncthreads();

  float p0 = 0.f, p1 = 0.f;
  for (int c = tid; c < nbp; c += kSThreads)
    if (in_band(c, min_bin, nb_valid)) add_part(p0, p1, c, a[c]);
  const float denom = fmaxf(static_cast<float>(band_width(nbp, min_bin, nb_valid)), 1.f);
  const float mean = __fdiv_rn(pair_reduce(p0, p1, red, AddOp()), denom);

  p0 = p1 = 0.f;
  for (int c = tid; c < nbp; c += kSThreads) {
    const float xl = c > 0 ? a[c - 1] : 0.f;
    const float xr = c + 1 < nbp ? a[c + 1] : 0.f;
    __stcg(gp + c, fabsf(__fadd_rn(__fmul_rn(0.5f, xl), __fmul_rn(-0.5f, xr))));
    __stcg(tp + c, a[c]);
    if (in_band(c, min_bin, nb_valid)) {
      const float d = __fsub_rn(a[c], mean);
      add_part(p0, p1, c, __fmul_rn(d, d));
    }
  }
  const float var = __fdiv_rn(pair_reduce(p0, p1, red, AddOp()), denom);
  float* st = scan_stats(p, s);
  if (tid == 0) {
    __stcg(st + r, mean);
    __stcg(st + p.na + r, var);
  }
  signal_done(p.sync + static_cast<size_t>(s) * p.na + r);
}

// Stage B of (scan s, row r): gs from the |grad| rows r - 1, r, r + 1 (wrap)
// into the output plane, and the row's max of gs.
__device__ __forceinline__ void stage_b(const StreamArgs& p, int s, int r, float* red) {
  const int na = p.na, nbp = p.nbp, tid = threadIdx.x;
  const int up_r = (r + na - 1) % na, dn_r = (r + 1) % na;
  const int* flags = p.sync + static_cast<size_t>(s) * na;
  if (tid < 3)
    while (ld_acquire(flags + (tid == 0 ? up_r : tid == 1 ? r : dn_r)) < 1) __nanosleep(32);
  __syncthreads();
  const float* g = p.gplane + slot_offset(p, s);
  const float* up = g + static_cast<size_t>(up_r) * nbp;
  const float* mid = g + static_cast<size_t>(r) * nbp;
  const float* dn = g + static_cast<size_t>(dn_r) * nbp;
  float* o = p.out + (static_cast<size_t>(s) * na + r) * nbp;
  float m = neg_inf();
  for (int c0 = tid; c0 < nbp; c0 += kBatch * kSThreads) {
    float u[kBatch], x[kBatch], d[kBatch];
#pragma unroll
    for (int j = 0; j < kBatch; ++j) {
      const int c = c0 + j * kSThreads;
      u[j] = c < nbp ? __ldcg(up + c) : 0.f;
      x[j] = c < nbp ? __ldcg(mid + c) : 0.f;
      d[j] = c < nbp ? __ldcg(dn + c) : 0.f;
    }
#pragma unroll
    for (int j = 0; j < kBatch; ++j) {
      const int c = c0 + j * kSThreads;
      if (c >= nbp) break;
      const float v = __fadd_rn(__fadd_rn(__fmul_rn(0.25f, u[j]), __fmul_rn(0.5f, x[j])),
                                __fmul_rn(0.25f, d[j]));
      __stcg(o + c, v);
      m = fmaxf(m, v);
    }
  }
  m = pair_reduce(m, neg_inf(), red, MaxOp());
  if (tid == 0) __stcg(scan_stats(p, s) + 2 * na + r, m);
  signal_done(done_counts(p, s));
}

// Stage C of (scan s, row r): the scan max of gs from the row maxima, h into
// the output plane over gs, the row's sum of h over the band.
__device__ __forceinline__ void stage_c(const StreamArgs& p, int s, int r, float* red) {
  const int na = p.na, nbp = p.nbp, tid = threadIdx.x;
  int* done = done_counts(p, s);
  wait_for(done, na);
  float* st = scan_stats(p, s);
  float gm = neg_inf();
  for (int i = tid; i < na; i += kSThreads) gm = fmaxf(gm, __ldcg(st + 2 * na + i));
  gm = fmaxf(pair_reduce(gm, neg_inf(), red, MaxOp()), 1e-9f);
  const float mean = __ldcg(st + r);
  const size_t row = static_cast<size_t>(r) * nbp;
  const float* sm = p.tplane + slot_offset(p, s) + row;
  float* o = p.out + static_cast<size_t>(s) * na * nbp + row;
  float p0 = 0.f, p1 = 0.f;
  for (int c0 = tid; c0 < nbp; c0 += kBatch * kSThreads) {
    float gs[kBatch], x[kBatch];
#pragma unroll
    for (int j = 0; j < kBatch; ++j) {
      const int c = c0 + j * kSThreads;
      gs[j] = c < nbp ? __ldcg(o + c) : 0.f;
      x[j] = c < nbp ? __ldcg(sm + c) : 0.f;
    }
#pragma unroll
    for (int j = 0; j < kBatch; ++j) {
      const int c = c0 + j * kSThreads;
      if (c >= nbp) break;
      const float g = __fdiv_rn(gs[j], gm);
      const float sp = fmaxf(__fsub_rn(x[j], mean), 0.f);
      const float h = __fmul_rn(sp, __fsub_rn(1.f, g));
      __stcg(o + c, h);
      if (in_band(c, p.min_bin, p.nb_valid)) add_part(p0, p1, c, h);
    }
  }
  const float part = pair_reduce(p0, p1, red, AddOp());
  if (tid == 0) __stcg(st + 3 * na + r, part);
  signal_done(done + 1);
}

// Stage D of (scan s, row r): mean h from the row sums, the mask, one peak a
// run, the map row; as score_scan's phase D.
__device__ __forceinline__ void stage_d(const StreamArgs& p, int s, int r, float* smem,
                                        float* red, int ntaps) {
  const int na = p.na, nbp = p.nbp, tid = threadIdx.x;
  int* done = done_counts(p, s);
  wait_for(done + 1, na);
  const float* st = scan_stats(p, s);
  float p0 = 0.f, p1 = 0.f;
  for (int i = tid; i < na; i += kSThreads) add_part(p0, p1, i, __ldcg(st + 3 * na + i));
  const float hs = pair_reduce(p0, p1, red, AddOp());
  const int min_bin = p.min_bin, nb_valid = p.nb_valid;
  const float n_band = static_cast<float>(na) * band_width(nbp, min_bin, nb_valid);
  const float h_mean = __fdiv_rn(hs, fmaxf(n_band, 1.f));
  const float mean = __ldcg(st + r), var = __ldcg(st + na + r);
  const float gate = __fadd_rn(mean, __fmul_rn(p.zq, __fsqrt_rn(var)));
  const size_t row = static_cast<size_t>(r) * nbp;
  const float* sm = p.tplane + slot_offset(p, s) + row;
  float* o = p.out + static_cast<size_t>(s) * na * nbp + row;
  float* w = smem;
  float* a = smem + stream_w_floats(nbp, ntaps);
  for (int c0 = tid; c0 < nbp; c0 += kBatch * kSThreads) {
    float x[kBatch], h[kBatch];
#pragma unroll
    for (int j = 0; j < kBatch; ++j) {
      const int c = c0 + j * kSThreads;
      x[j] = c < nbp ? __ldcg(sm + c) : 0.f;
      h[j] = c < nbp ? __ldcg(o + c) : 0.f;
    }
#pragma unroll
    for (int j = 0; j < kBatch; ++j) {
      const int c = c0 + j * kSThreads;
      if (c >= nbp) break;
      const bool on = in_band(c, min_bin, nb_valid) && h[j] > h_mean &&
                      (p.zq <= 0.f || x[j] > gate);
      w[c] = on ? x[j] : neg_inf();
      a[c] = 0.f;
    }
  }
  __syncthreads();
  for (int c = tid; c < nbp; c += kSThreads) {
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
  for (int c = tid; c < nbp; c += kSThreads) __stcs(o + c, a[c] != 0.f ? w[c] : neg_inf());
  signal_done(done + 2);
}

// The streamed kernel: a co-resident grid (cooperative launch) that zeroes
// its sync words, meets once, then walks the task list, block b taking
// tasks b, b + grid, ...  Phase g holds four segments of na row tasks: C
// of scan g - 1, A of scan g, B of scan g, D of scan g - 1.  Every
// task waits only on tasks earlier in the list, and every block takes its
// tasks in order, so the earliest unfinished task can always run.
template <int N>
__global__ void __launch_bounds__(kSThreads, kStreamBlocksPerSm)
cen2019_stream_kernel(const __grid_constant__ StreamArgs p) {
  extern __shared__ __align__(16) float rows[];
  __shared__ float red[kSThreads];
  cg::grid_group grid = cg::this_grid();
  const int ntaps = N > 0 ? N : p.taps.n;
  const long long nsync = static_cast<long long>(p.nscans) * (p.na + kDoneCounts);
  for (long long i = static_cast<long long>(blockIdx.x) * kSThreads + threadIdx.x; i < nsync;
       i += static_cast<long long>(gridDim.x) * kSThreads)
    p.sync[i] = 0;
  grid.sync();

  const long long seg = p.na;
  const long long total = (p.nscans + 1LL) * kStages * seg;
  for (long long t = blockIdx.x; t < total; t += gridDim.x) {
    const int g = static_cast<int>(t / (kStages * seg));
    const int k = static_cast<int>(t / seg % kStages);   // segment: C, A, B, D
    const int r = static_cast<int>(t % seg);
    const int s = k == 0 || k == 3 ? g - 1 : g;
    if (s < 0 || s >= p.nscans) continue;
    if (k == 0) stage_c(p, s, r, red);
    else if (k == 1) stage_a<N>(p, s, r, rows, red);
    else if (k == 2) stage_b(p, s, r, red);
    else stage_d(p, s, r, rows, red, ntaps);
    // the next task refills the rows and red
    __syncthreads();
  }
}

}  // namespace

// The launch constants the Python wrapper mirrors (ops/kernels/cen_peaks.py).
extern "C" int cen2019_threads() { return kThreads; }
extern "C" long long cen2019_smem_bytes(int nbp, int ntaps) {
  return static_cast<long long>(row_smem_bytes(nbp, ntaps) + sizeof(float) * kThreads);
}

// The current device's limits, in `out`: SMs, shared memory per SM, shared
// memory the system reserves per block, the most shared memory one block
// may opt in to, and threads per SM (the resident design's co-residency).
// Returns the CUDA error (0 = cudaSuccess).
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

// Shared memory of one block of the streamed design, its sync words and its
// row statistics per scan, and its scratch slots, which the wrapper mirrors.
extern "C" long long cen2019_stream_smem_bytes(int nbp, int ntaps) {
  return static_cast<long long>(stream_smem_bytes(nbp, ntaps) + sizeof(float) * kSThreads);
}
extern "C" int cen2019_stream_threads() { return kSThreads; }
extern "C" int cen2019_stream_words_per_row() { return kStatsPerRow + 1; }
extern "C" int cen2019_stream_words_per_scan() { return kDoneCounts; }
extern "C" int cen2019_stream_ring_scans() { return kRingScans; }

namespace {

// Checks and attributes common to both designs; the blocks one SM holds in
// *per_sm.
template <typename K>
cudaError_t prepare(K kernel, int threads, size_t smem, int* sms, int* per_sm) {
  int dev = 0, coop = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (e == cudaSuccess && !coop) e = cudaErrorNotSupported;
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                             static_cast<int>(cudaSharedmemCarveoutMaxShared));
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, kernel, threads, smem);
  return e;
}

}  // namespace

// One cooperative launch of nscans scans on `stream` (K1 is nscans = 1,
// K1 x B a (nscans, na, nbp) batch).  streamed = 0 takes the resident
// design: `stats` holds 2 * na * nscans floats and `scratch` is unused.
// streamed = 1 takes the streamed design: `scratch` holds the sm and |grad|
// planes of cen2019_stream_ring_scans() scans (2 * ring * na * nbp floats)
// and `stats` nscans * na * cen2019_stream_words_per_row() +
// nscans * cen2019_stream_words_per_scan() words.  The caller allocates
// them and the output.  Returns the CUDA error (0 = cudaSuccess),
// cudaErrorCooperativeLaunchTooLarge when the card cannot hold all na
// blocks of the resident design at once, and leaves no error pending.
// There is no fallback.  Does not synchronise.
extern "C" int cen2019_scores_launch(const float* power, float* out, float* stats,
                                     float* scratch, int nscans, int streamed, int na,
                                     int nbp, int min_bin, int nb_valid, const float* taps,
                                     int ntaps, float zq, void* stream) {
  if (nscans < 1 || na < 1 || nbp < 1 || ntaps < 1 || ntaps > kMaxTaps || ntaps % 2 == 0 ||
      (streamed && scratch == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  Taps t;
  t.n = ntaps;
  for (int i = 0; i < ntaps; ++i) t.w[i] = taps[i];
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  int sms = 0, per_sm = 0;
  cudaError_t e;
  if (!streamed) {
    const auto kernel = ntaps == 13 ? cen2019_kernel<13> : cen2019_kernel<0>;
    const size_t smem = row_smem_bytes(nbp, ntaps);
    e = prepare(kernel, kThreads, smem, &sms, &per_sm);
    if (e == cudaSuccess && static_cast<long long>(per_sm) * sms < na)
      e = cudaErrorCooperativeLaunchTooLarge;
    if (e == cudaSuccess) {
      void* args[] = {&power, &out, &stats, &nscans, &na, &nbp, &min_bin, &nb_valid, &t, &zq};
      e = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(kernel), dim3(na),
                                      dim3(kThreads), args, smem, st);
    }
  } else {
    const auto kernel = ntaps == 13 ? cen2019_stream_kernel<13> : cen2019_stream_kernel<0>;
    const size_t smem = stream_smem_bytes(nbp, ntaps);
    e = prepare(kernel, kSThreads, smem, &sms, &per_sm);
    if (e == cudaSuccess && per_sm < 1) e = cudaErrorCooperativeLaunchTooLarge;
    if (e == cudaSuccess) {
      StreamArgs p;
      const size_t slots = static_cast<size_t>(kRingScans) * na * nbp;
      p.power = power;
      p.out = out;
      p.tplane = scratch;
      p.gplane = scratch + slots;
      p.stats = stats;
      p.sync = reinterpret_cast<int*>(stats + static_cast<size_t>(nscans) * kStatsPerRow * na);
      p.nscans = nscans;
      p.na = na;
      p.nbp = nbp;
      p.min_bin = min_bin;
      p.nb_valid = nb_valid;
      p.taps = t;
      p.zq = zq;
      void* args[] = {&p};
      e = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(kernel),
                                      dim3(per_sm * sms), dim3(kSThreads), args, smem, st);
    }
  }
  const cudaError_t last = cudaGetLastError();  // clears a refused call
  return static_cast<int>(e != cudaSuccess ? e : last);
}
