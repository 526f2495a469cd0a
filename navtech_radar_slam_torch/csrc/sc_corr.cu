// ScanContext distance of one query against every bank row at every
// circular column shift, for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel
//   navtech_radar_slam_tpu/ops/pallas/sc_corr.py::sc_shift_distances_pallas
// and computes what its wrapper and body compute together, for a (R, S)
// query and a (N, R, S) bank (20 x 60 in every shipped config):
//
//   qn, bn   = descriptors with each column divided by max(|column|, 1e-9)
//   qnz, bnz = column |column| > 1e-9
//   C[n, z]     = sum_{r, c} qn[r, (z + c) mod S] * bn[n, r, c]
//   count[n, z] = sum_c qnz[(z + c) mod S] * bnz[n, c]
//   out[n, z]   = count > 0.5 ? 1 - C / max(count, 1) : 1
//
// The column normalisation, done in XLA around the TPU kernel, is done here
// in the kernel, so the bank is read once.
//
// What bounds it on the card: at 4096 rows the call reads the 19.7 MB bank
// once (6.2 us at 3.35 TB/s with the output) and does 2 x 4096 x 60 x 1200
// = 0.59 GFLOP of fp32 (9.0 us at 67 TFLOP/s with the norms): the fp32
// units.  The contraction stays true fp32 in a fixed order on the CUDA
// cores; TF32 tensor cores would not hold the 2e-5 tolerance.
//
// The first Hopper design (one thread per (row, shift), four rows a block)
// ran at 7 % of that bound.  What held it back, and what this design does:
//
//   1. Two shared-memory loads per FMA (the rolled query value and the
//      bank value) plus index arithmetic: the load unit set the pace.  An
//      SM's shared memory returns 32 floats a clock (a 16-byte load costs
//      4 wavefronts even when every lane reads one address) against 128
//      FMA lanes, so each loaded float must feed 4 FMAs or more.  Here a
//      thread holds one bank row x kShifts = 12 shifts in registers.  The
//      normalised query sits in shared memory doubled to (R, W) columns, so
//      the roll needs no mod, and the thread's window for columns c .. c + 3
//      is the 16 query values at z0 + c .. z0 + c + 15, of which only the
//      last 4 are loaded for each step (one 16-byte load), the rest carried
//      in registers; the 4 bank values are one 16-byte load.  The next
//      step's query load is issued before this step's 48 FMAs: 6 FMAs per
//      loaded float (0.5 before).
//   2. 64 threads per row for 60 shifts.  The shifts now come in 12-wide
//      groups: 5 for S = 60, none idle.
//   3. A prologue of 4-byte copies, a run-time division per element and a
//      division per bank value.  Rows are copied with 16-byte cp.async
//      (scalar copies only for an S that is not a multiple of 4 or a
//      misaligned bank) while the query's norms are taken; the column norms
//      and the in-place scaling take 4 columns at a time in 16-byte loads,
//      one reciprocal per column, and no index is divided per element.
//   4. The column count was a 60-step loop for every (row, shift).  The
//      non-zero columns are 64-bit masks (S <= 64), packed from one flag
//      byte per column, and count[n, z] = popc(bmask[n] & rot_S(qmask, z)),
//      exact.  (A shared 64-bit atomicOr per column serialised the lanes.)
//
// Outside the contraction a block's work is short chains of dependent
// loads, run once: at 4 warps an SM every such phase was latency-bound, so
// the R rings are split over kSplits thread groups (more warps, shorter
// chains), whose partial sums are added in group order; and code that runs
// once per block is kept in rolled loops, since there instruction fetches
// cost more than the work.  Two instantiations of one template, chosen per
// launch by the host (ops/kernels/sc_corr.py::launch_geometry):
//   * split (variant 0): 2 rows a block, the rings split 20 ways, 200
//     threads.  For the few rows the SLAM path searches (1 to 30 on the
//     60-scan run): N / 2 blocks spread over the SMs;
//   * tile (variant 1): 16 rows a block, the rings split 4 ways, 320
//     threads, 106 KB of shared memory: two blocks an SM, so 4096 rows are
//     one wave of 256 blocks.
// Every sum is taken in a fixed order, so two runs give the same matrix.
// ptxas (-Xptxas -v, which chip_smoke.py prints): 56 registers for each of
// the two instantiations (55 and 56 before the slot offsets), no spills,
// no stack; the bound of three blocks an SM keeps the tile variant there
// (it took 64, and 0.6 % longer at 4096 rows, once the phases below became
// functions the shared-bank kernel also calls).
//
// Measured on an H100 (chip_smoke.py, PERF.md): 4096 rows take about 26 us,
// a third of the way to the bound, the contraction sharing the time with
// the staging, the normalisation and the launch.  30 rows take about 9 us,
// set by the chain of dependent phases of one block.
//
// K2-T, T query slots in one launch (sc_corr_multi_launch), replaces the
// jax.vmap of the same TPU kernel over the streaming segment's T keyframes
// (navtech_radar_slam_tpu/models/slam.py, _make_kf_segment: vmap of
// detect_one): (T, R, S) queries against one (N, R, S) bank, or against
// per-slot (T, N, R, S) banks (ring-key mode's gathered candidates), given
// by a bank slot stride of 0 or N * R * S floats, into (T, N, S).  At the
// main path's shapes, T = 16 queries on the 30-row searchable prefix, it
// reads 77 KB of queries and 144 KB of bank and writes 115 KB (0.10 us at
// 3.35 TB/s) and does 2 x 16 x 30 x 60 x 1200 = 69 Mop of fp32 (1.04 us at
// 67 TFLOP/s): the fp32 units bound it, as K2's.  What the design does: the
// slots are grid axis y of the same template, every block offsetting its
// query, bank and output by its slot and then running K2's block as it is,
// so slot t's result is K2's for (query t, bank t) bit for bit and T = 1 is
// K2.  At 16 x 30 rows that is 15 x 16 = 240 split blocks, under two per
// SM in one wave, so the launch should cost about one K2 block's chain of
// phases, ~9 us, for all 16 queries.  Each block still stages its bank rows
// and normalises them for its own slot: the T blocks of one row block read
// the same rows (from L2 after the first).  ptxas: as above, the one kernel
// serves both.  Measured (chip_smoke.py, PERF.md): about 10.7 us at 16 x 30
// rows, a K2 launch's time for all 16 queries.
//
// K2-T with one shared bank of 2048 rows or more (the tile variant) stages
// and normalises each row block once for a group of query slots
// (sc_corr_shared_kernel): grid axis y holds the query groups, and a block
// runs its slots in turn against the rows it holds, each with K2's thread
// layout, register tile and order of sums (normalise the query, contract,
// add the splits' partials, count), so slot t's output is K2's for query t,
// bit for bit; the split variant's N (under 2048) fixes K2's order too, so
// the host keeps the variant K2 would take for N.  The host picks the slots
// a block (ops/kernels/sc_corr.py::multi_geometry): as many as keep 256
// blocks in the launch, two a tile SM, i.e. 8 at 2048 rows and 16 at 4096
// and 8192; one (the kernel above) for per-slot banks and under 2048 rows,
// where a split block stages only 2 rows and a longer chain of queries
// costs more than the staging it saves.  Measured on an H100 (PERF.md),
// 16 queries, device ms with 1 / 2 / 4 / 8 / 16 slots a block, this
// source's build: 30 rows 0.0106 / 0.0137 / 0.0233 / 0.0430 / 0.0819; 400
// rows 0.0645 / 0.0696 / 0.0685 / 0.0735 / 0.0969; 2048 rows 0.1822 /
// 0.1607 / 0.1498 / 0.1442 / 0.1889; 4096 rows 0.3591 / 0.3163 / 0.2961 /
// 0.2863 / 0.2800 (bound 0.141 ms by operations: share 0.50); 8192 rows
// 0.7109 / 0.6218 / 0.5880 / 0.5721 / 0.5621.  What is left: each slot
// still pays the query's normalisation and the block's barriers and
// distance phase in turn (how the time splits is not measured).  ptxas:
// the shared kernel 72 registers, no spills, no stack.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kMaxSectors = 64;   // S <= 64: one bit per column in a u64 mask
constexpr int kMaxCells = 2048;   // R * round_up(S, 4)
constexpr int kShifts = 12;       // shifts per thread
constexpr int kWin = kShifts / 4 + 1;   // float4s in a thread's query window
constexpr int kSlots = kWin + 1;        // ... plus one being loaded
constexpr int kRowPad = 4;        // floats after each staged bank row
constexpr int kQuadLoads = 8;     // query rings a lane loads at once
constexpr int kSplitRows = 2;     // bank rows a block, split variant
constexpr int kTileRows = 16;     // bank rows a block, tile variant
constexpr int kMaxThreads = 384;  // 6 shift groups (S = 64) x 16 rows x 4 splits
constexpr int kMaxSlots = 65535;  // query slots: gridDim.y

// Dynamic shared memory of one block, offsets in floats, each 16-byte aligned:
// bank rows (rows x stride), doubled query (R x W), partial sums (splits x
// rows x zpad), one byte per column (64 a row) that says it is non-zero,
// then the same as a 64-bit mask: the query's, then each bank row's.
struct Layout {
  int sp, zpad, w, stride, qd, part, flags, masks, bytes;
};

__host__ __device__ inline Layout layout(int rows, int splits, int nr, int ns) {
  Layout l;
  l.sp = (ns + 3) & ~3;
  l.zpad = (ns + kShifts - 1) / kShifts * kShifts;
  l.w = l.zpad + l.sp + 4;   // the last window reads column zpad + sp + 3
  l.stride = nr * l.sp + kRowPad;
  l.qd = rows * l.stride;
  l.part = l.qd + nr * l.w;
  l.flags = l.part + splits * rows * l.zpad;
  l.masks = l.flags + (rows + 1) * kMaxSectors / 4;
  l.bytes = l.masks * 4 + (rows + 1) * 8;
  return l;
}

// 64 column flags (bytes 0 / 1) -> a 64-bit mask, bit c = column c
__device__ __forceinline__ unsigned long long pack_flags(const unsigned char* f) {
  const unsigned* w = reinterpret_cast<const unsigned*>(f);
  unsigned long long m = 0ull;
#pragma unroll 1
  for (int j = 0; j < kMaxSectors / 4; ++j) {
    const unsigned x = w[j];
    const unsigned nib = (x & 1u) | ((x >> 7) & 2u) | ((x >> 14) & 4u) | ((x >> 21) & 8u);
    m |= static_cast<unsigned long long>(nib) << (4 * j);
  }
  return m;
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// sums of squares of 4 neighbouring columns (p 16-byte aligned) over n rows
// step floats apart, in row order, loading 8 rows at a time so that their
// latencies overlap
__device__ __forceinline__ float4 sum_sq4(const float* p, int step, int n) {
  float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int r0 = 0; r0 < n; r0 += 8) {
    float4 v[8];
#pragma unroll
    for (int u = 0; u < 8; ++u)
      v[u] = r0 + u < n ? ld4(p + (r0 + u) * step) : make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      s.x = fmaf(v[u].x, v[u].x, s.x);
      s.y = fmaf(v[u].y, v[u].y, s.y);
      s.z = fmaf(v[u].z, v[u].z, s.z);
      s.w = fmaf(v[u].w, v[u].w, s.w);
    }
  }
  return s;
}

__device__ __forceinline__ float recip_norm(float norm) { return 1.f / fmaxf(norm, 1e-9f); }

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
}

// 1. kRows bank rows from row0 into shared memory (rows past N as zeros);
//    with S % 4 == 0, Sp == S and a staged row is the row as it lies
template <int kRows>
__device__ __forceinline__ void stage_rows(const float* __restrict__ bank, float* bs, int row0,
                                           int rows_here, int nr, int ns, int sp, int stride,
                                           bool vec, int tid, int nthreads) {
  const int cells = nr * ns;
  if (vec) {
    for (int i = 0; i < kRows; ++i) {
      float* dst = bs + i * stride;
      if (i < rows_here) {
        const float* src = bank + static_cast<size_t>(row0 + i) * cells;
        for (int j = 4 * tid; j < cells; j += 4 * nthreads) cp_async16(dst + j, src + j);
      } else {
        for (int j = 4 * tid; j < cells; j += 4 * nthreads)
          *reinterpret_cast<float4*>(dst + j) = make_float4(0.f, 0.f, 0.f, 0.f);
      }
    }
  } else {
    for (int i = 0; i < kRows; ++i) {
      const float* src = bank + static_cast<size_t>(row0 + i) * cells;
      for (int r = 0; r < nr; ++r)
        for (int c = tid; c < sp; c += nthreads)
          bs[i * stride + r * sp + c] = (i < rows_here && c < ns) ? src[r * ns + c] : 0.f;
    }
  }
}

// 2. the doubled normalised query qd[r][j] = qn[r][j mod S], j < W, and its
//    flags, a quad of lanes to a column: lane h reads rings h, h + 4, ...
//    into registers and sums their squares, two xor shuffles add the quad's
//    4 sums in a fixed order (each lane gets the same total), and each lane
//    writes its own rings (nthreads % 4 == 0, so a quad is always whole)
__device__ __forceinline__ void normalize_query(const float* __restrict__ query, float* qd,
                                                unsigned char* qflag, int nr, int ns, int w,
                                                int tid, int nthreads) {
  const int h = tid & 3;
  const unsigned quad = 0xfu << (tid & 28);
  for (int c = ns + tid; c < kMaxSectors; c += nthreads) qflag[c] = 0;
  for (int p = tid; p < 4 * w; p += nthreads) {
    const int j = p >> 2;
    int c = j;
    while (c >= ns) c -= ns;
    float s = 0.f;
    for (int r0 = h; r0 < nr; r0 += 4 * kQuadLoads) {
      float v[kQuadLoads];   // loaded together, so their latencies overlap
#pragma unroll
      for (int u = 0; u < kQuadLoads; ++u)
        v[u] = r0 + 4 * u < nr ? query[(r0 + 4 * u) * ns + c] : 0.f;
#pragma unroll
      for (int u = 0; u < kQuadLoads; ++u) s = fmaf(v[u], v[u], s);
    }
    s += __shfl_xor_sync(quad, s, 1);
    s += __shfl_xor_sync(quad, s, 2);
    const float norm = sqrtf(s);
    const float inv = recip_norm(norm);
    for (int r = h; r < nr; r += 4) qd[r * w + j] = query[r * ns + c] * inv;
    if (h == 0 && j < ns) qflag[j] = norm > 1e-9f;
  }
}

// 3. the bank rows normalised in place, one thread per (row, 4 columns),
//    and their flag bytes
template <int kRows>
__device__ __forceinline__ void normalize_rows(float* bs, unsigned char* bflag, int rows_here,
                                               int nr, int sp, int stride, int tid,
                                               int nthreads) {
  constexpr int kGroups = kMaxSectors / 4;
  for (int p = tid; p < kRows * kGroups; p += nthreads) {
    const int i = p / kGroups, c = 4 * (p % kGroups);   // powers of two
    float4 nrm = make_float4(0.f, 0.f, 0.f, 0.f);
    if (c < sp && i < rows_here) {
      float* col = bs + i * stride + c;
      const float4 s = sum_sq4(col, sp, nr);
      nrm = make_float4(sqrtf(s.x), sqrtf(s.y), sqrtf(s.z), sqrtf(s.w));
      const float4 inv = make_float4(recip_norm(nrm.x), recip_norm(nrm.y), recip_norm(nrm.z),
                                     recip_norm(nrm.w));
#pragma unroll 4
      for (int r = 0; r < nr; ++r) {
        float4 v = ld4(col + r * sp);
        v.x *= inv.x;
        v.y *= inv.y;
        v.z *= inv.z;
        v.w *= inv.w;
        *reinterpret_cast<float4*>(col + r * sp) = v;
      }
    }
    // the flag bytes i * 64 + c .. c + 3, zero for padded columns and rows
    reinterpret_cast<unsigned*>(bflag)[p] =
        (nrm.x > 1e-9f ? 1u : 0u) | (nrm.y > 1e-9f ? 1u << 8 : 0u) |
        (nrm.z > 1e-9f ? 1u << 16 : 0u) | (nrm.w > 1e-9f ? 1u << 24 : 0u);
  }
}

// 4. the register tile: bank row i, shifts z0 .. z0 + 11, rings r = split,
//    split + kSplits, ...; each step loads the query float4 that the next
//    step needs before its own FMAs (the last such load reads qd's column
//    zpad + sp + 3 at most, inside the row).  5. every group's partial sums
//    into shared memory.
template <int kRows, int kSplits>
__device__ __forceinline__ void contract(const float* qd, const float* bs, float* part, int i,
                                         int split, int z0, int nr, int sp, int w, int stride,
                                         int zpad) {
  float acc[kShifts];
#pragma unroll
  for (int k = 0; k < kShifts; ++k) acc[k] = 0.f;

  for (int r = split; r < nr; r += kSplits) {
    const float* q = qd + r * w + z0;
    const float* b = bs + i * stride + r * sp;
    // a ring of kSlots float4s: at step t (columns 4t .. 4t + 3), slot
    // (t + u) % kSlots holds query columns z0 + 4t + 4u .. + 3, u < kWin,
    // and the free slot takes the next step's newest float4.  The steps
    // are unrolled kSlots at a time, so every slot index is a constant and
    // the window moves without register copies.
    float4 win[kSlots];
#pragma unroll
    for (int u = 0; u < kWin; ++u) win[u] = ld4(q + 4 * u);
    for (int c0 = 0; c0 < sp; c0 += 4 * kSlots) {
#pragma unroll
      for (int s = 0; s < kSlots; ++s) {
        const int c = c0 + 4 * s;
        if (c >= sp) break;
        win[(s + kWin) % kSlots] = ld4(q + c + 4 * kWin);
        const float4 bv = ld4(b + c);
        const float bb[4] = {bv.x, bv.y, bv.z, bv.w};
        float wv[4 * kWin];
#pragma unroll
        for (int u = 0; u < kWin; ++u) {
          const float4 x = win[(s + u) % kSlots];
          wv[4 * u] = x.x;
          wv[4 * u + 1] = x.y;
          wv[4 * u + 2] = x.z;
          wv[4 * u + 3] = x.w;
        }
#pragma unroll
        for (int m = 0; m < 4; ++m)
#pragma unroll
          for (int k = 0; k < kShifts; ++k) acc[k] = fmaf(wv[k + m], bb[m], acc[k]);
      }
    }
  }
#pragma unroll
  for (int k = 0; k < kShifts; ++k) part[(split * kRows + i) * zpad + z0 + k] = acc[k];
}

// 6. the distances: thread (split, i, zg) finishes shifts z0 + k for
//    k = split, split + kSplits, ..., adding the groups' partial sums in
//    group order and counting by popcount.  The loops stay rolled: code
//    that runs once per block costs more in instruction fetches than in
//    work.
template <int kRows, int kSplits>
__device__ __forceinline__ void distances(const float* part, unsigned long long qm,
                                          unsigned long long bm, float* o, int i, int split,
                                          int z0, int ns, int zpad) {
  const unsigned long long full = ns == 64 ? ~0ull : (1ull << ns) - 1ull;
#pragma unroll 1
  for (int k = split; k < kShifts; k += kSplits) {
    const int z = z0 + k;
    if (z >= ns) break;
    float v = 0.f;
#pragma unroll 4
    for (int s = 0; s < kSplits; ++s) v += part[(s * kRows + i) * zpad + z];
    const unsigned long long rot = z == 0 ? qm : ((qm >> z) | (qm << (ns - z))) & full;
    const float cnt = static_cast<float>(__popcll(bm & rot));
    o[z] = cnt > 0.5f ? 1.f - v / fmaxf(cnt, 1.f) : 1.f;
  }
}

// One query slot a block (K2, and K2-T with per-slot banks): slot blockIdx.y
// offsets its query, bank (the shared one at a stride of 0) and output
// block; slot 0 reads and writes what a single query does.
template <int kRows, int kSplits>
__global__ void __launch_bounds__(kMaxThreads, 3)
sc_corr_kernel(const float* __restrict__ query, const float* __restrict__ bank,
               float* __restrict__ out, int n, int nr, int ns, size_t bank_slot_stride,
               bool vec) {
  static_assert(kRows * kSplits % 4 == 0, "step 2 needs whole quads of lanes");
  extern __shared__ __align__(16) float smem[];
  const Layout L = layout(kRows, kSplits, nr, ns);
  const int sp = L.sp, zpad = L.zpad, w = L.w, stride = L.stride;
  float* bs = smem;
  float* qd = smem + L.qd;
  float* part = smem + L.part;
  unsigned char* qflag = reinterpret_cast<unsigned char*>(smem + L.flags);
  unsigned char* bflag = qflag + kMaxSectors;   // row i at bflag + i * 64
  unsigned long long* masks = reinterpret_cast<unsigned long long*>(smem + L.masks);

  const size_t slot = blockIdx.y;
  query += slot * nr * ns;
  bank += slot * bank_slot_stride;
  out += slot * n * ns;

  const int nthreads = blockDim.x;   // (zpad / 12) * kRows * kSplits
  const int tid = threadIdx.x;
  const int row0 = blockIdx.x * kRows;
  const int rows_here = min(kRows, n - row0);

  stage_rows<kRows>(bank, bs, row0, rows_here, nr, ns, sp, stride, vec, tid, nthreads);
  // while the copies fly, the query
  normalize_query(query, qd, qflag, nr, ns, w, tid, nthreads);
  cp_async_wait_all();
  __syncthreads();
  normalize_rows<kRows>(bs, bflag, rows_here, nr, sp, stride, tid, nthreads);
  __syncthreads();
  // the query's and each row's 64-bit column mask, read after step 5's barrier
  for (int t = tid; t <= kRows; t += nthreads) masks[t] = pack_flags(qflag + t * kMaxSectors);

  const int nzg = zpad / kShifts;
  const int zg = tid % nzg;          // one division per thread
  const int grp = tid / nzg;
  const int i = grp % kRows;
  const int split = grp / kRows;
  const int z0 = zg * kShifts;
  contract<kRows, kSplits>(qd, bs, part, i, split, z0, nr, sp, w, stride, zpad);
  __syncthreads();
  if (i >= rows_here) return;
  distances<kRows, kSplits>(part, masks[0], masks[1 + i],
                            out + static_cast<size_t>(row0 + i) * ns, i, split, z0, ns, zpad);
}

// K2-T with one shared bank: a block stages and normalises its kRows bank
// rows once and runs the query slots blockIdx.y * qgroup .. + qgroup - 1
// against them in turn, each with K2's block (the same thread layout,
// register tile and order of sums), so slot t's output is K2's for query t.
template <int kRows, int kSplits>
__global__ void __launch_bounds__(kMaxThreads, 2)
sc_corr_shared_kernel(const float* __restrict__ queries, const float* __restrict__ bank,
                      float* __restrict__ out, int slots, int qgroup, int n, int nr, int ns,
                      bool vec) {
  static_assert(kRows * kSplits % 4 == 0, "step 2 needs whole quads of lanes");
  extern __shared__ __align__(16) float smem[];
  const Layout L = layout(kRows, kSplits, nr, ns);
  const int sp = L.sp, zpad = L.zpad, w = L.w, stride = L.stride;
  float* bs = smem;
  float* qd = smem + L.qd;
  float* part = smem + L.part;
  unsigned char* qflag = reinterpret_cast<unsigned char*>(smem + L.flags);
  unsigned char* bflag = qflag + kMaxSectors;
  unsigned long long* masks = reinterpret_cast<unsigned long long*>(smem + L.masks);

  const int nthreads = blockDim.x;
  const int tid = threadIdx.x;
  const int row0 = blockIdx.x * kRows;
  const int rows_here = min(kRows, n - row0);
  const int q0 = blockIdx.y * qgroup;
  const int q1 = min(q0 + qgroup, slots);

  stage_rows<kRows>(bank, bs, row0, rows_here, nr, ns, sp, stride, vec, tid, nthreads);
  normalize_query(queries + static_cast<size_t>(q0) * nr * ns, qd, qflag, nr, ns, w, tid,
                  nthreads);
  cp_async_wait_all();
  __syncthreads();
  normalize_rows<kRows>(bs, bflag, rows_here, nr, sp, stride, tid, nthreads);
  __syncthreads();
  for (int t = tid; t <= kRows; t += nthreads) masks[t] = pack_flags(qflag + t * kMaxSectors);

  const int nzg = zpad / kShifts;
  const int zg = tid % nzg;
  const int grp = tid / nzg;
  const int i = grp % kRows;
  const int split = grp / kRows;
  const int z0 = zg * kShifts;
  for (int q = q0; q < q1; ++q) {
    if (q > q0) {
      // the previous slot is done with qd, qflag, part and the query mask
      __syncthreads();
      normalize_query(queries + static_cast<size_t>(q) * nr * ns, qd, qflag, nr, ns, w, tid,
                      nthreads);
      __syncthreads();
      if (tid == 0) masks[0] = pack_flags(qflag);
    }
    contract<kRows, kSplits>(qd, bs, part, i, split, z0, nr, sp, w, stride, zpad);
    __syncthreads();
    if (i < rows_here)
      distances<kRows, kSplits>(part, masks[0], masks[1 + i],
                                out + (static_cast<size_t>(q) * n + row0 + i) * ns, i, split,
                                z0, ns, zpad);
  }
}

template <int kRows, int kSplits>
int launch(const float* query, const float* bank, float* out, int slots, int qgroup, int n,
           int nr, int ns, size_t bank_slot_stride, cudaStream_t stream) {
  constexpr int kDevices = 64;
  // the opt-in already set, per device, for each of the two kernels
  static int attr_bytes[2][kDevices] = {};
  const Layout L = layout(kRows, kSplits, nr, ns);
  const bool shared = qgroup > 1;
  const void* kernel = shared ? reinterpret_cast<const void*>(sc_corr_shared_kernel<kRows, kSplits>)
                              : reinterpret_cast<const void*>(sc_corr_kernel<kRows, kSplits>);
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (dev >= kDevices) return static_cast<int>(cudaErrorInvalidDevice);
  if (L.bytes > attr_bytes[shared][dev]) {
    // the opt-in above 48 KB, and all of the SM's shared memory as such, so
    // that two tile blocks fit on an SM
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L.bytes);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
    if (e != cudaSuccess) return static_cast<int>(e);
    attr_bytes[shared][dev] = L.bytes;
  }
  const bool vec = ns % 4 == 0 && reinterpret_cast<uintptr_t>(bank) % 16 == 0 &&
                   bank_slot_stride % 4 == 0;
  const int threads = (L.zpad / kShifts) * kRows * kSplits;
  const int rows = (n + kRows - 1) / kRows;
  if (shared)
    sc_corr_shared_kernel<kRows, kSplits><<<dim3(rows, (slots + qgroup - 1) / qgroup), threads,
                                            L.bytes, stream>>>(query, bank, out, slots, qgroup,
                                                               n, nr, ns, vec);
  else
    sc_corr_kernel<kRows, kSplits><<<dim3(rows, slots), threads, L.bytes, stream>>>(
        query, bank, out, n, nr, ns, bank_slot_stride, vec);
  return static_cast<int>(cudaGetLastError());
}

int launch_variant(const float* query, const float* bank, float* out, int slots, int n,
                   int nr, int ns, long long bank_slot_stride, int variant, int qgroup,
                   void* stream) {
  if (n <= 0 || slots <= 0) return 0;
  if (nr < 1 || ns < 1 || ns > kMaxSectors || nr * ((ns + 3) & ~3) > kMaxCells ||
      slots > kMaxSlots || bank_slot_stride < 0 || qgroup < 1 ||
      (qgroup > 1 && bank_slot_stride != 0))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t stride = static_cast<size_t>(bank_slot_stride);
  if (variant == 0)
    return launch<kSplitRows, 20>(query, bank, out, slots, qgroup, n, nr, ns, stride, st);
  if (variant == 1)
    return launch<kTileRows, 4>(query, bank, out, slots, qgroup, n, nr, ns, stride, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// Limits and tile heights the Python wrapper mirrors (ops/kernels/sc_corr.py).
extern "C" int sc_corr_max_sectors() { return kMaxSectors; }
extern "C" int sc_corr_max_cells() { return kMaxCells; }
extern "C" int sc_corr_max_slots() { return kMaxSlots; }
extern "C" int sc_corr_block_rows(int variant) {
  return variant == 0 ? kSplitRows : variant == 1 ? kTileRows : 0;
}

// query (R, S), bank (N, R, S), out (N, S): contiguous float32 on the device.
// variant 0 is the split tile, 1 the register tile.
// Returns the CUDA error (0 = cudaSuccess) and leaves no error pending.
extern "C" int sc_corr_launch(const float* query, const float* bank, float* out, int n,
                              int nr, int ns, int variant, void* stream) {
  return launch_variant(query, bank, out, 1, n, nr, ns, 0, variant, 1, stream);
}

// The T-slot form: queries (T, R, S), out (T, N, S), and the bank of slot t
// at bank + t * bank_slot_stride floats: a stride of 0 shares one (N, R, S)
// bank, N * R * S gives every slot its own ((T, N, R, S)).  One launch.
// qgroup = 1: the slots on grid axis y, each block one slot; qgroup > 1
// (a shared bank only): each block runs qgroup slots against the rows it
// staged, the query groups on grid axis y.  Either way slot t's output is
// what sc_corr_launch gives for query t and bank t, bit for bit.
extern "C" int sc_corr_multi_launch(const float* queries, const float* bank, float* out,
                                    int slots, int n, int nr, int ns,
                                    long long bank_slot_stride, int variant, int qgroup,
                                    void* stream) {
  return launch_variant(queries, bank, out, slots, n, nr, ns, bank_slot_stride, variant,
                        qgroup, stream);
}
