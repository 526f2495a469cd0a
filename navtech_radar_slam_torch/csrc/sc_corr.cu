// ScanContext distance of one query against every bank row at every
// circular column shift, for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel
//   navtech_radar_slam_tpu/ops/pallas/sc_corr.py::sc_shift_distances_pallas
// and computes what its wrapper and body compute together, for a (R, S)
// query and a (N, R, S) bank (20 x 60 and N = 4096 at full width):
//
//   qn, bn  = descriptors with each column divided by max(|column|, 1e-9)
//   qnz, bnz = column |column| > 1e-9
//   C[n, z]     = sum_{r, c} qn[r, (z + c) mod S] * bn[n, r, c]
//   count[n, z] = sum_c qnz[(z + c) mod S] * bnz[n, c]
//   out[n, z]   = count > 0.5 ? 1 - C / max(count, 1) : 1
//
// The column normalisation, done in XLA around the TPU kernel, is done
// here in the kernel, so the bank is read once.
//
// What bounds it on the card: neither, at this size.  A call reads the
// 19.7 MB bank once (about 6 us at 3.35 TB/s) and does 2 x 4096 x 60 x
// 1200 = 0.59 GFLOP of fp32 (about 9 us at 67 TFLOP/s), so launch and
// wrapper time dominate.  The TPU kernel materialises the query rolled to
// all 60 shifts, (1200 x 60) floats = 288 KB, as a matrix for the MXU; that
// is more than a Hopper block's 227 KB of shared memory.  Here the roll is
// never materialised: the normalised query (4.8 KB) sits in shared memory
// and each thread reads column (z + c) mod S on the fly.  One block scores
// kRows bank rows; within a row, one thread per shift accumulates the 1200
// products and the column count in fp32 registers.  Neighbouring threads
// read neighbouring query columns (no bank conflicts) and the same bank
// element (a broadcast).  Sums are taken in a fixed order, so two runs give
// the same matrix.  Tensor cores (wgmma on the (N x 1200) x (1200 x 60)
// product) and restricting the work to the live bank prefix are later work.

#include <cuda_runtime.h>

namespace {

constexpr int kMaxSectors = 64;   // threads per bank row: one per shift
constexpr int kMaxCells = 2048;   // R * S held in shared memory per row
constexpr int kRows = 4;          // bank rows per block
constexpr int kThreads = kMaxSectors * kRows;

__global__ void __launch_bounds__(kThreads)
sc_corr_kernel(const float* __restrict__ query, const float* __restrict__ bank,
               float* __restrict__ out, int n, int nr, int ns) {
  __shared__ float q[kMaxCells];
  __shared__ float b[kRows][kMaxCells];
  __shared__ float qnorm[kMaxSectors];
  __shared__ float bnorm[kRows][kMaxSectors];

  const int cells = nr * ns;
  const int tid = threadIdx.x;
  const int row = tid / kMaxSectors;   // bank row within the block
  const int z = tid % kMaxSectors;     // shift (and column, for the norms)
  const int row0 = blockIdx.x * kRows;
  const int rows_here = min(kRows, n - row0);

  // the query and this block's bank rows (contiguous), into shared memory
  for (int i = tid; i < cells; i += kThreads) q[i] = query[i];
  const float* src = bank + static_cast<size_t>(row0) * cells;
  for (int i = tid; i < rows_here * cells; i += kThreads) {
    b[i / cells][i % cells] = src[i];
  }
  __syncthreads();

  // column norms: thread (row, z) takes column z of its bank row; the
  // threads of row 0 also take column z of the query
  if (z < ns) {
    if (row < rows_here) {
      float s = 0.f;
      for (int r = 0; r < nr; ++r) {
        const float v = b[row][r * ns + z];
        s = __fadd_rn(s, __fmul_rn(v, v));
      }
      bnorm[row][z] = sqrtf(s);
    }
    if (row == 0) {
      float s = 0.f;
      for (int r = 0; r < nr; ++r) {
        const float v = q[r * ns + z];
        s = __fadd_rn(s, __fmul_rn(v, v));
      }
      qnorm[z] = sqrtf(s);
    }
  }
  __syncthreads();

  // normalise in place: d / max(norm, 1e-9)
  for (int i = tid; i < cells; i += kThreads) {
    q[i] = __fdiv_rn(q[i], fmaxf(qnorm[i % ns], 1e-9f));
  }
  for (int i = tid; i < rows_here * cells; i += kThreads) {
    const int rr = i / cells, c = (i % cells) % ns;
    b[rr][i % cells] = __fdiv_rn(b[rr][i % cells], fmaxf(bnorm[rr][c], 1e-9f));
  }
  __syncthreads();

  if (row >= rows_here || z >= ns) return;
  float acc = 0.f;
  float count = 0.f;
  int qc = z;                                   // (z + c) mod S
  for (int c = 0; c < ns; ++c) {
    if (qnorm[qc] > 1e-9f && bnorm[row][c] > 1e-9f) count += 1.f;
    for (int r = 0; r < nr; ++r) {
      acc = fmaf(q[r * ns + qc], b[row][r * ns + c], acc);
    }
    qc = (qc + 1 == ns) ? 0 : qc + 1;
  }
  out[static_cast<size_t>(row0 + row) * ns + z] =
      count > 0.5f ? 1.f - acc / fmaxf(count, 1.f) : 1.f;
}

}  // namespace

extern "C" int sc_corr_max_sectors() { return kMaxSectors; }
extern "C" int sc_corr_max_cells() { return kMaxCells; }

// query (R, S), bank (N, R, S), out (N, S): contiguous float32 on the device.
extern "C" int sc_corr_launch(const float* query, const float* bank, float* out,
                              int n, int nr, int ns, void* stream) {
  if (n <= 0) return 0;
  const int blocks = (n + kRows - 1) / kRows;
  sc_corr_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      query, bank, out, n, nr, ns);
  return static_cast<int>(cudaGetLastError());
}
