// Compact-table SpMV (B2) and k-wide SpMM (B3) for Hopper (sm_90a).
//
// Replaces the TPU kernels matrel_tpu/ops/pallas_spmv.py::
// _make_scatter_kernel (pallas_spmv.py:50, pallas_call at :87) and
// ::_make_scatter_kernel_k (pallas_spmv.py:334, pallas_call at :371),
// together with the XLA width-8 gather-select that feeds them
// (compact_apply, pallas_spmv.py:137-140).
//
// Function: y[r] (B3: Y[r, :]) = sum over the slots of row r of
// split(x[col] * val), where split(w) is the sum of the first `passes`
// parts of w's bf16 mantissa-mask split (ops/spmv_routed.py::
// _bf16_split): passes = 3 adds w exactly; passes = 2 adds w truncated
// to its leading 16 significant bits, as the TPU kernel's two bf16
// passes do. x itself is not split (B8 splits it). Products and parts
// are f32 (no TF32, no bf16 arithmetic); the row sums are f64 and are
// rounded to f32 once, at the write. The overflow COO is summed outside,
// with index_add_.
//
// Both kernels walk the plan's CSR view (ops/csr_view.py,
// pallas_spmv.py::csr_view_on), built once per plan on the card:
// row_ptr int32 (n_rows + 1) and one 8-byte record a real slot, {int32
// column, f32 value bits}, ordered by output row, within a row in the
// plan's slot order (the compact tables' sentinel slots dropped).
//
// B2 is the row walk of csr_walk.cuh with SPLIT_X = false (B8, in
// spmv_routed.cu, instantiates it with true): a sub-warp of
// lanes_per_row lanes a row (8 at BASELINE row 5), f64 register sums in
// view order, a shuffle reduce, each row rounded and written once. No
// atomics and no shared memory: Hopper has no shared-memory f64 add
// (atomicAdd(double) there is a compare-and-swap loop). Bound and floor
// at row 5 are B8's (csr_walk.cuh): ~0.027 ms of bytes, but x's ~10 M
// random 32-byte L2 sector reads set the floor.
//
// B3's X and Y are row-major (n_cols, k) and (n_rows, k) f32.
//
// What bounds B3 on this card. Per slot and column: a 4-byte read of X
// and ~8 f32 operations plus one f64 add, far below the card's ~300
// operations a byte, so bytes bound it. At row 5, k = 16, the minimum is
// the records (80 MB), row_ptr (4 MB), X read once and Y written once
// (64 MB each): ~0.21 GB, ~0.064 ms at 3.35 TB/s. But X is larger than
// the 50 MB L2 and each X row is gathered ~10 times (~0.64 GB of 64-byte
// gathers), so the gathers that miss L2 set the real floor.
//
// B3 design. One output row and a chunk of min(32, next_pow2(k))
// columns belong to a group of lanes (further chunks over blockIdx.y):
// 4 columns a lane with 16-byte loads when k % 4 == 0 and X is 16-byte
// aligned (4 lanes a row at k = 16), else one column a lane. Per slot
// the group reads the slot's record (one broadcast 8-byte load) and its
// part of the X row (64 B at k = 16, coalesced); UNROLL = 4 slots are in
// flight per group (8 and 16 measured slower at row 5), and `passes` is
// a template argument (a loop over it at run time measured markedly
// slower at row 5: the walk is bound by issue as much as by bytes).
// Each lane adds its columns into f64 registers in slot order and writes
// its part of the Y row once. No shared memory, no atomics; 256-thread
// CTAs over row tiles fill all 132 SMs. Empty rows write 0; a hub row is
// walked by its one group.

#include <cuda_runtime.h>
#include <stdint.h>

#include "csr_walk.cuh"

namespace {

constexpr int THREADS = 256;      // threads per CTA
constexpr int UNROLL = 4;         // B3: slots in flight per group

// B3: Y[r, c] = sum over row r's records of split(X[col, c] * val).
// A group of G lanes owns a row and W consecutive columns a lane (W = 4:
// one 16-byte load of X and one 16-byte store of Y a lane and slot; k %
// 4 == 0 and X 16-byte aligned). grid = (ceil(n_rows / (THREADS / G)),
// ceil(k / (G * W))); group t of the CTA owns row
// blockIdx.x * (THREADS / G) + t. No shuffles, so out-of-range rows and
// columns return at once.
template <int G, int W, int P>
__global__ void __launch_bounds__(THREADS)
spmm_compact_kernel(const int* __restrict__ row_ptr,
                    const int2* __restrict__ cv,
                    const float* __restrict__ X, float* __restrict__ Y,
                    long long n_rows, long long n_cols, int k) {
  const long long r =
      (long long)blockIdx.x * (THREADS / G) + threadIdx.x / G;
  const int c = (blockIdx.y * G + threadIdx.x % G) * W;
  if (r >= n_rows || c >= k) return;
  const int s0 = __ldg(row_ptr + r), s1 = __ldg(row_ptr + r + 1);
  double acc[W];
#pragma unroll
  for (int w = 0; w < W; ++w) acc[w] = 0.0;
  for (int j0 = s0; j0 < s1; j0 += UNROLL) {
    int2 rec[UNROLL];
    float xv[UNROLL][W];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u)         // records, one a group
      rec[u] = j0 + u < s1 ? __ldg(cv + j0 + u) : make_int2(-1, 0);
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {       // X rows, coalesced a group
      const bool live = rec[u].x >= 0 && rec[u].x < n_cols;
      const float* xr = X + (long long)(live ? rec[u].x : 0) * k + c;
      if constexpr (W == 4) {
        const float4 q = live ? __ldg(reinterpret_cast<const float4*>(xr))
                              : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        xv[u][0] = q.x; xv[u][1] = q.y; xv[u][2] = q.z; xv[u][3] = q.w;
      } else {
        xv[u][0] = live ? __ldg(xr) : 0.0f;
      }
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {       // in slot order
      if (j0 + u < s1) {
        const float v = __int_as_float(rec[u].y);
#pragma unroll
        for (int w = 0; w < W; ++w)
          acc[w] += (double)csr_walk::split_sum<P>(xv[u][w] * v);
      }
    }
  }
  float* yr = Y + r * k + c;
  if constexpr (W == 4) {
    *reinterpret_cast<float4*>(yr) = make_float4(
        (float)acc[0], (float)acc[1], (float)acc[2], (float)acc[3]);
  } else {
    *yr = (float)acc[0];
  }
}

template <int G, int W>
cudaError_t launch_spmm(const int* row_ptr, const int2* cv, const float* X,
                        float* Y, long long n_rows, long long n_cols, int k,
                        int passes, cudaStream_t st) {
  const long long rows_per_cta = THREADS / G;
  const dim3 grid((unsigned)((n_rows + rows_per_cta - 1) / rows_per_cta),
                  (unsigned)((k + G * W - 1) / (G * W)));
  switch (passes) {
    case 1:
      spmm_compact_kernel<G, W, 1><<<grid, THREADS, 0, st>>>(
          row_ptr, cv, X, Y, n_rows, n_cols, k);
      break;
    case 2:
      spmm_compact_kernel<G, W, 2><<<grid, THREADS, 0, st>>>(
          row_ptr, cv, X, Y, n_rows, n_cols, k);
      break;
    default:
      spmm_compact_kernel<G, W, 3><<<grid, THREADS, 0, st>>>(
          row_ptr, cv, X, Y, n_rows, n_cols, k);
  }
  return cudaGetLastError();
}

}  // namespace

// Both entries launch on `stream`, never synchronise, and return
// cudaGetLastError() (0 on success).

// B2 over the CSR view: cv must be 8-byte aligned; lanes is 1, 2, 4, 8,
// 16 or 32.
extern "C" int matrel_spmv_compact(const void* row_ptr, const void* cv,
                                   const void* x, void* y, long long n_rows,
                                   long long n_cols, int passes, int lanes,
                                   int device, void* stream) {
  return csr_walk::launch<false>(row_ptr, cv, x, y, n_rows, n_cols, passes,
                                 lanes, device, stream);
}

// B3 over the CSR view: cv must be 8-byte aligned; chunk (the columns a
// group covers) is a power of two in [1, 32]; vec = 1 takes 4 columns a
// lane, and needs k % 4 == 0 and X and Y 16-byte aligned.
extern "C" int matrel_spmm_compact(const void* row_ptr, const void* cv,
                                   const void* X, void* Y, long long n_rows,
                                   long long n_cols, int k, int chunk,
                                   int vec, int passes, int device,
                                   void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (n_rows < 0 || n_rows >= (1LL << 31) || n_cols < 0 || k <= 0 ||
      passes < 1 || passes > 3 || reinterpret_cast<uintptr_t>(cv) % 8 != 0 ||
      (vec && (k % 4 != 0 || chunk < 4 ||
               reinterpret_cast<uintptr_t>(X) % 16 != 0 ||
               reinterpret_cast<uintptr_t>(Y) % 16 != 0)))
    return (int)cudaErrorInvalidValue;
  if ((k + chunk - 1) / chunk > 65535)
    return (int)cudaErrorInvalidConfiguration;
  if (n_rows == 0) return (int)cudaSuccess;
  const int* rp = static_cast<const int*>(row_ptr);
  const int2* c = static_cast<const int2*>(cv);
  const float* Xp = static_cast<const float*>(X);
  float* Yp = static_cast<float*>(Y);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define MATREL_SPMM(G, W) \
  return (int)launch_spmm<G, W>(rp, c, Xp, Yp, n_rows, n_cols, k, passes, st)
  if (vec) {
    switch (chunk) {
      case 4: MATREL_SPMM(1, 4);
      case 8: MATREL_SPMM(2, 4);
      case 16: MATREL_SPMM(4, 4);
      case 32: MATREL_SPMM(8, 4);
    }
  } else {
    switch (chunk) {
      case 1: MATREL_SPMM(1, 1);
      case 2: MATREL_SPMM(2, 1);
      case 4: MATREL_SPMM(4, 1);
      case 8: MATREL_SPMM(8, 1);
      case 16: MATREL_SPMM(16, 1);
      case 32: MATREL_SPMM(32, 1);
    }
  }
#undef MATREL_SPMM
  return (int)cudaErrorInvalidValue;
}
