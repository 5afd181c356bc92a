// The row walk over a plan's CSR view, shared by the compact SpMV (B2,
// spmv_compact.cu) and the routed SpMV (B8, spmv_routed.cu).
//
// Function: y[r] = sum over the slots of row r of split(x'[col] * val),
// with x' = split(x) when SPLIT_X (B8) and x' = x otherwise (B2), where
// split(v) is the sum of the first P parts of v's bf16 mantissa-mask
// split (ops/spmv_routed.py::_bf16_split): P = 3 adds exactly; P = 2
// keeps each side's leading 16 significant bits, as the TPU kernels' two
// bf16 passes do. Products and parts are f32 (no TF32), each row's sum
// f64, rounded to f32 once.
//
// Input: the view (ops/csr_view.py), built once per plan on the card:
// row_ptr int32 (n_rows + 1) and one 8-byte record a real slot, {int32
// column, f32 value bits}, ordered by output row. It holds only the
// slots the function adds (padding and sentinels dropped), every column
// below n_cols.
//
// What bounds it on this card. Per slot: one 8-byte record, one 4-byte
// gather of x, ~6 * P + 2 f32 operations and one f64 add, far below the
// card's ~300 operations a byte, so bytes bound it. At BASELINE row 5
// (1,000,000 rows, ~10 M real slots, ~10 a row) one matvec must read
// 80 MB of records + 4 MB of row_ptr + x and write y (4 MB each): ~92 MB,
// about 0.027 ms at 3.35 TB/s. x (4 MB) stays in the 50 MB L2, but its
// ~10 M random reads cost one 32-byte L2 sector each (~0.32 GB), and on
// the H100 that sets the floor, not HBM: every schedule tried at row 5
// (1 to 16 lanes a row, 4 or 8 records in flight, the CTA's records
// staged in shared memory) and cuSPARSE's CSR SpMV take about the same
// time (PERF.md).
//
// Design. One output row belongs to a sub-warp of L lanes (L = 8 at row
// 5, from the plan's mean row length: ops/spmv_routed.py::lanes_per_row).
// The lanes stride over the row's records, UNROLL records a lane in
// flight (the loads of a slot depend on one another, record -> x), gather
// x through the read-only path, form the split product in f32 (P a
// template argument: a loop over it at run time measured markedly slower)
// and add it into an f64 register. The L partial sums are reduced by
// shuffles in a fixed order and the first lane writes y[r] once. No
// shared memory, no atomics, no partial tiles, no second launch;
// 256-thread CTAs over row tiles fill all 132 SMs. Empty rows write 0. A
// hub row is walked by its one sub-warp: right, but slow (merge-path
// balancing is later work).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace csr_walk {

constexpr int THREADS = 256;
constexpr int UNROLL = 4;                 // records in flight per lane

// Sum of the first P parts of the mantissa-mask split of v. Each part and
// residual is exact, and every partial sum is a subset of v's bits, so
// the f32 additions are exact too.
template <int P>
__device__ __forceinline__ float split_sum(float v) {
  float acc = 0.0f, rem = v;
#pragma unroll
  for (int p = 0; p < P; ++p) {
    const float hi = __uint_as_float(__float_as_uint(rem) & 0xFFFF0000u);
    acc += hi;
    rem -= hi;
  }
  return acc;
}

// grid = ceil(n_rows / (THREADS / L)); sub-warp t of the CTA owns row
// blockIdx.x * (THREADS / L) + t. Every thread reaches the shuffles.
template <int L, int P, bool SPLIT_X>
__global__ void __launch_bounds__(THREADS)
kernel(const int* __restrict__ row_ptr, const int2* __restrict__ cv,
       const float* __restrict__ x, float* __restrict__ y, long long n_rows,
       long long n_cols) {
  const int sub = threadIdx.x % L;
  const long long r =
      (long long)blockIdx.x * (THREADS / L) + threadIdx.x / L;
  double acc = 0.0;
  if (r < n_rows) {
    const int s0 = __ldg(row_ptr + r), s1 = __ldg(row_ptr + r + 1);
    for (int j0 = s0 + sub; j0 < s1; j0 += UNROLL * L) {
      int2 rec[UNROLL];
      float xv[UNROLL];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {     // records, coalesced per row
        const int j = j0 + u * L;
        rec[u] = j < s1 ? __ldg(cv + j) : make_int2(-1, 0);
      }
#pragma unroll
      for (int u = 0; u < UNROLL; ++u)       // x gathers (L1/L2)
        xv[u] = rec[u].x >= 0 && rec[u].x < n_cols ? __ldg(x + rec[u].x)
                                                   : 0.0f;
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {     // in record order
        if (j0 + u * L < s1) {
          const float xs = SPLIT_X ? split_sum<P>(xv[u]) : xv[u];
          acc += (double)split_sum<P>(xs * __int_as_float(rec[u].y));
        }
      }
    }
  }
#pragma unroll
  for (int o = L / 2; o > 0; o >>= 1)
    acc += __shfl_down_sync(0xffffffffu, acc, o, L);
  if (sub == 0 && r < n_rows) y[r] = (float)acc;
}

template <int L, bool SPLIT_X>
cudaError_t launch_lanes(const int* row_ptr, const int2* cv, const float* x,
                         float* y, long long n_rows, long long n_cols,
                         int passes, cudaStream_t st) {
  const long long rows_per_cta = THREADS / L;
  const unsigned blocks =
      (unsigned)((n_rows + rows_per_cta - 1) / rows_per_cta);
  switch (passes) {
    case 1:
      kernel<L, 1, SPLIT_X><<<blocks, THREADS, 0, st>>>(row_ptr, cv, x, y,
                                                        n_rows, n_cols);
      break;
    case 2:
      kernel<L, 2, SPLIT_X><<<blocks, THREADS, 0, st>>>(row_ptr, cv, x, y,
                                                        n_rows, n_cols);
      break;
    default:
      kernel<L, 3, SPLIT_X><<<blocks, THREADS, 0, st>>>(row_ptr, cv, x, y,
                                                        n_rows, n_cols);
  }
  return cudaGetLastError();
}

// Launches one walk on `stream`, never synchronises, and returns
// cudaGetLastError() (0 on success). cv must be 8-byte aligned; lanes is
// 1, 2, 4, 8, 16 or 32; passes 1, 2 or 3.
template <bool SPLIT_X>
int launch(const void* row_ptr, const void* cv, const void* x, void* y,
           long long n_rows, long long n_cols, int passes, int lanes,
           int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (n_rows < 0 || n_rows >= (1LL << 31) || n_cols < 0 || passes < 1 ||
      passes > 3 || reinterpret_cast<uintptr_t>(cv) % 8 != 0)
    return (int)cudaErrorInvalidValue;
  if (n_rows == 0) return (int)cudaSuccess;
  const int* rp = static_cast<const int*>(row_ptr);
  const int2* c = static_cast<const int2*>(cv);
  const float* xp = static_cast<const float*>(x);
  float* yp = static_cast<float*>(y);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define MATREL_WALK(L) \
  return (int)launch_lanes<L, SPLIT_X>(rp, c, xp, yp, n_rows, n_cols, \
                                       passes, st)
  switch (lanes) {
    case 1: MATREL_WALK(1);
    case 2: MATREL_WALK(2);
    case 4: MATREL_WALK(4);
    case 8: MATREL_WALK(8);
    case 16: MATREL_WALK(16);
    case 32: MATREL_WALK(32);
    default: return (int)cudaErrorInvalidValue;
  }
#undef MATREL_WALK
}

}  // namespace csr_walk
