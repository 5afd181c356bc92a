// Routed SpMV (B8) for Hopper (sm_90a).
//
// Replaces the TPU kernels matrel_tpu/ops/spmv_routed.py::
// _make_gather_kernel (spmv_routed.py:232, pallas_call at :311) and
// ::_make_scatter_kernel (spmv_routed.py:261, pallas_call at :328), both
// launched by _routed_runner (:304), together with the bf16 split of x
// that routed_apply does in XLA before them (:357-361).
//
// Input: a RoutedSpMVPlan's tables, (g_s, g_d, cap) each, row-major:
// loc_src int32, loc_dst int32, val f32. Slot s of cell (gs, gd) holds an
// edge x[gs*SPAN + loc_src] * val -> y[gd*SPAN + loc_dst], SPAN = 16384;
// padded slots have val = 0. For each slot the kernel
//   1. reads loc_src, loc_dst and val (coalesced: neighbouring threads,
//      neighbouring slots);
//   2. reads x[gs*SPAN + loc_src] and keeps the sum of the first
//      `passes` parts of its bf16 mantissa-mask split (phase 1's x-side
//      split, ops/spmv_routed.py::_bf16_split);
//   3. multiplies by val in f32 (phase 1's product w);
//   4. adds the sum of the first `passes` parts of w's split (phase 3's
//      w-side split) into output row gd*SPAN + loc_dst.
// passes = 3 adds x*val exactly; passes = 2 truncates each side to its
// leading 16 significant bits, as the TPU kernels' two bf16 passes do.
// The overflow COO is summed outside, with index_add_.
//
// Schedule. The TPU builds one-hot factors of every cell in VMEM and
// contracts them on the MXU (a gather-free gather, a scatter-free
// scatter). On Hopper a gather is a load and a scatter by destination is
// a shared-memory reduction, so no one-hot tensor exists here. One CTA
// owns one destination group's 16,384-row f64 accumulator in shared
// memory (128 KB, dynamic, opted in) and walks the cells (gs, gd) of a
// contiguous range of source groups as one flat range of slots, 1024
// threads with 4 slots each in flight (the loads of a slot depend on one
// another, table -> x -> accumulator, so one slot a thread leaves the
// kernel waiting on latency); each real slot adds with a shared-memory
// atomicAdd (slots are in input order within a cell, not sorted by
// destination, so B2's warp scan does not apply). With fewer
// destination groups than SMs (62 at BASELINE row 5, against 132 SMs)
// the source groups of each destination group are split across `splits`
// CTAs; each writes its f64 partial tile and a second pass adds the
// partials in split order and rounds each row to f32 once. With splits =
// 1 the CTA writes y directly. No global atomics; the sums' order within
// a CTA varies, but f64 sums make that invisible at f32 precision.
//
// Bound at BASELINE row 5 (1,000,000 nodes, 10,000,000 uniform edges:
// g_s = g_d = 62, cap ~ 2944, ~11.3 M slots of 12 bytes): one matvec
// must read the real slots' ~120 MB of tables plus x and y (4 MB each),
// about 0.038 ms at 3.35 TB/s; the operations are negligible, so it is
// bound by bytes. The partial tiles add splits * g_d * 16384 * 8 bytes
// written and read once (16 MB at splits = 2). x's random reads hit one
// 64 KB source-group slab per cell (L1/L2). Left for later: staging the
// slab in shared memory, sorting a cell's slots by destination once per
// plan to cut the atomics, and a persistent schedule over cells.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int SPAN = 128 * 128;
constexpr int THREADS = 1024;
constexpr int UNROLL = 4;                 // slots in flight per thread
constexpr int SMEM_BYTES = SPAN * (int)sizeof(double);   // 128 KB

// Sum of the first `passes` parts of the mantissa-mask split of v. Each
// part and residual is exact, and every partial sum is a subset of v's
// bits, so the f32 additions are exact too.
__device__ __forceinline__ float split_sum(float v, int passes) {
  float acc = 0.0f, rem = v;
  for (int p = 0; p < passes; ++p) {
    const float hi = __uint_as_float(__float_as_uint(rem) & 0xFFFF0000u);
    acc += hi;
    rem -= hi;
  }
  return acc;
}

// grid = (g_d, splits). CTA (gd, s) sums the cells (gs, gd) for gs in
// [s*g_s/splits, (s+1)*g_s/splits) into its shared tile, then writes
// y (splits == 1) or its f64 partial tile. The CTA's slots are walked as
// one flat range (cell after cell), UNROLL slots a thread per step with
// all their loads issued before any is used.
__global__ void __launch_bounds__(THREADS)
spmv_routed_kernel(const int* __restrict__ loc_src,
                   const int* __restrict__ loc_dst,
                   const float* __restrict__ val,
                   const float* __restrict__ x, float* __restrict__ y,
                   double* __restrict__ partial, int g_s, int g_d, int cap,
                   long long n_cols, long long n_rows, int passes,
                   int splits) {
  extern __shared__ double acc[];
  for (int i = threadIdx.x; i < SPAN; i += blockDim.x) acc[i] = 0.0;
  __syncthreads();
  const int gd = blockIdx.x, s = blockIdx.y;
  const int gs0 = (int)((long long)s * g_s / splits);
  const int gs1 = (int)((long long)(s + 1) * g_s / splits);
  // < 2^31: the entry refuses tables with g_s * cap past that
  const unsigned total = (unsigned)(gs1 - gs0) * (unsigned)cap;
  for (unsigned q0 = threadIdx.x; q0 < total; q0 += UNROLL * blockDim.x) {
    float v[UNROLL], xv[UNROLL];
    int ld[UNROLL];
    long long xi[UNROLL];
#pragma unroll
    for (int j = 0; j < UNROLL; ++j) {     // table loads, coalesced
      const unsigned q = q0 + j * blockDim.x;
      v[j] = 0.0f;
      ld[j] = 0;
      xi[j] = -1;
      if (q < total) {
        const int c = (int)(q / (unsigned)cap);
        const int t = (int)(q - (unsigned)c * (unsigned)cap);
        const long long p = ((long long)(gs0 + c) * g_d + gd) * cap + t;
        v[j] = __ldg(val + p);
        const int ls = __ldg(loc_src + p);
        ld[j] = __ldg(loc_dst + p);
        xi[j] = (long long)(gs0 + c) * SPAN + ls;
        if ((unsigned)ls >= (unsigned)SPAN || (unsigned)ld[j] >= (unsigned)SPAN)
          v[j] = 0.0f;
      }
    }
#pragma unroll
    for (int j = 0; j < UNROLL; ++j) {     // x gathers (L1/L2)
      const bool live = v[j] != 0.0f && xi[j] >= 0 && xi[j] < n_cols;
      xv[j] = live ? __ldg(x + xi[j]) : 0.0f;
      if (!live) v[j] = 0.0f;              // padded slot
    }
#pragma unroll
    for (int j = 0; j < UNROLL; ++j) {
      if (v[j] == 0.0f) continue;
      const float w = split_sum(xv[j], passes) * v[j];
      atomicAdd(&acc[ld[j]], (double)split_sum(w, passes));
    }
  }
  __syncthreads();
  const long long row0 = (long long)gd * SPAN;
  if (splits == 1) {
    for (int i = threadIdx.x; i < SPAN; i += blockDim.x)
      if (row0 + i < n_rows) y[row0 + i] = (float)acc[i];
  } else {
    double* out = partial + ((long long)s * g_d + gd) * SPAN;
    for (int i = threadIdx.x; i < SPAN; i += blockDim.x) out[i] = acc[i];
  }
}

// y[r] = f32(sum over s of partial[s][r]), in split order; r < n_rows.
__global__ void spmv_routed_combine(const double* __restrict__ partial,
                                    float* __restrict__ y, long long n_rows,
                                    long long stride, int splits) {
  const long long r = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= n_rows) return;
  double sum = 0.0;
  for (int s = 0; s < splits; ++s) sum += partial[s * stride + r];
  y[r] = (float)sum;
}

}  // namespace

// Launches on `stream` (one kernel, plus the combining pass when
// splits > 1), never synchronises, and returns cudaGetLastError() (0 on
// success). `partial` holds splits * g_d * SPAN doubles when splits > 1.
extern "C" int matrel_spmv_routed(const void* loc_src, const void* loc_dst,
                                  const void* val, const void* x, void* y,
                                  void* partial, int g_s, int g_d, int cap,
                                  long long n_cols, long long n_rows,
                                  int passes, int splits, int device,
                                  void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (g_s <= 0 || g_d <= 0 || g_d > 65535 || cap <= 0 || passes < 1 ||
      passes > 3 || splits < 1 || splits > g_s || splits > 65535 ||
      (long long)g_s * cap >= (1LL << 31) || n_rows < 0 ||
      n_rows > (long long)g_d * SPAN ||
      n_cols > (long long)g_s * SPAN || (splits > 1 && partial == nullptr))
    return (int)cudaErrorInvalidValue;
  if (n_rows == 0) return (int)cudaSuccess;
  err = cudaFuncSetAttribute(spmv_routed_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid((unsigned)g_d, (unsigned)splits);
  spmv_routed_kernel<<<grid, THREADS, SMEM_BYTES, st>>>(
      static_cast<const int*>(loc_src), static_cast<const int*>(loc_dst),
      static_cast<const float*>(val), static_cast<const float*>(x),
      static_cast<float*>(y), static_cast<double*>(partial), g_s, g_d, cap,
      n_cols, n_rows, passes, splits);
  err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return (int)err;
  const int threads = 256;
  const long long blocks = (n_rows + threads - 1) / threads;
  spmv_routed_combine<<<(unsigned)blocks, threads, 0, st>>>(
      static_cast<const double*>(partial), static_cast<float*>(y), n_rows,
      (long long)g_d * SPAN, splits);
  return (int)cudaGetLastError();
}
