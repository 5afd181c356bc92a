// Compact-table SpMV (B2) and k-wide SpMM (B3) for Hopper (sm_90a).
//
// Replaces the TPU kernels matrel_tpu/ops/pallas_spmv.py::
// _make_scatter_kernel (pallas_spmv.py:50, pallas_call at :87) and
// ::_make_scatter_kernel_k (pallas_spmv.py:334, pallas_call at :371),
// together with the XLA width-8 gather-select that feeds them
// (compact_apply, pallas_spmv.py:137-140).
//
// Input: an EdgeSpMVPlan's compact tables, (nb, cap) each, row-major:
// src8 int32, lane int8, off int32, val f32. Slot s of block b holds an
// edge x[src8*8 + lane] * val -> y[b*block + off]; padded slots point at
// the sentinel column n_cols and read 0. For each slot the kernels
//   1. read src8, lane, off and val (coalesced: neighbouring threads,
//      neighbouring slots);
//   2. form idx = src8*8 + lane and read x[idx] (0 for idx >= n_cols);
//   3. compute w = x[idx] * val in f32;
//   4. add the sum of the first `passes` parts of w's bf16 mantissa-mask
//      split (ops/spmv_routed.py::_bf16_split) into output row
//      b*block + off. passes = 3 adds w exactly; passes = 2 adds w
//      truncated to its leading 16 significant bits, as the TPU kernel's
//      two bf16 passes do.
// The overflow COO is summed outside, with index_add_.
//
// Schedule. The TPU grid walks one block per step and builds one-hot
// factors in VMEM for an MXU contraction. On Hopper one CTA owns one
// block of `block` output rows (B3: one block and one chunk of kc output
// columns) and walks the block's slots, 32 consecutive slots per warp
// step. The plan sorts a block's slots by row, so neighbouring lanes
// mostly share an output row: a warp-level segmented scan sums each run
// of equal offs and only the run's last lane adds into the CTA's array
// in shared memory (shared-memory atomicAdd). Then the CTA writes each
// of its output rows exactly once (rows past n_rows masked). No global
// atomics; rows with no slots get zeros.
//
// Arithmetic. Products and split parts are f32 (no TF32, no bf16
// arithmetic); the per-row sums are f64 and are rounded to f32 once, at
// the write. The order of the atomic additions into one row varies from
// run to run: with f32 sums a 5,000-term hub row differed from the
// plain version (another order) by 1.6e-6 of max|y|; f64 sums make the
// order invisible at f32 precision, so the kernel and its plain version
// (which also sums in f64) agree to about one f32 rounding.
//
// Bound at BASELINE row 5 (n = 1,000,000 nodes, 10,000,000 uniform
// edges, block 512: nb = 1954, cap ~ 5376, ~10.5 M slots): one matvec
// must read the 13 B/slot tables (~137 MB) plus x and y (4 MB each),
// ~0.145 GB, about 0.043 ms at 3.35 TB/s; the FLOPs are negligible, so
// it is bound by bytes. x fits in the 50 MB L2, so its 10.5 M random
// reads come from L2 (~0.34 GB of 32-byte sectors, a second, softer
// floor). B3 at k = 16 must also read X and write Y (64 MB each): about
// 0.08 ms. The design reads each table byte once (B3: once per column
// chunk), with coalesced loads, and keeps the scatter in shared memory
// so output traffic is one write per row. Left for later: slots sorted
// by off once per plan with a segmented (deterministic) reduction,
// cp.async/TMA staging of the tables, and a persistent schedule.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WIDTH = 8;          // gather row width of the compact layout
constexpr int THREADS = 256;      // threads per CTA, both kernels
constexpr int MAX_KC = 16;        // widest column chunk of the B3 kernel
constexpr int MAX_SMEM = 64 * 1024;

// Sum of the first `passes` parts of the mantissa-mask split of w. Each
// part and residual is exact, and every partial sum is a subset of w's
// bits, so the f32 additions are exact too.
__device__ __forceinline__ float split_sum(float w, int passes) {
  float acc = 0.0f, rem = w;
  for (int p = 0; p < passes; ++p) {
    const float hi = __uint_as_float(__float_as_uint(rem) & 0xFFFF0000u);
    acc += hi;
    rem -= hi;
  }
  return acc;
}

// First lane of this lane's run of equal keys among the warp's lanes
// (runs are contiguous lanes; keys of inactive lanes must be unique so
// they never merge). Every lane of the warp must call it.
__device__ __forceinline__ int run_start(int key, int lane) {
  const int prev = __shfl_up_sync(0xffffffffu, key, 1);
  const unsigned heads =
      __ballot_sync(0xffffffffu, lane == 0 || prev != key);
  // the highest head at or below this lane
  return 31 - __clz(heads & (0xffffffffu >> (31 - lane)));
}

// Does this lane end its run (the next lane holds another key)?
__device__ __forceinline__ bool run_tail(int key, int lane) {
  const int next = __shfl_down_sync(0xffffffffu, key, 1);
  return lane == 31 || next != key;
}

// Inclusive sum of v over the lanes of this lane's run, from its first
// lane `start` (a segmented Hillis-Steele scan). Every lane must call it.
__device__ __forceinline__ double run_sum(double v, int start, int lane) {
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const double t = __shfl_up_sync(0xffffffffu, v, d);
    if (lane - d >= start) v += t;
  }
  return v;
}

// B2: y[b*block + off] += split(x[src8*8 + lane] * val) over block b's
// slots. grid = nb, dynamic shared memory = block doubles. Each warp
// takes 32 consecutive slots at a time (coalesced table loads); lanes
// whose slots share an off (the plan sorts a block's slots by row) are
// summed by a warp-level segmented scan, and only the last lane of each
// run adds into shared memory.
__global__ void __launch_bounds__(THREADS)
spmv_compact_kernel(const int* __restrict__ src8,
                    const int8_t* __restrict__ lane,
                    const int* __restrict__ off,
                    const float* __restrict__ val,
                    const float* __restrict__ x, float* __restrict__ y,
                    int cap, int block, long long n_cols, long long n_rows,
                    int passes) {
  extern __shared__ double acc[];
  for (int i = threadIdx.x; i < block; i += blockDim.x) acc[i] = 0.0;
  __syncthreads();
  const int ln = threadIdx.x & 31;
  const long long base = (long long)blockIdx.x * cap;
  for (int s0 = threadIdx.x - ln; s0 < cap; s0 += blockDim.x) {
    const long long p = base + s0 + ln;    // cap is a multiple of 32
    const long long idx = (long long)__ldg(src8 + p) * WIDTH + __ldg(lane + p);
    const int o = __ldg(off + p);
    // sentinel slots (idx >= n_cols) contribute 0 and take a unique key
    const bool real = idx >= 0 && idx < n_cols && (unsigned)o < (unsigned)block;
    const int key = real ? o : -1 - ln;
    const double w =
        real ? (double)split_sum(__ldg(x + idx) * __ldg(val + p), passes)
             : 0.0;
    const double sum = run_sum(w, run_start(key, ln), ln);
    if (run_tail(key, ln) && real) atomicAdd(&acc[o], sum);
  }
  __syncthreads();
  const long long row0 = (long long)blockIdx.x * block;
  for (int i = threadIdx.x; i < block; i += blockDim.x)
    if (row0 + i < n_rows) y[row0 + i] = (float)acc[i];
}

// B3: Y[b*block + off, c0:c0+kc] += split(X[idx, c0:c0+kc] * val). X and
// Y are row-major (n_cols, k) and (n_rows, k) f32. grid = (nb, chunks);
// each warp takes 32 consecutive slots at a time; each lane loads its
// slot's kc floats of X into registers at once (16-byte loads when
// x_vec: k % 4 == 0 and X 16-byte aligned), then the warp runs one
// segmented scan per column. kc is a power of two <= MAX_KC. Dynamic
// shared memory = block * kc doubles.
__global__ void __launch_bounds__(THREADS)
spmm_compact_kernel(const int* __restrict__ src8,
                    const int8_t* __restrict__ lane,
                    const int* __restrict__ off,
                    const float* __restrict__ val,
                    const float* __restrict__ X, float* __restrict__ Y,
                    int cap, int block, long long n_cols, long long n_rows,
                    int k, int kc, int x_vec, int passes) {
  extern __shared__ double acc[];
  const int c0 = blockIdx.y * kc;
  const int kw = min(kc, k - c0);           // columns of this chunk
  for (int i = threadIdx.x; i < block * kc; i += blockDim.x) acc[i] = 0.0;
  __syncthreads();
  const int ln = threadIdx.x & 31;
  const long long base = (long long)blockIdx.x * cap;
  for (int s0 = threadIdx.x - ln; s0 < cap; s0 += blockDim.x) {
    const long long p = base + s0 + ln;
    const long long idx = (long long)__ldg(src8 + p) * WIDTH + __ldg(lane + p);
    const int o = __ldg(off + p);
    const bool real = idx >= 0 && idx < n_cols && (unsigned)o < (unsigned)block;
    const int key = real ? o : -1 - ln;
    const int start = run_start(key, ln);
    const bool tail = run_tail(key, ln) && real;
    const float v = real ? __ldg(val + p) : 0.0f;
    float xv[MAX_KC];
#pragma unroll
    for (int c = 0; c < MAX_KC; ++c) xv[c] = 0.0f;
    if (real) {
      const float* xr = X + idx * k + c0;
      if (x_vec) {            // c0 and kw are multiples of 4 here
#pragma unroll
        for (int c = 0; c < MAX_KC; c += 4) {
          if (c < kw) {
            const float4 q = __ldg(reinterpret_cast<const float4*>(xr + c));
            xv[c] = q.x; xv[c + 1] = q.y; xv[c + 2] = q.z; xv[c + 3] = q.w;
          }
        }
      } else {
#pragma unroll
        for (int c = 0; c < MAX_KC; ++c)
          if (c < kw) xv[c] = __ldg(xr + c);
      }
    }
#pragma unroll
    for (int c = 0; c < MAX_KC; ++c) {
      if (c < kw) {           // warp-uniform
        const double w =
            real ? (double)split_sum(xv[c] * v, passes) : 0.0;
        const double sum = run_sum(w, start, ln);
        if (tail) atomicAdd(&acc[o * kc + c], sum);
      }
    }
  }
  __syncthreads();
  const long long row0 = (long long)blockIdx.x * block;
  for (int i = threadIdx.x; i < block * kc; i += blockDim.x) {
    const int r = i / kc, c = i % kc;
    if (row0 + r < n_rows && c0 + c < k)
      Y[(row0 + r) * k + c0 + c] = (float)acc[i];
  }
}

}  // namespace

// Both entries launch on `stream`, never synchronise, and return
// cudaGetLastError() (0 on success). cap must be a multiple of 32 (plans
// round it to 128).
extern "C" int matrel_spmv_compact(const void* src8, const void* lane,
                                   const void* off, const void* val,
                                   const void* x, void* y, int nb, int cap,
                                   int block, long long n_cols,
                                   long long n_rows, int passes, int device,
                                   void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (nb <= 0 || cap <= 0 || cap % 32 != 0 || block <= 0 || passes < 1 ||
      passes > 3 || (long long)block * (long long)sizeof(double) > 48 * 1024)
    return (int)cudaErrorInvalidValue;
  spmv_compact_kernel<<<nb, THREADS, block * sizeof(double),
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(src8), static_cast<const int8_t*>(lane),
      static_cast<const int*>(off), static_cast<const float*>(val),
      static_cast<const float*>(x), static_cast<float*>(y), cap, block,
      n_cols, n_rows, passes);
  return (int)cudaGetLastError();
}

extern "C" int matrel_spmm_compact(const void* src8, const void* lane,
                                   const void* off, const void* val,
                                   const void* X, void* Y, int nb, int cap,
                                   int block, long long n_cols,
                                   long long n_rows, int k, int kc,
                                   int x_vec, int passes, int device,
                                   void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const long long smem = (long long)block * kc * (long long)sizeof(double);
  if (nb <= 0 || cap <= 0 || cap % 32 != 0 || block <= 0 || k <= 0 || kc <= 0 ||
      kc > MAX_KC || (kc & (kc - 1)) != 0 || (x_vec && kc < 4 && k > kc) ||
      passes < 1 || passes > 3 ||
      smem > MAX_SMEM)
    return (int)cudaErrorInvalidValue;
  const long long chunks = (k + kc - 1) / kc;
  if (chunks > 65535) return (int)cudaErrorInvalidConfiguration;
  if (smem > 48 * 1024) {           // opt in above the 48 KB default
    err = cudaFuncSetAttribute(spmm_compact_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid((unsigned)nb, (unsigned)chunks);
  spmm_compact_kernel<<<grid, THREADS, (size_t)smem,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(src8), static_cast<const int8_t*>(lane),
      static_cast<const int*>(off), static_cast<const float*>(val),
      static_cast<const float*>(X), static_cast<float*>(Y), cap, block,
      n_cols, n_rows, k, kc, x_vec, passes);
  return (int)cudaGetLastError();
}
