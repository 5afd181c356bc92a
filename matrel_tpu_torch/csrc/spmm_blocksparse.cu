// Block-sparse x dense SpMM for Hopper (sm_90a): Y = S · D.
//
// Replaces the TPU kernel matrel_tpu/ops/pallas_spmm.py::_make_kernel
// (built by make_spmm, pallas_call at pallas_spmm.py:137). S is a stack
// of nnzb dense bs x bs tiles in CSR order (row_ptr over block rows,
// bcols per tile); D is a dense [k_rows, pm] matrix; Y is [out_rows, pm]
// in the payload dtype.
//
// Schedule. The TPU grid runs in order and accumulates a row run into
// one output block across grid steps. On Hopper the blocks run in
// parallel, so each CTA owns ONE output sub-tile (BM rows inside one
// block row x BN columns), walks that block row's tiles and their
// k-chunks from row_ptr, stages A and D sub-tiles in shared memory,
// accumulates in f32 registers/fragments and writes its output exactly
// once. No atomics; the result is the same on every run. A block row
// with no tiles writes zeros, so no zero tiles are appended. Ragged
// edges (any bs, any pm, D shorter than the tile grid) are masked to
// zero at the shared-memory loads and at the store.
//
// Arithmetic. bf16 payloads run on the tensor cores: where the shape
// allows (bf16_tile_wgmma.cuh::shape_ok, pm % 8 == 0, 16-byte aligned
// pointers) the wgmma body of bf16_tile_wgmma.cuh — a 128 x 256 sub-tile
// a CTA, TMA loads into a 4-stage ring, two consumer warpgroups — and
// elsewhere the WMMA body below (64 x 64, synchronous loads). The caller
// chooses the body (ops/tile_body.py) and passes it as the dtype code;
// this file refuses a wgmma code for a shape the body cannot take. f32
// payloads run full-f32 FMA on the CUDA cores, never TF32 — the
// counterpart of Precision.HIGHEST at pallas_spmm.py:135-136.
//
// Bound at BASELINE row 4 (n = 100,352, bs = 512, 1% of tiles:
// nnzb = 384, pm = 512, bf16): the kernel must move ~0.2 GB of tile
// payload, at most ~0.2 GB of D row blocks and ~0.1 GB of output, about
// 0.12 ms at 3.35 TB/s; it does 1.03e11 FLOP, about 0.10 ms at
// 989 TFLOP/s. So it is bound by memory. The wgmma body reads each tile
// once per column sub-tile (pm / 256 = 2 times) and each D panel once per
// row sub-tile (bs / 128 = 4 times), mostly from L2, and writes each
// output element once.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <mma.h>
#include <stdint.h>

#include "bf16_tile_wgmma.cuh"

namespace {

constexpr int BM = 64;          // output rows per CTA (inside one block row)
constexpr int BN = 64;          // output columns per CTA
constexpr int F_BK = 16;        // k-chunk of the f32 kernel
constexpr int F_THREADS = 256;  // 16 x 16 threads, 4 x 4 outputs each
constexpr int H_BK = 32;        // k-chunk of the bf16 kernel
constexpr int H_THREADS = 128;  // 4 warps, 32 x 32 outputs each

template <typename T> __device__ __forceinline__ T zero_of();
template <> __device__ __forceinline__ float zero_of<float>() { return 0.0f; }
template <> __device__ __forceinline__ __nv_bfloat16 zero_of<__nv_bfloat16>() {
  return __float2bfloat16(0.0f);
}

// Load row[col0 .. col0+VEC) into v, zero where !ok or col >= ncols.
// One 16-byte load when the whole segment is in bounds and aligned.
template <typename T, int VEC>
__device__ __forceinline__ void load_seg(T (&v)[VEC], const T* __restrict__ row,
                                         int64_t col0, int64_t ncols, bool ok,
                                         int vec_ok) {
  if (ok && vec_ok && col0 + VEC <= ncols) {
    const uint4 u = *reinterpret_cast<const uint4*>(row + col0);
    const T* e = reinterpret_cast<const T*>(&u);
#pragma unroll
    for (int i = 0; i < VEC; ++i) v[i] = e[i];
  } else {
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      const int64_t c = col0 + i;
      v[i] = (ok && c < ncols) ? row[c] : zero_of<T>();
    }
  }
}

// f32 payloads: SIMT FMA, 64 x 64 output tile, 4 x 4 per thread.
__global__ void __launch_bounds__(F_THREADS)
spmm_f32_kernel(const float* __restrict__ blocks, const int* __restrict__ row_ptr,
                const int* __restrict__ bcols, const float* __restrict__ d,
                float* __restrict__ out, int gr, int bs, int chunks,
                int64_t k_rows, int64_t pm, int64_t out_rows, int a_vec,
                int d_vec) {
  __shared__ float As[F_BK][BM + 4];               // A chunk, stored k-major
  __shared__ __align__(16) float Bs[F_BK][BN + 4];  // D chunk
  const int tid = threadIdx.x;
  const int64_t br = blockIdx.x / chunks;           // block row
  const int rloc0 = (int)(blockIdx.x % chunks) * BM;  // first row inside it
  const int64_t n0 = (int64_t)blockIdx.y * BN;
  if (br * bs + rloc0 >= out_rows) return;          // uniform for the CTA
  int t_begin = 0, t_end = 0;
  if (br < gr) {
    t_begin = row_ptr[br];
    t_end = row_ptr[br + 1];
  }
  const int ty = tid / 16, tx = tid % 16;
  const int a_r = tid / 4, a_c = (tid % 4) * 4;    // 64 rows x 4 segments
  const int b_r = tid / 16, b_c = (tid % 16) * 4;  // 16 rows x 16 segments
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;

  for (int t = t_begin; t < t_end; ++t) {
    const int64_t cb = bcols[t];
    const float* tile = blocks + (int64_t)t * bs * bs;
    for (int k0 = 0; k0 < bs; k0 += F_BK) {
      {
        const int rl = rloc0 + a_r;
        const bool ok = rl < bs;
        float v[4];
        load_seg<float, 4>(v, ok ? tile + (int64_t)rl * bs : nullptr, k0 + a_c,
                           bs, ok, a_vec);
#pragma unroll
        for (int i = 0; i < 4; ++i) As[a_c + i][a_r] = v[i];
      }
      {
        const int kr = k0 + b_r;
        const int64_t drow = cb * bs + kr;
        const bool ok = kr < bs && drow < k_rows;
        float v[4];
        load_seg<float, 4>(v, ok ? d + drow * pm : nullptr, n0 + b_c, pm, ok,
                           d_vec);
#pragma unroll
        for (int i = 0; i < 4; ++i) Bs[b_r][b_c + i] = v[i];
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < F_BK; ++kk) {
        float a[4], b[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = As[kk][ty * 4 + i];
#pragma unroll
        for (int j = 0; j < 4; ++j) b[j] = Bs[kk][tx * 4 + j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      }
      __syncthreads();
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int rl = rloc0 + ty * 4 + i;
    const int64_t r = br * bs + rl;
    if (rl >= bs || r >= out_rows) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int64_t c = n0 + tx * 4 + j;
      if (c < pm) out[r * pm + c] = acc[i][j];
    }
  }
}

// bf16 payloads of the shapes the wgmma body does not take: WMMA
// 16x16x16 bf16 -> f32 on the tensor cores. Four warps in a 2 x 2
// arrangement, each owning a 32 x 32 quadrant.
__global__ void __launch_bounds__(H_THREADS)
spmm_bf16_kernel(const __nv_bfloat16* __restrict__ blocks,
                 const int* __restrict__ row_ptr, const int* __restrict__ bcols,
                 const __nv_bfloat16* __restrict__ d,
                 __nv_bfloat16* __restrict__ out, int gr, int bs, int chunks,
                 int64_t k_rows, int64_t pm, int64_t out_rows, int a_vec,
                 int d_vec) {
  using namespace nvcuda;
  __shared__ __align__(32) __nv_bfloat16 As[BM][H_BK + 8];
  __shared__ __align__(32) __nv_bfloat16 Bs[H_BK][BN + 8];
  __shared__ __align__(32) float Cs[BM][BN + 4];
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int wm = warp / 2, wn = warp % 2;
  const int64_t br = blockIdx.x / chunks;
  const int rloc0 = (int)(blockIdx.x % chunks) * BM;
  const int64_t n0 = (int64_t)blockIdx.y * BN;
  if (br * bs + rloc0 >= out_rows) return;          // uniform for the CTA
  int t_begin = 0, t_end = 0;
  if (br < gr) {
    t_begin = row_ptr[br];
    t_end = row_ptr[br + 1];
  }
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

  for (int t = t_begin; t < t_end; ++t) {
    const int64_t cb = bcols[t];
    const __nv_bfloat16* tile = blocks + (int64_t)t * bs * bs;
    for (int k0 = 0; k0 < bs; k0 += H_BK) {
#pragma unroll
      for (int s = 0; s < 2; ++s) {           // A: 64 rows x 4 segments of 8
        const int seg = tid + s * H_THREADS;
        const int r = seg / 4, c = (seg % 4) * 8;
        const int rl = rloc0 + r;
        const bool ok = rl < bs;
        __nv_bfloat16 v[8];
        load_seg<__nv_bfloat16, 8>(v, ok ? tile + (int64_t)rl * bs : nullptr,
                                   k0 + c, bs, ok, a_vec);
#pragma unroll
        for (int i = 0; i < 8; ++i) As[r][c + i] = v[i];
      }
#pragma unroll
      for (int s = 0; s < 2; ++s) {           // D: 32 rows x 8 segments of 8
        const int seg = tid + s * H_THREADS;
        const int r = seg / 8, c = (seg % 8) * 8;
        const int kr = k0 + r;
        const int64_t drow = cb * bs + kr;
        const bool ok = kr < bs && drow < k_rows;
        __nv_bfloat16 v[8];
        load_seg<__nv_bfloat16, 8>(v, ok ? d + drow * pm : nullptr, n0 + c, pm,
                                   ok, d_vec);
#pragma unroll
        for (int i = 0; i < 8; ++i) Bs[r][c + i] = v[i];
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < H_BK; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                       wmma::row_major> fa[2];
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                       wmma::row_major> fb[2];
#pragma unroll
        for (int i = 0; i < 2; ++i)
          wmma::load_matrix_sync(fa[i], &As[wm * 32 + i * 16][kk], H_BK + 8);
#pragma unroll
        for (int j = 0; j < 2; ++j)
          wmma::load_matrix_sync(fb[j], &Bs[kk][wn * 32 + j * 16], BN + 8);
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int j = 0; j < 2; ++j)
            wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
      }
      __syncthreads();
    }
  }
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(&Cs[wm * 32 + i * 16][wn * 32 + j * 16],
                              acc[i][j], BN + 4, wmma::mem_row_major);
  __syncthreads();
  for (int idx = tid; idx < BM * BN; idx += H_THREADS) {
    const int r = idx / BN, c = idx % BN;
    const int rl = rloc0 + r;
    const int64_t gr_ = br * bs + rl;
    const int64_t gc_ = n0 + c;
    if (rl < bs && gr_ < out_rows && gc_ < pm)
      out[gr_ * pm + gc_] = __float2bfloat16(Cs[r][c]);
  }
}

// B1's pair list for the wgmma body: the tiles of block row s in CSR
// order; tile t multiplies D's row block bcols[t].
struct CsrRows {
  const int* __restrict__ row_ptr;
  const int* __restrict__ bcols;
  int gr;
  __device__ int begin(int s) const { return s < gr ? row_ptr[s] : 0; }
  __device__ int end(int s) const { return s < gr ? row_ptr[s + 1] : 0; }
  __device__ bool pair(int, int t, int64_t& ia, int64_t& ib) const {
    ia = t;
    ib = bcols[t];
    return true;
  }
};

int launch_wgmma(const void* blocks, const void* row_ptr, const void* bcols,
                 const void* d, void* out, int gr, int bs, long long nnzb,
                 long long k_rows, long long pm, long long out_rows,
                 cudaStream_t s) {
  namespace tw = tile_wgmma;
  if (!tw::shape_ok(bs) || pm % 8 != 0 || nnzb < 1 || k_rows < 1 ||
      !tw::aligned16(blocks) || !tw::aligned16(d) || !tw::aligned16(out))
    return (int)cudaErrorInvalidValue;
  CUtensorMap map_a, map_d;
  int rc = tw::encode_tiles(&map_a, blocks, nnzb, bs, tw::BM);
  if (rc == 0) rc = tw::encode_dense(&map_d, d, k_rows, pm);
  if (rc != 0) return rc;
  const CsrRows P{static_cast<const int*>(row_ptr),
                  static_cast<const int*>(bcols), gr};
  return tw::launch<CsrRows, true>(
      map_a, map_d, static_cast<__nv_bfloat16*>(out), P,
      (out_rows + bs - 1) / bs, bs, out_rows, pm, s);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (WMMA body), 2 = bfloat16 (wgmma body,
// refused with cudaErrorInvalidValue for a shape it cannot take).
// Launches on `stream` and returns cudaGetLastError() (0 on success), or
// tile_wgmma::ENCODE_FAILED + the CUresult of a tensor map that could not
// be encoded; it never synchronises.
extern "C" int matrel_spmm_blocksparse(const void* blocks, const void* row_ptr,
                                       const void* bcols, const void* d,
                                       void* out, int dtype, int gr, int bs,
                                       long long nnzb, long long k_rows,
                                       long long pm,
                                       long long out_rows, int a_vec, int d_vec,
                                       int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (bs <= 0 || pm <= 0 || out_rows <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 2)
    return launch_wgmma(blocks, row_ptr, bcols, d, out, gr, bs, nnzb, k_rows,
                        pm, out_rows, s);
  const int chunks = (bs + BM - 1) / BM;
  const long long block_rows_out = (out_rows + bs - 1) / bs;
  const long long gx = block_rows_out * chunks;
  const long long gy = (pm + BN - 1) / BN;
  if (gx > 0x7fffffffLL || gy > 65535LL) return (int)cudaErrorInvalidConfiguration;
  const dim3 grid((unsigned)gx, (unsigned)gy);
  if (dtype == 0) {
    spmm_f32_kernel<<<grid, F_THREADS, 0, s>>>(
        static_cast<const float*>(blocks), static_cast<const int*>(row_ptr),
        static_cast<const int*>(bcols), static_cast<const float*>(d),
        static_cast<float*>(out), gr, bs, chunks, k_rows, pm, out_rows, a_vec,
        d_vec);
  } else if (dtype == 1) {
    spmm_bf16_kernel<<<grid, H_THREADS, 0, s>>>(
        static_cast<const __nv_bfloat16*>(blocks),
        static_cast<const int*>(row_ptr), static_cast<const int*>(bcols),
        static_cast<const __nv_bfloat16*>(d), static_cast<__nv_bfloat16*>(out),
        gr, bs, chunks, k_rows, pm, out_rows, a_vec, d_vec);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
