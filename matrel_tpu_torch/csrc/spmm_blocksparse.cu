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
// parallel, so each CTA owns a run of output rows inside one block row
// (and, for the tile bodies, a run of output columns), walks that block
// row's tiles and their k-chunks from row_ptr and writes its output
// exactly once. No atomics; the result is the same on every run. A block
// row with no tiles writes zeros, so no zero tiles are appended. Ragged
// edges (any bs, any pm, D shorter than the tile grid, output rows past
// it) are masked to zero at the loads and at the store.
//
// Bodies. The caller chooses one by shape (ops/tile_body.py) and passes
// it as the dtype code; this file refuses a code for a shape its body
// cannot take, and nothing retries another body.
// - bf16, the tensor cores: where the shape allows
//   (bf16_tile_wgmma.cuh::shape_ok, pm % 8 == 0, 16-byte aligned
//   pointers) the wgmma body of bf16_tile_wgmma.cuh — a 128 x 256
//   sub-tile a CTA, TMA loads into a 4-stage ring, two consumer
//   warpgroups — and elsewhere the WMMA body below (64 x 64, synchronous
//   loads).
// - f32, wide D (pm > ops/tile_body.py F32_NARROW_MAX): the register-
//   blocked SIMT body of f32_tile_simt.cuh that B4-B7 share (128 x 128
//   sub-tiles, a two-stage cp.async ring), full-f32 FMA, never TF32 — the
//   counterpart of Precision.HIGHEST at pallas_spmm.py:135-136.
// - f32, narrow D (pm <= F32_NARROW_MAX, at most NARROW_MAX = 16): the
//   row walk below (spmm_narrow_kernel). Block-sparse PageRank's Sᵀ·w is
//   one column: a 64-column output tile would leave 63 of its columns,
//   and 63/64 of its FMAs and shared-memory reads, idle. The walk reads
//   each tile row once, as 512-byte coalesced loads, and sums in f64.
//
// Bounds. BASELINE row 4 (n = 100,352, bs = 512, 1% of tiles: nnzb =
// 384, pm = 512, bf16): ~0.2 GB of tile payload, at most ~0.2 GB of D row
// blocks and ~0.1 GB of output, about 0.12 ms at 3.35 TB/s; 1.03e11 FLOP,
// about 0.10 ms at 989 TFLOP/s: bound by memory. The wgmma body reads
// each tile once per column sub-tile (pm / 256 = 2 times) and each D
// panel once per row sub-tile (bs / 128 = 4 times), mostly from L2. In
// f32 the same shape is bound by operations (1.54 ms at 67 TFLOP/s).
// Block-sparse PageRank's Sᵀ·w (588 f32 512² tiles, one column) must
// read 617 MB of tiles: 0.18 ms at 3.35 TB/s. The narrow body's f64 work
// (one f32 -> f64 conversion a tile element, pm DFMA) stays under that
// at one column.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <mma.h>
#include <stdint.h>

#include "bf16_tile_wgmma.cuh"
#include "f32_tile_simt.cuh"

namespace {

constexpr int BM = 64;          // output rows per CTA (inside one block row)
constexpr int BN = 64;          // output columns per CTA
constexpr int H_BK = 32;        // k-chunk of the bf16 kernel
constexpr int H_THREADS = 128;  // 4 warps, 32 x 32 outputs each

template <typename T> __device__ __forceinline__ T zero_of();
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

// -- f32 payloads, narrow D: the row walk ----------------------------------

constexpr int N_THREADS = 256;  // 8 warps
constexpr int N_RW = 2;         // tile rows a warp
constexpr int N_ROWS = N_RW * (N_THREADS / 32);  // output rows a CTA
constexpr int NARROW_MAX = 16;  // widest D the narrow body takes

// Y = S · D for D of pm <= PMAX columns. The CTA owns N_ROWS output rows
// of one block row, and all its warps walk that block row's tiles in CSR
// order, each k-chunk of KC rows of D's row block staged once in shared
// memory as f64, transposed, for all of them. A warp owns N_RW tile rows
// (each D value read from shared memory feeds both): each lane loads its
// share of a chunk of each row (VEC: float4s at k = 4 * (lane + 32 j), so
// one instruction reads 512 contiguous bytes; else one float at k = lane
// + 32 j) and keeps N_RW x pm partial sums. A chunk's A loads and its D
// loads (into registers, then shared memory) are all issued before the
// first barrier, so their latencies overlap. Each f32 x f32 product is
// exact in f64, the sums are f64, and the lanes combine them by a fixed
// butterfly (every lane ends with the same sum); lane c writes column c,
// rounded once to f32. No atomics: the result is the same on every run.
// VEC: bs % 4 == 0 and the tiles 16-byte aligned (D is staged element by
// element, so its alignment is free).
template <int PMAX, bool VEC>
__global__ void __launch_bounds__(N_THREADS, 2)
spmm_narrow_kernel(const float* __restrict__ blocks,
                   const int* __restrict__ row_ptr,
                   const int* __restrict__ bcols, const float* __restrict__ d,
                   float* __restrict__ out, int gr, int bs, int chunks,
                   int64_t k_rows, int pm, int64_t out_rows) {
  constexpr int KC = PMAX <= 8 ? 512 : 128;   // Ds: at most 33 KB
  constexpr int W = VEC ? 4 : 1;              // floats a load
  constexpr int NJ = KC / (32 * W);           // loads a lane, a row, a chunk
  constexpr int SPT = PMAX * KC / N_THREADS;  // D values a thread stages
  // Ds holds element (c, k) at c * SC + k (scalar loads) or, VEC, at
  // c * SC + (k % 4) * SI + k / 4, so that a warp reading component k % 4
  // of its lanes' quads reads 256 contiguous bytes. The pads (SI = KC / 4
  // + 1, SC = 4 SI; scalar: SC = KC + 1) spread a warp's staging stores,
  // (c, k) with c fastest, over the banks.
  constexpr int SI = KC / 4 + 1;
  constexpr int SC = VEC ? 4 * SI : KC + 1;
  __shared__ double Ds[PMAX * SC];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int64_t br = blockIdx.x / chunks;
  const int rl0 = (int)(blockIdx.x % chunks) * N_ROWS;
  if (br * bs + rl0 >= out_rows) return;          // uniform for the CTA
  const int wr0 = rl0 + warp * N_RW;              // the warp's first row
  int t_begin = 0, t_end = 0;
  if (br < gr) {
    t_begin = row_ptr[br];
    t_end = row_ptr[br + 1];
  }
  bool live[N_RW];
#pragma unroll
  for (int r = 0; r < N_RW; ++r)
    live[r] = wr0 + r < bs && br * bs + wr0 + r < out_rows;
  double acc[N_RW][PMAX];
#pragma unroll
  for (int r = 0; r < N_RW; ++r)
#pragma unroll
    for (int c = 0; c < PMAX; ++c) acc[r][c] = 0.0;

  for (int t = t_begin; t < t_end; ++t) {
    const int64_t drow0 = (int64_t)bcols[t] * bs;
    const float* tile = blocks + (int64_t)t * bs * bs;
    for (int k0 = 0; k0 < bs; k0 += KC) {
      const int kn = min(KC, bs - k0);
      float a[N_RW][NJ * W];
#pragma unroll
      for (int r = 0; r < N_RW; ++r) {
        const float* row = tile + (int64_t)(wr0 + r) * bs + k0;
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          const int k = W * (lane + 32 * j);
          const bool ok = live[r] && k < kn;
          if constexpr (VEC) {
            const float4 v = ok ? __ldg(reinterpret_cast<const float4*>(row + k))
                                : make_float4(0.f, 0.f, 0.f, 0.f);
            a[r][4 * j] = v.x; a[r][4 * j + 1] = v.y;
            a[r][4 * j + 2] = v.z; a[r][4 * j + 3] = v.w;
          } else {
            a[r][j] = ok ? __ldg(row + k) : 0.f;
          }
        }
      }
      // D rows drow0 + k0 .. + kn (zero past k_rows), pm values each,
      // contiguous in d: thread i stages values i, i + N_THREADS, ...
      const int nd = kn * pm;
      const float* dsrc = d + (drow0 + k0) * pm;
      const int64_t d_left = (k_rows - drow0 - k0) * pm;  // values in d
      float dv[SPT];
#pragma unroll
      for (int u = 0; u < SPT; ++u) {
        const int idx = threadIdx.x + u * N_THREADS;
        dv[u] = idx < nd && idx < d_left ? __ldg(dsrc + idx) : 0.f;
      }
      __syncthreads();                 // the last chunk's Ds reads are done
#pragma unroll
      for (int u = 0; u < SPT; ++u) {
        const int idx = threadIdx.x + u * N_THREADS;
        if (idx < nd) {
          const int k = idx / pm, c = idx - k * pm;
          Ds[VEC ? c * SC + (k & 3) * SI + (k >> 2) : c * SC + k] =
              (double)dv[u];
        }
      }
      __syncthreads();
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int k = W * (lane + 32 * j);
        if (k >= kn) continue;         // the chunk's ragged end
#pragma unroll
        for (int i = 0; i < W; ++i) {
#pragma unroll
          for (int c = 0; c < PMAX; ++c) {
            if (c >= pm) break;
            const double dd = VEC ? Ds[c * SC + i * SI + lane + 32 * j]
                                  : Ds[c * SC + k];
#pragma unroll
            for (int r = 0; r < N_RW; ++r)
              acc[r][c] = fma((double)a[r][W * j + i], dd, acc[r][c]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < N_RW; ++r) {
    float w = 0.f;
#pragma unroll
    for (int c = 0; c < PMAX; ++c) {
      if (c >= pm) break;
      double v = acc[r][c];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        v += __shfl_xor_sync(0xffffffffu, v, off);
      if (lane == c) w = __double2float_rn(v);
    }
    if (live[r] && lane < pm) out[(br * bs + wr0 + r) * pm + lane] = w;
  }
}

template <int PMAX, bool VEC>
cudaError_t launch_narrow_as(const float* blocks, const int* row_ptr,
                             const int* bcols, const float* d, float* out,
                             int gr, int bs, long long k_rows, int pm,
                             long long out_rows, cudaStream_t s) {
  const int chunks = (bs + N_ROWS - 1) / N_ROWS;
  const long long gx = (out_rows + bs - 1) / bs * chunks;
  if (gx > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  spmm_narrow_kernel<PMAX, VEC><<<(unsigned)gx, N_THREADS, 0, s>>>(
      blocks, row_ptr, bcols, d, out, gr, bs, chunks, k_rows, pm, out_rows);
  return cudaGetLastError();
}

template <int PMAX>
cudaError_t launch_narrow_pm(const float* blocks, const int* row_ptr,
                             const int* bcols, const float* d, float* out,
                             int gr, int bs, long long k_rows, int pm,
                             long long out_rows, bool vec, cudaStream_t s) {
  return vec ? launch_narrow_as<PMAX, true>(blocks, row_ptr, bcols, d, out, gr,
                                            bs, k_rows, pm, out_rows, s)
             : launch_narrow_as<PMAX, false>(blocks, row_ptr, bcols, d, out,
                                             gr, bs, k_rows, pm, out_rows, s);
}

// The narrow body, its accumulator width the least of 1, 2, 4, 8, 16
// that holds pm; refused (cudaErrorInvalidValue) for pm > NARROW_MAX.
int launch_narrow(const void* blocks, const void* row_ptr, const void* bcols,
                  const void* d, void* out, int gr, int bs, long long k_rows,
                  long long pm, long long out_rows, int a_vec,
                  cudaStream_t s) {
  if (pm > NARROW_MAX) return (int)cudaErrorInvalidValue;
  const float* a = static_cast<const float*>(blocks);
  const int* rp = static_cast<const int*>(row_ptr);
  const int* bc = static_cast<const int*>(bcols);
  const float* dd = static_cast<const float*>(d);
  float* o = static_cast<float*>(out);
  const bool vec = a_vec && bs % 4 == 0;
  const int p = (int)pm;
  cudaError_t e;
  if (p <= 1)
    e = launch_narrow_pm<1>(a, rp, bc, dd, o, gr, bs, k_rows, p, out_rows, vec, s);
  else if (p <= 2)
    e = launch_narrow_pm<2>(a, rp, bc, dd, o, gr, bs, k_rows, p, out_rows, vec, s);
  else if (p <= 4)
    e = launch_narrow_pm<4>(a, rp, bc, dd, o, gr, bs, k_rows, p, out_rows, vec, s);
  else if (p <= 8)
    e = launch_narrow_pm<8>(a, rp, bc, dd, o, gr, bs, k_rows, p, out_rows, vec, s);
  else
    e = launch_narrow_pm<16>(a, rp, bc, dd, o, gr, bs, k_rows, p, out_rows, vec, s);
  return (int)e;
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

// B1's pair list for the wgmma and the wide f32 bodies: the tiles of
// block row s in CSR order; tile t multiplies D's row block bcols[t].
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
  __device__ int64_t out_slot(int s) const { return s; }
};

// The wide f32 body of f32_tile_simt.cuh over D's row blocks.
int launch_f32_wide(const void* blocks, const void* row_ptr, const void* bcols,
                    const void* d, void* out, int gr, int bs, long long k_rows,
                    long long pm, long long out_rows, int a_vec, int d_vec,
                    cudaStream_t s) {
  if (pm > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const CsrRows P{static_cast<const int*>(row_ptr),
                  static_cast<const int*>(bcols), gr};
  const tile_f32::DenseOperands O{(int)pm, k_rows, out_rows};
  const bool vec = a_vec && d_vec && bs % 4 == 0 && pm % 4 == 0 &&
                   tile_wgmma::aligned16(out);
  return (int)tile_f32::launch(static_cast<const float*>(blocks),
                               static_cast<const float*>(d),
                               static_cast<float*>(out), P, O,
                               (out_rows + bs - 1) / bs, bs, pm, vec, s);
}

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

// dtype (the tile body, ops/tile_body.py CODES): 0 = float32, wide D
// (f32_tile_simt.cuh), 1 = bfloat16 (WMMA body), 2 = bfloat16 (wgmma
// body, refused with cudaErrorInvalidValue for a shape it cannot take),
// 3 = float32, narrow D (the row walk, refused for pm > NARROW_MAX).
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
  switch (dtype) {
    case 0:
      return launch_f32_wide(blocks, row_ptr, bcols, d, out, gr, bs, k_rows,
                             pm, out_rows, a_vec, d_vec, s);
    case 2:
      return launch_wgmma(blocks, row_ptr, bcols, d, out, gr, bs, nnzb,
                          k_rows, pm, out_rows, s);
    case 3:
      return launch_narrow(blocks, row_ptr, bcols, d, out, gr, bs, k_rows, pm,
                           out_rows, a_vec, s);
    case 1:
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  const int chunks = (bs + BM - 1) / BM;
  const long long block_rows_out = (out_rows + bs - 1) / bs;
  const long long gx = block_rows_out * chunks;
  const long long gy = (pm + BN - 1) / BN;
  if (gx > 0x7fffffffLL || gy > 65535LL) return (int)cudaErrorInvalidConfiguration;
  const dim3 grid((unsigned)gx, (unsigned)gy);
  spmm_bf16_kernel<<<grid, H_THREADS, 0, s>>>(
      static_cast<const __nv_bfloat16*>(blocks),
      static_cast<const int*>(row_ptr), static_cast<const int*>(bcols),
      static_cast<const __nv_bfloat16*>(d), static_cast<__nv_bfloat16*>(out),
      gr, bs, chunks, k_rows, pm, out_rows, a_vec, d_vec);
  return (int)cudaGetLastError();
}
