// Block-sparse x block-sparse tile SpGEMM for Hopper (sm_90a):
// out[slot] = sum over the slot's pairs of A[ia] @ B[ib].
//
// Replaces the TPU kernels of matrel_tpu/ops/kernel_registry.py:
//   B4 _make_pair_kernel    (pallas_call :348, id pallas_generic)
//   B5 _make_grouped_kernel (pallas_call :494, id pallas_cluster and the
//                            fallback of pallas_band)
//   B6 _build_band's `kern` (pallas_call :664, id pallas_band)
//   B7 _build_bucketed      (two B5 calls + out.at[ids].set :745, id
//                            pallas_powerlaw) — here B5 launched once per
//                            bucket, writing through `ids`.
// A and B are stacks of dense bs x bs tiles (the payloads, read in place);
// out is a stack of n_out tiles in the payload dtype.
//
// Schedule. The TPU kernels walk a slot-sorted pair list one grid step at
// a time and carry the slot's sum in VMEM from step to step. On Hopper
// the blocks run in parallel, so each CTA owns ONE sub-tile of ONE output
// tile (f32: 128 x 128 for bs >= 128, else 64 x 64; bf16: 64 x 64), walks
// all of that slot's pairs itself, stages the A and B k-chunks in shared
// memory, accumulates in f32 registers / fragments and writes its
// sub-tile exactly once: no atomics, and the sum order (the slot's pair
// order, then k ascending) is the same on every run. The CTAs of one
// output tile are adjacent in launch order so their A and B tiles are
// shared through L2. The three kernels share that body and differ only in
// how a slot's pairs are listed (the Pairs policies below):
//   B4 PairRuns  a CSR pointer over the slot-sorted pair list;
//   B5 Grouped   the _grouped_tables layout — group_slot (sorted) names
//                each group's slot, src its G pair positions; padding
//                positions (src == npairs) are skipped, not multiplied.
//                A CTA finds its slot's groups by binary search in
//                group_slot. The TPU version pre-gathers every group into
//                contiguous copies for sequential DMA; this one reads the
//                payload stacks through the tables, so no copy is made.
//   B6 Band      per slot its band position sel = i * width + c; the
//                strip product of A block row i over its wa band tiles
//                (a_idx) with band column c (b_idx). Index nA / nB is the
//                zero tile and is skipped. Writing in slot order replaces
//                the TPU version's row-band output and its take(sel).
// Ragged tiles (bs not a multiple of the sub-tile, bs down to 8) are
// masked to zero at the shared-memory loads and at the store.
//
// Arithmetic. bf16 payloads run on the tensor cores: where the shape
// allows (bf16_tile_wgmma.cuh::shape_ok and 16-byte aligned stacks) the
// wgmma body of bf16_tile_wgmma.cuh — a 128 x 256 sub-tile a CTA, TMA
// loads into a 4-stage ring flattened over the slot's pairs, two consumer
// warpgroups — and elsewhere the 64 x 64 WMMA body below. The caller
// chooses the body (ops/tile_body.py) and passes it as the dtype code;
// this file refuses a wgmma code for a shape the body cannot take. f32
// payloads run full-f32 FMA on the CUDA cores, never TF32 — the
// counterpart of Precision.HIGHEST in _pallas_precision (:325).
//
// Bound. A pair does 2 bs^3 operations on 2 tiles; at bs = 512 that is
// 256 operations per byte read even if every tile were read once per
// pair, so f32 pairs (67 TFLOP/s) are bound by operations, and bf16
// pairs (989 TFLOP/s) lie near the line: the random 1% bf16 pair at
// n = 100,352 needs ~0.77 GB (0.23 ms) and 191 GFLOP (0.19 ms).
//
// f32 design (B4-B7 share it). Exact f32 rules out the tensor cores, so
// f32 pairs are bound by FMA issue on the CUDA cores. A thread holds
// 8 x 8 outputs as 2 x 2 groups of 4 x 4 (4 LDS.128 feed 64 FFMA); a
// 128 x 128 sub-tile re-reads each A and B tile once per sub-tile row or
// column (4 times at bs = 512), from L2; and a two-stage ring overlaps
// the next k-chunk's copies with the current chunk's FMAs, across pair
// boundaries (spgemm_f32_kernel). cuBLAS's own f32 FFMA GEMM reaches
// ~53 TFLOP/s of the 67 on this card (PERF.md).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <mma.h>
#include <stdint.h>

#include "bf16_tile_wgmma.cuh"

namespace {

using tile_wgmma::next_live;

constexpr int BM = 64;          // bf16: output sub-tile rows per CTA
constexpr int BN = 64;          // bf16: output sub-tile columns per CTA
constexpr int F_BK = 16;        // k-chunk of the f32 kernel
constexpr int F_THREADS = 256;  // f32: 16 x 16 threads
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
                                         int col0, int ncols, bool ok,
                                         int vec_ok) {
  if (ok && vec_ok && col0 + VEC <= ncols) {
    const uint4 u = *reinterpret_cast<const uint4*>(row + col0);
    const T* e = reinterpret_cast<const T*>(&u);
#pragma unroll
    for (int i = 0; i < VEC; ++i) v[i] = e[i];
  } else {
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      const int c = col0 + i;
      v[i] = (ok && c < ncols) ? row[c] : zero_of<T>();
    }
  }
}

// -- pair-list policies: positions [begin(s), end(s)) of slot s; pair()
// gives the A and B tile of one position, or false for a skipped one --

struct PairRuns {  // B4
  const int* __restrict__ slot_ptr;
  const int* __restrict__ pa;
  const int* __restrict__ pb;
  __device__ int begin(int s) const { return slot_ptr[s]; }
  __device__ int end(int s) const { return slot_ptr[s + 1]; }
  __device__ bool pair(int, int t, int64_t& ia, int64_t& ib) const {
    ia = pa[t];
    ib = pb[t];
    return true;
  }
  __device__ int64_t out_slot(int s) const { return s; }
};

__device__ __forceinline__ int lower_bound(const int* __restrict__ v, int n,
                                           int key) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (v[mid] < key) lo = mid + 1; else hi = mid;
  }
  return lo;
}

struct Grouped {  // B5, and B7 per bucket
  const int* __restrict__ src;
  const int* __restrict__ group_slot;
  const int* __restrict__ pa;
  const int* __restrict__ pb;
  const int* __restrict__ ids;  // local slot -> output slot, or null
  int n_groups, group, npairs;
  __device__ int begin(int s) const {
    return lower_bound(group_slot, n_groups, s) * group;
  }
  __device__ int end(int s) const {
    return lower_bound(group_slot, n_groups, s + 1) * group;
  }
  __device__ bool pair(int, int t, int64_t& ia, int64_t& ib) const {
    const int p = src[t];
    if (p < 0 || p >= npairs) return false;  // padding position
    ia = pa[p];
    ib = pb[p];
    return true;
  }
  __device__ int64_t out_slot(int s) const { return ids ? ids[s] : s; }
};

struct Band {  // B6
  const int* __restrict__ sel;
  const int* __restrict__ a_idx;
  const int* __restrict__ b_idx;
  int wa, width, na, nb;
  __device__ int begin(int) const { return 0; }
  __device__ int end(int) const { return wa; }
  __device__ bool pair(int s, int w, int64_t& ia, int64_t& ib) const {
    const int pos = sel[s];
    const int64_t i = pos / width, c = pos % width;
    const int a = a_idx[i * wa + w];
    const int b = b_idx[(i * wa + w) * width + c];
    if (a >= na || b >= nb) return false;  // the zero tile
    ia = a;
    ib = b;
    return true;
  }
  __device__ int64_t out_slot(int s) const { return s; }
};

// -- f32 body: a register-blocked SIMT product with a two-stage ring --

// 16-byte copy global -> shared that bypasses the registers (and L1);
// src_bytes = 0 writes 16 zero bytes and reads nothing.
__device__ __forceinline__ void cp_async16(float* smem, const float* gmem,
                                           int src_bytes) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(gmem), "r"(src_bytes));
}

// The same for one float (rows that are not 16-byte aligned).
__device__ __forceinline__ void cp_async4(float* smem, const float* gmem,
                                          int src_bytes) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(gmem), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// As column of (k, row): rows XOR-swizzled by k / 4, so that the
// transposed store of A (a warp writes 8 rows x 4 k-quads) hits 32
// distinct banks, while each aligned group of 4 rows stays contiguous
// for the float4 reads.
__device__ __forceinline__ int swz(int k, int row) {
  return row ^ (((k >> 2) & 3) << 3);
}

// f32 payloads: full-f32 FMA on the CUDA cores (never TF32). The CTA owns
// a TILE x TILE output sub-tile (TILE = 128 for bs >= 128, else 64) and
// 256 threads in a 16 x 16 grid; thread (ty, tx) owns G x G groups of
// 4 x 4 outputs (G = TILE / 64): rows g * 64 + ty * 4 + i, columns
// h * 64 + tx * 4 + j, so every shared-memory read is a conflict-free
// float4 (four LDS.128 feed 64 FFMA at TILE = 128).
//
// The k loop runs over (pair, k-chunk) steps flattened across the slot's
// pairs, so the next pair's first chunk is in flight while the current
// pair's last chunk computes. Shared memory is a ring of two k-chunks of
// F_BK: while step i computes from one stage, step i + 1's chunks are
// copied by cp.async (16 bytes a copy where VEC, 4 elsewhere, zero-filled
// out of bounds): B into the other stage, A row-major into a staging
// chunk, from which each thread stores the 16 bytes it copied into the
// other stage transposed (k-major, swizzled) once its copies have landed.
// cp.async cannot transpose; staging A in shared memory rather than in
// registers lets the 128 x 128 instance fit 128 registers, 2 CTAs an SM
// (measured 3-10% faster than A through registers at 1 CTA an SM). One
// __syncthreads a step. Each output's FMA chain runs over the slot's
// pairs in table order, then k ascending. VEC: bs % 4 == 0 and A, B and
// out 16-byte aligned (without it the 128 x 128 instance needs more
// registers and runs 1 CTA an SM).
template <class Pairs, int TILE, bool VEC>
__global__ void __launch_bounds__(F_THREADS, TILE == 128 ? (VEC ? 2 : 1) : 3)
spgemm_f32_kernel(const float* __restrict__ A, const float* __restrict__ B,
                  float* __restrict__ out, Pairs P, int bs, int nsub) {
  constexpr int G = TILE / 64;
  constexpr int M = 4 * G;                         // outputs a thread, a side
  constexpr int NQ = TILE * F_BK / 4 / F_THREADS;  // float4s a thread a chunk
  constexpr int BQ = TILE / 4;                     // float4s in a B row
  __shared__ __align__(16) float As[2][F_BK][TILE];  // k-major, swizzled
  __shared__ __align__(16) float Bs[2][F_BK][TILE];
  __shared__ __align__(16) float Ast[TILE][F_BK];    // A chunk, row-major
  const int tid = threadIdx.x;
  const int per_slot = nsub * nsub;
  const int s = (int)(blockIdx.x / per_slot);
  const int sub = (int)(blockIdx.x % per_slot);
  const int r0 = (sub / nsub) * TILE, c0 = (sub % nsub) * TILE;
  const int t_end = P.end(s);
  const int64_t tile = (int64_t)bs * bs;
  const int ty = tid / 16, tx = tid % 16;
  const int a_row = tid / 4, a_k = (tid % 4) * 4;  // + q * 64 rows

  float acc[M][M];
#pragma unroll
  for (int i = 0; i < M; ++i)
#pragma unroll
    for (int j = 0; j < M; ++j) acc[i][j] = 0.0f;

  // A rows r0 + a_row + q * 64, columns k0 + a_k .. + 3, into Ast
  auto load_a = [&](const float* at, int k0) {
#pragma unroll
    for (int q = 0; q < NQ; ++q) {
      const int r = r0 + a_row + q * 64, k = k0 + a_k;
      const float* src = at + (int64_t)r * bs + k;
      float* dst = &Ast[a_row + q * 64][a_k];
      if constexpr (VEC) {
        const bool ok = r < bs && k < bs;
        cp_async16(dst, ok ? src : at, ok ? 16 : 0);
      } else {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const bool ok = r < bs && k + i < bs;
          cp_async4(dst + i, ok ? src + i : at, ok ? 4 : 0);
        }
      }
    }
  };
  // this thread's Ast segments into stage st: As[st][k][swz(k, row)]
  auto store_a = [&](int st) {
#pragma unroll
    for (int q = 0; q < NQ; ++q) {
      const int r = a_row + q * 64;
      const float4 v = *reinterpret_cast<const float4*>(&Ast[r][a_k]);
      As[st][a_k + 0][swz(a_k, r)] = v.x;
      As[st][a_k + 1][swz(a_k, r)] = v.y;
      As[st][a_k + 2][swz(a_k, r)] = v.z;
      As[st][a_k + 3][swz(a_k, r)] = v.w;
    }
  };
  // B rows k0 .. k0 + F_BK, columns c0 .. c0 + TILE, into stage st
  auto load_b = [&](const float* bt, int k0, int st) {
#pragma unroll
    for (int q = 0; q < NQ; ++q) {
      const int idx = tid + q * F_THREADS;
      const int row = idx / BQ, col = (idx % BQ) * 4;
      const int k = k0 + row, c = c0 + col;
      const float* src = bt + (int64_t)k * bs + c;
      float* dst = &Bs[st][row][col];
      if constexpr (VEC) {
        const bool ok = k < bs && c < bs;
        cp_async16(dst, ok ? src : bt, ok ? 16 : 0);
      } else {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const bool ok = k < bs && c + i < bs;
          cp_async4(dst + i, ok ? src + i : bt, ok ? 4 : 0);
        }
      }
    }
    cp_async_commit();
  };

  int t = P.begin(s), k0 = 0;
  int64_t ia = 0, ib = 0;
  bool live = next_live(P, s, t, t_end, ia, ib);
  if (live) {
    load_a(A + ia * tile, 0);
    load_b(B + ib * tile, 0, 0);
    cp_async_wait_all();
    store_a(0);
    __syncthreads();
    int st = 0;
    while (true) {
      // the next step: the next k-chunk, or the next live pair's first
      k0 += F_BK;
      if (k0 >= bs) {
        k0 = 0;
        ++t;
        live = next_live(P, s, t, t_end, ia, ib);  // uniform for the CTA
      }
      if (live) {
        load_a(A + ia * tile, k0);
        load_b(B + ib * tile, k0, st ^ 1);
      }
#pragma unroll
      for (int kk = 0; kk < F_BK; ++kk) {
        float a[M], b[M];
#pragma unroll
        for (int g = 0; g < G; ++g) {
          const float4 v = *reinterpret_cast<const float4*>(
              &As[st][kk][g * 64 + swz(kk, ty * 4)]);
          a[4 * g] = v.x; a[4 * g + 1] = v.y;
          a[4 * g + 2] = v.z; a[4 * g + 3] = v.w;
        }
#pragma unroll
        for (int h = 0; h < G; ++h) {
          const float4 v = *reinterpret_cast<const float4*>(
              &Bs[st][kk][h * 64 + tx * 4]);
          b[4 * h] = v.x; b[4 * h + 1] = v.y;
          b[4 * h + 2] = v.z; b[4 * h + 3] = v.w;
        }
#pragma unroll
        for (int i = 0; i < M; ++i)
#pragma unroll
          for (int j = 0; j < M; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      }
      if (!live) break;
      cp_async_wait_all();
      store_a(st ^ 1);
      __syncthreads();
      st ^= 1;
    }
  }

  float* o = out + P.out_slot(s) * tile;
#pragma unroll
  for (int g = 0; g < G; ++g)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = r0 + g * 64 + ty * 4 + i;
      if (r >= bs) continue;
#pragma unroll
      for (int h = 0; h < G; ++h) {
        const int c = c0 + h * 64 + tx * 4;
        float* dst = o + (int64_t)r * bs + c;
        if constexpr (VEC) {
          if (c < bs)
            *reinterpret_cast<float4*>(dst) = make_float4(
                acc[4 * g + i][4 * h], acc[4 * g + i][4 * h + 1],
                acc[4 * g + i][4 * h + 2], acc[4 * g + i][4 * h + 3]);
        } else {
#pragma unroll
          for (int j = 0; j < 4; ++j)
            if (c + j < bs) dst[j] = acc[4 * g + i][4 * h + j];
        }
      }
    }
}

template <class Pairs, int TILE>
cudaError_t launch_f32(const float* A, const float* B, float* out,
                       const Pairs& P, long long n_slots, int bs, bool vec,
                       cudaStream_t st) {
  const long long nsub = (bs + TILE - 1) / TILE;
  const long long gx = n_slots * nsub * nsub;
  if (gx > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  if (vec)
    spgemm_f32_kernel<Pairs, TILE, true><<<(unsigned)gx, F_THREADS, 0, st>>>(
        A, B, out, P, bs, (int)nsub);
  else
    spgemm_f32_kernel<Pairs, TILE, false><<<(unsigned)gx, F_THREADS, 0, st>>>(
        A, B, out, P, bs, (int)nsub);
  return cudaGetLastError();
}

// bf16 payloads of the shapes the wgmma body does not take: WMMA
// 16x16x16 bf16 -> f32 on the tensor cores. Four warps in a 2 x 2
// arrangement, each owning a 32 x 32 quadrant.
template <class Pairs>
__global__ void __launch_bounds__(H_THREADS)
spgemm_bf16_kernel(const __nv_bfloat16* __restrict__ A,
                   const __nv_bfloat16* __restrict__ B,
                   __nv_bfloat16* __restrict__ out, Pairs P, int bs, int nsub,
                   int a_vec, int b_vec) {
  using namespace nvcuda;
  __shared__ __align__(32) __nv_bfloat16 As[BM][H_BK + 8];
  __shared__ __align__(32) __nv_bfloat16 Bs[H_BK][BN + 8];
  __shared__ __align__(32) float Cs[BM][BN + 4];
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int wm = warp / 2, wn = warp % 2;
  const int per_slot = nsub * nsub;
  const int s = (int)(blockIdx.x / per_slot);
  const int sub = (int)(blockIdx.x % per_slot);
  const int r0 = (sub / nsub) * BM, c0 = (sub % nsub) * BN;
  const int t_begin = P.begin(s), t_end = P.end(s);
  const int64_t tile = (int64_t)bs * bs;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

  for (int t = t_begin; t < t_end; ++t) {
    int64_t ia, ib;
    if (!P.pair(s, t, ia, ib)) continue;            // uniform for the CTA
    const __nv_bfloat16* at = A + ia * tile;
    const __nv_bfloat16* bt = B + ib * tile;
    for (int k0 = 0; k0 < bs; k0 += H_BK) {
#pragma unroll
      for (int q = 0; q < 2; ++q) {           // A: 64 rows x 4 segments of 8
        const int seg = tid + q * H_THREADS;
        const int r = seg / 4, c = (seg % 4) * 8;
        const int rl = r0 + r;
        const bool ok = rl < bs;
        __nv_bfloat16 v[8];
        load_seg<__nv_bfloat16, 8>(v, ok ? at + (int64_t)rl * bs : nullptr,
                                   k0 + c, bs, ok, a_vec);
#pragma unroll
        for (int i = 0; i < 8; ++i) As[r][c + i] = v[i];
      }
#pragma unroll
      for (int q = 0; q < 2; ++q) {           // B: 32 rows x 8 segments of 8
        const int seg = tid + q * H_THREADS;
        const int r = seg / 8, c = (seg % 8) * 8;
        const int kr = k0 + r;
        const bool ok = kr < bs;
        __nv_bfloat16 v[8];
        load_seg<__nv_bfloat16, 8>(v, ok ? bt + (int64_t)kr * bs : nullptr,
                                   c0 + c, bs, ok, b_vec);
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
  __nv_bfloat16* o = out + P.out_slot(s) * tile;
  for (int idx = tid; idx < BM * BN; idx += H_THREADS) {
    const int r = r0 + idx / BN, c = c0 + idx % BN;
    if (r < bs && c < bs)
      o[(int64_t)r * bs + c] = __float2bfloat16(Cs[idx / BN][idx % BN]);
  }
}

// The wgmma body over n_slots output slots: A and B as 3-D tensor maps
// of n_a and n_b tiles.
template <class Pairs>
int launch_wgmma(const void* A, const void* B, void* out, const Pairs& P,
                 long long n_slots, long long n_a, long long n_b, int bs,
                 cudaStream_t s) {
  namespace tw = tile_wgmma;
  if (!tw::shape_ok(bs) || n_a < 1 || n_b < 1 || !tw::aligned16(A) ||
      !tw::aligned16(B) || !tw::aligned16(out))
    return (int)cudaErrorInvalidValue;
  CUtensorMap map_a, map_b;
  int rc = tw::encode_tiles(&map_a, A, n_a, bs, tw::BM);
  if (rc == 0) rc = tw::encode_tiles(&map_b, B, n_b, bs, tw::BK);
  if (rc != 0) return rc;
  return tw::launch<Pairs, false>(map_a, map_b,
                                  static_cast<__nv_bfloat16*>(out), P,
                                  n_slots, bs, bs, bs, s);
}

// One launch over n_slots output slots; dtype 0 = float32, 1 = bfloat16
// (WMMA body), 2 = bfloat16 (wgmma body). Returns cudaGetLastError(), or
// tile_wgmma::ENCODE_FAILED + the CUresult of a tensor map that could not
// be encoded.
template <class Pairs>
int launch(const void* A, const void* B, void* out, const Pairs& P,
           long long n_slots, long long n_a, long long n_b, int bs, int dtype,
           int a_vec, int b_vec, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (bs <= 0 || n_slots <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    const float* a = static_cast<const float*>(A);
    const float* b = static_cast<const float*>(B);
    float* o = static_cast<float*>(out);
    const bool vec = a_vec && b_vec && bs % 4 == 0 &&
                     reinterpret_cast<uintptr_t>(o) % 16 == 0;
    return (int)(bs >= 128
                     ? launch_f32<Pairs, 128>(a, b, o, P, n_slots, bs, vec, s)
                     : launch_f32<Pairs, 64>(a, b, o, P, n_slots, bs, vec, s));
  }
  if (dtype == 2) return launch_wgmma(A, B, out, P, n_slots, n_a, n_b, bs, s);
  const long long nsub = (bs + BM - 1) / BM;
  const long long gx = n_slots * nsub * nsub;
  if (gx > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  if (dtype == 1) {
    spgemm_bf16_kernel<Pairs><<<(unsigned)gx, H_THREADS, 0, s>>>(
        static_cast<const __nv_bfloat16*>(A),
        static_cast<const __nv_bfloat16*>(B),
        static_cast<__nv_bfloat16*>(out), P, bs, (int)nsub, a_vec, b_vec);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (WMMA body), 2 = bfloat16 (wgmma
// body). Each entry point launches on `stream` and returns 0 or an error
// code (launch above); none synchronises. Index tables are int32 device
// arrays; A and B hold n_a and n_b tiles.

// B4: n_out slots, pairs slot_ptr[s] .. slot_ptr[s+1] of pa / pb.
extern "C" int matrel_spgemm_pairs(const void* A, const void* B, void* out,
                                   const void* slot_ptr, const void* pa,
                                   const void* pb, long long n_out,
                                   long long n_a, long long n_b, int bs,
                                   int dtype, int a_vec, int b_vec, int device,
                                   void* stream) {
  const PairRuns P{static_cast<const int*>(slot_ptr),
                   static_cast<const int*>(pa), static_cast<const int*>(pb)};
  return launch(A, B, out, P, n_out, n_a, n_b, bs, dtype, a_vec, b_vec,
                device, stream);
}

// B5 (ids null: local slot = output slot) and B7's bucket launches (ids:
// local slot -> output slot of an out stack of out_tiles tiles).
extern "C" int matrel_spgemm_grouped(const void* A, const void* B, void* out,
                                     const void* src, const void* group_slot,
                                     const void* pa, const void* pb,
                                     const void* ids, long long n_slots,
                                     long long n_a, long long n_b,
                                     int n_groups, int group, int npairs,
                                     int out_tiles, int bs, int dtype,
                                     int a_vec, int b_vec, int device,
                                     void* stream) {
  if (group < 1 || n_groups < 1) return (int)cudaErrorInvalidValue;
  if (ids == nullptr && n_slots > out_tiles) return (int)cudaErrorInvalidValue;
  const Grouped P{static_cast<const int*>(src),
                  static_cast<const int*>(group_slot),
                  static_cast<const int*>(pa), static_cast<const int*>(pb),
                  static_cast<const int*>(ids), n_groups, group, npairs};
  return launch(A, B, out, P, n_slots, n_a, n_b, bs, dtype, a_vec, b_vec,
                device, stream);
}

// B6: n_out slots at band positions sel; a_idx [gr * wa], b_idx
// [gr * wa * width]; index na / nb is the zero tile.
extern "C" int matrel_spgemm_band(const void* A, const void* B, void* out,
                                  const void* sel, const void* a_idx,
                                  const void* b_idx, long long n_out, int wa,
                                  int width, int na, int nb, int bs, int dtype,
                                  int a_vec, int b_vec, int device,
                                  void* stream) {
  if (wa < 1 || width < 1) return (int)cudaErrorInvalidValue;
  const Band P{static_cast<const int*>(sel), static_cast<const int*>(a_idx),
               static_cast<const int*>(b_idx), wa, width, na, nb};
  return launch(A, B, out, P, n_out, na, nb, bs, dtype, a_vec, b_vec, device,
                stream);
}
