// The f32 tile body of the block-sparse kernels on Hopper (sm_90a): one
// CTA sums, in full f32 on the CUDA cores (never TF32), the products of a
// list of (A tile, B panel) pairs into one TILE x TILE output sub-tile.
// Shared by the S×S tile SpGEMM B4-B7 (spgemm_registry.cu: out[slot] =
// sum A[ia] @ B[ib], matrel_tpu/ops/kernel_registry.py::_make_pair_kernel
// and the grouped, band and bucketed kernels built on the same pair walk)
// and by B1's wide launches (spmm_blocksparse.cu: Y = S · D for D wider
// than the narrow body takes, matrel_tpu/ops/pallas_spmm.py::_make_kernel).
// The counterpart of Precision.HIGHEST in both TPU kernels.
//
// What bounds it. Exact f32 rules out the tensor cores, so a product of
// bs = 512 tiles (256 operations per byte even if every tile were read
// once per pair) is bound by FMA issue on the CUDA cores: 67 TFLOP/s on
// an H100 SXM. cuBLAS's own f32 FFMA GEMM reaches ~53 on this card
// (PERF.md).
//
// Design.
// - A thread holds 8 x 8 outputs as 2 x 2 groups of 4 x 4 (4 LDS.128
//   feed 64 FFMA); a 128 x 128 sub-tile re-reads each A tile and B panel
//   once per sub-tile row or column (4 times at bs = 512), from L2.
// - The k loop runs over (pair, k-chunk) steps flattened across the
//   slot's pairs, with a two-stage shared-memory ring: while one step
//   computes, the next step's chunks are copied by cp.async, so the ring
//   does not drain between pairs.
// - The pair list is a policy (Pairs: begin / end / pair, as in
//   bf16_tile_wgmma.cuh). Where B and the output live is a second policy
//   (Operands below): B4-B7's stacks of bs x bs tiles (TileOperands), or
//   B1's dense D [k_rows, pm] and output [out_rows, pm] (DenseOperands),
//   whose slot s is block row s and whose pair (t, cb) reads D's row
//   block cb * bs ... Each gives B's row stride (also the output's, and
//   its columns), the rows of a panel that exist and the rows of a slot's
//   output that exist; what lies past them is zero-filled at the copies
//   and masked at the store.
// - Every output's FMA chain runs over the slot's pairs in list order,
//   then k ascending: the result is the same on every run.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "bf16_tile_wgmma.cuh"  // tile_wgmma::next_live, the pair walk

namespace tile_f32 {

constexpr int BK = 16;        // k-chunk a ring stage
constexpr int THREADS = 256;  // 16 x 16 threads

// -- operand policies ---------------------------------------------------------

// Each policy is given the kernel's bs, so that B4-B7's (every extent
// bs) compiles to the same index arithmetic, and the same registers, as
// a body written for tiles alone. Strides and extents are ints (the
// launch checks pm); offsets are 64-bit. kPanelPerPair: the body works
// out the current pair's A tile and B panel once a pair (DenseOperands)
// or again every step (TileOperands) — for each, the choice that keeps
// its 128 x 128 VEC instance within 128 registers (ptxas, H100 build).

// B4-B7: B is a stack of bs x bs tiles; the output is a stack of tiles,
// slot s writing tile P.out_slot(s).
struct TileOperands {
  static constexpr bool kPanelPerPair = false;
  __device__ int ldb(int bs) const { return bs; }
  __device__ int64_t b_offset(int64_t ib, int bs) const {
    return ib * bs * bs;
  }
  __device__ int b_rows(int64_t, int bs) const { return bs; }
  __device__ int cols(int bs) const { return bs; }
  __device__ int64_t out_offset(int64_t slot, int bs) const {
    return slot * bs * bs;
  }
  __device__ int out_rows(int64_t, int bs) const { return bs; }
};

// B1: B is D [k_rows, pm]; pair (t, cb) reads its rows cb * bs .. + bs
// (past k_rows: zero). The output is [out_rows, pm]; slot s is block row
// s (rows past out_rows are not written).
struct DenseOperands {
  static constexpr bool kPanelPerPair = true;
  int pm;
  int64_t k_rows, y_rows;     // D's rows, the output's rows
  __device__ int ldb(int) const { return pm; }
  __device__ int64_t b_offset(int64_t cb, int bs) const {
    return cb * bs * pm;
  }
  __device__ int b_rows(int64_t cb, int bs) const {
    const int64_t left = k_rows - cb * bs;
    return left <= 0 ? 0 : (left < bs ? (int)left : bs);
  }
  __device__ int cols(int) const { return pm; }
  __device__ int64_t out_offset(int64_t slot, int bs) const {
    return slot * bs * pm;
  }
  __device__ int out_rows(int64_t slot, int bs) const {
    const int64_t left = y_rows - slot * bs;
    return left <= 0 ? 0 : (left < bs ? (int)left : bs);
  }
};

// -- copies -------------------------------------------------------------------

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

// -- the body -----------------------------------------------------------------

// The CTA owns a TILE x TILE output sub-tile (TILE = 128 or 64) of slot s
// and 256 threads in a 16 x 16 grid; thread (ty, tx) owns G x G groups
// of 4 x 4 outputs (G = TILE / 64): rows g * 64 + ty * 4 + i, columns
// h * 64 + tx * 4 + j, so every shared-memory read is a conflict-free
// float4 (four LDS.128 feed 64 FFMA at TILE = 128).
//
// Shared memory is a ring of two k-chunks of BK: while step i computes
// from one stage, step i + 1's chunks are copied by cp.async (16 bytes a
// copy where VEC, 4 elsewhere, zero-filled out of bounds): B into the
// other stage, A row-major into a staging chunk, from which each thread
// stores the 16 bytes it copied into the other stage transposed (k-major,
// swizzled) once its copies have landed. cp.async cannot transpose;
// staging A in shared memory rather than in registers lets the 128 x 128
// instance fit 128 registers, 2 CTAs an SM (measured 3-10% faster than A
// through registers at 1 CTA an SM). One __syncthreads a step. VEC: bs
// and B's row stride a multiple of 4 and A, B and out 16-byte aligned
// (without it the 128 x 128 instance needs more registers and runs 1 CTA
// an SM). grid = n_slots * sub_rows * sub_cols.
template <class Pairs, class Operands, int TILE, bool VEC>
__global__ void __launch_bounds__(THREADS, TILE == 128 ? (VEC ? 2 : 1) : 3)
f32_tile_kernel(const float* __restrict__ A, const float* __restrict__ B,
                float* __restrict__ out, Pairs P, Operands O, int bs,
                int sub_rows, int sub_cols) {
  constexpr int G = TILE / 64;
  constexpr int M = 4 * G;                       // outputs a thread, a side
  constexpr int NQ = TILE * BK / 4 / THREADS;    // float4s a thread a chunk
  constexpr int BQ = TILE / 4;                   // float4s in a B row
  __shared__ __align__(16) float As[2][BK][TILE];  // k-major, swizzled
  __shared__ __align__(16) float Bs[2][BK][TILE];
  __shared__ __align__(16) float Ast[TILE][BK];    // A chunk, row-major
  const int tid = threadIdx.x;
  const int per_slot = sub_rows * sub_cols;
  const int s = (int)(blockIdx.x / per_slot);
  const int sub = (int)(blockIdx.x % per_slot);
  const int r0 = (sub / sub_cols) * TILE, c0 = (sub % sub_cols) * TILE;
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
  // B rows k0 .. k0 + BK (of the panel's b_rows), columns c0 .. c0 +
  // TILE, into stage st
  auto load_b = [&](const float* bt, int b_rows, int k0, int st) {
#pragma unroll
    for (int q = 0; q < NQ; ++q) {
      const int idx = tid + q * THREADS;
      const int row = idx / BQ, col = (idx % BQ) * 4;
      const int k = k0 + row, c = c0 + col;
      const float* src = bt + (int64_t)k * O.ldb(bs) + c;
      float* dst = &Bs[st][row][col];
      if constexpr (VEC) {
        const bool ok = k < b_rows && c < O.cols(bs);
        cp_async16(dst, ok ? src : B, ok ? 16 : 0);
      } else {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const bool ok = k < b_rows && c + i < O.cols(bs);
          cp_async4(dst + i, ok ? src + i : B, ok ? 4 : 0);
        }
      }
    }
    cp_async_commit();
  };

  // the current pair's A tile, B panel and B rows (Operands::kPanelPerPair)
  const float* at = A;
  const float* bt = B;
  int b_rows = 0;
  int64_t ia = 0, ib = 0;
  auto panel = [&] {
    at = A + ia * tile;
    bt = B + O.b_offset(ib, bs);
    b_rows = O.b_rows(ib, bs);
  };
  // step k0's copies into stage st
  auto load = [&](int k0, int st) {
    if constexpr (!Operands::kPanelPerPair) panel();
    load_a(at, k0);
    load_b(bt, b_rows, k0, st);
  };

  int t = P.begin(s), k0 = 0;
  bool live = tile_wgmma::next_live(P, s, t, t_end, ia, ib);
  if (live) {
    if constexpr (Operands::kPanelPerPair) panel();
    load(0, 0);
    cp_async_wait_all();
    store_a(0);
    __syncthreads();
    int st = 0;
    while (true) {
      // the next step: the next k-chunk, or the next live pair's first
      k0 += BK;
      if (k0 >= bs) {
        k0 = 0;
        ++t;
        live = tile_wgmma::next_live(P, s, t, t_end, ia, ib);  // uniform
        if constexpr (Operands::kPanelPerPair)
          if (live) panel();
      }
      if (live) load(k0, st ^ 1);
#pragma unroll
      for (int kk = 0; kk < BK; ++kk) {
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

  const int64_t slot = P.out_slot(s);
  const int rows = O.out_rows(slot, bs);
  const int ldo = O.ldb(bs);                    // the output's columns too
  const int ncols = O.cols(bs);
  float* o = out + O.out_offset(slot, bs);
#pragma unroll
  for (int g = 0; g < G; ++g)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = r0 + g * 64 + ty * 4 + i;
      if (r >= rows) continue;
#pragma unroll
      for (int h = 0; h < G; ++h) {
        const int c = c0 + h * 64 + tx * 4;
        float* dst = o + (int64_t)r * ldo + c;
        if constexpr (VEC) {
          if (c < ncols)
            *reinterpret_cast<float4*>(dst) = make_float4(
                acc[4 * g + i][4 * h], acc[4 * g + i][4 * h + 1],
                acc[4 * g + i][4 * h + 2], acc[4 * g + i][4 * h + 3]);
        } else {
#pragma unroll
          for (int j = 0; j < 4; ++j)
            if (c + j < ncols) dst[j] = acc[4 * g + i][4 * h + j];
        }
      }
    }
}

// One launch over n_slots slots: TILE = 128 where both the slot's rows
// (bs) and the output's columns reach it, else 64. vec: see VEC above.
template <class Pairs, class Operands>
cudaError_t launch(const float* A, const float* B, float* out,
                   const Pairs& P, const Operands& O, long long n_slots,
                   int bs, long long cols, bool vec, cudaStream_t st) {
  const bool wide = bs >= 128 && cols >= 128;
  const int tile = wide ? 128 : 64;
  const long long sub_rows = (bs + tile - 1) / tile;
  const long long sub_cols = (cols + tile - 1) / tile;
  const long long gx = n_slots * sub_rows * sub_cols;
  if (gx <= 0 || gx > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  const dim3 grid((unsigned)gx);
  const int sr = (int)sub_rows, sc = (int)sub_cols;
  if (wide && vec)
    f32_tile_kernel<Pairs, Operands, 128, true><<<grid, THREADS, 0, st>>>(
        A, B, out, P, O, bs, sr, sc);
  else if (wide)
    f32_tile_kernel<Pairs, Operands, 128, false><<<grid, THREADS, 0, st>>>(
        A, B, out, P, O, bs, sr, sc);
  else if (vec)
    f32_tile_kernel<Pairs, Operands, 64, true><<<grid, THREADS, 0, st>>>(
        A, B, out, P, O, bs, sr, sc);
  else
    f32_tile_kernel<Pairs, Operands, 64, false><<<grid, THREADS, 0, st>>>(
        A, B, out, P, O, bs, sr, sc);
  return cudaGetLastError();
}

}  // namespace tile_f32
