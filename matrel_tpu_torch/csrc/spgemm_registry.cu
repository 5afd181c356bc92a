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
// f32 design (B4-B7 share it with B1's wide launches): the
// register-blocked SIMT body of f32_tile_simt.cuh — 8 x 8 outputs a
// thread, a 128 x 128 sub-tile for bs >= 128, a two-stage cp.async ring
// flattened over the slot's pairs — over B's tiles (TileOperands).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <mma.h>
#include <stdint.h>

#include "bf16_tile_wgmma.cuh"
#include "f32_tile_simt.cuh"

namespace {

constexpr int BM = 64;          // bf16: output sub-tile rows per CTA
constexpr int BN = 64;          // bf16: output sub-tile columns per CTA
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
    return (int)tile_f32::launch(a, b, o, P, tile_f32::TileOperands{},
                                 n_slots, bs, bs, vec, s);
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
