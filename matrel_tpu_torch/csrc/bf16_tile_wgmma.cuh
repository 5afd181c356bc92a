// The bf16 tile body of the block-sparse kernels on Hopper (sm_90a):
// one CTA sums, in f32, the products of a list of (A tile, B panel) steps
// into one 128 x 256 output sub-tile, with wgmma fed by TMA through a
// shared-memory ring. Shared by B1 (spmm_blocksparse.cu: Y = S · D, the
// TPU kernel matrel_tpu/ops/pallas_spmm.py::_make_kernel) and by the
// S×S tile SpGEMM B4-B7 (spgemm_registry.cu: out[slot] = sum A[ia] @
// B[ib], matrel_tpu/ops/kernel_registry.py::_make_pair_kernel and the
// grouped, band and bucketed kernels built on the same pair walk).
//
// What bounds it. At bs = 512 a step (one 64-deep k-chunk of one A tile
// against one B panel) does 2 * 128 * 256 * 64 = 4.2 MFLOP on 48 KB read
// through L2, so a CTA needs ~85 operations per L2 byte, and the card
// (989 TFLOP/s bf16) is held by how fast L2 feeds the SMs and by keeping
// the tensor cores busy while the next chunk lands. At BASELINE row 4
// (B1) and at the S×S 1% random bf16 deployment (B4) the whole kernel's
// bound (each input once, output once) is bytes, ~0.1-0.2 ms.
//
// Design.
// - One CTA computes one BM x BN = 128 x 256 output sub-tile (at bs 512:
//   4 x 2 CTAs a slot). It sums a list of steps given by a pair-list
//   policy (P.begin / P.end / P.pair: B1's CSR walk over the block row's
//   tiles, B4's pair runs, B5's groups with padding skipped, B6's band
//   with the zero tile skipped), flattened into one cursor over (pair,
//   k-chunk), so the ring does not drain between pairs.
// - Warpgroup 0 is the producer: one thread issues the TMA loads of each
//   step, A's 128 x 64 box and B's four 64 x 64 boxes (48 KB), into a
//   ring of STAGES stages with the 128-byte swizzle, each stage guarded by
//   a full / empty mbarrier pair. A is a 3-D map [tiles, bs, bs]; B is a
//   3-D map of tiles (B4-B7) or B1's dense D as a 2-D map [k_rows, pm]
//   whose box starts at row ib * bs + k0. TMA zero-fills what lies past a
//   map's bounds: rows past bs or k_rows, columns past bs or pm.
// - Warpgroups 1 and 2 are the consumers, 64 output rows each: per step
//   four wgmma m64n256k16 bf16 x bf16 -> f32 from shared memory, A K-major
//   and B N-major (wgmma's transposed-B form, no transposing copy), the
//   sum in 128 f32 registers a thread. One wgmma group stays in flight:
//   a stage is released once the group that read it has completed.
//   setmaxnreg moves registers from the producer (40) to the consumers
//   (232).
// - Epilogue: each consumer rounds its f32 sum to bf16 once, stages it in
//   the (then idle) ring and stores it with 16-byte writes, masking rows
//   past bs or out_rows and columns past bs or pm.
// - Which shapes take it (shape_ok, and the Python function
//   ops/tile_body.py::bf16_body that decides before the launch): bs a
//   power of two >= 64, so the 64-deep k-chunks divide bs and the
//   128-row and 256-column sub-tiles either divide it or hold all of it;
//   output and D rows a multiple of 16 bytes; every base pointer 16-byte
//   aligned (TMA and the 16-byte stores need it). Other bf16 shapes run
//   the WMMA body of each .cu file.

#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace tile_wgmma {

constexpr int BM = 128;                   // output rows a CTA (2 x 64)
constexpr int BN = 256;                   // output columns a CTA
constexpr int BK = 64;                    // k-chunk: 128 bytes of bf16
constexpr int STAGES = 4;
constexpr int THREADS = 384;              // producer + two consumer groups
constexpr int A_BYTES = BM * BK * 2;      // 16 KB
constexpr int B_BOX_BYTES = BK * 64 * 2;  // one 64 x 64 box of B, 8 KB
constexpr int B_BYTES = (BN / 64) * B_BOX_BYTES;
constexpr int STAGE_BYTES = A_BYTES + B_BYTES;
constexpr int EPI_PITCH = BN * 2 + 16;    // bytes a staged output row
constexpr int SMEM_BYTES = STAGES * STAGE_BYTES + 2 * STAGES * 8 + 1024;
static_assert(2 * 64 * EPI_PITCH <= STAGES * STAGE_BYTES,
              "the epilogue stages its output in the ring");

// Codes of the C entry points beyond cudaError_t: a tensor map that could
// not be encoded (ENCODE_FAILED + its CUresult).
constexpr int ENCODE_FAILED = 10000;

__host__ __device__ inline bool shape_ok(int bs) {
  return bs >= 64 && (bs & (bs - 1)) == 0;
}

inline bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

// -- device helpers ----------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// Wait until the phase of parity `parity` of the barrier has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n.reg .pred P1;\nLAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@!P1 bra LAB_WAIT;\n}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}

__device__ __forceinline__ void tma_2d(uint32_t dst, const CUtensorMap* map,
                                       uint32_t bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

__device__ __forceinline__ void tma_3d(uint32_t dst, const CUtensorMap* map,
                                       uint32_t bar, int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2)
      : "memory");
}

// Shared-memory matrix descriptor, 128-byte swizzle: start address, leading
// and stride byte offsets (all >> 4), layout type 1 in bits 62-63. The
// ring stages are 1024-byte aligned, so the base offset is 0.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keeps the compiler from moving the accumulators across the asynchronous
// products.
__device__ __forceinline__ void fence_acc(float (&d)[128]) {
#pragma unroll
  for (int i = 0; i < 128; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d += A (64 x 16, K-major) * B (16 x 256, N-major: imm-trans-b = 1).
__device__ __forceinline__ void wgmma_m64n256k16(float (&d)[128],
                                                 uint64_t desc_a,
                                                 uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, "
      "%104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]),
        "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]),
        "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]),
        "+f"(d[102]), "+f"(d[103]), "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]),
        "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]),
        "+f"(d[126]), "+f"(d[127])
      : "l"(desc_a), "l"(desc_b), "r"(1));
}

// The first position t' >= t of slot s with a pair to multiply (padding
// positions and the zero tile skipped), its tiles in ia / ib; false when
// the slot has none left. The same for every thread of the CTA.
template <class Pairs>
__device__ __forceinline__ bool next_live(const Pairs& P, int s, int& t,
                                          int t_end, int64_t& ia,
                                          int64_t& ib) {
  for (; t < t_end; ++t)
    if (P.pair(s, t, ia, ib)) return true;
  return false;
}

// grid = n_slots * row_subs * col_subs; CTA (s, row sub-tile, column
// sub-tile). DENSE_B: B1, map_b is D [k_rows, pm] and slot s is block row
// s of out [out_rows, out_cols = pm]; else B4-B7, map_b holds B's tiles
// and slot s writes tile P.out_slot(s) of out [*, bs, bs].
template <class Pairs, bool DENSE_B>
__global__ void __launch_bounds__(THREADS, 1)
bf16_wgmma_kernel(const __grid_constant__ CUtensorMap map_a,
                  const __grid_constant__ CUtensorMap map_b,
                  __nv_bfloat16* __restrict__ out, Pairs P, int bs,
                  int row_subs, int col_subs, long long out_rows,
                  long long out_cols) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  uint8_t* ring = smem_raw + ((1024 - (raw & 1023)) & 1023);
  const uint32_t ring_u32 = smem_u32(ring);
  const uint32_t bars = ring_u32 + STAGES * STAGE_BYTES;
  auto full = [&](int st) { return bars + 8 * st; };
  auto empty = [&](int st) { return bars + 8 * (STAGES + st); };

  const int per_slot = row_subs * col_subs;
  const int s = (int)(blockIdx.x / per_slot);
  const int sub = (int)(blockIdx.x % per_slot);
  const int r0 = (sub / col_subs) * BM, c0 = (sub % col_subs) * BN;
  const int wg = threadIdx.x / 128;
  if (threadIdx.x == 0) {
#pragma unroll
    for (int st = 0; st < STAGES; ++st) {
      mbar_init(full(st), 1);
      mbar_init(empty(st), 8);            // the consumers' 8 warps
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const int chunks = bs / BK;
  const int t_begin = P.begin(s), t_end = P.end(s);

  if (wg == 0) {
    // producer: one thread keeps the ring full
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == 0) {
      int st = 0;
      uint32_t phase = 1;                 // a fresh stage is empty
      int t = t_begin;
      int64_t ia = 0, ib = 0;
      while (next_live(P, s, t, t_end, ia, ib)) {
        for (int kc = 0; kc < chunks; ++kc) {
          mbar_wait(empty(st), phase);
          mbar_expect_tx(full(st), STAGE_BYTES);
          const uint32_t a_dst = ring_u32 + st * STAGE_BYTES;
          const uint32_t b_dst = a_dst + A_BYTES;
          tma_3d(a_dst, &map_a, full(st), kc * BK, r0, (int)ia);
#pragma unroll
          for (int j = 0; j < BN / 64; ++j) {
            if constexpr (DENSE_B)
              tma_2d(b_dst + j * B_BOX_BYTES, &map_b, full(st), c0 + 64 * j,
                     (int)(ib * bs + kc * BK));
            else
              tma_3d(b_dst + j * B_BOX_BYTES, &map_b, full(st), c0 + 64 * j,
                     kc * BK, (int)ib);
          }
          if (++st == STAGES) {
            st = 0;
            phase ^= 1;
          }
        }
        ++t;
      }
    }
    return;
  }

  // consumers: warpgroup cw owns output rows r0 + cw * 64 .. + 63
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
  const int cw = wg - 1;
  const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
  __nv_bfloat16* obase;
  long long rows_valid, cols_valid, ld;
  if constexpr (DENSE_B) {
    obase = out + (long long)s * bs * out_cols;
    rows_valid = out_rows - (long long)s * bs;
    if (rows_valid > bs) rows_valid = bs;
    cols_valid = ld = out_cols;
  } else {
    obase = out + P.out_slot(s) * (long long)bs * bs;
    rows_valid = cols_valid = ld = bs;
  }

  float d[128];
#pragma unroll
  for (int i = 0; i < 128; ++i) d[i] = 0.0f;
  {
    int st = 0, prev = -1;
    uint32_t phase = 0;
    int t = t_begin;
    int64_t ia = 0, ib = 0;
    while (next_live(P, s, t, t_end, ia, ib)) {
      for (int kc = 0; kc < chunks; ++kc) {
        mbar_wait(full(st), phase);
        const uint32_t a_addr = ring_u32 + st * STAGE_BYTES + cw * 64 * 128;
        const uint32_t b_addr = ring_u32 + st * STAGE_BYTES + A_BYTES;
        fence_acc(d);
        wgmma_fence();
        // Rows past bs (a group wholly past it at bs = 64) multiply
        // TMA's zero fill: no branch around the products, which would
        // make ptxas serialise them.
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk)
          // A: 8-row groups 1024 bytes apart, k advances 32 bytes; B:
          // 8-k-row groups 1024 bytes apart, 64-column boxes 8 KB apart
          wgmma_m64n256k16(d, smem_desc(a_addr + kk * 32, 16, 1024),
                           smem_desc(b_addr + kk * 2048, B_BOX_BYTES, 1024));
        wgmma_commit();
        fence_acc(d);
        wgmma_wait<1>();                  // the previous step's group is done
        fence_acc(d);
        if (prev >= 0 && lane == 0) mbar_arrive(empty(prev));
        prev = st;
        if (++st == STAGES) {
          st = 0;
          phase ^= 1;
        }
      }
      ++t;
    }
  }
  wgmma_wait<0>();
  fence_acc(d);

  // epilogue: round once to bf16, stage in the idle ring, 16-byte stores
  asm volatile("bar.sync 1, 256;\n" ::: "memory");  // both groups done
  uint8_t* stage = ring + cw * 64 * EPI_PITCH;
  const int fr = warp * 16 + lane / 4, fc = 2 * (lane % 4);
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    *reinterpret_cast<__nv_bfloat162*>(stage + fr * EPI_PITCH +
                                       (8 * j + fc) * 2) =
        __floats2bfloat162_rn(d[4 * j], d[4 * j + 1]);
    *reinterpret_cast<__nv_bfloat162*>(stage + (fr + 8) * EPI_PITCH +
                                       (8 * j + fc) * 2) =
        __floats2bfloat162_rn(d[4 * j + 2], d[4 * j + 3]);
  }
  asm volatile("bar.sync %0, 128;\n" ::"r"(2 + cw) : "memory");
#pragma unroll 4
  for (int i = 0; i < 64 * (BN / 8) / 128; ++i) {
    const int idx = tid + i * 128;
    const int row = idx / (BN / 8), ch = idx % (BN / 8);
    const long long r = r0 + cw * 64 + row, c = c0 + ch * 8;
    if (r < rows_valid && c < cols_valid)
      *reinterpret_cast<uint4*>(obase + r * ld + c) =
          *reinterpret_cast<const uint4*>(stage + row * EPI_PITCH + ch * 16);
  }
}

// -- host side ---------------------------------------------------------------

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType,
                                  cuuint32_t, void*, const cuuint64_t*,
                                  const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle, CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled looked up through the CUDA runtime (no -lcuda).
inline EncodeTiledFn encode_fn() {
  static EncodeTiledFn fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                            cudaEnableDefault, &q);
#endif
    return (e == cudaSuccess && q == cudaDriverEntryPointSuccess)
               ? reinterpret_cast<EncodeTiledFn>(p)
               : nullptr;
  }();
  return fn;
}

inline int encode(CUtensorMap* map, const void* base, cuuint32_t rank,
                  const cuuint64_t* dims, const cuuint64_t* strides,
                  const cuuint32_t* box) {
  const EncodeTiledFn fn = encode_fn();
  if (fn == nullptr) return ENCODE_FAILED + (int)CUDA_ERROR_NOT_FOUND;
  const cuuint32_t elem_strides[3] = {1, 1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, rank,
                        const_cast<void*>(base), dims, strides, box,
                        elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : ENCODE_FAILED + (int)r;
}

// A stack of n bf16 tiles [n, bs, bs], boxes of box_rows x 64.
inline int encode_tiles(CUtensorMap* map, const void* base, long long n,
                        int bs, int box_rows) {
  const cuuint64_t dims[3] = {(cuuint64_t)bs, (cuuint64_t)bs, (cuuint64_t)n};
  const cuuint64_t strides[2] = {(cuuint64_t)bs * 2, (cuuint64_t)bs * bs * 2};
  const cuuint32_t box[3] = {BK, (cuuint32_t)box_rows, 1};
  return encode(map, base, 3, dims, strides, box);
}

// A dense bf16 matrix [rows, cols], boxes of 64 x 64.
inline int encode_dense(CUtensorMap* map, const void* base, long long rows,
                        long long cols) {
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * 2};
  const cuuint32_t box[2] = {64, BK};
  return encode(map, base, 2, dims, strides, box);
}

// One launch over n_slots slots (DENSE_B: block rows); returns 0, a
// cudaError_t, or ENCODE_FAILED + CUresult from the caller's encodes.
template <class Pairs, bool DENSE_B>
int launch(const CUtensorMap& map_a, const CUtensorMap& map_b,
           __nv_bfloat16* out, const Pairs& P, long long n_slots, int bs,
           long long out_rows, long long out_cols, cudaStream_t stream) {
  auto kernel = bf16_wgmma_kernel<Pairs, DENSE_B>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  const long long row_subs = (bs + BM - 1) / BM;
  const long long col_subs = (out_cols + BN - 1) / BN;
  const long long gx = n_slots * row_subs * col_subs;
  if (gx <= 0 || gx > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  kernel<<<(unsigned)gx, THREADS, SMEM_BYTES, stream>>>(
      map_a, map_b, out, P, bs, (int)row_subs, (int)col_subs, out_rows,
      out_cols);
  return (int)cudaGetLastError();
}

}  // namespace tile_wgmma
