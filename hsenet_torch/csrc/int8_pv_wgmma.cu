// The P.V probe product for Hopper (sm_90a), redesigned around TMA and
// wgmma: out[g] = P[g] V[g] in f32. int8_pv.cu computes the same function
// with mma.sync and stays as the yardstick that chip_smoke.py times this
// kernel against.
//
// Replaces the TPU kernel `make_kernel(mode)` of the JAX package
// (scripts/_probe_pallas_int8.py). Per grid cell g, a (M, K) x (K, 64)
// product with f32 output in one of four modes:
//   0 bf16            P, V bf16; bf16 products summed in f32;
//   1 int8_pre        P, V int8; exact int32 sums, one conversion to f32;
//   2 quant_then_int8 P f32, V int8; P becomes rint(p * 127) as int8 (round
//                     half to even, saturated at the int8 range) as it is
//                     read, then as int8_pre;
//   3 glue_only       P f32; each row's sum of its quantised codes (exact
//                     integer sums), broadcast to the 64 columns.
//
// What bounds it on an H100 SXM (3.35 TB/s): bytes. At the probe's shapes
// (G 192, M 1152, K 2176) P is 481 M elements (0.96 GB in bf16, 0.48 GB in
// int8, 1.93 GB in f32) against 61.6 G operations (0.06 ms at the bf16
// peak). The work is streaming P once at the memory's rate. The mma.sync
// kernel (int8_pv.cu) lost that rate three ways: every 64-row CTA read all
// of V[g] (18 reads of V per g, as many bytes as P in bf16), it transposed
// V into shared memory element by element, and it prefetched P one tile
// deep in registers.
//
// Design:
//   * one CTA per (row block, g), blockIdx.x fastest, so the CTAs that
//     share V[g] run together and read it from L2; a row block is 64 rows
//     per consumer warpgroup: 192 rows (3) in the product modes with
//     2-byte and 1-byte P, so V[g] is read M / 192 = 6 times, 128 rows (2)
//     where P is f32 and its tiles are 4 times as large;
//   * a producer warpgroup, one thread of which issues every TMA load: P's
//     tiles (64 rows x 128 bytes a box, the 128-byte swizzle, rows past M
//     and columns past K zero-filled) and V's into a ring of 4 stages (3
//     for f32 P) with a full and an empty mbarrier each;
//   * bf16: wgmma m64n64k16, P a K-major descriptor, V's (K, 64) tile an
//     MN-major descriptor (the transpose bit), so V is never transposed;
//   * int8_pre: wgmma m64n64k32 s8 -> s32, exact; int8 wgmma takes both
//     operands K-major, so V needs transposing: the ring holds V's
//     (128, 64) tiles as they are, and the first consumer warpgroup
//     transposes each into one of three K-major buffers with byte permutes
//     (4 x 4 bytes a `prmt` quad), behind a named barrier of the consumers,
//     so each CTA transposes the V[g] it reads once (quant_then_int8's ring
//     has 2 stages, to leave room for them). This was measured faster than
//     a transpose pass writing V^T (G, 64, K) before the product (PERF.md);
//   * quant_then_int8: P's f32 tiles are read from shared memory by the
//     consumers, each lane its A fragment's 16-byte chunks (the swizzle puts
//     the 8 rows of a quad column in 8 different bank groups), quantised to
//     int8 codes in registers and multiplied by wgmma with A in registers;
//   * glue_only: the consumers sum the quantised codes of P's f32 tiles in
//     integers, two threads a row; V is not read;
//   * each consumer warpgroup keeps one product group in flight and
//     releases a stage when the product that read it has finished; the
//     epilogue writes its 64 rows (rows past M are not written), the
//     integer sums converted once (round to nearest even).
// K must be a multiple of 64 (P's rows start on 16-byte boundaries) and N
// 64; M and G any. Zero-filled columns past K add exact zeros.

#include "hopper.cuh"

namespace {

using namespace hsenet_hopper;
using hsenet_hopper::pin;

constexpr int kBf16 = 0, kInt8 = 1, kQuant = 2, kGlue = 3;
constexpr int kN = 64;
constexpr int kBox = 64 * kRowBytes;  // one TMA box: 64 rows x 128 bytes

template <int MODE>
struct Cfg {
  static constexpr bool kF32P = MODE == kQuant || MODE == kGlue;
  // the modes that transpose V's tiles in the CTA
  static constexpr bool kVT = MODE == kInt8 || MODE == kQuant;
  static constexpr int kNwg = kF32P ? 2 : 3;  // consumer warpgroups
  static constexpr int kRows = 64 * kNwg;     // rows of M per CTA
  // f32 P with V^T in the CTA: 2 stages, so that the V^T tiles fit
  static constexpr int kStages = kF32P ? (kVT ? 2 : 3) : 4;
  static constexpr int kThreads = 128 * (kNwg + 1);
  static constexpr int kPBytes = MODE == kBf16 ? 2 : (MODE == kInt8 ? 1 : 4);
  static constexpr int kTileK = MODE == kBf16 ? 64 : 128;  // K per stage
  static constexpr int kPBoxes = kTileK * kPBytes / kRowBytes;  // per 64 rows
  static constexpr int kPWg = kPBoxes * kBox;  // one warpgroup's P a stage
  static constexpr int kVStage = MODE == kGlue ? 0 : kBox;
  static constexpr int kStage = kNwg * kPWg + kVStage;
  static constexpr int kVtOff = kStages * kStage;  // kVT: 3 V^T tiles
  static constexpr int kBarOff = kVtOff + (kVT ? 3 * kBox : 0);
  static constexpr int kBytes = kBarOff + 2 * kStages * 8 + 1024;
};

// D (64 x 64, s32) += A (64 x 32 s8) B (32 x 64 s8), both K-major in shared
// memory (descriptors)
__device__ __forceinline__ void wgmma_s8_ss(int (&d)[32], uint64_t da,
                                            uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31])
      : "l"(da), "l"(db), "r"(1));
}

// the same with A in registers (the mma.sync m16n8k32 fragment layout per
// warp: rows g and g + 8, bytes 4t..4t+3 and 16 + 4t..)
__device__ __forceinline__ void wgmma_s8_rs(int (&d)[32],
                                            const uint32_t (&a)[4],
                                            uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <int N>
__device__ __forceinline__ void pin(int (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

// p * 127 rounded half to even, saturated at the int8 range, as a byte
__device__ __forceinline__ uint32_t quant_code(float p) {
  const int q = min(127, max(-128, __float2int_rn(p * 127.0f)));
  return static_cast<uint32_t>(q) & 0xffu;
}

__device__ __forceinline__ uint32_t quant_word(float4 f) {
  return quant_code(f.x) | (quant_code(f.y) << 8) | (quant_code(f.z) << 16) |
         (quant_code(f.w) << 24);
}

__device__ __forceinline__ int code_sum(float4 f) {
  return static_cast<int8_t>(quant_code(f.x)) +
         static_cast<int8_t>(quant_code(f.y)) +
         static_cast<int8_t>(quant_code(f.z)) +
         static_cast<int8_t>(quant_code(f.w));
}

// one thread's part of transposing a (128 keys, 64) int8 tile of V (rows of
// 64 bytes at `src`) into a K-major (64, 128) tile with the 128-byte
// swizzle at `dst`: the 4 keys x 16 columns block `i` (of 128), as 16
// words of 4 keys
__device__ __forceinline__ void transpose_block(const unsigned char* src,
                                                unsigned char* dst, int i) {
  const int kb = i / 4, nq = i % 4;  // keys 4 kb .., columns 16 nq ..
  uint4 r[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    r[e] = *reinterpret_cast<const uint4*>(src + (4 * kb + e) * kN + 16 * nq);
  }
  const uint32_t w[4][4] = {{r[0].x, r[1].x, r[2].x, r[3].x},
                            {r[0].y, r[1].y, r[2].y, r[3].y},
                            {r[0].z, r[1].z, r[2].z, r[3].z},
                            {r[0].w, r[1].w, r[2].w, r[3].w}};
#pragma unroll
  for (int q = 0; q < 4; ++q) {  // columns 16 nq + 4 q .. + 3
    const uint32_t lo01 = __byte_perm(w[q][0], w[q][1], 0x5140);
    const uint32_t hi01 = __byte_perm(w[q][0], w[q][1], 0x7362);
    const uint32_t lo23 = __byte_perm(w[q][2], w[q][3], 0x5140);
    const uint32_t hi23 = __byte_perm(w[q][2], w[q][3], 0x7362);
    const uint32_t col[4] = {__byte_perm(lo01, lo23, 0x5410),
                             __byte_perm(lo01, lo23, 0x7632),
                             __byte_perm(hi01, hi23, 0x5410),
                             __byte_perm(hi01, hi23, 0x7632)};
#pragma unroll
    for (int f = 0; f < 4; ++f) {
      const int n = 16 * nq + 4 * q + f;
      *reinterpret_cast<uint32_t*>(
          dst + n * kRowBytes + (((kb / 4) ^ (n & 7)) << 4) + ((kb & 3) << 2)) =
          col[f];
    }
  }
}

template <int MODE>
__global__ void __launch_bounds__(Cfg<MODE>::kThreads, 1)
    pv_wgmma_kernel(const __grid_constant__ CUtensorMap tm_p,
                    const __grid_constant__ CUtensorMap tm_v,
                    float* __restrict__ out, int m, int k) {
  using C = Cfg<MODE>;
  constexpr int kStages = C::kStages;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw));
  const uint32_t base = (raw + 1023) & ~1023u;
  unsigned char* sbase = smem_raw + (base - raw);  // generic pointer
  const uint32_t full = base + C::kBarOff;               // kStages barriers
  const uint32_t empty = full + 8 * kStages;

  const int cell = blockIdx.y;
  const int m0 = blockIdx.x * C::kRows;
  const int n_tiles = (k + C::kTileK - 1) / C::kTileK;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full + 8 * s, 1);  // the producer's arrival + TMA bytes
      mbar_init(empty + 8 * s, 4 * C::kNwg);  // one per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp >= 4 * C::kNwg) {
    // ---- producer: one thread streams P's and V's tiles ----
    if (threadIdx.x % 128 != 0) return;
    for (int j = 0; j < n_tiles; ++j) {
      const int s = j % kStages;
      const uint32_t stage = base + s * C::kStage;
      mbar_wait(empty + 8 * s, ((j / kStages) & 1) ^ 1);
      mbar_arrive_tx(full + 8 * s, C::kStage);
#pragma unroll
      for (int wg = 0; wg < C::kNwg; ++wg) {
#pragma unroll
        for (int bx = 0; bx < C::kPBoxes; ++bx) {
          tma_load(stage + wg * C::kPWg + bx * kBox, &tm_p, full + 8 * s,
                   (j * C::kPBoxes + bx) * kRowBytes, m0 + 64 * wg, cell, 0);
        }
      }
      if constexpr (MODE == kBf16) {  // V's (64 keys, 64) tile
        tma_load(stage + C::kNwg * C::kPWg, &tm_v, full + 8 * s, 0, j * 64,
                 cell, 0);
      } else if constexpr (C::kVT) {  // V's (128 keys, 64) tile
        tma_load(stage + C::kNwg * C::kPWg, &tm_v, full + 8 * s, 0, j * 128,
                 cell, 0);
      }
    }
    return;
  }

  // ---- consumer warpgroups, 64 rows each ----
  const int wg = warp / 4;
  const int wq = warp % 4;  // rows 16 wq ... of the warpgroup's 64
  const int g = lane >> 2;
  const int t = lane & 3;

  if constexpr (MODE == kGlue) {
    // two threads a row: `half` sums boxes 2 half and 2 half + 1
    const int row = wq * 16 + lane / 2;
    const int half = lane & 1;
    int sum = 0;
    for (int j = 0; j < n_tiles; ++j) {
      const int s = j % kStages;
      mbar_wait(full + 8 * s, (j / kStages) & 1);
      const unsigned char* p_row = sbase + s * C::kStage + wg * C::kPWg +
                                   2 * half * kBox + row * kRowBytes;
#pragma unroll
      for (int bx = 0; bx < 2; ++bx) {
#pragma unroll
        for (int c = 0; c < 8; ++c) {
          sum += code_sum(*reinterpret_cast<const float4*>(
              p_row + bx * kBox + ((c ^ (row & 7)) << 4)));
        }
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(empty + 8 * s);
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    const int r = m0 + wg * 64 + row;
    if (r < m) {
      const float value = __int2float_rn(sum);
      float4* dst = reinterpret_cast<float4*>(
          out + (static_cast<long long>(cell) * m + r) * kN + 32 * half);
#pragma unroll
      for (int c = 0; c < 8; ++c) dst[c] = make_float4(value, value, value, value);
    }
  } else {
    float facc[32];
    int iacc[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      facc[i] = 0.f;
      iacc[i] = 0;
    }
    for (int j = 0; j < n_tiles; ++j) {
      const int s = j % kStages;
      const uint32_t stage = base + s * C::kStage;
      const uint32_t p_s = stage + wg * C::kPWg;
      uint32_t v_s = stage + C::kNwg * C::kPWg;
      mbar_wait(full + 8 * s, (j / kStages) & 1);
      if constexpr (C::kVT) {
        // V^T of this tile into buffer j % 3, whose last reader (tile j - 3)
        // finished before every consumer passed the barrier of tile j - 1
        const uint32_t vt = base + C::kVtOff + (j % 3) * kBox;
        if (threadIdx.x < 128) {
          transpose_block(sbase + (v_s - base), sbase + (vt - base),
                          threadIdx.x);
          // the generic-proxy writes, before wgmma reads them
          asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        }
        asm volatile("bar.sync 1, %0;\n" ::"n"(128 * C::kNwg) : "memory");
        v_s = vt;
      }
      if constexpr (MODE == kQuant) {
        // the A fragments of the tile's 4 k-steps (one f32 box each): rows
        // 16 wq + g and + 8, 16-byte chunks t and 4 + t, swizzled by row
        const unsigned char* p_row =
            sbase + (p_s - base) + (wq * 16 + g) * kRowBytes;
        uint32_t a[4][4];
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          const unsigned char* box = p_row + kk * kBox;
          const int lo = (t ^ g) << 4, hi = ((4 + t) ^ g) << 4;
          a[kk][0] = quant_word(*reinterpret_cast<const float4*>(box + lo));
          a[kk][1] = quant_word(
              *reinterpret_cast<const float4*>(box + 8 * kRowBytes + lo));
          a[kk][2] = quant_word(*reinterpret_cast<const float4*>(box + hi));
          a[kk][3] = quant_word(
              *reinterpret_cast<const float4*>(box + 8 * kRowBytes + hi));
        }
        pin(iacc);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          wgmma_s8_rs(iacc, a[kk], desc(v_s + kk * 32, 16, 1024));
        }
        wgmma_commit();
        wgmma_wait<0>();  // the A registers are read until the product ends
        pin(iacc);
        if (lane == 0) mbar_arrive(empty + 8 * s);
        continue;
      }
      if constexpr (MODE == kBf16) {
        pin(facc);
      } else {
        pin(iacc);
      }
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const uint64_t da = desc(p_s + kk * 32, 16, 1024);
        if constexpr (MODE == kBf16) {
          wgmma_ss_n64<0, 1, __nv_bfloat16>(
              facc, da, desc(v_s + kk * 16 * kRowBytes, 1024, 1024), 1);
        } else {
          wgmma_s8_ss(iacc, da, desc(v_s + kk * 32, 16, 1024));
        }
      }
      wgmma_commit();
      // keep this tile's products in flight; the previous tile's are done
      wgmma_wait<1>();
      if constexpr (MODE == kBf16) {
        pin(facc);
      } else {
        pin(iacc);
      }
      if (j > 0 && lane == 0) mbar_arrive(empty + 8 * ((j - 1) % kStages));
    }
    wgmma_wait<0>();
    if constexpr (MODE == kBf16) {
      pin(facc);
    } else {
      pin(iacc);
    }

    // d[4 j + 0..1] at (row g, columns 8 j + 2 t, + 1), d[4 j + 2..3] at row
    // g + 8
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int r = m0 + wg * 64 + wq * 16 + g + 8 * hr;
      if (r >= m) continue;
      float* dst = out + (static_cast<long long>(cell) * m + r) * kN + 2 * t;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        float2 val;
        if constexpr (MODE == kBf16) {
          val = make_float2(facc[4 * j + 2 * hr], facc[4 * j + 2 * hr + 1]);
        } else {
          val = make_float2(__int2float_rn(iacc[4 * j + 2 * hr]),
                            __int2float_rn(iacc[4 * j + 2 * hr + 1]));
        }
        *reinterpret_cast<float2*>(dst + 8 * j) = val;
      }
    }
  }
}

// a (cols, rows, cells) map of bytes, in boxes of 128 bytes x 64 rows with
// the 128-byte swizzle (or, `staged`, of 64 bytes x 128 rows unswizzled);
// rows and columns past the end read as zeros
bool make_byte_map(CUtensorMap* map, const void* ptr, long long cols,
                   long long rows, long long cells, bool staged = false) {
  const auto encode = encode_tiled();
  if (encode == nullptr) return false;
  cuuint64_t dims[4] = {static_cast<cuuint64_t>(cols),
                        static_cast<cuuint64_t>(rows),
                        static_cast<cuuint64_t>(cells), 1};
  cuuint64_t strides[3] = {static_cast<cuuint64_t>(cols),
                           static_cast<cuuint64_t>(cols * rows),
                           static_cast<cuuint64_t>(cols * rows * cells)};
  cuuint32_t box[4] = {static_cast<cuuint32_t>(staged ? kN : kRowBytes),
                       staged ? 128u : 64u, 1, 1};
  cuuint32_t elem[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 4, const_cast<void*>(ptr),
                dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                staged ? CU_TENSOR_MAP_SWIZZLE_NONE : CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int MODE>
cudaError_t launch_pv(const void* p, const void* v, float* out, int g, int m,
                      int k, cudaStream_t stream) {
  using C = Cfg<MODE>;
  CUtensorMap tm_p, tm_v;
  if (!make_byte_map(&tm_p, p, static_cast<long long>(k) * C::kPBytes, m, g)) {
    return cudaErrorInvalidValue;
  }
  const bool v_ok =
      MODE == kGlue ? make_byte_map(&tm_v, p, static_cast<long long>(k) *
                                                   C::kPBytes, m, g)
      : MODE == kBf16 ? make_byte_map(&tm_v, v, kN * 2, k, g)
                      : make_byte_map(&tm_v, v, kN, k, g, true);
  if (!v_ok) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      pv_wgmma_kernel<MODE>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, C::kBytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((m + C::kRows - 1) / C::kRows, g);
  pv_wgmma_kernel<MODE><<<grid, C::kThreads, C::kBytes, stream>>>(
      tm_p, tm_v, out, m, k);
  return cudaGetLastError();
}

}  // namespace

// Launches on `stream` and returns a cudaError_t (0 on success), or
// cudaErrorInvalidValue for shapes the kernel does not take. p is a
// contiguous (g, m, k) array of bf16 (mode 0), int8 (mode 1) or f32 (modes
// 2 and 3); v a contiguous (g, k, n) array of bf16 (mode 0) or int8 (modes
// 1 and 2), unused in mode 3; out a contiguous (g, m, n) f32 array. k must be a multiple of 64 and n 64; the
// caller checks dtypes, contiguity and 16-byte alignment.
extern "C" int hsenet_int8_pv_wgmma(const void* p, const void* v, void* out,
                                    int mode, int g, int m, int k, int n,
                                    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* o = static_cast<float*>(out);
  if (g < 1 || m < 1 || k < 64 || k % 64 != 0 || n != kN || g > 65535 ||
      mode < kBf16 || mode > kGlue) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  switch (mode) {
    case kBf16: return static_cast<int>(launch_pv<kBf16>(p, v, o, g, m, k, s));
    case kInt8: return static_cast<int>(launch_pv<kInt8>(p, v, o, g, m, k, s));
    case kQuant: return static_cast<int>(launch_pv<kQuant>(p, v, o, g, m, k, s));
    default: return static_cast<int>(launch_pv<kGlue>(p, nullptr, o, g, m, k, s));
  }
}
