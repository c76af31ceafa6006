// The yardstick of the P.V probe product: out[g] = P[g] V[g] in f32, by
// mma.sync (sm_90a). No path launches it: the probe runs int8_pv_wgmma.cu,
// the kernel redesigned for Hopper, and chip_smoke.py times that kernel
// against this one, in every mode on the same card.
//
// This was the first port of the TPU kernel `make_kernel(mode)` of the JAX
// package (scripts/_probe_pallas_int8.py), the probe that decides how
// attention's P.V product behaves in the W8A8 serving-encode mode. Per grid
// cell g it computes a (M, K) x (K, N) product with f32 output, in one of
// four modes:
//   0 bf16            P, V bf16; bf16 products summed in f32;
//   1 int8_pre        P, V int8; int32 sums, one conversion to f32;
//   2 quant_then_int8 P f32, V int8; P becomes rint(p * 127) as int8 (round
//                     half to even, saturated at the int8 range) as it is
//                     loaded, then as int8_pre;
//   3 glue_only       P f32; each row's sum of its quantised codes (exact:
//                     integers far below 2^24), broadcast to N columns. V is
//                     not read.
//
// What bounds it on an H100 SXM (3.35 TB/s; 989 TFLOP/s bf16, 1,979 TOP/s
// int8): bytes. At the probe's shapes (G 192, M 1152, K 2176, N 64) P holds
// 481 M elements, read once (0.96 GB in bf16, 0.48 GB in int8, 1.93 GB in
// f32), against 61.6 G operations: 0.17-0.6 ms of bytes, 0.03-0.06 ms of
// operations. The work is streaming P through the tensor cores.
//
// Design (mma.sync, registers for P, shared memory for V only):
//   * one CTA of 4 warps per (g, 64-row tile of M); each warp owns 16 rows
//     and all N = 64 columns (8 mma tiles of n = 8, accumulators in
//     registers); K is walked in tiles of 64;
//   * P never touches shared memory: each lane loads its A fragments
//     straight from device memory with 16-byte loads. A lane of quad t
//     reads the 16 consecutive elements t*16 .. t*16+15 of each of its two
//     rows in a K tile, and the K index inside the tile is permuted so that
//     those 16 elements are exactly the lane's A fragments of every mma
//     step of the tile (the product sums over K, so any permutation applied
//     to both operands leaves it unchanged). The four lanes of a quad read
//     a row's whole tile, 64-256 contiguous bytes;
//   * V's tile is transposed into shared memory (K contiguous per column
//     n), because the mma's B operand wants K-consecutive elements of one
//     column per register and `ldmatrix .trans` transposes 16-bit elements,
//     not bytes: each lane reads its B fragments of a step, under the same
//     permutation, as one 8-byte load. Two tile buffers, one barrier a tile;
//   * the next tile of P and V is loaded into registers while the current
//     one is multiplied;
//   * bf16: mma m16n8k16 bf16 -> f32. int8: mma m16n8k32 s8 -> s32, exact;
//     the sums reach 2176 * 127 * 127 ~ 3.5e7 > 2^24, so they stay int32
//     and are converted once at the end (round to nearest even);
//   * glue_only is its own kernel: one warp per row, 16-byte loads, int
//     sums reduced by shuffles.
// K must be a multiple of 64 and N equal to 64 (the probe's head dim); rows
// past M are clamped on load and masked on store.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBf16 = 0, kInt8 = 1, kQuant = 2, kGlue = 3;
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kRows = kWarps * 16;  // rows of M per CTA
constexpr int kTileK = 64;
constexpr int kN = 64;

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// p * 127 rounded half to even, saturated at the int8 range, as a byte
__device__ __forceinline__ uint32_t quant_code(float p) {
  const int q = min(127, max(-128, __float2int_rn(p * 127.0f)));
  return static_cast<uint32_t>(q) & 0xffu;
}

__device__ __forceinline__ uint32_t quant_word(float a, float b, float c,
                                               float d) {
  return quant_code(a) | (quant_code(b) << 8) | (quant_code(c) << 16) |
         (quant_code(d) << 24);
}

template <int MODE>
struct Mode {
  static constexpr bool kIsBf16 = MODE == kBf16;
  // bytes of one element of P and of V
  static constexpr int kPBytes = MODE == kBf16 ? 2 : (MODE == kInt8 ? 1 : 4);
  static constexpr int kVBytes = kIsBf16 ? 2 : 1;
  // 16-byte loads of P per row per K tile (16 elements a lane)
  static constexpr int kPVec = 16 * kPBytes / 16;
  // 16-byte loads of V per thread per K tile (64 x 64 elements a CTA)
  static constexpr int kVVec = kTileK * kN * kVBytes / 16 / kThreads;
  // 32-bit A words per row per K tile after conversion (16 elements)
  static constexpr int kWords = 16 * (kIsBf16 ? 2 : 1) / 4;
  // mma steps per K tile and K elements per step
  static constexpr int kSteps = kIsBf16 ? 4 : 2;
  // shared-memory row of one column n of V^T, padded (in bytes)
  static constexpr int kRowBytes = kTileK * kVBytes + 16;
};

// A words of one row's 16 elements: bf16 pairs or int8 quads, in element
// order (lowest K in the low bits)
template <int MODE>
__device__ __forceinline__ void to_words(const uint4 (&raw)[Mode<MODE>::kPVec],
                                         uint32_t (&w)[Mode<MODE>::kWords]) {
  if constexpr (MODE == kQuant) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      w[i] = quant_word(__uint_as_float(raw[i].x), __uint_as_float(raw[i].y),
                        __uint_as_float(raw[i].z), __uint_as_float(raw[i].w));
    }
  } else {
#pragma unroll
    for (int i = 0; i < Mode<MODE>::kPVec; ++i) {
      w[4 * i + 0] = raw[i].x;
      w[4 * i + 1] = raw[i].y;
      w[4 * i + 2] = raw[i].z;
      w[4 * i + 3] = raw[i].w;
    }
  }
}

template <int MODE>
__global__ void __launch_bounds__(kThreads)
    pv_kernel(const uint8_t* __restrict__ p, const uint8_t* __restrict__ v,
              float* __restrict__ out, int m, int k) {
  using T = Mode<MODE>;
  __shared__ __align__(16) uint8_t vs[2][kN * T::kRowBytes];

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;  // mma group and quad lane
  const long long cell = blockIdx.y;
  const int row = blockIdx.x * kRows + warp * 16 + g;
  // rows past M read the last row and are never stored
  const long long rows[2] = {min(row, m - 1), min(row + 8, m - 1)};
  const uint8_t* prow[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    prow[h] = p + ((cell * m + rows[h]) * k + t * 16) * T::kPBytes;
  }
  const uint8_t* vcell = v + cell * k * kN * T::kVBytes;

  uint4 a_cur[2][T::kPVec], a_nxt[2][T::kPVec];
  uint4 v_cur[T::kVVec], v_nxt[T::kVVec];
  // the V chunk of thread c: (K row, first column) of its 16 bytes
  constexpr int kChunksPerRow = kN * T::kVBytes / 16;

  auto load = [&](int tile, uint4 (&a)[2][T::kPVec], uint4 (&vv)[T::kVVec]) {
    const long long k0 = static_cast<long long>(tile) * kTileK;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const uint4* src =
          reinterpret_cast<const uint4*>(prow[h] + k0 * T::kPBytes);
#pragma unroll
      for (int i = 0; i < T::kPVec; ++i) a[h][i] = __ldcs(src + i);
    }
#pragma unroll
    for (int i = 0; i < T::kVVec; ++i) {
      const int c = threadIdx.x + i * kThreads;
      const int kr = c / kChunksPerRow, col = c % kChunksPerRow;
      vv[i] = __ldg(reinterpret_cast<const uint4*>(
                        vcell + ((k0 + kr) * kN) * T::kVBytes) +
                    col);
    }
  };

  float facc[8][4];
  int iacc[8][4];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      facc[j][e] = 0.f;
      iacc[j][e] = 0;
    }
  }

  const int tiles = k / kTileK;
  load(0, a_cur, v_cur);
  for (int tile = 0; tile < tiles; ++tile) {
    uint8_t* buf = vs[tile & 1];
    // V's tile, transposed: column n of V is row n of the buffer
#pragma unroll
    for (int i = 0; i < T::kVVec; ++i) {
      const int c = threadIdx.x + i * kThreads;
      const int kr = c / kChunksPerRow, col = c % kChunksPerRow;
      const uint32_t words[4] = {v_cur[i].x, v_cur[i].y, v_cur[i].z,
                                 v_cur[i].w};
      if constexpr (T::kIsBf16) {
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const int n = col * 8 + e;
          reinterpret_cast<uint16_t*>(buf + n * T::kRowBytes)[kr] =
              static_cast<uint16_t>(words[e / 2] >> (16 * (e % 2)));
        }
      } else {
#pragma unroll
        for (int e = 0; e < 16; ++e) {
          const int n = col * 16 + e;
          buf[n * T::kRowBytes + kr] =
              static_cast<uint8_t>(words[e / 4] >> (8 * (e % 4)));
        }
      }
    }
    __syncthreads();
    if (tile + 1 < tiles) load(tile + 1, a_nxt, v_nxt);

    uint32_t w[2][T::kWords];
    to_words<MODE>(a_cur[0], w[0]);
    to_words<MODE>(a_cur[1], w[1]);
    // step s of the tile: the lane's A words are (2s, 2s+1) of each row,
    // its B words the 8 bytes at K offset t*16 + s * (16 / kSteps) elements
#pragma unroll
    for (int s = 0; s < T::kSteps; ++s) {
      const uint32_t a[4] = {w[0][2 * s], w[1][2 * s], w[0][2 * s + 1],
                             w[1][2 * s + 1]};
      const int koff = (t * 16 + s * (16 / T::kSteps)) * T::kVBytes;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const uint2 b = *reinterpret_cast<const uint2*>(
            buf + (8 * j + g) * T::kRowBytes + koff);
        if constexpr (T::kIsBf16) {
          mma_bf16(facc[j], a, b.x, b.y);
        } else {
          mma_s8(iacc[j], a, b.x, b.y);
        }
      }
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
#pragma unroll
      for (int i = 0; i < T::kPVec; ++i) a_cur[h][i] = a_nxt[h][i];
    }
#pragma unroll
    for (int i = 0; i < T::kVVec; ++i) v_cur[i] = v_nxt[i];
  }

  // c0, c1 at (row g, columns 8j + 2t, +1); c2, c3 at row g + 8
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = row + 8 * h;
    if (r >= m) continue;
    float* dst = out + (cell * m + r) * kN + 2 * t;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      float2 val;
      if constexpr (T::kIsBf16) {
        val = make_float2(facc[j][2 * h], facc[j][2 * h + 1]);
      } else {
        val = make_float2(__int2float_rn(iacc[j][2 * h]),
                          __int2float_rn(iacc[j][2 * h + 1]));
      }
      *reinterpret_cast<float2*>(dst + 8 * j) = val;
    }
  }
}

// glue_only: one warp per row of P (f32), 16-byte loads, the row's codes
// summed as integers (exact), written to all n columns
constexpr int kGlueWarps = 8;

__global__ void __launch_bounds__(kGlueWarps * 32)
    glue_kernel(const float* __restrict__ p, float* __restrict__ out, int m,
                int k, int n) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int row = blockIdx.x * kGlueWarps + warp;
  if (row >= m) return;
  const long long cell = blockIdx.y;
  const float4* src =
      reinterpret_cast<const float4*>(p + (cell * m + row) * k);
  int sum = 0;
#pragma unroll 4
  for (int c = lane; c < k / 4; c += 32) {
    const float4 f = __ldcs(src + c);
    sum += static_cast<int8_t>(quant_code(f.x)) +
           static_cast<int8_t>(quant_code(f.y)) +
           static_cast<int8_t>(quant_code(f.z)) +
           static_cast<int8_t>(quant_code(f.w));
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    sum += __shfl_xor_sync(0xffffffffu, sum, off);
  }
  const float value = __int2float_rn(sum);
  float* dst = out + (cell * m + row) * n;
  for (int c = lane; c < n; c += 32) dst[c] = value;
}

template <int MODE>
cudaError_t launch_pv(const void* p, const void* v, float* out, int g, int m,
                      int k, cudaStream_t stream) {
  const dim3 grid((m + kRows - 1) / kRows, g);
  pv_kernel<MODE><<<grid, kThreads, 0, stream>>>(
      static_cast<const uint8_t*>(p), static_cast<const uint8_t*>(v), out, m,
      k);
  return cudaGetLastError();
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 on success), or
// cudaErrorInvalidValue for shapes the kernel does not take. p is a
// contiguous (g, m, k) array of bf16 (mode 0), int8 (mode 1) or f32 (modes
// 2 and 3); v a contiguous (g, k, n) array of bf16 (mode 0) or int8 (modes
// 1 and 2), unused in mode 3; out a contiguous (g, m, n) f32 array. Modes
// 0-2 need k a multiple of 64 and n == 64, mode 3 k a multiple of 4; the
// caller checks dtypes, contiguity and 16-byte alignment.
extern "C" int hsenet_int8_pv(const void* p, const void* v, void* out,
                              int mode, int g, int m, int k, int n,
                              void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* o = static_cast<float*>(out);
  if (g < 1 || m < 1 || k < 1 || n < 1 || g > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (mode == kGlue) {
    if (k % 4 != 0) return static_cast<int>(cudaErrorInvalidValue);
    const dim3 grid((m + kGlueWarps - 1) / kGlueWarps, g);
    glue_kernel<<<grid, kGlueWarps * 32, 0, s>>>(static_cast<const float*>(p),
                                                 o, m, k, n);
    return static_cast<int>(cudaGetLastError());
  }
  if (k % kTileK != 0 || n != kN) return static_cast<int>(cudaErrorInvalidValue);
  switch (mode) {
    case kBf16: return static_cast<int>(launch_pv<kBf16>(p, v, o, g, m, k, s));
    case kInt8: return static_cast<int>(launch_pv<kInt8>(p, v, o, g, m, k, s));
    case kQuant: return static_cast<int>(launch_pv<kQuant>(p, v, o, g, m, k, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
