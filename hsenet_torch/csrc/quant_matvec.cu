// int8 weight-only matvec for Hopper (sm_90a): y = (x W^T) * scale.
//
// Replaces the TPU kernel `_kernel` of the JAX package
// (ops/quant_matvec.py:42, launched by `_matvec_int8_pallas`).
// For M <= 8 activation rows it computes, per row m and output channel n,
//   y[m, n] = cast(scale[n] * sum_k x[m, k] * W[n, k])
// with W int8 codes stored (N, K), contiguous along K (one output channel
// is one contiguous row; the TPU kernel walks (K, block_n) tiles of a
// (K, N) array instead), the sum and the scale in f32 and one cast at the
// end. Two entries:
//
//   * hsenet_quant_matvec_mma: bf16 x on the tensor cores, every bf16 call
//     of the port (the serving decode's projections);
//   * hsenet_quant_matvec_fma: the first port's CUDA-core kernel, bf16 or
//     f32 x. It is the f32 route (exact f32 products, which TF32 products
//     would not keep) and, in bf16, the yardstick chip_smoke.py times the
//     tensor-core kernel against.
//
// What bounds it on an H100 SXM (3.35 TB/s): bytes. The K * N codes are
// read once (25 MB for Phi-4-mini's 3072 x 8192 gate projection, 7.5 us)
// against 2 * M * K * N operations (0.4 GFLOP at M = 8, 0.4 us at the bf16
// tensor-core peak). The work is the decode step's weight stream; nothing
// is reused but the M rows of x.
//
// What held the CUDA-core kernel back (estimated from its code):
//   1. instructions, not bytes, at M = 8: each code is converted by its own
//      I2F (16 a clock per SM) and meets M FMAs; a CTA owns 4 output
//      channels, so each 16-byte slice of x is loaded and unpacked for 4
//      channels only: about 11 thread instructions per code byte;
//   2. x traffic: each CTA reads all of x (48 KB at M = 8, K = 3072)
//      against its own 12 KB of codes;
//   3. exposed memory latency: four 16-byte loads in flight a thread and
//      nothing loaded ahead across the FMAs.
//
// What the tensor-core kernel does about each:
//   1. the products run on the tensor cores, mma.sync m16n8k16 bf16 with
//      f32 sums, the operands swapped: A is the weight (16 output channels
//      x 16 of K), B is x^T (16 of K x 8 rows; fragment rows >= M are zero
//      in registers, x is never padded in memory). Every int8 code and
//      every bf16 value is exact in bf16, so each product is exact and the
//      function is the f32 sum of the same products as the plain version's,
//      in another order. The codes become bf16 without I2F: with b a code's
//      byte, 0x4300 | (b & 0x7f) is the bf16 128 + (b & 0x7f) and
//      0x4300 | (b & 0x80) is 128 or 256, so their difference is the code,
//      exactly. Per 32-bit word of 4 codes that is one shift, four LOP3 and
//      two bf16x2 subtracts: 7 instructions for 4 codes, with the 16-byte
//      load and the mma about 2 thread instructions per code byte;
//   2. a CTA owns one tile of 16 channels and its 8 warps cut K into 8
//      contiguous slices; each lane copies its 32 bytes of x a chunk
//      through L1, and the codes stream with the evict-first hint so that
//      they do not push x out of L2. (Two tiles a warp, x's fragments
//      loaded once for 32 channels, and x staged once a CTA in shared
//      memory measured no faster: x is not what bounds it.)
//   3. each warp streams its codes and x through its own ring of 4 stages
//      in shared memory by cp.async, without registers to hold them: it
//      waits for the oldest two stages, multiplies them together (four
//      independent sums, so that no mma waits on the one before) and
//      refills them with the chunks 4 further on. A lane reads back only
//      the bytes its own copies wrote, so the ring needs no barrier.
//
// Why the K slices stay inside a CTA: the first version cut K over the
// CTAs of a thread-block cluster (up to 8, so that k,v's 64 tiles gave
// every SM a CTA) and summed the slices through distributed shared memory.
// Its two cluster barriers cost more than the SMs it added: one tile a CTA
// with the slices summed through shared memory after one __syncthreads
// measured faster at M = 1 and M = 8, though at k,v it leaves 68 of 132
// SMs without a CTA (PERF.md).
//
// What bounds it then: not the bytes alone. At the decode's shapes it
// stays well above the bytes bound and its time does not fall with M: a
// warp spends a nearly fixed time on each chunk (PERF.md).
//
// The K permutation. The A fragment wants a lane's codes at K slots
// 2t + {0, 1, 8, 9} (t = lane % 4) of a 16-wide step, not at 16 contiguous
// bytes. The sum over K does not depend on its order, so A and B take K in
// one and the same permuted order: in a 64-code chunk, lane t loads the 16
// bytes at 16 t of its two rows (channels g and g + 8 of the tile, g =
// lane / 4); its word j (codes 16 t + 4 j + {0, 1, 2, 3}) feeds mma j, the
// bf16 pair (code 0, code 2) at slots (2t, 2t + 1) and (code 1, code 3) at
// (2t + 8, 2t + 9). B gathers x's row g in the same order from the lane's
// 32 bytes of x at 16 t. The last chunk of a K that is not a multiple of
// 64 loads nothing for the lanes past K (zeros). `fragment_k_order` in
// ops/quant_matvec.py states the same map, and the CPU tests prove it.
//
// The warps' partial sums meet in shared memory and are summed in warp
// order, scaled in f32 and cast once: the same bits run to run, no atomics.
//
// The CUDA-core kernel (the yardstick and the f32 route):
//   * one CTA of 4 warps owns 4 output channels, and its warps share K:
//     each lane walks K in slices of 16 codes (one 16-byte streaming load
//     per channel, 4 in flight), 2048 codes a CTA step, and keeps 4 x M
//     partial sums in registers;
//   * x is read straight from global memory with read-only 16-byte loads
//     (L1 serves it after the first warp of the SM); the codes are loaded
//     with the evict-first hint;
//   * partial sums are reduced across the warp with shuffles and across
//     the CTA's warps through 512 bytes of shared memory, in a fixed order,
//     then scaled in f32 and cast once.
// K must be a multiple of 16 (16-byte loads of the codes, rows on 16-byte
// boundaries); N is free (the last CTA masks its stores).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "flash_common.cuh"

namespace {

// ---- the tensor-core kernel -------------------------------------------

constexpr int kTile = 16;     // output channels of a CTA (the mma's A rows)
constexpr int kChunk = 64;    // K codes of one warp step: 4 lanes x 16 bytes
constexpr int kRows = 8;      // x rows of one mma (B's columns)
constexpr int kMmaWarps = 8;  // warps per CTA, each a slice of K
constexpr int kStages = 4;    // chunks in flight a warp
constexpr int kVecs = 4;      // 16-byte vectors a lane a stage: 2 code rows, x
constexpr int kWarpRingBytes = kStages * kVecs * 32 * 16;  // 8 KB
constexpr int kRingBytes = kMmaWarps * kWarpRingBytes;     // 64 KB

// 16 code bytes global -> shared, asynchronous, evict-first in L2;
// zero-fills when !valid
__device__ __forceinline__ void cp_async_codes(void* dst, const void* src,
                                               bool valid, uint64_t policy) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile(
      "cp.async.cg.shared.global.L2::cache_hint [%0], [%1], 16, %2, %3;\n"
      :
      : "r"(a), "l"(src), "r"(valid ? 16 : 0), "l"(policy)
      : "memory");
}

// 16 bytes of x global -> shared, asynchronous, through L1 (the CTA's
// warps and the SM's other CTAs read the same x); zero-fills when !valid
__device__ __forceinline__ void cp_async_x(void* dst, const void* src,
                                           bool valid) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 16, %2;\n"
               :
               : "r"(a), "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

// a - b on bf16 pairs, as fma(b, -1, a): exact where a - b is a bf16
__device__ __forceinline__ uint32_t bf16x2_sub(uint32_t a, uint32_t b) {
  uint32_t d;
  asm("fma.rn.bf16x2 %0, %1, %2, %3;\n"
      : "=r"(d)
      : "r"(b), "r"(0xBF80BF80u), "r"(a));
  return d;
}

// four int8 codes (bytes b0..b3 of w, b0 at the lowest address) -> the bf16
// pairs (b0, b2) and (b1, b3), exactly: (128 + (b & 0x7f)) - (128 or 256)
__device__ __forceinline__ void codes_to_bf16(uint32_t w, uint32_t& even,
                                              uint32_t& odd) {
  const uint32_t h = w >> 8;
  even = bf16x2_sub((w & 0x007F007Fu) | 0x43004300u,
                    (w & 0x00800080u) | 0x43004300u);
  odd = bf16x2_sub((h & 0x007F007Fu) | 0x43004300u,
                   (h & 0x00800080u) | 0x43004300u);
}

__device__ __forceinline__ uint32_t word(const uint4& v, int j) {
  return j == 0 ? v.x : j == 1 ? v.y : j == 2 ? v.z : v.w;
}

// P chunks of a lane, multiplied together: v[p][0], v[p][1] its 16 code
// bytes of rows g and g + 8, v[p][2], v[p][3] its 32 bytes of x's row g
// (zeros past K, N, M). Chunk p's mma j adds to acc[2 p + j % 2]: 2 P
// independent sums, so that consecutive mmas do not wait on each other.
template <int P>
__device__ __forceinline__ void mma_chunks(float (&acc)[4][4],
                                           const uint4 (&v)[P][kVecs]) {
#pragma unroll
  for (int j = 0; j < 4; ++j) {
#pragma unroll
    for (int p = 0; p < P; ++p) {
      // x's row g at the lane's codes 4j + {0, 2} and 4j + {1, 3}
      const uint32_t x0 = word(v[p][2 + j / 2], 2 * (j % 2));
      const uint32_t x1 = word(v[p][2 + j / 2], 2 * (j % 2) + 1);
      uint32_t a[4];  // rows g and g + 8 at slots 2t + {0, 1}, then + 8
      codes_to_bf16(word(v[p][0], j), a[0], a[2]);
      codes_to_bf16(word(v[p][1], j), a[1], a[3]);
      hsenet_flash::mma_16816<__nv_bfloat16>(acc[2 * p + j % 2], a,
                                             __byte_perm(x0, x1, 0x5410),
                                             __byte_perm(x0, x1, 0x7632));
    }
  }
}

// grid (channel tiles): CTA b owns channels [16 b, 16 (b + 1)); warp w of
// it the K chunks [w cpw, (w + 1) cpw), cpw = ceil(chunks / 8)
__global__ void __launch_bounds__(kMmaWarps * 32)
    quant_matvec_mma_kernel(const __nv_bfloat16* __restrict__ x,
                            const int8_t* __restrict__ w,
                            const float* __restrict__ scale,
                            __nv_bfloat16* __restrict__ y, int m, int k, int n) {
  extern __shared__ uint4 ring[];
  __shared__ float part[kMmaWarps][kRows][kTile];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int n0 = blockIdx.x * kTile;
  const int chunks = (k + kChunk - 1) / kChunk;
  const int per_warp = (chunks + kMmaWarps - 1) / kMmaWarps;
  const int c_begin = warp * per_warp;
  const int c_end = min(c_begin + per_warp, chunks);

  // the lane's code rows (channels g and g + 8 of the tile) and x's row g,
  // each at the lane's 16 codes of a chunk; rows past N or M are never read
  // (their copies zero-fill)
  const bool ok0 = n0 + g < n, ok1 = n0 + g + 8 < n, xok = g < m;
  const int8_t* w0 = w + static_cast<long long>(ok0 ? n0 + g : 0) * k + 16 * t;
  const int8_t* w1 = w + static_cast<long long>(ok1 ? n0 + g + 8 : 0) * k + 16 * t;
  const __nv_bfloat16* xr = x + static_cast<long long>(xok ? g : 0) * k + 16 * t;
  uint64_t policy;
  asm("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;\n" : "=l"(policy));

  // this lane's vector v of stage s: mine[(s * kVecs + v) * 32]
  uint4* mine = ring + warp * (kWarpRingBytes / 16) + lane;
  // chunk c into stage s; past the warp's slice only an empty group, so
  // that the count of groups stays one a chunk
  auto issue = [&](int c, int s) {
    if (c < c_end) {
      const bool in = c * kChunk + 16 * t < k;  // the last chunk may end early
      const int kk = in ? c * kChunk : 0;
      uint4* dst = mine + s * kVecs * 32;
      cp_async_codes(dst, w0 + kk, in && ok0, policy);
      cp_async_codes(dst + 32, w1 + kk, in && ok1, policy);
      cp_async_x(dst + 64, xr + kk, in && xok);
      cp_async_x(dst + 96, xr + kk + 8, in && xok);
    }
    hsenet_flash::cp_async_commit();
  };
  auto read = [&](uint4 (&v)[kVecs], int s) {
#pragma unroll
    for (int q = 0; q < kVecs; ++q) v[q] = mine[(s * kVecs + q) * 32];
  };

  float acc[4][4];
#pragma unroll
  for (int p = 0; p < 4; ++p) {
#pragma unroll
    for (int r = 0; r < 4; ++r) acc[p][r] = 0.f;
  }

  // kStages chunks in flight: wait for the oldest two, multiply them
  // together, refill their stages with the chunks kStages further on. A
  // lane reads back only what its own copies wrote, so no barrier is
  // needed.
  constexpr int P = 2;
#pragma unroll
  for (int s = 0; s < kStages; ++s) issue(c_begin + s, s);
  int st = 0, c = c_begin;
  for (; c + P <= c_end; c += P) {
    hsenet_flash::cp_async_wait<kStages - P>();
    uint4 v[P][kVecs];
#pragma unroll
    for (int p = 0; p < P; ++p) read(v[p], st + p);
    mma_chunks<P>(acc, v);
#pragma unroll
    for (int p = 0; p < P; ++p) issue(c + p + kStages, st + p);
    st = st + P == kStages ? 0 : st + P;
  }
  if (c < c_end) {  // an odd last chunk
    hsenet_flash::cp_async_wait<kStages - 1>();
    uint4 v[1][kVecs];
    read(v[0], st);
    mma_chunks<1>(acc, v);
  }
  hsenet_flash::cp_async_wait<0>();

  // the sums hold (channel g, rows 2t, 2t + 1) and (channel g + 8, the same
  // rows) of the warp's K slice; summed over the warps in warp order
  part[warp][2 * t][g] = (acc[0][0] + acc[1][0]) + (acc[2][0] + acc[3][0]);
  part[warp][2 * t + 1][g] = (acc[0][1] + acc[1][1]) + (acc[2][1] + acc[3][1]);
  part[warp][2 * t][g + 8] = (acc[0][2] + acc[1][2]) + (acc[2][2] + acc[3][2]);
  part[warp][2 * t + 1][g + 8] = (acc[0][3] + acc[1][3]) + (acc[2][3] + acc[3][3]);
  __syncthreads();
  if (threadIdx.x < m * kTile) {
    const int r = threadIdx.x / kTile, cc = threadIdx.x % kTile;
    if (n0 + cc < n) {
      float sum = 0.f;
#pragma unroll
      for (int q = 0; q < kMmaWarps; ++q) sum += part[q][r][cc];
      y[static_cast<long long>(r) * n + n0 + cc] =
          __float2bfloat16(sum * scale[n0 + cc]);
    }
  }
}

cudaError_t launch_mma(const void* x, const void* w, const void* scale,
                       void* y, int m, int k, int n, cudaStream_t stream) {
  // the warps' rings, 64 KB, above the 48 KB default
  static const cudaError_t attr = cudaFuncSetAttribute(
      quant_matvec_mma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kRingBytes);
  if (attr != cudaSuccess) return attr;
  quant_matvec_mma_kernel<<<(n + kTile - 1) / kTile, kMmaWarps * 32,
                            kRingBytes, stream>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const int8_t*>(w),
      static_cast<const float*>(scale), static_cast<__nv_bfloat16*>(y), m, k,
      n);
  return cudaGetLastError();
}

// ---- the CUDA-core kernel (f32 route; bf16 yardstick) ------------------

constexpr int kWarps = 4;     // warps per CTA, sharing K
constexpr int kChannels = 4;  // output channels per CTA
constexpr int kVec = 16;      // codes per 16-byte load

__device__ __forceinline__ void load_x(const float* p, float (&x)[kVec]) {
  const float4* v = reinterpret_cast<const float4*>(p);
#pragma unroll
  for (int i = 0; i < kVec / 4; ++i) {
    const float4 f = __ldg(v + i);
    x[4 * i + 0] = f.x;
    x[4 * i + 1] = f.y;
    x[4 * i + 2] = f.z;
    x[4 * i + 3] = f.w;
  }
}

__device__ __forceinline__ void load_x(const __nv_bfloat16* p,
                                       float (&x)[kVec]) {
  const uint4* v = reinterpret_cast<const uint4*>(p);
#pragma unroll
  for (int i = 0; i < kVec / 8; ++i) {
    const uint4 u = __ldg(v + i);
    const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {  // a bf16 is the top half of an f32
      x[8 * i + 2 * j + 0] = __uint_as_float(w[j] << 16);
      x[8 * i + 2 * j + 1] = __uint_as_float(w[j] & 0xffff0000u);
    }
  }
}

__device__ __forceinline__ void unpack_codes(const uint4 u,
                                             float (&w)[kVec]) {
  const uint32_t words[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      w[4 * i + j] =
          static_cast<float>(static_cast<int8_t>(words[i] >> (8 * j)));
    }
  }
}

__device__ __forceinline__ void store_y(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_y(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

template <typename T, int M>
__global__ void __launch_bounds__(kWarps * 32)
    quant_matvec_fma_kernel(const T* __restrict__ x, const int8_t* __restrict__ w,
                            const float* __restrict__ scale, T* __restrict__ y,
                            int k, int n) {
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int n0 = blockIdx.x * kChannels;
  __shared__ float part[kWarps][32];

  float acc[kChannels][M];
#pragma unroll
  for (int c = 0; c < kChannels; ++c) {
#pragma unroll
    for (int m = 0; m < M; ++m) acc[c][m] = 0.f;
  }

  for (int k0 = (warp * 32 + lane) * kVec; k0 < k; k0 += kWarps * 32 * kVec) {
    float wf[kChannels][kVec];
#pragma unroll
    for (int c = 0; c < kChannels; ++c) {
      const int row = min(n0 + c, n - 1);  // a clamped row is never stored
      const uint4 codes = __ldcs(reinterpret_cast<const uint4*>(
          w + static_cast<long long>(row) * k + k0));
      unpack_codes(codes, wf[c]);
    }
#pragma unroll
    for (int m = 0; m < M; ++m) {
      float xf[kVec];
      load_x(x + static_cast<long long>(m) * k + k0, xf);
#pragma unroll
      for (int c = 0; c < kChannels; ++c) {
        float s = acc[c][m];
#pragma unroll
        for (int j = 0; j < kVec; ++j) s = fmaf(xf[j], wf[c][j], s);
        acc[c][m] = s;
      }
    }
  }

#pragma unroll
  for (int c = 0; c < kChannels; ++c) {
#pragma unroll
    for (int m = 0; m < M; ++m) {
      float s = acc[c][m];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        s += __shfl_xor_sync(0xffffffffu, s, off);
      }
      // every lane holds the warp's sum; lane c * M + m keeps it
      if (lane == c * M + m) part[warp][lane] = s;
    }
  }
  __syncthreads();
  if (warp == 0 && lane < kChannels * M) {
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) s += part[w][lane];
    const int c = lane / M, m = lane % M;
    if (n0 + c < n) {
      store_y(y + static_cast<long long>(m) * n + n0 + c, s * scale[n0 + c]);
    }
  }
}

template <typename T, int M>
cudaError_t launch_fma(const void* x, const void* w, const void* scale,
                       void* y, int k, int n, cudaStream_t stream) {
  const dim3 grid((n + kChannels - 1) / kChannels);
  quant_matvec_fma_kernel<T, M><<<grid, kWarps * 32, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const int8_t*>(w),
      static_cast<const float*>(scale), static_cast<T*>(y), k, n);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_fma_rows(const void* x, const void* w, const void* scale,
                            void* y, int m, int k, int n, cudaStream_t stream) {
  switch (m) {
    case 1: return launch_fma<T, 1>(x, w, scale, y, k, n, stream);
    case 2: return launch_fma<T, 2>(x, w, scale, y, k, n, stream);
    case 3: return launch_fma<T, 3>(x, w, scale, y, k, n, stream);
    case 4: return launch_fma<T, 4>(x, w, scale, y, k, n, stream);
    case 5: return launch_fma<T, 5>(x, w, scale, y, k, n, stream);
    case 6: return launch_fma<T, 6>(x, w, scale, y, k, n, stream);
    case 7: return launch_fma<T, 7>(x, w, scale, y, k, n, stream);
    case 8: return launch_fma<T, 8>(x, w, scale, y, k, n, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// Both entries launch on `stream` and return cudaGetLastError() (0 on
// success). x is a contiguous (m, k) array, w a contiguous (n, k) int8
// array, scale (n,) f32, y a contiguous (m, n) array of x's type. The
// caller checks m in 1..8, k a multiple of 16, dtypes, contiguity and
// 16-byte alignment of x and w.

// bf16 x on the tensor cores: a CTA of 8 warps a tile of 16 output
// channels, K cut over its warps (`mma_plan` in ops/quant_matvec.py states
// the cut).
extern "C" int hsenet_quant_matvec_mma(const void* x, const void* w,
                                       const void* scale, void* y, int m,
                                       int k, int n, void* stream) {
  if (m < 1 || m > kRows || k < 16 || k % 16 != 0 || n < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(
      launch_mma(x, w, scale, y, m, k, n, static_cast<cudaStream_t>(stream)));
}

// bf16 (`x_is_bf16` != 0) or f32 x on the CUDA cores.
extern "C" int hsenet_quant_matvec_fma(const void* x, const void* w,
                                       const void* scale, void* y, int m,
                                       int k, int n, int x_is_bf16,
                                       void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (k % kVec != 0 || n < 1) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(
      x_is_bf16 ? launch_fma_rows<__nv_bfloat16>(x, w, scale, y, m, k, n, s)
                : launch_fma_rows<float>(x, w, scale, y, m, k, n, s));
}
