// int8 weight-only matvec for Hopper (sm_90a): y = (x W^T) * scale.
//
// Replaces the TPU kernel `_kernel` of the JAX package
// (ops/quant_matvec.py, launched by `_matvec_int8_pallas`). For M <= 8
// activation rows it computes, per row m and output channel n,
//   y[m, n] = cast(scale[n] * sum_k x[m, k] * W[n, k])
// with x in bf16 or f32, W int8 codes, the sum and the scale in f32 and one
// cast at the end. The int8 -> f32 and bf16 -> f32 converts are exact, so
// every product is formed in f32.
//
// What bounds it on an H100 SXM (3.35 TB/s): bytes. The K * N codes are read
// once (25 MB for Phi-4-mini's 3072 x 8192 gate projection, 7.5 us), against
// 2 * M * K * N operations (0.4 GFLOP at M = 8). The work is the decode
// step's weight stream; nothing is reused but the M rows of x.
//
// Design (plain loads and FMAs; no tensor cores; shared memory only for the
// last reduction):
//   * the codes are stored (N, K), contiguous along K, so one output
//     channel is one contiguous row (the TPU kernel walks (K, block_n)
//     tiles of a (K, N) array instead);
//   * one CTA of 4 warps owns 4 output channels, and its warps share K:
//     each lane walks K in slices of 16 codes (one 16-byte streaming load
//     per channel, 4 in flight), 2048 codes a CTA step, and keeps 4 x M
//     partial sums in registers. Splitting K across the warps rather than
//     giving each warp its own channels keeps every warp's serial walk
//     short (2 steps at K = 3072) and the grid wide (256 CTAs at N = 1024);
//     it took the (3072, 1024) shape from 0.0149 to 0.0075 ms and the
//     (8192, 3072) shape from 0.0365 to 0.0227 ms on an H100 at 700 W;
//   * x (at most 8 x 8192 values, 128 KB in bf16) is not staged in shared
//     memory: every warp reads the slices it needs straight from global
//     memory with read-only 16-byte loads, which the L1 serves after the
//     first warp of the SM has touched them, and each loaded slice is used
//     for the 4 channels. The codes are loaded with the evict-first hint so
//     that they do not push x out;
//   * partial sums are reduced across the warp with shuffles and across
//     the CTA's warps through 512 bytes of shared memory, in a fixed order,
//     then scaled in f32 and cast once.
// K must be a multiple of 16 (16-byte loads of the codes, rows on 16-byte
// boundaries); N is free (the last CTA clamps its rows and masks its
// stores).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

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
    quant_matvec_kernel(const T* __restrict__ x, const int8_t* __restrict__ w,
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
cudaError_t launch(const void* x, const void* w, const void* scale, void* y,
                   int k, int n, cudaStream_t stream) {
  const dim3 grid((n + kChannels - 1) / kChannels);
  quant_matvec_kernel<T, M><<<grid, kWarps * 32, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const int8_t*>(w),
      static_cast<const float*>(scale), static_cast<T*>(y), k, n);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_rows(const void* x, const void* w, const void* scale,
                        void* y, int m, int k, int n, cudaStream_t stream) {
  switch (m) {
    case 1: return launch<T, 1>(x, w, scale, y, k, n, stream);
    case 2: return launch<T, 2>(x, w, scale, y, k, n, stream);
    case 3: return launch<T, 3>(x, w, scale, y, k, n, stream);
    case 4: return launch<T, 4>(x, w, scale, y, k, n, stream);
    case 5: return launch<T, 5>(x, w, scale, y, k, n, stream);
    case 6: return launch<T, 6>(x, w, scale, y, k, n, stream);
    case 7: return launch<T, 7>(x, w, scale, y, k, n, stream);
    case 8: return launch<T, 8>(x, w, scale, y, k, n, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 on success).
// x is a contiguous (m, k) array of bf16 (`x_is_bf16` != 0) or f32, w a
// contiguous (n, k) int8 array, scale (n,) f32, y a contiguous (m, n)
// array of x's type. The caller checks m in 1..8, k a multiple of 16,
// dtypes, contiguity and 16-byte alignment of x and w.
extern "C" int hsenet_quant_matvec(const void* x, const void* w,
                                   const void* scale, void* y, int m, int k,
                                   int n, int x_is_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (k % kVec != 0 || n < 1) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(
      x_is_bf16 ? launch_rows<__nv_bfloat16>(x, w, scale, y, m, k, n, s)
                : launch_rows<float>(x, w, scale, y, m, k, n, s));
}
