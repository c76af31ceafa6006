// The train step's optimizer over every trained leaf at once (sm_90a): the
// sum of squares of the gradients, leaf by leaf, and one pass of the clip by
// global norm and AdamW.
//
// Replaces no TPU kernel: the JAX package leaves optax's
// chain(clip_by_global_norm, adamw) to XLA, which fuses it. It replaces the
// port's leaf-by-leaf loops in train/train_state.py (`global_norm`, 3
// launches a leaf; `AdamW.step`, ~11 launches and two leaf-sized
// temporaries a leaf): 4,766 launches a CLIP step for 12.4 ms of kernels,
// and ~35 ms of idle card between them (PERF.md §5).
//
// Three entries, each over a table of up to kMaxLeaves leaves:
//
//   * hsenet_multi_tensor_sum_squares: one CTA per chunk of kChunk elements
//     of one leaf writes the f32 sum of its squares to partials[chunk];
//   * hsenet_multi_tensor_leaf_sums: one warp per leaf sums its chunks'
//     partials in a fixed order, in f64, into out[leaf] (f32). Nothing is
//     added by atomics: the sums are the same from run to run;
//   * hsenet_multi_tensor_adamw: one CTA per chunk reads g, p, mu, nu and
//     the device scalar grad_norm, and writes p, mu and nu in place. The
//     arithmetic is `AdamW.step`'s loop op for op, each rounding where one
//     of its PyTorch kernels rounds (the `__f*_rn` intrinsics keep nvcc
//     from contracting or reordering), so the two routes give the same
//     bits from the same grad_norm:
//       clip = norm < max ? 1 : (1 / norm) * max   (torch's `max / norm`)
//       g = g * clip
//       mu = fma(g, 1 - b1, mu * b1)               (mul_, add_ with alpha)
//       nu = fma(1 - b2, g * g, nu * b2)           (mul_, addcmul_)
//       u = (mu * (1 / c1)) / (sqrt(nu * (1 / c2)) + eps)
//       u = fma(p, wd, u)                          (only where wd != 0)
//       p = fma(u, -lr, p)                         (sub_ with alpha)
//     A tensor divided by a Python float is a product with the float's
//     reciprocal in PyTorch (taken in f64, rounded to f32); the host
//     passes 1 / c1 and 1 / c2 so rounded.
//
// The table is the kernels' parameter, by value (`__grid_constant__`, up to
// 32 KB on Hopper since CUDA 12.1): the launch copies it by value, so
// the host may rewrite its buffer for the next launch at once, and the
// gradients' pointers, new every step, cost no copy to the device. A CTA
// finds its leaf by a binary search of its chunk in `chunk_start` (each
// leaf's first chunk, the prefix sum of ceil(numel / kChunk)); the wrapper
// (ops/multi_tensor.py `chunk_plan`) computes the same cut.
//
// What bounds it on an H100 SXM (3.35 TB/s): bytes. The sum of squares
// reads g (4 B an element), the update reads g, p, mu, nu and writes p, mu,
// nu (28 B), all f32: 1.9 ms over CLIP's 197 M trained elements and 6.4 ms
// over the VLM's 671 M. Each thread keeps several 16-byte loads of each
// tensor in flight (kSumUnroll, kAdamUnroll); a leaf whose pointers are not
// all 16-byte aligned (a view with a storage offset) takes 4-byte loads,
// and the last chunk of a leaf ends in up to 3 elements taken one by one.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kMaxLeaves = 640;
constexpr long long kChunk = 65536;  // elements of one leaf a CTA
constexpr int kThreads = 256;
constexpr int kSumUnroll = 4;   // 16-byte loads of g a thread has in flight
constexpr int kAdamUnroll = 2;  // ... of each of g, p, mu, nu

// The layout ops/multi_tensor.py `_Table` writes (checked through
// hsenet_multi_tensor_table_bytes). ptr[0..3]: g, p, mu, nu; the sum of
// squares reads ptr[0] only.
struct LeafTable {
  int n;
  int chunk_start[kMaxLeaves + 1];
  long long numel[kMaxLeaves];
  const void* ptr[4][kMaxLeaves];
};

struct Hyper {
  float max_norm, b1, one_minus_b1, b2, one_minus_b2, inv_c1, inv_c2, eps,
      wd, neg_lr;
};

// the leaf that holds `chunk`: the last i < n with chunk_start[i] <= chunk
// (a leaf of 0 elements has no chunk and is never found)
__device__ __forceinline__ int leaf_of(const LeafTable& t, int chunk) {
  int lo = 0, hi = t.n;
  while (hi - lo > 1) {
    const int mid = (lo + hi) >> 1;
    if (t.chunk_start[mid] <= chunk) {
      lo = mid;
    } else {
      hi = mid;
    }
  }
  return lo;
}

__device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// the sum over the CTA of each thread's `v`, in a fixed order
__device__ __forceinline__ float block_sum(float v) {
  __shared__ float warp_sums[kThreads / 32];
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  if (threadIdx.x % 32 == 0) warp_sums[threadIdx.x / 32] = v;
  __syncthreads();
  float s = 0.f;
  if (threadIdx.x == 0) {
    for (int w = 0; w < kThreads / 32; ++w) s += warp_sums[w];
  }
  return s;
}

__global__ void __launch_bounds__(kThreads)
    sum_squares_kernel(const __grid_constant__ LeafTable t,
                       float* __restrict__ partials) {
  const int chunk = blockIdx.x;
  const int leaf = leaf_of(t, chunk);
  const float* g = static_cast<const float*>(t.ptr[0][leaf]);
  const long long c0 = (chunk - t.chunk_start[leaf]) * kChunk;
  const long long c1 = min(c0 + kChunk, t.numel[leaf]);
  float acc = 0.f;
  if (aligned16(g)) {
    const float4* g4 = reinterpret_cast<const float4*>(g + c0);
    const long long nvec = (c1 - c0) / 4;
    for (long long base = threadIdx.x; base < nvec;
         base += kThreads * kSumUnroll) {
      float4 v[kSumUnroll];
#pragma unroll
      for (int u = 0; u < kSumUnroll; ++u) {
        const long long i = base + u * kThreads;
        v[u] = i < nvec ? g4[i] : make_float4(0.f, 0.f, 0.f, 0.f);
      }
#pragma unroll
      for (int u = 0; u < kSumUnroll; ++u) {
        acc = __fmaf_rn(v[u].x, v[u].x, acc);
        acc = __fmaf_rn(v[u].y, v[u].y, acc);
        acc = __fmaf_rn(v[u].z, v[u].z, acc);
        acc = __fmaf_rn(v[u].w, v[u].w, acc);
      }
    }
    const long long i = c0 + nvec * 4 + threadIdx.x;
    if (i < c1) acc = __fmaf_rn(g[i], g[i], acc);
  } else {
    for (long long i = c0 + threadIdx.x; i < c1; i += kThreads) {
      acc = __fmaf_rn(g[i], g[i], acc);
    }
  }
  const float s = block_sum(acc);
  if (threadIdx.x == 0) partials[chunk] = s;
}

__global__ void leaf_sums_kernel(const __grid_constant__ LeafTable t,
                                 const float* __restrict__ partials,
                                 float* __restrict__ out) {
  const int leaf = (blockIdx.x * blockDim.x + threadIdx.x) / 32;
  const int lane = threadIdx.x % 32;
  if (leaf >= t.n) return;
  double acc = 0.0;
  for (int c = t.chunk_start[leaf] + lane; c < t.chunk_start[leaf + 1];
       c += 32) {
    acc += partials[c];
  }
  // a butterfly: every lane ends with the same sum
  for (int o = 16; o > 0; o >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, o);
  if (lane == 0) out[leaf] = static_cast<float>(acc);
}

__device__ __forceinline__ void adam(float& p, float& mu, float& nu, float g,
                                     float clip, const Hyper& h) {
  g = __fmul_rn(g, clip);
  mu = __fmaf_rn(g, h.one_minus_b1, __fmul_rn(mu, h.b1));
  nu = __fmaf_rn(h.one_minus_b2, __fmul_rn(g, g), __fmul_rn(nu, h.b2));
  const float den =
      __fadd_rn(__fsqrt_rn(__fmul_rn(nu, h.inv_c2)), h.eps);
  float u = __fdiv_rn(__fmul_rn(mu, h.inv_c1), den);
  if (h.wd != 0.f) u = __fmaf_rn(p, h.wd, u);
  p = __fmaf_rn(u, h.neg_lr, p);
}

__global__ void __launch_bounds__(kThreads)
    adamw_kernel(const __grid_constant__ LeafTable t,
                 const float* __restrict__ grad_norm, const Hyper h) {
  const int chunk = blockIdx.x;
  const int leaf = leaf_of(t, chunk);
  const float* g = static_cast<const float*>(t.ptr[0][leaf]);
  float* p = static_cast<float*>(const_cast<void*>(t.ptr[1][leaf]));
  float* mu = static_cast<float*>(const_cast<void*>(t.ptr[2][leaf]));
  float* nu = static_cast<float*>(const_cast<void*>(t.ptr[3][leaf]));
  const long long c0 = (chunk - t.chunk_start[leaf]) * kChunk;
  const long long c1 = min(c0 + kChunk, t.numel[leaf]);
  const float norm = *grad_norm;
  const float clip =
      norm < h.max_norm ? 1.f : __fmul_rn(__frcp_rn(norm), h.max_norm);
  if (aligned16(g) && aligned16(p) && aligned16(mu) && aligned16(nu)) {
    const float4* g4 = reinterpret_cast<const float4*>(g + c0);
    float4* p4 = reinterpret_cast<float4*>(p + c0);
    float4* m4 = reinterpret_cast<float4*>(mu + c0);
    float4* v4 = reinterpret_cast<float4*>(nu + c0);
    const long long nvec = (c1 - c0) / 4;
    for (long long base = threadIdx.x; base < nvec;
         base += kThreads * kAdamUnroll) {
      float4 vg[kAdamUnroll], vp[kAdamUnroll], vm[kAdamUnroll],
          vv[kAdamUnroll];
#pragma unroll
      for (int u = 0; u < kAdamUnroll; ++u) {
        const long long i = base + u * kThreads;
        if (i < nvec) {
          vg[u] = g4[i];
          vp[u] = p4[i];
          vm[u] = m4[i];
          vv[u] = v4[i];
        }
      }
#pragma unroll
      for (int u = 0; u < kAdamUnroll; ++u) {
        const long long i = base + u * kThreads;
        if (i < nvec) {
          adam(vp[u].x, vm[u].x, vv[u].x, vg[u].x, clip, h);
          adam(vp[u].y, vm[u].y, vv[u].y, vg[u].y, clip, h);
          adam(vp[u].z, vm[u].z, vv[u].z, vg[u].z, clip, h);
          adam(vp[u].w, vm[u].w, vv[u].w, vg[u].w, clip, h);
          p4[i] = vp[u];
          m4[i] = vm[u];
          v4[i] = vv[u];
        }
      }
    }
    const long long i = c0 + nvec * 4 + threadIdx.x;
    if (i < c1) adam(p[i], mu[i], nu[i], g[i], clip, h);
  } else {
    for (long long i = c0 + threadIdx.x; i < c1; i += kThreads) {
      adam(p[i], mu[i], nu[i], g[i], clip, h);
    }
  }
}

bool valid(const LeafTable* t) {
  return t != nullptr && t->n >= 1 && t->n <= kMaxLeaves &&
         t->chunk_start[0] == 0;
}

}  // namespace

// sizeof the table, so that the wrapper can check its own layout
extern "C" int hsenet_multi_tensor_table_bytes() {
  return static_cast<int>(sizeof(LeafTable));
}

// partials: f32 [chunk_start[n]]
extern "C" int hsenet_multi_tensor_sum_squares(const void* table,
                                               void* partials, void* stream) {
  const LeafTable* t = static_cast<const LeafTable*>(table);
  if (!valid(t)) return static_cast<int>(cudaErrorInvalidValue);
  const int chunks = t->chunk_start[t->n];
  if (chunks == 0) return 0;
  sum_squares_kernel<<<chunks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      *t, static_cast<float*>(partials));
  return static_cast<int>(cudaGetLastError());
}

// out: f32 [n], each leaf's sum of the partials of its chunks (0 for a leaf
// of no chunk)
extern "C" int hsenet_multi_tensor_leaf_sums(const void* table,
                                             const void* partials, void* out,
                                             void* stream) {
  const LeafTable* t = static_cast<const LeafTable*>(table);
  if (!valid(t)) return static_cast<int>(cudaErrorInvalidValue);
  const int warps = kThreads / 32;
  leaf_sums_kernel<<<(t->n + warps - 1) / warps, kThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      *t, static_cast<const float*>(partials), static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

// grad_norm: one f32 on the device; the floats as `Hyper` names them
extern "C" int hsenet_multi_tensor_adamw(const void* table,
                                         const void* grad_norm, float max_norm,
                                         float b1, float one_minus_b1, float b2,
                                         float one_minus_b2, float inv_c1,
                                         float inv_c2, float eps, float wd,
                                         float neg_lr, void* stream) {
  const LeafTable* t = static_cast<const LeafTable*>(table);
  if (!valid(t)) return static_cast<int>(cudaErrorInvalidValue);
  const int chunks = t->chunk_start[t->n];
  if (chunks == 0) return 0;
  const Hyper h{max_norm, b1,     one_minus_b1, b2, one_minus_b2,
                inv_c1,   inv_c2, eps,          wd, neg_lr};
  adamw_kernel<<<chunks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      *t, static_cast<const float*>(grad_norm), h);
  return static_cast<int>(cudaGetLastError());
}
