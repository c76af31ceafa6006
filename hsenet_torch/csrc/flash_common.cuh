// Shared pieces of the port's flash-attention kernels for Hopper (sm_90a):
// tile sizes, the mma.sync / ldmatrix / cp.async wrappers and the stride
// block that every kernel takes. Included by flash_fwd.cu,
// flash_bwd_dq.cu and flash_bwd_dkv.cu; each builds into its own library.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace hsenet_flash {

constexpr int kBlockM = 64;  // query rows per tile (16 per warp)
constexpr int kBlockN = 64;  // keys per tile
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kPad = 8;  // bf16 of padding per shared-memory row
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
// the log-sum-exp of a row with no valid column: exp(s - lse) is then 0
// in the backward (the JAX package writes -NEG_INF = 1e30 there)
constexpr float kEmptyRowLse = 1e30f;

// (batch, head, row) strides in elements of one (B, H, S, D) operand
struct Strides3 {
  long long b, h, s;
};

__device__ __forceinline__ void mma_16816(float (&c)[4], const uint32_t (&a)[4],
                                          uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// four 8x8 bf16 matrices from shared memory; lane i gives the address of
// row i % 8 of matrix i / 8
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a)
      : "memory");
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a)
      : "memory");
}

// 16 bytes global -> shared, asynchronous; zero-fills when !valid
__device__ __forceinline__ void cp_async_16(void* dst, const void* src,
                                            bool valid) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :
               : "r"(a), "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// two floats -> one 32-bit register of bf16, `lo` in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// start copying rows [r0, r0 + 64) of one (b, h) slice into a shared tile
// of row pitch D + kPad; rows at or past r_end are zero-filled, never read
template <int D>
__device__ __forceinline__ void load_rows(__nv_bfloat16* dst,
                                          const __nv_bfloat16* base,
                                          long long stride, int r0, int r_end,
                                          int tid) {
  constexpr int LD = D + kPad;
#pragma unroll
  for (int i = tid; i < 64 * D / 8; i += kThreads) {
    const int row = i / (D / 8);
    const int col = (i % (D / 8)) * 8;
    const int r = r0 + row;
    const bool valid = r < r_end;
    cp_async_16(dst + row * LD + col, base + (valid ? r * stride + col : 0),
                valid);
  }
}

// A fragments (16 rows x D, row-major) of rows r0 and r0 + 8, read straight
// from global memory; rows at or past `rows` are zero
template <int D>
__device__ __forceinline__ void load_a_rows(uint32_t (&f)[D / 16][4],
                                            const __nv_bfloat16* base,
                                            long long stride, int r0, int rows,
                                            int t) {
  const int r1 = r0 + 8;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const int c = kk * 16 + 2 * t;
    f[kk][0] = r0 < rows ? ld32(base + r0 * stride + c) : 0u;
    f[kk][1] = r1 < rows ? ld32(base + r1 * stride + c) : 0u;
    f[kk][2] = r0 < rows ? ld32(base + r0 * stride + c + 8) : 0u;
    f[kk][3] = r1 < rows ? ld32(base + r1 * stride + c + 8) : 0u;
  }
}

// write a thread's part of a 16 x D f32 accumulator as bf16 rows r0, r0 + 8
template <int D>
__device__ __forceinline__ void store_rows(__nv_bfloat16* base,
                                           long long stride,
                                           const float (&acc)[D / 8][4], int r0,
                                           int rows, int t, float s0 = 1.f,
                                           float s1 = 1.f) {
  const int r1 = r0 + 8;
#pragma unroll
  for (int dn = 0; dn < D / 8; ++dn) {
    const int c = dn * 8 + 2 * t;
    if (r0 < rows) {
      *reinterpret_cast<uint32_t*>(base + r0 * stride + c) =
          pack_bf16(acc[dn][0] * s0, acc[dn][1] * s0);
    }
    if (r1 < rows) {
      *reinterpret_cast<uint32_t*>(base + r1 * stride + c) =
          pack_bf16(acc[dn][2] * s1, acc[dn][3] * s1);
    }
  }
}

}  // namespace hsenet_flash
