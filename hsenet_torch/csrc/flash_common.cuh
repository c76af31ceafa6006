// Shared pieces of the port's mma.sync flash-attention kernels for Hopper
// (sm_90a): tile sizes, the mma.sync / ldmatrix / cp.async wrappers and the
// stride block that every kernel takes, for bf16 and f16 operands
// (m16n8k16) and f32 operands (TF32 m16n8k8). Included by flash_fwd.cu,
// flash_bwd_dq.cu and flash_bwd_dkv.cu (and, through hopper.cuh, by the
// wgmma kernels flash_fwd_wgmma.cu and flash_bwd.cu); each builds into its
// own library.
//
// Why TF32 for f32 operands: the tensor cores take f32 only as TF32, which
// keeps 10 of f32's 23 mantissa bits (each operand rounded to within 2^-11
// of its value); f32 FMAs outside the tensor cores run at 67 TFLOP/s
// against TF32's 495. The JAX kernels keep f32 operands in f32 on the
// TPU's MXU; chip_smoke.py holds the f32 kernels to their f32 plain
// versions at 5e-3 of each row's largest value for that reason.

#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace hsenet_flash {

constexpr int kBlockM = 64;  // query rows per tile (16 per warp)
constexpr int kBlockN = 64;  // keys per tile
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
// the 16-bit element types the tensor cores take beside TF32
template <typename T>
constexpr bool kIs16Bit = std::is_same<T, __nv_bfloat16>::value ||
                          std::is_same<T, __half>::value;
// padding per shared-memory row: one 16-byte chunk (8 bf16, 4 f32), so
// fragment reads of 8 consecutive rows hit distinct banks
template <typename T>
constexpr int kPadOf = 16 / static_cast<int>(sizeof(T));
// columns of one tensor-core k-step: 16 bf16 or f16 (m16n8k16), 8 TF32
// (m16n8k8)
template <typename T>
constexpr int kStepOf = std::is_same<T, float>::value ? 8 : 16;
// the output columns one CTA of the mma.sync backward kernels accumulates:
// all of them up to head dim 128; at 256 half, the grid's x axis holding
// both halves (a 64-row f32 tile of 256 columns is 128 registers a thread)
template <int D>
constexpr int kOutColsOf = D > 128 ? 128 : D;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
// the log-sum-exp of a row with no valid column: exp(s - lse) is then 0
// in the backward (the JAX package writes -NEG_INF = 1e30 there)
constexpr float kEmptyRowLse = 1e30f;

// (batch, head, row) strides in elements of one (B, H, S, D) operand
struct Strides3 {
  long long b, h, s;
};

// c += a b on the tensor cores, T (bf16 or f16) operands, f32 sums
template <typename T>
__device__ __forceinline__ void mma_16816(float (&c)[4], const uint32_t (&a)[4],
                                          uint32_t b0, uint32_t b1) {
  if constexpr (std::is_same<T, __half>::value) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  } else {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
}

// f32 -> TF32, rounded to nearest (ties away), in a 32-bit register
__device__ __forceinline__ uint32_t tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

__device__ __forceinline__ void mma_1688(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// A 16 x 8 f32 accumulator tile as the TF32 A fragment of one k-step. The
// step's 8 columns are taken in the order 0, 2, 4, 6, 1, 3, 5, 7 (column t of
// the fragment is the tile's 2t, column t + 4 its 2t + 1), which is where
// the accumulator keeps them; the B fragment of that step reads its rows
// 2t and 2t + 1 to match, and a product's sum does not depend on the order
// of its terms.
__device__ __forceinline__ void acc_as_a_tf32(uint32_t (&a)[4],
                                              float c0, float c1, float c2,
                                              float c3) {
  a[0] = tf32(c0);
  a[1] = tf32(c2);
  a[2] = tf32(c1);
  a[3] = tf32(c3);
}

// four 8x8 matrices of 16-bit elements from shared memory; lane i gives the address of
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

// two floats -> one 32-bit register of two T (bf16 or f16), rounded to
// nearest, `lo` in the low half
template <typename T>
__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  if constexpr (std::is_same<T, __half>::value) {
    __half2 v = __floats2half2_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
  } else {
    __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
  }
}

template <typename T>
__device__ __forceinline__ uint32_t ld32(const T* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// start copying rows [r0, r0 + 64) of one (b, h) slice into a shared tile
// of row pitch D + kPadOf<T>; rows at or past r_end are zero-filled, never
// read
template <typename T, int D>
__device__ __forceinline__ void load_rows(T* dst, const T* base,
                                          long long stride, int r0, int r_end,
                                          int tid) {
  constexpr int LD = D + kPadOf<T>;
  constexpr int V = 16 / static_cast<int>(sizeof(T));  // elements per copy
#pragma unroll
  for (int i = tid; i < 64 * D / V; i += kThreads) {
    const int row = i / (D / V);
    const int col = (i % (D / V)) * V;
    const int r = r0 + row;
    const bool valid = r < r_end;
    cp_async_16(dst + row * LD + col, base + (valid ? r * stride + col : 0),
                valid);
  }
}

// A fragments (16 rows x D, row-major) of rows r0 and r0 + 8, read straight
// from global memory; rows at or past `rows` are zero
template <int D, typename T,
          typename = typename std::enable_if<kIs16Bit<T>>::type>
__device__ __forceinline__ void load_a_rows(uint32_t (&f)[D / 16][4],
                                            const T* base,
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

// TF32 A fragments (16 rows x D, row-major, k-steps of 8) of rows r0 and
// r0 + 8 from global memory; rows at or past `rows` are zero
template <int D>
__device__ __forceinline__ void load_a_rows(uint32_t (&f)[D / 8][4],
                                            const float* base, long long stride,
                                            int r0, int rows, int t) {
  const int r1 = r0 + 8;
#pragma unroll
  for (int kk = 0; kk < D / 8; ++kk) {
    const int c = kk * 8 + t;
    f[kk][0] = r0 < rows ? tf32(base[r0 * stride + c]) : 0u;
    f[kk][1] = r1 < rows ? tf32(base[r1 * stride + c]) : 0u;
    f[kk][2] = r0 < rows ? tf32(base[r0 * stride + c + 4]) : 0u;
    f[kk][3] = r1 < rows ? tf32(base[r1 * stride + c + 4]) : 0u;
  }
}

// write a thread's part of a 16 x D f32 accumulator, scaled, to rows r0 and
// r0 + 8 (as pairs of T: bf16, f16 or f32)
template <typename T, int D>
__device__ __forceinline__ void store_rows(T* base, long long stride,
                                           const float (&acc)[D / 8][4], int r0,
                                           int rows, int t, float s0 = 1.f,
                                           float s1 = 1.f) {
  const int r1 = r0 + 8;
#pragma unroll
  for (int dn = 0; dn < D / 8; ++dn) {
    const int c = dn * 8 + 2 * t;
    if constexpr (std::is_same<T, float>::value) {
      if (r0 < rows) {
        *reinterpret_cast<float2*>(base + r0 * stride + c) =
            make_float2(acc[dn][0] * s0, acc[dn][1] * s0);
      }
      if (r1 < rows) {
        *reinterpret_cast<float2*>(base + r1 * stride + c) =
            make_float2(acc[dn][2] * s1, acc[dn][3] * s1);
      }
    } else {
      if (r0 < rows) {
        *reinterpret_cast<uint32_t*>(base + r0 * stride + c) =
            pack2<T>(acc[dn][0] * s0, acc[dn][1] * s0);
      }
      if (r1 < rows) {
        *reinterpret_cast<uint32_t*>(base + r1 * stride + c) =
            pack2<T>(acc[dn][2] * s1, acc[dn][3] * s1);
      }
    }
  }
}

}  // namespace hsenet_flash
