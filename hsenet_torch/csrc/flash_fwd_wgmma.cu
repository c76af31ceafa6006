// Flash-attention forward for Hopper (sm_90a), bf16 and f16 at head dim 64,
// 128 and 256: a warp-specialised kernel on wgmma, TMA and mbarriers (the
// Hopper helpers are in hopper.cuh). The f32 route stays on flash_fwd.cu
// (TF32 mma.sync), whose bf16 build chip_smoke.py times beside this one.
//
// Replaces the TPU kernels `_flash_kernel` and `_flash_kernel_stream` of the
// JAX package (ops/flash_attention.py, launched by `_flash_forward` and
// `_flash_forward_stream`). Per (batch b, head h, query row r) it computes
//   O[r] = softmax(sm_scale * Q[r] K^T) V
// over the columns c with c < kv_len[b] and, under `causal`, also
// c <= r + q_offset[b], with the softmax in f32. A row with no such column
// gives 0. When `lse` is given it also writes each row's log-sum-exp,
// ln sum_c exp(sm_scale Q[r].K[c]), as (B, H, Sq) f32, and 1e30 (the JAX
// package's -NEG_INF) for a row with no valid column.
//
// What bounds it on an H100 SXM (989 TFLOP/s bf16 and f16, 3.35 TB/s): two
// products of 2 d operations per valid (row, column) pair. The towers (24 x
// 12 heads x 2049 tokens, d 64) do 310 GFLOP, 0.31 ms at peak, against 50 MB
// of Q, K, V and O (0.015 ms): operations. Prefill and the serving
// admissions (a few hundred rows over a few hundred valid keys, d 128) are
// bound by bytes. Inside the SM the old mma.sync kernel (flash_fwd.cu) ran
// at ~20% of the tensor peak: mma.sync issues from each warp in 16 x 8
// steps and reads K and V through ldmatrix, so the tensor cores idle
// between the softmax's instructions. chip_smoke.py recomputes the bound
// from the shapes and data it runs.
//
// Design (FA3's, the public reference design for Hopper):
//   * one CTA per (b, h, query tile of 64 or 128 rows): a consumer
//     warpgroup per 64 rows and a producer warpgroup, one thread of which
//     issues every TMA load; setmaxnreg moves the producer's registers to
//     the consumers. The caller picks the query tile from the grid
//     (`forward_query_tile` in ops/flash_attention.py): 128 rows where the
//     grid fills the card, 64 where a small grid would leave SMs idle
//     (then two CTAs share an SM at head dim 64 and 128);
//   * the producer loads the Q tile once, then streams K and V tiles (128
//     keys; 64 at head dim 256, and at 128 under a 64-row tile) through a
//     two-stage ring each, a full and an empty mbarrier per stage; TMA
//     reads the strided (B, H, S, D) views through 4-D tensor maps with the
//     128-byte swizzle and fills rows past sq and skv with zeros;
//   * S = Q K^T by wgmma, Q and K K-major shared-memory descriptors; S's f32
//     accumulator converts in place into the register A fragments of
//     O += P V (P rounded to bf16 or f16, as the TPU rounds it for its MXU;
//     FA3's layout identity), V an MN-major B descriptor;
//   * the next tile's S = Q K^T is issued before this tile's P V, and the
//     softmax of the next tile runs while P V is in flight
//     (wgmma.wait_group 1), so the tensor cores work under the softmax;
//   * online softmax in f32 in the log2 domain (ex2.approx, quad shuffles
//     for the row max and sum); only tiles that a kv_len or causal edge
//     crosses are masked. Each warpgroup's key loop ends at min(kv_len, its
//     last row + q_offset + 1); past it, it only releases the tiles that
//     its sibling still reads;
//   * the epilogue normalises by the row sum and stores O and the
//     log-sum-exp with guarded stores (rows past sq are not written).
// K and V rows between kv_len and the end of a tile are read, as the TPU
// kernel reads them, and multiplied by exact zeros: they must be finite.

#include "hopper.cuh"

namespace {

using namespace hsenet_hopper;
using hsenet_flash::kEmptyRowLse;
using hsenet_flash::kLn2;
using hsenet_flash::kLog2e;
using hsenet_flash::pack2;
using hsenet_flash::Strides3;

// NWG consumer warpgroups of 64 query rows each and a producer warpgroup.
// setmaxnreg moves registers between whole warpgroups within the CTA's
// allocation, which ptxas sets to the mean of the warpgroups' counts:
// 2 x 232 + 40 over 384 threads (168 each), 232 + 40 over 256 (136), or
// 216 + 40 over 256 (128, two CTAs an SM). A consumer holds O (D / 2
// registers), S (kBlockN / 2) and P (kBlockN / 4).
template <int D, int NWG>
struct Cfg {
  static constexpr int kD = D;
  static constexpr int kNwg = NWG;
  static constexpr int kBlockM = 64 * NWG;
  static constexpr int kBlockN = D == 256 || (D == 128 && NWG == 1) ? 64 : 128;
  static constexpr int kStages = 2;
  static constexpr int kThreads = 128 * (NWG + 1);
  // byte offsets in shared memory from a 1024-aligned base; a tile of R
  // rows is D / 64 blocks of R rows x 128 bytes
  static constexpr int q_bytes = kBlockM * D * 2;
  static constexpr int kv_bytes = kBlockN * D * 2;  // one K or V tile
  static constexpr int q = 0;
  static constexpr int k = q_bytes;
  static constexpr int v = k + kStages * kv_bytes;
  static constexpr int bars = v + kStages * kv_bytes;
  static constexpr int bytes = bars + (4 * kStages + 1) * 8 + 1024;
  // two CTAs an SM where one consumer warpgroup's CTA leaves room (an SM
  // has 228 KB of shared memory, 1 KB of it reserved per CTA)
  static constexpr int kCtasPerSm =
      NWG == 1 && 2 * (bytes + 1024) <= 228 * 1024 ? 2 : 1;
  static constexpr int kConsumerRegs = kCtasPerSm == 2 ? 216 : 232;
};

// S = Q K^T for one key tile: Q's 64 rows of this warpgroup at `q_s`, the
// tile's kBlockN keys at `k_s`, D / 16 k-steps of 16 columns
template <typename T, int D, int NWG>
__device__ __forceinline__ void issue_qk(
    float (&s)[Cfg<D, NWG>::kBlockN / 2], uint32_t q_s, uint32_t k_s) {
  using C = Cfg<D, NWG>;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint64_t da =
        desc(q_s + (kk / 4) * C::kBlockM * kRowBytes + (kk % 4) * 32, 16, 1024);
    const uint64_t db =
        desc(k_s + (kk / 4) * C::kBlockN * kRowBytes + (kk % 4) * 32, 16, 1024);
    if constexpr (C::kBlockN == 128) {
      wgmma_ss_n128<0, 0, T>(s, da, db, kk > 0);
    } else {
      wgmma_ss_n64<0, 0, T>(s, da, db, kk > 0);
    }
  }
}

// O += P V for one key tile: P the register A fragments of kBlockN / 16
// k-steps, V the tile at `v_s` (MN-major), 64 output columns a product
template <typename T, int D, int NWG>
__device__ __forceinline__ void issue_pv(
    float (&o)[D / 64][32], const uint32_t (&p)[Cfg<D, NWG>::kBlockN / 16][4],
    uint32_t v_s) {
  using C = Cfg<D, NWG>;
#pragma unroll
  for (int kk = 0; kk < C::kBlockN / 16; ++kk) {
#pragma unroll
    for (int cb = 0; cb < D / 64; ++cb) {
      wgmma_rs_n64<1, T>(
          o[cb], p[kk],
          desc(v_s + cb * C::kBlockN * kRowBytes + kk * 16 * kRowBytes, 1024,
               1024),
          1);
    }
  }
}

// Row state of the online softmax for this thread's rows r0 and r0 + 8:
// the running max (log2 domain, scaled) and this thread's part of the sum.
struct RowState {
  float m0, m1, l0, l1;
};

// The online softmax of one tile of raw scores `s` (accumulator element
// 4j + e at row e < 2 ? r0 : r0 + 8 and key n0 + 8j + 2t + (e & 1)), in
// place: pairs outside kv_len and the causal edge become -inf when
// `masked`, the running max moves, s becomes P = 2^(scale_log2 s - max), the
// sums take P's; returns in (c0, c1) the factors that rescale what O held.
template <int N>
__device__ __forceinline__ void softmax_tile(float (&s)[N / 2], RowState& st,
                                             float& c0, float& c1, bool masked,
                                             int n0, int r0, int t, int kv_len,
                                             int causal, int q_off,
                                             float scale_log2) {
  if (masked) {
#pragma unroll
    for (int j = 0; j < N / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = n0 + 8 * j + 2 * t + (e & 1);
        const int row = e < 2 ? r0 : r0 + 8;
        if (!(col < kv_len && (!causal || col <= row + q_off))) {
          s[4 * j + e] = -INFINITY;
        }
      }
    }
  }
  float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
  for (int j = 0; j < N / 8; ++j) {
    mx0 = fmaxf(mx0, fmaxf(s[4 * j], s[4 * j + 1]));
    mx1 = fmaxf(mx1, fmaxf(s[4 * j + 2], s[4 * j + 3]));
  }
  mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
  mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
  mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
  mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
  const float mn0 = fmaxf(st.m0, mx0 * scale_log2);
  const float mn1 = fmaxf(st.m1, mx1 * scale_log2);
  // a row with no valid column so far keeps max -inf: subtract 0 there so
  // that 2^(-inf - base) is 0 rather than NaN
  const float b0 = mn0 == -INFINITY ? 0.f : mn0;
  const float b1 = mn1 == -INFINITY ? 0.f : mn1;
  c0 = ex2(st.m0 - b0);
  c1 = ex2(st.m1 - b1);
  st.m0 = mn0;
  st.m1 = mn1;
  float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
  for (int j = 0; j < N / 8; ++j) {
    s[4 * j] = ex2(fmaf(s[4 * j], scale_log2, -b0));
    s[4 * j + 1] = ex2(fmaf(s[4 * j + 1], scale_log2, -b0));
    s[4 * j + 2] = ex2(fmaf(s[4 * j + 2], scale_log2, -b1));
    s[4 * j + 3] = ex2(fmaf(s[4 * j + 3], scale_log2, -b1));
    sum0 += s[4 * j] + s[4 * j + 1];
    sum1 += s[4 * j + 2] + s[4 * j + 3];
  }
  st.l0 = st.l0 * c0 + sum0;
  st.l1 = st.l1 * c1 + sum1;
}

// P (f32, in S's accumulator) as the T A fragments of P V: two 8-key
// accumulator chunks make one 16-key k-step (FA3's layout identity)
template <typename T, int N>
__device__ __forceinline__ void pack_p(uint32_t (&p)[N / 16][4],
                                       const float (&s)[N / 2]) {
#pragma unroll
  for (int kk = 0; kk < N / 16; ++kk) {
#pragma unroll
    for (int x = 0; x < 4; ++x) {
      p[kk][x] = pack2<T>(s[8 * kk + 2 * x], s[8 * kk + 2 * x + 1]);
    }
  }
}

// C: Cfg<D, NWG> (one template argument, so that __launch_bounds__ reads it)
template <typename T, typename C>
__global__ void __launch_bounds__(C::kThreads, C::kCtasPerSm)
    flash_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                           const __grid_constant__ CUtensorMap tm_k,
                           const __grid_constant__ CUtensorMap tm_v,
                           T* __restrict__ o, float* __restrict__ lse,
                           const int* __restrict__ kv_lens,
                           const int* __restrict__ q_offset, int sq, int skv,
                           Strides3 so, int causal, float scale_log2) {
  constexpr int D = C::kD;
  constexpr int NWG = C::kNwg;
  constexpr int kBlockM = C::kBlockM;
  constexpr int kBlockN = C::kBlockN;
  constexpr int kStages = C::kStages;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw));
  const uint32_t base = (raw + 1023) & ~1023u;
  const uint32_t full_k = base + C::bars;  // kStages barriers each
  const uint32_t full_v = full_k + 8 * kStages;
  const uint32_t empty_k = full_v + 8 * kStages;
  const uint32_t empty_v = empty_k + 8 * kStages;
  const uint32_t q_bar = empty_v + 8 * kStages;

  const int b = blockIdx.z;
  const int h = blockIdx.y;
  const int q0 = blockIdx.x * kBlockM;
  const int kv_len = min(max(kv_lens[b], 0), skv);
  const int q_off = q_offset[b];
  // the keys that the rows below `row_end` see: the key loop ends there
  auto keys_for = [&](int row_end) {
    return max(causal ? min(kv_len, row_end + q_off) : kv_len, 0);
  };
  const int n_tiles = (keys_for(min(q0 + kBlockM, sq)) + kBlockN - 1) / kBlockN;

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full_k + 8 * s, 1);  // the producer's arrival + TMA bytes
      mbar_init(full_v + 8 * s, 1);
      mbar_init(empty_k + 8 * s, 4 * NWG);  // one per consumer warp
      mbar_init(empty_v + 8 * s, 4 * NWG);
    }
    mbar_init(q_bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp >= 4 * NWG) {
    // ---- producer: Q once, then K and V tile by tile, one thread ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (warp != 4 * NWG || lane != 0 || n_tiles == 0) return;
    mbar_arrive_tx(q_bar, C::q_bytes);
#pragma unroll
    for (int cb = 0; cb < D / 64; ++cb) {
      tma_load(base + C::q + cb * kBlockM * kRowBytes, &tm_q, q_bar, cb * 64,
               q0, h, b);
    }
    for (int j = 0; j < n_tiles; ++j) {
      const int s = j % kStages;
      const uint32_t free_parity = ((j / kStages) & 1) ^ 1;
      mbar_wait(empty_k + 8 * s, free_parity);
      mbar_arrive_tx(full_k + 8 * s, C::kv_bytes);
#pragma unroll
      for (int cb = 0; cb < D / 64; ++cb) {
        tma_load(base + C::k + s * C::kv_bytes + cb * kBlockN * kRowBytes,
                 &tm_k, full_k + 8 * s, cb * 64, j * kBlockN, h, b);
      }
      mbar_wait(empty_v + 8 * s, free_parity);
      mbar_arrive_tx(full_v + 8 * s, C::kv_bytes);
#pragma unroll
      for (int cb = 0; cb < D / 64; ++cb) {
        tma_load(base + C::v + s * C::kv_bytes + cb * kBlockN * kRowBytes,
                 &tm_v, full_v + 8 * s, cb * 64, j * kBlockN, h, b);
      }
    }
    return;
  }

  // ---- NWG consumer warpgroups, 64 query rows each ----
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(C::kConsumerRegs));
  const int wg = warp / 4;
  const int wq = warp % 4;  // rows 16 wq ... of the warpgroup's 64
  const int g = lane >> 2;
  const int t = lane & 3;
  const int row_lo = q0 + 64 * wg;  // the warpgroup's first row
  const int r0 = row_lo + 16 * wq + g;  // this thread's rows r0, r0 + 8
  const int r1 = r0 + 8;
  const int n_own =
      row_lo < sq ? (keys_for(min(row_lo + 64, sq)) + kBlockN - 1) / kBlockN : 0;
  const uint32_t q_s = base + C::q + wg * 64 * kRowBytes;
  // a tile that every row of the warpgroup sees whole needs no mask
  auto masked = [&](int n0) {
    return !(n0 + kBlockN <= kv_len &&
             (!causal || n0 + kBlockN - 1 <= row_lo + q_off));
  };

  float acc[D / 64][32];
#pragma unroll
  for (int cb = 0; cb < D / 64; ++cb) {
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[cb][i] = 0.f;
  }
  RowState st{-INFINITY, -INFINITY, 0.f, 0.f};
  float s[kBlockN / 2] = {};
  uint32_t p[kBlockN / 16][4];
  float c0, c1;

  if (n_own > 0) {
    mbar_wait(q_bar, 0);
    // the first tile: S, its softmax, P
    mbar_wait(full_k, 0);
    wgmma_fence();
    issue_qk<T, D, NWG>(s, q_s, base + C::k);
    wgmma_commit();
    wgmma_wait<0>();
    pin(s);
    if (lane == 0) mbar_arrive(empty_k);
    softmax_tile<kBlockN>(s, st, c0, c1, masked(0), 0, r0, t, kv_len, causal,
                          q_off, scale_log2);
    pack_p<T, kBlockN>(p, s);

    for (int j = 1; j < n_own; ++j) {
      const int sk = j % kStages;        // tile j's K
      const int sv = (j - 1) % kStages;  // tile j - 1's V
      mbar_wait(full_k + 8 * sk, (j / kStages) & 1);
      pin(s);
      pin(p);
#pragma unroll
      for (int cb = 0; cb < D / 64; ++cb) pin(acc[cb]);
      wgmma_fence();
      issue_qk<T, D, NWG>(s, q_s, base + C::k + sk * C::kv_bytes);
      wgmma_commit();
      mbar_wait(full_v + 8 * sv, ((j - 1) / kStages) & 1);
      issue_pv<T, D, NWG>(acc, p, base + C::v + sv * C::kv_bytes);
      wgmma_commit();
      // tile j's scores are in; its softmax runs under tile j - 1's P V
      wgmma_wait<1>();
      pin(s);
      if (lane == 0) mbar_arrive(empty_k + 8 * sk);
      softmax_tile<kBlockN>(s, st, c0, c1, masked(j * kBlockN), j * kBlockN,
                            r0, t, kv_len, causal, q_off, scale_log2);
      wgmma_wait<0>();
      pin(p);
#pragma unroll
      for (int cb = 0; cb < D / 64; ++cb) pin(acc[cb]);
      if (lane == 0) mbar_arrive(empty_v + 8 * sv);
#pragma unroll
      for (int cb = 0; cb < D / 64; ++cb) {
#pragma unroll
        for (int i = 0; i < 32; ++i) acc[cb][i] *= (i & 2) ? c1 : c0;
      }
      pack_p<T, kBlockN>(p, s);
    }
    // the last tile's P V
    const int sv = (n_own - 1) % kStages;
    mbar_wait(full_v + 8 * sv, ((n_own - 1) / kStages) & 1);
    pin(p);
#pragma unroll
    for (int cb = 0; cb < D / 64; ++cb) pin(acc[cb]);
    wgmma_fence();
    issue_pv<T, D, NWG>(acc, p, base + C::v + sv * C::kv_bytes);
    wgmma_commit();
    wgmma_wait<0>();
#pragma unroll
    for (int cb = 0; cb < D / 64; ++cb) pin(acc[cb]);
    if (lane == 0) mbar_arrive(empty_v + 8 * sv);
  }
  // the tiles that only the sibling warpgroup reads: released as they land
  for (int j = n_own; j < n_tiles; ++j) {
    const int sj = j % kStages;
    const uint32_t parity = (j / kStages) & 1;
    mbar_wait(full_k + 8 * sj, parity);
    if (lane == 0) mbar_arrive(empty_k + 8 * sj);
    mbar_wait(full_v + 8 * sj, parity);
    if (lane == 0) mbar_arrive(empty_v + 8 * sj);
  }

  float l0 = st.l0, l1 = st.l1;
  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  const float inv0 = l0 > 0.f ? 1.f / l0 : 0.f;  // empty row -> 0
  const float inv1 = l1 > 0.f ? 1.f / l1 : 0.f;
  T* o0 = o + b * so.b + h * so.h + static_cast<long long>(r0) * so.s;
  T* o1 = o0 + 8 * so.s;
#pragma unroll
  for (int cb = 0; cb < D / 64; ++cb) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int c = cb * 64 + 8 * j + 2 * t;
      if (r0 < sq) {
        *reinterpret_cast<uint32_t*>(o0 + c) =
            pack2<T>(acc[cb][4 * j] * inv0, acc[cb][4 * j + 1] * inv0);
      }
      if (r1 < sq) {
        *reinterpret_cast<uint32_t*>(o1 + c) =
            pack2<T>(acc[cb][4 * j + 2] * inv1, acc[cb][4 * j + 3] * inv1);
      }
    }
  }
  if (lse != nullptr && t == 0) {
    // ln(sum exp(scale s)) = (max + log2 sum) ln 2, max in the log2 domain
    float* lse_bh = lse + (static_cast<long long>(b) * gridDim.y + h) * sq;
    if (r0 < sq) lse_bh[r0] = l0 > 0.f ? (st.m0 + log2f(l0)) * kLn2 : kEmptyRowLse;
    if (r1 < sq) lse_bh[r1] = l1 > 0.f ? (st.m1 + log2f(l1)) * kLn2 : kEmptyRowLse;
  }
}

template <typename T, int D, int NWG>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   float* lse, const int* kv_lens, const int* q_offset,
                   int batch, int heads, int sq, int skv, const Strides3* st,
                   int causal, float scale_log2, cudaStream_t stream) {
  using C = Cfg<D, NWG>;
  CUtensorMap tm_q, tm_k, tm_v;
  if (!make_map<T>(&tm_q, q, D, sq, heads, batch, st[0], C::kBlockM) ||
      !make_map<T>(&tm_k, k, D, skv, heads, batch, st[1], C::kBlockN) ||
      !make_map<T>(&tm_v, v, D, skv, heads, batch, st[2], C::kBlockN)) {
    return cudaErrorInvalidValue;
  }
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_wgmma_kernel<T, C>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      C::bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((sq + C::kBlockM - 1) / C::kBlockM, heads, batch);
  flash_fwd_wgmma_kernel<T, C><<<grid, C::kThreads, C::bytes, stream>>>(
      tm_q, tm_k, tm_v, static_cast<T*>(o), lse, kv_lens, q_offset, sq, skv,
      st[3], causal, scale_log2);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_tile(int query_tile, const void* q, const void* k,
                        const void* v, void* o, float* lse, const int* kv_lens,
                        const int* q_offset, int batch, int heads, int sq,
                        int skv, const Strides3* st, int causal,
                        float scale_log2, cudaStream_t stream) {
  switch (query_tile) {
    case 64:
      return launch<T, D, 1>(q, k, v, o, lse, kv_lens, q_offset, batch, heads,
                             sq, skv, st, causal, scale_log2, stream);
    case 128:
      return launch<T, D, 2>(q, k, v, o, lse, kv_lens, q_offset, batch, heads,
                             sq, skv, st, causal, scale_log2, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, void* o, void* lse,
             const int* kv_lens, const int* q_offset, int batch, int heads,
             int sq, int skv, int head_dim, int query_tile, const Strides3* st,
             int causal, float sm_scale, void* stream) {
  const float scale_log2 = sm_scale * kLog2e;
  auto* lf = static_cast<float*>(lse);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (head_dim) {
    case 64:
      return static_cast<int>(launch_tile<T, 64>(
          query_tile, q, k, v, o, lf, kv_lens, q_offset, batch, heads, sq, skv,
          st, causal, scale_log2, s));
    case 128:
      return static_cast<int>(launch_tile<T, 128>(
          query_tile, q, k, v, o, lf, kv_lens, q_offset, batch, heads, sq, skv,
          st, causal, scale_log2, s));
    case 256:
      return static_cast<int>(launch_tile<T, 256>(
          query_tile, q, k, v, o, lf, kv_lens, q_offset, batch, heads, sq, skv,
          st, causal, scale_log2, s));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// Launch on `stream` and return a cudaError_t (0 on success); `_bf16` takes
// bf16 Q, K, V and O, `_f16` f16 ones. Pointers are device pointers; `lse`
// is null or a contiguous (B, H, Sq) f32 buffer; `query_tile` is 64 or 128
// rows; strides are in elements; the caller checks dtypes, shapes,
// alignment (16 bytes for every row) and head_dim (64, 128 or 256: it pads
// other widths).
#define HSENET_FLASH_FWD_WGMMA_ENTRY(NAME, T)                                  \
  extern "C" int NAME(                                                         \
      const void* q, const void* k, const void* v, void* o, void* lse,         \
      const int* kv_lens, const int* q_offset, int batch, int heads, int sq,   \
      int skv, int head_dim, int query_tile, long long q_b, long long q_h,     \
      long long q_s, long long k_b, long long k_h, long long k_s,              \
      long long v_b, long long v_h, long long v_s, long long o_b,              \
      long long o_h, long long o_s, int causal, float sm_scale,                \
      void* stream) {                                                          \
    const Strides3 st[4] = {                                                   \
        {q_b, q_h, q_s}, {k_b, k_h, k_s}, {v_b, v_h, v_s}, {o_b, o_h, o_s}};   \
    return dispatch<T>(q, k, v, o, lse, kv_lens, q_offset, batch, heads, sq,   \
                       skv, head_dim, query_tile, st, causal, sm_scale,        \
                       stream);                                                \
  }

HSENET_FLASH_FWD_WGMMA_ENTRY(hsenet_flash_fwd_wgmma_bf16, __nv_bfloat16)
HSENET_FLASH_FWD_WGMMA_ENTRY(hsenet_flash_fwd_wgmma_f16, __half)
