// Flash-attention backward for Hopper (sm_90a), bf16 and f16 at head dim 64
// and 128: dQ, dK and dV in one kernel built on wgmma, TMA, mbarriers and a
// producer warp (the Hopper helpers are in hopper.cuh). Head dim 256 takes
// flash_bwd_dq.cu and flash_bwd_dkv.cu: there a 64-key warpgroup's dK and
// dV accumulators would be 2 x 64 x 256 f32, 256 registers a thread, and K,
// V, the Q/dO ring and the f32 dQ staging more than 227 KB of shared memory.
//
// Replaces the TPU kernels `_bwd_dq_kernel`, `_bwd_dkv_kernel` and their
// streaming twins `_bwd_dq_kernel_stream`, `_bwd_dkv_kernel_stream` of the
// JAX package (ops/flash_attention.py, launched by `_flash_backward`). Per
// (batch b, head h), with the forward's log-sum-exp lse[r] and
// delta[r] = sum_d dO[r, d] O[r, d] (computed by the caller, as the JAX
// package computes it outside its kernels), it recomputes
//   P[r, c] = exp(sm_scale Q[r].K[c] - lse[r])
// over the pairs with c < kv_len[b] and, under `causal`, c <= r + q_offset[b]
// (P is 0 elsewhere), then
//   dS = P (dO V^T - delta) sm_scale,  dQ = dS K,  dK = dS^T Q,  dV = P^T dO.
// Keys at or past kv_len, and a batch row with kv_len 0, get exact zeros.
//
// What bounds it on an H100 SXM (989 TFLOP/s bf16, 3.35 TB/s): five
// products of 2 d operations per valid (row, column) pair (S, dP, dV, dK,
// dQ); at the CLIP tower (24 x 12 x 2049, d 64) that is 0.78 ms at peak
// against 0.1 GB of operands; at the fine-patch tower (2 x 12 x 16,385)
// 4.2 ms. The two kernels it replaces (flash_bwd_dq.cu, flash_bwd_dkv.cu,
// kept for f32) computed S and dP twice: seven products per pair. Inside
// the SM the bound is shared-memory bandwidth: at head dim 64 one 64 x 64
// tile step moves ~120 KB through shared memory (TMA writes, wgmma operand
// reads, dS and the f32 dQ staging) against 2.6 MFLOP, ~940 cycles at 128
// bytes a cycle against ~640 of tensor work; the design keeps operands in
// registers where it can. chip_smoke.py recomputes the bound from the
// shapes and data it runs.
//
// Design:
//   * one CTA per (b, h, key tile) with one consumer warpgroup per 64 keys:
//     at head dim 64 one warpgroup and two CTAs an SM, which interleave; at
//     128 two warpgroups and one CTA an SM. K and V are loaded once by TMA
//     and stay in shared memory (128-byte swizzle, 64-column blocks); at
//     head dim 64 each warpgroup also keeps its K and V rows in registers
//     as the A operands of S^T and dP^T;
//   * one producer warp streams the 64-row tiles of Q and dO through a
//     two-stage ring by TMA (rows past sq arrive as zeros), with each
//     tile's log-sum-exp and delta (read before the stage frees up); an
//     mbarrier per stage says "full" (the TMA bytes and the producer's 32
//     arrivals) and one says "empty" (an arrival from each consumer warp).
//     Under causal the stream starts at the first query tile that sees a
//     key of the tile; a tile at or past kv_len loads nothing and writes
//     zeros. setmaxnreg moves registers from the producer warpgroup to the
//     consumers;
//   * S^T = K Q^T and dP^T = V dO^T run by wgmma, so P^T and dS^T come out
//     of the accumulators in the key rows of the tile; P = 2^(s log2e -
//     lse) on the special-function unit; P^T and dS^T are rounded to bf16
//     (f16) in registers (as the TPU rounds P and dS for its MXU) and are the
//     register A operands of dV += P^T dO and dK += dS^T Q, where dO and Q
//     are MN-major B operands in the ring;
//   * dS^T also goes to shared memory, and each warpgroup computes its 64
//     keys' share of dQ_tile = dS K by wgmma (dS and K MN-major), stages it
//     in f32 in shared memory and adds it into an f32 (B, H, Sq, D)
//     accumulator with the TMA's reduce-add (cp.reduce.async.bulk.tensor),
//     which sums a whole 64 x 32 box in L2; no barrier couples two
//     warpgroups. A second kernel of this file converts the accumulator to
//     bf16 (f16) in the caller's layout. The adds land in an order that changes
//     from run to run, so dQ is not bit-reproducible;
//   * five products per valid pair, not seven; one exponential per pair.

#include "hopper.cuh"

namespace {

using namespace hsenet_hopper;
using hsenet_flash::kLog2e;
using hsenet_flash::pack2;
using hsenet_flash::Strides3;

constexpr int kBlockM = 64;  // query rows per streamed tile

// WGS consumer warpgroups of 64 keys each, and a producer warpgroup of
// which one warp loads. setmaxnreg moves registers between whole
// warpgroups within the CTA's allocation, which ptxas sets to the mean of
// the warpgroups' setmaxnreg counts: 2 x 232 + 40 over 384 threads (168
// each, one CTA an SM), or 216 + 40 over 256 threads (128 each, two CTAs
// an SM). A count that does not fit the allocation never returns.
template <int WGS>
struct Cfg {
  static constexpr int kBlockN = 64 * WGS;  // keys per CTA
  static constexpr int kConsumerThreads = 128 * WGS;
  static constexpr int kThreads = kConsumerThreads + 128;
  static constexpr int kConsumerRegs = WGS == 2 ? 232 : 216;
  static constexpr int kCtasPerSm = WGS == 2 ? 1 : 2;
};

// consumer warpgroups a CTA: at head dim 64 one, so that two CTAs share an
// SM and interleave; at 128 two, since a CTA's registers and shared memory
// allow only one
template <int D>
constexpr int kWgsOf = D == 64 ? 1 : 2;

// byte offsets in the CTA's shared memory (from a 1024-aligned base); a
// tile of R rows x D columns is D / 64 blocks of R rows x 128 bytes
template <int D, int WGS>
struct Layout {
  static constexpr int kStages = 2;
  static constexpr int kv_tile = Cfg<WGS>::kBlockN * D * 2;
  static constexpr int q_tile = kBlockM * D * 2;
  static constexpr int ds_tile = 64 * kBlockM * 2;  // a warpgroup's dS^T
  static constexpr int dq_tile = kBlockM * D * 4;   // a warpgroup's f32 dQ
  static constexpr int k = 0;
  static constexpr int v = kv_tile;
  static constexpr int q = 2 * kv_tile;
  static constexpr int d_o = q + kStages * q_tile;
  static constexpr int ds = d_o + kStages * q_tile;
  static constexpr int dq = ds + WGS * ds_tile;
  static constexpr int stats = dq + WGS * dq_tile;  // lse (log2), delta
  static constexpr int bars = stats + kStages * 2 * kBlockM * 4;
  static constexpr int bytes = bars + (2 * kStages + 1) * 8 + 1024;
};

template <typename T, int D, int WGS>
__global__ void __launch_bounds__(Cfg<WGS>::kThreads, Cfg<WGS>::kCtasPerSm)
    flash_bwd_kernel(const __grid_constant__ CUtensorMap tm_q,
                     const __grid_constant__ CUtensorMap tm_k,
                     const __grid_constant__ CUtensorMap tm_v,
                     const __grid_constant__ CUtensorMap tm_do,
                     const __grid_constant__ CUtensorMap tm_dq,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, T* __restrict__ dk,
                     T* __restrict__ dv, const int* __restrict__ kv_lens,
                     const int* __restrict__ q_offset, int sq, int skv,
                     Strides3 sdk, Strides3 sdv, int causal, float scale_log2,
                     float sm_scale) {
  using L = Layout<D, WGS>;
  constexpr int kBlockN = Cfg<WGS>::kBlockN;
  constexpr int kConsumerThreads = Cfg<WGS>::kConsumerThreads;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw));
  const uint32_t base = (raw + 1023) & ~1023u;
  unsigned char* smem = smem_raw + (base - raw);
  float* stats = reinterpret_cast<float*>(smem + L::stats);
  constexpr int kStages = L::kStages;
  const uint32_t full = base + L::bars;        // kStages barriers
  const uint32_t empty = full + 8 * kStages;   // kStages barriers
  const uint32_t kv_bar = empty + 8 * kStages;

  const int b = blockIdx.z;
  const int h = blockIdx.y;
  const int k0 = blockIdx.x * kBlockN;
  const int kv_len = min(max(kv_lens[b], 0), skv);
  const int q_off = q_offset[b];
  // queries that see a key of this tile: row >= k0 - q_offset
  const int m_first = causal ? max(0, k0 - q_off) / kBlockM * kBlockM : 0;
  const int n_tiles = k0 < kv_len && m_first < sq
                          ? (sq - m_first + kBlockM - 1) / kBlockM
                          : 0;
  const long long row_base = (static_cast<long long>(b) * gridDim.y + h) * sq;

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full + 8 * s, 32);  // the producer warp's lanes (+ TMA bytes)
      mbar_init(empty + 8 * s, kConsumerThreads / 32);  // one per consumer warp
    }
    mbar_init(kv_bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp >= kConsumerThreads / 32) {
    // ---- producer warp: K and V once, then Q, dO, lse, delta per tile ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (warp != kConsumerThreads / 32) return;  // the other three idle
    if (n_tiles > 0 && lane == 0) {
      mbar_arrive_tx(kv_bar, 2 * L::kv_tile);
#pragma unroll
      for (int cb = 0; cb < D / 64; ++cb) {
        tma_load(base + L::k + cb * kBlockN * kRowBytes, &tm_k, kv_bar, cb * 64,
                 k0, h, b);
        tma_load(base + L::v + cb * kBlockN * kRowBytes, &tm_v, kv_bar, cb * 64,
                 k0, h, b);
      }
    }
    for (int it = 0; it < n_tiles; ++it) {
      const int s = it % kStages;
      const int m0 = m_first + it * kBlockM;
      // the tile's log-sum-exp (log2 domain) and delta, two rows a lane,
      // read before the stage is free so that their latency overlaps
      float l2[2], dl[2];
#pragma unroll
      for (int x = 0; x < 2; ++x) {
        const int r = m0 + lane + 32 * x;
        l2[x] = r < sq ? lse[row_base + r] * kLog2e : 0.f;
        dl[x] = r < sq ? delta[row_base + r] : 0.f;
      }
      mbar_wait(empty + 8 * s, ((it / kStages) & 1) ^ 1);
      float* st = stats + s * 2 * kBlockM;
#pragma unroll
      for (int x = 0; x < 2; ++x) {
        st[lane + 32 * x] = l2[x];
        st[kBlockM + lane + 32 * x] = dl[x];
      }
      if (lane == 0) {
        mbar_arrive_tx(full + 8 * s, 2 * L::q_tile);
#pragma unroll
        for (int cb = 0; cb < D / 64; ++cb) {
          const uint32_t off = s * L::q_tile + cb * kBlockM * kRowBytes;
          tma_load(base + L::q + off, &tm_q, full + 8 * s, cb * 64, m0, h, b);
          tma_load(base + L::d_o + off, &tm_do, full + 8 * s, cb * 64, m0, h,
                   b);
        }
      } else {
        mbar_arrive(full + 8 * s);
      }
    }
  } else {
    // ---- WGS consumer warpgroups, 64 keys each ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(
        Cfg<WGS>::kConsumerRegs));
    const int wg = warp / 4;  // keys k0 + 64 wg ... + 63
    const int wq = warp % 4;  // rows 16 wq ... of the warpgroup's tiles
    const int g = lane >> 2;
    const int t = lane & 3;
    const int key0 = k0 + 64 * wg + 16 * wq + g;  // this thread's two keys
    const int key1 = key0 + 8;

    float acc_dk[D / 64][32], acc_dv[D / 64][32];
#pragma unroll
    for (int cb = 0; cb < D / 64; ++cb) {
#pragma unroll
      for (int i = 0; i < 32; ++i) acc_dk[cb][i] = acc_dv[cb][i] = 0.f;
    }
    if (n_tiles > 0) mbar_wait(kv_bar, 0);
    // At head dim 64 the warpgroup's K and V rows stay in registers as the
    // A operands of S^T and dP^T (16 registers each), so those products
    // read only Q and dO from shared memory, whose bandwidth bounds this
    // kernel: the A fragment of k-step kk holds rows (g, g + 8) x columns
    // (16 kk + 2t, + 8) of the 128-byte-swizzled tile
    constexpr int kRegKV = D == 64 ? D / 16 : 1;
    uint32_t kf[kRegKV][4], vf[kRegKV][4];
    if constexpr (D == 64) {
      const int r0 = 64 * wg + 16 * wq + g;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
#pragma unroll
        for (int x = 0; x < 4; ++x) {
          const int r = r0 + (x & 1) * 8;
          const uint32_t off = r * kRowBytes +
                               (((2 * kk + (x >> 1)) ^ (r & 7)) << 4) + 4 * t;
          asm volatile("ld.shared.b32 %0, [%1];\n"
                       : "=r"(kf[kk][x]) : "r"(base + L::k + off));
          asm volatile("ld.shared.b32 %0, [%1];\n"
                       : "=r"(vf[kk][x]) : "r"(base + L::v + off));
        }
      }
    }

    // this warpgroup's dS^T rows, its K rows and its f32 dQ staging tile
    // (D / 32 boxes of 64 rows x 128 bytes, swizzled as TMA reads them)
    const uint32_t ds_s = base + L::ds + wg * L::ds_tile;
    const uint32_t k_own = base + L::k + wg * 64 * kRowBytes;
    const uint32_t dq_s = base + L::dq + wg * L::dq_tile;
    const bool leader = threadIdx.x % 128 == 0;
    const int bar_id = 1 + wg;  // named barrier of this warpgroup's warps
    const int lr0 = 16 * wq + g;  // this thread's rows in the warpgroup's tiles
    const int lr1 = lr0 + 8;

    for (int it = 0; it < n_tiles; ++it) {
      const int s = it % kStages;
      const int m0 = m_first + it * kBlockM;
      const uint32_t q_s = base + L::q + s * L::q_tile;
      const uint32_t do_s = base + L::d_o + s * L::q_tile;
      mbar_wait(full + 8 * s, (it / kStages) & 1);

      // S^T = K Q^T and dP^T = V dO^T: 64 keys x 64 query rows each
      float st[32], dpt[32];
      pin(st);
      pin(dpt);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t a = (kk / 4) * kBlockN * kRowBytes + wg * 64 * kRowBytes +
                           (kk % 4) * 32;
        const uint32_t bq = (kk / 4) * kBlockM * kRowBytes + (kk % 4) * 32;
        if constexpr (D == 64) {
          wgmma_rs_n64<0, T>(st, kf[kk], desc(q_s + bq, 16, 1024), kk > 0);
          wgmma_rs_n64<0, T>(dpt, vf[kk], desc(do_s + bq, 16, 1024), kk > 0);
        } else {
          wgmma_ss_n64<0, 0, T>(st, desc(base + L::k + a, 16, 1024),
                             desc(q_s + bq, 16, 1024), kk > 0);
          wgmma_ss_n64<0, 0, T>(dpt, desc(base + L::v + a, 16, 1024),
                             desc(do_s + bq, 16, 1024), kk > 0);
        }
      }
      wgmma_commit();
      wgmma_wait<0>();
      pin(st);
      pin(dpt);

      // P^T and dS^T; accumulator element 4j + e sits at key (e < 2 ? key0 :
      // key1) and query row m0 + 8j + 2t + (e & 1)
      const float* lse_s = stats + s * 2 * kBlockM;
      const float* dl_s = lse_s + kBlockM;
      const bool whole = k0 + kBlockN <= kv_len && m0 + kBlockM <= sq &&
                         (!causal || k0 + kBlockN - 1 <= m0 + q_off);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = 8 * j + 2 * t + (e & 1);
          const int key = e < 2 ? key0 : key1;
          const int r = m0 + i;
          const bool ok = whole || (key < kv_len && r < sq &&
                                    (!causal || key <= r + q_off));
          const float p =
              ok ? ex2(fmaf(st[4 * j + e], scale_log2, -lse_s[i])) : 0.f;
          st[4 * j + e] = p;
          dpt[4 * j + e] = p * (dpt[4 * j + e] - dl_s[i]) * sm_scale;
        }
      }
      // bf16 (f16) A fragments of the 4 k-steps (16 query rows each)
      uint32_t pa[4][4], dsa[4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
        for (int x = 0; x < 4; ++x) {
          pa[kk][x] = pack2<T>(st[8 * kk + 2 * x], st[8 * kk + 2 * x + 1]);
          dsa[kk][x] = pack2<T>(dpt[8 * kk + 2 * x], dpt[8 * kk + 2 * x + 1]);
        }
      }
      // dS^T into shared memory: 64 key rows of 64 query columns (128
      // bytes), swizzled as TMA would store them. The last iteration's dQ
      // product, which read it, has completed (wgmma_wait<0> below)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const uint32_t a0 = ds_s + lr0 * kRowBytes + ((j ^ (lr0 & 7)) << 4) + 4 * t;
        const uint32_t a1 = ds_s + lr1 * kRowBytes + ((j ^ (lr1 & 7)) << 4) + 4 * t;
        asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(a0),
                     "r"(dsa[j / 2][(j % 2) * 2]));
        asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(a1),
                     "r"(dsa[j / 2][(j % 2) * 2 + 1]));
      }
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      // the staging tile is free once the last reduce has read it
      if (leader) bulk_wait_read();
      asm volatile("bar.sync %0, 128;\n" ::"r"(bar_id) : "memory");

      // dV += P^T dO and dK += dS^T Q: register A, MN-major B
      pin(pa);
      pin(dsa);
#pragma unroll
      for (int cb = 0; cb < D / 64; ++cb) {
        pin(acc_dv[cb]);
        pin(acc_dk[cb]);
      }
      wgmma_fence();
#pragma unroll
      for (int cb = 0; cb < D / 64; ++cb) {
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          const uint32_t off = cb * kBlockM * kRowBytes + kk * 16 * kRowBytes;
          wgmma_rs_n64<1, T>(acc_dv[cb], pa[kk], desc(do_s + off, 1024, 1024), 1);
          wgmma_rs_n64<1, T>(acc_dk[cb], dsa[kk], desc(q_s + off, 1024, 1024), 1);
        }
      }
      wgmma_commit();

      // this warpgroup's share of the tile's dQ, dS K over its 64 keys (dS
      // and K both MN-major), 64 columns at a time, staged in f32
#pragma unroll
      for (int cb = 0; cb < D / 64; ++cb) {
        float dq[32];
        pin(dq);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          wgmma_ss_n64<1, 1, T>(
              dq, desc(ds_s + kk * 16 * kRowBytes, 1024, 1024),
              desc(k_own + cb * kBlockN * kRowBytes + kk * 16 * kRowBytes, 1024,
                   1024),
              kk > 0);
        }
        wgmma_commit();
        wgmma_wait<0>();
        pin(dq);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int c = cb * 64 + 8 * j + 2 * t;  // column in the tile
          const uint32_t box = dq_s + (c >> 5) * (kBlockM * kRowBytes);
          const uint32_t in = (c & 3) * 4;
          const uint32_t a0 =
              box + lr0 * kRowBytes + ((((c & 31) >> 2) ^ (lr0 & 7)) << 4) + in;
          const uint32_t a1 =
              box + lr1 * kRowBytes + ((((c & 31) >> 2) ^ (lr1 & 7)) << 4) + in;
          asm volatile("st.shared.v2.f32 [%0], {%1, %2};\n" ::"r"(a0),
                       "f"(dq[4 * j]), "f"(dq[4 * j + 1]));
          asm volatile("st.shared.v2.f32 [%0], {%1, %2};\n" ::"r"(a1),
                       "f"(dq[4 * j + 2]), "f"(dq[4 * j + 3]));
        }
      }
      pin(pa);
      pin(dsa);
#pragma unroll
      for (int cb = 0; cb < D / 64; ++cb) {
        pin(acc_dv[cb]);
        pin(acc_dk[cb]);
      }
      if (lane == 0) mbar_arrive(empty + 8 * s);  // this stage is read

      // add the staged tile into the f32 (B, H, Sq, D) accumulator
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      asm volatile("bar.sync %0, 128;\n" ::"r"(bar_id) : "memory");
      if (leader) {
#pragma unroll
        for (int bx = 0; bx < D / 32; ++bx) {
          tma_reduce_add(&tm_dq, dq_s + bx * kBlockM * kRowBytes, bx * 32, m0,
                         h, b);
        }
        bulk_commit();
      }
    }
    if (leader) bulk_wait();  // shared memory stays until the adds are done

    // dK and dV rows key0, key1 (zeros for keys past kv_len)
    T* dk0 = dk + b * sdk.b + h * sdk.h + static_cast<long long>(key0) * sdk.s;
    T* dv0 = dv + b * sdv.b + h * sdv.h + static_cast<long long>(key0) * sdv.s;
#pragma unroll
    for (int cb = 0; cb < D / 64; ++cb) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int c = cb * 64 + 8 * j + 2 * t;
        if (key0 < skv) {
          *reinterpret_cast<uint32_t*>(dk0 + c) =
              pack2<T>(acc_dk[cb][4 * j], acc_dk[cb][4 * j + 1]);
          *reinterpret_cast<uint32_t*>(dv0 + c) =
              pack2<T>(acc_dv[cb][4 * j], acc_dv[cb][4 * j + 1]);
        }
        if (key1 < skv) {
          *reinterpret_cast<uint32_t*>(dk0 + 8 * sdk.s + c) =
              pack2<T>(acc_dk[cb][4 * j + 2], acc_dk[cb][4 * j + 3]);
          *reinterpret_cast<uint32_t*>(dv0 + 8 * sdv.s + c) =
              pack2<T>(acc_dv[cb][4 * j + 2], acc_dv[cb][4 * j + 3]);
        }
      }
    }
  }
}

// dQ (T, the caller's strides) from the f32 (B, H, Sq, D) accumulator;
// each thread converts eight adjacent columns (two 16-byte reads, one
// 16-byte write)
template <typename T>
__global__ void dq_convert_kernel(const float* __restrict__ acc,
                                  T* __restrict__ dq, int heads, int sq,
                                  int d, Strides3 sdq, long long groups) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= groups) return;
  const long long e = 8 * i;
  const int c = static_cast<int>(e % d);
  const long long row = e / d;
  const int r = static_cast<int>(row % sq);
  const long long bh = row / sq;
  const int h = static_cast<int>(bh % heads);
  const long long b = bh / heads;
  const float4 x = *reinterpret_cast<const float4*>(acc + e);
  const float4 y = *reinterpret_cast<const float4*>(acc + e + 4);
  *reinterpret_cast<uint4*>(dq + b * sdq.b + h * sdq.h + r * sdq.s + c) =
      make_uint4(pack2<T>(x.x, x.y), pack2<T>(x.z, x.w), pack2<T>(y.x, y.y),
                 pack2<T>(y.z, y.w));
}

template <typename T, int D, int WGS>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* d_o, const float* lse, const float* delta,
                   float* dq_acc, void* dq, void* dk, void* dv,
                   const int* kv_lens, const int* q_offset, int batch,
                   int heads, int sq, int skv, const Strides3* st, int causal,
                   float sm_scale, cudaStream_t stream) {
  // st: q, k, v, dO, dQ, dK, dV
  CUtensorMap tm_q, tm_k, tm_v, tm_do, tm_dq;
  const Strides3 acc{static_cast<long long>(heads) * sq * D,
                     static_cast<long long>(sq) * D, D};
  if (!make_map<T>(&tm_q, q, D, sq, heads, batch, st[0], kBlockM) ||
      !make_map<T>(&tm_k, k, D, skv, heads, batch, st[1], Cfg<WGS>::kBlockN) ||
      !make_map<T>(&tm_v, v, D, skv, heads, batch, st[2], Cfg<WGS>::kBlockN) ||
      !make_map<T>(&tm_do, d_o, D, sq, heads, batch, st[3], kBlockM) ||
      !make_map<float>(&tm_dq, dq_acc, D, sq, heads, batch, acc, kBlockM)) {
    return cudaErrorInvalidValue;
  }
  constexpr int bytes = Layout<D, WGS>::bytes;
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_kernel<T, D, WGS>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (err != cudaSuccess) return err;
  constexpr int kBlockN = Cfg<WGS>::kBlockN;
  const dim3 grid((skv + kBlockN - 1) / kBlockN, heads, batch);
  flash_bwd_kernel<T, D, WGS><<<grid, Cfg<WGS>::kThreads, bytes, stream>>>(
      tm_q, tm_k, tm_v, tm_do, tm_dq, lse, delta, static_cast<T*>(dk),
      static_cast<T*>(dv), kv_lens, q_offset, sq, skv, st[5], st[6], causal,
      sm_scale * kLog2e, sm_scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const long long groups = static_cast<long long>(batch) * heads * sq * D / 8;
  const int threads = 256;
  dq_convert_kernel<T>
      <<<static_cast<unsigned>((groups + threads - 1) / threads), threads, 0,
         stream>>>(dq_acc, static_cast<T*>(dq), heads, sq, D, st[4], groups);
  return cudaGetLastError();
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, const void* d_o,
             const void* lse, const void* delta, void* dq_acc, void* dq,
             void* dk, void* dv, const int* kv_lens, const int* q_offset,
             int batch, int heads, int sq, int skv, int head_dim,
             const Strides3* st, int causal, float sm_scale, void* stream) {
  const auto* lf = static_cast<const float*>(lse);
  const auto* df = static_cast<const float*>(delta);
  auto* acc = static_cast<float*>(dq_acc);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (head_dim) {
    case 64:
      return static_cast<int>(launch<T, 64, kWgsOf<64>>(
          q, k, v, d_o, lf, df, acc, dq, dk, dv, kv_lens, q_offset, batch,
          heads, sq, skv, st, causal, sm_scale, s));
    case 128:
      return static_cast<int>(launch<T, 128, kWgsOf<128>>(
          q, k, v, d_o, lf, df, acc, dq, dk, dv, kv_lens, q_offset, batch,
          heads, sq, skv, st, causal, sm_scale, s));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// Launches on `stream` and returns a cudaError_t (0 on success); `_bf16`
// takes bf16 Q, K, V, dO, dQ, dK and dV, `_f16` f16 ones. Pointers are
// device pointers; `lse` and `delta` are contiguous (B, H, Sq) f32; `dq_acc`
// a zeroed contiguous (B, H, Sq, D) f32 buffer the kernel adds dQ into;
// strides are in elements; the caller checks dtypes, shapes, alignment (16
// bytes for every row) and head_dim (64 or 128).
#define HSENET_FLASH_BWD_ENTRY(NAME, T)                                        \
  extern "C" int NAME(                                                         \
      const void* q, const void* k, const void* v, const void* d_o,            \
      const void* lse, const void* delta, void* dq_acc, void* dq, void* dk,    \
      void* dv, const int* kv_lens, const int* q_offset, int batch, int heads, \
      int sq, int skv, int head_dim, long long q_b, long long q_h,             \
      long long q_s, long long k_b, long long k_h, long long k_s,              \
      long long v_b, long long v_h, long long v_s, long long do_b,             \
      long long do_h, long long do_s, long long dq_b, long long dq_h,          \
      long long dq_s, long long dk_b, long long dk_h, long long dk_s,          \
      long long dv_b, long long dv_h, long long dv_s, int causal,              \
      float sm_scale, void* stream) {                                          \
    const Strides3 st[7] = {{q_b, q_h, q_s},    {k_b, k_h, k_s},               \
                            {v_b, v_h, v_s},    {do_b, do_h, do_s},            \
                            {dq_b, dq_h, dq_s}, {dk_b, dk_h, dk_s},            \
                            {dv_b, dv_h, dv_s}};                               \
    return dispatch<T>(q, k, v, d_o, lse, delta, dq_acc, dq, dk, dv, kv_lens,  \
                       q_offset, batch, heads, sq, skv, head_dim, st, causal,  \
                       sm_scale, stream);                                      \
  }

HSENET_FLASH_BWD_ENTRY(hsenet_flash_bwd_bf16, __nv_bfloat16)
HSENET_FLASH_BWD_ENTRY(hsenet_flash_bwd_f16, __half)
