// Flash-attention backward, dQ, for Hopper (sm_90a): the f32 route (f32 in
// and out, TF32 products, f32 accumulation) at head dim 64 and 128, the
// bf16 and f16 route at head dim 256 (where flash_bwd.cu's tiling does not
// fit: see below), and every dtype's wide route above those widths. The
// bf16 and f16 route of the port's backward at 64 and 128 is flash_bwd.cu;
// this file's bf16 instantiation there stays as the yardstick
// chip_smoke.py times that kernel against.
//
// Replaces the TPU kernel `_bwd_dq_kernel` of the JAX package
// (ops/flash_attention.py, launched by `_flash_backward`). Per (batch b,
// head h, query row r), with the forward's log-sum-exp `lse[r]` and
// delta[r] = sum_d dO[r, d] O[r, d], it recomputes
//   P[r, c] = exp(sm_scale Q[r].K[c] - lse[r])
// over the columns c < kv_len[b] (and, under `causal`, c <= r + q_offset[b];
// P is 0 elsewhere), then
//   dS[r, c] = P[r, c] (dO[r].V[c] - delta[r]) sm_scale,   dQ[r] = sum_c dS[r, c] K[c].
// A row with no valid column gets dQ = 0.
//
// What bounds it on an H100 SXM (989 TFLOP/s bf16, 3.35 TB/s): three
// products of 2 d operations per valid (row, column) pair (S, dP, dQ). At
// the LLM training shape (3 x 24 heads x 800 tokens, d 128, causal, kv_lens
// 800/700/560) that is 17 GFLOP (17 us) against 69 MB of Q, dO, dQ and of
// the K and V rows below kv_len (21 us): bytes, narrowly.
// chip_smoke.py recomputes the bound from the shapes and data it runs.
//
// Design (mma.sync, for both element types; f32 runs the same tiling with
// TF32 m16n8k8 products on 32-bit shared-memory loads, see
// flash_common.cuh), the forward's layout turned to the gradient:
//   * one CTA of 4 warps per (b, h, 64-row query tile); each warp keeps the
//     A fragments of its 16 rows of Q and of dO in registers, and their
//     log-sum-exp and delta;
//   * K and V tiles of 64 keys stream through a two-stage cp.async ring;
//     each tile is taken 16 keys at a time, so the score, dP and dS
//     fragments of one chunk are all a thread holds besides its dQ sum;
//   * S = Q K^T and dP = dO V^T read K and V as B operands by ldmatrix; dS
//     is rounded to bf16 as an A fragment and dQ += dS K reads K again by
//     ldmatrix.trans;
//   * the loop over K/V stops at min(kv_len, last row + q_offset + 1) as
//     in the forward, so tiles past kv_len or wholly above the diagonal
//     are never read. No atomics: each CTA owns its dQ rows;
//   * at head dim 256 (bf16 and f16 only) the A fragments of Q and dO take
//     128 registers a thread, so a CTA accumulates only 128 of dQ's
//     columns: the grid's x axis holds both halves of each query tile, and
//     each CTA computes S and dP over the full width for its half. That
//     costs S and dP twice (five products per valid pair, not three), a
//     price for a width that no configuration of the package runs. The
//     wide route below takes 256 too, at 2.5-2.7x this split's time
//     (chip_smoke.py [kernel-bwd], PERF.md), so 256 keeps it.
//
// The wide route (`_wide` entries: bf16 and f16 above head dim 256, f32
// above 128, any multiple of 64; ROADMAP C2), where even Q's and dO's A
// fragments of the full width do not fit the registers:
//   * one CTA per (b, h, 64-row query tile, 64-column block of dQ), the
//     grid's x axis holding the column blocks;
//   * S = Q K^T and dP = dO V^T are summed chunk by chunk: 64-column chunks
//     of Q, dO and the K and V tiles stream through the two-stage cp.async
//     ring, A fragments read from shared memory;
//   * the CTA's 64 columns of the K tile arrive with the tile's first chunk
//     (two buffers, by tile parity) for dQ += dS K;
//   * every column block recomputes S and dP over the full width (D / 64
//     times the two products). Right, not fast.

#include "flash_common.cuh"

namespace {

using namespace hsenet_flash;

template <typename T, int D>
constexpr int smem_bytes() {  // two stages of one K and one V tile
  return 2 * 2 * kBlockN * (D + kPadOf<T>) * static_cast<int>(sizeof(T));
}

struct Strides {
  Strides3 q, k, v, d_o, dq;
};

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const T* __restrict__ d_o,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta, T* __restrict__ dq,
                        const int* __restrict__ kv_lens,
                        const int* __restrict__ q_offset, int sq, int skv,
                        Strides st, int causal, float scale_log2,
                        float sm_scale) {
  constexpr bool kF32 = std::is_same<T, float>::value;
  constexpr int LD = D + kPadOf<T>;
  constexpr int kTile = kBlockN * LD;
  constexpr int KS = kStepOf<T>;
  constexpr int DO = kOutColsOf<D>;
  constexpr int kSplit = D / DO;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* smem = reinterpret_cast<T*>(smem_raw);

  const int b = blockIdx.z;
  const int h = blockIdx.y;
  const int q_start = blockIdx.x / kSplit * kBlockM;
  const int c_out = blockIdx.x % kSplit * DO;  // this CTA's first dQ column
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int lrow = lane & 7;
  const int lmat = lane >> 3;

  const int kv_len = min(max(kv_lens[b], 0), skv);
  const int q_off = q_offset[b];
  int n_end = kv_len;
  if (causal) n_end = min(n_end, min(q_start + kBlockM, sq) + q_off);
  n_end = max(n_end, 0);
  const int n_tiles = (n_end + kBlockN - 1) / kBlockN;

  const T* k_base = k + b * st.k.b + h * st.k.h;
  const T* v_base = v + b * st.v.b + h * st.v.h;
  if (n_tiles > 0) {
    load_rows<T, D>(smem, k_base, st.k.s, 0, n_end, tid);
    load_rows<T, D>(smem + kTile, v_base, st.v.s, 0, n_end, tid);
  }
  cp_async_commit();

  const int r0 = q_start + warp * 16 + g;
  const int r1 = r0 + 8;
  uint32_t qf[D / KS][4];
  uint32_t df[D / KS][4];
  load_a_rows<D>(qf, q + b * st.q.b + h * st.q.h, st.q.s, r0, sq, t);
  load_a_rows<D>(df, d_o + b * st.d_o.b + h * st.d_o.h, st.d_o.s, r0, sq, t);
  // log-sum-exp in the log2 domain; rows past sq get +inf so P is 0
  const long long row_base = (static_cast<long long>(b) * gridDim.y + h) * sq;
  const float lse0 = r0 < sq ? lse[row_base + r0] * kLog2e : INFINITY;
  const float lse1 = r1 < sq ? lse[row_base + r1] * kLog2e : INFINITY;
  const float dl0 = r0 < sq ? delta[row_base + r0] : 0.f;
  const float dl1 = r1 < sq ? delta[row_base + r1] : 0.f;

  float acc[DO / 8][4];
#pragma unroll
  for (int dn = 0; dn < DO / 8; ++dn) {
    acc[dn][0] = acc[dn][1] = acc[dn][2] = acc[dn][3] = 0.f;
  }

  for (int tile = 0; tile < n_tiles; ++tile) {
    const int n0 = tile * kBlockN;
    if (tile + 1 < n_tiles) {
      T* nxt = smem + ((tile + 1) & 1) * 2 * kTile;
      load_rows<T, D>(nxt, k_base, st.k.s, n0 + kBlockN, n_end, tid);
      load_rows<T, D>(nxt + kTile, v_base, st.v.s, n0 + kBlockN, n_end, tid);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const T* k_s = smem + (tile & 1) * 2 * kTile;
    const T* v_s = k_s + kTile;
    const bool whole = n0 + kBlockN <= kv_len &&
                       (!causal || n0 + kBlockN - 1 <= q_start + q_off);

    if constexpr (kF32) {
      // 8 keys at a time: S, dP, then dS as one TF32 A fragment (keys in
      // the order of acc_as_a_tf32) and dQ += dS K on K's rows 2t, 2t + 1
#pragma unroll
      for (int kc = 0; kc < kBlockN / 8; ++kc) {
        float s[4] = {0.f, 0.f, 0.f, 0.f}, dp[4] = {0.f, 0.f, 0.f, 0.f};
        const T* kr = k_s + (kc * 8 + g) * LD + t;
        const T* vr = v_s + (kc * 8 + g) * LD + t;
#pragma unroll
        for (int kk = 0; kk < D / 8; ++kk) {
          mma_1688(s, qf[kk], tf32(kr[kk * 8]), tf32(kr[kk * 8 + 4]));
          mma_1688(dp, df[kk], tf32(vr[kk * 8]), tf32(vr[kk * 8 + 4]));
        }
        float ds[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = n0 + kc * 8 + 2 * t + (e & 1);
          const int row = e < 2 ? r0 : r1;
          const bool ok =
              whole || (col < kv_len && (!causal || col <= row + q_off));
          const float p =
              ok ? exp2f(s[e] * scale_log2 - (e < 2 ? lse0 : lse1)) : 0.f;
          ds[e] = p * (dp[e] - (e < 2 ? dl0 : dl1)) * sm_scale;
        }
        uint32_t dsf[4];
        acc_as_a_tf32(dsf, ds[0], ds[1], ds[2], ds[3]);
        const T* kt = k_s + (kc * 8 + 2 * t) * LD + c_out + g;
#pragma unroll
        for (int dn = 0; dn < DO / 8; ++dn) {
          mma_1688(acc[dn], dsf, tf32(kt[dn * 8]), tf32(kt[LD + dn * 8]));
        }
      }
    } else {
#pragma unroll
    for (int kc = 0; kc < kBlockN / 16; ++kc) {
      // S and dP for 16 rows x 16 keys: two 8-key output tiles each
      float s[2][4], dp[2][4];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
        dp[j][0] = dp[j][1] = dp[j][2] = dp[j][3] = 0.f;
#pragma unroll
        for (int kk = 0; kk < D / 16; kk += 2) {
          const int off = (kc * 16 + j * 8 + lrow) * LD + kk * 16 + lmat * 8;
          uint32_t kb[4], vb[4];
          ldmatrix_x4(kb, k_s + off);
          ldmatrix_x4(vb, v_s + off);
          mma_16816<T>(s[j], qf[kk], kb[0], kb[1]);
          mma_16816<T>(s[j], qf[kk + 1], kb[2], kb[3]);
          mma_16816<T>(dp[j], df[kk], vb[0], vb[1]);
          mma_16816<T>(dp[j], df[kk + 1], vb[2], vb[3]);
        }
      }
      // dS = P (dP - delta) sm_scale, rounded to bf16 as one A fragment
      uint32_t dsf[4];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        float ds[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = n0 + kc * 16 + j * 8 + 2 * t + (e & 1);
          const int row = e < 2 ? r0 : r1;
          const bool ok =
              whole || (col < kv_len && (!causal || col <= row + q_off));
          const float p =
              ok ? exp2f(s[j][e] * scale_log2 - (e < 2 ? lse0 : lse1)) : 0.f;
          ds[e] = p * (dp[j][e] - (e < 2 ? dl0 : dl1)) * sm_scale;
        }
        dsf[j * 2 + 0] = pack2<T>(ds[0], ds[1]);
        dsf[j * 2 + 1] = pack2<T>(ds[2], ds[3]);
      }
      // dQ += dS K: ldmatrix.trans of the chunk's K rows (this CTA's
      // columns) gives B operands
#pragma unroll
      for (int dn = 0; dn < DO / 8; dn += 2) {
        uint32_t kb[4];
        ldmatrix_x4_trans(kb, k_s + (kc * 16 + (lmat & 1) * 8 + lrow) * LD +
                                  c_out + dn * 8 + (lmat >> 1) * 8);
        mma_16816<T>(acc[dn], dsf, kb[0], kb[1]);
        mma_16816<T>(acc[dn + 1], dsf, kb[2], kb[3]);
      }
    }
    }
    __syncthreads();  // every warp is done with this stage before refill
  }

  store_rows<T, DO>(dq + b * st.dq.b + h * st.dq.h + c_out, st.dq.s, acc, r0,
                    sq, t);
}

// ---- the wide route ----

template <typename T>
constexpr int wide_smem_bytes() {
  // two stages of a 64-column chunk of Q, dO and the K and V tiles, and two
  // buffers of the CTA's 64 columns of a K tile
  return 10 * kBlockN * (64 + kPadOf<T>) * static_cast<int>(sizeof(T));
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dq_wide_kernel(const T* __restrict__ q, const T* __restrict__ k,
                             const T* __restrict__ v,
                             const T* __restrict__ d_o,
                             const float* __restrict__ lse,
                             const float* __restrict__ delta,
                             T* __restrict__ dq,
                             const int* __restrict__ kv_lens,
                             const int* __restrict__ q_offset, int sq, int skv,
                             int d, Strides st, int causal, float scale_log2,
                             float sm_scale) {
  constexpr bool kF32 = std::is_same<T, float>::value;
  constexpr int LD = 64 + kPadOf<T>;
  constexpr int kTile = kBlockN * LD;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // stage s: Q, dO, K and V chunks at smem[(4 s + 0..3) kTile]; the K
  // block of a tile of parity p at smem[(8 + p) kTile]
  T* smem = reinterpret_cast<T*>(smem_raw);

  const int n_chunks = d / 64;
  const int b = blockIdx.z;
  const int h = blockIdx.y;
  const int q_start = blockIdx.x / n_chunks * kBlockM;
  const int c_out = blockIdx.x % n_chunks * 64;  // this CTA's first column
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int lrow = lane & 7;
  const int lmat = lane >> 3;

  const int kv_len = min(max(kv_lens[b], 0), skv);
  const int q_off = q_offset[b];
  int n_end = kv_len;
  if (causal) n_end = min(n_end, min(q_start + kBlockM, sq) + q_off);
  n_end = max(n_end, 0);
  const int n_steps = (n_end + kBlockN - 1) / kBlockN * n_chunks;

  const T* q_base = q + b * st.q.b + h * st.q.h;
  const T* do_base = d_o + b * st.d_o.b + h * st.d_o.h;
  const T* k_base = k + b * st.k.b + h * st.k.h;
  const T* v_base = v + b * st.v.b + h * st.v.h;
  auto load_step = [&](int i) {
    const int n0 = i / n_chunks * kBlockN, c = i % n_chunks * 64;
    T* dst = smem + (i & 1) * 4 * kTile;
    load_rows<T, 64>(dst, q_base + c, st.q.s, q_start, sq, tid);
    load_rows<T, 64>(dst + kTile, do_base + c, st.d_o.s, q_start, sq, tid);
    load_rows<T, 64>(dst + 2 * kTile, k_base + c, st.k.s, n0, n_end, tid);
    load_rows<T, 64>(dst + 3 * kTile, v_base + c, st.v.s, n0, n_end, tid);
    if (c == 0) {
      load_rows<T, 64>(smem + (8 + (i / n_chunks & 1)) * kTile,
                       k_base + c_out, st.k.s, n0, n_end, tid);
    }
  };
  if (n_steps > 0) load_step(0);
  cp_async_commit();

  const int r0 = q_start + warp * 16 + g;
  const int r1 = r0 + 8;
  const long long row_base = (static_cast<long long>(b) * gridDim.y + h) * sq;
  const float lse0 = r0 < sq ? lse[row_base + r0] * kLog2e : INFINITY;
  const float lse1 = r1 < sq ? lse[row_base + r1] * kLog2e : INFINITY;
  const float dl0 = r0 < sq ? delta[row_base + r0] : 0.f;
  const float dl1 = r1 < sq ? delta[row_base + r1] : 0.f;

  float acc[8][4], s[kBlockN / 8][4], dp[kBlockN / 8][4];
#pragma unroll
  for (int dn = 0; dn < 8; ++dn) {
    acc[dn][0] = acc[dn][1] = acc[dn][2] = acc[dn][3] = 0.f;
  }

  for (int i = 0; i < n_steps; ++i) {
    const int n0 = i / n_chunks * kBlockN;
    const int chunk = i % n_chunks;
    if (i + 1 < n_steps) {
      load_step(i + 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const T* q_s = smem + (i & 1) * 4 * kTile;
    const T* do_s = q_s + kTile;
    const T* k_s = q_s + 2 * kTile;
    const T* v_s = q_s + 3 * kTile;
    if (chunk == 0) {
#pragma unroll
      for (int j = 0; j < kBlockN / 8; ++j) {
        s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
        dp[j][0] = dp[j][1] = dp[j][2] = dp[j][3] = 0.f;
      }
    }
    // S += Q_c K_c^T and dP += dO_c V_c^T over this chunk's 64 columns
    if constexpr (kF32) {
      const T* qa = q_s + (warp * 16 + g) * LD + t;
      const T* da = do_s + (warp * 16 + g) * LD + t;
#pragma unroll 2
      for (int kk = 0; kk < 64 / 8; ++kk) {
        const int c = kk * 8;
        const uint32_t aq[4] = {tf32(qa[c]), tf32(qa[8 * LD + c]),
                                tf32(qa[c + 4]), tf32(qa[8 * LD + c + 4])};
        const uint32_t ad[4] = {tf32(da[c]), tf32(da[8 * LD + c]),
                                tf32(da[c + 4]), tf32(da[8 * LD + c + 4])};
#pragma unroll
        for (int j = 0; j < kBlockN / 8; ++j) {
          const T* kr = k_s + (j * 8 + g) * LD + c + t;
          const T* vr = v_s + (j * 8 + g) * LD + c + t;
          mma_1688(s[j], aq, tf32(kr[0]), tf32(kr[4]));
          mma_1688(dp[j], ad, tf32(vr[0]), tf32(vr[4]));
        }
      }
    } else {
#pragma unroll
      for (int kk = 0; kk < 64 / 16; kk += 2) {
        const int a_off = (warp * 16 + (lane & 15)) * LD + kk * 16 +
                          (lane >> 4) * 8;
        uint32_t aq0[4], aq1[4], ad0[4], ad1[4];
        ldmatrix_x4(aq0, q_s + a_off);
        ldmatrix_x4(aq1, q_s + a_off + 16);
        ldmatrix_x4(ad0, do_s + a_off);
        ldmatrix_x4(ad1, do_s + a_off + 16);
#pragma unroll
        for (int j = 0; j < kBlockN / 8; ++j) {
          const int off = (j * 8 + lrow) * LD + kk * 16 + lmat * 8;
          uint32_t kb[4], vb[4];
          ldmatrix_x4(kb, k_s + off);
          ldmatrix_x4(vb, v_s + off);
          mma_16816<T>(s[j], aq0, kb[0], kb[1]);
          mma_16816<T>(s[j], aq1, kb[2], kb[3]);
          mma_16816<T>(dp[j], ad0, vb[0], vb[1]);
          mma_16816<T>(dp[j], ad1, vb[2], vb[3]);
        }
      }
    }
    if (chunk == n_chunks - 1) {
      // dS = P (dP - delta) sm_scale, then dQ += dS K on this CTA's columns
      const bool whole = n0 + kBlockN <= kv_len &&
                         (!causal || n0 + kBlockN - 1 <= q_start + q_off);
      const T* kb_s = smem + (8 + (i / n_chunks & 1)) * kTile;
#pragma unroll
      for (int j = 0; j < kBlockN / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = n0 + j * 8 + 2 * t + (e & 1);
          const int row = e < 2 ? r0 : r1;
          const bool ok =
              whole || (col < kv_len && (!causal || col <= row + q_off));
          const float p =
              ok ? exp2f(s[j][e] * scale_log2 - (e < 2 ? lse0 : lse1)) : 0.f;
          s[j][e] = p * (dp[j][e] - (e < 2 ? dl0 : dl1)) * sm_scale;
        }
      }
      if constexpr (kF32) {
#pragma unroll
        for (int kc = 0; kc < kBlockN / 8; ++kc) {
          uint32_t dsf[4];
          acc_as_a_tf32(dsf, s[kc][0], s[kc][1], s[kc][2], s[kc][3]);
          const T* kt = kb_s + (kc * 8 + 2 * t) * LD + g;
#pragma unroll
          for (int dn = 0; dn < 8; ++dn) {
            mma_1688(acc[dn], dsf, tf32(kt[dn * 8]), tf32(kt[LD + dn * 8]));
          }
        }
      } else {
#pragma unroll
        for (int kc = 0; kc < kBlockN / 16; ++kc) {
          const uint32_t dsf[4] = {
              pack2<T>(s[2 * kc][0], s[2 * kc][1]),
              pack2<T>(s[2 * kc][2], s[2 * kc][3]),
              pack2<T>(s[2 * kc + 1][0], s[2 * kc + 1][1]),
              pack2<T>(s[2 * kc + 1][2], s[2 * kc + 1][3])};
#pragma unroll
          for (int dn = 0; dn < 8; dn += 2) {
            uint32_t kb[4];
            ldmatrix_x4_trans(kb, kb_s + (kc * 16 + (lmat & 1) * 8 + lrow) * LD +
                                      dn * 8 + (lmat >> 1) * 8);
            mma_16816<T>(acc[dn], dsf, kb[0], kb[1]);
            mma_16816<T>(acc[dn + 1], dsf, kb[2], kb[3]);
          }
        }
      }
    }
    __syncthreads();  // every warp is done with this stage before refill
  }

  store_rows<T, 64>(dq + b * st.dq.b + h * st.dq.h + c_out, st.dq.s, acc, r0,
                    sq, t);
}

template <typename T>
int dispatch_wide(const void* q, const void* k, const void* v,
                  const void* d_o, const void* lse, const void* delta,
                  void* dq, const int* kv_lens, const int* q_offset,
                  int batch, int heads, int sq, int skv, int head_dim,
                  const Strides& st, int causal, float sm_scale,
                  void* stream) {
  if (head_dim < 64 || head_dim % 64 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  constexpr int bytes = wide_smem_bytes<T>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq_wide_kernel<T>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((sq + kBlockM - 1) / kBlockM * (head_dim / 64), heads,
                  batch);
  flash_bwd_dq_wide_kernel<T><<<grid, kThreads, bytes,
                                static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(d_o),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<T*>(dq), kv_lens, q_offset, sq, skv, head_dim, st, causal,
      sm_scale * kLog2e, sm_scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* d_o, const float* lse, const float* delta,
                   void* dq, const int* kv_lens, const int* q_offset,
                   int batch, int heads, int sq, int skv, const Strides& st,
                   int causal, float sm_scale, cudaStream_t stream) {
  constexpr int bytes = smem_bytes<T, D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((sq + kBlockM - 1) / kBlockM * (D / kOutColsOf<D>), heads,
                  batch);
  flash_bwd_dq_kernel<T, D><<<grid, kThreads, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(d_o), lse, delta,
      static_cast<T*>(dq), kv_lens, q_offset, sq, skv, st, causal,
      sm_scale * kLog2e, sm_scale);
  return cudaGetLastError();
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, const void* d_o,
             const void* lse, const void* delta, void* dq, const int* kv_lens,
             const int* q_offset, int batch, int heads, int sq, int skv,
             int head_dim, const Strides& st, int causal, float sm_scale,
             void* stream) {
  const auto* lf = static_cast<const float*>(lse);
  const auto* df = static_cast<const float*>(delta);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (head_dim) {
    case 64:
      return static_cast<int>(launch<T, 64>(q, k, v, d_o, lf, df, dq, kv_lens,
                                            q_offset, batch, heads, sq, skv,
                                            st, causal, sm_scale, s));
    case 128:
      return static_cast<int>(launch<T, 128>(q, k, v, d_o, lf, df, dq,
                                             kv_lens, q_offset, batch, heads,
                                             sq, skv, st, causal, sm_scale, s));
    case 256:
      if constexpr (kIs16Bit<T>) {
        return static_cast<int>(launch<T, 256>(q, k, v, d_o, lf, df, dq,
                                               kv_lens, q_offset, batch, heads,
                                               sq, skv, st, causal, sm_scale,
                                               s));
      }
      return static_cast<int>(cudaErrorInvalidValue);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// Launch on `stream` and return cudaGetLastError() (0 on success); `_f32`
// takes f32 Q, K, V, dO and dQ, `_bf16` bf16 ones, `_f16` f16 ones. Pointers
// are device pointers; `lse` and `delta` are contiguous (B, H, Sq) f32;
// strides are in elements; the caller checks dtypes, shapes, alignment (16
// bytes for every row) and head_dim (64 or 128; 256 for bf16 and f16; a
// multiple of 64 for the wide route `hsenet_flash_bwd_dq_wide_*`).
#define HSENET_FLASH_BWD_DQ_ENTRY(NAME, T, DISPATCH)                           \
  extern "C" int NAME(                                                         \
      const void* q, const void* k, const void* v, const void* d_o,            \
      const void* lse, const void* delta, void* dq, const int* kv_lens,        \
      const int* q_offset, int batch, int heads, int sq, int skv,              \
      int head_dim, long long q_b, long long q_h, long long q_s,               \
      long long k_b, long long k_h, long long k_s, long long v_b,              \
      long long v_h, long long v_s, long long do_b, long long do_h,            \
      long long do_s, long long dq_b, long long dq_h, long long dq_s,          \
      int causal, float sm_scale, void* stream) {                              \
    const Strides st{{q_b, q_h, q_s}, {k_b, k_h, k_s}, {v_b, v_h, v_s},        \
                     {do_b, do_h, do_s}, {dq_b, dq_h, dq_s}};                  \
    return DISPATCH<T>(q, k, v, d_o, lse, delta, dq, kv_lens, q_offset,        \
                       batch, heads, sq, skv, head_dim, st, causal, sm_scale,  \
                       stream);                                                \
  }

HSENET_FLASH_BWD_DQ_ENTRY(hsenet_flash_bwd_dq_bf16, __nv_bfloat16, dispatch)
HSENET_FLASH_BWD_DQ_ENTRY(hsenet_flash_bwd_dq_f16, __half, dispatch)
HSENET_FLASH_BWD_DQ_ENTRY(hsenet_flash_bwd_dq_f32, float, dispatch)
HSENET_FLASH_BWD_DQ_ENTRY(hsenet_flash_bwd_dq_wide_bf16, __nv_bfloat16,
                          dispatch_wide)
HSENET_FLASH_BWD_DQ_ENTRY(hsenet_flash_bwd_dq_wide_f16, __half, dispatch_wide)
HSENET_FLASH_BWD_DQ_ENTRY(hsenet_flash_bwd_dq_wide_f32, float, dispatch_wide)
