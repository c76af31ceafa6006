// Flash-attention backward, dK and dV, for Hopper (sm_90a): the f32 route
// (f32 in and out, TF32 products, f32 accumulation) at head dim 64 and 128,
// the bf16 and f16 route at head dim 256 (where flash_bwd.cu's tiling does
// not fit: its dK and dV accumulators alone would take 256 registers a
// thread), and every dtype's wide route above those widths. The bf16 and
// f16 route at 64 and 128 is flash_bwd.cu; this file's bf16 instantiation
// there stays as the yardstick chip_smoke.py times that kernel against.
//
// Replaces the TPU kernel `_bwd_dkv_kernel` of the JAX package
// (ops/flash_attention.py, launched by `_flash_backward`). Per (batch b,
// head h, key c), with the forward's log-sum-exp `lse[r]` and
// delta[r] = sum_d dO[r, d] O[r, d] of every query row r, it recomputes
//   P[r, c] = exp(sm_scale Q[r].K[c] - lse[r])
// where c < kv_len[b] (and, under `causal`, c <= r + q_offset[b]; P is 0
// elsewhere), then
//   dV[c] = sum_r P[r, c] dO[r],
//   dK[c] = sum_r dS[r, c] Q[r],   dS[r, c] = P[r, c] (dO[r].V[c] - delta[r]) sm_scale.
// Keys at or past kv_len, and every key of a batch row with kv_len 0, get 0.
//
// What bounds it on an H100 SXM (989 TFLOP/s bf16, 3.35 TB/s): four
// products of 2 d operations per valid (row, column) pair (S, dP, dV, dK).
// At the LLM training shape (3 x 24 heads x 800 tokens, d 128, causal,
// kv_lens 800/700/560) that is 23 GFLOP (23 us) against 84 MB of Q and dO,
// the K and V rows below kv_len, and dK and dV (25 us): bytes, narrowly.
// chip_smoke.py recomputes the bound from the shapes and data it runs.
//
// Design (mma.sync, for both element types; f32 runs the same tiling with
// TF32 m16n8k8 products on 32-bit shared-memory loads, 8 query rows at a
// time, see flash_common.cuh):
//   * one CTA of 4 warps per (b, h, 64-key tile); its K and V rows stay in
//     shared memory and each warp owns 16 keys, accumulating their dK and
//     dV rows in f32 registers;
//   * Q and dO tiles of 64 rows, with their log-sum-exp and delta, stream
//     through a two-stage ring (cp.async for Q and dO); each tile is
//     taken 16 query rows at a time;
//   * the scores are computed transposed, S^T = K Q^T and dP^T = V dO^T,
//     with K and V as A operands (ldmatrix) and Q and dO as B operands
//     (ldmatrix), so P^T and dS^T come out of the accumulators already in
//     the layout of the A fragments of dV += P^T dO and dK += dS^T Q, whose
//     B operands are Q and dO again (ldmatrix.trans); P and dS are rounded
//     to bf16 for those products, as on the TPU;
//   * a key tile past kv_len writes zeros and reads nothing; under causal
//     the query loop starts at the first tile with a row that sees the
//     tile's first key. No atomics: each CTA owns its dK and dV rows;
//   * at head dim 256 (bf16 and f16 only) a CTA accumulates 128 of dK's and
//     dV's columns: the grid's x axis holds both halves of each key tile,
//     and each CTA computes S^T and dP^T over the full width for its half
//     (six products per valid pair, not four). The wide route below takes
//     256 too, at 1.8-1.9x this split's time (chip_smoke.py [kernel-bwd],
//     PERF.md), so 256 keeps it.
//
// The wide route (`_wide` entries: bf16 and f16 above head dim 256, f32
// above 128, any multiple of 64; ROADMAP C2), where the key tile's K and V
// of the full width do not fit shared memory:
//   * one CTA per (b, h, 64-key tile, 64-column block of dK and dV), the
//     grid's x axis holding the column blocks;
//   * S^T = K Q^T and dP^T = V dO^T are summed chunk by chunk: 64-column
//     chunks of the key tile's K and V and of the query tile's Q and dO
//     stream through the two-stage cp.async ring (K and V again for every
//     query tile), A fragments read from shared memory;
//   * the CTA's 64 columns of the Q and dO tiles, with the tile's
//     log-sum-exp and delta, arrive with its first chunk (two buffers, by
//     tile parity) for dV += P^T dO and dK += dS^T Q;
//   * every column block recomputes S^T and dP^T over the full width.
//     Right, not fast.

#include "flash_common.cuh"

namespace {

using namespace hsenet_flash;

template <typename T, int D>
constexpr int smem_bytes() {
  // resident K and V tiles, then two stages of a Q and a dO tile and of
  // their 64 log-sum-exp and delta values
  return (2 + 2 * 2) * kBlockM * (D + kPadOf<T>) * static_cast<int>(sizeof(T)) +
         2 * 2 * kBlockM * static_cast<int>(sizeof(float));
}

struct Strides {
  Strides3 q, k, v, d_o, dk, dv;
};

template <int DO>
__device__ __forceinline__ void zero_acc(float (&acc)[DO / 8][4]) {
#pragma unroll
  for (int dn = 0; dn < DO / 8; ++dn) {
    acc[dn][0] = acc[dn][1] = acc[dn][2] = acc[dn][3] = 0.f;
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v, const T* __restrict__ d_o,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta, T* __restrict__ dk,
                         T* __restrict__ dv,
                         const int* __restrict__ kv_lens,
                         const int* __restrict__ q_offset, int sq, int skv,
                         Strides st, int causal, float scale_log2,
                         float sm_scale) {
  constexpr bool kF32 = std::is_same<T, float>::value;
  constexpr int LD = D + kPadOf<T>;
  constexpr int kTile = kBlockM * LD;
  constexpr int DO = kOutColsOf<D>;
  constexpr int kSplit = D / DO;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* smem = reinterpret_cast<T*>(smem_raw);
  T* k_s = smem;
  T* v_s = smem + kTile;
  // stage s: Q at ring[2 s kTile], dO at ring[(2 s + 1) kTile]
  T* ring = smem + 2 * kTile;
  // stage s: log-sum-exp (log2 domain) at stats[2 s 64], delta after it
  float* stats = reinterpret_cast<float*>(smem + 6 * kTile);

  const int b = blockIdx.z;
  const int h = blockIdx.y;
  const int k_start = blockIdx.x / kSplit * kBlockN;
  const int c_out = blockIdx.x % kSplit * DO;  // this CTA's first column
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int lrow = lane & 7;
  const int lmat = lane >> 3;

  const int kv_len = min(max(kv_lens[b], 0), skv);
  const int q_off = q_offset[b];
  // this thread's two key rows: c0 and c0 + 8 of the warp's 16
  const int c0 = k_start + warp * 16 + g;
  const int c1 = c0 + 8;

  // queries that see a key of this tile: row >= k_start - q_offset
  const int m_first =
      causal ? max(0, k_start - q_off) / kBlockM * kBlockM : 0;
  const int n_qtiles =
      k_start < kv_len && m_first < sq ? (sq - m_first + kBlockM - 1) / kBlockM
                                       : 0;

  float acc_dk[DO / 8][4], acc_dv[DO / 8][4];
  zero_acc<DO>(acc_dk);
  zero_acc<DO>(acc_dv);

  const T* q_base = q + b * st.q.b + h * st.q.h;
  const T* do_base = d_o + b * st.d_o.b + h * st.d_o.h;
  const long long row_base = (static_cast<long long>(b) * gridDim.y + h) * sq;

  // fill one stage with the query tile at m0
  auto load_stage = [&](int stage, int m0) {
    T* dst = ring + stage * 2 * kTile;
    load_rows<T, D>(dst, q_base, st.q.s, m0, sq, tid);
    load_rows<T, D>(dst + kTile, do_base, st.d_o.s, m0, sq, tid);
    float* lse_s = stats + stage * 2 * kBlockM;
    for (int i = tid; i < kBlockM; i += kThreads) {
      const int r = m0 + i;
      // rows past sq: +inf so that P is 0 there
      lse_s[i] = r < sq ? lse[row_base + r] * kLog2e : INFINITY;
      lse_s[kBlockM + i] = r < sq ? delta[row_base + r] : 0.f;
    }
  };

  if (n_qtiles > 0) {
    load_rows<T, D>(k_s, k + b * st.k.b + h * st.k.h, st.k.s, k_start, kv_len,
                    tid);
    load_rows<T, D>(v_s, v + b * st.v.b + h * st.v.h, st.v.s, k_start, kv_len,
                    tid);
    load_stage(0, m_first);
  }
  cp_async_commit();

  for (int it = 0; it < n_qtiles; ++it) {
    const int m0 = m_first + it * kBlockM;
    if (it + 1 < n_qtiles) {
      load_stage((it + 1) & 1, m0 + kBlockM);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // this stage (and the K/V tiles) are in shared memory
    const T* q_s = ring + (it & 1) * 2 * kTile;
    const T* do_s = q_s + kTile;
    const float* lse_s = stats + (it & 1) * 2 * kBlockM;
    const float* dl_s = lse_s + kBlockM;
    const bool whole = k_start + kBlockN <= kv_len &&
                       (!causal || k_start + kBlockN - 1 <= m0 + q_off);

    if constexpr (kF32) {
      // 8 query rows at a time: S^T and dP^T (the warp's 16 keys x 8 rows),
      // then P^T and dS^T as TF32 A fragments (rows in the order of
      // acc_as_a_tf32) against the rows 2t, 2t + 1 of dO and Q
#pragma unroll 2
      for (int qc = 0; qc < kBlockM / 8; ++qc) {
        float s[4] = {0.f, 0.f, 0.f, 0.f}, dp[4] = {0.f, 0.f, 0.f, 0.f};
        const T* ka = k_s + (warp * 16 + g) * LD + t;
        const T* va = v_s + (warp * 16 + g) * LD + t;
        const T* qb = q_s + (qc * 8 + g) * LD + t;
        const T* db = do_s + (qc * 8 + g) * LD + t;
#pragma unroll
        for (int kk = 0; kk < D / 8; ++kk) {
          const int c = kk * 8;
          const uint32_t kf[4] = {tf32(ka[c]), tf32(ka[8 * LD + c]),
                                  tf32(ka[c + 4]), tf32(ka[8 * LD + c + 4])};
          const uint32_t vf[4] = {tf32(va[c]), tf32(va[8 * LD + c]),
                                  tf32(va[c + 4]), tf32(va[8 * LD + c + 4])};
          mma_1688(s, kf, tf32(qb[c]), tf32(qb[c + 4]));
          mma_1688(dp, vf, tf32(db[c]), tf32(db[c + 4]));
        }
        float p[4], ds[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = qc * 8 + 2 * t + (e & 1);  // row in tile
          const int key = e < 2 ? c0 : c1;
          const bool ok = whole || (key < kv_len &&
                                    (!causal || key <= m0 + i + q_off));
          p[e] = ok ? exp2f(s[e] * scale_log2 - lse_s[i]) : 0.f;
          ds[e] = p[e] * (dp[e] - dl_s[i]) * sm_scale;
        }
        uint32_t pa[4], dsa[4];
        acc_as_a_tf32(pa, p[0], p[1], p[2], p[3]);
        acc_as_a_tf32(dsa, ds[0], ds[1], ds[2], ds[3]);
        const T* orow = do_s + (qc * 8 + 2 * t) * LD + c_out + g;
        const T* qrow = q_s + (qc * 8 + 2 * t) * LD + c_out + g;
#pragma unroll
        for (int dn = 0; dn < DO / 8; ++dn) {
          mma_1688(acc_dv[dn], pa, tf32(orow[dn * 8]), tf32(orow[LD + dn * 8]));
          mma_1688(acc_dk[dn], dsa, tf32(qrow[dn * 8]), tf32(qrow[LD + dn * 8]));
        }
      }
    } else {
#pragma unroll
    for (int qc = 0; qc < kBlockM / 16; ++qc) {
      // S^T and dP^T for 16 keys x 16 query rows: two 8-row output tiles
      float s[2][4], dp[2][4];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
        dp[j][0] = dp[j][1] = dp[j][2] = dp[j][3] = 0.f;
      }
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        // A: the warp's 16 keys x 16 columns of K and of V
        const int a_off = (warp * 16 + (lane & 15)) * LD + kk * 16 +
                          (lane >> 4) * 8;
        // B: 16 query rows (two 8-row tiles) x the same 16 columns
        const int b_off = (qc * 16 + (lmat >> 1) * 8 + lrow) * LD + kk * 16 +
                          (lmat & 1) * 8;
        uint32_t ka[4], va[4], qb[4], db[4];
        ldmatrix_x4(ka, k_s + a_off);
        ldmatrix_x4(va, v_s + a_off);
        ldmatrix_x4(qb, q_s + b_off);
        ldmatrix_x4(db, do_s + b_off);
        mma_16816<T>(s[0], ka, qb[0], qb[1]);
        mma_16816<T>(s[1], ka, qb[2], qb[3]);
        mma_16816<T>(dp[0], va, db[0], db[1]);
        mma_16816<T>(dp[1], va, db[2], db[3]);
      }
      // P^T and dS^T, rounded to bf16 as A fragments (keys x query rows)
      uint32_t pa[4], dsa[4];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        float p[4], ds[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = qc * 16 + j * 8 + 2 * t + (e & 1);  // row in tile
          const int key = e < 2 ? c0 : c1;
          const bool ok = whole || (key < kv_len &&
                                    (!causal || key <= m0 + i + q_off));
          p[e] = ok ? exp2f(s[j][e] * scale_log2 - lse_s[i]) : 0.f;
          ds[e] = p[e] * (dp[j][e] - dl_s[i]) * sm_scale;
        }
        pa[j * 2 + 0] = pack2<T>(p[0], p[1]);
        pa[j * 2 + 1] = pack2<T>(p[2], p[3]);
        dsa[j * 2 + 0] = pack2<T>(ds[0], ds[1]);
        dsa[j * 2 + 1] = pack2<T>(ds[2], ds[3]);
      }
      // dV += P^T dO and dK += dS^T Q: ldmatrix.trans of the chunk's 16
      // rows of dO and Q (this CTA's columns) gives the B operands of two
      // 8-column tiles
#pragma unroll
      for (int dn = 0; dn < DO / 8; dn += 2) {
        const int off = (qc * 16 + (lmat & 1) * 8 + lrow) * LD + c_out +
                        dn * 8 + (lmat >> 1) * 8;
        uint32_t ob[4], qb[4];
        ldmatrix_x4_trans(ob, do_s + off);
        ldmatrix_x4_trans(qb, q_s + off);
        mma_16816<T>(acc_dv[dn], pa, ob[0], ob[1]);
        mma_16816<T>(acc_dv[dn + 1], pa, ob[2], ob[3]);
        mma_16816<T>(acc_dk[dn], dsa, qb[0], qb[1]);
        mma_16816<T>(acc_dk[dn + 1], dsa, qb[2], qb[3]);
      }
    }
    }
    __syncthreads();  // every warp is done with this stage before refill
  }

  store_rows<T, DO>(dk + b * st.dk.b + h * st.dk.h + c_out, st.dk.s, acc_dk,
                    c0, skv, t);
  store_rows<T, DO>(dv + b * st.dv.b + h * st.dv.h + c_out, st.dv.s, acc_dv,
                    c0, skv, t);
}

// ---- the wide route ----

template <typename T>
constexpr int wide_smem_bytes() {
  // two stages of 64-column chunks of K, V, Q and dO, two buffers of the
  // CTA's 64 columns of Q and dO, and two of 64 log-sum-exp and delta values
  return 12 * kBlockM * (64 + kPadOf<T>) * static_cast<int>(sizeof(T)) +
         2 * 2 * kBlockM * static_cast<int>(sizeof(float));
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dkv_wide_kernel(const T* __restrict__ q,
                              const T* __restrict__ k,
                              const T* __restrict__ v,
                              const T* __restrict__ d_o,
                              const float* __restrict__ lse,
                              const float* __restrict__ delta,
                              T* __restrict__ dk, T* __restrict__ dv,
                              const int* __restrict__ kv_lens,
                              const int* __restrict__ q_offset, int sq,
                              int skv, int d, Strides st, int causal,
                              float scale_log2, float sm_scale) {
  constexpr bool kF32 = std::is_same<T, float>::value;
  constexpr int LD = 64 + kPadOf<T>;
  constexpr int kTile = kBlockM * LD;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // stage s: K, V, Q and dO chunks at smem[(4 s + 0..3) kTile]; the Q and
  // dO blocks of a query tile of parity p at smem[(8 + 2 p + 0..1) kTile];
  // its log-sum-exp (log2 domain) and delta at stats[2 p 64], after it
  T* smem = reinterpret_cast<T*>(smem_raw);
  float* stats = reinterpret_cast<float*>(smem + 12 * kTile);

  const int n_chunks = d / 64;
  const int b = blockIdx.z;
  const int h = blockIdx.y;
  const int k_start = blockIdx.x / n_chunks * kBlockN;
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
  const int c0 = k_start + warp * 16 + g;
  const int c1 = c0 + 8;
  const int m_first =
      causal ? max(0, k_start - q_off) / kBlockM * kBlockM : 0;
  const int n_qtiles =
      k_start < kv_len && m_first < sq ? (sq - m_first + kBlockM - 1) / kBlockM
                                       : 0;
  const int n_steps = n_qtiles * n_chunks;

  const T* q_base = q + b * st.q.b + h * st.q.h;
  const T* do_base = d_o + b * st.d_o.b + h * st.d_o.h;
  const T* k_base = k + b * st.k.b + h * st.k.h;
  const T* v_base = v + b * st.v.b + h * st.v.h;
  const long long row_base = (static_cast<long long>(b) * gridDim.y + h) * sq;

  auto load_step = [&](int i) {
    const int qt = i / n_chunks, c = i % n_chunks * 64;
    const int m0 = m_first + qt * kBlockM;
    T* dst = smem + (i & 1) * 4 * kTile;
    load_rows<T, 64>(dst, k_base + c, st.k.s, k_start, kv_len, tid);
    load_rows<T, 64>(dst + kTile, v_base + c, st.v.s, k_start, kv_len, tid);
    load_rows<T, 64>(dst + 2 * kTile, q_base + c, st.q.s, m0, sq, tid);
    load_rows<T, 64>(dst + 3 * kTile, do_base + c, st.d_o.s, m0, sq, tid);
    if (c == 0) {
      T* blk = smem + (8 + 2 * (qt & 1)) * kTile;
      load_rows<T, 64>(blk, q_base + c_out, st.q.s, m0, sq, tid);
      load_rows<T, 64>(blk + kTile, do_base + c_out, st.d_o.s, m0, sq, tid);
      float* lse_s = stats + (qt & 1) * 2 * kBlockM;
      for (int r = tid; r < kBlockM; r += kThreads) {
        // rows past sq: +inf so that P is 0 there
        lse_s[r] = m0 + r < sq ? lse[row_base + m0 + r] * kLog2e : INFINITY;
        lse_s[kBlockM + r] = m0 + r < sq ? delta[row_base + m0 + r] : 0.f;
      }
    }
  };
  if (n_steps > 0) load_step(0);
  cp_async_commit();

  float acc_dk[8][4], acc_dv[8][4], s[kBlockM / 8][4], dp[kBlockM / 8][4];
  zero_acc<64>(acc_dk);
  zero_acc<64>(acc_dv);

  for (int i = 0; i < n_steps; ++i) {
    const int qt = i / n_chunks;
    const int m0 = m_first + qt * kBlockM;
    const int chunk = i % n_chunks;
    if (i + 1 < n_steps) {
      load_step(i + 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const T* k_s = smem + (i & 1) * 4 * kTile;
    const T* v_s = k_s + kTile;
    const T* q_s = k_s + 2 * kTile;
    const T* do_s = k_s + 3 * kTile;
    if (chunk == 0) {
#pragma unroll
      for (int j = 0; j < kBlockM / 8; ++j) {
        s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
        dp[j][0] = dp[j][1] = dp[j][2] = dp[j][3] = 0.f;
      }
    }
    // S^T += K_c Q_c^T and dP^T += V_c dO_c^T: the warp's 16 keys x 64 rows
    if constexpr (kF32) {
      const T* ka = k_s + (warp * 16 + g) * LD + t;
      const T* va = v_s + (warp * 16 + g) * LD + t;
#pragma unroll 2
      for (int kk = 0; kk < 64 / 8; ++kk) {
        const int c = kk * 8;
        const uint32_t kf[4] = {tf32(ka[c]), tf32(ka[8 * LD + c]),
                                tf32(ka[c + 4]), tf32(ka[8 * LD + c + 4])};
        const uint32_t vf[4] = {tf32(va[c]), tf32(va[8 * LD + c]),
                                tf32(va[c + 4]), tf32(va[8 * LD + c + 4])};
#pragma unroll
        for (int qc = 0; qc < kBlockM / 8; ++qc) {
          const T* qb = q_s + (qc * 8 + g) * LD + c + t;
          const T* db = do_s + (qc * 8 + g) * LD + c + t;
          mma_1688(s[qc], kf, tf32(qb[0]), tf32(qb[4]));
          mma_1688(dp[qc], vf, tf32(db[0]), tf32(db[4]));
        }
      }
    } else {
#pragma unroll
      for (int kk = 0; kk < 64 / 16; ++kk) {
        const int a_off = (warp * 16 + (lane & 15)) * LD + kk * 16 +
                          (lane >> 4) * 8;
        uint32_t ka[4], va[4];
        ldmatrix_x4(ka, k_s + a_off);
        ldmatrix_x4(va, v_s + a_off);
#pragma unroll
        for (int qc = 0; qc < kBlockM / 16; ++qc) {
          const int b_off = (qc * 16 + (lmat >> 1) * 8 + lrow) * LD + kk * 16 +
                            (lmat & 1) * 8;
          uint32_t qb[4], db[4];
          ldmatrix_x4(qb, q_s + b_off);
          ldmatrix_x4(db, do_s + b_off);
          mma_16816<T>(s[2 * qc], ka, qb[0], qb[1]);
          mma_16816<T>(s[2 * qc + 1], ka, qb[2], qb[3]);
          mma_16816<T>(dp[2 * qc], va, db[0], db[1]);
          mma_16816<T>(dp[2 * qc + 1], va, db[2], db[3]);
        }
      }
    }
    if (chunk == n_chunks - 1) {
      // P^T and dS^T, then dV += P^T dO and dK += dS^T Q on this CTA's
      // columns
      const T* q_blk = smem + (8 + 2 * (qt & 1)) * kTile;
      const T* do_blk = q_blk + kTile;
      const float* lse_s = stats + (qt & 1) * 2 * kBlockM;
      const float* dl_s = lse_s + kBlockM;
      const bool whole = k_start + kBlockN <= kv_len &&
                         (!causal || k_start + kBlockN - 1 <= m0 + q_off);
#pragma unroll
      for (int j = 0; j < kBlockM / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = j * 8 + 2 * t + (e & 1);  // row in tile
          const int key = e < 2 ? c0 : c1;
          const bool ok = whole || (key < kv_len &&
                                    (!causal || key <= m0 + r + q_off));
          const float p = ok ? exp2f(s[j][e] * scale_log2 - lse_s[r]) : 0.f;
          s[j][e] = p;
          dp[j][e] = p * (dp[j][e] - dl_s[r]) * sm_scale;
        }
      }
      if constexpr (kF32) {
#pragma unroll
        for (int qc = 0; qc < kBlockM / 8; ++qc) {
          uint32_t pa[4], dsa[4];
          acc_as_a_tf32(pa, s[qc][0], s[qc][1], s[qc][2], s[qc][3]);
          acc_as_a_tf32(dsa, dp[qc][0], dp[qc][1], dp[qc][2], dp[qc][3]);
          const T* orow = do_blk + (qc * 8 + 2 * t) * LD + g;
          const T* qrow = q_blk + (qc * 8 + 2 * t) * LD + g;
#pragma unroll
          for (int dn = 0; dn < 8; ++dn) {
            mma_1688(acc_dv[dn], pa, tf32(orow[dn * 8]),
                     tf32(orow[LD + dn * 8]));
            mma_1688(acc_dk[dn], dsa, tf32(qrow[dn * 8]),
                     tf32(qrow[LD + dn * 8]));
          }
        }
      } else {
#pragma unroll
        for (int qc = 0; qc < kBlockM / 16; ++qc) {
          const uint32_t pa[4] = {pack2<T>(s[2 * qc][0], s[2 * qc][1]),
                                  pack2<T>(s[2 * qc][2], s[2 * qc][3]),
                                  pack2<T>(s[2 * qc + 1][0], s[2 * qc + 1][1]),
                                  pack2<T>(s[2 * qc + 1][2], s[2 * qc + 1][3])};
          const uint32_t dsa[4] = {
              pack2<T>(dp[2 * qc][0], dp[2 * qc][1]),
              pack2<T>(dp[2 * qc][2], dp[2 * qc][3]),
              pack2<T>(dp[2 * qc + 1][0], dp[2 * qc + 1][1]),
              pack2<T>(dp[2 * qc + 1][2], dp[2 * qc + 1][3])};
#pragma unroll
          for (int dn = 0; dn < 8; dn += 2) {
            const int off = (qc * 16 + (lmat & 1) * 8 + lrow) * LD + dn * 8 +
                            (lmat >> 1) * 8;
            uint32_t ob[4], qb[4];
            ldmatrix_x4_trans(ob, do_blk + off);
            ldmatrix_x4_trans(qb, q_blk + off);
            mma_16816<T>(acc_dv[dn], pa, ob[0], ob[1]);
            mma_16816<T>(acc_dv[dn + 1], pa, ob[2], ob[3]);
            mma_16816<T>(acc_dk[dn], dsa, qb[0], qb[1]);
            mma_16816<T>(acc_dk[dn + 1], dsa, qb[2], qb[3]);
          }
        }
      }
    }
    __syncthreads();  // every warp is done with this stage before refill
  }

  store_rows<T, 64>(dk + b * st.dk.b + h * st.dk.h + c_out, st.dk.s, acc_dk,
                    c0, skv, t);
  store_rows<T, 64>(dv + b * st.dv.b + h * st.dv.h + c_out, st.dv.s, acc_dv,
                    c0, skv, t);
}

template <typename T>
int dispatch_wide(const void* q, const void* k, const void* v,
                  const void* d_o, const void* lse, const void* delta,
                  void* dk, void* dv, const int* kv_lens, const int* q_offset,
                  int batch, int heads, int sq, int skv, int head_dim,
                  const Strides& st, int causal, float sm_scale,
                  void* stream) {
  if (head_dim < 64 || head_dim % 64 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  constexpr int bytes = wide_smem_bytes<T>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkv_wide_kernel<T>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((skv + kBlockN - 1) / kBlockN * (head_dim / 64), heads,
                  batch);
  flash_bwd_dkv_wide_kernel<T><<<grid, kThreads, bytes,
                                 static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(d_o),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<T*>(dk), static_cast<T*>(dv), kv_lens, q_offset, sq, skv,
      head_dim, st, causal, sm_scale * kLog2e, sm_scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* d_o, const float* lse, const float* delta,
                   void* dk, void* dv, const int* kv_lens,
                   const int* q_offset, int batch, int heads, int sq, int skv,
                   const Strides& st, int causal, float sm_scale,
                   cudaStream_t stream) {
  constexpr int bytes = smem_bytes<T, D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkv_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((skv + kBlockN - 1) / kBlockN * (D / kOutColsOf<D>), heads,
                  batch);
  flash_bwd_dkv_kernel<T, D><<<grid, kThreads, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(d_o), lse, delta,
      static_cast<T*>(dk), static_cast<T*>(dv), kv_lens, q_offset, sq, skv, st,
      causal, sm_scale * kLog2e, sm_scale);
  return cudaGetLastError();
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, const void* d_o,
             const void* lse, const void* delta, void* dk, void* dv,
             const int* kv_lens, const int* q_offset, int batch, int heads,
             int sq, int skv, int head_dim, const Strides& st, int causal,
             float sm_scale, void* stream) {
  const auto* lf = static_cast<const float*>(lse);
  const auto* df = static_cast<const float*>(delta);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (head_dim) {
    case 64:
      return static_cast<int>(launch<T, 64>(q, k, v, d_o, lf, df, dk, dv,
                                            kv_lens, q_offset, batch, heads,
                                            sq, skv, st, causal, sm_scale, s));
    case 128:
      return static_cast<int>(launch<T, 128>(q, k, v, d_o, lf, df, dk, dv,
                                             kv_lens, q_offset, batch, heads,
                                             sq, skv, st, causal, sm_scale, s));
    case 256:
      if constexpr (kIs16Bit<T>) {
        return static_cast<int>(launch<T, 256>(q, k, v, d_o, lf, df, dk, dv,
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
// takes f32 Q, K, V, dO, dK and dV, `_bf16` bf16 ones, `_f16` f16 ones.
// Pointers are device pointers; `lse` and `delta` are contiguous (B, H, Sq)
// f32; strides are in elements; the caller checks dtypes, shapes, alignment
// (16 bytes for every row) and head_dim (64 or 128; 256 for bf16 and f16;
// a multiple of 64 for the wide route `hsenet_flash_bwd_dkv_wide_*`).
#define HSENET_FLASH_BWD_DKV_ENTRY(NAME, T, DISPATCH)                          \
  extern "C" int NAME(                                                         \
      const void* q, const void* k, const void* v, const void* d_o,            \
      const void* lse, const void* delta, void* dk, void* dv,                  \
      const int* kv_lens, const int* q_offset, int batch, int heads, int sq,   \
      int skv, int head_dim, long long q_b, long long q_h, long long q_s,      \
      long long k_b, long long k_h, long long k_s, long long v_b,              \
      long long v_h, long long v_s, long long do_b, long long do_h,            \
      long long do_s, long long dk_b, long long dk_h, long long dk_s,          \
      long long dv_b, long long dv_h, long long dv_s, int causal,              \
      float sm_scale, void* stream) {                                          \
    const Strides st{{q_b, q_h, q_s},    {k_b, k_h, k_s},                      \
                     {v_b, v_h, v_s},    {do_b, do_h, do_s},                   \
                     {dk_b, dk_h, dk_s}, {dv_b, dv_h, dv_s}};                  \
    return DISPATCH<T>(q, k, v, d_o, lse, delta, dk, dv, kv_lens, q_offset,    \
                       batch, heads, sq, skv, head_dim, st, causal, sm_scale,  \
                       stream);                                                \
  }

HSENET_FLASH_BWD_DKV_ENTRY(hsenet_flash_bwd_dkv_bf16, __nv_bfloat16, dispatch)
HSENET_FLASH_BWD_DKV_ENTRY(hsenet_flash_bwd_dkv_f16, __half, dispatch)
HSENET_FLASH_BWD_DKV_ENTRY(hsenet_flash_bwd_dkv_f32, float, dispatch)
HSENET_FLASH_BWD_DKV_ENTRY(hsenet_flash_bwd_dkv_wide_bf16, __nv_bfloat16,
                           dispatch_wide)
HSENET_FLASH_BWD_DKV_ENTRY(hsenet_flash_bwd_dkv_wide_f16, __half,
                           dispatch_wide)
HSENET_FLASH_BWD_DKV_ENTRY(hsenet_flash_bwd_dkv_wide_f32, float, dispatch_wide)
