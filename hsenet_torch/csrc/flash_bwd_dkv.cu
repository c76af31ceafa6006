// Flash-attention backward, dK and dV, for Hopper (sm_90a): bf16 in and
// out, f32 accumulation.
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
// Design (mma.sync; wgmma/TMA come later):
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
//     tile's first key. No atomics: each CTA owns its dK and dV rows.

#include "flash_common.cuh"

namespace {

using namespace hsenet_flash;

template <int D>
constexpr int smem_bytes() {
  // resident K and V tiles, then two stages of a Q and a dO tile and of
  // their 64 log-sum-exp and delta values
  return (2 + 2 * 2) * kBlockM * (D + kPad) *
             static_cast<int>(sizeof(__nv_bfloat16)) +
         2 * 2 * kBlockM * static_cast<int>(sizeof(float));
}

struct Strides {
  Strides3 q, k, v, d_o, dk, dv;
};

template <int D>
__device__ __forceinline__ void zero_acc(float (&acc)[D / 8][4]) {
#pragma unroll
  for (int dn = 0; dn < D / 8; ++dn) {
    acc[dn][0] = acc[dn][1] = acc[dn][2] = acc[dn][3] = 0.f;
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dkv_kernel(const __nv_bfloat16* __restrict__ q,
                         const __nv_bfloat16* __restrict__ k,
                         const __nv_bfloat16* __restrict__ v,
                         const __nv_bfloat16* __restrict__ d_o,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta,
                         __nv_bfloat16* __restrict__ dk,
                         __nv_bfloat16* __restrict__ dv,
                         const int* __restrict__ kv_lens,
                         const int* __restrict__ q_offset, int sq, int skv,
                         Strides st, int causal, float scale_log2,
                         float sm_scale) {
  constexpr int LD = D + kPad;
  constexpr int kTile = kBlockM * LD;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* smem = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* k_s = smem;
  __nv_bfloat16* v_s = smem + kTile;
  // stage s: Q at ring[2 s kTile], dO at ring[(2 s + 1) kTile]
  __nv_bfloat16* ring = smem + 2 * kTile;
  // stage s: log-sum-exp (log2 domain) at stats[2 s 64], delta after it
  float* stats = reinterpret_cast<float*>(smem + 6 * kTile);

  const int b = blockIdx.z;
  const int h = blockIdx.y;
  const int k_start = blockIdx.x * kBlockN;
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

  float acc_dk[D / 8][4], acc_dv[D / 8][4];
  zero_acc<D>(acc_dk);
  zero_acc<D>(acc_dv);

  const __nv_bfloat16* q_base = q + b * st.q.b + h * st.q.h;
  const __nv_bfloat16* do_base = d_o + b * st.d_o.b + h * st.d_o.h;
  const long long row_base = (static_cast<long long>(b) * gridDim.y + h) * sq;

  // fill one stage with the query tile at m0
  auto load_stage = [&](int stage, int m0) {
    __nv_bfloat16* dst = ring + stage * 2 * kTile;
    load_rows<D>(dst, q_base, st.q.s, m0, sq, tid);
    load_rows<D>(dst + kTile, do_base, st.d_o.s, m0, sq, tid);
    float* lse_s = stats + stage * 2 * kBlockM;
    for (int i = tid; i < kBlockM; i += kThreads) {
      const int r = m0 + i;
      // rows past sq: +inf so that P is 0 there
      lse_s[i] = r < sq ? lse[row_base + r] * kLog2e : INFINITY;
      lse_s[kBlockM + i] = r < sq ? delta[row_base + r] : 0.f;
    }
  };

  if (n_qtiles > 0) {
    load_rows<D>(k_s, k + b * st.k.b + h * st.k.h, st.k.s, k_start, kv_len,
                 tid);
    load_rows<D>(v_s, v + b * st.v.b + h * st.v.h, st.v.s, k_start, kv_len,
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
    const __nv_bfloat16* q_s = ring + (it & 1) * 2 * kTile;
    const __nv_bfloat16* do_s = q_s + kTile;
    const float* lse_s = stats + (it & 1) * 2 * kBlockM;
    const float* dl_s = lse_s + kBlockM;
    const bool whole = k_start + kBlockN <= kv_len &&
                       (!causal || k_start + kBlockN - 1 <= m0 + q_off);

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
        mma_16816(s[0], ka, qb[0], qb[1]);
        mma_16816(s[1], ka, qb[2], qb[3]);
        mma_16816(dp[0], va, db[0], db[1]);
        mma_16816(dp[1], va, db[2], db[3]);
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
        pa[j * 2 + 0] = pack_bf16(p[0], p[1]);
        pa[j * 2 + 1] = pack_bf16(p[2], p[3]);
        dsa[j * 2 + 0] = pack_bf16(ds[0], ds[1]);
        dsa[j * 2 + 1] = pack_bf16(ds[2], ds[3]);
      }
      // dV += P^T dO and dK += dS^T Q: ldmatrix.trans of the chunk's 16
      // rows of dO and Q gives the B operands of two 8-column tiles
#pragma unroll
      for (int dn = 0; dn < D / 8; dn += 2) {
        const int off = (qc * 16 + (lmat & 1) * 8 + lrow) * LD + dn * 8 +
                        (lmat >> 1) * 8;
        uint32_t ob[4], qb[4];
        ldmatrix_x4_trans(ob, do_s + off);
        ldmatrix_x4_trans(qb, q_s + off);
        mma_16816(acc_dv[dn], pa, ob[0], ob[1]);
        mma_16816(acc_dv[dn + 1], pa, ob[2], ob[3]);
        mma_16816(acc_dk[dn], dsa, qb[0], qb[1]);
        mma_16816(acc_dk[dn + 1], dsa, qb[2], qb[3]);
      }
    }
    __syncthreads();  // every warp is done with this stage before refill
  }

  store_rows<D>(dk + b * st.dk.b + h * st.dk.h, st.dk.s, acc_dk, c0, skv, t);
  store_rows<D>(dv + b * st.dv.b + h * st.dv.h, st.dv.s, acc_dv, c0, skv, t);
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* d_o, const float* lse, const float* delta,
                   void* dk, void* dv, const int* kv_lens,
                   const int* q_offset, int batch, int heads, int sq, int skv,
                   const Strides& st, int causal, float sm_scale,
                   cudaStream_t stream) {
  constexpr int bytes = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkv_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((skv + kBlockN - 1) / kBlockN, heads, batch);
  flash_bwd_dkv_kernel<D><<<grid, kThreads, bytes, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v),
      static_cast<const __nv_bfloat16*>(d_o), lse, delta,
      static_cast<__nv_bfloat16*>(dk), static_cast<__nv_bfloat16*>(dv),
      kv_lens, q_offset, sq, skv, st, causal, sm_scale * kLog2e, sm_scale);
  return cudaGetLastError();
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 on success).
// Pointers are device pointers; `lse` and `delta` are contiguous (B, H, Sq)
// f32; strides are in elements; the caller checks dtypes, shapes,
// alignment (16 bytes for every row) and head_dim.
extern "C" int hsenet_flash_bwd_dkv_bf16(
    const void* q, const void* k, const void* v, const void* d_o,
    const void* lse, const void* delta, void* dk, void* dv, const int* kv_lens,
    const int* q_offset, int batch, int heads, int sq, int skv, int head_dim,
    long long q_b, long long q_h, long long q_s, long long k_b, long long k_h,
    long long k_s, long long v_b, long long v_h, long long v_s, long long do_b,
    long long do_h, long long do_s, long long dk_b, long long dk_h,
    long long dk_s, long long dv_b, long long dv_h, long long dv_s, int causal,
    float sm_scale, void* stream) {
  const Strides st{{q_b, q_h, q_s},    {k_b, k_h, k_s},    {v_b, v_h, v_s},
                   {do_b, do_h, do_s}, {dk_b, dk_h, dk_s}, {dv_b, dv_h, dv_s}};
  const auto* lf = static_cast<const float*>(lse);
  const auto* df = static_cast<const float*>(delta);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (head_dim) {
    case 64:
      return static_cast<int>(launch<64>(q, k, v, d_o, lf, df, dk, dv,
                                         kv_lens, q_offset, batch, heads, sq,
                                         skv, st, causal, sm_scale, s));
    case 128:
      return static_cast<int>(launch<128>(q, k, v, d_o, lf, df, dk, dv,
                                          kv_lens, q_offset, batch, heads, sq,
                                          skv, st, causal, sm_scale, s));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
