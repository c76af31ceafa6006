// Flash-attention backward, dQ, for Hopper (sm_90a): bf16 in and out, f32
// accumulation.
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
// Design (mma.sync; wgmma/TMA come later), the forward's layout turned to
// the gradient:
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
//     are never read. No atomics: each CTA owns its dQ rows.

#include "flash_common.cuh"

namespace {

using namespace hsenet_flash;

template <int D>
constexpr int smem_bytes() {  // two stages of one K and one V tile
  return 2 * 2 * kBlockN * (D + kPad) * static_cast<int>(sizeof(__nv_bfloat16));
}

struct Strides {
  Strides3 q, k, v, d_o, dq;
};

template <int D>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dq_kernel(const __nv_bfloat16* __restrict__ q,
                        const __nv_bfloat16* __restrict__ k,
                        const __nv_bfloat16* __restrict__ v,
                        const __nv_bfloat16* __restrict__ d_o,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta,
                        __nv_bfloat16* __restrict__ dq,
                        const int* __restrict__ kv_lens,
                        const int* __restrict__ q_offset, int sq, int skv,
                        Strides st, int causal, float scale_log2,
                        float sm_scale) {
  constexpr int LD = D + kPad;
  constexpr int kTile = kBlockN * LD;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* smem = reinterpret_cast<__nv_bfloat16*>(smem_raw);

  const int b = blockIdx.z;
  const int h = blockIdx.y;
  const int q_start = blockIdx.x * kBlockM;
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

  const __nv_bfloat16* k_base = k + b * st.k.b + h * st.k.h;
  const __nv_bfloat16* v_base = v + b * st.v.b + h * st.v.h;
  if (n_tiles > 0) {
    load_rows<D>(smem, k_base, st.k.s, 0, n_end, tid);
    load_rows<D>(smem + kTile, v_base, st.v.s, 0, n_end, tid);
  }
  cp_async_commit();

  const int r0 = q_start + warp * 16 + g;
  const int r1 = r0 + 8;
  uint32_t qf[D / 16][4];
  uint32_t df[D / 16][4];
  load_a_rows<D>(qf, q + b * st.q.b + h * st.q.h, st.q.s, r0, sq, t);
  load_a_rows<D>(df, d_o + b * st.d_o.b + h * st.d_o.h, st.d_o.s, r0, sq, t);
  // log-sum-exp in the log2 domain; rows past sq get +inf so P is 0
  const long long row_base = (static_cast<long long>(b) * gridDim.y + h) * sq;
  const float lse0 = r0 < sq ? lse[row_base + r0] * kLog2e : INFINITY;
  const float lse1 = r1 < sq ? lse[row_base + r1] * kLog2e : INFINITY;
  const float dl0 = r0 < sq ? delta[row_base + r0] : 0.f;
  const float dl1 = r1 < sq ? delta[row_base + r1] : 0.f;

  float acc[D / 8][4];
#pragma unroll
  for (int dn = 0; dn < D / 8; ++dn) {
    acc[dn][0] = acc[dn][1] = acc[dn][2] = acc[dn][3] = 0.f;
  }

  for (int tile = 0; tile < n_tiles; ++tile) {
    const int n0 = tile * kBlockN;
    if (tile + 1 < n_tiles) {
      __nv_bfloat16* nxt = smem + ((tile + 1) & 1) * 2 * kTile;
      load_rows<D>(nxt, k_base, st.k.s, n0 + kBlockN, n_end, tid);
      load_rows<D>(nxt + kTile, v_base, st.v.s, n0 + kBlockN, n_end, tid);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const __nv_bfloat16* k_s = smem + (tile & 1) * 2 * kTile;
    const __nv_bfloat16* v_s = k_s + kTile;
    const bool whole = n0 + kBlockN <= kv_len &&
                       (!causal || n0 + kBlockN - 1 <= q_start + q_off);

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
          mma_16816(s[j], qf[kk], kb[0], kb[1]);
          mma_16816(s[j], qf[kk + 1], kb[2], kb[3]);
          mma_16816(dp[j], df[kk], vb[0], vb[1]);
          mma_16816(dp[j], df[kk + 1], vb[2], vb[3]);
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
        dsf[j * 2 + 0] = pack_bf16(ds[0], ds[1]);
        dsf[j * 2 + 1] = pack_bf16(ds[2], ds[3]);
      }
      // dQ += dS K: ldmatrix.trans of the chunk's K rows gives B operands
#pragma unroll
      for (int dn = 0; dn < D / 8; dn += 2) {
        uint32_t kb[4];
        ldmatrix_x4_trans(kb, k_s + (kc * 16 + (lmat & 1) * 8 + lrow) * LD +
                                  dn * 8 + (lmat >> 1) * 8);
        mma_16816(acc[dn], dsf, kb[0], kb[1]);
        mma_16816(acc[dn + 1], dsf, kb[2], kb[3]);
      }
    }
    __syncthreads();  // every warp is done with this stage before refill
  }

  store_rows<D>(dq + b * st.dq.b + h * st.dq.h, st.dq.s, acc, r0, sq, t);
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* d_o, const float* lse, const float* delta,
                   void* dq, const int* kv_lens, const int* q_offset,
                   int batch, int heads, int sq, int skv, const Strides& st,
                   int causal, float sm_scale, cudaStream_t stream) {
  constexpr int bytes = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((sq + kBlockM - 1) / kBlockM, heads, batch);
  flash_bwd_dq_kernel<D><<<grid, kThreads, bytes, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v),
      static_cast<const __nv_bfloat16*>(d_o), lse, delta,
      static_cast<__nv_bfloat16*>(dq), kv_lens, q_offset, sq, skv, st, causal,
      sm_scale * kLog2e, sm_scale);
  return cudaGetLastError();
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 on success).
// Pointers are device pointers; `lse` and `delta` are contiguous (B, H, Sq)
// f32; strides are in elements; the caller checks dtypes, shapes,
// alignment (16 bytes for every row) and head_dim.
extern "C" int hsenet_flash_bwd_dq_bf16(
    const void* q, const void* k, const void* v, const void* d_o,
    const void* lse, const void* delta, void* dq, const int* kv_lens,
    const int* q_offset, int batch, int heads, int sq, int skv, int head_dim,
    long long q_b, long long q_h, long long q_s, long long k_b, long long k_h,
    long long k_s, long long v_b, long long v_h, long long v_s, long long do_b,
    long long do_h, long long do_s, long long dq_b, long long dq_h,
    long long dq_s, int causal, float sm_scale, void* stream) {
  const Strides st{{q_b, q_h, q_s}, {k_b, k_h, k_s}, {v_b, v_h, v_s},
                   {do_b, do_h, do_s}, {dq_b, dq_h, dq_s}};
  const auto* lf = static_cast<const float*>(lse);
  const auto* df = static_cast<const float*>(delta);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (head_dim) {
    case 64:
      return static_cast<int>(launch<64>(q, k, v, d_o, lf, df, dq, kv_lens,
                                         q_offset, batch, heads, sq, skv, st,
                                         causal, sm_scale, s));
    case 128:
      return static_cast<int>(launch<128>(q, k, v, d_o, lf, df, dq, kv_lens,
                                          q_offset, batch, heads, sq, skv, st,
                                          causal, sm_scale, s));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
