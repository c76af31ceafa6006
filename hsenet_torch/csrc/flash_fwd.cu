// Flash-attention forward for Hopper (sm_90a), bf16 in and out, f32 softmax.
//
// Replaces the TPU kernel `_flash_kernel` of the JAX package
// (ops/flash_attention.py, launched by `_flash_forward`). Per (batch b,
// head h, query row r) it computes
//   O[r] = softmax(sm_scale * Q[r] K^T) V
// over the columns c with c < kv_len[b] and, under `causal`, also
// c <= r + q_offset[b]. A row with no such column gives 0. When `lse` is
// given it also writes each row's log-sum-exp, ln sum_c exp(sm_scale Q[r].K[c])
// in f32, as (B, H, Sq); a row with no valid column gets 1e30 (the JAX
// package's -NEG_INF), so the backward's exp(s - lse) is 0 there.
//
// What bounds it on an H100 SXM (989 TFLOP/s bf16, 3.35 TB/s):
//   * the ViT towers (B x 12 heads x 2049 tokens, d 64, non-causal) are
//     bound by operations: 4 * 2049^2 * 64 * 12 = 12.9 GFLOP per batch row,
//     13 us at peak, against 12.6 MB of Q, K, V and O (3.8 us);
//   * LLM prefill (B x 24 heads, 320 queries over a 352-slot cache, d 128,
//     causal) is bound by bytes: at B=2 its 15.5 MB of Q and O and of the
//     K and V rows below kv_len take 4.6 us, while its causal work
//     (1.26 GFLOP) takes 1.3 us.
// chip_smoke.py recomputes both bounds from the shapes and data it runs.
//
// Design (mma.sync; wgmma/TMA come later):
//   * one CTA of 4 warps per (b, h, 64-row query tile); each warp owns 16
//     query rows and keeps their Q fragments in registers for the whole
//     loop;
//   * K and V tiles of 64 keys go through a two-stage shared-memory ring
//     filled by cp.async, so the next tile loads while this one computes;
//     rows are padded by 8 bf16 so ldmatrix reads hit 32 distinct banks;
//   * QK^T and PV run on the tensor cores with mma.sync m16n8k16
//     (bf16 x bf16 -> f32), their B operands read by ldmatrix (.trans for
//     V); P is rounded to bf16 for PV, as on the TPU;
//   * scores are scaled in f32 and masked before the row max (tiles that
//     no mask touches skip the mask); the online softmax keeps its max
//     and sum in f32 (log2 domain);
//   * the K loop stops at min(kv_len, last row + q_offset + 1), so the
//     ragged edge costs nothing and no padding of the inputs is needed.
// Q, K, V and O are addressed through (batch, head, row) strides with the
// last dimension contiguous, so head-split views need no copy.

#include "flash_common.cuh"

namespace {

using namespace hsenet_flash;

template <int D>
constexpr int smem_bytes() {  // two stages of one K and one V tile
  return 2 * 2 * kBlockN * (D + kPad) * static_cast<int>(sizeof(__nv_bfloat16));
}

struct Strides {
  Strides3 q, k, v, o;
};

template <int D>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_kernel(const __nv_bfloat16* __restrict__ q,
                     const __nv_bfloat16* __restrict__ k,
                     const __nv_bfloat16* __restrict__ v,
                     __nv_bfloat16* __restrict__ o, float* __restrict__ lse,
                     const int* __restrict__ kv_lens,
                     const int* __restrict__ q_offset, int sq, int skv,
                     Strides st, int causal, float scale_log2) {
  constexpr int LD = D + kPad;
  constexpr int kTile = kBlockN * LD;  // bf16 per K or V tile
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // ring stage s: K at smem[2 s kTile], V at smem[(2 s + 1) kTile]
  __nv_bfloat16* smem = reinterpret_cast<__nv_bfloat16*>(smem_raw);

  const int b = blockIdx.z;
  const int h = blockIdx.y;
  const int q_start = blockIdx.x * kBlockM;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int g = lane >> 2;  // fragment row within the 8-row group
  const int t = lane & 3;   // thread within the quad

  const int kv_len = min(max(kv_lens[b], 0), skv);
  const int q_off = q_offset[b];
  int n_end = kv_len;
  if (causal) n_end = min(n_end, min(q_start + kBlockM, sq) + q_off);
  n_end = max(n_end, 0);
  const int n_tiles = (n_end + kBlockN - 1) / kBlockN;

  const __nv_bfloat16* q_base = q + b * st.q.b + h * st.q.h;
  const __nv_bfloat16* k_base = k + b * st.k.b + h * st.k.h;
  const __nv_bfloat16* v_base = v + b * st.v.b + h * st.v.h;
  __nv_bfloat16* o_base = o + b * st.o.b + h * st.o.h;

  if (n_tiles > 0) {
    load_rows<D>(smem, k_base, st.k.s, 0, n_end, tid);
    load_rows<D>(smem + kTile, v_base, st.v.s, 0, n_end, tid);
  }
  cp_async_commit();

  // this thread's two query rows: r0 and r0 + 8 of the warp's 16
  const int r0 = q_start + warp * 16 + g;
  const int r1 = r0 + 8;

  // A fragments of Q (16 rows x D), loaded once
  uint32_t qf[D / 16][4];
  load_a_rows<D>(qf, q_base, st.q.s, r0, sq, t);

  float acc[D / 8][4];
#pragma unroll
  for (int dn = 0; dn < D / 8; ++dn) {
    acc[dn][0] = acc[dn][1] = acc[dn][2] = acc[dn][3] = 0.f;
  }
  float m0 = -INFINITY, m1 = -INFINITY;  // running row max (log2 domain)
  float l0 = 0.f, l1 = 0.f;              // this thread's part of the row sum

  // ldmatrix lane addressing: row within an 8x8 matrix, and which matrix
  const int lrow = lane & 7;
  const int lmat = lane >> 3;

  for (int tile = 0; tile < n_tiles; ++tile) {
    const int n0 = tile * kBlockN;
    if (tile + 1 < n_tiles) {  // prefetch the next tile into the other stage
      __nv_bfloat16* nxt = smem + ((tile + 1) & 1) * 2 * kTile;
      load_rows<D>(nxt, k_base, st.k.s, n0 + kBlockN, n_end, tid);
      load_rows<D>(nxt + kTile, v_base, st.v.s, n0 + kBlockN, n_end, tid);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // this tile is in shared memory for every warp
    const __nv_bfloat16* k_s = smem + (tile & 1) * 2 * kTile;
    const __nv_bfloat16* v_s = k_s + kTile;

    // S = Q K^T: 16 rows x 64 keys per warp, as 8 tiles of 16 x 8; one
    // ldmatrix.x4 gives the B operands of two k-steps
    float s[kBlockN / 8][4];
#pragma unroll
    for (int j = 0; j < kBlockN / 8; ++j) {
      s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < D / 16; kk += 2) {
        uint32_t kb[4];
        ldmatrix_x4(kb, k_s + (j * 8 + lrow) * LD + kk * 16 + lmat * 8);
        mma_16816(s[j], qf[kk], kb[0], kb[1]);
        mma_16816(s[j], qf[kk + 1], kb[2], kb[3]);
      }
    }

    // scale in f32, mask, then take the row max over the valid columns; a
    // tile that every row sees whole needs no mask
    const bool whole = n0 + kBlockN <= kv_len &&
                       (!causal || n0 + kBlockN - 1 <= q_start + q_off);
    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int j = 0; j < kBlockN / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = n0 + j * 8 + 2 * t + (e & 1);
        const int row = e < 2 ? r0 : r1;
        const bool ok =
            whole || (col < kv_len && (!causal || col <= row + q_off));
        s[j][e] = ok ? s[j][e] * scale_log2 : -INFINITY;
      }
      mx0 = fmaxf(mx0, fmaxf(s[j][0], s[j][1]));
      mx1 = fmaxf(mx1, fmaxf(s[j][2], s[j][3]));
    }
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
    const float mn0 = fmaxf(m0, mx0);
    const float mn1 = fmaxf(m1, mx1);
    // a row with no valid column so far keeps max -inf: subtract 0 there
    // so exp2(-inf - base) is 0 rather than NaN
    const float base0 = mn0 == -INFINITY ? 0.f : mn0;
    const float base1 = mn1 == -INFINITY ? 0.f : mn1;
    const float corr0 = exp2f(m0 - base0);
    const float corr1 = exp2f(m1 - base1);
    m0 = mn0;
    m1 = mn1;
    l0 *= corr0;
    l1 *= corr1;
#pragma unroll
    for (int dn = 0; dn < D / 8; ++dn) {
      acc[dn][0] *= corr0;
      acc[dn][1] *= corr0;
      acc[dn][2] *= corr1;
      acc[dn][3] *= corr1;
    }

    // P = exp2(S - max); the f32 values feed the row sum, bf16 feeds PV.
    // Two adjacent 16x8 score tiles form one 16x16 A fragment.
    uint32_t pf[kBlockN / 16][4];
#pragma unroll
    for (int j = 0; j < kBlockN / 8; ++j) {
      const float p0 = exp2f(s[j][0] - base0);
      const float p1 = exp2f(s[j][1] - base0);
      const float p2 = exp2f(s[j][2] - base1);
      const float p3 = exp2f(s[j][3] - base1);
      l0 += p0 + p1;
      l1 += p2 + p3;
      pf[j / 2][(j % 2) * 2 + 0] = pack_bf16(p0, p1);
      pf[j / 2][(j % 2) * 2 + 1] = pack_bf16(p2, p3);
    }

    // O += P V: ldmatrix.trans of four 8x8 V blocks (keys +0/+8 x columns
    // +0/+8) gives the B operands of two 8-column output tiles
#pragma unroll
    for (int kc = 0; kc < kBlockN / 16; ++kc) {
#pragma unroll
      for (int dn = 0; dn < D / 8; dn += 2) {
        uint32_t vb[4];
        ldmatrix_x4_trans(
            vb, v_s + (kc * 16 + (lmat & 1) * 8 + lrow) * LD + dn * 8 +
                    (lmat >> 1) * 8);
        mma_16816(acc[dn], pf[kc], vb[0], vb[1]);
        mma_16816(acc[dn + 1], pf[kc], vb[2], vb[3]);
      }
    }
    __syncthreads();  // every warp is done with this stage before refill
  }

  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  const float inv0 = l0 > 0.f ? 1.f / l0 : 0.f;  // empty row -> 0
  const float inv1 = l1 > 0.f ? 1.f / l1 : 0.f;
  store_rows<D>(o_base, st.o.s, acc, r0, sq, t, inv0, inv1);
  if (lse != nullptr && t == 0) {
    // ln(sum exp(scale s)) = (max + log2 sum) ln 2, max in the log2 domain
    float* lse_bh = lse + (static_cast<long long>(b) * gridDim.y + h) * sq;
    if (r0 < sq) lse_bh[r0] = l0 > 0.f ? (m0 + log2f(l0)) * kLn2 : kEmptyRowLse;
    if (r1 < sq) lse_bh[r1] = l1 > 0.f ? (m1 + log2f(l1)) * kLn2 : kEmptyRowLse;
  }
}

template <int D>
cudaError_t launch(const __nv_bfloat16* q, const __nv_bfloat16* k,
                   const __nv_bfloat16* v, __nv_bfloat16* o, float* lse,
                   const int* kv_lens, const int* q_offset, int batch,
                   int heads, int sq, int skv, const Strides& st, int causal,
                   float scale_log2, cudaStream_t stream) {
  constexpr int bytes = smem_bytes<D>();
  // above 48 KB a block's shared memory must be opted into
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((sq + kBlockM - 1) / kBlockM, heads, batch);
  flash_fwd_kernel<D><<<grid, kThreads, bytes, stream>>>(
      q, k, v, o, lse, kv_lens, q_offset, sq, skv, st, causal, scale_log2);
  return cudaGetLastError();
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 on success).
// Pointers are device pointers; `lse` is null or a contiguous (B, H, Sq)
// f32 buffer; strides are in elements; the caller checks dtypes, shapes,
// alignment (16 bytes for every row) and head_dim.
extern "C" int hsenet_flash_fwd_bf16(
    const void* q, const void* k, const void* v, void* o, void* lse,
    const int* kv_lens, const int* q_offset, int batch, int heads, int sq,
    int skv, int head_dim, long long q_b, long long q_h, long long q_s,
    long long k_b, long long k_h, long long k_s, long long v_b, long long v_h,
    long long v_s, long long o_b, long long o_h, long long o_s, int causal,
    float sm_scale, void* stream) {
  const Strides st{{q_b, q_h, q_s}, {k_b, k_h, k_s}, {v_b, v_h, v_s},
                   {o_b, o_h, o_s}};
  const float scale_log2 = sm_scale * kLog2e;
  const auto* qb = static_cast<const __nv_bfloat16*>(q);
  const auto* kb = static_cast<const __nv_bfloat16*>(k);
  const auto* vb = static_cast<const __nv_bfloat16*>(v);
  auto* ob = static_cast<__nv_bfloat16*>(o);
  auto* lf = static_cast<float*>(lse);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (head_dim) {
    case 64:
      return static_cast<int>(launch<64>(qb, kb, vb, ob, lf, kv_lens, q_offset,
                                         batch, heads, sq, skv, st, causal,
                                         scale_log2, s));
    case 128:
      return static_cast<int>(launch<128>(qb, kb, vb, ob, lf, kv_lens,
                                          q_offset, batch, heads, sq, skv, st,
                                          causal, scale_log2, s));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
