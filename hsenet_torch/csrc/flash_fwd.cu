// Flash-attention forward for Hopper (sm_90a): bf16 or f32 in and out at
// head dim 64 or 128, and bf16, f16 or f32 at any multiple of 64 on the
// wide route below (the caller pads the head dim), softmax in f32. The
// port's f32 route and every dtype's wide route; bf16 and f16 up to 256 run
// flash_fwd_wgmma.cu, and this file's bf16 build at 64 and 128 stays as
// the yardstick chip_smoke.py times that kernel against.
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
// Design (mma.sync, for both element types; the f32 route runs the same
// tiling with TF32 m16n8k8 products, see flash_common.cuh for why TF32):
//   * one CTA of 4 warps per (b, h, 64-row query tile); each warp owns 16
//     query rows and keeps their Q fragments in registers for the whole
//     loop;
//   * K and V tiles of 64 keys go through a two-stage shared-memory ring
//     filled by cp.async, so the next tile loads while this one computes;
//     rows are padded by 8 bf16 so ldmatrix reads hit 32 distinct banks;
//   * QK^T and PV run on the tensor cores with mma.sync m16n8k16
//     (bf16 x bf16 -> f32), their B operands read by ldmatrix (.trans for
//     V); P is rounded to bf16 for PV, as on the TPU. In f32, m16n8k8 on
//     TF32 operands read by 32-bit shared-memory loads (ldmatrix moves
//     16-bit elements), P rounded to TF32;
//   * scores are scaled in f32 and masked before the row max (tiles that
//     no mask touches skip the mask); the online softmax keeps its max
//     and sum in f32 (log2 domain);
//   * the K loop stops at min(kv_len, last row + q_offset + 1), so the
//     ragged edge costs nothing and no padding of the inputs is needed.
// Q, K, V and O are addressed through (batch, head, row) strides with the
// last dimension contiguous, so head-split views need no copy.
//
// The wide route (`_wide` entries: bf16 and f16 above head dim 256, f32
// above 128, any multiple of 64; ROADMAP C2). A 64-row tile of O above 128
// columns does not fit the registers that the design above spends on Q's A
// fragments and the output, so:
//   * one CTA per (b, h, 64-row query tile, 64-column block of O), the grid's
//     x axis holding the column blocks of each query tile;
//   * S = Q K^T over the full width is summed chunk by chunk: 64-column
//     chunks of Q and of the K tile stream through the two-stage cp.async
//     ring, and each warp reads its A fragments from shared memory (nothing
//     of the width stays in registers, so any width runs);
//   * the CTA's 64 columns of the V tile arrive with the tile's first chunk
//     (two buffers, one per tile parity); softmax and O += P V as above;
//   * every column block recomputes S the same way, so its row max, row sum
//     and tile ends are the same; the first block writes the log-sum-exp.
// S is computed once per column block: D / 64 times the products of one
// pass. Right, not fast; no configuration of the package runs these widths.

#include "flash_common.cuh"

namespace {

using namespace hsenet_flash;

template <typename T, int D>
constexpr int smem_bytes() {  // two stages of one K and one V tile
  return 2 * 2 * kBlockN * (D + kPadOf<T>) * static_cast<int>(sizeof(T));
}

struct Strides {
  Strides3 q, k, v, o;
};

// the online softmax's state for this thread's rows r0 and r0 + 8: the
// running max (log2 domain, scaled) and this thread's part of the row sum
struct RowState {
  float m0 = -INFINITY, m1 = -INFINITY;
  float l0 = 0.f, l1 = 0.f;
};

// One 64-key tile of the online softmax and O += P V: `s` holds the warp's
// raw scores (16 rows x 64 keys, this thread's part), `v_s` the tile's V
// rows (D columns, pitch D + kPadOf<T>), `acc` this thread's part of O.
// Scores are scaled in f32 and masked before the row max (a tile that
// every row sees whole skips the mask).
template <typename T, int D>
__device__ __forceinline__ void softmax_pv(float (&s)[kBlockN / 8][4],
                                           float (&acc)[D / 8][4],
                                           RowState& rs, const T* v_s, int n0,
                                           bool whole, int kv_len, int causal,
                                           int q_off, int r0, int lane,
                                           float scale_log2) {
  constexpr bool kF32 = std::is_same<T, float>::value;
  constexpr int LD = D + kPadOf<T>;
  constexpr int KS = kStepOf<T>;
  const int g = lane >> 2, t = lane & 3;
  const int lrow = lane & 7, lmat = lane >> 3;
  const int r1 = r0 + 8;
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
  const float mn0 = fmaxf(rs.m0, mx0);
  const float mn1 = fmaxf(rs.m1, mx1);
  // a row with no valid column so far keeps max -inf: subtract 0 there
  // so exp2(-inf - base) is 0 rather than NaN
  const float base0 = mn0 == -INFINITY ? 0.f : mn0;
  const float base1 = mn1 == -INFINITY ? 0.f : mn1;
  const float corr0 = exp2f(rs.m0 - base0);
  const float corr1 = exp2f(rs.m1 - base1);
  rs.m0 = mn0;
  rs.m1 = mn1;
  rs.l0 *= corr0;
  rs.l1 *= corr1;
#pragma unroll
  for (int dn = 0; dn < D / 8; ++dn) {
    acc[dn][0] *= corr0;
    acc[dn][1] *= corr0;
    acc[dn][2] *= corr1;
    acc[dn][3] *= corr1;
  }

  // P = exp2(S - max); the f32 values feed the row sum, bf16 (TF32)
  // feeds PV. Two adjacent 16x8 score tiles form one 16x16 bf16 A
  // fragment; in f32 each tile is one k-step's A fragment.
  uint32_t pf[kBlockN / KS][4];
#pragma unroll
  for (int j = 0; j < kBlockN / 8; ++j) {
    const float p0 = exp2f(s[j][0] - base0);
    const float p1 = exp2f(s[j][1] - base0);
    const float p2 = exp2f(s[j][2] - base1);
    const float p3 = exp2f(s[j][3] - base1);
    rs.l0 += p0 + p1;
    rs.l1 += p2 + p3;
    if constexpr (kF32) {
      acc_as_a_tf32(pf[j], p0, p1, p2, p3);
    } else {
      pf[j / 2][(j % 2) * 2 + 0] = pack2<T>(p0, p1);
      pf[j / 2][(j % 2) * 2 + 1] = pack2<T>(p2, p3);
    }
  }

  // O += P V: ldmatrix.trans of four 8x8 V blocks (keys +0/+8 x columns
  // +0/+8) gives the B operands of two 8-column output tiles; in f32 the
  // step's keys 2t and 2t + 1 (the order of acc_as_a_tf32)
  if constexpr (kF32) {
#pragma unroll
    for (int kc = 0; kc < kBlockN / 8; ++kc) {
      const T* vr = v_s + (kc * 8 + 2 * t) * LD + g;
#pragma unroll
      for (int dn = 0; dn < D / 8; ++dn) {
        mma_1688(acc[dn], pf[kc], tf32(vr[dn * 8]), tf32(vr[LD + dn * 8]));
      }
    }
  } else {
#pragma unroll
    for (int kc = 0; kc < kBlockN / 16; ++kc) {
#pragma unroll
      for (int dn = 0; dn < D / 8; dn += 2) {
        uint32_t vb[4];
        ldmatrix_x4_trans(
            vb, v_s + (kc * 16 + (lmat & 1) * 8 + lrow) * LD + dn * 8 +
                    (lmat >> 1) * 8);
        mma_16816<T>(acc[dn], pf[kc], vb[0], vb[1]);
        mma_16816<T>(acc[dn + 1], pf[kc], vb[2], vb[3]);
      }
    }
  }
}

// O's D columns from `acc` normalised by the row sums, at `o_rows` (rows
// r0 and r0 + 8 below sq), and, where `lse_bh` is given, each row's
// log-sum-exp (1e30 for a row with no valid column)
template <typename T, int D>
__device__ __forceinline__ void finish_rows(T* o_rows, long long stride,
                                            const float (&acc)[D / 8][4],
                                            RowState rs, int r0, int sq,
                                            int lane, float* lse_bh) {
  const int t = lane & 3;
  const int r1 = r0 + 8;
  rs.l0 += __shfl_xor_sync(0xffffffffu, rs.l0, 1);
  rs.l0 += __shfl_xor_sync(0xffffffffu, rs.l0, 2);
  rs.l1 += __shfl_xor_sync(0xffffffffu, rs.l1, 1);
  rs.l1 += __shfl_xor_sync(0xffffffffu, rs.l1, 2);
  const float inv0 = rs.l0 > 0.f ? 1.f / rs.l0 : 0.f;  // empty row -> 0
  const float inv1 = rs.l1 > 0.f ? 1.f / rs.l1 : 0.f;
  store_rows<T, D>(o_rows, stride, acc, r0, sq, t, inv0, inv1);
  if (lse_bh != nullptr && t == 0) {
    // ln(sum exp(scale s)) = (max + log2 sum) ln 2, max in the log2 domain
    if (r0 < sq) {
      lse_bh[r0] = rs.l0 > 0.f ? (rs.m0 + log2f(rs.l0)) * kLn2 : kEmptyRowLse;
    }
    if (r1 < sq) {
      lse_bh[r1] = rs.l1 > 0.f ? (rs.m1 + log2f(rs.l1)) * kLn2 : kEmptyRowLse;
    }
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ o,
                     float* __restrict__ lse,
                     const int* __restrict__ kv_lens,
                     const int* __restrict__ q_offset, int sq, int skv,
                     Strides st, int causal, float scale_log2) {
  constexpr bool kF32 = std::is_same<T, float>::value;
  constexpr int LD = D + kPadOf<T>;
  constexpr int kTile = kBlockN * LD;  // elements per K or V tile
  constexpr int KS = kStepOf<T>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // ring stage s: K at smem[2 s kTile], V at smem[(2 s + 1) kTile]
  T* smem = reinterpret_cast<T*>(smem_raw);

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

  const T* q_base = q + b * st.q.b + h * st.q.h;
  const T* k_base = k + b * st.k.b + h * st.k.h;
  const T* v_base = v + b * st.v.b + h * st.v.h;
  T* o_base = o + b * st.o.b + h * st.o.h;

  if (n_tiles > 0) {
    load_rows<T, D>(smem, k_base, st.k.s, 0, n_end, tid);
    load_rows<T, D>(smem + kTile, v_base, st.v.s, 0, n_end, tid);
  }
  cp_async_commit();

  // this thread's two query rows: r0 and r0 + 8 of the warp's 16
  const int r0 = q_start + warp * 16 + g;

  // A fragments of Q (16 rows x D), loaded once
  uint32_t qf[D / KS][4];
  load_a_rows<D>(qf, q_base, st.q.s, r0, sq, t);

  float acc[D / 8][4];
#pragma unroll
  for (int dn = 0; dn < D / 8; ++dn) {
    acc[dn][0] = acc[dn][1] = acc[dn][2] = acc[dn][3] = 0.f;
  }
  RowState rs;

  // ldmatrix lane addressing: row within an 8x8 matrix, and which matrix
  const int lrow = lane & 7;
  const int lmat = lane >> 3;

  for (int tile = 0; tile < n_tiles; ++tile) {
    const int n0 = tile * kBlockN;
    if (tile + 1 < n_tiles) {  // prefetch the next tile into the other stage
      T* nxt = smem + ((tile + 1) & 1) * 2 * kTile;
      load_rows<T, D>(nxt, k_base, st.k.s, n0 + kBlockN, n_end, tid);
      load_rows<T, D>(nxt + kTile, v_base, st.v.s, n0 + kBlockN, n_end, tid);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // this tile is in shared memory for every warp
    const T* k_s = smem + (tile & 1) * 2 * kTile;
    const T* v_s = k_s + kTile;

    // S = Q K^T: 16 rows x 64 keys per warp, as 8 tiles of 16 x 8; in bf16
    // one ldmatrix.x4 gives the B operands of two k-steps
    float s[kBlockN / 8][4];
#pragma unroll
    for (int j = 0; j < kBlockN / 8; ++j) {
      s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
      if constexpr (kF32) {
        const T* kr = k_s + (j * 8 + g) * LD + t;
#pragma unroll
        for (int kk = 0; kk < D / 8; ++kk) {
          mma_1688(s[j], qf[kk], tf32(kr[kk * 8]), tf32(kr[kk * 8 + 4]));
        }
      } else {
#pragma unroll
        for (int kk = 0; kk < D / 16; kk += 2) {
          uint32_t kb[4];
          ldmatrix_x4(kb, k_s + (j * 8 + lrow) * LD + kk * 16 + lmat * 8);
          mma_16816<T>(s[j], qf[kk], kb[0], kb[1]);
          mma_16816<T>(s[j], qf[kk + 1], kb[2], kb[3]);
        }
      }
    }

    // a tile that every row sees whole needs no mask
    const bool whole = n0 + kBlockN <= kv_len &&
                       (!causal || n0 + kBlockN - 1 <= q_start + q_off);
    softmax_pv<T, D>(s, acc, rs, v_s, n0, whole, kv_len, causal, q_off, r0,
                     lane, scale_log2);
    __syncthreads();  // every warp is done with this stage before refill
  }

  finish_rows<T, D>(o_base, st.o.s, acc, rs, r0, sq, lane,
                    lse == nullptr ? nullptr
                                   : lse + (static_cast<long long>(b) *
                                                gridDim.y + h) * sq);
}

// ---- the wide route ----

template <typename T>
constexpr int wide_smem_bytes() {
  // two stages of a 64-column chunk of Q and of the K tile, and two buffers
  // of the CTA's 64 columns of a V tile
  return 6 * kBlockN * (64 + kPadOf<T>) * static_cast<int>(sizeof(T));
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_wide_kernel(const T* __restrict__ q, const T* __restrict__ k,
                          const T* __restrict__ v, T* __restrict__ o,
                          float* __restrict__ lse,
                          const int* __restrict__ kv_lens,
                          const int* __restrict__ q_offset, int sq, int skv,
                          int d, Strides st, int causal, float scale_log2) {
  constexpr bool kF32 = std::is_same<T, float>::value;
  constexpr int LD = 64 + kPadOf<T>;
  constexpr int kTile = kBlockN * LD;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // stage s: Q's chunk at smem[2 s kTile], K's at smem[(2 s + 1) kTile];
  // the V block of a tile of parity p at smem[(4 + p) kTile]
  T* smem = reinterpret_cast<T*>(smem_raw);

  const int n_chunks = d / 64;
  const int b = blockIdx.z;
  const int h = blockIdx.y;
  const int q_start = blockIdx.x / n_chunks * kBlockM;
  const int c_out = blockIdx.x % n_chunks * 64;  // this CTA's first O column
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
  const T* k_base = k + b * st.k.b + h * st.k.h;
  const T* v_base = v + b * st.v.b + h * st.v.h;
  T* o_base = o + b * st.o.b + h * st.o.h;

  // step i: chunk i % n_chunks of key tile i / n_chunks
  auto load_step = [&](int i) {
    const int n0 = i / n_chunks * kBlockN, c = i % n_chunks * 64;
    T* dst = smem + (i & 1) * 2 * kTile;
    load_rows<T, 64>(dst, q_base + c, st.q.s, q_start, sq, tid);
    load_rows<T, 64>(dst + kTile, k_base + c, st.k.s, n0, n_end, tid);
    if (c == 0) {
      load_rows<T, 64>(smem + (4 + (i / n_chunks & 1)) * kTile,
                       v_base + c_out, st.v.s, n0, n_end, tid);
    }
  };
  if (n_steps > 0) load_step(0);
  cp_async_commit();

  const int r0 = q_start + warp * 16 + g;
  float acc[8][4], s[kBlockN / 8][4];
#pragma unroll
  for (int dn = 0; dn < 8; ++dn) {
    acc[dn][0] = acc[dn][1] = acc[dn][2] = acc[dn][3] = 0.f;
  }
  RowState rs;

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
    const T* q_s = smem + (i & 1) * 2 * kTile;
    const T* k_s = q_s + kTile;
    if (chunk == 0) {
#pragma unroll
      for (int j = 0; j < kBlockN / 8; ++j) {
        s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
      }
    }
    // S += Q_c K_c^T over this chunk's 64 columns
    if constexpr (kF32) {
      const T* qa = q_s + (warp * 16 + g) * LD + t;
#pragma unroll
      for (int kk = 0; kk < 64 / 8; ++kk) {
        const uint32_t a[4] = {tf32(qa[kk * 8]), tf32(qa[8 * LD + kk * 8]),
                               tf32(qa[kk * 8 + 4]),
                               tf32(qa[8 * LD + kk * 8 + 4])};
#pragma unroll
        for (int j = 0; j < kBlockN / 8; ++j) {
          const T* kr = k_s + (j * 8 + g) * LD + kk * 8 + t;
          mma_1688(s[j], a, tf32(kr[0]), tf32(kr[4]));
        }
      }
    } else {
#pragma unroll
      for (int kk = 0; kk < 64 / 16; kk += 2) {
        uint32_t a0[4], a1[4];
        ldmatrix_x4(a0, q_s + (warp * 16 + (lane & 15)) * LD + kk * 16 +
                            (lane >> 4) * 8);
        ldmatrix_x4(a1, q_s + (warp * 16 + (lane & 15)) * LD + kk * 16 + 16 +
                            (lane >> 4) * 8);
#pragma unroll
        for (int j = 0; j < kBlockN / 8; ++j) {
          uint32_t kb[4];
          ldmatrix_x4(kb, k_s + (j * 8 + lrow) * LD + kk * 16 + lmat * 8);
          mma_16816<T>(s[j], a0, kb[0], kb[1]);
          mma_16816<T>(s[j], a1, kb[2], kb[3]);
        }
      }
    }
    if (chunk == n_chunks - 1) {  // the tile's S is whole
      const bool whole = n0 + kBlockN <= kv_len &&
                         (!causal || n0 + kBlockN - 1 <= q_start + q_off);
      softmax_pv<T, 64>(s, acc, rs, smem + (4 + (i / n_chunks & 1)) * kTile,
                        n0, whole, kv_len, causal, q_off, r0, lane,
                        scale_log2);
    }
    __syncthreads();  // every warp is done with this stage before refill
  }

  // the first column block writes the log-sum-exp
  finish_rows<T, 64>(o_base + c_out, st.o.s, acc, rs, r0, sq, lane,
                     lse == nullptr || c_out != 0
                         ? nullptr
                         : lse + (static_cast<long long>(b) * gridDim.y + h) *
                                     sq);
}

template <typename T>
int dispatch_wide(const void* q, const void* k, const void* v, void* o,
                  void* lse, const int* kv_lens, const int* q_offset,
                  int batch, int heads, int sq, int skv, int head_dim,
                  const Strides& st, int causal, float sm_scale,
                  void* stream) {
  if (head_dim < 64 || head_dim % 64 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  constexpr int bytes = wide_smem_bytes<T>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_wide_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((sq + kBlockM - 1) / kBlockM * (head_dim / 64), heads,
                  batch);
  flash_fwd_wide_kernel<T><<<grid, kThreads, bytes,
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), static_cast<float*>(lse),
      kv_lens, q_offset, sq, skv, head_dim, st, causal, sm_scale * kLog2e);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   float* lse, const int* kv_lens, const int* q_offset,
                   int batch, int heads, int sq, int skv, const Strides& st,
                   int causal, float scale_log2, cudaStream_t stream) {
  constexpr int bytes = smem_bytes<T, D>();
  // above 48 KB a block's shared memory must be opted into
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((sq + kBlockM - 1) / kBlockM, heads, batch);
  flash_fwd_kernel<T, D><<<grid, kThreads, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), lse, kv_lens, q_offset, sq,
      skv, st, causal, scale_log2);
  return cudaGetLastError();
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, void* o, void* lse,
             const int* kv_lens, const int* q_offset, int batch, int heads,
             int sq, int skv, int head_dim, const Strides& st, int causal,
             float sm_scale, void* stream) {
  const float scale_log2 = sm_scale * kLog2e;
  auto* lf = static_cast<float*>(lse);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (head_dim) {
    case 64:
      return static_cast<int>(launch<T, 64>(q, k, v, o, lf, kv_lens, q_offset,
                                            batch, heads, sq, skv, st, causal,
                                            scale_log2, s));
    case 128:
      return static_cast<int>(launch<T, 128>(q, k, v, o, lf, kv_lens,
                                             q_offset, batch, heads, sq, skv,
                                             st, causal, scale_log2, s));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// Launch on `stream` and return cudaGetLastError() (0 on success); `_bf16`
// takes bf16 Q, K, V and O, `_f16` f16 ones, `_f32` f32 ones. Pointers are
// device pointers; `lse` is null or a contiguous (B, H, Sq) f32 buffer;
// strides are in elements; the caller checks dtypes, shapes, alignment (16
// bytes for every row) and head_dim: 64 or 128 for `hsenet_flash_fwd_*`, a
// multiple of 64 for the wide route `hsenet_flash_fwd_wide_*` (it pads
// other widths).
#define HSENET_FLASH_FWD_ENTRY(NAME, T, DISPATCH)                              \
  extern "C" int NAME(                                                         \
      const void* q, const void* k, const void* v, void* o, void* lse,         \
      const int* kv_lens, const int* q_offset, int batch, int heads, int sq,   \
      int skv, int head_dim, long long q_b, long long q_h, long long q_s,      \
      long long k_b, long long k_h, long long k_s, long long v_b,              \
      long long v_h, long long v_s, long long o_b, long long o_h,              \
      long long o_s, int causal, float sm_scale, void* stream) {               \
    const Strides st{{q_b, q_h, q_s}, {k_b, k_h, k_s}, {v_b, v_h, v_s},        \
                     {o_b, o_h, o_s}};                                         \
    return DISPATCH<T>(q, k, v, o, lse, kv_lens, q_offset, batch, heads, sq,   \
                       skv, head_dim, st, causal, sm_scale, stream);           \
  }

HSENET_FLASH_FWD_ENTRY(hsenet_flash_fwd_bf16, __nv_bfloat16, dispatch)
HSENET_FLASH_FWD_ENTRY(hsenet_flash_fwd_f32, float, dispatch)
HSENET_FLASH_FWD_ENTRY(hsenet_flash_fwd_wide_bf16, __nv_bfloat16, dispatch_wide)
HSENET_FLASH_FWD_ENTRY(hsenet_flash_fwd_wide_f16, __half, dispatch_wide)
HSENET_FLASH_FWD_ENTRY(hsenet_flash_fwd_wide_f32, float, dispatch_wide)
