"""What surrounds the tensor-core int8 matvec kernel, on the CPU.

The kernel (`csrc/quant_matvec.cu`, `hsenet_quant_matvec_mma`) runs only on
the card; these tests hold what the wrapper and the source state about it:

  * the cut `mma_plan` at every shape the port launches it at (and a
    ragged one), every M in 1..8: the CTAs' channel tiles cover each output
    channel once, the warps' K slices cover K once in 16-code steps;
  * the K permutation of the mma fragments (`fragment_k_order`), and a
    numpy emulation of one warp's fragments as the kernel builds them
    (16-byte loads, the bit-level int8 -> bf16 conversion, x gathered by
    byte permutes, the m16n8k16 fragment layout) against the plain
    product;
  * `quant_matvec_int8_reference` summed over the plan's K slices in the
    kernel's order (f32 partial sums added in warp order, scaled, cast
    once) against the JAX package's `quant_matvec_int8` through its Pallas
    kernel in interpret mode, within `tests/test_torch_quant.py`'s `TOL`
    (1e-5: the two sum over K in another order).

The emulation sums exact products (int8 codes times bf16-exact values) in
f64, so it must equal the plain f64 product exactly.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import hsenet_tpu.ops.quant_matvec as jqm
from hsenet_torch.ops import quant_matvec as tqm
from test_torch_common import to_np

torch.set_num_threads(1)

TOL = dict(atol=1e-5, rtol=1e-5)  # tests/test_torch_quant.py's f32 limit
# (K, N) of every shape the port's paths and chip_smoke.py launch the
# kernel at: Phi-4-mini's projections, the LM head's table, the
# `--synthetic` models' projections, and a ragged shape (K = 193 x 16)
SHAPES = {
    "qo": (3072, 3072), "kv": (3072, 1024), "gate_up": (3072, 8192),
    "down": (8192, 3072), "lm_head": (3072, 200064), "syn_64x32": (64, 32),
    "syn_128x64": (128, 64), "ragged": (3088, 1000),
}


@pytest.mark.parametrize("name", sorted(SHAPES))
def test_plan_covers_channels_and_k_once(name):
    k, n = SHAPES[name]
    for m in range(1, tqm.MAX_KERNEL_ROWS + 1):
        plan = tqm.mma_plan(m, k, n)
        assert plan.blocks == -(-n // tqm.MMA_TILE)
        assert plan.blocks < 2 ** 31  # the grid's x
        assert plan.shared_bytes <= 227 * 1024  # an SM's shared memory
        # every output channel in exactly one CTA
        seen = np.zeros(n, np.int64)
        for tile in plan.tiles(n):
            assert len(tile) <= tqm.MMA_TILE
            seen[list(tile)] += 1
        assert (seen == 1).all()
        # the warps' K slices: contiguous, in warp order, none empty,
        # 64-code aligned but for the end at K, every 16-code step once
        slices = plan.k_slices(k)
        assert 1 <= len(slices) <= tqm.MMA_WARPS
        assert slices[0][0] == 0 and slices[-1][1] == k
        for (a0, a1), (b0, _) in zip(slices, slices[1:]):
            assert a1 == b0
        steps = np.zeros(k // tqm.K_ALIGN, np.int64)
        for k0, k1 in slices:
            assert k0 < k1 and k0 % tqm.MMA_CHUNK == 0 and k1 % tqm.K_ALIGN == 0
            assert k1 - k0 <= plan.chunks_per_warp * tqm.MMA_CHUNK
            steps[k0 // tqm.K_ALIGN:k1 // tqm.K_ALIGN] += 1
        assert (steps == 1).all()
        # the kernel's own cut (quant_matvec_mma_kernel)
        chunks = -(-k // tqm.MMA_CHUNK)
        assert plan.chunks_per_warp == -(-chunks // tqm.MMA_WARPS)


def test_plan_fills_the_card():
    """At the decode's shapes every warp of a CTA gets an equal slice of K
    (48 or 128 chunks over 8 warps), and the grid is one CTA a tile of 16
    channels: 192, 64, 512 and 192 CTAs of 8 warps, and 12504 at the LM
    head's table."""
    want = {"qo": (6, 192), "kv": (6, 64), "gate_up": (6, 512),
            "down": (16, 192), "lm_head": (6, 12504)}
    for name, (per_warp, blocks) in want.items():
        k, n = SHAPES[name]
        for m in (1, 8):
            plan = tqm.mma_plan(m, k, n)
            assert plan == (per_warp, blocks), (name, plan)
            assert [k1 - k0 for k0, k1 in plan.k_slices(k)] == (
                [per_warp * tqm.MMA_CHUNK] * tqm.MMA_WARPS)
    with pytest.raises(ValueError):
        tqm.mma_plan(9, 64, 32)
    with pytest.raises(ValueError):
        tqm.mma_plan(1, 24, 32)


def test_fragment_k_order_is_a_permutation():
    order = np.array(tqm.fragment_k_order())
    assert order.shape == (4, 16)
    assert sorted(order.ravel().tolist()) == list(range(tqm.MMA_CHUNK))
    for j in range(4):
        assert len(set(order[j])) == 16
        for t in range(4):  # lane t's slots come from its 16-byte load at 16 t
            slots = order[j][[2 * t, 2 * t + 1, 2 * t + 8, 2 * t + 9]]
            assert set(slots) == set(range(16 * t + 4 * j, 16 * t + 4 * j + 4))
    # the same permutation applied to both operands leaves the sum alone
    rng = np.random.default_rng(0)
    a = rng.integers(-128, 128, 64).astype(np.float64)
    b = rng.standard_normal(64)
    perm = order.ravel()
    assert np.dot(a[perm], b[perm]) == pytest.approx(np.dot(a, b), rel=1e-12)


def _bf16_bits_to_f64(bits):
    return (np.asarray(bits, np.uint32) << 16).view(np.float32).astype(np.float64)


def _codes_to_bf16(word):
    """The kernel's `codes_to_bf16` on one 32-bit word of 4 codes: the bf16
    pairs (b0, b2) and (b1, b3) as (lo, hi) values."""
    pairs = []
    for w in (word, word >> 8):
        a = (w & 0x007F007F) | 0x43004300
        s = (w & 0x00800080) | 0x43004300
        lo = _bf16_bits_to_f64(a & 0xFFFF) - _bf16_bits_to_f64(s & 0xFFFF)
        hi = _bf16_bits_to_f64(a >> 16) - _bf16_bits_to_f64(s >> 16)
        pairs.append((lo, hi))
    return pairs  # even, odd


def test_int8_to_bf16_by_bits_is_exact():
    codes = np.arange(-128, 128, dtype=np.int8)
    words = codes.view(np.uint8).reshape(-1, 4).astype(np.uint32)
    packed = words[:, 0] | words[:, 1] << 8 | words[:, 2] << 16 | words[:, 3] << 24
    got = []
    for w in packed:
        (e_lo, e_hi), (o_lo, o_hi) = _codes_to_bf16(int(w))
        got += [e_lo, o_lo, e_hi, o_hi]  # b0, b1, b2, b3
    assert np.array_equal(np.array(got), codes.astype(np.float64))


def _emulate_warp_tile(x, w, k):
    """One warp's 16-channel tile over all of K as the kernel builds it:
    (16, M) sums of mma fragments, in f64. x (M, K) bf16-exact values, w
    (16, K) int8."""
    m = x.shape[0]
    xb = np.zeros((8, k), np.float32)
    xb[:m] = x
    x_bits = xb.view(np.uint32) >> 16  # each value's bf16 bits
    w_bytes = w.view(np.uint8)
    d = np.zeros((16, 8))
    for c in range(-(-k // tqm.MMA_CHUNK)):
        for j in range(4):
            a = np.zeros((16, 16))
            b = np.zeros((16, 8))
            for lane in range(32):
                g, t = lane // 4, lane % 4
                kk = c * tqm.MMA_CHUNK + 16 * t
                if kk >= k:  # past K the lane loads zeros
                    continue
                for row in (g, g + 8):
                    wb = w_bytes[row, kk + 4 * j:kk + 4 * j + 4].astype(np.uint32)
                    word = int(wb[0] | wb[1] << 8 | wb[2] << 16 | wb[3] << 24)
                    (e_lo, e_hi), (o_lo, o_hi) = _codes_to_bf16(word)
                    a[row, 2 * t], a[row, 2 * t + 1] = e_lo, e_hi
                    a[row, 2 * t + 8], a[row, 2 * t + 9] = o_lo, o_hi
                # x's row g: words X[2j], X[2j + 1] of its 16 values at kk
                xs = x_bits[g, kk:kk + 16]
                x0 = (xs[4 * j], xs[4 * j + 1])  # (lo, hi) of X[2j]
                x1 = (xs[4 * j + 2], xs[4 * j + 3])  # of X[2j + 1]
                b0 = (x0[0], x1[0])  # byte_perm(x0, x1, 0x5410)
                b1 = (x0[1], x1[1])  # byte_perm(x0, x1, 0x7632)
                b[2 * t, g], b[2 * t + 1, g] = _bf16_bits_to_f64(b0)
                b[2 * t + 8, g], b[2 * t + 9, g] = _bf16_bits_to_f64(b1)
            d += a @ b
    return d[:, :m]


@pytest.mark.parametrize("k,m", [(64, 8), (112, 3), (208, 1)])
def test_fragments_give_the_plain_sum(k, m):
    """K 112 and 208 end inside a chunk (lanes past K load zeros)."""
    rng = np.random.default_rng(k + m)
    x = torch.randn(m, k, generator=torch.Generator().manual_seed(k)).to(
        torch.bfloat16).float().numpy()
    w = rng.integers(-128, 128, (16, k)).astype(np.int8)
    got = _emulate_warp_tile(x, w, k)
    want = w.astype(np.float64) @ x.astype(np.float64).T
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-9)


@pytest.mark.parametrize("k", [64, 112])
@pytest.mark.parametrize("m", [1, 8])
def test_split_sum_matches_jax(k, m):
    """The plain version over the plan's K slices in warp order, as the
    kernel sums them, against the JAX Pallas kernel (interpret mode). At K
    112 the plan cuts K in two slices (64 + 48)."""
    n = 256
    rng = np.random.default_rng(10 * k + m)
    x = rng.standard_normal((m, k)).astype(np.float32)
    wq = rng.integers(-127, 128, (k, n)).astype(np.int8)  # JAX layout (K, N)
    scale = rng.uniform(0.001, 0.02, n).astype(np.float32)
    want = np.asarray(jqm.quant_matvec_int8(
        jnp.asarray(x), jnp.asarray(wq), jnp.asarray(scale)))
    tx, tw = torch.as_tensor(x), torch.as_tensor(wq.T.copy())
    plan = tqm.mma_plan(m, k, n)
    assert len(plan.k_slices(k)) == -(-k // tqm.MMA_CHUNK)
    acc = torch.zeros(m, n)
    for k0, k1 in plan.k_slices(k):
        acc = acc + tx[:, k0:k1] @ tw[:, k0:k1].float().t()
    got = (acc * torch.as_tensor(scale)).to(tx.dtype)
    np.testing.assert_allclose(to_np(got), want, **TOL)
    np.testing.assert_allclose(
        to_np(tqm.quant_matvec_int8_reference(tx, tw, torch.as_tensor(scale))),
        want, **TOL)


def test_entries_refuse_the_cpu():
    """Each entry raises on CPU tensors and counts nothing; the dispatcher
    gives a CPU tensor the plain version."""
    x = torch.zeros(2, 64)
    w = torch.zeros(32, 64, dtype=torch.int8)
    s = torch.ones(32)
    for fn, dtype in ((tqm.quant_matvec_mma_kernel, torch.bfloat16),
                      (tqm.quant_matvec_fma_kernel, torch.float32),
                      (tqm.quant_matvec_kernel, torch.bfloat16)):
        with pytest.raises(RuntimeError, match="CUDA"):
            fn(x.to(dtype), w, s)
    assert tqm.launches == {tqm.KERNEL: 0}
    assert tqm.fma_launches == {tqm.FMA: 0}
    assert tqm.quant_matvec_int8(x.to(torch.bfloat16), w, s).shape == (2, 32)
