"""The frozen kernel bound against two rows of PERF.md's kernel table."""

import pytest

from benchmark.roofline import attention_pairs, calls_bound_ms, is_gemm, kernel_bound


def test_clip_tower_bound_is_the_table_row():
    ms, by, _, _ = kernel_bound("flash_fwd_lse", 24, 12, 2049, 2049, 64,
                                [2049] * 24, [0] * 24, False)
    assert by == "operations"
    assert ms == pytest.approx(0.3130, abs=5e-5)


def test_train_bound_is_the_table_row():
    ms, by, _, _ = kernel_bound("flash_fwd_lse", 3, 24, 800, 800, 128,
                                [800, 700, 560], [0] * 3, True)
    assert by == "bytes"
    assert ms == pytest.approx(0.0164, abs=5e-5)


def test_causal_pairs_count_the_triangle_up_to_each_length():
    pairs, kv_rows = attention_pairs(4, 4, [4, 2], [0, 0], True)
    assert pairs == (1 + 2 + 3 + 4) + (1 + 2 + 2 + 2)
    assert kv_rows == 4 + 2


def test_calls_bound_sums_counted_launches():
    one = ("flash_bwd", 2, 4, 64, 64, 64, [64, 40], [0, 0], False)
    assert calls_bound_ms([(3, *one)]) == pytest.approx(3 * kernel_bound(*one)[0])


@pytest.mark.parametrize("name,gemm", [
    ("nvjet_tst_256x128_64x4_1x2_h_bz_coopA_NNT", True),
    ("sm90_xmma_gemm_bf16bf16_bf16f32", True),
    ("void cutlass::Kernel2<cutlass_80_wmma>", True),
    ("void at::native::vectorized_elementwise_kernel<8, add>", False),
    ("void (anonymous namespace)::flash_bwd_kernel<__nv_bfloat16, 64, 1>", False),
])
def test_gemm_kernels_are_told_by_name(name, gemm):
    assert is_gemm(name) is gemm
