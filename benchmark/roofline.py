"""The device's peaks, the least time a flash-attention launch can take on
it, and the kinds of device kernels.

`attention_pairs` and `kernel_bound` are frozen copies of `chip_smoke.py`'s
functions of the same names: the benchmark holds the attention kernels to
this bound whatever kernel a later change launches.
"""

from __future__ import annotations

# NVIDIA H100 SXM, dense rates without sparsity (NVIDIA's data sheet), at
# the card's 700 W power limit
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES_PER_S = 3.35e12

# substrings of the library's matrix-product kernel names (cuBLAS, cuBLASLt,
# CUTLASS); compared in lower case
GEMM_MARKERS = ("gemm", "cutlass", "nvjet", "xmma", "cublas")


def is_gemm(kernel_name: str) -> bool:
    """Whether a device kernel is one of the library's matrix products."""
    name = kernel_name.lower()
    return any(m in name for m in GEMM_MARKERS)


def attention_pairs(sq, skv, kv_lens, q_off, causal):
    """(valid (row, column) pairs summed over the batch, K/V rows that some
    row of each batch row needs, summed over the batch)."""
    pairs = kv_rows = 0
    for kv, off in zip(kv_lens, q_off):
        valid = [max(min(kv, skv, r + off + 1) if causal else min(kv, skv), 0)
                 for r in range(sq)]
        pairs += sum(valid)
        kv_rows += max(valid)
    return pairs, kv_rows


def kernel_bound(kind, b, h, sq, skv, d, kv_lens, q_off, causal, elem=2,
                 peak=PEAK_BF16_FLOPS):
    """(bound_ms, bound_by, flops, bytes) of one launch of `kind`: each
    input read once and each output written once in `elem`-byte elements
    (K and V only up to the last column some row needs; log-sum-exp and
    delta in f32), and 2 d operations per product per valid (row, column)
    pair at `peak`: 2 products (S, PV) for flash_fwd, 5 (S, dP, dV, dK, dQ)
    for flash_bwd, 3 (S, dP, dQ) for flash_bwd_dq and 4 (S, dP, dV, dK) for
    flash_bwd_dkv."""
    pairs, kv_rows = attention_pairs(sq, skv, kv_lens, q_off, causal)
    q_bytes = elem * b * h * sq * d  # one (B, H, Sq, D) tensor
    kv_bytes = 2 * elem * h * kv_rows * d  # K and V below the valid edge
    dkv_bytes = 2 * elem * b * h * skv * d  # dK and dV
    rows = 4 * b * h * sq  # one f32 value per query row
    products, nbytes = {
        "flash_fwd": (2, 2 * q_bytes + kv_bytes),
        "flash_fwd_lse": (2, 2 * q_bytes + kv_bytes + rows),
        "flash_bwd": (5, 3 * q_bytes + kv_bytes + 2 * rows + dkv_bytes),
        "flash_bwd_dq": (3, 3 * q_bytes + kv_bytes + 2 * rows),
        "flash_bwd_dkv": (4, 2 * q_bytes + kv_bytes + 2 * rows + dkv_bytes),
    }[kind]
    flops = products * 2 * d * h * pairs
    nbytes += 8 * b  # kv_lens and q_offset
    t_ops = flops / peak * 1e3
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    if t_ops >= t_bytes:
        return t_ops, "operations", flops, nbytes
    return t_bytes, "bytes", flops, nbytes


def calls_bound_ms(calls) -> float:
    """The summed bound of attention launches, each a (count, kind, b, h,
    sq, skv, d, kv_lens, q_off, causal) tuple."""
    total = 0.0
    for count, *launch in calls:
        total += count * kernel_bound(*launch)[0]
    return total
