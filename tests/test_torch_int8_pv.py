"""The port's plain P.V probe product (`hsenet_torch.ops.int8_pv`) against
the JAX package's probe kernel `make_kernel(mode)` of
scripts/_probe_pallas_int8.py, run through `pl.pallas_call(...,
interpret=True)` on the CPU at a small size, and the port's probe entry on
`device="cpu"`.

The probe script runs its benchmark when imported, so the test takes the
`make_kernel` definition out of its source with `ast` and executes it with
its own M, HQ and N. Integer modes must agree bit for bit (both sides sum
integer codes exactly); `bf16` sums the same exact bf16 products in f32 in
another order, so it must agree within BF16_ROW_TOL of each row's largest
|value|.
"""

import ast
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from hsenet_torch.ops import int8_pv as tpv
from hsenet_torch.scripts import probe_int8_pv

torch.set_num_threads(1)

PROBE = Path(__file__).resolve().parent.parent / "scripts" / "_probe_pallas_int8.py"
G, M, HQ, K, N = 2, 64, 16, 128, 16
BF16_ROW_TOL = 1e-6


def _jax_probe_kernel(mode):
    tree = ast.parse(PROBE.read_text())
    fn = next(node for node in tree.body
              if isinstance(node, ast.FunctionDef) and node.name == "make_kernel")
    scope = {"jax": jax, "jnp": jnp, "pl": pl, "M": M, "HQ": HQ, "N": N}
    exec(compile(ast.Module(body=[fn], type_ignores=[]), str(PROBE), "exec"), scope)
    return scope["make_kernel"](mode)


def _jax_probe(mode, p, v):
    call = pl.pallas_call(
        _jax_probe_kernel(mode),
        grid=(G,),
        in_specs=[pl.BlockSpec((1, M, K), lambda b: (b, 0, 0)),
                  pl.BlockSpec((1, K, N), lambda b: (b, 0, 0))],
        out_specs=pl.BlockSpec((1, M, N), lambda b: (b, 0, 0)),
        out_shape=jax.ShapeDtypeStruct((G, M, N), jnp.float32),
        interpret=True,
    )
    return np.asarray(call(p, v))


def _inputs(mode, seed):
    """The JAX probe's distributions, from numpy."""
    rng = np.random.default_rng(seed)
    p_int = mode == "int8_pre"
    v_int = mode != "bf16"
    p = rng.integers(0, 127, (G, M, K)) if p_int else rng.random((G, M, K))
    v = rng.integers(-127, 127, (G, K, N)) if v_int else rng.normal(size=(G, K, N))
    p_np = p.astype(np.int8) if p_int else p.astype(np.float32)
    v_np = v.astype(np.int8) if v_int else v.astype(np.float32)
    jdt = {"bf16": (jnp.bfloat16, jnp.bfloat16), "int8_pre": (jnp.int8, jnp.int8),
           "quant_then_int8": (jnp.float32, jnp.int8),
           "glue_only": (jnp.float32, jnp.int8)}[mode]
    jp, jv = jnp.asarray(p_np, jdt[0]), jnp.asarray(v_np, jdt[1])
    tdt = tpv.DTYPES[mode]
    tp = torch.as_tensor(p_np).to(tdt[0])
    tv = torch.as_tensor(v_np).to(tdt[1])
    return (jp, jv), (tp, tv)


@pytest.mark.parametrize("mode", tpv.MODES)
def test_plain_version_matches_the_jax_probe_kernel(mode):
    (jp, jv), (tp, tv) = _inputs(mode, seed=tpv.MODES.index(mode))
    want = _jax_probe(mode, jp, jv)
    got = tpv.int8_pv(tp, tv, mode)  # CPU tensors: the plain version
    width = tpv.HEAD_DIM if mode == "glue_only" else N
    assert got.shape == (G, M, width) and got.dtype == torch.float32
    if mode == "bf16":
        err = np.abs(got.numpy() - want)
        scale = np.abs(want).max(axis=-1, keepdims=True)
        assert (err <= BF16_ROW_TOL * scale).all(), (err / scale).max()
    elif mode == "glue_only":
        # each row's sum, broadcast to the port's 64 columns (the JAX
        # probe broadcasts to its own N)
        assert np.array_equal(got.numpy()[..., :N], want)
        assert bool((got == got[..., :1]).all())
    else:
        assert np.array_equal(got.numpy(), want)


def test_integer_sums_are_exact_past_float32():
    """Sums of 2176 products of 127 x 127 reach 3.5e7 > 2^24: they must be
    taken exactly and converted once, not summed in f32."""
    g, m, k = 1, 2, 2176
    p = torch.full((g, m, k), 127, dtype=torch.int8)
    p[0, 1, ::2] = -127
    v = torch.full((g, k, tpv.HEAD_DIM), 127, dtype=torch.int8)
    v[0, 7, 0] = 126
    got = tpv.int8_pv_reference(p, v, "int8_pre")
    want = (p.long() @ v.long()).double().float()
    assert torch.equal(got, want) and got[0, 0, 0] == float(2176 * 127 * 127 - 127)


def test_quantisation_rounds_half_to_even_and_saturates():
    p = torch.tensor([[[0.5 / 127, 1.5 / 127, 2.5 / 127, 1.0, 1.1, -2.0, 0.0, 0.25]]])
    codes = tpv.quantize_p(p)
    assert codes.tolist() == [[[0, 2, 2, 127, 127, -128, 0, 32]]]
    glue = tpv.int8_pv_reference(p, None, "glue_only")
    assert glue.shape == (1, 1, tpv.HEAD_DIM) and bool((glue == 162.0).all())


def test_kernel_request_refuses_the_cpu_and_bad_shapes():
    p = torch.zeros(1, 64, 64, dtype=torch.bfloat16)
    v = torch.zeros(1, 64, 64, dtype=torch.bfloat16)
    with pytest.raises(RuntimeError, match="CUDA"):
        tpv.int8_pv_kernel(p, v, "bf16")
    with pytest.raises(ValueError, match="mode"):
        tpv.int8_pv(p, v, "fp8")
    assert tpv.launches == {name: {mode: 0 for mode in tpv.MODES}
                            for name in (tpv.KERNEL, tpv.YARDSTICK)}


def _operands(mode, m, k):
    p_dtype, v_dtype = tpv.DTYPES[mode]
    return (torch.zeros(2, m, k, dtype=p_dtype),
            torch.zeros(2, k, tpv.HEAD_DIM, dtype=v_dtype))


@pytest.mark.parametrize("mode", tpv.MODES)
def test_wgmma_kernel_refuses_the_cpu(mode):
    """int8_pv_wgmma launches on CUDA tensors only: the probe's shapes on
    the CPU raise, and nothing is counted."""
    p, v = _operands(mode, 64, 128)
    with pytest.raises(RuntimeError, match="CUDA"):
        tpv.int8_pv_wgmma_kernel(p, v, mode)
    assert sum(tpv.launches[tpv.KERNEL].values()) == 0


@pytest.mark.parametrize("mode", tpv.MODES)
def test_wgmma_kernel_refuses_k_off_its_tile(mode):
    """K must be a multiple of 64 in every mode (P's rows start on 16-byte
    boundaries for TMA; the tiles past K are zero-filled)."""
    p, v = _operands(mode, 64, 96)
    with pytest.raises(ValueError, match="multiple of 64"):
        tpv.int8_pv_wgmma_kernel(p, v, mode)


@pytest.mark.parametrize("mode", tpv.MODES)
def test_wgmma_kernel_takes_m_off_its_row_tile(mode):
    """M needs no padding: rows past M arrive as zeros and are not stored.
    An M that is not a multiple of the CTA's rows passes every shape check
    and is refused only for its device."""
    m = 1000
    assert m % tpv.row_tile(mode) != 0
    assert tpv.row_tile(mode) == (128 if mode in ("quant_then_int8", "glue_only")
                                  else 192)
    p, v = _operands(mode, m, 128)
    with pytest.raises(RuntimeError, match="CUDA"):
        tpv.int8_pv_wgmma_kernel(p, v, mode)


def test_probe_entry_on_the_cpu(capsys):
    shapes = (2, 32, 128, tpv.HEAD_DIM)
    results = probe_int8_pv.main(["int8_pre", "glue_only"], device="cpu",
                                 shapes=shapes)
    lines = capsys.readouterr().out.strip().splitlines()
    assert json.loads(lines[-1]) == results
    assert set(results) == {"int8_pre", "glue_only"}
    for r in results.values():
        assert r["ms"] is None and r["tflops"] is None and r["shape"] == list(shapes)
    assert "not measured" in lines[0]
    with pytest.raises(ValueError, match="unknown mode"):
        probe_int8_pv.probe(["int4"], shapes, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            probe_int8_pv.main(["bf16"], shapes=shapes)
