"""The port's int8 weight-only pieces against the JAX package's, on the CPU.

`quant_matvec_int8_reference` (the plain version of the Hopper kernel, and
what the dispatcher runs on a CPU tensor) against the JAX
`quant_matvec_int8`: its Pallas kernel in interpret mode for M <= 8 rows and
its XLA expression above that. The converters (`quantize_kernels_int8`,
`quantize_embed_int8`, `quantize_kv`, `merge_lora`) against the JAX
package's on the same float weights; `LoRADense(quantized=True)` and
`QuantEmbed` on bridged int8 trees.

Tolerances: f32 outputs 1e-5 absolute and relative (the two sides sum over
K in another order); int8 codes equal; scales 1e-7 relative (the same IEEE
divisions); bf16 outputs of the kernel's function within one bf16 unit of
the JAX kernel's, 2^-7 relative (both scale the f32 sum and round once).
The layer's expression rounds three times instead (the product, the scale
and their product, half a unit each), so where the two meet they may lie
1.5 units apart: 2^-6 relative.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import hsenet_tpu.models.lora as jlora
import hsenet_tpu.models.phi3 as jphi3
import hsenet_tpu.ops.quant_matvec as jqm
from hsenet_torch.bridge import flax_to_torch
from hsenet_torch.models import lora as tlora
from hsenet_torch.models import phi3 as tphi3
from hsenet_torch.ops import quant_matvec as tqm
from test_torch_common import to_np

torch.set_num_threads(1)

TOL = dict(atol=1e-5, rtol=1e-5)
BF16_TOL = dict(atol=2.0 ** -7, rtol=2.0 ** -7)
BF16_MEET_TOL = dict(atol=2.0 ** -6, rtol=2.0 ** -6)
K, N = 64, 256  # N tiles by the JAX kernel's block rule, K by the port's


def _problem(seed, m, k=K, n=N):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((m, k)).astype(np.float32)
    wq = rng.integers(-127, 128, (k, n)).astype(np.int8)  # JAX layout (K, N)
    scale = rng.uniform(0.001, 0.02, n).astype(np.float32)
    return x, wq, scale


@pytest.mark.parametrize("m", [1, 4, 8, 16])
def test_reference_matches_jax_matvec(m):
    """M <= 8 goes through the JAX Pallas kernel (interpret mode), M = 16
    through its XLA expression; the port's dispatcher follows the same row
    rule."""
    x, wq, scale = _problem(m, m)
    want = np.asarray(jqm.quant_matvec_int8(
        jnp.asarray(x), jnp.asarray(wq), jnp.asarray(scale)))
    args = (torch.as_tensor(x), torch.as_tensor(wq.T.copy()),
            torch.as_tensor(scale))
    np.testing.assert_allclose(
        to_np(tqm.quant_matvec_int8_reference(*args)), want, **TOL)
    np.testing.assert_allclose(to_np(tqm.quant_matvec_int8(*args)), want, **TOL)
    assert tqm.in_kernel_rule(args[0], args[1]) == (m <= 8)


@pytest.mark.parametrize("m", [1, 8])
def test_reference_bf16_within_one_rounding(m):
    x, wq, scale = _problem(10 + m, m)
    xb = jnp.asarray(x, jnp.bfloat16)
    want = np.asarray(jqm.quant_matvec_int8(
        xb, jnp.asarray(wq), jnp.asarray(scale)).astype(jnp.float32))
    tx = torch.as_tensor(x).to(torch.bfloat16)
    tw, ts = torch.as_tensor(wq.T.copy()), torch.as_tensor(scale)
    got = tqm.quant_matvec_int8_reference(tx, tw, ts)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(to_np(got), want, **BF16_TOL)
    # where the kernel's function and the layer's expression meet (the
    # 8-row boundary of LoRADense): three roundings against one
    np.testing.assert_allclose(
        to_np(tqm.plain_expression(tx, tw, ts)), to_np(got), **BF16_MEET_TOL)


def test_dispatch_rule():
    x, wq, scale = _problem(3, 4)
    tw, ts = torch.as_tensor(wq.T.copy()), torch.as_tensor(scale)
    tx = torch.as_tensor(x)
    assert tqm.in_kernel_rule(tx, tw)
    assert tqm.in_kernel_rule(tx.reshape(2, 2, K), tw)  # rows = 2 * 2
    assert not tqm.in_kernel_rule(torch.zeros(9, K), tw)
    assert not tqm.in_kernel_rule(torch.zeros(3, 3, K), tw)
    # K off the 16-code alignment takes the plain expression
    assert not tqm.in_kernel_rule(torch.zeros(2, 24), torch.zeros(8, 24, dtype=torch.int8))
    assert not tqm.in_kernel_rule(tx.double(), tw)
    # the kernel is forward-only: a gradient takes the plain expression
    xg = tx.clone().requires_grad_()
    assert not tqm.in_kernel_rule(xg, tw)
    y = tqm.quant_matvec_int8(xg, tw, ts)
    (g,) = torch.autograd.grad(y.sum(), xg)
    want = (tw.float() * ts[:, None]).sum(dim=0).expand_as(g)
    torch.testing.assert_close(g, want, rtol=1e-5, atol=1e-5)
    with torch.no_grad():
        assert tqm.in_kernel_rule(xg, tw)
    # leading dimensions come back
    assert tqm.quant_matvec_int8(tx.reshape(2, 2, K), tw, ts).shape == (2, 2, N)


def test_kernel_request_refuses_the_cpu():
    """A direct request for the kernel on a host without a card raises; it
    never gives the plain version instead."""
    x, wq, scale = _problem(4, 2)
    with pytest.raises(RuntimeError, match="CUDA"):
        tqm.quant_matvec_kernel(torch.as_tensor(x), torch.as_tensor(wq.T.copy()),
                                torch.as_tensor(scale))
    assert tqm.launches == {"quant_matvec": 0}


def _float_tree(seed=0):
    """A float flax tree shaped like a toy decoder: two scanned layers of
    projections with LoRA adapters, an embedding, a norm."""
    rng = np.random.default_rng(seed)

    def dense(i, o):
        return {"kernel": rng.standard_normal((2, i, o)).astype(np.float32) * 0.1,
                "lora_a": rng.standard_normal((2, i, 3)).astype(np.float32),
                "lora_b": rng.standard_normal((2, 3, o)).astype(np.float32) * 0.1}

    layers = {name: dense(16, 32) for name in ("q_proj", "gate_proj")}
    layers["down_proj"] = dense(32, 16)
    layers["input_norm"] = {"scale": np.ones((2, 16), np.float32)}
    # one all-zero output channel: its scale is floored at 1e-8
    layers["q_proj"]["kernel"][0, :, 5] = 0.0
    return {"params": {
        "embed": {"embedding": rng.standard_normal((40, 16)).astype(np.float32)},
        "decoder": {"layers": layers,
                    "norm": {"scale": np.ones(16, np.float32)}},
    }}


def _strip_lora(tree):
    if isinstance(tree, dict):
        return {k: _strip_lora(v) for k, v in tree.items()
                if k not in ("lora_a", "lora_b")}
    return tree


def test_quantize_kernels_codes_equal_jax():
    tree = _strip_lora(_float_tree())
    want = flax_to_torch(jlora.quantize_kernels_int8(tree))
    got = tlora.quantize_kernels_int8(flax_to_torch(tree))
    assert set(got) == set(want)
    n_codes = 0
    for name, value in want.items():
        assert got[name].dtype == value.dtype, name
        if value.dtype == torch.int8:
            n_codes += 1
            assert torch.equal(got[name], value), name
        else:
            np.testing.assert_allclose(to_np(got[name]), to_np(value),
                                       rtol=1e-7, atol=0, err_msg=name)
    assert n_codes == 6  # three projections x two layers
    assert got["decoder.layers.0.q_proj.weight_scale"][5] == pytest.approx(1e-8)
    assert got["decoder.layers.1.down_proj.weight_q"].shape == (16, 32)


def test_quantize_embed_codes_equal_jax():
    tree = _strip_lora(_float_tree(1))
    want = flax_to_torch(jlora.quantize_embed_int8(tree))
    got = tlora.quantize_embed_int8(flax_to_torch(tree))
    assert set(got) == set(want)
    assert torch.equal(got["embed.embedding_q"], want["embed.embedding_q"])
    assert got["embed.embedding_q"].dtype == torch.int8
    np.testing.assert_allclose(to_np(got["embed.scale"]),
                               to_np(want["embed.scale"]), rtol=1e-7, atol=0)
    torch.testing.assert_close(got["decoder.norm.weight"],
                               want["decoder.norm.weight"])


def test_merge_lora_matches_jax():
    tree = _float_tree(2)
    want = flax_to_torch(jax.tree.map(
        np.asarray, jlora.merge_lora(jax.tree.map(jnp.asarray, tree), 1.5)))
    got = tlora.merge_lora(flax_to_torch(tree), 1.5)
    assert set(got) == set(want) and not any("lora" in k for k in got)
    for name in want:
        np.testing.assert_allclose(to_np(got[name]), to_np(want[name]),
                                   atol=1e-6, rtol=1e-6, err_msg=name)
    # the default scale is alpha / r = 32 / 16
    two = tlora.merge_lora(flax_to_torch(tree))
    key = "decoder.layers.0.q_proj.weight"
    base = flax_to_torch(tree)[key]
    torch.testing.assert_close(two[key] - base, (got[key] - base) * (2.0 / 1.5),
                               atol=1e-5, rtol=1e-5)


def test_quantize_kv_codes_equal_jax():
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 3, 5, 16)).astype(np.float32)
    x[0, 0, 0] = 0.0  # an all-zero row: scale floored, codes 0
    jq, js = jphi3.quantize_kv(jnp.asarray(x))
    tq, ts = tphi3.quantize_kv(torch.as_tensor(x))
    assert tq.dtype == torch.int8 and ts.shape == (2, 3, 5)
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-7, atol=0)
    np.testing.assert_allclose(
        tphi3.dequantize_kv(tq, ts, torch.float32).numpy(),
        np.asarray(jphi3.dequantize_kv(jq, js, jnp.float32)), rtol=1e-7, atol=0)
    assert not tq[0, 0, 0].any()


@pytest.mark.parametrize("rows", [(1, 1), (2, 4), (2, 9)],
                         ids=["m1", "m8", "m18"])
@pytest.mark.parametrize("bias", [False, True], ids=["nobias", "bias"])
def test_quantized_lora_dense_matches_jax(rows, bias):
    """A bridged int8 layer, below and above the 8-row boundary, with LoRA
    adapters on top (the int8-base finetune's layer)."""
    from hsenet_tpu.configs import LoRAConfig as JLoRA
    from hsenet_torch.configs import LoRAConfig as TLoRA

    rng = np.random.default_rng(7)
    x = rng.standard_normal((*rows, 32)).astype(np.float32)
    jm = jlora.LoRADense(48, use_bias=bias, lora=JLoRA(rank=2, alpha=4, dropout_rate=0.0),
                         quantized=True, dtype=jnp.float32)
    params = jm.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"]
    params = {
        **params,
        "kernel_q": rng.integers(-127, 128, (32, 48)).astype(np.int8),
        "kernel_scale": rng.uniform(0.001, 0.02, 48).astype(np.float32),
        "lora_b": rng.standard_normal((2, 48)).astype(np.float32) * 0.1,
    }
    if bias:
        params["bias"] = rng.standard_normal(48).astype(np.float32)
    want = np.asarray(jm.apply({"params": params}, jnp.asarray(x)))
    tm = tlora.LoRADense(32, 48, use_bias=bias,
                         lora=TLoRA(rank=2, alpha=4, dropout_rate=0.0),
                         quantized=True, dtype=torch.float32, device="cpu")
    state = flax_to_torch(jax.tree.map(np.asarray, params))
    tm.load_state_dict(state, strict=True)
    assert tm.weight_q.dtype == torch.int8 and tm.weight_q.shape == (48, 32)
    assert tm.weight_scale.dtype == torch.float32 and tm.weight is None
    assert set(dict(tm.named_buffers())) == {"weight_q", "weight_scale"}
    with torch.no_grad():
        got = tm(torch.as_tensor(x))
    np.testing.assert_allclose(to_np(got), want, **TOL)


def test_quant_embed_matches_jax():
    rng = np.random.default_rng(8)
    table = rng.standard_normal((40, 16)).astype(np.float32)
    tree = jlora.quantize_embed_int8({"embed": {"embedding": table}})
    jm = jlora.QuantEmbed(40, 16, dtype=jnp.float32)
    ids = rng.integers(0, 40, (2, 5))
    hidden = rng.standard_normal((2, 5, 16)).astype(np.float32)
    variables = {"params": tree["embed"]}
    tm = tlora.QuantEmbed(40, 16, dtype=torch.float32, device="cpu")
    tm.load_state_dict(flax_to_torch(tree["embed"]), strict=True)
    assert tm.embedding_q.dtype == torch.int8 and tm.scale.dtype == torch.float32
    np.testing.assert_allclose(
        to_np(tm(torch.as_tensor(ids))),
        np.asarray(jm.apply(variables, jnp.asarray(ids))), **TOL)
    np.testing.assert_allclose(
        to_np(tm.attend(torch.as_tensor(hidden))),
        np.asarray(jm.apply(variables, jnp.asarray(hidden),
                            method=jlora.QuantEmbed.attend)), **TOL)
    # the lookup dequantises a row to within half a step of the float row
    assert np.abs(to_np(tm(torch.arange(40))) - table).max() <= \
        np.abs(table).max() / 127 * 0.51
