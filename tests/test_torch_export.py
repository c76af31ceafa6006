"""The port's registered kernel operators and its `torch.export` artifacts
(`hsenet_torch.ops.library`, `hsenet_torch.utils.export`) on the CPU at toy
size.

`hsenet_torch::flash_fwd` (B1) and `hsenet_torch::quant_matvec` (B5) pass
`torch.library.opcheck`. The greedy-decode artifact (the prefill and one
decode step, f32 and int8 weights) gives the tokens of the port's live
generate and of the JAX package's `make_greedy_generate_llm_only` on the
same bridged weights, with an EOS that fires; its export does not grow with
`max_new_tokens`. The encode artifact gives the JAX package's
`encode_images_only` to 1e-5. No artifact holds a weight, and a fresh
process loads and runs them without importing `hsenet_torch.models`.
"""

import dataclasses
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hsenet_tpu.eval.generate import make_greedy_generate_llm_only as jax_generate
from hsenet_tpu.models import lora as jlora
from hsenet_tpu.models.mllm import HSENetVLM as JaxVLM
from hsenet_tpu.models.phi3 import Phi3ForCausalLM as JaxLM
from hsenet_torch.bridge import flax_to_torch
from hsenet_torch.eval.generate import make_greedy_generate_llm_only
from hsenet_torch.models.mllm import HSENetVLM
from hsenet_torch.models.phi3 import Phi3ForCausalLM
from hsenet_torch.ops import flash_attention as tfa
from hsenet_torch.ops import quant_matvec as tqm
from hsenet_torch.utils import export as tex
from test_torch_common import (
    PORT_DIR,
    TINY_LLM,
    TINY_VLM,
    fill_zero_inits,
    load_flax,
    to_torch_config,
)

torch.set_num_threads(1)

LLM = dataclasses.replace(TINY_LLM, vocab_size=96, lora=None)
LLM_INT8 = dataclasses.replace(LLM, quant_int8=True, quant_int8_embed=True)
PROMPT = 70  # at least 64 tokens: the prefill runs the flash op
KV_LENS = (70, 61)
MAX_NEW = 6
PAD = 0
ENCODE_TOL = dict(rtol=1e-5, atol=1e-5)


def _flash_args(causal, with_lse, d=64, seed=0):
    g = torch.Generator().manual_seed(seed)
    q, k, v = (torch.randn((2, 3, s, d), generator=g) for s in (24, 40, 40))
    kv = torch.tensor([40, 17], dtype=torch.int32)
    q_off = torch.tensor([0, 5] if causal else [0, 0], dtype=torch.int32)
    return (q, k, v, kv, q_off, causal, d ** -0.5, with_lse)


def _matvec_args(m, dtype, k=48, n=40):
    g = torch.Generator().manual_seed(m)
    x = torch.randn((m, k), generator=g).to(dtype)
    w_q = torch.randint(-127, 128, (n, k), generator=g, dtype=torch.int8)
    return (x, w_q, torch.rand(n, generator=g) / 100)


OPCHECK = {
    "flash_ragged_lse": (tfa.flash_fwd_op, _flash_args(False, True)),
    "flash_causal_offsets": (tfa.flash_fwd_op, _flash_args(True, False)),
    "flash_causal_offsets_lse": (tfa.flash_fwd_op, _flash_args(True, True, 128)),
    "matvec_m1_f32": (tqm.quant_matvec_op, _matvec_args(1, torch.float32)),
    "matvec_m8_bf16": (tqm.quant_matvec_op, _matvec_args(8, torch.bfloat16)),
}


@pytest.mark.parametrize("case", list(OPCHECK))
def test_ops_pass_opcheck(case):
    op, args = OPCHECK[case]
    torch.library.opcheck(op, args)
    if op is tfa.flash_fwd_op:  # the plain version, in the kernel's layout
        out, lse = op(*args)
        want = tfa.flash_attention_reference(
            *args[:3], kv_lens=args[3], q_offset=args[4], causal=args[5],
            sm_scale=args[6], with_lse=args[7])
        torch.testing.assert_close(out, want[0] if args[7] else want)
        assert out.permute(0, 2, 1, 3).is_contiguous()
        assert lse.shape == (out.shape[:3] if args[7] else (0,))


def _llm(cfg, seed):
    """A JAX Phi3 and the port's, on bridged weights (int8 ones quantised by
    the JAX converters)."""
    float_cfg = dataclasses.replace(cfg, quant_int8=False, quant_int8_embed=False)
    jm = JaxLM(cfg, dtype=jnp.float32)
    params = fill_zero_inits(jax.jit(JaxLM(float_cfg, dtype=jnp.float32).init)(
        jax.random.PRNGKey(seed), jnp.zeros((1, 8), jnp.int32)), seed)
    if cfg.quant_int8:
        params = {"params": jlora.quantize_embed_int8(
            jlora.quantize_kernels_int8(jax.device_get(params["params"])))}
    tm = load_flax(Phi3ForCausalLM(to_torch_config(cfg), dtype=torch.float32,
                                   device="cpu"), params)
    return jm, params, tm


@pytest.fixture(scope="module")
def prompts():
    rng = np.random.default_rng(0)
    ids = rng.integers(3, LLM.vocab_size, (len(KV_LENS), PROMPT))
    for row, n in enumerate(KV_LENS):
        ids[row, n:] = PAD
    return ids.astype(np.int32), np.asarray(KV_LENS, np.int32)


def _live(tm, ids, kv, eos, max_new=MAX_NEW):
    return make_greedy_generate_llm_only(
        tm, max_new_tokens=max_new, eos_token_id=eos, pad_token_id=PAD,
        cache_dtype=torch.float32)(torch.as_tensor(ids), torch.as_tensor(kv))


@pytest.fixture(scope="module")
def decoders(prompts):
    """Per weight kind: the models, an EOS that row 0 emits by its third
    token, and the greedy-decode artifact exported at MAX_NEW."""
    ids, kv = prompts
    out = {}
    for kind, cfg in (("f32", LLM), ("int8", LLM_INT8)):
        jm, params, tm = _llm(cfg, seed=len(out))
        eos = int(_live(tm, ids, kv, -1)[0, 2])
        blob = tex.export_greedy_decode(
            tm, tm.state_dict(), max_new_tokens=MAX_NEW, prompt_len=PROMPT,
            batch=len(KV_LENS), eos_token_id=eos, pad_token_id=PAD,
            cache_dtype=torch.float32)
        served = tex.load_exported(blob)
        tokens = served(tm.state_dict(), torch.as_tensor(ids), torch.as_tensor(kv))
        out[kind] = dict(jm=jm, params=params, tm=tm, eos=eos, blob=blob,
                         served=served, tokens=tokens)
    return out


def _no_state(exported):
    """Nothing lifted into any program but a few scalar constants."""
    for name, held in exported.lifted().items():
        assert all(n >= 0 for n in held.values()), (name, held)
        assert sum(held.values()) <= 4, (name, held)


@pytest.mark.parametrize("kind", ["f32", "int8"])
def test_greedy_decode_artifact(decoders, prompts, kind):
    d = decoders[kind]
    ids, kv = prompts
    nodes = d["served"].op_nodes()
    assert nodes["prefill"] == {"hsenet_torch.flash_fwd.default": LLM.num_layers}
    # the decode step's 7 projections a layer take B5 at 2 rows
    want_step = ({"hsenet_torch.quant_matvec.default": 7 * LLM.num_layers}
                 if kind == "int8" else {})
    assert nodes["step"] == want_step
    _no_state(d["served"])
    served = d["tokens"]
    live = _live(d["tm"], ids, kv, d["eos"])
    want = np.asarray(jax_generate(
        d["jm"], max_new_tokens=MAX_NEW, eos_token_id=d["eos"],
        pad_token_id=PAD, cache_dtype=jnp.float32,
    )(d["params"], jnp.asarray(ids), jnp.asarray(kv)))
    assert served.dtype == torch.int32 and served.shape == (len(KV_LENS), MAX_NEW)
    np.testing.assert_array_equal(served.numpy(), live.numpy())
    np.testing.assert_array_equal(served.numpy(), want)
    # the EOS fired: row 0 pads after it (by its third token)
    first = served[0].tolist().index(d["eos"])
    assert first <= 2 and (served[0, first + 1:] == PAD).all()


def test_decode_export_does_not_grow_with_new_tokens(decoders):
    """The decode loop runs on the loading side: a budget four times
    larger exports the same two programs, node for node."""
    d = decoders["f32"]
    longer = tex.load_exported(tex.export_greedy_decode(
        d["tm"], d["tm"].state_dict(), max_new_tokens=4 * MAX_NEW,
        prompt_len=PROMPT, batch=len(KV_LENS), eos_token_id=d["eos"],
        pad_token_id=PAD, cache_dtype=torch.float32))

    def nodes(exported):
        return {name: [str(n.target) for n in ep.graph.nodes]
                for name, ep in exported.programs.items()}

    assert nodes(longer) == nodes(d["served"])
    assert longer.convention["max_new_tokens"] == 4 * MAX_NEW


@pytest.fixture(scope="module")
def encoder():
    rng = np.random.default_rng(1)
    v = TINY_VLM.vision
    vol = rng.standard_normal((2, 1, *v.image_size)).astype(np.float32)
    sf = rng.standard_normal((2, v.num_slices, v.slice_feature_dim)).astype(np.float32)
    jm = JaxVLM(TINY_VLM, dtype=jnp.float32)

    def encode(p, volume, slices):
        return jm.apply(p, volume, slices, method=jm.encode_images_only)

    # the towers' and packers' weights (the LLM's stay the port's own draw)
    params = fill_zero_inits(jax.jit(lambda k, a, b: jm.init(
        k, a, b, method=jm.encode_images_only))(
        jax.random.PRNGKey(2), jnp.asarray(vol[:1]), jnp.asarray(sf[:1])), 2)
    tm = HSENetVLM(to_torch_config(TINY_VLM), dtype=torch.float32, device="cpu")
    missing, unexpected = tm.load_state_dict(
        flax_to_torch(jax.tree.map(np.asarray, params)), strict=False)
    assert not unexpected and all(k.startswith("llm.") for k in missing)
    tm.eval()
    blob = tex.export_encode(tm, tm.state_dict(), batch=2)
    served = tex.load_exported(blob)
    want = np.asarray(jax.jit(encode)(params, jnp.asarray(vol), jnp.asarray(sf)))
    return dict(tm=tm, blob=blob, vol=vol, sf=sf, want=want, served=served,
                feats=served(tm.state_dict(), torch.as_tensor(vol),
                             torch.as_tensor(sf)))


def test_encode_artifact_matches_jax(encoder):
    e = encoder
    # two towers of one block each, the flash op once a block
    assert e["served"].op_nodes()["fn"] == {"hsenet_torch.flash_fwd.default": 2}
    _no_state(e["served"])
    got = e["feats"]
    assert got.shape == e["want"].shape
    np.testing.assert_allclose(got.numpy(), e["want"], **ENCODE_TOL)


def test_export_refuses_a_weight_left_out(encoder):
    """A weight missing from the dict would be traced in as a constant: the
    export raises instead."""
    tm = encoder["tm"]
    state = dict(tm.state_dict())
    del state["mm_projector.proj_fc1.weight"]
    with pytest.raises(ValueError, match="holds state"):
        tex.export_encode(tm, state, batch=2)


CHILD = """
import sys, torch
from hsenet_torch.utils import export as tex
root = sys.argv[1]
inputs = torch.load(root + "/inputs.pt", weights_only=True)
out = {}
for name, args in inputs.items():
    out[name] = tex.load_exported_file(root + "/" + name + ".pt2")(*args)
assert "hsenet_torch.models" not in sys.modules, sorted(sys.modules)
torch.save(out, root + "/out.pt")
"""


def test_artifacts_load_without_the_models(decoders, encoder, prompts, tmp_path):
    """A fresh process with only torch, the operators and the loader runs
    both artifacts and gets the in-process results."""
    ids, kv = prompts
    d, e = decoders["int8"], encoder
    inputs = {
        "decode": (d["tm"].state_dict(), torch.as_tensor(ids), torch.as_tensor(kv)),
        "encode": (e["tm"].state_dict(), torch.as_tensor(e["vol"]),
                   torch.as_tensor(e["sf"])),
    }
    tex.save_exported(str(tmp_path / "decode.pt2"), d["blob"])
    tex.save_exported(str(tmp_path / "encode.pt2"), e["blob"])
    torch.save(inputs, tmp_path / "inputs.pt")
    proc = subprocess.run([sys.executable, "-c", CHILD, str(tmp_path)],
                          cwd=PORT_DIR.parent, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    got = torch.load(tmp_path / "out.pt", weights_only=True)
    torch.testing.assert_close(got["decode"], d["tokens"], rtol=0, atol=0)
    torch.testing.assert_close(got["encode"], e["feats"], rtol=0, atol=0)
