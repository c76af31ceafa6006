"""The port's reverse converters (`hsenet_torch.utils.export_hf`) and its
`export_checkpoint` CLI on the CPU at toy size.

Each exporter runs on the bridged state of a JAX package model and must
give the JAX exporter's arrays: bit for bit where it renames, transposes
and dequantises, and to 1e-6 where it merges LoRA adapters (a product that
numpy and torch may sum in another order). The exports then go back through
the port's own converters: a plain export reconverts to the state it came
from, and a merged-LoRA or dequantised-int8 export gives the logits of the
model it came from.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hsenet_tpu.configs import LlamaConfig as JaxLlamaConfig
from hsenet_tpu.configs import LoRAConfig as JaxLoRAConfig
from hsenet_tpu.configs import PackerConfig as JaxPackerConfig
from hsenet_tpu.configs import Phi3Config as JaxPhi3Config
from hsenet_tpu.configs import ViT3DConfig as JaxViTConfig
from hsenet_tpu.models import lora as jlora
from hsenet_tpu.models.llama import LlamaForCausalLM as JaxLlama
from hsenet_tpu.models.mllm import HSENetVLM as JaxVLM
from hsenet_tpu.models.phi3 import Phi3ForCausalLM as JaxLM
from hsenet_tpu.models.projector import VisualPacker as JaxPacker
from hsenet_tpu.models.vit import ViT3D as JaxViT
from hsenet_tpu.utils import export_hf as jexport
from hsenet_torch.bridge import flax_to_torch
from hsenet_torch.cli import export_checkpoint
from hsenet_torch.models.llama import convert_hf_llama
from hsenet_torch.models.phi3 import Phi3ForCausalLM, convert_hf_phi3
from hsenet_torch.utils import export_hf as texport
from hsenet_torch.utils.checkpoint import filter_tree, save_params
from hsenet_torch.utils.convert import convert_reference_packer, convert_reference_vit
from test_torch_common import TINY_VLM, to_torch_config

torch.set_num_threads(1)

TINY = JaxPhi3Config(
    vocab_size=64, hidden_size=32, intermediate_size=48, num_layers=2,
    num_heads=4, num_kv_heads=2, head_dim=8, tie_word_embeddings=False,
)
TINY_LORA = dataclasses.replace(
    TINY, lora=JaxLoRAConfig(rank=2, alpha=4, dropout_rate=0.0))
TINY_INT8 = dataclasses.replace(TINY, quant_int8=True, quant_int8_embed=True)
TINY_LLAMA = JaxLlamaConfig(
    vocab_size=64, hidden_size=32, intermediate_size=48, num_layers=2,
    num_heads=4, num_kv_heads=2, head_dim=8, tie_word_embeddings=False,
)
VIT = JaxViTConfig(
    image_size=(4, 16, 16), patch_size=(2, 8, 8), hidden_size=16, mlp_dim=32,
    num_layers=2, num_heads=2, num_slices=2, slice_feature_dim=16,
    slice_guided=True,
)
PACKER = JaxPackerConfig(grid=(4, 4, 4), kernel=(1, 2, 2), in_dim=16,
                         out_dim=32, dropout_rate=0.0)
VLM = dataclasses.replace(TINY_VLM, llm=TINY_LORA)
MERGE_TOL = dict(rtol=1e-6, atol=1e-6)  # LoRA merged by numpy and by torch


def _random(variables, seed, scale=0.05):
    """Every leaf drawn anew (normal, `scale`), as f32 numpy arrays."""
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda x: np.asarray(rng.standard_normal(np.shape(x)) * scale,
                             np.float32), jax.device_get(variables))


def _state(params):
    return flax_to_torch(params)


@pytest.fixture(scope="module")
def trees():
    """JAX parameter trees of every exported model, drawn from seeds."""
    ids = jnp.zeros((1, 8), jnp.int32)
    key = jax.random.PRNGKey(0)
    phi3 = _random(JaxLM(TINY, dtype=jnp.float32).init(key, ids), 0)
    lora = _random(JaxLM(TINY_LORA, dtype=jnp.float32).init(key, ids), 1)
    int8 = {"params": jlora.quantize_embed_int8(
        jlora.quantize_kernels_int8(phi3["params"]))}
    llama = _random(JaxLlama(TINY_LLAMA, dtype=jnp.float32).init(key, ids), 2)
    vit = _random(JaxViT(VIT, dtype=jnp.float32).init(
        key, jnp.zeros((1, 1, 4, 16, 16)), jnp.zeros((1, 2, 16))), 3)
    packer = _random(JaxPacker(PACKER, dtype=jnp.float32).init(
        key, jnp.zeros((1, 64, 16))), 4)
    n = 1 + VLM.num_image_tokens + 4
    vlm = _random(jax.jit(JaxVLM(VLM, dtype=jnp.float32).init)(
        key, jnp.ones((1, n), jnp.int32), jnp.zeros((1, 1, 4, 16, 16)),
        jnp.zeros((1, 2, 16))), 5, scale=0.1)
    return dict(phi3=phi3, lora=lora, int8=int8, llama=llama, vit=vit,
                packer=packer, vlm=vlm)


# kind -> (tree, the JAX exporter's call, the port exporter's call)
EXPORTS = {
    "phi3": ("phi3", lambda p: jexport.export_hf_phi3(p, TINY),
             lambda s: texport.export_hf_phi3(s, to_torch_config(TINY))),
    "phi3_lora": ("lora", lambda p: jexport.export_hf_phi3(p, TINY_LORA),
                  lambda s: texport.export_hf_phi3(s, to_torch_config(TINY_LORA))),
    "phi3_int8": ("int8", lambda p: jexport.export_hf_phi3(p, TINY_INT8),
                  lambda s: texport.export_hf_phi3(s, to_torch_config(TINY_INT8))),
    "llama": ("llama", lambda p: jexport.export_hf_llama(p, TINY_LLAMA),
              lambda s: texport.export_hf_llama(s, to_torch_config(TINY_LLAMA))),
    "vit": ("vit", lambda p: jexport.export_reference_vit(p, "vision_encoder."),
            lambda s: texport.export_reference_vit(s, "vision_encoder.")),
    "vit_slice_guided": (
        "vit", lambda p: jexport.export_reference_vit(p, slice_guided=True),
        lambda s: texport.export_reference_vit(s, slice_guided=True)),
    "packer": ("packer", jexport.export_reference_packer,
               texport.export_reference_packer),
    "vlm_deltas": ("vlm", jexport.export_reference_vlm_deltas,
                   texport.export_reference_vlm_deltas),
}


@pytest.mark.parametrize("kind", list(EXPORTS))
def test_exports_match_jax(trees, kind):
    tree, jax_export, port_export = EXPORTS[kind]
    want = jax_export(trees[tree])
    got = port_export(_state(trees[tree]))
    assert sorted(got) == sorted(want)
    merged = kind in ("phi3_lora", "vlm_deltas")
    for name, value in want.items():
        assert got[name].dtype == np.float32, name
        if merged:
            np.testing.assert_allclose(got[name], value, err_msg=name, **MERGE_TOL)
        else:
            np.testing.assert_array_equal(got[name], value, err_msg=name)


def test_vlm_deltas_from_the_saved_subset(trees):
    """The `save_vlm_deltas` subset (projectors, LoRA, token table) exports
    what the whole VLM state exports."""
    state = _state(trees["vlm"])
    subset = filter_tree(state, r"(mm_projector|lora_[ab]|\.embed\.)")
    want = texport.export_reference_vlm_deltas(state)
    got = texport.export_reference_vlm_deltas(subset)
    assert sorted(got) == sorted(want)
    for name in want:
        np.testing.assert_array_equal(got[name], want[name], err_msg=name)


ROUND_TRIPS = {
    "phi3": ("phi3", lambda s: convert_hf_phi3(
        texport.export_hf_phi3(s, to_torch_config(TINY)), to_torch_config(TINY))),
    "llama": ("llama", lambda s: convert_hf_llama(
        texport.to_torch_state_dict(texport.export_hf_llama(
            s, to_torch_config(TINY_LLAMA))), to_torch_config(TINY_LLAMA))),
    "vit": ("vit", lambda s: convert_reference_vit(
        texport.export_reference_vit(s, "vision_encoder.", slice_guided=True),
        num_layers=2, prefix="vision_encoder.", slice_guided=True)),
    "packer": ("packer", lambda s: convert_reference_packer(
        texport.export_reference_packer(s))),
}


@pytest.mark.parametrize("kind", list(ROUND_TRIPS))
def test_export_reconverts_to_the_same_state(trees, kind):
    tree, round_trip = ROUND_TRIPS[kind]
    state = _state(trees[tree])
    back = round_trip(state)
    assert sorted(back) == sorted(state)
    for name, value in state.items():
        torch.testing.assert_close(back[name].float(), value.float(), rtol=0,
                                   atol=0, msg=name)


def _logits(cfg, state, ids):
    model = Phi3ForCausalLM(to_torch_config(cfg), dtype=torch.float32,
                            device="cpu")
    model.load_state_dict(state, strict=True)
    with torch.no_grad():
        return model.eval()(ids)[0]


@pytest.mark.parametrize("tree,cfg", [("lora", TINY_LORA), ("int8", TINY_INT8)],
                         ids=["lora_merged", "int8_dequantised"])
def test_export_keeps_the_logits(trees, tree, cfg):
    """A LoRA model exported with its adapters merged, or an int8 model
    dequantised, and converted back as a plain float model, gives the
    logits of the model it came from (at 8 rows the int8 projections take
    B5's plain version)."""
    ids = torch.as_tensor(np.random.default_rng(6).integers(0, 64, (2, 8)))
    state = _state(trees[tree])
    sd = texport.export_hf_phi3(state, to_torch_config(cfg))
    assert not any("lora" in k or "_q" in k for k in sd)
    back = convert_hf_phi3(sd, to_torch_config(TINY))
    torch.testing.assert_close(_logits(TINY, back, ids), _logits(cfg, state, ids),
                               rtol=0, atol=1e-4)


CLI_KINDS = {
    # the JAX CLI's config: Phi3Config(num_layers=32), LoRA scale 2.0
    "phi3": ("lora", [],
             lambda p: jexport.export_hf_phi3(p, JaxPhi3Config(num_layers=32))),
    "llama": ("llama", [], EXPORTS["llama"][1]),
    "vit": ("vit", ["--prefix", "vision_encoder.", "--slice-guided"],
            lambda p: jexport.export_reference_vit(p, "vision_encoder.", True)),
    "packer": ("packer", [], jexport.export_reference_packer),
    "vlm-deltas": ("vlm", [], jexport.export_reference_vlm_deltas),
}


@pytest.mark.parametrize("kind", list(CLI_KINDS))
def test_export_checkpoint_cli(trees, kind, tmp_path):
    """`export_checkpoint --kind K` on a `save_params` file writes the JAX
    exporter's arrays as a torch state dict (phi3 from a LoRA model, its
    adapters merged at the default Phi3Config's scale 2.0, as the JAX CLI
    merges them); an existing output is refused."""
    tree, extra, jax_export = CLI_KINDS[kind]
    src, out = tmp_path / "params.pt", tmp_path / "out.pt"
    save_params(str(src), _state(trees[tree]))
    argv = ["--kind", kind, "--input", str(src), "--output", str(out), *extra]
    export_checkpoint.main(argv, device="cpu")
    got = torch.load(out, weights_only=True)
    want = jax_export(trees[tree])
    assert sorted(got) == sorted(want)
    for name, value in want.items():
        np.testing.assert_allclose(got[name].numpy(), value, err_msg=name,
                                   **MERGE_TOL)
    with pytest.raises(FileExistsError):
        export_checkpoint.main(argv, device="cpu")
