"""Port-wide checks and the helpers the other `test_torch_*` files share.

The port (`hsenet_torch`) must import neither JAX nor the JAX package,
must refuse to run on a CUDA device that is not there, and must carry the
JAX package's configuration dataclasses with the same derived values.
"""

import dataclasses
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import hsenet_tpu.configs as jcfg
import hsenet_torch.configs as tcfg
from hsenet_torch.bridge import flax_to_torch
from hsenet_torch.models.mllm import HSENetVLM
from hsenet_torch.models.phi3 import KVCache, Phi3ForCausalLM
from hsenet_torch.models.vit import ViT3D

torch.set_num_threads(1)

PORT_DIR = Path(__file__).resolve().parent.parent / "hsenet_torch"

# toy sizes of tests/test_vlm.py, in the JAX package's config classes
TINY_VIT = jcfg.ViT3DConfig(
    image_size=(4, 16, 16), patch_size=(2, 8, 8), hidden_size=16, mlp_dim=32,
    num_layers=1, num_heads=2, num_slices=2, slice_feature_dim=16,
)
TINY_PACKER = jcfg.PackerConfig(
    grid=(2, 2, 2), kernel=(1, 2, 2), in_dim=16, out_dim=32, dropout_rate=0.0
)
TINY_LLM = jcfg.Phi3Config(
    vocab_size=64, hidden_size=32, intermediate_size=64, num_layers=2,
    num_heads=4, num_kv_heads=2, head_dim=8, tie_word_embeddings=True,
    lora=jcfg.LoRAConfig(rank=2, alpha=4, dropout_rate=0.0),
)
TINY_VLM = jcfg.VLMConfig(vision=TINY_VIT, packer=TINY_PACKER, llm=TINY_LLM)


def to_torch_config(cfg):
    """A JAX package config dataclass -> the port's dataclass of that name
    (fields the port leaves out are dropped)."""
    if not dataclasses.is_dataclass(cfg):
        return cfg
    cls = getattr(tcfg, type(cfg).__name__)
    return cls(**{
        f.name: to_torch_config(getattr(cfg, f.name))
        for f in dataclasses.fields(cls)
    })


def fill_zero_inits(variables, seed: int):
    """flax initialises biases, LoRA B and the CLS token to zero; draw them
    instead so those paths carry signal through a comparison."""
    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        if path[-1].key in ("bias", "lora_b", "cls_token"):
            return np.asarray(rng.normal(0.0, 0.05, leaf.shape), leaf.dtype)
        return leaf

    return jax.tree_util.tree_map_with_path(fill, variables)


def load_flax(module: torch.nn.Module, variables) -> torch.nn.Module:
    """Load a flax variable tree into `module` through the bridge."""
    state = flax_to_torch(jax.tree.map(np.asarray, variables))
    module.load_state_dict(state, strict=True)
    return module.eval()


T_TINY_VIT = to_torch_config(TINY_VIT)
T_TINY_LLM = to_torch_config(TINY_LLM)


def to_np(t: torch.Tensor) -> np.ndarray:
    return t.detach().float().numpy()


def test_port_sources_never_name_jax():
    offenders = [
        str(p.relative_to(PORT_DIR))
        for p in PORT_DIR.rglob("*")
        if p.suffix in (".py", ".cu", ".cuh")
        and ("jax" in p.read_text() or "hsenet_tpu" in p.read_text())
    ]
    assert offenders == []


def test_importing_the_port_loads_no_jax():
    code = (
        "import sys, hsenet_torch, hsenet_torch.bridge, "
        "hsenet_torch.eval.generate, hsenet_torch.models.mllm, "
        "hsenet_torch.train.trainer, hsenet_torch.data.datasets, "
        "hsenet_torch.serving, hsenet_torch.cli.serve, hsenet_torch.cli.common, "
        "hsenet_torch.ops.quant_matvec, hsenet_torch.models.clip, "
        "hsenet_torch.train.stage1, hsenet_torch.train.stage2, "
        "hsenet_torch.eval.retrieval, hsenet_torch.eval.speculative, "
        "hsenet_torch.ops.int8_pv, hsenet_torch.scripts.probe_int8_pv, "
        "hsenet_torch.utils.convert; "
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith(('jax.', "
        "'flax', 'hsenet_tpu'))]; print(bad); sys.exit(1 if bad else 0)"
    )
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=PORT_DIR.parent,
        capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr


@pytest.mark.parametrize(
    "build",
    [
        lambda: HSENetVLM(tcfg.VLMConfig(vision=T_TINY_VIT, llm=T_TINY_LLM)),
        lambda: ViT3D(T_TINY_VIT),
        lambda: Phi3ForCausalLM(T_TINY_LLM),
        lambda: KVCache.create(T_TINY_LLM, 1, 4),
    ],
    ids=["HSENetVLM", "ViT3D", "Phi3ForCausalLM", "KVCache"],
)
def test_entry_points_refuse_missing_cuda(build):
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA; the check is for hosts without it")
    with pytest.raises(RuntimeError, match="CUDA"):
        build()


@pytest.mark.parametrize(
    "jax_cfg",
    [
        jcfg.VLMConfig(),
        jcfg.VLMConfig(tower_mode="2e3_vit"),
        jcfg.VLMConfig(tower_mode="med2e3"),
        jcfg.VLMConfig(packer=jcfg.PackerConfig(projector_type="qformer")),
    ],
    ids=["default", "2e3", "med2e3", "qformer"],
)
def test_config_copies_agree(jax_cfg):
    t = to_torch_config(jax_cfg)
    assert t.num_image_tokens == jax_cfg.num_image_tokens
    assert t.vision.grid == jax_cfg.vision.grid
    assert t.vision.seq_len == jax_cfg.vision.seq_len == 2049
    assert t.vision.patch_dim == jax_cfg.vision.patch_dim
    assert t.packer.proj_out_num == jax_cfg.packer.proj_out_num
    assert t.packer.window_size == jax_cfg.packer.window_size
    for name in ("q_dim", "kv_dim", "rotary_dim"):
        assert getattr(t.llm, name) == getattr(jax_cfg.llm, name)
    assert tcfg.LoRAConfig().scale == jcfg.LoRAConfig().scale
