"""The port's profiling helpers (`hsenet_torch.utils.profiling`) on the CPU.

FLOP counts equal the JAX package's on the same configurations; `mfu`'s
default peak is one H100 SXM's dense bf16 rate; `time_fn` returns the JAX
helper's keys; `trace` writes a Chrome trace of the block. The modules of
the exports-and-tools slice import no JAX.
"""

import inspect
import json
import subprocess
import sys

import pytest
import torch

from hsenet_tpu.configs import ViT3DConfig as JaxViTConfig
from hsenet_tpu.utils import profiling as jprof
from hsenet_torch.utils import profiling as tprof
from test_torch_common import PORT_DIR, to_torch_config

VITS = {
    "default": JaxViTConfig(),
    "fine_patch": JaxViTConfig(patch_size=(2, 8, 8)),
    "toy": JaxViTConfig(image_size=(4, 16, 16), patch_size=(2, 8, 8),
                        hidden_size=16, mlp_dim=32, num_layers=1, num_heads=2),
}


@pytest.mark.parametrize("name", list(VITS))
def test_flops_match_jax(name):
    cfg = VITS[name]
    for batch in (1, 2, 24):
        assert tprof.vit3d_encode_flops(batch, to_torch_config(cfg)) == \
            jprof.vit3d_encode_flops(batch, cfg)
    args = (2, cfg.seq_len, cfg.hidden_size, cfg.mlp_dim, cfg.num_layers)
    assert tprof.transformer_flops(*args, extra_matmul_flops=7.0) == \
        jprof.transformer_flops(*args, extra_matmul_flops=7.0)


def test_mfu_defaults_to_the_h100_bf16_peak():
    peak = inspect.signature(tprof.mfu).parameters["peak_flops"].default
    assert peak == tprof.H100_BF16_PEAK_FLOPS == 989e12
    assert tprof.mfu(989e12, 2.0) == 0.5
    assert tprof.mfu(3.0, 1.0, peak_flops=6.0) == jprof.mfu(3.0, 1.0, peak_flops=6.0)


def test_time_fn_keys():
    calls = []

    def fn(x, scale=1.0):
        calls.append(1)
        return {"y": (x * scale,)}

    out = tprof.time_fn(fn, torch.ones(4), warmup=1, iters=3, scale=2.0)
    assert set(out) == {"best_s", "mean_s", "iters"} and out["iters"] == 3
    assert 0 <= out["best_s"] <= out["mean_s"] and len(calls) == 4


def test_trace_writes_a_chrome_trace(tmp_path):
    with tprof.trace(str(tmp_path / "trace")) as path:
        torch.ones(64, 64) @ torch.ones(64, 64)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    assert any("mm" in e.get("name", "") for e in events)


def test_tool_modules_load_no_jax():
    code = (
        "import sys, hsenet_torch.utils.profiling, hsenet_torch.utils.export, "
        "hsenet_torch.utils.export_hf, hsenet_torch.cli.export_checkpoint, "
        "hsenet_torch.ops.library; "
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'flax', "
        "'hsenet_tpu')]; print(bad); sys.exit(1 if bad else 0)"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=PORT_DIR.parent,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
