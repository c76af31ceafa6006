"""Toy cells of both configurations, small enough for the CPU: the
cell's files with every size cut, computing in float32."""

from __future__ import annotations

import copy

from benchmark.harness import Cell, find_cell

LIMITS = {"loss": 1e-4, "first_grad": 1e-3, "change": 1e-3}


def toy_vision(vision: dict) -> dict:
    return {**vision, "image_size": [8, 32, 32], "patch_size": [2, 8, 8],
            "hidden_size": 32, "mlp_dim": 64, "num_layers": 2, "num_heads": 4,
            **({"num_slices": 4, "slice_feature_dim": 32}
               if "num_slices" in vision else {})}


def toy_cell(name: str, **traffic) -> Cell:
    """The cell `name` of BENCHMARK.json at toy sizes, in float32."""
    cell = copy.deepcopy(find_cell(name))
    cfg = cell.config
    cfg["dtype"] = "float32"
    cfg["vision"] = toy_vision(cfg["vision"])
    if cfg["family"] == "clip":
        cfg["text"].update(vocab_size=512, hidden_size=32, num_layers=2,
                           num_heads=4, intermediate_size=64,
                           max_position_embeddings=64)
        cfg.update(projection_dim=32, max_text_len=16)
        cfg["tokens"]["words"] = [200, 512]
        cell.traffic.update(batch=4, pool=12, text_tokens=[6, 16],
                            words_per_sample=8, trace_steps=1)
    else:
        cfg["packer"].update(grid=[4, 4, 4], kernel=[1, 2, 2], in_dim=32, out_dim=64)
        cfg["llm"].update(vocab_size=512, hidden_size=64, intermediate_size=128,
                          num_layers=2, num_heads=4, num_kv_heads=2, head_dim=16)
        cfg["lora"].update(rank=4, alpha=8)
        cfg["image_tokens"] = 32
        cfg["tokens"] = {"pad": 0, "bos": 1, "eos": 2, "image": 3, "words": [10, 512]}
        cell.traffic.update(batch=4, grad_accum=2, pool=12, seq_len=64,
                            text_tokens=[10, 30], prompt_tokens=[2, 6],
                            trace_steps=1)
    cell.traffic.update(traffic)
    cell.limits = dict(LIMITS)
    return cell
