"""The model FLOP counts against hand counts at toy sizes."""

import numpy as np

from benchmark.reference import clip, vlm

VISION = {"in_channels": 1, "image_size": [2, 4, 4], "patch_size": [1, 2, 2],
          "hidden_size": 4, "mlp_dim": 8, "num_layers": 1, "num_heads": 2,
          "num_slices": 2, "slice_feature_dim": 4}


def test_clip_step_by_hand():
    config = {"vision": VISION, "projection_dim": 4,
              "text": {"hidden_size": 4, "intermediate_size": 8, "num_layers": 1,
                       "num_heads": 2}}
    batch = {"input_ids": np.zeros((2, 6), np.int64),
             "attention_mask": np.array([[1] * 3 + [0] * 3, [1] * 5 + [0]])}
    # tower, 2 volumes of 8 patches + CLS, head dim 2
    patch = 2 * 16 * 4 * 4  # 16 patches of 4 voxels into 4; weight gradient only
    dense = 2 * 18 * 4 * (12 + 4 + 8) + 2 * 18 * 8 * 4  # qkv, out, fc1 + fc2
    pairs = 2 * 2 * 9 * 9  # batch x heads x queries x keys
    tower = patch + patch + dense * 3 + 2 * 2 * 2 * pairs + 4 * 2 * 2 * pairs
    # BERT over the 3 + 5 valid tokens
    bert_dense = 4 * 2 * 8 * 4 * 4 + 2 * 2 * 8 * 4 * 8
    bert_pairs = (9 + 25) * 2
    bert = bert_dense * 3 + 2 * 2 * 2 * bert_pairs + 4 * 2 * 2 * bert_pairs
    projections = 2 * (2 * 2 * 4 * 4) * 3
    logits = 2 * 2 * 2 * 4 * 3
    assert clip.step_flops(config, {}, batch) == tower + bert + projections + logits


def test_vlm_parts_by_hand():
    config = {"vision": VISION,
              "packer": {"grid": [2, 2, 2], "kernel": [1, 2, 2], "in_dim": 4,
                         "out_dim": 6},
              "llm": {"vocab_size": 10, "hidden_size": 4, "intermediate_size": 6,
                      "num_layers": 1, "num_heads": 2, "num_kv_heads": 1,
                      "head_dim": 2},
              "lora": {"rank": 1}}
    # both towers forward: patches, one block, attention; the 2E3 guidance
    vit = 2 * 8 * 4 * 4 + (2 * 9 * 4 * 16 + 2 * 9 * 8 * 4 * 2) + 2 * 2 * 2 * 2 * 81
    guide = 2 * 8 * 16 * 2 + 2 * 2 * 2 * 4 * 4 + 2 * 2 * 8 * 2 * 4 + 2 * 8 * 4
    assert vlm.tower_flops(config, 1) == 2 * vit + guide
    # one packer: 2 windows of 4 tokens; the first products' inputs are frozen
    q, kv = 2 * 2 * 16, 2 * 2 * 2 * 4 * 16
    attn, rest = 2 * 2 * 2 * 4 * 4, 2 * 2 * (16 + 24 + 36)
    assert vlm.packer_flops(config["packer"], 1) == 2 * (q + kv) + 3 * (attn + rest)
    # the decoder over 3 valid tokens, 2 of them labelled
    base = 4 * (16 + 8 + 8 + 16 + 24 + 24 + 24)
    adapters = 6 * (8 + 6 + 6 + 8 + 10 + 10 + 10)
    attn = 6 * 2 * 2 * 2 * (1 + 2 + 3)
    head = 3 * 2 * 4 * 10
    assert vlm.llm_flops(config, [3], 2) == 3 * (base + adapters) + attn + 2 * head


def test_vlm_step_adds_its_parts():
    batch = {"input_ids": np.zeros((2, 5), np.int64),
             "attention_mask": np.array([[1, 1, 1, 0, 0], [1, 1, 1, 1, 1]]),
             "labels": np.array([[-100, -100, 7, -100, -100], [-100, 3, 4, 5, 6]])}
    config = {"vision": VISION,
              "packer": {"grid": [2, 2, 2], "kernel": [1, 2, 2], "in_dim": 4,
                         "out_dim": 6},
              "llm": {"vocab_size": 10, "hidden_size": 4, "intermediate_size": 6,
                      "num_layers": 1, "num_heads": 2, "num_kv_heads": 1,
                      "head_dim": 2},
              "lora": {"rank": 1}}
    want = (vlm.tower_flops(config, 2) + 2 * vlm.packer_flops(config["packer"], 2)
            + vlm.llm_flops(config, [3, 5], 5))
    assert vlm.step_flops(config, {}, batch) == want
