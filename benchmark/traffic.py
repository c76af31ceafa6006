"""The one generator of training samples, driven by a traffic file.

A traffic file (`workloads/<traffic>.json`) holds only parameters:

  * `task`: "contrastive" (a volume and its report, for the CLIP stages) or
    "causal_lm" (a volume, its slice features and a prompt with its answer,
    for the VLM finetune);
  * `batch`, `grad_accum`: the global batch of a step and the microbatches
    it is cut into;
  * `pool`: distinct samples generated at set-up; the loader reads them in
    a seeded order, epoch after epoch;
  * `text_tokens` [low, high]: the valid text length of a sample (BOS, the
    words and EOS of a report; the prompt, the answer and EOS after the
    image block of a VLM sample);
  * `prompt_tokens` [low, high] (causal_lm): the prompt's share of it;
  * `pattern_mix`: the share of each volume that is a pattern of its own,
    repeated in every patch (the rest is uniform noise);
  * `words_per_sample` (contrastive): each report draws its words from a
    vocabulary of its own of this many ids;
  * `int8_base`, `trace_steps`: read by the program driver and the harness.

The token ids a sample is made of (padding, the special tokens, the range
words are drawn from) are the configuration's `tokens`.

Every seed gets the same set of lengths (spread evenly over the range), in
an order of its own, so a seed changes the data and not the work. Token
ids, volumes, patterns and slice features come from the seed. Volumes are
drawn on the device in a few large calls and handed to the host, where the
program's loader reads them.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

IGNORE_INDEX = -100


def even_lengths(low: int, high: int, n: int) -> np.ndarray:
    """n lengths spread evenly over [low, high], ends included."""
    return np.round(np.linspace(low, high, n)).astype(np.int64)


def volumes(config: dict, traffic: dict, seed: int, device) -> np.ndarray:
    """(pool, C, D, H, W) f32 volumes in [0, 1]: noise mixed with a pattern
    of each sample's own repeated in every patch (a random tower gives
    i.i.d. noise volumes nearly one feature)."""
    vision = config["vision"]
    n, mix = traffic["pool"], traffic["pattern_mix"]
    chans, size, patch = vision["in_channels"], vision["image_size"], vision["patch_size"]
    gen = torch.Generator(device=device).manual_seed(int(seed) % (1 << 63))
    noise = torch.rand((n, chans, *size), generator=gen, device=device)
    pattern = torch.rand((n, chans, *patch), generator=gen, device=device)
    reps = [s // p for s, p in zip(size, patch)]
    vol = noise.mul_(1.0 - mix).add_(pattern.repeat(1, 1, *reps).mul_(mix))
    return vol.cpu().numpy()


def contrastive_samples(config: dict, traffic: dict, seed: int,
                        device) -> List[Dict[str, np.ndarray]]:
    """Volumes with reports: [CLS] words [SEP], right-padded to the
    config's `max_text_len`."""
    rng = np.random.default_rng(seed)
    n, width = traffic["pool"], config["max_text_len"]
    lens = rng.permutation(even_lengths(*traffic["text_tokens"], n))
    tok = config["tokens"]
    words = traffic["words_per_sample"]
    vols = volumes(config, traffic, seed, device)
    out = []
    for i, length in enumerate(lens):
        own = rng.choice(np.arange(*tok["words"]), words, replace=False)
        ids = np.full(width, tok["pad"], np.int64)
        ids[0], ids[length - 1] = tok["cls"], tok["sep"]
        ids[1:length - 1] = rng.choice(own, length - 2)
        mask = (np.arange(width) < length).astype(np.int64)
        out.append({"image": vols[i], "input_ids": ids, "attention_mask": mask})
    return out


def causal_lm_samples(config: dict, traffic: dict, seed: int,
                      device) -> List[Dict[str, np.ndarray]]:
    """VLM samples: BOS, the image block's placeholders, prompt, answer,
    EOS, right-padded to `seq_len`; labels are the answer and EOS."""
    rng = np.random.default_rng(seed)
    n, width = traffic["pool"], traffic["seq_len"]
    image_tokens, tok = config["image_tokens"], config["tokens"]
    text = rng.permutation(even_lengths(*traffic["text_tokens"], n))
    prompts = even_lengths(*traffic["prompt_tokens"], n)
    prompts = np.minimum(rng.permutation(prompts), text - 2)
    vols = volumes(config, traffic, seed, device)
    vision = config["vision"]
    slices = torch.randn(
        (n, vision["num_slices"], vision["slice_feature_dim"]),
        generator=torch.Generator(device=device).manual_seed(
            (int(seed) + 1) % (1 << 63)), device=device).cpu().numpy()
    out = []
    for i in range(n):
        valid = 1 + image_tokens + int(text[i])
        if valid > width:
            raise ValueError(f"a sample of {valid} tokens exceeds seq_len {width}")
        ids = np.full(width, tok["pad"], np.int64)
        ids[0] = tok["bos"]
        ids[1:1 + image_tokens] = tok["image"]
        ids[1 + image_tokens:valid - 1] = rng.integers(*tok["words"], text[i] - 1)
        ids[valid - 1] = tok["eos"]
        labels = np.full(width, IGNORE_INDEX, np.int64)
        answer_from = 1 + image_tokens + int(prompts[i])
        labels[answer_from:valid] = ids[answer_from:valid]
        mask = (np.arange(width) < valid).astype(np.int64)
        out.append({"image": vols[i], "image_2d": slices[i], "input_ids": ids,
                    "attention_mask": mask, "labels": labels})
    return out


TASKS = {"contrastive": contrastive_samples, "causal_lm": causal_lm_samples}


def samples(config: dict, traffic: dict, seed: int, device):
    """The pool of samples of a run, as the traffic file's task makes it."""
    return TASKS[traffic["task"]](config, traffic, seed, device)
