"""The CLIP stage-1 step as `hsenet_torch.cli.train_clip_stage1` builds it:
`CLIPModel` computing in the configuration's dtype with remat, every
parameter an f32 master and trained, `train/stage1.make_stage1_train_step`
over the port's optimizer."""

from __future__ import annotations

import torch

from benchmark.program import fill_weights

# where the train step finds its loss function (a fault is planted there)
LOSS = ('hsenet_torch.train.stage1', 'clip_contrastive_loss')


def port_config(config: dict):
    from hsenet_torch.configs import BertConfig, CLIPConfig, ViT3DConfig

    vision = {k: tuple(v) if isinstance(v, list) else v
              for k, v in config["vision"].items()}
    return CLIPConfig(vision=ViT3DConfig(**vision), text=BertConfig(**config["text"]),
                      projection_dim=config["projection_dim"],
                      logit_scale_init=config["logit_scale_init"],
                      scale_is_log=config["scale_is_log"],
                      max_text_len=config["max_text_len"])


def build(config: dict, traffic: dict, seed: int, device):
    """(model, trainable mask): None, every leaf trains."""
    from hsenet_torch.models.clip import CLIPModel
    from hsenet_torch.train.vlm import to_training_dtypes

    model = CLIPModel(port_config(config), dtype=getattr(torch, config["dtype"]),
                      remat=config["remat"], device=device)
    fill_weights(model, seed, config.get("qk_gain"))
    model.train()
    to_training_dtypes(model, {n: True for n, _ in model.named_parameters()})
    return model, None


def make_step(model, tx, traffic: dict):
    from hsenet_torch.train.stage1 import make_stage1_train_step

    return make_stage1_train_step(model, tx)
