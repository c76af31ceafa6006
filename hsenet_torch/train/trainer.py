"""Training loop (the port of the JAX package's train/trainer.py): host
loader -> device batches -> train step, with step timing, a NaN guard and
the history of logged metrics.

The step's randomness is a pure function of (seed, step): step i passes the
train step `fold_seed(cfg.seed, i)`, from which it seeds its own dropout
generator. On-device augmentation and checkpointing (with resuming) come
with their slices of the port.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Callable, Dict, Iterable, List, Optional

import numpy as np
import torch

from hsenet_torch.configs import TrainConfig
from hsenet_torch.train.train_state import TrainState
from hsenet_torch.train.vlm import fold_seed


@dataclass
class TrainerHooks:
    on_log: Optional[Callable[[int, Dict[str, float]], None]] = None
    on_eval: Optional[Callable[[int, TrainState], Dict[str, float]]] = None


class Trainer:
    def __init__(
        self,
        train_step: Callable,
        state: TrainState,
        loader_factory: Callable[[], Iterable[dict]],
        cfg: TrainConfig,
        checkpoint_manager=None,
        hooks: Optional[TrainerHooks] = None,
        augment=None,
    ):
        if checkpoint_manager is not None:
            raise NotImplementedError(
                "checkpointing comes with a later slice of the port"
            )
        if augment is not None:
            raise NotImplementedError(
                "on-device augmentation comes with a later slice of the port"
            )
        self.train_step = train_step
        self.state = state
        self.loader_factory = loader_factory
        self.cfg = cfg
        self.hooks = hooks or TrainerHooks()
        self.history: List[Dict[str, float]] = []
        self.device = next(iter(state.params.values())).device

    def _place(self, batch: dict) -> Dict[str, torch.Tensor]:
        """Host batch -> device tensors (array fields only)."""
        return {
            k: torch.as_tensor(v).to(self.device, non_blocking=True)
            for k, v in batch.items() if isinstance(v, np.ndarray)
        }

    def fit(self, total_steps: Optional[int] = None) -> TrainState:
        total = total_steps or self.cfg.total_steps
        step = self.state.step
        epoch = 0
        t_last = time.perf_counter()
        while step < total:
            loader = self.loader_factory()
            if hasattr(loader, "epoch"):
                loader.epoch = epoch
            for batch in loader:
                if step >= total:
                    break
                self.state, metrics = self.train_step(
                    self.state, self._place(batch), fold_seed(self.cfg.seed, step)
                )
                step = self.state.step

                if step % self.cfg.log_every == 0 or step == total:
                    row = {k: float(v) for k, v in metrics.items()}
                    now = time.perf_counter()
                    # NaN guard at log granularity (a read per step would
                    # wait on the device every step)
                    if not np.isfinite(row["loss"]):
                        raise FloatingPointError(
                            f"non-finite loss {row['loss']} at step {step}"
                        )
                    row["steps_per_sec"] = self.cfg.log_every / max(
                        now - t_last, 1e-9
                    )
                    t_last = now
                    self.history.append({"step": step, **row})
                    if self.hooks.on_log:
                        self.hooks.on_log(step, row)
                    else:
                        msg = ", ".join(f"{k}={v:.4f}" for k, v in row.items())
                        print(f"step {step}: {msg}", flush=True)

                if (self.hooks.on_eval and self.cfg.eval_every
                        and step % self.cfg.eval_every == 0):
                    eval_metrics = self.hooks.on_eval(step, self.state)
                    if eval_metrics:
                        print(f"eval @ {step}: {eval_metrics}", flush=True)
            epoch += 1
        return self.state
