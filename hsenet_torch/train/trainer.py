"""Training loop (the port of the JAX package's train/trainer.py): host
loader -> device batches -> train step, with step timing, a NaN guard, the
history of logged metrics, a periodic eval hook, and checkpoints with a
keep-limit and milestone saves (`utils.checkpoint.CheckpointManager`).

The step's randomness is a pure function of (seed, step): step i passes the
train step `fold_seed(cfg.seed, i)`, from which it seeds its own dropout
generator. With the data position fast-forwarded on resume, a run restored
from a checkpoint at step k consumes exactly the batches and randomness an
unbroken run would have. On-device augmentation comes with its slice of
the port (ROADMAP §A5).
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
    milestone_steps: tuple = ()


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
        if augment is not None:
            raise NotImplementedError(
                "on-device augmentation comes with a later slice of the port "
                "(ROADMAP §A5)"
            )
        self.train_step = train_step
        self.state = state
        self.loader_factory = loader_factory
        self.cfg = cfg
        self.ckpt = checkpoint_manager
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
        epoch: Optional[int] = None
        pending_skip = 0
        t_last = time.perf_counter()
        while step < total:
            loader = self.loader_factory()
            if epoch is None:
                epoch = 0
                if step:  # resumed: recover (epoch, intra-epoch offset)
                    try:
                        steps_per_epoch = len(loader)
                    except TypeError:
                        steps_per_epoch = 0
                    if steps_per_epoch:
                        epoch = step // steps_per_epoch
                        pending_skip = step % steps_per_epoch
            if hasattr(loader, "epoch"):
                loader.epoch = epoch
            batches = iter(loader)
            for _ in range(pending_skip):  # the batches the run had consumed
                next(batches, None)
            pending_skip = 0
            for batch in batches:
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

                if self.ckpt is not None and (
                    step % self.cfg.checkpoint_every == 0
                    or step in self.hooks.milestone_steps
                ):
                    self.ckpt.save(step, self.state)
            epoch += 1
        if self.ckpt is not None:
            self.ckpt.wait()  # join an in-flight async save before returning
        return self.state
