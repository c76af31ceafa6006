"""The system under test: the port's training step on the card, fed as the
training CLIs feed it.

`Program` holds what a CLI's set-up builds: the model (from the family's
driver in `families/`, its weights from `benchmark.weights`), the port's
optimizer and train state, and the train step, which it calls as the
port's `Trainer` does. `Feed` is the CLIs' input path: the port's
`DataLoader` over the in-memory pool of samples, each batch placed on the
card ahead of the step by the port's `DevicePrefetcher`.

Faults for the checks' own tests are planted here, in the program:
"unchanged" (the optimizer returns the state as it was), "half_batch"
(the step sees the first half of each batch), "loss_scaled" (the
step's answer altered where it is produced: the family's loss function,
`families/<family>.LOSS`, returns its loss 1.1 times over, as a mean over
a wrong count would) and "attention_dqk_zeroed" (the attention's backward,
B3 on the card, returns zeros for the gradients of queries and keys).

The checked steps run with the model's dropout rates at 0
(`Program.dropout_off`): the reference draws no masks. The rates are
restored before the window, which runs them as the configuration states.
"""

from __future__ import annotations

import contextlib
import dataclasses
import importlib
from typing import Dict, List

import numpy as np
import torch

from benchmark import weights as bench_weights

FAULTS = ("unchanged", "half_batch", "loss_scaled", "attention_dqk_zeroed")
# where the attention's backward is looked up at each call
ATTENTION_BACKWARD = ("hsenet_torch.ops.flash_attention", "flash_attention_backward")
LOSS_FAULT_SCALE = 1.1


class Pool:
    """The in-memory dataset: a list of sample dicts of host arrays."""

    def __init__(self, samples: List[Dict[str, np.ndarray]]):
        self.samples = samples

    def __len__(self):
        return len(self.samples)

    def __getitem__(self, idx):
        return self.samples[idx]


def batch_info(batch: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """The fields of a host batch that the operation counts read."""
    return {k: batch[k] for k in ("input_ids", "attention_mask", "labels")
            if k in batch}


class Feed:
    """Device batches, epoch after epoch over the pool, with the host
    batches' count fields in `info` (in the order the steps take them) and
    the first `keep` host batches whole in `kept`."""

    def __init__(self, samples, batch: int, seed: int, device, keep: int,
                 depth: int = 2):
        from hsenet_torch.data.datasets import DataLoader
        from hsenet_torch.data.prefetch import DevicePrefetcher

        self.loader = DataLoader(Pool(samples), batch, shuffle=True, seed=seed)
        self.info: List[Dict[str, np.ndarray]] = []
        self.kept: List[Dict[str, np.ndarray]] = []
        self.keep = keep
        self._batches = iter(DevicePrefetcher(self._host(), depth, device=device))

    def _host(self):
        while True:  # the loader shuffles each epoch from seed + epoch
            for batch in self.loader:
                if len(self.kept) < self.keep:
                    self.kept.append(batch)
                self.info.append(batch_info(batch))
                yield batch

    def __next__(self) -> Dict[str, torch.Tensor]:
        return next(self._batches)

    def close(self) -> None:
        self._batches.close()


def fill_weights(model: torch.nn.Module, seed: int, qk_gain=None) -> None:
    """Every parameter of `model` from `benchmark.weights`, in place."""
    with torch.no_grad():
        for name, p in model.named_parameters():
            p.copy_(bench_weights.draw(seed, name, p.shape, p.device, qk_gain))


def train_config(config: dict):
    """The port's TrainConfig of the configuration's optimizer."""
    from hsenet_torch.configs import TrainConfig

    fields = {f.name for f in dataclasses.fields(TrainConfig)}
    return TrainConfig(**{k: v for k, v in config["optimizer"].items() if k in fields})


class Program:
    """The port's model, optimizer, train state and train step."""

    def __init__(self, family, config: dict, traffic: dict, seed: int, device,
                 fault=None):
        from hsenet_torch.train.train_state import TrainState, make_optimizer
        from hsenet_torch.train.vlm import fold_seed

        if fault is not None and fault not in FAULTS:
            raise ValueError(f"fault must be one of {FAULTS}")
        self.fold_seed = fold_seed
        self.seed = seed
        self.fault = fault
        self._restore = []
        if fault == "loss_scaled":
            self._patch(*family.LOSS, _scaled_loss)
        if fault == "attention_dqk_zeroed":
            self._patch(*ATTENTION_BACKWARD, _zero_dqk)
        self.model, mask = family.build(config, traffic, seed, device)
        self.tx = make_optimizer(train_config(config), trainable_mask=mask)
        self.state = TrainState.create(self.model, self.tx)
        self.step_fn = family.make_step(self.model, self.tx, traffic)
        if fault == "unchanged":
            self.tx.step = lambda params, grads, state, norm: dataclasses.replace(
                state, count=state.count + 1)

    def _patch(self, module_name: str, attr: str, wrap) -> None:
        module = importlib.import_module(module_name)
        original = getattr(module, attr)
        setattr(module, attr, wrap(original))
        self._restore.append((module, attr, original))

    def dropout_rates(self):
        """(module, attribute, value) of every dropout rate above 0 that the
        model's modules read when they run: a `*dropout_rate` attribute, or
        the rate of a LoRA configuration."""
        found = []
        for m in self.model.modules():
            for attr, value in vars(m).items():
                rate = (value if attr.endswith("dropout_rate")
                        else getattr(value, "dropout_rate", 0.0) if attr == "lora"
                        else 0.0)
                if isinstance(rate, float) and rate > 0.0:
                    found.append((m, attr, value))
        return found

    @property
    def has_dropout(self) -> bool:
        return bool(self.dropout_rates())

    @contextlib.contextmanager
    def dropout_off(self):
        """Every dropout rate of the model at 0 inside the context, as it
        was after."""
        found = self.dropout_rates()
        for m, attr, value in found:
            setattr(m, attr, 0.0 if attr != "lora"
                    else dataclasses.replace(value, dropout_rate=0.0))
        try:
            yield
        finally:
            for m, attr, value in found:
                setattr(m, attr, value)

    def step(self, batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """One train step, called as the port's Trainer calls it."""
        if self.fault == "half_batch":
            half = next(iter(batch.values())).shape[0] // 2
            batch = {k: v[:half] for k, v in batch.items()}
        self.state, metrics = self.step_fn(
            self.state, batch, self.fold_seed(self.seed, self.state.step))
        return metrics

    def trainable(self) -> Dict[str, torch.Tensor]:
        return self.state.params

    def first_grad_norms(self) -> Dict[str, float]:
        """Each trained leaf's norm of the first step's gradient as the
        optimizer got it: its first moment after one update over 1 - b1."""
        opt = self.state.opt_state
        b1 = self.tx.cfg.adam_b1
        return {n: float(m.norm()) / (1.0 - b1)
                for n, m in zip(self.state.params, opt.mu)}

    def close(self) -> None:
        while self._restore:
            setattr(*self._restore.pop())
        self.model = self.tx = self.state = self.step_fn = None


def _scaled_loss(loss_fn):
    def scaled(*args, **kwargs):
        loss, *rest = loss_fn(*args, **kwargs)
        return (loss * LOSS_FAULT_SCALE, *rest)
    return scaled


def _zero_dqk(backward):
    def zeroed(*args, **kwargs):
        dq, dk, dv = backward(*args, **kwargs)
        return torch.zeros_like(dq), torch.zeros_like(dk), dv
    return zeroed
