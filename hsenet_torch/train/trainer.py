"""Training loop (the port of the JAX package's train/trainer.py): host
loader -> device batches -> train step, with step timing, a NaN guard, the
history of logged metrics, a periodic eval hook, checkpoints with a
keep-limit and milestone saves (`utils.checkpoint.CheckpointManager`), a
profiled window of steps (`TrainConfig.profile_dir`: a torch.profiler trace
of steps [profile_start, profile_stop), Chrome/Perfetto JSON) and the
TensorBoard logger of the CLIs (`TensorBoardLogger`).

Batches reach the device through `data.prefetch.DevicePrefetcher`, which
keeps `TrainConfig.device_prefetch` of them placed ahead of the step (0:
each is placed as it comes). With `augment=` (an `AugmentConfig`) the
`image` field is then augmented on the device (`data.augment`).

The step's randomness is a pure function of (seed, step): step i passes the
train step `fold_seed(cfg.seed, i)`, from which it seeds its own dropout
generator, and draws its augmentations from a CPU generator seeded with
`fold_seed(cfg.seed, i, AUGMENT_STREAM)`. With the data position
fast-forwarded on resume (before the prefetcher wraps the batches), a run
restored from a checkpoint at step k consumes exactly the batches and
randomness an unbroken run would have.

Over a (dp, tp) mesh (`mesh=`) every rank runs this loop on its own rows
(the CLI's loader shards the global batch over dp) and the train step
reduces the metrics, so every rank holds the single-card values. Rank 0
alone logs and prints; every rank calls the eval hook (a tensor-parallel
model needs all its ranks) and the checkpoint save, which gathers the
shards and writes from rank 0 (`utils.checkpoint`). Each dp rank draws
its augmentations from its own stream.
"""

from __future__ import annotations

import contextlib
import os
import socket
import struct
import time
from dataclasses import dataclass
from typing import Callable, Dict, Iterable, List, Optional

import numpy as np
import torch

from hsenet_torch.configs import AugmentConfig, TrainConfig
from hsenet_torch.data.augment import augment_batch
from hsenet_torch.data.prefetch import DevicePrefetcher, default_place
from hsenet_torch.parallel.mesh import axis_rank, axis_size, is_main_process
from hsenet_torch.train.train_state import TrainState
from hsenet_torch.train.vlm import fold_seed
from hsenet_torch.utils.profiling import profiled_spans

# the augmentation's stream beside the step's dropout stream
AUGMENT_STREAM = 0x617567


@dataclass
class TrainerHooks:
    on_log: Optional[Callable[[int, Dict[str, float]], None]] = None
    on_eval: Optional[Callable[[int, TrainState], Dict[str, float]]] = None
    milestone_steps: tuple = ()


def _crc32c_table():
    table = []
    for n in range(256):
        for _ in range(8):
            n = (n >> 1) ^ 0x82F63B78 if n & 1 else n >> 1
        table.append(n)
    return table


_CRC32C = _crc32c_table()


def masked_crc32c(data: bytes) -> int:
    """The TFRecord framing's checksum: CRC-32C (Castagnoli), rotated right
    by 15 bits plus 0xa282ead8."""
    crc = 0xFFFFFFFF
    for byte in data:
        crc = _CRC32C[(crc ^ byte) & 0xFF] ^ (crc >> 8)
    crc ^= 0xFFFFFFFF
    return (((crc >> 15) | (crc << 17)) + 0xA282EAD8) & 0xFFFFFFFF


def _varint(n: int) -> bytes:
    out = bytearray()
    while True:
        byte, n = n & 0x7F, n >> 7
        out.append(byte | (0x80 if n else 0))
        if not n:
            return bytes(out)


def _field(number: int, payload: bytes) -> bytes:
    """A length-delimited protobuf field."""
    return _varint(number << 3 | 2) + _varint(len(payload)) + payload


def _event(wall_time: float, step: int = 0, file_version: str = "",
           scalars: Optional[Dict[str, float]] = None) -> bytes:
    """A tensorflow `Event` message: wall_time (1, double), step (2, int64),
    file_version (3) or summary (5) of `Summary.Value`s (tag 1,
    simple_value 2, float)."""
    msg = b"\x09" + struct.pack("<d", wall_time)
    if step:
        msg += b"\x10" + _varint(step)
    if file_version:
        msg += _field(3, file_version.encode())
    if scalars:
        msg += _field(5, b"".join(
            _field(1, _field(1, tag.encode()) + b"\x15" + struct.pack("<f", value))
            for tag, value in scalars.items()))
    return msg


def tfrecord(data: bytes) -> bytes:
    """One TFRecord: the u64 length, its masked CRC, the data, its masked
    CRC."""
    length = struct.pack("<Q", len(data))
    return (length + struct.pack("<I", masked_crc32c(length)) + data
            + struct.pack("<I", masked_crc32c(data)))


class TensorBoardLogger:
    """The CLIs' `TrainerHooks(on_log=...)`: each logged metric as a scalar
    at its step in a TensorBoard event file under `logdir`, then the
    `step N: k=v` line the trainer prints without a logger (the reference
    reports to TensorBoard through HF Trainer, train_CLIP_stage1.py:113).

    The JAX package writes through `tf.summary`; the port writes the file
    itself (TFRecord framing around hand-encoded `Event` messages, first a
    `file_version` "brain.Event:2" record), so logging needs neither
    TensorFlow nor the `tensorboard` package."""

    def __init__(self, logdir: str):
        os.makedirs(logdir, exist_ok=True)
        stem = os.path.join(logdir, f"events.out.tfevents.{int(time.time())}."
                                    f"{socket.gethostname()}.{os.getpid()}")
        for n in range(1000):  # a relaunch in the same second gets its own file
            try:
                self._file = open(f"{stem}.{n}", "xb")
                break
            except FileExistsError:
                continue
        self.path = self._file.name
        self._write(_event(time.time(), file_version="brain.Event:2"))

    def _write(self, event: bytes) -> None:
        self._file.write(tfrecord(event))
        self._file.flush()

    def __call__(self, step: int, metrics: Dict[str, float]) -> None:
        self._write(_event(time.time(), step,
                           scalars={k: float(v) for k, v in metrics.items()}))
        msg = ", ".join(f"{k}={v:.4f}" for k, v in metrics.items())
        print(f"step {step}: {msg}", flush=True)

    def close(self) -> None:
        self._file.close()


class Trainer:
    def __init__(
        self,
        train_step: Callable,
        state: TrainState,
        loader_factory: Callable[[], Iterable[dict]],
        cfg: TrainConfig,
        checkpoint_manager=None,
        hooks: Optional[TrainerHooks] = None,
        augment: Optional[AugmentConfig] = None,
        mesh=None,
    ):
        self.train_step = train_step
        self.state = state
        self.loader_factory = loader_factory
        self.cfg = cfg
        self.ckpt = checkpoint_manager
        self.hooks = hooks or TrainerHooks()
        self.augment = augment
        self.history: List[Dict[str, float]] = []
        self.device = next(iter(state.params.values())).device
        self._profiler = None
        dp = axis_size(mesh, "dp")
        self._stream = (axis_rank(mesh, "dp"),) if dp > 1 else ()
        self._main = is_main_process()

    def _start_profile(self) -> None:
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            activities.append(ProfilerActivity.CUDA)
        self._spans = contextlib.ExitStack()  # spans on while it records
        self._spans.enter_context(profiled_spans())
        self._profiler = profile(activities=activities)
        self._profiler.start()
        self._profile_from = self.state.step

    def _stop_profile(self) -> None:
        """Close the window once the device has finished its steps, and
        write the trace to profile_dir."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self._profiler.stop()
        self._spans.close()
        os.makedirs(self.cfg.profile_dir, exist_ok=True)
        self._profiler.export_chrome_trace(os.path.join(
            self.cfg.profile_dir, f"steps_{self._profile_from}-{self.state.step}."
                                  f"{socket.gethostname()}.{os.getpid()}.pt.trace.json"))
        self._profiler = None

    def _place(self, batch: dict) -> Dict[str, torch.Tensor]:
        """Host batch -> device tensors (array fields only), inline."""
        return default_place(batch, self.device)

    def _augmented(self, batch: Dict[str, torch.Tensor],
                   step: int) -> Dict[str, torch.Tensor]:
        if self.augment is None or "image" not in batch:
            return batch
        gen = torch.Generator().manual_seed(
            fold_seed(self.cfg.seed, step, AUGMENT_STREAM, *self._stream))
        return {**batch, "image": augment_batch(batch["image"], gen, self.augment)}

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
            # batch i+1's copy runs while step i computes
            depth = self.cfg.device_prefetch
            if depth:
                batches = iter(DevicePrefetcher(batches, depth, device=self.device))
            for batch in batches:
                if step >= total:
                    break
                if self.cfg.profile_dir:  # a steady-state window of steps
                    if step == self.cfg.profile_start:
                        self._start_profile()
                    elif step == self.cfg.profile_stop and self._profiler is not None:
                        self._stop_profile()
                placed = batch if depth else self._place(batch)
                self.state, metrics = self.train_step(
                    self.state, self._augmented(placed, step),
                    fold_seed(self.cfg.seed, step)
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
                    if self._main and self.hooks.on_log:
                        self.hooks.on_log(step, row)
                    elif self._main:
                        msg = ", ".join(f"{k}={v:.4f}" for k, v in row.items())
                        print(f"step {step}: {msg}", flush=True)

                if (self.hooks.on_eval and self.cfg.eval_every
                        and step % self.cfg.eval_every == 0):
                    eval_metrics = self.hooks.on_eval(step, self.state)
                    if eval_metrics and self._main:
                        print(f"eval @ {step}: {eval_metrics}", flush=True)

                if self.ckpt is not None and (
                    step % self.cfg.checkpoint_every == 0
                    or step in self.hooks.milestone_steps
                ):
                    self.ckpt.save(step, self.state)
            if depth:
                batches.close()  # stops the prefetcher's producer now
            epoch += 1
        if self._profiler is not None:  # the window reaches past total_steps
            self._stop_profile()
        if self.ckpt is not None:
            self.ckpt.wait()  # join an in-flight async save before returning
        return self.state
