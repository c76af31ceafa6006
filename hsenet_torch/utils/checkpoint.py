"""Checkpoints of the port (the port of the JAX package's
utils/checkpoint.py): periodic train-state saves with a keep-limit,
single parameter-set saves, and the VLM finetune's delta-only saves.

The format is PyTorch's own: `torch.save` of state dicts whose tensors were
moved to the host, read back with `torch.load(weights_only=True)` onto the
template's device. Nothing beyond PyTorch is needed to read or write one.

  * `CheckpointManager(directory)` keeps `<directory>/<step>/state.pt`
    (the step count, the trainable parameters by name and the AdamW
    moments), the newest `max_to_keep` of them, and a `config.json` beside
    the steps. A step is written under a temporary name and renamed when
    complete, so a reader never sees half a step.
  * `save_params` / `restore_params`: one state dict in one file (the
    converters' output and `--checkpoint`'s input). An existing path is
    refused unless `overwrite=True`.
    Over a mesh the saved state is always the full, gathered one: `save`
    gathers every tensor- or data-parallel shard and ZeRO-1 slice (every
    rank calls it) and rank 0 writes; `restore` reads the file on every
    rank and cuts each leaf to the rank's shard, so `--resume` works
    across layouts. Where a rank holds part of the model's leaves (a
    pipeline stage), `save` collects the whole model's leaves and their
    moments in its order and `restore` keeps the rank's own
    (`parallel/sharding.py`).
  * `filter_tree`, `save_vlm_deltas`, `load_vlm_deltas`: the projector,
    LoRA and embedding leaves only (`LaMedTrainer._save`,
    lamed_trainer.py:20-24), selected by a regex over the state dict's
    dotted names.
"""

from __future__ import annotations

import dataclasses
import json
import os
import re
import shutil
import threading
from typing import Dict, List, Mapping, Optional

import torch

from hsenet_torch.parallel.mesh import barrier, is_main_process
from hsenet_torch.train.train_state import TrainState
from hsenet_torch.utils.convert import graft_params

_STATE_FILE = "state.pt"


def _host(t: torch.Tensor) -> torch.Tensor:
    """A host copy of `t` that owns its storage (later in-place updates of
    `t` do not reach it)."""
    return t.detach().to("cpu", copy=True)


def _atomic_save(obj, path: str) -> None:
    tmp = f"{path}.tmp-{os.getpid()}-{threading.get_ident()}"
    torch.save(obj, tmp)
    os.replace(tmp, path)


def _check_like(name: str, got: torch.Tensor, want: torch.Tensor) -> torch.Tensor:
    """`got` as a leaf of the template's `want`: same shape; a float leaf
    takes the template's float dtype (as orbax casts to its target's); any
    other dtype difference (int8 codes against a float leaf) raises."""
    if tuple(got.shape) != tuple(want.shape):
        raise ValueError(f"{name}: checkpoint shape {tuple(got.shape)} != "
                         f"template {tuple(want.shape)}")
    if got.dtype != want.dtype and not (got.is_floating_point()
                                        and want.is_floating_point()):
        raise TypeError(f"{name}: checkpoint dtype {got.dtype} != template "
                        f"{want.dtype}")
    return got.to(device=want.device, dtype=want.dtype)


def _check_keys(got: Mapping, want: Mapping, where: str) -> None:
    missing = sorted(set(want) - set(got))
    unexpected = sorted(set(got) - set(want))
    if missing or unexpected:
        raise KeyError(f"{where}: missing {missing[:6]}, unexpected "
                       f"{unexpected[:6]}")


class CheckpointManager:
    """Train-state saves under `directory`, the newest `max_to_keep` kept.

    With `async_save=True`, `save()` copies the tensors to the host and
    returns; the write runs on a background thread while training goes on.
    `wait()` (and the next `save` or `restore`, which call it) joins it and
    re-raises an error the write met."""

    def __init__(self, directory: str, max_to_keep: int = 3,
                 async_save: bool = False):
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        self.async_save = async_save
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[Exception] = None
        os.makedirs(self.directory, exist_ok=True)

    def all_steps(self) -> List[int]:
        return sorted(int(n) for n in os.listdir(self.directory)
                      if n.isdigit() and os.path.isfile(
                          os.path.join(self.directory, n, _STATE_FILE)))

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def save(self, step: int, state: TrainState, config: Optional[dict] = None,
             force: bool = False) -> None:
        """Save `state` as step `step`. A step already on disk is refused
        unless `force`, which replaces it."""
        self.wait()
        final = os.path.join(self.directory, str(step))
        exists = os.path.exists(final)
        # every rank has looked before rank 0 writes the step: a rank that
        # looked after would find it and raise where the others do not
        barrier()
        if exists and not force:
            raise FileExistsError(f"step {step} exists in {self.directory}")
        mu, nu = _full_moments(state)
        leaves = {k: (_full_leaf(state, k, v), m, n)
                  for (k, v), m, n in zip(state.params.items(), mu, nu)}
        if state.model is not None:
            from hsenet_torch.parallel.sharding import gather_model_leaves

            leaves = gather_model_leaves(state.model, leaves)
        payload = {
            "step": int(state.step),
            "params": {k: _host(v[0]) for k, v in leaves.items()},
            "opt_state": {"count": int(state.opt_state.count),
                          "mu": [_host(v[1]) for v in leaves.values()],
                          "nu": [_host(v[2]) for v in leaves.values()]},
        }
        if not is_main_process():
            if not self.async_save:
                barrier()
            return
        if config is not None:
            with open(os.path.join(self.directory, "config.json"), "w") as f:
                json.dump(config, f, indent=2, default=str)
        if self.async_save:
            self._thread = threading.Thread(
                target=self._write_guarded, args=(final, payload), daemon=True)
            self._thread.start()
        else:
            self._write(final, payload)
            barrier()  # the step is on disk before any rank goes on

    def _write_guarded(self, final: str, payload: dict) -> None:
        try:
            self._write(final, payload)
        except Exception as e:  # re-raised by wait() on the caller's thread
            self._error = e

    def _write(self, final: str, payload: dict) -> None:
        tmp = f"{final}.tmp"
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        torch.save(payload, os.path.join(tmp, _STATE_FILE))
        shutil.rmtree(final, ignore_errors=True)
        os.replace(tmp, final)
        if self.max_to_keep:
            for old in self.all_steps()[:-self.max_to_keep]:
                shutil.rmtree(os.path.join(self.directory, str(old)))

    def wait(self) -> None:
        """Join an in-flight async save; raise what it met."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            error, self._error = self._error, None
            raise error

    def restore(self, state_template: TrainState, step: Optional[int] = None
                ) -> TrainState:
        """The saved state of `step` (the latest by default), written into
        the template's tensors in place (its params are the model's
        parameters) and returned as a `TrainState` holding them."""
        self.wait()  # a step being written counts
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {self.directory}")
        path = os.path.join(self.directory, str(step), _STATE_FILE)
        payload = torch.load(path, map_location="cpu", weights_only=True)
        params = state_template.params
        opt = state_template.opt_state
        saved = payload["opt_state"]
        full = list(payload["params"])  # the whole model's, in its order
        if len(saved["mu"]) != len(full) or len(saved["nu"]) != len(full):
            raise ValueError(f"{path}: {len(saved['mu'])} optimizer moments "
                             f"for {len(full)} leaves")
        leaves = {k: (payload["params"][k], m, n)
                  for k, m, n in zip(full, saved["mu"], saved["nu"])}
        if state_template.model is not None:
            from hsenet_torch.parallel.sharding import keep_rank_leaves

            leaves = keep_rank_leaves(state_template.model, leaves)
        _check_keys(leaves, params, path)
        names = list(params)
        pairs = [(f"params.{k}", _local_leaf(state_template, k, leaves[k][0]),
                  params[k]) for k in names]
        pairs += [(f"opt_state.{m}.{i}",
                   _local_leaf(state_template, k, leaves[k][j], i), t)
                  for j, m in ((1, "mu"), (2, "nu"))
                  for i, (k, t) in enumerate(zip(names, getattr(opt, m)))]
        with torch.no_grad():
            for name, src, dst in pairs:
                if src.dtype != dst.dtype:
                    raise TypeError(f"{name}: checkpoint dtype {src.dtype} != "
                                    f"template {dst.dtype}")
                dst.copy_(_check_like(name, src, dst))
        return TrainState(step=int(payload["step"]), params=params,
                          opt_state=dataclasses.replace(
                              opt, count=int(saved["count"])),
                          model=state_template.model, mesh=state_template.mesh)


def _zero1_extra(state: TrainState, i: int):
    opt = state.opt_state
    if opt.zero1_dims is None or opt.zero1_dims[i] is None:
        return None
    return opt.zero1_dims[i], opt.zero1_group


def _full_leaf(state: TrainState, name: str, t: torch.Tensor,
               i: Optional[int] = None) -> torch.Tensor:
    """A parameter (or, with its index `i`, an Adam moment) gathered from
    its shards; itself on one card."""
    if state.model is None or state.mesh is None:
        return t
    from hsenet_torch.parallel.sharding import gather_leaf

    return gather_leaf(state.model, name, t,
                       None if i is None else _zero1_extra(state, i))


def _full_moments(state: TrainState):
    names = list(state.params)
    opt = state.opt_state
    return ([_full_leaf(state, names[i], t, i) for i, t in enumerate(opt.mu)],
            [_full_leaf(state, names[i], t, i) for i, t in enumerate(opt.nu)])


def _local_leaf(state: TrainState, name: str, full: torch.Tensor,
                i: Optional[int] = None) -> torch.Tensor:
    """The inverse of `_full_leaf`: this rank's shard of a saved leaf."""
    if state.model is None or state.mesh is None:
        return full
    from hsenet_torch.parallel.sharding import split_leaf

    local = split_leaf(state.model, name, full)
    extra = None if i is None else _zero1_extra(state, i)
    if extra is not None:
        opt = state.opt_state
        local = local.chunk(opt.zero1_size, dim=extra[0])[opt.zero1_rank]
    return local


def save_params(path: str, state: Mapping[str, torch.Tensor], *,
                overwrite: bool = False) -> None:
    """One state dict (no optimizer state) to the file `path` — the
    'model_params.bin' analog of CustomSaveCallback. An existing path is
    refused unless `overwrite=True` (a run re-exporting its own artifacts);
    the converter CLI, writing to a destination the user names, keeps the
    refusal."""
    path = os.path.abspath(path)
    if os.path.exists(path) and not overwrite:
        raise FileExistsError(f"{path} exists; pass overwrite=True to replace it")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    _atomic_save({k: v.detach().to("cpu").contiguous() for k, v in state.items()},
                 path)


def restore_params(path: str, template: Mapping[str, torch.Tensor]
                   ) -> Dict[str, torch.Tensor]:
    """The state dict saved at `path`, shaped by `template`: the same keys
    (a missing or extra key raises), each leaf of its template's shape
    (else raises) on the template's device; float leaves take the
    template's dtype, and any other dtype difference raises."""
    device = next(iter(template.values())).device
    saved = torch.load(os.path.abspath(path), map_location=device,
                       weights_only=True)
    _check_keys(saved, template, path)
    return {k: _check_like(k, saved[k], want) for k, want in template.items()}


def filter_tree(state: Mapping[str, torch.Tensor], pattern: str
                ) -> Dict[str, torch.Tensor]:
    """The leaves whose dotted name, with a leading ".", matches `pattern`
    (searched, not anchored) — e.g. r'(mm_projector|lora_)' keeps
    LaMedTrainer._save's projector+LoRA-only set."""
    rx = re.compile(pattern)
    return {k: v for k, v in state.items() if rx.search("." + k)}


# the VLM finetune's trainable set: projectors + LoRA + embeddings
# (lamed_trainer.py:20-24 + new-token embeddings), plus the seg branch
# (seg_projector + the grafted SegVol); "\.embed\." is the JAX package's
# "/embed/" over dotted names: the LLM's token table, not `patch_embed`
_VLM_DELTA_RX = r"(mm_projector|lora_[ab]|\.embed\.|seg_projector|seg_module)"


def is_vlm_delta(name: str) -> bool:
    """Whether the leaf `name` is in the VLM finetune's trainable set."""
    return re.search(_VLM_DELTA_RX, "." + name) is not None


def save_vlm_deltas(path: str, state: Mapping[str, torch.Tensor]) -> None:
    """Persist only the VLM finetune's trainable set (see _VLM_DELTA_RX).
    Overwrites: the finetune re-exports into its own output dir on
    restarts."""
    save_params(path, filter_tree(state, _VLM_DELTA_RX), overwrite=True)


def load_vlm_deltas(path: str, full_state: Mapping[str, torch.Tensor]
                    ) -> Dict[str, torch.Tensor]:
    """`full_state` with the saved deltas grafted in (a new dict; load it
    with `model.load_state_dict(..., strict=True)`)."""
    full = dict(full_state)
    deltas = restore_params(path, filter_tree(full, _VLM_DELTA_RX))
    return graft_params(full, deltas)
