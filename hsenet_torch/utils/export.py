"""AOT model export of the port: `torch.export` programs on disk (the port
of the JAX package's utils/export.py).

A serving process loads an artifact and calls it without the model code,
its configuration objects or any tracing: only torch, `hsenet_torch.ops`
(which registers the kernels' operators, `hsenet_torch::flash_fwd` and
`hsenet_torch::quant_matvec`, so the graph's kernel nodes resolve) and this
module. The models package is never imported on the loading side.

Weights stay outside the artifact: they are a dict argument (the model's
state dict, or the part of it the function reads), swapped into the model
while the function is traced, so one artifact serves every checkpoint of
the same architecture and holds no weight. `export_*` raise if a program
lifted a parameter, a buffer or a tensor of the state into the artifact.

An artifact is a zip of `torch.export.save` programs and `convention.json`,
its calling convention:

  * `export_fn(fn, *example_args)`: one program, called as `fn` is;
  * `export_encode`: `(params, volume (B, 1, D, H, W) f32[, slice_features
    (B, S, F) f32]) -> (B, n_img, llm_hidden)`, `HSENetVLM.
    encode_images_only`;
  * `export_greedy_decode`: `(params, input_ids (B, P) int32, kv_lens (B,)
    int32) -> (B, max_new_tokens) int32`, what
    `eval.generate.make_greedy_generate_llm_only` returns (pad after EOS).
    It holds two programs, the prefill with its first token and one decode
    step (token and KV cache -> next token, the cache written in place), and
    the loader runs the decode loop on the host. The loop is not traced, so
    the export costs the same at any `max_new_tokens`.

Programs take fixed shapes (those of the example arguments) and are checked
against them at each call. An artifact exported from tensors on the card
runs on the card, and one exported on the CPU runs on the CPU: a program
holds the device it was traced on, and nothing here moves one across
devices. On the card the operators launch the hand-written kernels and
count their launches as eager code does.
"""

from __future__ import annotations

import contextlib
import io
import json
import zipfile
from typing import Callable, Dict, Mapping

import torch

# the kernels' operators must be registered before a program is loaded
from hsenet_torch.ops import flash_attention as _flash  # noqa: F401
from hsenet_torch.ops import quant_matvec as _matvec  # noqa: F401

FORMAT = "hsenet_torch.export/1"
CONVENTION = "convention.json"


class _Program(torch.nn.Module):
    """A function as the module `torch.export.export` takes; it holds no
    state of its own."""

    def __init__(self, fn: Callable):
        super().__init__()
        self.fn = fn

    def forward(self, *args):
        return self.fn(*args)


@contextlib.contextmanager
def _swapped(model: torch.nn.Module, params: Mapping[str, torch.Tensor]):
    """`model` with each named parameter or buffer replaced by `params`'s
    tensor of that name, for the duration of the block."""
    from torch.nn.utils.stateless import _reparametrize_module

    with _reparametrize_module(model, dict(params)):
        yield model


def bind(model: torch.nn.Module, method: str = "forward") -> Callable:
    """`fn(params, *args)`: `getattr(model, method)(*args)` with the model's
    state replaced by `params` (names as in `model.state_dict()`)."""

    def fn(params, *args):
        with _swapped(model, params):
            return getattr(model, method)(*args)

    return fn


def _weights(params: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """`params` as the programs take them: a plain dict in sorted order
    (its layout is part of the calling convention), no gradient."""
    return {k: params[k].detach() for k in sorted(params)}


def _state_storages(*states) -> set:
    ptrs = {t.untyped_storage().data_ptr() for state in states
            for t in state.values() if isinstance(t, torch.Tensor)}
    return ptrs - {0}


def _export(fn: Callable, args: tuple, *states) -> torch.export.ExportedProgram:
    """Trace `fn(*args)` (non-strict, no gradient recorded) and check that
    the program lifted no parameter, buffer or tensor of `states`."""
    with torch.no_grad():
        ep = torch.export.export(_Program(fn), args, strict=False)
    sig = ep.graph_signature
    lifted = list(sig.inputs_to_parameters) + list(sig.inputs_to_buffers)
    storages = _state_storages(*states)
    lifted += [name for name, t in ep.constants.items()
               if isinstance(t, torch.Tensor)
               and t.untyped_storage().data_ptr() in storages]
    if lifted:
        raise ValueError(f"the exported program holds state: {lifted[:6]}; "
                         "pass every weight the function reads in params")
    ep.example_inputs = None  # the weights among them: not saved with it
    return ep


def _pack(convention: dict, programs: Dict[str, torch.export.ExportedProgram]
          ) -> bytes:
    buf = io.BytesIO()
    with zipfile.ZipFile(buf, "w", zipfile.ZIP_STORED) as z:
        z.writestr(CONVENTION, json.dumps({"format": FORMAT, **convention}))
        for name, ep in programs.items():
            program = io.BytesIO()
            torch.export.save(ep, program)
            z.writestr(f"{name}.pt2", program.getvalue())
    return buf.getvalue()


def export_fn(fn: Callable, *example_args) -> bytes:
    """Serialize `fn` traced at `example_args`' shapes and dtypes. The first
    argument is the weights' dict, kept outside the artifact (see `bind`)."""
    args = (_weights(example_args[0]), *example_args[1:])
    return _pack({"kind": "function"},
                 {"fn": _export(fn, args, example_args[0])})


def export_encode(model, params: Mapping[str, torch.Tensor], *,
                  batch: int = 1, with_slice_features: bool = True) -> bytes:
    """Serialize the vision side, dual towers + packers -> image features:
    `(params, volume (B, 1, D, H, W) f32[, slice_features (B, S, F) f32])
    -> (B, n_img, llm_hidden)`, `HSENetVLM.encode_images_only`, the
    prompt-independent prefix a disaggregated encode tier computes. Traced
    on the device of `params`."""
    v = model.config.vision
    device = next(iter(params.values())).device
    args = [_weights(params),
            torch.zeros((batch, 1, *v.image_size), device=device)]
    if with_slice_features:
        args.append(torch.zeros((batch, v.num_slices, v.slice_feature_dim),
                                device=device))
    ep = _export(bind(model, "encode_images_only"), tuple(args), params,
                 model.state_dict())
    return _pack({"kind": "function", "program": "encode_images_only"},
                 {"fn": ep})


def export_greedy_decode(model, params: Mapping[str, torch.Tensor], *,
                         max_new_tokens: int, prompt_len: int, batch: int = 1,
                         eos_token_id: int = -1, pad_token_id: int = 0,
                         cache_dtype=torch.bfloat16) -> bytes:
    """Serialize LLM-only greedy decoding of a `Phi3ForCausalLM`: `(params,
    input_ids (B, P) int32, kv_lens (B,) int32) -> (B, max_new_tokens)
    int32`, the tokens `make_greedy_generate_llm_only(model,
    max_new_tokens=, eos_token_id=, pad_token_id=, cache_dtype=)` gives,
    with B = `batch` and P = `prompt_len`. Two programs, neither unrolling
    the decode loop: the prefill into a fresh KV cache of P +
    `max_new_tokens` slots a row with its first token, and one decode step.
    Traced on the device of `params`."""
    from hsenet_torch.models.phi3 import KVCache

    cfg = model.config
    capacity = prompt_len + max_new_tokens
    device = next(iter(params.values())).device
    weights = _weights(params)
    state = model.state_dict()

    def prefill(p, input_ids, kv_lens):
        with _swapped(model, p):
            cache = KVCache.create(cfg, batch, capacity, dtype=cache_dtype,
                                   device=input_ids.device)
            logits, cache = model(input_ids, kv_lens=kv_lens.to(torch.int32),
                                  cache=cache, last_token_only=True)
        first = logits[:, 0].argmax(dim=-1).to(torch.int32)
        return (first, cache.k, cache.v, cache.lengths,
                *([cache.k_scale, cache.v_scale] if cache.quantized else []))

    def step(p, token, k, v, lengths, *scales):
        with _swapped(model, p):
            cache = KVCache(k, v, lengths, *scales)
            logits, cache = model(token[:, None], cache=cache)
        return logits[:, 0].argmax(dim=-1).to(torch.int32), cache.lengths

    ids = torch.zeros((batch, prompt_len), dtype=torch.int32, device=device)
    kv = torch.full((batch,), prompt_len, dtype=torch.int32, device=device)
    prefill_ep = _export(prefill, (weights, ids, kv), params, state)
    cache = KVCache.create(cfg, batch, capacity, dtype=cache_dtype,
                           device=device)
    cache = (cache.k, cache.v, cache.lengths,
             *([cache.k_scale, cache.v_scale] if cache.quantized else []))
    token = torch.zeros((batch,), dtype=torch.int32, device=device)
    step_ep = _export(step, (weights, token, *cache), params, state)
    convention = {"kind": "greedy_decode", "batch": batch,
                  "prompt_len": prompt_len, "max_new_tokens": max_new_tokens,
                  "eos_token_id": eos_token_id, "pad_token_id": pad_token_id}
    return _pack(convention, {"prefill": prefill_ep, "step": step_ep})


def _greedy_loop(prefill, step, conv: dict) -> Callable:
    """The decode loop over the two programs, the loop of
    `eval.generate._greedy_loop`: pad after EOS, and the last step feeds no
    output."""
    n_steps = conv["max_new_tokens"]
    eos, pad_id = conv["eos_token_id"], conv["pad_token_id"]

    def generate(params, input_ids, kv_lens):
        params = _weights(params)
        token, *cache = prefill(params, input_ids, kv_lens)
        k, v, lengths, *scales = cache
        done = torch.zeros_like(token, dtype=torch.bool)
        pad = torch.full_like(token, pad_id)
        out = []
        for i in range(n_steps):
            out.append(torch.where(done, pad, token))
            if i == n_steps - 1:
                break
            next_tok, lengths = step(params, token, k, v, lengths, *scales)
            done = done | (token == eos)
            token = torch.where(done, pad, next_tok)
        if not out:
            return token.new_zeros((token.shape[0], 0))
        return torch.stack(out, dim=1)

    return generate


class Exported:
    """A loaded artifact: call it with the artifact's calling convention.
    `programs` are its `torch.export` programs by name (`fn`, or `prefill`
    and `step`), `convention` its calling convention."""

    def __init__(self, blob: bytes):
        with zipfile.ZipFile(io.BytesIO(blob)) as z:
            self.convention = json.loads(z.read(CONVENTION))
            if self.convention.get("format") != FORMAT:
                raise ValueError(f"not an artifact of {FORMAT}: "
                                 f"{self.convention.get('format')}")
            self.programs = {
                name[:-len(".pt2")]: torch.export.load(io.BytesIO(z.read(name)))
                for name in z.namelist() if name.endswith(".pt2")}
        mods = {name: ep.module() for name, ep in self.programs.items()}
        if self.convention["kind"] == "greedy_decode":
            self._fn = _greedy_loop(mods["prefill"], mods["step"],
                                    self.convention)
        else:
            fn = mods["fn"]
            self._fn = lambda params, *args: fn(_weights(params), *args)

    def __call__(self, *args):
        with torch.inference_mode():
            return self._fn(*args)

    def op_nodes(self) -> Dict[str, Dict[str, int]]:
        """Calls of the `hsenet_torch` operators in each program, by op."""
        out = {}
        for name, ep in self.programs.items():
            counts: Dict[str, int] = {}
            for node in ep.graph.nodes:
                target = str(node.target) if node.op == "call_function" else ""
                if target.startswith("hsenet_torch."):
                    counts[target] = counts.get(target, 0) + 1
            out[name] = counts
        return out

    def lifted(self) -> Dict[str, Dict[str, int]]:
        """What each program holds besides its graph: lifted parameters,
        buffers and tensor constants by name, with their element counts
        (parameters and buffers -1), and saved example inputs' elements
        under "example_inputs"."""
        out = {}
        for name, ep in self.programs.items():
            sig = ep.graph_signature
            held = {n: -1 for n in (*sig.inputs_to_parameters,
                                    *sig.inputs_to_buffers)}
            held.update({n: t.numel() for n, t in ep.constants.items()
                         if isinstance(t, torch.Tensor)})
            if ep.example_inputs is not None:
                held["example_inputs"] = sum(
                    t.numel() for t in torch.utils._pytree.tree_leaves(
                        ep.example_inputs) if isinstance(t, torch.Tensor))
            out[name] = held
        return out


def load_exported(blob: bytes) -> Exported:
    """bytes -> callable with the artifact's calling convention."""
    return Exported(blob)


def save_exported(path: str, blob: bytes) -> None:
    with open(path, "wb") as f:
        f.write(blob)


def load_exported_file(path: str) -> Exported:
    with open(path, "rb") as f:
        return load_exported(f.read())
