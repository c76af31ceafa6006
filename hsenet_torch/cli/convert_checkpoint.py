"""Convert reference PyTorch checkpoints into the port's params files (the
port of the JAX package's cli/convert_checkpoint.py).

Supported artifacts (see hsenet_torch/utils/convert.py for the mappings):
  * --kind clip-stage1 / clip-stage2 : M3DCLIP_stage{1,2} save_pretrained
    dirs or raw state-dict .bin files -> `CLIPModel` state (stage 2: the
    student; the frozen `stage1_pretrained_CLIP.` teacher is left out)
  * --kind bert    : HF BertModel -> `BertEncoder` state
  * --kind phi3    : HF Phi3ForCausalLM -> `Phi3ForCausalLM` state
  * --kind vlm-deltas : LaMedTrainer projector .bin -> the packers' state
    (`mm_projector.*`, `mm_projector2.*`)
  * --kind biomedclip : open_clip BiomedCLIP's ViT-B/16 trunk (timm names;
    a `visual.trunk.` prefix is taken off) -> `ViT2D` state, which
    `preprocess_ct --vit2d-checkpoint` reads
  * --kind llama   : HF LlamaForCausalLM -> `models.llama.LlamaForCausalLM`
    state (tensors renamed, kept in their dtype)

The output is one `utils.checkpoint.save_params` file; `serve` and
`evaluate` read it with `--checkpoint`. An existing output is refused.

    python -m hsenet_torch.cli.convert_checkpoint --kind phi3 \\
        --input /ckpts/phi4mini --output phi3_int8.pt --quant-int8
    python -m hsenet_torch.cli.convert_checkpoint --kind llama \\
        --input /ckpts/llama3_8b --output llama_int8.pt --quant-int8
    # the same on a host without a card
    python -c "from hsenet_torch.cli.convert_checkpoint import main; \\
        main(['--kind', 'bert', '--input', 'bert.bin', '--output', 'bert.pt'], \\
             device='cpu')"

Quantisation (--quant-int8, --quant-w8a8 with its calibration pass) runs
on `device`, the card unless the caller passes `device="cpu"`.
"""

from __future__ import annotations

import argparse
import json
import os


def load_state_dict(path: str):
    """A reference state dict from a `.pt`/`.bin` file (read with
    `torch.load(weights_only=True)`), a `.safetensors` file (where
    `safetensors` imports) or a save_pretrained directory holding one."""
    import torch

    if os.path.isdir(path):
        for name in ("pytorch_model.bin", "model.safetensors"):
            cand = os.path.join(path, name)
            if os.path.exists(cand):
                path = cand
                break
    if path.endswith(".safetensors"):
        from safetensors.torch import load_file

        return load_file(path)
    sd = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(sd, dict) and "state_dict" in sd:
        sd = sd["state_dict"]
    return sd


def main(argv=None, *, device="cuda"):
    p = argparse.ArgumentParser()
    p.add_argument("--kind", required=True, choices=[
        "clip-stage1", "clip-stage2", "bert", "phi3", "llama",
        "biomedclip", "vlm-deltas",
    ])
    p.add_argument("--input", required=True)
    p.add_argument("--output", required=True)
    p.add_argument("--num-layers", type=int, default=12)
    p.add_argument(
        "--quant-int8", action="store_true",
        help="after conversion, int8-quantize LLM projections and the "
        "embedding/LM-head table (serving analog of the reference's "
        "bitsandbytes 8-bit load, train_VLM.py:376-380); phi3/llama only",
    )
    p.add_argument(
        "--quant-w8a8", action="store_true",
        help="after conversion, prep the int8 serving encode mode: "
        "int8-quantize the vision-tower block kernels and calibrate static "
        "activation scales (load with ViT3DConfig(quant_w8a8=True, "
        "quant_w8a8_static=True)); clip-stage1/clip-stage2 only",
    )
    p.add_argument(
        "--calib-volumes", default=None,
        help="optional .npy (N, 1, D, H, W) of preprocessed volumes for "
        "the --quant-w8a8 calibration pass; unit-range noise if absent",
    )
    p.add_argument(
        "--config-json", default=None,
        help="JSON dict of config-field overrides for phi3/llama "
        '(e.g. \'{"num_layers": 2, "vocab_size": 64}\'); '
        "defaults are Phi-4-mini / Llama-3-8B shapes",
    )
    args = p.parse_args(argv)
    if args.quant_w8a8 and args.kind not in ("clip-stage1", "clip-stage2"):
        p.error("--quant-w8a8 only applies to --kind clip-stage1/clip-stage2")
    if args.quant_int8 and args.kind not in ("phi3", "llama"):
        p.error("--quant-int8 only applies to --kind phi3/llama")

    from hsenet_torch import resolve_device
    from hsenet_torch.configs import BertConfig

    device = resolve_device(device)
    overrides = json.loads(args.config_json) if args.config_json else {}
    sd = load_state_dict(args.input)
    print(f"loaded {len(sd)} tensors from {args.input}")

    if args.kind in ("clip-stage1", "clip-stage2"):
        from hsenet_torch.utils.convert import convert_reference_clip

        # stage 2: strip the frozen teacher subtree; convert the student
        student = {k: v for k, v in sd.items()
                   if not k.startswith("stage1_pretrained_CLIP.")}
        state = convert_reference_clip(student, args.num_layers,
                                       slice_guided=args.kind == "clip-stage2")
    elif args.kind == "bert":
        from hsenet_torch.models.bert import convert_hf_bert

        state = convert_hf_bert(sd, BertConfig(num_layers=args.num_layers))
    elif args.kind == "phi3":
        from hsenet_torch.configs import Phi3Config
        from hsenet_torch.models.phi3 import convert_hf_phi3

        state = convert_hf_phi3(sd, Phi3Config(**overrides))
    elif args.kind == "llama":
        from hsenet_torch.configs import LlamaConfig
        from hsenet_torch.models.llama import convert_hf_llama

        state = convert_hf_llama(sd, LlamaConfig(**overrides))
    elif args.kind == "biomedclip":
        from hsenet_torch.utils.convert import convert_biomedclip_vit2d

        # a whole open_clip model: its trunk; else a bare trunk state dict
        trunk = {k[len("visual.trunk."):]: v for k, v in sd.items()
                 if k.startswith("visual.trunk.")} or sd
        state = convert_biomedclip_vit2d(trunk, args.num_layers)
    else:  # vlm-deltas
        from hsenet_torch.utils.convert import convert_reference_packer

        state = {f"mm_projector.{k}": v for k, v in convert_reference_packer(
            sd, "model.mm_projector.").items()}
        if any(k.startswith("model.mm_projector2.") for k in sd):
            state.update({f"mm_projector2.{k}": v for k, v in
                          convert_reference_packer(sd, "model.mm_projector2.").items()})

    if args.quant_w8a8:
        import numpy as np

        from hsenet_torch.configs import CLIPConfig, ViT3DConfig
        from hsenet_torch.utils.convert import quantize_clip_w8a8

        cfg = CLIPConfig(
            vision=ViT3DConfig(num_layers=args.num_layers,
                               slice_guided=args.kind == "clip-stage2"),
            text=BertConfig(num_layers=args.num_layers),
        )
        volumes = np.load(args.calib_volumes) if args.calib_volumes else None
        state = quantize_clip_w8a8({k: v.to(device) for k, v in state.items()},
                                   cfg, volumes=volumes)
        print("quantized vision tower to W8A8 + calibrated act scales "
              "(load with ViT3DConfig(quant_w8a8=True, "
              "quant_w8a8_static=True))")

    if args.quant_int8:
        from hsenet_torch.models.lora import (
            quantize_embed_int8,
            quantize_kernels_int8,
        )

        state = quantize_embed_int8(quantize_kernels_int8(
            {k: v.to(device) for k, v in state.items()}))
        print("quantized projections + embedding table to int8 "
              "(load with Phi3Config(quant_int8=True, quant_int8_embed=True))")

    from hsenet_torch.utils.checkpoint import save_params

    save_params(args.output, state)
    print(f"wrote {args.output}")
    return state


if __name__ == "__main__":
    main()
