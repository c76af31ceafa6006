"""Export the port's params files back to reference PyTorch state dicts (the
port of the JAX package's cli/export_checkpoint.py).

The reverse of `convert_checkpoint` (mappings in
hsenet_torch/utils/export_hf.py): weights trained here go back to the key
layouts the reference stack loads, so the round trip convert -> finetune ->
export closes. LoRA adapters are folded into the base weights (the
exported model is the merged full model, loadable without peft);
int8-quantised weights are dequantised exactly.

Supported:
  * --kind phi3   : `Phi3ForCausalLM` state -> HF Phi3 state dict
                    (fused qkv_proj / gate_up_proj)
  * --kind llama  : `LlamaForCausalLM` state -> HF Llama state dict
  * --kind vit    : `ViT3D` tower state -> MONAI-style reference keys
                    (--prefix vision_encoder. --slice-guided for stage 2)
  * --kind packer : `VisualPacker` state -> VisualPacker_3d_phi_v3 keys
  * --kind vlm-deltas : a `save_vlm_deltas` file (or a whole `HSENetVLM`
    state) -> the reference's LaMedTrainer._save file (peft-named fused
    LoRA + mm_projector keys; load with
    LoraConfig(rank_pattern={'qkv_proj': 3r, 'gate_up_proj': 2r}))

`--input` is one `utils.checkpoint.save_params` file, as `convert_checkpoint`,
the training CLIs or `save_vlm_deltas` write it. The output is a
`torch.save` of the state dict; an existing output is refused.

    python -m hsenet_torch.cli.export_checkpoint --kind phi3 \\
        --input out3/llm_params --output phi3_merged.pt
    # the same on a host without a card
    python -c "from hsenet_torch.cli.export_checkpoint import main; \\
        main(['--kind', 'phi3', '--input', 'llm.pt', '--output', 'hf.pt'], \\
             device='cpu')"

The dequantisation and the LoRA merge run on `device`, the card unless the
caller passes `device="cpu"`.
"""

from __future__ import annotations

import argparse
import os


def main(argv=None, *, device="cuda"):
    p = argparse.ArgumentParser()
    p.add_argument("--kind", required=True,
                   choices=["phi3", "llama", "vit", "packer", "vlm-deltas"])
    p.add_argument("--input", required=True,
                   help="params file (as written by convert_checkpoint, the "
                        "train CLIs or save_vlm_deltas)")
    p.add_argument("--output", required=True,
                   help=".pt file (torch.save of the state dict)")
    p.add_argument("--num-layers", type=int, default=32)
    p.add_argument("--prefix", default="",
                   help="key prefix for --kind vit/packer (e.g. "
                        "'vision_encoder.' / 'mm_projector.')")
    p.add_argument("--slice-guided", action="store_true",
                   help="--kind vit: export the 2E3 stage-2 extras")
    args = p.parse_args(argv)

    import torch

    from hsenet_torch import resolve_device
    from hsenet_torch.utils import export_hf

    output = os.path.abspath(args.output)
    if os.path.exists(output):
        raise FileExistsError(f"{output} exists; the export does not overwrite")
    state = torch.load(os.path.abspath(args.input),
                       map_location=resolve_device(device), weights_only=True)

    if args.kind == "phi3":
        from hsenet_torch.configs import Phi3Config

        sd = export_hf.export_hf_phi3(state, Phi3Config(num_layers=args.num_layers))
    elif args.kind == "llama":
        from hsenet_torch.configs import LlamaConfig

        sd = export_hf.export_hf_llama(state, LlamaConfig(num_layers=args.num_layers))
    elif args.kind == "vit":
        sd = export_hf.export_reference_vit(
            state, prefix=args.prefix, slice_guided=args.slice_guided)
    elif args.kind == "packer":
        sd = export_hf.export_reference_packer(
            state, prefix=args.prefix or "mm_projector.")
    else:
        sd = export_hf.export_reference_vlm_deltas(
            state, prefix=args.prefix or "base_model.model.model.")

    os.makedirs(os.path.dirname(output), exist_ok=True)
    torch.save(export_hf.to_torch_state_dict(sd), output)
    print(f"wrote {len(sd)} tensors -> {args.output}")
    return sd


if __name__ == "__main__":
    main()
