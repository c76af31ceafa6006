"""Evaluation entry point: MRG, VQA, CLIP retrieval, segmentation and REC
(the port of the JAX package's cli/evaluate.py).

Counterparts of the reference Bench scripts (`eval_HSENet_CT_Rate_MRG.py`,
`eval_HSENet_BIMCV_R_MRG.py`, `eval_HSENet_Rad_Geome_VQA.py`) and the
retrieval utilities (`image_text_retrieval_stage{1,2}.py`), behind one CLI
with the JAX CLI's arguments:

    # smoke runs, no data needed (tiny models), on the card
    python -m hsenet_torch.cli.evaluate --task mrg --synthetic
    python -m hsenet_torch.cli.evaluate --task vqa --synthetic --engine
    python -m hsenet_torch.cli.evaluate --task retrieval --synthetic
    python -m hsenet_torch.cli.evaluate --task seg --synthetic
    python -m hsenet_torch.cli.evaluate --task rec --synthetic
    # the same on a host without a card: `main` takes `device="cpu"`
    python -c "from hsenet_torch.cli.evaluate import main; \
        main(['--task', 'mrg', '--synthetic'], device='cpu')"

    # a converted checkpoint (cli/convert_checkpoint.py) scored on a manifest
    python -m hsenet_torch.cli.evaluate --task mrg --manifest m.json \
        --data-root /data --checkpoint vlm.pt --csv mrg.csv

    # sampled reports (temperature, nucleus top-p), reproducible from
    # --gen-seed: each generate call draws with fold_seed(gen_seed, n), n
    # counting the calls
    python -m hsenet_torch.cli.evaluate --task mrg --synthetic --do-sample \
        --temperature 0.7 --top-p 0.9 --gen-seed 1

Without --checkpoint the weights are random, drawn from seed 0 (the JAX
CLI draws its own from PRNGKey(0)). --do-sample draws from the port's own
random stream (one seed, one token stream per device, none equal to the
JAX CLI's); as in the JAX CLI it refuses --engine and --spec-decode.

`seg` scores SegVol alone (`ViT3DConfig(classification=False)`, f32 as in
the JAX CLI) by dice over `SegQADataset` batches; its prompts are embedded
by a stage-1 CLIP's text tower restored from --clip-checkpoint (required
without --synthetic, which prompts with a fixed embedding). `rec` generates
box answers over `PosRECDataset` batches and scores their IoU and
accuracy at 0.25 and 0.5, with the reference's bounding-extent IoU under
--reference-compatible (Bench/utils.py:38-54).

--dp / --tp (mrg, vqa, rec) run over the processes of `torchrun
--nproc-per-node N -m hsenet_torch.cli.evaluate ...`: the LLM split over tp,
each batch split over dp (`eval.generate.make_data_parallel_generate`),
every rank holding the whole batch's ids; rank 0 prints and writes --csv.
`--dp N --do-sample` draws the tokens of `--dp 1`. --engine shards over tp
only: with --dp above 1 it is the JAX CLI's AssertionError. --task
retrieval needs --synthetic: the JAX CLI builds no model configuration
without it (ROADMAP §C).

    torchrun --nproc-per-node 2 -m hsenet_torch.cli.evaluate --task mrg \
        --manifest m.json --data-root /data --checkpoint vlm.pt --dp 2
"""

from __future__ import annotations

import argparse
import json

import torch


def _tiny_clip_cfg():
    from hsenet_torch.configs import BertConfig, CLIPConfig, ViT3DConfig

    return CLIPConfig(
        vision=ViT3DConfig(
            image_size=(8, 32, 32), patch_size=(2, 8, 8), hidden_size=32,
            mlp_dim=64, num_layers=2, num_heads=4,
        ),
        text=BertConfig(
            vocab_size=512, hidden_size=32, num_layers=2, num_heads=4,
            intermediate_size=64, max_position_embeddings=64,
        ),
        projection_dim=32,
    )


def _evaluate_seg(args, parser, device, model, max_samples):
    """--task seg: SegVol's dice over seg QA batches (see the module
    docstring)."""
    import numpy as np

    from hsenet_torch.cli.common import random_model, restore_checkpoint
    from hsenet_torch.configs import CLIPConfig, ViT3DConfig
    from hsenet_torch.data.datasets import (
        DataArgs,
        DataLoader,
        SegQADataset,
        SimpleTokenizer,
    )
    from hsenet_torch.eval.segmentation import evaluate_segmentation
    from hsenet_torch.models.segvol import SegVol

    if args.synthetic:
        vit_cfg = ViT3DConfig(
            image_size=(8, 16, 16), patch_size=(2, 4, 4), hidden_size=32,
            mlp_dim=64, num_layers=1, num_heads=4, classification=False,
        )
    else:
        vit_cfg = ViT3DConfig(classification=False)
    if model is None:
        model = random_model(SegVol, vit_cfg, dtype=torch.float32,
                             device=device, seed=0)
    if args.checkpoint:
        restore_checkpoint(model, args.checkpoint)

    def segment_fn(volume, text_emb):
        return model(volume, text_emb)

    if args.synthetic:
        def text_embed_fn(prompts):
            # a fixed embedding drives the prompt encoder without a text tower
            return np.ones((len(prompts), vit_cfg.hidden_size), np.float32)
    else:
        # real runs embed the prompts with a stage-1 CLIP's text tower
        if not args.clip_checkpoint:
            parser.error("--task seg without --synthetic needs "
                         "--clip-checkpoint (stage-1 CLIP params for "
                         "prompt embeddings)")
        from hsenet_torch.cli.common import load_tokenizer
        from hsenet_torch.models.clip import CLIPModel

        clip_cfg = CLIPConfig()
        clip = random_model(CLIPModel, clip_cfg, dtype=torch.float32,
                            device=device, seed=0)
        restore_checkpoint(clip, args.clip_checkpoint)
        tok = load_tokenizer(args, clip_cfg.text.vocab_size)

        @torch.no_grad()
        def text_embed_fn(prompts):
            rows = [tok(t_, max_length=clip_cfg.max_text_len, truncation=True,
                        padding="max_length") for t_ in prompts]
            ids, mask = (
                torch.as_tensor(np.concatenate(
                    [np.asarray(r[k]).reshape(1, -1) for r in rows]),
                    device=device)
                for k in ("input_ids", "attention_mask"))
            return clip.encode_text(ids, mask)[0]

    if args.synthetic:
        rng = np.random.default_rng(0)
        batches = [{
            "image": rng.random((2, 1, *vit_cfg.image_size)).astype("float32"),
            "seg": (rng.random((2, 1, *vit_cfg.image_size)) > 0.5
                    ).astype("float32"),
            "question": ["segment the liver [SEG]", "segment the heart [SEG]"],
        }]
    else:
        ds = SegQADataset(DataArgs(data_root=args.data_root), SimpleTokenizer(),
                          args.manifest, args.split)
        batches = DataLoader(ds, batch_size=args.batch_size, shuffle=False,
                             drop_remainder=False)
    return evaluate_segmentation(segment_fn, text_embed_fn, batches,
                                 max_samples=max_samples, device=device)


def main(argv=None, *, device="cuda", model=None):
    """Score the task `argv` describes and print the metrics as JSON (the
    JAX CLI's print). Runs on the CUDA card unless the caller passes
    `device="cpu"`, where every kernel is replaced by its plain version.

    `model`, where given, is evaluated in place of the configuration's
    model with random weights: a `HSENetVLM` for mrg/vqa/rec, a
    `CLIPModel` for retrieval, a `SegVol` for seg, on `device`
    (--checkpoint, if set, loads into it)."""
    p = argparse.ArgumentParser()
    p.add_argument(
        "--task", choices=["mrg", "vqa", "retrieval", "seg", "rec"],
        required=True,
    )
    p.add_argument("--reference-compatible", action="store_true",
                   help="rec: score with the reference's bounding-extent "
                        "IoU (Bench/utils.py:38-54)")
    p.add_argument("--synthetic", action="store_true")
    p.add_argument("--data-root", default="")
    p.add_argument("--manifest", default="")
    p.add_argument("--split", default="validation")
    p.add_argument("--batch-size", type=int, default=14)  # reference MRG bs
    p.add_argument("--max-new-tokens", type=int, default=0,
                   help="0 = task default (mrg 512 / vqa 74)")
    p.add_argument("--checkpoint", default="",
                   help="params file (utils.checkpoint.save_params)")
    p.add_argument("--clip-checkpoint", default="",
                   help="seg: stage-1 CLIP params for prompt embeddings")
    p.add_argument("--tokenizer", default="")
    p.add_argument("--csv", default="", help="per-sample CSV output (mrg)")
    p.add_argument("--max-samples", type=int, default=0)
    p.add_argument("--do-sample", action="store_true",
                   help="sample instead of greedy (HF generate's knobs; "
                        "the reference harnesses default to greedy)")
    p.add_argument("--temperature", type=float, default=1.0)
    p.add_argument("--top-p", type=float, default=None)
    p.add_argument("--gen-seed", type=int, default=0,
                   help="base seed for --do-sample")
    p.add_argument("--spec-decode", action="store_true",
                   help="prompt-lookup speculative decoding (lossless "
                        "greedy, fewer forwards; eval/speculative.py)")
    p.add_argument("--draft-len", type=int, default=7,
                   help="spec-decode draft window (tokens verified/round)")
    p.add_argument("--engine", action="store_true",
                   help="generate through the continuous-batching "
                        "ServingEngine (composes with --spec-decode for "
                        "in-engine speculation; greedy-only)")
    p.add_argument("--engine-slots", type=int, default=8)
    p.add_argument("--engine-vol-cache", type=int, default=0,
                   help="with --engine: LRU size for per-volume image-"
                        "feature caching (repeated volumes skip the towers)")
    p.add_argument("--engine-kv-prefix-cache", type=int, default=0,
                   help="with --engine: LRU size for per-volume KV-prefix "
                        "caching (repeat questions skip the towers AND "
                        "the BOS+image-block share of the LLM prefill)")
    p.add_argument("--kv-int8", action="store_true",
                   help="int8 KV cache (per-token/head absmax scales)")
    p.add_argument("--dp", type=int, default=1,
                   help="data-parallel replicas (torchrun's processes)")
    p.add_argument("--tp", type=int, default=1,
                   help="tensor-parallel LLM shards")
    args = p.parse_args(argv)
    if args.task == "retrieval" and not args.synthetic:
        raise NotImplementedError(
            "--task retrieval needs --synthetic: the JAX CLI builds no model "
            "configuration without it (ROADMAP §C)")

    from hsenet_torch import resolve_device
    from hsenet_torch.cli.common import (
        build_vlm_config,
        random_model,
        restore_checkpoint,
    )
    from hsenet_torch.configs import MeshConfig
    from hsenet_torch.parallel.mesh import (
        create_mesh,
        init_distributed,
        is_main_process,
    )
    from hsenet_torch.data.datasets import (
        SPECIAL_TOKENS,
        DataArgs,
        DataLoader,
        SimpleTokenizer,
        SyntheticCTDataset,
    )

    device = resolve_device(device)
    max_samples = args.max_samples or None
    init_distributed(device)
    mesh = create_mesh(MeshConfig(dp=args.dp, tp=args.tp), device=device)
    main_rank = is_main_process()

    if args.task == "retrieval":
        from hsenet_torch.eval.retrieval import clip_retrieval_eval
        from hsenet_torch.models.clip import CLIPModel

        cfg = _tiny_clip_cfg()
        tokenizer = SimpleTokenizer(vocab_size=cfg.text.vocab_size)
        ds = SyntheticCTDataset(
            n=16, shape=(1, *cfg.vision.image_size), tokenizer=tokenizer,
            mode="clip", args=DataArgs(max_text_len=16),
        )
        if model is None:
            from hsenet_torch.models import init_random_

            model = CLIPModel(cfg, dtype=torch.float32, device=device)
            init_random_(model, torch.Generator(device=device).manual_seed(0))
        if args.checkpoint:
            restore_checkpoint(model, args.checkpoint)
        metrics = clip_retrieval_eval(
            model, DataLoader(ds, batch_size=8, shuffle=False), ks=(1, 5, 10),
        )
        print(json.dumps(metrics, indent=2))
        return metrics

    if args.task == "seg":
        metrics = _evaluate_seg(args, p, device, model, max_samples)
        print(json.dumps(metrics, indent=2))
        return metrics

    from hsenet_torch.models.mllm import HSENetVLM

    max_new = args.max_new_tokens or (512 if args.task == "mrg" else 74)
    cfg = build_vlm_config(argparse.Namespace(synthetic=args.synthetic))
    tokenizer = SimpleTokenizer(vocab_size=cfg.llm.vocab_size)
    tokenizer.add_special_tokens({"additional_special_tokens": SPECIAL_TOKENS})
    data_args = DataArgs(
        data_root=args.data_root,
        max_length=96 if args.synthetic else 800,
        proj_out_num=cfg.num_image_tokens,
    )
    if args.synthetic:
        max_new = min(max_new, 8)
        ds = SyntheticCTDataset(
            n=4, shape=(1, *cfg.vision.image_size), tokenizer=tokenizer,
            mode="caption", args=data_args,
            num_slices=cfg.vision.num_slices,
            slice_dim=cfg.vision.slice_feature_dim,
        )
    elif args.task == "mrg":
        from hsenet_torch.data.datasets import CaptionDataset

        ds = CaptionDataset(data_args, tokenizer, args.manifest, args.split)
    elif args.task == "rec":
        from hsenet_torch.data.datasets import PosRECDataset

        ds = PosRECDataset(data_args, tokenizer, args.manifest, args.split)
    else:
        from hsenet_torch.data.datasets import VQALocationDataset

        ds = VQALocationDataset(data_args, tokenizer, args.manifest, args.split)
    loader = DataLoader(
        ds, batch_size=min(args.batch_size, len(ds)), shuffle=False,
        drop_remainder=False,
    )
    dtype = torch.float32 if args.synthetic else torch.bfloat16
    if model is None:
        model = random_model(HSENetVLM, cfg, dtype=dtype, device=device, seed=0)
    if args.checkpoint:
        restore_checkpoint(model, args.checkpoint)
    if mesh is not None:
        from hsenet_torch.parallel.sharding import shard_params

        shard_params(model, mesh)

    cache_dtype = torch.int8 if args.kv_int8 else dtype
    gen_kwargs = dict(
        max_new_tokens=max_new, eos_token_id=tokenizer.eos_token_id,
        pad_token_id=tokenizer.pad_token_id, cache_dtype=cache_dtype,
    )
    if args.engine:
        from hsenet_torch.serving import ServingEngine, engine_generate_fn

        if args.do_sample:  # the JAX CLI's asserts
            raise AssertionError("--engine eval is greedy-only")
        if args.dp > 1:
            raise AssertionError(
                "--engine shards tensor-parallel only (--tp); for dp-style "
                "scaling run one engine per replica")
        eng = ServingEngine(
            model,
            eos_token_id=tokenizer.eos_token_id,
            pad_token_id=tokenizer.pad_token_id,
            num_slots=args.engine_slots,
            prompt_cap=data_args.max_length,
            max_new_tokens=max_new,
            cache_dtype=cache_dtype,
            multimodal=True,
            speculative=args.spec_decode, draft_len=args.draft_len,
            volume_cache_size=args.engine_vol_cache,
            kv_prefix_cache_size=args.engine_kv_prefix_cache,
            mesh=mesh,
            device=device,
        )
        gen = engine_generate_fn(eng)
    elif args.spec_decode:
        from hsenet_torch.eval.speculative import make_pld_generate

        if args.do_sample:  # the JAX CLI's assert
            raise AssertionError("--spec-decode is greedy-only (lossless)")
        gen = make_pld_generate(model, draft_len=args.draft_len, **gen_kwargs)
    else:
        from hsenet_torch.eval.generate import make_greedy_generate

        gen = make_greedy_generate(
            model, do_sample=args.do_sample, temperature=args.temperature,
            top_p=args.top_p, **gen_kwargs,
        )
    if not args.engine and mesh is not None:
        from hsenet_torch.eval.generate import make_data_parallel_generate

        # inside the sampling fold below, so it sees each call's seed
        gen = make_data_parallel_generate(gen, mesh)
    if args.do_sample:
        # a fresh fold of one base seed per generate call: every batch
        # samples independently and the run stays reproducible (--gen-seed)
        import itertools

        from hsenet_torch.eval.generate import fold_seed

        counter = itertools.count()
        inner_gen = gen

        def gen(*a, **kw):
            return inner_gen(*a, rng=fold_seed(args.gen_seed, next(counter)),
                             **kw)
    if args.task == "rec":
        import numpy as np

        from hsenet_torch.eval.segmentation import evaluate_rec

        if args.synthetic:
            # the synthetic caption batches carry no gold boxes; fixed ones
            # run the IoU path end to end, as in the JAX CLI
            def _with_boxes(it):
                for b_ in it:
                    b_ = dict(b_)
                    b_["box"] = [
                        np.asarray([0.1, 0.1, 0.1, 0.6, 0.6, 0.6], np.float32)
                        for _ in range(len(b_["input_ids"]))
                    ]
                    yield b_

            loader = _with_boxes(loader)
        metrics = evaluate_rec(
            gen, loader, tokenizer, max_samples=max_samples,
            reference_compatible=args.reference_compatible, device=device,
        )
    elif args.task == "mrg":
        from hsenet_torch.eval.mrg import evaluate_mrg

        metrics = evaluate_mrg(
            gen, loader, tokenizer,
            csv_path=(args.csv or None) if main_rank else None,
            max_samples=max_samples, device=device,
        )
    else:
        from hsenet_torch.eval.vqa import evaluate_vqa

        metrics = evaluate_vqa(gen, loader, tokenizer, max_samples=max_samples,
                               device=device)
    if main_rank:
        print(json.dumps(metrics, indent=2, default=str))
    return metrics


if __name__ == "__main__":
    main()
