"""Online serving entry point: continuous batching over the VLM or the
bare LLM (the port of the JAX package's cli/serve.py), built on
`hsenet_torch.serving.ServingEngine`.

    # smoke test, no data needed (tiny VLM, random requests), on the card
    python -m hsenet_torch.cli.serve --synthetic --num-requests 6
    # the same on a host without a card: `main` takes `device="cpu"`, like
    # every entry point of the port
    python -c "from hsenet_torch.cli.serve import main; \
        main(['--synthetic', '--num-requests', '6'], device='cpu')"

    # full width with int8 weights (random weights from --seed), requests
    # as JSONL {id, prompt_ids, max_new, volume, slice_features}
    python -m hsenet_torch.cli.serve --quant-int8 --requests req.jsonl \
        --output out.jsonl --slots 8 --chunk 16

    # prompt-lookup speculative decoding: a chunk is --chunk verify rounds
    # of --draft-len drafted tokens each (lossless: the greedy tokens)
    python -m hsenet_torch.cli.serve --quant-int8 --llm-only --synthetic \
        --speculative --draft-len 7 --ngram 2

    # a converted checkpoint (python -m hsenet_torch.cli.convert_checkpoint
    # --kind phi3 --quant-int8 ...) served by the bare decoder
    python -m hsenet_torch.cli.serve --quant-int8 --llm-only \
        --checkpoint phi3_int8.pt --requests req.jsonl

    # sampling (temperature, nucleus top-p), reproducible from --gen-seed;
    # with --speculative it is exact speculative sampling
    python -m hsenet_torch.cli.serve --quant-int8 --synthetic --do-sample \
        --temperature 0.7 --top-p 0.9 --gen-seed 3 [--speculative]

`volume` / `slice_features` are .npy paths; omit them with --llm-only to
serve the bare decoder. --quant-int8 holds the LLM's projections and
embedding as int8 codes, the tiny `--llm-only --synthetic` decoder's too
(where the JAX CLI keeps it float, ROADMAP §C), whose f32 calls run the
matvec's f32 route. Weights are random, drawn from --seed, unless
--checkpoint names a `utils.checkpoint.save_params` file of the model's
keys and shapes. --gen-seed seeds the port's own random stream
(`eval.generate.fold_seed`): one seed gives one token stream per device,
none equal to the JAX CLI's.

    # tensor-parallel over two cards: the LLM split by the Megatron rules,
    # the KV cache by kv heads; rank 0 reads --requests and writes --output
    torchrun --nproc-per-node 2 -m hsenet_torch.cli.serve --quant-int8 \
        --tp 2 --requests req.jsonl --output out.jsonl
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch


def main(argv=None, *, device="cuda"):
    """Serve the requests `argv` describes and print a JSON summary. Runs
    on the CUDA card unless the caller passes `device="cpu"`, where every
    kernel is replaced by its plain version."""
    p = argparse.ArgumentParser()
    p.add_argument("--synthetic", action="store_true",
                   help="tiny VLM + random requests (smoke test)")
    p.add_argument("--llm-only", action="store_true",
                   help="serve the bare decoder (no vision side)")
    p.add_argument("--checkpoint", default="",
                   help="params file (utils.checkpoint.save_params) of the "
                        "model the other flags build")
    p.add_argument("--quant-int8", action="store_true",
                   help="int8 projections + embedding (the --llm-only "
                        "--synthetic decoder's too)")
    p.add_argument("--requests", default="",
                   help="JSONL requests: {id, prompt_ids, max_new, "
                        "volume?, slice_features?}; volume (.npy path) is "
                        "required per request unless --llm-only; combines "
                        "with --synthetic (tiny model, your requests)")
    p.add_argument("--output", default="", help="JSONL responses path")
    p.add_argument("--num-requests", type=int, default=8,
                   help="synthetic request count")
    p.add_argument("--distinct-volumes", type=int, default=0,
                   help="synthetic multimodal traffic: cycle requests over "
                        "this many distinct volumes (0 = all distinct); "
                        ">0 makes --vol-cache / --kv-prefix-cache hit")
    p.add_argument("--slots", type=int, default=8)
    p.add_argument("--chunk", type=int, default=16,
                   help="decode steps per host synchronisation; admission "
                        "happens at chunk boundaries")
    p.add_argument("--prompt-cap", type=int, default=512)
    p.add_argument("--max-new-tokens", type=int, default=512)
    p.add_argument("--eos-token-id", type=int, default=2)
    p.add_argument("--pad-token-id", type=int, default=0)
    p.add_argument("--tp", type=int, default=1,
                   help="tensor-parallel shards (serve over a tp mesh of "
                        "torchrun's processes)")
    p.add_argument("--do-sample", action="store_true",
                   help="sample instead of greedy (temperature + top-p)")
    p.add_argument("--temperature", type=float, default=1.0)
    p.add_argument("--top-p", type=float, default=None)
    p.add_argument("--gen-seed", type=int, default=0,
                   help="seed of the sampling stream for --do-sample")
    p.add_argument("--speculative", action="store_true",
                   help="prompt-lookup speculative decoding (lossless; "
                        "the chunk becomes verify rounds; with --do-sample "
                        "exact speculative sampling)")
    p.add_argument("--draft-len", type=int, default=7)
    p.add_argument("--ngram", type=int, default=2)
    p.add_argument("--kv-int8", action="store_true",
                   help="int8 KV cache (per-token/head absmax scales)")
    p.add_argument("--vol-cache", type=int, default=0,
                   help="LRU size for per-volume image-feature caching "
                        "(multimodal only): repeated volumes skip the "
                        "vision towers at admission")
    p.add_argument("--kv-prefix-cache", type=int, default=0,
                   help="LRU size for per-volume KV-prefix caching "
                        "(multimodal only): repeat questions about one "
                        "volume skip the towers AND the BOS+image-block "
                        "share of the LLM prefill")
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)
    if args.vol_cache and args.llm_only:
        p.error("--vol-cache caches image features; it requires the "
                "multimodal engine (drop --llm-only)")
    if args.kv_prefix_cache and args.llm_only:
        p.error("--kv-prefix-cache caches the image-block KV; it requires "
                "the multimodal engine (drop --llm-only)")

    from hsenet_torch import resolve_device
    from hsenet_torch.cli.common import (
        build_vlm_config,
        int8_serving_config,
        random_model,
        restore_checkpoint,
    )
    from hsenet_torch.configs import MeshConfig
    from hsenet_torch.parallel.mesh import (
        broadcast_object,
        create_mesh,
        init_distributed,
        is_main_process,
    )
    from hsenet_torch.serving import ServingEngine

    device = resolve_device(device)
    mesh = None
    if args.tp > 1:
        init_distributed(device)
        mesh = create_mesh(MeshConfig(dp=1, tp=args.tp), device=device)
    main_rank = is_main_process()
    rng = np.random.default_rng(args.seed)
    dtype = torch.float32 if args.synthetic else torch.bfloat16

    if args.llm_only:
        from hsenet_torch.configs import Phi3Config
        from hsenet_torch.models.phi3 import Phi3ForCausalLM

        quant = dict(quant_int8=args.quant_int8,
                     quant_int8_embed=args.quant_int8)
        if args.synthetic:
            cfg = Phi3Config(
                vocab_size=512, hidden_size=64, intermediate_size=128,
                num_layers=2, num_heads=4, num_kv_heads=2, head_dim=16,
                tie_word_embeddings=True, **quant,
            )
        else:
            cfg = Phi3Config(**quant)
        model = random_model(Phi3ForCausalLM, cfg, dtype=dtype, device=device,
                             seed=args.seed)
        vocab = cfg.vocab_size
        multimodal = False
    else:
        from hsenet_torch.models.mllm import HSENetVLM

        cfg = build_vlm_config(args)
        if not args.synthetic and args.quant_int8:
            cfg = int8_serving_config(cfg)
        model = random_model(HSENetVLM, cfg, dtype=dtype, device=device,
                             seed=args.seed)
        n_img = cfg.num_image_tokens
        vocab = cfg.llm.vocab_size
        multimodal = True
    if args.checkpoint:
        restore_checkpoint(model, args.checkpoint)

    eng = ServingEngine(
        model,
        eos_token_id=args.eos_token_id,
        pad_token_id=args.pad_token_id,
        num_slots=args.slots,
        prompt_cap=args.prompt_cap,
        max_new_tokens=args.max_new_tokens,
        chunk_size=args.chunk,
        cache_dtype=torch.int8 if args.kv_int8
        else (torch.float32 if args.synthetic else torch.bfloat16),
        multimodal=multimodal,
        do_sample=args.do_sample,
        temperature=args.temperature,
        top_p=args.top_p,
        rng=args.gen_seed if args.do_sample else None,
        speculative=args.speculative,
        draft_len=args.draft_len,
        ngram=args.ngram,
        volume_cache_size=args.vol_cache if multimodal else 0,
        kv_prefix_cache_size=args.kv_prefix_cache if multimodal else 0,
        mesh=mesh,
        device=device,
    )

    # ---- build the request list ----
    id_of = {}
    if args.synthetic and not args.requests:
        n_vols = args.distinct_volumes or args.num_requests
        vols = [
            (
                rng.standard_normal(
                    (1, 1, *cfg.vision.image_size)
                ).astype(np.float32),
                rng.standard_normal(
                    (1, cfg.vision.num_slices, cfg.vision.slice_feature_dim)
                ).astype(np.float32),
            )
            for _ in range(min(n_vols, args.num_requests))
        ] if multimodal else []
        for i in range(args.num_requests):
            n_text = int(rng.integers(2, 8))
            if multimodal:
                ids = rng.integers(3, vocab, size=1 + n_img + n_text)
                ids[0] = 1
                # repeated placeholder block, as the datasets lay it out
                # (byte-identical prefix -> the KV-prefix cache can hit)
                ids[1 : 1 + n_img] = 4
                vol, sl = vols[i % len(vols)]
                uid = eng.submit(
                    ids,
                    max_new=int(rng.integers(4, args.max_new_tokens + 1)),
                    volume=vol,
                    slice_features=sl,
                )
            else:
                ids = rng.integers(3, vocab, size=4 + n_text)
                uid = eng.submit(
                    ids, max_new=int(rng.integers(4, args.max_new_tokens + 1))
                )
            id_of[uid] = f"synthetic-{i}"
    else:
        if not args.requests:
            p.error("--requests JSONL required (or --synthetic)")
        # rank 0 reads the requests (and their arrays); every rank submits
        # the same list in the same order
        reqs = _read_requests(args.requests, multimodal) if main_rank else None
        for name, ids, max_new, kw in broadcast_object(reqs):
            uid = eng.submit(ids, max_new=max_new, **kw)
            id_of[uid] = name if name is not None else str(uid)

    # ---- serve ----
    out_f = open(args.output, "w") if args.output and main_rank else None
    t0 = time.perf_counter()
    finished = 0
    total_tokens = 0
    while eng.pending or eng.active:
        for uid, tokens in eng.step().items():
            finished += 1
            total_tokens += len(tokens)
            if out_f is not None:
                out_f.write(
                    json.dumps({"id": id_of[uid], "tokens": tokens}) + "\n"
                )
                out_f.flush()
    wall = time.perf_counter() - t0
    if out_f is not None:
        out_f.close()

    summary = {
        "requests": finished,
        "tokens": total_tokens,
        "wall_s": round(wall, 2),
        "tok_per_s": round(total_tokens / wall, 1) if wall else 0.0,
        "slot_utilization": round(eng.utilization, 3),
        "slots": args.slots,
        "tp": args.tp,
    }
    if args.speculative:
        summary["mean_committed_per_round"] = round(eng.mean_accepted, 2)
    if args.vol_cache:
        summary["encode_hits"] = eng.encode_hits
        summary["encode_misses"] = eng.encode_misses
    if args.kv_prefix_cache:
        summary["prefix_hits"] = eng.prefix_hits
        summary["prefix_misses"] = eng.prefix_misses
    summary.update({
        f"latency_{k}": round(v, 3) for k, v in eng.latency_stats().items()
    })
    if main_rank:
        print(json.dumps(summary))
    return summary


def _read_requests(path: str, multimodal: bool):
    """[(id, prompt ids, max_new, submit kwargs)] of a JSONL request file,
    the .npy arrays it names loaded."""
    out = []
    with open(path) as f:
        for line in f:
            if not line.strip():
                continue
            req = json.loads(line)
            kw = {}
            if multimodal:
                if not req.get("volume"):
                    raise SystemExit(
                        f"request {req.get('id', '?')}: 'volume' is "
                        "required when serving a VLM; use --llm-only "
                        "for text-only requests"
                    )
                kw["volume"] = np.load(req["volume"])
                if req.get("slice_features"):
                    kw["slice_features"] = np.load(req["slice_features"])
            out.append((req.get("id"), np.asarray(req["prompt_ids"], np.int32),
                        req.get("max_new"), kw))
    return out


if __name__ == "__main__":
    main()
