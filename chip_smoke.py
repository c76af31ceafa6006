#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (hsenet_torch) on one NVIDIA card.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with a CUDA card and nvcc.
In order:

1. prints the card's name and power limit (nvidia-smi);
2. builds every kernel of the port from `hsenet_torch/csrc/` with nvcc,
   one nvcc per source, all started at once;
3. [kernel] holds the forward kernel (flash_fwd_wgmma: wgmma, TMA, a
   producer warpgroup) against its plain PyTorch version on
   the card, in bf16, at the shapes the paths give it (towers, prefill,
   the LLM training shape with its log-sum-exp output, and the serving
   engine's admissions: 512 rows over a 1040-slot cache row, a KV-prefix
   hit's 255 rows at offset 257, and 512 rows over the 2576-slot row of an
   engine with a 2048-token output budget, where the TPU streams K/V), and
   times the kernel, the plain version and one PyTorch library call
   computing the same function (a yardstick only: the port never calls
   it); the time over the 2576-slot row must not exceed 1.5 times the
   time over the 1040-slot row at the same kv_len; beside each time the
   old mma.sync kernel's (flash_fwd.cu's bf16 build, which no path
   launches) and the time at the other query tile; then the same checks
   off the paths for C2: f16 at head dims 64 and 128, head dim 256 in bf16
   and f16 and the padded head dim 160, and ragged edge cases in bf16 and
   f16 at head dims 64, 160 and 256; every path phase below checks that
   each bf16 forward launch went through flash_fwd_wgmma;
3a. [kernel] at the BiomedCLIP 2D trunk's shapes (ViT2D: 197 tokens, 12
   heads of 64, non-causal, no log-sum-exp, every launch with a ragged
   last tile): 32 x 12 and 64 x 12, checked beside 64 dropped keys and
   timed like the shapes above;
3b. [ct-data] writes NIfTI volumes at chest-CT size from a numpy seed (a
   gzipped int16 (300, 512, 512) at (0.7, 0.7, 1.0) mm with intercept
   -1024, a plain (24, 512, 512) at 5 mm whose intercept comes from a
   metadata CSV) and runs `preprocess_ct.main` on the card, by default with
   --slices (the 24-deep volume takes the slice path's z-upsample) and with
   --faithful --slices, decoding with the native reader where it builds
   (else says so and reads in Python); holds every output against the same
   functions on the CPU (1e-5; the faithful slices 1e-4 where their uint8
   codes agree, codes one apart at a rounding edge in at most 1e-4 of
   them) and the faithful volumes against the numpy
   `reference_preprocess` (2e-5 beyond 1e-4 of the value); prints the decode's MB/s and, at
   (300, 512, 512), the wall, vol/s, device busy time and idle share of
   `preprocess_volume`, `preprocess_volume_faithful`, `extract_slices` and
   `preprocess_batch` at batch 8;
3c. [vit2d] converts a seeded open_clip BiomedCLIP trunk (ViT-B/16, drawn
   on the card) with `convert_checkpoint --kind biomedclip` and runs
   `preprocess_ct --vit2d-checkpoint` on those volumes: (32, 768) features
   per volume, 12 B1 launches per volume at 32 x 12 x 197 x 64, all on
   flash_fwd_wgmma; the features against a direct `ViT2D` call on the
   slices and against the plain attention path (relative L2 5e-2); the
   trunk's time per volume and a profile;
4. [kernel-bwd] holds the bf16 backward kernel (flash_bwd: dQ, dK and dV,
   wgmma/TMA) against its plain version at the LLM training shape (3 x 24
   heads x 800 tokens, d 128, causal, kv_lens 800/700/560) and the tower
   shape (2 x 12 x 2049, d 64), each error a share of its row's largest
   value; shows that versions with delta left out, the last valid key tile
   dropped or the diagonal tile dropped miss the limit, that keys past
   kv_len and a row with kv_len 0 get exactly zero gradients, and how far
   dQ moves between two runs (its f32 adds land in another order); and
   times it against the bound, the plain version, the backward of one SDPA
   call and the two mma.sync kernels it replaced (their bf16 build, which
   no path launches); then f16 (flash_bwd) and head dim 256 in bf16 and f16
   (the mma.sync pair, each timed in turns beside the wide route's kernel,
   which is checked there too), edge cases and planted faults alike;
4w. [kernel-wide] the wide route of the flash kernels (ROADMAP C2, closed:
   bf16 and f16 above head dim 256, f32 above 128, padded to a multiple of
   64; the `_wide` entries of flash_fwd.cu, flash_bwd_dq.cu and
   flash_bwd_dkv.cu) at d 320 and 512 in bf16, f16 and f32, at 192 and
   256 in f32, and at d 300 in bf16 and 200 in f32 (zero-padded to 320 and
   256), on small grids: forward, log-sum-exp and dQ/dK/dV against
   the plain versions, edge cases (Skv 0, a kv_len-0 row, causal offsets),
   two planted faults that must miss (S over the first 256 columns, 128 in
   f32 below 320; the last 64 valid keys dropped), every launch counted on
   the wide kernels; times beside the bound, the plain version and SDPA;
4a. [cli-serve] runs the serving CLI's documented examples on the card
   (`--synthetic --num-requests 6`; `--quant-int8 --llm-only --synthetic
   --speculative`): tiny f32 models with head dims 8 and 16, so every flash
   launch is f32 at the padded width 64; every request must finish; B5's
   launches counted by entry (none may reach the tensor-core entry: the
   models compute in f32; the second one's int8 projections take the
   CUDA-core entry where a call has at most 8 rows, where the JAX CLI keeps
   that decoder float);
4b. [train-f32] the VLM finetune step at the same `--synthetic`
   configuration in f32: 8 forward, 2 dQ and 2 dK/dV f32 launches a step;
4c. [kernel-f32] holds the f32 route of the forward (with and without the
   log-sum-exp), dQ and dK/dV, through the head-dim padding, against the
   f32 plain versions at the shapes those paths launched, QFormer's head
   dim 96 and the CLIP tower (2 x 12 x 2049 x 64): 5e-3 of the largest
   value of each (batch, head) slice (TF32 products), beside versions with
   the softmax scale of the padded width and without the last 64 valid keys
   that must miss; times against the bound at the TF32 peak, the plain
   version and f32 SDPA;
5. [kernel-matvec] holds B5's tensor-core entry (hsenet_quant_matvec_mma:
   mma.sync bf16 products of codes converted in registers, cp.async rings,
   K slices over a CTA's warps) against its plain version in bf16 at
   Phi-4-mini's four projection shapes, a ragged shape (K 3088 x N 1000)
   and the `--synthetic` shapes (K 64 x N 32, K 128 x N 64), each at M 1, 2,
   3, 5 and 8, beside two wrong variants that must miss the limit, two
   launches bit-equal; the CUDA-core entry (hsenet_quant_matvec_fma, the f32
   route and the yardstick) likewise in f32 at the synthetic shapes; the
   dispatcher's route by dtype; then at the four path shapes, M = 8 and M
   = 1, with the codes read cold, times both entries in turns beside the
   bound, the plain version, a bf16 matmul on a converted copy and
   `torch._weight_int8pack_mm` where the card's PyTorch has a CUDA kernel
   for it (both library calls yardsticks only), and the tensor-core entry
   at the LM head's 3072 x 200064 table (off the path) beside its plain
   version and the same two library calls;
5a. [kernel-pv] holds the P.V probe kernel (B6: int8_pv_wgmma, TMA and
   wgmma, and the mma.sync int8_pv it replaced, kept as its yardstick)
   against its plain version in its four modes at the JAX probe's shapes
   (G 192, M 1152, K 2176, N 64) and int8_pv_wgmma at M 1000 (off its row
   tiles): the integer modes bit-equal, bf16 within 1e-4 of each row's
   largest value, beside versions with the last 32 of K dropped (and P
   quantised at 128) that must miss; times both kernels in turns beside
   the bound, the plain version and, for bf16, one torch.bmm;
   int8_pv_wgmma must not be slower than 1.05 times the yardstick in any
   mode; then drives the probe entry (`python -m
   hsenet_torch.scripts.probe_int8_pv`) with launches counted by kernel;
5b. [encode-w8a8] the W8A8 serving encode of bench.py at full width,
   batch 8 (both towers with static activation scales calibrated on 2
   volumes and tanh GELU, two packers, random weights quantised on the
   card) against the bf16/erf encode of the same weights: per-token
   cosine of the tower features beside two wrong variants, 24 flash
   launches an encode, vol/s of both, a profile of each;
6. [main] drives generation at the full width of `VLMConfig()` (dual ViT-B
   towers, two packers, Phi-4-mini with 32 layers, vocab 200064) with
   random bf16 weights drawn on the card from a seeded generator: B=2
   prompts of BOS + 256 image tokens + text (valid lengths 300 and 320)
   through `make_greedy_generate` for 32 new tokens. It checks that the
   flash kernel ran exactly 24 (towers) + 32 (prefill) times, that logits
   are finite and tokens inside the vocabulary, and that prefill logits
   through the kernel agree with those of the plain sdpa path (and that
   a kernel without the last 64 keys of each row would not);
7. [train] runs the VLM LoRA finetune at the configuration of the JAX
   package's `cli/train_vlm.py` (`VLMConfig()` with LoRA r16/a32 on the
   LLM, f32 trainable masters over a bf16 base, towers frozen, remat on)
   through `Trainer` and `make_vlm_train_step`: batch 3 of BOS + 256 image
   tokens + report, right-padded to 800 tokens (valid 800, 700, 560), 2
   warm-up and 6 timed steps on that one batch. It prints step ms, tokens/s,
   peak memory and each step's loss (which must fall), profiles one step,
   and checks the flash launches per step: 24 forward d64 (towers), 64
   forward d128 with the log-sum-exp (32 layers, twice under remat), 32 dQ
   and 32 dK/dV;
8. [train-grads] one step's gradients through the kernels against the same
   step through the plain sdpa path, as relative L2 per group of leaves,
   and shows that steps with a planted fault in the attention backward
   (delta left out; no gradient through attention) miss the limit;
8a. [cli-evaluate] runs the evaluation CLI (`hsenet_torch.cli.evaluate.main`)
   at the full width of `build_vlm_config` (`VLMConfig()` with LoRA r16 on
   Phi-4-mini) in bf16, random weights from seed 0, one model passed to
   every run through `model=`, on manifests the script writes to a
   temporary directory (4 caption entries, and 2 volumes x 2 location
   questions; volumes (1, 32, 256, 256), slice features (32, 768), from a
   numpy seed): `--task mrg --batch-size 2 --max-new-tokens 32 --csv`
   through greedy generation, `--engine` and `--spec-decode`, then `--task
   vqa --engine --engine-vol-cache 2`. Each route's ids must equal the
   greedy route's or part only at a near-tie (NEAR_TIE_SHARE on f32
   logits); the CSV's running means must equal the returned means; B1 must
   run at the tower (d 64) and LLM prefill (d 128) widths in every run, and
   the VQA towers once per volume. Prints wall time and reports/min of each
   route and a profile of the greedy one on one batch of 2 reports and 4
   new tokens (the profiler's processing of the whole route's events took
   minutes); [kernel-eval] then holds
   flash_fwd_wgmma against its plain version at every shape those runs
   launched (beside a dropped key tile that must miss) and times it;
8b. [ckpt] `save_vlm_deltas` of that model (its LoRA, packer and token-table
   leaves moved first) and `load_vlm_deltas` into a fresh model of the same
   seed: greedy tokens must differ before the load and equal the
   original's after; bytes and seconds printed. Then `convert_checkpoint
   --kind phi3 --quant-int8` of HF Phi-3 tensors at the serving CLI's
   `--synthetic` widths, served by `serve --quant-int8 --llm-only
   --synthetic --checkpoint`: every request finishes, the tokens differ
   from the random weights', and B5's CUDA-core entry (f32) runs on every
   decode step, checked and timed at that model's four shapes;
9. [serve] drives the serving engine at the full width the serving CLI
   builds for `--quant-int8` (`VLMConfig()` with int8 projections and
   embedding in Phi-4-mini, no LoRA, towers and packers in bf16; random
   bf16 weights quantised on the card) and at the CLI's defaults (8 slots,
   chunks of 16, prompt cap 512, 512 new tokens, bf16 KV cache of 1040
   slots a row, feature LRU and KV-prefix LRU of 4): 12 requests over 4
   scans closed loop, then 8 more through `run_open_loop`. It checks that
   every request finishes with tokens in the vocabulary, the hit and miss
   counts, flash_fwd launches = 24 per encode miss + 32 per admission and
   quant_matvec launches = 224 per decode step, all on B5's tensor-core
   entry (none on the CUDA-core entry); prints tokens/s, slot
   utilization, TTFT and TPOT, peak memory and `hbm_stats()`; holds one
   decode step's logits through the matvec kernel against the same step
   through its plain version, and a prefix hit's first-token logits
   against a full prefill of the same request, each beside a wrong variant;
10. [serve-kv-int8] the same engine with the int8 KV cache: 4 requests, two
   of them prefix hits, and first-token logits against the bf16 cache;
11. [serve-long] an engine with a 2048-token budget (rows of 2576 slots,
   2 slots, two requests), launches counted; then [profile]s of one
   admission that misses, one that hits the prefix cache and one decode
   chunk with 8 live slots;
11a. [serve-spec] the engine with speculative=True (drafts of 7 from
   2-grams) on [serve]'s 12 closed-loop requests and, with the int8 KV
   cache, on [serve-kv-int8]'s 4: tokens/s, mean_accepted, TTFT and TPOT
   beside [serve]'s, flash launches counted, tokens against the greedy
   engine's (where they part, greedy's top-2 logit margin must be a
   near-tie);
11b. [spec] prompt-lookup decoding at batch 1 on the same Phi-4-mini
   (int8 projections and embedding) against greedy decoding: a 320-token
   prompt of one repeated phrase, 64 new tokens; rounds, mean committed
   per round, tokens/s of both, 224 matvec launches per verify round (8
   rows each), first with the random weights, then with constant weights
   that accept every draft (the ceiling bench.py measures);
11c. [serve-sample] the [serve] engine with do_sample=True on [serve]'s 12
   closed-loop requests: a one-token nucleus (top-p 1e-9) gives the greedy
   engine's tokens request for request, and with speculative=True the
   greedy speculative engine's; T 0.7 / top-p 0.9 twice with one seed gives
   equal tokens, another seed other tokens; every token in the vocabulary
   and its budget; B1 and B5 launches counted as in [serve]; tokens/s,
   TTFT and speculative sampling's mean_accepted beside greedy
   speculation's;
11d. [sample] the sampler (`warp_logits`, then a Gumbel-max draw) at 8 x
   200,064 and 8 x 128,256 seeded peaked logits: 81,920 draws a row over
   folded seeds, each token's frequency within 0.01 of the exact law above
   p 1e-3 (and the rest's mass), none outside the nucleus, one seed twice
   equal, a one-token nucleus the argmax; the device time of the warp and
   one draw with and without top-p 0.9; [spec-law] `pld_round(sample=)`
   against a constant target, each token within 0.03 of softmax(logits /
   T); [cli-sample] `evaluate --task mrg --synthetic --do-sample` and
   `serve --synthetic --do-sample [--speculative]` through `main(argv,
   device="cuda")`;
11e. [llama] `LlamaForCausalLM(LlamaConfig(quant_int8=True))` at
   Llama-3-8B's width and depth, built layer by layer from a seeded
   HF-layout state dict (`convert_hf_llama_layer`, `quantize_kernels_int8`)
   with its peak memory: the greedy, speculative and sampled engines (8
   slots, 8 prompts of 20-200 tokens): B1 32 launches an admission, B5 224
   a decode step on the tensor-core entry; greedy tokens against the plain
   path (every kernel replaced by its plain version), where they part the
   two tokens' logits, replayed as the engine decodes, within the near-tie
   limit; the speculative engine's partings from greedy printed; a decode
   chunk profiled; `convert_checkpoint --kind llama --quant-int8` of a
   file at full width and depth 2, its output served at one slot (B5 at M
   = 1); [kernel-llama] B5 at Llama's four (K, N), held at M 1-8 beside
   the wrong variants and timed at M = 8 and 1 with the codes cold, and B1
   at the engine's admission shape, beside bound, plain and library;
11f. [variants] full-width VLMs (towers at full depth, the LLM at 4
   layers) with projector spatial_pooling, mlp and qformer and tower_mode
   med2e3: two volumes through prefill, 8 greedy and 8 sampled tokens,
   launches by shape held (QFormer's 4 attentions a projector at head dim
   96), prefill logits within 5e-2 of the plain sdpa path, med2e3 served
   through the engine without caches; QFormer's B1 shapes checked and
   timed;
11g. [export] the exports and tools, on the models of [main] and [serve]
   (no new model is built for it): `export_encode` of [main]'s bf16
   `HSENetVLM(VLMConfig())` at batch 2 right after [main] (the towers' and
   packers' weights passed as the params dict), and, after [serve-sample]
   and before [spec], `export_greedy_decode` of [serve]'s int8 Phi-4-mini at
   [main]'s prompts (2 x 320, kv (300, 320)) and 16 new tokens; each
   artifact is saved and then loaded and called in a child process that
   imports torch, the kernels' operators and the loader only and fails if
   `hsenet_torch.models` (or JAX) was imported. It checks the op nodes in
   both graphs (24 `hsenet_torch.flash_fwd` in the encode, 32 in the
   prefill, 224 `hsenet_torch.quant_matvec` in the decode step), no weight
   inside any program, the child's launches equal to the live calls' (B1
   24 and 32, B5 224 a decode step), the features within B1's row
   tolerance of the live encode's and the tokens equal to the live
   generate's or parting at a near-tie; prints export, load and call times
   against eager, the artifacts' bytes, the encode's MFU
   (`utils.profiling`), and a B5 call's host time through the registered
   op against a direct call. Then `export_hf_phi3` at Phi-4-mini's width
   cut to 2 layers: [serve]'s int8 state dequantised and a LoRA model on
   those weights merged, each through `convert_hf_phi3` into an f32 model
   whose prefill logits must be the source's (beside a wrong variant that
   must miss), the card's export equal to the CPU's within 1e-6 a tensor;
   [kernel-export] times B1 at the exported prefill's shape (a cache of 336
   slots) and B5 at its decode steps' 2 rows;
12. [kernel] / [kernel-bwd] / [kernel-time] (flash_fwd and flash_bwd, the
   latter beside the old dQ + dK/dV pair) at the CLIP paths' shapes: the
   tower at batch 24 (24 x 12 x 2049, d 64) and BERT (24 x 12 x 128, valid
   lengths 32-128), the fine-patch tower at 2 x 12 x 16,385 where the TPU
   streams its forward (B2) and backward (B4), and the LLM's causal 1 x 24
   x 4096 x 128 at kv_len 4096 and 3000 (checked only); the plain versions
   run a chunk of batch rows and heads at a time, wrong variants beside each
   limit; times against the bound, the plain version, one SDPA call and
   (forward) the old mma.sync kernel and the other query tile, and the
   time per valid pair at 16,385 tokens within 1.5 times that at 2,049;
13. [clip-stage1] trains `CLIPModel(CLIPConfig())` (ViT-B 3D tower + BERT-
   base, bf16 over f32 masters, remat) at batch 24 through `Trainer` and
   `make_stage1_train_step` on a repeated `SyntheticCTDataset` clip batch:
   2 warm-up and 4 timed steps, the flash launches per step by shape, a
   falling loss, one in-training retrieval eval and a profile of one step;
14. [clip-stage2] trains the 2E3 student against that model as its frozen
   teacher: 4 steps with the teacher recomputed, 4 served by a
   `TeacherCache` (hits and misses counted), launches checked by step;
15. [clip-grads] one stage-1 step's gradients at batch 6 through the kernels
   against the plain sdpa path, per group, beside two planted faults; the
   fused optimizer (`ops/multi_tensor.py`) at CLIP's trained leaves: the
   routes and launches of the main path's last warm step, one norm and
   update against the per-leaf loop from one state, and its time beside
   the bound, the loop and torch._fused_adamw_;
16. [clip-long] the stage-1 step at `--patch-size 2 8 8` (16,385 tower
   tokens), batch 2: launches at that shape, finite losses, a non-zero
   gradient in every tower block, step time, peak memory and a profile;
16a. [clip-augment] the stage-1 `Trainer` at batch 24 with
   `augment=AugmentConfig()` over an epoch of three batches, 4 steps, its
   step ms beside [clip-stage1]'s; the state at step 2 resumed by a new
   Trainer: steps 3-4 train on the same augmented volumes bit for bit,
   step 3's loss is bit-equal and step 4's within 1e-3 (the last update went
   through dQ's reduce-adds, which are not bit-reproducible);
16b. [cli-train] the three training CLIs through their `main` at the CLIs'
   full-width defaults in bf16 with remat on (every Trainer prefetching two
   batches onto the card on a side stream), on manifests written to a
   temporary directory (8 volumes (1, 32, 256, 256) and slice features
   (32, 768) from a numpy seed, shared by the entries; inline reports):
   `train_clip_stage1` at batch 24 for 4 steps (a checkpoint and the
   retrieval eval at 4), `train_clip_stage2` on its `clip_params` (4
   steps, then 2 with `--cached-teacher`, whose losses must equal the
   recomputed run's first two within CACHED_TEACHER_RTOL), `train_vlm
   --task mrg` at batch 2 x 800 on both `tower_params` exports (4 steps,
   the profile window over step 3), the same command with `--resume auto
   --total-steps 6` (it must log steps 5 and 6), `train_vlm --task vqa
   --int8-base` at batch 5 x 330 for 3 steps and `train_vlm --task mrg
   --online-slice-features` for 3 steps on the MRG manifest without slice
   features (the frozen BiomedCLIP trunk: 12 B1 launches a step at 64 x 12
   x 197 x 64, no B3 there, its weights unchanged). It checks the flash launches
   of every step by shape (B1 with and without the log-sum-exp at d 64
   and d 128, B3), every bf16 forward on flash_fwd_wgmma, no B5 launch,
   finite and falling losses, the exports, the VLM's tower_stage1 equal
   to stage 1's export (in bf16) bit for bit after training, the int8
   codes unchanged and the adapters moved, each run's TensorBoard file
   read back here (CRC-32C, one scalar per metric per logged step, the
   logged values) and each trace naming the flash kernels; it prints each
   run's wall, step ms, samples/s, peak memory and the idle share over
   the profiled step; [kernel-train-cli] then holds and times B1 and B3
   at the shapes those runs launched that no phase above timed;
16c. [kernel-seg] B1 and B3 at this slice's shapes against the plain
   versions, wrong variants beside each limit, timed beside the bound, the
   plain version and SDPA: SegVol's ViT-B at 2 x 12 x 2048 x 64 (forward,
   with the log-sum-exp, B3) and at batch 1 (a sliding window), the legacy
   masked CLIP's masked stream at 24 x 12 x 1793 and 1281 x 64 (with the
   log-sum-exp, B3);
16d. [segvol] SegVol at ViT3DConfig(classification=False) in bf16 at batch
   2, text-prompted: 12 B1 launches, logits against the plain attention
   path (rel L2 5e-2) beside shifted heads (must miss), the predictor's
   cached grid equal to the uncached one, `sliding_window_segment` over a
   (48, 384, 384) volume in 8 windows, ms a volume; SegVol on SwinConfig()
   in bf16 against f32;
16e. [cli-train-seg] `train_vlm --task seg --online-slice-features` at full
   width (VLMConfig() with LoRA on Phi-4-mini, SegVol trainable, remat) for
   3 steps at batch 2 on a seg manifest the script writes (box masks, [SEG]
   answers), the seg eval at the last: launches by shape, finite lm_loss
   and seg_loss, SegVol's leaves moved, step ms, peak memory;
   [cli-evaluate-seg] `evaluate --task seg` (f32 SegVol, prompts from a
   random stage-1 CLIP that the port saves, through --clip-checkpoint) and
   `evaluate --task rec --reference-compatible` on the same entries
   (VLMConfig() with the in-graph slice features through `model=`): the
   runs and their launches held, the random scores printed; B1 and B3 then
   at the shapes those runs launched that no phase above timed, f32
   included;
16f. [clip-masked] `MaskedCLIPModel(CLIPConfig())` at batch 24 through the
   legacy step at the ramp's steps 0, 5000 and 20000 (2048, 1792 and 1280
   kept patches): launches by shape, finite losses, step ms; gradients at
   batch 6 against the plain path beside two planted faults; the W8A8
   static mode of both streams against bf16 (per-token cosine >= 0.995);
   [remat-dots] runs inside [train-grads]: the finetune step's gradients
   with the Phi remat policy "dots" against "full", step ms and peak
   memory of each;
16g. the parallel slice at VLMConfig() (all 32 LLM layers): [dist-world1]
   the training CLIs with --zero1 / --fsdp and evaluate --dp 1 --tp 1 in a
   one-rank NCCL group against plain runs; [dist-tp2] serve --tp 2 and
   [dist-dp2] (a CLIP step, train_vlm --dp 2 with --zero1 and --fsdp at 4
   LLM layers, evaluate --dp 2) as two ranks on the one card over gloo (`chip_smoke.py
   --dist-rank`), each against one process beside a wrong variant that
   must miss (the row-parallel all-reduce left out, the feature gather
   without gradient, ranks keeping their own gradients, ranks keeping
   their own ids); FSDP's step peak of device memory below ZeRO-1's, and
   with --int8-base the split int8 codes' peak below the whole codes';
   then the sixteenth slice as two ranks on the card over gloo:
   [dist-pp2] `train_vlm --pp 2 --n-micro 2` (16 layers a stage) for 3
   steps against [dist-world1]'s plain run's losses and LoRA gradients, beside the stages
   swapped (must miss), each stage's flash launches, step peak and step
   time, then `evaluate` on the model its vlm_deltas make; [dist-sp2] the
   CLIP towers over the ring (train_clip_stage1 --sp 2 at 1025 tokens a
   rank, train_clip_stage2 --sp 2 --cached-teacher), train_vlm --sp 2 (400
   tokens a rank) and the fine-patch tower at 16,385 tokens with query
   blocks, each against one process's run, and the ring at the tower's
   and at the decoder's attention shape; a ring that never reads its
   neighbours' chunks must miss in train_vlm --sp 2 and in both rings;
   [kernel-tp] B5 at the tp = 2 shards and B1 / B3 at the new shapes;
17. prints one JSON line of kernel numbers, then as its last line
   {"ok": true, "device": {...}}.

Any failed phase raises and the script exits non-zero. Without a CUDA
device, or without the hsenet_torch package beside it, it prints no
result and exits non-zero.
"""

from __future__ import annotations

import gc
import itertools
import json
import math
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# H100 SXM dense peaks (NVIDIA data sheet) for the bound of each kernel
PEAK_BF16_FLOPS = 989e12
PEAK_INT8_OPS = 1979e12
PEAK_TF32_FLOPS = 495e12  # the f32 flash kernels' TF32 products
PEAK_F32_FLOPS = 67e12  # outside the tensor cores
PEAK_BYTES_PER_S = 3.35e12

# device-side sleep that the timed calls queue behind (~10 ms at the
# H100's 1.98 GHz boost clock)
SLEEP_CYCLES = 20_000_000

# bf16 tolerance of a kernel against its plain version, as a share of the
# largest |value| in each output row (a row with no valid column must give
# exact zeros): both round O to bf16, which alone can put them 2^-7 of the
# row's largest value apart, and the kernel rounds P to bf16 as well.
# check_flash_kernel shows that a version that drops one 64-key tile at
# the tower shape breaks it.
KERNEL_ROW_TOL = 2e-2
# prefill last-token logits, kernel vs plain sdpa, as a relative L2 error:
# the two attention paths round at different places in each of 32 bf16
# layers, and the differences travel through the residual stream
LOGITS_REL_L2 = 5e-2

# backward kernels against their plain version: |error| as a share of the
# largest |value| in its row (a query row of dQ, a key row of dK and dV),
# that largest value floored at BWD_ROW_FLOOR of the output's largest: a
# query row with one valid column has a gradient of exactly 0 in exact
# arithmetic, so both sides hold rounding noise there. P and dS are rounded
# to bf16 for the tensor cores and each output to bf16 at the end (2^-9 of
# the row's largest value); check_flash_bwd_kernels shows that versions
# with delta left out, the last valid key tile of each batch row dropped,
# or the diagonal tile dropped break it. Keys at or past kv_len, and a
# batch row with kv_len 0, must get exact zeros.
KERNEL_BWD_TOL = 2e-2
BWD_ROW_FLOOR = 1e-4
# the f32 route of the flash kernels (forward, dQ, dK/dV) against its f32
# plain version, as a share of the largest |value| of its (batch, head)
# slice: the kernels multiply on the tensor cores in TF32, which rounds
# each operand to within 2^-11 of its value, and sum in f32, so an error
# stays near 1e-3 of the scale of the terms it sums; nothing is rounded on
# output. A row share is no measure here: a query row with one valid key
# has dQ = 0 exactly (dP equals delta), which the kernel gets as the
# difference of two TF32 sums, so its error sits at the terms' scale, not
# its own. check_f32_kernels prints the forward's row share beside it, and
# shows that a forward and backward with the softmax scale of the padded
# width, or without the last 64 valid keys, break the limit.
KERNEL_F32_TOL = 5e-3
# the f32 forward's log-sum-exp against the plain version's, absolute: the
# scores carry the TF32 rounding of Q and K (about 5e-4 at these widths);
# without the last 64 valid keys it moves by 0.03 or more
LSE_F32_ABS_TOL = 5e-3
# the forward's log-sum-exp against the plain version's, absolute: both
# sum the same bf16 products in f32
LSE_ABS_TOL = 1e-3
# one training step's gradients through the kernels against the plain sdpa
# path, relative L2 per group of leaves: 32 bf16 layers that round at
# different places; check_train_grads shows that steps with delta left out
# of the backward, or with no gradient through attention, break it
TRAIN_GRAD_REL_L2 = 5e-2

# the int8 matvec kernel against its plain version, bf16: |error| as a
# share of the largest |value| in its output row. Both sum the same exact
# products in f32 (in another order) and round once to bf16, so they differ
# by at most one bf16 unit of an element, 2^-8 of the row's largest value
# or less. check_matvec_kernel shows that versions with the scales shifted
# by one channel, or the last 16 codes of K dropped, break it.
MATVEC_ROW_TOL = 8e-3
# (K, N) of Phi-4-mini's int8 projections, and how many of each a decode
# step of the 32-layer model launches
MATVEC_SHAPES = {"qo_3072x3072": (3072, 3072), "kv_3072x1024": (3072, 1024),
                 "gate_up_3072x8192": (3072, 8192), "down_8192x3072": (8192, 3072)}
MATVEC_PER_LAYER = {"qo_3072x3072": 2, "kv_3072x1024": 2,
                    "gate_up_3072x8192": 2, "down_8192x3072": 1}
# timed launches cycle over enough copies of the codes that each launch
# reads them from device memory, as a decode step does (its 32 layers hold
# 3.2 GB of codes), not from the 50 MB L2
MATVEC_COLD_BYTES = 128e6
# [kernel-matvec] checks every shape at these M, and beside the path's
# four shapes a ragged one (K = 193 x 16, N off the 64-channel blocks) and
# the `--synthetic` models' (hidden 64: K 64 and 128), where the CUDA-core
# entry is checked in f32 too
MATVEC_CHECK_ROWS = (1, 2, 3, 5, 8)
MATVEC_CHECK_SHAPES = {"ragged_3088x1000": (3088, 1000),
                       "synthetic_64x32": (64, 32), "synthetic_128x64": (128, 64)}
MATVEC_SYNTHETIC = ("synthetic_64x32", "synthetic_128x64")
# the LM head's tied int8 table (K x vocab), timed once at M = 8: 614 MB of
# codes, the kernel's streaming rate without a launch's fixed cost
MATVEC_LM_HEAD = (3072, 200064)

EOS_TOKEN_ID = 200020  # Phi-4-mini <|end|>
IM_PATCH_TOKEN_ID = 200010  # placeholder id under the spliced image block
MAX_NEW_TOKENS = 32
KV_LENS = (300, 320)
# the serving engine at the CLI's defaults: 8 slots, chunks of 16 steps,
# prompts capped at 512, 512 new tokens: cache rows of 512 + 512 + 16
SERVE_SLOTS = 8
SERVE_CHUNK = 16
SERVE_PROMPT_CAP = 512
SERVE_MAX_NEW = 512
SERVE_CAPACITY = SERVE_PROMPT_CAP + SERVE_MAX_NEW + SERVE_CHUNK
SERVE_PREFIX = 257  # BOS + 256 image tokens, what the KV-prefix cache keeps
# an engine with a 2048-token output budget: rows of 2576 slots, the key
# length at which the TPU's dispatch streams K/V
SERVE_LONG_MAX_NEW = 2048
SERVE_LONG_CAPACITY = SERVE_PROMPT_CAP + SERVE_LONG_MAX_NEW + SERVE_CHUNK
# flash_fwd over a 2576-slot row may take this many times what it takes over
# a 1040-slot row at the same kv_len (it reads the same keys; a kernel that
# walked the whole row would take 2.5 times)
CAPACITY_TIME_RATIO = 1.5
# one decode step's logits (8 slots, 32 layers) through the matvec kernel
# against the same step through its plain version, relative L2: the two
# sum in another order, so a projection's output flips by one bf16 unit
# here and there, and 32 layers carry the flips on. check_serve_logits
# prints the same distance between two plain versions (f32 and f64 sums)
# as the floor of such flips, and shows that a step with the scales
# shifted by one channel breaks the limit
DECODE_LOGITS_REL_L2 = 5e-2
# a KV-prefix hit's first-token logits against a full prefill of the same
# request, relative L2: the question chunk runs as 255 rows where the full
# prefill runs 512, so GEMMs and flash tiles round at other places in each
# of 32 bf16 layers; a hit resumed 64 positions early must miss it
PREFIX_LOGITS_REL_L2 = 5e-2
# first-token logits with the int8 KV cache against the bf16 cache,
# relative L2: each key and value carries up to 1/254 of its row's largest
# value of quantisation error through 32 layers; a prefix hit whose cached
# prefix lost its scales (the image block reads as zeros) must miss it
KV_INT8_LOGITS_REL_L2 = 1e-1
PROMPT_LEN = 320
# the finetune's traffic: batch 3 (the reference's per-GPU batch), right
# padded to the MRG max length, rows of different valid length
TRAIN_KV_LENS = (800, 700, 560)
TRAIN_SEQ = 800
TRAIN_WARMUP_STEPS = 2
TRAIN_TIMED_STEPS = 6
# the CLIP pretraining stages at the JAX CLIs' defaults: global batch 24,
# text right-padded to 128 tokens, learning rate 1e-4 over a run of 1000
# steps with 3% warmup (the phases run its first steps). The reports' valid
# lengths are spread over 32-128, the last four cut at the cap (BOS + words
# + EOS, truncated)
CLIP_BATCH = 24
CLIP_RUN_STEPS = 1000
CLIP_TEXT_LENS = tuple(min(128, 32 + 5 * i) for i in range(CLIP_BATCH))
CLIP_WARMUP_STEPS = 2
CLIP_TIMED_STEPS = 4
# stage 2: steps with the teacher recomputed, then steps served by the
# teacher cache (the first of them fills it)
CLIP2_STEPS = 4
# [clip-grads]: the plain sdpa path holds 1.2 GB of f32 scores a layer at 6
CLIP_GRADS_BATCH = 6
CLIP_GRADS_WARM_STEPS = 5
# the fused optimizer against the per-leaf loop from one state (the bits
# agree on an H100; the kernel tests' limits): each of p, mu and nu within
# this share of the loop's value, the norm within NORM_REL of the loop's
FUSED_ADAMW_REL = 2e-6
FUSED_NORM_REL = 1e-6
# bytes an element: the norm reads g; the update reads g, p, mu, nu and
# writes p, mu, nu, all f32
FUSED_ADAMW_BYTES = 32
# [clip-long]: the finer patching of `--patch-size 2 8 8`, a (16, 32, 32)
# grid: 16,384 patches + CLS, where the TPU streams the flash forward and
# backward; batch 2, the least at which the contrastive loss has a gradient
CLIP_LONG_PATCH = (2, 8, 8)
CLIP_LONG_BATCH = 2
CLIP_LONG_WARMUP_STEPS = 1
CLIP_LONG_TIMED_STEPS = 2
# the flash kernels' time per valid (query, key) pair at 16,385 tokens may be
# this many times their time per pair at 2,049 (a kernel that walked tiles
# it should skip, or thrashed at length, would break it)
PAIR_TIME_RATIO = 1.5


# [kernel-wide]: the wide route of the flash kernels (ROADMAP C2, closed),
# on no path, checked and timed at small grids: name, dtype, (batch, heads,
# sq, skv, true head dim), kv_lens, q_offset, causal. Limits: KERNEL_BWD_TOL
# of each row's largest value in bf16 and f16 (forward and gradients),
# KERNEL_F32_TOL of each (batch, head) slice's in f32, the log-sum-exp at
# LSE_ABS_TOL / LSE_F32_ABS_TOL
WIDE_CASES = [
    ("d320_bf16", "bfloat16", (2, 8, 512, 512, 320), (512, 333), (0, 0), True),
    ("d512_bf16", "bfloat16", (2, 8, 384, 448, 512), (448, 300), (64, 100), True),
    ("d320_f16", "float16", (2, 8, 512, 512, 320), (512, 400), (0, 0), False),
    ("d512_f16", "float16", (2, 8, 384, 448, 512), (448, 300), (64, 100), True),
    ("d320_f32", "float32", (2, 8, 384, 384, 320), (384, 250), (0, 0), False),
    ("d512_f32", "float32", (2, 8, 256, 320, 512), (320, 200), (64, 30), True),
    ("d192_f32", "float32", (2, 8, 512, 512, 192), (512, 300), (0, 0), True),
    ("d256_f32", "float32", (2, 8, 512, 512, 256), (512, 450), (0, 0), False),
    # widths off the multiples of 64, zero-padded to 320 and 256
    ("d300_bf16", "bfloat16", (2, 8, 384, 448, 300), (448, 320), (64, 100), True),
    ("d200_f32", "float32", (2, 8, 512, 512, 200), (512, 350), (0, 0), False),
]

# [kernel-pv]: B6 against its plain version at the probe's shapes. The
# integer modes must be bit-equal (both sides sum integer codes exactly and
# convert once); bf16 sums the same exact bf16 products in f32 in another
# order, so |error| may reach this share of its row's largest |value|.
# Each mode runs beside a version with the last 32 of K dropped (and, for
# quant_then_int8, P quantised with a scale of 128), which must miss.
PV_BF16_ROW_TOL = 1e-4
PV_DROPPED_K = 32
# int8_pv_wgmma is also checked at this M, not a multiple of its row tiles
# (192 and 128 rows). In every mode it may take at most PV_SLACK times the
# time of its yardstick (int8_pv, the mma.sync kernel): 5%, far above the
# turns' noise
PV_OFF_TILE_M = 1000
PV_SLACK = 1.05
# [encode-w8a8]: the serving encode of bench.py at batch 8; the W8A8 towers
# calibrated on 2 volumes. The per-token cosine of their features against
# the float bf16/erf towers of the same weights must reach W8A8_COSINE_MIN
# on every token (read 0.99949 at the lowest token on an H100 80GB HBM3);
# the same towers with the first block's activation scales divided by 4
# (activations clipped at a quarter of their range; read 0.858), and with
# one dense's weight scales shifted by a channel in each tower (read
# 0.992), must miss it.
ENCODE_BATCH = 8
W8A8_CALIB_VOLUMES = 2
W8A8_COSINE_MIN = 0.995
# [spec]: prompt-lookup decoding at the batch-1 decode configuration of
# bench.py (Phi-4-mini, 32 layers, int8 projections and embedding): a
# 320-token prompt of one 40-token phrase repeated, SPEC_NEW_TOKENS new
# tokens, drafts of 7 from 2-grams
SPEC_PHRASE = 40
SPEC_NEW_TOKENS = 64
SPEC_DRAFT_LEN = 7
SPEC_NGRAM = 2
# where speculative tokens leave greedy ones, the token speculative
# decoding chose must lie within a near-tie of greedy's top logit there
# (from a prefill of the prompt and the greedy tokens before it): at most
# this share of the logits' RMS below it. Two bf16 routes through the 32
# layers put a logit ~1.6e-2 of that RMS apart (the decode-logits reading
# of check_serve_logits), so a flip needs a gap under about twice that; a
# draft accepted past its first mismatch ([spec]'s wrong variant) must
# miss the limit. [spec] reads the gap on f32 logits of the prefill's last
# hidden state: the model's bf16 logits near a top logit of ~5 move in
# steps of 0.028 of the RMS, too coarse for this limit (a parting read
# 0.0564 in bf16 and 0.0431 in f32 on the same hidden state, PERF.md)
NEAR_TIE_SHARE = 0.05
# [cli-evaluate]: the evaluate CLI on a manifest written by the script: 4
# validation reports (caption) and 2 volumes x 2 questions (location VQA),
# volumes (1, 32, 256, 256) and slice features (32, 768) from a numpy seed;
# MRG at batch 2 and 32 new tokens through each generate route
EVAL_REPORTS = (
    "The lungs are clear. No pleural effusion or pneumothorax. Heart size is "
    "normal.",
    "A 6 mm nodule in the right upper lobe. No consolidation. Mild "
    "emphysema in both lungs.",
    "Small left pleural effusion with adjacent atelectasis. No pericardial "
    "effusion.",
    "Mediastinal lymphadenopathy. Thickening of the bronchial walls. No mass.",
)
EVAL_VQA = ((0, "nodule", "right lung"), (0, "pleural effusion", "pleura"),
            (1, "atelectasis", "left lung"), (1, "lymphadenopathy", "mediastinum"))
EVAL_BATCH = 2
EVAL_MAX_NEW = 32
EVAL_PROFILE_NEW = 4
# [ckpt]: greedy tokens of the full-width VLM before and after its deltas
# went through save_vlm_deltas / load_vlm_deltas; then an HF Phi-3 state at
# the serving CLI's --synthetic widths, converted with --quant-int8 and
# served with --checkpoint
CKPT_NEW_TOKENS = 16
CKPT_PHI3 = dict(vocab_size=512, hidden_size=64, intermediate_size=128,
                 num_layers=2, num_heads=4, num_kv_heads=2, head_dim=16,
                 tie_word_embeddings=True)
CKPT_SERVE = ["--quant-int8", "--llm-only", "--synthetic", "--num-requests", "6"]
# the int8 projections' (K, N) in one decode step of that model's 2 layers:
# q,o (64, 64), k,v (64, 32), gate,up (64, 128), down (128, 64), each at
# the engine's 8 slots
CKPT_MATVEC = {"ckpt_64x64": ((64, 64), 4), "ckpt_64x32": ((64, 32), 4),
               "ckpt_64x128": ((64, 128), 4), "ckpt_128x64": ((128, 64), 2)}


# [cli-train]: the three training CLIs through their `main` on manifests
TRAIN_CLI_VOLUMES = 8  # distinct volumes; the CLIP entries share them, 3 each
TRAIN_CLI_BATCH = {"clip": 24, "mrg": 2, "vqa": 5}
TRAIN_CLI_STEPS = 4
TRAIN_CLI_PROFILE = ["--profile-start", "2", "--profile-stop", "3"]
TRAIN_CLI_ONLINE_STEPS = 3  # train_vlm --online-slice-features
# the cached-teacher run's losses against the recomputed run's first two:
# the cache serves the teacher's bf16 features as f32, so the teacher's
# logits round once less (~1e-3 of the loss); a wrong batch or a stale
# feature moves the loss by its whole size
CACHED_TEACHER_RTOL = 1e-2

# [ct-data]: chest-CT NIfTI volumes written from a numpy seed: name ->
# (stored (z, y, x) shape, (x, y, z) spacing in mm, the header's intercept,
# the metadata CSV's intercept); both compose to HU = stored - 1024
CT_VOLUMES = {
    "chest_a.nii.gz": ((300, 512, 512), (0.7, 0.7, 1.0), -1024.0, 0.0),
    "chest_b.nii": ((24, 512, 512), (0.7, 0.7, 5.0), 0.0, -1024.0),
}
CT_BATCH = 8  # preprocess_batch's batch in the timing
CT_ATOL = 1e-5  # the card against the CPU: volumes and linear slices
CT_CUBIC_ATOL = 1e-4  # the faithful (cubic) slices, where their codes agree
CT_EDGE_SHARE = 1e-4  # the share of faithful slice codes one apart
CT_REFERENCE_ATOL = 2e-5  # the faithful volume against reference_preprocess,
CT_REFERENCE_RTOL = 1e-4  # beyond this share of the reference's value
# [vit2d]: the BiomedCLIP trunk's features against the plain attention path
VIT2D_REL_L2 = 5e-2
VIT2D_SLICES = 32  # slices a volume, each a batch row of the trunk's B1
# [clip-augment]: the augmented stage-1 run and its resume
AUG_BATCHES = 3  # an epoch, so the resume at step 2 lands mid-epoch
AUG_STEPS = 4
AUG_RESUME_AT = 2
# the step after the resumed one trains on weights whose last update went
# through dQ's f32 reduce-adds, which land in another order each run
AUG_LATER_STEP_RTOL = 1e-3

SEG_BATCH = 2  # SegVol's batch in [segvol], train_vlm --task seg and evaluate --task seg
# a volume that (32, 256, 256) windows at overlap 0.25 cover in 2 x 2 x 2 = 8
SEG_WINDOW_VOLUME = (48, 384, 384)
SEG_VOLUMES = 4  # seg manifest entries, 2 train and 2 validation
SEG_TRAIN_STEPS = 3
SEG_TARGETS = ("liver", "right kidney", "spleen", "pancreas")
# SegVol's bf16 logits through B1 against the plain attention path, and its
# Swin encoder in bf16 against f32, as relative L2 of the logits
SEGVOL_REL_L2 = 5e-2
SWIN_REL_L2 = 5e-2
# the legacy masked CLIP: the ramp's buckets at steps 0, 5000 and 20000 keep
# 2048, 1792 and 1280 of 2048 patches
MASKED_STEPS = (0, 5000, 20000)
MASKED_W8A8_BATCH = 8
# [remat-dots]: "dots" keeps the projections' outputs where "full"
# recomputes them; the arithmetic is the same and only dQ's f32 reduce-adds
# land in another order, so the two gradients agree far inside the kernel
# limits
REMAT_DOTS_REL_L2 = 1e-2
CRC32C_CHECK = 0xE3069283  # CRC-32C of b"123456789"


_LAP = [time.perf_counter()]


def lap(label: str) -> None:
    """Print the command time since the last lap: the script's time by
    group of phases, against its time limit."""
    now = time.perf_counter()
    print(f"[time] {label}: {now - _LAP[0]:.1f} s")
    _LAP[0] = now


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, reps: int = 20, warmup: int = 3, runs: int = 5) -> float:
    """Device time of one call: `reps` calls between two CUDA events, queued
    behind a device-side sleep so that the host's own time per call (the
    wrapper's Python, the launch) stays out of the interval; the median
    over `runs` such intervals of their mean per call."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        cycles = SLEEP_CYCLES
        while True:  # until the host queued every call inside the sleep
            slept, start, end = (torch.cuda.Event(enable_timing=True)
                                 for _ in range(3))
            slept.record()
            torch.cuda._sleep(cycles)
            start.record()
            t = time.perf_counter()
            for _ in range(reps):
                fn()
            end.record()
            host_ms = (time.perf_counter() - t) * 1e3
            end.synchronize()
            if host_ms < slept.elapsed_time(start) or cycles >= 16 * SLEEP_CYCLES:
                break
            cycles *= 2
        times.append(start.elapsed_time(end) / reps)
    return statistics.median(times)


def median_wall_ms(fn, runs: int = 5) -> float:
    """Median host-clock time of `fn` over `runs` calls, each closed by a
    device synchronise."""
    import torch

    times = []
    for _ in range(runs):
        torch.cuda.synchronize()
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t) * 1e3)
    return statistics.median(times)


def profile_phase(label: str, fn, wall_ms: float, top: int = 6) -> dict:
    """One call of `fn` under torch.profiler: summed device kernel time,
    the heaviest kernels and ops, and the device's idle share against `wall_ms`,
    the phase's unprofiled median wall time (the profiler's own cost would
    inflate a profiled wall time). Device numbers are None where the
    profiler recorded no device time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    if busy_ms == 0:
        print(f"[profile] {label}: wall {wall_ms:.2f} ms; device time not measured")
        return {"wall_ms": wall_ms, "device_ms": None, "idle_share": None}
    kernels.sort(key=lambda e: -e.self_device_time_total)
    heavy = [(e.key[:60], e.self_device_time_total / 1e3, e.count)
             for e in kernels[:top]]
    # device time by kind of kernel: the port's flash kernels, its int8
    # matvec kernel, the library's int8 and float matrix products, and
    # everything else (elementwise, norms, reductions, copies)
    kinds = {"flash": 0.0, "matvec": 0.0, "int8_gemm": 0.0, "gemm": 0.0,
             "other": 0.0}
    for e in kernels:
        name = e.key.lower()
        gemm = any(w in name for w in ("nvjet", "gemm", "cutlass"))
        kind = ("flash" if "flash_" in name else
                "matvec" if "quant_matvec" in name else
                "int8_gemm" if gemm and any(w in name for w in ("s8", "i8", "imma"))
                else "gemm" if gemm else "other")
        kinds[kind] += e.self_device_time_total / 1e3
    out = {"wall_ms": wall_ms, "device_ms": busy_ms,
           "idle_share": max(0.0, 1 - busy_ms / wall_ms), "by_kind_ms": kinds}
    print(f"[profile] {label}: wall {wall_ms:.2f} ms (unprofiled median), "
          f"device busy {busy_ms:.2f} ms (profiled call), idle share "
          f"{out['idle_share']:.1%}; device ms by kind: "
          + ", ".join(f"{k} {v:.2f}" for k, v in kinds.items()))
    for name, ms, count in heavy:
        print(f"[profile] {label}:   {ms:9.3f} ms  x{count:<5d} {name}")
    # the same device time by the PyTorch op that launched it
    ops = sorted((e for e in prof.key_averages()
                  if e.device_type == DeviceType.CPU and e.self_device_time_total > 0),
                 key=lambda e: -e.self_device_time_total)
    out["by_op_ms"] = {e.key: e.self_device_time_total / 1e3 for e in ops[:top]}
    for e in ops[:top]:
        print(f"[profile] {label}: op {e.key[:40]:40s} "
              f"{e.self_device_time_total / 1e3:9.3f} ms  x{e.count}")
    return out


def attention_pairs(sq, skv, kv_lens, q_off, causal):
    """(valid (row, column) pairs summed over the batch, K/V rows that some
    row of each batch row needs, summed over the batch)."""
    pairs = kv_rows = 0
    for kv, off in zip(kv_lens, q_off):
        valid = [max(min(kv, skv, r + off + 1) if causal else min(kv, skv), 0)
                 for r in range(sq)]
        pairs += sum(valid)
        kv_rows += max(valid)
    return pairs, kv_rows


def kernel_bound(kind, b, h, sq, skv, d, kv_lens, q_off, causal, elem=2,
                 peak=PEAK_BF16_FLOPS):
    """(bound_ms, bound_by, flops, bytes) of one launch of `kind`: each
    input read once and each output written once in `elem`-byte elements
    (K and V only up to the last column some row needs; log-sum-exp and
    delta in f32), and 2 d operations per product per valid (row, column)
    pair at `peak`: 2 products (S, PV) for flash_fwd, 5 (S, dP, dV, dK, dQ)
    for flash_bwd, 3 (S, dP, dQ) for flash_bwd_dq and 4 (S, dP, dV, dK) for
    flash_bwd_dkv."""
    pairs, kv_rows = attention_pairs(sq, skv, kv_lens, q_off, causal)
    q_bytes = elem * b * h * sq * d  # one (B, H, Sq, D) tensor
    kv_bytes = 2 * elem * h * kv_rows * d  # K and V below the valid edge
    dkv_bytes = 2 * elem * b * h * skv * d  # dK and dV
    rows = 4 * b * h * sq  # one f32 value per query row
    products, nbytes = {
        "flash_fwd": (2, 2 * q_bytes + kv_bytes),
        "flash_fwd_lse": (2, 2 * q_bytes + kv_bytes + rows),
        "flash_bwd": (5, 3 * q_bytes + kv_bytes + 2 * rows + dkv_bytes),
        "flash_bwd_dq": (3, 3 * q_bytes + kv_bytes + 2 * rows),
        "flash_bwd_dkv": (4, 2 * q_bytes + kv_bytes + 2 * rows + dkv_bytes),
    }[kind]
    flops = products * 2 * d * h * pairs
    nbytes += 8 * b  # kv_lens and q_offset
    t_ops = flops / peak * 1e3
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    if t_ops >= t_bytes:
        return t_ops, "operations", flops, nbytes
    return t_bytes, "bytes", flops, nbytes


def compare(out, ref, tol=KERNEL_ROW_TOL):
    """(max abs error, max error over its row's largest |ref|, within `tol`
    (the bf16 tolerance unless given) and finite) of a kernel's output
    against its plain version's."""
    err = (out.float() - ref.float()).abs()
    scale = ref.float().abs().amax(dim=-1, keepdim=True)
    ok = bool((err <= tol * scale).all())
    row_rel = (err / scale.clamp_min(1e-30)).max().item()
    return err.max().item(), row_rel, ok and bool(out.float().isfinite().all())


def fwd_route(tag, launches, f32_launches):
    """The forward launches of one counted run by kernel, and the check that
    every bf16 and f16 one went through flash_fwd_wgmma: on the paths the
    mma.sync flash_fwd runs only the f32 route."""
    f32 = sum(n for (kernel, _), n in f32_launches.items() if kernel == "flash_fwd")
    by_kernel = {"flash_fwd_wgmma": launches["flash_fwd_wgmma"], "flash_fwd_f32": f32}
    print(f"[{tag}] forward launches by kernel: {by_kernel}")
    if launches["flash_fwd"] != f32:
        raise AssertionError(f"{tag}: {launches['flash_fwd'] - f32} bf16 or f16 "
                             "forward launches took the mma.sync flash_fwd")
    return by_kernel


def fwd_yardsticks(q, k, v, kv_t, off_t, causal, with_lse):
    """Times beside flash_fwd_wgmma's at one shape (q at a kernel width):
    the old mma.sync flash_fwd's (its bf16 build, which no path launches;
    None where it does not run: f16, head_dim 256), and flash_fwd_wgmma's at
    the query tile that `forward_query_tile` did not choose."""
    import torch

    from hsenet_torch.ops import flash_attention as tfa

    b, h, s, d = q.shape
    scale = d ** -0.5
    tile = tfa.forward_query_tile(b, h, s, d, tfa._sm_count(q.device.index))
    other = 192 - tile
    old = None
    if q.dtype == torch.bfloat16 and d <= 128:
        old = time_ms(lambda: tfa._fwd_mma_kernel(q, k, v, kv_t, off_t, causal,
                                                  scale, with_lse))
    other_ms = time_ms(lambda: tfa._fwd_launch(
        "flash_fwd_wgmma", q, k, v, kv_t, off_t, causal, scale, with_lse, (other,)))
    return {"tile": tile, "old_ms": old, "other_tile": other,
            "other_tile_ms": other_ms}


def yardstick_text(r):
    """The yardsticks of a flash_fwd_wgmma timing, as printed."""
    old = ("" if r.get("old_ms") is None else
           f"; old mma.sync flash_fwd {r['old_ms']:.4f} ms (new / old "
           f"{r['ms'] / r['old_ms']:.3f})")
    return (f"; new / SDPA {r['ms'] / r['library_ms']:.3f}{old}; query tile "
            f"{r['tile']} (at {r['other_tile']}: {r['other_tile_ms']:.4f} ms)")


def check_flash_kernel():
    """B1 against its plain version at the tower, prefill and training
    shapes, then at f16 and head dims 160 and 256 (C2)."""
    import torch
    import torch.nn.functional as F
    from einops import rearrange

    from hsenet_torch.ops import flash_attention as tfa
    from hsenet_torch.ops.flash_attention import (
        flash_attention,
        flash_attention_reference,
    )

    gen = torch.Generator(device="cuda").manual_seed(0)
    dev = "cuda"

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device=dev,
                           dtype=torch.bfloat16)

    # tower: q/k/v are head-split views of one packed qkv projection
    b, h, s, d = 2, 12, 2049, 64
    qkv = randn(b, s, 3 * h * d)
    tq, tk, tv = (rearrange(t, "b s (n d) -> b n s d", n=h)
                  for t in qkv.chunk(3, dim=-1))
    # prefill: q from the q projection, k/v GQA-expanded from a 352-slot
    # cache (8 kv heads -> 24)
    pq = rearrange(randn(2, 320, 24 * 128), "b s (n d) -> b n s d", n=24)
    pk = randn(2, 8, 352, 128).repeat_interleave(3, dim=1)
    pv = randn(2, 8, 352, 128).repeat_interleave(3, dim=1)
    # training: 3 x 800 tokens, q from its projection, k/v GQA-expanded
    lq, lk, lv = llm_training_qkv(randn)
    # serving: one admission's queries over its slot's cache row (8 kv
    # heads -> 24): the whole padded prompt (512 rows) on a miss, the
    # question chunk (255 rows from offset 257) on a KV-prefix hit; over the
    # 1040-slot row of the default engine and the 2576-slot row of an engine
    # with a 2048-token output budget, where the TPU streams its K/V
    sq = rearrange(randn(1, SERVE_PROMPT_CAP, 24 * 128), "b s (n d) -> b n s d", n=24)
    hq = rearrange(randn(1, SERVE_PROMPT_CAP - SERVE_PREFIX, 24 * 128),
                   "b s (n d) -> b n s d", n=24)
    sk, sv, gk, gv = (randn(1, 8, t, 128).repeat_interleave(3, dim=1)
                      for t in (SERVE_CAPACITY, SERVE_CAPACITY,
                                SERVE_LONG_CAPACITY, SERVE_LONG_CAPACITY))
    cases = [
        ("tower", (tq, tk, tv), (2049, 1900), (0, 0), False),
        ("prefill", (pq, pk, pv), KV_LENS, (0, 0), True),
        ("prefill_q_offset", (pq, pk, pv), (316, 352), (16, 32), True),
        ("train", (lq, lk, lv), TRAIN_KV_LENS, (0, 0, 0), True),
        ("serve_prefill", (sq, sk, sv), (300,), (0,), True),
        ("serve_prefill_full", (sq, sk, sv), (512,), (0,), True),
        ("serve_prefix_hit", (hq, sk, sv), (400,), (SERVE_PREFIX,), True),
        ("serve_long", (sq, gk, gv), (300,), (0,), True),
        ("serve_long_full", (sq, gk, gv), (512,), (0,), True),
    ]
    # ragged edges off the main path: Sq and Skv not multiples of 64, an
    # empty row (kv_len 0 -> zeros) and a causal offset, in bf16 and f16 at
    # head dims 64 and 256 (and 160, padded to 256); checked, not timed
    for dtype, d in ((torch.bfloat16, 64), (torch.float16, 64),
                     (torch.bfloat16, 256), (torch.float16, 256),
                     (torch.float16, 160)):
        eq, ek, ev = (torch.randn(2, 4, n, d, generator=gen, device=dev,
                                  dtype=dtype) for n in (70, 100, 100))
        for causal in (False, True):
            kw = dict(kv_lens=torch.tensor([0, 77], dtype=torch.int32, device=dev),
                      causal=causal, q_offset=torch.tensor(
                          [5, 9], dtype=torch.int32, device=dev))
            out = flash_attention(eq, ek, ev, **kw)
            max_abs, _, ok = compare(out, flash_attention_reference(eq, ek, ev, **kw))
            if not ok or torch.count_nonzero(out[0]) != 0:
                raise AssertionError(f"flash_fwd edge case ({dtype}, d {d}, "
                                     f"causal={causal}) failed")
            print(f"[kernel] flash_fwd edge case {str(dtype)[6:]} d {d} "
                  f"causal={causal}: Sq 70, Skv 100, kv_lens (0, 77), q_offset "
                  f"(5, 9): max_abs_err {max_abs:.3e}, empty row all zeros")
    # no keys at all: every row is empty, and nothing is launched
    zq = randn(1, 2, 5, 64)
    zout = flash_attention(zq, zq[:, :, :0], zq[:, :, :0])
    if zout.shape != zq.shape or torch.count_nonzero(zout) != 0:
        raise AssertionError("flash_fwd over no keys did not give zeros")
    print("[kernel] flash_fwd edge case Skv 0: all zeros")

    results = {}
    for name, (q, k, v), kv_lens, q_off, causal in cases:
        kv_t = torch.tensor(kv_lens, dtype=torch.int32, device=dev)
        off_t = torch.tensor(q_off, dtype=torch.int32, device=dev)
        kw = dict(kv_lens=kv_t, causal=causal, q_offset=off_t)
        if name == "train":
            # the launch of the training path, which also writes the
            # log-sum-exp that the backward kernels read
            def run(q=q, k=k, v=v):
                return tfa._forward_kernel(q, k, v, kv_t, off_t, causal,
                                           q.shape[3] ** -0.5, True)

            out, lse = run()
            ref, ref_lse = flash_attention_reference(q, k, v, with_lse=True, **kw)
            lse_err = (lse - ref_lse).abs().max().item()
            # the limit's power: the log-sum-exp without the last 64 valid
            # keys of each batch row must miss it
            _, short_lse = flash_attention_reference(
                q, k, v, with_lse=True, **{**kw, "kv_lens": kv_t - 64})
            short_err = (short_lse - ref_lse).abs().max().item()
            print(f"[kernel] flash_fwd train: log-sum-exp max abs err "
                  f"{lse_err:.3e} (tol {LSE_ABS_TOL}); without the last 64 "
                  f"keys {short_err:.3e}")
            if not lse_err <= LSE_ABS_TOL:
                raise AssertionError("flash_fwd log-sum-exp disagrees with its plain version")
            if short_err <= LSE_ABS_TOL:
                raise AssertionError("the log-sum-exp tolerance passes 64 dropped keys")
        else:
            def run(q=q, k=k, v=v, kw=kw):
                return flash_attention(q, k, v, **kw)

            out = run()
            ref = flash_attention_reference(q, k, v, **kw)
        max_abs, row_rel, ok = compare(out, ref)
        ref_max = ref.float().abs().max().item()
        print(f"[kernel] flash_fwd {name}: shape q{tuple(q.shape)} "
              f"k{tuple(k.shape)} causal={causal} kv_lens={kv_lens} "
              f"q_offset={q_off}: max_abs_err {max_abs:.3e} (max |ref| "
              f"{ref_max:.3e}), max err / row's max |ref| {row_rel:.3e} "
              f"(tol {KERNEL_ROW_TOL})")
        if not ok:
            raise AssertionError(f"flash_fwd {name} disagrees with its plain version")
        if name == "tower":
            # the limit's power: attention without keys 64..127 must fail it
            keep = torch.cat([torch.arange(64, device=dev),
                              torch.arange(128, k.shape[2], device=dev)])
            dropped = flash_attention_reference(
                q, k[:, :, keep], v[:, :, keep], kv_lens=kv_t - 64)
            _, drop_rel, drop_ok = compare(dropped, ref)
            print(f"[kernel] flash_fwd tower without one 64-key tile: max err "
                  f"/ row's max |ref| {drop_rel:.3e} (must exceed {KERNEL_ROW_TOL})")
            if drop_ok:
                raise AssertionError("the kernel tolerance passes a dropped key tile")
        if name.startswith("serve_"):
            # the limit's power at the serving shapes: attention that skips
            # the last valid 64-key tile of the row must fail it
            col = torch.arange(k.shape[2], device=dev)[None, None, None, :]
            first = (kv_t[:, None, None, None] - 1) // 64 * 64
            _, drop_rel, drop_ok = compare(
                forward_dropping(q, k, v, kv_t, off_t, causal, col >= first), ref)
            print(f"[kernel] flash_fwd {name} without the last valid 64-key "
                  f"tile: max err / row's max |ref| {drop_rel:.3e} (must "
                  f"exceed {KERNEL_ROW_TOL})")
            if drop_ok:
                raise AssertionError(f"the kernel tolerance passes a dropped "
                                     f"key tile at {name}")
        # the library yardstick: one SDPA call with the same boolean mask
        col = torch.arange(k.shape[2], device=dev)
        mask = col[None, None, None, :] < kv_t[:, None, None, None]
        if causal:
            row = torch.arange(q.shape[2], device=dev)[None, None, :, None]
            mask = mask & (col[None, None, None, :] <= row + off_t[:, None, None, None])
        qc, kc, vc = q.contiguous(), k.contiguous(), v.contiguous()
        bound, bound_by, flops, nbytes = kernel_bound(
            "flash_fwd_lse" if name == "train" else "flash_fwd",
            q.shape[0], q.shape[1], q.shape[2], k.shape[2], q.shape[3],
            kv_lens, q_off, causal,
        )
        results[name] = {
            "max_abs_err": max_abs,
            "max_row_rel_err": row_rel,
            "ms": time_ms(run),
            "plain_ms": time_ms(lambda: flash_attention_reference(q, k, v, **kw), reps=5),
            "library_ms": time_ms(lambda: F.scaled_dot_product_attention(
                qc, kc, vc, attn_mask=mask)),
            "bound_ms": bound,
            "bound_by": bound_by,
            "gflop": flops / 1e9,
            "mbytes": nbytes / 1e6,
        }
        r = results[name]
        r.update(fwd_yardsticks(q, k, v, kv_t, off_t, causal, name == "train"))
        print(f"[kernel-time] flash_fwd {name}: kernel {r['ms']:.4f} ms, plain "
              f"{r['plain_ms']:.4f} ms, library (SDPA) {r['library_ms']:.4f} ms, "
              f"bound {r['bound_ms']:.4f} ms ({bound_by}: {r['gflop']:.2f} "
              f"GFLOP, {r['mbytes']:.2f} MB){yardstick_text(r)}")
    # the loop over K/V ends at kv_len and the diagonal, so a longer cache
    # row must not cost more: the same queries and kv_len over the
    # 2576-slot row against the 1040-slot row
    for short, long in (("serve_prefill", "serve_long"),
                        ("serve_prefill_full", "serve_long_full")):
        ratio = results[long]["ms"] / results[short]["ms"]
        print(f"[kernel] flash_fwd {long} over a {SERVE_LONG_CAPACITY}-slot row "
              f"{results[long]['ms']:.4f} ms against {short} over a "
              f"{SERVE_CAPACITY}-slot row {results[short]['ms']:.4f} ms: ratio "
              f"{ratio:.2f} (limit {CAPACITY_TIME_RATIO})")
        if ratio > CAPACITY_TIME_RATIO:
            raise AssertionError("flash_fwd's time grows with the cache row's "
                                 "capacity: it does not stop at kv_len")
    results.update(check_flash_c2_forward(gen))
    return results


def check_flash_c2_forward(gen):
    """C2 off the paths (no configuration runs them): the forward with its
    log-sum-exp (the autograd route's launch, through the head-dim padding)
    at f16 and head dims 160 and 256, against the plain version, beside a
    version without the last valid 64-key tile that must miss; timed
    against the bound, the plain version and one SDPA call."""
    import torch
    import torch.nn.functional as F

    from hsenet_torch.ops import flash_attention as tfa

    dev = "cuda"
    cases = [  # name, dtype, (batch, heads, sq, head dim), kv_lens, causal
        ("tower_f16", torch.float16, (2, 12, 2049, 64), (2049, 1900), False),
        ("train_f16", torch.float16, (3, 24, 800, 128), TRAIN_KV_LENS, True),
        ("d256", torch.bfloat16, (2, 16, 2048, 256), (2048, 1500), True),
        ("d256_f16", torch.float16, (2, 16, 1024, 256), (1024, 700), False),
        ("d160", torch.bfloat16, (2, 16, 1024, 160), (1024, 900), False),
    ]
    results = {}
    for name, dtype, (b, h, s, d), kv_lens, causal in cases:
        q, k, v = (torch.randn(b, h, s, d, generator=gen, device=dev, dtype=dtype)
                   for _ in range(3))
        kv_t = torch.tensor(kv_lens, dtype=torch.int32, device=dev)
        off_t = torch.zeros(b, dtype=torch.int32, device=dev)
        kw = dict(kv_lens=kv_t, causal=causal, q_offset=off_t)

        def run(q=q, k=k, v=v, kv_t=kv_t, off_t=off_t, causal=causal, d=d):
            return tfa._forward(q, k, v, kv_t, off_t, causal, d ** -0.5, True)

        out, lse = run()
        ref, ref_lse = tfa.flash_attention_reference(q, k, v, with_lse=True, **kw)
        max_abs, row_rel, ok = compare(out, ref)
        lse_err = (lse - ref_lse).abs().max().item()
        col = torch.arange(s, device=dev)[None, None, None, :]
        first = (kv_t[:, None, None, None] - 1) // 64 * 64
        _, drop_rel, drop_ok = compare(
            forward_dropping(q, k, v, kv_t, off_t, causal, col >= first), ref)
        print(f"[kernel] flash_fwd {name}: {str(dtype)[6:]} q{tuple(q.shape)} "
              f"causal={causal} kv_lens={kv_lens}: max_abs_err {max_abs:.3e}, "
              f"max err / row's max |ref| {row_rel:.3e} (tol {KERNEL_ROW_TOL}), "
              f"log-sum-exp max abs err {lse_err:.3e} (tol {LSE_ABS_TOL}); "
              f"without the last valid 64-key tile {drop_rel:.3e}")
        if not ok or not lse_err <= LSE_ABS_TOL:
            raise AssertionError(f"flash_fwd {name} disagrees with its plain version")
        if drop_ok:
            raise AssertionError(f"the kernel tolerance passes a dropped key tile at {name}")
        mask = tfa._valid(q, k, kv_t, off_t, causal)
        bound, bound_by, flops, nbytes = kernel_bound(
            "flash_fwd_lse", b, h, s, s, d, kv_lens, (0,) * b, causal)
        r = results[name] = {
            "max_abs_err": max_abs, "max_row_rel_err": row_rel,
            "ms": time_ms(run),
            "plain_ms": time_ms(lambda: tfa.flash_attention_reference(
                q, k, v, with_lse=True, **kw), reps=2, warmup=1, runs=3),
            "library_ms": time_ms(lambda: F.scaled_dot_product_attention(
                q, k, v, attn_mask=mask)),
            "bound_ms": bound, "bound_by": bound_by,
            "gflop": flops / 1e9, "mbytes": nbytes / 1e6,
            "dtype": str(dtype)[6:], "head_dim": d,
        }
        if d in tfa.SUPPORTED_HEAD_DIMS:
            r.update(fwd_yardsticks(q, k, v, kv_t, off_t, causal, True))
            more = yardstick_text(r)
        else:
            more = (f"; new / SDPA {r['ms'] / r['library_ms']:.3f} (the "
                    f"padded route: zero columns to "
                    f"{tfa.kernel_head_dim(d)} and the slice back included)")
        print(f"[kernel-time] flash_fwd {name}: kernel {r['ms']:.4f} ms, plain "
              f"{r['plain_ms']:.4f} ms, library (SDPA) {r['library_ms']:.4f} ms, "
              f"bound {bound:.4f} ms ({bound_by}: {r['gflop']:.2f} GFLOP, "
              f"{r['mbytes']:.2f} MB){more}")
        del q, k, v, out, ref, mask
    return results


def forward_dropping(q, k, v, kv_t, off_t, causal, drop, score_cols=None):
    """The plain forward with the (row, column) pairs of `drop` left out
    (and, with `score_cols`, the scores taken over only the first
    `score_cols` columns of Q and K): what a kernel that skipped those tiles
    (or those columns) would give."""
    import torch

    from hsenet_torch.ops import flash_attention as tfa

    keep = tfa._valid(q, k, kv_t, off_t, causal) & ~drop
    c = score_cols or q.shape[3]
    s = (q[..., :c].float() @ k[..., :c].float().transpose(-1, -2)) * q.shape[3] ** -0.5
    p = torch.softmax(s.masked_fill(~keep, -math.inf), dim=-1).nan_to_num(0.0)
    return (p @ v.float()).to(q.dtype)


def matvec_row_share(out, ref):
    """(max abs error, max error over its row's largest |ref|) of a matvec
    output; a non-finite output reads as an infinite share."""
    import torch

    err = (out.float() - ref.float()).abs()
    scale = ref.float().abs().amax(dim=-1, keepdim=True).clamp_min(1e-30)
    share = torch.where(out.float().isfinite(), err / scale, math.inf)
    return err.max().item(), share.max().item()


def matvec_codes(gen, k, n):
    """Seeded int8 codes (N, K) and f32 scales (N,) on the card."""
    import torch

    w = torch.randint(-127, 128, (n, k), generator=gen, device="cuda",
                      dtype=torch.int8)
    return w, (0.5 + torch.rand(n, generator=gen, device="cuda")) / (127 * k ** 0.5)


def hold_matvec(tag, kernel, x, w, scale, phase="kernel-matvec"):
    """One matvec entry against its plain version (MATVEC_ROW_TOL), two
    launches bit-equal, beside two wrong variants that must miss."""
    import torch

    from hsenet_torch.ops import quant_matvec as tqm

    out = kernel(x, w, scale)
    again = kernel(x, w, scale)
    torch.cuda.synchronize()
    ref = tqm.quant_matvec_int8_reference(x, w, scale)
    max_abs, share = matvec_row_share(out, ref)
    wrong = {
        "scales shifted by one channel":
            tqm.quant_matvec_int8_reference(x, w, scale.roll(1)),
        "last 16 codes of K dropped":
            tqm.quant_matvec_int8_reference(x[:, :-16], w[:, :-16], scale),
    }
    wrong = {what: matvec_row_share(o, ref)[1] for what, o in wrong.items()}
    same = torch.equal(out, again)
    print(f"[{phase}] {tag}: x{tuple(x.shape)} w_q{tuple(w.shape)} "
          f"int8: max_abs_err {max_abs:.3e}, max err / row's max |ref| "
          f"{share:.3e} (tol {MATVEC_ROW_TOL}); two launches bit-equal: "
          f"{same}; wrong variants: "
          + ", ".join(f"{what} {v:.3e}" for what, v in wrong.items()))
    if not share <= MATVEC_ROW_TOL:
        raise AssertionError(f"quant_matvec {tag} disagrees with its plain version")
    if not same:
        raise AssertionError(f"quant_matvec {tag}: two launches differ")
    for what, v in wrong.items():
        if v <= MATVEC_ROW_TOL:
            raise AssertionError(f"the matvec tolerance passes {what} ({tag})")


def time_matvec_cold(tag, name, k, n, gen, library, rows=(8, 1)):
    """At (K, N) and each M of `rows`, with the codes read cold: both
    entries in turns (new/old/old/new), the bound, the plain version, a
    bf16 matmul on a converted copy and, where `library`,
    `torch._weight_int8pack_mm`. Returns (results, yardstick) by key:
    `name` at M = 8, `name_m<M>` at another M."""
    import torch

    from hsenet_torch.ops import quant_matvec as tqm

    results, yardstick = {}, {}
    copies = int(MATVEC_COLD_BYTES // (k * n)) + 1
    w, scale = matvec_codes(gen, k, n)
    ws = [w] + [w.clone() for _ in range(copies - 1)]
    wbs = [t.to(torch.bfloat16) for t in ws]
    scale_b = scale.to(torch.bfloat16)
    turn = itertools.count()

    def cold(fn, pool):
        return lambda: fn(pool[next(turn) % copies])

    for m in rows:
        x = torch.randn(m, k, generator=gen, device="cuda", dtype=torch.bfloat16)
        ref = tqm.quant_matvec_int8_reference(x, w, scale)
        new_err = matvec_row_share(tqm.quant_matvec_mma_kernel(x, w, scale), ref)[0]
        old_err = matvec_row_share(tqm.quant_matvec_fma_kernel(x, w, scale), ref)[0]
        new = cold(lambda t: tqm.quant_matvec_mma_kernel(x, t, scale), ws)
        old = cold(lambda t: tqm.quant_matvec_fma_kernel(x, t, scale), ws)
        turns = [time_ms(f) for f in (new, old, old, new)]
        nbytes = k * n + 2 * m * k + 2 * m * n + 4 * n
        t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
        t_ops = 2 * m * k * n / PEAK_BF16_FLOPS * 1e3
        shared = {
            "plain_ms": time_ms(cold(
                lambda t: tqm.quant_matvec_int8_reference(x, t, scale), ws), reps=5),
            "library_ms": time_ms(cold(
                lambda t: torch.matmul(x, t.t()) * scale_b, wbs)),
            "int8pack_ms": time_ms(cold(
                lambda t: torch._weight_int8pack_mm(x, t, scale_b), ws))
            if library else None,
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "mbytes": nbytes / 1e6, "gflop": 2 * m * k * n / 1e9, "rows": m,
        }
        key = name if m == 8 else f"{name}_m{m}"
        r = results[key] = {"max_abs_err": new_err, "ms": (turns[0] + turns[3]) / 2,
                            "old_ms": (turns[1] + turns[2]) / 2, **shared}
        yardstick[key] = {"max_abs_err": old_err, "ms": r["old_ms"], **shared}
        lib8 = ("not registered" if r["int8pack_ms"] is None
                else f"{r['int8pack_ms']:.4f} ms")
        print(f"[{tag}] {name} M={m}, plan {tuple(tqm.mma_plan(m, k, n))}, codes "
              f"read cold ({copies} copies in turn), in turns new/old/old/new: "
              f"tensor cores {r['ms']:.4f} ms ({nbytes / r['ms'] / 1e6:.0f} GB/s, "
              f"{r['bound_ms'] / r['ms']:.1%} of the bound), CUDA cores "
              f"{r['old_ms']:.4f} ms ({nbytes / r['old_ms'] / 1e6:.0f} GB/s, "
              f"{r['bound_ms'] / r['old_ms']:.1%}); turns "
              + " / ".join(f"{t:.4f}" for t in turns)
              + f"; plain {r['plain_ms']:.4f} ms, bf16 matmul on a "
              f"converted copy {r['library_ms']:.4f} ms, _weight_int8pack_mm "
              f"{lib8}; bound {r['bound_ms']:.4f} ms ({r['bound_by']}: "
              f"{r['mbytes']:.2f} MB, {r['gflop']:.3f} GFLOP)")
    del ws, wbs
    return results, yardstick


def int8pack_registered() -> bool:
    import torch

    return torch._C._dispatch_has_kernel_for_dispatch_key(
        "aten::_weight_int8pack_mm", "CUDA")


def check_matvec_kernel():
    """B5: the tensor-core entry against its plain version in bf16 at
    Phi-4-mini's four (K, N), a ragged shape and the `--synthetic` shapes,
    every M in MATVEC_CHECK_ROWS, two launches bit-equal, two wrong
    variants beside each limit; the CUDA-core entry likewise in f32 at the
    synthetic shapes; the dispatcher's routes by dtype. Then, at the four
    path shapes, M = 8 and M = 1, with the codes read cold: both entries
    in turns, the bound, the plain version, a bf16 matmul on a converted
    copy and `torch._weight_int8pack_mm` where the card's PyTorch has a
    CUDA kernel for it (both library calls yardsticks only); and the
    tensor-core entry at the LM head's table beside its plain version and
    the same two library calls. Returns the numbers by shape of each
    entry."""
    import torch

    from hsenet_torch.ops import quant_matvec as tqm

    gen = torch.Generator(device="cuda").manual_seed(4)
    dev = "cuda"

    for name, (k, n) in {**MATVEC_SHAPES, **MATVEC_CHECK_SHAPES}.items():
        w, scale = matvec_codes(gen, k, n)
        for m in MATVEC_CHECK_ROWS:
            x = torch.randn(m, k, generator=gen, device=dev, dtype=torch.bfloat16)
            hold_matvec(f"{name} M={m} bf16, plan {tuple(tqm.mma_plan(m, k, n))}",
                        tqm.quant_matvec_mma_kernel, x, w, scale)
            if name in MATVEC_SYNTHETIC:
                hold_matvec(f"{name} M={m} f32, CUDA-core entry",
                            tqm.quant_matvec_fma_kernel, x.float(), w, scale)
        # the dispatcher with leading dimensions, as the decode step calls
        # it: bf16 on the tensor-core entry, f32 on the CUDA-core entry
        x = torch.randn(8, k, generator=gen, device=dev, dtype=torch.bfloat16)
        for dtype, kernel, want in (
                (torch.bfloat16, tqm.quant_matvec_mma_kernel, (1, 0)),
                (torch.float32, tqm.quant_matvec_fma_kernel, (0, 1))):
            tqm.reset_launch_counts()
            via = tqm.quant_matvec_int8(x.to(dtype).reshape(8, 1, k), w, scale)
            got = (tqm.launches[tqm.KERNEL], tqm.fma_launches[tqm.FMA])
            if via.shape != (8, 1, n) or got != want or not torch.equal(
                    via.reshape(8, n), kernel(x.to(dtype), w, scale)):
                raise AssertionError(f"quant_matvec_int8 in {dtype} does not "
                                     f"reach {kernel.__name__}")
    tqm.reset_launch_counts()

    # a launch's fixed time: both entries at the smallest synthetic shape
    # (codes and x in L2), beside one PyTorch launch that does next to
    # nothing
    w, scale = matvec_codes(gen, *MATVEC_CHECK_SHAPES["synthetic_64x32"])
    x = torch.randn(8, w.shape[1], generator=gen, device=dev, dtype=torch.bfloat16)
    tiny = torch.zeros(8, device=dev)
    floor = {"tensor-core entry": time_ms(
                 lambda: tqm.quant_matvec_mma_kernel(x, w, scale)),
             "CUDA-core entry": time_ms(
                 lambda: tqm.quant_matvec_fma_kernel(x, w, scale)),
             "zero_ of 8 floats": time_ms(tiny.zero_)}
    print(f"[kernel-matvec] a launch's floor, M=8 K 64 x N 32 and a tiny "
          f"PyTorch op, device ms: "
          + ", ".join(f"{what} {v:.4f}" for what, v in floor.items()))

    library = int8pack_registered()
    print(f"[kernel-matvec] torch._weight_int8pack_mm has a CUDA kernel: {library}")
    results, yardstick = {}, {}
    for name, (k, n) in MATVEC_SHAPES.items():
        r, y = time_matvec_cold("kernel-matvec", name, k, n, gen, library)
        results.update(r)
        yardstick.update(y)

    # the LM head's table (no path routes it through B5): the streaming
    # rate without a launch's fixed cost, beside the plain version, a bf16
    # matmul on a converted copy and torch._weight_int8pack_mm (the table's
    # 614 MB are read cold by every call: they exceed the L2 many times)
    k, n = MATVEC_LM_HEAD
    w, scale = matvec_codes(gen, k, n)
    x = torch.randn(8, k, generator=gen, device=dev, dtype=torch.bfloat16)
    max_abs, share = matvec_row_share(tqm.quant_matvec_mma_kernel(x, w, scale),
                                      tqm.quant_matvec_int8_reference(x, w, scale))
    nbytes = k * n + 2 * 8 * k + 2 * 8 * n + 4 * n
    wb, scale_b = w.to(torch.bfloat16), scale.to(torch.bfloat16)
    r = results[f"lm_head_{k}x{n}"] = {
        "max_abs_err": max_abs, "ms": time_ms(
            lambda: tqm.quant_matvec_mma_kernel(x, w, scale), reps=5),
        "old_ms": None,
        "plain_ms": time_ms(
            lambda: tqm.quant_matvec_int8_reference(x, w, scale), reps=3),
        "library_ms": time_ms(lambda: torch.matmul(x, wb.t()) * scale_b, reps=5),
        "int8pack_ms": time_ms(
            lambda: torch._weight_int8pack_mm(x, w, scale_b), reps=5)
        if library else None,
        "bound_ms": nbytes / PEAK_BYTES_PER_S * 1e3, "bound_by": "bytes",
        "mbytes": nbytes / 1e6, "gflop": 2 * 8 * k * n / 1e9, "rows": 8}
    lib8 = ("not registered" if r["int8pack_ms"] is None
            else f"{r['int8pack_ms']:.4f} ms")
    print(f"[kernel-matvec] LM head {k} x {n} at M=8 (off the path), plan "
          f"{tuple(tqm.mma_plan(8, k, n))}: {r['ms']:.4f} ms "
          f"({nbytes / r['ms'] / 1e6:.0f} GB/s, {r['bound_ms'] / r['ms']:.1%} of "
          f"the bound {r['bound_ms']:.4f} ms); plain {r['plain_ms']:.4f} ms, bf16 "
          f"matmul on a converted copy {r['library_ms']:.4f} ms, "
          f"_weight_int8pack_mm {lib8}; max err / row's max |ref| {share:.3e}")
    if not share <= MATVEC_ROW_TOL:
        raise AssertionError("quant_matvec disagrees at the LM head's shape")
    del w, wb
    return results, yardstick


def llm_training_qkv(randn):
    """q, k, v of one Phi layer at the training shape: q a head-split view
    of its (3, 800, 24 x 128) projection, k and v GQA-expanded from 8 kv
    heads (what `multi_head_attention` hands the kernels)."""
    from einops import rearrange

    b, s = len(TRAIN_KV_LENS), TRAIN_SEQ
    q = rearrange(randn(b, s, 24 * 128), "b s (n d) -> b n s d", n=24)
    k, v = (rearrange(randn(b, s, 8 * 128), "b s (n d) -> b n s d", n=8)
            .repeat_interleave(3, dim=1) for _ in range(2))
    return q, k, v


def row_rel(out, ref):
    """(max |out - ref|, max over rows of |out - ref| / the row's largest
    |ref|) of one backward output, a row being the last axis (a query row
    of dQ, a key row of dK and dV), each row's largest |ref| floored at
    BWD_ROW_FLOOR of the output's largest. A non-finite value gives inf."""
    import torch

    out, ref = out.float(), ref.float()
    err = (out - ref).abs()
    floor = max(BWD_ROW_FLOOR * ref.abs().max().item(), 1e-30)
    scale = ref.abs().amax(dim=-1, keepdim=True).clamp_min(floor)
    share = torch.where(out.isfinite(), err / scale, math.inf)
    return err.max().item(), share.max().item()


def backward_dropping(q, k, v, out, lse, do, kv_t, off_t, causal, drop,
                      score_cols=None):
    """The plain backward with the (row, column) pairs of `drop` left out of
    P (dQ, dK, dV in f32), and with `score_cols` the scores taken over only
    the first `score_cols` columns: what a kernel that skipped those tiles
    (or columns) would give."""
    import torch

    from hsenet_torch.ops import flash_attention as tfa

    scale = q.shape[3] ** -0.5
    qf, kf, vf, dof = q.float(), k.float(), v.float(), do.float()
    keep = tfa._valid(q, k, kv_t, off_t, causal) & ~drop
    c = score_cols or q.shape[3]
    p = torch.where(keep, torch.exp(qf[..., :c] @ kf[..., :c].transpose(-1, -2)
                                    * scale - lse.float()[..., None]), 0.0)
    delta = (dof * out.float()).sum(dim=-1, keepdim=True)
    ds = p * (dof @ vf.transpose(-1, -2) - delta) * scale
    return ds @ kf, ds.transpose(-1, -2) @ qf, p.transpose(-1, -2) @ dof


def wrong_backwards(q, k, v, out, lse, do, kv_t, off_t, causal):
    """Deliberately wrong backwards, by name: delta left out; the last
    valid 64-key tile of each batch row dropped; and under causal the
    diagonal tile (keys of the query's own 64-row tile) dropped."""
    import torch

    from hsenet_torch.ops import flash_attention as tfa

    dev = q.device
    col = torch.arange(k.shape[2], device=dev)[None, None, None, :]
    last_tile = (kv_t.clamp_min(1) - 1) // 64 * 64
    drops = {"last key tile dropped": col >= last_tile[:, None, None, None]}
    if causal:
        row = torch.arange(q.shape[2], device=dev)[None, None, :, None]
        drops["diagonal tile dropped"] = (
            col // 64 == (row + off_t[:, None, None, None]) // 64)
    wrong = {"delta left out": tfa.flash_attention_backward_reference(
        q, k, v, torch.zeros_like(out), lse, do, kv_t, off_t, causal)}
    for name, drop in drops.items():
        wrong[name] = backward_dropping(q, k, v, out, lse, do, kv_t, off_t,
                                        causal, drop)
    return wrong


def check_flash_bwd_kernels():
    """B3 (flash_bwd: dQ, dK and dV in one kernel) against its plain version
    at the training and tower shapes, with edge cases and wrong variants;
    timed beside the two kernels it replaced. Then C2 off the paths: f16
    (flash_bwd) and head dim 256 (the mma.sync pair flash_bwd_dq +
    flash_bwd_dkv, in bf16 and f16), held the same way."""
    import torch
    import torch.nn.functional as F
    from einops import rearrange

    from hsenet_torch.ops import flash_attention as tfa

    gen = torch.Generator(device="cuda").manual_seed(2)
    dev = "cuda"

    def randn(*shape, dtype=torch.bfloat16):
        return torch.randn(*shape, generator=gen, device=dev, dtype=dtype)

    # edge cases off the main path: Sq, Skv not multiples of 64, a batch
    # row with kv_len 0 (all its gradients exactly 0), a causal offset; in
    # bf16 and f16 at each kernel width
    for dtype, d in itertools.product((torch.bfloat16, torch.float16),
                                      (64, 128, 256)):
        for causal in (False, True):
            q, k, v = (randn(2, 3, n, d, dtype=dtype) for n in (70, 100, 100))
            kv_t = torch.tensor([0, 77], dtype=torch.int32, device=dev)
            off_t = torch.tensor([5, 9], dtype=torch.int32, device=dev)
            out, lse = tfa._forward_kernel(q, k, v, kv_t, off_t, causal,
                                           d ** -0.5, True)
            do = randn(*out.shape, dtype=dtype)
            got = tfa.flash_attention_backward(q, k, v, out, lse, do, kv_t,
                                               off_t, causal)
            want = tfa.flash_attention_backward_reference(
                q, k, v, out, lse, do, kv_t, off_t, causal)
            rels = [row_rel(g, w)[1] for g, w in zip(got, want)]
            zeros = all(torch.count_nonzero(g[0]) == 0 for g in got)
            print(f"[kernel-bwd] edge case {str(dtype)[6:]} d {d} causal={causal}: Sq 70, Skv "
                  f"100, kv_lens (0, 77), q_offset (5, 9): dQ/dK/dV err / row's "
                  f"max |ref| {rels[0]:.3e} {rels[1]:.3e} {rels[2]:.3e}, kv_len-0 "
                  f"row all zeros: {zeros}")
            if not (zeros and max(rels) <= KERNEL_BWD_TOL):
                raise AssertionError(f"flash backward edge case {dtype} d {d} "
                                     f"causal={causal} failed")

    tq, tk, tv = (rearrange(t, "b s (n d) -> b n s d", n=12)
                  for t in randn(2, 2049, 3 * 12 * 64).chunk(3, dim=-1))
    cases = [
        ("train", llm_training_qkv(randn), TRAIN_KV_LENS, (0, 0, 0), True),
        ("tower", (tq, tk, tv), (2049, 2049), (0, 0), False),
        # C2, off the paths
        ("train_f16", llm_training_qkv(
            lambda *sh: randn(*sh, dtype=torch.float16)), TRAIN_KV_LENS,
         (0, 0, 0), True),
        ("d256", tuple(randn(2, 16, 1024, 256) for _ in range(3)), (1024, 700),
         (0, 0), True),
        ("d256_f16", tuple(randn(2, 16, 1024, 256, dtype=torch.float16)
                           for _ in range(3)), (1024, 700), (0, 0), False),
    ]
    results = {}
    for name, (q, k, v), kv_lens, q_off, causal in cases:
        kv_t = torch.tensor(kv_lens, dtype=torch.int32, device=dev)
        off_t = torch.tensor(q_off, dtype=torch.int32, device=dev)
        scale = q.shape[3] ** -0.5
        out, lse = tfa._forward_kernel(q, k, v, kv_t, off_t, causal, scale, True)
        do = randn(*out.shape, dtype=q.dtype)
        got = tfa.flash_attention_backward(q, k, v, out, lse, do, kv_t, off_t,
                                           causal)
        want = tfa.flash_attention_backward_reference(
            q, k, v, out, lse, do, kv_t, off_t, causal)
        errs = {g: row_rel(a, b) for g, a, b in zip(("dq", "dk", "dv"), got, want)}
        past_kv = (torch.arange(k.shape[2], device=dev)[None, None, :, None]
                   >= kv_t[:, None, None, None])
        past_kv_zero = all(torch.count_nonzero(torch.where(past_kv, g, 0)) == 0
                           for g in got[1:])
        print(f"[kernel-bwd] {name}: {str(q.dtype)[6:]} q{tuple(q.shape)} "
              f"k{tuple(k.shape)} causal={causal} kv_lens={kv_lens}: err / "
              "row's max |ref| "
              + ", ".join(f"{g} {e[1]:.3e} (abs {e[0]:.3e})" for g, e in errs.items())
              + f" (tol {KERNEL_BWD_TOL}, floor {BWD_ROW_FLOOR} of the "
              f"output's max); dK, dV exactly 0 at keys past kv_len: {past_kv_zero}")
        if not past_kv_zero or max(e[1] for e in errs.values()) > KERNEL_BWD_TOL:
            raise AssertionError(f"flash backward {name} disagrees with its plain version")
        # the limit's power: each wrong variant must miss it
        for wname, wgrads in wrong_backwards(q, k, v, out, lse, do, kv_t,
                                             off_t, causal).items():
            wrels = [row_rel(a, b)[1] for a, b in zip(wgrads, want)]
            print(f"[kernel-bwd] {name} {wname}: dQ/dK/dV err / row's max "
                  f"|ref| {wrels[0]:.3e} {wrels[1]:.3e} {wrels[2]:.3e}")
            if max(wrels) <= KERNEL_BWD_TOL:
                raise AssertionError(f"the backward tolerance passes {wname}")
            del wgrads

        # dQ is summed by the TMA's reduce-add, in an order that changes
        # from run to run: the same call again, dQ's largest difference
        rerun = (tfa.flash_attention_backward(q, k, v, out, lse, do, kv_t, off_t,
                                              causal)[0].float()
                 - got[0].float()).abs().max().item()
        # device times against the bound, the plain version, one SDPA call's
        # backward, and the two mma.sync kernels flash_bwd replaced (their
        # bf16 instantiation, which no path launches any more)
        delta = (do.float() * out.float()).sum(dim=-1).contiguous()
        args = (q, k, v, do, lse, delta, kv_t, off_t, causal, scale)
        plain_ms = time_ms(lambda: tfa.flash_attention_backward_reference(
            q, k, v, out, lse, do, kv_t, off_t, causal), reps=3)
        mask = tfa._valid(q, k, kv_t, off_t, causal)
        leaves = [t.detach().contiguous().requires_grad_() for t in (q, k, v)]
        lib_out = F.scaled_dot_product_attention(*leaves, attn_mask=mask)
        library_ms = time_ms(lambda: torch.autograd.grad(
            lib_out, leaves, do, retain_graph=True))
        shape = (q.shape[0], q.shape[1], q.shape[2], k.shape[2], q.shape[3],
                  kv_lens, q_off, causal)
        common = {
            "max_abs_err": max(e[0] for e in errs.values()),
            "max_rel_err": max(e[1] for e in errs.values()),
            "plain_ms": plain_ms, "library_ms": library_ms,
            "dtype": str(q.dtype)[6:],
        }
        if q.shape[3] <= 128:
            bound, bound_by, flops, nbytes = kernel_bound("flash_bwd", *shape)
            r = results[name] = {
                **common,
                "dq_rerun_max_abs_diff": rerun,
                "ms": time_ms(lambda: tfa._bwd_kernel(*args)),
                "old_pair_ms": time_ms(lambda: (tfa._bwd_dq_kernel(*args),
                                                tfa._bwd_dkv_kernel(*args))),
                "bound_ms": bound,
                "bound_by": bound_by,
                "gflop": flops / 1e9,
                "mbytes": nbytes / 1e6,
            }
            print(f"[kernel-bwd] flash_bwd {name}: kernel {r['ms']:.4f} ms (the "
                  f"old dQ + dK/dV pair {r['old_pair_ms']:.4f} ms), plain "
                  f"{plain_ms:.4f} ms, library (SDPA backward) {library_ms:.4f} "
                  f"ms, bound {bound:.4f} ms ({bound_by}: {r['gflop']:.2f} GFLOP, "
                  f"{r['mbytes']:.2f} MB); dQ of a second run differs by at "
                  f"most {rerun:.3e}")
            continue
        # head dim 256: the mma.sync pair, each kernel timed and bounded on
        # its own (the plain and library times compute dQ, dK and dV), in
        # turns beside the wide route's kernels, which take 256 too: held to
        # the same limit, they show what the pair's half split of the output
        # columns is worth
        wide = (tfa._bwd_dq_kernel(*args, name="flash_bwd_dq_wide"),
                *tfa._bwd_dkv_kernel(*args, name="flash_bwd_dkv_wide"))
        wide_errs = [row_rel(a, b)[1] for a, b in zip(wide, want)]
        print(f"[kernel-bwd] {name} by the wide kernels: dQ/dK/dV err / row's "
              "max |ref| " + " ".join(f"{e:.3e}" for e in wide_errs)
              + f" (tol {KERNEL_BWD_TOL})")
        if max(wide_errs) > KERNEL_BWD_TOL:
            raise AssertionError(f"the wide backward disagrees at {name}")
        del wide
        for kernel, fn in (("flash_bwd_dq", tfa._bwd_dq_kernel),
                           ("flash_bwd_dkv", tfa._bwd_dkv_kernel)):
            bound, bound_by, flops, nbytes = kernel_bound(kernel, *shape)
            turns = {"pair": [], "wide": []}
            for which in ("pair", "wide", "wide", "pair"):
                kw = {} if which == "pair" else {"name": kernel + "_wide"}
                turns[which].append(time_ms(lambda fn=fn, kw=kw: fn(*args, **kw)))
            r = results.setdefault(kernel + "_d256", {})[name] = {
                **common, "ms": statistics.mean(turns["pair"]),
                "wide_ms": statistics.mean(turns["wide"]), "turns_ms": turns,
                "bound_ms": bound, "bound_by": bound_by,
                "gflop": flops / 1e9, "mbytes": nbytes / 1e6,
            }
            print(f"[kernel-bwd] {kernel} {name}: kernel {r['ms']:.4f} ms "
                  f"(the wide kernel {r['wide_ms']:.4f} ms; turns pair "
                  f"{turns['pair'][0]:.4f} {turns['pair'][1]:.4f}, wide "
                  f"{turns['wide'][0]:.4f} {turns['wide'][1]:.4f}), "
                  f"bound {bound:.4f} ms ({bound_by}: {r['gflop']:.2f} GFLOP, "
                  f"{r['mbytes']:.2f} MB); dQ, dK and dV: plain {plain_ms:.4f} "
                  f"ms, library (SDPA backward) {library_ms:.4f} ms")
    return results


def check_flash_wide():
    """[kernel-wide]: the wide route (ROADMAP C2, closed: bf16 and f16 above
    head dim 256, f32 above 128, padded to a multiple of 64) of the forward
    (with its log-sum-exp) and of dQ and dK/dV, against the plain versions
    at the true width, on small grids: edge cases (Skv 0, a kv_len-0 row,
    causal offsets), then each WIDE_CASES shape beside two planted faults
    that must miss (S over only the first 256 columns, 128 in f32 at 192
    and 256; the last 64 valid keys dropped), its launches counted on the
    wide kernels only; times at the padded width against the bound, the
    plain version and one SDPA call (forward, and its backward)."""
    import torch
    import torch.nn.functional as F

    from hsenet_torch.ops import flash_attention as tfa

    dev = "cuda"
    gen = torch.Generator(device=dev).manual_seed(13)

    def randn(*shape, dtype):
        return torch.randn(*shape, generator=gen, device=dev, dtype=dtype)

    def wide_only(tag, want):
        # every launch since the reset went to the wide kernels, as many as
        # `want` says
        got = {k: n for k, n in tfa.launches.items() if n}
        if got != want:
            raise AssertionError(f"{tag}: launches {got}, expected {want}: a "
                                 "wide call did not reach the wide kernels")

    def measures(dtype):
        # (forward measure, backward measure, forward / backward limit,
        # log-sum-exp limit) of a dtype: a share of each row's largest
        # value in bf16 and f16, of each (batch, head) slice's in f32
        if dtype == torch.float32:
            return slice_rel, slice_rel, KERNEL_F32_TOL, LSE_F32_ABS_TOL
        return (lambda o, r: compare(o, r)[:2], row_rel, KERNEL_BWD_TOL,
                LSE_ABS_TOL)

    # edge cases: Sq, Skv not multiples of 64, a batch row with kv_len 0,
    # causal offsets; then no keys at all
    for dtype, d in ((torch.bfloat16, 320), (torch.float16, 512),
                     (torch.float32, 192)):
        fwd_m, bwd_m, tol, _ = measures(dtype)
        for causal in (False, True):
            q, k, v = (randn(2, 3, n, d, dtype=dtype) for n in (70, 100, 100))
            kv_t = torch.tensor([0, 77], dtype=torch.int32, device=dev)
            off_t = torch.tensor([5, 9], dtype=torch.int32, device=dev)
            tfa.reset_launch_counts()
            out, lse = tfa._forward(q, k, v, kv_t, off_t, causal, d ** -0.5, True)
            do = randn(*out.shape, dtype=dtype)
            got = tfa.flash_attention_backward(q, k, v, out, lse, do, kv_t,
                                               off_t, causal)
            torch.cuda.synchronize()
            wide_only(f"wide edge case {dtype} d {d}", {
                "flash_fwd_wide": 1, "flash_bwd_dq_wide": 1, "flash_bwd_dkv_wide": 1})
            ref = tfa.flash_attention_reference(q, k, v, kv_lens=kv_t,
                                                causal=causal, q_offset=off_t)
            want = tfa.flash_attention_backward_reference(
                q, k, v, out, lse, do, kv_t, off_t, causal)
            rels = [fwd_m(out, ref)[1]] + [bwd_m(g, w)[1] for g, w in zip(got, want)]
            zeros = all(torch.count_nonzero(t[0]) == 0 for t in (out, *got))
            print(f"[kernel-wide] edge case {str(dtype)[6:]} d {d} (kernel width "
                  f"{tfa.kernel_head_dim(d, dtype)}) causal={causal}: Sq 70, Skv "
                  f"100, kv_lens (0, 77), q_offset (5, 9): out/dQ/dK/dV err "
                  + " ".join(f"{r:.3e}" for r in rels)
                  + f" (tol {tol}), kv_len-0 row all zeros: {zeros}")
            if not (zeros and max(rels) <= tol):
                raise AssertionError(f"wide edge case {dtype} d {d} causal={causal} failed")
        q = randn(1, 2, 5, d, dtype=dtype)
        leaf = q.detach().requires_grad_()
        zout = tfa.flash_attention(leaf, leaf[:, :, :0], leaf[:, :, :0])
        zgrad = torch.autograd.grad(zout, leaf, torch.ones_like(zout))[0]
        if torch.count_nonzero(zout) or torch.count_nonzero(zgrad):
            raise AssertionError(f"wide route over no keys ({dtype} d {d}) is not zero")
        print(f"[kernel-wide] edge case {str(dtype)[6:]} d {d} Skv 0: output and "
              "dQ all zeros")

    results = {"flash_fwd_wide": {}, "flash_bwd_dq_wide": {},
               "flash_bwd_dkv_wide": {}}
    for name, dtype_name, (b, h, sq, skv, d), kv_lens, q_off, causal in WIDE_CASES:
        dtype = getattr(torch, dtype_name)
        fwd_m, bwd_m, tol, lse_tol = measures(dtype)
        share_of = "slice" if dtype == torch.float32 else "row"
        q = randn(b, h, sq, d, dtype=dtype)
        k, v = (randn(b, h, skv, d, dtype=dtype) for _ in range(2))
        kv_t = torch.tensor(kv_lens, dtype=torch.int32, device=dev)
        off_t = torch.tensor(q_off, dtype=torch.int32, device=dev)
        scale, width = d ** -0.5, tfa.kernel_head_dim(d, dtype)
        kw = dict(kv_lens=kv_t, causal=causal, q_offset=off_t)
        tfa.reset_launch_counts()
        out, lse = tfa._forward(q, k, v, kv_t, off_t, causal, scale, True)
        do = randn(*out.shape, dtype=dtype)
        got = tfa.flash_attention_backward(q, k, v, out, lse, do, kv_t, off_t,
                                           causal)
        torch.cuda.synchronize()
        wide_only(f"wide {name}", {"flash_fwd_wide": 1, "flash_bwd_dq_wide": 1,
                                   "flash_bwd_dkv_wide": 1})
        ref, ref_lse = tfa.flash_attention_reference(q, k, v, with_lse=True, **kw)
        want = tfa.flash_attention_backward_reference(q, k, v, out, lse, do,
                                                      kv_t, off_t, causal)
        fwd_abs, fwd_rel = fwd_m(out, ref)
        lse_err = (lse - ref_lse).abs().max().item()
        errs = [bwd_m(g, w) for g, w in zip(got, want)]
        # the planted faults: S over the first 256 (f32: 128) columns only,
        # and the last 64 valid keys of each batch row dropped
        cut = 256 if d > 256 else 128
        col = torch.arange(skv, device=dev)[None, None, None, :]
        none = torch.zeros_like(col, dtype=torch.bool)
        drop = col >= kv_t[:, None, None, None] - 64
        wrong = {}
        for wname, dr, cols in ((f"S over the first {cut} columns", none, cut),
                                ("last 64 valid keys dropped", drop, None)):
            w_out = forward_dropping(q, k, v, kv_t, off_t, causal, dr, cols)
            w_grads = backward_dropping(q, k, v, out, lse, do, kv_t, off_t,
                                        causal, dr, cols)
            wrong[wname] = (fwd_m(w_out, ref)[1],
                            max(bwd_m(g, w)[1] for g, w in zip(w_grads, want)))
        print(f"[kernel-wide] {name}: {str(dtype)[6:]} q{tuple(q.shape)} "
              f"k{tuple(k.shape)} (kernel width {width}) causal={causal} "
              f"kv_lens={kv_lens} q_offset={q_off}: err / {share_of}'s max "
              f"|ref|: out {fwd_rel:.3e}, dQ/dK/dV {errs[0][1]:.3e} "
              f"{errs[1][1]:.3e} {errs[2][1]:.3e} (tol {tol}), log-sum-exp abs "
              f"{lse_err:.3e} (tol {lse_tol}); wrong variants (out, gradients): "
              + ", ".join(f"{w} {e[0]:.3e} {e[1]:.3e}" for w, e in wrong.items()))
        if not (max(fwd_rel, *(e[1] for e in errs)) <= tol and lse_err <= lse_tol):
            raise AssertionError(f"the wide route disagrees with its plain version at {name}")
        for w, (e_fwd, e_bwd) in wrong.items():
            if e_fwd <= tol or e_bwd <= tol:
                raise AssertionError(f"the wide route's limits pass {w} at {name}")

        # times at the padded width (the launchers on padded operands)
        qp, kp, vp, op, dop = (F.pad(t, (0, width - d)) for t in (q, k, v, out, do))
        delta = (dop.float() * op.float()).sum(dim=-1).contiguous()
        args = (qp, kp, vp, dop, lse, delta, kv_t, off_t, causal, scale)
        mask = tfa._valid(q, k, kv_t, off_t, causal)
        leaves = [t.detach().requires_grad_() for t in (q, k, v)]
        lib_out = F.scaled_dot_product_attention(*leaves, attn_mask=mask)
        lib_fwd = time_ms(lambda: F.scaled_dot_product_attention(
            *leaves, attn_mask=mask))
        lib_bwd = time_ms(lambda: torch.autograd.grad(lib_out, leaves, do,
                                                      retain_graph=True))
        plain_fwd = time_ms(lambda: tfa.flash_attention_reference(
            q, k, v, with_lse=True, **kw), reps=3)
        plain_bwd = time_ms(lambda: tfa.flash_attention_backward_reference(
            q, k, v, out, lse, do, kv_t, off_t, causal), reps=3)
        elem, peak = ((4, PEAK_TF32_FLOPS) if dtype == torch.float32
                      else (2, PEAK_BF16_FLOPS))
        timed = {
            "flash_fwd_wide": ("flash_fwd_lse", lambda: tfa._fwd_wide_kernel(
                qp, kp, vp, kv_t, off_t, causal, scale, True), plain_fwd,
                lib_fwd, fwd_abs),
            "flash_bwd_dq_wide": ("flash_bwd_dq", lambda: tfa._bwd_dq_kernel(
                *args, name="flash_bwd_dq_wide"), plain_bwd, lib_bwd, errs[0][0]),
            "flash_bwd_dkv_wide": ("flash_bwd_dkv", lambda: tfa._bwd_dkv_kernel(
                *args, name="flash_bwd_dkv_wide"), plain_bwd, lib_bwd,
                max(errs[1][0], errs[2][0])),
        }
        for kname, (kind, fn, plain_ms, lib_ms, err) in timed.items():
            bound, bound_by, flops, nbytes = kernel_bound(
                kind, b, h, sq, skv, d, kv_lens, q_off, causal, elem=elem,
                peak=peak)
            r = results[kname][name] = {
                "max_abs_err": err, "ms": time_ms(fn), "plain_ms": plain_ms,
                "library_ms": lib_ms, "bound_ms": bound, "bound_by": bound_by,
                "gflop": flops / 1e9, "mbytes": nbytes / 1e6,
                "dtype": str(dtype)[6:], "head_dim": d, "kernel_width": width,
            }
            print(f"[kernel-wide] {kname} {name}: kernel {r['ms']:.4f} ms at "
                  f"width {width}, plain {plain_ms:.4f} ms, library (SDPA"
                  f"{'' if kname == 'flash_fwd_wide' else ' backward, dQ, dK, dV'}) "
                  f"{lib_ms:.4f} ms, bound {bound:.4f} ms ({bound_by}: "
                  f"{r['gflop']:.3f} GFLOP, {r['mbytes']:.2f} MB)")
        del q, k, v, do, out, lse, got, want, args, leaves, lib_out, mask
        gc.collect()
        torch.cuda.empty_cache()
    return results


def clip_kernel_cases():
    """Every flash shape the CLIP paths launch, and the LLM's length past
    which the TPU streams its backward (checked, launched by no path): (name,
    (batch, heads, tokens, head_dim), kv_lens, causal, (batch rows, heads) a
    plain call takes at once, the forward's kinds on the paths)."""
    bert = CLIP_TEXT_LENS
    fwd_both = ("flash_fwd", "flash_fwd_lse")  # teacher / eval, and trained
    return [
        ("clip_tower", (CLIP_BATCH, 12, 2049, 64), (2049,) * CLIP_BATCH, False,
         (4, 12), fwd_both),
        ("clip_bert", (CLIP_BATCH, 12, 128, 64), bert, False, (CLIP_BATCH, 12),
         fwd_both),
        ("clip_long", (CLIP_LONG_BATCH, 12, 16385, 64), (16385,) * CLIP_LONG_BATCH,
         False, (1, 1), ("flash_fwd_lse",)),
        ("clip_long_bert", (CLIP_LONG_BATCH, 12, 128, 64), bert[:CLIP_LONG_BATCH],
         False, (CLIP_LONG_BATCH, 12), ("flash_fwd_lse",)),
        ("llm_long_4096", (1, 24, 4096, 128), (4096,), True, (1, 24),
         ("flash_fwd_lse",)),
        ("llm_long_3000", (1, 24, 4096, 128), (3000,), True, (1, 24),
         ("flash_fwd_lse",)),
    ]


def clip_shape_index():
    """(kind, batch, heads, sq, skv, head_dim) of a launch -> (kernel, shape
    name in the kernel JSON line), for every shape of `clip_kernel_cases`."""
    index = {}
    for name, (b, h, s, d), _, _, _, fwd_kinds in clip_kernel_cases():
        for kind in fwd_kinds:
            suffix = "_lse" if kind == "flash_fwd_lse" else ""
            index[(kind, b, h, s, s, d)] = ("flash_fwd", name + suffix)
        index[("flash_bwd", b, h, s, s, d)] = ("flash_bwd", name)
    return index


def by_chunks(fn, b, h, rows, heads):
    """`fn(i, hs)` over slices i of `rows` batch rows and hs of `heads`
    heads, its outputs (each (rows, heads, ...)) put back together: the
    plain versions at shapes where one call would hold too many f32 scores
    (one 16,385-token head's are 1.07 GB)."""
    import torch

    full = None
    for i0 in range(0, b, rows):
        for h0 in range(0, h, heads):
            i, hs = slice(i0, min(b, i0 + rows)), slice(h0, min(h, h0 + heads))
            outs = fn(i, hs)
            if full is None:
                full = [torch.empty((b, h, *o.shape[2:]), dtype=o.dtype,
                                    device=o.device) for o in outs]
            for f, o in zip(full, outs):
                f[i, hs] = o
    return full


def check_clip_kernels():
    """B1 and B3 at the CLIP paths' shapes (the towers at batch 24, BERT at
    24 x 12 x 128 with per-row kv_lens), B2 and B4's shapes (the fine-patch
    tower, 2 x 12 x 16,385 x 64, and the LLM's causal 1 x 24 x 4096 x 128 at
    kv_len 4096 and 3000), through `check_flash_cases`. The time per valid
    (query, key) pair at 16,385 tokens must stay within PAIR_TIME_RATIO of
    the time at 2,049."""
    results = check_flash_cases(clip_kernel_cases(), seed=9)
    # B2 and B4 at 16,385 tokens walk 8 times the keys of the tower's 2,049;
    # their time per valid pair must not grow with it
    for kname, suffix in (("flash_fwd", "_lse"), ("flash_bwd", "")):
        short, long = (results[kname][n + suffix] for n in ("clip_tower", "clip_long"))
        ratio = (long["ms"] / long["pairs"]) / (short["ms"] / short["pairs"])
        print(f"[kernel-time] {kname} per valid pair at 16,385 tokens over "
              f"2,049: {ratio:.3f} (limit {PAIR_TIME_RATIO})")
        if ratio > PAIR_TIME_RATIO:
            raise AssertionError(f"{kname}'s time per pair grows with the length")
        results[kname]["clip_long" + suffix]["pair_time_ratio"] = ratio
    return results


def check_flash_cases(cases, seed: int):
    """B1 (with the log-sum-exp and without, as each case's path launches
    it) and, where the path runs the backward (a forward with the
    log-sum-exp), B3 at each case's shape against the plain versions, a
    chunk of batch rows and heads at a time, beside wrong variants (on the
    first chunk); each timed against its bound, the plain version and one
    SDPA call (its backward for dQ, dK/dV). A case is (name, (batch, heads,
    tokens, head_dim), kv_lens, causal, (batch rows, heads) a plain call
    takes at once, the forward's kinds on the path)."""
    import torch
    import torch.nn.functional as F
    from einops import rearrange

    from hsenet_torch.ops import flash_attention as tfa

    dev = "cuda"
    gen = torch.Generator(device=dev).manual_seed(seed)
    results = {"flash_fwd": {}, "flash_bwd": {}}
    for name, (b, h, s, d), kv_lens, causal, (rows, heads), fwd_kinds in cases:
        with_bwd = "flash_fwd_lse" in fwd_kinds
        # q, k, v: head-split views of one packed projection, as the towers
        # hand them over
        qkv = torch.randn(b, s, 3 * h * d, generator=gen, device=dev,
                          dtype=torch.bfloat16)
        q, k, v = (rearrange(t, "b s (n d) -> b n s d", n=h)
                   for t in qkv.chunk(3, dim=-1))
        kv_t = torch.tensor(kv_lens, dtype=torch.int32, device=dev)
        off_t = torch.zeros(b, dtype=torch.int32, device=dev)
        q_off, scale = (0,) * b, d ** -0.5
        shape = (f"q{tuple(q.shape)} causal={causal} kv_lens "
                 f"{kv_lens if len(set(kv_lens)) > 1 else kv_lens[0]}")

        def plain_fwd(with_lse):
            return by_chunks(lambda i, hs: tfa.flash_attention_reference(
                q[i, hs], k[i, hs], v[i, hs], kv_lens=kv_t[i], causal=causal,
                q_offset=off_t[i], with_lse=True)[:1 + with_lse], b, h, rows, heads)

        out, lse = tfa._forward_kernel(q, k, v, kv_t, off_t, causal, scale, True)
        ref, ref_lse = plain_fwd(True)
        max_abs, rel, ok = compare(out, ref)
        lse_err = (lse - ref_lse).abs().max().item()
        # wrong variants on the first chunk: the last 64 valid keys left out
        # of the output and of the log-sum-exp (at 2,049 and 16,385 tokens
        # the last 64-key tile holds one key)
        i, hs = slice(0, min(rows, b)), slice(0, min(heads, h))
        col = torch.arange(s, device=dev)[None, None, None, :]
        _, drop_rel, drop_ok = compare(forward_dropping(
            q[i, hs], k[i, hs], v[i, hs], kv_t[i], off_t[i], causal,
            col >= kv_t[i, None, None, None] - 64), ref[i, hs])
        _, short_lse = tfa.flash_attention_reference(
            q[i, hs], k[i, hs], v[i, hs], kv_lens=kv_t[i] - 64, causal=causal,
            q_offset=off_t[i], with_lse=True)
        short_err = (short_lse - ref_lse[i, hs]).abs().max().item()
        print(f"[kernel] flash_fwd {name}: {shape}: max_abs_err {max_abs:.3e}, "
              f"max err / row's max |ref| {rel:.3e} (tol {KERNEL_ROW_TOL}), "
              f"log-sum-exp max abs err {lse_err:.3e} (tol {LSE_ABS_TOL}); "
              f"without the last 64 valid keys {drop_rel:.3e}, its log-sum-exp "
              f"{short_err:.3e}")
        if not ok or not lse_err <= LSE_ABS_TOL:
            raise AssertionError(f"flash_fwd {name} disagrees with its plain version")
        if drop_ok or short_err <= LSE_ABS_TOL:
            raise AssertionError(f"the forward limits pass 64 dropped keys at {name}")
        del ref, ref_lse

        do = torch.randn(out.shape, generator=gen, device=dev, dtype=torch.bfloat16)

        def plain_bwd():
            return by_chunks(lambda i, hs: tfa.flash_attention_backward_reference(
                q[i, hs], k[i, hs], v[i, hs], out[i, hs], lse[i, hs], do[i, hs],
                kv_t[i], off_t[i], causal), b, h, rows, heads)

        if with_bwd:
            got = tfa.flash_attention_backward(q, k, v, out, lse, do, kv_t, off_t, causal)
            rerun = (tfa.flash_attention_backward(q, k, v, out, lse, do, kv_t, off_t,
                                                  causal)[0].float()
                     - got[0].float()).abs().max().item()
            want = plain_bwd()
            errs = {g: row_rel(a, w) for g, a, w in zip(("dq", "dk", "dv"), got, want)}
            past_kv = (torch.arange(s, device=dev)[None, None, :, None]
                       >= kv_t[:, None, None, None])
            past_kv_zero = all(torch.count_nonzero(torch.where(past_kv, g, 0)) == 0
                               for g in got[1:])
            wrong = {}
            for wname, wgrads in wrong_backwards(
                    q[i, hs], k[i, hs], v[i, hs], out[i, hs], lse[i, hs], do[i, hs],
                    kv_t[i], off_t[i], causal).items():
                wrong[wname] = max(row_rel(a, w[i, hs])[1] for a, w in zip(wgrads, want))
                del wgrads
            print(f"[kernel-bwd] {name}: {shape}: err / row's max |ref| "
                  + ", ".join(f"{g} {e[1]:.3e} (abs {e[0]:.3e})" for g, e in errs.items())
                  + f" (tol {KERNEL_BWD_TOL}); dK, dV exactly 0 past kv_len: "
                  f"{past_kv_zero}; dQ of a second run differs by at most "
                  f"{rerun:.3e}; wrong variants: "
                  + ", ".join(f"{w} {e:.3e}" for w, e in wrong.items()))
            if not past_kv_zero or max(e[1] for e in errs.values()) > KERNEL_BWD_TOL:
                raise AssertionError(f"flash backward {name} disagrees with its plain version")
            for wname, e in wrong.items():
                if e <= KERNEL_BWD_TOL:
                    raise AssertionError(f"the backward tolerance passes {wname} at {name}")
            del got, want

        # times: the kernels, the plain versions (chunk by chunk), one SDPA
        # call and its backward (no mask where every key is valid, so that
        # it takes its flash route)
        full_kv = not causal and min(kv_lens) == s
        mask = None if full_kv else tfa._valid(q, k, kv_t, off_t, causal)
        leaves = [t.detach().contiguous().requires_grad_() for t in (q, k, v)]
        lib_out = F.scaled_dot_product_attention(*leaves, attn_mask=mask)
        lib_fwd = time_ms(lambda: F.scaled_dot_product_attention(
            *leaves, attn_mask=mask))
        lib_bwd = time_ms(lambda: torch.autograd.grad(lib_out, leaves, do,
                                                      retain_graph=True)) \
            if with_bwd else None
        del lib_out
        pairs = h * attention_pairs(s, s, kv_lens, q_off, causal)[0]
        timed = {}
        for kind in fwd_kinds:
            with_lse = kind == "flash_fwd_lse"
            timed[("flash_fwd", name + ("_lse" if with_lse else ""), kind)] = (
                lambda with_lse=with_lse: tfa._forward_kernel(
                    q, k, v, kv_t, off_t, causal, scale, with_lse),
                time_ms(lambda with_lse=with_lse: plain_fwd(with_lse), reps=1,
                        warmup=1, runs=3),
                lib_fwd, max_abs)
        delta = (do.float() * out.float()).sum(dim=-1).contiguous()
        args = (q, k, v, do, lse, delta, kv_t, off_t, causal, scale)
        if with_bwd:
            plain_b = time_ms(plain_bwd, reps=1, warmup=1, runs=3)
            timed[("flash_bwd", name, "flash_bwd")] = (
                lambda: tfa._bwd_kernel(*args), plain_b, lib_bwd,
                max(e[0] for e in errs.values()))
        for (kname, key, kind), (fn, plain_ms, lib_ms, err) in timed.items():
            bound, bound_by, flops, nbytes = kernel_bound(
                kind, b, h, s, s, d, kv_lens, q_off, causal)
            r = results[kname][key] = {
                "max_abs_err": err, "ms": time_ms(fn), "plain_ms": plain_ms,
                "library_ms": lib_ms, "bound_ms": bound, "bound_by": bound_by,
                "gflop": flops / 1e9, "mbytes": nbytes / 1e6, "pairs": pairs,
            }
            old = ""
            if kname == "flash_fwd":
                r.update(fwd_yardsticks(q, k, v, kv_t, off_t, causal,
                                        kind == "flash_fwd_lse"))
                old = yardstick_text(r)
            if kname == "flash_bwd":
                # the two mma.sync kernels flash_bwd replaced, in bf16
                r["old_pair_ms"] = time_ms(lambda: (tfa._bwd_dq_kernel(*args),
                                                    tfa._bwd_dkv_kernel(*args)))
                r["dq_rerun_max_abs_diff"] = rerun
                old = f" (the old dQ + dK/dV pair {r['old_pair_ms']:.4f} ms)"
            print(f"[kernel-time] {kname} {key}: kernel {r['ms']:.4f} ms{old}, "
                  f"plain {plain_ms:.4f} ms, library (SDPA"
                  f"{'' if kname == 'flash_fwd' else ' backward, dQ, dK, dV'}) "
                  f"{lib_ms:.4f} ms, bound {bound:.4f} ms ({bound_by}: "
                  f"{r['gflop']:.2f} GFLOP, {r['mbytes']:.2f} MB), "
                  f"{r['ms'] * 1e9 / pairs:.3f} ps a pair")
        del q, k, v, qkv, out, lse, do, leaves, delta, args, timed
        gc.collect()
        torch.cuda.empty_cache()
    return results


def synthetic_config():
    """The VLM of the CLIs' `--synthetic` runs (`cli.common.build_vlm_config`):
    f32, towers of hidden 32 over 4 heads (head dim 8) on 65 tokens, an LLM
    of 4 heads of 16."""
    import argparse

    from hsenet_torch.cli.common import build_vlm_config

    return build_vlm_config(argparse.Namespace(synthetic=True))


def run_cli_serve(card: str):
    """[cli-serve]: the serving CLI's documented examples on the card, as a
    user runs them (`python -m hsenet_torch.cli.serve ...`): the tiny f32
    VLM (towers at head dim 8, the LLM at 16), and the tiny int8 LLM with
    speculative decoding. Every request must finish, and every flash launch
    must be an f32 launch at the padded width 64. Returns the summaries and
    the launches by (kind, batch, heads, sq, skv, head_dim)."""
    import torch

    from hsenet_torch.cli.serve import main as serve_main
    from hsenet_torch.ops import flash_attention as tfa
    from hsenet_torch.ops import quant_matvec as tqm

    runs = {
        "synthetic": (["--synthetic", "--num-requests", "6"], 6),
        "speculative": (["--quant-int8", "--llm-only", "--synthetic",
                         "--speculative", "--draft-len", "7", "--ngram", "2"], 8),
    }
    numbers, shapes = {}, {}
    for name, (argv, n_requests) in runs.items():
        tfa.reset_launch_counts()
        tqm.reset_launch_counts()
        t0 = time.perf_counter()
        summary = serve_main(argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        f32 = {f"{kernel}_d{d}": n for (kernel, d), n in tfa.f32_launches.items()}
        all_fwd = tfa.launches["flash_fwd"]
        print(f"[cli-serve] {name}: hsenet_torch.cli.serve {' '.join(argv)} on "
              f"{card}: {summary['requests']} of {n_requests} requests, "
              f"{summary['tokens']} tokens, {wall:.1f} s; flash launches "
              f"{all_fwd}, f32 by (kernel, padded head dim) {f32}; "
              f"matvec launches: CUDA-core entry {tqm.fma_launches[tqm.FMA]}, "
              f"tensor-core entry {tqm.launches[tqm.KERNEL]} (f32 models: "
              "never the tensor-core entry)")
        if tqm.launches[tqm.KERNEL]:
            raise AssertionError(f"cli serve {name}: an f32 model launched the "
                                 "tensor-core matvec entry")
        if summary["requests"] != n_requests or summary["tokens"] < n_requests:
            raise AssertionError(f"cli serve {name}: not every request finished")
        if not all_fwd or tfa.f32_launches[("flash_fwd", 64)] != all_fwd:
            raise AssertionError(f"cli serve {name}: the flash forward did not "
                                 "run in f32 at the padded width")
        for key, n in tfa.shape_launches.items():
            shapes[key] = shapes.get(key, 0) + n
        numbers[name] = {**summary, "wall_s_measured": wall,
                         "f32_launches": f32,
                         "matvec_fma_launches": tqm.fma_launches[tqm.FMA]}
    return numbers, shapes


def run_train_f32(card: str):
    """[train-f32]: the VLM finetune step in f32 at the `--synthetic`
    configuration (towers frozen at head dim 8, LoRA on the LLM at head dim
    16, remat on), batch 3 of the finetune's lengths through `Trainer`: the
    f32 forward and the f32 dQ and dK/dV kernels at the padded width 64,
    launches counted over the timed steps, losses finite. Returns the
    numbers and the launches of one step by (kind, batch, heads, sq, skv,
    head_dim)."""
    import torch

    from hsenet_torch.configs import TrainConfig
    from hsenet_torch.models import init_random_
    from hsenet_torch.models.mllm import HSENetVLM
    from hsenet_torch.ops import flash_attention as tfa
    from hsenet_torch.train.train_state import TrainState, make_optimizer
    from hsenet_torch.train.trainer import Trainer, TrainerHooks
    from hsenet_torch.train.vlm import (
        make_vlm_train_step,
        to_training_dtypes,
        vlm_trainable_mask,
    )

    cfg = synthetic_config()
    model = HSENetVLM(cfg, dtype=torch.float32, device="cuda", remat=True)
    init_random_(model, torch.Generator(device="cuda").manual_seed(0))
    mask = vlm_trainable_mask(model)
    to_training_dtypes(model, mask)
    batch = training_batch(cfg)
    warm, timed = 1, 2
    train_cfg = TrainConfig(learning_rate=1e-3, total_steps=warm + timed,
                            log_every=1, eval_every=0, seed=0)
    tx = make_optimizer(train_cfg, mask)
    counts = {}

    def on_log(step, row):
        if step == warm:
            torch.cuda.synchronize()
            tfa.reset_launch_counts()
        if step == warm + timed:
            torch.cuda.synchronize()
            counts.update(f32=dict(tfa.f32_launches), all=dict(tfa.launches),
                          shapes=dict(tfa.shape_launches))
            fwd_route("train-f32", tfa.launches, tfa.f32_launches)

    trainer = Trainer(make_vlm_train_step(model, tx),
                      TrainState.create(model, tx), lambda: [batch], train_cfg,
                      hooks=TrainerHooks(on_log=on_log))
    trainer.fit()
    losses = [row["loss"] for row in trainer.history]
    step_ms = [1e3 / row["steps_per_sec"] for row in trainer.history[warm:]]
    per_step = {f"{k}_d{d}": n / timed for (k, d), n in counts["f32"].items()}
    expected = {"flash_fwd_d64": 2 * cfg.vision.num_layers + 2 * cfg.llm.num_layers,
                "flash_bwd_dq_d64": cfg.llm.num_layers,
                "flash_bwd_dkv_d64": cfg.llm.num_layers}
    print(f"[train-f32] on {card}: losses {[round(x, 4) for x in losses]}, "
          f"step {statistics.median(step_ms):.1f} ms; f32 flash launches per "
          f"step by (kernel, padded head dim) {per_step} (expected {expected})")
    if per_step != expected or sum(counts["all"].values()) != sum(
            counts["f32"].values()):
        raise AssertionError(f"f32 flash launches per step {per_step}, not {expected}")
    if not all(map(math.isfinite, losses)):
        raise AssertionError(f"f32 finetune losses not finite: {losses}")
    del model, trainer
    return ({"losses": losses, "step_ms": step_ms, "launches_per_step": per_step},
            {k: n // timed for k, n in counts["shapes"].items()})


def f32_kernel_cases(path_shapes):
    """The f32 shapes to check: each shape the f32 paths launched ([cli-serve],
    [train-f32]; towers non-causal over all their tokens, LLM shapes causal
    with the finetune's valid lengths or a whole prompt), QFormer's head dim
    96 over 8 heads, and the CLIP tower at 2 x 12 x 2049 x 64. (name, (batch,
    heads, sq, skv, true head dim), kv_lens, causal) by name, and the path's
    (kind, batch, heads, sq, skv, padded head dim) -> name."""
    cfg = synthetic_config()
    tower_d = cfg.vision.hidden_size // cfg.vision.num_heads
    cases, index = {}, {}
    for key in sorted(path_shapes):
        _, b, h, sq, skv, _ = key
        tower = sq == skv == cfg.vision.seq_len
        name = f"{'tower' if tower else 'llm'}_{b}x{h}x{sq}x{skv}"
        if tower:
            kv = (skv,) * b
        elif (b, sq) == (len(TRAIN_KV_LENS), TRAIN_SEQ):
            kv = TRAIN_KV_LENS
        else:
            kv = (min(sq, skv),) * b
        cases[name] = ((b, h, sq, skv, tower_d if tower else cfg.llm.head_dim),
                       kv, not tower)
        index[key] = name
    cases["qformer_d96"] = ((2, 8, 257, 257, 96), (257, 200), False)
    cases["clip_tower_f32"] = ((2, 12, 2049, 2049, 64), (2049, 2049), False)
    return cases, index


def slice_rel(out, ref):
    """(max |out - ref|, max over (batch, head) slices of |out - ref| over
    the slice's largest |ref|), the f32 route's measure; a non-finite value
    gives inf."""
    import torch

    out, ref = out.float(), ref.float()
    err = (out - ref).abs()
    scale = ref.abs().amax(dim=(-2, -1), keepdim=True).clamp_min(1e-30)
    share = torch.where(out.isfinite(), err / scale, math.inf)
    return err.max().item(), share.max().item()


def check_f32_kernels(path_shapes):
    """[kernel-f32]: the f32 route of flash_fwd (with and without the
    log-sum-exp), flash_bwd_dq and flash_bwd_dkv through the padding at the
    shapes of `f32_kernel_cases`, against the f32 plain versions at the true
    width, each beside a version with the softmax scale of the padded width
    (where the width is padded) and one without the last 64 valid keys that
    must miss the limits; times at the padded width against the bound at
    the TF32 peak, the plain version and f32 SDPA. Returns the results by
    kernel and shape name, and the path's launch key -> (kernel, name)."""
    import torch
    import torch.nn.functional as F

    from hsenet_torch.ops import flash_attention as tfa

    dev = "cuda"
    gen = torch.Generator(device=dev).manual_seed(11)
    cases, names = f32_kernel_cases(path_shapes)
    results = {"flash_fwd": {}, "flash_bwd_dq": {}, "flash_bwd_dkv": {}}
    for name, ((b, h, sq, skv, d), kv_lens, causal) in cases.items():
        q = torch.randn(b, h, sq, d, generator=gen, device=dev)
        k, v = (torch.randn(b, h, skv, d, generator=gen, device=dev) for _ in range(2))
        do = torch.randn(b, h, sq, d, generator=gen, device=dev)
        kv_t = torch.tensor(kv_lens, dtype=torch.int32, device=dev)
        off_t = torch.zeros(b, dtype=torch.int32, device=dev)
        q_off, scale, width = (0,) * b, d ** -0.5, tfa.kernel_head_dim(d, torch.float32)
        kw = dict(kv_lens=kv_t, causal=causal, q_offset=off_t)

        out = tfa.flash_attention(q, k, v, **kw)
        out_l, lse = tfa._forward(q, k, v, kv_t, off_t, causal, scale, True)
        got = tfa.flash_attention_backward(q, k, v, out_l, lse, do, kv_t, off_t,
                                           causal)
        ref, ref_lse = tfa.flash_attention_reference(q, k, v, with_lse=True, **kw)
        want = tfa.flash_attention_backward_reference(q, k, v, out_l, lse, do,
                                                      kv_t, off_t, causal)
        fwd_abs, fwd_rel = slice_rel(out, ref)
        fwd_rel_l = slice_rel(out_l, ref)[1]
        fwd_row = compare(out, ref, KERNEL_F32_TOL)[1]
        lse_err = (lse - ref_lse).abs().max().item()
        errs = [slice_rel(g, w) for g, w in zip(got, want)]
        past_kv = (torch.arange(skv, device=dev)[None, None, :, None]
                   >= kv_t[:, None, None, None])
        zeros = all(torch.count_nonzero(torch.where(past_kv, g, 0)) == 0
                    for g in got[1:])
        # the limits' power: the true width's scale replaced by the padded
        # width's, and the last 64 valid keys dropped
        wrong = {}
        if width != d:
            pad_scale = width ** -0.5
            w_out, w_lse = tfa.flash_attention_reference(
                q, k, v, with_lse=True, sm_scale=pad_scale, **kw)
            w_grads = tfa.flash_attention_backward_reference(
                q, k, v, out_l, lse, do, kv_t, off_t, causal, pad_scale)
            wrong["sm_scale of the padded width"] = (
                slice_rel(w_out, ref)[1],
                (w_lse - ref_lse).abs().max().item(),
                max(slice_rel(g, w)[1] for g, w in zip(w_grads, want)))
        col = torch.arange(skv, device=dev)[None, None, None, :]
        drop = col >= kv_t[:, None, None, None] - 64
        _, short_lse = tfa.flash_attention_reference(
            q, k, v, with_lse=True, **{**kw, "kv_lens": kv_t - 64})
        wrong["last 64 valid keys dropped"] = (
            slice_rel(forward_dropping(q, k, v, kv_t, off_t, causal, drop),
                      ref)[1],
            (short_lse - ref_lse).abs().max().item(),
            max(slice_rel(g, w)[1] for g, w in zip(backward_dropping(
                q, k, v, out_l, lse, do, kv_t, off_t, causal, drop), want)))
        print(f"[kernel-f32] {name}: q{tuple(q.shape)} k{tuple(k.shape)} f32, "
              f"padded to {width}, causal={causal} kv_lens "
              f"{kv_lens if len(set(kv_lens)) > 1 else kv_lens[0]}: err / "
              f"(batch, head) slice's max |ref|: forward {fwd_rel:.3e} (with "
              f"the log-sum-exp {fwd_rel_l:.3e}; per row {fwd_row:.3e}), "
              f"log-sum-exp abs {lse_err:.3e} (tol "
              f"{LSE_F32_ABS_TOL}), dQ/dK/dV {errs[0][1]:.3e} {errs[1][1]:.3e} "
              f"{errs[2][1]:.3e} (tol {KERNEL_F32_TOL}); dK, dV exactly 0 "
              f"past kv_len: {zeros}; wrong variants (forward, log-sum-exp, "
              "backward): " + ", ".join(
                  f"{w} {e[0]:.3e} {e[1]:.3e} {e[2]:.3e}" for w, e in wrong.items()))
        if not (max(fwd_rel, fwd_rel_l, *(e[1] for e in errs)) <= KERNEL_F32_TOL
                and lse_err <= LSE_F32_ABS_TOL and zeros):
            raise AssertionError(f"f32 flash kernels disagree with their plain "
                                 f"versions at {name}")
        for w, (e_fwd, e_lse, e_bwd) in wrong.items():
            if (e_fwd <= KERNEL_F32_TOL or e_lse <= LSE_F32_ABS_TOL
                    or e_bwd <= KERNEL_F32_TOL):
                raise AssertionError(f"the f32 limits pass {w} at {name}")

        # times at the padded width (the launchers on padded operands)
        pad = [F.pad(t, (0, width - d)) for t in (q, k, v, out_l, do)]
        qp, kp, vp, op, dop = pad
        delta = (dop * op).sum(dim=-1).contiguous()
        args = (qp, kp, vp, dop, lse, delta, kv_t, off_t, causal, scale)
        mask = tfa._valid(q, k, kv_t, off_t, causal)
        leaves = [t.detach().requires_grad_() for t in (q, k, v)]
        lib_out = F.scaled_dot_product_attention(*leaves, attn_mask=mask)
        lib_fwd = time_ms(lambda: F.scaled_dot_product_attention(
            *leaves, attn_mask=mask))
        lib_bwd = time_ms(lambda: torch.autograd.grad(lib_out, leaves, do,
                                                      retain_graph=True))
        plain_fwd = time_ms(lambda: tfa.flash_attention_reference(q, k, v, **kw),
                            reps=3)
        plain_bwd = time_ms(lambda: tfa.flash_attention_backward_reference(
            q, k, v, out_l, lse, do, kv_t, off_t, causal), reps=3)
        timed = {
            ("flash_fwd", name, "flash_fwd"): (
                lambda: tfa._forward_kernel(qp, kp, vp, kv_t, off_t, causal,
                                            scale, False),
                plain_fwd, lib_fwd, fwd_abs),
            ("flash_fwd", name + "_lse", "flash_fwd_lse"): (
                lambda: tfa._forward_kernel(qp, kp, vp, kv_t, off_t, causal,
                                            scale, True),
                plain_fwd, lib_fwd, fwd_abs),
            ("flash_bwd_dq", name, "flash_bwd_dq"): (
                lambda: tfa._bwd_dq_kernel(*args), plain_bwd, lib_bwd, errs[0][0]),
            ("flash_bwd_dkv", name, "flash_bwd_dkv"): (
                lambda: tfa._bwd_dkv_kernel(*args), plain_bwd, lib_bwd,
                max(errs[1][0], errs[2][0])),
        }
        for (kname, key, kind), (fn, plain_ms, lib_ms, err) in timed.items():
            bound, bound_by, flops, nbytes = kernel_bound(
                kind, b, h, sq, skv, d, kv_lens, q_off, causal, elem=4,
                peak=PEAK_TF32_FLOPS)
            r = results[kname][key] = {
                "max_abs_err": err, "ms": time_ms(fn), "plain_ms": plain_ms,
                "library_ms": lib_ms, "bound_ms": bound, "bound_by": bound_by,
                "gflop": flops / 1e9, "mbytes": nbytes / 1e6,
            }
            print(f"[kernel-f32] {kname} {key}: kernel {r['ms']:.4f} ms at "
                  f"width {width}, plain {plain_ms:.4f} ms, library (f32 SDPA"
                  f"{'' if kname == 'flash_fwd' else ' backward, dQ, dK, dV'}) "
                  f"{lib_ms:.4f} ms, bound {bound:.4f} ms at the TF32 peak "
                  f"({bound_by}: {r['gflop']:.3f} GFLOP, {r['mbytes']:.2f} MB)")
        del q, k, v, do, out, out_l, lse, got, want, pad, args, leaves, lib_out
        gc.collect()
        torch.cuda.empty_cache()
    index = {}
    for key, name in names.items():
        kind = key[0]
        kernel = "flash_fwd" if kind.startswith("flash_fwd") else kind
        index[key] = (kernel, name + ("_lse" if kind == "flash_fwd_lse" else ""))
    return results, index


def run_main_path(card: str):
    """The full-width main path. Returns the flash launches of one
    generate run, in all and at each path shape, the main path's numbers
    and the model ([export] exports its encode)."""
    import torch

    from hsenet_torch.configs import VLMConfig
    from hsenet_torch.eval.generate import make_greedy_generate
    from hsenet_torch.models import init_random_
    from hsenet_torch.models.mllm import HSENetVLM, splice_image_embeds
    from hsenet_torch.models.phi3 import KVCache
    from hsenet_torch.ops import attention
    from hsenet_torch.ops import flash_attention as tfa

    cfg = VLMConfig()
    dev = "cuda"
    t0 = time.perf_counter()
    model = HSENetVLM(cfg, dtype=torch.bfloat16, device=dev)
    init_random_(model, torch.Generator(device=dev).manual_seed(0))
    model.eval()
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    print(f"[main] HSENetVLM(VLMConfig()) with {n_params / 1e9:.3f} B "
          f"parameters in bf16, random weights (seed 0), built in "
          f"{time.perf_counter() - t0:.1f} s")

    gen = torch.Generator(device=dev).manual_seed(1)
    b = len(KV_LENS)
    n_img = cfg.num_image_tokens
    ids = torch.randint(3, 100000, (b, PROMPT_LEN), generator=gen, device=dev)
    ids[:, 0] = 1  # BOS
    ids[:, 1:1 + n_img] = IM_PATCH_TOKEN_ID
    kv_lens = torch.tensor(KV_LENS, dtype=torch.int32, device=dev)
    for row, n in enumerate(KV_LENS):
        ids[row, n:] = 0  # right padding
    volume = torch.rand((b, 1, *cfg.vision.image_size), generator=gen,
                        device=dev)
    slices = torch.randn((b, cfg.vision.num_slices,
                          cfg.vision.slice_feature_dim), generator=gen,
                         device=dev)
    capacity = PROMPT_LEN + MAX_NEW_TOKENS

    with torch.inference_mode():
        # the first encode and prefill warm up cuBLAS handles and the
        # allocator
        feats = model.encode_images(volume, slices)
        embeds = splice_image_embeds(model.llm.embed_tokens(ids), feats)

        def prefill():
            return model.llm.decode_embeds(
                embeds, kv_lens=kv_lens, last_token_only=True,
                cache=KVCache.create(cfg.llm, b, capacity, device=dev))

        prefill()
        logits, cache = prefill()
        steps = MAX_NEW_TOKENS - 1

        def decode():
            token = prefill_token
            for _ in range(steps):
                step_logits, _ = model.decode_step(token, decode_cache)
                token = step_logits.argmax(dim=-1, keepdim=True)

        # host-clock times of the phases, median of several runs each (the
        # host is shared, so one run can be far off)
        encode_ms = median_wall_ms(lambda: model.encode_images(volume, slices))
        prefill_ms = median_wall_ms(prefill)
        decode_runs = []
        for _ in range(3):
            step_logits, decode_cache = prefill()
            prefill_token = step_logits[:, 0].argmax(dim=-1, keepdim=True)
            decode_runs.append(median_wall_ms(decode, runs=1))
        decode_ms = statistics.median(decode_runs)
        token = prefill_token

        # where the device time goes in each phase, and its idle share
        # against the unprofiled wall times above
        profiles = {
            "encode": profile_phase(
                "encode", lambda: model.encode_images(volume, slices),
                encode_ms),
            "prefill": profile_phase("prefill", prefill, prefill_ms),
            "decode_step": profile_phase(
                "decode step", lambda: model.decode_step(token, cache),
                decode_ms / steps),
        }

        # the same prefill through the plain sdpa path, same weights
        ref_cache = KVCache.create(cfg.llm, b, capacity, device=dev)
        try:
            attention.set_flash_mode("never")
            ref_logits, _ = model.llm.decode_embeds(
                embeds, kv_lens=kv_lens, cache=ref_cache, last_token_only=True)
        finally:
            attention.set_flash_mode("auto")
    got, want = logits[:, 0].float(), ref_logits[:, 0].float()
    if not (torch.isfinite(got).all() and torch.isfinite(want).all()):
        raise AssertionError("prefill logits are not finite")
    rel_l2 = ((got - want).norm() / want.norm()).item()
    max_abs = (got - want).abs().max().item()
    same_argmax = (got.argmax(-1) == want.argmax(-1)).float().mean().item()
    print(f"[main] prefill last-token logits, kernel vs plain sdpa: rel L2 "
          f"{rel_l2:.3e} (tol {LOGITS_REL_L2}), max abs {max_abs:.3e}, "
          f"logit std {want.std().item():.3f}, same argmax in "
          f"{same_argmax:.0%} of rows")
    if rel_l2 > LOGITS_REL_L2:
        raise AssertionError("prefill logits through the kernel disagree with sdpa")
    # the limit's power: prefill through a kernel that skips the last 64
    # valid keys of each row must miss it
    sound = tfa._forward_kernel
    try:
        tfa._forward_kernel = lambda q, k, v, kv, *rest, **kw: sound(
            q, k, v, (kv - 64).clamp_min(1), *rest, **kw)
        with torch.inference_mode():
            short_logits, _ = prefill()
    finally:
        tfa._forward_kernel = sound
    short_rel = ((short_logits[:, 0].float() - want).norm() / want.norm()).item()
    print(f"[main] prefill last-token logits through a kernel without the "
          f"last 64 keys, vs plain sdpa: rel L2 {short_rel:.3e}")
    if short_rel <= LOGITS_REL_L2:
        raise AssertionError("the logits tolerance passes 64 dropped keys")

    generate = make_greedy_generate(model, max_new_tokens=MAX_NEW_TOKENS,
                                    eos_token_id=EOS_TOKEN_ID)
    torch.cuda.reset_peak_memory_stats()
    tfa.reset_launch_counts()  # the main path, counted
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tokens = generate(ids, kv_lens, volume, slices)
    torch.cuda.synchronize()
    generate_ms = (time.perf_counter() - t0) * 1e3
    launches = sum(tfa.launches.values())
    fwd_route("main", tfa.launches, tfa.f32_launches)
    by_d = tfa.fwd_launches  # d 64: towers, 128: prefill; no log-sum-exp
    by_shape = {"tower": by_d[(cfg.vision.hidden_size // cfg.vision.num_heads, False)],
                "prefill": by_d[(cfg.llm.head_dim, False)]}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    expected = {"tower": 2 * cfg.vision.num_layers, "prefill": cfg.llm.num_layers}
    print(f"[main] generate: tokens {tuple(tokens.shape)}, flash launches "
          f"{launches}: {by_shape} (expected {expected})")
    if by_shape != expected or launches != sum(expected.values()):
        raise AssertionError(f"flash kernel launched {launches} times "
                             f"({by_shape}), not {expected}")
    if tokens.shape != (b, MAX_NEW_TOKENS) or not bool(
            ((tokens >= 0) & (tokens < cfg.llm.vocab_size)).all()):
        raise AssertionError("generated tokens outside the vocabulary")
    numbers = {
        "encode_ms": encode_ms,
        "prefill_ms": prefill_ms,
        "decode_tokens_per_s": b * steps / (decode_ms / 1e3),
        "generate_ms": generate_ms,
        "peak_memory_gb": peak_gb,
        "profiles": profiles,
        "batch": b,
        "max_new_tokens": MAX_NEW_TOKENS,
    }
    print(f"[main] on {card}: encode {encode_ms:.2f} ms, prefill (LLM, "
          f"320 tokens x 2) {prefill_ms:.2f} ms, decode "
          f"{numbers['decode_tokens_per_s']:.1f} tokens/s at batch {b}, "
          f"generate end to end {generate_ms:.1f} ms, peak memory "
          f"{peak_gb:.2f} GB")
    print(f"[main] first tokens: {tokens[:, :8].tolist()}")
    return launches, by_shape, numbers, model


def training_batch(cfg):
    """The finetune's batch, made as its dataset makes one: BOS + 256
    <im_patch> + prompt, then a report of seeded random words, tokenized by
    `tokenize_qa_sample` right-padded to TRAIN_SEQ (valid lengths
    TRAIN_KV_LENS), collated by the port's `DataLoader`; random volumes and
    slice features from a seeded numpy generator."""
    import numpy as np

    from hsenet_torch.data.datasets import (
        IM_PATCH_TOKEN,
        SPECIAL_TOKENS,
        DataArgs,
        DataLoader,
        SimpleTokenizer,
        tokenize_qa_sample,
    )

    tokenizer = SimpleTokenizer(vocab_size=cfg.llm.vocab_size)
    tokenizer.add_special_tokens({"additional_special_tokens": SPECIAL_TOKENS})
    args = DataArgs(max_length=TRAIN_SEQ, proj_out_num=cfg.num_image_tokens)
    rng = np.random.default_rng(3)
    question = IM_PATCH_TOKEN * args.proj_out_num + "Describe the scan."
    q_len = 1 + args.proj_out_num + 3  # BOS, image block, three words

    class Reports:
        def __len__(self):
            return len(TRAIN_KV_LENS)

        def __getitem__(self, i):
            words = rng.integers(0, 5000, TRAIN_KV_LENS[i] - q_len)
            tok = tokenize_qa_sample(
                tokenizer, question, " ".join(f"w{w}" for w in words),
                args.max_length,
            )
            return {
                "image": rng.random((1, *cfg.vision.image_size), np.float32),
                "image_2d": rng.standard_normal(
                    (cfg.vision.num_slices, cfg.vision.slice_feature_dim)
                ).astype(np.float32),
                **{k: tok[k] for k in ("input_ids", "attention_mask", "labels")},
            }

    batch = next(iter(DataLoader(Reports(), len(TRAIN_KV_LENS), shuffle=False)))
    valid = tuple(int(n) for n in batch["attention_mask"].sum(axis=1))
    if valid != TRAIN_KV_LENS:
        raise AssertionError(f"training batch valid lengths {valid}, not {TRAIN_KV_LENS}")
    return batch


def finetune_config():
    """The finetune's configuration, as `cli.common.build_vlm_config` (the
    JAX package's `cli/train_vlm.py::build_vlm_config`) makes it for a real run:
    `VLMConfig()` with LoRA (rank 16, alpha 32) on the Phi-4-mini LLM."""
    import argparse

    from hsenet_torch.cli.common import build_vlm_config

    return build_vlm_config(argparse.Namespace(synthetic=False))


def build_finetune_model(cfg, remat: bool = True):
    """The finetune's model on the card: bf16 modules with random weights
    (seed 0), trainable leaves (LoRA, packers, tied embedding) held as f32
    masters, everything else frozen."""
    import torch

    from hsenet_torch.models import init_random_
    from hsenet_torch.models.mllm import HSENetVLM
    from hsenet_torch.train.vlm import to_training_dtypes, vlm_trainable_mask

    model = HSENetVLM(cfg, dtype=torch.bfloat16, device="cuda", remat=remat)
    init_random_(model, torch.Generator(device="cuda").manual_seed(0))
    mask = vlm_trainable_mask(model)
    to_training_dtypes(model, mask)
    return model, mask


def run_train_path(card: str):
    """The finetune at full width: Trainer + make_vlm_train_step for warm-up
    and timed steps on one batch. Returns the launches per step by kind and
    the phase's numbers."""
    import torch

    from hsenet_torch.configs import TrainConfig
    from hsenet_torch.ops import flash_attention as tfa
    from hsenet_torch.train.train_state import TrainState, make_optimizer
    from hsenet_torch.train.trainer import Trainer, TrainerHooks
    from hsenet_torch.train.vlm import make_vlm_eval_fn, make_vlm_train_step

    cfg = finetune_config()
    t0 = time.perf_counter()
    model, mask = build_finetune_model(cfg)
    n_train = sum(p.numel() for n, p in model.named_parameters() if mask[n])
    n_all = sum(p.numel() for p in model.parameters())
    print(f"[train] HSENetVLM(VLMConfig() + LoRA r{cfg.llm.lora.rank}/a"
          f"{cfg.llm.lora.alpha}), remat on: {n_all / 1e9:.3f} B parameters, {n_train / 1e6:.1f} M "
          f"trainable (f32), built in {time.perf_counter() - t0:.1f} s")
    batch = training_batch(cfg)
    total = TRAIN_WARMUP_STEPS + TRAIN_TIMED_STEPS
    train_cfg = TrainConfig(learning_rate=1e-4, total_steps=total,
                            log_every=1, eval_every=0, seed=0)
    tx = make_optimizer(train_cfg, mask)
    state = TrainState.create(model, tx)
    step_fn = make_vlm_train_step(model, tx)
    counts = {}

    def on_log(step, row):
        if step == TRAIN_WARMUP_STEPS:  # the timed steps start here
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            tfa.reset_launch_counts()
        if step == total:
            counts.update(kernels=dict(tfa.launches), fwd=dict(tfa.fwd_launches))
            fwd_route("train", tfa.launches, tfa.f32_launches)

    trainer = Trainer(step_fn, state, lambda: [batch], train_cfg,
                      hooks=TrainerHooks(on_log=on_log))
    state = trainer.fit()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    hist = trainer.history
    losses = [row["loss"] for row in hist]
    timed = hist[TRAIN_WARMUP_STEPS:]
    step_ms = [1e3 / row["steps_per_sec"] for row in timed]
    med = statistics.median(step_ms)
    tokens = sum(TRAIN_KV_LENS)
    per_step = {
        "fwd_d64": counts["fwd"][(64, False)] / TRAIN_TIMED_STEPS,
        "fwd_d128_lse": counts["fwd"][(128, True)] / TRAIN_TIMED_STEPS,
        "bwd": counts["kernels"]["flash_bwd"] / TRAIN_TIMED_STEPS,
    }
    expected = {"fwd_d64": 2 * cfg.vision.num_layers,
                "fwd_d128_lse": 2 * cfg.llm.num_layers,
                "bwd": cfg.llm.num_layers}
    print(f"[train] losses by step: {[round(x, 4) for x in losses]}")
    print(f"[train] grad norms by step: "
          f"{[round(row['grad_norm'], 4) for row in hist]}")
    print(f"[train] flash launches per step: {per_step} (expected {expected}); "
          f"forward launches by (head dim, log-sum-exp) {counts['fwd']}")
    print(f"[train] on {card}: step {med:.1f} ms median of "
          f"{TRAIN_TIMED_STEPS} (min {min(step_ms):.1f}, max "
          f"{max(step_ms):.1f}), {tokens / (med / 1e3):.0f} valid tokens/s "
          f"({tokens} a step), peak memory {peak_gb:.2f} GB")
    if per_step != expected or sum(counts["fwd"].values()) != (
            per_step["fwd_d64"] + per_step["fwd_d128_lse"]) * TRAIN_TIMED_STEPS:
        raise AssertionError(f"flash launches per step {per_step}, not {expected}")
    if not all(map(math.isfinite, losses)) or not losses[-1] < losses[TRAIN_WARMUP_STEPS]:
        raise AssertionError(f"the loss did not fall over the timed steps: {losses}")

    device_batch = trainer._place(batch)
    holder = {"state": state}

    def one_step():
        holder["state"], _ = step_fn(holder["state"], device_batch, 7)

    profile = profile_phase("train step", one_step, med, top=12)
    val = make_vlm_eval_fn(model)([batch])
    print(f"[train] eval on the batch (deterministic): {val}")
    numbers = {
        "step_ms_median": med, "step_ms": step_ms, "losses": losses,
        "tokens_per_s": tokens / (med / 1e3), "peak_memory_gb": peak_gb,
        "launches_per_step": per_step, "profile": profile, "eval": val,
        "batch": len(TRAIN_KV_LENS), "seq": TRAIN_SEQ,
        "kv_lens": list(TRAIN_KV_LENS),
    }
    del model, state, trainer, holder
    return per_step, numbers


def check_train_grads():
    """One step's gradients through the kernels against the same step
    through the plain sdpa path, same weights and batch, no dropout; then
    the same step with planted faults in the attention backward; then
    [remat-dots] on the same model and batch."""
    import torch

    from hsenet_torch.ops import attention
    from hsenet_torch.ops import flash_attention as tfa
    from hsenet_torch.train.vlm import vlm_loss_fn

    cfg = finetune_config()
    model, mask = build_finetune_model(cfg)
    # LoRA B starts at 0, which leaves LoRA A without gradient: draw it
    with torch.no_grad():
        gen = torch.Generator(device="cuda").manual_seed(5)
        for name, p in model.named_parameters():
            if name.endswith("lora_b"):
                p.normal_(0.0, 0.02, generator=gen)
    batch = {k: torch.as_tensor(v).cuda() for k, v in
             training_batch(cfg).items() if hasattr(v, "shape")}
    names = [n for n in mask if mask[n]]
    params = [dict(model.named_parameters())[n] for n in names]

    def grads():
        loss, _ = vlm_loss_fn(model, batch)
        return loss.item(), torch.autograd.grad(loss, params)

    groups = {"lora": "lora_", "packers": "mm_projector", "embedding": "llm.embed"}

    def rel_l2(g, ref):
        rel = {}
        for group, key in groups.items():
            idx = [i for i, n in enumerate(names) if key in n]
            num = sum((g[i].float() - ref[i].float()).pow(2).sum() for i in idx)
            den = sum(ref[i].float().pow(2).sum() for i in idx)
            rel[group] = (num / den).sqrt().item()
        return rel

    loss_k, g_k = grads()
    try:
        attention.set_flash_mode("never")
        loss_p, g_p = grads()
    finally:
        attention.set_flash_mode("auto")
    rel = rel_l2(g_k, g_p)
    del g_k
    # the loss is printed, not held to a limit: at random init it sits near
    # ln(vocab) whatever attention does; [kernel] and [main] hold the forward
    print(f"[train-grads] loss kernel {loss_k:.6f} vs plain sdpa {loss_p:.6f} "
          f"(rel {abs(loss_k - loss_p) / abs(loss_p):.2e}); gradient rel L2 by "
          + ", ".join(f"{g} {r:.3e}" for g, r in rel.items())
          + f" (tol {TRAIN_GRAD_REL_L2})")
    if max(rel.values()) > TRAIN_GRAD_REL_L2:
        raise AssertionError("training gradients through the kernels disagree "
                             "with the plain path")

    # the limit's power: the same step with a planted fault in the attention
    # backward (the kernels launched with delta = 0; no gradient through
    # attention at all, the fault this port once had) must miss it
    sound = tfa.flash_attention_backward
    faults = {
        "delta left out": lambda q, k, v, o, *rest: sound(
            q, k, v, torch.zeros_like(o), *rest),
        "no attention gradient": lambda q, k, v, *rest: tuple(
            torch.zeros_like(t) for t in (q, k, v)),
    }
    wrong = {}
    for fault, backward in faults.items():
        try:
            tfa.flash_attention_backward = backward
            _, g_w = grads()
        finally:
            tfa.flash_attention_backward = sound
        wrong[fault] = rel_l2(g_w, g_p)
        del g_w
        print(f"[train-grads] {fault}: gradient rel L2 by "
              + ", ".join(f"{g} {r:.3e}" for g, r in wrong[fault].items()))
        if max(wrong[fault].values()) <= TRAIN_GRAD_REL_L2:
            raise AssertionError(f"the training gradient limit passes {fault}")
    del g_p
    dots = run_remat_dots(model, names, params, batch)
    del model, params
    return {"loss_kernel": loss_k, "loss_plain": loss_p, "grad_rel_l2": rel,
            "planted_faults_rel_l2": wrong, "remat_dots": dots}


def build_serving_model():
    """The serving configuration at full width, as the serving CLI builds
    it for `--quant-int8`: `VLMConfig()` with int8 projections and
    embedding in Phi-4-mini and no LoRA, towers and packers in bf16; random
    bf16 weights (seed 0) quantised on the card by the port's converters."""
    import argparse

    import torch

    from hsenet_torch.cli.common import (
        build_vlm_config,
        int8_serving_config,
        random_model,
    )
    from hsenet_torch.models.mllm import HSENetVLM

    cfg = int8_serving_config(build_vlm_config(argparse.Namespace(synthetic=False)))
    t0 = time.perf_counter()
    model = random_model(HSENetVLM, cfg, dtype=torch.bfloat16, device="cuda",
                         seed=0)
    torch.cuda.synchronize()
    n_codes = sum(b.numel() for b in model.buffers() if b.dtype == torch.int8)
    n_float = sum(p.numel() for p in model.parameters())
    print(f"[serve] HSENetVLM(VLMConfig(), quant_int8 + quant_int8_embed, no "
          f"LoRA): {n_codes / 1e9:.3f} B int8 codes, {n_float / 1e9:.3f} B bf16 "
          f"parameters, random weights (seed 0) quantised on the card, built "
          f"in {time.perf_counter() - t0:.1f} s, "
          f"{torch.cuda.memory_allocated() / 1e9:.2f} GB allocated")
    return cfg, model


def serving_traffic(cfg, n_requests: int, n_volumes: int, seed: int):
    """`n_requests` submit() kwargs over `n_volumes` synthetic scans, asked
    in turn: prompts of BOS + 256 <im_patch> + 20-200 text tokens, budgets
    of 16-64 new tokens, from a seeded numpy generator."""
    import numpy as np

    rng = np.random.default_rng(seed)
    vols = [(rng.random((1, 1, *cfg.vision.image_size), np.float32),
             rng.standard_normal((1, cfg.vision.num_slices,
                                  cfg.vision.slice_feature_dim)).astype(np.float32))
            for _ in range(n_volumes)]
    requests = []
    for i in range(n_requests):
        n_text = int(rng.integers(20, 201))
        ids = rng.integers(3, 100000, 1 + cfg.num_image_tokens + n_text)
        ids[0] = 1  # BOS
        ids[1:1 + cfg.num_image_tokens] = IM_PATCH_TOKEN_ID
        vol, sl = vols[i % n_volumes]
        requests.append(dict(prompt_ids=ids, max_new=int(rng.integers(16, 65)),
                             volume=vol, slice_features=sl))
    return requests


def make_engine(model, **kw):
    import torch

    from hsenet_torch.serving import ServingEngine

    settings = dict(eos_token_id=EOS_TOKEN_ID, num_slots=SERVE_SLOTS,
                    prompt_cap=SERVE_PROMPT_CAP, max_new_tokens=SERVE_MAX_NEW,
                    chunk_size=SERVE_CHUNK, cache_dtype=torch.bfloat16,
                    multimodal=True, volume_cache_size=4, kv_prefix_cache_size=4)
    settings.update(kw)
    return ServingEngine(model, **settings)


def reset_counts():
    from hsenet_torch.ops import flash_attention as tfa
    from hsenet_torch.ops import quant_matvec as tqm

    tfa.reset_launch_counts()
    tqm.reset_launch_counts()


def check_serve_counts(tag, cfg, eng, n_requests, results, expect):
    """The checks every serving run shares: all requests finished with
    tokens inside the vocabulary and within their budgets, the hit and miss
    counters as expected, B1 launched 24 times per encode miss (two towers
    of 12 blocks) + 32 times per admission (one per LLM layer), and B5 224
    times (7 projections x 32 layers) per decode step run."""
    from hsenet_torch.ops import flash_attention as tfa
    from hsenet_torch.ops import quant_matvec as tqm

    fwd_route(tag, tfa.launches, tfa.f32_launches)
    tokens = [t for toks in results.values() for t in toks]
    if len(results) != n_requests or not all(
            0 <= t < cfg.llm.vocab_size for t in tokens) or not all(results.values()):
        raise AssertionError(f"{tag}: a request did not finish, or a token "
                             "lies outside the vocabulary")
    got = {k: getattr(eng, k) for k in ("encode_misses", "encode_hits",
                                         "prefix_misses", "prefix_hits")}
    want_b1 = {"d64": 2 * cfg.vision.num_layers * eng.encode_misses,
               "d128": cfg.llm.num_layers * n_requests}
    got_b1 = {"d64": tfa.fwd_launches[(64, False)],
              "d128": tfa.fwd_launches[(128, False)]}
    per_step = 7 * cfg.llm.num_layers
    want_b5 = per_step * eng.steps_run
    print(f"[{tag}] {n_requests} requests finished, {len(tokens)} tokens, "
          f"{eng.steps_run} decode steps in {eng.steps_run // eng.chunk} "
          f"chunks; {got} (expected {expect}); flash_fwd launches {got_b1} "
          f"(expected {want_b1}: 24 per encode miss, 32 per admission); "
          f"quant_matvec launches {tqm.launches['quant_matvec']} on the "
          f"tensor-core entry (expected {want_b5} = {per_step} x "
          f"{eng.steps_run} steps), {tqm.fma_launches[tqm.FMA]} on the "
          "CUDA-core entry (expected 0)")
    if any(got[k] != v for k, v in expect.items()):
        raise AssertionError(f"{tag}: hit/miss counts {got}, expected {expect}")
    if got_b1 != want_b1 or sum(tfa.launches.values()) != sum(want_b1.values()):
        raise AssertionError(f"{tag}: flash launches {got_b1}, not {want_b1}")
    if tqm.launches["quant_matvec"] != want_b5 or want_b5 == 0:
        raise AssertionError(f"{tag}: quant_matvec launched "
                             f"{tqm.launches['quant_matvec']} times, not {want_b5}")
    if tqm.fma_launches[tqm.FMA]:
        raise AssertionError(f"{tag}: a bf16 decode step took the CUDA-core "
                             "matvec entry")
    return {"tokens": len(tokens), "decode_steps": eng.steps_run,
            "flash_fwd_launches": got_b1,
            "quant_matvec_launches": tqm.launches["quant_matvec"], **got}


def run_serve_path(card: str, cfg, model):
    """[serve]: the full-width engine at the CLI's defaults. 12 requests
    over 4 scans closed loop (counted), then 8 more through run_open_loop
    (counted again). Returns the numbers and the closed loop's tokens by
    request."""
    import torch

    from hsenet_torch.serving import run_open_loop

    eng = make_engine(model)
    if eng.capacity != SERVE_CAPACITY:
        raise AssertionError(f"cache rows of {eng.capacity} slots, not {SERVE_CAPACITY}")
    requests = serving_traffic(cfg, 20, 4, seed=11)
    closed, opened = requests[:12], requests[12:]
    # warm-up off the record: one request through every program the run
    # uses (encode, full prefill, prefix-hit prefill, a decode chunk)
    warm = make_engine(model, num_slots=SERVE_SLOTS)
    for req in serving_traffic(cfg, 2, 1, seed=12):
        warm.submit(**{**req, "max_new": 4})
    warm.run_until_drained()
    del warm
    gc.collect()
    torch.cuda.empty_cache()

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()  # the serving path, counted
    t0 = time.perf_counter()
    for req in closed:
        eng.submit(**req)
    results = eng.run_until_drained()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    closed_tokens = [results[u] for u in sorted(results)]
    counts = check_serve_counts(
        "serve", cfg, eng, 12, results,
        {"encode_misses": 4, "encode_hits": 0, "prefix_misses": 4,
         "prefix_hits": 8})
    stats = eng.latency_stats()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    numbers = {
        "closed_loop": {
            **counts, "wall_s": wall, "tokens_per_s": counts["tokens"] / wall,
            "slot_utilization": eng.utilization, "latency": stats,
            "peak_memory_gb": peak_gb, "hbm": eng.hbm_stats(),
        },
        "slots": SERVE_SLOTS, "chunk": SERVE_CHUNK, "capacity": eng.capacity,
    }
    print(f"[serve] on {card}: closed loop, 12 requests over 4 scans, "
          f"{SERVE_SLOTS} slots: {counts['tokens']} tokens in {wall:.2f} s = "
          f"{counts['tokens'] / wall:.1f} tokens/s, slot utilization "
          f"{eng.utilization:.3f}, TTFT p50/p99 {stats['ttft_p50_s']:.3f}/"
          f"{stats['ttft_p99_s']:.3f} s, TPOT p50/p99 {stats['tpot_p50_s'] * 1e3:.1f}/"
          f"{stats['tpot_p99_s'] * 1e3:.1f} ms, latency p50/max "
          f"{stats['p50_s']:.2f}/{stats['max_s']:.2f} s, peak memory "
          f"{peak_gb:.2f} GB, hbm_stats {eng.hbm_stats()}")
    print(f"[serve] first tokens of each request: "
          f"{[toks[:4] for toks in results.values()]}")

    # open loop: 8 more questions about the same 4 scans, one every 0.25 s,
    # on a fresh engine so that its counters and latencies are its own
    eng = make_engine(model)
    offsets = [0.25 * i for i in range(len(opened))]
    reset_counts()
    results, makespan = run_open_loop(eng, opened, offsets)
    torch.cuda.synchronize()
    counts = check_serve_counts(
        "serve", cfg, eng, 8, results,
        {"encode_misses": 4, "prefix_misses": 4, "prefix_hits": 4})
    stats = eng.latency_stats()
    numbers["open_loop"] = {
        **counts, "makespan_s": makespan, "arrival_offsets_s": offsets,
        "tokens_per_s": counts["tokens"] / makespan,
        "slot_utilization": eng.utilization, "latency": stats,
    }
    print(f"[serve] open loop, 8 requests arriving every 0.25 s: makespan "
          f"{makespan:.2f} s, {counts['tokens'] / makespan:.1f} tokens/s, slot "
          f"utilization {eng.utilization:.3f}, TTFT p50/p99 "
          f"{stats['ttft_p50_s']:.3f}/{stats['ttft_p99_s']:.3f} s, TPOT p50/p99 "
          f"{stats['tpot_p50_s'] * 1e3:.1f}/{stats['tpot_p99_s'] * 1e3:.1f} ms")
    return numbers, closed_tokens


def rel_l2(got, want):
    got, want = got.float(), want.float()
    return ((got - want).norm() / want.norm()).item()


def admission_logits(eng, request):
    """The first-token logits (1, V) of one admission of `eng`, through the
    engine's own admission code into slot 0."""
    import torch

    from hsenet_torch.serving import _Request

    req = _Request(uid=-1, prompt=request["prompt_ids"].astype("int32"),
                   max_new=1, volume=request["volume"],
                   slices=request["slice_features"])
    with torch.inference_mode():
        return eng._prefill(req, eng._slot_row(0))


def check_serve_logits(cfg, model):
    """One decode step's logits through B5 against the same step through
    its plain version, and a KV-prefix hit's first-token logits against a
    full prefill of the same request; each limit beside a wrong variant."""
    import torch

    from hsenet_torch.models.phi3 import KVCache
    from hsenet_torch.ops import quant_matvec as tqm

    dev = "cuda"
    gen = torch.Generator(device=dev).manual_seed(6)
    b, prompt = SERVE_SLOTS, 320
    ids = torch.randint(3, 100000, (b, prompt), generator=gen, device=dev)
    lens = torch.randint(200, prompt + 1, (b,), generator=gen, device=dev,
                         dtype=torch.int32)
    sound = tqm.quant_matvec_kernel
    with torch.inference_mode():
        cache = KVCache.create(cfg.llm, b, SERVE_CAPACITY, device=dev)
        logits, cache = model.llm(ids, kv_lens=lens, cache=cache,
                                  last_token_only=True)
        token = logits[:, 0].argmax(dim=-1, keepdim=True)
        lengths = cache.lengths

        def step(matvec):
            # the step writes each row's new key at `lengths`, so every
            # variant starts from the same cache
            tqm.quant_matvec_kernel = matvec
            try:
                out, _ = model.decode_step(
                    token, KVCache(k=cache.k, v=cache.v, lengths=lengths))
            finally:
                tqm.quant_matvec_kernel = sound
            return out

        reset_counts()
        through_kernel = step(sound)
        launched = tqm.launches["quant_matvec"]
        plain = step(tqm.quant_matvec_int8_reference)
        plain64 = step(lambda x, w, s: (
            x.double() @ w.double().t() * s.double()).to(x.dtype))
        wrong = step(lambda x, w, s: tqm.quant_matvec_int8_reference(
            x, w, s.roll(1)))
    if launched != 7 * cfg.llm.num_layers:
        raise AssertionError(f"a decode step launched quant_matvec {launched} times")
    if not torch.isfinite(through_kernel.float()).all():
        raise AssertionError("decode logits are not finite")
    rel, wrong_rel = rel_l2(through_kernel, plain), rel_l2(wrong, plain)
    floor = rel_l2(plain64, plain)
    same = (through_kernel.argmax(-1) == plain.argmax(-1)).float().mean().item()
    print(f"[serve] one decode step at {b} slots, logits through quant_matvec "
          f"vs through its plain version: rel L2 {rel:.3e} (tol "
          f"{DECODE_LOGITS_REL_L2}), same argmax in {same:.0%} of rows; the "
          f"plain version summed in f64 vs in f32: {floor:.3e}; with the "
          f"scales shifted by one channel: {wrong_rel:.3e}")
    if rel > DECODE_LOGITS_REL_L2:
        raise AssertionError("decode logits through the matvec kernel disagree "
                             "with the plain version")
    if wrong_rel <= DECODE_LOGITS_REL_L2:
        raise AssertionError("the decode logits limit passes shifted scales")
    numbers = {"decode_logits_rel_l2": rel, "decode_shifted_scales_rel_l2": wrong_rel,
               "decode_plain_f64_vs_f32_rel_l2": floor,
               "decode_same_argmax": same}

    # a KV-prefix hit against a full prefill of the same request
    first, second = serving_traffic(cfg, 2, 1, seed=13)
    hit_eng = make_engine(model, num_slots=1)
    full_eng = make_engine(model, num_slots=1, kv_prefix_cache_size=0)
    admission_logits(hit_eng, first)  # the miss that fills the prefix cache
    hit = admission_logits(hit_eng, second)
    full = admission_logits(full_eng, second)
    if (hit_eng.prefix_misses, hit_eng.prefix_hits) != (1, 1):
        raise AssertionError("the second question about a scan was no prefix hit")
    # the wrong variant: the hit resumes 64 positions early (positions and
    # the causal offset both off by 64)
    n = SERVE_PREFIX - 64
    row = hit_eng._slot_row(0)
    with torch.inference_mode():
        for target, cached in zip((row.k, row.v),
                                  next(iter(hit_eng._kv_prefix_cache.values()))):
            target[:, :, :, :n] = cached[:, :, :, :n]
        row.lengths.fill_(n)
        q_ids, q_len = hit_eng._padded(second["prompt_ids"][SERVE_PREFIX:],
                                       SERVE_PROMPT_CAP - SERVE_PREFIX)
        early, _ = model.prefill_continue(q_ids, row, q_len)
    rel, early_rel = rel_l2(hit, full), rel_l2(early, full)
    same = bool(hit.argmax(-1) == full.argmax(-1))
    print(f"[serve] first-token logits of a KV-prefix hit "
          f"({SERVE_PROMPT_CAP - SERVE_PREFIX} question rows at offset "
          f"{SERVE_PREFIX}) vs a full prefill of the same request: "
          f"rel L2 {rel:.3e} (tol {PREFIX_LOGITS_REL_L2}), same first token: "
          f"{same}; a hit resumed 64 positions early: {early_rel:.3e}")
    if rel > PREFIX_LOGITS_REL_L2:
        raise AssertionError("a prefix hit's logits disagree with a full prefill")
    if early_rel <= PREFIX_LOGITS_REL_L2:
        raise AssertionError("the prefix-hit logits limit passes a hit resumed "
                             "64 positions early")
    numbers.update(prefix_hit_rel_l2=rel, prefix_hit_early_rel_l2=early_rel,
                   prefix_hit_same_first_token=same)
    return numbers


def run_serve_kv_int8(cfg, model):
    """[serve-kv-int8]: the same engine with an int8 KV cache: 4 requests
    over 2 scans (two prefix hits), and first-token logits of a miss and a
    hit against the bf16-cache engine. Returns the numbers and the tokens
    by request."""
    import torch

    traffic = serving_traffic(cfg, 6, 2, seed=14)
    requests = traffic[:4]
    eng = make_engine(model, cache_dtype=torch.int8)
    if eng._cache.k.dtype != torch.int8 or eng._cache.k_scale is None:
        raise AssertionError("the engine's cache is not int8")
    reset_counts()
    for req in requests:
        eng.submit(**req)
    results = eng.run_until_drained()
    counts = check_serve_counts(
        "serve-kv-int8", cfg, eng, 4, results,
        {"encode_misses": 2, "prefix_misses": 2, "prefix_hits": 2})
    tokens = [results[u] for u in sorted(results)]

    # first-token logits, admission by admission, against the bf16 cache
    q_eng = make_engine(model, num_slots=1, cache_dtype=torch.int8)
    b_eng = make_engine(model, num_slots=1)
    rels = {}
    for kind, req in zip(("miss", "hit"), requests[::2]):  # scan 0 twice
        rels[kind] = rel_l2(admission_logits(q_eng, req),
                            admission_logits(b_eng, req))
    if (q_eng.prefix_misses, q_eng.prefix_hits) != (1, 1):
        raise AssertionError("expected one prefix miss and one hit")
    # the wrong variant: a third question about the scan, admitted from a
    # cached prefix that carries its codes but not their scales
    with torch.inference_mode():
        for pkv in q_eng._kv_prefix_cache.values():
            pkv[2].zero_()
            pkv[3].zero_()
    wrong = rel_l2(admission_logits(q_eng, traffic[4]),
                   admission_logits(b_eng, traffic[4]))
    if (q_eng.prefix_hits, b_eng.prefix_hits) != (2, 2):
        raise AssertionError("the third question about a scan was no prefix hit")
    print(f"[serve-kv-int8] first-token logits, int8 cache vs bf16 cache: rel "
          f"L2 " + ", ".join(f"{k} {v:.3e}" for k, v in rels.items())
          + f" (tol {KV_INT8_LOGITS_REL_L2}); a hit whose cached prefix lost "
          f"its scales: {wrong:.3e}; cache {eng._cache.k.numel() * 2 / 1e9:.2f} GB of "
          f"codes + {eng._cache.k_scale.numel() * 8 / 1e9:.3f} GB of scales")
    if max(rels.values()) > KV_INT8_LOGITS_REL_L2:
        raise AssertionError("int8-cache logits disagree with the bf16 cache")
    if wrong <= KV_INT8_LOGITS_REL_L2:
        raise AssertionError("the int8-cache logits limit passes a prefix "
                             "without its scales")
    return ({**counts, "logits_rel_l2": rels, "prefix_without_scales_rel_l2": wrong},
            tokens)


def run_serve_long(cfg, model):
    """[serve-long]: an engine with a 2048-token output budget, so that
    every prefill attends over a 2576-slot row (where the TPU's dispatch
    picks its streaming kernel): 2 slots, two requests about two scans."""
    eng = make_engine(model, num_slots=2, max_new_tokens=SERVE_LONG_MAX_NEW)
    if eng.capacity != SERVE_LONG_CAPACITY or eng._cache.k.shape[3] != SERVE_LONG_CAPACITY:
        raise AssertionError(f"cache rows of {eng.capacity} slots")
    requests = serving_traffic(cfg, 2, 2, seed=15)
    reset_counts()
    for req in requests:
        eng.submit(**{**req, "max_new": 24})
    t0 = time.perf_counter()
    results = eng.run_until_drained()
    wall = time.perf_counter() - t0
    counts = check_serve_counts(
        "serve-long", cfg, eng, 2, results,
        {"encode_misses": 2, "prefix_misses": 2, "prefix_hits": 0})
    print(f"[serve-long] cache rows of {eng.capacity} slots, 2 requests of 24 "
          f"tokens in {wall:.2f} s; every prefill ran flash_fwd over the "
          f"{eng.capacity}-slot row")
    return {**counts, "capacity": eng.capacity, "wall_s": wall}


def profile_serve(cfg, model):
    """[profile] of one admission that misses every cache, one that hits
    the KV-prefix cache, and one decode chunk with 8 live slots."""
    import torch

    eng = make_engine(model)
    first, second = serving_traffic(cfg, 2, 1, seed=16)

    def miss():
        eng._kv_prefix_cache.clear()
        eng._vol_cache.clear()
        admission_logits(eng, first)

    def hit():
        admission_logits(eng, second)

    miss()
    profiles = {
        "admission_miss": profile_phase("admission, miss (encode + 512-row "
                                        "prefill)", miss, median_wall_ms(miss)),
        "admission_prefix_hit": profile_phase("admission, prefix hit (255-row "
                                              "prefill)", hit, median_wall_ms(hit)),
    }
    eng = make_engine(model)
    for req in serving_traffic(cfg, SERVE_SLOTS, 4, seed=17):
        eng.submit(**{**req, "max_new": SERVE_MAX_NEW})
    with torch.inference_mode():
        eng._admit()

        def chunk():
            eng._decode_chunk().cpu()

        chunk()
        wall = median_wall_ms(chunk, runs=3)
        profiles["decode_chunk"] = profile_phase(
            f"decode chunk ({SERVE_CHUNK} steps x {SERVE_SLOTS} slots)", chunk,
            wall, top=10)
    profiles["decode_chunk"]["tokens_per_s"] = SERVE_SLOTS * SERVE_CHUNK / (wall / 1e3)
    print(f"[profile] decode chunk: {wall / SERVE_CHUNK:.2f} ms a step, "
          f"{profiles['decode_chunk']['tokens_per_s']:.1f} tokens/s with "
          f"{SERVE_SLOTS} live slots")

    # two conversions of int8 codes that the plain expressions make on every
    # call, timed alone: the tied LM head of a decode step (the whole table
    # to bf16, then the product), and one layer's gate projection at an
    # admission's 512 rows (above the matvec's 8 rows: codes to bf16, then
    # the GEMM)
    gen = torch.Generator(device="cuda").manual_seed(8)
    llm = model.llm
    gate = llm.decoder.layers[0].gate_proj
    hidden = torch.randn(SERVE_SLOTS, 1, cfg.llm.hidden_size, generator=gen,
                         device="cuda", dtype=torch.bfloat16)
    rows = torch.randn(1, SERVE_PROMPT_CAP, cfg.llm.hidden_size, generator=gen,
                       device="cuda", dtype=torch.bfloat16)
    with torch.inference_mode():
        table = llm.embed.embedding_q.to(torch.bfloat16)
        gate_w = gate.weight_q.to(torch.bfloat16)
        conversions = {
            "lm_head_ms": time_ms(lambda: llm.compute_logits(hidden)),
            "lm_head_convert_ms": time_ms(
                lambda: llm.embed.embedding_q.to(torch.bfloat16)),
            "lm_head_product_ms": time_ms(lambda: hidden @ table.t()),
            "gate_512_rows_ms": time_ms(lambda: gate(rows)),
            "gate_512_rows_convert_ms": time_ms(
                lambda: gate.weight_q.to(torch.bfloat16)),
            "gate_512_rows_product_ms": time_ms(lambda: rows @ gate_w.t()),
        }
    del table, gate_w
    profiles["conversions"] = conversions
    print("[profile] int8 conversions of the plain expressions, device ms: "
          + ", ".join(f"{k[:-3]} {v:.4f}" for k, v in conversions.items())
          + f" (LM head {cfg.llm.vocab_size} x {cfg.llm.hidden_size} at "
          f"{SERVE_SLOTS} rows; gate projection at {SERVE_PROMPT_CAP} rows)")
    return profiles


def clip_config(patch_size=(4, 16, 16), slice_guided: bool = False):
    """`CLIPConfig()` as the CLIP CLIs build it: a ViT-B 3D tower over
    (32, 256, 256) volumes (the 2E3 tower with `slice_guided`) and
    BERT-base, projection 768, text of 128 tokens; `patch_size` is the CLIs'
    `--patch-size`."""
    from hsenet_torch.configs import CLIPConfig, ViT3DConfig

    return CLIPConfig(vision=ViT3DConfig(patch_size=tuple(patch_size),
                                         slice_guided=slice_guided))


def build_clip_model(cfg, seed: int, remat: bool = True):
    """`CLIPModel` computing in bf16 with remat (as the CLIs set it for real
    data), random weights drawn on the card (seed `seed`), every parameter
    an f32 master: the CLIP stages train all of them."""
    import torch

    from hsenet_torch.models import init_random_
    from hsenet_torch.models.clip import CLIPModel
    from hsenet_torch.train.vlm import to_training_dtypes

    model = CLIPModel(cfg, dtype=torch.bfloat16, remat=remat, device="cuda")
    init_random_(model, torch.Generator(device="cuda").manual_seed(seed))
    return to_training_dtypes(model, {n: True for n, _ in model.named_parameters()})


def clip_batch(cfg, n: int, mode: str, seed: int):
    """One batch of `n` samples of `SyntheticCTDataset` in `mode` (clip or
    clip2) through the port's loader, with signal a random model can see:
    sample i's report is seeded random words from a vocabulary of 16 words
    of its own, its valid length CLIP_TEXT_LENS[i] (BOS + words + EOS, cut
    at 128), and its volume the dataset's noise mixed half and half with a
    pattern of its own repeated in every patch. On i.i.d. noise and words
    alone a random ViT-B and BERT give every sample nearly one feature: the
    contrastive loss sits at ln(batch) and its gradient is rounding noise."""
    import numpy as np

    from hsenet_torch.data.datasets import (
        DataArgs,
        DataLoader,
        SimpleTokenizer,
        SyntheticCTDataset,
    )

    rng = np.random.default_rng(seed)
    lens = CLIP_TEXT_LENS[:n]
    reports = [" ".join(f"w{16 * i + w}" for w in rng.integers(
        0, 16, n_tok - 2 if n_tok < cfg.max_text_len else cfg.max_text_len + 12))
        for i, n_tok in enumerate(lens)]
    ds = SyntheticCTDataset(
        n=n, shape=(cfg.vision.in_channels, *cfg.vision.image_size),
        tokenizer=SimpleTokenizer(vocab_size=cfg.text.vocab_size), mode=mode,
        args=DataArgs(max_text_len=cfg.max_text_len),
        num_slices=cfg.vision.num_slices, slice_dim=cfg.vision.slice_feature_dim,
        reports=reports)
    batch = next(iter(DataLoader(ds, n, shuffle=False)))
    valid = tuple(int(x) for x in batch["attention_mask"].sum(axis=1))
    if valid != lens:
        raise AssertionError(f"text valid lengths {valid}, not {lens}")
    patch = cfg.vision.patch_size
    reps = [size // p for size, p in zip(cfg.vision.image_size, patch)]
    pattern = rng.random((n, cfg.vision.in_channels, *patch), np.float32)
    batch["image"] = 0.5 * batch["image"] + 0.5 * np.tile(pattern, [1, 1, *reps])
    return batch


def clip_launches(cfg, batch: int, teacher: bool = False):
    """The flash launches one CLIP training step makes, by (kind, batch,
    heads, sq, skv, head_dim): the trained tower's forward twice per block
    under remat (with the log-sum-exp), BERT's once, dQ and dK/dV once per
    block of each; with `teacher` also the frozen stage-1 teacher's
    forwards (no log-sum-exp) of both towers."""
    v, t = cfg.vision, cfg.text
    tower = (batch, v.num_heads, v.seq_len, v.seq_len, v.hidden_size // v.num_heads)
    text = (batch, t.num_heads, cfg.max_text_len, cfg.max_text_len,
            t.hidden_size // t.num_heads)
    want = {("flash_fwd_lse", *tower): 2 * v.num_layers,
            ("flash_fwd_lse", *text): t.num_layers}
    want.update({("flash_bwd", *tower): v.num_layers,
                 ("flash_bwd", *text): t.num_layers})
    if teacher:
        want.update({("flash_fwd", *tower): v.num_layers,
                     ("flash_fwd", *text): t.num_layers})
    return want


def per_step(counts, steps):
    """Launches per step from counts over `steps` steps."""
    return {k: n // steps if n % steps == 0 else n / steps
            for k, n in counts.items()}


def run_clip_stage1(card: str):
    """[clip-stage1]: `CLIPModel(CLIPConfig())` at batch 24 through `Trainer`
    and `make_stage1_train_step`, on one repeated `SyntheticCTDataset` clip
    batch: warm-up and timed steps, launches per step, one in-training
    retrieval eval (`TrainerHooks.on_eval`) and a profile of one step.
    Returns the trained model (stage 2's teacher) and the phase's numbers."""
    import torch

    from hsenet_torch.configs import TrainConfig
    from hsenet_torch.eval.retrieval import make_clip_retrieval_eval_fn
    from hsenet_torch.ops import flash_attention as tfa
    from hsenet_torch.train.stage1 import make_stage1_train_step
    from hsenet_torch.train.train_state import TrainState, make_optimizer
    from hsenet_torch.train.trainer import Trainer, TrainerHooks

    cfg = clip_config()
    t0 = time.perf_counter()
    model = build_clip_model(cfg, seed=0)
    n_params = sum(p.numel() for p in model.parameters())
    print(f"[clip-stage1] CLIPModel(CLIPConfig()): ViT-B 3D tower over "
          f"{cfg.vision.seq_len} tokens + BERT-base, {n_params / 1e6:.1f} M "
          f"parameters, all trained (f32 masters, bf16 compute), remat on, "
          f"built in {time.perf_counter() - t0:.1f} s")
    batch = clip_batch(cfg, CLIP_BATCH, "clip", seed=21)
    total = CLIP_WARMUP_STEPS + CLIP_TIMED_STEPS
    train_cfg = TrainConfig(learning_rate=1e-4, total_steps=CLIP_RUN_STEPS,
                            log_every=1, eval_every=total, seed=0)
    tx = make_optimizer(train_cfg)  # no mask: every parameter trains
    step_fn = make_stage1_train_step(model, tx)
    evaluate = make_clip_retrieval_eval_fn(model, ks=(5, 10))
    counts, evals = {}, {}

    def on_log(step, row):
        if step == CLIP_WARMUP_STEPS:  # the timed steps start here
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            tfa.reset_launch_counts()
        if step == total:
            counts.update(tfa.shape_launches)
            fwd_route("clip-stage1", tfa.launches, tfa.f32_launches)

    def on_eval(step, state):
        evals.update(evaluate([batch]))
        return evals

    trainer = Trainer(step_fn, TrainState.create(model, tx), lambda: [batch],
                      train_cfg, hooks=TrainerHooks(on_log=on_log, on_eval=on_eval))
    state = trainer.fit(total)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    hist = trainer.history
    losses = [row["loss"] for row in hist]
    step_ms = [1e3 / row["steps_per_sec"] for row in hist[CLIP_WARMUP_STEPS:]]
    med = statistics.median(step_ms)
    got, want = per_step(counts, CLIP_TIMED_STEPS), clip_launches(cfg, CLIP_BATCH)
    print(f"[clip-stage1] losses by step: {[round(x, 4) for x in losses]}")
    print(f"[clip-stage1] retrieval_acc by step: "
          f"{[round(r['retrieval_acc'], 4) for r in hist]}; grad norms: "
          f"{[round(r['grad_norm'], 4) for r in hist]}; logit scale "
          f"{hist[-1]['logit_scale']:.6f}")
    print(f"[clip-stage1] flash launches per step by (kind, batch, heads, sq, "
          f"skv, d): {got} (expected {want})")
    print(f"[clip-stage1] in-training retrieval eval on the batch: {evals}")
    print(f"[clip-stage1] on {card}: step {med:.1f} ms median of "
          f"{CLIP_TIMED_STEPS} (min {min(step_ms):.1f}, max {max(step_ms):.1f}), "
          f"{CLIP_BATCH / (med / 1e3):.1f} samples/s, peak memory {peak_gb:.2f} GB")
    if got != want:
        raise AssertionError(f"[clip-stage1] flash launches per step {got}, not {want}")
    if not all(map(math.isfinite, losses)) or not losses[-1] < losses[CLIP_WARMUP_STEPS]:
        raise AssertionError(f"the stage-1 loss did not fall: {losses}")
    if set(evals) != {"i2t_r@5", "t2i_r@5", "i2t_r@10", "t2i_r@10"}:
        raise AssertionError(f"the in-training eval gave {evals}")

    device_batch = trainer._place(batch)
    holder = {"state": state}

    def one_step():
        holder["state"], _ = step_fn(holder["state"], device_batch, 7)

    profile = profile_phase("clip-stage1 step", one_step, med, top=10)
    numbers = {
        "step_ms_median": med, "step_ms": step_ms, "losses": losses,
        "retrieval_acc": [r["retrieval_acc"] for r in hist],
        "grad_norm": [r["grad_norm"] for r in hist],
        "samples_per_s": CLIP_BATCH / (med / 1e3), "peak_memory_gb": peak_gb,
        "eval": evals, "profile": profile, "batch": CLIP_BATCH,
        "text_lens": list(CLIP_TEXT_LENS),
    }
    return model, got, numbers


def run_clip_stage2(card: str, teacher):
    """[clip-stage2]: the 2E3 student at batch 24 against the frozen
    stage-1 teacher that [clip-stage1] trained (handed over in process),
    its BERT and projections warm-started from copies of the teacher's:
    steps with the teacher recomputed, then steps served by a
    `TeacherCache` (one miss per sample, then hits)."""
    import torch

    from hsenet_torch.configs import TrainConfig
    from hsenet_torch.ops import flash_attention as tfa
    from hsenet_torch.train.stage2 import (
        TeacherCache,
        make_stage2_train_step,
        make_teacher_embed_fn,
    )
    from hsenet_torch.train.train_state import TrainState, make_optimizer
    from hsenet_torch.train.trainer import Trainer, TrainerHooks

    cfg = clip_config(slice_guided=True)
    student = build_clip_model(cfg, seed=1)
    with torch.no_grad():
        for name in ("language_encoder", "mm_vision_proj", "mm_language_proj"):
            for dst, src in zip(getattr(student, name).parameters(),
                                getattr(teacher, name).parameters()):
                dst.copy_(src)
    batch = clip_batch(cfg, CLIP_BATCH, "clip2", seed=22)
    total = 2 * CLIP2_STEPS
    train_cfg = TrainConfig(learning_rate=1e-4, total_steps=CLIP_RUN_STEPS,
                            log_every=1, eval_every=0, seed=1)
    tx = make_optimizer(train_cfg)
    steps = {}

    def on_log(step, row):  # each step's launches, teacher cache fill included
        steps[step] = dict(tfa.shape_launches)
        fwd_route(f"clip-stage2 step {step}", tfa.launches, tfa.f32_launches)
        tfa.reset_launch_counts()

    hooks = TrainerHooks(on_log=on_log)
    tfa.reset_launch_counts()
    first = Trainer(make_stage2_train_step(student, teacher, cfg, tx),
                    TrainState.create(student, tx), lambda: [batch], train_cfg,
                    hooks=hooks)
    state = first.fit(CLIP2_STEPS)
    cache = TeacherCache(make_teacher_embed_fn(teacher))
    second = Trainer(make_stage2_train_step(student, teacher, cfg, tx,
                                            cached_teacher=True),
                     state, lambda: (cache.attach(b) for b in [batch]),
                     train_cfg, hooks=hooks)
    second.fit(total)
    hist = first.history + second.history
    with_teacher = clip_launches(cfg, CLIP_BATCH, teacher=True)
    student_only = clip_launches(cfg, CLIP_BATCH)
    # the recompute steps and the cached mode's first step (which fills the
    # cache) run the teacher; the cached hits run the student alone
    want = {s: with_teacher if s <= CLIP2_STEPS + 1 else student_only
            for s in range(1, total + 1)}
    keys = ("loss", "loss_cl", "loss_relation", "relation_weight",
            "retrieval_acc", "grad_norm")
    for row in hist:
        print(f"[clip-stage2] step {row['step']}: "
              + ", ".join(f"{k} {row[k]:.5f}" for k in keys)
              + f", {1e3 / row['steps_per_sec']:.1f} ms")
    print(f"[clip-stage2] teacher cache: {cache.misses} misses, {cache.hits} hits "
          f"(expected {CLIP_BATCH} and {(CLIP2_STEPS - 1) * CLIP_BATCH}); flash "
          f"launches of a recompute step {steps[2]}, of a cached hit "
          f"{steps[total]}")
    if steps != want:
        raise AssertionError(f"[clip-stage2] flash launches by step {steps}, not {want}")
    if (cache.misses, cache.hits) != (CLIP_BATCH, (CLIP2_STEPS - 1) * CLIP_BATCH):
        raise AssertionError("[clip-stage2] teacher cache counts are off")
    counts = {"misses": cache.misses, "hits": cache.hits}
    # what the cache serves is what the teacher computes in a recompute step
    # (a misplaced or stale row would be off by a feature's whole size,
    # ~0.04 a component; rounding differs by under a bf16 unit, ~1e-4)
    served = cache.attach(batch)
    fresh = make_teacher_embed_fn(teacher)(batch)
    cache_err = max((torch.as_tensor(served[k]) - v.float().cpu()).abs().max().item()
                    for k, v in fresh.items())
    print(f"[clip-stage2] cached teacher features vs a fresh teacher forward: "
          f"max abs difference {cache_err:.3e}")
    if not cache_err <= 1e-3:
        raise AssertionError("the teacher cache serves other features than the teacher's")
    losses = [row["loss"] for row in hist]
    if not all(map(math.isfinite, losses)) or not losses[-1] < losses[1]:
        raise AssertionError(f"the stage-2 loss did not fall: {losses}")
    step_ms = {"recompute": statistics.median(
        1e3 / r["steps_per_sec"] for r in first.history[1:]),
        "cached_hit": statistics.median(
        1e3 / r["steps_per_sec"] for r in second.history[1:])}
    print(f"[clip-stage2] on {card}: step {step_ms['recompute']:.1f} ms with the "
          f"teacher recomputed, {step_ms['cached_hit']:.1f} ms on cached hits "
          f"(medians of {CLIP2_STEPS - 1})")
    return {"recompute": per_step(steps[2], 1),
            "cached_hit": per_step(steps[total], 1)}, {
        "history": hist, "step_ms": step_ms,
        "teacher_cache": counts, "cache_vs_teacher_max_abs": cache_err}


def check_clip_grads():
    """[clip-grads]: one stage-1 step's gradients at batch 6 through the
    kernels against the same step through the plain sdpa path, relative L2
    per group (tower, BERT, projections with the logit scale), after a few
    steps on the batch; then the same step with planted faults in the
    attention backward."""
    import numpy as np
    import torch

    from hsenet_torch.configs import TrainConfig
    from hsenet_torch.ops import attention, multi_tensor
    from hsenet_torch.ops import flash_attention as tfa
    from hsenet_torch.train.stage1 import make_stage1_train_step, stage1_loss_fn
    from hsenet_torch.train.train_state import TrainState, make_optimizer

    cfg = clip_config()
    model = build_clip_model(cfg, seed=3)
    batch = {k: torch.as_tensor(v).cuda() for k, v in
             clip_batch(cfg, CLIP_GRADS_BATCH, "clip", seed=23).items()
             if isinstance(v, np.ndarray)}
    # at random init every sample's features nearly coincide (cosines of
    # 0.97-0.99), so the contrastive gradient is a difference of nearly
    # equal vectors that bf16 rounding decides, whatever attention does; a
    # few steps on the batch (through the kernels) pull the features apart
    tx = make_optimizer(TrainConfig(learning_rate=1e-4, warmup_ratio=0.0,
                                    schedule="constant"))
    state, step = TrainState.create(model, tx), make_stage1_train_step(model, tx)
    for i in range(CLIP_GRADS_WARM_STEPS):
        if i == CLIP_GRADS_WARM_STEPS - 1:  # the main path's step, counted
            multi_tensor.reset_launch_counts()
        state, metrics = step(state, batch, 0)
    routes, launches = dict(multi_tensor.routes), dict(multi_tensor.launches)
    n_leaves = len(list(model.parameters()))
    print(f"[clip-grads] one step's optimizer: routes {routes}, launches {launches}")
    if routes != {"fused": n_leaves, "per_leaf": 0} or launches != {
            "sum_squares": 1, "leaf_sums": 1, "adamw": 1}:
        raise AssertionError("the CLIP step's optimizer did not take the fused "
                             "route in three launches")
    print(f"[clip-grads] after {CLIP_GRADS_WARM_STEPS} steps on the batch: loss "
          f"{float(metrics['loss']):.4f}")
    names, params = zip(*model.named_parameters())
    groups = {"tower": ("vision_encoder.",), "bert": ("language_encoder.",),
              "projections": ("mm_", "logit_scale")}

    def grads():
        loss, _ = stage1_loss_fn(model, batch)
        return loss.item(), torch.autograd.grad(loss, params)

    def rel_l2(g, ref):
        rel = {}
        for group, prefixes in groups.items():
            idx = [i for i, n in enumerate(names) if n.startswith(prefixes)]
            num = sum((g[i].float() - ref[i].float()).pow(2).sum() for i in idx)
            den = sum(ref[i].float().pow(2).sum() for i in idx)
            rel[group] = (num / den).sqrt().item()
        return rel

    loss_k, g_k = grads()
    optimizer = check_fused_optimizer(tx, state.opt_state, params, g_k,
                                      launches)
    try:
        attention.set_flash_mode("never")
        loss_p, g_p = grads()
    finally:
        attention.set_flash_mode("auto")
    rel = rel_l2(g_k, g_p)
    del g_k
    print(f"[clip-grads] batch {CLIP_GRADS_BATCH}: loss kernel {loss_k:.6f} vs "
          f"plain sdpa {loss_p:.6f}; gradient rel L2 by "
          + ", ".join(f"{g} {r:.3e}" for g, r in rel.items())
          + f" (tol {TRAIN_GRAD_REL_L2})")
    if max(rel.values()) > TRAIN_GRAD_REL_L2:
        raise AssertionError("CLIP gradients through the kernels disagree with "
                             "the plain path")
    sound = tfa.flash_attention_backward
    faults = {
        "delta left out": lambda q, k, v, o, *rest: sound(
            q, k, v, torch.zeros_like(o), *rest),
        "no attention gradient": lambda q, k, v, *rest: tuple(
            torch.zeros_like(t) for t in (q, k, v)),
    }
    wrong = {}
    for fault, backward in faults.items():
        try:
            tfa.flash_attention_backward = backward
            _, g_w = grads()
        finally:
            tfa.flash_attention_backward = sound
        wrong[fault] = rel_l2(g_w, g_p)
        del g_w
        print(f"[clip-grads] {fault}: gradient rel L2 by "
              + ", ".join(f"{g} {r:.3e}" for g, r in wrong[fault].items()))
        if max(wrong[fault].values()) <= TRAIN_GRAD_REL_L2:
            raise AssertionError(f"the CLIP gradient limit passes {fault}")
    del model, params, g_p
    return {"loss_kernel": loss_k, "loss_plain": loss_p, "grad_rel_l2": rel,
            "planted_faults_rel_l2": wrong, "batch": CLIP_GRADS_BATCH,
            "optimizer_routes": routes, "kernel": optimizer}


def check_fused_optimizer(tx, opt, params, grads, launches):
    """[clip-grads]' check of the fused optimizer (`ops/multi_tensor.py`) at
    CLIP's trained leaves, from the state the warm steps left: the norm and
    one update through the kernels against the per-leaf loop on copies of
    the same inputs, then device times of one optimizer step: the kernels
    (norm and update), the loop (`g.float().pow(2).sum()` a leaf and
    `AdamW.update_per_leaf`), and the library's torch._foreach_norm with
    torch._fused_adamw_ (a yardstick only: it decays p before the step, and
    the clip goes in as its grad_scale). Returns the `kernels` entry."""
    import torch

    from hsenet_torch.train.train_state import AdamWState, global_norm

    grads = list(grads)
    n, leaves = sum(g.numel() for g in grads), len(grads)

    def plain_norm(gs):
        return torch.sqrt(sum(g.float().pow(2).sum() for g in gs))

    def copies():
        return ([p.detach().clone() for p in params], [m.clone() for m in opt.mu],
                [v.clone() for v in opt.nu])

    norm, fused_norm = plain_norm(grads), global_norm(grads)
    norm_rel = abs(fused_norm.item() - norm.item()) / norm.item()
    fused, loop = copies(), copies()
    # AdamW.step may overwrite its gradients (the CPU's route does)
    tx.step(fused[0], [g.clone() for g in grads],
            AdamWState(opt.count, fused[1], fused[2]), norm)
    loop_grads = [g.clone() for g in grads]
    loop_state = AdamWState(opt.count, loop[1], loop[2])
    tx.update_per_leaf(list(zip(loop[0], loop_grads, loop[1], loop[2],
                                [None] * leaves)), loop_state, norm)
    max_abs, outside = 0.0, {}
    for name, a_row, b_row in zip(("p", "mu", "nu"), fused, loop):
        outside[name] = 0
        for a, b in zip(a_row, b_row):
            diff = (a - b).abs()
            max_abs = max(max_abs, diff.max().item() if diff.numel() else 0.0)
            outside[name] += int((diff > FUSED_ADAMW_REL * b.abs()).sum())
    print(f"[clip-grads] fused optimizer at {leaves} leaves, {n} elements: norm "
          f"{fused_norm.item():.6f} vs the loop's {norm.item():.6f} (rel "
          f"{norm_rel:.2e}, tol {FUSED_NORM_REL}); elements beyond "
          f"{FUSED_ADAMW_REL} of the loop's {outside}, max abs err {max_abs:.3e}")
    if norm_rel > FUSED_NORM_REL or any(outside.values()):
        raise AssertionError("the fused optimizer disagrees with the per-leaf loop")
    # the loop and the library overwrite their gradients: time them on a
    # copy, so that the phase's own gradients stay as they were
    del loop_grads
    grads = [g.clone() for g in grads]

    def fused_step():
        tx.step(fused[0], grads, AdamWState(opt.count, fused[1], fused[2]),
                global_norm(grads))

    def loop_step():
        tx.update_per_leaf(list(zip(loop[0], grads, loop[1], loop[2],
                                    [None] * leaves)), loop_state,
                           plain_norm(grads))

    ms = time_ms(fused_step)
    # one loop a sleep: the host takes longer to queue it than it runs
    plain_ms = time_ms(loop_step, reps=1, warmup=1, runs=3)
    cfg = tx.cfg
    lr = tx.coefficients(opt.count)[0]
    steps = [torch.full((), float(opt.count), device=norm.device) for _ in grads]

    def library_step():
        total = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
        scale = torch.where(total < cfg.max_grad_norm, 1.0, total / cfg.max_grad_norm)
        torch._fused_adamw_(loop[0], grads, loop[1], loop[2], [], steps, lr=lr,
                            beta1=cfg.adam_b1, beta2=cfg.adam_b2,
                            weight_decay=cfg.weight_decay, eps=cfg.adam_eps,
                            amsgrad=False, maximize=False, grad_scale=scale)

    try:
        library_ms = time_ms(library_step)
    except (AttributeError, RuntimeError, TypeError) as e:
        print(f"[clip-grads] torch._fused_adamw_ not timed: {e}")
        library_ms = None
    bound_ms = FUSED_ADAMW_BYTES * n / PEAK_BYTES_PER_S * 1e3
    print(f"[clip-grads] fused optimizer {ms:.3f} ms (bound {bound_ms:.3f} ms, "
          f"{bound_ms / ms:.1%}), per-leaf loop {plain_ms:.3f} ms, foreach_norm + "
          f"_fused_adamw_ {library_ms if library_ms is None else f'{library_ms:.3f}'} ms")
    shape = {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": "bytes",
             "library_ms": library_ms, "max_abs_err": max_abs, "leaves": leaves,
             "elements": n, "launches": sum(launches.values())}
    del fused, loop, steps, grads
    return {
        "name": "multi_tensor_adamw",
        "route": "cuda",
        "source": "hsenet_torch/csrc/multi_tensor_adamw.cu",
        "replaces": "none: the JAX package leaves optax's chain(clip_by_global_norm, "
                    "adamw) to XLA",
        "launches": sum(launches.values()),
        "max_abs_err": max_abs,
        "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": "bytes",
        "library_ms": library_ms,
        "times_are": "one optimizer step at CLIP's trained leaves (the three "
                     "launches: sum_squares_kernel, leaf_sums_kernel, "
                     "adamw_kernel), from [clip-grads]' state; plain is the "
                     "per-leaf norm and AdamW.update_per_leaf; library is "
                     "torch._foreach_norm with torch._fused_adamw_ (another "
                     "update: decay before the step)",
        "shapes": {f"clip_{leaves}_leaves": shape},
    }


def run_clip_long(card: str):
    """[clip-long]: the stage-1 step at `--patch-size 2 8 8` (16,385 tower
    tokens), batch 2, remat on, through `Trainer`: launches per step at
    the long shape, finite losses, a finite non-zero gradient in every
    tower block, step time, peak memory and a profile."""
    import torch

    from hsenet_torch.configs import TrainConfig
    from hsenet_torch.ops import flash_attention as tfa
    from hsenet_torch.train.stage1 import make_stage1_train_step, stage1_loss_fn
    from hsenet_torch.train.train_state import TrainState, make_optimizer
    from hsenet_torch.train.trainer import Trainer, TrainerHooks

    cfg = clip_config(patch_size=CLIP_LONG_PATCH)
    model = build_clip_model(cfg, seed=4)
    batch = clip_batch(cfg, CLIP_LONG_BATCH, "clip", seed=24)
    total = CLIP_LONG_WARMUP_STEPS + CLIP_LONG_TIMED_STEPS
    train_cfg = TrainConfig(learning_rate=1e-4, total_steps=CLIP_RUN_STEPS,
                            log_every=1, eval_every=0, seed=2)
    tx = make_optimizer(train_cfg)
    step_fn = make_stage1_train_step(model, tx)
    counts = {}

    def on_log(step, row):
        if step == CLIP_LONG_WARMUP_STEPS:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            tfa.reset_launch_counts()
        if step == total:
            counts.update(tfa.shape_launches)
            fwd_route("clip-long", tfa.launches, tfa.f32_launches)

    trainer = Trainer(step_fn, TrainState.create(model, tx), lambda: [batch],
                      train_cfg, hooks=TrainerHooks(on_log=on_log))
    state = trainer.fit(total)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    hist = trainer.history
    losses = [row["loss"] for row in hist]
    step_ms = [1e3 / r["steps_per_sec"] for r in hist[CLIP_LONG_WARMUP_STEPS:]]
    med = statistics.median(step_ms)
    got = per_step(counts, CLIP_LONG_TIMED_STEPS)
    want = clip_launches(cfg, CLIP_LONG_BATCH)

    # every tower block's gradient, from one more forward and backward
    device_batch = trainer._place(batch)
    blocks = model.vision_encoder.tower.blocks
    loss, _ = stage1_loss_fn(model, device_batch)
    block_grads = torch.autograd.grad(loss, list(blocks.parameters()))
    sizes = [len(list(b.parameters())) for b in blocks]
    norms, at = [], 0
    for n in sizes:
        norms.append(torch.sqrt(sum(g.float().pow(2).sum()
                                    for g in block_grads[at:at + n])).item())
        at += n
    del block_grads, loss
    print(f"[clip-long] CLIPConfig() at --patch-size {' '.join(map(str, CLIP_LONG_PATCH))}: "
          f"{cfg.vision.seq_len} tower tokens, batch {CLIP_LONG_BATCH}: losses "
          f"{[round(x, 4) for x in losses]}, grad norms "
          f"{[round(r['grad_norm'], 4) for r in hist]}")
    print(f"[clip-long] tower block gradient norms: "
          f"{[f'{x:.3e}' for x in norms]}")
    print(f"[clip-long] flash launches per step: {got} (expected {want})")
    print(f"[clip-long] on {card}: step {med:.1f} ms median of "
          f"{CLIP_LONG_TIMED_STEPS} ({[round(x, 1) for x in step_ms]}), peak "
          f"memory {peak_gb:.2f} GB")
    if got != want:
        raise AssertionError(f"[clip-long] flash launches per step {got}, not {want}")
    if not all(map(math.isfinite, losses)):
        raise AssertionError(f"[clip-long] loss not finite: {losses}")
    if not all(math.isfinite(x) and x > 0 for x in norms):
        raise AssertionError(f"[clip-long] a tower block has no finite gradient: {norms}")
    holder = {"state": state}

    def one_step():
        holder["state"], _ = step_fn(holder["state"], device_batch, 7)

    profile = profile_phase("clip-long step", one_step, med, top=8)
    if profile["device_ms"]:
        profile["flash_share"] = profile["by_kind_ms"]["flash"] / profile["device_ms"]
        print(f"[profile] clip-long step: flash kernels take "
              f"{profile['flash_share']:.1%} of device time")
    return got, {"step_ms_median": med, "step_ms": step_ms, "losses": losses,
                 "grad_norm": [r["grad_norm"] for r in hist],
                 "tower_block_grad_norms": norms, "peak_memory_gb": peak_gb,
                 "profile": profile, "batch": CLIP_LONG_BATCH,
                 "tokens": cfg.vision.seq_len,
                 "samples_per_s": CLIP_LONG_BATCH / (med / 1e3)}


def write_train_cli_data(root):
    """[cli-train]'s data under `root`: TRAIN_CLI_VOLUMES volumes (1, 32,
    256, 256) f32 (noise mixed half and half with a pattern of their own in
    every patch, so that a random tower tells them apart) and slice features
    (32, 768), from a numpy seed; reports of seeded words, 16 of their own
    per volume, in sentences of 8 (the CLIP reports 20-104 words, under the
    128 tokens past which the sentence sampling would draw another text at
    each read: the teacher cache then hits from the second step on); a CLIP
    manifest of 24 entries (3 a volume) in both splits, an MRG manifest (2 train and 2 validation
    entries of ~450-word reports), the same without slice features and a
    location-VQA manifest (5 and 5).
    Returns the manifests' paths by name."""
    import os

    import numpy as np

    v = clip_config().vision
    rng = np.random.default_rng(31)
    reps = [size // p for size, p in zip(v.image_size, v.patch_size)]
    for i in range(TRAIN_CLI_VOLUMES):
        pattern = rng.random((1, *v.patch_size), np.float32)
        vol = 0.5 * rng.random((1, *v.image_size), np.float32) + 0.5 * np.tile(
            pattern, [1, *reps])
        np.save(os.path.join(root, f"vol{i}.npy"), vol)
        np.save(os.path.join(root, f"feat{i}.npy"), rng.standard_normal(
            (v.num_slices, v.slice_feature_dim)).astype(np.float32))

    def report(i, n_words):
        words = [f"w{16 * i + w}" for w in rng.integers(0, 16, n_words)]
        return ". ".join(" ".join(words[j:j + 8])
                         for j in range(0, n_words, 8)) + "."

    clip_reports = [report(i, 20 + 12 * i) for i in range(TRAIN_CLI_VOLUMES)]

    def entry(i, **kw):
        return {"image": f"vol{i}.npy", "biomedclip_features": f"feat{i}.npy", **kw}

    clip = [entry(j % TRAIN_CLI_VOLUMES, text=clip_reports[j % TRAIN_CLI_VOLUMES])
            for j in range(TRAIN_CLI_BATCH["clip"])]
    mrg = [entry(i, text=report(i, 440 + 8 * i)) for i in range(4)]
    places = [("nodule", "right lung"), ("pleural effusion", "pleura"),
              ("emphysema", "left lung"), ("cardiomegaly", "heart"),
              ("hiatal hernia", "esophagus"), ("atelectasis", "lung base"),
              ("calcification", "aorta"), ("cyst", "kidney")]
    vqa = [entry(i, abnormality=a, anatomy=b) for i, (a, b) in enumerate(places)]
    # the MRG entries without their slice features, for the VLM that
    # computes them in-graph
    online = [{k: v for k, v in e.items() if k != "biomedclip_features"} for e in mrg]
    paths = {}
    for name, train, val in (("clip", clip, clip), ("mrg", mrg[:2], mrg[2:]),
                             ("vqa", vqa[:5], vqa[3:]),
                             ("mrg_online", online[:2], online[2:])):
        paths[name] = os.path.join(root, f"{name}.json")
        with open(paths[name], "w") as f:
            json.dump({"train": train, "validation": val}, f)
    return paths


def _crc32c(data: bytes) -> int:
    crc = 0xFFFFFFFF
    for byte in data:
        crc ^= byte
        for _ in range(8):
            crc = (crc >> 1) ^ (0x82F63B78 if crc & 1 else 0)
    return crc ^ 0xFFFFFFFF


def _masked_crc(data: bytes) -> int:
    crc = _crc32c(data)
    return (((crc >> 15) | (crc << 17)) + 0xA282EAD8) & 0xFFFFFFFF


def _proto_fields(buf: bytes):
    """(field number, wire type, value) of a protobuf message: varints as
    ints, 64- and 32-bit fields as their bytes, length-delimited as bytes."""
    pos = 0

    def varint():
        nonlocal pos
        out = shift = 0
        while True:
            byte = buf[pos]
            pos += 1
            out |= (byte & 0x7F) << shift
            shift += 7
            if not byte & 0x80:
                return out

    while pos < len(buf):
        key = varint()
        number, wire = key >> 3, key & 7
        if wire == 0:
            yield number, wire, varint()
        elif wire in (1, 5):
            size = 8 if wire == 1 else 4
            yield number, wire, buf[pos:pos + size]
            pos += size
        elif wire == 2:
            size = varint()
            yield number, wire, buf[pos:pos + size]
            pos += size
        else:
            raise ValueError(f"protobuf wire type {wire}")


def read_tensorboard_events(path):
    """The events of a TensorBoard event file, read here from its bytes:
    each TFRecord's length and data checked against their masked CRC-32C,
    each `Event` decoded to (step, file_version, {tag: simple_value})."""
    import struct

    if _crc32c(b"123456789") != CRC32C_CHECK:
        raise AssertionError("the record reader's CRC-32C is wrong")
    with open(path, "rb") as f:
        data = f.read()
    events, pos = [], 0
    while pos < len(data):
        head = data[pos:pos + 8]
        (length,) = struct.unpack("<Q", head)
        (head_crc,) = struct.unpack("<I", data[pos + 8:pos + 12])
        body = data[pos + 12:pos + 12 + length]
        (body_crc,) = struct.unpack("<I", data[pos + 12 + length:pos + 16 + length])
        if head_crc != _masked_crc(head) or body_crc != _masked_crc(body):
            raise AssertionError(f"{path}: a record at byte {pos} fails its CRC")
        pos += 16 + length
        step, version, scalars = 0, "", {}
        for number, _, value in _proto_fields(body):
            if number == 2:
                step = value
            elif number == 3:
                version = value.decode()
            elif number == 5:
                for _, _, item in _proto_fields(value):
                    fields = {n: v for n, _, v in _proto_fields(item)}
                    scalars[fields[1].decode()] = struct.unpack("<f", fields[2])[0]
        events.append((step, version, scalars))
    return events


def check_tensorboard_file(tag, path, logged):
    """The run's event file read back: a first record "brain.Event:2", then
    one event per logged step holding one scalar per metric, each the f32 of
    the value the trainer logged."""
    import numpy as np

    events = read_tensorboard_events(path)
    want = [(step, "", {k: float(np.float32(v)) for k, v in metrics.items()})
            for step, metrics in logged]
    ok = events[0] == (0, "brain.Event:2", {}) and events[1:] == want
    print(f"[cli-train] {tag}: TensorBoard file {Path(path).name}: {len(events)} "
          f"records, CRCs valid, {len(want)} logged steps x "
          f"{len(logged[0][1]) if logged else 0} scalars equal to the logged "
          f"values: {ok}")
    if not ok:
        raise AssertionError(f"[cli-train] {tag}: the TensorBoard file does not "
                             f"hold the logged metrics: {events[:3]} ...")


def trace_numbers(tag, trace_dir):
    """The profile window's trace: the flash kernels it names, the device's
    kernel time and its idle share over the window (one step and its
    logging)."""
    import os

    files = [f for f in os.listdir(trace_dir) if f.endswith(".pt.trace.json")]
    if len(files) != 1:
        raise AssertionError(f"[cli-train] {tag}: traces {files} in {trace_dir}")
    with open(os.path.join(trace_dir, files[0])) as f:
        events = [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X"]
    kernels = [e for e in events if e.get("cat") == "kernel"]
    flash = sorted({m for e in kernels
                    for m in re.findall(r"flash_[a-z0-9_]*kernel", e["name"])})
    span = (max(e["ts"] + e["dur"] for e in events)
            - min(e["ts"] for e in events)) / 1e3
    busy = sum(e["dur"] for e in kernels) / 1e3
    idle = max(0.0, 1 - busy / span) if span else None
    print(f"[cli-train] {tag}: trace {files[0]}: window {span:.2f} ms, device "
          f"kernels {busy:.2f} ms ({len(kernels)}), idle share "
          f"{idle:.1%}; flash kernels named: {flash}")
    if not any("flash_fwd" in k for k in flash) or not any("flash_bwd" in k
                                                          for k in flash):
        raise AssertionError(f"[cli-train] {tag}: the trace names no flash "
                             "forward and backward kernels")
    return {"trace": files[0], "window_ms": span, "device_ms": busy,
            "idle_share": idle, "flash_kernels": flash}


def run_train_cli(tag, main, argv, snapshot=()):
    """One training CLI `main(argv)` on the card, counted: every launch count
    set to 0 just before and read just after; the flash launches by shape
    between two logged steps (each step's), and after the last (the final
    eval); the logged metrics and the event file's path; each train step's
    time between two device synchronisations; the host batches' valid
    lengths (read as each is placed, by the prefetcher or inline); with
    `snapshot`, copies of the model's leaves whose names hold one of those
    strings as training starts; the peak of allocated device memory over the
    whole run and over `Trainer.fit` alone (the step's peak: the model
    built and placed). Returns (state, record)."""
    import torch

    from hsenet_torch.data import prefetch as tprefetch
    from hsenet_torch.ops import flash_attention as tfa
    from hsenet_torch.ops import quant_matvec as tqm
    from hsenet_torch.train import trainer as ttrainer

    rec = {"steps": {}, "logged": [], "step_ms": [], "lens": [], "before": {},
           "route": {"launches": {}, "f32": {}}}

    def take_counts():
        for key, counts in (("launches", tfa.launches), ("f32", tfa.f32_launches)):
            for k, n in counts.items():
                rec["route"][key][k] = rec["route"][key].get(k, 0) + n
        shapes = dict(tfa.shape_launches)
        tfa.reset_launch_counts()
        return shapes

    class CountingLogger(ttrainer.TensorBoardLogger):
        def __init__(self, logdir):
            super().__init__(logdir)
            rec["tb"] = self.path

        def __call__(self, step, metrics):
            rec["steps"][step] = take_counts()
            rec["logged"].append((step, dict(metrics)))
            super().__call__(step, metrics)

    fit, host_arrays = ttrainer.Trainer.fit, tprefetch.host_arrays

    def spy_fit(self, total_steps=None):
        model = self.state.model
        rec["before"] = {k: v.detach().to("cpu", copy=True)
                         for k, v in model.state_dict().items()
                         if any(part in k for part in snapshot)}
        inner = self.train_step

        def timed_step(*args):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = inner(*args)
            torch.cuda.synchronize()
            rec["step_ms"].append((time.perf_counter() - t) * 1e3)
            return out

        self.train_step = timed_step
        torch.cuda.synchronize()
        rec["build_peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
        torch.cuda.reset_peak_memory_stats()
        try:
            return fit(self, total_steps)
        finally:
            torch.cuda.synchronize()
            rec["step_peak_gb"] = torch.cuda.max_memory_allocated() / 1e9

    def spy_host_arrays(batch):  # each host batch, prefetched or placed inline
        rec["lens"].append(tuple(int(n) for n in batch["attention_mask"].sum(-1)))
        return host_arrays(batch)

    reset_counts()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    patches = ((ttrainer, "TensorBoardLogger", CountingLogger),
               (ttrainer.Trainer, "fit", spy_fit),
               (tprefetch, "host_arrays", spy_host_arrays))
    saved = [(obj, name, getattr(obj, name)) for obj, name, _ in patches]
    for obj, name, value in patches:
        setattr(obj, name, value)
    try:
        t0 = time.perf_counter()
        state = main(argv)
        torch.cuda.synchronize()
        rec["wall_s"] = time.perf_counter() - t0
    finally:
        for obj, name, value in saved:
            setattr(obj, name, value)
    rec["after"] = take_counts()
    rec["matvec_launches"] = tqm.launches[tqm.KERNEL] + tqm.fma_launches[tqm.FMA]
    rec["peak_gb"] = max(rec.get("build_peak_gb", 0.0),
                         torch.cuda.max_memory_allocated() / 1e9)
    fwd_route(f"cli-train {tag}", rec["route"]["launches"], rec["route"]["f32"])
    losses = [m["loss"] for _, m in rec["logged"]]
    print(f"[cli-train] {tag}: {' '.join(argv)}")
    print(f"[cli-train] {tag}: steps {[s for s, _ in rec['logged']]}, losses "
          f"{[round(x, 4) for x in losses]}; B5 launches {rec['matvec_launches']}")
    return state, rec


def launches_by_kernel(counts):
    """Flash launches of one step by kernel and head dim: B1 with and without
    the log-sum-exp, B3."""
    out = {}
    for (kind, *_, d), n in counts.items():
        key = f"{'B3' if kind == 'flash_bwd' else 'B1'}" + (
            " LSE" if kind == "flash_fwd_lse" else "") + f" d{d}"
        out[key] = out.get(key, 0) + n
    return dict(sorted(out.items()))


def check_train_cli_run(tag, rec, per_step, after, batch, falls=True):
    """A run's launches (each step `per_step(step)`, after the last step
    `after`), finite losses that fall over the run, no B5 launch; prints
    the run's wall, step ms (median of the steps after the first),
    samples/s and peak memory. Returns the run's numbers."""
    steps = {s: c for s, c in rec["steps"].items()}
    bad = {s: c for s, c in steps.items() if c != per_step(s)}
    losses = [m["loss"] for _, m in rec["logged"]]
    med = statistics.median(rec["step_ms"][1:] or rec["step_ms"])
    by_kernel = {s: launches_by_kernel(c) for s, c in steps.items()}
    print(f"[cli-train] {tag}: flash launches per step by kernel "
          f"{by_kernel}; after the last step {launches_by_kernel(rec['after'])}")
    print(f"[cli-train] {tag}: wall {rec['wall_s']:.1f} s, step "
          f"{med:.1f} ms (median of steps 2-{len(rec['step_ms'])}: "
          f"{[round(x, 1) for x in rec['step_ms']]}), {batch / (med / 1e3):.1f} "
          f"samples/s, peak memory {rec['peak_gb']:.2f} GB")
    if bad:
        raise AssertionError(f"[cli-train] {tag}: flash launches {bad}, not "
                             f"{ {s: per_step(s) for s in bad} }")
    if rec["after"] != after:
        raise AssertionError(f"[cli-train] {tag}: launches after the last step "
                             f"{rec['after']}, not {after}")
    if rec["matvec_launches"]:
        raise AssertionError(f"[cli-train] {tag}: B5 ran {rec['matvec_launches']} "
                             "times in training")
    if not all(map(math.isfinite, losses)) or (falls and not losses[-1] < losses[0]):
        raise AssertionError(f"[cli-train] {tag}: the loss did not fall: {losses}")
    return {"wall_s": rec["wall_s"], "step_ms_median": med,
            "step_ms": rec["step_ms"], "samples_per_s": batch / (med / 1e3),
            "peak_memory_gb": rec["peak_gb"], "losses": losses,
            "launches_per_step": {s: {" ".join(map(str, k)): n
                                      for k, n in c.items()}
                                  for s, c in steps.items()},
            "launches_after": {" ".join(map(str, k)): n
                               for k, n in rec["after"].items()}}


def vlm_launches(cfg, batch, seq, lse_fwd=True):
    """One VLM finetune step's flash launches by shape: both frozen towers'
    forwards (no log-sum-exp), the LLM's forward with it twice per layer
    under remat and its backward; `lse_fwd=False`: the eval's forwards."""
    v, llm = cfg.vision, cfg.llm
    tower = (batch, v.num_heads, v.seq_len, v.seq_len, v.hidden_size // v.num_heads)
    dec = (batch, llm.num_heads, seq, seq, llm.head_dim)
    if not lse_fwd:
        return {("flash_fwd", *tower): 2 * v.num_layers,
                ("flash_fwd", *dec): llm.num_layers}
    return {("flash_fwd", *tower): 2 * v.num_layers,
            ("flash_fwd_lse", *dec): 2 * llm.num_layers,
            ("flash_bwd", *dec): llm.num_layers}


def clip_eval_launches(cfg, batch):
    """The retrieval eval's forwards over one validation batch: both
    encoders, no log-sum-exp."""
    launches = clip_launches(cfg, batch, teacher=True)
    return {k: n for k, n in launches.items() if k[0] == "flash_fwd"}


def run_cli_train(card: str):
    """[cli-train]: `train_clip_stage1`, `train_clip_stage2` (recomputed,
    then cached teacher), `train_vlm --task mrg` (then resumed with
    --resume auto), `train_vlm --task vqa --int8-base` and `train_vlm --task
    mrg --online-slice-features` (a manifest without slice features), through their
    `main` at the CLIs' full-width defaults in bf16 with remat on, on the
    manifests `write_train_cli_data` writes to a temporary directory.
    Returns the phase's numbers and the flash launches by shape over the
    counted runs (the cached run's and the resumed run's included)."""
    import argparse
    import os
    import shutil
    import tempfile

    import torch

    from hsenet_torch.cli import train_clip_stage1, train_clip_stage2, train_vlm
    from hsenet_torch.cli.common import build_vlm_config

    root = tempfile.mkdtemp(prefix="hsenet_train_cli_")
    free_gb = shutil.disk_usage(root).free / 1e9
    print(f"[cli-train] on {card}; {free_gb:.1f} GB free under the temporary "
          "directory")
    numbers, shapes, recs = {}, {}, {}
    try:
        paths = write_train_cli_data(root)
        out = {k: os.path.join(root, k)
               for k in ("s1", "s2", "s2c", "mrg", "vqa", "online")}
        # one checkpoint a run, at its last step (the resumed run starts
        # there): a save of the VLM's trainable state (the token table and
        # its moments) is 8 GB, and a call to the card's machine may write
        # 45 GiB to its disk in all
        steps = ["--total-steps", str(TRAIN_CLI_STEPS), "--log-every", "1",
                 "--eval-every", str(TRAIN_CLI_STEPS), "--checkpoint-every",
                 str(TRAIN_CLI_STEPS), "--remat", "--data-root", root]
        clip = ["--manifest", paths["clip"], "--batch-size", str(TRAIN_CLI_BATCH["clip"])]
        cfg1, cfg2 = clip_config(), clip_config(slice_guided=True)
        clip_step = clip_launches(cfg1, TRAIN_CLI_BATCH["clip"])

        # 1. stage 1
        s1, recs["stage1"] = run_train_cli(
            "stage 1", train_clip_stage1.main,
            clip + steps + ["--output-dir", out["s1"], "--profile",
                            os.path.join(root, "prof_s1"), *TRAIN_CLI_PROFILE])
        numbers["stage1"] = check_train_cli_run(
            "stage 1", recs["stage1"], lambda s: clip_step,
            clip_eval_launches(cfg1, TRAIN_CLI_BATCH["clip"]), TRAIN_CLI_BATCH["clip"])
        numbers["stage1"]["profile"] = trace_numbers("stage 1", os.path.join(root, "prof_s1"))
        del s1

        # 2. stage 2 against stage 1's export, then 2 steps with the cache
        teacher = ["--stage1-checkpoint", os.path.join(out["s1"], "clip_params")]
        s2, recs["stage2"] = run_train_cli(
            "stage 2", train_clip_stage2.main,
            clip + steps + teacher + ["--output-dir", out["s2"], "--profile",
                                      os.path.join(root, "prof_s2"), *TRAIN_CLI_PROFILE])
        with_teacher = clip_launches(cfg2, TRAIN_CLI_BATCH["clip"], teacher=True)
        numbers["stage2"] = check_train_cli_run(
            "stage 2", recs["stage2"], lambda s: with_teacher,
            clip_eval_launches(cfg2, TRAIN_CLI_BATCH["clip"]), TRAIN_CLI_BATCH["clip"])
        numbers["stage2"]["profile"] = trace_numbers("stage 2", os.path.join(root, "prof_s2"))
        del s2
        s2c, recs["stage2_cached"] = run_train_cli(
            "stage 2 cached", train_clip_stage2.main,
            clip + ["--total-steps", "2"] + steps[2:] + teacher
            + ["--cached-teacher", "--output-dir", out["s2c"]])
        student = clip_launches(cfg2, TRAIN_CLI_BATCH["clip"])
        numbers["stage2_cached"] = check_train_cli_run(
            "stage 2 cached", recs["stage2_cached"],
            lambda s: with_teacher if s == 1 else student, {},
            TRAIN_CLI_BATCH["clip"], falls=False)
        del s2c
        want = numbers["stage2"]["losses"][:2]
        got = numbers["stage2_cached"]["losses"]
        rel = max(abs(a - b) / abs(b) for a, b in zip(got, want))
        print(f"[cli-train] stage 2 cached: losses {got} against the recomputed "
              f"run's first two {want}: max relative difference {rel:.3e} (limit "
              f"{CACHED_TEACHER_RTOL})")
        if not rel <= CACHED_TEACHER_RTOL:
            raise AssertionError("[cli-train] the cached teacher's losses are not "
                                 "the recomputed teacher's")
        numbers["stage2_cached"]["rel_to_recomputed"] = rel

        # 3. the VLM on both towers' exports; 4. resumed
        cfg = build_vlm_config(argparse.Namespace(synthetic=False))
        towers = ["--clip-stage1-checkpoint", os.path.join(out["s1"], "tower_params"),
                  "--clip-stage2-checkpoint", os.path.join(out["s2"], "tower_params")]
        mrg = (["--task", "mrg", "--manifest", paths["mrg"], "--batch-size",
                str(TRAIN_CLI_BATCH["mrg"]), "--async-save"] + steps + towers
               + ["--output-dir", out["mrg"]])
        vlm, recs["mrg"] = run_train_cli(
            "vlm mrg", train_vlm.main,
            mrg + ["--profile", os.path.join(root, "prof_mrg"), *TRAIN_CLI_PROFILE])
        mrg_step = vlm_launches(cfg, TRAIN_CLI_BATCH["mrg"], 800)
        numbers["mrg"] = check_train_cli_run(
            "vlm mrg", recs["mrg"], lambda s: mrg_step,
            vlm_launches(cfg, TRAIN_CLI_BATCH["mrg"], 800, lse_fwd=False),
            TRAIN_CLI_BATCH["mrg"])
        numbers["mrg"]["profile"] = trace_numbers("vlm mrg", os.path.join(root, "prof_mrg"))
        # the frozen tower_stage1 holds stage 1's export, rounded to the
        # bf16 in which the VLM keeps its frozen leaves
        export = torch.load(os.path.join(out["s1"], "tower_params"),
                            map_location="cuda", weights_only=True)
        vlm_state = vlm.model.state_dict()
        prefix = train_vlm.TOWER_PREFIX["stage1"]
        same = all(torch.equal(vlm_state[prefix + k], v.to(vlm_state[prefix + k].dtype))
                   for k, v in export.items())
        print(f"[cli-train] vlm mrg: the trained VLM's tower_stage1 ({len(export)} "
              f"leaves) equals stage 1's export in bf16 bit for bit: {same}")
        if not same:
            raise AssertionError("[cli-train] the VLM's frozen tower moved or "
                                 "was not grafted")
        del vlm, vlm_state, export
        gc.collect()
        torch.cuda.empty_cache()

        at = mrg.index("--total-steps") + 1
        resumed = mrg[:at] + ["6"] + mrg[at + 1:] + ["--resume", "auto"]
        vlm, recs["mrg_resumed"] = run_train_cli("vlm mrg resumed", train_vlm.main,
                                                 resumed)
        numbers["mrg_resumed"] = check_train_cli_run(
            "vlm mrg resumed", recs["mrg_resumed"], lambda s: mrg_step, {},
            TRAIN_CLI_BATCH["mrg"], falls=False)
        logged = [s for s, _ in recs["mrg_resumed"]["logged"]]
        first = numbers["mrg"]["losses"][0]
        print(f"[cli-train] vlm mrg resumed: steps {logged} (the first run ended "
              f"at {TRAIN_CLI_STEPS}), losses {numbers['mrg_resumed']['losses']} "
              f"below the first run's first {first:.4f}")
        if logged != [5, 6] or vlm.step != 6 or not max(
                numbers["mrg_resumed"]["losses"]) < first:
            raise AssertionError("[cli-train] --resume auto did not continue the run")
        del vlm
        gc.collect()
        torch.cuda.empty_cache()

        # 5. VQA with an int8 base
        vqa = (["--task", "vqa", "--manifest", paths["vqa"], "--batch-size",
                str(TRAIN_CLI_BATCH["vqa"]), "--int8-base", "--async-save",
                "--total-steps", "3"]
               + steps[2:] + towers + ["--output-dir", out["vqa"], "--profile",
                                       os.path.join(root, "prof_vqa"), *TRAIN_CLI_PROFILE])
        vlm, recs["vqa"] = run_train_cli("vlm vqa int8", train_vlm.main, vqa,
                                         snapshot=("weight_q", "lora_a", "lora_b"))
        vqa_seq = 330
        numbers["vqa_int8"] = check_train_cli_run(
            "vlm vqa int8", recs["vqa"],
            lambda s: vlm_launches(cfg, TRAIN_CLI_BATCH["vqa"], vqa_seq), {},
            TRAIN_CLI_BATCH["vqa"])
        numbers["vqa_int8"]["profile"] = trace_numbers("vlm vqa int8",
                                                       os.path.join(root, "prof_vqa"))
        before = recs["vqa"]["before"]
        end = {k: v.cpu() for k, v in vlm.model.state_dict().items() if k in before}
        codes = [k for k in before if k.endswith("weight_q")]
        codes_same = bool(codes) and all(torch.equal(end[k], before[k]) for k in codes)
        adapters = [k for k in before if ".lora_" in k]
        moved = sum(not torch.equal(end[k], before[k]) for k in adapters)
        print(f"[cli-train] vlm vqa int8: {len(codes)} int8 code tensors unchanged "
              f"after training: {codes_same}; {moved} of {len(adapters)} LoRA "
              f"tensors moved (lora_b starts at 0: every B moves, A moves once B "
              f"is nonzero); peak memory {recs['vqa']['peak_gb']:.2f} GB with "
              f"--int8-base (batch 5 x 330) against {recs['mrg']['peak_gb']:.2f} "
              "GB without (batch 2 x 800)")
        if not codes_same or moved < len(adapters) // 2:
            raise AssertionError("[cli-train] --int8-base moved the codes or "
                                 "trained no adapter")
        numbers["vqa_int8"]["codes_unchanged"] = codes_same
        numbers["vqa_int8"]["adapters_moved"] = [moved, len(adapters)]
        del vlm, end, before
        recs["vqa"]["before"] = {}
        gc.collect()
        torch.cuda.empty_cache()

        # 6. in-graph slice features (the frozen BiomedCLIP trunk) on the MRG
        # manifest without them
        online = (["--task", "mrg", "--manifest", paths["mrg_online"], "--batch-size",
                   str(TRAIN_CLI_BATCH["mrg"]), "--online-slice-features",
                   "--total-steps", str(TRAIN_CLI_ONLINE_STEPS)]
                  + steps[2:] + towers + ["--output-dir", out["online"]])
        vlm, recs["online"] = run_train_cli("vlm mrg online", train_vlm.main, online,
                                            snapshot=("slice_encoder.",))
        trunk = trunk_launches(build_vlm_config(argparse.Namespace(
            synthetic=False, online_slice_features=True)), TRAIN_CLI_BATCH["mrg"])
        numbers["mrg_online"] = check_train_cli_run(
            "vlm mrg online", recs["online"], lambda s: {**mrg_step, **trunk}, {},
            TRAIN_CLI_BATCH["mrg"])
        before = recs["online"]["before"]
        end = vlm.model.state_dict()
        kept = bool(before) and all(torch.equal(end[k].cpu(), v) for k, v in before.items())
        print(f"[cli-train] vlm mrg online: B1 launches a step from the trunk "
              f"{trunk}, none with a log-sum-exp and no B3 at that shape; the "
              f"trunk's {len(before)} leaves unchanged bit for bit: {kept}")
        if not kept:
            raise AssertionError("[cli-train] the frozen 2D trunk moved")
        numbers["mrg_online"]["trunk_unchanged"] = kept
        del vlm, end, before
        recs["online"]["before"] = {}
        gc.collect()
        torch.cuda.empty_cache()

        for name, rec in recs.items():
            check_tensorboard_file(name, rec["tb"], rec["logged"])
        for name, run in (("stage1", out["s1"]), ("stage2", out["s2"])):
            for export in ("clip_params", "tower_params"):
                if not os.path.isfile(os.path.join(run, export)):
                    raise AssertionError(f"[cli-train] {name}: no {export}")
        for name in ("mrg", "vqa", "online"):
            if not os.path.isfile(os.path.join(out[name], "vlm_deltas")):
                raise AssertionError(f"[cli-train] {name}: no vlm_deltas")
    finally:
        shutil.rmtree(root, ignore_errors=True)

    for rec in recs.values():
        for counts in (*rec["steps"].values(), rec["after"]):
            for key, n in counts.items():
                shapes[key] = shapes.get(key, 0) + n
    lens = {len(rec["lens"][0]): rec["lens"][0] for name, rec in recs.items()
            if name in ("mrg", "vqa")}
    numbers["llm_kv_lens"] = {str(b): list(v) for b, v in lens.items()}
    numbers["card"] = card
    return numbers, shapes, lens


def train_cli_kernel_cases(path_shapes, known, lens, prefix="train_cli"):
    """The flash cases of the [cli-train] shapes that no earlier phase
    timed: the VLM towers (non-causal over 2049 tokens) and the LLM at the
    runs' batch sizes (causal, the first training batch's valid lengths),
    with the kinds each shape launched (a shape whose backward ran ran its
    forward with the log-sum-exp)."""
    by_shape = {}
    for kind, *shape in path_shapes:
        if (kind, *shape) not in known:
            by_shape.setdefault(tuple(shape), set()).add(kind)
    cases = []
    for (b, h, s, _, d), kinds in sorted(by_shape.items()):
        tower = d == 64
        name = f"{prefix}_{'tower' if tower else 'llm'}_{b}x{h}x{s}"
        kv = (s,) * b if tower else lens[b]
        fwd = tuple(k for k in ("flash_fwd", "flash_fwd_lse")
                    if k in kinds or (k == "flash_fwd_lse" and "flash_bwd" in kinds))
        cases.append((name, (b, h, s, d), kv, not tower, (b, h), fwd))
    return cases


def check_train_cli_kernels(path_shapes, known, lens, prefix="train_cli"):
    """[kernel-train-cli]: B1 and B3 at the [cli-train] shapes no earlier
    phase held and timed (`check_flash_cases`), named `prefix`_... Returns
    the results and the launch key -> (kernel, shape name)."""
    cases = train_cli_kernel_cases(path_shapes, known, lens, prefix)
    results = check_flash_cases(cases, seed=17)
    index = {}
    for name, (b, h, s, d), _, _, _, fwd_kinds in cases:
        for kind in fwd_kinds:
            index[(kind, b, h, s, s, d)] = (
                "flash_fwd", name + ("_lse" if kind == "flash_fwd_lse" else ""))
        index[("flash_bwd", b, h, s, s, d)] = ("flash_bwd", name)
    return results, index


def pv_bound(mode, g, m, k, n):
    """(bound_ms, bound_by, operations, bytes) of one B6 launch: P read once
    in its mode's dtype, V once (not in glue_only), the f32 output written
    once; 2 M K N operations per cell on the tensor cores at the bf16 or
    int8 peak, or for glue_only 3 per element of P (multiply, round, add)
    on the CUDA cores at the f32 peak."""
    p_bytes = {"bf16": 2, "int8_pre": 1, "quant_then_int8": 4, "glue_only": 4}[mode]
    v_bytes = {"bf16": 2, "int8_pre": 1, "quant_then_int8": 1, "glue_only": 0}[mode]
    nbytes = g * m * k * p_bytes + g * k * n * v_bytes + 4 * g * m * n
    if mode == "glue_only":
        ops, peak = 3 * g * m * k, PEAK_F32_FLOPS
    else:
        ops = 2 * g * m * k * n
        peak = PEAK_BF16_FLOPS if mode == "bf16" else PEAK_INT8_OPS
    t_ops, t_bytes = ops / peak * 1e3, nbytes / PEAK_BYTES_PER_S * 1e3
    if t_ops >= t_bytes:
        return t_ops, "operations", ops, nbytes
    return t_bytes, "bytes", ops, nbytes


def check_pv_kernel():
    """[kernel-pv]: B6 in its four modes at the probe's shapes, both kernels
    (the probe's int8_pv_wgmma and the yardstick int8_pv) against the plain
    version, beside wrong variants that must miss; int8_pv_wgmma again at
    an M off its row tile; both timed in turns (yardstick, new, new,
    yardstick) beside the bound, the plain version and, for bf16, one
    batched library product (no single PyTorch call computes the integer
    modes). int8_pv_wgmma, which the probe launches, must not be slower
    than PV_SLACK times the yardstick."""
    import torch

    from hsenet_torch.ops import int8_pv as tpv
    from hsenet_torch.scripts import probe_int8_pv as probe

    if torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("the bf16 plain version needs full-f32 products")
    g, m, k, n = probe.SHAPES
    kernels = {tpv.KERNEL: tpv.int8_pv_wgmma_kernel,
               tpv.YARDSTICK: tpv.int8_pv_kernel}
    results = {name: {} for name in kernels}

    def holds(mode, out, ref):
        """(max abs error, max error / row's max |ref|, within the limit)."""
        row_max = ref.abs().amax(dim=-1, keepdim=True).clamp_min(1e-30)
        err = torch.where(out.isfinite(), (out - ref).abs() / row_max,
                          math.inf).max().item()
        ok = err <= PV_BF16_ROW_TOL if mode == "bf16" else torch.equal(out, ref)
        return (out - ref).abs().max().item(), err, ok

    for mode in tpv.MODES:
        p, v = probe.make_inputs(mode, probe.SHAPES, device="cuda")
        ref = tpv.int8_pv_reference(p, v, mode)
        kept = p[..., :-PV_DROPPED_K]
        wrong = {f"last {PV_DROPPED_K} of K dropped": tpv.int8_pv_reference(
            kept, None if v is None else v[:, :-PV_DROPPED_K], mode)}
        if mode == "quant_then_int8":
            wrong["P quantised with a scale of 128"] = tpv.int8_pv_reference(
                torch.round(p * 128.0).clamp(-128, 127).to(torch.int8), v,
                "int8_pre")
        missed = {w: holds(mode, o, ref) for w, o in wrong.items()}
        passes = [w for w, (_, _, ok) in missed.items() if ok]
        print(f"[kernel-pv] {mode}: P{tuple(p.shape)} {p.dtype}, V"
              f"{tuple(v.shape)} {v.dtype}, max |ref| {ref.abs().max().item():.3e}; "
              "wrong variants (max err / row's max |ref|): "
              + ", ".join(f"{w} {e:.3e}" for w, (_, e, _) in missed.items()))
        if passes:
            raise AssertionError(f"int8_pv {mode}: the check passes {passes}")
        del wrong, kept
        errs = {}
        for name, fn in kernels.items():
            out = fn(p, v, mode)
            torch.cuda.synchronize()
            errs[name] = holds(mode, out, ref)
            max_abs, err, ok = errs[name]
            limit = (f"max err / row's max |ref| {err:.3e} (tol {PV_BF16_ROW_TOL})"
                     if mode == "bf16" else f"bit-equal: {ok}")
            print(f"[kernel-pv] {name} {mode}: max_abs_err {max_abs:.3e}, {limit}")
            if not ok:
                raise AssertionError(f"{name} {mode} disagrees with its plain version")
            del out
        # int8_pv_wgmma at an M that is not a multiple of its row tile
        off = (8, PV_OFF_TILE_M, k, n)
        pm, vm = probe.make_inputs(mode, off, device="cuda", seed=1)
        refm = tpv.int8_pv_reference(pm, vm, mode)
        m_abs, m_err, m_ok = holds(mode, tpv.int8_pv_wgmma_kernel(pm, vm, mode),
                                   refm)
        limit = (f"max err / row's max |ref| {m_err:.3e}" if mode == "bf16"
                 else f"bit-equal: {m_ok}")
        print(f"[kernel-pv] {tpv.KERNEL} {mode} at G 8, M {PV_OFF_TILE_M} (row "
              f"tile {tpv.row_tile(mode)}): max_abs_err {m_abs:.3e}, {limit}")
        if not m_ok:
            raise AssertionError(f"{tpv.KERNEL} {mode} disagrees off its row tile")
        del pm, vm, refm

        library = None
        if mode == "bf16":  # one batched product with f32 output
            library = time_ms(lambda: torch.bmm(p, v, out_dtype=torch.float32))
        plain = time_ms(lambda: tpv.int8_pv_reference(p, v, mode), reps=2,
                        warmup=1, runs=3)
        bound, bound_by, ops, nbytes = pv_bound(mode, g, m, k, n)
        turns = {name: [] for name in kernels}
        for name in (tpv.YARDSTICK, tpv.KERNEL, tpv.KERNEL, tpv.YARDSTICK):
            turns[name].append(time_ms(lambda fn=kernels[name]: fn(p, v, mode)))
        times = {name: statistics.mean(t) for name, t in turns.items()}
        for name in kernels:
            r = results[name][mode] = {
                "max_abs_err": errs[name][0], "max_row_rel_err": errs[name][1],
                "ms": times[name], "turns_ms": turns[name], "plain_ms": plain,
                "library_ms": library, "bound_ms": bound, "bound_by": bound_by,
                "gops": ops / 1e9, "mbytes": nbytes / 1e6,
                "tflops": 2 * g * m * k * n / times[name] / 1e9,
            }
        results[tpv.KERNEL][f"{mode}_m{PV_OFF_TILE_M}"] = {
            "max_abs_err": m_abs, "max_row_rel_err": m_err, "shape": list(off),
            "ms": None, "plain_ms": None, "library_ms": None,
            "bound_ms": pv_bound(mode, *off)[0], "bound_by": bound_by}
        lib = ("— (no single PyTorch call: torch has no batched int8 product)"
               if library is None
               else f"{library:.4f} ms (torch.bmm(..., out_dtype=float32))")
        new, old = times[tpv.KERNEL], times[tpv.YARDSTICK]
        print(f"[kernel-pv] {mode}: {tpv.KERNEL} {new:.4f} ms ({nbytes / new / 1e6:.0f} "
              f"GB/s, {bound / new:.1%} of the bound; turns "
              f"{turns[tpv.KERNEL][0]:.4f}, {turns[tpv.KERNEL][1]:.4f}), "
              f"{tpv.YARDSTICK} {old:.4f} ms (turns {turns[tpv.YARDSTICK][0]:.4f}, "
              f"{turns[tpv.YARDSTICK][1]:.4f}; new / old {new / old:.3f}), plain "
              f"{plain:.4f} ms, library {lib}, bound {bound:.4f} ms ({bound_by}: "
              f"{nbytes / 1e9:.3f} GB, {ops / 1e9:.1f} G operations)")
        if new > PV_SLACK * old:
            raise AssertionError(f"int8_pv_wgmma {mode} ({new:.4f} ms) is slower "
                                 f"than {PV_SLACK} x int8_pv ({old:.4f} ms)")
        del p, v, ref
        torch.cuda.empty_cache()
    return results


def run_pv_probe():
    """B6's path: the probe entry `hsenet_torch.scripts.probe_int8_pv` over
    its four modes, launches counted by kernel and mode; every mode must
    have launched int8_pv_wgmma, and never the yardstick."""
    from hsenet_torch.ops import int8_pv as tpv
    from hsenet_torch.scripts import probe_int8_pv as probe

    tpv.reset_launch_counts()  # the probe's run, counted
    probe.probe(tpv.MODES, probe.SHAPES, device="cuda")
    launches = {name: dict(c) for name, c in tpv.launches.items()}
    print(f"[kernel-pv] probe run: launches by kernel and mode {launches}")
    for mode in tpv.MODES:
        if launches[tpv.KERNEL][mode] == 0 or launches[tpv.YARDSTICK][mode]:
            raise AssertionError(f"the probe's {mode} run did not go through "
                                 f"{tpv.KERNEL} alone: {launches}")
    return launches


def build_encode_path(vit_cfg):
    """bench.py's encode model: both towers and the two packer_v3
    projectors, in bf16 on the card, returning the packed image tokens and
    the two towers' features."""
    import torch
    from torch import nn

    from hsenet_torch.configs import PackerConfig
    from hsenet_torch.models.projector import build_projector
    from hsenet_torch.models.vit import DualVisionTower

    class EncodePath(nn.Module):
        def __init__(self):
            super().__init__()
            kw = dict(dtype=torch.bfloat16, device="cuda")
            self.tower = DualVisionTower(vit_cfg, **kw)
            self.p1 = build_projector(PackerConfig(), **kw)
            self.p2 = build_projector(PackerConfig(), **kw)

        def forward(self, volume, slices):
            f1, f2 = self.tower(volume, slices)
            return torch.cat([self.p1(f1), self.p2(f2)], dim=1), (f1, f2)

    return EncodePath().eval()


def token_cosines(got, want):
    """Per-token cosine of two (..., D) feature tensors, in f32."""
    a, b = got.float().flatten(0, -2), want.float().flatten(0, -2)
    return (a * b).sum(-1) / (a.norm(dim=-1) * b.norm(dim=-1)).clamp_min(1e-30)


def run_encode_w8a8(card: str):
    """[encode-w8a8]: the W8A8 serving encode of bench.py at full width and
    batch 8 (static activation scales from 2 volumes, tanh GELU) against
    the float bf16/erf encode of the same weights: per-token cosine of the
    tower features beside a wrong variant, flash launches per encode, vol/s
    of both, a profile, and B1's time at the batch-8 tower shape."""
    import torch
    import torch.nn.functional as F

    from hsenet_torch.configs import ViT3DConfig, VLMConfig
    from hsenet_torch.models import init_random_
    from hsenet_torch.models.lora import (
        DenseW8A8,
        calibrate_w8a8_act_scales,
        quantize_towers_w8a8,
    )
    from hsenet_torch.ops import flash_attention as tfa

    t0 = time.perf_counter()
    float_path = build_encode_path(ViT3DConfig())
    init_random_(float_path, torch.Generator(device="cuda").manual_seed(3))
    w8a8_cfg = ViT3DConfig(quant_w8a8=True, quant_w8a8_static=True,
                           gelu_approx=True)
    w8a8_path = build_encode_path(w8a8_cfg)
    w8a8_path.load_state_dict(
        quantize_towers_w8a8(float_path.state_dict(), static=True), strict=True)
    gen = torch.Generator(device="cuda").manual_seed(4)
    vol = torch.rand((ENCODE_BATCH, 1, *w8a8_cfg.image_size), generator=gen,
                     device="cuda").to(torch.bfloat16)
    sl = torch.rand((ENCODE_BATCH, w8a8_cfg.num_slices,
                     w8a8_cfg.slice_feature_dim), generator=gen, device="cuda")
    calibrate_w8a8_act_scales(
        w8a8_path, [(vol[:W8A8_CALIB_VOLUMES], sl[:W8A8_CALIB_VOLUMES])])
    denses = [m for m in w8a8_path.modules() if isinstance(m, DenseW8A8)]
    torch.cuda.synchronize()
    print(f"[encode-w8a8] float and W8A8 encode paths (2 ViT-B towers + 2 "
          f"packers, bf16; {len(denses)} DenseW8A8 calibrated on "
          f"{W8A8_CALIB_VOLUMES} volumes), built in "
          f"{time.perf_counter() - t0:.1f} s")

    with torch.inference_mode():
        ref_packed, ref_feats = float_path(vol, sl)
        tfa.reset_launch_counts()  # one W8A8 encode, counted
        packed, feats = w8a8_path(vol, sl)
        torch.cuda.synchronize()
        flash, flash_all = tfa.fwd_launches[(64, False)], sum(tfa.launches.values())
        fwd_route("encode-w8a8", tfa.launches, tfa.f32_launches)
        cos = torch.cat([token_cosines(f, r) for f, r in zip(feats, ref_feats)])
        cos_packed = token_cosines(packed, ref_packed)
        # the limit's power: the first block of each tower with its
        # activation scales divided by 4
        first = [m for tower in (w8a8_path.tower.tower_stage1,
                                 w8a8_path.tower.tower_stage2)
                 for m in tower.tower.blocks[0].modules()
                 if isinstance(m, DenseW8A8)]
        for m in first:
            m.act_scale /= 4
        _, clipped = w8a8_path(vol, sl)
        for m in first:
            m.act_scale *= 4
        clipped_cos = torch.cat([token_cosines(f, r) for f, r in zip(clipped, ref_feats)])
        # and one dense's weight scales shifted by one channel in each tower
        for m in first[:1] + first[4:5]:
            m.weight_scale.copy_(m.weight_scale.roll(1))
        _, shifted = w8a8_path(vol, sl)
        for m in first[:1] + first[4:5]:
            m.weight_scale.copy_(m.weight_scale.roll(-1))
        shifted_cos = torch.cat([token_cosines(f, r) for f, r in zip(shifted, ref_feats)])
    finite = all(bool(f.float().isfinite().all()) for f in (packed, *feats))
    print(f"[encode-w8a8] batch {ENCODE_BATCH}: packed tokens "
          f"{tuple(packed.shape)}, finite {finite}; per-token cosine of the W8A8 "
          f"tower features vs the float bf16/erf towers: min {cos.min().item():.5f}, "
          f"mean {cos.mean().item():.5f} (limit: min >= {W8A8_COSINE_MIN}); packed "
          f"tokens min {cos_packed.min().item():.5f}; first block's activation "
          f"scales / 4: min {clipped_cos.min().item():.5f}, mean "
          f"{clipped_cos.mean().item():.5f}; one dense's weight scales shifted "
          f"by a channel: min {shifted_cos.min().item():.5f}; flash launches "
          f"{flash} (expected {2 * w8a8_cfg.num_layers})")
    n_img = VLMConfig().num_image_tokens
    if not finite or packed.shape != (ENCODE_BATCH, n_img, VLMConfig().llm.hidden_size):
        raise AssertionError("the W8A8 encode gave non-finite or misshapen tokens")
    if cos.min().item() < W8A8_COSINE_MIN:
        raise AssertionError("W8A8 tower features disagree with the float towers")
    if clipped_cos.min().item() >= W8A8_COSINE_MIN:
        raise AssertionError("the cosine limit passes clipped activations")
    if shifted_cos.min().item() >= W8A8_COSINE_MIN:
        raise AssertionError("the cosine limit passes shifted weight scales")
    if flash != 2 * w8a8_cfg.num_layers or flash_all != flash:
        raise AssertionError(f"a W8A8 encode launched flash_fwd {flash} times")

    with torch.inference_mode():
        w8a8_ms = median_wall_ms(lambda: w8a8_path(vol, sl))
        float_ms = median_wall_ms(lambda: float_path(vol, sl))
        profiles = {
            "w8a8": profile_phase(f"encode W8A8, batch {ENCODE_BATCH}",
                                  lambda: w8a8_path(vol, sl), w8a8_ms, top=8),
            "float": profile_phase(f"encode bf16/erf, batch {ENCODE_BATCH}",
                                   lambda: float_path(vol, sl), float_ms, top=8),
        }
    # the quantisation glue: the W8A8 encode's elementwise device time
    # (conversions, division, rounding, clipping, rescaling) beyond the
    # float encode's
    kinds = [profiles[k].get("by_kind_ms") for k in ("w8a8", "float")]
    glue_ms = None if None in kinds else kinds[0]["other"] - kinds[1]["other"]
    numbers = {
        "batch": ENCODE_BATCH,
        "w8a8_ms": w8a8_ms, "float_ms": float_ms,
        "w8a8_vol_per_s": ENCODE_BATCH / (w8a8_ms / 1e3),
        "float_vol_per_s": ENCODE_BATCH / (float_ms / 1e3),
        "cosine_min": cos.min().item(), "cosine_mean": cos.mean().item(),
        "packed_cosine_min": cos_packed.min().item(),
        "clipped_cosine_min": clipped_cos.min().item(),
        "shifted_scales_cosine_min": shifted_cos.min().item(),
        "flash_launches": flash,
        "quant_glue_device_ms": glue_ms,
        "profiles": profiles,
    }
    print(f"[encode-w8a8] on {card}: W8A8 (static scales, tanh GELU) "
          f"{numbers['w8a8_vol_per_s']:.2f} vol/s ({w8a8_ms:.2f} ms), bf16/erf "
          f"{numbers['float_vol_per_s']:.2f} vol/s ({float_ms:.2f} ms) at batch "
          f"{ENCODE_BATCH}; quantise glue (device time of the W8A8 encode's "
          f"elementwise kernels beyond the float encode's) "
          f"{'not measured' if glue_ms is None else f'{glue_ms:.2f} ms'}")

    # B1 at the batch-8 tower shape, for the launches of this path
    q, k, v = (t.contiguous() for t in torch.randn(
        3, ENCODE_BATCH, 12, 2049, 64, generator=gen, device="cuda",
        dtype=torch.bfloat16))
    kv_t = torch.full((ENCODE_BATCH,), 2049, dtype=torch.int32, device="cuda")
    out = tfa.flash_attention(q, k, v, kv_lens=kv_t)
    ref = tfa.flash_attention_reference(q, k, v, kv_lens=kv_t)
    max_abs, row_rel, ok = compare(out, ref)
    if not ok:
        raise AssertionError("flash_fwd disagrees at the batch-8 tower shape")
    bound, bound_by, flops, nbytes = kernel_bound(
        "flash_fwd", ENCODE_BATCH, 12, 2049, 2049, 64, (2049,) * ENCODE_BATCH,
        (0,) * ENCODE_BATCH, False)
    tower_b8 = {
        "max_abs_err": max_abs, "max_row_rel_err": row_rel,
        "ms": time_ms(lambda: tfa.flash_attention(q, k, v, kv_lens=kv_t)),
        "plain_ms": time_ms(lambda: tfa.flash_attention_reference(
            q, k, v, kv_lens=kv_t), reps=2, warmup=1, runs=3),
        "library_ms": time_ms(lambda: F.scaled_dot_product_attention(q, k, v)),
        "bound_ms": bound, "bound_by": bound_by,
        "gflop": flops / 1e9, "mbytes": nbytes / 1e6,
    }
    tower_b8.update(fwd_yardsticks(q, k, v, kv_t, torch.zeros_like(kv_t), False,
                                   False))
    print(f"[kernel] flash_fwd encode_w8a8_tower q{tuple(q.shape)}: max err / "
          f"row's max |ref| {row_rel:.3e} (tol {KERNEL_ROW_TOL}); kernel "
          f"{tower_b8['ms']:.4f} ms, plain {tower_b8['plain_ms']:.4f} ms, library "
          f"(SDPA) {tower_b8['library_ms']:.4f} ms, bound {bound:.4f} ms "
          f"({bound_by}){yardstick_text(tower_b8)}")
    return numbers, {"encode_w8a8_tower": tower_b8}


def next_token_margin(logits, token):
    """Of one (V,) greedy logits row where speculative decoding chose
    `token` (None where its output had ended): (top-1 minus top-2 logit,
    top-1 minus the chosen token's logit, that gap over the logits' RMS).
    The gap is the top-2 margin when the chosen token is greedy's
    runner-up, and an arbitrary token's distance from the top otherwise."""
    x = logits.float().reshape(-1)
    top = x.topk(2).values
    margin = (top[0] - top[1]).item()
    gap = margin if token is None else (top[0] - x[token]).item()
    return margin, gap, gap / x.pow(2).mean().sqrt().item()


def first_divergence(got, want):
    """The first position where two token lists differ, or None."""
    for i, (a, b) in enumerate(zip(got, want)):
        if a != b:
            return i
    return None if len(got) == len(want) else min(len(got), len(want))


def check_near_ties(tag, diverged):
    """`diverged` lists (request, position, top-2 margin, chosen token's
    gap, gap's share of RMS): every divergence must pick a token within a
    near-tie of greedy's top logit."""
    for req, pos, margin, gap, share in diverged:
        print(f"[{tag}] request {req} leaves greedy at token {pos}: greedy's "
              f"top-2 logit margin there {margin:.4e}, the chosen token "
              f"{gap:.4e} below the top = {share:.3e} of the logits' RMS "
              f"(near-tie limit {NEAR_TIE_SHARE})")
    far = [d for d in diverged if d[4] > NEAR_TIE_SHARE]
    if far:
        raise AssertionError(f"{tag}: speculative tokens leave greedy away from "
                             f"a near-tie: {far}")


def f32_head_logits(llm, hidden):
    """The LM head of `llm` on `hidden` with its product and scale in f32
    (the model's own head rounds the logits to bf16)."""
    import torch.nn.functional as F

    if llm.config.tie_word_embeddings and llm.config.quant_int8_embed:
        return (F.linear(hidden.float(), llm.embed.embedding_q.float())
                * llm.embed.scale.float())
    head = llm.embed if llm.config.tie_word_embeddings else llm.lm_head
    return F.linear(hidden.float(), head.weight.float())


def greedy_divergences(cfg, llm, ids, got, want, head=f32_head_logits):
    """Where the token list `got` first leaves greedy's `want` for the
    batch-1 prompt `ids`: (position or None, [(0, position, *margins)]),
    the margins from a prefill of the prompt and the greedy tokens before
    that position, on `head`'s logits of its last hidden state (f32 by
    default)."""
    import torch

    from hsenet_torch.models.phi3 import KVCache

    div = first_divergence(got, want)
    if div is None:
        return None, []
    with torch.inference_mode():
        prefix = torch.cat([ids, torch.tensor([want[:div]], dtype=ids.dtype,
                                              device=ids.device)], dim=1)
        cache = KVCache.create(cfg.llm, 1, prefix.shape[1], device="cuda")
        hidden, _ = llm.decoder(
            llm.embed_tokens(prefix), cache=cache,
            kv_lens=torch.tensor([prefix.shape[1]], device="cuda"))
        logits = head(llm, hidden[0, -1])
    chosen = got[div] if div < len(got) else None
    return div, [(0, div, *next_token_margin(logits, chosen))]


class AcceptOnePastMismatch:
    """[spec]'s wrong variant: the LLM with each verify forward's logits
    edited so that the round accepts the draft at its first mismatch too,
    one draft past the last correct one."""

    def __init__(self, llm):
        self.llm, self.config = llm, llm.config

    def __call__(self, tokens, **kw):
        logits, cache = self.llm(tokens, **kw)
        if tokens.shape[1] == SPEC_DRAFT_LEN + 1 and not kw.get("last_token_only"):
            drafts = tokens[0, 1:]
            miss = (drafts != logits[0, :-1].argmax(dim=-1)).nonzero()
            if len(miss):
                at = int(miss[0, 0])
                logits[0, at, drafts[at]] = logits[0, at].max() + 1
        return logits, cache


def wrong_acceptance_misses(cfg, llm, ids, lens, want):
    """Prompt-lookup decoding that accepts one draft past its first
    mismatch must leave greedy away from a near-tie: the near-tie check
    has to refuse it. Returns the divergence it printed."""
    import torch

    from hsenet_torch.eval.speculative import make_pld_generate_llm_only

    wrong = make_pld_generate_llm_only(
        AcceptOnePastMismatch(llm), max_new_tokens=SPEC_NEW_TOKENS,
        draft_len=SPEC_DRAFT_LEN, ngram=SPEC_NGRAM, eos_token_id=EOS_TOKEN_ID,
        cache_dtype=torch.bfloat16)(ids, lens)
    div, diverged = greedy_divergences(cfg, llm, ids, wrong[0].tolist(), want)
    if div is None:
        raise AssertionError("the wrong-acceptance variant equals greedy")
    try:
        check_near_ties("spec wrong variant", diverged)
    except AssertionError:
        print(f"[spec] wrong variant (one draft accepted past its first "
              f"mismatch) misses the near-tie limit, as it must")
        return diverged
    raise AssertionError("the near-tie check passes a wrong acceptance")


def spec_against_greedy(tag, cfg, llm, ids, lens):
    """One prompt through greedy decoding and through prompt-lookup
    decoding on `llm`: tokens, rounds, tokens/s of both, launches of the
    speculative run, and greedy's margin where the two part; and greedy's
    tokens."""
    import torch

    from hsenet_torch.eval.generate import make_greedy_generate_llm_only
    from hsenet_torch.eval.speculative import make_pld_generate_llm_only
    from hsenet_torch.ops import flash_attention as tfa
    from hsenet_torch.ops import quant_matvec as tqm

    kw = dict(eos_token_id=EOS_TOKEN_ID, cache_dtype=torch.bfloat16)
    spec_kw = dict(draft_len=SPEC_DRAFT_LEN, ngram=SPEC_NGRAM, **kw)
    # warm-up off the record: a few tokens through each
    make_greedy_generate_llm_only(llm, max_new_tokens=4, **kw)(ids, lens)
    make_pld_generate_llm_only(llm, max_new_tokens=16, **spec_kw)(ids, lens)
    greedy = make_greedy_generate_llm_only(llm, max_new_tokens=SPEC_NEW_TOKENS, **kw)
    spec = make_pld_generate_llm_only(llm, max_new_tokens=SPEC_NEW_TOKENS,
                                      collect_stats=True, **spec_kw)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    want = greedy(ids, lens)
    torch.cuda.synchronize()
    greedy_s = time.perf_counter() - t0
    reset_counts()  # the speculative run, counted
    t0 = time.perf_counter()
    got, rounds, emitted = spec(ids, lens)
    torch.cuda.synchronize()
    spec_s = time.perf_counter() - t0
    b5 = tqm.launches["quant_matvec"]
    flash = sum(tfa.launches.values())
    fwd_route("spec", tfa.launches, tfa.f32_launches)
    per_round = 7 * cfg.llm.num_layers
    mean_committed = int(emitted.sum()) / rounds
    got_l, want_l = got[0].tolist(), want[0].tolist()
    div, diverged = greedy_divergences(cfg, llm, ids, got_l, want_l)
    numbers = {
        "rounds": rounds, "mean_committed_per_round": mean_committed,
        "spec_tokens_per_s": SPEC_NEW_TOKENS / spec_s,
        "greedy_tokens_per_s": SPEC_NEW_TOKENS / greedy_s,
        "quant_matvec_launches": b5, "flash_fwd_launches": flash,
        "equal_to_greedy": div is None, "divergences": diverged,
    }
    print(f"[spec] {tag}: {rounds} verify rounds, mean committed per round "
          f"{mean_committed:.2f}, {numbers['spec_tokens_per_s']:.1f} tokens/s "
          f"against greedy {numbers['greedy_tokens_per_s']:.1f} tokens/s "
          f"(x{numbers['spec_tokens_per_s'] / numbers['greedy_tokens_per_s']:.2f}); "
          f"tokens equal greedy: {div is None}; quant_matvec launches {b5} "
          f"(expected {per_round} x {rounds} rounds: 7 projections x "
          f"{cfg.llm.num_layers} layers, each at 1 slot x {SPEC_DRAFT_LEN + 1} "
          f"positions = {SPEC_DRAFT_LEN + 1} rows), flash_fwd {flash} (expected "
          f"{cfg.llm.num_layers}: the prefill)")
    print(f"[spec] {tag}: first tokens: speculative {got_l[:10]}, greedy {want_l[:10]}")
    if (b5 != per_round * rounds or flash != cfg.llm.num_layers
            or tqm.fma_launches[tqm.FMA]):
        raise AssertionError("the verify rounds did not go through the kernels")
    if int(emitted.sum()) != SPEC_NEW_TOKENS and EOS_TOKEN_ID not in got_l:
        raise AssertionError("speculative decoding emitted the wrong count")
    check_near_ties("spec", diverged)
    return numbers, want_l


def run_spec(card: str, cfg, model):
    """[spec]: prompt-lookup decoding at batch 1 on the serving model's
    Phi-4-mini (32 layers, int8 projections and embedding) against greedy
    decoding of the same prompt: with the random weights, then with
    bench.py's constant weights (int8 codes 1, every float 0.01), whose
    greedy output is one token repeated, so that every draft is accepted:
    the full-acceptance ceiling. The second overwrites the model's LLM."""
    import torch

    llm = model.llm
    gen = torch.Generator(device="cuda").manual_seed(9)
    phrase = torch.randint(3, 100000, (SPEC_PHRASE,), generator=gen, device="cuda")
    ids = phrase.repeat(PROMPT_LEN // SPEC_PHRASE)[None, :]
    lens = torch.tensor([PROMPT_LEN], dtype=torch.int32, device="cuda")
    print(f"[spec] on {card}: Phi-4-mini, int8 projections and embedding, "
          f"batch 1, a prompt of {PROMPT_LEN} tokens ({PROMPT_LEN // SPEC_PHRASE} "
          f"x one {SPEC_PHRASE}-token phrase), {SPEC_NEW_TOKENS} new tokens, "
          f"drafts of {SPEC_DRAFT_LEN} from {SPEC_NGRAM}-grams")
    numbers = {"prompt_len": PROMPT_LEN, "new_tokens": SPEC_NEW_TOKENS,
               "draft_len": SPEC_DRAFT_LEN, "ngram": SPEC_NGRAM}
    numbers["random_weights"], want = spec_against_greedy(
        "random weights", cfg, llm, ids, lens)
    numbers["wrong_variant_divergence"] = wrong_acceptance_misses(
        cfg, llm, ids, lens, want)
    with torch.no_grad():
        for t in [*llm.parameters(), *llm.buffers()]:
            t.fill_(1 if t.dtype == torch.int8 else 0.01)
    numbers["constant_weights"], _ = spec_against_greedy(
        "constant weights (full acceptance)", cfg, llm, ids, lens)
    return numbers


def spec_parting_witness(cfg, model):
    """[spec]'s prompt through greedy and prompt-lookup decoding with the
    decode's matvec on each route in turn (B5's tensor-core entry, its
    CUDA-core entry, the plain version): where the two first part, and the
    chosen token's gap below greedy's top on the model's bf16 logits and on
    f32 logits of the same hidden state. A parting on every route is the
    verify forward's own rounding, not B5's. Run by hand (README); no phase
    calls it."""
    import torch

    from hsenet_torch.eval.generate import make_greedy_generate_llm_only
    from hsenet_torch.eval.speculative import make_pld_generate_llm_only
    from hsenet_torch.ops import quant_matvec as tqm

    llm = model.llm
    gen = torch.Generator(device="cuda").manual_seed(9)  # run_spec's prompt
    phrase = torch.randint(3, 100000, (SPEC_PHRASE,), generator=gen, device="cuda")
    ids = phrase.repeat(PROMPT_LEN // SPEC_PHRASE)[None, :]
    lens = torch.tensor([PROMPT_LEN], dtype=torch.int32, device="cuda")
    kw = dict(eos_token_id=EOS_TOKEN_ID, cache_dtype=torch.bfloat16,
              max_new_tokens=SPEC_NEW_TOKENS)
    sound = tqm.quant_matvec_kernel
    for route, matvec in (("tensor-core entry", tqm.quant_matvec_mma_kernel),
                          ("CUDA-core entry", tqm.quant_matvec_fma_kernel),
                          ("plain version", tqm.quant_matvec_int8_reference)):
        tqm.quant_matvec_kernel = matvec
        try:
            want = make_greedy_generate_llm_only(llm, **kw)(ids, lens)[0].tolist()
            got = make_pld_generate_llm_only(
                llm, draft_len=SPEC_DRAFT_LEN, ngram=SPEC_NGRAM, **kw)(ids, lens)
            got = got[0].tolist()
            div, f32 = greedy_divergences(cfg, llm, ids, got, want)
            _, b16 = greedy_divergences(
                cfg, llm, ids, got, want,
                head=lambda m, h: m.compute_logits(h).float())
        finally:
            tqm.quant_matvec_kernel = sound
        gaps = ("" if div is None else
                f": gap / RMS {b16[0][4]:.4f} on bf16 logits, {f32[0][4]:.4f} on f32")
        print(f"[spec-witness] {route}: first parting at token {div}{gaps}")


def run_serve_spec(card: str, cfg, model, serve_numbers, serve_tokens,
                   kv_int8_tokens):
    """[serve-spec]: the [serve] engine with speculative=True on [serve]'s
    closed-loop requests, tokens against the greedy engine's, and the same
    with the int8 KV cache on [serve-kv-int8]'s requests. Returns the
    numbers and the bf16 cache's tokens by request."""
    import numpy as np
    import torch

    from hsenet_torch.ops import flash_attention as tfa
    from hsenet_torch.ops import quant_matvec as tqm

    spec = dict(speculative=True, draft_len=SPEC_DRAFT_LEN, ngram=SPEC_NGRAM)
    warm = make_engine(model, **spec)
    for req in serving_traffic(cfg, 2, 1, seed=12):
        warm.submit(**{**req, "max_new": 4})
    warm.run_until_drained()
    del warm
    numbers, spec_tokens = {}, {}
    runs = (("bf16 cache", torch.bfloat16, serving_traffic(cfg, 20, 4, seed=11)[:12],
             serve_tokens),
            ("int8 cache", torch.int8, serving_traffic(cfg, 6, 2, seed=14)[:4],
             kv_int8_tokens))
    for label, cache_dtype, requests, want in runs:
        eng = make_engine(model, cache_dtype=cache_dtype, **spec)
        if eng.capacity != SERVE_CAPACITY:  # 2 x (7 + 1) = the chunk of 16
            raise AssertionError(f"speculative cache rows of {eng.capacity} slots")
        torch.cuda.synchronize()
        reset_counts()  # the speculative engine, counted
        t0 = time.perf_counter()
        for req in requests:
            eng.submit(**req)
        results = eng.run_until_drained()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        got = spec_tokens[label] = [results[u] for u in sorted(results)]
        n_tokens = sum(map(len, got))
        want_b1 = {"d64": 2 * cfg.vision.num_layers * eng.encode_misses,
                   "d128": cfg.llm.num_layers * len(requests)}
        got_b1 = {"d64": tfa.fwd_launches[(64, False)],
                  "d128": tfa.fwd_launches[(128, False)]}
        fwd_route(f"serve-spec {label}", tfa.launches, tfa.f32_launches)
        if len(got) != len(requests) or got_b1 != want_b1:
            raise AssertionError(f"serve-spec {label}: {len(got)} requests "
                                 f"finished, flash launches {got_b1}, not {want_b1}")
        if tqm.launches["quant_matvec"] or tqm.fma_launches[tqm.FMA]:
            raise AssertionError("a verify round of 8 slots took the matvec kernel")
        diverged = []
        for r, (g_toks, w_toks) in enumerate(zip(got, want)):
            div = first_divergence(g_toks, w_toks)
            if div is None:
                continue
            req = requests[r]
            probe_eng = make_engine(model, num_slots=1, prompt_cap=640,
                                    volume_cache_size=0, kv_prefix_cache_size=0,
                                    cache_dtype=cache_dtype)
            logits = admission_logits(probe_eng, {
                **req, "prompt_ids": np.concatenate(
                    [req["prompt_ids"], np.asarray(w_toks[:div])])})
            diverged.append((r, div, *next_token_margin(
                logits[0], g_toks[div] if div < len(g_toks) else None)))
            del probe_eng
        stats = eng.latency_stats()
        numbers[label] = {
            "requests": len(requests), "tokens": n_tokens, "wall_s": wall,
            "tokens_per_s": n_tokens / wall, "mean_accepted": eng.mean_accepted,
            "verify_rounds": eng.verify_rounds_used, "latency": stats,
            "equal_requests": len(requests) - len(diverged),
            "divergences": diverged, "flash_fwd_launches": got_b1,
            "prefix_misses": eng.prefix_misses, "prefix_hits": eng.prefix_hits,
        }
        base = serve_numbers["closed_loop"] if label == "bf16 cache" else None
        beside = "" if base is None else (
            f" ([serve]: {base['tokens_per_s']:.1f} tokens/s, TTFT p50/p99 "
            f"{base['latency']['ttft_p50_s']:.3f}/{base['latency']['ttft_p99_s']:.3f}"
            f" s, TPOT p50/p99 {base['latency']['tpot_p50_s'] * 1e3:.1f}/"
            f"{base['latency']['tpot_p99_s'] * 1e3:.1f} ms)")
        print(f"[serve-spec] on {card}, {label}, {len(requests)} requests closed "
              f"loop, {SERVE_SLOTS} slots, chunks of {SERVE_CHUNK} verify rounds: "
              f"{n_tokens} tokens in {wall:.2f} s = {n_tokens / wall:.1f} tokens/s, "
              f"mean_accepted {eng.mean_accepted:.2f} over "
              f"{eng.verify_rounds_used} slot-rounds, TTFT p50/p99 "
              f"{stats['ttft_p50_s']:.3f}/{stats['ttft_p99_s']:.3f} s, TPOT "
              f"p50/p99 {stats['tpot_p50_s'] * 1e3:.1f}/"
              f"{stats['tpot_p99_s'] * 1e3:.1f} ms{beside}; requests equal to the "
              f"greedy engine's: {len(requests) - len(diverged)} of "
              f"{len(requests)}; flash_fwd {got_b1}")
        check_near_ties("serve-spec", diverged)
    return numbers, spec_tokens["bf16 cache"]


def write_eval_data(root, cfg):
    """[cli-evaluate]'s manifests under `root`: EVAL_REPORTS as the
    validation split of a caption manifest (one volume each) and EVAL_VQA
    as a location-VQA manifest over the first two volumes. Returns the
    manifests' paths by task."""
    import os

    import numpy as np

    rng = np.random.default_rng(21)
    for i in range(len(EVAL_REPORTS)):
        np.save(os.path.join(root, f"vol{i}.npy"),
                rng.random((1, *cfg.vision.image_size), dtype=np.float32))
        np.save(os.path.join(root, f"feat{i}.npy"), rng.standard_normal(
            (cfg.vision.num_slices, cfg.vision.slice_feature_dim)).astype(np.float32))
    entries = {
        "mrg": [{"image": f"vol{i}.npy", "biomedclip_features": f"feat{i}.npy",
                 "text": text} for i, text in enumerate(EVAL_REPORTS)],
        "vqa": [{"image": f"vol{v}.npy", "biomedclip_features": f"feat{v}.npy",
                 "abnormality": abnormality, "anatomy": anatomy}
                for v, abnormality, anatomy in EVAL_VQA],
    }
    paths = {}
    for task, data in entries.items():
        paths[task] = os.path.join(root, f"{task}.json")
        with open(paths[task], "w") as f:
            json.dump({"validation": data}, f)
    return paths


class recording_generate:
    """Within the block, every batch the evaluation harnesses generate for
    is recorded with its output ids: `calls` holds (batch, ids) pairs."""

    def __enter__(self):
        from hsenet_torch.eval import mrg, vqa

        self.modules, self.inner, self.calls = (mrg, vqa), mrg.generate_batch, []

        def spy(generate_fn, batch, device):
            out = self.inner(generate_fn, batch, device)
            self.calls.append((batch, out))
            return out

        for m in self.modules:
            m.generate_batch = spy
        return self.calls

    def __exit__(self, *exc):
        for m in self.modules:
            m.generate_batch = self.inner


def evaluate_route(tag, argv, model):
    """One `hsenet_torch.cli.evaluate.main(argv, model=model)` run on the
    card, launches counted: its metrics (which its JSON print must equal),
    the recorded batches and ids, the wall time, the B1 launches at the
    tower (d 64) and LLM (d 128) widths and by shape."""
    import contextlib
    import io

    import torch

    from hsenet_torch.cli.evaluate import main as evaluate_main
    from hsenet_torch.ops import flash_attention as tfa

    reset_counts()
    out = io.StringIO()
    with recording_generate() as calls, contextlib.redirect_stdout(out):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        metrics = evaluate_main(argv, model=model)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    if json.loads(out.getvalue()) != json.loads(json.dumps(metrics, default=str)):
        raise AssertionError(f"cli-evaluate {tag}: the JSON print is not the result")
    fwd_route(f"cli-evaluate {tag}", tfa.launches, tfa.f32_launches)
    tower = tfa.fwd_launches.get((64, False), 0)
    llm = tfa.fwd_launches.get((128, False), 0)
    shapes = {key: n for key, n in tfa.shape_launches.items()}
    n = metrics["num_samples"]
    print(f"[cli-evaluate] {tag}: hsenet_torch.cli.evaluate {' '.join(argv)}: "
          f"{n} samples in {wall:.2f} s ({60 * n / wall:.1f} reports/min); B1 "
          f"launches: towers (d 64) {tower}, LLM prefill (d 128) {llm}; "
          f"by shape {dict(sorted((str(k[1:]), v) for k, v in shapes.items()))}")
    if not tower or not llm:
        raise AssertionError(f"cli-evaluate {tag}: B1 did not run at the tower "
                             "and prefill widths")
    return {"metrics": metrics, "calls": calls, "wall_s": wall,
            "tower_launches": tower, "llm_launches": llm, "shapes": shapes}


def eval_divergences(model, got_calls, want_calls):
    """Where a route's ids first leave the greedy route's, row by row:
    (row, position, top-2 margin, chosen token's gap, its share of the RMS)
    on f32 logits of the prefill of the prompt, image and the greedy tokens
    before that position."""
    import torch

    from hsenet_torch.models.mllm import splice_image_embeds
    from hsenet_torch.models.phi3 import KVCache

    out, row = [], 0
    for (batch, got), (_, want) in zip(got_calls, want_calls):
        for r in range(len(got)):
            g, w = got[r].tolist(), want[r].tolist()
            div = first_divergence(g, w)
            if div is not None:
                n = int(batch["attention_mask"][r].sum())
                ids = torch.tensor([list(batch["input_ids"][r, :n]) + w[:div]],
                                   device="cuda")
                vol = torch.as_tensor(batch["image"][r:r + 1], device="cuda")
                sl = torch.as_tensor(batch["image_2d"][r:r + 1], device="cuda")
                with torch.inference_mode():
                    embeds = splice_image_embeds(model.llm.embed_tokens(ids),
                                                 model.encode_images(vol, sl))
                    cache = KVCache.create(model.config.llm, 1, ids.shape[1],
                                           device="cuda")
                    hidden, _ = model.llm.decoder(
                        embeds, cache=cache,
                        kv_lens=torch.tensor([ids.shape[1]], device="cuda"))
                    logits = f32_head_logits(model.llm, hidden[0, -1])
                out.append((row, div, *next_token_margin(logits, g[div])))
            row += 1
    return out


def run_cli_evaluate(card: str):
    """[cli-evaluate]: `hsenet_torch.cli.evaluate` at `VLMConfig()` in bf16
    (LoRA r16 on Phi-4-mini, as `build_vlm_config` makes it; random
    weights from seed 0, built once and passed to every run through
    `model=`) on a manifest the script writes: MRG at batch 2 through
    greedy generation, the serving engine and prompt-lookup decoding
    (with a CSV each), then VQA through the engine with a volume cache of
    2. Every route's ids must equal the greedy route's or part only at a
    near-tie; the CSV's running means must equal the returned means; B1
    must run at the tower and prefill widths in every run. Returns the
    model, the numbers and the launches by shape over the runs."""
    import argparse
    import csv
    import os
    import shutil
    import tempfile

    import torch

    from hsenet_torch.cli.common import build_vlm_config, random_model
    from hsenet_torch.cli.evaluate import main as evaluate_main
    from hsenet_torch.eval.mrg import CSV_FIELDS
    from hsenet_torch.models.mllm import HSENetVLM

    cfg = build_vlm_config(argparse.Namespace(synthetic=False))
    t0 = time.perf_counter()
    model = random_model(HSENetVLM, cfg, dtype=torch.bfloat16, device="cuda",
                         seed=0)
    torch.cuda.synchronize()
    print(f"[cli-evaluate] build_vlm_config's VLM (LoRA r{cfg.llm.lora.rank}) in "
          f"bf16, random weights (seed 0), built once in "
          f"{time.perf_counter() - t0:.1f} s")
    root = tempfile.mkdtemp(prefix="hsenet_eval_")
    try:
        paths = write_eval_data(root, cfg)
        mrg = ["--task", "mrg", "--manifest", paths["mrg"], "--data-root", root,
               "--batch-size", str(EVAL_BATCH), "--max-new-tokens", str(EVAL_MAX_NEW)]
        runs = {}
        for name, flags in (("greedy", []), ("engine", ["--engine"]),
                            ("spec-decode", ["--spec-decode"])):
            csv_path = os.path.join(root, f"{name}.csv")
            runs[name] = evaluate_route(f"mrg {name}", mrg + ["--csv", csv_path, *flags],
                                        model)
            with open(csv_path, newline="") as f:
                rows = list(csv.DictReader(f))
            means = runs[name]["metrics"]
            last = {k: rows[-1][f"mean_{k}"] for k in CSV_FIELDS[4:]}
            want = {k: f"{means[k]:.6f}" for k in CSV_FIELDS[4:]}
            print(f"[cli-evaluate] mrg {name}: {len(rows)} CSV rows; running means "
                  f"in the last row equal the returned means: {last == want}")
            if len(rows) != len(EVAL_REPORTS) or last != want:
                raise AssertionError(f"cli-evaluate mrg {name}: the CSV's running "
                                     "means are not the returned means")
        vqa = ["--task", "vqa", "--manifest", paths["vqa"], "--data-root", root,
               "--batch-size", str(EVAL_BATCH), "--engine", "--engine-vol-cache", "2"]
        runs["vqa-engine"] = evaluate_route("vqa engine", vqa, model)
        volumes = len({v for v, _, _ in EVAL_VQA})
        towers = runs["vqa-engine"]["tower_launches"]
        if towers != 2 * cfg.vision.num_layers * volumes:
            raise AssertionError(f"cli-evaluate vqa: {towers} tower launches, not "
                                 f"one encode per volume ({volumes})")

        greedy = runs["greedy"]["calls"]
        for name in ("engine", "spec-decode"):
            diverged = eval_divergences(model, runs[name]["calls"], greedy)
            runs[name]["divergences"] = diverged
            print(f"[cli-evaluate] mrg {name}: ids equal the greedy route's in "
                  f"{len(EVAL_REPORTS) - len(diverged)} of {len(EVAL_REPORTS)} rows")
            check_near_ties(f"cli-evaluate {name}", diverged)

        # where the greedy route's device time goes, on one batch of
        # EVAL_BATCH reports and EVAL_PROFILE_NEW new tokens (the profiler's
        # own processing grows with the events: the whole route's ~400k took
        # it minutes): the unprofiled median wall of that run, then one
        # profiled run
        short = mrg + ["--max-samples", str(EVAL_BATCH),
                       "--max-new-tokens", str(EVAL_PROFILE_NEW)]
        wall = median_wall_ms(lambda: evaluate_route("mrg greedy, one batch",
                                                     short, model), runs=3)
        profile = profile_phase(
            f"cli-evaluate mrg greedy, one batch of {EVAL_BATCH}, "
            f"{EVAL_PROFILE_NEW} new tokens",
            lambda: evaluate_route("mrg greedy, one batch (profiled)", short,
                                   model), wall)
    finally:
        shutil.rmtree(root, ignore_errors=True)

    shapes = {}
    for run in runs.values():
        for key, n in run["shapes"].items():
            shapes[key] = shapes.get(key, 0) + n
    first = greedy[0][0]["attention_mask"].sum(-1).tolist()
    numbers = {name: {"metrics": {k: v for k, v in r["metrics"].items()
                                  if k not in ("classification_report", "per_anatomy")},
                      "wall_s": r["wall_s"],
                      "reports_per_min": 60 * r["metrics"]["num_samples"] / r["wall_s"],
                      "tower_launches": r["tower_launches"],
                      "llm_launches": r["llm_launches"],
                      "divergences": r.get("divergences", [])}
               for name, r in runs.items()}
    numbers["profile_greedy"] = profile
    numbers["prompt_lens"] = [int(n) for n in first]
    print(f"[cli-evaluate] on {card}: "
          + "; ".join(f"{name} {r['wall_s']:.2f} s, {r['reports_per_min']:.1f} "
                      "reports/min" for name, r in numbers.items()
                      if isinstance(r, dict) and "wall_s" in r))
    return model, numbers, shapes


def check_eval_kernels(path_shapes, prompt_lens):
    """[kernel-eval]: flash_fwd_wgmma at every bf16 shape [cli-evaluate]
    launched (key (kind, batch, heads, sq, skv, head_dim)) through
    `b1_case`: against its plain version, beside the same attention
    without the last valid 64-key tile (must miss the limit), and timed
    beside the bound, the plain version and one SDPA call: towers
    non-causal over all their tokens, LLM prefills causal at the first MRG
    batch's valid lengths. Returns the results by name and the launch key
    -> name."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(13)
    results, index = {}, {}
    for key in sorted(path_shapes):
        _, b, h, sq, skv, d = key
        tower = d == 64
        name = index[key] = f"eval_{'tower' if tower else 'llm'}_{b}x{h}x{sq}x{skv}"
        kv_lens = (skv,) * b if tower else tuple(prompt_lens[:b]) + (
            prompt_lens[0],) * max(0, b - len(prompt_lens))
        results[name] = b1_case("kernel-eval", name, b, h, sq, skv, d, kv_lens,
                                not tower, gen)
        print(f"[kernel-eval] flash_fwd {name}: {path_shapes[key]} launches in "
              "[cli-evaluate]")
    return results, index


def run_ckpt(card: str, model):
    """[ckpt]: `save_vlm_deltas` of [cli-evaluate]'s full-width LoRA model
    (its LoRA, packer and token-table leaves moved first, as a finetune
    moves them) and `load_vlm_deltas` into a freshly drawn model of the same
    seed: its greedy tokens must differ before and equal the original's
    after. Then `convert_checkpoint --kind phi3 --quant-int8` of an HF Phi-3
    state at the serving CLI's --synthetic widths, served by `serve
    --quant-int8 --llm-only --synthetic --checkpoint`: every request must
    finish, the tokens must differ from the random weights', and B5 must
    run (its CUDA-core entry: the model computes in f32). Returns the
    numbers, B5's f32 timings at that model's shapes and its launches
    there."""
    import contextlib
    import io
    import os
    import shutil
    import tempfile

    import torch

    from hsenet_torch.cli.common import random_model
    from hsenet_torch.cli.convert_checkpoint import main as convert_main
    from hsenet_torch.cli.serve import main as serve_main
    from hsenet_torch.configs import Phi3Config
    from hsenet_torch.eval.generate import make_greedy_generate
    from hsenet_torch.models.mllm import HSENetVLM
    from hsenet_torch.ops import quant_matvec as tqm
    from hsenet_torch.utils.checkpoint import (
        _VLM_DELTA_RX,
        filter_tree,
        load_vlm_deltas,
        save_vlm_deltas,
    )

    dev = "cuda"
    cfg = model.config
    gen = torch.Generator(device=dev).manual_seed(7)
    with torch.no_grad():  # a finetune's deltas
        deltas = filter_tree(dict(model.named_parameters()), _VLM_DELTA_RX)
        for p in deltas.values():
            p.add_(torch.randn(p.shape, generator=gen, device=dev, dtype=p.dtype),
                   alpha=0.01)
    b = len(KV_LENS)
    ids = torch.randint(3, 100000, (b, PROMPT_LEN), generator=gen, device=dev)
    ids[:, 0] = 1
    ids[:, 1:1 + cfg.num_image_tokens] = IM_PATCH_TOKEN_ID
    kv_lens = torch.tensor(KV_LENS, dtype=torch.int32, device=dev)
    volume = torch.rand((b, 1, *cfg.vision.image_size), generator=gen, device=dev)
    slices = torch.randn((b, cfg.vision.num_slices, cfg.vision.slice_feature_dim),
                         generator=gen, device=dev)

    def tokens(m):
        return make_greedy_generate(m, max_new_tokens=CKPT_NEW_TOKENS,
                                    eos_token_id=EOS_TOKEN_ID)(ids, kv_lens, volume,
                                                               slices)

    root = tempfile.mkdtemp(prefix="hsenet_ckpt_")
    try:
        want = tokens(model)
        path = os.path.join(root, "deltas.pt")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        save_vlm_deltas(path, model.state_dict())
        save_s = time.perf_counter() - t0
        nbytes = os.path.getsize(path)
        fresh = random_model(HSENetVLM, cfg, dtype=torch.bfloat16, device=dev, seed=0)
        before = tokens(fresh)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fresh.load_state_dict(load_vlm_deltas(path, fresh.state_dict()), strict=True)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        after = tokens(fresh)
        del fresh
        gc.collect()
        torch.cuda.empty_cache()
        print(f"[ckpt] save_vlm_deltas: {len(deltas)} leaves, {nbytes / 1e6:.1f} MB "
              f"in {save_s:.2f} s; load_vlm_deltas into a fresh model of the "
              f"same seed {load_s:.2f} s; greedy tokens ({CKPT_NEW_TOKENS} new, "
              f"batch {b}) equal the original's: before the load "
              f"{torch.equal(before, want)}, after {torch.equal(after, want)}")
        if not torch.equal(after, want) or torch.equal(before, want):
            raise AssertionError("load_vlm_deltas did not restore the deltas")

        # HF Phi-3 tensors at the --synthetic widths -> int8 params -> serve
        pc = Phi3Config(**CKPT_PHI3)
        g = torch.Generator().manual_seed(8)
        h = pc.hidden_size

        def rnd(*shape, std):
            return torch.randn(shape, generator=g) * std

        hf = {"model.embed_tokens.weight": rnd(pc.vocab_size, h, std=0.02),
              "model.norm.weight": 1 + rnd(h, std=0.1)}
        for i in range(pc.num_layers):
            hp = f"model.layers.{i}"
            hf.update({
                f"{hp}.self_attn.qkv_proj.weight": rnd(pc.q_dim + 2 * pc.kv_dim, h,
                                                       std=h ** -0.5),
                f"{hp}.self_attn.o_proj.weight": rnd(h, pc.q_dim, std=pc.q_dim ** -0.5),
                f"{hp}.mlp.gate_up_proj.weight": rnd(2 * pc.intermediate_size, h,
                                                     std=h ** -0.5),
                f"{hp}.mlp.down_proj.weight": rnd(h, pc.intermediate_size,
                                                  std=pc.intermediate_size ** -0.5),
                f"{hp}.input_layernorm.weight": 1 + rnd(h, std=0.1),
                f"{hp}.post_attention_layernorm.weight": 1 + rnd(h, std=0.1),
            })
        src, out = os.path.join(root, "phi3_hf.bin"), os.path.join(root, "phi3_int8.pt")
        torch.save(hf, src)
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):
            state = convert_main(["--kind", "phi3", "--input", src, "--output", out,
                                  "--config-json", json.dumps(CKPT_PHI3),
                                  "--quant-int8"])
        convert_s = time.perf_counter() - t0
        int8 = sum(t.dtype == torch.int8 for t in state.values())
        served = {}
        for ckpt in (["--checkpoint", out], []):
            reset_counts()
            resp = os.path.join(root, f"resp{len(ckpt)}.jsonl")
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(io.StringIO()):
                summary = serve_main([*CKPT_SERVE, "--output", resp, *ckpt])
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            with open(resp) as f:
                toks = {r["id"]: r["tokens"] for r in map(json.loads, f)}
            served[bool(ckpt)] = (summary, toks, wall, tqm.fma_launches[tqm.FMA],
                                  tqm.launches[tqm.KERNEL])
        summary, toks, wall, fma, tensor_core = served[True]
        n_req = int(CKPT_SERVE[CKPT_SERVE.index("--num-requests") + 1])
        per_step = sum(n for _, n in CKPT_MATVEC.values())
        print(f"[ckpt] convert_checkpoint --kind phi3 --quant-int8 at the "
              f"--synthetic widths: {len(hf)} HF tensors -> {len(state)} leaves "
              f"({int8} int8) in {convert_s:.2f} s; serve {' '.join(CKPT_SERVE)} "
              f"--checkpoint on {card}: {summary['requests']} of {n_req} requests, "
              f"{summary['tokens']} tokens in {wall:.2f} s; tokens differ from the "
              f"random weights': {toks != served[False][1]}; B5 launches: CUDA-core "
              f"entry {fma} (f32; {per_step} a decode step), tensor-core entry "
              f"{tensor_core}")
        if summary["requests"] != n_req or toks == served[False][1]:
            raise AssertionError("serve --checkpoint did not serve the converted model")
        if not fma or tensor_core or fma % per_step:
            raise AssertionError("serve --checkpoint: B5 did not run its f32 entry "
                                 "on the decode steps")
    finally:
        shutil.rmtree(root, ignore_errors=True)

    # B5's CUDA-core entry at that model's shapes, 8 rows (the engine's
    # slots), f32: checked against the plain version and timed
    mg = torch.Generator(device=dev).manual_seed(9)
    results, counts = {}, {}
    for name, ((k, n), per_layer_step) in CKPT_MATVEC.items():
        w = torch.randint(-127, 128, (n, k), generator=mg, device=dev, dtype=torch.int8)
        scale = (0.5 + torch.rand(n, generator=mg, device=dev)) / (127 * k ** 0.5)
        x = torch.randn(8, k, generator=mg, device=dev)
        ref = tqm.quant_matvec_int8_reference(x, w, scale)
        err = (tqm.quant_matvec_fma_kernel(x, w, scale) - ref).abs()
        share = (err / ref.abs().amax(dim=-1, keepdim=True)).max().item()
        if not share <= MATVEC_ROW_TOL:
            raise AssertionError(f"quant_matvec_fma disagrees at {name}")
        wf = w.float()
        nb = k * n + 4 * 8 * k + 4 * 8 * n + 4 * n
        t_bytes, t_ops = nb / PEAK_BYTES_PER_S * 1e3, 2 * 8 * k * n / PEAK_F32_FLOPS * 1e3
        r = results[name] = {
            "max_abs_err": err.max().item(),
            "ms": time_ms(lambda: tqm.quant_matvec_fma_kernel(x, w, scale)),
            "plain_ms": time_ms(lambda: tqm.quant_matvec_int8_reference(x, w, scale)),
            "library_ms": time_ms(lambda: torch.matmul(x, wf.t()) * scale),
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "mbytes": nb / 1e6, "gflop": 2 * 8 * k * n / 1e9, "rows": 8,
        }
        counts[name] = fma // per_step * per_layer_step
        print(f"[ckpt] quant_matvec_fma {name} M=8 f32: max err / row's max |ref| "
              f"{share:.3e} (tol {MATVEC_ROW_TOL}); kernel {r['ms']:.4f} ms, plain "
              f"{r['plain_ms']:.4f} ms, f32 matmul on a converted copy "
              f"{r['library_ms']:.4f} ms, bound {r['bound_ms']:.2e} ms "
              f"({r['bound_by']}); {counts[name]} launches in the served run")
    numbers = {"deltas": {"leaves": len(deltas), "mbytes": nbytes / 1e6,
                          "save_s": save_s, "load_s": load_s,
                          "tokens_equal_after_load": True},
               "phi3_int8": {"convert_s": convert_s, "leaves": len(state),
                             "int8_leaves": int8, "serve": summary,
                             "serve_wall_s": wall, "matvec_fma_launches": fma}}
    return numbers, results, counts


def ct_phantom(shape, seed: int):
    """Stored int16 values (HU + 1024) of a smooth chest phantom of `shape`
    (z, y, x): an elliptic body of soft tissue in air, two lungs, a spine,
    slow variations along z and seeded nodules. Smooth, so that gzip at
    level 1 writes it in seconds."""
    import numpy as np

    rng = np.random.default_rng(seed)
    d, h, w = shape
    y = np.linspace(-1, 1, h, dtype=np.float32)[:, None]
    x = np.linspace(-1, 1, w, dtype=np.float32)[None, :]
    body = (x / 0.8) ** 2 + (y / 0.55) ** 2 < 1.0
    lungs = body & (((np.abs(x) - 0.38) / 0.28) ** 2 + ((y + 0.05) / 0.38) ** 2 < 1.0)
    spine = (x / 0.08) ** 2 + ((y - 0.42) / 0.08) ** 2 < 1.0
    base = np.where(body, 40.0 + 30.0 * np.sin(3 * x) * np.cos(2 * y), -1024.0)
    base = np.where(lungs, -850.0 + 40.0 * np.cos(5 * x) * np.sin(4 * y), base)
    base = np.where(spine, 700.0, base).astype(np.float32)
    z = np.cos(np.linspace(0, 3 * np.pi, d, dtype=np.float32))[:, None, None]
    vol = base[None] + np.where(body & ~spine, 15.0, 0.0).astype(np.float32)[None] * z
    for _ in range(6):  # nodules inside the lungs
        cz, cy, cx = rng.uniform(0.2, 0.8) * d, rng.uniform(0.35, 0.55) * h, \
            rng.choice([0.25, 0.75]) * w
        r = rng.uniform(0.02, 0.05) * w
        zs, ys, xs = (slice(max(0, int(c - r)), min(n, int(c + r) + 1))
                      for c, n in zip((cz, cy, cx), shape))
        gz, gy, gx = np.ogrid[zs, ys, xs]
        ball = (gz - cz) ** 2 + (gy - cy) ** 2 + (gx - cx) ** 2 < r * r
        vol[zs, ys, xs] = np.where(ball, 60.0, vol[zs, ys, xs])
    return np.round(vol + 1024.0).astype(np.int16)


def write_ct_data(root):
    """CT_VOLUMES as NIfTI files under `root`/nii (the .gz at gzip level 1)
    and a CT-RATE metadata CSV. Returns (nii dir, csv path, {name: stored
    (z, y, x) int16 array})."""
    import csv
    import os

    from hsenet_torch.data.nifti import write_nifti

    nii = os.path.join(root, "nii")
    os.makedirs(nii)
    stored = {}
    for i, (name, (shape, spacing, header_inter, _)) in enumerate(CT_VOLUMES.items()):
        stored[name] = ct_phantom(shape, seed=40 + i)
        write_nifti(os.path.join(nii, name), stored[name].transpose(2, 1, 0),
                    spacing=spacing, scl_inter=header_inter, compresslevel=1)
    meta = os.path.join(root, "metadata.csv")
    with open(meta, "w", newline="") as f:
        rows = csv.writer(f)
        rows.writerow(["VolumeName", "RescaleSlope", "RescaleIntercept"])
        for name, (*_, csv_inter) in CT_VOLUMES.items():
            rows.writerow([name, "1.0", str(csv_inter)])
    return nii, meta, stored


def _max_err(got, want):
    import torch

    return (torch.as_tensor(got).float() - torch.as_tensor(want).float()).abs().max().item()


def slice_codes(slices):
    """The uint8 codes behind CLIP-normalised faithful slices (n, S, S, 3):
    round((x * std + mean) * 255) of the first channel."""
    import numpy as np

    from hsenet_torch.data.preprocess import _CLIP_MEAN, _CLIP_STD

    gray = slices[..., 0] * np.float32(_CLIP_STD[0]) + np.float32(_CLIP_MEAN[0])
    return np.round(gray * 255).astype(np.int16)


def _held(tag, err, tol):
    print(f"[ct-data] {tag}: max abs err {err:.3e} (tol {tol})")
    if not err <= tol:
        raise AssertionError(f"[ct-data] {tag} disagrees: {err} > {tol}")
    return err


def run_ct_data(card: str, root):
    """[ct-data]: NIfTI volumes at chest-CT size (`write_ct_data`) through
    `preprocess_ct.main` on the card, by default with --slices and then
    --faithful --slices, decoding with the native reader where it builds.
    Every output is held against the same functions on the CPU, the
    faithful volumes against the numpy `reference_preprocess`; then the
    decode's MB/s and, per function at (300, 512, 512), vol/s, device busy
    time and idle share. Returns (numbers, nii dir, metadata path, stored
    arrays)."""
    import functools
    import os

    import numpy as np
    import torch

    from hsenet_torch import native
    from hsenet_torch.cli import preprocess_ct
    from hsenet_torch.data import nifti
    from hsenet_torch.data import preprocess as tpre

    numbers = {"card": card}
    t0 = time.perf_counter()
    nii, meta, stored = write_ct_data(root)
    sizes = {name: os.path.getsize(os.path.join(nii, name)) for name in stored}
    numbers["write_s"] = time.perf_counter() - t0
    print(f"[ct-data] wrote {', '.join(f'{n} {a.shape} int16 ({sizes[n] / 1e6:.1f} MB on disk)' for n, a in stored.items())} "
          f"in {numbers['write_s']:.1f} s")
    if native.available():
        reader, route = functools.partial(nifti.read_nifti, native="require"), "native"
    else:
        reader, route = functools.partial(nifti.read_nifti, native="never"), "python"
        print(f"[ct-data] the native decoder did not build on this machine "
              f"({(native.load_error or '').strip().splitlines()[0]}); decoding with "
              "the Python reader")
    numbers["decoder"] = route
    numbers["decode_mb_per_s"] = {}
    for name, want in stored.items():
        t = time.perf_counter()
        vol = reader(os.path.join(nii, name))
        dt = time.perf_counter() - t
        if not np.array_equal(vol.zyx_data, want.astype(vol.zyx_data.dtype)):
            raise AssertionError(f"[ct-data] the {route} reader misread {name}")
        mb = want.size * 4 / 1e6  # the decoded f32 volume
        numbers["decode_mb_per_s"][name] = mb / dt
        print(f"[ct-data] {route} decode of {name}: {dt * 1e3:.1f} ms, "
              f"{mb / dt:.1f} MB/s of f32 out ({sizes[name] / 1e6 / dt:.1f} MB/s of file)")

    runs = {}
    saved = preprocess_ct.read_nifti
    preprocess_ct.read_nifti = reader
    try:
        for tag, flags in (("default", ["--slices"]), ("faithful", ["--faithful", "--slices"])):
            out = os.path.join(root, tag)
            torch.cuda.synchronize()
            t = time.perf_counter()
            manifest = preprocess_ct.main(["--input-dir", nii, "--output-dir", out,
                                           "--metadata", meta, *flags])
            torch.cuda.synchronize()
            wall = time.perf_counter() - t
            n = len(manifest["train"])
            runs[tag] = (out, manifest)
            numbers[f"cli_{tag}"] = {"wall_s": wall, "vol_per_s": n / wall}
            print(f"[ct-data] preprocess_ct {' '.join(flags)} on {card}: {n} volumes in "
                  f"{wall:.2f} s ({n / wall:.2f} vol/s, decode and writes included)")
            if n != len(stored):
                raise AssertionError(f"[ct-data] the manifest has {n} volumes")
    finally:
        preprocess_ct.read_nifti = saved

    # every output against the same functions on the CPU
    cfg = preprocess_ct.PreprocessConfig()
    errs = {}
    for name, st in stored.items():
        stem = name.replace(".nii.gz", "").replace(".nii", "")
        _, (sx, sy, sz), header_inter, csv_inter = CT_VOLUMES[name]
        inter = header_inter + csv_inter
        spacing_zyx = (sz, sy, sx)
        raw = torch.as_tensor(st.astype(np.float32))
        grid = tpre.spacing_resample_shape(raw.shape, spacing_zyx, cfg)
        out_d, out_f = runs["default"][0], runs["faithful"][0]

        def npy(out, suffix):
            return np.load(os.path.join(out, f"{stem}_{suffix}.npy"))

        e = errs[name] = {}
        e["volume"] = _held(f"{name} volume, card against CPU", _max_err(
            npy(out_d, "3D_features"), tpre.preprocess_volume(raw, 1.0, inter, cfg)), CT_ATOL)
        e["slices"] = _held(f"{name} slices, card against CPU", _max_err(
            npy(out_d, "slices"), tpre.extract_slices(raw, 1.0, inter, cfg)), CT_ATOL)
        faithful = npy(out_f, "3D_features")
        e["faithful_volume"] = _held(f"{name} faithful volume, card against CPU", _max_err(
            faithful, tpre.preprocess_volume_faithful(raw, 1.0, inter, grid, cfg)), CT_ATOL)
        # the f32 chain against the float64 one: |err| <= atol + rtol |ref|,
        # the JAX package's own limit for this comparison
        ref = torch.as_tensor(tpre.reference_preprocess(st, 1.0, inter, spacing_zyx, cfg))
        err = (torch.as_tensor(faithful) - ref).abs()
        print(f"[ct-data] {name} faithful volume against numpy reference_preprocess: "
              f"max abs err {err.max().item():.3e}")
        e["faithful_reference"] = _held(
            f"{name} faithful volume against numpy reference_preprocess, beyond "
            f"{CT_REFERENCE_RTOL} of |ref|", (err - CT_REFERENCE_RTOL * ref.abs()).max().item(),
            CT_REFERENCE_ATOL)
        # faithful slices: the uint8 codes behind them (floor(x * 255) before
        # the resize, round(x * 255) after it) may land one apart on the
        # card and the CPU where a value sits on a rounding edge
        got = npy(out_f, "slices")
        want = tpre.extract_slices(raw, 1.0, inter, cfg, grid, faithful=True).numpy()
        codes, cpu_codes = slice_codes(got), slice_codes(want)
        moved = codes != cpu_codes
        floor_moved = int((tpre.extract_slices_uint8(raw.cuda(), 1.0, inter, cfg, grid).cpu()
                           != tpre.extract_slices_uint8(raw, 1.0, inter, cfg, grid)).sum())
        e["faithful_slices"] = _held(
            f"{name} faithful slices, card against CPU, where their codes are equal",
            float(np.abs(got - want)[~moved].max()), CT_CUBIC_ATOL)
        share = moved.sum() / moved.size
        print(f"[ct-data] {name} faithful slice codes one apart at a rounding edge: "
              f"{int(moved.sum())} of {moved.size} ({share:.2e}, limit {CT_EDGE_SHARE}); "
              f"floor codes before the resize one apart: {floor_moved}")
        if np.abs(codes.astype(int) - cpu_codes).max() > 1 or share > CT_EDGE_SHARE:
            raise AssertionError(f"[ct-data] {name}'s faithful slice codes disagree")
        e["faithful_codes_moved"] = int(moved.sum())
    numbers["errors"] = errs

    # the card's time per function on the chest volume
    name = next(iter(stored))
    _, (sx, sy, sz), header_inter, csv_inter = CT_VOLUMES[name]
    inter = header_inter + csv_inter
    raw = torch.as_tensor(stored[name].astype(np.float32), device="cuda")
    grid = tpre.spacing_resample_shape(raw.shape, (sz, sy, sx), cfg)
    batch = raw[None].expand(CT_BATCH, *raw.shape).contiguous()
    ones = torch.ones(CT_BATCH, device="cuda")
    single = tpre.preprocess_volume(raw, 1.0, inter, cfg)
    _held(f"preprocess_batch at batch {CT_BATCH} against preprocess_volume",
          _max_err(tpre.preprocess_batch(batch, ones, ones * inter, cfg)[0], single), CT_ATOL)
    fns = {
        "preprocess_volume": (1, lambda: tpre.preprocess_volume(raw, 1.0, inter, cfg)),
        "preprocess_volume_faithful": (1, lambda: tpre.preprocess_volume_faithful(
            raw, 1.0, inter, grid, cfg)),
        "extract_slices": (1, lambda: tpre.extract_slices(raw, 1.0, inter, cfg)),
        f"preprocess_batch_{CT_BATCH}": (CT_BATCH, lambda: tpre.preprocess_batch(
            batch, ones, ones * inter, cfg)),
    }
    numbers["functions"] = {}
    for label, (n, fn) in fns.items():
        wall = median_wall_ms(fn)
        prof = profile_phase(f"ct-data {label}", fn, wall)
        numbers["functions"][label] = {"wall_ms": wall, "vol_per_s": n / (wall / 1e3),
                                       "device_ms": prof["device_ms"],
                                       "idle_share": prof["idle_share"]}
        print(f"[ct-data] {label} on {tuple(raw.shape)} x {n} on {card}: wall "
              f"{wall:.2f} ms, {n / (wall / 1e3):.1f} vol/s")
    del raw, batch
    return numbers, nii, meta, stored


def vit2d_kernel_cases():
    """B1 at the 2D trunk's shape: 197 tokens (196 patches and CLS) over 12
    heads of 64, non-causal, no log-sum-exp; 32 slices of one volume
    ([vit2d]) and 64 of a batch of two (train_vlm
    --online-slice-features)."""
    return [(f"vit2d_{b}", (b, 12, 197, 64), (197,) * b, False, (b, 12), ("flash_fwd",))
            for b in (VIT2D_SLICES, 2 * VIT2D_SLICES)]


def vit2d_shape_index():
    return {("flash_fwd", b, h, s, s, d): ("flash_fwd", name)
            for name, (b, h, s, d), *_ in vit2d_kernel_cases()}


def check_vit2d_kernels():
    """[kernel] at the ViT2D shapes: B1 against its plain version (2e-2 of
    each row's largest value, beside 64 dropped keys that must miss), timed
    beside its bound, the plain version and one SDPA call."""
    return check_flash_cases(vit2d_kernel_cases(), seed=23)["flash_fwd"]


def biomedclip_trunk(path):
    """An open_clip-named BiomedCLIP ViT-B/16 trunk (timm's names under
    `visual.trunk.`), its weights drawn on the card from a seed (std 0.02,
    LayerNorm weights about 1), saved with torch.save at `path`."""
    import torch

    from hsenet_torch.configs import ViT2DConfig

    cfg = ViT2DConfig()
    gen = torch.Generator(device="cuda").manual_seed(12)
    h, m, p = cfg.hidden_size, cfg.mlp_dim, cfg.patch_size

    def draw(*shape, mean=0.0):
        return (mean + 0.02 * torch.randn(*shape, generator=gen, device="cuda")).cpu()

    sd = {"patch_embed.proj.weight": draw(h, cfg.in_channels, p, p),
          "patch_embed.proj.bias": draw(h), "cls_token": draw(1, 1, h),
          "pos_embed": draw(1, cfg.num_patches + 1, h),
          "norm.weight": draw(h, mean=1.0), "norm.bias": draw(h)}
    for i in range(cfg.num_layers):
        b = f"blocks.{i}"
        for ln in ("norm1", "norm2"):
            sd[f"{b}.{ln}.weight"], sd[f"{b}.{ln}.bias"] = draw(h, mean=1.0), draw(h)
        for name, (o, n) in (("attn.qkv", (3 * h, h)), ("attn.proj", (h, h)),
                             ("mlp.fc1", (m, h)), ("mlp.fc2", (h, m))):
            sd[f"{b}.{name}.weight"], sd[f"{b}.{name}.bias"] = draw(o, n), draw(o)
    torch.save({f"visual.trunk.{k}": v for k, v in sd.items()}, path)


def trunk_launches(cfg, volumes: int):
    """The B1 launches of the VLM `cfg`'s 2D slice trunk over `volumes`
    volumes: one forward per block, no log-sum-exp, at (volumes x slices,
    heads, 197, 197, 64) for ViT2DConfig()."""
    from hsenet_torch.configs import ViT2DConfig

    t = cfg.vit2d or ViT2DConfig()
    tokens = t.num_patches + 1
    return {("flash_fwd", volumes * cfg.vision.num_slices, t.num_heads, tokens, tokens,
             t.hidden_size // t.num_heads): t.num_layers}


def run_vit2d(card: str, root, nii, meta, stored):
    """[vit2d]: `convert_checkpoint --kind biomedclip` of a seeded
    open_clip trunk, then `preprocess_ct --vit2d-checkpoint` on [ct-data]'s
    volumes with every launch counted: (32, 768) features per volume, 12 B1
    launches per volume at 32 x 12 x 197 x 64, all on flash_fwd_wgmma; the
    features against a direct `ViT2D` call on the slices and against the
    plain attention path; the trunk's time per volume and a profile."""
    import os

    import numpy as np
    import torch

    from hsenet_torch.cli import convert_checkpoint, preprocess_ct
    from hsenet_torch.data import preprocess as tpre
    from hsenet_torch.ops import attention
    from hsenet_torch.ops import flash_attention as tfa

    numbers = {"card": card}
    trunk, params = os.path.join(root, "open_clip.bin"), os.path.join(root, "vit2d.pt")
    t = time.perf_counter()
    biomedclip_trunk(trunk)
    convert_checkpoint.main(["--kind", "biomedclip", "--input", trunk, "--output", params])
    numbers["convert_s"] = time.perf_counter() - t
    out = os.path.join(root, "features")
    reset_counts()
    torch.cuda.synchronize()
    t = time.perf_counter()
    manifest = preprocess_ct.main(["--input-dir", nii, "--output-dir", out,
                                   "--metadata", meta, "--vit2d-checkpoint", params])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    launches = dict(tfa.shape_launches)
    numbers["route"] = fwd_route("vit2d", tfa.launches, tfa.f32_launches)
    n = len(manifest["train"])
    tc = preprocess_ct.ViT2DConfig()
    tokens, slices = tc.num_patches + 1, preprocess_ct.PreprocessConfig().num_slices
    want = {("flash_fwd", slices, tc.num_heads, tokens, tokens, tc.hidden_size // tc.num_heads):
            tc.num_layers * n}
    print(f"[vit2d] convert_checkpoint --kind biomedclip in {numbers['convert_s']:.1f} s; "
          f"preprocess_ct --vit2d-checkpoint: {n} volumes in {wall:.2f} s on {card}; "
          f"flash launches {launches} (expected {want})")
    if launches != want:
        raise AssertionError(f"[vit2d] flash launches {launches}, not {want}")
    numbers.update(cli_wall_s=wall, launches=sum(launches.values()))

    model = preprocess_ct.load_vit2d(params, "cuda")
    cfg = preprocess_ct.PreprocessConfig()
    numbers["features"] = {}
    for entry, name in zip(manifest["train"], stored):
        _, _, header_inter, csv_inter = CT_VOLUMES[name]
        raw = torch.as_tensor(stored[name].astype(np.float32), device="cuda")
        sl = tpre.extract_slices(raw, 1.0, header_inter + csv_inter, cfg)
        got = torch.as_tensor(np.load(os.path.join(out, entry["biomedclip_features"])))
        with torch.inference_mode():
            direct = model(sl).float().cpu()
            attention.set_flash_mode("never")
            try:
                plain = model(sl).float().cpu()
            finally:
                attention.set_flash_mode("auto")
        same, rel = _max_err(got, direct), rel_l2(direct, plain)
        print(f"[vit2d] {name}: features {tuple(got.shape)} {got.dtype}, finite "
              f"{bool(got.isfinite().all())}; against a direct ViT2D call on its "
              f"slices max abs diff {same:.3e}; against the plain attention path rel "
              f"L2 {rel:.3e} (limit {VIT2D_REL_L2})")
        if got.shape != (slices, tc.hidden_size) or not got.isfinite().all() or same > 1e-6:
            raise AssertionError(f"[vit2d] the CLI's features of {name} are wrong")
        if not rel <= VIT2D_REL_L2:
            raise AssertionError(f"[vit2d] the trunk through B1 disagrees with the plain path")
        numbers["features"][name] = {"direct_max_abs_diff": same, "plain_rel_l2": rel}

    def trunk_call():
        with torch.inference_mode():
            model(sl)

    wall_ms = median_wall_ms(trunk_call)
    numbers["per_volume"] = {"wall_ms": wall_ms, "slices_per_s": slices / (wall_ms / 1e3),
                             "profile": profile_phase("vit2d per volume", trunk_call, wall_ms)}
    print(f"[vit2d] the trunk on one volume's {slices} slices on {card}: "
          f"{wall_ms:.2f} ms, {slices / (wall_ms / 1e3):.0f} slices/s")
    return numbers


def run_clip_augment(card: str, plain_step_ms: float):
    """[clip-augment]: the stage-1 `Trainer` at batch 24 with
    `augment=AugmentConfig()` (the port's prefetcher on, as by default) over
    an epoch of AUG_BATCHES batches: AUG_STEPS steps, their step ms beside
    [clip-stage1]'s unaugmented step; then the state at step AUG_RESUME_AT
    (kept in memory) resumed by a new Trainer to AUG_STEPS. The resumed
    steps must train on the unbroken run's augmented volumes bit for bit
    and log its first loss bit for bit; the loss after it within
    AUG_LATER_STEP_RTOL (dQ's reduce-adds are not bit-reproducible)."""
    import dataclasses

    import torch

    from hsenet_torch.configs import AugmentConfig, TrainConfig
    from hsenet_torch.data.augment import augment_batch
    from hsenet_torch.train.stage1 import make_stage1_train_step
    from hsenet_torch.train.train_state import TrainState, make_optimizer
    from hsenet_torch.train.trainer import Trainer, TrainerHooks

    cfg = clip_config()
    model = build_clip_model(cfg, seed=0)
    batches = [clip_batch(cfg, CLIP_BATCH, "clip", seed=31 + i) for i in range(AUG_BATCHES)]
    train_cfg = TrainConfig(learning_rate=1e-4, total_steps=CLIP_RUN_STEPS, log_every=1,
                            eval_every=0, seed=0)
    tx = make_optimizer(train_cfg)
    step_fn = make_stage1_train_step(model, tx)
    images, snap = {"whole": {}, "resumed": {}}, {}

    def recording(run):
        def step(state, batch, rng):
            if state.step >= AUG_RESUME_AT:
                images[run][state.step + 1] = batch["image"].clone()
            return step_fn(state, batch, rng)
        return step

    def on_log(step, row):
        if step == AUG_RESUME_AT:
            st = trainer.state
            snap["params"] = {k: v.detach().clone() for k, v in st.params.items()}
            snap["opt"] = dataclasses.replace(
                st.opt_state, mu=[m.clone() for m in st.opt_state.mu],
                nu=[m.clone() for m in st.opt_state.nu])

    trainer = Trainer(recording("whole"), TrainState.create(model, tx), lambda: batches,
                      train_cfg, hooks=TrainerHooks(on_log=on_log), augment=AugmentConfig())
    state = trainer.fit(AUG_STEPS)
    whole = trainer.history
    step_ms = [1e3 / r["steps_per_sec"] for r in whole[1:]]
    with torch.no_grad():
        for k, p in state.params.items():
            p.copy_(snap["params"][k])
    resumed = Trainer(recording("resumed"),
                      dataclasses.replace(state, step=AUG_RESUME_AT, opt_state=snap["opt"]),
                      lambda: batches, train_cfg, augment=AugmentConfig())
    resumed.fit(AUG_STEPS)
    later = resumed.history
    same_images = all(torch.equal(images["whole"][s], images["resumed"][s])
                      for s in range(AUG_RESUME_AT + 1, AUG_STEPS + 1))
    changed = not torch.equal(images["whole"][AUG_RESUME_AT + 1],
                              torch.as_tensor(batches[AUG_RESUME_AT % AUG_BATCHES]["image"],
                                              device="cuda"))
    want = [r["loss"] for r in whole[AUG_RESUME_AT:]]
    got = [r["loss"] for r in later]
    rel = [abs(a - b) / abs(b) for a, b in zip(got[1:], want[1:])]
    gen = torch.Generator().manual_seed(0)
    aug_ms = median_wall_ms(lambda: augment_batch(images["whole"][AUG_STEPS], gen))
    med = statistics.median(step_ms)
    print(f"[clip-augment] on {card}: step {med:.1f} ms with augmentation (median of "
          f"steps 2-{AUG_STEPS}: {[round(x, 1) for x in step_ms]}) against "
          f"{plain_step_ms:.1f} ms without ([clip-stage1]); augment_batch alone "
          f"{aug_ms:.2f} ms a batch of {CLIP_BATCH}")
    print(f"[clip-augment] losses {[round(r['loss'], 6) for r in whole]}; resumed at "
          f"step {AUG_RESUME_AT}: steps {[r['step'] for r in later]}, losses {got} "
          f"against {want}; augmented volumes bit-equal {same_images}, augmented "
          f"(differ from the batch) {changed}; later steps' relative loss difference "
          f"{rel} (limit {AUG_LATER_STEP_RTOL})")
    if [r["step"] for r in later] != list(range(AUG_RESUME_AT + 1, AUG_STEPS + 1)):
        raise AssertionError("[clip-augment] the resumed run logged other steps")
    if not (same_images and changed and got[0] == want[0]
            and all(r <= AUG_LATER_STEP_RTOL for r in rel)):
        raise AssertionError("[clip-augment] the augmented resume is not the unbroken run")
    if not all(map(math.isfinite, [r["loss"] for r in whole])):
        raise AssertionError("[clip-augment] non-finite losses")
    return {"card": card, "step_ms_median": med, "step_ms": step_ms,
            "plain_step_ms": plain_step_ms, "augment_ms": aug_ms,
            "losses": [r["loss"] for r in whole], "resumed_losses": got,
            "later_rel": rel, "batch": CLIP_BATCH}


# [sample]: the sampler on the card at the two serving vocabularies
# (Phi-4-mini's 200,064 and Llama-3's 128,256), 8 rows of seeded peaked
# logits (a normal times 4, in bf16 as the decode's logits are), warped at
# T 0.7 and top-p 0.9; SAMPLE_DRAWS draws a row over folded seeds,
# SAMPLE_CHUNK at a time. The frequency of each token whose probability
# exceeds SAMPLE_MIN_P, and the mass of the rest, must lie within
# SAMPLE_FREQ_TOL of the exact law, and no draw may leave the nucleus. One
# standard error of a frequency is at most 0.0017 at 81,920 draws, so the
# limit is 5.7 of them for the ~100 tokens above SAMPLE_MIN_P (at 20,480
# draws a token near p 0.5 read 0.0115 on the CPU's stream, 3.3 of them)
SAMPLE_VOCABS = {"phi4_mini": 200064, "llama3": 128256}
SAMPLE_ROWS = 8
SAMPLE_DRAWS = 81920
SAMPLE_CHUNK = 128
SAMPLE_T = 0.7
SAMPLE_TOP_P = 0.9
SAMPLE_FREQ_TOL = 0.01
SAMPLE_MIN_P = 1e-3
# a nucleus of one token: sampling at it must give the argmax
COLLAPSE_TOP_P = 1e-9
# [spec-law]: speculative sampling against a constant target (the port of
# the JAX package's tests/test_serving.py law test): each committed token's
# frequency within this of softmax(logits / T)
SPEC_LAW_TOL = 0.03
SPEC_LAW_ROWS = 64
SPEC_LAW_ROUNDS = 100
# [llama]: Llama-3-8B's shape at full depth with int8 projections, served
# by the engine at 8 slots over prompts of 20-200 tokens
LLAMA_EOS = 128009  # Llama-3 <|eot_id|>
LLAMA_SLOTS = 8
LLAMA_PROMPT_CAP = 256
LLAMA_MAX_NEW = 64
LLAMA_CHUNK = 16
LLAMA_REQUESTS = 8
LLAMA_CONVERT_LAYERS = 2  # convert_checkpoint --kind llama runs at this depth
# (K, N) of Llama-3-8B's int8 projections and how many of each a decode
# step of one layer launches
LLAMA_MATVEC_SHAPES = {"llama_qo_4096x4096": (4096, 4096),
                       "llama_kv_4096x1024": (4096, 1024),
                       "llama_gate_up_4096x14336": (4096, 14336),
                       "llama_down_14336x4096": (14336, 4096)}
LLAMA_MATVEC_PER_LAYER = {"llama_qo_4096x4096": 2, "llama_kv_4096x1024": 2,
                          "llama_gate_up_4096x14336": 2,
                          "llama_down_14336x4096": 1}
# [variants]: the ablation projectors and tower_mode med2e3 at full width
# (towers at full depth; the LLM cut to VARIANT_LLM_LAYERS layers), two
# volumes a run; prefill logits through the kernels against the plain sdpa
# path (relative L2, as [vit2d] holds features)
VARIANTS = ("spatial_pooling", "mlp", "qformer", "med2e3")
VARIANT_LLM_LAYERS = 4
VARIANT_NEW_TOKENS = 8
VARIANT_TEXT = (40, 60)
VARIANT_LOGITS_REL_L2 = 5e-2


def run_sample(card: str):
    """[sample]: the sampler's law on the card at each serving vocabulary
    (warp once, then SAMPLE_DRAWS Gumbel-max draws a row over folded
    seeds), the same seed twice, a one-token nucleus against the argmax,
    and the device time of the warp plus one draw with and without top-p."""
    import torch

    from hsenet_torch.eval.generate import (
        _make_next_token,
        categorical,
        fold_seed,
        seeded_generator,
        warp_logits,
    )

    numbers = {}
    for name, vocab in SAMPLE_VOCABS.items():
        gen = torch.Generator(device="cuda").manual_seed(21)
        logits = (torch.randn(SAMPLE_ROWS, vocab, generator=gen, device="cuda")
                  * 4).to(torch.bfloat16)
        wl = warp_logits(logits, SAMPLE_T, SAMPLE_TOP_P)
        law = torch.softmax(wl, dim=-1)
        counts = torch.zeros(SAMPLE_ROWS, vocab, dtype=torch.int64, device="cuda")
        ones = torch.ones(SAMPLE_ROWS, SAMPLE_CHUNK, dtype=torch.int64, device="cuda")
        t0 = time.perf_counter()
        for c in range(SAMPLE_DRAWS // SAMPLE_CHUNK):
            tok = categorical(wl.expand(SAMPLE_CHUNK, -1, -1),
                              seeded_generator(fold_seed(21, c), "cuda"))
            counts.scatter_add_(1, tok.t().long(), ones)
        torch.cuda.synchronize()
        draw_s = time.perf_counter() - t0
        freq = counts.double() / SAMPLE_DRAWS
        outside = int(counts[~wl.isfinite()].sum())
        big = law > SAMPLE_MIN_P
        tok_err = (freq - law.double()).abs()[big].max().item()
        rest_err = ((freq * ~big).sum(-1) - (law.double() * ~big).sum(-1)).abs().max().item()
        sample = _make_next_token(True, SAMPLE_T, SAMPLE_TOP_P)
        same = torch.equal(sample(logits, 5), sample(logits, 5))
        other = not torch.equal(sample(logits, 5), sample(logits, 6))
        argmax = torch.equal(_make_next_token(True, SAMPLE_T, COLLAPSE_TOP_P)(logits, 7),
                             logits.argmax(dim=-1).to(torch.int32))
        times = {label: time_ms(lambda top_p=top_p: _make_next_token(
                     True, SAMPLE_T, top_p)(logits, 8))
                 for label, top_p in (("top_p_0.9", SAMPLE_TOP_P), ("no_top_p", None))}
        nucleus = int(wl.isfinite().sum(-1).float().mean())
        numbers[name] = {
            "rows": SAMPLE_ROWS, "vocab": vocab, "draws_a_row": SAMPLE_DRAWS,
            "nucleus_tokens_mean": nucleus, "tokens_above_min_p": int(big.sum()),
            "max_token_freq_err": tok_err, "max_rest_mass_err": rest_err,
            "draws_outside_nucleus": outside, "same_seed_equal": same,
            "other_seed_differs": other, "collapse_is_argmax": argmax,
            "draw_s": draw_s, "warp_and_draw_ms": times,
        }
        print(f"[sample] on {card}: {SAMPLE_ROWS} x {vocab} seeded logits "
              f"(normal x 4, bf16), T {SAMPLE_T}, top-p {SAMPLE_TOP_P} (nucleus "
              f"{nucleus} tokens a row on average): {SAMPLE_DRAWS} draws a row "
              f"over {SAMPLE_DRAWS // SAMPLE_CHUNK} folded seeds in {draw_s:.2f} s; "
              f"max |freq - p| over the {int(big.sum())} tokens above p "
              f"{SAMPLE_MIN_P} {tok_err:.4f}, the rest's mass {rest_err:.4f} (tol "
              f"{SAMPLE_FREQ_TOL}); draws outside the nucleus {outside}; same "
              f"seed equal {same}, another seed differs {other}; top-p "
              f"{COLLAPSE_TOP_P} gives the argmax {argmax}; warp + one draw "
              + ", ".join(f"{k} {v:.4f} ms" for k, v in times.items())
              + " (device)")
        if not (tok_err <= SAMPLE_FREQ_TOL and rest_err <= SAMPLE_FREQ_TOL
                and outside == 0 and same and other and argmax):
            raise AssertionError(f"[sample] the sampler's law at {name} fails a check")
        del logits, wl, law, counts
    return numbers


def run_spec_law(card: str):
    """[spec-law]: `pld_round(sample=...)` on the card against a constant
    target over a vocabulary of 8 (the port of the JAX package's law test):
    whatever the n-gram drafter proposes, every committed token, with each
    round's correction token, is distributed as softmax(logits / T)."""
    import torch

    from hsenet_torch.configs import Phi3Config
    from hsenet_torch.eval.generate import fold_seed
    from hsenet_torch.eval.speculative import pld_round
    from hsenet_torch.models.phi3 import KVCache

    vocab, k, b, temperature = 8, 4, SPEC_LAW_ROWS, 1.3
    base = torch.linspace(0.0, 2.0, vocab, device="cuda")
    target = torch.softmax(base / temperature, dim=-1)
    cfg = Phi3Config(vocab_size=vocab, hidden_size=8, intermediate_size=8,
                     num_layers=1, num_heads=1, num_kv_heads=1, head_dim=8)
    gen = torch.Generator(device="cuda").manual_seed(23)
    counts = torch.zeros(vocab, dtype=torch.int64, device="cuda")
    t0 = time.perf_counter()
    for trial in range(SPEC_LAW_ROUNDS):
        cache = KVCache.create(cfg, b, 64, dtype=torch.float32, device="cuda")
        cache.lengths.fill_(8)
        ctx = torch.randint(0, vocab, (b, 64), generator=gen, device="cuda",
                            dtype=torch.int32)
        pending = torch.multinomial(target.expand(b, -1), 1, generator=gen)[:, 0]
        out = pld_round(
            lambda t, c: (base.expand(*t.shape, vocab), c), pending.int(), cache,
            ctx, torch.full((b,), 9, dtype=torch.int32, device="cuda"),
            torch.zeros(b, dtype=torch.bool, device="cuda"),
            torch.zeros(b, dtype=torch.int32, device="cuda"),
            torch.full((b,), 100, dtype=torch.int32, device="cuda"),
            draft_len=k, ngram=2, eos_token_id=-1, pad_token_id=0,
            sample=(fold_seed(23, trial), temperature, None))
        nxt, inputs, commit = out[0], out[6], out[7]
        keep = torch.arange(k + 1, device="cuda")[None, :] < commit[:, None]
        counts += torch.bincount(inputs[keep].long(), minlength=vocab)
        counts += torch.bincount(nxt.long(), minlength=vocab)
    torch.cuda.synchronize()
    n = int(counts.sum())
    err = (counts.double() / n - target.double()).abs().max().item()
    print(f"[spec-law] on {card}: {SPEC_LAW_ROUNDS} rounds x {b} rows, drafts "
          f"of {k}, T {temperature}: {n} tokens in {time.perf_counter() - t0:.2f} "
          f"s, max |freq - softmax(logits / T)| {err:.4f} (tol {SPEC_LAW_TOL})")
    if n < 2000 or not err <= SPEC_LAW_TOL:
        raise AssertionError("[spec-law] speculative sampling's law is off")
    return {"tokens": n, "max_freq_err": err, "rounds": SPEC_LAW_ROUNDS, "rows": b}


def run_serve_sample(card: str, cfg, model, serve_tokens, spec_tokens,
                     spec_numbers):
    """[serve-sample]: the [serve] engine with do_sample=True on [serve]'s
    12 closed-loop requests: a one-token nucleus gives the greedy engine's
    tokens request for request (and, speculative, the greedy speculative
    engine's); T 0.7 / top-p 0.9 twice with one seed gives equal tokens,
    another seed other tokens; tokens/s, TTFT and speculative sampling's
    mean_accepted beside greedy speculation's; launches counted. Returns
    the numbers, with the counted runs' decode steps and admissions."""
    import torch

    from hsenet_torch.ops import flash_attention as tfa
    from hsenet_torch.ops import quant_matvec as tqm

    requests = serving_traffic(cfg, 20, 4, seed=11)[:12]
    spec = dict(speculative=True, draft_len=SPEC_DRAFT_LEN, ngram=SPEC_NGRAM)
    hot = dict(do_sample=True, temperature=SAMPLE_T, top_p=SAMPLE_TOP_P)
    runs = {
        "collapse": (dict(do_sample=True, top_p=COLLAPSE_TOP_P, rng=31), serve_tokens),
        "spec_collapse": (dict(do_sample=True, top_p=COLLAPSE_TOP_P, rng=32, **spec),
                          spec_tokens),
        "hot": (dict(rng=33, **hot), None),
        "hot_again": (dict(rng=33, **hot), None),
        "hot_other_seed": (dict(rng=34, **hot), None),
        "spec_hot": (dict(rng=35, **hot, **spec), None),
    }
    expect = {"encode_misses": 4, "encode_hits": 0, "prefix_misses": 4,
              "prefix_hits": 8}
    numbers, tokens = {}, {}
    for name, (kw, want) in runs.items():
        eng = make_engine(model, **kw)
        torch.cuda.synchronize()
        reset_counts()  # the sampling engine, counted
        t0 = time.perf_counter()
        for req in requests:
            eng.submit(**req)
        results = eng.run_until_drained()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        got = tokens[name] = [results[u] for u in sorted(results)]
        if "speculative" in kw:
            want_b1 = {"d64": 2 * cfg.vision.num_layers * eng.encode_misses,
                       "d128": cfg.llm.num_layers * len(requests)}
            got_b1 = {"d64": tfa.fwd_launches[(64, False)],
                      "d128": tfa.fwd_launches[(128, False)]}
            fwd_route(f"serve-sample {name}", tfa.launches, tfa.f32_launches)
            if got_b1 != want_b1 or tqm.launches[tqm.KERNEL] or tqm.fma_launches[tqm.FMA]:
                raise AssertionError(f"serve-sample {name}: flash launches {got_b1}, "
                                     f"not {want_b1}, or a 64-row verify took B5")
            counts = {"tokens": sum(map(len, got)), "flash_fwd_launches": got_b1,
                      "prefix_misses": eng.prefix_misses, "prefix_hits": eng.prefix_hits}
        else:
            counts = check_serve_counts(f"serve-sample {name}", cfg, eng,
                                        len(requests), results, expect)
        budgets = [r["max_new"] for r in requests]
        if not all(len(t) <= m for t, m in zip(got, budgets)) or not all(
                0 <= t < cfg.llm.vocab_size for row in got for t in row):
            raise AssertionError(f"serve-sample {name}: a token outside the "
                                 "vocabulary or a request past its budget")
        stats = eng.latency_stats()
        numbers[name] = {**counts, "wall_s": wall,
                         "tokens_per_s": counts["tokens"] / wall,
                         "latency": stats, "mean_accepted": eng.mean_accepted,
                         "sampling": {k: v for k, v in kw.items() if k != "rng"}}
        equal = None if want is None else got == want
        numbers[name]["equal_to_greedy"] = equal
        print(f"[serve-sample] on {card}, {name} ({', '.join(f'{k}={v}' for k, v in kw.items())}): "
              f"{counts['tokens']} tokens in {wall:.2f} s = "
              f"{counts['tokens'] / wall:.1f} tokens/s, TTFT p50/p99 "
              f"{stats['ttft_p50_s']:.3f}/{stats['ttft_p99_s']:.3f} s"
              + (f", mean_accepted {eng.mean_accepted:.2f}" if "speculative" in kw else "")
              + ("" if want is None else f"; tokens equal to the greedy "
                 f"{'speculative ' if 'speculative' in kw else ''}engine's: {equal}"))
        if equal is False:
            raise AssertionError(f"serve-sample {name}: a one-token nucleus does "
                                 "not give the greedy engine's tokens")
    if tokens["hot"] != tokens["hot_again"]:
        raise AssertionError("serve-sample: one seed gave two token streams")
    if tokens["hot"] == tokens["hot_other_seed"]:
        raise AssertionError("serve-sample: two seeds gave one token stream")
    greedy_spec = spec_numbers["bf16 cache"]["mean_accepted"]
    print(f"[serve-sample] speculative sampling (T {SAMPLE_T}, top-p "
          f"{SAMPLE_TOP_P}) mean_accepted {numbers['spec_hot']['mean_accepted']:.2f} "
          f"against greedy speculation's {greedy_spec:.2f} ([serve-spec]); "
          f"sampled {numbers['hot']['tokens_per_s']:.1f} tokens/s")
    numbers["greedy_spec_mean_accepted"] = greedy_spec
    return numbers


def run_cli_sample(card: str):
    """[cli-sample]: `evaluate --task mrg --synthetic --do-sample` and
    `serve --synthetic --do-sample [--speculative]` through `main(argv,
    device="cuda")`: tiny f32 models, so every flash launch is f32 at the
    padded width 64."""
    import torch

    from hsenet_torch.cli.evaluate import main as eval_main
    from hsenet_torch.cli.serve import main as serve_main
    from hsenet_torch.ops import flash_attention as tfa

    sampling = ["--do-sample", "--temperature", "0.7", "--top-p", "0.9"]
    runs = {
        "evaluate": (eval_main, ["--task", "mrg", "--synthetic", *sampling,
                                 "--gen-seed", "1"]),
        "serve": (serve_main, ["--synthetic", "--num-requests", "6", *sampling,
                               "--gen-seed", "3"]),
        "serve_speculative": (serve_main, ["--synthetic", "--num-requests", "6",
                                           "--speculative", *sampling,
                                           "--gen-seed", "3"]),
    }
    numbers = {}
    for name, (entry, argv) in runs.items():
        reset_counts()
        t0 = time.perf_counter()
        out = entry(argv, device="cuda")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        fwd = tfa.launches["flash_fwd"]
        print(f"[cli-sample] {name}: {' '.join(argv)} on {card}: {wall:.1f} s, "
              f"flash launches {fwd} (f32 at the padded width 64: "
              f"{tfa.f32_launches[('flash_fwd', 64)]}); "
              + json.dumps({k: v for k, v in out.items() if not isinstance(v, (list, dict))}))
        if not fwd or tfa.f32_launches[("flash_fwd", 64)] != fwd:
            raise AssertionError(f"cli-sample {name}: the flash forward did not "
                                 "run in f32 at the padded width")
        if name == "evaluate" and not out["num_samples"]:
            raise AssertionError("cli-sample: evaluate scored nothing")
        if name != "evaluate" and out["requests"] != 6:
            raise AssertionError(f"cli-sample {name}: not every request finished")
        numbers[name] = {"wall_s": wall, "flash_fwd_f32_launches": fwd,
                         **{k: v for k, v in out.items() if isinstance(v, (int, float))}}
    return numbers


def llama_config(num_layers=None, quant_embed: bool = False):
    """`LlamaConfig()` (Llama-3-8B's shape) with int8 projections, at
    `num_layers` where given."""
    import dataclasses

    from hsenet_torch.configs import LlamaConfig

    cfg = LlamaConfig(quant_int8=True, quant_int8_embed=quant_embed)
    return cfg if num_layers is None else dataclasses.replace(cfg, num_layers=num_layers)


def hf_llama_top(cfg, seed: int):
    """The embedding, final norm and LM head of a seeded HF Llama state dict,
    bf16 on the card."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(seed)
    v, h = cfg.vocab_size, cfg.hidden_size

    def normal(shape, std):
        return (torch.randn(shape, generator=gen, device="cuda") * std).to(torch.bfloat16)

    return {"model.embed_tokens.weight": normal((v, h), 0.02),
            "model.norm.weight": torch.ones(h, dtype=torch.bfloat16, device="cuda"),
            "lm_head.weight": normal((v, h), h ** -0.5)}


def hf_llama_layer(cfg, i: int, seed: int):
    """Decoder layer i of a seeded HF Llama state dict, bf16 on the card:
    each projection normal with std 1/sqrt(fan_in), norms 1."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(seed + 1 + i)
    h, f = cfg.hidden_size, cfg.intermediate_size
    q, kv = cfg.num_heads * cfg.head_dim, cfg.num_kv_heads * cfg.head_dim
    shapes = {"self_attn.q_proj": (q, h), "self_attn.k_proj": (kv, h),
              "self_attn.v_proj": (kv, h), "self_attn.o_proj": (h, q),
              "mlp.gate_proj": (f, h), "mlp.up_proj": (f, h), "mlp.down_proj": (h, f)}
    out = {f"model.layers.{i}.{name}.weight":
           (torch.randn(shape, generator=gen, device="cuda") * shape[1] ** -0.5
            ).to(torch.bfloat16) for name, shape in shapes.items()}
    for norm in ("input_layernorm", "post_attention_layernorm"):
        out[f"model.layers.{i}.{norm}.weight"] = torch.ones(
            h, dtype=torch.bfloat16, device="cuda")
    return out


def build_llama(cfg, seed: int):
    """`LlamaForCausalLM(cfg)` on the card from a seeded HF-layout state
    dict drawn layer by layer: each layer converted (`convert_hf_llama_layer`),
    quantised (`quantize_kernels_int8`), loaded and freed, so that the bf16
    model (16 GB at full width) never exists whole. Returns the model and
    the peak device memory of the build in GB."""
    import dataclasses

    import torch

    from hsenet_torch.models.llama import (
        LlamaForCausalLM,
        convert_hf_llama,
        convert_hf_llama_layer,
    )
    from hsenet_torch.models.lora import quantize_embed_int8, quantize_kernels_int8

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    model = LlamaForCausalLM(cfg, dtype=torch.bfloat16, device="cuda").eval()
    want = set(model.state_dict())
    loaded = set()

    def load(state):
        if cfg.quant_int8_embed:
            state = quantize_embed_int8(state)
        result = model.load_state_dict(state, strict=False)
        if result.unexpected_keys:
            raise AssertionError(f"llama build: unexpected {result.unexpected_keys[:4]}")
        loaded.update(state)

    with torch.no_grad():
        load(convert_hf_llama(hf_llama_top(cfg, seed),
                              dataclasses.replace(cfg, num_layers=0)))
        for i in range(cfg.num_layers):
            load(quantize_kernels_int8(convert_hf_llama_layer(
                hf_llama_layer(cfg, i, seed), i)))
    if loaded != want:
        raise AssertionError(f"llama build: {sorted(want - loaded)[:4]} not loaded")
    torch.cuda.synchronize()
    return model, torch.cuda.max_memory_allocated() / 1e9


def llama_traffic(n: int, seed: int):
    """`n` submit() kwargs: prompts of 20-200 random tokens, budgets of
    16-64 new tokens, from a seeded numpy generator."""
    import numpy as np

    rng = np.random.default_rng(seed)
    return [dict(prompt_ids=rng.integers(3, 100000, int(rng.integers(20, 201))),
                 max_new=int(rng.integers(16, LLAMA_MAX_NEW + 1)))
            for _ in range(n)]


def llama_engine(model, **kw):
    import torch

    from hsenet_torch.serving import ServingEngine

    settings = dict(eos_token_id=LLAMA_EOS, num_slots=LLAMA_SLOTS,
                    prompt_cap=LLAMA_PROMPT_CAP, max_new_tokens=LLAMA_MAX_NEW,
                    chunk_size=LLAMA_CHUNK, cache_dtype=torch.bfloat16)
    settings.update(kw)
    return ServingEngine(model, **settings)


def drain(eng, requests):
    """Submit `requests`, drain the engine; (tokens by request, wall s)."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    uids = [eng.submit(**req) for req in requests]
    results = eng.run_until_drained()
    torch.cuda.synchronize()
    return [results[u] for u in uids], time.perf_counter() - t0


def check_llm_engine_counts(tag, cfg, eng, n_requests, matvec: bool):
    """B1 launched once a layer per admission at head dim 128, all on
    flash_fwd_wgmma; B5 7 x layers per decode step on the tensor-core entry
    (or, for a speculative engine's 64-row verify, never)."""
    from hsenet_torch.ops import flash_attention as tfa
    from hsenet_torch.ops import quant_matvec as tqm

    fwd_route(tag, tfa.launches, tfa.f32_launches)
    want_b1 = cfg.num_layers * n_requests
    want_b5 = 7 * cfg.num_layers * eng.steps_run if matvec else 0
    got_b1, got_b5 = tfa.fwd_launches[(128, False)], tqm.launches[tqm.KERNEL]
    print(f"[{tag}] flash_fwd launches {got_b1} (expected {want_b1}: one a layer "
          f"per admission), quant_matvec {got_b5} on the tensor-core entry "
          f"(expected {want_b5}{f' = 7 x {cfg.num_layers} x {eng.steps_run} steps' if matvec else ''}), "
          f"{tqm.fma_launches[tqm.FMA]} on the CUDA-core entry (expected 0)")
    if (got_b1 != want_b1 or sum(tfa.launches.values()) != want_b1
            or got_b5 != want_b5 or tqm.fma_launches[tqm.FMA]):
        raise AssertionError(f"{tag}: launches off the expected counts")
    return {"flash_fwd_launches": got_b1, "quant_matvec_launches": got_b5,
            "decode_steps": eng.steps_run}


def engine_replay_logits(cfg, model, prompt, tokens):
    """f32 logits (V,) of the position after `prompt` + `tokens`, computed
    as the Llama engine computes it on the current path: the prompt
    prefilled at the engine's width (padded to LLAMA_PROMPT_CAP, a row of
    its capacity), then `tokens` decoded one at a time; the f32 LM head on
    the last hidden state."""
    import torch

    from hsenet_torch.models.phi3 import KVCache

    n = len(prompt)
    ids = torch.zeros((1, LLAMA_PROMPT_CAP), dtype=torch.int32, device="cuda")
    ids[0, :n] = torch.as_tensor(prompt, device="cuda")
    cache = KVCache.create(cfg, 1, LLAMA_PROMPT_CAP + LLAMA_MAX_NEW + LLAMA_CHUNK,
                           device="cuda")
    with torch.inference_mode():
        hidden, cache = model.decoder(
            model.embed_tokens(ids), cache=cache,
            kv_lens=torch.tensor([n], dtype=torch.int32, device="cuda"))
        h = hidden[0, n - 1]
        for t in tokens:
            hidden, cache = model.decoder(model.embed_tokens(torch.tensor(
                [[t]], dtype=torch.int32, device="cuda")), cache=cache)
            h = hidden[0, -1]
        return f32_head_logits(model, h)


def llama_divergences(tag, cfg, model, requests, got, want, hold=True):
    """Where each request's `got` tokens first leave `want`, the gap
    between the two tokens' logits at that position, replayed on the
    current path as the engine decodes (`engine_replay_logits`); with
    `hold`, each must be a near-tie: at most NEAR_TIE_SHARE of the logits'
    RMS. Returns (request, position, top-2 margin, gap, gap's share of RMS)
    for each parting."""
    diverged = []
    for r, (req, g, w) in enumerate(zip(requests, got, want)):
        div = first_divergence(g, w)
        if div is None:
            continue
        x = engine_replay_logits(cfg, model, req["prompt_ids"], w[:div]).float()
        top = x.topk(2).values
        margin = (top[0] - top[1]).item()
        gap = (abs((x[g[div]] - x[w[div]]).item())
               if div < len(g) and div < len(w) else margin)
        share = gap / x.pow(2).mean().sqrt().item()
        diverged.append((r, div, margin, gap, share))
        print(f"[{tag}] request {r} parts at token {div}: top-2 logit margin "
              f"{margin:.4e}, the two tokens' logits {gap:.4e} apart = "
              f"{share:.3e} of the logits' RMS (near-tie limit {NEAR_TIE_SHARE})")
    far = [d for d in diverged if d[4] > NEAR_TIE_SHARE]
    if far and hold:
        raise AssertionError(f"{tag}: tokens part away from a near-tie: {far}")
    return diverged


def run_llama(card: str, root: str):
    """[llama]: Llama-3-8B's shape at full depth, int8 projections, built
    layer by layer from a seeded HF-layout state dict; the greedy,
    speculative and sampled engines on 8 prompts of 20-200 tokens; greedy
    tokens against the plain path under the near-tie rule; a decode chunk
    profiled; then `convert_checkpoint --kind llama --quant-int8` from a
    file at full width and depth 2, served. Returns the numbers."""
    import dataclasses

    import torch

    from hsenet_torch.models.llama import llama_as_phi3_config
    from hsenet_torch.ops import attention
    from hsenet_torch.ops import quant_matvec as tqm

    cfg = llama_config()
    t0 = time.perf_counter()
    model, build_peak = build_llama(cfg, seed=100)
    n_codes = sum(b.numel() for b in model.buffers() if b.dtype == torch.int8)
    n_float = sum(p.numel() for p in model.parameters())
    print(f"[llama] LlamaForCausalLM(LlamaConfig(quant_int8=True)) on {card}: "
          f"{cfg.num_layers} layers, {n_codes / 1e9:.3f} B int8 codes, "
          f"{n_float / 1e9:.3f} B bf16 parameters (embedding, LM head, norms), "
          f"built layer by layer in {time.perf_counter() - t0:.1f} s, peak "
          f"{build_peak:.2f} GB, {torch.cuda.memory_allocated() / 1e9:.2f} GB "
          "allocated")
    phi = llama_as_phi3_config(cfg)
    numbers = {"build_peak_gb": build_peak, "int8_codes_b": n_codes / 1e9,
               "bf16_params_b": n_float / 1e9}
    requests = llama_traffic(LLAMA_REQUESTS, seed=41)
    warm = llama_engine(model)
    drain(warm, [{**r, "max_new": 4} for r in llama_traffic(2, seed=42)])
    del warm
    spec = dict(speculative=True, draft_len=SPEC_DRAFT_LEN, ngram=SPEC_NGRAM)
    runs = {"greedy": {}, "speculative": spec,
            "sampled": dict(do_sample=True, temperature=SAMPLE_T,
                            top_p=SAMPLE_TOP_P, rng=43)}
    tokens = {}
    torch.cuda.reset_peak_memory_stats()
    for name, kw in runs.items():
        eng = llama_engine(model, **kw)
        reset_counts()  # the Llama engine, counted
        got, wall = drain(eng, requests)
        tokens[name] = got
        counts = check_llm_engine_counts(f"llama {name}", phi, eng, len(requests),
                                         matvec=name != "speculative")
        if not all(0 <= t < cfg.vocab_size for row in got for t in row) or not all(
                len(t) <= r["max_new"] for t, r in zip(got, requests)):
            raise AssertionError(f"llama {name}: a token outside the vocabulary "
                                 "or a request past its budget")
        n_tok = sum(map(len, got))
        stats = eng.latency_stats()
        numbers[name] = {**counts, "tokens": n_tok, "wall_s": wall,
                         "tokens_per_s": n_tok / wall, "latency": stats,
                         "mean_accepted": eng.mean_accepted}
        print(f"[llama] {name} engine, {len(requests)} requests, {LLAMA_SLOTS} "
              f"slots: {n_tok} tokens in {wall:.2f} s = {n_tok / wall:.1f} "
              f"tokens/s, TTFT p50/p99 {stats['ttft_p50_s']:.3f}/"
              f"{stats['ttft_p99_s']:.3f} s"
              + (f", mean_accepted {eng.mean_accepted:.2f}" if kw.get("speculative") else ""))
    numbers["serve_peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    print(f"[llama] peak memory while serving {numbers['serve_peak_gb']:.2f} GB")
    # the plain path: every kernel replaced by its plain version
    sound = tqm.quant_matvec_kernel
    tqm.quant_matvec_kernel = tqm.quant_matvec_int8_reference
    attention.set_flash_mode("never")
    try:
        plain, _ = drain(llama_engine(model), requests)
    finally:
        tqm.quant_matvec_kernel = sound
        attention.set_flash_mode("auto")
    numbers["greedy_vs_plain"] = llama_divergences(
        "llama kernels vs plain", phi, model, requests, tokens["greedy"], plain)
    # reported, not held: the 64-row verify takes the plain int8 expression,
    # whose scale rounds to bf16 (up to 1.5 bf16 units from B5's rows,
    # ROADMAP §C), so its partings may sit past [spec]'s limit (0.051 of the
    # RMS at one parting of the first run)
    numbers["speculative_vs_greedy"] = llama_divergences(
        "llama speculative vs greedy", phi, model, requests,
        tokens["speculative"], tokens["greedy"], hold=False)
    print(f"[llama] greedy requests equal to the plain path's: "
          f"{sum(g == p for g, p in zip(tokens['greedy'], plain))} of "
          f"{len(requests)}; speculative equal to greedy: "
          f"{sum(s == g for s, g in zip(tokens['speculative'], tokens['greedy']))}")
    # one decode chunk with 8 live slots, profiled
    eng = llama_engine(model)
    for req in llama_traffic(LLAMA_SLOTS, seed=44):
        eng.submit(**{**req, "max_new": LLAMA_MAX_NEW})
    with torch.inference_mode():
        eng._admit()

        def chunk():
            eng._decode_chunk().cpu()

        chunk()
        wall = median_wall_ms(chunk, runs=3)
        numbers["decode_chunk"] = profile_phase(
            f"llama decode chunk ({LLAMA_CHUNK} steps x {LLAMA_SLOTS} slots)",
            chunk, wall, top=8)
    numbers["decode_chunk"]["step_wall_ms"] = wall / LLAMA_CHUNK
    dev_ms = numbers["decode_chunk"]["device_ms"]
    print(f"[llama] decode step {wall / LLAMA_CHUNK:.2f} ms wall, "
          + ("device not measured" if dev_ms is None else
             f"{dev_ms / LLAMA_CHUNK:.2f} ms device")
          + f"; {LLAMA_SLOTS * LLAMA_CHUNK / (wall / 1e3):.1f} tokens/s at "
          f"{LLAMA_SLOTS} live slots")
    del eng
    numbers["convert"] = run_llama_convert(card, root)
    numbers["prompt_lens"] = [len(r["prompt_ids"]) for r in requests]
    return numbers


def run_llama_convert(card: str, root: str):
    """`convert_checkpoint --kind llama --quant-int8` of a seeded HF state
    dict at full width and depth LLAMA_CONVERT_LAYERS, written to a file;
    the output loads into the int8 model, holds the codes of the same
    quantisation, and serves one request (B5 at one row)."""
    import os

    import torch

    from hsenet_torch.cli.common import restore_checkpoint
    from hsenet_torch.cli.convert_checkpoint import main as convert_main
    from hsenet_torch.models.llama import LlamaForCausalLM, llama_as_phi3_config
    from hsenet_torch.models.lora import quantize_kernels_int8

    cfg = llama_config(LLAMA_CONVERT_LAYERS, quant_embed=True)
    sd = hf_llama_top(cfg, seed=200)
    for i in range(cfg.num_layers):
        sd.update(hf_llama_layer(cfg, i, seed=200))
    probe = "model.layers.1.mlp.down_proj.weight"
    want_codes = quantize_kernels_int8({"down_proj.weight": sd[probe]})
    src, out = os.path.join(root, "llama_hf.bin"), os.path.join(root, "llama_int8.pt")
    t0 = time.perf_counter()
    torch.save({k: v.cpu() for k, v in sd.items()}, src)
    write_s = time.perf_counter() - t0
    del sd
    t0 = time.perf_counter()
    convert_main(["--kind", "llama", "--input", src, "--output", out, "--config-json",
                  json.dumps({"num_layers": cfg.num_layers}), "--quant-int8"],
                 device="cuda")
    convert_s = time.perf_counter() - t0
    model = restore_checkpoint(LlamaForCausalLM(cfg, dtype=torch.bfloat16,
                                                device="cuda"), out).eval()
    got_codes = model.decoder.layers[1].down_proj.weight_q
    same = torch.equal(got_codes, want_codes["down_proj.weight_q"])
    eng = llama_engine(model, num_slots=1)
    reset_counts()
    got, wall = drain(eng, llama_traffic(1, seed=45))
    counts = check_llm_engine_counts("llama convert", llama_as_phi3_config(cfg),
                                     eng, 1, matvec=True)
    sizes = {"hf_file_gb": os.path.getsize(src) / 1e9,
             "output_gb": os.path.getsize(out) / 1e9}
    print(f"[llama] convert_checkpoint --kind llama --quant-int8 on {card}: "
          f"{cfg.num_layers} layers at full width, HF file {sizes['hf_file_gb']:.2f} "
          f"GB written in {write_s:.1f} s, converted in {convert_s:.1f} s to "
          f"{sizes['output_gb']:.2f} GB; a layer's codes equal a quantisation "
          f"of the same weights: {same}; served one request of {len(got[0])} "
          f"tokens in {wall:.2f} s (1 slot: B5 at M = 1)")
    if not same or not got[0]:
        raise AssertionError("llama convert: the converted model's codes or its "
                             "served request are wrong")
    os.remove(src)
    os.remove(out)
    return {**sizes, "write_s": write_s, "convert_s": convert_s, **counts,
            "served_tokens": len(got[0])}


def b1_case(tag, name, b, h, sq, skv, d, kv_lens, causal, gen):
    """B1 through `flash_attention` (head dim d, padded to the kernel's
    width there) against its plain version at d, beside the same attention
    without its last valid 64-key tile (must miss), timed beside the bound
    at d, the plain version and one SDPA call."""
    import torch
    import torch.nn.functional as F

    from hsenet_torch.ops import flash_attention as tfa

    q = torch.randn(b, h, sq, d, generator=gen, device="cuda", dtype=torch.bfloat16)
    k, v = (torch.randn(b, h, skv, d, generator=gen, device="cuda",
                        dtype=torch.bfloat16) for _ in range(2))
    kv_t = torch.tensor(kv_lens, dtype=torch.int32, device="cuda")
    off_t = torch.zeros(b, dtype=torch.int32, device="cuda")
    kw = dict(kv_lens=kv_t, causal=causal, q_offset=off_t)
    out = tfa.flash_attention(q, k, v, **kw)
    ref = tfa.flash_attention_reference(q, k, v, **kw)
    max_abs, rel, ok = compare(out, ref)
    col = torch.arange(skv, device="cuda")[None, None, None, :]
    first = (kv_t[:, None, None, None] - 1) // 64 * 64
    _, drop_rel, drop_ok = compare(
        forward_dropping(q, k, v, kv_t, off_t, causal, col >= first), ref)
    mask = tfa._valid(q, k, kv_t, off_t, causal)
    bound, bound_by, flops, nbytes = kernel_bound(
        "flash_fwd", b, h, sq, skv, d, kv_lens, (0,) * b, causal)
    r = {"max_abs_err": max_abs, "max_row_rel_err": rel,
         "ms": time_ms(lambda: tfa.flash_attention(q, k, v, **kw)),
         "plain_ms": time_ms(lambda: tfa.flash_attention_reference(q, k, v, **kw),
                             reps=5),
         "library_ms": time_ms(lambda: F.scaled_dot_product_attention(
             q, k, v, attn_mask=mask)),
         "bound_ms": bound, "bound_by": bound_by, "gflop": flops / 1e9,
         "mbytes": nbytes / 1e6, "head_dim": d,
         "kernel_head_dim": tfa.kernel_head_dim(d, q.dtype)}
    print(f"[{tag}] flash_fwd {name}: q{tuple(q.shape)} k{tuple(k.shape)} "
          f"causal={causal} kv_lens {kv_lens}: max err / row's max |ref| "
          f"{rel:.3e} (tol {KERNEL_ROW_TOL}); without the last valid 64-key "
          f"tile {drop_rel:.3e}; kernel {r['ms']:.4f} ms (head dim {d} at the "
          f"kernel's {r['kernel_head_dim']}{', copies included' if r['kernel_head_dim'] != d else ''}), "
          f"plain {r['plain_ms']:.4f} ms, library (SDPA) {r['library_ms']:.4f} "
          f"ms, bound {bound:.4f} ms ({bound_by}: {r['gflop']:.3f} GFLOP, "
          f"{r['mbytes']:.2f} MB)")
    if not ok:
        raise AssertionError(f"flash_fwd disagrees with its plain version at {name}")
    if drop_ok:
        raise AssertionError(f"the kernel tolerance passes a dropped key tile at {name}")
    return r


def check_llama_kernels(prefill_kv: int):
    """[kernel-llama]: B5's tensor-core entry at Llama-3-8B's four (K, N),
    held at every M of MATVEC_CHECK_ROWS beside the two wrong variants, and
    timed at M = 8 and 1 with the codes cold; B1 at the Llama engine's
    admission shape (32 heads, 256 rows over a 336-slot row, causal, at
    `prefill_kv`). Returns the matvec results by shape and B1's."""
    import torch

    from hsenet_torch.ops import quant_matvec as tqm

    gen = torch.Generator(device="cuda").manual_seed(24)
    library = int8pack_registered()
    matvec = {}
    for name, (k, n) in LLAMA_MATVEC_SHAPES.items():
        w, scale = matvec_codes(gen, k, n)
        for m in MATVEC_CHECK_ROWS:
            x = torch.randn(m, k, generator=gen, device="cuda", dtype=torch.bfloat16)
            hold_matvec(f"{name} M={m} bf16, plan {tuple(tqm.mma_plan(m, k, n))}",
                        tqm.quant_matvec_mma_kernel, x, w, scale, "kernel-llama")
        del w, scale
        r, _ = time_matvec_cold("kernel-llama", name, k, n, gen, library)
        matvec.update(r)
    capacity = LLAMA_PROMPT_CAP + LLAMA_MAX_NEW + LLAMA_CHUNK
    name = f"llama_prefill_1x32x{LLAMA_PROMPT_CAP}x{capacity}"
    flash = {name: b1_case("kernel-llama", name, 1, 32, LLAMA_PROMPT_CAP, capacity,
                           128, (prefill_kv,), True, gen)}
    return matvec, flash


def variant_config(kind: str):
    """`VLMConfig()` with projector `kind` (tower_mode 'med2e3' for
    "med2e3"), the LLM cut to VARIANT_LLM_LAYERS layers."""
    import dataclasses

    from hsenet_torch.configs import VLMConfig

    cfg = VLMConfig()
    cfg = dataclasses.replace(cfg, llm=dataclasses.replace(
        cfg.llm, num_layers=VARIANT_LLM_LAYERS))
    if kind == "med2e3":
        return dataclasses.replace(cfg, tower_mode="med2e3")
    return dataclasses.replace(cfg, packer=dataclasses.replace(
        cfg.packer, projector_type=kind))


def image_tokens(cfg) -> int:
    """The image tokens the VLM splices in: `num_image_tokens`, but for
    spatial_pooling the pooled grid's size a stream ((grid / pooling)^3),
    where the JAX package's `proj_out_num` counts the packer's windows."""
    p = cfg.packer
    if p.projector_type != "spatial_pooling":
        return cfg.num_image_tokens
    n = math.prod(g // p.pooling_size for g in p.grid)
    return (2 if cfg.tower_mode == "dual_vits" else 1) * n


def run_variants(card: str):
    """[variants]: full-width VLMs (towers at full depth, the LLM at
    VARIANT_LLM_LAYERS layers) with projector spatial_pooling, mlp and
    qformer, and tower_mode med2e3: two volumes a run through prefill,
    VARIANT_NEW_TOKENS greedy and as many sampled tokens; launches by shape
    held to their expected counts; prefill logits against the plain sdpa
    path; QFormer's B1 at head dim 96 checked and timed; med2e3 served
    through the engine (no caches). Returns the numbers, the QFormer B1
    results by shape and their launches."""
    import torch

    from hsenet_torch.eval.generate import make_greedy_generate
    from hsenet_torch.models import init_random_
    from hsenet_torch.models.mllm import HSENetVLM
    from hsenet_torch.models.phi3 import KVCache
    from hsenet_torch.ops import attention
    from hsenet_torch.ops import flash_attention as tfa

    numbers, qformer_counts = {}, {}
    for kind in VARIANTS:
        cfg = variant_config(kind)
        t0 = time.perf_counter()
        model = HSENetVLM(cfg, dtype=torch.bfloat16, device="cuda")
        init_random_(model, torch.Generator(device="cuda").manual_seed(50))
        model.eval()
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        gen = torch.Generator(device="cuda").manual_seed(51)
        n_img = image_tokens(cfg)
        b = len(VARIANT_TEXT)
        kv = [1 + n_img + t for t in VARIANT_TEXT]
        seq = max(kv)
        ids = torch.randint(3, 100000, (b, seq), generator=gen, device="cuda")
        ids[:, 0] = 1
        ids[:, 1:1 + n_img] = IM_PATCH_TOKEN_ID
        for row, n in enumerate(kv):
            ids[row, n:] = 0
        kv_t = torch.tensor(kv, dtype=torch.int32, device="cuda")
        vol = torch.rand((b, 1, *cfg.vision.image_size), generator=gen, device="cuda")
        sl = torch.randn((b, cfg.vision.num_slices, cfg.vision.slice_feature_dim),
                         generator=gen, device="cuda")
        streams = 2 if cfg.tower_mode == "dual_vits" else 1
        tower_seq = cfg.vision.seq_len

        def expect(capacity):
            # launches of one encode + prefill by (kind, batch, heads, sq,
            # skv, kernel head dim): 12 a tower, one an LLM layer, and
            # QFormer's 4 attentions a projector (3 over its 32 queries, 1
            # over the 2048 patch tokens) at head dim 96 padded to 128
            want = {("flash_fwd", b, cfg.vision.num_heads, tower_seq, tower_seq, 64):
                    cfg.vision.num_layers * streams,
                    ("flash_fwd", b, cfg.llm.num_heads, seq, capacity, 128):
                    cfg.llm.num_layers}
            if kind == "qformer":
                nq = cfg.packer.num_queries
                want[("flash_fwd", b, 8, nq, nq, 128)] = 3 * streams
                want[("flash_fwd", b, 8, nq, tower_seq - 1, 128)] = streams
            return want

        def prefill():
            cache = KVCache.create(cfg.llm, b, seq, device="cuda")
            with torch.inference_mode():
                return model.prefill(ids, vol, sl, cache, kv_t)[0]

        generate = make_greedy_generate(model, max_new_tokens=VARIANT_NEW_TOKENS,
                                        eos_token_id=EOS_TOKEN_ID)
        sampled = make_greedy_generate(model, max_new_tokens=VARIANT_NEW_TOKENS,
                                       eos_token_id=EOS_TOKEN_ID, do_sample=True,
                                       temperature=SAMPLE_T, top_p=SAMPLE_TOP_P)
        prefill()  # warm-up
        torch.cuda.synchronize()
        run = {}
        gen_cap = seq + VARIANT_NEW_TOKENS
        for label, fn, capacity in (
                ("prefill", prefill, seq),
                ("greedy", lambda: generate(ids, kv_t, vol, sl), gen_cap),
                ("sampled", lambda: sampled(ids, kv_t, vol, sl, rng=52), gen_cap)):
            reset_counts()  # each run of the variant, counted
            t1 = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            run[label] = (out, time.perf_counter() - t1)
            fwd_route(f"variants {kind} {label}", tfa.launches, tfa.f32_launches)
            got, want = dict(tfa.shape_launches), expect(capacity)
            if got != want:
                raise AssertionError(f"variants {kind} {label}: launches {got}, "
                                     f"expected {want}")
            for key, n in got.items():
                if kind == "qformer" and key[2] == 8:
                    qformer_counts[key] = qformer_counts.get(key, 0) + n
        logits = run["prefill"][0]
        attention.set_flash_mode("never")
        try:
            plain = prefill()
        finally:
            attention.set_flash_mode("auto")
        err = rel_l2(logits, plain)
        tokens = {k: run[k][0] for k in ("greedy", "sampled")}
        vocab_ok = all(bool(((t >= 0) & (t < cfg.llm.vocab_size)).all())
                       for t in tokens.values())
        numbers[kind] = {
            "image_tokens": n_img, "prompt_lens": kv, "prefill_s": run["prefill"][1],
            "greedy_s": run["greedy"][1], "sampled_s": run["sampled"][1],
            "logits_rel_l2_vs_plain": err, "launches_per_generate": {
                " ".join(map(str, k)): n for k, n in expect(gen_cap).items()},
            "build_s": build_s}
        print(f"[variants] {kind} on {card}: towers {cfg.tower_mode} at "
              f"{cfg.vision.num_layers} blocks, LLM at {cfg.llm.num_layers} "
              f"layers, {n_img} image tokens (config says "
              f"{cfg.num_image_tokens}), prompts {kv}: prefill "
              f"{run['prefill'][1] * 1e3:.1f} ms, {VARIANT_NEW_TOKENS} greedy "
              f"tokens {run['greedy'][1]:.2f} s, sampled {run['sampled'][1]:.2f} "
              f"s; prefill logits vs the plain path rel L2 {err:.3e} (tol "
              f"{VARIANT_LOGITS_REL_L2}); launches a generate run "
              f"{expect(gen_cap)}; built in {build_s:.1f} s; greedy "
              f"{tokens['greedy'][0, :4].tolist()}, sampled "
              f"{tokens['sampled'][0, :4].tolist()}")
        if not err <= VARIANT_LOGITS_REL_L2 or not logits.isfinite().all() or not vocab_ok:
            raise AssertionError(f"variants {kind}: logits off the plain path, or "
                                 "a token outside the vocabulary")
        if kind == "med2e3":
            numbers[kind]["engine"] = run_med2e3_engine(cfg, model, ids, kv, vol, sl)
        del model, run, logits, plain
        gc.collect()
        torch.cuda.empty_cache()
    gen = torch.Generator(device="cuda").manual_seed(53)
    qformer = {}
    for key in sorted(qformer_counts):
        _, b, h, sq, skv, _ = key
        name = f"qformer_{b}x{h}x{sq}x{skv}_d96"
        qformer[name] = b1_case("variants", name, b, h, sq, skv, 96, (skv,) * b,
                                False, gen)
    counts = {f"qformer_{k[1]}x{k[2]}x{k[3]}x{k[4]}_d96": n
              for k, n in qformer_counts.items()}
    return numbers, qformer, counts


def run_med2e3_engine(cfg, model, ids, kv, vol, sl):
    """The med2e3 VLM served through the engine without caches: two
    requests, each admission running the 3D tower and the LLM prefill."""
    import torch

    from hsenet_torch.ops import flash_attention as tfa
    from hsenet_torch.serving import ServingEngine

    eng = ServingEngine(model, eos_token_id=EOS_TOKEN_ID, num_slots=2,
                        prompt_cap=256, max_new_tokens=VARIANT_NEW_TOKENS,
                        chunk_size=VARIANT_NEW_TOKENS, multimodal=True,
                        cache_dtype=torch.bfloat16)
    reqs = [dict(prompt_ids=ids[r, :kv[r]].cpu().numpy(),
                 volume=vol[r:r + 1].cpu().numpy(),
                 slice_features=sl[r:r + 1].cpu().numpy()) for r in range(2)]
    reset_counts()
    got, wall = drain(eng, reqs)
    want = {"d64": cfg.vision.num_layers * 2, "d128": cfg.llm.num_layers * 2}
    got_b1 = {"d64": tfa.fwd_launches[(64, False)],
              "d128": tfa.fwd_launches[(128, False)]}
    fwd_route("variants med2e3 engine", tfa.launches, tfa.f32_launches)
    print(f"[variants] med2e3 through the engine (no caches): 2 requests, "
          f"{sum(map(len, got))} tokens in {wall:.2f} s; flash_fwd {got_b1} "
          f"(expected {want}: one 3D tower and the LLM per admission)")
    if got_b1 != want or not all(got):
        raise AssertionError("variants med2e3 engine: launches or tokens off")
    return {"tokens": sum(map(len, got)), "wall_s": wall, "flash_fwd_launches": got_b1}


def seg_kernel_cases():
    """B1 and B3 at the shapes of this slice's paths: SegVol's ViT-B (2,048
    tokens, no CLS, so no ragged tile) at batch 2 (forward, and with the
    log-sum-exp and B3 where train_vlm --task seg trains it) and at batch 1
    (one sliding window); the legacy masked CLIP's masked stream at batch
    24 at the buckets 1,792 and 1,280 (1,793 and 1,281 tokens with CLS: a
    ragged last tile of one row; the bucket 2,048 runs at the tower's 2,049,
    [kernel-time]'s clip_tower)."""
    from hsenet_torch.train.legacy_clip import bucketed_unmasked_tokens

    v, c = seg_vit_config(), clip_config().vision
    h, s, d = v.num_heads, v.num_patches, v.hidden_size // v.num_heads
    cases = [
        ("segvol_vit", (SEG_BATCH, h, s, d), (s,) * SEG_BATCH, False,
         (SEG_BATCH, h), ("flash_fwd", "flash_fwd_lse")),
        ("segvol_window", (1, h, s, d), (s,), False, (1, h), ("flash_fwd",)),
    ]
    for step in MASKED_STEPS[1:]:
        n = bucketed_unmasked_tokens(step, c.num_patches) + 1
        cases.append((f"masked_{n}", (CLIP_BATCH, c.num_heads, n,
                                      c.hidden_size // c.num_heads),
                       (n,) * CLIP_BATCH, False, (4, c.num_heads),
                       ("flash_fwd_lse",)))
    return cases


def seg_shape_index():
    index = {}
    for name, (b, h, s, d), _, _, _, fwd_kinds in seg_kernel_cases():
        for kind in fwd_kinds:
            index[(kind, b, h, s, s, d)] = (
                "flash_fwd", name + ("_lse" if kind == "flash_fwd_lse" else ""))
        if "flash_fwd_lse" in fwd_kinds:
            index[("flash_bwd", b, h, s, s, d)] = ("flash_bwd", name)
    return index


def check_seg_kernels():
    """[kernel-seg]: B1 and B3 at `seg_kernel_cases` against the plain
    versions (2e-2 of each row's largest value, wrong variants beside each
    limit), timed beside the bound, the plain version and SDPA."""
    return check_flash_cases(seg_kernel_cases(), seed=29)


def counted(fn):
    """`fn()` with every launch count set to 0 just before; its result, the
    flash launches by shape (bf16, f16 and f32 alike) and by kernel, and the
    f32 launches."""
    from hsenet_torch.ops import flash_attention as tfa

    reset_counts()
    out = fn()
    return (out, dict(tfa.shape_launches), dict(tfa.launches),
            dict(tfa.f32_launches))


def seg_vit_config():
    """SegVol's encoder as `evaluate --task seg` builds it: ViT-B over
    (32, 256, 256) in (4, 16, 16) patches without CLS."""
    from hsenet_torch.configs import ViT3DConfig

    return ViT3DConfig(classification=False)


def build_segvol(dtype, seed: int, swin=None):
    import torch

    from hsenet_torch.models import init_random_
    from hsenet_torch.models.segvol import SegVol

    model = SegVol(seg_vit_config(), swin, dtype=dtype, device="cuda")
    return init_random_(model, torch.Generator(device="cuda").manual_seed(seed)).eval()


def rel_l2_of(got, want) -> float:
    got, want = got.float(), want.float()
    return ((got - want).norm() / want.norm()).item()


def run_segvol(card: str):
    """[segvol]: SegVol at `ViT3DConfig(classification=False)` (ViT-B, 12
    layers, (32, 256, 256)) in bf16 at batch 2, text-prompted: 12 B1
    launches a forward at 2 x 12 x 2048 x 64, the logits against the same
    model through the plain attention path beside a path with the heads'
    outputs shifted by one head (must miss), `SegVolPredictor`'s cached grid equal to
    `encode_image`'s and its prediction to the forward's,
    `sliding_window_segment` over a (48, 384, 384) volume in 8 windows (96
    launches at batch 1), ms a volume; then SegVol on `SwinConfig()` in
    bf16 against f32 (no flash kernel: windows of 64 tokens with a bias)."""
    import torch

    from hsenet_torch.configs import SwinConfig
    from hsenet_torch.eval.sliding_window import (
        SegVolPredictor,
        make_segvol_predictor,
        sliding_window_segment,
        window_offsets,
    )
    from hsenet_torch.models import layers
    from hsenet_torch.ops import attention

    gen = torch.Generator(device="cuda").manual_seed(41)
    cfg = seg_vit_config()
    model = build_segvol(torch.bfloat16, seed=1)
    vol = torch.rand(SEG_BATCH, 1, *cfg.image_size, generator=gen, device="cuda")
    text = torch.randn(SEG_BATCH, cfg.hidden_size, generator=gen, device="cuda")
    numbers = {}
    with torch.no_grad():
        logits, shapes, by_kernel, f32 = counted(lambda: model(vol, text))
        torch.cuda.synchronize()
        key = (cfg.num_heads, cfg.num_patches, cfg.num_patches,
               cfg.hidden_size // cfg.num_heads)
        want_shapes = {("flash_fwd", SEG_BATCH, *key): cfg.num_layers}
        fwd_route("segvol", by_kernel, f32)
        print(f"[segvol] SegVol(ViT3DConfig(classification=False)) bf16, batch "
              f"{SEG_BATCH}, text prompts: logits {tuple(logits.shape)}, finite "
              f"{bool(logits.isfinite().all())}; B1 launches by shape {shapes}")
        if shapes != want_shapes or not bool(logits.isfinite().all()):
            raise AssertionError(f"[segvol] launches {shapes}, not {want_shapes}")
        try:
            attention.set_flash_mode("never")
            plain = model(vol, text)
            # the wrong variant: each head's output in the next head's
            # columns. A random ViT attends nearly uniformly, so a dropped
            # key tile moves these logits by ~2e-3 (f32 on the CPU): the
            # kernel checks of [kernel-seg] hold that fault
            sound = layers.multi_head_attention
            layers.multi_head_attention = lambda q, k, v, **kw: \
                attention.sdpa_reference(q, k, v).roll(1, dims=1)
            dropped = model(vol, text)
        finally:
            attention.set_flash_mode("auto")
            layers.multi_head_attention = sound
        rel, wrong = rel_l2_of(logits, plain), rel_l2_of(dropped, plain)
        print(f"[segvol] logits through B1 against the plain attention path: "
              f"rel L2 {rel:.3e} (limit {SEGVOL_REL_L2}); the plain path with the "
              f"heads' outputs shifted by one head {wrong:.3e}")
        if not rel <= SEGVOL_REL_L2 or wrong <= SEGVOL_REL_L2:
            raise AssertionError("[segvol] the logits' limit failed or passes "
                                 "shifted heads")
        numbers["logits_rel_l2"], numbers["shifted_heads_rel_l2"] = rel, wrong

        pred = SegVolPredictor(model)
        pred.set_image(vol)
        direct = model.encode_image(vol)
        cached = pred.predict(text_embedding=text)
        same_grid = torch.equal(pred.get_image_embedding(), direct)
        pred_rel = rel_l2_of(cached, logits)
        print(f"[segvol] SegVolPredictor: cached grid equals encode_image's bit "
              f"for bit: {same_grid}; predict against the forward: rel L2 "
              f"{pred_rel:.3e}")
        if not same_grid or pred_rel > 1e-6:
            raise AssertionError("[segvol] the predictor's cache is not the "
                                 "uncached encode")
        numbers["predictor_rel_l2"] = pred_rel

        wall = median_wall_ms(lambda: model(vol, text), runs=5)
        numbers["ms_per_volume"] = wall / SEG_BATCH
        encode = median_wall_ms(lambda: model.encode_image(vol), runs=5)
        decode = median_wall_ms(lambda: model.decode(direct, cfg.image_size,
                                                     text_embedding=text), runs=5)
        numbers.update(encode_ms=encode, decode_ms=decode, forward_ms=wall)
        numbers["profile"] = profile_phase("segvol forward, batch 2",
                                           lambda: model(vol, text), wall)

        big = torch.rand(1, *SEG_WINDOW_VOLUME, generator=gen, device="cuda")
        predict = make_segvol_predictor(model)
        windows = len(window_offsets(SEG_WINDOW_VOLUME, cfg.image_size))
        t0 = time.perf_counter()
        blended, w_shapes, by_kernel, f32 = counted(lambda: sliding_window_segment(
            lambda p: predict(p, text[:1]), big, cfg.image_size))
        torch.cuda.synchronize()
        sw_s = time.perf_counter() - t0
        fwd_route("segvol window", by_kernel, f32)
        want_w = {("flash_fwd", 1, *key): windows * cfg.num_layers}
        print(f"[segvol] sliding_window_segment over {SEG_WINDOW_VOLUME} in "
              f"{windows} windows: {tuple(blended.shape)}, finite "
              f"{bool(blended.isfinite().all())}, {sw_s:.2f} s; B1 launches "
              f"{w_shapes}")
        if windows < 8 or w_shapes != want_w or not bool(blended.isfinite().all()):
            raise AssertionError(f"[segvol] sliding window launches {w_shapes}, "
                                 f"not {want_w}")
        numbers["sliding_window"] = {"windows": windows, "wall_s": sw_s}
        for key, n in w_shapes.items():
            shapes[key] = shapes.get(key, 0) + n
        del model, big, blended, pred, direct
        gc.collect()
        torch.cuda.empty_cache()

        swin = SwinConfig()
        f32_model = build_segvol(torch.float32, seed=2, swin=swin)
        bf16_model = build_segvol(torch.bfloat16, seed=2, swin=swin)
        bf16_model.load_state_dict(f32_model.state_dict())
        text = torch.randn(1, swin.out_dim, generator=gen, device="cuda")
        want = f32_model(vol[:1], text)
        got, swin_shapes, _, _ = counted(lambda: bf16_model(vol[:1], text))
        swin_rel = rel_l2_of(got, want)
        swin_ms = {name: median_wall_ms(lambda m=m: m(vol[:1], text), runs=3)
                   for name, m in (("bf16", bf16_model), ("f32", f32_model))}
        print(f"[segvol] SegVol on SwinConfig() (grid {swin.grid} x "
              f"{swin.out_dim}), batch 1: bf16 against f32 rel L2 {swin_rel:.3e} "
              f"(limit {SWIN_REL_L2}); flash launches {swin_shapes or 'none'}; "
              f"ms a volume bf16 {swin_ms['bf16']:.1f}, f32 {swin_ms['f32']:.1f}")
        if not swin_rel <= SWIN_REL_L2 or swin_shapes:
            raise AssertionError("[segvol] the Swin encoder's bf16 logits miss f32's")
        numbers["swin"] = {"bf16_vs_f32_rel_l2": swin_rel, "ms": swin_ms}
    print(f"[segvol] on {card}: {numbers['ms_per_volume']:.2f} ms a volume at "
          f"batch {SEG_BATCH} (encode {encode:.2f} ms, decode {decode:.2f} ms a "
          "batch)")
    numbers["card"] = card
    del f32_model, bf16_model
    gc.collect()
    torch.cuda.empty_cache()
    return numbers, shapes


def write_seg_data(root):
    """This slice's manifests under `root`: SEG_VOLUMES volumes (1, 32, 256,
    256) f32 from a numpy seed, each with a box mask (32, 256, 256) of its
    own size, place and target (SEG_TARGETS), in a seg QA / REC manifest of 2 train and 2
    validation entries (the CLIs build these sets without a class list, so
    each entry names its target). Returns the manifest's path."""
    import os

    import numpy as np

    shape = seg_vit_config().image_size
    rng = np.random.default_rng(43)
    entries = []
    for i in range(SEG_VOLUMES):
        np.save(os.path.join(root, f"segvol{i}.npy"),
                rng.random((1, *shape), dtype=np.float32))
        mask = np.zeros(shape, np.float32)
        d, h, w = shape
        z, y, x = (int(rng.integers(0, n // 2)) for n in shape)
        mask[z:z + d // 4 + i, y:y + h // 4, x:x + w // 4 + i] = 1.0
        np.save(os.path.join(root, f"segmask{i}.npy"), mask)
        entries.append({"image": f"segvol{i}.npy", "seg": f"segmask{i}.npy",
                        "target": SEG_TARGETS[i]})
    path = os.path.join(root, "seg.json")
    with open(path, "w") as f:
        json.dump({"train": entries[:2], "validation": entries[2:]}, f)
    return path


def seg_vlm_launches(cfg, batch, seq, lse_fwd=True):
    """One `train_vlm --task seg --online-slice-features` step's flash
    launches by shape: the VLM step's (`vlm_launches`), the 2D trunk's, and
    SegVol's ViT (forward with the log-sum-exp, no remat, and its B3);
    `lse_fwd=False`: the seg eval's forwards."""
    v = cfg.seg_vision or cfg.vision
    seg = (batch, v.num_heads, v.num_patches, v.num_patches,
           v.hidden_size // v.num_heads)
    out = {**vlm_launches(cfg, batch, seq, lse_fwd), **trunk_launches(cfg, batch)}
    if lse_fwd:
        out.update({("flash_fwd_lse", *seg): v.num_layers,
                    ("flash_bwd", *seg): v.num_layers})
    else:
        out[("flash_fwd", *seg)] = v.num_layers
    return out


def run_cli_train_seg(card: str, root: str, manifest: str):
    """[cli-train-seg]: `train_vlm.main(["--task", "seg",
    "--online-slice-features", ...])` at the CLI's full width (VLMConfig()
    with LoRA on Phi-4-mini, 32 layers, SegVol trainable, remat on) on the
    seg manifest, batch 2 x 330 tokens, SEG_TRAIN_STEPS steps and the seg
    eval at the last: launches by shape each step, finite lm_loss and
    seg_loss, SegVol's leaves moved by the updates (their gradients are not
    zero), step ms and peak memory. Returns the numbers, the launches by
    shape over the run and the LLM's valid lengths by batch size."""
    import argparse
    import os

    import torch

    from hsenet_torch.cli import train_vlm
    from hsenet_torch.cli.common import build_vlm_config

    argv = ["--task", "seg", "--online-slice-features", "--manifest", manifest,
            "--data-root", root, "--batch-size", str(SEG_BATCH), "--total-steps",
            str(SEG_TRAIN_STEPS), "--log-every", "1", "--eval-every",
            str(SEG_TRAIN_STEPS), "--checkpoint-every", "1000",
            "--remat", "--output-dir", os.path.join(root, "train_seg")]
    snapshot = ("seg_module.image_encoder.tower.blocks.0.attn.qkv.weight",
                "seg_module.mask_decoder.hyper_mlp0.fc1.weight",
                "seg_module.mask_decoder.transformer.block1.mlp_fc1.weight",
                "seg_projector.layers_0.weight", "seg_projector.layers_2.weight")
    state, rec = run_train_cli("vlm seg", train_vlm.main, argv, snapshot=snapshot)
    cfg = build_vlm_config(argparse.Namespace(synthetic=False,
                                              online_slice_features=True))
    step = seg_vlm_launches(cfg, SEG_BATCH, 330)
    numbers = check_train_cli_run("vlm seg", rec, lambda s: step,
                                  seg_vlm_launches(cfg, SEG_BATCH, 330, False),
                                  SEG_BATCH, falls=False)
    logged = [m for _, m in rec["logged"]]
    lm = [m["lm_loss"] for m in logged]
    seg = [m["seg_loss"] for m in logged]
    end = state.model.state_dict()
    moved = {k: not torch.equal(end[k].cpu(), v) for k, v in rec["before"].items()}
    per_step = launches_by_kernel(step)
    print(f"[cli-train-seg] lm_loss {[round(x, 4) for x in lm]}, seg_loss "
          f"{[round(x, 4) for x in seg]}; B1/B3 launches a step {per_step}; "
          f"SegVol and seg_projector leaves moved by the updates: {moved}")
    if not all(map(math.isfinite, lm + seg)) or not all(moved.values()) or len(moved) != len(snapshot):
        raise AssertionError("[cli-train-seg] a loss is not finite or the seg "
                             "branch's gradients are zero")
    numbers.update(lm_loss=lm, seg_loss=seg, seg_leaves_moved=moved,
                   launches_per_step_by_kernel=per_step, card=card)
    del state, end
    rec["before"] = {}
    gc.collect()
    torch.cuda.empty_cache()
    shapes = {}
    for counts in (*rec["steps"].values(), rec["after"]):
        for key, n in counts.items():
            shapes[key] = shapes.get(key, 0) + n
    return numbers, shapes, {SEG_BATCH: rec["lens"][0]}


class recording_kv_lens:
    """Within the block, the valid lengths of the first flash forward
    launched at each (kind, batch, heads, sq, skv, head_dim): `lens`."""

    def __enter__(self):
        from hsenet_torch.ops import flash_attention as tfa

        self.tfa, self.inner, self.lens = tfa, tfa._forward, {}

        def spy(q, k, v, kv, q_off, causal, sm_scale, with_lse):
            key = ("flash_fwd_lse" if with_lse else "flash_fwd", *q.shape[:3],
                   k.shape[2], q.shape[3])
            self.lens.setdefault(key, tuple(int(n) for n in kv.tolist()))
            return self.inner(q, k, v, kv, q_off, causal, sm_scale, with_lse)

        tfa._forward = spy
        return self.lens

    def __exit__(self, *exc):
        self.tfa._forward = self.inner


def f32_b1_case(tag, name, b, h, sq, skv, d, kv_lens, gen):
    """B1's f32 route at one shape against its f32 plain version (5e-3 of
    each (batch, head) slice's largest value), beside the same attention
    without the last 64 valid keys (must miss), timed beside the bound at
    the TF32 peak, the plain version and f32 SDPA."""
    import torch
    import torch.nn.functional as F

    from hsenet_torch.ops import flash_attention as tfa

    q = torch.randn(b, h, sq, d, generator=gen, device="cuda")
    k, v = (torch.randn(b, h, skv, d, generator=gen, device="cuda") for _ in range(2))
    kv_t = torch.tensor(kv_lens, dtype=torch.int32, device="cuda")
    off_t = torch.zeros(b, dtype=torch.int32, device="cuda")
    kw = dict(kv_lens=kv_t, causal=False, q_offset=off_t)
    out = tfa.flash_attention(q, k, v, **kw)
    ref = tfa.flash_attention_reference(q, k, v, **kw)
    max_abs, rel = slice_rel(out, ref)
    col = torch.arange(skv, device="cuda")[None, None, None, :]
    drop = slice_rel(forward_dropping(q, k, v, kv_t, off_t, False,
                                      col >= kv_t[:, None, None, None] - 64), ref)[1]
    bound, bound_by, flops, nbytes = kernel_bound(
        "flash_fwd", b, h, sq, skv, d, kv_lens, (0,) * b, False, elem=4,
        peak=PEAK_TF32_FLOPS)
    mask = tfa._valid(q, k, kv_t, off_t, False)
    r = {"max_abs_err": max_abs, "max_slice_rel_err": rel,
         "ms": time_ms(lambda: tfa.flash_attention(q, k, v, **kw)),
         "plain_ms": time_ms(lambda: tfa.flash_attention_reference(q, k, v, **kw),
                             reps=3),
         "library_ms": time_ms(lambda: F.scaled_dot_product_attention(
             q, k, v, attn_mask=mask)),
         "bound_ms": bound, "bound_by": bound_by, "gflop": flops / 1e9,
         "mbytes": nbytes / 1e6}
    print(f"[{tag}] flash_fwd f32 {name}: q{tuple(q.shape)} kv_lens "
          f"{kv_lens if len(set(kv_lens)) > 1 else kv_lens[0]}: err / slice's "
          f"max |ref| {rel:.3e} (tol {KERNEL_F32_TOL}), without the last 64 "
          f"valid keys {drop:.3e}; kernel {r['ms']:.4f} ms, plain "
          f"{r['plain_ms']:.4f} ms, library (f32 SDPA) {r['library_ms']:.4f} ms, "
          f"bound {bound:.4f} ms at the TF32 peak ({bound_by})")
    if not rel <= KERNEL_F32_TOL:
        raise AssertionError(f"the f32 forward disagrees with its plain version at {name}")
    if drop <= KERNEL_F32_TOL:
        raise AssertionError(f"the f32 limit passes 64 dropped keys at {name}")
    return r


def run_cli_evaluate_seg(card: str, root: str, manifest: str):
    """[cli-evaluate-seg]: `evaluate --task seg` on the seg manifest's
    validation split at batch 2 (SegVol at ViT3DConfig(classification=False)
    in f32, as the JAX CLI builds it, random weights from seed 0), its
    prompts embedded by a random stage-1 CLIP (`CLIPConfig()`, f32) that the
    port saves with `save_params` and the CLI restores from
    --clip-checkpoint; then `evaluate --task rec --reference-compatible` on
    the same entries as a PosREC manifest at batch 2, 32 new tokens, with
    `VLMConfig()` (LoRA on Phi-4-mini, bf16, random from seed 0) built with
    the in-graph slice features and passed through `model=` (the grounding
    entries carry no slice features, and the CLI has no flag for them).
    Random weights make the scores meaningless: they are printed, and the
    runs and their launches are held. Returns the numbers, the bf16 and the
    f32 launches by shape and the valid lengths of each shape's first
    launch."""
    import argparse
    import contextlib
    import io
    import os

    import torch

    from hsenet_torch.cli.common import build_vlm_config, random_model
    from hsenet_torch.cli.evaluate import main as evaluate_main
    from hsenet_torch.configs import CLIPConfig
    from hsenet_torch.models.clip import CLIPModel
    from hsenet_torch.models.mllm import HSENetVLM
    from hsenet_torch.utils.checkpoint import save_params

    clip_path = os.path.join(root, "clip_stage1.pt")
    clip = random_model(CLIPModel, CLIPConfig(), dtype=torch.float32,
                        device="cuda", seed=5)
    save_params(clip_path, clip.state_dict())
    del clip
    numbers, lens = {}, {}

    def run(tag, argv, model=None):
        out = io.StringIO()
        with recording_kv_lens() as seen, contextlib.redirect_stdout(out):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            (metrics, shapes, by_kernel, f32) = counted(
                lambda: evaluate_main(argv, model=model))
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        if json.loads(out.getvalue()) != json.loads(json.dumps(metrics)):
            raise AssertionError(f"[cli-evaluate-seg] {tag}: the JSON print is "
                                 "not the result")
        fwd_route(f"cli-evaluate-seg {tag}", by_kernel, f32)
        lens.update(seen)
        print(f"[cli-evaluate-seg] {tag}: evaluate {' '.join(argv)}: {metrics} "
              f"in {wall:.2f} s; flash launches by shape {shapes}")
        return {"metrics": metrics, "wall_s": wall,
                "launches": {" ".join(map(str, k)): n for k, n in shapes.items()}}, shapes

    seg_argv = ["--task", "seg", "--manifest", manifest, "--data-root", root,
                "--batch-size", str(SEG_BATCH), "--clip-checkpoint", clip_path]
    numbers["seg"], seg_shapes = run("seg", seg_argv)
    cfg = seg_vit_config()
    clip_cfg = CLIPConfig()
    text = clip_cfg.text
    batches = (SEG_VOLUMES // 2) // SEG_BATCH
    want = {("flash_fwd", SEG_BATCH, cfg.num_heads, cfg.num_patches, cfg.num_patches,
             cfg.hidden_size // cfg.num_heads): batches * cfg.num_layers,
            ("flash_fwd", SEG_BATCH, text.num_heads, clip_cfg.max_text_len,
             clip_cfg.max_text_len, text.hidden_size // text.num_heads):
                batches * text.num_layers}
    if seg_shapes != want or numbers["seg"]["metrics"]["num_samples"] != SEG_VOLUMES // 2:
        raise AssertionError(f"[cli-evaluate-seg] seg: launches {seg_shapes}, not {want}")

    vlm_cfg = build_vlm_config(argparse.Namespace(synthetic=False,
                                                  online_slice_features=True))
    t0 = time.perf_counter()
    vlm = random_model(HSENetVLM, vlm_cfg, dtype=torch.bfloat16, device="cuda",
                       seed=0)
    print(f"[cli-evaluate-seg] VLMConfig() with LoRA and the in-graph slice "
          f"features, bf16, built in {time.perf_counter() - t0:.1f} s")
    rec_argv = ["--task", "rec", "--reference-compatible", "--manifest", manifest,
                "--data-root", root, "--batch-size", str(SEG_BATCH),
                "--max-new-tokens", str(EVAL_MAX_NEW)]
    numbers["rec"], rec_shapes = run("rec", rec_argv, model=vlm)
    metrics = numbers["rec"]["metrics"]
    if metrics["num_samples"] != SEG_VOLUMES // 2 or not all(
            k in metrics for k in ("mean_iou", "acc@0.25", "acc@0.5")):
        raise AssertionError("[cli-evaluate-seg] rec scored no sample")
    towers = sum(n for k, n in rec_shapes.items() if k[3] == vlm_cfg.vision.seq_len)
    if towers != 2 * vlm_cfg.vision.num_layers * batches:
        raise AssertionError(f"[cli-evaluate-seg] rec: {towers} tower launches")
    del vlm
    gc.collect()
    torch.cuda.empty_cache()
    numbers["card"] = card
    return numbers, rec_shapes, seg_shapes, lens


def check_seg_f32_kernels(path_shapes, lens):
    """[kernel-seg] in f32: B1's f32 route at each shape `evaluate --task
    seg` launched (SegVol's ViT and the CLIP text tower), at that run's
    valid lengths. Returns the results by name and the launch key -> name."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(31)
    results, index = {}, {}
    for key in sorted(path_shapes):
        _, b, h, sq, skv, d = key
        name = index[key] = f"eval_seg_f32_{b}x{h}x{sq}"
        results[name] = f32_b1_case("kernel-seg", name, b, h, sq, skv, d,
                                    lens[key], gen)
    return results, index


def masked_clip_model(cfg, seed: int, quant: bool = False):
    """`MaskedCLIPModel` computing in bf16 with remat, random weights drawn
    on the card (seed `seed`), every parameter an f32 master."""
    import torch

    from hsenet_torch.models import init_random_
    from hsenet_torch.models.clip import MaskedCLIPModel
    from hsenet_torch.train.vlm import to_training_dtypes

    model = MaskedCLIPModel(cfg, dtype=torch.bfloat16, remat=True, device="cuda")
    init_random_(model, torch.Generator(device="cuda").manual_seed(seed))
    return to_training_dtypes(model, {n: True for n, _ in model.named_parameters()})


def masked_clip_launches(cfg, batch, kept):
    """The flash launches of one legacy masked CLIP step: the full stream
    and the masked stream of `kept` patches each through the tower (forward
    twice per block under remat, with the log-sum-exp, and B3), BERT
    once."""
    want = {}
    v = cfg.vision
    for seq in (v.seq_len, kept + 1):
        key = (batch, v.num_heads, seq, seq, v.hidden_size // v.num_heads)
        want[("flash_fwd_lse", *key)] = want.get(("flash_fwd_lse", *key), 0) + 2 * v.num_layers
        want[("flash_bwd", *key)] = want.get(("flash_bwd", *key), 0) + v.num_layers
    t = cfg.text
    text = (batch, t.num_heads, cfg.max_text_len, cfg.max_text_len,
            t.hidden_size // t.num_heads)
    want[("flash_fwd_lse", *text)] = t.num_layers
    want[("flash_bwd", *text)] = t.num_layers
    return want


def run_clip_masked(card: str):
    """[clip-masked]: `MaskedCLIPModel(CLIPConfig())` at batch 24 (bf16 over
    f32 masters, remat) through `make_masked_clip_train_step` at the ramp's
    steps 0, 5000 and 20000 (2048, 1792 and 1280 kept patches): launches by
    shape each step, finite losses, step ms, peak memory; the gradients at
    batch 6 and bucket 1280 against the plain attention path after a few
    steps on the batch, beside two planted backward faults; the W8A8 static
    mode of both streams against bf16 (per-token cosine). Returns the
    numbers and the launches by shape of the three steps."""
    import dataclasses

    import numpy as np
    import torch

    from hsenet_torch.configs import TrainConfig
    from hsenet_torch.models.lora import calibrate_w8a8_act_scales, quantize_towers_w8a8
    from hsenet_torch.models.vit import MaskedViT3D
    from hsenet_torch.ops import attention
    from hsenet_torch.ops import flash_attention as tfa
    from hsenet_torch.train.legacy_clip import (
        bucketed_unmasked_tokens,
        make_masked_clip_train_step,
        masked_clip_loss_fn,
    )
    from hsenet_torch.train.train_state import TrainState, make_optimizer

    cfg = clip_config()
    n_patch = cfg.vision.num_patches
    kept = [bucketed_unmasked_tokens(s, n_patch) for s in MASKED_STEPS]
    if kept[0] != n_patch or len(set(kept)) != len(kept):
        raise AssertionError(f"[clip-masked] buckets {kept}")
    model = masked_clip_model(cfg, seed=7)
    tx = make_optimizer(TrainConfig(learning_rate=1e-4, warmup_ratio=0.0,
                                    schedule="constant"))
    state, step = TrainState.create(model, tx), make_masked_clip_train_step(model, tx)
    batch = {k: torch.as_tensor(v).to("cuda") for k, v in
             clip_batch(cfg, CLIP_BATCH, "clip2", seed=37).items()
             if isinstance(v, np.ndarray)}
    state, _ = step(state, batch, 0, kept[-1])  # warm-up, not counted
    rows, shapes = [], {}
    torch.cuda.reset_peak_memory_stats()
    for s, k in zip(MASKED_STEPS, kept):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        (state, metrics), launched, by_kernel, f32 = counted(
            lambda: step(state, batch, s, k))
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        fwd_route(f"clip-masked {k}", by_kernel, f32)
        want = masked_clip_launches(cfg, CLIP_BATCH, k)
        m = {key: float(v) for key, v in metrics.items()}
        print(f"[clip-masked] step at ramp step {s}: {k} kept patches, {ms:.1f} "
              f"ms, {m}; launches by shape {launched}")
        if launched != want or not all(map(math.isfinite, m.values())):
            raise AssertionError(f"[clip-masked] launches {launched}, not {want}, "
                                 "or a loss is not finite")
        for key, n in launched.items():
            shapes[key] = shapes.get(key, 0) + n
        rows.append({"ramp_step": s, "kept": k, "step_ms": ms, **m})
    peak = torch.cuda.max_memory_allocated() / 1e9
    print(f"[clip-masked] batch {CLIP_BATCH} on {card}: step ms "
          f"{[round(r['step_ms'], 1) for r in rows]}, peak memory {peak:.2f} GB")
    del state, step, batch
    gc.collect()
    torch.cuda.empty_cache()

    # gradients through the kernels against the plain path, after a few
    # steps on the batch pulled the features apart (see [clip-grads])
    small = {k: torch.as_tensor(v).to("cuda") for k, v in
             clip_batch(cfg, CLIP_GRADS_BATCH, "clip2", seed=23).items()
             if isinstance(v, np.ndarray)}
    state, step = TrainState.create(model, tx), make_masked_clip_train_step(model, tx)
    for _ in range(CLIP_GRADS_WARM_STEPS):
        state, metrics = step(state, small, 0, kept[-1])
    names, params = zip(*model.named_parameters())
    groups = {"tower": ("vision_encoder.",), "bert": ("language_encoder.",),
              "projections": ("mm_", "logit_scale")}

    def grads():
        loss, _ = masked_clip_loss_fn(model, small, kept[-1])
        return loss.item(), torch.autograd.grad(loss, params, allow_unused=True)

    def rel_l2(g, ref):
        rel = {}
        for group, prefixes in groups.items():
            idx = [i for i, n in enumerate(names) if n.startswith(prefixes)]
            num = sum((g[i].float() - ref[i].float()).pow(2).sum() for i in idx)
            den = sum(ref[i].float().pow(2).sum() for i in idx)
            rel[group] = (num / den).sqrt().item()
        return rel

    loss_k, g_k = grads()
    try:
        attention.set_flash_mode("never")
        loss_p, g_p = grads()
    finally:
        attention.set_flash_mode("auto")
    rel = rel_l2(g_k, g_p)
    del g_k
    sound = tfa.flash_attention_backward
    faults = {"delta left out": lambda q, k, v, o, *rest: sound(
                  q, k, v, torch.zeros_like(o), *rest),
              "no attention gradient": lambda q, k, v, *rest: tuple(
                  torch.zeros_like(t) for t in (q, k, v))}
    wrong = {}
    for fault, backward in faults.items():
        try:
            tfa.flash_attention_backward = backward
            _, g_w = grads()
        finally:
            tfa.flash_attention_backward = sound
        wrong[fault] = rel_l2(g_w, g_p)
        del g_w
    print(f"[clip-masked] gradients at batch {CLIP_GRADS_BATCH}, {kept[-1]} kept, "
          f"after {CLIP_GRADS_WARM_STEPS} steps: loss kernel {loss_k:.6f} vs plain "
          f"{loss_p:.6f}; rel L2 by " + ", ".join(f"{g} {r:.3e}" for g, r in rel.items())
          + f" (tol {TRAIN_GRAD_REL_L2}); planted faults: "
          + "; ".join(f"{f}: " + ", ".join(f"{g} {r:.3e}" for g, r in w.items())
                      for f, w in wrong.items()))
    if max(rel.values()) > TRAIN_GRAD_REL_L2:
        raise AssertionError("[clip-masked] gradients through the kernels "
                             "disagree with the plain path")
    for fault, w in wrong.items():
        if max(w["tower"], w["bert"]) <= TRAIN_GRAD_REL_L2:
            raise AssertionError(f"[clip-masked] the gradient limit passes {fault}")
    del state, step, params, g_p, small
    gc.collect()
    torch.cuda.empty_cache()

    # W8A8 static mode of both streams: int8 tower blocks, activation scales
    # calibrated on the batch, against the bf16 encoder of the same weights
    enc = model.vision_encoder.eval()
    qcfg = dataclasses.replace(cfg.vision, quant_w8a8=True, quant_w8a8_static=True)
    qenc = MaskedViT3D(qcfg, dtype=torch.bfloat16, device="cuda")
    qenc.load_state_dict(quantize_towers_w8a8(
        {k: v.detach() for k, v in enc.state_dict().items()}, static=True), strict=True)
    wbatch = clip_batch(cfg, MASKED_W8A8_BATCH, "clip2", seed=47)
    args = (torch.as_tensor(wbatch["image"]).to("cuda"),
            torch.as_tensor(wbatch["image_2d"]).to("cuda"), kept[-1])
    with torch.no_grad():
        calibrate_w8a8_act_scales(qenc.eval(), [args])
        got = qenc(*args)
        want = enc(*args)
    cos = {name: token_cosines(g, w) for name, g, w in
           zip(("full", "masked"), got, want)}
    print(f"[clip-masked] W8A8 static, batch {MASKED_W8A8_BATCH}, {kept[-1]} kept: "
          "per-token cosine against bf16: " + ", ".join(
              f"{n} min {c.min().item():.5f} mean {c.mean().item():.5f}"
              for n, c in cos.items()) + f" (limit min >= {W8A8_COSINE_MIN})")
    if min(c.min().item() for c in cos.values()) < W8A8_COSINE_MIN:
        raise AssertionError("[clip-masked] the W8A8 streams miss bf16")
    del model, enc, qenc, got, want
    gc.collect()
    torch.cuda.empty_cache()
    return {"steps": rows, "peak_memory_gb": peak, "grad_rel_l2": rel,
            "planted_faults_rel_l2": wrong, "loss_kernel": loss_k,
            "loss_plain": loss_p,
            "w8a8_cosine": {n: {"min": c.min().item(), "mean": c.mean().item()}
                            for n, c in cos.items()}, "card": card}, shapes


def run_remat_dots(model, names, params, batch):
    """[remat-dots]: [train]'s finetune step (3 x 800) with Phi remat policy
    "dots" against "full" on the same model and batch: the trainable
    leaves' gradients (relative L2 by group, limit REMAT_DOTS_REL_L2), the
    forward + backward ms and the peak memory of each."""
    import dataclasses

    import torch

    from hsenet_torch.train.vlm import vlm_loss_fn

    decoder = model.llm.decoder
    full_cfg = decoder.config
    out = {}
    for policy in ("full", "dots"):
        decoder.config = dataclasses.replace(full_cfg, remat_policy=policy)

        def grads():
            loss, _ = vlm_loss_fn(model, batch)
            return torch.autograd.grad(loss, params)

        try:
            g = grads()
            ms = median_wall_ms(grads, runs=3)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            grads()
            torch.cuda.synchronize()
            peak = torch.cuda.max_memory_allocated() / 1e9
        finally:
            decoder.config = full_cfg
        out[policy] = {"grads": g, "ms": ms, "peak_gb": peak}
    groups = {"lora": "lora_", "packers": "mm_projector", "embedding": "llm.embed"}
    rel = {}
    for group, key in groups.items():
        idx = [i for i, n in enumerate(names) if key in n]
        num = sum((out["dots"]["grads"][i].float() - out["full"]["grads"][i].float())
                  .pow(2).sum() for i in idx)
        den = sum(out["full"]["grads"][i].float().pow(2).sum() for i in idx)
        rel[group] = (num / den).sqrt().item()
    print(f"[remat-dots] finetune step 3 x 800: gradient rel L2 dots against full "
          + ", ".join(f"{g} {r:.3e}" for g, r in rel.items())
          + f" (limit {REMAT_DOTS_REL_L2}); forward + backward ms full "
          f"{out['full']['ms']:.1f}, dots {out['dots']['ms']:.1f}; peak memory "
          f"full {out['full']['peak_gb']:.2f} GB, dots {out['dots']['peak_gb']:.2f} GB")
    if max(rel.values()) > REMAT_DOTS_REL_L2:
        raise AssertionError("[remat-dots] the dots policy's gradients miss full's")
    return {"grad_rel_l2": rel,
            **{f"{p}_ms": out[p]["ms"] for p in out},
            **{f"{p}_peak_gb": out[p]["peak_gb"] for p in out}}


# ---- the parallel slice: [dist-world1], [dist-tp2], [dist-dp2], [kernel-tp] ----

# the dist phases run the CLIs' models at VLMConfig(), all 32 LLM layers
DIST_STEPS = 2
# [dist-pp2]'s train_vlm runs; [dist-world1]'s plain VLM run takes as many
# and the other parallel VLM runs read its first steps
PP_STEPS = 3
DIST_WORLD1_RTOL = 1e-3  # a one-rank group against the plain run
DIST_REL_TOL = 5e-2  # two ranks against one process (relative L2, bf16)
# the trained leaves' move (trained - initial) against one process's: an
# early Adam step moves an element by about lr x sign(g), so an element
# whose gradient rounding carries across 0 moves the other way; a quarter
# of the move is far above that and far below a move of other gradients
DIST_MOVE_TOL = 0.25
# [dist-dp2]'s VLM runs cut the LLM to this depth: under FSDP two ranks on
# one card gather every layer through the host (gloo), ~0.5 s a layer a
# step; the other phases keep all 32 layers
DP2_LLM_LAYERS = 4
DIST_TIMEOUT = 600  # seconds a world of two ranks may take
DIST_SERVE_REQUESTS = 4
DIST_SERVE_NEW = 24
DIST_EVAL_NEW = 16
DIST_CLIP_SEED = 51
# [dist-sp2]'s fine-patch tower: the query block of each hop of the ring
# (at 8,193 tokens a rank, a (1024, 8193) f32 score block a head)
SP_LONG_BLOCK_Q = 1024
SP_LONG_BATCH = 1  # [dist-sp2]'s fine-patch tower, one volume
# [dist-sp2]'s CLIP CLI runs: K/V of 1025 tokens a rank cross the host
# every hop (gloo), ~10 s a step at batch 24
SP_CLIP_BATCH = 4
SP_CAUSAL_LENS = (800, 613)  # [dist-sp2]'s causal ring check, by row
PP_EVAL_NEW = 4  # [dist-pp2]'s evaluate on the run's deltas
# B5 at Phi-4-mini's tensor-parallel shards (tp = 2): (K, N) of q, k and v,
# gate and up (column-parallel: N / 2), o and down (row-parallel: K / 2)
TP_MATVEC_SHAPES = {"tp2_q_3072x1536": (3072, 1536), "tp2_kv_3072x512": (3072, 512),
                    "tp2_gate_up_3072x4096": (3072, 4096),
                    "tp2_o_1536x3072": (1536, 3072), "tp2_down_4096x3072": (4096, 3072)}
TP_MATVEC_PER_LAYER = {"tp2_q_3072x1536": 1, "tp2_kv_3072x512": 2,
                       "tp2_gate_up_3072x4096": 2, "tp2_o_1536x3072": 1,
                       "tp2_down_4096x3072": 1}
# the [main] path's prefill at tp = 2: 12 of the 24 heads, 320 tokens over
# a 352-slot cache
TP_PREFILL = ("flash_fwd", len(KV_LENS), 12, PROMPT_LEN, PROMPT_LEN + MAX_NEW_TOKENS,
              128)


class patched:
    """Set attributes for the block: patched((obj, name, value), ...)."""

    def __init__(self, *patches):
        self.patches = patches

    def __enter__(self):
        self.saved = [(obj, name, getattr(obj, name)) for obj, name, _ in self.patches]
        for obj, name, value in self.patches:
            setattr(obj, name, value)

    def __exit__(self, *exc):
        for obj, name, value in self.saved:
            setattr(obj, name, value)


def dist_vlm_config():
    import argparse

    from hsenet_torch.cli.common import build_vlm_config

    return build_vlm_config(argparse.Namespace(synthetic=False))


def dist_vlm_model(llm_layers=None):
    """The training CLIs' VLM (`build_vlm_config`: VLMConfig() with LoRA,
    its LLM cut to `llm_layers` layers if given) with every dropout rate at
    0, drawn on the card from train_vlm's default seed, for
    `train_vlm.main(model=)`: dp ranks draw their own dropout masks, so the
    runs compared across layouts train without dropout."""
    import dataclasses
    import functools

    import torch

    from hsenet_torch.cli.common import random_model
    from hsenet_torch.models.mllm import HSENetVLM

    cfg = dist_vlm_config()
    cfg = dataclasses.replace(
        cfg, vision=dataclasses.replace(cfg.vision, dropout_rate=0.0,
                                        slice_dropout_rate=0.0),
        packer=dataclasses.replace(cfg.packer, dropout_rate=0.0),
        llm=dataclasses.replace(cfg.llm, num_layers=llm_layers or cfg.llm.num_layers,
                                lora=dataclasses.replace(cfg.llm.lora,
                                                         dropout_rate=0.0)))
    return random_model(functools.partial(HSENetVLM, remat=True), cfg,
                        dtype=torch.bfloat16, device="cuda", seed=42)


def dist_requests(cfg):
    """DIST_SERVE_REQUESTS multimodal requests from a numpy seed, over two
    volumes: BOS, the image block, 16 + 8 i text tokens."""
    import numpy as np

    rng = np.random.default_rng(57)
    n_img = cfg.num_image_tokens
    vols = [rng.random((1, *cfg.vision.image_size), np.float32) for _ in range(2)]
    feats = [rng.standard_normal((cfg.vision.num_slices, cfg.vision.slice_feature_dim)
                                 ).astype(np.float32) for _ in range(2)]
    out = []
    for i in range(DIST_SERVE_REQUESTS):
        ids = rng.integers(3, 100000, 1 + n_img + 16 + 8 * i).astype(np.int32)
        ids[0] = 1
        ids[1:1 + n_img] = IM_PATCH_TOKEN_ID
        out.append({"id": f"r{i}", "prompt_ids": ids, "volume": vols[i % 2],
                    "slice_features": feats[i % 2], "vol": i % 2})
    return out


def write_dist_data(root):
    """The dist phases' data under `root`: [cli-train]'s volumes and CLIP and
    MRG manifests (two train entries, each with its own report);
    [cli-evaluate]'s MRG manifest under `root/eval`; the serving requests as
    JSONL over .npy files. Returns the paths by name."""
    import os

    import numpy as np

    paths = write_train_cli_data(root)
    cfg = dist_vlm_config()
    paths["eval_root"] = os.path.join(root, "eval")
    os.makedirs(paths["eval_root"])
    paths["eval"] = write_eval_data(paths["eval_root"], cfg)["mrg"]
    paths["requests"] = os.path.join(root, "requests.jsonl")
    with open(paths["requests"], "w") as f:
        for r in dist_requests(cfg):
            vol = os.path.join(root, f"req_vol{r['vol']}.npy")
            feat = os.path.join(root, f"req_feat{r['vol']}.npy")
            np.save(vol, r["volume"])
            np.save(feat, r["slice_features"])
            f.write(json.dumps({"id": r["id"], "prompt_ids": r["prompt_ids"].tolist(),
                                "max_new": DIST_SERVE_NEW, "volume": vol,
                                "slice_features": feat}) + "\n")
    return paths


def dist_train_argv(paths, kind, out, total=DIST_STEPS):
    # lr 1e-3: the second step (the first runs at the warmup's 0) moves a
    # leaf by about 1e-3, well above the runs' rounding
    steps = ["--total-steps", str(total), "--log-every", "1", "--eval-every", "0",
             "--checkpoint-every", "1000", "--remat", "--learning-rate", "1e-3",
             "--data-root", paths["root"], "--output-dir", out]
    if kind == "clip":
        return ["--manifest", paths["clip"], "--batch-size",
                str(TRAIN_CLI_BATCH["clip"])] + steps
    return ["--task", "mrg", "--manifest", paths["mrg"], "--batch-size",
            str(TRAIN_CLI_BATCH["mrg"])] + steps


def dist_eval_argv(paths, batch):
    return ["--task", "mrg", "--manifest", paths["eval"], "--data-root",
            paths["eval_root"], "--batch-size", str(batch), "--max-new-tokens",
            str(DIST_EVAL_NEW)]


def dist_train(tag, main, argv, snapshot=()):
    """`run_train_cli` of one training CLI: (state, record); the record's
    flash launches by shape over the whole run under "shapes". The run's
    output directory (its exports: 2.4 GB of token table for the VLM) is
    removed after it."""
    import shutil

    state, rec = run_train_cli(tag, main, argv, snapshot)
    shutil.rmtree(argv[argv.index("--output-dir") + 1], ignore_errors=True)
    shapes = dict(rec["after"])
    for counts in rec["steps"].values():
        for k, n in counts.items():
            shapes[k] = shapes.get(k, 0) + n
    rec["shapes"] = shapes
    return state, rec


def dist_eval(tag, argv):
    """`evaluate.main(argv)` counted: (metrics with the generated ids of
    every row in order under "ids", the flash launches by shape, the first
    batch's prompt lengths)."""
    import contextlib
    import io

    import torch

    from hsenet_torch.cli.evaluate import main as evaluate_main
    from hsenet_torch.ops import flash_attention as tfa

    reset_counts()
    with recording_generate() as calls, contextlib.redirect_stdout(io.StringIO()):
        t0 = time.perf_counter()
        metrics = evaluate_main(argv)
        torch.cuda.synchronize()
    fwd_route(f"dist {tag}", tfa.launches, tfa.f32_launches)
    print(f"[dist] {tag}: evaluate {' '.join(argv)}: {metrics['num_samples']} "
          f"samples in {time.perf_counter() - t0:.2f} s")
    ids = [row for _, out in calls for row in out.tolist()]
    lens = tuple(int(n) for n in calls[0][0]["attention_mask"].sum(-1))
    return {**metrics, "ids": ids}, dict(tfa.shape_launches), lens


def trainable_rel(got, want):
    """Relative L2 distance of two {name: tensor} sets over all leaves."""
    num = sum((got[k].float() - want[k].float().to(got[k].device)).pow(2).sum().item()
              for k in want)
    den = sum(w.float().pow(2).sum().item() for w in want.values())
    return math.sqrt(num / den)


def move_rel(got, want, before):
    """Relative L2 distance of two trained {name: tensor} sets over the
    move of `want` from `before` (trained - initial), on the host."""
    num = sum((got[k].float().cpu() - want[k].float().cpu()).pow(2).sum().item()
              for k in want)
    den = sum((want[k].float().cpu() - before[k].float().cpu()).pow(2).sum().item()
              for k in want)
    return math.sqrt(num / den)


class recorded_lora_grads:
    """Within the block, each VLM train step's gradients of the LoRA leaves,
    as the step's norm reads them (after the dp reduction), land in the
    list in bf16 on the host. With `leaves`, `self.leaves` gets the LoRA
    leaves as each step found them (f32 on the host): from the second step
    on, the leaves the step before trained."""

    def __init__(self, leaves=False):
        self.keep_leaves = leaves
        self.leaves = []

    def __enter__(self):
        import torch

        from hsenet_torch.train import vlm as tvlm

        self.real = real = tvlm.global_norm
        steps = self.steps = []

        def spy(grads, names, model):
            steps.append({n: g.detach().to(torch.bfloat16).cpu()
                          for n, g in zip(names, grads) if "lora_" in n})
            if self.keep_leaves:
                self.leaves.append({n: p.detach().float().cpu() for n, p in
                                    model.named_parameters() if "lora_" in n})
            return real(grads, names, model)

        tvlm.global_norm = spy
        return steps

    def __exit__(self, *exc):
        from hsenet_torch.train import vlm as tvlm

        tvlm.global_norm = self.real


def losses_rel(got, want):
    return max(abs(a - b) / abs(b) for a, b in zip(got, want))


def logged(rec, key="loss"):
    return [m[key] for _, m in rec["logged"]]


def run_dist_world1(card, paths):
    """[dist-world1]: at VLMConfig(), the plain runs (no process group) of
    train_clip_stage1, train_vlm (PP_STEPS steps, the LoRA leaves recorded
    after each: the reference of every parallel VLM run) and evaluate
    (batch 1), then in a one-rank
    NCCL group train_clip_stage1 --zero1, train_vlm --zero1 and --fsdp and
    evaluate --dp 1 --tp 1 (train_vlm on `dist_vlm_model`, without dropout):
    the losses and the trained leaves within DIST_WORLD1_RTOL of the plain
    runs' (the untrained leaves must miss),
    the reports equal; each VLM run's step peak of device memory. Returns
    (numbers, flash launches by shape of the counted runs, the LLM's batch
    lengths by batch size, the plain VLM run's record, the plain eval's
    metrics, its first batch's prompt lengths, the plain VLM run's LoRA
    leaves after DIST_STEPS and after each step, and each step's LoRA
    gradients)."""
    import os

    import torch
    import torch.distributed as dist

    from hsenet_torch.cli import train_clip_stage1, train_vlm

    root = paths["root"]
    numbers, shapes, lens = {}, {}, {}

    def add(counts):
        for k, n in counts.items():
            shapes[k] = shapes.get(k, 0) + n

    def trained(state):
        return {k: v.detach().clone() for k, v in state.params.items()}

    s1, s1_rec = dist_train("dist-world1 stage 1 plain", train_clip_stage1.main,
                            dist_train_argv(paths, "clip", os.path.join(root, "w1_s1")),
                            snapshot=("mm_vision_proj",))
    plain_s1 = trained(s1)
    del s1
    def vlm_main(argv):
        return train_vlm.main(argv, model=dist_vlm_model())

    # the one plain VLM run of the parallel phases: PP_STEPS steps, each
    # step's LoRA gradients and the LoRA leaves after it; the DIST_STEPS-step
    # runs read its first steps
    spy = recorded_lora_grads(leaves=True)
    with spy as plain_grads:
        vlm, vlm_rec = dist_train("dist-world1 vlm plain", vlm_main,
                                  dist_train_argv(paths, "mrg",
                                                  os.path.join(root, "w1_vlm"),
                                                  PP_STEPS),
                                  snapshot=("lora_",))
    by_step = spy.leaves[1:] + [{k: v.cpu() for k, v in trained(vlm).items()
                                 if "lora_" in k}]
    plain_vlm = by_step[DIST_STEPS - 1]
    del vlm
    gc.collect()
    torch.cuda.empty_cache()
    plain_eval, eval_shapes, eval_lens = dist_eval("dist-world1 evaluate plain",
                                                   dist_eval_argv(paths, 1))
    for rec in (s1_rec, vlm_rec):
        add(rec["shapes"])
        for n in rec["lens"]:
            lens.setdefault(len(n), n)
    add(eval_shapes)

    os.environ.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(free_port()),
                      RANK="0", WORLD_SIZE="1", LOCAL_RANK="0")
    try:
        runs = {}
        st, rec = dist_train("dist-world1 stage 1 --zero1", train_clip_stage1.main,
                             dist_train_argv(paths, "clip", os.path.join(root, "w1_s1z"))
                             + ["--zero1"])
        backend = dist.get_backend()
        runs["stage1_zero1"] = (rec, trained(st), s1_rec, plain_s1)
        del st
        for flag in ("--zero1", "--fsdp"):
            st, rec = dist_train(f"dist-world1 vlm {flag}", vlm_main,
                                 dist_train_argv(paths, "mrg",
                                                 os.path.join(root, f"w1_vlm{flag}"))
                                 + [flag])
            runs[f"vlm_{flag[2:]}"] = (rec, {k: v for k, v in trained(st).items()
                                             if "lora_" in k}, vlm_rec, plain_vlm)
            del st
            gc.collect()
            torch.cuda.empty_cache()
        grouped_eval, g_shapes, _ = dist_eval("dist-world1 evaluate --dp 1 --tp 1",
                                           dist_eval_argv(paths, 1) + ["--dp", "1",
                                                                       "--tp", "1"])
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
        for key in ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE", "LOCAL_RANK"):
            os.environ.pop(key, None)
    print(f"[dist-world1] on {card}: a one-rank {backend} group")
    if backend != "nccl":
        raise AssertionError(f"[dist-world1] the group's backend is {backend}, not nccl")
    for name, (rec, params, plain_rec, plain) in runs.items():
        add(rec["shapes"])
        # the plain run's first steps: the VLM's ran PP_STEPS
        plain_losses = logged(plain_rec)[:len(logged(rec))]
        loss_rel = losses_rel(logged(rec), plain_losses)
        rel = trainable_rel(params, plain)
        before = {k: v for k, v in plain_rec["before"].items() if k in plain}
        wrong = trainable_rel(before, {k: plain[k] for k in before})
        print(f"[dist-world1] {name}: losses {logged(rec)} against the plain run's "
              f"{plain_losses}: max relative difference {loss_rel:.3e}; the "
              f"trained leaves ({len(plain)}) at relative L2 {rel:.3e} (limit "
              f"{DIST_WORLD1_RTOL}); wrong variant, the leaves before training: "
              f"{wrong:.3e}; device memory peak {rec['peak_gb']:.2f} GB, in the "
              f"steps {rec['step_peak_gb']:.2f} GB (the plain run's "
              f"{plain_rec['step_peak_gb']:.2f} GB)")
        if not (loss_rel <= DIST_WORLD1_RTOL and rel <= DIST_WORLD1_RTOL):
            raise AssertionError(f"[dist-world1] {name} is not the plain run")
        if wrong <= DIST_WORLD1_RTOL:
            raise AssertionError(f"[dist-world1] the limit passes untrained leaves ({name})")
        numbers[name] = {"losses": logged(rec), "plain_losses": plain_losses,
                         "loss_rel": loss_rel, "params_rel": rel, "wrong_rel": wrong,
                         "wall_s": rec["wall_s"], "step_ms": rec["step_ms"],
                         "peak_gb": rec["peak_gb"], "step_peak_gb": rec["step_peak_gb"],
                         "plain_step_peak_gb": plain_rec["step_peak_gb"]}
    add(g_shapes)
    same = grouped_eval == plain_eval
    print(f"[dist-world1] evaluate --dp 1 --tp 1 in the group: reports equal to "
          f"the plain run's: {same} (bleu {grouped_eval.get('bleu')})")
    if not same:
        raise AssertionError("[dist-world1] evaluate's reports differ in the group")
    numbers["evaluate"] = {"equal": same}
    return (numbers, shapes, lens, vlm_rec, plain_eval, eval_lens,
            {"leaves": plain_vlm, "by_step": by_step, "grads": plain_grads})


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_ranks(phase, root, world=2):
    """`python chip_smoke.py --dist-rank <phase> <root>` as `world` ranks of
    one gloo group on the card (two ranks cannot share one card over
    NCCL), each child's output printed after it; a child that fails or
    overruns DIST_TIMEOUT fails the phase, and every child is stopped.
    Returns rank 0's results (`<root>/<phase>.pt`)."""
    import os

    import torch

    env = {**os.environ, "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(free_port()),
           "WORLD_SIZE": str(world)}
    procs = [subprocess.Popen(
        [sys.executable, str(Path(__file__).resolve()), "--dist-rank", phase, root],
        env={**env, "RANK": str(r), "LOCAL_RANK": str(r)}, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(world)]
    t0 = time.perf_counter()
    try:
        outs = [p.communicate(timeout=DIST_TIMEOUT)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, out) in enumerate(zip(procs, outs)):
        for line in out.splitlines()[-60:]:
            print(f"[{phase} rank {r}] {line}")
        if p.returncode != 0:
            raise AssertionError(f"[{phase}] rank {r} exited with {p.returncode}")
    print(f"[{phase}] two ranks on one card over gloo: {time.perf_counter() - t0:.1f} s")
    return torch.load(os.path.join(root, f"{phase}.pt"), weights_only=False)


def dist_serve_argv(paths, out):
    return ["--quant-int8", "--kv-int8", "--requests", paths["requests"], "--output",
            out, "--slots", str(SERVE_SLOTS), "--chunk", str(SERVE_CHUNK),
            "--prompt-cap", str(SERVE_PROMPT_CAP), "--max-new-tokens",
            str(DIST_SERVE_NEW), "--eos-token-id", str(EOS_TOKEN_ID), "--seed", "0"]


def dist_generate_inputs():
    import torch

    gen = torch.Generator(device="cuda").manual_seed(58)
    ids = torch.randint(3, 100000, (len(KV_LENS), PROMPT_LEN), generator=gen,
                        device="cuda")
    for row, n in enumerate(KV_LENS):
        ids[row, n:] = 0
    return ids, torch.tensor(KV_LENS, dtype=torch.int32, device="cuda")


class captured_engines:
    """Within the block, every `ServingEngine` built lands in the list."""

    def __enter__(self):
        from hsenet_torch import serving

        self.real, made = serving.ServingEngine, []

        class Recorded(self.real):
            def __init__(self, *a, **kw):
                super().__init__(*a, **kw)
                made.append(self)

        serving.ServingEngine = Recorded
        return made

    def __exit__(self, *exc):
        from hsenet_torch import serving

        serving.ServingEngine = self.real


def dist_serve(tag, paths, out, extra=()):
    """The serve CLI on the dist requests, counted; then one admission's
    first-token logits for request 0 and greedy generate over the [main]
    path's two prompts on the engine's LLM (counted apart). Returns a dict
    of the results and the engine."""
    import contextlib
    import io

    import torch

    from hsenet_torch.cli import serve
    from hsenet_torch.eval.generate import make_greedy_generate_llm_only
    from hsenet_torch.ops import flash_attention as tfa
    from hsenet_torch.ops import quant_matvec as tqm

    with captured_engines() as made, contextlib.redirect_stdout(io.StringIO()):
        reset_counts()
        t0 = time.perf_counter()
        summary = serve.main(dist_serve_argv(paths, out) + list(extra))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    eng = made[0]
    fwd_route(f"dist {tag}", tfa.launches, tfa.f32_launches)
    res = {"summary": summary, "wall_s": wall, "steps": eng.steps_run,
           "matvec": tqm.launches[tqm.KERNEL], "fma": tqm.fma_launches[tqm.FMA],
           "shapes": dict(tfa.shape_launches), "cache_heads": eng._cache.k.shape[2],
           "heads": (eng.model.config.llm.num_heads, eng.model.config.llm.num_kv_heads)}
    ids, lens = dist_generate_inputs()
    reset_counts()
    gen = make_greedy_generate_llm_only(eng.model.llm, max_new_tokens=MAX_NEW_TOKENS,
                                        eos_token_id=EOS_TOKEN_ID,
                                        cache_dtype=torch.bfloat16)
    t0 = time.perf_counter()
    res["gen_tokens"] = gen(ids, lens).cpu()
    torch.cuda.synchronize()
    res["gen_wall_s"] = time.perf_counter() - t0
    res["gen_matvec"] = tqm.launches[tqm.KERNEL]
    res["gen_shapes"] = dict(tfa.shape_launches)
    request = dist_requests(eng.model.config)[0]
    request = {**request, "volume": request["volume"][None],
               "slice_features": request["slice_features"][None]}
    res["logits"] = admission_logits(eng, request).float().cpu()
    return res, eng, request


def dist_child_tp2(root):
    """Rank of [dist-tp2]: serve --quant-int8 --kv-int8 --tp 2, the
    admission logits with the row-parallel all-reduce and without it (the
    wrong variant), generate at tp = 2."""
    import os

    import torch

    from hsenet_torch.models import lora

    with open(os.path.join(root, "paths.json")) as f:
        paths = json.load(f)
    res, eng, request = dist_serve("tp2", paths, os.path.join(root, "tp2.jsonl"),
                                   ("--tp", "2"))
    with patched((lora, "reduce_from_group", lambda x, group: x)):
        res["wrong_logits"] = admission_logits(eng, request).float().cpu()
    res["model_layers"] = eng.model.config.llm.num_layers
    return res


def run_dist_tp2(card, paths):
    """[dist-tp2]: the serve CLI at VLMConfig() (int8 weights and KV cache,
    8 slots, all 32 LLM layers) on two ranks with
    --tp 2 against one process: tokens equal or parting at a near-tie,
    the admission's first-token logits within DIST_REL_TOL (relative L2)
    where the variant without the row-parallel all-reduce must miss; B5
    launched 7 x layers per decode step at the shard shapes, B1 at 12
    heads; greedy generate over the [main] path's prompts likewise.
    Returns (numbers, the ranks' launches)."""
    import os

    import torch

    from hsenet_torch.models.phi3 import KVCache

    root = paths["root"]
    one, eng, _ = dist_serve("tp1", paths, os.path.join(root, "tp1.jsonl"))
    two = run_ranks("dist-tp2", root)

    def rows(path):
        with open(path) as f:
            return {r["id"]: r["tokens"] for r in map(json.loads, f)}

    want, got = rows(os.path.join(root, "tp1.jsonl")), rows(os.path.join(root, "tp2.jsonl"))
    if set(want) != set(got) or len(want) != DIST_SERVE_REQUESTS:
        raise AssertionError("[dist-tp2] the two runs did not serve the same requests")
    model, cfg = eng.model, eng.model.config
    reqs = {r["id"]: r for r in dist_requests(cfg)}
    diverged = []
    for rid in sorted(want):
        div = first_divergence(got[rid], want[rid])
        if div is None:
            continue
        r = reqs[rid]
        # the margin on f32 logits of the last hidden state (the model's
        # own head rounds them to bf16)
        prefix = torch.tensor([list(r["prompt_ids"]) + want[rid][:div]], device="cuda")
        with torch.inference_mode():
            cache = KVCache.create(cfg.llm, 1, prefix.shape[1], device="cuda")
            embeds = model.multimodal_embeds(
                prefix, torch.as_tensor(r["volume"][None], device="cuda"),
                torch.as_tensor(r["slice_features"][None], device="cuda"))
            _, _, hidden = model.llm.decode_embeds(
                embeds, cache=cache, return_hidden=True,
                kv_lens=torch.tensor([prefix.shape[1]], dtype=torch.int32,
                                     device="cuda"))
            logits = f32_head_logits(model.llm, hidden[0, -1])
        chosen = got[rid][div] if div < len(got[rid]) else None
        diverged.append((rid, div, *next_token_margin(logits, chosen)))
    check_near_ties("dist-tp2 serve", diverged)
    ids, lens = dist_generate_inputs()
    gen_div = []
    for row in range(len(KV_LENS)):
        g, w = two["gen_tokens"][row].tolist(), one["gen_tokens"][row].tolist()
        _, d = greedy_divergences(cfg, model.llm, ids[row:row + 1, :lens[row]], g, w)
        gen_div += [(row, *x[1:]) for x in d]
    check_near_ties("dist-tp2 generate", gen_div)
    rel = rel_l2(two["logits"], one["logits"])
    wrong = rel_l2(two["wrong_logits"], one["logits"])
    layers = two["model_layers"]
    want_b5 = 7 * layers * two["steps"]
    print(f"[dist-tp2] on {card}: serve --quant-int8 --kv-int8 --tp 2 "
          f"({DIST_SERVE_REQUESTS} requests, {SERVE_SLOTS} slots, {layers} LLM layers): "
          f"each rank holds {two['heads']} (query, kv) heads, a cache of "
          f"{two['cache_heads']} kv heads; requests equal to one process's: "
          f"{sum(got[k] == want[k] for k in want)}/{len(want)}, partings "
          f"{[(d[0], d[1]) for d in diverged]}; generate rows parting "
          f"{[(d[0], d[1]) for d in gen_div]}; admission logits relative L2 {rel:.3e} "
          f"(limit {DIST_REL_TOL}), without the row-parallel all-reduce "
          f"{wrong:.3e}; B5 launches a rank {two['matvec']} (expected {want_b5} = 7 x "
          f"{layers} x {two['steps']} steps); wall {two['wall_s']:.2f} s against one "
          f"process's {one['wall_s']:.2f} s (two ranks sharing one card over gloo "
          f"through the host: not a tensor-parallel speed)")
    if not rel <= DIST_REL_TOL:
        raise AssertionError("[dist-tp2] the tp = 2 logits are not one process's")
    if wrong <= DIST_REL_TOL:
        raise AssertionError("[dist-tp2] the limit passes the missing all-reduce")
    if two["matvec"] != want_b5 or two["fma"]:
        raise AssertionError("[dist-tp2] B5 launches are not 7 per layer and step")
    if two["heads"] != (12, 4) or two["cache_heads"] != 4:
        raise AssertionError(f"[dist-tp2] a rank holds {two['heads']} heads")
    numbers = {"requests_equal": sum(got[k] == want[k] for k in want),
               "partings": diverged, "generate_partings": gen_div,
               "logits_rel": rel, "wrong_logits_rel": wrong,
               "wall_s": two["wall_s"], "one_process_wall_s": one["wall_s"],
               "gen_wall_s": two["gen_wall_s"], "decode_steps": two["steps"],
               "matvec_launches_per_rank": two["matvec"],
               "note": "two ranks share one card over gloo: times are no tp speed"}
    del eng, model
    return numbers, two


def clip_step_grads(model, batch):
    """The stage-1 loss of `batch` and its gradients (averaged over dp where
    the model is placed on a mesh), deterministic."""
    import torch

    from hsenet_torch.train.stage1 import stage1_loss_fn
    from hsenet_torch.train.train_state import reduce_gradients

    params = dict(model.named_parameters())
    loss, _ = stage1_loss_fn(model, batch, None)
    grads = torch.autograd.grad(loss, list(params.values()), allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(params.values(), grads)]
    mesh = model.__dict__.get("mesh")
    if mesh is not None:
        grads = reduce_gradients(grads, list(params), model, mesh)
    return loss.detach(), dict(zip(params, grads))


def dist_clip_batch(rows=None):
    import torch

    batch = clip_batch(clip_config(), CLIP_BATCH, "clip", seed=DIST_CLIP_SEED)
    out = {k: torch.as_tensor(batch[k]).cuda() for k in ("image", "input_ids",
                                                        "attention_mask")}
    return out if rows is None else {k: v[rows] for k, v in out.items()}


def gather_keeping_own(x, group, dim=0):
    """[dist-dp2]'s wrong variant of the feature gather: the other ranks'
    rows without their gradient, this rank's own with it."""
    import torch
    import torch.distributed as dist

    from hsenet_torch.parallel.mesh import all_gather

    parts = list(all_gather(x, group, dim).split(x.shape[dim], dim))
    parts[dist.get_rank(group)] = x
    return torch.cat(parts, dim)


def dist_child_dp2(root):
    """Rank of [dist-dp2]: the CLIP stage-1 step at batch 24 (12 rows a rank)
    and with the wrong gather; train_vlm --dp 2 at DP2_LLM_LAYERS layers with
    --zero1, with --fsdp, with --fsdp --int8-base (one step) and with
    --zero1 where each rank keeps its own gradients (the wrong variant),
    each against the one-process run's LoRA gradients and trained LoRA
    leaves (`vlm_ref_dp2.pt`); evaluate --dp 2 (and with each
    rank's own ids beside zeros in place of the gathered ones, the wrong
    variant)."""
    import os

    import torch
    import torch.distributed as dist

    from hsenet_torch.cli import train_vlm
    from hsenet_torch.configs import MeshConfig
    from hsenet_torch.ops import flash_attention as tfa
    from hsenet_torch.parallel import mesh as pmesh
    from hsenet_torch.parallel.sharding import gather_leaf, is_sharded, shard_params
    from hsenet_torch.train import stage1 as tstage1
    from hsenet_torch.train import vlm as tvlm

    with open(os.path.join(root, "paths.json")) as f:
        paths = json.load(f)
    rank = dist.get_rank()
    res = {}
    mesh = pmesh.create_mesh(MeshConfig(dp=2, tp=1), device="cuda")
    model = shard_params(build_clip_model(clip_config(), DIST_CLIP_SEED), mesh)
    n = CLIP_BATCH // 2
    batch = dist_clip_batch(slice(rank * n, (rank + 1) * n))
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    loss, grads = clip_step_grads(model, batch)
    torch.cuda.synchronize()
    res["clip_ms"] = (time.perf_counter() - t0) * 1e3
    res["clip_shapes"] = dict(tfa.shape_launches)
    ref = torch.load(os.path.join(root, "clip_ref.pt"), weights_only=True)
    res["clip_loss"] = loss.item()
    res["clip_rel"] = trainable_rel(grads, ref["grads"])
    del grads
    with patched((tstage1, "gather_with_grad", gather_keeping_own)):
        wloss, wgrads = clip_step_grads(model, batch)
    res["clip_wrong_rel"] = trainable_rel(wgrads, ref["grads"])
    res["clip_wrong_loss"] = wloss.item()
    del model, wgrads, ref
    gc.collect()
    torch.cuda.empty_cache()

    ref = torch.load(os.path.join(root, "vlm_ref_dp2.pt"), weights_only=True)

    def vlm_main(argv):
        return train_vlm.main(argv, model=dist_vlm_model(DP2_LLM_LAYERS))

    def vlm_run(tag, flags, *patches, n_steps=DIST_STEPS):
        with recorded_lora_grads() as steps, patched(*patches):
            state, rec = dist_train(f"dist-dp2 vlm {tag}", vlm_main,
                                    dist_train_argv(paths, "mrg", os.path.join(
                                        root, f"dp2_{tag}{rank}"), n_steps)
                                    + ["--dp", "2", *flags])
        model = state.model
        leaves = {k: gather_leaf(model, k, v).detach().cpu()
                  for k, v in model.state_dict().items() if "lora_" in k}
        # FSDP's gradients are this rank's shards: its leaves are compared
        out = {"logged": rec["logged"], "shapes": rec["shapes"], "lens": rec["lens"],
               "grad_rel": None if "--fsdp" in flags else [
                   trainable_rel(g, w) for g, w in zip(steps, ref["grads"])],
               "params_rel": trainable_rel(leaves, ref["leaves"]),
               "move_rel": move_rel(leaves, ref["leaves"], ref["before"]),
               "moment_split": any(m.shape != p.shape for m, p in zip(
                   state.opt_state.mu, state.params.values())),
               "params_split": is_sharded(model),
               "wall_s": rec["wall_s"], "step_ms": rec["step_ms"],
               "peak_gb": rec["peak_gb"], "step_peak_gb": rec["step_peak_gb"]}
        del state, model, leaves, steps
        gc.collect()
        torch.cuda.empty_cache()
        return out

    res["vlm"] = vlm_run("zero1", ["--zero1"])
    res["vlm_fsdp"] = vlm_run("fsdp", ["--fsdp"])
    # --int8-base under FSDP, one step: the int8 codes and scales split
    # over dp as the float leaves are
    res["vlm_fsdp_int8"] = vlm_run("fsdp-int8", ["--fsdp", "--int8-base"], n_steps=1)
    res["vlm_wrong"] = vlm_run("local-grads", ["--zero1"], (
        tvlm, "reduce_gradients", lambda grads, names, model, mesh: grads))
    del ref
    res["eval"], res["eval_shapes"], _ = dist_eval(
        "dp2 evaluate --dp 2", dist_eval_argv(paths, 2) + ["--dp", "2"])

    def own_rows_only(t, group, dim=0):
        parts = [torch.zeros_like(t)] * dist.get_world_size(group)
        parts[dist.get_rank(group)] = t
        return torch.cat(parts, dim)

    with patched((pmesh, "all_gather", own_rows_only)):
        res["eval_wrong"], _, _ = dist_eval("dp2 evaluate, wrong variant",
                                         dist_eval_argv(paths, 2) + ["--dp", "2"])
    return res


def run_dist_dp2(card, paths, world1):
    """[dist-dp2]: two ranks on the one card. The CLIP stage-1 step at batch
    24 (12 rows a rank) against one process's at batch 24: loss and every
    gradient (relative L2 over all leaves) within DIST_REL_TOL, where the
    gather that keeps only the rank's own rows' gradient must miss.
    train_vlm --dp 2 with --zero1 and with --fsdp on `dist_vlm_model` cut to
    DP2_LLM_LAYERS LLM layers, without dropout, against that model's plain
    run here (two reports of their own, one a rank): losses and gradient
    norms within DIST_REL_TOL; each step's LoRA gradients (--zero1) within
    DIST_REL_TOL and the trained LoRA leaves' move within DIST_MOVE_TOL,
    where a real run whose ranks keep their own gradients must miss both;
    FSDP's step peak of device memory below ZeRO-1's. evaluate --dp 2
    (batch 2: one row a rank) reporting and generating what the plain run
    does at batch 1, where ranks that keep their own ids must not. Returns
    (numbers, rank 0's launches by shape and lengths)."""
    import os

    import torch

    root = paths["root"]
    plain_vlm, plain_eval, plain_lora = world1[3], world1[4], world1[6]
    torch.save({"before": {k: v for k, v in plain_vlm["before"].items()
                           if k in plain_lora["leaves"]},
                "leaves": plain_lora["leaves"], "by_step": plain_lora["by_step"],
                "grads": plain_lora["grads"]},
               os.path.join(root, "vlm_ref.pt"))
    # the --dp 1 run's losses and step peak, for [dist-pp2] and [dist-sp2]
    torch.save({"losses": logged(plain_vlm), "step_peak_gb": plain_vlm["step_peak_gb"]},
               os.path.join(root, "vlm_plain.pt"))
    # this phase's VLM runs train the model cut to DP2_LLM_LAYERS: its plain run
    from hsenet_torch.cli import train_vlm

    with recorded_lora_grads() as grads:
        state, plain_vlm = dist_train(
            "dist-dp2 vlm plain", lambda argv: train_vlm.main(
                argv, model=dist_vlm_model(DP2_LLM_LAYERS)),
            dist_train_argv(paths, "mrg", os.path.join(root, "dp2_plain")),
            snapshot=("lora_",))
    leaves = {k: v.detach().cpu() for k, v in state.params.items() if "lora_" in k}
    torch.save({"before": {k: v for k, v in plain_vlm["before"].items() if k in leaves},
                "leaves": leaves, "grads": grads},
               os.path.join(root, "vlm_ref_dp2.pt"))
    del state, leaves, grads
    model = build_clip_model(clip_config(), DIST_CLIP_SEED)
    loss, grads = clip_step_grads(model, dist_clip_batch())
    torch.save({"loss": loss.item(),
                "grads": {k: g.to(torch.bfloat16).cpu() for k, g in grads.items()}},
               os.path.join(root, "clip_ref.pt"))
    del model, grads
    gc.collect()
    torch.cuda.empty_cache()
    two = run_ranks("dist-dp2", root)
    loss_rel = abs(two["clip_loss"] - loss.item()) / abs(loss.item())
    print(f"[dist-dp2] on {card}: CLIP stage-1 step at batch {CLIP_BATCH}, "
          f"{CLIP_BATCH // 2} rows a rank: loss {two['clip_loss']:.6f} against one "
          f"process's {loss.item():.6f} (relative {loss_rel:.3e}); gradients at "
          f"relative L2 {two['clip_rel']:.3e} (limit {DIST_REL_TOL}); wrong variant, "
          f"the gather without the other ranks' gradient: {two['clip_wrong_rel']:.3e}; "
          f"step {two['clip_ms']:.1f} ms a rank (two ranks sharing one card over gloo)")
    if not (loss_rel <= DIST_REL_TOL and two["clip_rel"] <= DIST_REL_TOL):
        raise AssertionError("[dist-dp2] the two-rank CLIP step is not one process's")
    if two["clip_wrong_rel"] <= DIST_REL_TOL:
        raise AssertionError("[dist-dp2] the limit passes the gather without gradient")
    want, want_n = logged(plain_vlm), logged(plain_vlm, "grad_norm")
    vlm = {}
    for key, name in (("vlm", "--zero1"), ("vlm_fsdp", "--fsdp"),
                      ("vlm_wrong", "--zero1, each rank keeping its own gradients")):
        run = two[key]
        got, got_n = [m["loss"] for _, m in run["logged"]], [
            m["grad_norm"] for _, m in run["logged"]]
        l_rel, n_rel = losses_rel(got, want), losses_rel(got_n, want_n)
        g_rel = None if run["grad_rel"] is None else max(run["grad_rel"])
        want_k, want_nk = want[:len(got)], want_n[:len(got)]
        vlm[key] = {"losses": got, "grad_norms": got_n, "loss_rel": l_rel,
                    "grad_norm_rel": n_rel, "lora_grad_rel": run["grad_rel"],
                    "lora_params_rel": run["params_rel"],
                    "lora_move_rel": run["move_rel"], "wall_s": run["wall_s"],
                    "step_ms": run["step_ms"], "peak_gb": run["peak_gb"],
                    "step_peak_gb": run["step_peak_gb"]}
        print(f"[dist-dp2] train_vlm --dp 2 {name} ({DP2_LLM_LAYERS} LLM layers): "
              f"losses {got} against --dp 1's "
              f"{want_k} (max relative {l_rel:.3e}), gradient norms {got_n} against "
              f"{want_nk} (max relative {n_rel:.3e}); LoRA gradients by step at "
              f"relative L2 {run['grad_rel']} (limit {DIST_REL_TOL}); trained LoRA "
              f"leaves at relative L2 {run['params_rel']:.3e}, their move from the "
              f"initial leaves at {run['move_rel']:.3e} of --dp 1's (limit "
              f"{DIST_MOVE_TOL}); Adam's moments split over the ranks: "
              f"{run['moment_split']}, the parameters: {run['params_split']}; "
              f"device memory peak a rank {run['peak_gb']:.2f} "
              f"GB, in the steps {run['step_peak_gb']:.2f} GB; steps "
              f"{[round(t, 1) for t in run['step_ms']]} ms (two ranks sharing one "
              f"card over gloo)")
        if key == "vlm_wrong":
            if g_rel <= DIST_REL_TOL or run["move_rel"] <= DIST_MOVE_TOL:
                raise AssertionError("[dist-dp2] the limits pass ranks that keep "
                                     "their own gradients")
            continue
        split = run["params_split"] if key == "vlm_fsdp" else run["moment_split"]
        if not (l_rel <= DIST_REL_TOL and n_rel <= DIST_REL_TOL
                and run["move_rel"] <= DIST_MOVE_TOL and split
                and (g_rel is None or g_rel <= DIST_REL_TOL)):
            raise AssertionError(f"[dist-dp2] train_vlm --dp 2 {name} is not --dp 1")
    print(f"[dist-dp2] step peak of device memory a rank: --fsdp "
          f"{two['vlm_fsdp']['step_peak_gb']:.2f} GB, --zero1 "
          f"{two['vlm']['step_peak_gb']:.2f} GB")
    if not two["vlm_fsdp"]["step_peak_gb"] < two["vlm"]["step_peak_gb"]:
        raise AssertionError("[dist-dp2] FSDP's step peak is not below ZeRO-1's")
    # the frozen projections: bf16 split over two ranks hold what int8
    # codes held whole on every rank would; split int8 codes hold half that
    split = two["vlm_fsdp_int8"]
    int8_losses = [m["loss"] for _, m in split["logged"]]
    print(f"[dist-dp2] train_vlm --dp 2 --fsdp --int8-base ({DP2_LLM_LAYERS} LLM "
          f"layers), one step: step peak of "
          f"device memory a rank {split['step_peak_gb']:.2f} GB with the int8 codes "
          f"and scales split over dp, against --fsdp's "
          f"{two['vlm_fsdp']['step_peak_gb']:.2f} GB (bf16 projections split); "
          f"loss {int8_losses}; step {[round(t, 1) for t in split['step_ms']]} ms")
    if not (split["step_peak_gb"] < two["vlm_fsdp"]["step_peak_gb"]
            and all(map(math.isfinite, int8_losses))):
        raise AssertionError("[dist-dp2] --fsdp --int8-base's step peak is not "
                             "below --fsdp's: the int8 codes are not split")
    same = two["eval"] == plain_eval
    wrong_same = two["eval_wrong"] == plain_eval
    print(f"[dist-dp2] evaluate --dp 2: reports and generated ids equal to "
          f"--dp 1's: {same}; with each rank's own ids beside zeros in place of "
          f"the gathered ones: {wrong_same}")
    if not same or wrong_same:
        raise AssertionError("[dist-dp2] evaluate --dp 2 does not report --dp 1's")
    numbers = {"clip": {k: two[k] for k in ("clip_loss", "clip_rel", "clip_wrong_rel",
                                            "clip_ms")},
               "clip_one_process_loss": loss.item(),
               "vlm_plain": {"losses": want, "grad_norms": want_n,
                             "step_peak_gb": plain_vlm["step_peak_gb"]},
               "vlm_fsdp_int8": {"losses": int8_losses,
                                 **{k: split[k] for k in ("step_peak_gb", "peak_gb",
                                                          "step_ms")}},
               **vlm, "evaluate_equal": same,
               "note": "two ranks share one card over gloo: times are no dp speed"}
    return numbers, two


# ---- the sixteenth slice: [dist-pp2], [dist-sp2] ----

def gathered_counts(counts):
    """Every rank's `counts` (a dict), in rank order."""
    import torch.distributed as dist

    every = [None] * dist.get_world_size()
    dist.all_gather_object(every, counts)
    return every


def kept_dist_train(tag, main, argv, keep, snapshot=()):
    """`dist_train`, with the run's `vlm_deltas` copied to `keep` (rank 0
    writes it) before its output directory goes."""
    import os
    import shutil

    import torch.distributed as dist

    out = argv[argv.index("--output-dir") + 1]
    real = shutil.rmtree

    def keep_then_remove(path, *args, **kwargs):
        if os.path.abspath(path) == os.path.abspath(out) and dist.get_rank() == 0:
            shutil.copy(os.path.join(out, "vlm_deltas"), keep)
        return real(path, *args, **kwargs)

    with patched((shutil, "rmtree", keep_then_remove)):
        return dist_train(tag, main, argv, snapshot)


def dist_child_pp2(root):
    """Rank of [dist-pp2]: train_vlm --pp 2 --n-micro 2 at VLMConfig() (16
    layers a stage) for PP_STEPS steps on `dist_vlm_model`, each step's
    LoRA gradients and the trained LoRA leaves gathered over the stages;
    the same with the stages swapped (stage 0 holding the upper half of the
    layers and running it first) for one step; each stage's flash launches
    by shape, step peak and step times."""
    import os

    import torch
    import torch.distributed as dist

    from hsenet_torch.cli import train_vlm
    from hsenet_torch.parallel import pipeline as tpp

    with open(os.path.join(root, "paths.json")) as f:
        paths = json.load(f)
    rank = dist.get_rank()

    def vlm_main(argv):
        return train_vlm.main(argv, model=dist_vlm_model())

    def run(tag, steps, *patches):
        argv = dist_train_argv(paths, "mrg", os.path.join(root, f"pp2_{tag}{rank}"))
        argv[argv.index("--total-steps") + 1] = str(steps)
        with recorded_lora_grads() as grads, patched(*patches):
            state, rec = kept_dist_train(
                f"dist-pp2 vlm {tag}", vlm_main, argv + ["--pp", "2", "--n-micro", "2"],
                os.path.join(root, f"pp2_{tag}_deltas"))
        model = state.model
        grads = [tpp.gather_stages(model, g) for g in grads]
        leaves = tpp.gather_stages(model, {k: v.detach().cpu() for k, v in
                                           model.state_dict().items() if "lora_" in k})
        held = sorted({int(k.split(".")[3]) for k in model.state_dict()
                       if k.startswith("llm.decoder.layers.")})
        every = gathered_counts({"shapes": rec["shapes"], "held": held,
                                 "step_peak_gb": rec["step_peak_gb"],
                                 "peak_gb": rec["peak_gb"], "step_ms": rec["step_ms"]})
        out = {"logged": rec["logged"], "grads": grads, "leaves": leaves,
               "stages": every, "lens": rec["lens"], "wall_s": rec["wall_s"]}
        del state, model
        gc.collect()
        torch.cuda.empty_cache()
        return out

    res = {"run": run("train", PP_STEPS)}
    real = tpp.stage_layers
    res["swapped"] = run("swapped", 1, (tpp, "stage_layers",
                                        lambda n, pp, s: real(n, pp, pp - 1 - s)))
    return res


def run_dist_pp2(card, paths):
    """[dist-pp2]: two ranks on the one card. train_vlm --pp 2 --n-micro 2
    at VLMConfig() (all 32 layers, 16 a stage; a microbatch 1 x 24 heads x
    800 tokens) for PP_STEPS steps against [dist-world1]'s plain run (--dp
    1, `vlm_ref.pt`): losses and each step's LoRA gradients within DIST_REL_TOL,
    the trained LoRA leaves' move within DIST_MOVE_TOL; the stages swapped
    must miss the gradients. Each stage's flash launches by shape (B1 with
    the log-sum-exp, B3), step peak of device memory against one process's,
    step time. Then `evaluate` (batch 1) on `dist_vlm_model` with the run's
    vlm_deltas loaded, whose LoRA leaves must be the ones the stages
    trained. Returns (numbers, the flash launches by shape of both ranks'
    runs)."""
    import os

    import torch

    from hsenet_torch.cli.evaluate import main as evaluate_main
    from hsenet_torch.utils.checkpoint import load_vlm_deltas

    root = paths["root"]
    # [dist-world1]'s plain run, PP_STEPS steps
    ref = torch.load(os.path.join(root, "vlm_ref.pt"), weights_only=True)
    ref["leaves"] = ref["by_step"][PP_STEPS - 1]
    plain = torch.load(os.path.join(root, "vlm_plain.pt"), weights_only=True)
    two = run_ranks("dist-pp2", root)
    run, wrong = two["run"], two["swapped"]
    got = [m["loss"] for _, m in run["logged"]]
    l_rel = losses_rel(got, plain["losses"])
    g_rel = [trainable_rel(g, w) for g, w in zip(run["grads"], ref["grads"])]
    lora = {k: v for k, v in run["leaves"].items()}
    m_rel = move_rel(lora, ref["leaves"], ref["before"])
    w_rel = trainable_rel(wrong["grads"][0], ref["grads"][0])
    shapes = {}
    for stage, st in enumerate(run["stages"]):
        for k, n in st["shapes"].items():
            shapes[k] = shapes.get(k, 0) + n
        print(f"[dist-pp2] stage {stage} holds layers {st['held'][0]}-{st['held'][-1]}; "
              f"flash launches by (kernel, B, H, Sq, Skv, d): {st['shapes']}; step "
              f"peak of device memory {st['step_peak_gb']:.2f} GB (one process's "
              f"{plain['step_peak_gb']:.2f} GB), peak {st['peak_gb']:.2f} GB; steps "
              f"{[round(t, 1) for t in st['step_ms']]} ms (two ranks sharing one "
              f"card over gloo)")
    print(f"[dist-pp2] on {card}: train_vlm --pp 2 --n-micro 2: losses {got} against "
          f"--dp 1's {plain['losses']} (max relative {l_rel:.3e}); LoRA gradients by "
          f"step at relative L2 {[f'{x:.3e}' for x in g_rel]} (limit "
          f"{DIST_REL_TOL}); the trained LoRA leaves' move at {m_rel:.3e} of --dp "
          f"1's (limit {DIST_MOVE_TOL}); wrong variant, the stages swapped: step-1 "
          f"LoRA gradients at {w_rel:.3e}; wall {run['wall_s']:.1f} s")
    if not (l_rel <= DIST_REL_TOL and max(g_rel) <= DIST_REL_TOL
            and m_rel <= DIST_MOVE_TOL):
        raise AssertionError("[dist-pp2] train_vlm --pp 2 is not --dp 1")
    if w_rel <= DIST_REL_TOL:
        raise AssertionError("[dist-pp2] the limit passes the stages swapped")
    layers = dist_vlm_config().llm.num_layers
    if [st["held"] for st in run["stages"]] != [list(range(layers // 2)),
                                                list(range(layers // 2, layers))]:
        raise AssertionError("[dist-pp2] the stages do not hold half the layers each")
    for st in run["stages"]:
        kinds = {k[0] for k in st["shapes"]}
        if not {"flash_fwd_lse", "flash_bwd"} <= kinds:
            raise AssertionError(f"[dist-pp2] a stage launched no B1 with the "
                                 f"log-sum-exp or no B3: {sorted(kinds)}")

    model = dist_vlm_model()
    deltas = os.path.join(root, "pp2_train_deltas")
    model.load_state_dict(load_vlm_deltas(deltas, model.state_dict()), strict=True)
    # the fresh model holds its LoRA leaves in bf16, the run f32 masters
    same = all(torch.equal(v.cpu(), lora[k].to(v.dtype))
               for k, v in model.state_dict().items() if "lora_" in k)
    t0 = time.perf_counter()
    import contextlib
    import io

    argv = dist_eval_argv(paths, 1)
    argv[argv.index("--max-new-tokens") + 1] = str(PP_EVAL_NEW)
    with contextlib.redirect_stdout(io.StringIO()):
        metrics = evaluate_main(argv, model=model)
    torch.cuda.synchronize()
    eval_s = time.perf_counter() - t0
    del model
    gc.collect()
    torch.cuda.empty_cache()
    print(f"[dist-pp2] evaluate on the model of the run's vlm_deltas: "
          f"{metrics['num_samples']} samples in {eval_s:.2f} s, bleu "
          f"{metrics.get('bleu')}; its LoRA leaves are the stages' trained ones: "
          f"{same}")
    if not (same and metrics["num_samples"] > 0):
        raise AssertionError("[dist-pp2] the run's vlm_deltas are not its trained "
                             "model")
    numbers = {"losses": got, "plain_losses": plain["losses"], "loss_rel": l_rel,
               "lora_grad_rel": g_rel, "lora_move_rel": m_rel, "wrong_rel": w_rel,
               "stages": [{k: st[k] for k in ("held", "step_peak_gb", "peak_gb",
                                              "step_ms")} for st in run["stages"]],
               "plain_step_peak_gb": plain["step_peak_gb"], "wall_s": run["wall_s"],
               "evaluate_samples": metrics["num_samples"], "evaluate_s": eval_s,
               "note": "two ranks share one card over gloo: no pp speed, no NCCL"}
    return numbers, shapes, run["lens"]


def long_tower():
    """[dist-sp2]'s fine-patch tower: the stage-1 ViT of [clip-long]
    (16,385 tokens), its volumes and a fixed cotangent of its tokens."""
    import torch

    cfg = clip_config(patch_size=CLIP_LONG_PATCH)
    vit = build_clip_model(cfg, seed=4).vision_encoder
    image = torch.as_tensor(clip_batch(cfg, SP_LONG_BATCH, "clip", seed=24)["image"]).cuda()
    gen = torch.Generator(device="cuda").manual_seed(71)
    w = torch.randn(SP_LONG_BATCH, cfg.vision.seq_len, cfg.vision.hidden_size,
                    generator=gen, device="cuda")
    return vit, image, w


def long_attention_inputs():
    """q, k, v at the fine-patch tower's attention shape (1 x 12 x 16,385 x
    64, bf16) from a seed: random scores are far from uniform, so a ring
    that misses keys shows (a random tower attends nearly uniformly)."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(73)
    return [torch.randn(SP_LONG_BATCH, 12, 16385, 64, generator=gen, device="cuda",
                        dtype=torch.bfloat16) for _ in range(3)]


def sp_long_attention(mesh):
    """`long_attention_inputs` through the ring at this rank (its chunk of
    the sequence padded to a multiple of the group, query blocks of
    SP_LONG_BLOCK_Q), the chunks gathered and the padding stripped."""
    from hsenet_torch.ops.ring_attention import local_chunk, pad_to_multiple, ring_attention
    from hsenet_torch.parallel.mesh import axis_group, axis_size, gather_from_group

    group = axis_group(mesh, "sp")
    q, k, v = (local_chunk(pad_to_multiple(t, axis_size(mesh, "sp"), 2), group, 2)
               for t in long_attention_inputs())
    out = ring_attention(q, k, v, group=group, kv_len=16385, block_q=SP_LONG_BLOCK_Q)
    return gather_from_group(out, group, 2)[:, :, :16385]


def causal_ring_inputs():
    """q (2 x 24 x 800 x 128), k and v (2 x 8 x 800 x 128), bf16 from a
    seed, and per-row lengths: the shape of Phi-4-mini's attention in
    train_vlm --sp 2 at batch 2, random scores far from uniform."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(79)
    q, k, v = (torch.randn(2, h, 800, 128, generator=gen, device="cuda",
                           dtype=torch.bfloat16) for h in (24, 8, 8))
    return q, k, v, torch.tensor(SP_CAUSAL_LENS, dtype=torch.int32, device="cuda")


def sp_causal_attention(mesh):
    """`causal_ring_inputs` through the causal ring at this rank (the
    unexpanded kv heads travel, each row's kv_lens masks its keys), the
    chunks gathered."""
    from hsenet_torch.ops.ring_attention import local_chunk, ring_attention
    from hsenet_torch.parallel.mesh import axis_group, gather_from_group

    group = axis_group(mesh, "sp")
    q, k, v, lens = causal_ring_inputs()
    q, k, v = (local_chunk(t, group, 2) for t in (q, k, v))
    out = ring_attention(q, k, v, group=group, kv_lens=lens, causal=True)
    return gather_from_group(out, group, 2)


def tower_grads(vit, tokens, w):
    import torch

    params = dict(vit.named_parameters())
    grads = torch.autograd.grad((tokens.float() * w).sum(), list(params.values()))
    return dict(zip(params, grads))


def sp_train_argv(paths, kind, out, total=DIST_STEPS):
    """`dist_train_argv`, the CLIP runs at SP_CLIP_BATCH."""
    argv = dist_train_argv(paths, kind, out, total)
    if kind == "clip":
        argv[argv.index("--batch-size") + 1] = str(SP_CLIP_BATCH)
    return argv


def dist_child_sp2(root):
    """Rank of [dist-sp2] on a (dp 1, sp 2) mesh: train_clip_stage1 --sp 2
    (1025 tokens a rank), train_clip_stage2 --sp 2 --cached-teacher and
    train_vlm --sp 2 (its LoRA gradients and trained leaves), and one step
    of it with a ring whose hops never rotate; the fine-patch tower's tokens
    and gradients at 16,385 tokens (8,193 a rank, query blocks of
    SP_LONG_BLOCK_Q); the ring at the tower's attention shape and the
    causal ring at the decoder's, each also with the ring that never
    rotates; each with its step or pass peak of device memory."""
    import os

    import torch
    import torch.distributed as dist

    from hsenet_torch.cli import train_clip_stage1, train_clip_stage2, train_vlm
    from hsenet_torch.configs import MeshConfig
    from hsenet_torch.ops import ring_attention as tring
    from hsenet_torch.parallel import mesh as pmesh
    from hsenet_torch.parallel.sp import sp_encode_tokens
    from hsenet_torch.train.train_state import sum_over_sp

    with open(os.path.join(root, "paths.json")) as f:
        paths = json.load(f)
    rank = dist.get_rank()
    res = {}
    mesh = pmesh.create_mesh(MeshConfig(dp=1, sp=2), device="cuda")
    broken = (tring, "ppermute", lambda x, group, shift=1: x)

    def cli(tag, main, kind, flags, steps=DIST_STEPS, grads=False, patches=()):
        argv = sp_train_argv(paths, kind, os.path.join(root, f"sp2_{tag}{rank}"),
                             steps)
        with recorded_lora_grads() as lora, patched(*patches):
            state, rec = dist_train(f"dist-sp2 {tag}", main, argv + ["--sp", "2", *flags])
        out = {"logged": rec["logged"], "shapes": rec["shapes"], "lens": rec["lens"],
               "step_ms": rec["step_ms"], "step_peak_gb": rec["step_peak_gb"],
               "peak_gb": rec["peak_gb"], "wall_s": rec["wall_s"]}
        if grads:
            out["grads"] = list(lora)
            out["leaves"] = {k: v.detach().cpu() for k, v in
                             state.model.state_dict().items() if "lora_" in k}
        del state
        gc.collect()
        torch.cuda.empty_cache()
        return out

    def vlm_main(argv):
        return train_vlm.main(argv, model=dist_vlm_model())

    res["stage1"] = cli("stage1", train_clip_stage1.main, "clip", [])
    res["stage2"] = cli("stage2", train_clip_stage2.main, "clip", ["--cached-teacher"])
    res["vlm"] = cli("vlm", vlm_main, "mrg", [], grads=True)
    res["vlm_broken"] = cli("vlm-broken", vlm_main, "mrg", [], steps=1, grads=True,
                            patches=(broken,))

    vit, image, w = long_tower()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    tokens = sp_encode_tokens(vit, mesh, image, block_q=SP_LONG_BLOCK_Q)
    grads = tower_grads(vit, tokens, w)
    names = list(grads)
    grads = dict(zip(names, sum_over_sp(list(grads.values()), names, ("",), mesh)))
    torch.cuda.synchronize()
    long_ref = torch.load(os.path.join(root, "long_ref.pt"), weights_only=True)
    res["long"] = {"ms": (time.perf_counter() - t0) * 1e3,
                   "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
                   "tokens_rel": trainable_rel({"t": tokens.detach()},
                                               {"t": long_ref["tokens"]}),
                   "grads_rel": trainable_rel(grads, long_ref["grads"])}
    del tokens, grads
    with torch.no_grad():
        attn = sp_long_attention(mesh)
        res["long"]["attention_rel"] = trainable_rel({"a": attn},
                                                     {"a": long_ref["attention"]})
        with patched(broken):
            attn = sp_long_attention(mesh)
        res["long"]["attention_wrong_rel"] = trainable_rel(
            {"a": attn}, {"a": long_ref["attention"]})
        attn = sp_causal_attention(mesh)
        res["causal"] = {"rel": trainable_rel({"a": attn}, {"a": long_ref["causal"]})}
        with patched(broken):
            attn = sp_causal_attention(mesh)
        res["causal"]["wrong_rel"] = trainable_rel({"a": attn},
                                                   {"a": long_ref["causal"]})
    res["peaks"] = gathered_counts({"long": res["long"]["peak_gb"]}
                                   | {k: res[k]["step_peak_gb"] for k in
                                      ("stage1", "stage2", "vlm")})
    return res


def run_dist_sp2(card, paths):
    """[dist-sp2]: two ranks on the one card over a (dp 1, sp 2) ring, each
    check against one process's run:
      * train_clip_stage1 --sp 2 (2049 tokens, 1025 a rank) and
        train_clip_stage2 --sp 2 --cached-teacher (the cache filled over the
        ring), at batch SP_CLIP_BATCH, against one process's runs here;
      * train_vlm --sp 2 (800 tokens, 400 a rank) against --dp 1's losses,
        LoRA gradients and trained leaves' move (`vlm_ref.pt`), where one
        step with a ring whose hops never rotate (each rank reads only its
        own chunk: at sp 2, the ring without its last hop) must miss;
      * the causal ring at Phi-4-mini's attention shape (GQA, per-row
        kv_lens) on random q, k, v against one process's flash over the
        expanded heads, where that broken ring must miss;
      * the fine-patch tower at 16,385 tokens (8,193 a rank, query blocks of
        SP_LONG_BLOCK_Q), one forward and backward: tokens and gradients
        against one process's flash run; each rank's peak beside it;
      * the ring at the tower's attention shape on random q, k, v against
        one process's flash, where the broken ring must miss. A random
        tower attends nearly uniformly (and a CLIP gradient at random init
        is rounding noise between two bf16 paths: on the card a CLIP step's
        gradients read 3.5e-2 from one process's with the ring and 4.8e-2
        without its last hop, the fine-patch tower's tokens 8.87e-3 and
        1.04e-2), so the towers' and the CLIP CLIs' checks cannot tell the
        broken ring apart; random scores and the decoder's LoRA gradients
        can.
    Returns (numbers, the flash launches by shape of both ranks' CLI runs,
    their LLM batch lengths)."""
    import os

    import torch

    from hsenet_torch.cli import train_clip_stage1, train_clip_stage2

    root = paths["root"]
    plain_clip = {}
    for key, main, flags in (("stage1", train_clip_stage1.main, []),
                             ("stage2", train_clip_stage2.main, ["--cached-teacher"])):
        state, plain_clip[key] = dist_train(
            f"dist-sp2 {key} plain", main,
            sp_train_argv(paths, "clip", os.path.join(root, f"sp2_{key}_plain")) + flags)
        del state
        gc.collect()
        torch.cuda.empty_cache()
    vit, image, w = long_tower()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    tokens = vit(image)
    grads = tower_grads(vit, tokens, w)
    torch.cuda.synchronize()
    long_ms = (time.perf_counter() - t0) * 1e3
    long_peak = torch.cuda.max_memory_allocated() / 1e9
    from hsenet_torch.ops.attention import flash_attention

    with torch.no_grad():
        attention = flash_attention(*long_attention_inputs())
        q, k, v, lens = causal_ring_inputs()
        g = q.shape[1] // k.shape[1]  # query heads per kv head
        causal = flash_attention(q, k.repeat_interleave(g, 1), v.repeat_interleave(g, 1),
                                 kv_lens=lens, causal=True)
    torch.save({"tokens": tokens.detach().to(torch.bfloat16).cpu(),
                "grads": {k: g.to(torch.bfloat16).cpu() for k, g in grads.items()},
                "attention": attention.cpu(), "causal": causal.cpu()},
               os.path.join(root, "long_ref.pt"))
    del vit, image, w, tokens, grads, attention, q, k, v, causal
    gc.collect()
    torch.cuda.empty_cache()

    two = run_ranks("dist-sp2", root)
    ref = torch.load(os.path.join(root, "vlm_ref.pt"), weights_only=True)
    plain = torch.load(os.path.join(root, "vlm_plain.pt"), weights_only=True)
    plain["losses"] = plain["losses"][:DIST_STEPS]
    checks, numbers = [], {}
    print(f"[dist-sp2] on {card}:")
    for key, label in (("stage1", "train_clip_stage1 --sp 2"),
                       ("stage2", "train_clip_stage2 --sp 2 --cached-teacher")):
        want = logged(plain_clip[key])
        run = two[key]
        got = logged(run)
        rel = losses_rel(got, want)
        print(f"[dist-sp2] {label} at batch {SP_CLIP_BATCH}: losses {got} against one "
              f"process's {want} (max "
              f"relative {rel:.3e}, limit {DIST_REL_TOL}); step peak "
              f"{run['step_peak_gb']:.2f} GB a rank; steps "
              f"{[round(t, 1) for t in run['step_ms']]} ms")
        checks.append((label, rel <= DIST_REL_TOL, True))
        numbers[key] = {"losses": got, "plain_losses": want, "loss_rel": rel,
                        "step_ms": run["step_ms"], "step_peak_gb": run["step_peak_gb"],
                        "wall_s": run["wall_s"]}
    for key in ("stage1", "stage2"):
        numbers[key]["plain_step_peak_gb"] = plain_clip[key]["step_peak_gb"]
    run = two["vlm"]
    got = logged(run)
    l_rel = losses_rel(got, plain["losses"])
    g_rel = [trainable_rel(g, r) for g, r in zip(run["grads"], ref["grads"])]
    m_rel = move_rel(run["leaves"], ref["leaves"], ref["before"])
    b_rel = trainable_rel(two["vlm_broken"]["grads"][0], ref["grads"][0])
    print(f"[dist-sp2] train_vlm --sp 2 (400 tokens a rank): losses {got} against "
          f"--dp 1's {plain['losses']} (max relative {l_rel:.3e}); LoRA "
          f"gradients by step at relative L2 {[f'{x:.3e}' for x in g_rel]} (limit "
          f"{DIST_REL_TOL}); the trained LoRA leaves' move at {m_rel:.3e} (limit "
          f"{DIST_MOVE_TOL}); step peak {run['step_peak_gb']:.2f} GB a rank (one "
          f"process's {plain['step_peak_gb']:.2f} GB); steps "
          f"{[round(t, 1) for t in run['step_ms']]} ms; wrong variant, the decoder's "
          f"ring never rotating: step-1 LoRA gradients at {b_rel:.3e}")
    checks.append(("train_vlm --sp 2", l_rel <= DIST_REL_TOL and max(g_rel) <= DIST_REL_TOL
                   and m_rel <= DIST_MOVE_TOL, b_rel > DIST_REL_TOL))
    numbers["vlm"] = {"losses": got, "plain_losses": plain["losses"], "loss_rel": l_rel,
                      "lora_grad_rel": g_rel, "lora_move_rel": m_rel, "wrong_rel": b_rel,
                      "step_ms": run["step_ms"], "step_peak_gb": run["step_peak_gb"],
                      "plain_step_peak_gb": plain["step_peak_gb"], "wall_s": run["wall_s"]}
    lg = two["long"]
    print(f"[dist-sp2] the fine-patch tower at 16,385 tokens, batch {SP_LONG_BATCH}, "
          f"8,193 a rank in query blocks of {SP_LONG_BLOCK_Q}: one forward and "
          f"backward, tokens at relative L2 {lg['tokens_rel']:.3e} and gradients at "
          f"{lg['grads_rel']:.3e} of one process's flash run (limit {DIST_REL_TOL}); "
          f"{lg['ms']:.1f} ms a rank (one process "
          f"{long_ms:.1f} ms); peak of device memory by rank "
          f"{[round(p['long'], 2) for p in two['peaks']]} GB, one process's "
          f"{long_peak:.2f} GB")
    print(f"[dist-sp2] the ring at the tower's attention shape ({SP_LONG_BATCH} x 12 x "
          f"16,385 x 64, "
          f"random bf16 q, k, v) against one process's flash: relative L2 "
          f"{lg['attention_rel']:.3e} (limit {DIST_REL_TOL}); wrong variant, the ring "
          f"never rotating: {lg['attention_wrong_rel']:.3e}")
    cz = two["causal"]
    print(f"[dist-sp2] the causal ring at Phi-4-mini's attention shape (2 x 24 x 800 "
          f"x 128 queries, 8 kv heads, kv_lens {list(SP_CAUSAL_LENS)}, random bf16 q, "
          f"k, v) against one process's flash over the expanded heads: relative L2 "
          f"{cz['rel']:.3e} (limit {DIST_REL_TOL}); wrong variant, the ring never "
          f"rotating: {cz['wrong_rel']:.3e}")
    checks.append(("the causal ring", cz["rel"] <= DIST_REL_TOL,
                   cz["wrong_rel"] > DIST_REL_TOL))
    numbers["causal"] = cz
    checks.append(("the fine-patch tower", lg["tokens_rel"] <= DIST_REL_TOL
                   and lg["grads_rel"] <= DIST_REL_TOL
                   and lg["attention_rel"] <= DIST_REL_TOL,
                   lg["attention_wrong_rel"] > DIST_REL_TOL))
    numbers["long"] = {**lg, "one_process_ms": long_ms, "one_process_peak_gb": long_peak,
                       "peaks_by_rank": two["peaks"]}
    print(f"[dist-sp2] peaks of device memory by rank (GB): {two['peaks']}")
    for label, held, wrong_missed in checks:
        if not held:
            raise AssertionError(f"[dist-sp2] {label} is not one process's")
        if not wrong_missed:
            raise AssertionError(f"[dist-sp2] the limit passes the broken ring ({label})")
    shapes = {}
    for key in ("stage1", "stage2", "vlm"):
        for k, n in two[key]["shapes"].items():
            shapes[k] = shapes.get(k, 0) + 2 * n  # the ranks launch alike
    numbers["note"] = "two ranks share one card over gloo: no sp speed, no NCCL"
    return numbers, shapes, two["vlm"]["lens"]


def check_tp_kernels(dist_shapes, known, lens, fwd_lens):
    """[kernel-tp], in this process alone: B5's tensor-core entry at the five
    tp = 2 shard shapes (held at M = 8 and 1 beside the two wrong variants,
    timed at M = 8 with the codes cold, with the bound, the plain version
    and the library's products), B1 at the tp = 2 prefill (2 x 12 x 320 over
    352), B1 with the log-sum-exp and B3 at the dp-split CLIP batch (12 x
    12 x 2049 x 64, BERT at 12 x 12 x 128); then B1 and B3 at every other
    shape the dist runs launched that no phase above held: the training
    shapes as [kernel-train-cli] holds them (the LLM at its first batch's
    lengths `lens`), forward-only shapes (the tp engine's admissions at 12
    heads, the evaluations' prefills) at the valid lengths `fwd_lens` gives
    by (batch, heads): the first request's, the first batch's. Returns (matvec
    results, flash results by kernel, launch key -> (kernel, shape
    name))."""
    import torch

    from hsenet_torch.ops import quant_matvec as tqm

    gen = torch.Generator(device="cuda").manual_seed(61)
    matvec = {}
    library = int8pack_registered()
    for name, (k, n) in TP_MATVEC_SHAPES.items():
        w, scale = matvec_codes(gen, k, n)
        for m in (8, 1):
            x = torch.randn(m, k, generator=gen, device="cuda", dtype=torch.bfloat16)
            hold_matvec(f"{name} M={m} bf16, plan {tuple(tqm.mma_plan(m, k, n))}",
                        tqm.quant_matvec_mma_kernel, x, w, scale, phase="kernel-tp")
        r, _ = time_matvec_cold("kernel-tp", name, k, n, gen, library, rows=(8,))
        matvec.update(r)
    fwd, index = {}, {}
    b, h, sq, skv, d = TP_PREFILL[1:]
    name = f"tp2_prefill_{b}x{h}x{sq}x{skv}"
    fwd[name] = b1_case("kernel-tp", name, b, h, sq, skv, d, KV_LENS, True, gen)
    index[TP_PREFILL] = ("flash_fwd", name)
    cases = [("clip_tower_dp2", (CLIP_BATCH // 2, 12, 2049, 64),
              (2049,) * (CLIP_BATCH // 2), False, (4, 12), ("flash_fwd_lse",)),
             ("clip_bert_dp2", (CLIP_BATCH // 2, 12, 128, 64),
              CLIP_TEXT_LENS[:CLIP_BATCH // 2], False, (CLIP_BATCH // 2, 12),
              ("flash_fwd_lse",))]
    dp = check_flash_cases(cases, seed=62)
    for name, (b, h, s, d), _, _, _, _ in cases:
        index[("flash_fwd_lse", b, h, s, s, d)] = ("flash_fwd", name + "_lse")
        index[("flash_bwd", b, h, s, s, d)] = ("flash_bwd", name)
    fwd.update(dp["flash_fwd"])
    bwd = dict(dp["flash_bwd"])
    known = {**known, **index}
    square = {k: n for k, n in dist_shapes.items() if k[3] == k[4] and k not in known}
    train, train_index = check_train_cli_kernels(square, known, lens, prefix="dist")
    fwd.update(train["flash_fwd"])
    bwd.update(train["flash_bwd"])
    index.update(train_index)
    for key in sorted(k for k in dist_shapes if k not in known and k not in index):
        kind, b, h, sq, skv, d = key
        name = f"dist_{'llm' if d == 128 else 'tower'}_{b}x{h}x{sq}x{skv}"
        kv = fwd_lens.get((b, h), (sq,) * b) if d == 128 else (sq,) * b
        fwd[name] = b1_case("kernel-tp", name, b, h, sq, skv, d, kv, d == 128, gen)
        index[key] = ("flash_fwd", name)
    return matvec, {"flash_fwd": fwd, "flash_bwd": bwd}, index


def dist_child(argv) -> int:
    """A rank of a two-rank phase: `chip_smoke.py --dist-rank <phase> <root>`,
    in a gloo group of the environment the parent set (two ranks cannot
    share one card over NCCL; the CLIs keep the group they find); rank 0
    writes its results to `<root>/<phase>.pt`."""
    import os
    import traceback

    sys.path.insert(0, str(ROOT))
    import torch
    import torch.distributed as dist

    phase, root = argv
    try:
        dist.init_process_group("gloo", init_method="env://")
        res = {"dist-tp2": dist_child_tp2, "dist-dp2": dist_child_dp2,
               "dist-pp2": dist_child_pp2, "dist-sp2": dist_child_sp2}[phase](root)
        if dist.get_rank() == 0:
            torch.save(res, os.path.join(root, f"{phase}.pt"))
        dist.barrier()
        dist.destroy_process_group()
    except Exception:
        traceback.print_exc()
        return 1
    return 0


# the seventeenth slice: exports and tools. The exported encode and greedy
# decode run in a child process that imports torch, the kernels' operators
# and the loader only (never hsenet_torch.models): the serving side of an
# artifact
EXPORT_BATCH = 2  # the exported encode's batch, [main]'s volumes
EXPORT_NEW_TOKENS = 16  # the exported greedy decode's budget
EXPORT_DECODE_RUNS = 2  # timed calls of the eager and the exported decode
EXPORT_TIMEOUT = 600  # seconds the child may take
EXPORT_CONST_MAX = 256  # elements of a constant in a program (the smallest
# weight the programs read, a norm's or a bias's, has 768)
HF_LAYERS = 2  # the HF exports' decoder depth (full width)
HF_ROWS, HF_TOKENS = 2, 64  # the HF round trips' prefill
HF_LORA_B_STD = 0.0625  # the adapters' B, so that the delta moves the logits
HF_EXACT_REL = 1e-6  # the card's export against the CPU's, each tensor
MATVEC_DISPATCH_CALLS = 2000  # host time a call, direct and through the op
EXPORT_CHILD = r'''
import os, statistics, sys, time
import torch
from hsenet_torch.ops import flash_attention as tfa
from hsenet_torch.ops import quant_matvec as tqm
from hsenet_torch.utils import export as tex

work = sys.argv[1]
runs = {"encode": int(sys.argv[2]), "decode": int(sys.argv[3])}
out, calls = {}, {}
for name in ("encode", "decode"):
    t = time.perf_counter()
    fn = tex.load_exported_file(f"{work}/{name}.pt2")
    load_s = time.perf_counter() - t
    args = torch.load(f"{work}/{name}_inputs.pt", map_location="cuda",
                      weights_only=True)
    torch.cuda.synchronize()
    tfa.reset_launch_counts()
    tqm.reset_launch_counts()
    result = fn(*args)  # counted
    torch.cuda.synchronize()
    counts = {**tfa.launches, **tqm.launches, **tqm.fma_launches}
    out[name] = {"result": result.cpu(), "counts": counts, "load_s": load_s,
                 "nodes": fn.op_nodes(), "lifted": fn.lifted()}
    calls[name] = (fn, args)
# the timed calls wait until the card is this process's alone
deadline = time.perf_counter() + float(sys.argv[4])
while not os.path.exists(f"{work}/go"):
    if time.perf_counter() > deadline:
        sys.exit("export child: no go")
    time.sleep(0.05)
for name, (fn, args) in calls.items():
    walls = []
    for _ in range(runs[name]):
        torch.cuda.synchronize()
        t = time.perf_counter()
        fn(*args)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t) * 1e3)
    out[name]["wall_ms"] = statistics.median(walls)
loaded = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "flax",
                "hsenet_tpu") or m.startswith("hsenet_torch.models"))
out["modules_loaded"] = loaded
torch.save(out, f"{work}/child.pt")
print("export child: loaded", len(sys.modules), "modules; of the model code:",
      loaded)
sys.exit(1 if loaded else 0)
'''


def export_encode_live(card: str, model, work: str):
    """[export], the encode half, on [main]'s bf16 `HSENetVLM(VLMConfig())`:
    `export_encode` of its towers and packers at batch 2 (the weights given
    as the part of the state they read), the artifact and its inputs saved
    under `work` for the child; the live encode's features, B1 launches (24:
    two towers of 12 blocks at 2 x 12 x 2049 x 64) and wall beside them."""
    import torch

    from hsenet_torch.utils import export as tex

    cfg = model.config
    params = {k: v for k, v in model.state_dict().items()
              if k.startswith(("vision_tower.", "mm_projector.", "mm_projector2."))}
    gen = torch.Generator(device="cuda").manual_seed(61)
    volume = torch.rand((EXPORT_BATCH, 1, *cfg.vision.image_size), generator=gen,
                        device="cuda")
    slices = torch.randn((EXPORT_BATCH, cfg.vision.num_slices,
                          cfg.vision.slice_feature_dim), generator=gen,
                         device="cuda")
    with torch.inference_mode():
        model.encode_images_only(volume, slices)
        reset_counts()
        live = model.encode_images_only(volume, slices)
        torch.cuda.synchronize()
        counts = export_counts()
        eager_ms = median_wall_ms(lambda: model.encode_images_only(volume, slices))
    t0 = time.perf_counter()
    blob = tex.export_encode(model, params, batch=EXPORT_BATCH)
    export_s = time.perf_counter() - t0
    tex.save_exported(f"{work}/encode.pt2", blob)
    torch.save((params, volume, slices), f"{work}/encode_inputs.pt")
    n_params = sum(v.numel() for v in params.values())
    print(f"[export] encode of HSENetVLM(VLMConfig()) at batch {EXPORT_BATCH}, "
          f"{n_params / 1e6:.1f} M weights passed as the params dict: exported "
          f"in {export_s:.1f} s, {len(blob) / 1e6:.2f} MB; live encode "
          f"{eager_ms:.2f} ms, launches {counts}")
    return {"live": live.float().cpu(), "counts": counts, "export_s": export_s,
            "bytes": len(blob), "eager_ms": eager_ms}


def export_counts():
    """The kernels' launch counts since the last reset, by entry."""
    from hsenet_torch.ops import flash_attention as tfa
    from hsenet_torch.ops import quant_matvec as tqm

    return {**tfa.launches, **tqm.launches, **tqm.fma_launches}


def export_prompts(cfg):
    """[main]'s prompts: B = 2 rows of BOS + 256 image placeholders + text,
    valid lengths 300 and 320, right-padded."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(1)
    ids = torch.randint(3, 100000, (len(KV_LENS), PROMPT_LEN), generator=gen,
                        device="cuda")
    ids[:, 0] = 1
    ids[:, 1:1 + cfg.num_image_tokens] = IM_PATCH_TOKEN_ID
    for row, n in enumerate(KV_LENS):
        ids[row, n:] = 0
    return ids.to(torch.int32), torch.tensor(KV_LENS, dtype=torch.int32,
                                             device="cuda")


def export_decode_live(card: str, cfg, model, work: str):
    """[export], the decode half, on [serve]'s int8 Phi-4-mini (32 layers,
    int8 projections and embedding): `export_greedy_decode` at [main]'s
    prompts (2 x 320, kv (300, 320)) and 16 new tokens, the artifact and its
    inputs saved under `work`; the live generate's tokens, launches (B1 32
    in the prefill, B5 224 a decode step) and wall beside them. Then the
    host time of one B5 call through the registered op against a direct
    call of the kernel's wrapper."""
    import torch

    from hsenet_torch.eval.generate import make_greedy_generate_llm_only
    from hsenet_torch.ops import quant_matvec as tqm
    from hsenet_torch.utils import export as tex

    llm = model.llm
    params = llm.state_dict()
    ids, kv = export_prompts(cfg)
    generate = make_greedy_generate_llm_only(
        llm, max_new_tokens=EXPORT_NEW_TOKENS, eos_token_id=EOS_TOKEN_ID)
    generate(ids, kv)
    reset_counts()
    live = generate(ids, kv)
    torch.cuda.synchronize()
    counts = export_counts()
    eager_ms = median_wall_ms(lambda: generate(ids, kv), runs=EXPORT_DECODE_RUNS)
    t0 = time.perf_counter()
    blob = tex.export_greedy_decode(
        llm, params, max_new_tokens=EXPORT_NEW_TOKENS, prompt_len=PROMPT_LEN,
        batch=len(KV_LENS), eos_token_id=EOS_TOKEN_ID)
    export_s = time.perf_counter() - t0
    tex.save_exported(f"{work}/decode.pt2", blob)
    t0 = time.perf_counter()
    torch.save((params, ids, kv), f"{work}/decode_inputs.pt")
    save_s = time.perf_counter() - t0
    print(f"[export] greedy decode of [serve]'s int8 Phi-4-mini "
          f"({cfg.llm.num_layers} layers), prompts 2 x {PROMPT_LEN} kv "
          f"{KV_LENS}, {EXPORT_NEW_TOKENS} new tokens: exported in "
          f"{export_s:.1f} s (the prefill and one decode step), "
          f"{len(blob) / 1e6:.2f} MB; live generate {eager_ms:.1f} ms, "
          f"launches {counts}; its weights written for the child in "
          f"{save_s:.1f} s")

    # the op's dispatch: host time a call, B5 at the q projection's shape and
    # 2 rows, through the registered op and by a direct call of the kernel's
    # wrapper, in turns (direct, op, op, direct)
    q_proj = llm.decoder.layers[0].q_proj
    x = torch.randn(len(KV_LENS), cfg.llm.hidden_size, device="cuda",
                    dtype=torch.bfloat16)
    args = (x, q_proj.weight_q, q_proj.weight_scale)

    def host_us(fn):
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(MATVEC_DISPATCH_CALLS):
            fn(*args)
        host = (time.perf_counter() - t) / MATVEC_DISPATCH_CALLS * 1e6
        torch.cuda.synchronize()
        return host

    with torch.inference_mode():
        host_us(tqm.quant_matvec_op)
        turns = [host_us(f) for f in (tqm.quant_matvec_kernel, tqm.quant_matvec_op,
                                      tqm.quant_matvec_op, tqm.quant_matvec_kernel)]
    dispatch = {"direct_us": (turns[0] + turns[3]) / 2,
                "op_us": (turns[1] + turns[2]) / 2}
    dispatch["op_added_us"] = dispatch["op_us"] - dispatch["direct_us"]
    per_step = 7 * cfg.llm.num_layers
    print(f"[export] B5 dispatch on {card}: host time a call at M=2, K x N "
          f"{cfg.llm.hidden_size} x {cfg.llm.q_dim}, {MATVEC_DISPATCH_CALLS} "
          f"calls, in turns direct/op/op/direct: "
          + " / ".join(f"{t:.2f}" for t in turns)
          + f" us; the op adds {dispatch['op_added_us']:.2f} us a call, "
          f"{dispatch['op_added_us'] * per_step / 1e3:.3f} ms a decode step "
          f"({per_step} calls)")
    return {"live": live.cpu(), "counts": counts, "export_s": export_s,
            "bytes": len(blob), "eager_ms": eager_ms, "save_s": save_s,
            "ids": ids, "kv_lens": kv, "dispatch": dispatch}


def run_export_child(card: str, cfg, model, work: str, enc, dec, meanwhile):
    """[export]: the child process loads and calls both artifacts on the
    card (counting their launches) while this process runs `meanwhile()`;
    then the child times its calls alone on the card. The checks: op nodes
    in both graphs (24 flash_fwd in the encode, 32 in the prefill, 224
    quant_matvec in the decode step), no weight inside any program, the
    child's launches equal to the live calls' (B1 24 and 32, B5 224 a decode
    step), features within B1's row tolerance of the live ones, tokens
    equal to the live generate's or parting at a near-tie; export, load and
    call times against eager, and the encode's MFU. Returns the numbers and
    what `meanwhile` returned."""
    import torch

    from hsenet_torch.utils.profiling import mfu, vit3d_encode_flops

    t0 = time.perf_counter()
    proc = subprocess.Popen(
        [sys.executable, "-c", EXPORT_CHILD, work, "5", str(EXPORT_DECODE_RUNS),
         str(EXPORT_TIMEOUT)],
        cwd=str(ROOT), stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        during = meanwhile()
        Path(work, "go").touch()
        stdout, stderr = proc.communicate(timeout=EXPORT_TIMEOUT)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    child_s = time.perf_counter() - t0
    print(stdout.strip())
    if proc.returncode != 0:
        raise AssertionError(f"[export] the child failed (rc {proc.returncode}):\n"
                             f"{stderr[-4000:]}")
    got = torch.load(f"{work}/child.pt", weights_only=True)
    layers = cfg.llm.num_layers
    want_nodes = {
        "encode": {"fn": {"hsenet_torch.flash_fwd.default": 2 * cfg.vision.num_layers}},
        "decode": {"prefill": {"hsenet_torch.flash_fwd.default": layers},
                   "step": {"hsenet_torch.quant_matvec.default": 7 * layers}},
    }
    steps = EXPORT_NEW_TOKENS - 1
    want_counts = {"encode": {"flash_fwd_wgmma": 2 * cfg.vision.num_layers},
                   "decode": {"flash_fwd_wgmma": layers,
                              "quant_matvec": 7 * layers * steps}}
    numbers = {}
    for name, live in (("encode", enc), ("decode", dec)):
        g = got[name]
        # a lifted parameter or buffer (-1), or a constant the size of a
        # weight, would be state inside the artifact (the export itself
        # refuses a constant that shares a weight's storage)
        held = g["lifted"]
        weights = {prog: [k for k, n in h.items() if n < 0 or n >= EXPORT_CONST_MAX]
                   for prog, h in held.items()}
        nonzero = lambda c: {k: n for k, n in c.items() if n}  # noqa: E731
        print(f"[export] {name}: op nodes {g['nodes']} (expected "
              f"{want_nodes[name]}); held besides the graph {held}; child "
              f"launches {nonzero(g['counts'])}, live {nonzero(live['counts'])} "
              f"(expected {want_counts[name]}); load {g['load_s']:.1f} s, call "
              f"{g['wall_ms']:.2f} ms against eager {live['eager_ms']:.2f} ms "
              f"(x{g['wall_ms'] / live['eager_ms']:.3f})")
        if g["nodes"] != want_nodes[name]:
            raise AssertionError(f"[export] {name}: op nodes {g['nodes']}")
        if any(weights.values()):
            raise AssertionError(f"[export] {name}: the artifact holds {weights}")
        if nonzero(g["counts"]) != nonzero(live["counts"]) or \
                nonzero(g["counts"]) != want_counts[name]:
            raise AssertionError(f"[export] {name}: launches differ")
        numbers[name] = {"export_s": live["export_s"], "load_s": g["load_s"],
                         "bytes": live["bytes"], "wall_ms": g["wall_ms"],
                         "eager_ms": live["eager_ms"],
                         "launches": nonzero(g["counts"])}

    # the features: each row's error a share of its largest |live| value
    feats, ref = got["encode"]["result"], enc["live"]
    max_abs, row_rel, ok = compare(feats, ref)
    print(f"[export] encode features {tuple(feats.shape)} against the live "
          f"encode: max abs {max_abs:.3e}, max err / row's max |live| "
          f"{row_rel:.3e} (tol {KERNEL_ROW_TOL})")
    if not ok or feats.shape != ref.shape:
        raise AssertionError("[export] the exported encode disagrees with the live one")
    numbers["encode"]["max_row_rel_err"] = row_rel

    # the tokens: equal, or parting where the chosen token lies in a near-tie
    tokens, want = got["decode"]["result"], dec["live"]
    if tokens.shape != want.shape or tokens.dtype != torch.int32:
        raise AssertionError(f"[export] decode tokens {tuple(tokens.shape)} "
                             f"{tokens.dtype}, live {tuple(want.shape)}")
    parted = []
    for row, n in enumerate(KV_LENS):
        pos, div = greedy_divergences(
            cfg, model.llm, dec["ids"][row:row + 1, :n].long(),
            tokens[row].tolist(), want[row].tolist())
        parted += [(row, *d[1:]) for d in div]
    check_near_ties("export", parted)
    print(f"[export] decode tokens equal to the live generate's in "
          f"{int((tokens == want).all(dim=1).sum())} of {len(KV_LENS)} rows; "
          f"first tokens {tokens[:, :6].tolist()}")
    numbers["decode"]["rows_parted"] = len(parted)

    # the encode's model FLOPs utilisation: two towers at batch 2
    flops = 2 * vit3d_encode_flops(EXPORT_BATCH, cfg.vision)
    numbers["encode"]["mfu"] = {
        "exported": mfu(flops, numbers["encode"]["wall_ms"] / 1e3),
        "eager": mfu(flops, enc["eager_ms"] / 1e3), "tflop": flops / 1e12}
    print(f"[export] encode MFU on {card} (towers only, {flops / 1e12:.3f} TFLOP "
          f"a call, against 989 TFLOP/s bf16): exported "
          f"{numbers['encode']['mfu']['exported']:.2%}, eager "
          f"{numbers['encode']['mfu']['eager']:.2%} (wall clock)")
    numbers["child_s"] = child_s
    numbers["dispatch"] = dec["dispatch"]
    return numbers, during


def hf_logits(model, ids):
    import torch

    with torch.inference_mode():
        logits, _ = model(ids)
    return logits.float()


def run_hf_exports(card: str, cfg, model):
    """[export] the HF exports at full width, the decoder cut to 2 layers:
    [serve]'s int8 state (2 layers) exported dequantised and a LoRA model on
    those weights (r 16, alpha 32, f32 adapters) exported merged, each
    through the port's `convert_hf_phi3` into a plain f32 model whose prefill
    logits must be the source model's (LOGITS_REL_L2), beside a wrong
    variant that must miss (each projection's output channels shifted by
    one; the adapters left out, which is the dequantised model); and each
    export on the card equal to the CPU's export of the same weights within
    HF_EXACT_REL a tensor."""
    import dataclasses

    import numpy as np
    import torch

    from hsenet_torch.configs import LoRAConfig
    from hsenet_torch.models.phi3 import Phi3ForCausalLM, convert_hf_phi3
    from hsenet_torch.utils.export_hf import export_hf_phi3

    int8_cfg = dataclasses.replace(cfg.llm, num_layers=HF_LAYERS)
    float_cfg = dataclasses.replace(int8_cfg, quant_int8=False,
                                    quant_int8_embed=False)
    lora_cfg = dataclasses.replace(float_cfg, lora=LoRAConfig(dropout_rate=0.0))
    kept = tuple(f"decoder.layers.{i}." for i in range(HF_LAYERS))
    int8_state = {k: v for k, v in model.llm.state_dict().items()
                  if not k.startswith("decoder.layers.") or k.startswith(kept)}
    gen = torch.Generator(device="cuda").manual_seed(71)
    ids = torch.randint(3, 100000, (HF_ROWS, HF_TOKENS), generator=gen,
                        device="cuda")

    def built(c, state):
        m = Phi3ForCausalLM(c, dtype=torch.float32, device="cuda")
        m.load_state_dict(state, strict=True)
        return m.eval()

    def exported(state, c):
        """The export on the card, held against the CPU's export."""
        t0 = time.perf_counter()
        on_card = export_hf_phi3(state, c)
        card_s = time.perf_counter() - t0
        on_cpu = export_hf_phi3({k: v.cpu() for k, v in state.items()}, c)
        if sorted(on_card) != sorted(on_cpu):
            raise AssertionError("[export] the card's and the CPU's HF exports "
                                 "hold other tensors")
        worst = max(0.0 if np.array_equal(on_card[k], on_cpu[k]) else
                    float(np.abs(on_card[k] - on_cpu[k]).max()
                          / max(float(np.abs(on_cpu[k]).max()), 1e-30))
                    for k in on_cpu)
        return on_card, card_s, worst

    numbers = {}
    # int8, dequantised; the wrong variant shifts the converted model's
    # projections by one output channel
    sd, card_s, worst = exported(int8_state, int8_cfg)
    base = convert_hf_phi3(sd, float_cfg)
    want = hf_logits(built(int8_cfg, int8_state), ids)
    dequantised = built(float_cfg, base)
    deq_logits = hf_logits(dequantised, ids)
    with torch.no_grad():
        for name, p in dequantised.named_parameters():
            if name.endswith("_proj.weight"):
                p.copy_(p.roll(1, dims=0))
    numbers["int8_dequantised"] = {
        "rel_l2": rel_l2(deq_logits, want),
        "wrong_rel_l2": rel_l2(hf_logits(dequantised, ids), want),
        "card_vs_cpu": worst, "export_s": card_s, "tensors": len(sd)}
    del dequantised
    # LoRA, merged: the dequantised weights as the base, f32 adapters drawn
    # from a seed with B non-zero
    lora_state = {k: v.to("cuda") for k, v in base.items()}
    for name in list(lora_state):
        if name.endswith("_proj.weight"):
            out_dim, in_dim = lora_state[name].shape
            prefix = name[: -len("weight")]
            lora_state[prefix + "lora_a"] = torch.randn(
                in_dim, 16, generator=gen, device="cuda") / in_dim ** 0.5
            lora_state[prefix + "lora_b"] = torch.randn(
                16, out_dim, generator=gen, device="cuda") * HF_LORA_B_STD
    sd, card_s, worst = exported(lora_state, lora_cfg)
    want = hf_logits(built(lora_cfg, lora_state), ids)
    numbers["lora_merged"] = {
        "rel_l2": rel_l2(hf_logits(built(float_cfg, convert_hf_phi3(sd, float_cfg)),
                                   ids), want),
        "wrong_rel_l2": rel_l2(deq_logits, want),
        "card_vs_cpu": worst, "export_s": card_s, "tensors": len(sd)}
    del base, lora_state, sd
    for what, r in numbers.items():
        print(f"[export] export_hf_phi3 on {card}, {what}, Phi-4-mini width at "
              f"{HF_LAYERS} layers: {r['tensors']} tensors in {r['export_s']:.1f} "
              f"s; prefill logits ({HF_ROWS} x {HF_TOKENS}) through "
              f"convert_hf_phi3 against the source model: rel L2 "
              f"{r['rel_l2']:.3e} (tol {LOGITS_REL_L2}), wrong variant "
              f"({'output channels shifted by one' if what.startswith('int8') else 'adapters left out'}) "
              f"{r['wrong_rel_l2']:.3e}; card against CPU export, worst tensor "
              f"{r['card_vs_cpu']:.3e} (tol {HF_EXACT_REL})")
        if not r["rel_l2"] <= LOGITS_REL_L2:
            raise AssertionError(f"[export] {what}: the exported model's logits "
                                 "disagree")
        if r["wrong_rel_l2"] <= LOGITS_REL_L2:
            raise AssertionError(f"[export] {what}: the logits limit passes the "
                                 "wrong variant")
        if not r["card_vs_cpu"] <= HF_EXACT_REL:
            raise AssertionError(f"[export] {what}: the card's HF export differs "
                                 f"from the CPU's: {r['card_vs_cpu']:.3e}")
    return numbers


def check_export_kernels():
    """[kernel-export]: B1 at the exported decode's prefill (2 x 24 x 320
    over a cache of 336 slots, d 128, causal, kv (300, 320)) and B5 at its
    decode steps' 2 rows, at Phi-4-mini's four (K, N), codes read cold
    ([kernel-matvec] holds B5 at 2 rows against its plain version): B1 held
    against its plain version, each timed beside the bound, the plain
    version and the library call. Returns (B1 by shape, B5 by shape,
    B5's CUDA-core yardstick by shape)."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(73)
    skv = PROMPT_LEN + EXPORT_NEW_TOKENS
    name = f"export_prefill_{len(KV_LENS)}x24x{PROMPT_LEN}x{skv}"
    flash = {name: b1_case("kernel-export", name, len(KV_LENS), 24, PROMPT_LEN,
                           skv, 128, KV_LENS, True, gen)}
    library = int8pack_registered()
    matvec, yardstick = {}, {}
    for shape, (k, n) in MATVEC_SHAPES.items():
        r, y = time_matvec_cold("kernel-export", shape, k, n, gen, library,
                                rows=(len(KV_LENS),))
        matvec.update(r)
        yardstick.update(y)
    return flash, matvec, yardstick


def run_dist(card):
    """The parallel slice's two-rank and one-rank phases on a temporary
    directory: [dist-world1], [dist-tp2], [dist-dp2]. Returns (numbers, the
    flash launches by shape of every counted run, B5's launches by shard
    shape, the LLM's first batch lengths by batch size, the forward-only
    shapes' valid lengths by (batch, heads))."""
    import shutil
    import tempfile

    import torch

    root = tempfile.mkdtemp(prefix="hsenet_dist_")
    try:
        paths = write_dist_data(root)
        paths["root"] = root
        with open(f"{root}/paths.json", "w") as f:
            json.dump(paths, f)
        world1 = run_dist_world1(card, paths)
        gc.collect()
        torch.cuda.empty_cache()
        tp2_numbers, tp2 = run_dist_tp2(card, paths)
        gc.collect()
        torch.cuda.empty_cache()
        dp2_numbers, dp2 = run_dist_dp2(card, paths, world1)
        lap("[dist-world1], [dist-tp2], [dist-dp2]")
        gc.collect()
        torch.cuda.empty_cache()
        pp2_numbers, pp2_shapes, pp2_lens = run_dist_pp2(card, paths)
        lap("[dist-pp2]")
        gc.collect()
        torch.cuda.empty_cache()
        sp2_numbers, sp2_shapes, sp2_lens = run_dist_sp2(card, paths)
        lap("[dist-sp2]")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    numbers = {"world1": world1[0], "tp2": tp2_numbers, "dp2": dp2_numbers,
               "pp2": pp2_numbers, "sp2": sp2_numbers}
    # launches by shape: [dist-world1]'s counted runs, two ranks' of each
    # two-rank run (rank 0's counts, twice: the ranks launch alike)
    shapes = dict(world1[1])
    for counts in (tp2["shapes"], tp2["gen_shapes"], dp2["clip_shapes"],
                   dp2["vlm"]["shapes"], dp2["vlm_fsdp"]["shapes"], dp2["eval_shapes"]):
        for k, n in counts.items():
            shapes[k] = shapes.get(k, 0) + 2 * n
    # the pipeline's stages (each rank's own counts) and the ring's CLI runs
    for counts in (pp2_shapes, sp2_shapes):
        for k, n in counts.items():
            shapes[k] = shapes.get(k, 0) + n
    steps = tp2["steps"] + MAX_NEW_TOKENS - 1
    matvec_counts = {name: 2 * per_layer * tp2["model_layers"] * steps
                     for name, per_layer in TP_MATVEC_PER_LAYER.items()}
    if sum(matvec_counts.values()) != 2 * (tp2["matvec"] + tp2["gen_matvec"]):
        raise AssertionError("[dist-tp2] B5 launches by shard shape do not add up")
    lens = dict(world1[2])
    for n in (*dp2["vlm"]["lens"], *pp2_lens, *sp2_lens):
        lens.setdefault(len(n), n)
    # the pipeline's microbatch of one row: the first batch's first row
    lens.setdefault(1, pp2_lens[0][:1])
    # the forward-only shapes' valid lengths: the tp engine's first request,
    # the evaluations' first batch (one row a call)
    fwd_lens = {(1, 12): (len(dist_requests(dist_vlm_config())[0]["prompt_ids"]),),
                (1, 24): world1[5][:1]}
    return numbers, shapes, matvec_counts, lens, fwd_lens


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke run needs one",
              file=sys.stderr)
        return 1
    if not (ROOT / "hsenet_torch" / "csrc").is_dir():
        print(f"chip_smoke: no hsenet_torch package beside {__file__}",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    import shutil
    import tempfile

    card = card_line()
    print(f"[card] {card}")
    print(f"[env] python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}")

    from hsenet_torch.ops import _build
    from hsenet_torch.ops import int8_pv as tpv
    from hsenet_torch.ops import quant_matvec as tqm
    from hsenet_torch.ops.flash_attention import KERNELS

    t0 = time.perf_counter()
    # one nvcc per source, all at once
    _build.load_all((*KERNELS, tqm.KERNEL, tpv.KERNEL, tpv.YARDSTICK))
    print(f"[build] {time.perf_counter() - t0:.1f} s for "
          f"{sorted(_build.BUILD_LOGS) or 'cached'}")
    for name, log in _build.BUILD_LOGS.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"[build] {name}: {line.strip()}")

    lap("start and build")
    per_shape = check_flash_kernel()
    bwd = check_flash_bwd_kernels()
    bwd_d256 = {k: bwd.pop(k) for k in ("flash_bwd_dq_d256", "flash_bwd_dkv_d256")}
    wide = check_flash_wide()
    lap("[kernel], [kernel-bwd], [kernel-wide]")
    clip_kernels = check_clip_kernels()
    lap("[kernel-time] at the CLIP shapes")
    vit2d_kernels = check_vit2d_kernels()
    lap("[kernel] at the ViT2D shapes")
    # the CT data path: NIfTI volumes at chest-CT size through preprocess_ct,
    # then the BiomedCLIP trunk's slice features from them
    ct_root = tempfile.mkdtemp(prefix="hsenet_ct_")
    try:
        ct_numbers, nii, meta, stored = run_ct_data(card, ct_root)
        gc.collect()
        torch.cuda.empty_cache()
        vit2d_numbers = run_vit2d(card, ct_root, nii, meta, stored)
    finally:
        shutil.rmtree(ct_root, ignore_errors=True)
    del stored
    gc.collect()
    torch.cuda.empty_cache()
    lap("[ct-data], [vit2d]")
    # the f32 route: the CLIs' --synthetic paths on the card, then the f32
    # kernels at the shapes they launched and at QFormer's and the CLIP
    # tower's
    cli_numbers, cli_shapes = run_cli_serve(card)
    train_f32_numbers, train_f32_shapes = run_train_f32(card)
    f32_kernels, f32_index = check_f32_kernels({**cli_shapes, **train_f32_shapes})
    lap("[cli-serve], [train-f32], [kernel-f32]")
    matvec, matvec_old = check_matvec_kernel()
    pv = check_pv_kernel()
    pv_launches = run_pv_probe()
    encode_numbers, encode_shapes = run_encode_w8a8(card)
    lap("[kernel-matvec], [kernel-pv], [encode-w8a8]")
    gc.collect()
    torch.cuda.empty_cache()
    launches, counts, numbers, main_model = run_main_path(card)
    # [export], the encode half: the artifact of [main]'s model, run later
    # in a child process beside the decode artifact
    export_root = tempfile.mkdtemp(prefix="hsenet_export_")
    export_enc = export_encode_live(card, main_model, export_root)
    del main_model
    gc.collect()
    torch.cuda.empty_cache()
    lap("[main], [export] encode")
    train_counts, train_numbers = run_train_path(card)
    gc.collect()
    torch.cuda.empty_cache()
    grad_numbers = check_train_grads()
    gc.collect()
    torch.cuda.empty_cache()
    lap("[train], [train-grads]")
    # the evaluation CLI on a manifest at full width (one model for its
    # four runs), B1 at the shapes it launched, then the checkpoint and
    # converter paths on that model
    eval_model, eval_numbers, eval_shapes = run_cli_evaluate(card)
    eval_kernels, eval_index = check_eval_kernels(eval_shapes,
                                                  eval_numbers["prompt_lens"])
    ckpt_numbers, fma_shapes, fma_counts = run_ckpt(card, eval_model)
    del eval_model
    gc.collect()
    torch.cuda.empty_cache()
    lap("[cli-evaluate], [kernel-eval], [ckpt]")
    serve_cfg, serve_model = build_serving_model()
    serve_numbers, serve_tokens = run_serve_path(card, serve_cfg, serve_model)
    serve_numbers["logits"] = check_serve_logits(serve_cfg, serve_model)
    serve_numbers["kv_int8"], kv_int8_tokens = run_serve_kv_int8(serve_cfg, serve_model)
    serve_numbers["long"] = run_serve_long(serve_cfg, serve_model)
    serve_numbers["profiles"] = profile_serve(serve_cfg, serve_model)
    # prompt-lookup speculative decoding on the same model: the engine,
    # then batch 1 on the bare LLM (last: its ceiling run overwrites the
    # LLM's weights)
    spec_engine, spec_tokens = run_serve_spec(card, serve_cfg, serve_model,
                                              serve_numbers, serve_tokens,
                                              kv_int8_tokens)
    # sampling on the same engine: a one-token nucleus against the greedy
    # and speculative engines' tokens, seeds, speculative sampling
    sample_serve = run_serve_sample(card, serve_cfg, serve_model, serve_tokens,
                                    spec_tokens, spec_engine)
    # [export], the decode half on [serve]'s model (before [spec], whose
    # ceiling run overwrites its LLM's weights), the child process that runs
    # both artifacts, the HF exports, then B1 and B5 at the shapes the
    # exported decode launched that no phase above timed
    lap("[serve] ... [serve-sample]")
    export_dec = export_decode_live(card, serve_cfg, serve_model, export_root)
    # the HF exports run while the child process loads the artifacts
    export_numbers, export_numbers["hf"] = run_export_child(
        card, serve_cfg, serve_model, export_root, export_enc, export_dec,
        lambda: run_hf_exports(card, serve_cfg, serve_model))
    shutil.rmtree(export_root, ignore_errors=True)
    del export_enc, export_dec
    gc.collect()
    torch.cuda.empty_cache()
    export_flash, export_matvec, export_matvec_old = check_export_kernels()
    lap("[export]")
    spec_numbers = run_spec(card, serve_cfg, serve_model)
    spec_numbers["engine"] = spec_engine
    del serve_model
    gc.collect()
    torch.cuda.empty_cache()
    lap("[spec]")
    sample_numbers = run_sample(card)
    spec_law_numbers = run_spec_law(card)
    cli_sample_numbers = run_cli_sample(card)
    gc.collect()
    torch.cuda.empty_cache()
    lap("[sample], [spec-law], [cli-sample]")
    # Llama-3-8B's shape at full depth, int8, under the engine; then B5 and
    # B1 at its shapes
    llama_root = tempfile.mkdtemp(prefix="hsenet_llama_")
    try:
        llama_numbers = run_llama(card, llama_root)
    finally:
        shutil.rmtree(llama_root, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    llama_matvec, llama_flash = check_llama_kernels(
        int(statistics.median(llama_numbers["prompt_lens"])))
    lap("[llama], [kernel-llama]")
    variant_numbers, qformer_kernels, qformer_counts = run_variants(card)
    gc.collect()
    torch.cuda.empty_cache()
    lap("[variants]")

    # the CLIP pretraining stages: stage 1, stage 2 against the stage-1
    # model it just trained, one step's gradients against the plain path,
    # and the stage-1 step at 16,385 tower tokens
    teacher, stage1_counts, stage1_numbers = run_clip_stage1(card)
    stage2_counts, stage2_numbers = run_clip_stage2(card, teacher)
    del teacher
    gc.collect()
    torch.cuda.empty_cache()
    clip_grad_numbers = check_clip_grads()
    gc.collect()
    torch.cuda.empty_cache()
    long_counts, long_numbers = run_clip_long(card)
    gc.collect()
    torch.cuda.empty_cache()
    augment_numbers = run_clip_augment(card, stage1_numbers["step_ms_median"])
    gc.collect()
    torch.cuda.empty_cache()
    lap("[clip-stage1] ... [clip-long], [clip-augment]")

    # the three training CLIs through their `main` on manifests, then B1 and
    # B3 at the shapes they launched that no phase above held
    train_cli_numbers, train_cli_shapes, train_cli_lens = run_cli_train(card)
    gc.collect()
    torch.cuda.empty_cache()
    known = {**clip_shape_index(), **vit2d_shape_index(),
             **{key: ("flash_fwd", name) for key, name in eval_index.items()}}
    train_cli_kernels, train_cli_index = check_train_cli_kernels(
        train_cli_shapes, known, train_cli_lens)
    lap("[cli-train], [kernel-train-cli]")

    # the segmentation slice: B1 and B3 at its shapes; SegVol with its
    # predictor, the sliding window and the Swin encoder; the seg finetune
    # and the seg and REC evaluations through the CLIs on a seg manifest;
    # then B1 and B3 at the shapes those runs launched that no phase above
    # timed; the legacy masked CLIP
    seg_kernels = check_seg_kernels()
    lap("[kernel-seg]")
    segvol_numbers, segvol_shapes = run_segvol(card)
    lap("[segvol]")
    seg_root = tempfile.mkdtemp(prefix="hsenet_seg_")
    try:
        seg_manifest = write_seg_data(seg_root)
        train_seg_numbers, train_seg_shapes, train_seg_lens = run_cli_train_seg(
            card, seg_root, seg_manifest)
        gc.collect()
        torch.cuda.empty_cache()
        (eval_seg_numbers, rec_shapes, eval_seg_f32_shapes,
         eval_seg_lens) = run_cli_evaluate_seg(card, seg_root, seg_manifest)
    finally:
        shutil.rmtree(seg_root, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    known_seg = {**known, **train_cli_index, **seg_shape_index()}
    train_seg_kernels, train_seg_index = check_train_cli_kernels(
        train_seg_shapes, known_seg, train_seg_lens)
    known_seg.update(train_seg_index)
    rec_kernels, rec_index = {}, {}
    gen = torch.Generator(device="cuda").manual_seed(43)
    for key in sorted(k for k in rec_shapes if k not in known_seg):
        _, b, h, sq, skv, d = key
        name = rec_index[key] = f"eval_rec_{b}x{h}x{sq}x{skv}"
        rec_kernels[name] = b1_case("kernel-seg", name, b, h, sq, skv, d,
                                    eval_seg_lens[key], d != 64, gen)
    known_seg.update({k: ("flash_fwd", n) for k, n in rec_index.items()})
    seg_f32_kernels, seg_f32_index = check_seg_f32_kernels(eval_seg_f32_shapes,
                                                           eval_seg_lens)
    lap("[cli-train-seg], [cli-evaluate-seg], their kernels")
    masked_numbers, masked_shapes = run_clip_masked(card)
    gc.collect()
    torch.cuda.empty_cache()
    lap("[clip-masked]")

    # the parallel slice: the CLIs in a one-rank NCCL group and on two ranks
    # sharing the card (tp = 2 serving, dp = 2 training and evaluation),
    # then B5 at the tp shards and B1 / B3 at the shapes those runs
    # launched that no phase above held
    (dist_numbers, dist_shapes, tp_matvec_counts, dist_lens,
     dist_fwd_lens) = run_dist(card)
    gc.collect()
    torch.cuda.empty_cache()
    lap("[dist] the parallel phases' end")
    tp_matvec, dist_kernels, dist_index = check_tp_kernels(
        dist_shapes, known_seg, dist_lens, dist_fwd_lens)
    lap("[kernel-tp]")

    # launches on the main paths, by shape: one generate run, one training
    # step (its towers run at the tower shape) and the counted serving runs
    # (closed loop, open loop, the long-budget engine): 24 tower launches
    # per encode miss, 32 per admission at its prefill shape
    served = (serve_numbers["closed_loop"], serve_numbers["open_loop"],
              *(sample_serve[k] for k in ("collapse", "hot", "hot_again",
                                          "hot_other_seed")))
    admitted = (*served, *spec_numbers["engine"].values(),
                sample_serve["spec_collapse"], sample_serve["spec_hot"])
    long_run = serve_numbers["long"]
    fwd_counts = {
        "tower": counts["tower"] + train_counts["fwd_d64"] + sum(
            r["flash_fwd_launches"]["d64"] for r in (*admitted, long_run)),
        "encode_w8a8_tower": encode_numbers["flash_launches"],
        "prefill": counts["prefill"],
        "train": train_counts["fwd_d128_lse"],
        # admissions of the greedy and the speculative engines
        "serve_prefill": 32 * sum(r["prefix_misses"] for r in admitted),
        "serve_prefix_hit": 32 * sum(r["prefix_hits"] for r in admitted),
        "serve_long": long_run["flash_fwd_launches"]["d128"],
        # the four counted [cli-evaluate] runs, by the shape each launched
        **{eval_index[key]: n for key, n in eval_shapes.items()},
        # [vit2d]'s preprocess_ct --vit2d-checkpoint run
        "vit2d_32": vit2d_numbers["launches"],
        # the Llama engines' admissions (greedy, speculative, sampled and
        # the converted model's), one shape at every prompt length
        **{name: sum(llama_numbers[r]["flash_fwd_launches"]
                     for r in ("greedy", "speculative", "sampled"))
           + llama_numbers["convert"]["flash_fwd_launches"]
           for name in llama_flash},
        # QFormer's attentions in [variants] (head dim 96)
        **qformer_counts,
    }
    # the matvec's launches at 8 rows: the decode steps of the closed and
    # open loops (the long-budget engine runs 2 slots)
    matvec_steps = sum(r["decode_steps"] for r in served)
    matvec_counts = {name: 32 * per_layer * matvec_steps
                     for name, per_layer in MATVEC_PER_LAYER.items()}
    # the Llama engines' decode steps at 8 rows (greedy, sampled) and the
    # converted 2-layer model's at 1 row
    llama_steps = sum(llama_numbers[r]["decode_steps"] for r in ("greedy", "sampled"))
    convert_run = llama_numbers["convert"]
    for name, per_layer in LLAMA_MATVEC_PER_LAYER.items():
        matvec_counts[name] = llama_config().num_layers * per_layer * llama_steps
        matvec_counts[f"{name}_m1"] = (LLAMA_CONVERT_LAYERS * per_layer
                                       * convert_run["decode_steps"])
    if sum(matvec_counts.values()) != sum(
            r["quant_matvec_launches"] for r in (
                *served, llama_numbers["greedy"], llama_numbers["sampled"],
                convert_run)):
        raise AssertionError("quant_matvec launches by shape do not add up")
    bwd_counts = {"train": train_counts["bwd"]}
    # the CLIP steps' launches by shape: one step each of [clip-stage1],
    # [clip-stage2] with the teacher recomputed and served from the cache,
    # and [clip-long]
    index = clip_shape_index()
    clip_counts = {k: {} for k in ("flash_fwd", "flash_bwd")}
    for counts in (stage1_counts, stage2_counts["recompute"],
                   stage2_counts["cached_hit"], long_counts):
        for key, n in counts.items():
            kernel, shape = index[key]
            clip_counts[kernel][shape] = clip_counts[kernel].get(shape, 0) + n
    fwd_counts.update(clip_counts["flash_fwd"])
    bwd_counts.update(clip_counts["flash_bwd"])
    # the [cli-train] runs' launches, by the shape each launched
    train_cli_counts = {"flash_fwd": {}, "flash_bwd": {}}
    for key, n in train_cli_shapes.items():
        kernel, shape = known.get(key) or train_cli_index[key]
        counts = fwd_counts if kernel == "flash_fwd" else bwd_counts
        counts[shape] = counts.get(shape, 0) + n
        train_cli_counts[kernel][shape] = train_cli_counts[kernel].get(shape, 0) + n
    train_cli_numbers["launches_by_shape"] = train_cli_counts
    # this slice's launches by shape: [segvol]'s forward and sliding window,
    # the [cli-train-seg] run, the [cli-evaluate-seg] rec run (the seg run is
    # f32, below) and the three [clip-masked] steps
    seg_counts = {"flash_fwd": {}, "flash_bwd": {}}
    for path in (segvol_shapes, train_seg_shapes, rec_shapes, masked_shapes):
        for key, n in path.items():
            kernel, shape = known_seg[key]
            counts = fwd_counts if kernel == "flash_fwd" else bwd_counts
            counts[shape] = counts.get(shape, 0) + n
            seg_counts[kernel][shape] = seg_counts[kernel].get(shape, 0) + n
    # the parallel slice's launches by shape
    dist_counts = {"flash_fwd": {}, "flash_bwd": {}}
    known_dist = {**known_seg, **dist_index}
    for key, n in dist_shapes.items():
        kernel, shape = known_dist[key]
        counts = fwd_counts if kernel == "flash_fwd" else bwd_counts
        counts[shape] = counts.get(shape, 0) + n
        dist_counts[kernel][shape] = dist_counts[kernel].get(shape, 0) + n
    dist_numbers["launches_by_shape"] = dist_counts
    matvec_counts.update(tp_matvec_counts)
    # the exported encode and decode, as the child process counted them: the
    # towers at the tower shape, the prefill at its capacity of 336 slots,
    # the decode steps at 2 rows
    fwd_counts["tower"] += export_numbers["encode"]["launches"]["flash_fwd_wgmma"]
    fwd_counts.update({name: 32 for name in export_flash})
    export_m2 = {f"{name}_m2": 32 * per_layer * (EXPORT_NEW_TOKENS - 1)
                 for name, per_layer in MATVEC_PER_LAYER.items()}
    if sum(export_m2.values()) != export_numbers["decode"]["launches"]["quant_matvec"]:
        raise AssertionError("[export] quant_matvec launches by shape do not add up")
    matvec_counts.update(export_m2)
    # the f32 launches by shape: the two [cli-serve] runs and one step of
    # [train-f32]
    f32_counts = {k: {} for k in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")}
    for counts in (cli_shapes, train_f32_shapes):
        for key, n in counts.items():
            kernel, shape = f32_index[key]
            f32_counts[kernel][shape] = f32_counts[kernel].get(shape, 0) + n
    # the f32 launches of [cli-evaluate-seg]'s seg run (SegVol and BERT)
    f32_kernels["flash_fwd"].update(seg_f32_kernels)
    for key, n in eval_seg_f32_shapes.items():
        name = seg_f32_index[key]
        f32_counts["flash_fwd"][name] = f32_counts["flash_fwd"].get(name, 0) + n
        seg_counts["flash_fwd"][name] = n

    def entry(name, source, replaces, shapes, path_counts, note):
        # a kernel that no path launches: its per-launch numbers, summed
        # over the shapes it was timed at
        weights = path_counts or dict.fromkeys(shapes, 1)

        def per_run(key):  # per-launch times x launches at each shape
            timed = [(shapes[s][key], n) for s, n in weights.items()]
            if any(t is None for t, _ in timed):  # no partial sums
                return None
            return sum(t * n for t, n in timed)

        # the shape that holds most of the bound names what bounds it
        heaviest = max(weights, key=lambda s: shapes[s]["bound_ms"] * weights[s])
        return {
            "name": name,
            "route": "cuda",
            "source": source,
            "replaces": replaces,
            "launches": int(sum(path_counts.values())),
            "max_abs_err": max(r["max_abs_err"] for r in shapes.values()),
            "ms": per_run("ms"),
            "plain_ms": per_run("plain_ms"),
            "bound_ms": per_run("bound_ms"),
            "bound_by": shapes[heaviest]["bound_by"],
            "library_ms": per_run("library_ms"),
            "times_are": note,
            "shapes": {s: {**shapes[s], "launches": path_counts.get(s, 0)}
                       for s in shapes},
        }

    note = ("sums over one generate run, one finetune step, the counted "
            "serving runs (closed loop, open loop, long-budget engine), the four "
            "counted [cli-evaluate] runs (MRG greedy, engine, spec-decode; VQA "
            "engine; the eval_ shapes) and one "
            "step each of [clip-stage1], [clip-stage2] (teacher recomputed, "
            "and a teacher-cache hit) and [clip-long], and the six [cli-train] "
            "runs whole (train_clip_stage1, train_clip_stage2 recomputed and "
            "cached, train_vlm mrg and resumed, vqa --int8-base; the "
            "train_cli_ shapes) and the seventh, train_vlm "
            "--online-slice-features (its trunk at vit2d_64), and [vit2d]'s "
            "preprocess_ct --vit2d-checkpoint run (vit2d_32); this slice's runs: "
            "[segvol]'s forward at batch 2 and its sliding window (segvol_), "
            "the [cli-train-seg] run whole (SegVol at segvol_vit, the rest at "
            "their shapes), [cli-evaluate-seg]'s rec run and the three "
            "[clip-masked] steps (masked_ and the clip_ shapes); the parallel "
            "slice's runs ([dist-world1]'s seven CLI runs, the two ranks' "
            "serve --tp 2 and generate of [dist-tp2], the CLIP step, train_vlm "
            "--dp 2 --zero1 and --fsdp and evaluate --dp 2 of [dist-dp2]; the "
            "sixteenth slice's: both stages of [dist-pp2]'s train_vlm --pp 2 "
            "(its microbatch at dist_llm_1x24x800) and both ranks of "
            "[dist-sp2]'s three --sp 2 CLI runs (BERT and the towers outside the "
            "ring); tp2_, dist_ and "
            "_dp2 shapes, forward-only dist_ shapes timed at every key valid): "
            "per-launch times at each shape x its launches there")
    jax_fa = "hsenet_tpu/ops/flash_attention.py"
    f32_note = ("f32 route (TF32 products), sums over the two [cli-serve] runs, "
                "one step of [train-f32] and [cli-evaluate-seg]'s seg run (SegVol "
                "and the CLIP text tower in f32, eval_seg_f32_): per-launch times at the padded "
                "width at each shape x its launches there; bound at the TF32 "
                "peak; library is f32 SDPA")
    wide_note = ("the wide route (ROADMAP C2: bf16 and f16 above head dim 256, "
                 "f32 above 128, at the next multiple of 64), on no path: "
                 "per-launch times at each [kernel-wide] shape summed; bound at "
                 "the bf16 peak, or the TF32 peak in f32; library is SDPA")
    pv_note = ("sums over the probe run (python -m hsenet_torch.scripts."
               "probe_int8_pv, all four modes at G 192, M 1152, K 2176, N 64) "
               "of this kernel's launches, per-launch times x launches, or "
               "where it launched none (the yardstick), over all four modes "
               "once; library_ms is null: no single PyTorch call "
               "computes the integer modes, and the bf16 mode's torch.bmm time "
               "stands under shapes")
    kernels = [
        entry("flash_fwd", "hsenet_torch/csrc/flash_fwd_wgmma.cu",
              f"{jax_fa}:109 (_flash_kernel), {jax_fa}:256 (_flash_kernel_stream)",
              {**per_shape, **clip_kernels["flash_fwd"], **encode_shapes,
               **eval_kernels, **train_cli_kernels["flash_fwd"], **vit2d_kernels,
               **llama_flash, **qformer_kernels, **seg_kernels["flash_fwd"],
               **train_seg_kernels["flash_fwd"], **rec_kernels,
               **dist_kernels["flash_fwd"], **export_flash},
              fwd_counts, note + "; one W8A8 encode at its batch-8 tower shape "
              "and the speculative engine's admissions ([spec]'s one prefill "
              "is left out); the six [serve-sample] runs' admissions; the "
              "[llama] engines' admissions at their one launch shape (timed at "
              "the median prompt length); QFormer's attentions in [variants] "
              "(head dim 96 at the kernel's 128, copies included; the other "
              "[variants] launches are held there, not summed here); [export]'s "
              "exported encode (at the tower shape) and exported decode's "
              "prefill (export_prefill_, a cache of 336 slots), as the child "
              "process that ran the artifacts counted them; bf16 and "
              "f16, every path's launches counted under "
              "flash_fwd_wgmma; old_ms under shapes is the mma.sync "
              "csrc/flash_fwd.cu's bf16 build at the same shape (a yardstick "
              "no path launches); the f16, head dim 160 and 256 shapes (C2) "
              "are on no path"),
        entry("flash_bwd", "hsenet_torch/csrc/flash_bwd.cu",
              f"{jax_fa}:552 (_bwd_dq_kernel), {jax_fa}:611 (_bwd_dkv_kernel), "
              f"{jax_fa}:678 (_bwd_dq_kernel_stream), {jax_fa}:750 "
              "(_bwd_dkv_kernel_stream)",
              {**bwd, **clip_kernels["flash_bwd"], **train_cli_kernels["flash_bwd"],
               **seg_kernels["flash_bwd"], **train_seg_kernels["flash_bwd"],
               **dist_kernels["flash_bwd"]},
              bwd_counts,
              note + "; bf16; plain and library times compute dQ, dK and dV"),
        entry("flash_bwd_dq_d256", "hsenet_torch/csrc/flash_bwd_dq.cu",
              f"{jax_fa}:552 (_bwd_dq_kernel), {jax_fa}:678 (_bwd_dq_kernel_stream)",
              bwd_d256["flash_bwd_dq_d256"], {},
              "bf16 and f16 at head dim 256 (C2), on no path: per-launch times "
              "summed over the shapes; plain and library times compute dQ, dK "
              "and dV"),
        entry("flash_bwd_dkv_d256", "hsenet_torch/csrc/flash_bwd_dkv.cu",
              f"{jax_fa}:611 (_bwd_dkv_kernel), {jax_fa}:750 (_bwd_dkv_kernel_stream)",
              bwd_d256["flash_bwd_dkv_d256"], {},
              "bf16 and f16 at head dim 256 (C2), on no path: per-launch times "
              "summed over the shapes; plain and library times compute dQ, dK "
              "and dV"),
        entry("flash_fwd_wide", "hsenet_torch/csrc/flash_fwd.cu",
              f"{jax_fa}:109 (_flash_kernel), {jax_fa}:256 (_flash_kernel_stream)",
              wide["flash_fwd_wide"], {}, wide_note),
        entry("flash_bwd_dq_wide", "hsenet_torch/csrc/flash_bwd_dq.cu",
              f"{jax_fa}:552 (_bwd_dq_kernel), {jax_fa}:678 (_bwd_dq_kernel_stream)",
              wide["flash_bwd_dq_wide"], {},
              wide_note + "; plain and library times compute dQ, dK and dV"),
        entry("flash_bwd_dkv_wide", "hsenet_torch/csrc/flash_bwd_dkv.cu",
              f"{jax_fa}:611 (_bwd_dkv_kernel), {jax_fa}:750 (_bwd_dkv_kernel_stream)",
              wide["flash_bwd_dkv_wide"], {},
              wide_note + "; plain and library times compute dQ, dK and dV"),
        entry("flash_fwd_f32", "hsenet_torch/csrc/flash_fwd.cu",
              f"{jax_fa}:109 (_flash_kernel), {jax_fa}:256 (_flash_kernel_stream)",
              f32_kernels["flash_fwd"], f32_counts["flash_fwd"], f32_note),
        entry("flash_bwd_dq_f32", "hsenet_torch/csrc/flash_bwd_dq.cu",
              f"{jax_fa}:552 (_bwd_dq_kernel), {jax_fa}:678 (_bwd_dq_kernel_stream)",
              f32_kernels["flash_bwd_dq"], f32_counts["flash_bwd_dq"],
              f32_note + "; plain and library times compute dQ, dK and dV"),
        entry("flash_bwd_dkv_f32", "hsenet_torch/csrc/flash_bwd_dkv.cu",
              f"{jax_fa}:611 (_bwd_dkv_kernel), {jax_fa}:750 (_bwd_dkv_kernel_stream)",
              f32_kernels["flash_bwd_dkv"], f32_counts["flash_bwd_dkv"],
              f32_note + "; plain and library times compute dQ, dK and dV"),
        entry("quant_matvec", "hsenet_torch/csrc/quant_matvec.cu",
              "hsenet_tpu/ops/quant_matvec.py:42",
              {**matvec, **llama_matvec, **tp_matvec, **export_matvec},
              matvec_counts,
              "the tensor-core entry hsenet_quant_matvec_mma (every bf16 call); "
              "sums over the decode steps of the closed and open serving loops "
              "and the four counted non-speculative [serve-sample] runs at 8 "
              "slots, the [llama] greedy and sampled engines at 8 slots (the "
              "llama_ shapes) and the converted 2-layer Llama at 1 slot (the "
              "llama_ _m1 shapes), the two ranks' decode steps of [dist-tp2]'s "
              "serve --tp 2 and generate at the tp2_ shard shapes, [export]'s "
              "exported decode steps at 2 rows (the _m2 shapes, counted by the "
              "child process that ran the artifact): per-launch "
              "times at each (K, N), codes read cold, x its "
              "launches there; library is a matmul on a bf16 copy of the weight; "
              "old_ms under shapes is the CUDA-core entry timed in turns with "
              "it; int8pack_ms is torch._weight_int8pack_mm (null where the "
              "card's PyTorch has no CUDA kernel for it); Phi-4-mini's _m1 "
              "shapes (M = 1) and the LM head's table are on no counted path"),
        entry("quant_matvec_fma", "hsenet_torch/csrc/quant_matvec.cu",
              "hsenet_tpu/ops/quant_matvec.py:42",
              {**matvec_old, **fma_shapes, **export_matvec_old},
              fma_counts,
              "the CUDA-core entry hsenet_quant_matvec_fma: its f32 build is "
              "the f32 route, launched by [ckpt]'s served run (serve --quant-int8 "
              "--llm-only --synthetic --checkpoint, 8 slots; per-launch times at "
              "each ckpt_ (K, N) x its launches there; library is an f32 matmul "
              "on a converted copy); its bf16 build at the other shapes is the "
              "yardstick of the tensor-core entry (no path launches it; library "
              "a matmul on a bf16 copy)"),
        *(entry(name, f"hsenet_torch/csrc/{name}.cu",
                "scripts/_probe_pallas_int8.py:10 (make_kernel)", pv[name],
                {mode: n for mode, n in pv_launches[name].items() if n},
                pv_note + ("" if name == tpv.KERNEL else "; the mma.sync "
                           "yardstick of int8_pv_wgmma"))
          for name in (tpv.KERNEL, tpv.YARDSTICK)),
        clip_grad_numbers.pop("kernel"),
    ]
    clip = {"stage1": stage1_numbers, "stage2": stage2_numbers,
            "grads": clip_grad_numbers, "long": long_numbers,
            "launches_per_step": {
                name: {" ".join(map(str, k)): n for k, n in c.items()}
                for name, c in (("stage1", stage1_counts),
                                ("stage2_recompute", stage2_counts["recompute"]),
                                ("stage2_cached_hit", stage2_counts["cached_hit"]),
                                ("long", long_counts))}}
    print(json.dumps({"kernels": kernels, "main_path": numbers,
                      "cli_serve": cli_numbers, "train_f32": train_f32_numbers,
                      "train": train_numbers, "train_grads": grad_numbers,
                      "serve": serve_numbers, "clip": clip,
                      "encode_w8a8": encode_numbers, "spec": spec_numbers,
                      "cli_evaluate": eval_numbers, "ckpt": ckpt_numbers,
                      "cli_train": train_cli_numbers, "ct_data": ct_numbers,
                      "vit2d": vit2d_numbers, "clip_augment": augment_numbers,
                      "sample": sample_numbers, "spec_law": spec_law_numbers,
                      "serve_sample": sample_serve, "cli_sample": cli_sample_numbers,
                      "llama": llama_numbers, "variants": variant_numbers,
                      "segvol": segvol_numbers, "cli_train_seg": train_seg_numbers,
                      "cli_evaluate_seg": eval_seg_numbers,
                      "clip_masked": masked_numbers, "dist": dist_numbers,
                      "export": export_numbers,
                      "seg_launches_by_shape": seg_counts, "card": card}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--dist-rank"]:
        sys.exit(dist_child(sys.argv[2:]))
    sys.exit(main())
