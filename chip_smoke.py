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
   launches counted by entry (none may reach the tensor-core entry; the
   `--synthetic` models carry no int8 weights, as in the JAX CLI, so the
   CUDA-core entry's f32 count is 0 too);
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
   once at the LM head's 3072 x 200064 table (off the path);
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
   against the plain sdpa path, per group, beside two planted faults;
16. [clip-long] the stage-1 step at `--patch-size 2 8 8` (16,385 tower
   tokens), batch 2: launches at that shape, finite losses, a non-zero
   gradient in every tower block, step time, peak memory and a profile;
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
    tensor-core entry once at the LM head's table. Returns the numbers by
    shape of each entry."""
    import torch

    from hsenet_torch.ops import quant_matvec as tqm

    gen = torch.Generator(device="cuda").manual_seed(4)
    dev = "cuda"

    def row_share(out, ref):
        err = (out.float() - ref.float()).abs()
        scale = ref.float().abs().amax(dim=-1, keepdim=True).clamp_min(1e-30)
        share = torch.where(out.float().isfinite(), err / scale, math.inf)
        return err.max().item(), share.max().item()

    def codes(k, n):
        w = torch.randint(-127, 128, (n, k), generator=gen, device=dev,
                          dtype=torch.int8)
        return w, (0.5 + torch.rand(n, generator=gen, device=dev)) / (127 * k ** 0.5)

    def hold(tag, kernel, x, w, scale):
        out = kernel(x, w, scale)
        again = kernel(x, w, scale)
        torch.cuda.synchronize()
        ref = tqm.quant_matvec_int8_reference(x, w, scale)
        max_abs, share = row_share(out, ref)
        wrong = {
            "scales shifted by one channel":
                tqm.quant_matvec_int8_reference(x, w, scale.roll(1)),
            "last 16 codes of K dropped":
                tqm.quant_matvec_int8_reference(x[:, :-16], w[:, :-16], scale),
        }
        wrong = {what: row_share(o, ref)[1] for what, o in wrong.items()}
        same = torch.equal(out, again)
        print(f"[kernel-matvec] {tag}: x{tuple(x.shape)} w_q{tuple(w.shape)} "
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

    for name, (k, n) in {**MATVEC_SHAPES, **MATVEC_CHECK_SHAPES}.items():
        w, scale = codes(k, n)
        for m in MATVEC_CHECK_ROWS:
            x = torch.randn(m, k, generator=gen, device=dev, dtype=torch.bfloat16)
            hold(f"{name} M={m} bf16, plan {tuple(tqm.mma_plan(m, k, n))}",
                 tqm.quant_matvec_mma_kernel, x, w, scale)
            if name in MATVEC_SYNTHETIC:
                hold(f"{name} M={m} f32, CUDA-core entry",
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
    w, scale = codes(*MATVEC_CHECK_SHAPES["synthetic_64x32"])
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

    library = torch._C._dispatch_has_kernel_for_dispatch_key(
        "aten::_weight_int8pack_mm", "CUDA")
    print(f"[kernel-matvec] torch._weight_int8pack_mm has a CUDA kernel: {library}")
    results, yardstick = {}, {}
    for name, (k, n) in MATVEC_SHAPES.items():
        copies = int(MATVEC_COLD_BYTES // (k * n)) + 1
        w, scale = codes(k, n)
        ws = [w] + [w.clone() for _ in range(copies - 1)]
        wbs = [t.to(torch.bfloat16) for t in ws]
        scale_b = scale.to(torch.bfloat16)
        turn = itertools.count()

        def cold(fn, pool):
            return lambda: fn(pool[next(turn) % copies])

        for m in (8, 1):
            x = torch.randn(m, k, generator=gen, device=dev, dtype=torch.bfloat16)
            ref = tqm.quant_matvec_int8_reference(x, w, scale)
            new_err = row_share(tqm.quant_matvec_mma_kernel(x, w, scale), ref)[0]
            old_err = row_share(tqm.quant_matvec_fma_kernel(x, w, scale), ref)[0]
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
            key = name if m == 8 else f"{name}_m1"
            r = results[key] = {"max_abs_err": new_err, "ms": (turns[0] + turns[3]) / 2,
                                "old_ms": (turns[1] + turns[2]) / 2, **shared}
            yardstick[key] = {"max_abs_err": old_err, "ms": r["old_ms"], **shared}
            lib8 = ("not registered" if r["int8pack_ms"] is None
                    else f"{r['int8pack_ms']:.4f} ms")
            print(f"[kernel-matvec] {name} M={m}, codes read cold ({copies} "
                  f"copies in turn), in turns new/old/old/new: tensor cores "
                  f"{r['ms']:.4f} ms ({nbytes / r['ms'] / 1e6:.0f} GB/s, "
                  f"{r['bound_ms'] / r['ms']:.1%} of the bound), CUDA cores "
                  f"{r['old_ms']:.4f} ms ({nbytes / r['old_ms'] / 1e6:.0f} GB/s, "
                  f"{r['bound_ms'] / r['old_ms']:.1%}); turns "
                  + " / ".join(f"{t:.4f}" for t in turns)
                  + f"; plain {r['plain_ms']:.4f} ms, bf16 matmul on a "
                  f"converted copy {r['library_ms']:.4f} ms, _weight_int8pack_mm "
                  f"{lib8}; bound {r['bound_ms']:.4f} ms ({r['bound_by']}: "
                  f"{r['mbytes']:.2f} MB, {r['gflop']:.3f} GFLOP)")
        del ws, wbs

    # the LM head's table (no path routes it through B5): the streaming
    # rate without a launch's fixed cost
    k, n = MATVEC_LM_HEAD
    w, scale = codes(k, n)
    x = torch.randn(8, k, generator=gen, device=dev, dtype=torch.bfloat16)
    max_abs, share = row_share(tqm.quant_matvec_mma_kernel(x, w, scale),
                               tqm.quant_matvec_int8_reference(x, w, scale))
    nbytes = k * n + 2 * 8 * k + 2 * 8 * n + 4 * n
    r = results[f"lm_head_{k}x{n}"] = {
        "max_abs_err": max_abs, "ms": time_ms(
            lambda: tqm.quant_matvec_mma_kernel(x, w, scale), reps=5),
        "old_ms": None, "plain_ms": None, "library_ms": None, "int8pack_ms": None,
        "bound_ms": nbytes / PEAK_BYTES_PER_S * 1e3, "bound_by": "bytes",
        "mbytes": nbytes / 1e6, "gflop": 2 * 8 * k * n / 1e9, "rows": 8}
    print(f"[kernel-matvec] LM head {k} x {n} at M=8 (off the path), plan "
          f"{tuple(tqm.mma_plan(8, k, n))}: {r['ms']:.4f} ms "
          f"({nbytes / r['ms'] / 1e6:.0f} GB/s, {r['bound_ms'] / r['ms']:.1%} of "
          f"the bound {r['bound_ms']:.4f} ms); max err / row's max |ref| {share:.3e}")
    if not share <= MATVEC_ROW_TOL:
        raise AssertionError("quant_matvec disagrees at the LM head's shape")
    del w
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
    kv_len 4096 and 3000) against the plain versions, a chunk of batch rows
    and heads at a time, beside wrong variants (on the first chunk); each
    timed against its bound, the plain version and one SDPA call (its
    backward for dQ, dK/dV). The time per valid (query, key) pair at 16,385
    tokens must stay within PAIR_TIME_RATIO of the time at 2,049."""
    import torch
    import torch.nn.functional as F
    from einops import rearrange

    from hsenet_torch.ops import flash_attention as tfa

    dev = "cuda"
    gen = torch.Generator(device=dev).manual_seed(9)
    results = {"flash_fwd": {}, "flash_bwd": {}}
    for name, (b, h, s, d), kv_lens, causal, (rows, heads), fwd_kinds in (
            clip_kernel_cases()):
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
                                                      retain_graph=True))
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
    generate run, in all and at each path shape, and the main path's
    numbers."""
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
    return launches, by_shape, numbers


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
    the same step with planted faults in the attention backward."""
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
    del model, params, g_p
    return {"loss_kernel": loss_k, "loss_plain": loss_p, "grad_rel_l2": rel,
            "planted_faults_rel_l2": wrong}


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
    from hsenet_torch.ops import attention
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
    for _ in range(CLIP_GRADS_WARM_STEPS):
        state, metrics = step(state, batch, 0)
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
            "planted_faults_rel_l2": wrong, "batch": CLIP_GRADS_BATCH}


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
    with the int8 KV cache on [serve-kv-int8]'s requests."""
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
    numbers = {}
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
        got = [results[u] for u in sorted(results)]
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
    return numbers


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
    launches, counts, numbers = run_main_path(card)
    gc.collect()
    torch.cuda.empty_cache()
    train_counts, train_numbers = run_train_path(card)
    gc.collect()
    torch.cuda.empty_cache()
    grad_numbers = check_train_grads()
    gc.collect()
    torch.cuda.empty_cache()
    lap("[main], [train], [train-grads]")
    serve_cfg, serve_model = build_serving_model()
    serve_numbers, serve_tokens = run_serve_path(card, serve_cfg, serve_model)
    serve_numbers["logits"] = check_serve_logits(serve_cfg, serve_model)
    serve_numbers["kv_int8"], kv_int8_tokens = run_serve_kv_int8(serve_cfg, serve_model)
    serve_numbers["long"] = run_serve_long(serve_cfg, serve_model)
    serve_numbers["profiles"] = profile_serve(serve_cfg, serve_model)
    # prompt-lookup speculative decoding on the same model: the engine,
    # then batch 1 on the bare LLM (last: its ceiling run overwrites the
    # LLM's weights)
    spec_engine = run_serve_spec(card, serve_cfg, serve_model, serve_numbers,
                                 serve_tokens, kv_int8_tokens)
    spec_numbers = run_spec(card, serve_cfg, serve_model)
    spec_numbers["engine"] = spec_engine
    del serve_model
    gc.collect()
    torch.cuda.empty_cache()
    lap("[serve] ... [spec]")

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
    lap("[clip-stage1] ... [clip-long]")

    # launches on the main paths, by shape: one generate run, one training
    # step (its towers run at the tower shape) and the counted serving runs
    # (closed loop, open loop, the long-budget engine): 24 tower launches
    # per encode miss, 32 per admission at its prefill shape
    served = (serve_numbers["closed_loop"], serve_numbers["open_loop"])
    admitted = (*served, *spec_numbers["engine"].values())
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
    }
    # the matvec's launches at 8 rows: the decode steps of the closed and
    # open loops (the long-budget engine runs 2 slots)
    matvec_steps = sum(r["decode_steps"] for r in served)
    matvec_counts = {name: 32 * per_layer * matvec_steps
                     for name, per_layer in MATVEC_PER_LAYER.items()}
    if sum(matvec_counts.values()) != sum(
            r["quant_matvec_launches"] for r in served):
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
    # the f32 launches by shape: the two [cli-serve] runs and one step of
    # [train-f32]
    f32_counts = {k: {} for k in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")}
    for counts in (cli_shapes, train_f32_shapes):
        for key, n in counts.items():
            kernel, shape = f32_index[key]
            f32_counts[kernel][shape] = f32_counts[kernel].get(shape, 0) + n

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
            "serving runs (closed loop, open loop, long-budget engine) and one "
            "step each of [clip-stage1], [clip-stage2] (teacher recomputed, "
            "and a teacher-cache hit) and [clip-long]: per-launch times at "
            "each shape x its launches there")
    jax_fa = "hsenet_tpu/ops/flash_attention.py"
    f32_note = ("f32 route (TF32 products), sums over the two [cli-serve] runs "
                "and one step of [train-f32]: per-launch times at the padded "
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
              {**per_shape, **clip_kernels["flash_fwd"], **encode_shapes},
              fwd_counts, note + "; one W8A8 encode at its batch-8 tower shape "
              "and the speculative engine's admissions ([spec]'s one prefill "
              "is left out); bf16 and f16, every path's launches counted under "
              "flash_fwd_wgmma; old_ms under shapes is the mma.sync "
              "csrc/flash_fwd.cu's bf16 build at the same shape (a yardstick "
              "no path launches); the f16, head dim 160 and 256 shapes (C2) "
              "are on no path"),
        entry("flash_bwd", "hsenet_torch/csrc/flash_bwd.cu",
              f"{jax_fa}:552 (_bwd_dq_kernel), {jax_fa}:611 (_bwd_dkv_kernel), "
              f"{jax_fa}:678 (_bwd_dq_kernel_stream), {jax_fa}:750 "
              "(_bwd_dkv_kernel_stream)",
              {**bwd, **clip_kernels["flash_bwd"]}, bwd_counts,
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
              "hsenet_tpu/ops/quant_matvec.py:42", matvec, matvec_counts,
              "the tensor-core entry hsenet_quant_matvec_mma (every bf16 call); "
              "sums over the decode steps of the closed and open serving loops "
              "at 8 slots: per-launch times at each (K, N), codes read cold, x its "
              "launches there; library is a matmul on a bf16 copy of the weight; "
              "old_ms under shapes is the CUDA-core entry timed in turns with "
              "it; int8pack_ms is torch._weight_int8pack_mm (null where the "
              "card's PyTorch has no CUDA kernel for it); the _m1 shapes (M = 1) "
              "and the LM head's table are on no counted path"),
        entry("quant_matvec_fma", "hsenet_torch/csrc/quant_matvec.cu",
              "hsenet_tpu/ops/quant_matvec.py:42", matvec_old, {},
              "the CUDA-core entry hsenet_quant_matvec_fma in bf16, the "
              "yardstick of the tensor-core entry (no path launches it; its f32 "
              "build is the f32 route): per-launch times at each (K, N) and M "
              "summed; library is a matmul on a bf16 copy of the weight"),
        *(entry(name, f"hsenet_torch/csrc/{name}.cu",
                "scripts/_probe_pallas_int8.py:10 (make_kernel)", pv[name],
                {mode: n for mode, n in pv_launches[name].items() if n},
                pv_note + ("" if name == tpv.KERNEL else "; the mma.sync "
                           "yardstick of int8_pv_wgmma"))
          for name in (tpv.KERNEL, tpv.YARDSTICK)),
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
                      "card": card}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
