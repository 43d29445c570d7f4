#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from `src/repro_torch/csrc/` (one nvcc per
source, all started together), holds each against its plain PyTorch
version on the card, and drives the port's main paths, each with its
launch counters set to 0 just before it and read just after:

* SpMV (schedule -> sharded kernel -> observe/refine -> sharded kernel) on
  the paper's `wikipedia` matrix at its published size (3,566,907 rows),
  checked against a float64 host product;
* BFS (`levels(0)`, cross-checked against the flat walk at every
  level, then observe/refine and `levels(0)` again) at Rodinia BFS's
  largest published input, 1,000,000 vertices, on both graph kinds of the
  paper's BF workload, checked against a host BFS (scipy);
* K-Means assignment (run, cross-check, observe/refine, run, and two more
  rounds' schedules) at the shape of Rodinia K-Means' `kdd_cup` input,
  494,020 points x 34 features, K = 5, checked against a float64 host
  argmin;
* MoE expert dispatch (plan -> schedule -> sharded kernel -> expert load
  -> `refine_cap_scale` -> next plan, three closed-loop rounds) at the
  width of one OLMoE-1B-7B MoE layer (64 experts, top-8, D = 2048, expert
  F = 1024, float32) over 4,096 tokens, checked against a float64 host
  evaluation of 64 sampled tokens;
* Zamba2-1.2B serving (`Engine.generate`: iCh-chunked prefill, each chunk
  re-running the prefix through 6 flash-attention and 32 SSD-scan
  launches, then 32 decode steps) at full width (38 layers, d_model 2048,
  random float32 weights from a seeded generator) on 4 prompts of 2,048
  tokens, held to three bars: the last chunk's logits equal a one-shot
  prefill bit for bit, decode at position S matches a fresh prefill of
  S + 1 tokens, the logits are finite;
* xlstm-350m serving (`Engine.generate` with an incremental prefill: each
  chunk feeds only its own tokens through `prefill_extend`, 18 SSD-scan
  launches at N = 512, Pd = 513 from the last chunk's states, then 32
  decode steps) at full width (24 layers: 18 mLSTM, 6 sLSTM, d_model
  1024) on the same prompts' shape, held to the incremental prefill
  equalling a one-shot prefill bit for bit (logits and every block state)
  with no prefix rerun, decode against a fresh prefill, finite logits, and
  the scan from a state at that shape against its plain version and the
  float64 recurrence, split calls bit for bit;
* qwen2-1.5b serving (`Engine.generate` with an incremental prefill: each
  chunk writes its keys and values into the prompt-sized cache and
  attends from its offset, 28 flash-attention launches a call, then 32
  decode steps) at full width (28 layers, d_model 1536, qkv biases drawn
  from a seed, tied embeddings) on the same prompts' shape, held to the
  incremental prefill equalling a one-shot prefill bit for bit (logits
  and the whole KV cache), decode against a fresh prefill, finite logits,
  two runs the same ids; the flash kernel from a query offset at its
  extend shapes against its plain version (its rows == one call's rows,
  bit for bit); the continuous batcher (8 Poisson arrivals, IChAdaptive
  on a wall clock) whose every request equals the prompt served alone;
  and olmo-1b, glm4-9b and phi3-medium-14b at full width with 2 layers;
* olmoe-1b-7b serving (`Engine.generate` with an incremental prefill:
  each chunk through `prefill_extend`, 16 flash-attention and 16 expert
  kernel launches a call, every MoE layer's expert FFN planned on the
  host (`plan_dispatch` -> `LoopScheduler(p=SM count).build(
  "moe-dispatch")`) and run by `ich_moe_sharded`, dropless; then 32
  decode steps, 16 expert kernel launches each) at full width and depth
  (16 layers, 64 experts top-8, 6.9 B float32 parameters from a seeded
  generator) on the same prompts' shape, held to the incremental prefill
  equalling a one-shot prefill bit for bit (logits and the whole KV
  cache), decode against a fresh prefill, finite logits, two runs the
  same ids; the expert kernel's rows of a token planned alone equal to
  its rows planned among the one-shot prefill's 8,192 tokens; the expert
  kernel at a prefill chunk's shape and flash from an offset at 16 / 16
  heads against their plain versions; the continuous batcher over 4
  requests; and deepseek-moe-16b at full width cut to 3 layers (its dense
  first layer, shared experts);
* whisper-small serving (`prefill` with frames, then 32 greedy
  `decode_step`s: the engine passes no frames) uncut (12 encoder and 12
  decoder layers, d_model 768, learned positions) on 4 segments of 1,500
  random frame rows and 192-token prompts: 36 flash launches a prefill
  (12 non-causal encoder blocks over 1,500 ragged keys, 12 causal
  self-attentions without RoPE, 12 non-causal cross-attentions of 192
  queries against 1,500 keys), held to decode against a fresh prefill,
  finite logits, two runs the same ids, and the kernel at the encoder's
  and the cross shapes against its plain version;
* phi-3-vision-4.2b serving uncut (32 layers, d_model 3,072, heads of
  96, 3.8 B float32 parameters): `Engine.generate` text-only on the same
  prompts' shape with the dense bars (incremental prefill == one-shot
  bits), and an image prefill of 576 patch rows before 1,472 tokens,
  decode from position 2,048 held against a prefill of one more token
  with the same patches; the kernel at (4, 2,048, 32, 96) causal and from
  an offset at GQA 1 against its plain version and SDPA;
* qwen2-1.5b training at full width and depth (`init_train_state` ->
  `make_train_step` -> 8 bfloat16 steps of 4 x 2,048 tokens from
  `data.pipeline.Pipeline`, remat on: 56 flash forward and 28 flash
  backward launches a step), held to finite losses that fall, finite
  non-zero grad norms and the launch counts; one more step from the same
  state under remat_policy "dots" (its grad norm against "nothing"'s);
  the flash backward kernel (three CUDA kernels a call, bfloat16 on the
  tensor cores) at that shape in float32 and bfloat16 against its plain
  version, two calls the same bits, each CUDA kernel's device time, the
  forward's log-sum-exp against torch.logsumexp, and the serving shapes'
  bits unchanged when the log-sum-exp is written; one float32 step at 2
  layers on the card against the CPU; `train()` with a failure after step
  2 and a resume whose losses equal an uninterrupted run's;
* phi-3-vision-4.2b and whisper-small training at full width and depth
  (the same path, 6 bfloat16 steps each: 4 x (576 patch rows + 1,472
  tokens), 32 flash forward launches twice and 32 backward launches a
  step; 4 x (1,500 frame rows + 448 tokens), 36 and 36: 12 encoder, 12
  self, 12 cross), held to the same bars with the launches by kind; the
  flash backward kernel at the four shapes these steps give it (dh 96
  causal at 2,048; dh 64 non-causal over 1,500 ragged keys, 448 queries
  against 1,500 keys, causal at 448) against its plain version per block
  of 64 rows; one float32 step of each at 2 layers against the CPU;
* xlstm-350m and zamba2-1.2b training at full width and depth (the same
  path, 2 and 6 bfloat16 steps of 4 x 2,048 tokens: 2 x 18 SSD-scan
  forward and 18 scan backward launches a step for xlstm, whose 6 sLSTM
  blocks run their step loops by autograd; 2 x 32 and 32 for zamba2, with
  2 x 6 and 6 flash launches for its shared attention block), held to
  the same bars; the scan's backward kernel (six CUDA kernels a call,
  seven with q and k shared by the heads) at both models' shapes in
  float32 and bfloat16 against its plain version, two calls the same
  bits, each CUDA kernel's registers, shared memory and CTAs an SM, and
  the scan's forward as training runs it at the same shapes; one sLSTM
  block's loop, forward and backward, timed apart; one
  float32 step of each cut to ("X", "S") and ("M", "A") over 2 x 512
  tokens against the CPU;
* olmoe-1b-7b training at full width cut to 10 of its 16 layers (the
  same path, 5 bfloat16 steps of 4 x 2,048 tokens from capacity scales
  of ones: every MoE layer planned at capacity with the steal round, 2 x
  10 expert kernel and 10 expert backward launches a step, the balancer
  updating the scales after each), held to the same bars and to entries
  dropped and stolen; the expert kernel and its backward
  (`csrc/ich_moe_bwd.cu`, six launches of five CUDA kernels a call,
  bfloat16 tensor-core passes over split float32 operands) at that training
  shape, under drawn capacity scales, against their plain versions, two
  calls the same bits,
  the backward the same bits at p = 132 and p = 2, and given x and dy
  in bfloat16 (fewer passes) the same bits as given their float32
  casts, each CUDA kernel's device time; one float32 step of olmoe-1b-7b and of deepseek-moe-16b
  (its dense first layer and one MoE layer with shared experts) at 2
  layers over 2 x 128 and 2 x 256 tokens against the CPU, the new
  capacity scales equal;
* olmoe-1b-7b training over a torch.distributed mesh at full width cut
  to 2 layers (`phase_train_mesh`): `make_smoke_mesh()` (1 x 1 ("data",
  "model"), NCCL) and `make_train_step` with its `DistContext`, 3
  bfloat16 steps of 4 x 2,048 tokens under drawn capacity scales, equal
  to the unmeshed step's bit for bit (metrics, every state leaf, the
  scales), each path's launches counted from its own steps; expert
  parallelism rank by rank in one process at 2 and 4 model ranks
  (`moe_local` over each rank's experts, summed) against one rank,
  outputs and gradients (the expert kernel and its backward once a rank,
  counted for each number of ranks apart); and `python -m repro_torch.launch.train` / `launch.serve` at
  their tiny preset, exit 0.
* the tensor parallelism of dense layers and the dry run
  (`phase_tp_dryrun`) at qwen2-1.5b's full width: rank by rank in one
  process at 2 and 4 model ranks (each rank's query heads through the
  flash kernel and its MLP columns, 2 layers, 4 x 2,048 float32 tokens)
  against the unmeshed layers, outputs and gradients, flash and its
  backward launched tp times a layer; the full placements over the 1 x 1
  NCCL mesh, 2 bfloat16 steps, the unmeshed bits; the dry run's predicted
  argument + temp bytes of the training main path against its measured
  peak within 20 %; and the dry run's and the roofline's command lines
  (olmo-1b decode_32k, olmoe-1b-7b train_4k on the 32 x 8 production
  mesh), exit 0 with OK.

Then two paths of the schedule layer, each counted on its own:

* the schedule pipeline on the card (`LoopScheduler(backend="torch")` ->
  `device_lowering()` -> `pack_csr_torch` -> `ich_spmv_sharded` at
  wikipedia, whose y and costs must equal the host-built op's bit for bit,
  and `device_lowering()` of every other main path's schedule, through
  the `segment_fold` and `lpt_assign` kernels of `csrc/lpt.cu`): every
  lowering element-identical to the host `build_schedule` +
  `shard_schedule` (tile costs bit for bit), with and without `n_steps=`;
  the host path (schedule, shard, pack + upload) and the device path
  (CSR upload, lower, pack) timed per shape; both kernels at wikipedia's
  full size against np.bincount / `partition_tiles` and their plain
  versions, the same bits twice, `lpt_assign`'s rounds and each call's
  device time;
* sharded recovery (`Schedule.reshard_survivors` -> the completed-prefix
  and survivor layouts through rows 2, 4 and 6 -> `combine`) for SpMV,
  a mid-depth BFS step on both graphs and K-Means, one or two workers
  dead, with a ragged checkpoint or none: the combined output must equal
  the fault-free run's bits and each run's cost stream must sum per
  worker to its layout's `worker_cost`.

For the flat walks (`ich_spmv`, `ich_bfs_step`: two kernels a call over
the whole card) it logs the launch shape, the longest run of one row (the
serial part of their fold) and the device time of each phase. For the
sharded walks (`ich_spmv_sharded`, `ich_bfs_step_sharded`: one CTA per
worker, a ring of supersteps) it logs the launch shape, the worker balance
(the most live slots of one worker over the mean) and the device time
beside the host's enqueue time; for both K-Means walks
(`ich_kmeans_assign` and `ich_kmeans_assign_sharded`, each one launch over
the whole card, the sharded one in chunks of whole supersteps) their grids,
checked to span the card, and the same split; for MoE the device time and
achieved rate of each product, and for flash attention and the SSD scan
(on the tensor cores) the device time of each of their kernels and the
achieved rate of float32 work.

Each sharded kernel that emits a cost stream (SpMV, BFS, K-Means, MoE) is
held against the port's discrete-event simulator at its main path's
shapes: `Schedule.replay_sharded` under zero overhead and jitter runs each
tile on the worker the kernel's shard layout gave it, and its per-worker
busy time must equal the per-worker sums of the emitted stream (within
COST_RTOL), its makespan their max. On the K-Means path the threaded
executor runs the schedule's work units on four host threads
(`parallel_for_units`), its chunk timings are folded in
(`observe(ExecStats)` -> `refine()`), and the refined generation's kernel
must give the main path's ids.

It times every kernel beside its plain version, its bound and PyTorch
computing the same function (cuSPARSE SpMV, `torch.cdist` argmin, MoE's
capacity-buffer `torch.bmm` form, `scaled_dot_product_attention`; the SSD
scan has no single PyTorch call; it is listed twice, at Zamba2's and at
xlstm-350m's shape, flash seven times, at Zamba2's prefill, from an
offset at qwen2-1.5b's and olmoe-1b-7b's extend shapes, at
whisper-small's encoder and cross-attention shapes and at phi-3-vision's
prefill and extend shapes (dh 96), and the expert
kernel twice, at the dispatch phase's shape and at olmoe-1b-7b's serving
shape; the flash backward kernel five times, at qwen2-1.5b's,
phi-3-vision's and whisper-small's three training shapes, beside the
backward of `scaled_dot_product_attention`; the scan's backward and its
forward (as training runs it, keeping the chunk states) twice each, at
zamba2-1.2b's and xlstm-350m's training shapes in bfloat16, with no
single PyTorch call to set beside them; the expert kernel a third time
and its backward at olmoe-1b-7b's training shape, beside the
capacity-buffer `bmm` form and its autograd backward), and prints one
JSON line per result
(and each phase's wall seconds).
Any failed check raises, so the script exits non-zero and prints no final
line. It needs CUDA and the repository's `src/` beside it.

The last line is `{"ok": true, "device": {...}}`; the line before the
last gives the card's name and power limit as nvidia-smi reports them, and
the line before that lists the kernels with their launches on the main
path and their times.
"""
from __future__ import annotations

import json
import os
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

SEED = 0
N_ROWS = 3_566_907          # SuiteSparse Gleich/wikipedia-20070206
MATRIX = "wikipedia"
SMALL_ROWS = 20_000
N_VERTICES = 1_000_000      # Rodinia BFS, largest published input (graph1M)
GRAPHS = ("uniform", "scale_free")   # the paper's BF workload (Fig. 5a)
N_POINTS, N_FEATURES, N_CLUSTERS = 494_020, 34, 5   # Rodinia kdd_cup
KMEANS_ROUNDS = 3
HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory
F32_FLOPS = 67e12           # H100 SXM float32 outside the tensor cores
F64_FLOPS = 34e12           # H100 SXM float64 outside the tensor cores
TF32_FLOPS = 495e12         # H100 SXM dense TF32 on the tensor cores
BF16_FLOPS = 989e12         # H100 SXM dense bfloat16 on the tensor cores
RTOL = ATOL = 1e-5          # kernel vs plain: same adds, other reductions
HOST_RTOL = 1e-4            # vs float64, relative to each row's sum |a*x|
COST_RTOL = 1e-6            # float32 cost-stream sums vs float64 totals
EXEC_THREADS = 4            # host threads of the executor phase
TIE_RTOL = 1e-5             # K-Means ids may differ from float64 only here
# MoE: one OLMoE-1B-7B MoE layer (src/repro/configs/olmoe_1b_7b.py)
MOE_EXPERTS, MOE_TOP_K, MOE_D, MOE_F = 64, 8, 2048, 1024
MOE_TOKENS = 4096
MOE_ROWS_PER_TILE = 2       # as the reference's MoE benchmark lowers it
MOE_ROUNDS = 3
MOE_SAMPLE = 64             # tokens checked against float64 on the host
MOE_TOL = 1e-4              # kernel vs plain: 3xTF32 sums vs cuBLAS float32
PASS = "src/repro/kernels/"
KERNELS = {  # name -> (CUDA source, the Pallas kernel it replaces)
    "ich_spmv": ("src/repro_torch/csrc/ich_spmv.cu",
                 PASS + "ich_spmv/ich_spmv.py:109"),
    "ich_spmv_sharded": ("src/repro_torch/csrc/ich_spmv.cu",
                         PASS + "ich_spmv/ich_spmv.py:215"),
    "ich_bfs_step": ("src/repro_torch/csrc/ich_bfs.cu",
                     PASS + "ich_bfs/ich_bfs.py:90"),
    "ich_bfs_step_sharded": ("src/repro_torch/csrc/ich_bfs.cu",
                             PASS + "ich_bfs/ich_bfs.py:195"),
    "ich_kmeans_assign": ("src/repro_torch/csrc/ich_kmeans.cu",
                          PASS + "ich_kmeans/ich_kmeans.py:83"),
    "ich_kmeans_assign_sharded": ("src/repro_torch/csrc/ich_kmeans.cu",
                                  PASS + "ich_kmeans/ich_kmeans.py:163"),
    "ich_moe_sharded": ("src/repro_torch/csrc/ich_moe.cu",
                        PASS + "ich_moe/ich_moe.py:197"),
    "flash_attention": ("src/repro_torch/csrc/flash_attention.cu",
                        PASS + "flash_attention/flash_attention.py:95"),
    "mamba_scan": ("src/repro_torch/csrc/mamba_scan.cu",
                   PASS + "mamba_scan/mamba_scan.py:83"),
    # the same kernel at xlstm-350m's mLSTM shape, from a state
    "mamba_scan_xlstm": ("src/repro_torch/csrc/mamba_scan.cu",
                         PASS + "mamba_scan/mamba_scan.py:83"),
    # the flash kernel from a query offset at qwen2-1.5b's extend shape
    "flash_attention_offset": ("src/repro_torch/csrc/flash_attention.cu",
                               PASS + "flash_attention/flash_attention.py:95"),
    # the expert kernel at olmoe-1b-7b's serving shape (a prefill chunk's
    # MoE layer, dropless) and flash at its extend shape (16 / 16 heads)
    "ich_moe_sharded_serving": ("src/repro_torch/csrc/ich_moe.cu",
                                PASS + "ich_moe/ich_moe.py:197"),
    "flash_attention_moe": ("src/repro_torch/csrc/flash_attention.cu",
                            PASS + "flash_attention/flash_attention.py:95"),
    # the flash kernel at whisper-small's encoder (non-causal over 1,500
    # ragged keys) and cross-attention shapes (192 queries, 1,500 keys),
    # and at phi-3-vision's dh 96: one shot (causal) and from an offset
    "flash_attention_whisper_encoder": (
        "src/repro_torch/csrc/flash_attention.cu",
        PASS + "flash_attention/flash_attention.py:95"),
    "flash_attention_whisper_cross": (
        "src/repro_torch/csrc/flash_attention.cu",
        PASS + "flash_attention/flash_attention.py:95"),
    "flash_attention_vlm": ("src/repro_torch/csrc/flash_attention.cu",
                            PASS + "flash_attention/flash_attention.py:95"),
    "flash_attention_vlm_offset": (
        "src/repro_torch/csrc/flash_attention.cu",
        PASS + "flash_attention/flash_attention.py:95"),
    # the flash kernel's gradient replaces XLA's automatic derivative of the
    # reference's attention in its training loss, not a Pallas kernel:
    # `blockwise_attention` (:84) from 1,024 tokens on, `full_attention`
    # (:151) below; at qwen2-1.5b's training shape, then at phi-3-vision's
    # (dh 96) and at whisper-small's encoder (non-causal, ragged keys),
    # cross-attention (448 queries, 1,500 keys) and decoder (448, causal)
    "flash_attention_bwd": ("src/repro_torch/csrc/flash_attention_bwd.cu",
                            "src/repro/models/attention.py:84"),
    "flash_attention_bwd_vlm": (
        "src/repro_torch/csrc/flash_attention_bwd.cu",
        "src/repro/models/attention.py:84"),
    "flash_attention_bwd_whisper_encoder": (
        "src/repro_torch/csrc/flash_attention_bwd.cu",
        "src/repro/models/attention.py:84"),
    "flash_attention_bwd_whisper_cross": (
        "src/repro_torch/csrc/flash_attention_bwd.cu",
        "src/repro/models/attention.py:151"),
    "flash_attention_bwd_whisper_self": (
        "src/repro_torch/csrc/flash_attention_bwd.cu",
        "src/repro/models/attention.py:151"),
    # the SSD scan's gradient replaces XLA's automatic derivative of the
    # reference's chunked scan in its training loss (`chunked_gated_scan`,
    # a lax.scan of einsums), not a Pallas kernel: at zamba2-1.2b's training
    # shape (q and k shared by the heads), then at xlstm-350m's mLSTM shape
    "mamba_scan_bwd": ("src/repro_torch/csrc/mamba_scan_bwd.cu",
                       "src/repro/models/ssm.py:32"),
    "mamba_scan_bwd_xlstm": ("src/repro_torch/csrc/mamba_scan_bwd.cu",
                             "src/repro/models/ssm.py:32"),
    # the scan's forward in bfloat16 as training runs it (keeping each
    # chunk's state for the backward), at the same two shapes
    "mamba_scan_train": ("src/repro_torch/csrc/mamba_scan.cu",
                         PASS + "mamba_scan/mamba_scan.py:83"),
    "mamba_scan_train_xlstm": ("src/repro_torch/csrc/mamba_scan.cu",
                               PASS + "mamba_scan/mamba_scan.py:83"),
    # the schedule pipeline's two kernels replace XLA code of the reference's
    # jitted pipeline, not a Pallas kernel: its segment sum and LPT loop
    # the expert kernel at olmoe-1b-7b's training shape (8,192 tokens at
    # capacity with the steal round), and the expert FFN's gradient, which
    # replaces XLA's derivative of the reference's expert einsums inside its
    # training loss (`moe_local`'s slot-buffer products), not a Pallas
    # kernel
    "ich_moe_sharded_train": ("src/repro_torch/csrc/ich_moe.cu",
                              PASS + "ich_moe/ich_moe.py:197"),
    "ich_moe_bwd": ("src/repro_torch/csrc/ich_moe_bwd.cu",
                    "src/repro/models/moe.py:258"),
    "segment_fold": ("src/repro_torch/csrc/lpt.cu",
                     "src/repro/core/tiling_jax.py:198"),
    "lpt_assign": ("src/repro_torch/csrc/lpt.cu",
                   "src/repro/core/tiling_jax.py:292"),
}
# the schedule pipeline and recovery (this slice's paths) re-use the main
# paths' schedules, ops and inputs, which each phase leaves here by name
SHAPES: dict = {}
PIPELINE_REPS = 3           # synchronized runs a pipeline timing is the median of
# lpt_assign's latency bound: its rounds times the least a round can take,
# ASSUMED (not measured) to be 300 SM cycles: two block barriers, two block
# minima and a four-way search of four dependent shared-memory loads of ~30
# cycles, at the card's maximum SM clock (nvidia-smi clocks.max.sm)
LPT_ROUND_CYCLES = 300
# Zamba2-1.2B serving (src/repro/configs/zamba2_1_2b.py, full width)
LM_ARCH = "zamba2-1.2b"
LM_BATCH, LM_PROMPT, LM_NEW = 4, 2048, 32
LM_MAX_SEQ = 4096
FLASH_TOL = {"float32": 2e-5, "bfloat16": 2e-2}   # tests/test_kernels.py:23-24
# xlstm-350m serving (src/repro/configs/xlstm_350m.py, full width), the
# same batch, prompts and new tokens
XLSTM_ARCH = "xlstm-350m"
SCAN_TOL = 2e-4        # tests/test_kernels.py:206-209 (main shape: of sum |terms|)
SCAN_TOL_BF16 = 0.2    # bfloat16 q, k, v and y: 10 x the reference's 2e-2
DECODE_TOL = 2e-3        # decode vs fresh prefill (tests/test_arch_smoke.py)
# qwen2-1.5b serving (src/repro/configs/qwen2_1_5b.py, full width), the
# same batch, prompts and new tokens; the flash kernel from a query offset
# at its extend shapes: chunks of DENSE_CHUNK queries against the prompt
DENSE_ARCH = "qwen2-1.5b"
DENSE_CHUNK = 512
DENSE_OFFSETS = (0, 512, 1536)            # kernel vs plain
DENSE_ROW_OFFSETS = (64, 256, 1536)       # offset rows == one-shot rows
DENSE_ODD_OFFSETS = (1, 100, 1000)        # not multiples of 64: reported
DENSE_ROWS = (256, 1024, 8192)            # row counts of the invariance probe
# the other dense configurations at full width, 2 layers each
DENSE_OTHERS = ("olmo-1b", "glm4-9b", "phi3-medium-14b")
DENSE_OTHER_LAYERS, DENSE_OTHER_BATCH, DENSE_OTHER_PROMPT = 2, 2, 1024
# the continuous batcher over qwen2-1.5b: 8 Poisson arrivals within the
# first second, prompts uniform in [256, 2048], 16 new tokens each
BATCHER_REQUESTS, BATCHER_NEW, BATCHER_RATE = 8, 16, 32.0
# olmoe-1b-7b serving (src/repro/configs/olmoe_1b_7b.py, full width and
# depth), the same batch, prompts and new tokens; the expert kernel timed
# at a chunk of MOE_CHUNK tokens a row; its rows compared between the
# one-shot pool and pools of MOE_ROW_POOLS tokens; the batcher over 4
# requests; deepseek-moe-16b (src/repro/configs/deepseek_moe_16b.py) at
# full width cut to 3 layers, 2 prompts of 1,024 tokens
MOE_ARCH, MOE_CHUNK, MOE_ROW_POOLS = "olmoe-1b-7b", 512, (256, 4)
MOE_BATCHER_REQUESTS = 4
DEEPSEEK_ARCH, DEEPSEEK_LAYERS = "deepseek-moe-16b", 3
# whisper-small (src/repro/configs/whisper_small.py, arXiv:2212.04356)
# uncut: the same batch of 4 segments of encoder_seq = 1,500 frame rows
# (30 s of audio each), 192-token decoder prompts and 32 decode steps
# within whisper's text context of 448 positions; its encoder and decoder
# share one learned position table, which must hold the 1,500 frames
WHISPER_ARCH, WHISPER_PROMPT, WHISPER_NEW = "whisper-small", 192, 32
WHISPER_MAX_SEQ, WHISPER_TEXT_CONTEXT = 1500, 448
# phi-3-vision-4.2b (src/repro/configs/phi3_vision_4_2b.py,
# hf:microsoft/Phi-3-vision-128k-instruct) uncut: the same batch, prompts
# and new tokens text-only; its image prefill puts num_patches = 576 patch
# rows before 2,048 - 576 = 1,472 tokens
VLM_ARCH = "phi-3-vision-4.2b"
# training (src/repro/train/train_step.py): qwen2-1.5b at full width and
# depth, 8 steps of 4 x 2,048 tokens in bfloat16 (TrainConfig's default
# dtype) on the data pipeline's batches; float32 parity with the CPU and
# train()'s failure and resume at full width cut to 2 layers, 2 x 256
# tokens; the checkpoints go to build/ (gitignored) and are removed
TRAIN_ARCH, TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = "qwen2-1.5b", 4, 2048, 8
TRAIN_CUT_LAYERS, TRAIN_CUT_BATCH, TRAIN_CUT_SEQ = 2, 2, 256
# the backward kernel against its plain version: max |diff| within this
# share of max |plain|. float32: both sum in float32, in other orders,
# held over the whole tensor. bfloat16: both sum the same bfloat16 inputs
# in float32 and round dq, dk, dv to bfloat16 once, so an element may
# differ by one bfloat16 ulp, at most 2^-7 of its own size; held per block
# of 64 rows (queries for dq, keys for dk, dv) of each (batch, head)
# against that block's max |plain|, since dk and dv shrink with the key's
# position under the causal mask and a share of the whole tensor's max
# would pass a fault on the late keys
BWD_TOL = {"float32": 1e-4, "bfloat16": 1e-2}
BWD_BLOCK = 64
# the bound's peak rate for the backward's type: float32 as 3xTF32 (as the
# forward's rows), bfloat16 at the card's bfloat16 tensor-core rate
BWD_PEAK = {"float32": TF32_FLOPS / 3, "bfloat16": BF16_FLOPS}
# a full-width step's grad norm under remat_policy "dots" against the same
# step under "nothing" (the same products; saved or rerun)
REMAT_NORM_RTOL = 1e-6
# the backward's three CUDA kernels by name: D, dK/dV, dQ
BWD_KERNELS = ("flash_bwd_dot", "flash_bwd_dkdv", "flash_bwd_dq")
LSE_TOL = 1e-5       # the forward's log-sum-exp against torch.logsumexp
# the card's float32 step against the CPU's from the same state and batch:
# the loss within 1e-5 and the grad norm within 1e-4 relative, each
# gradient leaf within 1e-4 of its max |CPU gradient| (float32 sums in
# other orders over ~330 M gradient elements, the bar of the CPU tests
# against the reference). The whole step's parameters are not held: Adam's
# first step moves an element by +-lr whatever its gradient's size, so an
# element whose gradient is rounding noise may move the other way; the
# update is held instead given identical gradients (the CPU's on both):
# m, v and the grad norm within 1e-6 relative, a parameter within 1e-6
# relative or 1e-6 lr (elementwise float32 on both sides; the clip factor
# comes from a norm summed in another order)
TRAIN_LOSS_RTOL, TRAIN_GNORM_RTOL, TRAIN_GRAD_TOL = 1e-5, 1e-4, 1e-4
UPDATE_RTOL = 1e-6
RESUME_TOL = 1e-5    # resumed losses against an uninterrupted run's
# training the vlm and encdec families (ROADMAP.md queue 1 item 5(c)) at
# full width and depth, qwen2-1.5b's TrainConfig (bfloat16, float32
# parameters, no microbatch; phi-3-vision's config asks for a microbatch
# of 4, whose accumulation would hold ~30 GB more), remat on, TRAIN_VE_STEPS
# steps each: phi-3-vision-4.2b on 4 x (576 patch rows + 1,472 tokens),
# the 2,048 positions of its serving run; whisper-small on 4 x (1,500
# frame rows + 448 tokens), its decoder's text context. Tokens and labels
# from `data.pipeline.Pipeline`, patches and frames standard normal from
# numpy. Float32 parity with the CPU at TRAIN_CUT_LAYERS layers (and as
# many encoder layers), TRAIN_CUT_BATCH x TRAIN_CUT_SEQ tokens with all
# 576 patch rows or 1,500 frame rows.
TRAIN_VE_STEPS = 6
# training the ssm and hybrid families (ROADMAP.md queue 1 item 5(a)) at
# full width and depth with qwen2-1.5b's TrainConfig (bfloat16, no
# microbatch: the configs' train_microbatch of 16 would accumulate new
# sums), remat on, on 4 x 2,048 tokens from the pipeline: xlstm-350m (its
# sLSTM step loop runs by autograd, seconds a step) and zamba2-1.2b.
# Float32 parity with the CPU cuts the pattern to its first kinds, ("X",
# "S") and ("M", "A"), at TRAIN_CUT_BATCH x TRAIN_SSM_CUT_SEQ tokens: two
# scan chunks of 256 a block.
TRAIN_XLSTM_STEPS, TRAIN_ZAMBA2_STEPS = 2, 6
TRAIN_SSM_CUT_SEQ = 512
# xlstm's step split is traced on its last batch's first
# TRAIN_XLSTM_TRACE_SEQ tokens a row: the profiler records the sLSTM
# loop's tens of thousands of small kernels a step, and a full step's
# trace took 99-119 s of host time
TRAIN_XLSTM_TRACE_SEQ = 512
# training the moe family (ROADMAP.md queue 1 item 5(b)): olmoe-1b-7b at
# full width (d_model 2,048, 64 experts top-8 of width 1,024) cut in depth
# to TRAIN_MOE_LAYERS of its 16 layers (a layer's 403 M expert parameters
# take 16 bytes each with their gradient and moments, ~6.7 GB a layer with
# its attention: 16 layers would need ~108 GB; 10 is the most that leaves
# 10 GB of the card free at the step's peak, 11.8 GB on an H100 80GB
# HBM3 at 700 W, where 11 would leave ~5), qwen2-1.5b's
# TrainConfig (bfloat16 loss, float32 parameters), a warm-up step and
# TRAIN_MOE_STEPS - 1 more of 4 x 2,048 tokens from `init_train_state`'s
# capacity scales (ones, as the reference starts), which the balancer
# updates every step. The expert FFN's backward kernel against its plain
# version at that shape within MOE_BWD_TOL of each output's max |plain|,
# on a plan of N(0, 1) rows under capacity scales drawn in
# TRAIN_MOE_CAP_RANGE from a seed: such a router spreads its 65,536
# entries near-uniformly (1,024 +- 32 an expert against a capacity of
# 1,280 at scale 1), so at scales around 1 the steal round places every
# overflowing entry and nothing is dropped; the drawn scales (mean 0.75)
# make the record drop as well as steal. Float32 parity with the CPU at
# TRAIN_CUT_LAYERS layers for olmoe-1b-7b and deepseek-moe-16b (its dense
# first layer, then one MoE layer with shared experts) from the same drawn
# scales, so that the cut binds: olmoe's at 2 x TRAIN_OLMOE_PARITY_SEQ
# tokens (fewer than the other parities: it cuts its CPU step's time),
# deepseek's at 2 x TRAIN_CUT_SEQ (its time is the CPU's state, not its
# tokens).
TRAIN_MOE_LAYERS, TRAIN_MOE_STEPS = 10, 5
TRAIN_MOE_CAP_RANGE = (0.25, 1.25)
TRAIN_OLMOE_PARITY_SEQ = 128
MOE_BWD_TOL = 1e-4
# training over a torch.distributed mesh (`phase_train_mesh`): olmoe-1b-7b
# at full width cut to TRAIN_MESH_LAYERS layers, TRAIN_MESH_STEPS bfloat16
# steps of TRAIN_BATCH x TRAIN_SEQ tokens on a 1 x 1 NCCL mesh against the
# unmeshed step (bit for bit), and expert parallelism rank by rank in one
# process at TRAIN_MESH_TP model ranks against one rank
TRAIN_MESH_LAYERS, TRAIN_MESH_STEPS, TRAIN_MESH_TP = 2, 3, (2, 4)
EP_Y_TOL, EP_GRAD_TOL = 1e-5, 1e-4   # of max |y| and of each gradient's max
# the tensor parallelism of dense layers and the dry run
# (`phase_tp_dryrun`): TRAIN_ARCH at full width cut to TP_LAYERS layers,
# rank by rank at TP_RANKS model ranks (float32: y within TP_Y_TOL of
# max |y|, each gradient within TP_GRAD_TOL of its max), TP_BITS_STEPS
# steps over the 1 x 1 NCCL mesh, the dry run's argument + temp bytes
# within TP_DRYRUN_RTOL of the measured peak of `phase_train`'s main path,
# and the command line at TP_DRYRUN_CELLS on the 32 x 8 production mesh
TP_LAYERS, TP_RANKS, TP_BITS_STEPS = 2, (2, 4), 2
TP_Y_TOL, TP_GRAD_TOL, TP_DRYRUN_RTOL = 1e-5, 1e-4, 0.20
TP_DRYRUN_CELLS = (("olmo-1b", "decode_32k"), ("olmoe-1b-7b", "train_4k"),
                   ("zamba2-1.2b", "train_4k"))
# the tensor parallelism of the recurrent and encoder-decoder families
# (`phase_tp_recurrent`): one block of each kind at full width, float32,
# TP_REC_BATCH x TP_REC_SEQ tokens (whisper's encoder on its 1,500
# frames), rank by rank at TP_RANKS with the model axis's collectives
# replayed across the ranks for at most TP_REC_PASSES passes; the bars of
# the dense layers (TP_Y_TOL, TP_GRAD_TOL)
TP_REC_BATCH, TP_REC_SEQ, TP_REC_PASSES = 2, 512, 12
# the replay's passes for `tp_rank_by_rank`'s whole stack (its chain of
# collectives is longer than one block's)
TP_RBR_PASSES = 24
# numbers one phase measures and a later one reads
MEASURED = {}
# the scan's backward kernel against its plain version: max |diff| within
# this share of max |plain|. float32: 3xTF32 against cuBLAS float32 sums
# in other orders. bfloat16: both round dq, dk, dv to bfloat16 once from
# float32 sums (one ulp is at most 2^-7 of an element); dlog_a stays
# float32 and keeps the float32 bar
SCAN_BWD_TOL = {"float32": 1e-4, "bfloat16": 1e-2}
# the CUDA kernels of the scan's backward by input type (and the head sum
# with q and k shared): bfloat16 runs its own dstates and pair kernels
SCAN_BWD_KERNELS = {
    "float32": ("ssd_bwd_kernel_dstates", "ssd_bwd_kernel_pass",
                "ssd_bwd_kernel_gdot", "ssd_bwd_kernel_pair",
                "ssd_bwd_kernel_dl"),
    "bfloat16": ("ssd_bwd_kernel_dstates_bf16", "ssd_bwd_kernel_pass",
                 "ssd_bwd_kernel_gdot", "ssd_bwd_kernel_pair_bf16",
                 "ssd_bwd_kernel_dl")}


T_START = time.perf_counter()


def log(**kw) -> None:
    """One JSON line, with the script's wall seconds so far ("t")."""
    print(json.dumps({**kw, "t": round(time.perf_counter() - T_START, 2)}),
          flush=True)


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"check failed: {what}")


def random_csr(n: int, seed: int):
    """A Zipf-row-length CSR with ~10% empty rows, values in [-1, 1)."""
    rng = np.random.default_rng(seed)
    row_nnz = np.minimum(rng.zipf(1.8, n), 200).astype(np.int64)
    row_nnz[rng.random(n) < 0.1] = 0
    return _csr_from_row_nnz(row_nnz, n, rng)


def _csr_from_row_nnz(row_nnz, n_cols, rng):
    indptr = np.zeros(row_nnz.size + 1, np.int64)
    np.cumsum(row_nnz, out=indptr[1:])
    nnz = int(indptr[-1])
    indices = rng.integers(0, n_cols, nnz, dtype=np.int32)
    data = rng.uniform(-1.0, 1.0, nnz).astype(np.float32)
    return indptr, indices, data


def timed_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Median of `iters` CUDA-event timings of fn(), after `warmup` calls;
    5 timings after one warm-up when a first call takes over 100 ms."""
    import torch
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    if time.perf_counter() - t0 > 0.1:
        iters, warmup = 5, 1
    for _ in range(warmup - 1):
        fn()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop))
    return float(np.median(times))


def kernel_entry(name, *, launches, err, ms, plain_ms, library_ms,
                 bytes_, flops, peak=F32_FLOPS) -> dict:
    """One kernel's record for the `kernels` line: `bound_ms` is the larger
    of its bytes over the memory rate and its operations over `peak`, the
    rate of the units its arithmetic runs on (float32 CUDA cores unless
    said otherwise)."""
    t_bytes = bytes_ / HBM_BYTES_PER_S * 1e3
    t_ops = flops / peak * 1e3
    source, replaces = KERNELS[name]
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches, "max_abs_err": err,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": library_ms, "bytes": bytes_, "flops": flops}


def phase_environment():
    import torch
    from repro_torch.device import card_identity
    from repro_torch.kernels import _build
    props = torch.cuda.get_device_properties(0)
    log(phase="environment", torch=torch.__version__, cuda=torch.version.cuda,
        device=torch.cuda.get_device_name(0), sm_count=props.multi_processor_count,
        card=card_identity())
    t0 = time.perf_counter()
    names = _build.build_all()
    log(phase="build", sources=names, seconds=time.perf_counter() - t0)
    return props.multi_processor_count


def phase_small():
    """Both kernels against their plain versions on a small Zipf CSR, at
    p in {1, 2, 4} x B in {1, 4, 8}; sharded == flat walk bit for bit; a
    0-tile schedule returns zeros without a launch."""
    import torch
    from repro_torch.kernels.ich_spmv import ich_spmv as K
    from repro_torch.sched import LoopScheduler
    indptr, indices, data = random_csr(SMALL_ROWS, SEED)
    x = torch.from_numpy(np.random.default_rng(SEED + 1).uniform(
        -1.0, 1.0, SMALL_ROWS).astype(np.float32)).cuda()
    worst = 0.0
    for p in (1, 2, 4):
        for B in (1, 4, 8):
            op = LoopScheduler(p=p, superstep=B, cache_size=0).build(
                "spmv", indptr, indices, data)
            y, costs = K.ich_spmv_sharded(op.vals, op.cols, op.rowid,
                                          op.blkid, x, op.n_rows, p, B,
                                          slot_cost=op.slot_cost)
            y_plain, c_plain = K.ich_spmv_sharded_plain(
                op.vals, op.cols, op.rowid, op.blkid, x, op.n_rows, p, B,
                slot_cost=op.slot_cost)
            T = op.n_tiles
            rowid = torch.from_numpy(op.schedule.item_id).cuda()
            y_seq = K.ich_spmv(op.vals[:T], op.cols[:T], rowid, x, op.n_rows)
            y_seq_plain = K.ich_spmv_plain(op.vals[:T], op.cols[:T], rowid,
                                           x, op.n_rows)
            torch.cuda.synchronize()
            check(torch.allclose(y, y_plain, rtol=RTOL, atol=ATOL),
                  f"sharded kernel == plain at p={p} B={B}")
            check(torch.equal(costs, c_plain),
                  f"cost stream == plain at p={p} B={B}")
            check(torch.allclose(y_seq, y_seq_plain, rtol=RTOL, atol=ATOL),
                  f"flat walk == plain at p={p} B={B}")
            check(torch.equal(y, y_seq),
                  f"sharded == flat walk bit for bit at p={p} B={B}")
            worst = max(worst, float((y - y_plain).abs().max()),
                        float((y_seq - y_seq_plain).abs().max()))
    # a matrix with no rows lowers to a 0-tile schedule (every row, even
    # an empty one, owns a slot)
    empty = LoopScheduler(p=4).build("spmv", np.zeros(1, np.int64),
                                     np.zeros(0, np.int32),
                                     np.zeros(0, np.float32))
    before = dict(K.LAUNCHES)
    y0 = empty(torch.zeros(0, device="cuda"))
    check(empty.n_tiles == 0 and y0.shape == (0,) and K.LAUNCHES == before
          and not empty.last_costs.any(),
          "0-tile schedule returns zeros with no launch")
    log(phase="small", rows=SMALL_ROWS, nnz=int(indptr[-1]),
        max_abs_err=worst, ok=True)


def phase_small_bfs_kmeans():
    """The BFS and K-Means kernels against their plain versions at
    p in {1, 2, 4} x B in {1, 4, 8}: BFS on a small uniform graph, K-Means
    on small points with a heavy point split over several tiles; sharded ==
    sequential exactly; a 0-vertex graph and a 0-point K-Means launch
    nothing."""
    import torch
    from repro_torch.core.workloads import bfs_graph
    from repro_torch.kernels.ich_bfs import ich_bfs as KB
    from repro_torch.kernels.ich_kmeans import ich_kmeans as KK
    from repro_torch.sched import LoopScheduler
    rng = np.random.default_rng(SEED + 2)
    indptr, indices = bfs_graph("uniform", SMALL_ROWS, SEED)
    f = torch.from_numpy((rng.random(SMALL_ROWS) < 0.05).astype(
        np.float32)).cuda()
    v = torch.maximum(f, torch.from_numpy(
        (rng.random(SMALL_ROWS) < 0.3).astype(np.float32)).cuda())
    costs = rng.uniform(6.0, 10.0, SMALL_ROWS)
    costs[123] = 20_000.0  # heavier than many slots: split over tiles
    pts = torch.from_numpy(rng.standard_normal(
        (SMALL_ROWS, N_FEATURES)).astype(np.float32)).cuda()
    cent = torch.from_numpy(rng.standard_normal(
        (N_CLUSTERS, N_FEATURES)).astype(np.float32)).cuda()
    for p in (1, 2, 4):
        for B in (1, 4, 8):
            sched = LoopScheduler(p=p, superstep=B, cache_size=0)
            op = sched.build("bfs", indptr, indices)
            args = (op.mask, op.cols, op.rowid, op.blkid, f, v, op.n, p, B)
            nxt, c = KB.ich_bfs_step_sharded(*args, slot_cost=op.slot_cost)
            nxt_p, c_p = KB.ich_bfs_step_sharded_plain(
                *args, slot_cost=op.slot_cost)
            T = op.n_tiles
            seq = (op.mask[:T], op.cols[:T],
                   torch.from_numpy(op.schedule.item_id).cuda(), f, v, op.n)
            nxt_s = KB.ich_bfs_step(*seq)
            torch.cuda.synchronize()
            check(torch.equal(nxt, nxt_p) and torch.equal(c, c_p),
                  f"BFS sharded kernel == plain at p={p} B={B}")
            check(torch.equal(nxt_s, KB.ich_bfs_step_plain(*seq)),
                  f"BFS flat walk == plain at p={p} B={B}")
            check(torch.equal(nxt, nxt_s),
                  f"BFS sharded == flat walk bit for bit at p={p} B={B}")
            km = sched.build("kmeans", costs)
            check(np.unique(np.nonzero(km.schedule.item_id == 123)[0]).size
                  > 1, "the heavy point spans several tiles")
            ids, c = KK.ich_kmeans_assign_sharded(
                pts, cent, km.rowid, p, B, slot_cost=km.slot_cost)
            ids_p, c_p = KK.ich_kmeans_assign_sharded_plain(
                pts, cent, km.rowid, p, B, slot_cost=km.slot_cost)
            rid = torch.from_numpy(km.schedule.item_id).cuda()
            ids_s = KK.ich_kmeans_assign(pts, cent, rid)
            torch.cuda.synchronize()
            check(torch.equal(ids, ids_p) and torch.equal(c, c_p),
                  f"K-Means sharded kernel == plain at p={p} B={B}")
            check(torch.equal(ids_s,
                              KK.ich_kmeans_assign_plain(pts, cent, rid)),
                  f"K-Means sequential kernel == plain at p={p} B={B}")
            check(torch.equal(ids, ids_s),
                  f"K-Means sharded == sequential at p={p} B={B}")
    # the sharded K-Means walk's other paths: 4-byte row copies (odd D, a
    # point table off 8-byte alignment), a superstep wider than a chunk
    for D, misaligned, R in ((33, False, 8), (34, True, 8), (34, False, 64)):
        host = rng.standard_normal((SMALL_ROWS, D)).astype(np.float32)
        pts_d = torch.from_numpy(host).cuda()
        if misaligned:
            pts_d = torch.empty(host.size + 1, device="cuda")[1:].view(
                SMALL_ROWS, D).copy_(pts_d)
        cent_d = torch.from_numpy(rng.standard_normal(
            (N_CLUSTERS, D)).astype(np.float32)).cuda()
        km = LoopScheduler(p=4, superstep=8, rows_per_tile=R,
                           cache_size=0).build("kmeans", costs)
        shape = KK.sharded_launch_shape(4, km.shards.n_steps, 8, R, D,
                                        N_CLUSTERS, aligned=not misaligned)
        ids, c = KK.ich_kmeans_assign_sharded(pts_d, cent_d, km.rowid, 4, 8,
                                              slot_cost=km.slot_cost)
        ids_p, c_p = KK.ich_kmeans_assign_sharded_plain(
            pts_d, cent_d, km.rowid, 4, 8, slot_cost=km.slot_cost)
        rid = torch.from_numpy(km.schedule.item_id).cuda()
        torch.cuda.synchronize()
        label = f"D={D} misaligned={misaligned} R={R}"
        check(shape["copy_bytes"] == (4 if D % 2 or misaligned else 8)
              and shape["chunk_slots"] >= 8 * R,
              f"K-Means sharded launch shape at {label}")
        check(torch.equal(ids, ids_p) and torch.equal(c, c_p),
              f"K-Means sharded kernel == plain at {label}")
        check(torch.equal(ids, KK.ich_kmeans_assign(pts_d, cent_d, rid)),
              f"K-Means sharded == sequential at {label}")
    before = (dict(KB.LAUNCHES), dict(KK.LAUNCHES))
    empty = LoopScheduler(p=4).build("bfs", np.zeros(1, np.int64),
                                     np.zeros(0, np.int32))
    z = torch.zeros(0, device="cuda")
    nxt0 = empty.step(z, z)
    km0 = LoopScheduler(p=4).build("kmeans", np.zeros(0))
    ids0 = km0(torch.zeros((0, 3), device="cuda"),
               torch.zeros((2, 3), device="cuda"))
    check(nxt0.shape == (0,) and nxt0.dtype == torch.float32
          and ids0.shape == (0,) and ids0.dtype == torch.int32
          and not empty.last_costs.any() and not km0.last_costs.any()
          and (dict(KB.LAUNCHES), dict(KK.LAUNCHES)) == before,
          "0-vertex BFS and 0-point K-Means return empty outputs unlaunched")
    log(phase="small_bfs_kmeans", vertices=SMALL_ROWS,
        edges=int(indptr[-1]), points=SMALL_ROWS, ok=True)


def _host_reference(indptr, indices, data, x):
    """float64 y and per-row sum |a*x| on the host."""
    row = np.repeat(np.arange(indptr.size - 1), np.diff(indptr))
    prod = data.astype(np.float64) * x.astype(np.float64)[indices]
    n = indptr.size - 1
    return (np.bincount(row, weights=prod, minlength=n),
            np.bincount(row, weights=np.abs(prod), minlength=n))


def _check_run(op, y, y64, absum, label):
    err = np.abs(y.cpu().numpy().astype(np.float64) - y64)
    check(bool(np.all(err <= HOST_RTOL * absum)),
          f"{label}: y within {HOST_RTOL} of each row's sum |a*x| "
          f"(worst excess {float(np.max(err - HOST_RTOL * absum))})")
    emitted = op.last_costs.cpu().numpy().sum(axis=1)
    expect = op.shards.worker_cost(op.schedule.tile_cost()).astype(np.float32)
    check(np.array_equal(emitted, expect),
          f"{label}: per-worker cost sums == worker_cost(tile_cost())")


def phase_main(sm_count):
    import torch
    from repro_torch.core.workloads import TABLE1, matrix_row_nnz
    from repro_torch.kernels.ich_spmv import ich_spmv as K
    from repro_torch.sched import LoopScheduler, NnzCosts, SpmvOp

    t0 = time.perf_counter()
    spec = next(s for s in TABLE1 if s.name == MATRIX)
    row_nnz = matrix_row_nnz(spec, n=N_ROWS, seed=SEED).astype(np.int64)
    rng = np.random.default_rng(SEED)
    indptr, indices, data = _csr_from_row_nnz(row_nnz, N_ROWS, rng)
    x_host = rng.uniform(-1.0, 1.0, N_ROWS).astype(np.float32)
    y64, absum = _host_reference(indptr, indices, data, x_host)
    log(phase="matrix", name=MATRIX, rows=N_ROWS, nnz=int(indptr[-1]),
        seconds=time.perf_counter() - t0)

    scheduler = LoopScheduler(p=sm_count)
    t0 = time.perf_counter()
    s = scheduler.schedule(NnzCosts(indptr))
    t_schedule = time.perf_counter() - t0
    t0 = time.perf_counter()
    shards = s.shard()
    t_shard = time.perf_counter() - t0
    t0 = time.perf_counter()
    op = scheduler.build("spmv", indptr, indices, data)
    torch.cuda.synchronize()
    t_pack = time.perf_counter() - t0
    check(op.schedule is s and op.shards is shards, "build reused the cache")
    x = torch.from_numpy(x_host).cuda()
    T, R, W = op.n_tiles, s.rows_per_tile, s.width
    log(phase="host_construction", schedule_s=t_schedule, shard_s=t_shard,
        pack_and_upload_s=t_pack, tiles=T, rows_per_tile=R, width=W,
        p=op.p, superstep=op.superstep, steps=shards.n_steps,
        slots=T * R * W, slots_per_nnz=T * R * W / int(indptr[-1]))

    # ---- the main path, counted: run -> cross-check -> refine -> run ----
    K.reset_launches()
    t0 = time.perf_counter()
    y = op(x)
    rowid_seq = torch.from_numpy(s.item_id).cuda()
    y_seq = K.ich_spmv(op.vals[:T], op.cols[:T], rowid_seq, x, op.n_rows)
    s2 = op.observe().refine()
    op2 = SpmvOp(s2, indptr, indices, data)
    y2 = op2(x)
    torch.cuda.synchronize()
    t_path = time.perf_counter() - t0
    launches = dict(K.LAUNCHES)
    log(phase="main_path", seconds=t_path, launches=launches,
        generation=s2.generation)
    for name in launches:
        check(launches[name] > 0, f"{name} launched on the main path")
    _check_run(op, y, y64, absum, "generation 0")
    check(torch.equal(y, y_seq), "full-size sharded == flat walk bit for bit")
    _check_run(op2, y2, y64, absum, "generation 1")
    check(torch.equal(y2, y), "refined schedule gives the same y")
    del op2, y2
    replay_cross_check("spmv", op)

    # ---- kernels against their plain versions at the main path's shapes ----
    args = (op.vals, op.cols, op.rowid, op.blkid, x, op.n_rows, op.p,
            op.superstep)
    y_k, c_k = K.ich_spmv_sharded(*args, slot_cost=op.slot_cost)
    y_p, c_p = K.ich_spmv_sharded_plain(*args, slot_cost=op.slot_cost)
    check(torch.allclose(y_k, y_p, rtol=RTOL, atol=ATOL),
          "full-size sharded kernel == plain")
    check(torch.equal(c_k, c_p), "full-size cost stream == plain")
    err_sharded = float((y_k - y_p).abs().max())
    seq_args = (op.vals[:T], op.cols[:T], rowid_seq, x, op.n_rows)
    y_sp = K.ich_spmv_plain(*seq_args)
    check(torch.allclose(y_seq, y_sp, rtol=RTOL, atol=ATOL),
          "full-size flat walk == plain")
    err_seq = float((y_seq - y_sp).abs().max())
    del y_k, c_k, y_p, c_p, y_sp

    # ---- timings ----
    ms = {
        "ich_spmv_sharded": timed_ms(
            lambda: K.ich_spmv_sharded(*args, slot_cost=op.slot_cost)),
        "ich_spmv": timed_ms(lambda: K.ich_spmv(*seq_args)),
    }
    plain_ms = {
        "ich_spmv_sharded": timed_ms(
            lambda: K.ich_spmv_sharded_plain(*args, slot_cost=op.slot_cost)),
        "ich_spmv": timed_ms(lambda: K.ich_spmv_plain(*seq_args)),
    }
    csr = torch.sparse_csr_tensor(
        torch.from_numpy(indptr.astype(np.int32)).cuda(),
        torch.from_numpy(indices).cuda(), torch.from_numpy(data).cuda(),
        size=(N_ROWS, N_ROWS), check_invariants=False)
    y_lib = csr @ x
    torch.cuda.synchronize()
    check(bool(np.all(np.abs(y_lib.cpu().numpy() - y64)
                      <= HOST_RTOL * absum)), "cuSPARSE y sane")
    library_ms = timed_ms(lambda: csr @ x)
    del csr, y_lib
    log_flat_walk("spmv", K, lambda: K.ich_spmv(*seq_args), T, R, W,
                  rowid_seq, sm_count)
    log_sharded_walk("spmv", K, op, op.vals, lambda: K.ich_spmv_sharded(
        *args, slot_cost=op.slot_cost))

    # ---- bounds: bytes each input is read once / output written once ----
    real = int((s.item_id >= 0).sum())          # slots the kernels read
    p, S_B = op.shards.block_perm.shape
    common = real * W * 8 + N_ROWS * 4 + N_ROWS * 4   # vals+cols, x, y
    bytes_ = {
        "ich_spmv_sharded": common + real * 4 + op.rowid.numel() * 4
        + p * S_B * 4 * 2,                      # slot_cost, rowid, blkid+costs
        "ich_spmv": common + T * R * 4,         # rowid
    }
    flops = 2 * real * W
    SHAPES["wikipedia"] = {
        "workload": "spmv", "inputs": (indptr, indices, data),
        "sched": {"p": sm_count}, "schedule": s, "op": op,
        "csr": (indptr, indices, data), "x": x, "y": y,
        "costs": op.last_costs}
    return [kernel_entry(name, launches=launches[name], err=err,
                         ms=ms[name], plain_ms=plain_ms[name],
                         library_ms=library_ms, bytes_=bytes_[name],
                         flops=flops)
            for name, err in (("ich_spmv_sharded", err_sharded),
                              ("ich_spmv", err_seq))]


def _host_levels(indptr, indices):
    """BFS levels from vertex 0 on the host (scipy): row u of the CSR lists
    u's in-neighbors, so the edges are v -> u; unreached = -1."""
    from scipy.sparse import csr_matrix
    from scipy.sparse.csgraph import shortest_path
    n = indptr.size - 1
    row = np.repeat(np.arange(n), np.diff(indptr))
    g = csr_matrix((np.ones(indices.size, np.float32), (indices, row)),
                   shape=(n, n))
    d = shortest_path(g, unweighted=True, indices=0)
    return np.where(np.isinf(d), -1, d).astype(np.int32)


def _bfs_run(kind, sm_count):
    """One graph's BFS main path, counted; then its kernels against their
    plain versions and their times at the level with the largest
    frontier."""
    import torch
    from repro_torch.core.workloads import bfs_graph
    from repro_torch.kernels.ich_bfs import ich_bfs as K
    from repro_torch.sched import BfsOp, LoopScheduler

    t0 = time.perf_counter()
    indptr, indices = bfs_graph(kind, N_VERTICES, SEED)
    level_host = _host_levels(indptr, indices)
    t_setup = time.perf_counter() - t0
    t0 = time.perf_counter()
    op = LoopScheduler(p=sm_count).build("bfs", indptr, indices)
    torch.cuda.synchronize()
    t_build = time.perf_counter() - t0
    s, n, T = op.schedule, op.n, op.n_tiles
    rowid_seq = torch.from_numpy(s.item_id).cuda()

    def seq_args(f, v):
        return (op.mask[:T], op.cols[:T], rowid_seq, f, v, n)

    # ---- the main path, counted: levels -> per-level cross-check ->
    #      refine -> levels ----
    K.reset_launches()
    t0 = time.perf_counter()
    level = op.levels(0)
    torch.cuda.synchronize()
    t_levels = time.perf_counter() - t0
    frontier = torch.zeros(n, device="cuda")
    frontier[0] = 1.0
    visited = frontier.clone()
    level_loop = torch.full((n,), -1, dtype=torch.int32, device="cuda")
    level_loop[0] = 0
    depth, widest, big = 0, -1, None
    while bool(frontier.any()):
        width = int(frontier.sum())
        if width > widest:
            widest, big = width, (frontier, visited)
        nxt = op.step(frontier, visited)
        check(torch.equal(nxt, K.ich_bfs_step(*seq_args(frontier, visited))),
              f"{kind}: sharded == flat frontier at level {depth + 1}")
        depth += 1
        level_loop = torch.where(nxt > 0, depth, level_loop)
        visited = torch.maximum(visited, nxt)
        frontier = nxt
    s2 = op.observe().refine()
    level2 = BfsOp(s2, indptr, indices).levels(0)
    torch.cuda.synchronize()
    launches = dict(K.LAUNCHES)
    log(phase="bfs_main_path", graph=kind, vertices=n,
        edges=int(indptr[-1]), max_degree=int(np.diff(indptr).max()),
        width=s.width, tiles=T, steps=op.shards.n_steps, levels=depth,
        widest_frontier=widest, reached=int((level >= 0).sum()),
        traversal_s=t_levels, setup_s=t_setup, build_s=t_build,
        launches=launches, generation=s2.generation)
    check(np.array_equal(level.cpu().numpy(), level_host),
          f"{kind}: levels == host BFS")
    check(torch.equal(level_loop, level), f"{kind}: step loop == levels()")
    emitted = op.last_costs.cpu().numpy().sum(axis=1)
    check(np.array_equal(emitted, op.shards.worker_cost(
        s.tile_cost()).astype(np.float32)),
        f"{kind}: per-worker cost sums == worker_cost(tile_cost())")
    check(s2.generation == 1 and torch.equal(level2, level),
          f"{kind}: refined generation gives the same levels")
    replay_cross_check("bfs", op, graph=kind)
    del level2, level_loop
    # the first traversal above paid for PyTorch's first use of its own
    # kernels; the warm traversal is the median of three more
    warm = []
    for _ in range(3):
        t0 = time.perf_counter()
        op.levels(0)
        torch.cuda.synchronize()
        warm.append(time.perf_counter() - t0)
    log(phase="bfs_traversal", graph=kind, levels=depth,
        first_s=t_levels, warm_median_s=float(np.median(warm)))

    # ---- kernels against their plain versions at the widest level ----
    f, v = big
    args = (op.mask, op.cols, op.rowid, op.blkid, f, v, n, op.p,
            op.superstep)
    y_k, c_k = K.ich_bfs_step_sharded(*args, slot_cost=op.slot_cost)
    y_p, c_p = K.ich_bfs_step_sharded_plain(*args, slot_cost=op.slot_cost)
    check(torch.equal(y_k, y_p) and torch.equal(c_k, c_p),
          f"{kind}: full-size sharded kernel == plain")
    y_s = K.ich_bfs_step(*seq_args(f, v))
    y_sp = K.ich_bfs_step_plain(*seq_args(f, v))
    check(torch.equal(y_s, y_sp), f"{kind}: full-size flat walk == plain")
    err = {"ich_bfs_step_sharded": float((y_k - y_p).abs().max()),
           "ich_bfs_step": float((y_s - y_sp).abs().max())}
    del y_p, c_p, y_sp
    ms = {"ich_bfs_step_sharded": timed_ms(
              lambda: K.ich_bfs_step_sharded(*args, slot_cost=op.slot_cost)),
          "ich_bfs_step": timed_ms(lambda: K.ich_bfs_step(*seq_args(f, v)))}
    plain_ms = {
        "ich_bfs_step_sharded": timed_ms(lambda: K.ich_bfs_step_sharded_plain(
            *args, slot_cost=op.slot_cost)),
        "ich_bfs_step": timed_ms(
            lambda: K.ich_bfs_step_plain(*seq_args(f, v)))}
    # yardstick: cuSPARSE over the 0/1 CSR counts each vertex's frontier
    # in-neighbors; count > 0 on an unvisited vertex is the next frontier
    csr = torch.sparse_csr_tensor(
        torch.from_numpy(indptr.astype(np.int32)).cuda(),
        torch.from_numpy(indices.astype(np.int32)).cuda(),
        torch.ones(indices.size, device="cuda"), size=(n, n),
        check_invariants=False)
    hits = csr @ f
    check(torch.equal((hits > 0).float() * (1.0 - v), y_k),
          f"{kind}: cuSPARSE frontier count agrees")
    library_ms = timed_ms(lambda: csr @ f)
    del csr, hits
    log_flat_walk("bfs", K, lambda: K.ich_bfs_step(*seq_args(f, v)), T,
                  s.rows_per_tile, s.width, rowid_seq, sm_count, graph=kind)
    log_sharded_walk("bfs", K, op, op.mask, lambda: K.ich_bfs_step_sharded(
        *args, slot_cost=op.slot_cost), graph=kind)

    # ---- bounds: bytes each input is read once / output written once ----
    real = int((s.item_id >= 0).sum())        # slots the kernels read
    W = s.width
    p, S_B = op.shards.block_perm.shape
    common = real * W * 8 + 3 * n * 4         # mask+cols; f, visited, out
    bytes_ = {"ich_bfs_step_sharded": common + real * 4
              + op.rowid.numel() * 4 + p * S_B * 4 * 2,
              "ich_bfs_step": common + T * s.rows_per_tile * 4}
    flops = 2 * real * W                      # a multiply and a max a lane
    SHAPES[f"bfs_{kind}"] = {
        "workload": "bfs", "inputs": (indptr, indices),
        "sched": {"p": sm_count}, "schedule": s, "op": op,
        "csr": (indptr, indices, np.ones(indices.size, np.float32)),
        "level": level}
    return {name: kernel_entry(name, launches=launches[name], err=err[name],
                               ms=ms[name], plain_ms=plain_ms[name],
                               library_ms=library_ms, bytes_=bytes_[name],
                               flops=flops)
            for name in ms}


def phase_bfs(sm_count):
    """Both graphs of the paper's BF workload at 1,000,000 vertices. The
    `kernels` line takes the uniform graph's times and both graphs'
    launches; the scale-free graph's times are logged beside them."""
    runs = {kind: _bfs_run(kind, sm_count) for kind in GRAPHS}
    for kind, entries in runs.items():
        log(phase="bfs_kernels", graph=kind, kernels=list(entries.values()))
    kernels = []
    for name, entry in runs[GRAPHS[0]].items():
        entry = dict(entry)
        entry["launches"] = sum(r[name]["launches"] for r in runs.values())
        check(entry["launches"] > 0, f"{name} launched on the main path")
        kernels.append(entry)
    return kernels


def _near_tie_mismatches(points, centroids, ids):
    """Points whose id differs from the float64 host argmin, and whether
    every one of them is a near tie (float64 distances of the two
    centroids within TIE_RTOL)."""
    pts = points.cpu().numpy().astype(np.float64)
    cent = centroids.cpu().numpy().astype(np.float64)
    d2 = np.stack([((pts - c) ** 2).sum(axis=1) for c in cent], axis=1)
    host = d2.argmin(axis=1)
    ours = ids.cpu().numpy()
    diff = np.nonzero(ours != host)[0]
    a, b = d2[diff, ours[diff]], d2[diff, host[diff]]
    return diff.size, bool(np.all(np.abs(a - b) <= TIE_RTOL * b))


def phase_kmeans(sm_count):
    """K-Means assignment at the kdd_cup shape: the round-0 schedule's run,
    its sequential cross-check, observe/refine and the refined run, then
    rounds 1-2 as fresh schedules, all giving the same ids; the simulator
    cross-check of the cost stream; the threaded executor over the
    schedule's work units, observed and refined, and the kernel on that
    generation; the kernels against their plain versions, their launch
    shapes and timings."""
    import torch
    from repro_torch.core.workloads import kmeans_rounds
    from repro_torch.kernels.ich_kmeans import ich_kmeans as K
    from repro_torch.sched import KMeansOp, LoopScheduler

    t0 = time.perf_counter()
    rounds, _ = kmeans_rounds(N_POINTS, rounds=KMEANS_ROUNDS, seed=SEED)
    rng = np.random.default_rng(SEED)
    pts = torch.from_numpy(rng.standard_normal(
        (N_POINTS, N_FEATURES)).astype(np.float32)).cuda()
    cent = torch.from_numpy(rng.standard_normal(
        (N_CLUSTERS, N_FEATURES)).astype(np.float32)).cuda()
    t_setup = time.perf_counter() - t0
    scheduler = LoopScheduler(p=sm_count)
    t0 = time.perf_counter()
    op = scheduler.build("kmeans", rounds[0])
    torch.cuda.synchronize()
    t_build = time.perf_counter() - t0
    s = op.schedule
    rowid_seq = torch.from_numpy(s.item_id).cuda()

    # ---- the main path, counted ----
    K.reset_launches()
    t0 = time.perf_counter()
    ids = op(pts, cent)
    ids_seq = K.ich_kmeans_assign(pts, cent, rowid_seq)
    s2 = op.observe().refine()
    ids2 = KMeansOp(s2, rounds[0])(pts, cent)
    later = [scheduler.build("kmeans", r)(pts, cent) for r in rounds[1:]]
    torch.cuda.synchronize()
    t_path = time.perf_counter() - t0
    launches = dict(K.LAUNCHES)
    n_ties, ties_ok = _near_tie_mismatches(pts, cent, ids)
    log(phase="kmeans_main_path", points=N_POINTS, features=N_FEATURES,
        clusters=N_CLUSTERS, width=s.width, tiles=s.n_tiles,
        live_slots=int((s.item_id >= 0).sum()), steps=op.shards.n_steps,
        seconds=t_path, setup_s=t_setup, build_s=t_build,
        launches=launches, generation=s2.generation,
        near_tie_mismatches=n_ties)
    for name in launches:
        check(launches[name] > 0, f"{name} launched on the main path")
    check(torch.equal(ids, ids_seq), "K-Means sharded == sequential ids")
    check(ties_ok, "K-Means ids == float64 argmin outside near ties")
    emitted = op.last_costs.cpu().numpy().astype(np.float64).sum(axis=1)
    expect = op.shards.worker_cost(s.tile_cost())
    check(bool(np.allclose(emitted, expect, rtol=COST_RTOL, atol=0)),
          "K-Means per-worker cost sums within 1e-6 of worker_cost")
    check(s2.generation == 1 and torch.equal(ids2, ids),
          "K-Means refined generation gives the same ids")
    check(all(torch.equal(x, ids) for x in later),
          "K-Means rounds 1-2 give the same ids")
    del ids2, later
    replay_cross_check("kmeans", op)

    # ---- the threaded executor over the schedule's work units ----
    t0 = time.perf_counter()
    stats = s.parallel_for_units(lambda u: None, p=EXEC_THREADS,
                                 record_chunks=True)
    t_exec = time.perf_counter() - t0
    ranges = sorted((b, e) for b, e, _, _ in stats.chunk_log)
    check(np.array_equal(np.asarray(ranges), s.unit_ranges()),
          "executor dispatched every tile chunk once")
    t0 = time.perf_counter()
    s3 = s.observe(stats).refine()
    t_refine = time.perf_counter() - t0
    ids3 = KMeansOp(s3, rounds[0])(pts, cent)
    torch.cuda.synchronize()
    log(phase="kmeans_executor", threads=EXEC_THREADS,
        units=int(s.sizes.sum()), chunks=len(stats.chunk_log),
        exec_s=t_exec, observe_refine_s=t_refine, generation=s3.generation,
        tiles=s3.n_tiles)
    check(s3.generation == 1 and torch.equal(ids3, ids),
          "K-Means generation refined from the executor gives the same ids")
    del ids3

    # ---- kernels against their plain versions at the main path's shapes ----
    args = (pts, cent, op.rowid, op.p, op.superstep)
    i_k, c_k = K.ich_kmeans_assign_sharded(*args, slot_cost=op.slot_cost)
    i_p, c_p = K.ich_kmeans_assign_sharded_plain(*args,
                                                 slot_cost=op.slot_cost)
    check(torch.equal(i_k, i_p) and torch.equal(c_k, c_p),
          "full-size K-Means sharded kernel == plain")
    i_sp = K.ich_kmeans_assign_plain(pts, cent, rowid_seq)
    check(torch.equal(ids_seq, i_sp), "full-size K-Means sequential == plain")
    err = {"ich_kmeans_assign_sharded": float((i_k - i_p).abs().max()),
           "ich_kmeans_assign": float((ids_seq - i_sp).abs().max())}
    del i_k, c_k, i_p, c_p, i_sp
    ms = {"ich_kmeans_assign_sharded": timed_ms(
              lambda: K.ich_kmeans_assign_sharded(
                  *args, slot_cost=op.slot_cost)),
          "ich_kmeans_assign": timed_ms(
              lambda: K.ich_kmeans_assign(pts, cent, rowid_seq))}
    plain_ms = {
        "ich_kmeans_assign_sharded": timed_ms(
            lambda: K.ich_kmeans_assign_sharded_plain(
                *args, slot_cost=op.slot_cost)),
        "ich_kmeans_assign": timed_ms(
            lambda: K.ich_kmeans_assign_plain(pts, cent, rowid_seq))}
    # yardstick: cdist's distances take another formula, so its ids may
    # differ on near ties; the count is logged, not held
    lib_ids = torch.cdist(pts, cent).argmin(dim=1)
    log(phase="kmeans_library", cdist_argmin_mismatches=int(
        (lib_ids != ids).sum()))
    library_ms = timed_ms(lambda: torch.cdist(pts, cent).argmin(dim=1))
    shape = K.assign_launch_shape(rowid_seq.numel(), N_FEATURES, N_CLUSTERS)
    check(shape["ctas"] >= min(sm_count, -(-rowid_seq.numel() // max(
        shape["chunk_slots"], 1))), "K-Means flat walk's grid spans the card")
    log(phase="kmeans_flat_grid", sm_count=sm_count,
        slots=rowid_seq.numel(), **shape)
    log_split("kmeans_flat", lambda: K.ich_kmeans_assign(pts, cent, rowid_seq),
              "ich_kmeans_assign_kernel")
    S_B = op.shards.n_steps
    shape = K.sharded_launch_shape(op.p, S_B, op.superstep, s.rows_per_tile,
                                   N_FEATURES, N_CLUSTERS)
    n_chunks = -(-op.p * S_B // shape["chunk_steps"])
    check(shape["chunk_slots"] > 0
          and shape["ctas"] >= min(sm_count, n_chunks),
          "K-Means sharded walk's grid spans the card")
    log(phase="kmeans_sharded_grid", sm_count=sm_count, p=op.p, steps=S_B,
        superstep=op.superstep, rows_per_tile=s.rows_per_tile,
        chunks=n_chunks, **shape)
    log_split("kmeans_sharded", lambda: K.ich_kmeans_assign_sharded(
        *args, slot_cost=op.slot_cost), "ich_kmeans_assign_sharded_kernel")

    # ---- bounds: bytes each input is read once / output written once ----
    live = int((s.item_id >= 0).sum())
    p, S_B = op.shards.block_perm.shape
    common = (N_POINTS * N_FEATURES + N_CLUSTERS * N_FEATURES
              + N_POINTS) * 4                  # points, centroids, ids
    bytes_ = {"ich_kmeans_assign_sharded": common + op.rowid.numel() * 8
              + p * S_B * 4,                   # rowid+slot_cost, costs
              "ich_kmeans_assign": common + rowid_seq.numel() * 4}
    flops = 3 * live * N_CLUSTERS * N_FEATURES   # sub, mul, add
    SHAPES["kmeans"] = {
        "workload": "kmeans", "inputs": (rounds[0],),
        "sched": {"p": sm_count}, "schedule": s, "op": op, "csr": None,
        "pts": pts, "cent": cent}
    return [kernel_entry(name, launches=launches[name], err=err[name],
                         ms=ms[name], plain_ms=plain_ms[name],
                         library_ms=library_ms, bytes_=bytes_[name],
                         flops=flops)
            for name in ms]


def _moe_weights(E, D, F, T, seed):
    """Expert weights (scaled by fan-in) and activations drawn on the card
    from a seeded generator."""
    import torch
    g = torch.Generator(device="cuda")
    g.manual_seed(seed)
    wi = torch.randn((E, D, F), generator=g, device="cuda") * D ** -0.5
    wg = torch.randn((E, D, F), generator=g, device="cuda") * D ** -0.5
    wo = torch.randn((E, F, D), generator=g, device="cuda") * F ** -0.5
    x = torch.randn((T, D), generator=g, device="cuda")
    return x, wi, wg, wo


def phase_small_moe():
    """The MoE kernel against its plain version at p in {1, 2, 4} x
    B in {1, 4, 8} on a narrow layer whose experts split over several slot
    rows (W = 64) and whose F is no multiple of the kernel's tiles: y
    within MOE_TOL, cost streams exactly, one y bit for bit across every
    lowering (p = 1, B = 1 is the sequential walk); a plan that admits no
    token launches nothing."""
    import torch
    from repro_torch.core.workloads import moe_router
    from repro_torch.kernels.ich_moe import ich_moe as K
    from repro_torch.sched import LoopScheduler, plan_dispatch
    T, E, D, F = 2000, 16, 72, 200
    e_topk, w = moe_router(T, E, 4, seed=SEED + 3, skew=1.2)
    plan = plan_dispatch(e_topk, w, cap_scale=np.ones(E))
    x, wi, wg, wo = _moe_weights(E, D, F, T, SEED + 3)
    first, worst = None, 0.0
    for p in (1, 2, 4):
        for B in (1, 4, 8):
            op = LoopScheduler(p=p, superstep=B, rows_per_tile=2,
                               cache_size=0).build("moe-dispatch", plan,
                                                   width=64)
            args = (op.vals, op.cols, op.rowid, op.blkid, x, wi, wg, wo, p,
                    B, op.slots)
            y, c, ec = K.ich_moe_sharded(*args, slot_cost=op.slot_cost)
            y_p, c_p, ec_p = K.ich_moe_sharded_plain(
                *args, slot_cost=op.slot_cost)
            torch.cuda.synchronize()
            check(torch.allclose(y, y_p, rtol=MOE_TOL, atol=MOE_TOL),
                  f"MoE kernel == plain at p={p} B={B}")
            check(torch.equal(c, c_p) and torch.equal(ec, ec_p),
                  f"MoE cost streams == plain at p={p} B={B}")
            check(np.array_equal(ec.cpu().numpy().sum(axis=0),
                                 plan.counts.astype(np.float32)),
                  f"MoE expert costs sum to the plan at p={p} B={B}")
            first = y if first is None else first
            check(torch.equal(y, first),
                  f"MoE sharded == sequential bit for bit at p={p} B={B}")
            worst = max(worst, float((y - y_p).abs().max()))
    before = dict(K.LAUNCHES)
    empty = plan_dispatch(np.zeros((0, 2), np.int64),
                          np.zeros((0, 2), np.float32))
    op0 = LoopScheduler(p=4).build("moe-dispatch", empty)
    E0 = empty.n_experts
    y0 = op0(torch.zeros((0, 8), device="cuda"),
             torch.zeros((E0, 8, 16), device="cuda"),
             torch.zeros((E0, 8, 16), device="cuda"),
             torch.zeros((E0, 16, 8), device="cuda"))
    check(op0.n_tiles > 0 and tuple(y0.shape) == (0, 8)
          and K.LAUNCHES == before and not op0.last_costs.any()
          and not op0.expert_load().any(),
          "MoE plan with no token returns an empty y unlaunched")
    log(phase="small_moe", tokens=T, experts=E, d=D, f=F,
        kept=int(plan.counts.sum()), max_abs_err=worst, ok=True)


def torch_index(a):
    """An int64 index tensor on the card."""
    import torch
    return torch.from_numpy(np.asarray(a, np.int64)).cuda()


def _moe_host_reference(plan, x, wi, wg, wo, sample):
    """float64 y of the `sample` tokens on the host, and per element the
    sum over each token's entries of |w| * sum_f |a_f * wo[f, d]| (the
    terms of the last product), the scale an error is measured against."""
    keep = plan.keep & np.isin(plan.token, sample)
    row = {int(t): i for i, t in enumerate(sample)}
    xs = x[torch_index(sample)].cpu().numpy().astype(np.float64)
    y64 = np.zeros((sample.size, x.shape[1]))
    absum = np.zeros_like(y64)
    for e in np.unique(plan.expert[keep]):
        sel = keep & (plan.expert == e)
        rows = np.array([row[int(t)] for t in plan.token[sel]])
        wt = plan.weight[sel].astype(np.float64)[:, None]
        a_in = xs[rows]
        h = a_in @ wi[e].cpu().numpy().astype(np.float64)
        g = a_in @ wg[e].cpu().numpy().astype(np.float64)
        a = g / (1.0 + np.exp(-g)) * h
        w_o = wo[e].cpu().numpy().astype(np.float64)
        np.add.at(y64, rows, wt * (a @ w_o))
        np.add.at(absum, rows, wt * (np.abs(a) @ np.abs(w_o)))
    return y64, absum


def capacity_buffer_moe(x, wi, wg, wo, plan, C=None):
    """The dense capacity-buffer form of the reference's `moe_local`: kept
    entries gathered into an (E, C, D) buffer (C = the plan's largest
    capacity unless given; a dropless plan's largest expert load fits
    every kept entry), three float32 `torch.bmm` with silu, weighted
    scatter-add back to the tokens. Several PyTorch calls; the yardstick,
    never used by the port."""
    import torch
    E, D = wi.shape[0], x.shape[1]
    C = int(plan.cap.max()) if C is None else int(C)
    k = plan.keep
    at = torch_index(plan.expert[k].astype(np.int64) * C + plan.pos[k])
    tok = torch_index(plan.token[k])
    wt = torch.from_numpy(plan.weight[k]).cuda()

    def run():
        buf = torch.zeros((E * C, D), device="cuda")
        buf[at] = x[tok]
        buf = buf.view(E, C, D)
        a = torch.nn.functional.silu(torch.bmm(buf, wg)) * torch.bmm(buf, wi)
        yb = torch.bmm(a, wo).view(E * C, D)
        return torch.zeros_like(x).index_add_(0, tok, yb[at] * wt[:, None])
    return run, C


def device_ms_by_kernel(fn, expect=(), warmup: bool = True) -> dict:
    """Device milliseconds per kernel name over one call of fn (after one
    warm-up call, unless `warmup` is False: the caller has run fn just
    before), from torch.profiler's CUDA trace, taken up to three
    times while a trace holds no device time (one has come back empty) or
    lacks a kernel whose name holds one of `expect` (one has come back
    with only some of a call's kernels); the last trace if none held
    all."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    if warmup:
        fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            # the trace can miss the first kernel it sees: let that be a
            # short spin (left out below), not the first kernel of fn
            torch.cuda._sleep(1000)
            fn()
            torch.cuda.synchronize()
        by_name = {}
        for ev in prof.key_averages():
            if ev.device_time_total > 0 and "spin_kernel" not in ev.key:
                key = ev.key[:80]
                by_name[key] = by_name.get(key, 0.0) \
                    + ev.device_time_total / 1e3
        if by_name and all(any(e in n for n in by_name) for e in expect):
            return by_name
    return by_name


def log_flat_walk(label, K, fn, T, R, W, rowid, sm_count, **extra) -> None:
    """Three lines on a flat walk: its grid (the CTAs of each phase on this
    card), the longest run of one row in slots (one thread folds it), and
    the device milliseconds of each phase over one call of fn beside the
    host's microseconds to enqueue one call (the mean of 20, unsynced)."""
    from repro_torch.core.segmented import longest_run
    shape = K.flat_launch_shape(T, R, W)
    check(shape["ctas_phase_a"] >= min(sm_count, -(-T * R // shape[
        "chunk_slots"])), f"{label}: the phase-A grid spans the card")
    log(phase=f"{label}_flat_grid", sm_count=sm_count, tiles=T,
        rows_per_tile=R, width=W, **shape, **extra)
    log(phase=f"{label}_flat_longest_run", slots=longest_run(rowid),
        **extra)
    by_name = device_ms_by_kernel(fn)
    a = sum(v for k, v in by_name.items() if "flat_slot_partials" in k)
    b = sum(v for k, v in by_name.items() if "flat_fold_rows" in k)
    log(phase=f"{label}_flat_split", phase_a_ms=a, phase_b_ms=b,
        other_ms=sum(by_name.values()) - a - b,
        host_enqueue_us=enqueue_us(fn), device_ms=by_name, **extra)


def enqueue_us(fn) -> float:
    """The host's microseconds to enqueue one call of fn: the mean of 20
    calls, unsynced, from an idle card."""
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(20):
        fn()
    host_us = (time.perf_counter() - t0) / 20 * 1e6
    torch.cuda.synchronize()
    return host_us


def log_split(label, fn, kernel, **extra) -> None:
    """The device milliseconds of one call of fn, the kernel whose name
    holds `kernel` apart from everything else (output fills), beside the
    host's microseconds to enqueue one call."""
    by_name = device_ms_by_kernel(fn)
    k = sum(v for name, v in by_name.items() if kernel in name)
    log(phase=f"{label}_split", kernel_ms=k,
        other_ms=sum(by_name.values()) - k, host_enqueue_us=enqueue_us(fn),
        device_ms=by_name, **extra)


def log_sharded_walk(label, K, op, payload, fn, **extra) -> None:
    """A sharded walk's launch (one CTA per worker, a ring of >= 3 stages:
    checked) over its (T_pad, R, W) payload, the worker balance of this
    schedule (live slots of the busiest worker over the mean: the LPT
    makespan the one-CTA-per-worker rule keeps), and its device time and
    host enqueue."""
    p, B = op.p, op.superstep
    S_B = op.blkid.numel() // p
    T_pad, R, W = payload.shape
    shape = K.sharded_launch_shape(p, S_B, B, R, W)
    check(shape["ctas"] == p and shape["stages"] >= 3,
          f"{label} sharded walk: one CTA per worker, a ring of >= 3 stages")
    live = (op.rowid >= 0).view(p, -1).sum(dim=1).double()
    log(phase=f"{label}_sharded_grid", p=p, steps=S_B, superstep=B,
        rows_per_tile=R, width=W, **shape,
        live_slots_max=int(live.max()), live_slots_mean=float(live.mean()),
        balance=float(live.max() / live.mean()), **extra)
    log_split(f"{label}_sharded", fn, "sharded_walk", **extra)


def replay_cross_check(label, op, **extra) -> None:
    """The simulator's twin of a sharded kernel run: `replay_sharded` under
    zero overhead and jitter dispatches each tile on the worker the op's
    shard layout gave it. Its per-worker busy time must equal the
    per-worker sums of the cost stream the kernel emitted on its last call
    (within COST_RTOL), and its makespan their max."""
    from repro_torch.core.simulator import SimParams
    emitted = op.last_costs.double().sum(dim=1).cpu().numpy()
    t0 = time.perf_counter()
    rep = op.schedule.replay_sharded(
        p=op.p, superstep=op.superstep,
        params=SimParams(dispatch_overhead=0.0, local_dispatch_overhead=0.0,
                         speed_jitter=0.0), record_chunks=False)
    seconds = time.perf_counter() - t0
    diff = np.abs(rep.worker_busy - emitted)
    log(phase=f"{label}_replay_cross_check", workers=op.p, tiles=op.n_tiles,
        chunks=rep.chunks, makespan=rep.makespan,
        emitted_max=float(emitted.max()),
        max_rel_diff=float(np.max(diff / np.maximum(emitted, 1e-300))),
        seconds=seconds, **extra)
    check(rep.chunks == op.n_tiles and bool(np.all(
        diff <= COST_RTOL * emitted)),
        f"{label}: replay_sharded per-worker busy == emitted per-worker sums")
    check(abs(rep.makespan - float(emitted.max()))
          <= COST_RTOL * float(emitted.max()),
          f"{label}: replay_sharded makespan == max emitted per-worker sum")


def phase_moe(sm_count):
    """One OLMoE-1B-7B MoE layer over 4,096 tokens routed by
    `moe_router(seed=0)`, p = SM count, R = 2, B = 8: the counted main path
    (run, then three closed-loop rounds of refine_cap_scale -> plan ->
    rebuilt op -> run), the checks, the kernel against its plain version
    and the timings."""
    import torch
    from repro_torch.core.workloads import moe_router
    from repro_torch.kernels.ich_moe import ich_moe as K
    from repro_torch.sched import (LoopScheduler, plan_dispatch,
                                   refine_cap_scale)
    torch.backends.cuda.matmul.allow_tf32 = False  # plain + library: f32
    E, Kt, D, F, T = MOE_EXPERTS, MOE_TOP_K, MOE_D, MOE_F, MOE_TOKENS
    t0 = time.perf_counter()
    e_topk, w = moe_router(T, E, Kt, seed=SEED)
    plan = plan_dispatch(e_topk, w, cap_scale=np.ones(E))
    kept = int(plan.counts.sum())
    x, wi, wg, wo = _moe_weights(E, D, F, T, SEED)
    torch.cuda.synchronize()
    t_setup = time.perf_counter() - t0
    log(phase="moe_plan", tokens=T, experts=E, top_k=Kt, d_model=D,
        expert_ff=F, kept=kept, stolen=plan.stolen,
        dropped=plan.dropped, load_min=int(plan.counts.min()),
        load_max=int(plan.counts.max()), cap_max=int(plan.cap.max()),
        weight_bytes=3 * E * D * F * 4, x_bytes=T * D * 4, setup_s=t_setup)
    scheduler = LoopScheduler(p=sm_count, rows_per_tile=MOE_ROWS_PER_TILE)
    t0 = time.perf_counter()
    op = scheduler.build("moe-dispatch", plan)
    torch.cuda.synchronize()
    t_build = time.perf_counter() - t0
    s = op.schedule
    n_slots = op.slots.tok_slot.numel()
    log(phase="moe_lowering", tiles=op.n_tiles, width=s.width,
        rows_per_tile=s.rows_per_tile, p=op.p, superstep=op.superstep,
        blocks=int((op.shards.block_perm >= 0).sum()),
        steps=op.shards.n_steps, live_slots=n_slots,
        slot_buffer_bytes=n_slots * D * 4, scratch_bytes=n_slots * F * 4,
        build_s=t_build)

    # ---- the main path, counted: run -> three closed-loop rounds ----
    K.reset_launches()
    t0 = time.perf_counter()
    y = op(x, wi, wg, wo)
    load = op.expert_load()
    rounds, s_r, op_r, load_r = [], s, op, load
    for r in range(1, MOE_ROUNDS + 1):
        s_r, cap_scale = refine_cap_scale(s_r, load_r)
        plan_r = plan_dispatch(e_topk, w, cap_scale=cap_scale)
        op_r = scheduler.build("moe-dispatch", plan_r)
        y_r = op_r(x, wi, wg, wo)
        load_r = op_r.expert_load()
        check(np.array_equal(load_r, plan_r.counts.astype(np.float64)),
              f"MoE round {r}: expert_load() == plan.counts")
        check(bool(torch.isfinite(y_r).all()), f"MoE round {r}: y finite")
        rounds.append({"round": r, "generation": s_r.generation,
                       "kept": int(plan_r.counts.sum()),
                       "stolen": plan_r.stolen, "dropped": plan_r.dropped,
                       "cap_max": int(plan_r.cap.max()),
                       "tiles": op_r.n_tiles,
                       "blocks": int((op_r.shards.block_perm >= 0).sum())})
    torch.cuda.synchronize()
    t_path = time.perf_counter() - t0
    launches = dict(K.LAUNCHES)
    log(phase="moe_main_path", seconds=t_path, launches=launches,
        rounds=rounds)
    check(launches["ich_moe_sharded"] > 0, "ich_moe_sharded launched")
    check(all(rd["generation"] == rd["round"] for rd in rounds),
          "MoE refine generations count the rounds")
    SHAPES["moe"] = {
        "workload": "moe-dispatch", "inputs": (plan,),
        "sched": {"p": sm_count, "rows_per_tile": MOE_ROWS_PER_TILE},
        "schedule": s, "csr": None}
    del op_r, y_r

    # ---- checks of round 0 ----
    check(np.array_equal(load, plan.counts.astype(np.float64)),
          "MoE expert_load() == plan.counts")
    emitted = op.last_costs.cpu().numpy().sum(axis=1)
    check(np.array_equal(emitted, op.shards.worker_cost(
        s.tile_cost()).astype(np.float32)),
        "MoE per-worker step costs == worker_cost(tile_cost())")
    replay_cross_check("moe", op)
    check(tuple(y.shape) == (T, D) and bool(torch.isfinite(y).all()),
          "MoE y finite, (n_tokens, D)")
    sample = np.sort(np.random.default_rng(SEED).choice(T, MOE_SAMPLE,
                                                        replace=False))
    t0 = time.perf_counter()
    y64, absum = _moe_host_reference(plan, x, wi, wg, wo, sample)
    err = np.abs(y[torch_index(sample)].cpu().numpy() - y64)
    check(bool(np.all(err <= HOST_RTOL * absum)),
          f"MoE y within {HOST_RTOL} of float64 relative to each token's "
          f"sum |terms| (worst excess {float(np.max(err - HOST_RTOL * absum))})")
    log(phase="moe_host_check", tokens=MOE_SAMPLE,
        max_rel=float(np.max(err / np.maximum(absum, 1e-30))),
        seconds=time.perf_counter() - t0)

    # ---- the kernel against its plain version at the main path's shapes ----
    args = (op.vals, op.cols, op.rowid, op.blkid, x, wi, wg, wo, op.p,
            op.superstep, op.slots)
    y_k, c_k, e_k = K.ich_moe_sharded(*args, slot_cost=op.slot_cost)
    y_p, c_p, e_p = K.ich_moe_sharded_plain(*args, slot_cost=op.slot_cost)
    check(torch.allclose(y_k, y_p, rtol=MOE_TOL, atol=MOE_TOL),
          "full-width MoE kernel == plain")
    check(torch.equal(c_k, c_p) and torch.equal(e_k, e_p),
          "full-width MoE cost streams == plain")
    check(torch.equal(y_k, y), "full-width MoE kernel is deterministic")
    err_k = float((y_k - y_p).abs().max())
    del y_k, c_k, e_k, y_p, c_p, e_p
    library, C = capacity_buffer_moe(x, wi, wg, wo, plan)
    y_lib = library()
    torch.cuda.synchronize()
    lib_err = float((y_lib - y).abs().max())
    check(torch.allclose(y_lib, y, rtol=MOE_TOL, atol=MOE_TOL),
          "capacity-buffer bmm y agrees")
    del y_lib
    ms = timed_ms(lambda: K.ich_moe_sharded(*args, slot_cost=op.slot_cost))
    plain_ms = timed_ms(lambda: K.ich_moe_sharded_plain(
        *args, slot_cost=op.slot_cost))
    library_ms = timed_ms(library)
    log(phase="moe_library", capacity=C, buffer_entries=E * C,
        kept=kept, max_abs_diff=lib_err)
    breakdown = device_ms_by_kernel(
        lambda: K.ich_moe_sharded(*args, slot_cost=op.slot_cost))
    # achieved rate of each product: its float32 operations (up: two
    # products, 4*D*F a kept entry; down: 2*D*F) over its device time; the
    # tensor cores run three TF32 products for each
    rate = {}
    for label, key, per_entry in (("up", "moe_product<true", 4),
                                  ("down", "moe_product<false", 2)):
        k_ms = sum(v for name, v in breakdown.items() if key in name)
        rate[f"{label}_ms"] = k_ms
        rate[f"{label}_tflops"] = (per_entry * D * F * kept / (k_ms * 1e-3)
                                   / 1e12 if k_ms > 0 else None)
    log(phase="moe_breakdown", event_ms=ms, device_ms=breakdown,
        device_total_ms=sum(breakdown.values()), **rate)

    # ---- bound: each input read once, each output written once ----
    inputs = [op.vals, op.cols, op.rowid, op.blkid, op.slot_cost, x, wi, wg,
              wo, *op.slots]
    bytes_ = sum(t.numel() * t.element_size() for t in inputs) \
        + (T * D + op.p * (op.shards.n_steps + E)) * 4   # y, both streams
    flops = 6 * D * F * kept                              # three products
    # each float32 product runs as three TF32 products on the tensor cores
    return [kernel_entry("ich_moe_sharded",
                         launches=launches["ich_moe_sharded"], err=err_k,
                         ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                         bytes_=bytes_, flops=flops, peak=TF32_FLOPS / 3)]


def phase_small_lm():
    """Flash attention and the SSD scan against their plain versions on
    small shapes: flash over causal and not, GQA rep in {1, 2, 4}, ragged
    S, window in {0, 32}, float32 and bfloat16, dh in {64, 128}, then off
    the kernel's tile edges (Sq, Skv in {1, 15, 17, 200}, Sq != Skv, dh in
    {64, 96, 128}); the scan over several (S, H, N, Pd, chunk), ragged S,
    chunks of 1 and 7 steps and 11 chunks among them, with q/k
    materialised and shared across heads (head stride 0), in float32 and
    bfloat16, from a given state at N up to 512 and Pd up to 513, and
    chunk = 1024 against the float64 recurrence."""
    import itertools
    import torch
    from repro_torch.kernels.flash_attention import flash_attention as KF
    from repro_torch.kernels.mamba_scan import mamba_scan as KS
    from repro_torch.kernels.mamba_scan.ref import ssd_sequential_ref
    g = torch.Generator(device="cuda")
    g.manual_seed(SEED + 4)
    worst = {"float32": 0.0, "bfloat16": 0.0}
    cases = 0

    def flash_case(Sq, Skv, rep, dh, causal, window, dtype):
        q = torch.randn((2, Sq, 2 * rep, dh), generator=g, device="cuda")
        k = torch.randn((2, Skv, 2, dh), generator=g, device="cuda")
        v = torch.randn((2, Skv, 2, dh), generator=g, device="cuda")
        q, k, v = (t.to(getattr(torch, dtype)) for t in (q, k, v))
        out = KF.flash_attention(q, k, v, causal=causal, window=window)
        plain = KF.flash_attention_plain(q, k, v, causal=causal,
                                         window=window)
        torch.cuda.synchronize()
        tol = FLASH_TOL[dtype]
        check(torch.allclose(out.float(), plain.float(), rtol=tol, atol=tol),
              f"flash == plain at Sq={Sq} Skv={Skv} rep={rep} dh={dh} "
              f"causal={causal} window={window} {dtype}")
        worst[dtype] = max(worst[dtype], float(
            (out.float() - plain.float()).abs().max()))

    for causal in (True, False):
        for rep in (1, 2, 4):
            for S in (128, 200):
                for window in (0, 32):
                    for dtype in ("float32", "bfloat16"):
                        flash_case(S, S, rep, 128 if rep == 4 else 64,
                                   causal, window, dtype)
                        cases += 1
    edges = (1, 15, 17, 200)
    for Sq, Skv in itertools.product(edges, edges):
        for dh in (64, 96, 128):
            for causal in (True, False):
                for dtype in ("float32", "bfloat16"):
                    flash_case(Sq, Skv, 2, dh, causal, 0, dtype)
                    cases += 1
    scan_worst = {"float32": 0.0, "bfloat16": 0.0}
    scan_cases = 0
    for S, H, N, Pd, chunk in ((128, 2, 16, 32, 64), (300, 4, 64, 64, 256),
                               (129, 2, 8, 16, 64), (100, 2, 64, 128, 32),
                               (520, 8, 64, 64, 256), (37, 3, 64, 64, 256),
                               (50, 2, 64, 64, 1), (60, 2, 64, 64, 7),
                               (700, 2, 64, 64, 64), (300, 2, 13, 30, 100)):
        for shared in (False, True):
            q = torch.randn((2, S, 1 if shared else H, N), generator=g,
                            device="cuda")
            k = torch.randn((2, S, 1 if shared else H, N), generator=g,
                            device="cuda")
            q, k = q.expand(2, S, H, N), k.expand(2, S, H, N)
            v = torch.randn((2, S, H, Pd), generator=g, device="cuda")
            la = -torch.rand((2, S, H), generator=g, device="cuda") * 0.3
            for dtype, tol in (("float32", SCAN_TOL),
                               ("bfloat16", SCAN_TOL_BF16)):
                qd, kd, vd = (t.to(getattr(torch, dtype)) for t in (q, k, v))
                y, st = KS.mamba_scan(qd, kd, vd, la, chunk=chunk)
                y_p, st_p = KS.mamba_scan_plain(qd, kd, vd, la, chunk=chunk)
                torch.cuda.synchronize()
                check(torch.allclose(y.float(), y_p.float(), rtol=tol,
                                     atol=tol)
                      and torch.allclose(st, st_p, rtol=tol, atol=tol),
                      f"scan == plain at S={S} H={H} N={N} Pd={Pd} "
                      f"chunk={chunk} shared={shared} {dtype}")
                scan_worst[dtype] = max(
                    scan_worst[dtype], float((y.float() - y_p.float())
                                             .abs().max()),
                    float((st - st_p).abs().max()))
                scan_cases += 1
    # from a given state: N over 64 (its slices of 64), Pd over 64 (score
    # tiles per head) and off the 16-byte copies (xlstm's Pd = 513)
    for S, H, N, Pd, chunk in ((300, 2, 128, 65, 64), (300, 2, 512, 513, 256),
                               (129, 3, 16, 33, 64), (520, 2, 64, 64, 256)):
        q = torch.randn((2, S, H, N), generator=g, device="cuda")
        k = torch.randn((2, S, H, N), generator=g, device="cuda") / N ** 0.5
        v = torch.randn((2, S, H, Pd), generator=g, device="cuda")
        la = -torch.rand((2, S, H), generator=g, device="cuda") * 0.3
        st0 = torch.randn((2, H, N, Pd), generator=g, device="cuda")
        y, st = KS.mamba_scan(q, k, v, la, chunk=chunk, state=st0)
        y_p, st_p = KS.mamba_scan_plain(q, k, v, la, chunk=chunk, state=st0)
        torch.cuda.synchronize()
        check(torch.allclose(y, y_p, rtol=SCAN_TOL, atol=SCAN_TOL)
              and torch.allclose(st, st_p, rtol=SCAN_TOL, atol=SCAN_TOL),
              f"scan from a state == plain at S={S} H={H} N={N} Pd={Pd} "
              f"chunk={chunk}")
        scan_worst["float32"] = max(scan_worst["float32"],
                                    float((y - y_p).abs().max()),
                                    float((st - st_p).abs().max()))
        scan_cases += 1
    # chunk = 1024: inside a chunk that long l runs to ~-150 and
    # exp(l_i - l_j) subtracts two large cumulative sums whose rounding
    # depends on their order (torch.cumsum against the kernel's scan), so
    # both versions are held as the serving shape is: within SCAN_TOL of
    # each element's sum of |terms|, against each other and against float64
    long_chunk = {}
    for S, shared in ((1500, True), (1100, False)):
        H, N, Pd = 2, 64, 64
        q = torch.randn((2, S, 1 if shared else H, N), generator=g,
                        device="cuda").expand(2, S, H, N)
        k = torch.randn((2, S, 1 if shared else H, N), generator=g,
                        device="cuda").expand(2, S, H, N)
        v = torch.randn((2, S, H, Pd), generator=g, device="cuda")
        la = -torch.rand((2, S, H), generator=g, device="cuda") * 0.3
        y, st = KS.mamba_scan(q, k, v, la, chunk=1024)
        y_p, st_p = KS.mamba_scan_plain(q, k, v, la, chunk=1024)
        y_a, st_a = KS.mamba_scan_plain(q.abs(), k.abs(), v.abs(), la,
                                        chunk=1024)
        y_64, st_64 = ssd_sequential_ref(q, k, v, la)
        rel = {"kernel_vs_plain": max(_rel_terms(y, y_p, y_a),
                                      _rel_terms(st, st_p, st_a)),
               "kernel_vs_f64": max(_rel_terms(y, y_64, y_a),
                                    _rel_terms(st, st_64, st_a)),
               "plain_vs_f64": max(_rel_terms(y_p, y_64, y_a),
                                   _rel_terms(st_p, st_64, st_a))}
        long_chunk[f"S{S}_shared{shared}"] = rel
        check(rel["kernel_vs_plain"] <= SCAN_TOL
              and rel["kernel_vs_f64"] <= SCAN_TOL,
              f"scan at chunk 1024 (S={S}, shared={shared}) within "
              f"{SCAN_TOL} of each element's sum |terms|")
        scan_cases += 1
    log(phase="small_lm", flash_cases=cases, flash_max_abs_err=worst,
        scan_cases=scan_cases, scan_max_abs_err=scan_worst,
        scan_chunk_1024_max_rel_to_terms=long_chunk, ok=True)


def _rel_terms(a, b, terms) -> float:
    """The largest |a - b| over the sum of |terms| of the same element."""
    return float(((a.double() - b.double()).abs()
                  / (terms.double() + 1e-30)).max())


def _kernel_split(ms_by_name: dict) -> dict:
    """Device milliseconds of one traced call grouped: the LM kernels
    (flash, its backward's three `flash_bwd_*` kernels, the SSD scan, its
    backward's `ssd_bwd_*` kernels, the expert kernel's five `moe_*`
    kernels, its backward's five `moe_bwd_*`), matrix products (cuBLAS's
    `*gemm*` and `nvjet_*` kernels, CUTLASS),
    matrix products (cuBLAS/CUTLASS), everything else."""
    out = {"flash_attention": 0.0, "flash_attention_bwd": 0.0,
           "mamba_scan": 0.0, "mamba_scan_bwd": 0.0, "ich_moe": 0.0,
           "ich_moe_bwd": 0.0, "matmul": 0.0, "other": 0.0}
    for name, ms in ms_by_name.items():
        low = name.lower()
        if "flash_fwd_kernel" in name:
            out["flash_attention"] += ms
        elif "flash_bwd_" in name:
            out["flash_attention_bwd"] += ms
        elif "ssd_scan_kernel" in name:
            out["mamba_scan"] += ms
        elif "ssd_bwd_kernel" in name:
            out["mamba_scan_bwd"] += ms
        elif "moe_bwd_" in name:
            out["ich_moe_bwd"] += ms
        elif "moe_" in name:
            out["ich_moe"] += ms
        elif any(w in low for w in ("gemm", "cutlass", "matmul", "nvjet")):
            out["matmul"] += ms
        else:
            out["other"] += ms
    return out


def _split_log(label, fn, wall_ms, expect=(), top: int = 0,
               warmup: bool = True) -> dict:
    """Where one call's device time goes (`_kernel_split`'s groups, those
    with no time left out) against its wall time: logged as `<label>` with
    the idle share (and the `top` kernels by time, when asked),
    returned. `warmup` as in `device_ms_by_kernel`."""
    by_name = device_ms_by_kernel(fn, expect=expect, warmup=warmup)
    split = {k_: v_ for k_, v_ in _kernel_split(by_name).items() if v_ > 0}
    total = sum(split.values())
    rec = {"device_ms": split, "device_total_ms": total,
           "share": {k_: v_ / total for k_, v_ in split.items()},
           "wall_ms": wall_ms, "idle_share": 1.0 - total / wall_ms}
    if top:
        rec["top_kernels_ms"] = dict(sorted(by_name.items(),
                                            key=lambda kv: -kv[1])[:top])
    log(phase=label, **rec)
    return rec


def _wall_ms(fn, reps: int = 5) -> float:
    """The median wall milliseconds of fn() with a synchronize, of reps."""
    import torch
    wall = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall.append(time.perf_counter() - t0)
    return float(np.median(wall)) * 1e3


def _scan_work(B, S, H, N, Pd, chunk, *, shared_qk: bool):
    """Operations the scan's algebra needs on these shapes. Per chunk of
    length c (the last may be short) and c(c+1)/2 causal pairs: 2N for the
    q.k score of each pair, once per batch row when q and k are shared by
    all heads (Zamba2's C and B, a head stride of 0) and once per head
    otherwise; per head, 2Pd + 1 for each pair's decayed product with v,
    and 4 c N Pd for the inter-chunk term and the state update."""
    score = per_head = 0
    for t0 in range(0, S, chunk):
        c = min(chunk, S - t0)
        pairs = c * (c + 1) // 2
        score += pairs * 2 * N
        per_head += pairs * (2 * Pd + 1) + 4 * c * N * Pd
    return B * (score * (1 if shared_qk else H) + H * per_head)


def phase_zamba2():
    """Zamba2-1.2B at full width (38 layers, d_model 2048, random weights
    from a seeded generator on the card, float32): the counted main path
    `Engine.generate` on 4 prompts of 2,048 tokens with 32 new tokens;
    bars (a) the last chunk's logits == a one-shot prefill bit for bit,
    (b) decode at position S == a fresh prefill of S + 1 tokens within
    DECODE_TOL, (c) finite logits; then both kernels at the main path's
    shapes against their plain versions, timed beside their bounds and
    (flash) scaled_dot_product_attention."""
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.kernels.flash_attention import flash_attention as KF
    from repro_torch.kernels.mamba_scan import mamba_scan as KS
    from repro_torch.kernels.mamba_scan.ref import ssd_sequential_ref
    from repro_torch.models import model as M
    from repro_torch.serve import Engine, EngineConfig
    torch.backends.cuda.matmul.allow_tf32 = False  # float32 end to end
    cfg = get_arch(LM_ARCH)
    B, S, n_new = LM_BATCH, LM_PROMPT, LM_NEW
    t0 = time.perf_counter()
    params = M.init_params(cfg, SEED, device="cuda")
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in params.parameters())
    prompts = np.random.default_rng(SEED).integers(
        0, cfg.vocab_size, (B, S)).astype(np.int64)
    log(phase="zamba2_setup", arch=cfg.name, layers=cfg.n_layers,
        d_model=cfg.d_model, attention_uses=cfg.block_pattern.count("A"),
        mamba_blocks=cfg.block_pattern.count("M"), params=n_params,
        weight_bytes=n_params * 4, batch=B, prompt=S, new_tokens=n_new,
        init_s=time.perf_counter() - t0)
    # first use of cuBLAS and of both kernel libraries, outside the count
    M.prefill(cfg, params, {"tokens": torch.from_numpy(
        prompts[:, :64]).cuda()})
    torch.cuda.synchronize()

    # ---- the main path, counted ----
    KF.reset_launches()
    KS.reset_launches()
    engine = Engine(cfg, params, EngineConfig(max_seq=LM_MAX_SEQ))
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    ids, stats = engine.generate(prompts, n_new=n_new)
    torch.cuda.synchronize()
    t_generate = time.perf_counter() - t0
    launches = {"flash_attention": KF.LAUNCHES["flash_attention"],
                "mamba_scan": KS.LAUNCHES["mamba_scan"]}
    chunks = stats["chunks"]
    t_prefill = sum(c["dt"] for c in chunks)
    reruns = engine.n_prefill_fallbacks
    log(phase="zamba2_main_path", chunk_log=chunks,
        n_prefill_fallbacks=reruns, launches=launches,
        generate_s=t_generate, time_to_first_token_s=t_prefill,
        decode_ms_per_token=(t_generate - t_prefill) / n_new * 1e3,
        generated_ids=ids.tolist(), peak_gb=torch.cuda.max_memory_allocated()
        / 1e9)
    check(reruns == len(chunks) > 0, "every prefill chunk counted")
    check(launches["flash_attention"] == cfg.block_pattern.count("A") * reruns
          and launches["mamba_scan"] == cfg.block_pattern.count("M") * reruns,
          "flash 6 and scan 32 launches per prefill rerun")
    check(ids.shape == (B, n_new) and bool(np.all((ids >= 0)
                                                  & (ids < cfg.vocab_size))),
          "generated ids in the vocabulary")

    # ---- bars ----
    toks = torch.from_numpy(prompts).cuda()
    last, _, _ = Engine(cfg, params, EngineConfig(
        max_seq=LM_MAX_SEQ)).prefill_chunked(prompts)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    one_shot, cache = M.prefill(cfg, params, {"tokens": toks})
    torch.cuda.synchronize()
    t_one_shot = time.perf_counter() - t0
    check(torch.equal(last, one_shot),
          "(a) last chunk's logits == one-shot prefill bit for bit")
    check(bool(torch.isfinite(one_shot).all()), "(c) prefill logits finite")
    first = torch.from_numpy(ids[:, :1].astype(np.int64)).cuda()
    d_logits, _ = M.decode_step(cfg, params, first, engine._pad_cache(cache),
                                S)
    fresh, _ = M.prefill(cfg, params, {"tokens": torch.cat([toks, first],
                                                           dim=1)})
    torch.cuda.synchronize()
    err = float((d_logits - fresh).abs().max())
    log(phase="zamba2_bars", one_shot_prefill_s=t_one_shot,
        decode_vs_prefill_max_abs=err,
        logits_max_abs=float(fresh.abs().max()),
        decode_argmax_is_second_id=bool(np.array_equal(
            d_logits.argmax(-1).cpu().numpy(), ids[:, 1])))
    check(bool(torch.isfinite(d_logits).all()), "(c) decode logits finite")
    check(torch.allclose(d_logits, fresh, rtol=DECODE_TOL, atol=DECODE_TOL),
          f"(b) decode at S == prefill of S + 1 within {DECODE_TOL}")
    split = _kernel_split(device_ms_by_kernel(
        lambda: M.prefill(cfg, params, {"tokens": toks})))
    total = sum(split.values())
    log(phase="zamba2_prefill_split", device_ms=split, device_total_ms=total,
        share={k_: v_ / total for k_, v_ in split.items()})
    # one decode step (position S, rewritten in place each call): the
    # card's busy time against the host's wall time
    dec_cache = engine._pad_cache(cache)

    def one_decode():
        M.decode_step(cfg, params, first, dec_cache, S)
    _split_log("zamba2_decode_split", one_decode, _wall_ms(one_decode))
    del cache, dec_cache, last, one_shot, d_logits, fresh, engine

    # ---- both kernels at the main path's shapes ----
    g = torch.Generator(device="cuda")
    g.manual_seed(SEED + 5)
    Hq, Hkv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.dh
    q = torch.randn((B, S, Hq, dh), generator=g, device="cuda")
    k = torch.randn((B, S, Hkv, dh), generator=g, device="cuda")
    v = torch.randn((B, S, Hkv, dh), generator=g, device="cuda")
    win = cfg.attn_window
    out = KF.flash_attention(q, k, v, causal=True, window=win)
    plain = KF.flash_attention_plain(q, k, v, causal=True, window=win)
    torch.cuda.synchronize()
    check(torch.allclose(out, plain, rtol=FLASH_TOL["float32"],
                         atol=FLASH_TOL["float32"]),
          "main-path-shape flash == plain")
    err_flash = float((out - plain).abs().max())
    del plain
    check(torch.equal(out, KF.flash_attention(q, k, v, causal=True,
                                              window=win)),
          "main-path-shape flash: two calls give the same bits")
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    gqa = Hq != Hkv

    def sdpa():
        return torch.nn.functional.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True, enable_gqa=gqa)
    lib_out = sdpa().transpose(1, 2)
    log(phase="flash_library", sdpa_max_abs_diff=float(
        (lib_out - out).abs().max()))
    del lib_out
    flash_ms = timed_ms(lambda: KF.flash_attention(q, k, v, causal=True,
                                                   window=win))
    flash_plain_ms = timed_ms(lambda: KF.flash_attention_plain(
        q, k, v, causal=True, window=win))
    flash_lib_ms = timed_ms(sdpa)
    pairs = S * (S + 1) // 2                 # S <= window: causal pairs
    flash_flops = 4 * dh * pairs * B * Hq    # q.k and p.v, 2 flops a MAC
    flash_bytes = 4 * (q.numel() + k.numel() + v.numel() + out.numel())
    del q, k, v, out, qt, kt, vt

    d_in = cfg.mamba_expand * cfg.d_model
    H, N, Pd = d_in // cfg.ssm_head_dim, cfg.ssm_state, cfg.ssm_head_dim
    chunk = min(cfg.ssm_chunk, S)
    Cm = torch.randn((B, S, N), generator=g, device="cuda")
    Bm = torch.randn((B, S, N), generator=g, device="cuda")
    qs, ks = Cm[:, :, None].expand(B, S, H, N), Bm[:, :, None].expand(
        B, S, H, N)                           # shared across heads
    vs = torch.randn((B, S, H, Pd), generator=g, device="cuda")
    # the model's decay: log_a = -exp(A_log) dt with A_log = 0 and
    # dt = softplus(.), so l reaches ~ -180 inside a 256-step chunk
    la = -torch.nn.functional.softplus(torch.randn((B, S, H), generator=g,
                                                   device="cuda"))
    y, st = KS.mamba_scan(qs, ks, vs, la, chunk=chunk)
    y_p, st_p = KS.mamba_scan_plain(qs, ks, vs, la, chunk=chunk)
    # exp(l_i - l_j) subtracts two large cumulative sums, whose rounding
    # depends on the order they were summed in (a parallel cumsum on each
    # side): the error is measured against each element's sum of |terms|,
    # the scan of |q|, |k|, |v| with the same decays
    y_abs, st_abs = KS.mamba_scan_plain(qs.abs(), ks.abs(), vs.abs(), la,
                                        chunk=chunk)
    torch.cuda.synchronize()
    rel_y = float(((y - y_p).abs() / (y_abs + 1e-30)).max())
    rel_st = float(((st - st_p).abs() / (st_abs + 1e-30)).max())
    log(phase="scan_main_shape_check", max_abs_y=float((y - y_p).abs().max()),
        max_rel_to_terms_y=rel_y, max_rel_to_terms_state=rel_st,
        y_max_abs=float(y_p.abs().max()))
    check(rel_y <= SCAN_TOL and rel_st <= SCAN_TOL,
          f"main-path-shape scan == plain within {SCAN_TOL} of each "
          f"element's sum |terms|")
    # which side drifts: both against the step-by-step recurrence in
    # float64, which has no cumulative sum and no exp(l_i - l_j)
    y_64, st_64 = ssd_sequential_ref(qs, ks, vs, la)

    drift = {"kernel_y": _rel_terms(y, y_64, y_abs),
             "plain_y": _rel_terms(y_p, y_64, y_abs),
             "kernel_state": _rel_terms(st, st_64, st_abs),
             "plain_state": _rel_terms(st_p, st_64, st_abs)}
    log(phase="scan_main_shape_f64", max_rel_to_terms=drift,
        max_abs={"kernel_y": float((y.double() - y_64).abs().max()),
                 "plain_y": float((y_p.double() - y_64).abs().max())})
    check(drift["kernel_y"] <= SCAN_TOL and drift["kernel_state"] <= SCAN_TOL,
          f"main-path-shape scan == float64 recurrence within {SCAN_TOL} "
          f"of each element's sum |terms|")
    del y_64, st_64
    err_scan = max(float((y - y_p).abs().max()),
                   float((st - st_p).abs().max()))
    del y_p, st_p, y_abs, st_abs
    y2, st2 = KS.mamba_scan(qs, ks, vs, la, chunk=chunk)
    check(torch.equal(y, y2) and torch.equal(st, st2),
          "main-path-shape scan: two calls give the same bits")
    del y2, st2
    scan_ms = timed_ms(lambda: KS.mamba_scan(qs, ks, vs, la, chunk=chunk))
    scan_plain_ms = timed_ms(lambda: KS.mamba_scan_plain(qs, ks, vs, la,
                                                         chunk=chunk))
    scan_flops = _scan_work(B, S, H, N, Pd, chunk, shared_qk=True)
    scan_bytes = 4 * (Cm.numel() + Bm.numel() + vs.numel() + la.numel()
                      + y.numel() + st.numel())
    log(phase="lm_kernels", flash_shape=[B, S, Hq, Hkv, dh],
        scan_shape=[B, S, H, N, Pd, chunk], flash_flops=flash_flops,
        scan_flops=scan_flops)
    steps = {}
    for name, ms in device_ms_by_kernel(
            lambda: KS.mamba_scan(qs, ks, vs, la, chunk=chunk),
            expect=SCAN_STEPS).items():
        step = _scan_step(name)
        steps[step] = steps.get(step, 0.0) + ms
    scan_device = sum(v for k_, v in steps.items() if k_ != "other")
    log(phase="scan_breakdown", device_ms=steps, kernels_ms=scan_device,
        **_rates(scan_flops, scan_device))
    del qs, ks, vs, la, y, st, Cm, Bm
    q = torch.randn((B, S, Hq, dh), generator=g, device="cuda")
    k = torch.randn((B, S, Hkv, dh), generator=g, device="cuda")
    v = torch.randn((B, S, Hkv, dh), generator=g, device="cuda")
    by_name = device_ms_by_kernel(
        lambda: KF.flash_attention(q, k, v, causal=True, window=win))
    flash_device = sum(v_ for n, v_ in by_name.items()
                       if "flash_fwd_kernel" in n)
    log(phase="flash_breakdown", device_ms=by_name, kernel_ms=flash_device,
        **_rates(flash_flops, flash_device))
    # float32 inputs: both products run as three TF32 products on the
    # tensor cores
    return [kernel_entry("flash_attention",
                         launches=launches["flash_attention"], err=err_flash,
                         ms=flash_ms, plain_ms=flash_plain_ms,
                         library_ms=flash_lib_ms, bytes_=flash_bytes,
                         flops=flash_flops, peak=TF32_FLOPS / 3),
            kernel_entry("mamba_scan", launches=launches["mamba_scan"],
                         err=err_scan, ms=scan_ms, plain_ms=scan_plain_ms,
                         library_ms=None, bytes_=scan_bytes,
                         flops=scan_flops, peak=TF32_FLOPS / 3)]


def _states_equal(a, b) -> bool:
    """Two caches (lists of tensors or of dicts of tensors) equal bit for
    bit."""
    import torch
    if isinstance(a, dict):
        return set(a) == set(b) and all(_states_equal(a[n], b[n]) for n in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(map(_states_equal, a, b))
    return a.dtype == b.dtype and bool(torch.equal(a, b))


def phase_xlstm():
    """xlstm-350m at full width (24 layers: 18 mLSTM, 6 sLSTM, d_model 1024,
    random weights from a seeded generator on the card, float32): the
    counted main path `Engine.generate` on 4 prompts of 2,048 tokens with
    32 new tokens, its prefill incremental (each chunk only its own tokens
    through `prefill_extend`, 18 scan launches a call, from the last
    chunk's states); bars (a) the incremental prefill's last logits and
    every block state == a one-shot prefill's bit for bit, no prefix rerun,
    every chunk but the last a multiple of Q = 256, (b) decode at position
    S == a fresh prefill of S + 1 tokens within DECODE_TOL, (c) finite
    logits, (d) 18 scan launches per prefill and per prefill_extend call;
    then the scan at the mLSTM shape (N 512, Pd 513) without and with a
    state, (e) within SCAN_TOL of each element's sum of |terms| of the
    plain version and of the float64 recurrence, (f) one call == two calls
    split at a chunk boundary bit for bit, (g) two calls the same bits;
    timed beside its bound."""
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.kernels.mamba_scan import mamba_scan as KS
    from repro_torch.kernels.mamba_scan.ref import ssd_sequential_ref
    from repro_torch.models import model as M
    from repro_torch.models import ssm as SS
    from repro_torch.serve import Engine, EngineConfig
    torch.backends.cuda.matmul.allow_tf32 = False  # float32 end to end
    cfg = get_arch(XLSTM_ARCH)
    B, S, n_new = LM_BATCH, LM_PROMPT, LM_NEW
    n_x, H = cfg.block_pattern.count("X"), cfg.n_heads
    t0 = time.perf_counter()
    params = M.init_params(cfg, SEED, device="cuda")
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in params.parameters())
    prompts = np.random.default_rng(SEED + 1).integers(
        0, cfg.vocab_size, (B, S)).astype(np.int64)
    log(phase="xlstm_setup", arch=cfg.name, layers=cfg.n_layers,
        d_model=cfg.d_model, mlstm_blocks=n_x,
        slstm_blocks=cfg.block_pattern.count("S"), params=n_params,
        weight_bytes=n_params * 4, batch=B, prompt=S, new_tokens=n_new,
        init_s=time.perf_counter() - t0)
    # first use of cuBLAS and the scan at these widths, outside the count
    M.prefill(cfg, params, {"tokens": torch.from_numpy(
        prompts[:, :64]).cuda()})
    torch.cuda.synchronize()

    # ---- the main path, counted ----
    KS.reset_launches()
    engine = Engine(cfg, params, EngineConfig(max_seq=LM_MAX_SEQ))
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    ids, stats = engine.generate(prompts, n_new=n_new)
    torch.cuda.synchronize()
    t_generate = time.perf_counter() - t0
    launches = KS.LAUNCHES["mamba_scan"]
    chunks = stats["chunks"]
    sizes = [c["chunk"] for c in chunks]
    t_prefill = sum(c["dt"] for c in chunks)
    Q = min(cfg.ssm_chunk, S)
    log(phase="xlstm_main_path", chunk_log=chunks,
        n_prefill_fallbacks=engine.n_prefill_fallbacks,
        launches={"mamba_scan": launches}, generate_s=t_generate,
        time_to_first_token_s=t_prefill,
        decode_ms_per_token=(t_generate - t_prefill) / n_new * 1e3,
        generated_ids=ids.tolist(),
        peak_gb=torch.cuda.max_memory_allocated() / 1e9)
    check(engine.n_prefill_fallbacks == 0 and sum(sizes) == S,
          "(a) incremental prefill: no prefix rerun")
    check(all(c % Q == 0 for c in sizes[:-1]),
          f"(a) every chunk but the last a multiple of Q = {Q}")
    check(launches == n_x * len(chunks),
          f"(d) {n_x} scan launches per prefill_extend call")
    check(ids.shape == (B, n_new) and bool(np.all((ids >= 0)
                                                  & (ids < cfg.vocab_size))),
          "generated ids in the vocabulary")

    # ---- bars ----
    toks = torch.from_numpy(prompts).cuda()
    KS.reset_launches()
    last, inc_cache, inc_log = Engine(cfg, params, EngineConfig(
        max_seq=LM_MAX_SEQ)).prefill_chunked(prompts)
    torch.cuda.synchronize()
    inc_launches = KS.LAUNCHES["mamba_scan"]
    KS.reset_launches()
    t0 = time.perf_counter()
    one_shot, cache = M.prefill(cfg, params, {"tokens": toks})
    torch.cuda.synchronize()
    t_one_shot = time.perf_counter() - t0
    one_launches = KS.LAUNCHES["mamba_scan"]
    check(one_launches == n_x and inc_launches == n_x * len(inc_log),
          f"(d) {n_x} scan launches per prefill and prefill_extend call")
    check(torch.equal(last, one_shot) and _states_equal(inc_cache, cache),
          "(a) incremental prefill's logits and block states == one-shot "
          "prefill bit for bit")
    check(bool(torch.isfinite(one_shot).all()), "(c) prefill logits finite")
    first = torch.from_numpy(ids[:, :1].astype(np.int64)).cuda()
    d_logits, _ = M.decode_step(cfg, params, first, cache, S)
    fresh, _ = M.prefill(cfg, params, {"tokens": torch.cat([toks, first],
                                                           dim=1)})
    torch.cuda.synchronize()
    err = float((d_logits - fresh).abs().max())
    log(phase="xlstm_bars", one_shot_prefill_s=t_one_shot,
        second_run_chunks=[c["chunk"] for c in inc_log],
        decode_vs_prefill_max_abs=err,
        logits_max_abs=float(fresh.abs().max()),
        decode_argmax_is_second_id=bool(np.array_equal(
            d_logits.argmax(-1).cpu().numpy(), ids[:, 1])))
    check(bool(torch.isfinite(d_logits).all()), "(c) decode logits finite")
    check(torch.allclose(d_logits, fresh, rtol=DECODE_TOL, atol=DECODE_TOL),
          f"(b) decode at S == prefill of S + 1 within {DECODE_TOL}")
    del inc_cache, last, d_logits, fresh, cache, one_shot
    # why the mLSTM and sLSTM run their token-wise products per block of Q
    # tokens (`layers.by_blocks`): does a product's row give the same bits
    # over Q tokens as over the whole prompt?
    mlstm = params.blocks[0].mlstm
    gr = torch.Generator(device="cuda").manual_seed(SEED + 8)
    xm = torch.randn((B, S, mlstm.wq.shape[0]), generator=gr, device="cuda")
    rows = {}
    for name in ("w_i", "wq", "down"):
        w = getattr(mlstm, name)
        xs = xm[..., :w.shape[0]]
        full = xs.contiguous() @ w
        rows[name] = {"shape": list(w.shape), "rows_of_one_call_equal": {
            f"{how}_{c}": bool(torch.equal(full[:, :c], (
                xs[:, :c].contiguous() if how == "contiguous" else xs[:, :c])
                @ w)) for c in (Q, 4 * Q) for how in ("contiguous", "strided")}}
    log(phase="xlstm_row_invariance", products=rows)
    del xm, full

    # ---- the scan at the mLSTM shape ----
    d_in = cfg.mamba_expand * cfg.d_model
    N = d_in // H
    Pd = N + 1
    g = torch.Generator(device="cuda")
    g.manual_seed(SEED + 6)
    # mLSTM's inputs: q, k scaled by dh^-1/2 (k also by the input gate), v
    # with the ones channel, log_a = log(sigmoid(.) + 1e-9)
    q = torch.randn((B, S, H, N), generator=g, device="cuda") * N ** -0.5
    k = torch.randn((B, S, H, N), generator=g, device="cuda") * N ** -0.5 \
        * torch.rand((B, S, H, 1), generator=g, device="cuda")
    v = torch.randn((B, S, H, Pd), generator=g, device="cuda")
    v[..., -1] = 1.0
    la = torch.log(torch.sigmoid(torch.randn((B, S, H), generator=g,
                                             device="cuda") + 1.0) + 1e-9)
    st0 = torch.randn((B, H, N, Pd), generator=g, device="cuda")
    rec, err_scan = {}, 0.0
    for name, state in (("no_state", None), ("state", st0)):
        y, st = KS.mamba_scan(q, k, v, la, chunk=Q, state=state)
        y_p, st_p = KS.mamba_scan_plain(q, k, v, la, chunk=Q, state=state)
        y_a, st_a = KS.mamba_scan_plain(
            q.abs(), k.abs(), v.abs(), la, chunk=Q,
            state=None if state is None else state.abs())
        y_64, st_64 = ssd_sequential_ref(q, k, v, la, state)
        torch.cuda.synchronize()
        rel = {"kernel_vs_plain": max(_rel_terms(y, y_p, y_a),
                                      _rel_terms(st, st_p, st_a)),
               "kernel_vs_f64": max(_rel_terms(y, y_64, y_a),
                                    _rel_terms(st, st_64, st_a)),
               "plain_vs_f64": max(_rel_terms(y_p, y_64, y_a),
                                   _rel_terms(st_p, st_64, st_a))}
        del y_64, st_64, y_a, st_a
        check(rel["kernel_vs_plain"] <= SCAN_TOL
              and rel["kernel_vs_f64"] <= SCAN_TOL,
              f"(e) xlstm-shape scan ({name}) within {SCAN_TOL} of each "
              f"element's sum |terms| of plain and float64")
        err_scan = max(err_scan, float((y - y_p).abs().max()),
                       float((st - st_p).abs().max()))
        del y_p, st_p
        # (f) split at a chunk boundary, the second call from the first's
        # final state; (g) a second call
        cut = S // 2 // Q * Q
        ya, sa = KS.mamba_scan(q[:, :cut], k[:, :cut],
                               v[:, :cut].contiguous(),
                               la[:, :cut].contiguous(), chunk=Q,
                               state=state)
        yb, sb = KS.mamba_scan(q[:, cut:], k[:, cut:],
                               v[:, cut:].contiguous(),
                               la[:, cut:].contiguous(), chunk=Q, state=sa)
        check(torch.equal(y, torch.cat([ya, yb], 1)) and torch.equal(st, sb),
              f"(f) xlstm-shape scan ({name}): one call == two calls split "
              f"at a chunk boundary, bit for bit")
        y2, st2 = KS.mamba_scan(q, k, v, la, chunk=Q, state=state)
        check(torch.equal(y, y2) and torch.equal(st, st2),
              f"(g) xlstm-shape scan ({name}): two calls, the same bits")
        del ya, sa, yb, sb, y2, st2, y, st
        rec[name] = {
            "max_rel_to_terms": rel,
            "ms": timed_ms(lambda: KS.mamba_scan(q, k, v, la, chunk=Q,
                                                 state=state)),
            "plain_ms": timed_ms(lambda: KS.mamba_scan_plain(
                q, k, v, la, chunk=Q, state=state))}
    steps = {}
    for name, ms in device_ms_by_kernel(
            lambda: KS.mamba_scan(q, k, v, la, chunk=Q, state=st0),
            expect=SCAN_STEPS).items():
        step = _scan_step(name)
        steps[step] = steps.get(step, 0.0) + ms
    scan_flops = _scan_work(B, S, H, N, Pd, Q, shared_qk=False)
    scan_device = sum(v_ for k_, v_ in steps.items() if k_ != "other")
    # inputs read once (the state too, when given), outputs written once
    scan_bytes = 4 * (q.numel() + k.numel() + 2 * v.numel() + la.numel()
                      + 2 * st0.numel())
    log(phase="xlstm_scan", shape=[B, S, H, N, Pd, Q], flops=scan_flops,
        bytes=scan_bytes, load_path="16-byte cp.async" if Pd % 4 == 0
        else "4-byte cp.async (Pd % 4 != 0)",
        score_tiles_per_head=KS._score_heads(q, k, N, Pd),
        max_abs_err=err_scan, **rec)
    log(phase="xlstm_scan_breakdown", device_ms=steps, kernels_ms=scan_device,
        **_rates(scan_flops, scan_device))
    del q, k, v, la, st0

    # ---- where the prefill's device time goes: the sLSTM recurrences
    # (their own trace: bmm and elementwise kernels, launched one step at
    # a time) taken out of the prefill's cuBLAS products and other ----
    split = _kernel_split(device_ms_by_kernel(
        lambda: M.prefill(cfg, params, {"tokens": toks})))
    gs = torch.Generator(device="cuda")
    gs.manual_seed(SEED + 7)
    dh = cfg.d_model // H
    # z, then the output, input and forget gates (in (0, 1))
    slstm_in = [torch.randn((B, S, H, dh), generator=gs, device="cuda"),
                torch.rand((B, S, H, dh), generator=gs, device="cuda"),
                torch.rand((B, S, H), generator=gs, device="cuda"),
                torch.rand((B, S, H), generator=gs, device="cuda")]
    h0 = torch.zeros((B, H, dh), device="cuda")
    r = params.blocks[cfg.block_pattern.index("S")].slstm.r
    n_s = cfg.block_pattern.count("S")

    def slstm_loops():
        for _ in range(n_s):
            SS.slstm_recurrence(r, *slstm_in, h0, h0)
    loop = _kernel_split(device_ms_by_kernel(slstm_loops))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    slstm_loops()
    torch.cuda.synchronize()
    loop_wall = time.perf_counter() - t0
    xsplit = {"cublas_products": split["matmul"] - loop["matmul"],
              "mamba_scan": split["mamba_scan"],
              "slstm_loop": loop["matmul"] + loop["other"],
              "other": split["other"] - loop["other"]}
    total = sum(split.values())
    log(phase="xlstm_prefill_split", device_ms=xsplit, device_total_ms=total,
        share={k_: v_ / total for k_, v_ in xsplit.items()},
        one_shot_wall_ms=t_one_shot * 1e3,
        idle_share=1.0 - total / (t_one_shot * 1e3),
        slstm_loop_wall_s=loop_wall, slstm_steps=n_s * S,
        slstm_loop_device_ms=loop)
    del slstm_in

    return [kernel_entry("mamba_scan_xlstm", launches=launches, err=err_scan,
                         ms=rec["state"]["ms"],
                         plain_ms=rec["state"]["plain_ms"], library_ms=None,
                         bytes_=scan_bytes, flops=scan_flops,
                         peak=TF32_FLOPS / 3)]


def dense_row_invariance(cfg, B: int = LM_BATCH) -> dict:
    """Does a row of each token-wise product of a dense layer (qwen2's
    widths: wq and wo 1,536 wide, wk and wv 256, wi and wg 8,960, wo of the
    MLP back to 1,536) give the same bits in a call of r rows as in one of
    B x S rows, r in DENSE_ROWS? The answer decides whether the model runs
    them per block of tokens (`models.layers.by_blocks`)."""
    import torch
    gr = torch.Generator(device="cuda").manual_seed(SEED + 9)
    n = max(DENSE_ROWS)
    d, f = cfg.d_model, cfg.d_ff
    hq, hkv = cfg.n_heads * cfg.dh, cfg.n_kv_heads * cfg.dh
    out = {}
    for name, (d_in, d_out) in (("wq", (d, hq)), ("wk", (d, hkv)),
                                ("wv", (d, hkv)), ("wo", (hq, d)),
                                ("wi", (d, f)), ("wg", (d, f)),
                                ("down", (f, d))):
        w = torch.randn((d_in, d_out), generator=gr, device="cuda") \
            / d_in ** 0.5
        x = torch.randn((n, d_in), generator=gr, device="cuda")
        full = x @ w
        out[name] = {"shape": list(w.shape), "rows_equal_to_8192": {
            str(r): bool(torch.equal(full[:r], x[:r].contiguous() @ w))
            for r in DENSE_ROWS[:-1]}}
        # B rows of one block each, as `by_blocks` feeds them: (B, r, d)
        xb = x.reshape(B, n // B, -1)
        r = DENSE_ROWS[0]
        blk = xb[:, :r].contiguous() @ w
        out[name]["batched_block_rows_equal"] = bool(torch.equal(
            (xb @ w)[:, :r], blk))
    del x, full, xb, blk, w
    return out


def flash_offset_checks(cfg, g) -> dict:
    """The flash kernel from a query offset at `cfg`'s extend shapes:
    q (B, DENSE_CHUNK, Hq, dh) from each of DENSE_OFFSETS against k, v
    (B, S, Hkv, dh), float32 within FLASH_TOL of each element's sum of
    |terms| of the plain version and bfloat16 within FLASH_TOL; the rows
    of a call from each of DENSE_ROW_OFFSETS == the same rows of one call
    over all S queries, bit for bit (reported, not held, at offsets off
    the 64-row tiles); timed at the last chunk beside the plain version
    and scaled_dot_product_attention with the boolean mask."""
    import torch
    from repro_torch.kernels.flash_attention import flash_attention as KF
    B, S, C = LM_BATCH, LM_PROMPT, DENSE_CHUNK
    Hq, Hkv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.dh
    q = torch.randn((B, S, Hq, dh), generator=g, device="cuda")
    k = torch.randn((B, S, Hkv, dh), generator=g, device="cuda")
    v = torch.randn((B, S, Hkv, dh), generator=g, device="cuda")
    rel, err, bf16 = {}, 0.0, {}
    for off in DENSE_OFFSETS:
        qc = q[:, off:off + C].contiguous()
        out = KF.flash_attention(qc, k, v, causal=True, q_offset=off)
        plain = KF.flash_attention_plain(qc, k, v, causal=True, q_offset=off)
        terms = KF.flash_attention_plain(qc, k, v.abs(), causal=True,
                                         q_offset=off)
        rel[str(off)] = _rel_terms(out, plain, terms)
        err = max(err, float((out - plain).abs().max()))
        check(rel[str(off)] <= FLASH_TOL["float32"],
              f"flash from q_offset {off} == plain within "
              f"{FLASH_TOL['float32']} of each element's sum |terms|")
        qh, kh, vh = (t.bfloat16() for t in (qc, k, v))
        outh = KF.flash_attention(qh, kh, vh, causal=True, q_offset=off)
        plainh = KF.flash_attention_plain(qh, kh, vh, causal=True,
                                          q_offset=off)
        bf16[str(off)] = float((outh.float() - plainh.float()).abs().max())
        check(bf16[str(off)] <= FLASH_TOL["bfloat16"],
              f"bfloat16 flash from q_offset {off} == plain within "
              f"{FLASH_TOL['bfloat16']}")
    del plain, terms, qh, kh, vh, outh, plainh
    whole = KF.flash_attention(q, k, v, causal=True)
    rows = {}
    for off in DENSE_ROW_OFFSETS + DENSE_ODD_OFFSETS:
        n = min(C, S - off)
        part = KF.flash_attention(q[:, off:off + n].contiguous(), k, v,
                                  causal=True, q_offset=off)
        rows[str(off)] = {
            "equal": bool(torch.equal(part, whole[:, off:off + n])),
            "max_abs": float((part - whole[:, off:off + n]).abs().max())}
    for off in DENSE_ROW_OFFSETS:
        check(rows[str(off)]["equal"],
              f"flash rows from q_offset {off} == one-shot rows bit for bit")
    del whole, part
    off = S - C
    qc = q[:, off:].contiguous()
    qt, kt, vt = (t.transpose(1, 2) for t in (qc, k, v))
    keep = (torch.arange(S, device="cuda")[None, :]
            <= off + torch.arange(C, device="cuda")[:, None])

    def sdpa():
        return torch.nn.functional.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=keep, enable_gqa=Hq != Hkv)
    lib_diff = float((sdpa().transpose(1, 2) - KF.flash_attention(
        qc, k, v, causal=True, q_offset=off)).abs().max())
    ms = timed_ms(lambda: KF.flash_attention(qc, k, v, causal=True,
                                             q_offset=off))
    plain_ms = timed_ms(lambda: KF.flash_attention_plain(
        qc, k, v, causal=True, q_offset=off))
    lib_ms = timed_ms(sdpa)
    by_name = device_ms_by_kernel(lambda: KF.flash_attention(
        qc, k, v, causal=True, q_offset=off), expect=("flash_fwd_kernel",))
    kernel_ms = sum(v_ for n_, v_ in by_name.items()
                    if "flash_fwd_kernel" in n_)
    pairs = C * off + C * (C + 1) // 2        # the keys the mask keeps
    flops = 4 * dh * pairs * B * Hq           # q.k and p.v, 2 flops a MAC
    nbytes = 4 * (qc.numel() + k.numel() + v.numel() + qc.numel())
    rec = {"shape": [B, C, Hq, Hkv, dh, S], "max_rel_to_terms": rel,
           "bfloat16_max_abs": bf16, "rows_vs_one_shot": rows,
           "timed_offset": off, "flops": flops, "bytes": nbytes,
           "sdpa_max_abs_diff": lib_diff, "ms": ms, "plain_ms": plain_ms,
           "library_ms": lib_ms, "kernel_device_ms": kernel_ms,
           "max_abs_err": err, **_rates(flops, kernel_ms)}
    del q, k, v, qc, qt, kt, vt
    return rec


def _seed_biases(params, seed: int) -> None:
    """Draw the qkv biases (zeros at init, as in the reference) from a
    seeded generator, N(0, 0.1^2), so that the bias path carries weight."""
    import torch
    g = torch.Generator(device="cuda").manual_seed(seed)
    with torch.no_grad():
        for layer in params.layers:
            for b in (layer.attn.bq, layer.attn.bk, layer.attn.bv):
                b.copy_(torch.randn(b.shape, generator=g, device="cuda")
                        * 0.1)


def _dense_bars(label, cfg, params, prompts, n_new, ids, n_chunks):
    """Bars (a)-(d) of a dense or moe `Engine.generate` run on `prompts`:
    (a) no prefix rerun, and the incremental prefill's last logits and
    whole KV cache == a one-shot prefill's bits; (b) one flash launch per
    layer, and one ich_moe_sharded launch per MoE layer, in every
    prefill_extend call and in the one-shot prefill; (c) decode at S == a
    fresh prefill of S + 1 within DECODE_TOL; (d) finite logits. Returns
    (record, one-shot prefill seconds, one-shot cache)."""
    import torch
    from repro_torch.kernels.flash_attention import flash_attention as KF
    from repro_torch.kernels.ich_moe import ich_moe as KM
    from repro_torch.models import model as M
    from repro_torch.serve import Engine, EngineConfig
    L = cfg.n_layers
    n_moe = cfg.n_layers - cfg.moe_layer_start if cfg.moe else 0
    toks = torch.from_numpy(prompts).cuda()
    eng = Engine(cfg, params, EngineConfig(max_seq=LM_MAX_SEQ))
    KF.reset_launches()
    KM.reset_launches()
    last, inc_cache, inc_log = eng.prefill_chunked(prompts)
    torch.cuda.synchronize()
    inc_launches = KF.LAUNCHES["flash_attention"]
    inc_moe = KM.LAUNCHES["ich_moe_sharded"]
    KF.reset_launches()
    KM.reset_launches()
    t0 = time.perf_counter()
    one_shot, cache = M.prefill(cfg, params, {"tokens": toks})
    torch.cuda.synchronize()
    t_one_shot = time.perf_counter() - t0
    one_launches = KF.LAUNCHES["flash_attention"]
    one_moe = KM.LAUNCHES["ich_moe_sharded"]
    check(eng.n_prefill_fallbacks == 0 and n_chunks > 0,
          f"({label} a) incremental prefill: no prefix rerun")
    check(one_launches == L and inc_launches == L * len(inc_log)
          and one_moe == n_moe and inc_moe == n_moe * len(inc_log),
          f"({label} b) {L} flash and {n_moe} ich_moe_sharded launches per "
          f"prefill and prefill_extend call")
    check(torch.equal(last, one_shot) and _states_equal(inc_cache, cache),
          f"({label} a) incremental prefill's last logits and KV cache == "
          f"one-shot prefill bit for bit")
    check(bool(torch.isfinite(one_shot).all()),
          f"({label} d) prefill logits finite")
    first = torch.from_numpy(ids[:, :1].astype(np.int64)).cuda()
    d_logits, _ = M.decode_step(cfg, params, first, eng._pad_cache(cache),
                                prompts.shape[1])
    fresh, _ = M.prefill(cfg, params, {"tokens": torch.cat([toks, first],
                                                           dim=1)})
    torch.cuda.synchronize()
    err = float((d_logits - fresh).abs().max())
    check(bool(torch.isfinite(d_logits).all()),
          f"({label} d) decode logits finite")
    check(torch.allclose(d_logits, fresh, rtol=DECODE_TOL, atol=DECODE_TOL),
          f"({label} c) decode at S == prefill of S + 1 within {DECODE_TOL}")
    rec = {"second_run_chunks": [c["chunk"] for c in inc_log],
           "flash_launches_one_shot": one_launches,
           "flash_launches_incremental": inc_launches,
           "moe_launches_one_shot": one_moe,
           "moe_launches_incremental": inc_moe,
           "one_shot_prefill_s": t_one_shot,
           "decode_vs_prefill_max_abs": err,
           "logits_max_abs": float(fresh.abs().max()),
           "decode_argmax_is_second_id": bool(np.array_equal(
               d_logits.argmax(-1).cpu().numpy(), ids[:, 1]))
           if n_new > 1 else None}
    del last, inc_cache, d_logits, fresh, one_shot
    return rec, t_one_shot, cache


def dense_batcher(cfg, params, n_requests=BATCHER_REQUESTS) -> dict:
    """The continuous batcher over a dense or moe model: IChAdaptive on a
    wall clock through `EngineBackend`, `n_requests` Poisson arrivals
    within the first second (prompts uniform in [256, 2048], 16 new
    tokens each); every
    request's tokens must equal the same prompt served alone through
    `Engine.generate` (B = 1), and its last logits the bits of the prompt
    served alone through the per-request surface in one chunk; prefill
    chunks must interleave with decodes."""
    import torch
    from repro_torch.kernels.flash_attention import flash_attention as KF
    from repro_torch.kernels.ich_moe import ich_moe as KM
    from repro_torch.robust import ServeJournal
    from repro_torch.serve import (ContinuousBatcher, Engine, EngineBackend,
                                   EngineConfig, IChAdaptive, LengthDist,
                                   OpenPoissonLoadGen, RequestState,
                                   WallClock, make_request_factory)
    gen = OpenPoissonLoadGen(
        BATCHER_RATE, prompt_lens=LengthDist("uniform", 256, 2048),
        output_lens=LengthDist("fixed", BATCHER_NEW, BATCHER_NEW), seed=SEED)
    arrivals = gen.arrivals(n_requests)
    check(max(a.t for a in arrivals) < 1.0,
          "batcher: every arrival within the first second")
    engine = Engine(cfg, params, EngineConfig(max_seq=LM_MAX_SEQ))
    journal = ServeJournal()
    b = ContinuousBatcher(IChAdaptive(), backend=EngineBackend(engine),
                          clock=WallClock(), journal=journal)
    KF.reset_launches()
    KM.reset_launches()
    t0 = time.perf_counter()
    m = b.run(arrivals, make_request=make_request_factory(
        gen, vocab_size=cfg.vocab_size))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = KF.LAUNCHES["flash_attention"]
    moe_launches = KM.LAUNCHES["ich_moe_sharded"]
    steps = [e for e in journal.events if e["ev"] == "step"]
    mixed = sum(1 for e in steps if e["decode"] and e["prefill"] is not None)
    done = sorted(b.queue.done, key=lambda st: st.request.req_id)
    check(len(done) == n_requests and all(
        len(st.out_tokens) == BATCHER_NEW for st in done),
          "batcher: every request completed")
    check(mixed > 0, "batcher: prefill chunks interleaved with decodes")
    check(m.n_prefill_fallback == 0, "batcher: no prefix rerun")
    alone = Engine(cfg, params, EngineConfig(max_seq=LM_MAX_SEQ))
    for st in done:
        ids, _ = alone.generate(st.request.tokens, n_new=st.request.n_new)
        check(st.out_tokens == ids[0].tolist(),
              f"batcher: request {st.request.req_id}'s tokens == the "
              f"prompt served alone")
        one = RequestState(request=st.request)
        alone.prefill_chunk_step(one, st.prompt_len)
        while len(one.out_tokens) < st.request.n_new:
            alone.decode_one(one)
        check(one.out_tokens == st.out_tokens
              and torch.equal(one.last_logits, st.last_logits),
              f"batcher: request {st.request.req_id}'s last logits == the "
              f"prompt served alone in one chunk, bit for bit")
    summary = m.summary()
    return {"requests": n_requests, "rate_per_s": BATCHER_RATE,
            "prompt_lens": [st.prompt_len for st in done],
            "chunks": [[c["chunk"] for c in st.chunk_log] for st in done],
            "steps": len(steps), "steps_prefill_and_decode": mixed,
            "flash_launches": launches, "moe_launches": moe_launches,
            "wall_s": wall,
            "ttft_s": {"p50": summary["ttft"]["p50"],
                       "p99": summary["ttft"]["p99"]},
            "ms_per_output_token": {
                "p50": summary["per_token"]["p50"] * 1e3,
                "p99": summary["per_token"]["p99"] * 1e3,
                "mean": summary["per_token"]["mean"] * 1e3},
            "n_prefill_fallback": summary["n_prefill_fallback"],
            "goodput_tok_s": summary["goodput_tok_s"],
            "distinct_ids": len({t for st in done for t in st.out_tokens}),
            "tokens_and_logits_equal_served_alone": True}


def phase_dense():
    """qwen2-1.5b at full width (28 layers, d_model 1,536, 12 heads, 2 KV
    heads, dh 128, d_ff 8,960, qkv bias, tied embeddings; random float32
    weights from a seeded generator, the qkv biases drawn too): first the
    row-invariance probe of its products; then the counted main path
    `Engine.generate` on 4 prompts of 2,048 tokens with 32 new tokens, its
    prefill incremental (`prefill_extend` per chunk, one flash launch a
    layer from the chunk's offset); bars (a)-(d) of `_dense_bars` and (e)
    two runs give the same bits; where the prefill's device time goes;
    the flash kernel from an offset at the extend shapes
    (`flash_offset_checks`); the continuous batcher (`dense_batcher`);
    then olmo-1b, glm4-9b and phi3-medium-14b at full width with 2 layers
    each, bars (a)-(d) on 2 prompts of 1,024 tokens."""
    import dataclasses
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.kernels.flash_attention import flash_attention as KF
    from repro_torch.models import model as M
    from repro_torch.serve import Engine, EngineConfig
    torch.backends.cuda.matmul.allow_tf32 = False  # float32 end to end
    cfg = get_arch(DENSE_ARCH)
    B, S, n_new = LM_BATCH, LM_PROMPT, LM_NEW
    log(phase="dense_row_invariance", arch=cfg.name,
        products=dense_row_invariance(cfg))
    t0 = time.perf_counter()
    params = M.init_params(cfg, SEED, device="cuda")
    _seed_biases(params, SEED + 10)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in params.parameters())
    prompts = np.random.default_rng(SEED + 2).integers(
        0, cfg.vocab_size, (B, S)).astype(np.int64)
    log(phase="dense_setup", arch=cfg.name, layers=cfg.n_layers,
        d_model=cfg.d_model, heads=cfg.n_heads, kv_heads=cfg.n_kv_heads,
        dh=cfg.dh, d_ff=cfg.d_ff, vocab=cfg.padded_vocab, params=n_params,
        weight_bytes=n_params * 4, batch=B, prompt=S, new_tokens=n_new,
        token_block=M.TOKEN_BLOCK, init_s=time.perf_counter() - t0)
    # first use of cuBLAS at these widths and of the kernel, uncounted
    M.prefill(cfg, params, {"tokens": torch.from_numpy(
        prompts[:, :64]).cuda()})
    torch.cuda.synchronize()

    # ---- the main path, counted ----
    KF.reset_launches()
    engine = Engine(cfg, params, EngineConfig(max_seq=LM_MAX_SEQ))
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    ids, stats = engine.generate(prompts, n_new=n_new)
    torch.cuda.synchronize()
    t_generate = time.perf_counter() - t0
    launches = KF.LAUNCHES["flash_attention"]
    chunks = stats["chunks"]
    sizes = [c["chunk"] for c in chunks]
    t_prefill = sum(c["dt"] for c in chunks)
    Q = min(M.TOKEN_BLOCK, S)
    log(phase="dense_main_path", chunk_log=chunks,
        n_prefill_fallbacks=engine.n_prefill_fallbacks,
        launches={"flash_attention": launches}, generate_s=t_generate,
        time_to_first_token_s=t_prefill,
        decode_ms_per_token=(t_generate - t_prefill) / n_new * 1e3,
        generated_ids=ids.tolist(), distinct_ids=len(np.unique(ids)),
        peak_gb=torch.cuda.max_memory_allocated() / 1e9)
    check(engine.n_prefill_fallbacks == 0 and sum(sizes) == S,
          "(a) incremental prefill: no prefix rerun")
    check(all(c % Q == 0 for c in sizes[:-1]),
          f"(a) every chunk but the last a multiple of Q = {Q}")
    check(launches == cfg.n_layers * len(chunks),
          f"(b) {cfg.n_layers} flash launches per prefill_extend call")
    check(ids.shape == (B, n_new) and bool(np.all((ids >= 0)
                                                  & (ids < cfg.vocab_size))),
          "generated ids in the vocabulary")

    # ---- bars ----
    rec, t_one_shot, cache = _dense_bars("qwen2", cfg, params, prompts,
                                         n_new, ids, len(chunks))
    ids2, _ = Engine(cfg, params, EngineConfig(max_seq=LM_MAX_SEQ)).generate(
        prompts, n_new=n_new)
    check(np.array_equal(ids, ids2), "(e) two runs give the same ids")
    log(phase="dense_bars", **rec)

    # ---- where the prefill's and a decode step's device time goes ----
    toks = torch.from_numpy(prompts).cuda()
    _split_log("dense_prefill_split", lambda: M.prefill(
        cfg, params, {"tokens": toks}), t_one_shot * 1e3,
               expect=("flash_fwd_kernel",))
    first = torch.from_numpy(ids[:, :1].astype(np.int64)).cuda()
    dec_cache = engine._pad_cache(cache)

    def one_decode():
        M.decode_step(cfg, params, first, dec_cache, S)
    _split_log("dense_decode_split", one_decode, _wall_ms(one_decode))
    del cache, dec_cache, toks

    # ---- the flash kernel from an offset at the extend shapes ----
    g = torch.Generator(device="cuda")
    g.manual_seed(SEED + 11)
    flash = flash_offset_checks(cfg, g)
    log(phase="dense_flash_offset", **flash)

    # ---- the continuous batcher ----
    log(phase="dense_batcher", **dense_batcher(cfg, params))
    del params, engine
    torch.cuda.empty_cache()

    # ---- the other dense configurations, 2 layers at full width ----
    for name in DENSE_OTHERS:
        ocfg = dataclasses.replace(get_arch(name),
                                   n_layers=DENSE_OTHER_LAYERS)
        oparams = M.init_params(ocfg, SEED, device="cuda")
        oprompts = np.random.default_rng(SEED + 3).integers(
            0, ocfg.vocab_size, (DENSE_OTHER_BATCH, DENSE_OTHER_PROMPT)
        ).astype(np.int64)
        eng = Engine(ocfg, oparams, EngineConfig(max_seq=LM_MAX_SEQ))
        KF.reset_launches()
        t0 = time.perf_counter()
        oids, ostats = eng.generate(oprompts, n_new=8)
        torch.cuda.synchronize()
        t_gen = time.perf_counter() - t0
        olaunches = KF.LAUNCHES["flash_attention"]
        check(olaunches == ocfg.n_layers * len(ostats["chunks"]),
              f"({name} b) {ocfg.n_layers} flash launches per "
              f"prefill_extend call")
        orec, _, ocache = _dense_bars(name, ocfg, oparams, oprompts, 8, oids,
                                      len(ostats["chunks"]))
        log(phase="dense_other", arch=name, layers=ocfg.n_layers,
            d_model=ocfg.d_model, heads=ocfg.n_heads,
            kv_heads=ocfg.n_kv_heads, gqa_ratio=ocfg.n_heads
            // ocfg.n_kv_heads, dh=ocfg.dh, norm=ocfg.norm,
            tied=ocfg.tie_embeddings, batch=DENSE_OTHER_BATCH,
            prompt=DENSE_OTHER_PROMPT,
            chunks=[c["chunk"] for c in ostats["chunks"]],
            flash_launches=olaunches, generate_s=t_gen, **orec)
        del oparams, ocache, eng
        torch.cuda.empty_cache()

    # float32 inputs: both products run as three TF32 products on the
    # tensor cores
    return [kernel_entry("flash_attention_offset", launches=launches,
                         err=flash["max_abs_err"], ms=flash["ms"],
                         plain_ms=flash["plain_ms"],
                         library_ms=flash["library_ms"],
                         bytes_=flash["bytes"], flops=flash["flops"],
                         peak=TF32_FLOPS / 3)]


def moe_row_invariance(cfg, p, g) -> dict:
    """Does the expert kernel's y row of a token depend on the other
    tokens of its plan? 8,192 tokens (the one-shot prefill's pool) routed
    by `p`'s router and dispatched dropless through `moe_local`, against
    the first 256 (one token block) and the first 4 (a decode step's pool)
    with the same routing dispatched alone: their y rows must be equal bit
    for bit, or the engine's chunk quantum cannot keep chunked prefill
    equal to one-shot."""
    import torch
    from repro_torch.models import moe as MOE
    B, S = LM_BATCH, LM_PROMPT
    x = torch.randn((B, S, cfg.d_model), generator=g, device="cuda")
    routing = MOE.route(p, x, cfg.experts_per_token)
    flat = x.reshape(B * S, -1)
    y_all, aux = MOE.moe_local(cfg, p, flat, dropless=True, routing=routing)
    out = {"tokens": B * S, "load_min": int(aux["counts"].min()),
           "load_max": int(aux["counts"].max())}
    for n in MOE_ROW_POOLS:
        y_n, aux_n = MOE.moe_local(cfg, p, flat[:n], dropless=True,
                                   routing=tuple(r[:n] for r in routing))
        out[str(n)] = {
            "equal": bool(torch.equal(y_n, y_all[:n])),
            "max_abs": float((y_n - y_all[:n]).abs().max()),
            "experts_with_one_token": int((aux_n["counts"] == 1).sum())}
    del x, routing, flat, y_all
    return out


def moe_serving_kernel(cfg, p, g, sm_count) -> dict:
    """Row 7b: the expert kernel at the shape of one olmoe prefill_extend
    call's MoE layer, a chunk of 4 x 512 tokens (16,384 slots at top-8):
    N(0, 1) rows (a normed hidden state's scale) routed by `p`'s router,
    planned dropless and lowered at p = SM count, as `moe_local` does;
    the kernel against its plain version (MOE_TOL, cost streams equal),
    timed beside them and the dropless capacity-buffer bmm at C = the
    largest expert load; the host's plan and lowering timed per pool."""
    import torch
    from repro_torch.kernels.ich_moe import ich_moe as KM
    from repro_torch.models import moe as MOE
    from repro_torch.sched import LoopScheduler, plan_dispatch
    T, D, F, E = LM_BATCH * MOE_CHUNK, cfg.d_model, cfg.moe_d_ff, \
        cfg.n_experts
    x = torch.randn((LM_BATCH, MOE_CHUNK, D), generator=g, device="cuda")
    _, w_topk, e_topk = MOE.route(p, x, cfg.experts_per_token)
    x = x.reshape(T, D)
    plan = plan_dispatch(e_topk.cpu().numpy(), w_topk.cpu().numpy(),
                         cap=np.full(E, T, np.int32), steal=False)
    op = LoopScheduler(p=sm_count, cache_size=0).build("moe-dispatch", plan)
    args = (op.vals, op.cols, op.rowid, op.blkid, x, p.wi, p.wg, p.wo, op.p,
            op.superstep, op.slots)
    y_k, c_k, e_k = KM.ich_moe_sharded(*args, slot_cost=op.slot_cost)
    y_p, c_p, e_p = KM.ich_moe_sharded_plain(*args, slot_cost=op.slot_cost)
    check(torch.allclose(y_k, y_p, rtol=MOE_TOL, atol=MOE_TOL),
          "serving-shape MoE kernel == plain")
    check(torch.equal(c_k, c_p) and torch.equal(e_k, e_p),
          "serving-shape MoE cost streams == plain")
    err = float((y_k - y_p).abs().max())
    library, C = capacity_buffer_moe(x, p.wi, p.wg, p.wo, plan,
                                     C=int(plan.counts.max()))
    y_lib = library()
    lib_err = float((y_lib - y_k).abs().max())
    check(torch.allclose(y_lib, y_k, rtol=MOE_TOL, atol=MOE_TOL),
          "dropless capacity-buffer bmm y agrees")
    del y_k, c_k, e_k, y_p, c_p, e_p, y_lib
    ms = timed_ms(lambda: KM.ich_moe_sharded(*args, slot_cost=op.slot_cost))
    plain_ms = timed_ms(lambda: KM.ich_moe_sharded_plain(
        *args, slot_cost=op.slot_cost))
    library_ms = timed_ms(library)
    by_name = device_ms_by_kernel(lambda: KM.ich_moe_sharded(
        *args, slot_cost=op.slot_cost), expect=("moe_product",))
    kept = int(plan.counts.sum())
    inputs = [op.vals, op.cols, op.rowid, op.blkid, op.slot_cost, x, p.wi,
              p.wg, p.wo, *op.slots]
    bytes_ = sum(t.numel() * t.element_size() for t in inputs) \
        + (T * D + op.p * (op.shards.n_steps + E)) * 4
    flops = 6 * D * F * kept
    # the host's part of every MoE layer call: the router's choices to the
    # host, plan_dispatch, then schedule, shard, pack and upload
    host = {}
    for n in (LM_BATCH, T, LM_BATCH * LM_PROMPT):
        xn = torch.randn((1, n, D), generator=g, device="cuda")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, wn, en = MOE.route(p, xn, cfg.experts_per_token)
        en, wn = en.cpu().numpy(), wn.cpu().numpy()
        t1 = time.perf_counter()
        pn = plan_dispatch(en, wn, cap=np.full(E, n, np.int32), steal=False)
        t2 = time.perf_counter()
        LoopScheduler(p=sm_count, cache_size=0).build("moe-dispatch", pn)
        torch.cuda.synchronize()
        host[str(n)] = {"route_and_copy_ms": (t1 - t0) * 1e3,
                        "plan_ms": (t2 - t1) * 1e3,
                        "lower_pack_upload_ms": (time.perf_counter() - t2)
                        * 1e3}
    rec = {"tokens": T, "slots": kept, "experts": E, "d_model": D,
           "expert_ff": F, "p": op.p, "tiles": op.n_tiles,
           "width": op.schedule.width, "load_min": int(plan.counts.min()),
           "load_max": int(plan.counts.max()), "library_capacity": C,
           "library_max_abs_diff": lib_err, "ms": ms, "plain_ms": plain_ms,
           "library_ms": library_ms, "device_ms": by_name,
           "device_total_ms": sum(by_name.values()), "max_abs_err": err,
           "bytes": bytes_, "flops": flops, "host_ms_by_pool": host,
           **_rates(flops, sum(by_name.values()))}
    del x, op, args, inputs, library
    return rec


def phase_moe_lm():
    """olmoe-1b-7b at full width and depth (16 layers, d_model 2,048, 16
    heads and 16 KV heads of 128, 64 experts top-8 of width 1,024; random
    float32 weights from a seeded generator, 6.9 B parameters): first
    `moe_row_invariance`; then the counted main path `Engine.generate` on
    4 prompts of 2,048 tokens with 32 new tokens, its prefill incremental
    (`prefill_extend` per chunk: one flash launch and one ich_moe_sharded
    launch a layer; a decode step one ich_moe_sharded launch a layer);
    bars (a)-(d) of `_dense_bars` and (e) two runs give the same ids;
    where the prefill's and a decode step's device time goes (products,
    flash, ich_moe, other, idle); rows 7b (`moe_serving_kernel`) and 8c
    (`flash_offset_checks` at 16/16 heads); the continuous batcher over 4
    requests (`dense_batcher`); then deepseek-moe-16b at full width cut
    to 3 layers (layer 0 dense with d_ff 11,264, layers 1-2 with 2 shared
    and 64 routed experts, top-6), bars (a)-(d) on 2 prompts of 1,024
    tokens with 8 new."""
    import dataclasses
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.kernels.flash_attention import flash_attention as KF
    from repro_torch.kernels.ich_moe import ich_moe as KM
    from repro_torch.models import model as M
    from repro_torch.serve import Engine, EngineConfig
    torch.backends.cuda.matmul.allow_tf32 = False  # float32 end to end
    sm_count = torch.cuda.get_device_properties(0).multi_processor_count
    cfg = get_arch(MOE_ARCH)
    B, S, n_new = LM_BATCH, LM_PROMPT, LM_NEW
    n_moe = cfg.n_layers - cfg.moe_layer_start
    t0 = time.perf_counter()
    params = M.init_params(cfg, SEED, device="cuda")
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in params.parameters())
    prompts = np.random.default_rng(SEED + 5).integers(
        0, cfg.vocab_size, (B, S)).astype(np.int64)
    log(phase="moe_lm_setup", arch=cfg.name, layers=cfg.n_layers,
        d_model=cfg.d_model, heads=cfg.n_heads, kv_heads=cfg.n_kv_heads,
        dh=cfg.dh, experts=cfg.n_experts, top_k=cfg.experts_per_token,
        expert_ff=cfg.moe_d_ff, vocab=cfg.padded_vocab, params=n_params,
        weight_bytes=n_params * 4, batch=B, prompt=S, new_tokens=n_new,
        token_block=M.TOKEN_BLOCK, p=sm_count,
        init_s=time.perf_counter() - t0)
    g = torch.Generator(device="cuda")
    g.manual_seed(SEED + 12)
    log(phase="moe_row_invariance", arch=cfg.name,
        pools=moe_row_invariance(cfg, params.layers[0].moe, g))
    # first use of cuBLAS at these widths and of both kernels, uncounted
    M.prefill(cfg, params, {"tokens": torch.from_numpy(
        prompts[:, :64]).cuda()})
    torch.cuda.synchronize()

    # ---- the main path, counted ----
    KF.reset_launches()
    KM.reset_launches()
    engine = Engine(cfg, params, EngineConfig(max_seq=LM_MAX_SEQ))
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    ids, stats = engine.generate(prompts, n_new=n_new)
    torch.cuda.synchronize()
    t_generate = time.perf_counter() - t0
    launches = {"flash_attention": KF.LAUNCHES["flash_attention"],
                "ich_moe_sharded": KM.LAUNCHES["ich_moe_sharded"]}
    chunks = stats["chunks"]
    sizes = [c["chunk"] for c in chunks]
    t_prefill = sum(c["dt"] for c in chunks)
    Q = min(M.TOKEN_BLOCK, S)
    log(phase="moe_lm_main_path", chunk_log=chunks,
        n_prefill_fallbacks=engine.n_prefill_fallbacks, launches=launches,
        generate_s=t_generate, time_to_first_token_s=t_prefill,
        decode_ms_per_token=(t_generate - t_prefill) / n_new * 1e3,
        generated_ids=ids.tolist(), distinct_ids=len(np.unique(ids)),
        peak_gb=torch.cuda.max_memory_allocated() / 1e9)
    check(engine.n_prefill_fallbacks == 0 and sum(sizes) == S,
          "(olmoe a) incremental prefill: no prefix rerun")
    check(all(c % Q == 0 for c in sizes[:-1]),
          f"(olmoe a) every chunk but the last a multiple of Q = {Q}")
    check(launches["flash_attention"] == cfg.n_layers * len(chunks)
          and launches["ich_moe_sharded"] == n_moe * (len(chunks) + n_new),
          f"(olmoe b) {cfg.n_layers} flash and {n_moe} ich_moe_sharded "
          f"launches per prefill_extend call, {n_moe} ich_moe_sharded a "
          f"decode step")
    check(ids.shape == (B, n_new) and bool(np.all((ids >= 0)
                                                  & (ids < cfg.vocab_size))),
          "olmoe generated ids in the vocabulary")

    # ---- bars ----
    rec, t_one_shot, cache = _dense_bars("olmoe", cfg, params, prompts,
                                         n_new, ids, len(chunks))
    ids2, _ = Engine(cfg, params, EngineConfig(max_seq=LM_MAX_SEQ)).generate(
        prompts, n_new=n_new)
    check(np.array_equal(ids, ids2), "(olmoe e) two runs give the same ids")
    log(phase="moe_lm_bars", **rec)

    # ---- where the prefill's and a decode step's device time goes ----
    toks = torch.from_numpy(prompts).cuda()
    _split_log("moe_lm_prefill_split", lambda: M.prefill(
        cfg, params, {"tokens": toks}), t_one_shot * 1e3,
               expect=("flash_fwd_kernel", "moe_product"))
    first = torch.from_numpy(ids[:, :1].astype(np.int64)).cuda()
    dec_cache = engine._pad_cache(cache)

    def one_decode():
        M.decode_step(cfg, params, first, dec_cache, S)
    _split_log("moe_lm_decode_split", one_decode, _wall_ms(one_decode),
               expect=("moe_product",))
    del cache, dec_cache, toks

    # ---- rows 7b and 8c at the serving shapes ----
    moe_k = moe_serving_kernel(cfg, params.layers[0].moe, g, sm_count)
    log(phase="moe_lm_expert_kernel", **moe_k)
    flash = flash_offset_checks(cfg, g)
    log(phase="moe_lm_flash_offset", **flash)

    # ---- the continuous batcher ----
    log(phase="moe_lm_batcher", **dense_batcher(
        cfg, params, n_requests=MOE_BATCHER_REQUESTS))
    del params, engine
    torch.cuda.empty_cache()

    # ---- deepseek-moe-16b, 3 layers at full width ----
    dcfg = dataclasses.replace(get_arch(DEEPSEEK_ARCH),
                               n_layers=DEEPSEEK_LAYERS)
    dparams = M.init_params(dcfg, SEED, device="cuda")
    dprompts = np.random.default_rng(SEED + 6).integers(
        0, dcfg.vocab_size, (DENSE_OTHER_BATCH, DENSE_OTHER_PROMPT)
    ).astype(np.int64)
    eng = Engine(dcfg, dparams, EngineConfig(max_seq=LM_MAX_SEQ))
    KF.reset_launches()
    KM.reset_launches()
    t0 = time.perf_counter()
    dids, dstats = eng.generate(dprompts, n_new=8)
    torch.cuda.synchronize()
    t_gen = time.perf_counter() - t0
    d_moe = dcfg.n_layers - dcfg.moe_layer_start
    dl = {"flash_attention": KF.LAUNCHES["flash_attention"],
          "ich_moe_sharded": KM.LAUNCHES["ich_moe_sharded"]}
    check(dl["flash_attention"] == dcfg.n_layers * len(dstats["chunks"])
          and dl["ich_moe_sharded"] == d_moe * (len(dstats["chunks"]) + 8),
          f"(deepseek b) {dcfg.n_layers} flash and {d_moe} ich_moe_sharded "
          f"launches per prefill_extend call")
    drec, _, dcache = _dense_bars("deepseek", dcfg, dparams, dprompts, 8,
                                  dids, len(dstats["chunks"]))
    log(phase="moe_lm_deepseek", arch=dcfg.name, layers=dcfg.n_layers,
        segments=M.segments_of(dcfg), dense_d_ff=dcfg.dense_d_ff,
        shared_experts=dcfg.n_shared_experts, experts=dcfg.n_experts,
        top_k=dcfg.experts_per_token, expert_ff=dcfg.moe_d_ff,
        params=sum(p.numel() for p in dparams.parameters()),
        batch=DENSE_OTHER_BATCH, prompt=DENSE_OTHER_PROMPT,
        chunks=[c["chunk"] for c in dstats["chunks"]], launches=dl,
        generate_s=t_gen, **drec)
    del dparams, dcache, eng
    torch.cuda.empty_cache()

    # float32 inputs: each product runs as three TF32 products on the
    # tensor cores
    return [kernel_entry("ich_moe_sharded_serving",
                         launches=launches["ich_moe_sharded"],
                         err=moe_k["max_abs_err"], ms=moe_k["ms"],
                         plain_ms=moe_k["plain_ms"],
                         library_ms=moe_k["library_ms"],
                         bytes_=moe_k["bytes"], flops=moe_k["flops"],
                         peak=TF32_FLOPS / 3),
            kernel_entry("flash_attention_moe", launches=launches[
                "flash_attention"], err=flash["max_abs_err"], ms=flash["ms"],
                         plain_ms=flash["plain_ms"],
                         library_ms=flash["library_ms"],
                         bytes_=flash["bytes"], flops=flash["flops"],
                         peak=TF32_FLOPS / 3)]


def flash_shape_record(q, k, v, *, causal: bool) -> dict:
    """The flash kernel at one of a main path's shapes from position 0 (q
    (B, Sq, Hq, dh), k, v (B, Skv, Hkv, dh)): against its plain version
    within FLASH_TOL (logged also against each element's sum of |terms|),
    two calls the same bits; timed beside the plain version and
    scaled_dot_product_attention (`is_causal`, or no mask), with its
    operations (the (query, key) pairs the mask keeps), its bytes (each
    input read once, the output written once) and the rates its
    CUDA-event time gives (a torch.profiler trace of one launch of this
    kernel has come back empty at dh 96 and 128)."""
    import torch
    from repro_torch.kernels.flash_attention import flash_attention as KF
    B, Sq, Hq, dh = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    label = f"flash q {tuple(q.shape)} k {tuple(k.shape)} causal={causal}"
    out = KF.flash_attention(q, k, v, causal=causal)
    plain = KF.flash_attention_plain(q, k, v, causal=causal)
    terms = KF.flash_attention_plain(q, k, v.abs(), causal=causal)
    torch.cuda.synchronize()
    err = float((out - plain).abs().max())
    rel = _rel_terms(out, plain, terms)
    check(torch.allclose(out, plain, rtol=FLASH_TOL["float32"],
                         atol=FLASH_TOL["float32"]),
          f"{label} == plain within {FLASH_TOL['float32']}")
    check(torch.equal(out, KF.flash_attention(q, k, v, causal=causal)),
          f"{label}: two calls give the same bits")
    del plain, terms
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))

    def sdpa():
        return torch.nn.functional.scaled_dot_product_attention(
            qt, kt, vt, is_causal=causal, enable_gqa=Hq != Hkv)
    lib_diff = float((sdpa().transpose(1, 2) - out).abs().max())
    ms = timed_ms(lambda: KF.flash_attention(q, k, v, causal=causal))
    plain_ms = timed_ms(lambda: KF.flash_attention_plain(q, k, v,
                                                         causal=causal))
    lib_ms = timed_ms(sdpa)
    # causal from position 0 with Sq <= Skv: query i keeps keys 0..i
    pairs = Sq * (Sq + 1) // 2 if causal else Sq * Skv
    flops = 4 * dh * pairs * B * Hq           # q.k and p.v, 2 flops a MAC
    nbytes = 4 * (2 * q.numel() + k.numel() + v.numel())
    del out, qt, kt, vt
    return {"shape": {"q": list(q.shape), "kv": list(k.shape)},
            "causal": causal, "max_abs_err": err, "max_rel_to_terms": rel,
            "sdpa_max_abs_diff": lib_diff, "ms": ms, "plain_ms": plain_ms,
            "library_ms": lib_ms, "flops": flops, "bytes": nbytes,
            **_rates(flops, ms)}


def flash_calls_by_shape(module=None, name: str = "flash_attention"):
    """Replace `module.<name>` (default `models.attention.flash_attention`;
    `flash_attention_bwd.flash_attention_backward` for the backward, which
    the gradient Function looks up at each call) by a shim that tallies
    each call by (q shape, k shape, causal) in the returned dict and calls
    the wrapper; `restore()` puts the wrapper back. The wrapper's own
    launch counter is untouched: the tally only attributes its launches to
    the encoder's, the decoder's self- and its cross-attention calls."""
    if module is None:
        from repro_torch.models import attention as module
    inner, calls = getattr(module, name), {}

    def tally(q, k, *args, **kw):
        key = (tuple(q.shape), tuple(k.shape), bool(kw.get("causal", True)))
        calls[key] = calls.get(key, 0) + 1
        return inner(q, k, *args, **kw)

    def restore():
        setattr(module, name, inner)
    setattr(module, name, tally)
    return calls, restore


def phase_whisper():
    """whisper-small uncut (12 encoder and 12 decoder layers, d_model 768,
    12 heads and 12 KV heads of 64, vocab 51,865, tied, layernorm, GELU,
    learned positions in one table of WHISPER_MAX_SEQ rows; random
    float32 weights from a seeded generator), served as users call it:
    `prefill` with frames, then greedy `decode_step`s on the cache the
    engine's `_pad_cache` grows (the engine itself takes no frames). The
    counted main path: 4 segments of 1,500 random frame rows (30 s of
    audio each in whisper's frontend) and 192-token decoder prompts, one
    prefill (36 flash launches: 12 encoder blocks non-causal, 12 causal
    self-attentions, 12 non-causal cross-attentions of 192 queries
    against 1,500 keys), 32 decode steps (plain attention). Bars: the
    launches, by call kind; decode at S == a fresh prefill of S + 1 within
    DECODE_TOL; finite logits; two runs the same ids; the flash kernel at
    the encoder's and the cross-attention's shapes == its plain version
    within FLASH_TOL. Logs the prefill's wall and device time by group,
    and decode's ms a token and idle share."""
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.kernels.flash_attention import flash_attention as KF
    from repro_torch.models import model as M
    from repro_torch.serve import Engine, EngineConfig
    torch.backends.cuda.matmul.allow_tf32 = False  # float32 end to end
    cfg = get_arch(WHISPER_ARCH)
    B, S, n_new, Se = LM_BATCH, WHISPER_PROMPT, WHISPER_NEW, cfg.encoder_seq
    t0 = time.perf_counter()
    params = M.init_params(cfg, SEED, max_seq=WHISPER_MAX_SEQ,
                           device="cuda")
    g = torch.Generator(device="cuda")
    g.manual_seed(SEED + 13)
    frames = torch.randn((B, Se, cfg.d_model), generator=g, device="cuda")
    prompts = np.random.default_rng(SEED + 7).integers(
        0, cfg.vocab_size, (B, S)).astype(np.int64)
    toks = torch.from_numpy(prompts).cuda()
    batch = {"tokens": toks, "frames": frames}
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in params.parameters())
    log(phase="whisper_setup", arch=cfg.name, encoder_layers=
        cfg.encoder_layers, decoder_layers=cfg.n_layers, d_model=cfg.d_model,
        heads=cfg.n_heads, kv_heads=cfg.n_kv_heads, dh=cfg.dh, d_ff=cfg.d_ff,
        vocab=cfg.padded_vocab, max_seq=WHISPER_MAX_SEQ, params=n_params,
        weight_bytes=n_params * 4, batch=B, frames=Se, prompt=S,
        new_tokens=n_new, init_s=time.perf_counter() - t0)
    check(S + n_new <= WHISPER_TEXT_CONTEXT <= WHISPER_MAX_SEQ,
          "the prompt and new tokens fit whisper's text context")
    # first use of cuBLAS at these widths and of the kernel, uncounted
    M.prefill(cfg, params, {"tokens": toks[:, :8], "frames": frames})
    torch.cuda.synchronize()
    eng = Engine(cfg, params, EngineConfig(max_seq=WHISPER_MAX_SEQ))

    def serve():
        """prefill, then n_new greedy decode steps: (ids (B, n_new + 1),
        prefill s, decode s, the first decode step's logits)."""
        t0 = time.perf_counter()
        logits, cache = M.prefill(cfg, params, batch)
        torch.cuda.synchronize()
        t_pre = time.perf_counter() - t0
        check(bool(torch.isfinite(logits).all()),
              "(whisper d) prefill logits finite")
        cache = eng._pad_cache(cache)
        tok = torch.argmax(logits, -1)[:, None]
        ids, first = [tok], None
        t0 = time.perf_counter()
        for i in range(n_new):
            logits, cache = M.decode_step(cfg, params, tok, cache, S + i)
            first = logits if first is None else first
            tok = torch.argmax(logits, -1)[:, None]
            ids.append(tok)
        torch.cuda.synchronize()
        t_dec = time.perf_counter() - t0
        check(bool(torch.isfinite(logits).all()),
              "(whisper d) decode logits finite")
        return (torch.cat(ids, 1).cpu().numpy(), t_pre, t_dec, first)

    # ---- the main path, counted ----
    calls, restore = flash_calls_by_shape()
    KF.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    try:
        ids, t_pre, t_dec, first_logits = serve()
    finally:
        restore()
    launches = KF.LAUNCHES["flash_attention"]
    H, dh = cfg.n_heads, cfg.dh
    kinds = {"encoder": ((B, Se, H, dh), (B, Se, H, dh), False),
             "self": ((B, S, H, dh), (B, S, H, dh), True),
             "cross": ((B, S, H, dh), (B, Se, H, dh), False)}
    by_kind = {name: calls.get(key, 0) for name, key in kinds.items()}
    log(phase="whisper_main_path", launches={"flash_attention": launches},
        flash_calls_by_kind=by_kind, prefill_s=t_pre,
        decode_ms_per_token=t_dec / n_new * 1e3, generated_ids=ids.tolist(),
        distinct_ids=len(np.unique(ids)),
        peak_gb=torch.cuda.max_memory_allocated() / 1e9)
    check(launches == cfg.encoder_layers + 2 * cfg.n_layers == 36
          and by_kind == {"encoder": cfg.encoder_layers,
                          "self": cfg.n_layers, "cross": cfg.n_layers}
          and sum(calls.values()) == launches,
          "(whisper b) 36 flash launches a prefill: 12 encoder, 12 self, "
          "12 cross; none in decode")
    check(ids.shape == (B, n_new + 1) and bool(np.all(
        (ids >= 0) & (ids < cfg.vocab_size))),
          "whisper generated ids in the vocabulary")

    # ---- bars ----
    first = torch.from_numpy(ids[:, :1]).cuda()
    fresh, _ = M.prefill(cfg, params, {"tokens": torch.cat([toks, first], 1),
                                       "frames": frames})
    err = float((first_logits - fresh).abs().max())
    check(torch.allclose(first_logits, fresh, rtol=DECODE_TOL,
                         atol=DECODE_TOL),
          f"(whisper c) decode at S == prefill of S + 1 within {DECODE_TOL}")
    ids2, _, _, _ = serve()
    check(np.array_equal(ids, ids2), "(whisper e) two runs give the same ids")
    log(phase="whisper_bars", decode_vs_prefill_max_abs=err,
        logits_max_abs=float(fresh.abs().max()), same_ids_twice=True)
    del fresh

    # ---- where the prefill's and a decode step's device time goes ----
    pre_wall = _wall_ms(lambda: M.prefill(cfg, params, batch), reps=3)
    _split_log("whisper_prefill_split", lambda: M.prefill(cfg, params, batch),
               pre_wall, expect=("flash_fwd_kernel",))
    _, cache = M.prefill(cfg, params, batch)
    dec_cache = eng._pad_cache(cache)

    def one_decode():
        M.decode_step(cfg, params, first, dec_cache, S)
    _split_log("whisper_decode_split", one_decode, _wall_ms(one_decode))
    del cache, dec_cache

    # ---- rows 8d and 8e: the kernel at the encoder's and cross shapes ----
    q = torch.randn((B, Se, H, dh), generator=g, device="cuda")
    k = torch.randn((B, Se, H, dh), generator=g, device="cuda")
    v = torch.randn((B, Se, H, dh), generator=g, device="cuda")
    enc = flash_shape_record(q, k, v, causal=False)
    log(phase="whisper_flash_encoder", **enc)
    cross = flash_shape_record(q[:, :S].contiguous(), k, v, causal=False)
    log(phase="whisper_flash_cross", **cross)
    del q, k, v, params, eng, frames
    torch.cuda.empty_cache()
    # float32 inputs: both products run as three TF32 products on the
    # tensor cores
    return [kernel_entry(name, launches=by_kind[kind], err=rec["max_abs_err"],
                         ms=rec["ms"], plain_ms=rec["plain_ms"],
                         library_ms=rec["library_ms"], bytes_=rec["bytes"],
                         flops=rec["flops"], peak=TF32_FLOPS / 3)
            for name, kind, rec in (
                ("flash_attention_whisper_encoder", "encoder", enc),
                ("flash_attention_whisper_cross", "cross", cross))]


def phase_vlm():
    """phi-3-vision-4.2b uncut (the phi3-mini backbone: 32 layers, d_model
    3,072, 32 heads and 32 KV heads of 96, SwiGLU of 8,192, untied; about
    3.8 B float32 parameters, 15.3 GB, random from a seeded generator).
    (a) The counted main path `Engine.generate` text-only (the reference's
    engine serves it so) on 4 prompts of 2,048 tokens with 32 new tokens,
    incremental (one flash launch a layer per `prefill_extend` call),
    held to `_dense_bars` (a)-(d). (b) The counted image path: `prefill`
    of 4 x (576 patch rows from the seed + 1,472 tokens), one shot (one
    flash launch a layer at 2,048 queries), then 32 greedy decode steps
    from position 2,048; bars: decode at S + P == a prefill of S + 1
    tokens with the same patches within DECODE_TOL, finite logits; where
    its device time goes. (c) Row 8f: the kernel at (4, 2,048, 32, 96)
    causal against its plain version and SDPA; row 8g: from an offset at
    the extend shape (`flash_offset_checks`: GQA 1 at dh 96, row 8c's
    question)."""
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.kernels.flash_attention import flash_attention as KF
    from repro_torch.models import model as M
    from repro_torch.serve import Engine, EngineConfig
    torch.backends.cuda.matmul.allow_tf32 = False  # float32 end to end
    cfg = get_arch(VLM_ARCH)
    B, S, n_new, P = LM_BATCH, LM_PROMPT, LM_NEW, cfg.num_patches
    t0 = time.perf_counter()
    params = M.init_params(cfg, SEED, device="cuda")
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in params.parameters())
    prompts = np.random.default_rng(SEED + 8).integers(
        0, cfg.vocab_size, (B, S)).astype(np.int64)
    log(phase="vlm_setup", arch=cfg.name, layers=cfg.n_layers,
        d_model=cfg.d_model, heads=cfg.n_heads, kv_heads=cfg.n_kv_heads,
        dh=cfg.dh, d_ff=cfg.d_ff, vocab=cfg.padded_vocab, patches=P,
        params=n_params, weight_bytes=n_params * 4, batch=B, prompt=S,
        new_tokens=n_new, token_block=M.TOKEN_BLOCK,
        init_s=time.perf_counter() - t0)
    # first use of cuBLAS at these widths and of the kernel, uncounted
    M.prefill(cfg, params, {"tokens": torch.from_numpy(
        prompts[:, :64]).cuda()})
    torch.cuda.synchronize()

    # ---- (a) text only through the engine, counted ----
    KF.reset_launches()
    engine = Engine(cfg, params, EngineConfig(max_seq=LM_MAX_SEQ))
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    ids, stats = engine.generate(prompts, n_new=n_new)
    torch.cuda.synchronize()
    t_generate = time.perf_counter() - t0
    text_launches = KF.LAUNCHES["flash_attention"]
    chunks = stats["chunks"]
    sizes = [c["chunk"] for c in chunks]
    t_prefill = sum(c["dt"] for c in chunks)
    Q = min(M.TOKEN_BLOCK, S)
    log(phase="vlm_main_path", chunk_log=chunks,
        n_prefill_fallbacks=engine.n_prefill_fallbacks,
        launches={"flash_attention": text_launches}, generate_s=t_generate,
        time_to_first_token_s=t_prefill,
        decode_ms_per_token=(t_generate - t_prefill) / n_new * 1e3,
        generated_ids=ids.tolist(), distinct_ids=len(np.unique(ids)),
        peak_gb=torch.cuda.max_memory_allocated() / 1e9)
    check(engine.n_prefill_fallbacks == 0 and sum(sizes) == S,
          "(vlm a) incremental prefill: no prefix rerun")
    check(all(c % Q == 0 for c in sizes[:-1]),
          f"(vlm a) every chunk but the last a multiple of Q = {Q}")
    check(text_launches == cfg.n_layers * len(chunks),
          f"(vlm b) {cfg.n_layers} flash launches per prefill_extend call")
    check(ids.shape == (B, n_new) and bool(np.all((ids >= 0)
                                                  & (ids < cfg.vocab_size))),
          "vlm generated ids in the vocabulary")
    rec, _, cache = _dense_bars("vlm", cfg, params, prompts, n_new, ids,
                                len(chunks))
    log(phase="vlm_bars", **rec)
    del cache, engine
    torch.cuda.empty_cache()

    # ---- (b) an image prefill and decode from S + P, counted ----
    g = torch.Generator(device="cuda")
    g.manual_seed(SEED + 14)
    patches = torch.randn((B, P, cfg.d_model), generator=g, device="cuda")
    itoks = torch.from_numpy(prompts[:, :S - P]).cuda()
    image = {"tokens": itoks, "patches": patches}
    eng = Engine(cfg, params, EngineConfig(max_seq=LM_MAX_SEQ))
    KF.reset_launches()
    t0 = time.perf_counter()
    logits, cache = M.prefill(cfg, params, image)
    torch.cuda.synchronize()
    t_pre = time.perf_counter() - t0
    check(bool(torch.isfinite(logits).all()), "(vlm image) prefill finite")
    check(cache[0]["k"].shape[2] == S, "(vlm image) a cache of P + S "
          "positions")
    cache = eng._pad_cache(cache)
    tok = torch.argmax(logits, -1)[:, None]
    iids, first_logits = [tok], None
    t0 = time.perf_counter()
    for i in range(n_new):
        logits, cache = M.decode_step(cfg, params, tok, cache, S + i)
        first_logits = logits if first_logits is None else first_logits
        tok = torch.argmax(logits, -1)[:, None]
        iids.append(tok)
    torch.cuda.synchronize()
    t_dec = time.perf_counter() - t0
    image_launches = KF.LAUNCHES["flash_attention"]
    check(image_launches == cfg.n_layers,
          f"(vlm image) {cfg.n_layers} flash launches in the prefill, none "
          f"in decode")
    check(bool(torch.isfinite(logits).all()), "(vlm image) decode finite")
    first = iids[0]                  # the token decoded at position S
    fresh, _ = M.prefill(cfg, params, {"tokens": torch.cat([itoks, first], 1),
                                       "patches": patches})
    err = float((first_logits - fresh).abs().max())
    check(torch.allclose(first_logits, fresh, rtol=DECODE_TOL,
                         atol=DECODE_TOL),
          f"(vlm image) decode at S + P == prefill of S + 1 tokens with the "
          f"same patches within {DECODE_TOL}")
    iids = torch.cat(iids, 1).cpu().numpy()
    log(phase="vlm_image", launches={"flash_attention": image_launches},
        patches=P, tokens=S - P, prefill_s=t_pre,
        decode_ms_per_token=t_dec / n_new * 1e3,
        decode_vs_prefill_max_abs=err, generated_ids=iids.tolist(),
        distinct_ids=len(np.unique(iids)))
    del cache, fresh, logits, first_logits
    pre_wall = _wall_ms(lambda: M.prefill(cfg, params, image), reps=3)
    _split_log("vlm_prefill_split", lambda: M.prefill(cfg, params, image),
               pre_wall, expect=("flash_fwd_kernel",))
    _, cache = M.prefill(cfg, params, image)
    dec_cache = eng._pad_cache(cache)

    def one_decode():
        M.decode_step(cfg, params, first, dec_cache, S)
    _split_log("vlm_decode_split", one_decode, _wall_ms(one_decode))
    del cache, dec_cache, params, eng, patches
    torch.cuda.empty_cache()

    # ---- (c) rows 8f and 8g ----
    H, dh = cfg.n_heads, cfg.dh
    q = torch.randn((B, S, H, dh), generator=g, device="cuda")
    k = torch.randn((B, S, cfg.n_kv_heads, dh), generator=g, device="cuda")
    v = torch.randn((B, S, cfg.n_kv_heads, dh), generator=g, device="cuda")
    causal = flash_shape_record(q, k, v, causal=True)
    log(phase="vlm_flash_causal", **causal)
    del q, k, v
    offset = flash_offset_checks(cfg, g)
    log(phase="vlm_flash_offset", **offset)
    torch.cuda.empty_cache()
    return [kernel_entry(name, launches=n, err=rec["max_abs_err"],
                         ms=rec["ms"], plain_ms=rec["plain_ms"],
                         library_ms=rec["library_ms"], bytes_=rec["bytes"],
                         flops=rec["flops"], peak=TF32_FLOPS / 3)
            for name, n, rec in (
                ("flash_attention_vlm", image_launches, causal),
                ("flash_attention_vlm_offset", text_launches, offset))]


def _kept_pairs(Sq: int, Skv: int, causal: bool) -> int:
    """The (query, key) pairs a mask from position 0 keeps: query i keeps
    keys 0..min(i, Skv - 1) when causal, all Skv keys when not."""
    if not causal:
        return Sq * Skv
    n = min(Sq, Skv)
    return n * (n + 1) // 2 + (Sq - n) * Skv


def flash_backward_record(q, k, v, g, *, causal: bool = True) -> dict:
    """The backward kernel at one shape from position 0, causal or not (q
    (B, Sq, Hq, dh), k, v (B, Skv, Hkv, dh)): the forward's log-sum-exp
    against torch.logsumexp within LSE_TOL; dq, dk, dv against
    `flash_attention_backward_plain` within BWD_TOL of max |plain|; two
    calls the same bits; timed beside the plain version and
    scaled_dot_product_attention's backward (`torch.autograd.grad` through
    SDPA, `is_causal` or no mask, with GQA, its forward outside the
    timing), with its operations (10 dh flops a kept pair: S recomputed,
    dP, dV, dK, dQ) and bytes (q, k, v, out, dout, lse read once, dq, dk,
    dv written once)."""
    import torch
    from repro_torch.kernels.flash_attention import flash_attention as KF
    from repro_torch.kernels.flash_attention import flash_attention_bwd as KB
    B, Sq, Hq, dh = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    name = str(q.dtype).replace("torch.", "")
    label = (f"flash backward {name} q {tuple(q.shape)} k {tuple(k.shape)} "
             f"causal={causal}")
    out, lse = KF.flash_attention_lse(q, k, v, causal=causal)
    _, plain_lse = KF.flash_attention_lse_plain(q, k, v, causal=causal)
    lse_err = float((lse - plain_lse).abs().max())
    check(lse_err <= LSE_TOL, f"{label}: lse within {LSE_TOL} of logsumexp")
    dout = g.to(q.dtype)

    def kernel():
        return KB.flash_attention_backward(q, k, v, out, dout, lse,
                                           causal=causal)

    def plain_version():
        return KB.flash_attention_backward_plain(q, k, v, out, dout, lse,
                                                 causal=causal)
    grads = kernel()
    plain = plain_version()
    torch.cuda.synchronize()
    errs = {n: float((a.float() - b.float()).abs().max())
            for n, a, b in zip(("dq", "dk", "dv"), grads, plain)}
    scale = {n: float(b.float().abs().max())
             for n, b in zip(("dq", "dk", "dv"), plain)}
    if name == "float32":
        for n in errs:
            check(errs[n] <= BWD_TOL[name] * scale[n],
                  f"{label}: {n} within {BWD_TOL[name]} of max |plain|")
        block_share = None
    else:
        block_share = {n: _block_share(a, b)
                       for n, a, b in zip(("dq", "dk", "dv"), grads, plain)}
        for n, share in block_share.items():
            check(share <= BWD_TOL[name],
                  f"{label}: {n} within {BWD_TOL[name]} of max |plain| in "
                  f"every block of {BWD_BLOCK} rows of each head")
    again = kernel()
    check(all(torch.equal(a, b) for a, b in zip(grads, again)),
          f"{label}: two calls give the same bits")
    del plain, again, plain_lse
    qt, kt, vt = (t.transpose(1, 2).contiguous().requires_grad_()
                  for t in (q, k, v))
    ot = torch.nn.functional.scaled_dot_product_attention(
        qt, kt, vt, is_causal=causal, enable_gqa=Hq != Hkv)
    gt = dout.transpose(1, 2).contiguous()
    lib_grads = torch.autograd.grad(ot, (qt, kt, vt), gt, retain_graph=True)
    lib_diff = max(float((a.transpose(1, 2).float() - b.float()).abs().max())
                   for a, b in zip(lib_grads, grads))
    del lib_grads
    ms = timed_ms(kernel)
    plain_ms = timed_ms(plain_version)
    lib_ms = timed_ms(lambda: torch.autograd.grad(
        ot, (qt, kt, vt), gt, retain_graph=True))
    pairs = _kept_pairs(Sq, Skv, causal)
    flops = 10 * dh * pairs * B * Hq
    # q, out, dout, dq and k, v, dk, dv once each, and the float32 lse
    nbytes = q.element_size() * (4 * q.numel() + 4 * k.numel()) \
        + 4 * lse.numel()
    # the three CUDA kernels of one call apart, each with the operations
    # it runs (S and dP recomputed in both tile kernels: 8 dh flops a pair
    # in dK/dV, 6 dh in dQ)
    by_name = device_ms_by_kernel(kernel, expect=BWD_KERNELS)
    split = {}
    for kern, per_pair in zip(BWD_KERNELS, (0, 8, 6)):
        kms = sum(t for n, t in by_name.items() if kern in n)
        work = per_pair * dh * pairs * B * Hq
        split[kern] = {"device_ms": kms, "flops_run": work,
                       "tflops": work / kms / 1e9 if kms > 0 and work
                       else None}
    del ot, qt, kt, vt, gt, grads, out, lse
    return {"dtype": name, "shape": {"q": list(q.shape), "kv": list(k.shape)},
            "causal": causal, "lse_max_abs_err": lse_err, "max_abs_err": max(errs.values()),
            "max_abs_err_by_grad": errs, "max_abs_plain": scale,
            "worst_block_share": block_share,
            "sdpa_max_abs_diff": lib_diff, "ms": ms, "plain_ms": plain_ms,
            "library_ms": lib_ms, "flops": flops, "bytes": nbytes,
            "tflops_needed_work": flops / (ms * 1e-3) / 1e12,
            "kernels": split, "kernels_other_ms": sum(by_name.values())
            - sum(r["device_ms"] for r in split.values())}


def _block_share(a, b) -> float:
    """The largest max |a - b| of a block of BWD_BLOCK rows (dim 1) of one
    (batch, head) of (B, S, H, dh) tensors, as a share of that block's
    max |b| (a block whose b is all zero must match exactly). A ragged
    last block holds the rows that are left (zeros pad it)."""
    import torch
    B, S, H, dh = b.shape
    n = -(-S // BWD_BLOCK)

    def block_max(t):
        t = torch.nn.functional.pad(t.abs(), (0, 0, 0, 0, 0,
                                              n * BWD_BLOCK - S))
        return t.reshape(B, n, BWD_BLOCK, H, dh).amax(dim=(2, 4))
    diff = block_max(a.float() - b.float())
    ref = block_max(b.float())
    share = torch.where(ref > 0, diff / ref, torch.where(
        diff > 0, torch.inf, 0.0))
    return float(share.max())


def serving_bits_without_lse(cfg_dense, cfg_vlm, g) -> dict:
    """Rows 8b and 8g's serving calls (a chunk of 512 queries from offset
    1,536 against 2,048 keys: qwen2-1.5b's 12 / 2 heads of 128, and
    phi-3-vision's 32 / 32 of 96) give the same bits whether or not the
    kernel is asked for the log-sum-exp: serving (lse null) is untouched
    by the training output."""
    import torch
    from repro_torch.kernels.flash_attention import flash_attention as KF
    out = {}
    for cfg in (cfg_dense, cfg_vlm):
        q = torch.randn((LM_BATCH, DENSE_CHUNK, cfg.n_heads, cfg.dh),
                        generator=g, device="cuda")
        k = torch.randn((LM_BATCH, LM_PROMPT, cfg.n_kv_heads, cfg.dh),
                        generator=g, device="cuda")
        v = torch.randn_like(k)
        off = LM_PROMPT - DENSE_CHUNK
        served = KF.flash_attention(q, k, v, causal=True, q_offset=off)
        with_lse, _ = KF._launch(q, k, v, causal=True, window=0,
                                 q_offset=off, lse=True)
        same = bool(torch.equal(served, with_lse))
        check(same, f"{cfg.name}: flash without lse == with lse, bit for "
                    f"bit")
        out[cfg.name] = same
    return out


def _state_copy(state, device):
    """A copy of train state `state` on `device` (the same bits): its
    model deep-copied and moved, every other tensor copied."""
    import copy
    import torch
    if isinstance(state, torch.nn.Module):
        return copy.deepcopy(state).to(device)
    if isinstance(state, dict):
        return {k_: _state_copy(v_, device) for k_, v_ in state.items()}
    if isinstance(state, torch.Tensor):
        return state.detach().to(device, copy=True)
    return copy.deepcopy(state)


def _loss_grads(cfg, state, batch) -> dict:
    """The float32 loss's gradient of every parameter of `state`, by name,
    under the state's MoE capacity scales (the state is not changed)."""
    import torch
    from repro_torch.models import model as M
    model = state["params"]
    loss, _ = M.loss_fn(cfg, model, batch, state["cap_scales"],
                        dtype=torch.float32)
    names = [n for n, _ in model.named_parameters()]
    return dict(zip(names, torch.autograd.grad(loss,
                                               list(model.parameters()))))


def remat_dots_step(cfg, tcfg, state, batch) -> dict:
    """One full-width step from `state` on `batch` under remat_policy
    "nothing" and, from the same state, under "dots" (selective
    checkpointing keeps the projections' outputs), each after one warm-up
    step from that state (the caching allocator grows to the policy's
    peak): wall ms and peak GB of each, and the grad norms within
    REMAT_NORM_RTOL relative. `state` ends as the "dots" step leaves
    it."""
    import dataclasses
    import torch
    from repro_torch.train import checkpoint as CKPT
    from repro_torch.train import train_step as TS
    # the state's copy waits in host memory, so each step's peak is its own
    saved = [t.detach().to("cpu", copy=True)
             for _, t in CKPT.state_leaves(state)]
    def restore():
        with torch.no_grad():
            for (_, t), s_ in zip(CKPT.state_leaves(state), saved):
                t.copy_(s_)

    rec = {}
    for policy in ("nothing", "dots"):
        step = TS.make_train_step(dataclasses.replace(
            cfg, remat_policy=policy), tcfg)
        restore()
        step(state, batch)
        restore()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        _, m = step(state, batch)
        norm = float(m["grad_norm"])
        torch.cuda.synchronize()
        rec[policy] = {"wall_ms": (time.perf_counter() - t0) * 1e3,
                       "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
                       "loss": float(m["loss"]), "grad_norm": norm}
    del saved
    rel = abs(rec["dots"]["grad_norm"] - rec["nothing"]["grad_norm"]) \
        / rec["nothing"]["grad_norm"]
    check(rel <= REMAT_NORM_RTOL, f"train: the grad norm under \"dots\" "
          f"within {REMAT_NORM_RTOL} relative of \"nothing\"'s")
    return {**rec, "grad_norm_rel_diff": rel}


def attention_calls(cfg) -> int:
    """Flash calls of one training forward: one a layer; for encdec each
    encoder layer's, and each decoder layer's self- and cross-attention;
    for hybrid and ssm one an "A" position."""
    if cfg.family == "encdec":
        return cfg.encoder_layers + 2 * cfg.n_layers
    if cfg.family in ("hybrid", "ssm"):
        return cfg.block_pattern.count("A")
    return cfg.n_layers


def scan_calls(cfg) -> int:
    """SSD scan calls of one training forward: one an "M" or "X" block."""
    if cfg.family not in ("hybrid", "ssm"):
        return 0
    return sum(kind in "MX" for kind in cfg.block_pattern)


def family_inputs(cfg, batch: int, rows: int, rng) -> dict:
    """The family's own inputs, float32 standard normal from numpy `rng`
    (shaped as `repro/launch/specs.py:19-25` gives them): "patches"
    (batch, rows, d) for a vlm, "frames" (batch, rows, d) for encdec;
    none for other families or rows 0."""
    key = {"vlm": "patches", "encdec": "frames"}.get(cfg.family)
    if key is None or not rows:
        return {}
    return {key: rng.standard_normal((batch, rows, cfg.d_model),
                                     dtype=np.float32)}


def _update_parity(tcfg, cpu, card, step_cpu, m_grad_cpu, g_cpu):
    """AdamW given identical gradients (the CPU's `g_cpu` on both sides):
    the CPU's step (`step_cpu.apply` on its state `cpu`, in place) and
    AdamW on a copy of the same state on the card (`card`, left as it
    is), compared on the card: the grad norm, every parameter and both
    moments within UPDATE_RTOL (a parameter also within UPDATE_RTOL lr).
    Returns (the largest parameter difference, the CPU's stepped state,
    its metrics)."""
    import torch
    from repro_torch.optim import adamw
    upd_card = _state_copy(card, "cuda")
    p_card = dict(upd_card["params"].named_parameters())
    _, o_card, m_card = adamw.apply_updates(
        p_card, {n: g.cuda() for n, g in g_cpu.items()}, upd_card["opt"],
        tcfg.opt)
    cpu, m_cpu = step_cpu.apply(cpu, m_grad_cpu, g_cpu)
    lr = float(m_cpu["lr"])
    check(abs(float(m_card["grad_norm"]) - float(m_cpu["grad_norm"]))
          <= UPDATE_RTOL * float(m_cpu["grad_norm"]),
          f"train parity: the update's grad norm within {UPDATE_RTOL}")
    update_worst = 0.0
    for n, p in cpu["params"].named_parameters():
        a, b = p_card[n].detach(), p.detach().cuda()
        check(torch.allclose(a, b, rtol=UPDATE_RTOL, atol=UPDATE_RTOL * lr),
              f"train parity: {n} after the update given identical "
              f"gradients within {UPDATE_RTOL} relative or {UPDATE_RTOL} lr")
        update_worst = max(update_worst, float((a - b).abs().max()))
        for k_ in ("m", "v"):
            check(torch.allclose(o_card[k_][n], cpu["opt"][k_][n].cuda(),
                                 rtol=UPDATE_RTOL, atol=0.0),
                  f"train parity: {k_} of {n} given identical gradients "
                  f"within {UPDATE_RTOL} relative")
    del upd_card, p_card, o_card
    return update_worst, cpu, m_cpu


def train_parity(cfg, *, rows: int = 0, max_seq: int = 0,
                 seq: int = TRAIN_CUT_SEQ, pattern=None,
                 cap_scales=None, update: bool = True) -> dict:
    """One float32 step of `cfg` at full width cut to TRAIN_CUT_LAYERS
    layers (an encoder too; a hybrid or ssm `pattern` of blocks) on the
    card (the kernels) and on the CPU (the plain versions) from the same
    state and batch (TRAIN_CUT_BATCH x `seq` tokens, and `rows` patch or
    frame rows for a vlm or encdec; `max_seq` sizes a learned position
    table; a moe model's capacity scales from `cap_scales`, when given):
    every gradient leaf (the largest deviation logged per leaf and per
    leaf group, the layer index left out), the step's loss and grad norm,
    and, with `update`, the AdamW update given identical gradients, within
    the stated tolerances; for moe also the dropped and stolen entries and
    the new capacity scales equal. The state is drawn on the host and
    copied to the card; the CPU's step is AdamW of the CPU's gradient, on
    the CPU with `update` (`_update_parity`), else on a copy of the
    card's state (AdamW on both devices is held by phase_train's parity;
    the capacity scales still updated on the CPU from the CPU's counts);
    leaves are compared on the card. `seconds_by_part`: where its wall
    time went (the card synchronised at each boundary)."""
    import dataclasses
    import torch
    from repro_torch.data.pipeline import synthetic_tokens
    from repro_torch.kernels.flash_attention import flash_attention as KF
    from repro_torch.kernels.flash_attention import flash_attention_bwd as KB
    from repro_torch.kernels.ich_moe import ich_moe as KM
    from repro_torch.kernels.ich_moe import ich_moe_bwd as KMB
    from repro_torch.kernels.mamba_scan import mamba_scan as KS
    from repro_torch.kernels.mamba_scan import mamba_scan_bwd as KSB
    from repro_torch.models import model as M
    from repro_torch.optim import adamw
    from repro_torch.train import train_step as TS
    over = {"n_layers": TRAIN_CUT_LAYERS}
    if cfg.family == "encdec":
        over["encoder_layers"] = TRAIN_CUT_LAYERS
    if pattern is not None:
        over.update(block_pattern=tuple(pattern), n_layers=len(pattern))
    cut = dataclasses.replace(cfg, **over)
    tcfg = TS.TrainConfig(dtype=torch.float32, opt=adamw.AdamWConfig(
        warmup_steps=2, total_steps=TRAIN_STEPS))
    part_s, t_lap = {}, [time.perf_counter()]

    def lap(name):
        torch.cuda.synchronize()
        now = time.perf_counter()
        part_s[name] = part_s.get(name, 0.0) + now - t_lap[0]
        t_lap[0] = now

    cpu = TS.init_train_state(cut, SEED + 20, max_seq=max_seq, tcfg=tcfg,
                              device="cpu")
    if cap_scales is not None:
        cpu["cap_scales"].copy_(torch.from_numpy(
            cap_scales[:M.n_moe_layers(cut)]))
    lap("cpu_state")
    card = _state_copy(cpu, "cuda")
    lap("card_state")
    batch = synthetic_tokens(TRAIN_CUT_BATCH, seq, cut.padded_vocab, 0, SEED)
    batch.update(family_inputs(cut, TRAIN_CUT_BATCH, rows,
                               np.random.default_rng(SEED + 22)))
    b_cpu = {k_: torch.from_numpy(v_) for k_, v_ in batch.items()}
    b_card = {k_: v_.cuda() for k_, v_ in b_cpu.items()}

    # every gradient leaf, from the same state and batch: the CPU's one
    # gradient of this parity, which its step below reuses
    step_cpu = TS.make_train_step(cut, tcfg)
    lap("batch")
    m_grad_cpu, g_cpu = step_cpu.loss_and_grads(cpu, b_cpu)
    lap("cpu_grad")
    g_card = _loss_grads(cut, card, b_card)
    lap("card_grad")
    grad_share = {}
    for n, b in g_cpu.items():
        b = b.cuda()
        diff = float((g_card[n] - b).abs().max())
        top = float(b.abs().max())
        check(diff <= TRAIN_GRAD_TOL * top,
              f"train parity: gradient {n} within {TRAIN_GRAD_TOL} of its "
              f"max |CPU gradient| ({diff:.3g} of {top:.3g})")
        grad_share[n] = diff / top if top > 0 else diff
    del g_card
    by_group = {}
    for n, share in grad_share.items():
        parts = n.split(".")
        group = ".".join(parts[2:]) if parts[0] in M.STACKED_PREFIXES else n
        by_group[group] = max(by_group.get(group, 0.0), share)

    # the CPU's step, AdamW of the CPU's gradient: on the CPU, held against
    # the card's AdamW given identical gradients, with `update`; else on a
    # copy of the card's state
    update_worst = None
    if update:
        update_worst, ref, m_cpu = _update_parity(tcfg, cpu, card, step_cpu,
                                                  m_grad_cpu, g_cpu)
    else:
        ref = dict(_state_copy(card, "cuda"), cap_scales=cpu["cap_scales"])
        ref, m_cpu = step_cpu.apply(ref, m_grad_cpu,
                                    {n: g.cuda() for n, g in g_cpu.items()})
    del g_cpu
    lap("cpu_step")

    # the card's whole step, its launches counted
    for mod in (KF, KB, KS, KSB, KM, KMB):
        mod.reset_launches()
    card, m_card = TS.make_train_step(cut, tcfg)(card, b_card)
    lap("card_step")
    launches = {"flash_attention": KF.LAUNCHES["flash_attention"],
                "flash_attention_bwd": KB.LAUNCHES["flash_attention_bwd"],
                "mamba_scan": KS.LAUNCHES["mamba_scan"],
                "mamba_scan_bwd": KSB.LAUNCHES["mamba_scan_bwd"],
                "ich_moe_sharded": KM.LAUNCHES["ich_moe_sharded"],
                "ich_moe_bwd": KMB.LAUNCHES["ich_moe_bwd"]}
    lr = float(m_cpu["lr"])
    worst, flipped, n_el = 0.0, 0, 0
    for (name, a), (_, b) in zip(card["params"].named_parameters(),
                                 ref["params"].named_parameters()):
        b = b.detach().cuda()
        diff = (a.detach() - b).abs()
        worst = max(worst, float(diff.max()))
        flipped += int((diff > 1e-6 * (b.abs() + lr)).sum())
        n_el += b.numel()
    lap("step_compare")
    loss = (float(m_card["loss"]), float(m_cpu["loss"]))
    gnorm = (float(m_card["grad_norm"]), float(m_cpu["grad_norm"]))
    check(abs(loss[0] - loss[1]) <= TRAIN_LOSS_RTOL * abs(loss[1]),
          f"train parity: loss within {TRAIN_LOSS_RTOL} of the CPU's")
    check(abs(gnorm[0] - gnorm[1]) <= TRAIN_GNORM_RTOL * abs(gnorm[1]),
          f"train parity: grad norm within {TRAIN_GNORM_RTOL} of the CPU's")
    per_call = 2 if cut.remat else 1    # remat reruns each forward
    n_attn, n_scan = attention_calls(cut), scan_calls(cut)
    n_moe = M.n_moe_layers(cut)
    check(launches == {"flash_attention": per_call * n_attn,
                       "flash_attention_bwd": n_attn,
                       "mamba_scan": per_call * n_scan,
                       "mamba_scan_bwd": n_scan,
                       "ich_moe_sharded": per_call * n_moe,
                       "ich_moe_bwd": n_moe},
          f"train parity: {per_call} forward and 1 backward launch an "
          f"attention call ({n_attn}), a scan call ({n_scan}) and a MoE "
          f"layer ({n_moe}) on the card")
    moe = {}
    if n_moe:
        moe = {k_: (float(m_card[k_]), float(m_cpu[k_]))
               for k_ in ("aux_loss", "dropped", "stolen")}
        check(moe["dropped"][0] == moe["dropped"][1]
              and moe["stolen"][0] == moe["stolen"][1],
              "train parity: the card drops and steals the CPU's entries")
        check(torch.equal(card["cap_scales"].cpu(), ref["cap_scales"]),
              "train parity: the new capacity scales equal the CPU's")
    return {"arch": cfg.name, "layers": cut.n_layers,
            "block_pattern": list(cut.block_pattern),
            "encoder_layers": cut.encoder_layers, "batch": TRAIN_CUT_BATCH,
            "seq": seq, "rows": rows, "loss_card_cpu": loss,
            "grad_norm_card_cpu": gnorm, "lr": lr,
            "grad_worst_share": max(grad_share.values()),
            "grad_share_by_group": by_group,
            "grad_share_by_leaf": grad_share, "moe_card_cpu": moe,
            "update_max_abs_diff": update_worst,
            "step_param_max_abs_diff": worst, "params": n_el,
            "step_params_past_1e-6": flipped, "launches": launches,
            "cpu_grad_s": part_s["cpu_grad"], "seconds_by_part": part_s}


def train_resume(cfg) -> dict:
    """`train()` at full width cut to TRAIN_CUT_LAYERS layers: 4 steps,
    a checkpoint every 2, a failure injected after step 2 (InjectedFailure,
    list_steps == [2]), then a resume that runs 2 more steps; its losses
    against an uninterrupted in-memory run of the same 4 steps
    (init_train_state -> make_train_step -> Pipeline)."""
    import contextlib
    import dataclasses
    import io
    import shutil
    import torch
    from repro_torch.data.pipeline import Pipeline
    from repro_torch.train import checkpoint as CKPT
    from repro_torch.train import train_step as TS
    from repro_torch.train.trainer import InjectedFailure, RunConfig, train
    cut = dataclasses.replace(cfg, n_layers=TRAIN_CUT_LAYERS)
    ckpt_dir = Path(__file__).resolve().parent / "build" / "chip_smoke_ckpt"
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    run = RunConfig(steps=4, batch=TRAIN_CUT_BATCH, seq=TRAIN_CUT_SEQ,
                    ckpt_dir=str(ckpt_dir), ckpt_every=2, failure_at=2,
                    log_every=1, seed=SEED)
    lines = io.StringIO()
    try:
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(lines):
            try:
                train(cut, run, device="cuda")
                failed = False
            except InjectedFailure:
                failed = True
            check(failed, "train(): the injected failure after step 2")
            steps = CKPT.list_steps(str(ckpt_dir))
            check(steps == [2], f"train(): list_steps == [2], got {steps}")
            state, resumed = train(cut, dataclasses.replace(
                run, failure_at=None), device="cuda")
        train_s = time.perf_counter() - t0
        check(len(resumed) == 2, "train(): the resume runs steps 2 and 3")
        ckpt_bytes = {s_: sum(f.stat().st_size for f in
                              (ckpt_dir / f"step_{s_}").iterdir())
                      for s_ in CKPT.list_steps(str(ckpt_dir))}
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    # the same 4 steps uninterrupted, in memory, with train()'s TrainConfig
    tcfg = TS.TrainConfig(opt=dataclasses.replace(
        TS.TrainConfig().opt, warmup_steps=10, total_steps=run.steps))
    mem = TS.init_train_state(cut, run.seed, max_seq=run.seq, tcfg=tcfg,
                              device="cuda")
    step = TS.make_train_step(cut, tcfg)
    pipe = Pipeline(cut, run.batch, run.seq, seed=run.seed, device="cuda")
    losses = []
    for t in range(run.steps):
        batch, _ = pipe.get_batch(t)
        mem, m = step(mem, {k_: torch.from_numpy(v_).cuda()
                            for k_, v_ in batch.items()})
        losses.append(float(m["loss"]))
    pipe.close()
    diff = max(abs(a - b) for a, b in zip(resumed, losses[2:]))
    check(diff <= RESUME_TOL, f"train(): resumed losses within {RESUME_TOL} "
                              f"of the uninterrupted run's")
    same_state = all(torch.equal(a, b) for (_, a), (_, b) in zip(
        CKPT.state_leaves(state), CKPT.state_leaves(mem)))
    del state, mem
    return {"resumed_losses": resumed, "uninterrupted_losses": losses,
            "max_abs_diff": diff, "bits_equal": resumed == losses[2:],
            "final_state_bits_equal": same_state,
            "checkpoint_bytes": ckpt_bytes, "train_s": train_s,
            "trainer_log": lines.getvalue().splitlines()}


def phase_train():
    """Training (ROADMAP.md queue 1 item 5, the dense family). (1) The
    flash backward kernel at qwen2-1.5b's training shape (q (4, 2,048, 12,
    128), k, v (4, 2,048, 2, 128), causal), float32 and bfloat16, against
    its plain version (`flash_backward_record`), and the serving shapes of
    rows 8b and 8g giving the same bits with and without the log-sum-exp.
    (2) The counted main path (`train_model`): qwen2-1.5b at full width
    and depth (1.544 B float32 parameters, remat on), TRAIN_STEPS bfloat16
    steps of 4 x 2,048 tokens; bars: finite losses, the last below the
    first, finite non-zero grad norms, 2 x 28 flash forward launches
    (remat reruns each layer's forward) and 28 backward launches a step;
    logged: step wall ms, tokens/s, peak memory, where a step's device
    time goes (products, flash forward, flash backward, other) and the
    idle share; then one step under remat_policy "dots" beside one under
    "nothing" from the same state and batch (`remat_dots_step`).
    (3) Float32 parity with the CPU at 2 layers (`train_parity`). (4)
    `train()`'s failure and resume (`train_resume`).
    """
    import torch
    from repro_torch.configs import get_arch
    torch.backends.cuda.matmul.allow_tf32 = False  # float32 as float32
    cfg = get_arch(TRAIN_ARCH)
    B, S = TRAIN_BATCH, TRAIN_SEQ
    g = torch.Generator(device="cuda")
    g.manual_seed(SEED + 30)

    # ---- (1) the backward kernel at the training shape ----
    records = {}
    for dtype in (torch.float32, torch.bfloat16):
        q = torch.randn((B, S, cfg.n_heads, cfg.dh), generator=g,
                        device="cuda").to(dtype)
        k = torch.randn((B, S, cfg.n_kv_heads, cfg.dh), generator=g,
                        device="cuda").to(dtype)
        v = torch.randn_like(k)
        dout = torch.randn(q.shape, generator=g, device="cuda")
        rec = flash_backward_record(q, k, v, dout)
        records[rec["dtype"]] = rec
        log(phase="train_flash_backward", bound_ms=1e3 * max(
            rec["bytes"] / HBM_BYTES_PER_S,
            rec["flops"] / BWD_PEAK[rec["dtype"]]), **rec)
        del q, k, v, dout
    log(phase="train_serving_bits", same_bits=serving_bits_without_lse(
        get_arch(DENSE_ARCH), get_arch(VLM_ARCH), g))
    torch.cuda.empty_cache()

    # ---- (2) full width and depth, bfloat16, counted ----
    state, batch, tcfg, by_kind, extra = train_model(
        cfg, label="train", batch=B, seq=S, n_steps=TRAIN_STEPS, max_seq=S)
    MEASURED["train_main_path"] = {"peak_gb": extra["peak_gb"],
                                   "tcfg": tcfg}
    log(phase="train_remat_dots", **remat_dots_step(cfg, tcfg, state, batch))
    del state, batch
    torch.cuda.empty_cache()

    # ---- (3) float32 parity with the CPU, (4) train()'s resume ----
    log(phase="train_parity", **train_parity(cfg))
    torch.cuda.empty_cache()
    log(phase="train_resume", **train_resume(cfg))
    torch.cuda.empty_cache()
    rec = records["bfloat16"]       # the main path's type
    return [kernel_entry("flash_attention_bwd", launches=by_kind["self"],
                         err=rec["max_abs_err"], ms=rec["ms"],
                         plain_ms=rec["plain_ms"],
                         library_ms=rec["library_ms"], bytes_=rec["bytes"],
                         flops=rec["flops"], peak=BWD_PEAK["bfloat16"])]


def train_kinds(cfg, batch: int, seq: int, rows: int) -> dict:
    """The flash calls of a training step by kind: {kind: ((q shape, k
    shape, causal), calls a forward)}. A vlm: its layers' causal
    self-attention over rows + seq positions; whisper: its encoder's
    non-causal self-attention over the rows, its decoder's causal
    self-attention and its cross-attention against the rows; hybrid and
    ssm: the causal (windowed) attention of their "A" positions, if any."""
    H, Hkv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.dh
    if cfg.family in ("hybrid", "ssm"):
        n = cfg.block_pattern.count("A")
        return {"self": (((batch, seq, H, dh), (batch, seq, Hkv, dh), True),
                         n)} if n else {}
    if cfg.family != "encdec":
        n = rows + seq
        return {"self": (((batch, n, H, dh), (batch, n, Hkv, dh), True),
                         cfg.n_layers)}
    enc, dec = (batch, rows, H, dh), (batch, seq, H, dh)
    kv_enc, kv_dec = (batch, rows, Hkv, dh), (batch, seq, Hkv, dh)
    return {"encoder": ((enc, kv_enc, False), cfg.encoder_layers),
            "self": ((dec, kv_dec, True), cfg.n_layers),
            "cross": ((dec, kv_enc, False), cfg.n_layers)}


def train_model(cfg, *, label: str, batch: int, seq: int, n_steps: int,
                rows: int = 0, max_seq: int = 0, parts: bool = True,
                trace_seq: int = 0):
    """The counted main path of one model's training at full width and
    depth: `init_train_state` (from an emptied card) -> `make_train_step`
    -> `n_steps` bfloat16 steps of `Pipeline` batches of batch x seq tokens
    with the family's `rows` patch or frame rows (`family_inputs`), remat
    on, TrainConfig's defaults (no microbatch). Bars: finite losses, the
    last below the first; finite non-zero grad norms; 2 flash forward
    launches (remat reruns each) and 1 backward launch an attention call
    a step, by kind (`train_kinds`, tallied by shape), and likewise 2 SSD
    scan forward and 1 backward launch an "M" or "X" block (`scan_calls`)
    and 2 expert kernel and 1 expert backward launch a MoE layer; a moe
    model's step logs its aux loss, dropped and stolen entries and how many experts' scales
    the balancer moved. Logged as `<label>_setup`, `<label>_main_path`
    (steps, step wall ms, tokens/s, positions/s, peak GB),
    `<label>_step_split` (`_split_log`: one step traced, on the last
    batch's first `trace_seq` tokens when given, after an untimed and a
    timed step at that length, whose wall the split holds its device time
    against) and, with `parts`, `<label>_step_parts` (`step_parts`).
    Returns (the state, the last batch, the TrainConfig, the backward
    launches of the counted steps by kind, {"split": the step split,
    "wall_ms": the median step wall ms, "launches": the counted steps'
    launches by wrapper, "steps": each step's record, "peak_gb",
    "split_seq": the traced step's tokens a row, "split_wall_ms"}); the
    caller frees the state."""
    import dataclasses
    import gc
    import torch
    from repro_torch.data.pipeline import Pipeline
    from repro_torch.kernels.flash_attention import flash_attention as KF
    from repro_torch.kernels.flash_attention import flash_attention_bwd as KB
    from repro_torch.kernels.ich_moe import ich_moe as KM
    from repro_torch.kernels.ich_moe import ich_moe_bwd as KMB
    from repro_torch.kernels.mamba_scan import mamba_scan as KS
    from repro_torch.kernels.mamba_scan import mamba_scan_bwd as KSB
    from repro_torch.models import model as M
    from repro_torch.optim import adamw
    from repro_torch.train import train_step as TS
    gc.collect()
    torch.cuda.empty_cache()
    start_gb = torch.cuda.memory_allocated() / 1e9
    tcfg = TS.TrainConfig(opt=adamw.AdamWConfig(warmup_steps=2,
                                                total_steps=n_steps))
    t0 = time.perf_counter()
    state = TS.init_train_state(cfg, SEED, max_seq=max_seq, tcfg=tcfg,
                                device="cuda")
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in state["params"].parameters())
    n_moe = M.n_moe_layers(cfg)
    log(phase=f"{label}_setup", arch=cfg.name, family=cfg.family,
        layers=cfg.n_layers, encoder_layers=cfg.encoder_layers,
        d_model=cfg.d_model, heads=cfg.n_heads, kv_heads=cfg.n_kv_heads,
        dh=cfg.dh, d_ff=cfg.d_ff, vocab=cfg.padded_vocab, params=n_params,
        moe_layers=n_moe, experts=cfg.n_experts,
        top_k=cfg.experts_per_token, expert_ff=cfg.moe_d_ff,
        remat=cfg.remat, remat_policy=cfg.remat_policy, batch=batch,
        seq=seq, rows=rows, max_seq=max_seq, steps=n_steps,
        train_config={"dtype": str(tcfg.dtype), "microbatch": tcfg.microbatch,
                      "grad_compress": tcfg.grad_compress,
                      "bf16_params": tcfg.bf16_params,
                      "cast_params_once": tcfg.cast_params_once,
                      "opt": dataclasses.asdict(tcfg.opt)},
        allocated_gb_before=start_gb, init_s=time.perf_counter() - t0)
    check(start_gb < 2.0, f"{label}: starts on an emptied card")
    step = TS.make_train_step(cfg, tcfg)
    pipe = Pipeline(cfg, batch, seq, seed=SEED, device="cuda")
    rng = np.random.default_rng(SEED + 40)
    kinds = train_kinds(cfg, batch, seq, rows)
    n_attn, n_scan = attention_calls(cfg), scan_calls(cfg)
    check(sum(n for _, n in kinds.values()) == n_attn,
          f"{label}: the kinds hold every attention call")
    fwd, restore_fwd = flash_calls_by_shape()
    bwd, restore_bwd = flash_calls_by_shape(KB, "flash_attention_backward")
    torch.cuda.reset_peak_memory_stats()
    KF.reset_launches()
    KB.reset_launches()
    KS.reset_launches()
    KSB.reset_launches()
    KM.reset_launches()
    KMB.reset_launches()
    steps = []
    try:
        for t in range(n_steps):
            batch_np, ingest = pipe.get_batch(t)
            batch_np = {**batch_np, **family_inputs(cfg, batch, rows, rng)}
            f0, b0 = KF.LAUNCHES["flash_attention"], \
                KB.LAUNCHES["flash_attention_bwd"]
            s0, sb0 = KS.LAUNCHES["mamba_scan"], \
                KSB.LAUNCHES["mamba_scan_bwd"]
            m0, mb0 = KM.LAUNCHES["ich_moe_sharded"], \
                KMB.LAUNCHES["ich_moe_bwd"]
            caps_before = state["cap_scales"].clone()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            dev_batch = {k_: torch.from_numpy(v_).cuda()
                         for k_, v_ in batch_np.items()}
            state, m = step(state, dev_batch)
            loss = float(m["loss"])
            torch.cuda.synchronize()
            steps.append({"step": t, "loss": loss,
                          "grad_norm": float(m["grad_norm"]),
                          "lr": float(m["lr"]),
                          "n_tokens": int(m["n_tokens"]),
                          "wall_ms": (time.perf_counter() - t0) * 1e3,
                          "flash_forward": KF.LAUNCHES["flash_attention"]
                          - f0,
                          "flash_backward": KB.LAUNCHES["flash_attention_bwd"]
                          - b0,
                          "scan_forward": KS.LAUNCHES["mamba_scan"] - s0,
                          "scan_backward": KSB.LAUNCHES["mamba_scan_bwd"]
                          - sb0,
                          "moe_forward": KM.LAUNCHES["ich_moe_sharded"] - m0,
                          "moe_backward": KMB.LAUNCHES["ich_moe_bwd"] - mb0,
                          "ingest_steals": ingest.steals})
            if n_moe:
                steps[-1].update(
                    {k_: float(m[k_]) for k_ in M.AUX_SUMS},
                    cap_scales_moved=int((state["cap_scales"]
                                          != caps_before).sum()),
                    cap_scales_min=float(state["cap_scales"].min()),
                    cap_scales_max=float(state["cap_scales"].max()))
    finally:
        restore_fwd()
        restore_bwd()
        pipe.close()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    launches = {"flash_attention": KF.LAUNCHES["flash_attention"],
                "flash_attention_bwd": KB.LAUNCHES["flash_attention_bwd"],
                "mamba_scan": KS.LAUNCHES["mamba_scan"],
                "mamba_scan_bwd": KSB.LAUNCHES["mamba_scan_bwd"],
                "ich_moe_sharded": KM.LAUNCHES["ich_moe_sharded"],
                "ich_moe_bwd": KMB.LAUNCHES["ich_moe_bwd"]}
    fwd_by_kind = {kind: fwd.get(key, 0) for kind, (key, _) in kinds.items()}
    bwd_by_kind = {kind: bwd.get(key, 0) for kind, (key, _) in kinds.items()}
    losses = [s_["loss"] for s_ in steps]
    wall = float(np.median([s_["wall_ms"] for s_ in steps[1:]]))
    log(phase=f"{label}_main_path", steps=steps, launches=launches,
        flash_forward_by_kind=fwd_by_kind, flash_backward_by_kind=bwd_by_kind,
        step_wall_ms=wall, tokens_per_s=batch * seq / (wall * 1e-3),
        positions_per_s=batch * (rows + seq) / (wall * 1e-3),
        peak_gb=peak_gb)
    check(all(np.isfinite(losses)), f"{label}: finite losses")
    check(losses[-1] < losses[0], f"{label}: the loss at step {n_steps} "
                                  f"below step 1's")
    check(all(np.isfinite(s_["grad_norm"]) and s_["grad_norm"] > 0
              for s_ in steps), f"{label}: finite non-zero grad norms")
    check(all(s_["flash_forward"] == 2 * n_attn
              and s_["flash_backward"] == n_attn for s_ in steps),
          f"{label}: {2 * n_attn} flash forward and {n_attn} backward "
          f"launches a step")
    check(all(s_["scan_forward"] == 2 * n_scan
              and s_["scan_backward"] == n_scan for s_ in steps),
          f"{label}: {2 * n_scan} scan forward and {n_scan} backward "
          f"launches a step")
    check(all(s_["moe_forward"] == 2 * n_moe
              and s_["moe_backward"] == n_moe for s_ in steps),
          f"{label}: {2 * n_moe} expert kernel and {n_moe} expert backward "
          f"launches a step")
    want = {kind: n * n_steps for kind, (_, n) in kinds.items()}
    check(bwd_by_kind == want and sum(bwd.values()) == launches[
        "flash_attention_bwd"] and fwd_by_kind == {
            kind: 2 * n for kind, n in want.items()}
          and sum(fwd.values()) == launches["flash_attention"],
          f"{label}: launches by kind, forward 2 x and backward 1 x {want}")
    expect = (("flash_bwd_",) if n_attn else ()) \
        + (("ssd_bwd_",) if n_scan else ()) \
        + (("moe_bwd_",) if n_moe else ())
    # the steps above warmed the step up (a step of seconds, as xlstm's
    # host-bound sLSTM loop makes it, is not run twice for the trace); a
    # shorter traced step is warmed and timed at its own length first
    traced, split_wall = dev_batch, wall
    if trace_seq:
        traced = {k_: v_[:, :trace_seq] if k_ in ("tokens", "labels")
                  else v_ for k_, v_ in dev_batch.items()}
        step(state, traced)
        split_wall = _wall_ms(lambda: step(state, traced), reps=1)
    split = _split_log(f"{label}_step_split", lambda: step(state, traced),
                       split_wall, expect=expect, top=12, warmup=False)
    split["seq"] = trace_seq or seq
    if parts:
        log(phase=f"{label}_step_parts", **step_parts(cfg, tcfg, state,
                                                      dev_batch))
    return state, dev_batch, tcfg, bwd_by_kind, {
        "split": split, "wall_ms": wall, "launches": launches,
        "steps": steps, "peak_gb": peak_gb, "split_seq": trace_seq or seq,
        "split_wall_ms": split_wall}


def step_parts(cfg, tcfg, state, batch) -> dict:
    """Where a step's wall goes, part by part: the loss with its gradient
    (forward, the remat reruns, backward) and AdamW's update, each run
    alone with a synchronize (median wall ms of 3) beside its device ms
    (torch.profiler) and the share of its wall the card idles. The
    update's runs change `state`."""
    import torch
    from repro_torch.models import model as M
    from repro_torch.optim import adamw
    params = dict(state["params"].named_parameters())

    def loss_and_grad():
        loss, _ = M.loss_fn(cfg, state["params"], batch, dtype=tcfg.dtype)
        return torch.autograd.grad(loss, list(params.values()))

    def part(fn) -> dict:
        wall = _wall_ms(fn, reps=3)
        device = sum(device_ms_by_kernel(fn).values())
        return {"wall_ms": wall, "device_ms": device,
                "idle_share": 1.0 - device / wall}
    rec = {"loss_and_grad": part(loss_and_grad)}
    grads = dict(zip(params, loss_and_grad()))
    rec["update"] = part(lambda: adamw.apply_updates(
        params, grads, state["opt"], tcfg.opt))
    rec["update_tensors"] = len(grads)
    del grads
    return rec


def phase_train_vlm_encdec():
    """Training the vlm and encdec families (ROADMAP.md queue 1 item
    5(c)). (1) The flash backward kernel in bfloat16 at the four shapes
    the two models' steps give it (`flash_backward_record`): phi-3-vision's
    (4, 2,048, 32, 96) causal; whisper-small's encoder (4, 1,500, 12, 64)
    non-causal with a ragged last key block, its cross-attention of 448
    queries against 1,500 keys and its decoder's causal 448 (an odd
    nKB of 7). (2) phi-3-vision-4.2b at full width and depth (3.82 B
    float32 parameters; ~61 GB of parameters, gradients and AdamW
    moments) and (3) whisper-small uncut, each `train_model`'s counted
    steps: 2 x 32 flash forward and 32 backward launches a step for
    phi-3-vision, 2 x 36 and 36 (12 encoder, 12 self, 12 cross) for
    whisper. (4) Float32 parity of each with the CPU at 2 layers
    (`train_parity`)."""
    import torch
    from repro_torch.configs import get_arch
    torch.backends.cuda.matmul.allow_tf32 = False  # float32 as float32
    vlm, whisper = get_arch(VLM_ARCH), get_arch(WHISPER_ARCH)
    B, P, Se = TRAIN_BATCH, vlm.num_patches, whisper.encoder_seq
    S_vlm, S_dec = TRAIN_SEQ - P, WHISPER_TEXT_CONTEXT
    shapes = {   # row -> (model, the kind of its call)
        "flash_attention_bwd_vlm": (vlm, S_vlm, P, "self"),
        "flash_attention_bwd_whisper_encoder": (whisper, S_dec, Se,
                                                "encoder"),
        "flash_attention_bwd_whisper_cross": (whisper, S_dec, Se, "cross"),
        "flash_attention_bwd_whisper_self": (whisper, S_dec, Se, "self"),
    }
    g = torch.Generator(device="cuda")
    g.manual_seed(SEED + 42)

    # ---- (1) the backward kernel at the four shapes ----
    records = {}
    for row, (cfg, seq, rows, kind) in shapes.items():
        (q_shape, k_shape, causal), _ = train_kinds(cfg, B, seq, rows)[kind]
        q = torch.randn(q_shape, generator=g, device="cuda").bfloat16()
        k = torch.randn(k_shape, generator=g, device="cuda").bfloat16()
        v = torch.randn(k_shape, generator=g, device="cuda").bfloat16()
        dout = torch.randn(q_shape, generator=g, device="cuda")
        rec = flash_backward_record(q, k, v, dout, causal=causal)
        records[row] = rec
        log(phase="train_ve_flash_backward", row=row, arch=cfg.name,
            kind=kind, bound_ms=1e3 * max(rec["bytes"] / HBM_BYTES_PER_S,
                                          rec["flops"] / BWD_PEAK["bfloat16"]),
            **rec)
        del q, k, v, dout
    torch.cuda.empty_cache()

    # ---- (2), (3) full width and depth, bfloat16, counted ----
    launches = {}
    for label, cfg, seq, rows, max_seq in (
            ("train_vlm", vlm, S_vlm, P, 0),
            ("train_whisper", whisper, S_dec, Se, WHISPER_MAX_SEQ)):
        state, batch, _, by_kind, _ = train_model(
            cfg, label=label, batch=B, seq=seq, n_steps=TRAIN_VE_STEPS,
            rows=rows, max_seq=max_seq)
        del state, batch
        launches.update({row: by_kind[kind] for row, (c, _, _, kind)
                         in shapes.items() if c is cfg})

    # ---- (4) float32 parity with the CPU at 2 layers ----
    log(phase="train_vlm_parity", **train_parity(vlm, rows=P))
    torch.cuda.empty_cache()
    log(phase="train_whisper_parity", **train_parity(
        whisper, rows=Se, max_seq=WHISPER_MAX_SEQ))
    torch.cuda.empty_cache()
    return [kernel_entry(row, launches=launches[row], err=rec["max_abs_err"],
                         ms=rec["ms"], plain_ms=rec["plain_ms"],
                         library_ms=rec["library_ms"], bytes_=rec["bytes"],
                         flops=rec["flops"], peak=BWD_PEAK["bfloat16"])
            for row, rec in records.items()]


def scan_backward_work(B, S, H, N, Pd, chunk, *, shared_qk: bool) -> int:
    """Operations the scan's gradient needs on these shapes. Per chunk of
    length c (the last may be short) and c(c+1)/2 causal pairs: 2N for the
    q.k score of each pair, once per batch row when q and k are shared by
    all heads and once per head otherwise; per head, 2Pd for each pair's
    dy.v, 2N each for its terms of dq and dk, 2Pd for its term of dv, and
    8 c N Pd for the four products with a chunk state (dq's, dk's and dv's
    terms and the adjoint state)."""
    score = per_head = 0
    for t0 in range(0, S, chunk):
        c = min(chunk, S - t0)
        pairs = c * (c + 1) // 2
        score += pairs * 2 * N
        per_head += pairs * (4 * Pd + 4 * N) + 8 * c * N * Pd
    return B * (score * (1 if shared_qk else H) + H * per_head)


def scan_backward_bf16_work(B, S, H, N, Pd, chunk) -> int:
    """Operations of the bfloat16 products the backward's bfloat16 kernels
    run on these shapes (csrc/mamba_scan_bwd.cu): per head and causal pair
    one product for each score (dy.v in dq's and dk's kernels, q.k in dv's:
    2Pd + 2Pd + 2N) and two for each pair term (P k, P q, P dy: 2 x (2N +
    2N + 2Pd)), and per head and step two for each product with a chunk
    state and for the adjoint state (2 x 8 N Pd)."""
    work = 0
    for t0 in range(0, S, chunk):
        c = min(chunk, S - t0)
        pairs = c * (c + 1) // 2
        work += pairs * (8 * Pd + 10 * N) + 16 * c * N * Pd
    return B * H * work


def scan_forward_record(q, k, v, la, chunk: int) -> dict:
    """The scan's forward as training runs it (`mamba_scan._launch` with
    `keep=True`: the five kernels keeping each chunk's state and l) at one
    shape, against `_plain_chunks` (y and the kept states within
    SCAN_BWD_TOL of their max |plain| in bfloat16, 2e-4 in float32), timed
    beside it, with its operations (`_scan_work`) and bytes (q, k, v,
    log_a read once; y, the kept states and l written once): `bound_ms`
    with the operations in 3xTF32 at 495 TFLOP/s, the units the kernels
    run them on, and `bound_bf16_ms` at 989 TFLOP/s, the card's rate for
    bfloat16 inputs."""
    import torch
    from repro_torch.kernels.mamba_scan import mamba_scan as KS
    B, S, H, Pd = v.shape
    N, shared = q.shape[3], q.shape[2] != H
    out = KS._launch(q, k, v, la, chunk=chunk, keep=True)
    plain = KS._plain_chunks(q, k, v, la, chunk, None)
    tol = SCAN_BWD_TOL["bfloat16"] if v.dtype == torch.bfloat16 else 2e-4
    err = 0.0
    for i in (0, 2):   # y and the kept states (from a zero state)
        e_ = float((out[i].float() - plain[i].float()).abs().max())
        check(e_ <= tol * float(plain[i].float().abs().max()),
              f"scan forward B{B} S{S} H{H} N{N} Pd{Pd}: output {i} within "
              f"{tol} of max |plain|")
        err = max(err, e_)
    nbytes = q.element_size() * (q.numel() + k.numel() + v.numel()
                                 + out[0].numel()) \
        + 4 * (la.numel() + out[2].numel() + out[3].numel())
    flops = _scan_work(B, S, H, N, Pd, chunk, shared_qk=shared)
    del out, plain
    return {"max_abs_err": err,
            "ms": timed_ms(lambda: KS._launch(q, k, v, la, chunk=chunk,
                                              keep=True)),
            "plain_ms": timed_ms(lambda: KS._plain_chunks(q, k, v, la, chunk,
                                                          None)),
            "flops": flops, "bytes": nbytes,
            "bound_ms": 1e3 * max(nbytes / HBM_BYTES_PER_S,
                                  flops / (TF32_FLOPS / 3)),
            "bound_bf16_ms": 1e3 * max(nbytes / HBM_BYTES_PER_S,
                                       flops / BF16_FLOPS)}


def scan_backward_record(B, S, H, N, Pd, *, shared: bool, dtype, g,
                         chunk: int = 256) -> dict:
    """The scan's backward kernel at one shape (q, k (B, S, H, N) or, shared
    by the heads, (B, S, 1, N); v, dy (B, S, H, Pd)) from the forward
    kernel's kept states: each gradient against
    `mamba_scan_backward_plain` within SCAN_BWD_TOL of its max |plain|,
    two calls the same bits, timed beside the plain version, with the
    device time of each of its CUDA kernels (and of the wrapper's padding
    copies), each kernel's registers, shared memory and CTAs an SM
    (`kernel_occupancy`), its operations (`scan_backward_work`) and bytes
    (q, k, v, dy, the kept states and l read once; dq, dk, dv and dlog_a
    written once): `bound_ms` with the operations in 3xTF32 at 495
    TFLOP/s; in bfloat16 also `bound_bf16_ms`, the bfloat16 products the
    kernels run (`scan_backward_bf16_work`) at 989 TFLOP/s beside the
    bytes. The forward as training runs it at the same shape goes under
    "forward" (`scan_forward_record`, bfloat16 only: the type training
    runs)."""
    import torch
    from repro_torch.kernels.mamba_scan import mamba_scan as KS
    from repro_torch.kernels.mamba_scan import mamba_scan_bwd as KSB
    name = str(dtype).replace("torch.", "")
    label = f"scan backward {name} B{B} S{S} H{H} N{N} Pd{Pd} shared={shared}"
    hq = 1 if shared else H

    def randn(*shape, scale=1.0):
        return (torch.randn(shape, generator=g, device="cuda")
                * scale).to(dtype)
    q, k = randn(B, S, hq, N, scale=N ** -0.5), randn(B, S, hq, N,
                                                      scale=N ** -0.5)
    v, dy = randn(B, S, H, Pd), randn(B, S, H, Pd)
    la = -torch.rand((B, S, H), generator=g, device="cuda") * 0.3
    forward = scan_forward_record(q, k, v, la, chunk) \
        if dtype == torch.bfloat16 else None
    _, _, st, lc = KS._launch(q, k, v, la, chunk=chunk, keep=True)

    def kernel():
        return KSB.mamba_scan_backward(q, k, v, dy, st, lc, chunk=chunk)

    def plain_version():
        return KSB.mamba_scan_backward_plain(q, k, v, dy, st, lc,
                                             chunk=chunk)
    grads, plain = kernel(), plain_version()
    torch.cuda.synchronize()
    names = ("dq", "dk", "dv", "dlog_a")
    errs = {n: float((a.float() - b.float()).abs().max())
            for n, a, b in zip(names, grads, plain)}
    scale = {n: float(b.float().abs().max()) for n, b in zip(names, plain)}
    for n in names:
        tol = SCAN_BWD_TOL["float32" if n == "dlog_a" else name]
        check(errs[n] <= tol * scale[n],
              f"{label}: {n} within {tol} of max |plain|")
    again = kernel()
    check(all(torch.equal(a, b) for a, b in zip(grads, again)),
          f"{label}: two calls give the same bits")
    del plain, again
    ms = timed_ms(kernel)
    plain_ms = timed_ms(plain_version)
    kernels = SCAN_BWD_KERNELS[name]
    by_name = device_ms_by_kernel(kernel, expect=kernels)
    split = {kern: sum(t for n, t in by_name.items() if kern in n)
             for kern in kernels + ("ssd_bwd_kernel_headsum",)}
    padding_ms = sum(t for n, t in by_name.items() if "ssd_bwd_" not in n)
    occupancy = KSB.kernel_occupancy(B, S, H, N, Pd, chunk=chunk,
                                     shared=shared, dtype=dtype)
    check(all(o["ctas_per_sm"] >= 1 for o in occupancy.values()),
          f"{label}: every kernel fits an SM")
    flops = scan_backward_work(B, S, H, N, Pd, chunk, shared_qk=shared)
    nbytes = q.element_size() * 2 * (q.numel() + k.numel() + v.numel()) \
        + v.element_size() * dy.numel() + 4 * (st.numel() + lc.numel()
                                              + B * S * H)
    del q, k, v, dy, la, st, lc, grads
    rec = {"dtype": name, "shape": {"B": B, "S": S, "H": H, "N": N,
                                    "Pd": Pd, "chunk": chunk,
                                    "shared_qk": shared},
           "max_abs_err": max(errs.values()), "max_abs_err_by_grad": errs,
           "max_abs_plain": scale, "ms": ms, "plain_ms": plain_ms,
           "flops": flops, "bytes": nbytes,
           "bound_ms": 1e3 * max(nbytes / HBM_BYTES_PER_S,
                                 flops / (TF32_FLOPS / 3)),
           "bytes_bound_ms": 1e3 * nbytes / HBM_BYTES_PER_S,
           "kernels_ms": split, "kernels_total_ms": sum(split.values()),
           "padding_ms": padding_ms, "occupancy": occupancy,
           "tflops_needed_work": flops / (ms * 1e-3) / 1e12}
    if dtype == torch.bfloat16:
        rec["forward"] = forward
        bf16_flops = scan_backward_bf16_work(B, S, H, N, Pd, chunk)
        rec["bf16_flops"] = bf16_flops
        rec["bound_bf16_ms"] = 1e3 * max(nbytes / HBM_BYTES_PER_S,
                                         bf16_flops / BF16_FLOPS)
    return rec


def slstm_loop_parts(cfg, batch: int, seq: int) -> dict:
    """One sLSTM block's step loop (`ssm.slstm_recurrence`, which training
    differentiates by autograd) at the training step's shapes, in float32
    as the block runs it, its forward and its backward apart: wall ms
    (with a synchronize, median of 2) and device ms by `_kernel_split`
    group (its h r products are cuBLAS batched products)."""
    import torch
    from repro_torch.models import ssm as SS
    H, dh = cfg.n_heads, cfg.d_model // cfg.n_heads
    g = torch.Generator(device="cuda").manual_seed(SEED + 50)

    def leaf(*shape):
        return torch.rand(shape, generator=g,
                          device="cuda").requires_grad_()
    zs, og, ig, fg = (leaf(batch, seq, H, dh), leaf(batch, seq, H, dh),
                      leaf(batch, seq, H), leaf(batch, seq, H))
    r = (torch.randn((H, dh, dh), generator=g, device="cuda")
         * dh ** -0.5).requires_grad_()
    h0 = torch.zeros((batch, H, dh), device="cuda")
    out = {}

    def forward():
        out["ys"] = SS.slstm_recurrence(r, zs, og, ig, fg, h0, h0)[0]

    def backward():
        torch.autograd.grad(out["ys"], (r, zs, og, ig, fg), gy,
                            retain_graph=True)
    rec = {"steps": seq, "batch": batch, "heads": H, "dh": dh}
    rec["forward_wall_ms"] = _wall_ms(forward, reps=2)
    rec["forward_device_ms"] = {k_: v_ for k_, v_ in _kernel_split(
        device_ms_by_kernel(forward)).items() if v_ > 0}
    gy = torch.randn(out["ys"].shape, generator=g, device="cuda")
    rec["backward_wall_ms"] = _wall_ms(backward, reps=2)
    rec["backward_device_ms"] = {k_: v_ for k_, v_ in _kernel_split(
        device_ms_by_kernel(backward)).items() if v_ > 0}
    del out["ys"]
    return rec


def phase_train_ssm():
    """Training the ssm and hybrid families (ROADMAP.md queue 1 item
    5(a)). (1) The scan's backward kernel at the two shapes the steps give
    it, float32 and bfloat16 (`scan_backward_record`, with the forward's
    record at the same shape): zamba2-1.2b's
    Mamba2 (4, 2,048, 64 heads, N = Pd = 64, B and C shared by the heads)
    and xlstm-350m's mLSTM (4, 2,048, 4 heads, N = 512, Pd = 513).
    (2) xlstm-350m at full width and depth (24 blocks: 18 mLSTM, 6
    sLSTM), `train_model`'s TRAIN_XLSTM_STEPS bfloat16 steps of 4 x 2,048
    tokens: 2 x 18 scan forward and 18 scan backward launches a step;
    one sLSTM block's step loop timed apart, forward and backward
    (`slstm_loop_parts`), and the device time of a step on
    TRAIN_XLSTM_TRACE_SEQ tokens a row split with an `slstm_loop` group
    (the 6 blocks' loops, the forward twice under remat). (3) zamba2-1.2b at full width and depth (38 blocks: 32 Mamba2,
    the shared attention block at 6 positions), TRAIN_ZAMBA2_STEPS steps:
    2 x 32 scan forward and 32 backward, 2 x 6 flash forward and 6
    backward launches a step. (4) Float32 parity of each with the CPU at
    full width cut to ("X", "S") and ("M", "A") over TRAIN_CUT_BATCH x
    TRAIN_SSM_CUT_SEQ tokens (`train_parity`)."""
    import gc
    import torch
    from repro_torch.configs import get_arch
    torch.backends.cuda.matmul.allow_tf32 = False  # float32 as float32
    xlstm, zamba2 = get_arch(XLSTM_ARCH), get_arch(LM_ARCH)
    B, S = TRAIN_BATCH, TRAIN_SEQ
    d_x = xlstm.mamba_expand * xlstm.d_model // xlstm.n_heads
    shapes = {   # row -> (model, H, N, Pd, shared)
        "mamba_scan_bwd": (zamba2, zamba2.mamba_expand * zamba2.d_model
                           // zamba2.ssm_head_dim, zamba2.ssm_state,
                           zamba2.ssm_head_dim, True),
        "mamba_scan_bwd_xlstm": (xlstm, xlstm.n_heads, d_x, d_x + 1, False),
    }
    g = torch.Generator(device="cuda")
    g.manual_seed(SEED + 44)

    # ---- (1) the backward kernel at the two shapes ----
    records = {}
    for row, (cfg, H, N, Pd, shared) in shapes.items():
        for dtype in (torch.float32, torch.bfloat16):
            rec = scan_backward_record(B, S, H, N, Pd, shared=shared,
                                       dtype=dtype, g=g,
                                       chunk=cfg.ssm_chunk)
            records[(row, rec["dtype"])] = rec
            log(phase="train_ssm_scan_backward", row=row, arch=cfg.name,
                **rec)
    torch.cuda.empty_cache()

    # ---- (2), (3) full width and depth, bfloat16, counted ----
    infos = {}
    for label, cfg, n_steps, trace in (
            ("train_xlstm", xlstm, TRAIN_XLSTM_STEPS, TRAIN_XLSTM_TRACE_SEQ),
            ("train_zamba2", zamba2, TRAIN_ZAMBA2_STEPS, 0)):
        state, batch, _, _, info = train_model(
            cfg, label=label, batch=B, seq=S, n_steps=n_steps,
            parts=cfg.family == "hybrid", trace_seq=trace)
        infos[cfg.name] = info
        del state, batch
        gc.collect()
        torch.cuda.empty_cache()
    MEASURED["train_zamba2"] = {"peak_gb": infos[zamba2.name]["peak_gb"],
                                "batch": B, "seq": S}
    # the loop at the traced step's length (its split's)
    S_split = infos[xlstm.name]["split_seq"]
    loop = slstm_loop_parts(xlstm, B, S_split)
    n_s = xlstm.block_pattern.count("S")
    reruns = 2 if xlstm.remat else 1     # remat reruns each forward
    loop_ms = {k_: n_s * (reruns * loop["forward_device_ms"].get(k_, 0.0)
                          + loop["backward_device_ms"].get(k_, 0.0))
               for k_ in ("matmul", "other")}
    split = infos[xlstm.name]["split"]
    dev = split["device_ms"]
    # the backward wrapper's padding copies (Pd 513 -> 520) run as generic
    # kernels that the split counts under "other": a step's share is its
    # backward launches (the counted steps' over their number) times one
    # call's padding_ms at the step's shape, scaled to the traced step's
    # length (the copies are linear in the tokens)
    pad_ms = infos[xlstm.name]["launches"]["mamba_scan_bwd"] \
        // TRAIN_XLSTM_STEPS * records[
            ("mamba_scan_bwd_xlstm", "bfloat16")]["padding_ms"] \
        * S_split / S
    by_part = {"cublas_products": dev.get("matmul", 0.0) - loop_ms["matmul"],
               "mamba_scan": dev.get("mamba_scan", 0.0),
               "mamba_scan_bwd": dev.get("mamba_scan_bwd", 0.0),
               "mamba_scan_bwd_padding": pad_ms,
               "slstm_loop": loop_ms["matmul"] + loop_ms["other"],
               "other": dev.get("other", 0.0) - loop_ms["other"] - pad_ms}
    log(phase="train_xlstm_slstm_loop", **loop, blocks=n_s,
        forward_runs_a_step=reruns, step_device_ms_by_part=by_part,
        step_share_by_part={k_: v_ / split["device_total_ms"]
                            for k_, v_ in by_part.items()},
        step_wall_ms=infos[xlstm.name]["wall_ms"],
        traced_step_seq=S_split,
        traced_step_wall_ms=infos[xlstm.name]["split_wall_ms"],
        step_idle_share=split["idle_share"])
    torch.cuda.empty_cache()

    # ---- (4) float32 parity with the CPU at 2 blocks ----
    log(phase="train_xlstm_parity", **train_parity(
        xlstm, seq=TRAIN_SSM_CUT_SEQ, pattern=("X", "S")))
    torch.cuda.empty_cache()
    log(phase="train_zamba2_parity", **train_parity(
        zamba2, seq=TRAIN_SSM_CUT_SEQ, pattern=("M", "A")))
    torch.cuda.empty_cache()
    # the `kernels` rows at the bfloat16 rate, the main path's type: the
    # backward with the bfloat16 products its kernels run (the 3xTF32
    # bound stays in its record, `bound_ms`), the forward with its
    # operations (it runs them in 3xTF32: `bound_ms` of its record)
    out = []
    for row, (cfg, *_) in shapes.items():
        rec = records[(row, "bfloat16")]
        out.append(kernel_entry(
            row, launches=infos[cfg.name]["launches"]["mamba_scan_bwd"],
            err=rec["max_abs_err"], ms=rec["ms"], plain_ms=rec["plain_ms"],
            library_ms=None, bytes_=rec["bytes"], flops=rec["bf16_flops"],
            peak=BF16_FLOPS))
        fwd = rec["forward"]
        out.append(kernel_entry(
            row.replace("mamba_scan_bwd", "mamba_scan_train"),
            launches=infos[cfg.name]["launches"]["mamba_scan"],
            err=fwd["max_abs_err"], ms=fwd["ms"], plain_ms=fwd["plain_ms"],
            library_ms=None, bytes_=fwd["bytes"], flops=fwd["flops"],
            peak=BF16_FLOPS))
    return out


def capacity_buffer_backward(x, wi, wg, wo, plan, dy):
    """The yardstick of the expert FFN's backward: autograd of
    `capacity_buffer_moe`'s form (kept entries gathered into an (E, C, D)
    buffer, C the plan's largest capacity, three float32 `torch.bmm`, the
    weighted scatter-add back), its forward built once. Returns (run,
    grads): run() computes the gradients of x, wi, wg, wo and the kept
    entries' weights given dy, keeping the graph; grads is its first
    result."""
    import torch
    E, D = wi.shape[0], x.shape[1]
    C = int(plan.cap.max())
    k = plan.keep
    at = torch_index(plan.expert[k].astype(np.int64) * C + plan.pos[k])
    tok = torch_index(plan.token[k])
    leaves = [t.detach().requires_grad_(True) for t in (
        x, wi, wg, wo, torch.from_numpy(plan.weight[k]).cuda())]
    xl, wil, wgl, wol, wtl = leaves
    buf = torch.zeros((E * C, D), device="cuda").index_put(
        (at,), xl[tok]).view(E, C, D)
    a = torch.nn.functional.silu(torch.bmm(buf, wgl)) * torch.bmm(buf, wil)
    yb = torch.bmm(a, wol).view(E * C, D)
    y = torch.zeros_like(xl).index_add(0, tok, yb[at] * wtl[:, None])

    def run():
        return torch.autograd.grad(y, leaves, dy, retain_graph=True)
    return run, run()


def moe_backward_record(cfg, cap_scale, g, sm_count) -> tuple:
    """Rows 7c and `ich_moe_bwd`: the expert kernel and its backward at
    olmoe-1b-7b's training shape, one MoE layer of a step of TRAIN_BATCH
    x TRAIN_SEQ tokens: N(0, 1) rows routed by a full-width layer's router
    (seeded), planned at capacity under `cap_scale` (E,) with the steal
    round and lowered at p = SM count, as `moe_local` does in training.
    The forward against its plain version (MOE_TOL, cost streams equal),
    timed beside it and the capacity-buffer bmm. The backward
    (`ich_moe_backward` over the plan's CSR, the forward's token -> slots
    index, a N(0, 1) dy) against its plain version, each output within
    MOE_BWD_TOL of its max |plain|; two calls the same bits; through
    `MoeExpertsFn` over the lowerings at p = SM count and p = 2 the same
    bits (y and every gradient); timed beside the plain version and the
    capacity-buffer form's autograd backward, with the device time of
    each of its CUDA kernels (`device_ms_by_kernel`: the fused up and v
    product, dx_s, the two weight-gradient launches, the token fold, the
    dw fold), the bound of its three bfloat16 passes (`bound_split_ms`)
    beside the 3xTF32 `bound_ms`, and the TFLOP/s of the split products
    (all three passes: x and dy are float32 here) of the call and of
    each product kernel. Then (`bf16`) x and dy rounded to bfloat16, as
    training gives them: the call with them in bfloat16 (the kernels
    leave out the passes of their zero lo parts) the same bits as the
    call with their float32 casts (every pass), within MOE_BWD_TOL of the
    plain version, both timed and traced by kernel. Returns (forward
    record, backward record)."""
    import torch
    from repro_torch.kernels.ich_moe import ich_moe as KM
    from repro_torch.kernels.ich_moe import ich_moe_bwd as KMB
    from repro_torch.models import moe as MOE
    from repro_torch.sched import LoopScheduler, plan_dispatch
    T, D, F = TRAIN_BATCH * TRAIN_SEQ, cfg.d_model, cfg.moe_d_ff
    E, K = cfg.n_experts, cfg.experts_per_token
    p = MOE.MoE(cfg, g, "cuda")
    x = torch.randn((TRAIN_BATCH, TRAIN_SEQ, D), generator=g, device="cuda")
    _, w_topk, e_topk = MOE.route(p, x, K)
    x = x.reshape(T, D)
    plan = plan_dispatch(e_topk.cpu().numpy(), w_topk.cpu().numpy(),
                         cap_scale=cap_scale)
    check(plan.dropped > 0 and plan.stolen > 0,
          "training-shape plan: entries dropped and stolen")
    ops = {q: LoopScheduler(p=q, cache_size=0).build("moe-dispatch", plan)
           for q in (sm_count, 2)}
    op = ops[sm_count]
    kept = int(plan.counts.sum())
    shape = {"tokens": T, "experts": E, "top_k": K, "d_model": D,
             "expert_ff": F, "kept": kept, "dropped": plan.dropped,
             "stolen": plan.stolen, "cap_min": int(plan.cap.min()),
             "cap_max": int(plan.cap.max()),
             "load_max": int(plan.counts.max()), "p": op.p,
             "tiles": op.n_tiles, "width": op.schedule.width}

    # ---- row 7c: the forward ----
    fargs = (op.vals, op.cols, op.rowid, op.blkid, x, p.wi, p.wg, p.wo,
             op.p, op.superstep, op.slots)
    y_k, c_k, e_k = KM.ich_moe_sharded(*fargs, slot_cost=op.slot_cost)
    y_p, c_p, e_p = KM.ich_moe_sharded_plain(*fargs, slot_cost=op.slot_cost)
    check(torch.allclose(y_k, y_p, rtol=MOE_TOL, atol=MOE_TOL),
          "training-shape MoE kernel == plain")
    check(torch.equal(c_k, c_p) and torch.equal(e_k, e_p),
          "training-shape MoE cost streams == plain")
    f_err = float((y_k - y_p).abs().max())
    library, C = capacity_buffer_moe(x, p.wi, p.wg, p.wo, plan)
    check(torch.allclose(library(), y_k, rtol=MOE_TOL, atol=MOE_TOL),
          "training-shape capacity-buffer bmm y agrees")
    del y_k, c_k, e_k, y_p, c_p, e_p
    f_bytes = sum(t.numel() * t.element_size() for t in (
        op.vals, op.cols, op.rowid, op.blkid, op.slot_cost, x, p.wi, p.wg,
        p.wo, *op.slots)) + (T * D + op.p * (op.shards.n_steps + E)) * 4
    fwd = {**shape, "max_abs_err": f_err, "library_capacity": C,
           "ms": timed_ms(lambda: KM.ich_moe_sharded(
               *fargs, slot_cost=op.slot_cost)),
           "plain_ms": timed_ms(lambda: KM.ich_moe_sharded_plain(
               *fargs, slot_cost=op.slot_cost)),
           "library_ms": timed_ms(library), "flops": 6 * D * F * kept,
           "bytes": f_bytes}
    fwd["bound_ms"] = 1e3 * max(fwd["bytes"] / HBM_BYTES_PER_S,
                                fwd["flops"] / (TF32_FLOPS / 3))
    del library

    # ---- the backward ----
    indptr, entry = plan.csr_entries()
    entry_t = torch_index(entry)
    indptr_t = torch.from_numpy(indptr.astype(np.int32)).cuda()
    dy = torch.randn((T, D), generator=g, device="cuda")
    args = (x, dy, p.wi, p.wg, p.wo, indptr_t, (entry_t // K).int(),
            w_topk.reshape(-1)[entry_t].contiguous(), op.slots.tok_ptr,
            op.slots.tok_slot)
    names = ("dx", "dwi", "dwg", "dwo", "dw")
    got = KMB.ich_moe_backward(*args)
    plain = KMB.ich_moe_backward_plain(*args)
    errs = {n: float((a - b).abs().max()) for n, a, b in
            zip(names, got, plain)}
    scale = {n: float(b.abs().max()) for n, b in zip(names, plain)}
    for n in names:
        check(errs[n] <= MOE_BWD_TOL * scale[n],
              f"expert backward: {n} within {MOE_BWD_TOL} of max |plain|")
    del plain
    again = KMB.ich_moe_backward(*args)
    check(all(torch.equal(a, b) for a, b in zip(got, again)),
          "expert backward: two calls give the same bits")
    del again
    for n in ("dwi", "dwg", "dwo"):
        dead = plan.counts == 0
        check(not dead.any() or not bool(
            got[names.index(n)][torch_index(np.flatnonzero(dead))].any()),
            f"expert backward: {n} zero for an expert with no kept slot")

    def through(op_):
        leaves = [t.detach().requires_grad_(True)
                  for t in (x, w_topk, p.wi, p.wg, p.wo)]
        y = MOE.MoeExpertsFn.apply(*leaves, op_, entry_t, indptr_t)
        return [y.detach(), *torch.autograd.grad(y, leaves, dy)]
    lowered = through(ops[sm_count])
    check(all(torch.equal(a, b) for a, b in zip(lowered, through(ops[2]))),
          f"expert backward: the same bits at p = {sm_count} and p = 2")
    check(torch.equal(lowered[1], got[0]),
          "expert backward: the Function's dx is the kernel's")
    del lowered
    run, lib = capacity_buffer_backward(x, p.wi, p.wg, p.wo, plan, dy)
    lib_diff = {n: float((a - b).abs().max()) / scale[n] for n, a, b in
                zip(("dx", "dwi", "dwg", "dwo"), got, lib)}
    check(max(lib_diff.values()) <= MOE_BWD_TOL,
          "capacity-buffer backward agrees")
    del lib, got
    ms = timed_ms(lambda: KMB.ich_moe_backward(*args))
    plain_ms = timed_ms(lambda: KMB.ich_moe_backward_plain(*args))
    library_ms = timed_ms(run)
    del run
    expect = ("moe_bwd_upv", "moe_bwd_dweights")
    by_name = device_ms_by_kernel(lambda: KMB.ich_moe_backward(*args),
                                  expect=expect)
    flops = KMB.backward_flops(kept, D, F)

    # ---- bfloat16 x and dy: the passes of their lo parts left out ----
    args_b = (x.bfloat16(), dy.bfloat16(), *args[2:])
    args_f = (args_b[0].float(), args_b[1].float(), *args[2:])
    skip = KMB.ich_moe_backward(*args_b)
    full = KMB.ich_moe_backward(*args_f)
    check(all(torch.equal(a, b) for a, b in zip(skip, full)),
          "expert backward: bfloat16 x and dy, the same bits as every pass")
    del full
    plain = KMB.ich_moe_backward_plain(*args_f)
    errs_b = {n: float((a - b).abs().max()) / float(b.abs().max())
              for n, a, b in zip(names, skip, plain)}
    check(max(errs_b.values()) <= MOE_BWD_TOL,
          f"expert backward, bfloat16 x and dy: within {MOE_BWD_TOL} of "
          "max |plain|")
    del skip, plain
    # the passes run: x's and dy's products (up, v, dwi, dwg, dwo: 12 of
    # the 16 D F a slot) two, dx's three
    bf16 = {"rel_err_by_output": errs_b,
            "ms": timed_ms(lambda: KMB.ich_moe_backward(*args_b)),
            "full_passes_ms": timed_ms(lambda: KMB.ich_moe_backward(*args_f)),
            "device_ms_by_kernel": _moe_bwd_kernels(device_ms_by_kernel(
                lambda: KMB.ich_moe_backward(*args_b), expect=expect)),
            "full_passes_device_ms_by_kernel": _moe_bwd_kernels(
                device_ms_by_kernel(lambda: KMB.ich_moe_backward(*args_f),
                                    expect=expect)),
            "bound_split_ms": 1e3 * (2 * 12 + 3 * 4) / 16 * flops
            / BF16_FLOPS}
    del args_b, args_f
    by_kernel = _moe_bwd_kernels(by_name)
    # each float32 product runs as three bfloat16 passes; the kernels'
    # share of the 16 D F a slot: up and v 6, dx 4, dwi + dwg 4, dwo 2
    split = {"upv": 6, "dx": 4, "dweights_in": 4, "dweights_out": 2}
    split_tflops = {k_: 3 * n * D * F * kept / (by_kernel[k_] * 1e-3) / 1e12
                    for k_, n in split.items() if by_kernel[k_] > 0}
    nbytes = 4 * (3 * T * D + 6 * E * D * F + 2 * kept) \
        + sum(t.numel() * t.element_size() for t in args[5:7] + args[8:])
    bwd = {**shape, "max_abs_err": max(errs.values()),
           "max_abs_err_by_output": errs, "max_abs_plain": scale,
           "library_rel_diff": lib_diff, "ms": ms, "plain_ms": plain_ms,
           "library_ms": library_ms, "device_ms": by_name,
           "device_ms_by_kernel": by_kernel,
           "device_total_ms": sum(by_name.values()), "flops": flops,
           "bytes": nbytes,
           "bound_ms": 1e3 * max(nbytes / HBM_BYTES_PER_S,
                                 flops / (TF32_FLOPS / 3)),
           "bound_split_ms": 1e3 * 3 * flops / BF16_FLOPS,
           "float32_cuda_core_ms": 1e3 * flops / F32_FLOPS,
           "tflops": flops / (ms * 1e-3) / 1e12,
           "split_tflops": 3 * flops / (ms * 1e-3) / 1e12,
           "split_tflops_by_kernel": split_tflops, "bf16": bf16}
    del x, dy, args, p, ops, op, fargs
    return fwd, bwd


def phase_train_moe():
    """Training the moe family (ROADMAP.md queue 1 item 5(b)). (1) The
    expert kernel (row 7c) and its backward at olmoe-1b-7b's training
    shape (`moe_backward_record`): 8,192 tokens, 64 experts top-8, D
    2,048, F 1,024, at capacity with the steal round under the first MoE
    layer's drawn capacity scales. (2) olmoe-1b-7b at full width cut to
    TRAIN_MOE_LAYERS layers (`train_model`): TRAIN_MOE_STEPS bfloat16
    steps of 4 x 2,048 tokens from the state's capacity scales of ones,
    2 expert kernel and 1 expert backward launch a MoE layer a step
    (remat reruns the forward), entries dropped and stolen in at least
    one step. (3) Float32 parity with the CPU at
    TRAIN_CUT_LAYERS layers for olmoe-1b-7b (two MoE layers) and
    deepseek-moe-16b (its dense first layer, then one MoE layer with
    shared experts), each from the same drawn scales (`train_parity`,
    without its AdamW part)."""
    import dataclasses
    import gc
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.models import model as M
    torch.backends.cuda.matmul.allow_tf32 = False  # float32 as float32
    sm_count = torch.cuda.get_device_properties(0).multi_processor_count
    olmoe = get_arch(MOE_ARCH)
    cut = dataclasses.replace(olmoe, n_layers=TRAIN_MOE_LAYERS)
    caps = np.random.default_rng(SEED + 50).uniform(
        *TRAIN_MOE_CAP_RANGE, (M.n_moe_layers(cut), cut.n_experts)
    ).astype(np.float32)
    g = torch.Generator(device="cuda")
    g.manual_seed(SEED + 51)

    # ---- (1) the expert kernel and its backward at the training shape ----
    t0 = time.perf_counter()
    fwd, bwd = moe_backward_record(olmoe, caps[0], g, sm_count)
    log(phase="train_moe_ffn_forward", **fwd)
    log(phase="train_moe_ffn_backward", **bwd,
        seconds=time.perf_counter() - t0)
    gc.collect()
    torch.cuda.empty_cache()

    # ---- (2) olmoe-1b-7b at full width, bfloat16, counted ----
    t0 = time.perf_counter()
    state, batch, _, _, info = train_model(
        cut, label="train_olmoe", batch=TRAIN_BATCH, seq=TRAIN_SEQ,
        n_steps=TRAIN_MOE_STEPS, parts=False)
    steps = info["steps"]
    check(any(s_["dropped"] > 0 for s_ in steps)
          and any(s_["stolen"] > 0 for s_ in steps),
          "train_olmoe: entries dropped and stolen in a step")
    split = info["split"]
    log(phase="train_olmoe_summary", layers=cut.n_layers,
        step_wall_ms=info["wall_ms"],
        tokens_per_s=TRAIN_BATCH * TRAIN_SEQ / (info["wall_ms"] * 1e-3),
        traced_step_device_ms=split["device_total_ms"],
        traced_step_idle_share=split["idle_share"],
        peak_gb=info["peak_gb"],
        free_gb_at_peak=torch.cuda.get_device_properties(0).total_memory
        / 1e9 - info["peak_gb"],
        per_step=[{k_: s_[k_] for k_ in (
            "step", "wall_ms", "loss", "aux_loss", "dropped", "stolen",
            "entries", "cap_scales_moved", "moe_forward", "moe_backward")}
            for s_ in steps], seconds=time.perf_counter() - t0)
    del state, batch
    gc.collect()
    torch.cuda.empty_cache()

    # ---- (3) float32 parity with the CPU at 2 layers (AdamW given
    # identical gradients is held by phase_train's parity: not again) ----
    for label, arch, seq in (
            ("train_olmoe_parity", olmoe, TRAIN_OLMOE_PARITY_SEQ),
            ("train_deepseek_parity", get_arch(DEEPSEEK_ARCH),
             TRAIN_CUT_SEQ)):
        t0 = time.perf_counter()
        rec = train_parity(arch, cap_scales=caps, update=False, seq=seq)
        log(phase=label, **rec, seconds=time.perf_counter() - t0)
        torch.cuda.empty_cache()
    # the forward at the 3xTF32 rate it runs, as rows 7-9; the backward
    # with the three bfloat16 passes its kernels run on float32 x and dy
    # (the 3xTF32 bound stays in its record, `bound_ms`, and beside)
    return [kernel_entry(
        "ich_moe_sharded_train",
        launches=info["launches"]["ich_moe_sharded"], err=fwd["max_abs_err"],
        ms=fwd["ms"], plain_ms=fwd["plain_ms"], library_ms=fwd["library_ms"],
        bytes_=fwd["bytes"], flops=fwd["flops"], peak=TF32_FLOPS / 3),
        kernel_entry(
        "ich_moe_bwd", launches=info["launches"]["ich_moe_bwd"],
        err=bwd["max_abs_err"], ms=bwd["ms"], plain_ms=bwd["plain_ms"],
        library_ms=bwd["library_ms"], bytes_=bwd["bytes"],
        flops=3 * bwd["flops"], peak=BF16_FLOPS)
        | {"bound_3xtf32_ms": bwd["bound_ms"]}]


def _state_differs(a, b) -> list:
    """The names of the leaves of train states a and b whose bits
    differ."""
    import torch
    from repro_torch.train import checkpoint as CKPT
    return [n for (n, x), (_, y) in zip(CKPT.state_leaves(a),
                                        CKPT.state_leaves(b))
            if not torch.equal(x, y)]


def mesh_step_bits(cfg, caps, dist) -> dict:
    """(i) `make_train_step(cfg, tcfg, dist)` over a one-rank mesh against
    `make_train_step(cfg, tcfg)`: TRAIN_MESH_STEPS bfloat16 steps of the
    same `Pipeline` batches from the same state (seed, `caps`): every
    metric, every state leaf (parameters, moments, step) and the capacity
    scales the same bits. Each path's kernel launches are counted from
    its own steps alone (reset just before each step, read just after).
    Then each path's step once more, traced (`_split_log`, against the
    median wall of the steps after the first, which warms the card up).
    Logs each step's wall ms and the ms its kernels run on the card."""
    import gc
    import torch
    from repro_torch.data.pipeline import Pipeline
    from repro_torch.kernels.flash_attention import flash_attention as KF
    from repro_torch.kernels.flash_attention import flash_attention_bwd as KB
    from repro_torch.kernels.ich_moe import ich_moe as KM
    from repro_torch.kernels.ich_moe import ich_moe_bwd as KMB
    from repro_torch.optim import adamw
    from repro_torch.train import train_step as TS
    kernels = (KF, KB, KM, KMB)
    tcfg = TS.TrainConfig(opt=adamw.AdamWConfig(
        warmup_steps=2, total_steps=TRAIN_MESH_STEPS))
    runs = {}
    for label, d in (("unmeshed", None), ("meshed", dist)):
        state = TS.init_train_state(cfg, SEED, tcfg=tcfg, device="cuda",
                                    dist=d)
        state["cap_scales"].copy_(torch.from_numpy(caps))
        runs[label] = {"state": state, "dist": d,
                       "step": TS.make_train_step(cfg, tcfg, d),
                       "metrics": [], "wall_ms": [], "launches": {}}
    pipe = Pipeline(cfg, TRAIN_BATCH, TRAIN_SEQ, seed=SEED, device="cuda")
    try:
        for t in range(TRAIN_MESH_STEPS):
            batch_np, _ = pipe.get_batch(t)
            for run in runs.values():
                batch = {k_: torch.from_numpy(v_) for k_, v_ in
                         TS.batch_shard(batch_np, run["dist"]).items()}
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                batch = {k_: v_.cuda() for k_, v_ in batch.items()}
                # each path's launches counted from its own steps alone
                for mod in kernels:
                    mod.reset_launches()
                run["state"], m = run["step"](run["state"], batch)
                torch.cuda.synchronize()
                run["wall_ms"].append((time.perf_counter() - t0) * 1e3)
                for mod in kernels:
                    for k_, v_ in mod.LAUNCHES.items():
                        run["launches"][k_] = run["launches"].get(k_, 0) + v_
                run["metrics"].append(m)
                run["batch"] = batch
    finally:
        pipe.close()
    launches = {k_: r["launches"] for k_, r in runs.items()}
    a, b = runs["unmeshed"], runs["meshed"]
    metrics_differ = [f"{k_} step {t}" for t in range(TRAIN_MESH_STEPS)
                      for k_ in a["metrics"][t]
                      if not torch.equal(a["metrics"][t][k_],
                                         b["metrics"][t][k_])]
    leaves_differ = _state_differs(a["state"], b["state"])
    n_moe = TRAIN_MESH_LAYERS
    rec = {"layers": cfg.n_layers, "steps": TRAIN_MESH_STEPS,
           "batch": TRAIN_BATCH, "seq": TRAIN_SEQ,
           "losses": {k_: [float(m["loss"]) for m in r["metrics"]]
                      for k_, r in runs.items()},
           "dropped": [float(m["dropped"]) for m in a["metrics"]],
           "stolen": [float(m["stolen"]) for m in a["metrics"]],
           "metrics_differ": metrics_differ, "leaves_differ": leaves_differ,
           "launches": launches}
    check(not metrics_differ and not leaves_differ,
          "train_mesh: the one-rank meshed step gives the unmeshed step's "
          "bits (metrics, every leaf, the capacity scales)")
    # remat runs a layer's forward twice, its backward once
    want = {"flash_attention": 2 * n_moe * TRAIN_MESH_STEPS,
            "flash_attention_bwd": n_moe * TRAIN_MESH_STEPS,
            "ich_moe_sharded": 2 * n_moe * TRAIN_MESH_STEPS,
            "ich_moe_bwd": n_moe * TRAIN_MESH_STEPS}
    for label, got in launches.items():
        check(got == want, f"train_mesh: the {label} path's steps launch "
              "flash and the expert kernel twice and each backward once a "
              "layer a step")
    check(any(d_ > 0 for d_ in rec["dropped"])
          and any(s_ > 0 for s_ in rec["stolen"]),
          "train_mesh: entries dropped and stolen in a step")
    for label, run in runs.items():
        rec[f"{label}_step_wall_ms"] = run["wall_ms"]
        split = _split_log(
            f"train_mesh_{label}_step_split",
            lambda run=run: run["step"](run["state"], run["batch"]),
            float(np.median(run["wall_ms"][1:])), expect=("moe_bwd_",))
        rec[f"{label}_step_device_ms"] = split["device_total_ms"]
        rec[f"{label}_step_idle_share"] = split["idle_share"]
    del runs, a, b
    gc.collect()
    torch.cuda.empty_cache()
    return rec


def ep_rank_by_rank(cfg, cap_scale, g) -> dict:
    """(ii) Expert parallelism rank by rank in one process at full width:
    TRAIN_BATCH x TRAIN_SEQ float32 tokens routed once over all E experts
    at capacity with the steal round (`cap_scale`), then for each tp of
    TRAIN_MESH_TP the sum over r of `moe_local(..., n_local_experts=E/tp,
    local_expert_offset=r E/tp)` with those experts' weights (what model
    rank r computes) against tp = 1 within EP_Y_TOL of max |y|, and the
    gradients of x, the combine weights and the experts (`MoeExpertsFn`,
    the backward kernel) summed and stacked the same way within
    EP_GRAD_TOL of each one's max. The expert kernel and its backward
    launch once for every rank, counted for each tp apart."""
    import torch
    from repro_torch.kernels.ich_moe import ich_moe as KM
    from repro_torch.kernels.ich_moe import ich_moe_bwd as KMB
    from repro_torch.models import moe as MOE
    E, K, D = cfg.n_experts, cfg.experts_per_token, cfg.d_model
    p = MOE.MoE(cfg, g, "cuda")
    x = torch.randn((TRAIN_BATCH, TRAIN_SEQ, D), generator=g, device="cuda")
    probs, w_topk, e_topk = MOE.route(p, x, K)
    x = x.reshape(-1, D)
    dy = torch.randn(x.shape, generator=g, device="cuda")
    cap = torch.from_numpy(cap_scale).cuda()

    def ranks(tp):
        e_loc = E // tp
        ys, grads = [], []
        for r in range(tp):
            cut = slice(r * e_loc, (r + 1) * e_loc)
            leaves = [x.clone().requires_grad_(),
                      w_topk.detach().clone().requires_grad_(),
                      *(w[cut].clone().requires_grad_()
                        for w in (p.wi, p.wg, p.wo))]
            y, _ = MOE.moe_local(cfg, p, leaves[0], cap,
                                 routing=(probs, leaves[1], e_topk),
                                 n_local_experts=e_loc,
                                 local_expert_offset=r * e_loc,
                                 experts=tuple(leaves[2:]))
            ys.append(y.detach())
            grads.append(torch.autograd.grad(y, leaves, dy))
        return (sum(ys[1:], ys[0]),
                {"x": sum(g_[0] for g_ in grads),
                 "w_topk": sum(g_[1] for g_ in grads),
                 **{n: torch.cat([g_[i] for g_ in grads])
                    for i, n in ((2, "wi"), (3, "wg"), (4, "wo"))}})

    def counted(tp):
        # launches counted from this tp's ranks alone
        KM.reset_launches()
        KMB.reset_launches()
        out = ranks(tp)
        launches = {"ich_moe_sharded": KM.LAUNCHES["ich_moe_sharded"],
                    "ich_moe_bwd": KMB.LAUNCHES["ich_moe_bwd"]}
        rec["launches"][f"tp{tp}"] = launches
        check(launches == {"ich_moe_sharded": tp, "ich_moe_bwd": tp},
              f"ep rank by rank: at tp {tp} the expert kernel and its "
              "backward launch once a rank")
        return out

    rec = {"tokens": x.shape[0], "experts": E, "top_k": K, "d_model": D,
           "expert_ff": cfg.moe_d_ff, "launches": {}}
    y1, g1 = counted(1)
    for tp in TRAIN_MESH_TP:
        y, grads = counted(tp)
        y_share = float((y - y1).abs().max() / y1.abs().max())
        g_share = {n: float((grads[n] - g1[n]).abs().max()
                            / g1[n].abs().max()) for n in g1}
        rec[f"tp{tp}"] = {"y_share": y_share, "grad_share": g_share}
        check(y_share <= EP_Y_TOL,
              f"ep rank by rank: y at tp {tp} within {EP_Y_TOL} of max |y|")
        check(all(v_ <= EP_GRAD_TOL for v_ in g_share.values()),
              f"ep rank by rank: gradients at tp {tp} within {EP_GRAD_TOL}")
    return rec


def launcher_runs() -> dict:
    """(iii) The command-line launchers on the card: `python -m
    repro_torch.launch.train --arch olmoe-1b-7b --preset tiny --steps 2`
    (checkpoints under build/) and `launch.serve --arch qwen2-1.5b
    --preset tiny`, each in a process of its own: exit 0, the last line
    as the reference prints it."""
    import shutil
    import subprocess
    root = Path(__file__).resolve().parent
    ckpt = root / "build" / "launch_train_ckpt"
    shutil.rmtree(ckpt, ignore_errors=True)
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(root / "src"), os.environ.get("PYTHONPATH", "")]))
    out = {}
    for name, args in (
            ("train", ["--arch", "olmoe-1b-7b", "--preset", "tiny",
                       "--steps", "2", "--ckpt-dir", str(ckpt)]),
            ("serve", ["--arch", "qwen2-1.5b", "--preset", "tiny"])):
        t0 = time.perf_counter()
        r = subprocess.run(
            [sys.executable, "-m", f"repro_torch.launch.{name}", *args],
            capture_output=True, text=True, timeout=600, env=env,
            cwd=str(root))
        lines = r.stdout.strip().splitlines()
        out[name] = {"rc": r.returncode, "last_line": lines[-1] if lines
                     else "", "seconds": time.perf_counter() - t0}
        if r.returncode != 0:
            print(r.stderr[-4000:], file=sys.stderr)
        check(r.returncode == 0 and lines
              and lines[-1].startswith(f"[{name}]"),
              f"launch.{name} exits 0 on the card with its line")
    shutil.rmtree(ckpt, ignore_errors=True)
    return out


def phase_train_mesh():
    """Training over a torch.distributed mesh (ROADMAP.md queue 1 item
    6a) at olmoe-1b-7b's full width (D 2,048, 64 experts top-8, F 1,024)
    cut to TRAIN_MESH_LAYERS layers, bfloat16, capacity scales drawn in
    TRAIN_MOE_CAP_RANGE: (i) `make_smoke_mesh()` (a 1 x 1 ("data",
    "model") mesh over the card, NCCL) and `make_train_step` with its
    `DistContext` for TRAIN_MESH_STEPS steps of TRAIN_BATCH x TRAIN_SEQ
    tokens against the unmeshed step, bit for bit (`mesh_step_bits`);
    (ii) expert parallelism rank by rank in one process
    (`ep_rank_by_rank`); (iii) the launchers (`launcher_runs`). Several
    cards are not driven here: one card holds one NCCL rank."""
    import dataclasses
    import torch
    import torch.distributed as tdist
    from repro_torch.configs import get_arch
    from repro_torch.device import card_identity
    from repro_torch.launch.mesh import make_smoke_mesh
    from repro_torch.models import model as M
    from repro_torch.launch.mesh import DistContext
    torch.backends.cuda.matmul.allow_tf32 = False  # float32 as float32
    cfg = dataclasses.replace(get_arch(MOE_ARCH),
                              n_layers=TRAIN_MESH_LAYERS)
    caps = np.random.default_rng(SEED + 60).uniform(
        *TRAIN_MOE_CAP_RANGE, (M.n_moe_layers(cfg), cfg.n_experts)
    ).astype(np.float32)
    g = torch.Generator(device="cuda")
    g.manual_seed(SEED + 61)
    t0 = time.perf_counter()
    mesh = make_smoke_mesh()
    try:
        dist = DistContext(mesh)
        log(phase="train_mesh_setup", mesh=list(mesh.mesh.shape),
            axes=list(mesh.mesh_dim_names), backend=tdist.get_backend(),
            card=card_identity(), seconds=time.perf_counter() - t0)
        t0 = time.perf_counter()
        log(phase="train_mesh_bits", **mesh_step_bits(cfg, caps, dist),
            card=card_identity(), seconds=time.perf_counter() - t0)
    finally:
        tdist.destroy_process_group()
    t0 = time.perf_counter()
    log(phase="train_mesh_ep_rank_by_rank",
        **ep_rank_by_rank(cfg, caps[0], g), seconds=time.perf_counter() - t0)
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    log(phase="train_mesh_launchers", **launcher_runs(),
        seconds=time.perf_counter() - t0)
    return []


def tp_rank_views(dist, tp: int) -> list:
    """`dist` (a `DistContext` over the 1 x 1 NCCL mesh) seen as each rank
    r < tp of a model axis `tp` ranks wide: `size` counts tp ranks over
    it, `index` gives r, and its group stays the one-rank group, whose
    collectives return their input. So the port's tensor-parallel code
    runs one rank at a time on the card, each rank's `from_model` and
    all-reduces leaving its partial result, which the caller sums over
    the ranks."""
    import dataclasses
    from repro_torch.launch.mesh import DistContext

    @dataclasses.dataclass(frozen=True)
    class RankView(DistContext):
        ranks: int = 1
        rank: int = 0

        def size(self, axes) -> int:
            n = super().size(axes)
            return n * self.ranks if self.tp_axis in self._key(axes) else n

        def index(self, axes) -> int:
            if self._key(axes) == (self.tp_axis,):
                return self.rank
            return super().index(axes)

    return [RankView(dist.mesh, groups=dict(dist.groups), ranks=tp, rank=r)
            for r in range(tp)]


def tp_rank_by_rank(cfg, g, dist, device="cuda") -> dict:
    """(i) Tensor parallelism rank by rank in one process at `cfg`'s full
    width, TP_LAYERS layers, TRAIN_BATCH x TRAIN_SEQ float32 tokens,
    through the port's own tensor-parallel code: for each tp of TP_RANKS
    and each rank r (`tp_rank_views`), the layers and the token table are
    cut to r's shards by `layers.shard_module` at the placements'
    axes (`attention_pspec`, `mlp_pspec`, `embeddings_pspec`), and
    `layers.embed_tokens`, `model._train_layer` (r's query heads through
    the flash kernel, whole KV heads mapped by `kv_for` where they do not
    divide tp, r's MLP columns and rows), `layers.lm_logits` (r's
    vocabulary slice) and `model._ce` run with r's view, the model axis's
    collectives replayed across the ranks (`ReplayedModelAxis`): the
    partial outputs summed by `from_model`, the CE's log-sum-exp merged
    by `_ce`, the gradients summed by `to_model`. Against the unmeshed
    modules: the embeddings, each layer's output and the CE within
    TP_Y_TOL of their max on every rank, every gradient (a split leaf's
    shards against `DistContext.shard` of the whole gradient, a whole
    leaf against the whole gradient) within TP_GRAD_TOL of its max;
    flash and flash backward launch once a layer on each rank."""
    import copy
    import dataclasses
    import torch
    from repro_torch.kernels.flash_attention import flash_attention as KF
    from repro_torch.kernels.flash_attention import flash_attention_bwd as KB
    from repro_torch.models import attention as A
    from repro_torch.models import layers as L
    from repro_torch.models import model as M
    cut = dataclasses.replace(cfg, n_layers=TP_LAYERS)
    H, Hkv, F = cut.n_heads, cut.n_kv_heads, cut.d_ff
    layers = [M.AttnBlock(cut, g, device) for _ in range(TP_LAYERS)]
    embed = L.Embed(cut, g, device)
    for p in layers:            # the qkv biases drawn, not zeros
        for leaf in ("bq", "bk", "bv"):
            if hasattr(p.attn, leaf):
                getattr(p.attn, leaf).copy_(0.1 * torch.randn(
                    getattr(p.attn, leaf).shape, generator=g, device=device))
    modules = [embed] + layers
    for m in modules:
        m.requires_grad_(True)
    tokens = torch.randint(0, cut.vocab_size, (TRAIN_BATCH, TRAIN_SEQ),
                           generator=g, device=device)
    dys = [torch.randn((TRAIN_BATCH, TRAIN_SEQ, cut.d_model), generator=g,
                       device=device) for _ in range(TP_LAYERS)]
    labels = tokens[0].roll(-1)     # the CE on the first row's tokens

    def forward(e, ls, view):
        """The outputs, the CE's (lse, label logit) and the loss of the
        embedding and `ls` (whole with view None, else r's shards)."""
        x = L.embed_tokens(e, tokens, view)
        outs = [x]
        for p in ls:
            x = M._train_layer(cut, p, x, dist=view)
            outs.append(x)
        logits = L.lm_logits(e, x[0], view, whole=False) if view else \
            L.lm_logits(e, x[0])
        ce = M._ce(logits, labels, L.head_group(e, view) if view else None,
                   view)
        loss = (ce[0] - ce[1]).mean() + sum(
            (y * dy).sum() for y, dy in zip(outs[1:], dys))
        return outs, ce, loss

    def pspecs(tp):
        return {"embed": L.embeddings_pspec(cut), "attn":
                A.attention_pspec(cut, tp), "mlp": L.mlp_pspec(cut)}

    def ranks(tp):
        views = tp_rank_views(dist, tp)
        specs = pspecs(tp)
        shards = []
        for view in views:
            e, ls = copy.deepcopy(embed), copy.deepcopy(layers)
            L.shard_module(e, view, {k: view.effective(a)
                                     for k, a in specs["embed"].items()})
            for p in ls:
                for part in ("attn", "mlp"):
                    L.shard_module(getattr(p, part), view, {
                        k: view.effective(a)
                        for k, a in specs[part].items()})
            shards.append((view, [e] + ls))

        def rank(r):
            view, mods = shards[r]
            KF.reset_launches()
            KB.reset_launches()
            outs, ce, loss = forward(mods[0], mods[1:], view)
            names = [(k, n) for k, m in enumerate(mods)
                     for n, _ in m.named_parameters()]
            grads = torch.autograd.grad(loss, [
                mods[k].get_parameter(n) for k, n in names])
            return ([y.detach() for y in outs],
                    tuple(t.detach() for t in ce), dict(zip(names, grads)),
                    {"flash_attention": KF.LAUNCHES["flash_attention"],
                     "flash_attention_bwd":
                     KB.LAUNCHES["flash_attention_bwd"]})
        with ReplayedModelAxis(views[0].group(views[0].tp_axis), tp) as rp:
            outs, passes = rp.run(rank, TP_RBR_PASSES)
        return outs, shards, passes

    def share(a, b):
        return float((a - b).detach().abs().max() / b.detach().abs().max())

    outs_w, ce_w, loss_w = forward(embed, layers, None)
    loss_w.backward()
    rec = {"arch": cfg.name, "layers": TP_LAYERS, "d_model": cut.d_model,
           "heads": H, "kv_heads": Hkv, "d_ff": F, "vocab": cut.padded_vocab,
           "tokens": TRAIN_BATCH * TRAIN_SEQ, "ce_tokens": TRAIN_SEQ}
    for tp in TP_RANKS:
        outs, shards, passes = ranks(tp)
        y_share = max(share(y, w) for o in outs
                      for y, w in zip(o[0], outs_w))
        ce_share = max(share(a, b) for o in outs for a, b in zip(o[1], ce_w))
        worst, split = 0.0, set()
        for (view, mods), (_, _, grads, _) in zip(shards, outs):
            for (k, name), gr in grads.items():
                want = modules[k].get_parameter(name).grad
                axes = L.placements(mods[k]).get(name)
                if axes:            # split: this rank's shard
                    split.add(name.split(".")[-1])
                    want = view.shard(want, axes)
                worst = max(worst, share(gr, want))
        launches = {n: sum(o[3][n] for o in outs)
                    for n in ("flash_attention", "flash_attention_bwd")}
        rec[f"tp{tp}"] = {"y_share": y_share, "ce_share": ce_share,
                          "grad_worst_share": worst, "launches": launches,
                          "passes": passes, "split_leaves": sorted(split),
                          "kv_heads_local": Hkv % tp == 0}
        check(y_share <= TP_Y_TOL,
              f"tp rank by rank: y at tp {tp} within {TP_Y_TOL} of max |y|")
        check(ce_share <= TP_Y_TOL,
              f"tp rank by rank: the CE at tp {tp} within {TP_Y_TOL}")
        check(worst <= TP_GRAD_TOL,
              f"tp rank by rank: gradients at tp {tp} within {TP_GRAD_TOL}")
        check(launches == {"flash_attention": tp * TP_LAYERS,
                           "flash_attention_bwd": tp * TP_LAYERS},
              f"tp rank by rank: flash and its backward launch {tp} times "
              f"a layer")
        check({"wq", "wo", "wi", "tok"} <= split,
              f"tp rank by rank: the heads, MLP and vocabulary split at "
              f"tp {tp}")
        del outs, shards
    return rec


def tp_mesh_bits(cfg, dist) -> dict:
    """(ii) `make_train_step` through the meshed code paths with `dist`
    (a `DistContext` over `make_smoke_mesh()`'s 1 x 1 NCCL mesh: every
    axis one rank wide, so the placements split no leaf and the
    collectives run over one rank) against the unmeshed step,
    TP_BITS_STEPS bfloat16 steps of TRAIN_BATCH x TRAIN_SEQ tokens at
    TP_LAYERS layers from one seed: every metric and state leaf the same
    bits."""
    import dataclasses
    import torch
    from repro_torch.data.pipeline import Pipeline
    from repro_torch.models import layers as L
    from repro_torch.optim import adamw
    from repro_torch.train import checkpoint as CKPT
    from repro_torch.train import train_step as TS
    cut = dataclasses.replace(cfg, n_layers=TP_LAYERS)
    tcfg = TS.TrainConfig(opt=adamw.AdamWConfig(
        warmup_steps=2, total_steps=TP_BITS_STEPS))
    pipe = Pipeline(cut, TRAIN_BATCH, TRAIN_SEQ, seed=SEED, device="cuda")
    runs = []
    for d in (None, dist):
        st = TS.init_train_state(cut, SEED, tcfg=tcfg, device="cuda", dist=d)
        runs.append([st, TS.make_train_step(cut, tcfg, d), []])
    differ = []
    for t in range(TP_BITS_STEPS):
        batch_np, _ = pipe.get_batch(t)
        for run in runs:
            batch = {k: torch.from_numpy(v).cuda()
                     for k, v in batch_np.items()}
            run[0], m = run[1](run[0], batch)
            run[2].append(m)
        differ += [f"{k} step {t}" for k in runs[0][2][t]
                   if not torch.equal(runs[0][2][t][k], runs[1][2][t][k])]
    differ += [n for (n, a), (_, b) in zip(
        CKPT.state_leaves(runs[0][0]), CKPT.state_leaves(runs[1][0]))
        if not torch.equal(a, b)]
    split = sorted(L.placements(runs[1][0]["params"]))
    rec = {"steps": TP_BITS_STEPS, "layers": TP_LAYERS,
           "losses": [float(m["loss"]) for m in runs[0][2]],
           "differ": differ, "split_leaves": split}
    check(not differ, "tp mesh bits: the 1 x 1 mesh's steps give the "
                      "unmeshed bits")
    check(not split, "tp mesh bits: a 1 x 1 mesh splits no leaf")
    return rec


def tp_dryrun_prediction(cfg) -> dict:
    """(iii) The dry run's prediction for `phase_train`'s main path
    (qwen2-1.5b at full depth, TRAIN_BATCH x TRAIN_SEQ, bfloat16, remat
    "nothing", its TrainConfig) on a 1 x 1 fake mesh: argument + temp
    bytes against that step's measured peak (`MEASURED`), within
    TP_DRYRUN_RTOL."""
    import torch.distributed as tdist
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import fake_mesh
    measured = MEASURED["train_main_path"]
    shape = ShapeSpec("train_main_path", TRAIN_SEQ, TRAIN_BATCH, "train")
    t0 = time.perf_counter()
    try:
        rec = dryrun.trace_step(cfg, shape, fake_mesh((1, 1),
                                                      ("data", "model")),
                                tcfg=measured["tcfg"])
    finally:
        tdist.destroy_process_group()
    m = rec["memory"]
    predicted = (m["argument_bytes"] + m["temp_bytes"]) / 1e9
    out = {"predicted_gb": predicted, "measured_peak_gb":
           measured["peak_gb"], "argument_gb": m["argument_bytes"] / 1e9,
           "temp_gb": m["temp_bytes"] / 1e9, "flops": rec["cost"]["flops"],
           "kernel_flops": rec["kernel_flops"], "trace_s": rec["trace_s"],
           "seconds": time.perf_counter() - t0}
    out["rel_gap"] = predicted / measured["peak_gb"] - 1.0
    check(abs(out["rel_gap"]) <= TP_DRYRUN_RTOL,
          f"tp dry run: predicted bytes within {TP_DRYRUN_RTOL} of the "
          f"measured peak")
    return out


DRYRUN_OUT = Path(__file__).resolve().parent / "build" / "dryrun_smoke"


def start_dryrun_cli():
    """(iv) The dry run's command line at TP_DRYRUN_CELLS, started as
    processes of their own (they run on no device, so `main` starts them
    first, beside the kernels' build): ({cell: process}, env)."""
    import shutil
    shutil.rmtree(DRYRUN_OUT, ignore_errors=True)
    env = dict(os.environ, PYTHONPATH=str(Path(__file__).resolve().parent
                                          / "src"))
    procs = {}
    for arch, shape in TP_DRYRUN_CELLS:
        procs[f"{arch}:{shape}"] = subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
             arch, "--shape", shape, "--out", str(DRYRUN_OUT)], env=env,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    return procs, env


def dryrun_cli_results(procs, env) -> dict:
    """(iv) The dry-run processes' records (each exits 0 with OK), then
    `python -m repro_torch.launch.roofline` over them (its table)."""
    out_dir = DRYRUN_OUT
    out = {}
    for key, p in procs.items():
        stdout, stderr = p.communicate(timeout=600)
        arch, shape = key.split(":")
        rec = json.loads((Path(out_dir) / f"{arch}_{shape}_32x8.json")
                         .read_text())
        out[key] = {"rc": p.returncode, "status": rec["status"],
                    "memory": rec.get("memory"), "flops":
                    rec.get("cost", {}).get("flops"),
                    "collective_wire_bytes": rec.get("collective_wire_bytes"),
                    "trace_s": rec.get("trace_s")}
        check(p.returncode == 0 and rec["status"] == "OK",
              f"tp dry run: {key} exits 0 with OK ({stderr[-500:]})")
    r = subprocess.run([sys.executable, "-m", "repro_torch.launch.roofline",
                        "--dir", str(out_dir), "--csv",
                        str(Path(out_dir) / "roofline.csv")], env=env,
                       capture_output=True, text=True, timeout=120)
    lines = r.stdout.strip().splitlines()
    out["roofline"] = lines
    check(r.returncode == 0 and lines[0].startswith("arch,shape,status")
          and len(lines) == 1 + len(procs),
          "tp dry run: the roofline prints its table")
    return out


def phase_tp_dryrun(cli=None):
    """The compile-only half of `launch/` and the tensor parallelism of
    dense layers (ROADMAP.md queue 1 item 6b), at qwen2-1.5b's full width,
    over `make_smoke_mesh()`'s 1 x 1 NCCL mesh: (i) the port's
    tensor-parallel layers rank by rank in one process
    (`tp_rank_by_rank`); (ii) the meshed train step, which splits no leaf
    on that mesh, gives the unmeshed bits (`tp_mesh_bits`); (iii) the dry
    run's prediction for `phase_train`'s main path against its measured
    peak (`tp_dryrun_prediction`); (iv)
    `python -m repro_torch.launch.dryrun` at TP_DRYRUN_CELLS (`cli`, the
    processes `start_dryrun_cli` started; started here when None) and
    `python -m repro_torch.launch.roofline` (`dryrun_cli_results`), the
    zamba2-1.2b train cell's prediction a rank logged beside
    `phase_train_ssm`'s measured one-card peak. Every number beside the
    card's name and power limit."""
    import torch
    import torch.distributed as tdist
    from repro_torch.configs import get_arch
    from repro_torch.device import card_identity
    from repro_torch.launch.mesh import DistContext, make_smoke_mesh
    torch.backends.cuda.matmul.allow_tf32 = False  # float32 as float32
    cfg = get_arch(TRAIN_ARCH)
    card = card_identity()
    t0 = time.perf_counter()
    procs, env = cli or start_dryrun_cli()
    g = torch.Generator(device="cuda")
    g.manual_seed(SEED + 80)
    mesh = make_smoke_mesh()
    try:
        dist = DistContext(mesh)
        t1 = time.perf_counter()
        log(phase="tp_rank_by_rank", **tp_rank_by_rank(cfg, g, dist),
            card=card, seconds=time.perf_counter() - t1)
        torch.cuda.empty_cache()
        t1 = time.perf_counter()
        log(phase="tp_mesh_bits", **tp_mesh_bits(cfg, dist), card=card,
            seconds=time.perf_counter() - t1)
    finally:
        tdist.destroy_process_group()
    torch.cuda.empty_cache()
    log(phase="tp_dryrun_prediction", **tp_dryrun_prediction(cfg),
        card=card)
    t1 = time.perf_counter()
    cli_rec = dryrun_cli_results(procs, env)
    log(phase="tp_dryrun_cli", **cli_rec, card=card,
        seconds=time.perf_counter() - t1)
    # zamba2-1.2b's train cell: one rank of the 32 x 8 mesh (its 8 rows of
    # 4,096 tokens, the model axis 8 wide) beside the one-card step
    # `phase_train_ssm` measured (4 x 2,048 tokens, the whole model)
    mem = cli_rec["zamba2-1.2b:train_4k"]["memory"]
    log(phase="tp_dryrun_zamba2_train", predicted_gb=(
        mem["argument_bytes"] + mem["temp_bytes"]) / 1e9,
        argument_gb=mem["argument_bytes"] / 1e9,
        temp_gb=mem["temp_bytes"] / 1e9,
        measured_one_card=MEASURED.get("train_zamba2"), card=card)
    log(phase="tp_dryrun_phase", card=card,
        seconds=time.perf_counter() - t0)
    return []


class ReplayedModelAxis:
    """The model axis's collectives of `tp_rank_views`' ranks, run one
    rank at a time in this process. Inside it `collectives.all_reduce`,
    `all_gather` and `reduce_scatter` over `group` (the views' one-rank
    model group; any other group is left to the real ones) record each
    rank's input of its k-th call and return what the ranks' inputs of
    the k-th call in the previous pass combine to (the sum or max, the
    concatenation, this rank's slice of the sum); in a first pass a
    rank's own input stands in for each. `run(fn)` runs fn(r) for every
    rank r, a pass at a time, until a pass's inputs equal the previous
    pass's bit for bit: every result that pass used was then the exact
    collective over the ranks, computed from the same inputs."""

    def __init__(self, group, tp: int):
        self.group, self.tp = group, tp
        self.prev, self.cur, self.rank, self.k = None, {}, 0, 0

    def __enter__(self):
        from repro_torch.launch import collectives as C
        self._C = C
        self._orig = (C.all_reduce, C.all_gather, C.reduce_scatter)
        ar, ag, rs = self._orig

        def all_reduce(t, group, op=None):
            if group is not self.group:
                return ar(t, group, op)
            import torch.distributed as tdist
            ins = self._inputs(t)
            import torch
            if op == tdist.ReduceOp.MAX:
                return torch.stack(ins).amax(0)
            return torch.stack(ins).sum(0)

        def all_gather(t, dim, group):
            if group is not self.group:
                return ag(t, dim, group)
            import torch
            return torch.cat(self._inputs(t), dim=dim)

        def reduce_scatter(t, dim, group):
            if group is not self.group:
                return rs(t, dim, group)
            import torch
            n = t.shape[dim] // self.tp
            total = torch.stack(self._inputs(t)).sum(0)
            return total.narrow(dim, self.rank * n, n).contiguous()
        C.all_reduce, C.all_gather, C.reduce_scatter = \
            all_reduce, all_gather, reduce_scatter
        return self

    def __exit__(self, *exc):
        C = self._C
        C.all_reduce, C.all_gather, C.reduce_scatter = self._orig

    def _inputs(self, t):
        k, self.k = self.k, self.k + 1
        t = t.detach()
        self.cur.setdefault(k, [None] * self.tp)[self.rank] = t.clone()
        prev = (self.prev or {}).get(k)
        if prev is None or any(p is None or p.shape != t.shape
                               for p in prev):
            return [t] * self.tp
        return prev

    def run(self, fn, passes: int):
        """[fn(r) of each rank r] of the first pass whose collective inputs
        repeat the previous pass's; (outputs, passes run)."""
        import torch
        for n in range(1, passes + 1):
            self.cur, outs = {}, []
            for r in range(self.tp):
                self.rank, self.k = r, 0
                outs.append(fn(r))
            same = self.prev is not None and self.prev.keys() == \
                self.cur.keys() and all(
                    torch.equal(a, b) for k in self.cur
                    for a, b in zip(self.cur[k], self.prev[k]))
            self.prev = self.cur
            if same:
                return outs, n
        check(False, f"tp recurrent: the collectives' inputs repeat within "
                     f"{passes} passes")
        return outs, passes


def shard_tree(module, view, tree: dict) -> None:
    """`layers.shard_module` on every submodule of `module` at its entry of
    the nested placement tree (`models.model._block_pspec`), as `view`
    splits it."""
    from repro_torch.models import layers as L
    for name, sub in module.named_modules():
        node = tree
        for part in filter(None, name.split(".")):
            node = node.get(part, {}) if isinstance(node, dict) else {}
        if not isinstance(node, dict):
            continue
        L.shard_module(sub, view, {
            leaf: view.effective(node.get(leaf))
            for leaf, _ in sub.named_parameters(recurse=False)
            if isinstance(node.get(leaf), tuple)})


def _cut_cache(view, entry, axes):
    """A block's whole cache entry (a tensor or a dict of them) cut to the
    view's slice of every dimension its placement `axes` puts on "model"."""
    if isinstance(entry, dict):
        return {k_: _cut_cache(view, entry[k_], axes[k_]) for k_ in entry}
    return view.shard(entry, tuple(view.tp_axis if a == "model" else None
                                   for a in axes))


def _clone(entry):
    if isinstance(entry, dict):
        return {k_: _clone(v_) for k_, v_ in entry.items()}
    return entry.clone()


def _rel(a, b) -> float:
    return float((a - b).detach().abs().max() / b.detach().abs().max())


def tp_recurrent_block(cfg, kind: str, dist, tps, *, batch: int, seq: int,
                       frames: int = 0, device="cuda", g=None) -> dict:
    """One block of `kind` ("M", "A", "X", "S"; whisper's "enc" or "dec")
    at `cfg`'s width, float32, whole and rank by rank at each tp of `tps`
    (`tp_rank_views` of `dist`, the collectives replayed across the ranks:
    `ReplayedModelAxis`), through the port's own `shard_module` (the
    block's `models.model._block_pspec`) and `dist=` paths: the block's
    output and every gradient (of sum(y * dy): each parameter's, x's, and
    for "dec" the encoder output's) against the whole block's, then one
    decode step from the rank's slice of the whole prefill's cache
    (`cache_pspecs`' placement; a whisper decoder's cross cache whole):
    its output and new cache. Each rank's launches of the scan and flash
    (and their backwards) in the training pass."""
    import copy
    import torch
    from repro_torch.kernels.flash_attention import flash_attention as KF
    from repro_torch.kernels.flash_attention import flash_attention_bwd as KB
    from repro_torch.kernels.mamba_scan import mamba_scan as KS
    from repro_torch.kernels.mamba_scan import mamba_scan_bwd as KSB
    from repro_torch.models import attention as A
    from repro_torch.models import layers as L
    from repro_torch.models import model as M
    mods = (KF, KB, KS, KSB)
    names = ("flash_attention", "flash_attention_bwd", "mamba_scan",
             "mamba_scan_bwd")
    block = {"M": M.MambaBlock, "X": M.MLSTMBlock, "S": M.SLSTMBlock,
             "A": M.AttnBlock, "enc": M.AttnBlock,
             "dec": M.DecBlock}[kind](cfg, g, device)
    block.requires_grad_(True)
    D = cfg.d_model
    x = torch.randn((batch, seq, D), generator=g, device=device)
    dy = torch.randn((batch, seq, D), generator=g, device=device)
    enc = torch.randn((batch, frames, D), generator=g, device=device) \
        if kind == "dec" else None
    x1 = torch.randn((batch, 1, D), generator=g, device=device)

    def forward(p, d, xin, ein):
        if kind in "MXS":
            return M._apply_recurrent(cfg, kind, p, xin, dist=d)[0]
        if kind == "A":
            return M._train_layer(cfg, p, xin, window=cfg.attn_window,
                                  dist=d)
        if kind == "enc":
            return M._train_layer(cfg, p, xin, causal=False, dist=d)
        return M._dec_layer(cfg, p, xin, ein, d)[0]

    def grads(p, d):
        xin = x.clone().requires_grad_(True)
        ein = None if enc is None else enc.clone().requires_grad_(True)
        y = forward(p, d, xin, ein)
        leaves = [xin] + ([ein] if ein is not None else []) \
            + list(p.parameters())
        gs = torch.autograd.grad((y * dy).sum(), leaves)
        named = ["x"] + (["enc_out"] if ein is not None else []) \
            + [n for n, _ in p.named_parameters()]
        return y.detach(), dict(zip(named, gs))

    def cache_of(p):
        """The whole prefill's cache entry of the block (no gradient),
        with the decode step's position: an attention cache padded by 8
        slots (its ring, or its linear cache) for the step."""
        with torch.no_grad():
            if kind in "MXS":
                return M._apply_recurrent(cfg, kind, p, x)[1]
            if kind == "A":
                kv = M._apply_block_full(cfg, "A", p, x,
                                         window=cfg.attn_window)[1]
                return {k_: torch.nn.functional.pad(v_, (0, 0, 0, 0, 0, 8))
                        for k_, v_ in kv.items()}
            if kind == "dec":
                _, (k_, v_), (ek, ev) = M._dec_layer(cfg, p, x, enc)
                pad = (0, 0, 0, 0, 0, 8)
                return {"k": torch.nn.functional.pad(k_, pad),
                        "v": torch.nn.functional.pad(v_, pad),
                        "ck": ek, "cv": ev}
            return None

    def decode(p, d, entry):
        with torch.no_grad():
            if kind in "MXS":
                return M._apply_recurrent(cfg, kind, p, x1, state=entry,
                                          dist=d)
            if kind == "A":
                return M._shared_attn_step(cfg, p, x1, entry, seq, d)
            y = M._dec_layer_step(cfg, p, x1, entry["k"], entry["v"],
                                  entry["ck"], entry["cv"], seq, d)
            return y, {k_: entry[k_] for k_ in ("k", "v")}

    def cache_axes():
        """The placement of the block's cache entry (`cache_pspecs` of a
        pattern holding it; the stacked self cache without its layer
        axis)."""
        sizes = {"data": 1, "model": tp}
        if kind == "dec":
            self_ax = M.cache_pspecs(cfg, batch, sizes)["self"][0]["k"][1:]
            return {"k": self_ax, "v": self_ax,
                    "ck": (None,) * 4, "cv": (None,) * 4}
        pattern = ("M", "A") if kind == "A" else (kind,)
        import dataclasses
        one = dataclasses.replace(cfg, block_pattern=pattern,
                                  n_layers=len(pattern))
        return M.cache_pspecs(one, batch, sizes)[pattern.index(kind)]

    y_w, g_w = grads(block, None)
    entry = cache_of(block)
    dec_w = decode(block, None, _clone(entry)) if entry is not None \
        else None
    rec = {"kind": kind, "batch": batch, "seq": seq, "frames": frames}
    for tp in tps:
        views = tp_rank_views(dist, tp)
        spec = M._block_pspec(cfg, "dec" if kind == "dec" else
                              "A" if kind == "enc" else kind, tp)
        ranks = []
        for view in views:
            p = copy.deepcopy(block)
            shard_tree(p, view, spec)
            ranks.append(p)
        split = sorted({f"{n}.{leaf}" for n, sub in ranks[0].named_modules()
                        for leaf in getattr(sub, "placement", {})})

        def train(r):
            for m in mods:
                m.reset_launches()
            y, gs = grads(ranks[r], views[r])
            return y, gs, {n: m.LAUNCHES[n] for m, n in zip(mods, names)}
        with ReplayedModelAxis(views[0].group(views[0].tp_axis), tp) as rp:
            outs, passes = rp.run(train, TP_REC_PASSES)
        y_share = max(_rel(y, y_w) for y, _, _ in outs)
        worst = {}
        for r, (_, gs, _) in enumerate(outs):
            for n, gr in gs.items():
                sub, _, leaf = n.rpartition(".")
                axes = L.placement(ranks[r].get_submodule(sub), leaf) \
                    if n not in ("x", "enc_out") else None
                want = views[r].shard(g_w[n], axes) if axes else g_w[n]
                worst[n] = max(worst.get(n, 0.0), _rel(gr, want))
        launches = [l_ for _, _, l_ in outs]
        t_rec = {"passes": passes, "y_share": y_share,
                 "grad_worst_share": max(worst.values()),
                 "grad_worst_leaf": max(worst, key=worst.get),
                 "split_leaves": split, "launches_by_rank": launches}
        check(y_share <= TP_Y_TOL, f"tp recurrent: {cfg.name} {kind} y at "
                                   f"tp {tp} within {TP_Y_TOL} of max |y|")
        check(t_rec["grad_worst_share"] <= TP_GRAD_TOL,
              f"tp recurrent: {cfg.name} {kind} gradients at tp {tp} within "
              f"{TP_GRAD_TOL} of their max")
        if entry is not None:
            axes = cache_axes()

            def step(r):
                return decode(ranks[r], views[r],
                              _cut_cache(views[r], _clone(entry), axes))
            with ReplayedModelAxis(views[0].group(views[0].tp_axis),
                                   tp) as rp:
                d_outs, d_passes = rp.run(step, TP_REC_PASSES)
            d_y = max(_rel(y, dec_w[0]) for y, _ in d_outs)
            d_state = 0.0
            for r, (_, st) in enumerate(d_outs):
                want = _cut_cache(views[r], dec_w[1], axes)
                flat = st if isinstance(st, dict) else {"state": st}
                ref = want if isinstance(want, dict) else {"state": want}
                for k_ in flat:
                    d_state = max(d_state, _rel(flat[k_], ref[k_]))
            t_rec.update(decode_y_share=d_y, decode_state_share=d_state,
                         decode_passes=d_passes)
            check(d_y <= TP_Y_TOL and d_state <= TP_Y_TOL,
                  f"tp recurrent: {cfg.name} {kind} decode at tp {tp} "
                  f"within {TP_Y_TOL}")
        rec[f"tp{tp}"] = t_rec
        del ranks, outs
    return rec


def phase_tp_recurrent():
    """The tensor parallelism of the recurrent and encoder-decoder
    families (ROADMAP.md queue 1 item 6c) at full width, float32 with
    TF32 off, over a view of `make_smoke_mesh()`'s 1 x 1 NCCL mesh, rank
    by rank at TP_RANKS model ranks (`tp_recurrent_block`): zamba2-1.2b's
    Mamba2 block ("M": d_in and its 64 heads split, B and C whole, the
    gated norm's squares summed over the ranks) and its shared attention
    block ("A", window 4,096); xlstm-350m's mLSTM ("X": the head
    projections' partial sums reduce-scattered onto the ranks' heads) and
    sLSTM ("S": replicated, its h/c state cut by heads) blocks;
    whisper-small's encoder layer over its 1,500 frames and a decoder
    layer (self- and cross-attention, 12 heads over 2 and 4 ranks). Each
    on TP_REC_BATCH x TP_REC_SEQ tokens: y within TP_Y_TOL of max |y|,
    every gradient within TP_GRAD_TOL of its max, one decode step over
    the rank's cache within TP_Y_TOL; the scan and flash run on each
    rank's heads once (and their backwards once) a block and rank.
    Every number beside the card's name and power limit."""
    import torch
    import torch.distributed as tdist
    from repro_torch.configs import get_arch
    from repro_torch.device import card_identity
    from repro_torch.launch.mesh import DistContext, make_smoke_mesh
    torch.backends.cuda.matmul.allow_tf32 = False  # float32 as float32
    card = card_identity()
    g = torch.Generator(device="cuda")
    g.manual_seed(SEED + 90)
    mesh = make_smoke_mesh()
    # a block's launches a rank: (scan, scan backward, flash, its backward)
    expect = {"M": (1, 1, 0, 0), "X": (1, 1, 0, 0), "S": (0, 0, 0, 0),
              "A": (0, 0, 1, 1), "enc": (0, 0, 1, 1), "dec": (0, 0, 2, 2)}
    try:
        dist = DistContext(mesh)
        for arch, kinds in ((LM_ARCH, ("M", "A")), (XLSTM_ARCH, ("X", "S")),
                            (WHISPER_ARCH, ("enc", "dec"))):
            cfg = get_arch(arch)
            for kind in kinds:
                t0 = time.perf_counter()
                frames = cfg.encoder_seq if cfg.family == "encdec" else 0
                seq = frames if kind == "enc" else TP_REC_SEQ
                rec = tp_recurrent_block(cfg, kind, dist, TP_RANKS,
                                         batch=TP_REC_BATCH, seq=seq,
                                         frames=frames, g=g)
                for tp in TP_RANKS:
                    s, sb, f, fb = expect[kind]
                    want = {"flash_attention": f, "flash_attention_bwd": fb,
                            "mamba_scan": s, "mamba_scan_bwd": sb}
                    check(all(l_ == want for l_ in
                              rec[f"tp{tp}"]["launches_by_rank"]),
                          f"tp recurrent: {arch} {kind} launches {want} on "
                          f"each of {tp} ranks")
                log(phase="tp_recurrent", arch=arch, **rec, card=card,
                    seconds=time.perf_counter() - t0)
                torch.cuda.empty_cache()
    finally:
        tdist.destroy_process_group()
    return []


def _moe_bwd_kernels(ms_by_name: dict) -> dict:
    """Device milliseconds of one traced `ich_moe_backward` call by
    kernel of csrc/ich_moe_bwd.cu: the weight-gradient kernel's two
    launches apart (template argument 0: dwi and dwg, 1: dwo)."""
    out = {"upv": 0.0, "dx": 0.0, "dweights_in": 0.0, "dweights_out": 0.0,
           "combine": 0.0, "dw": 0.0}
    for name, ms in ms_by_name.items():
        if "moe_bwd_dweights" in name:
            role = re.search(r"moe_bwd_dweights<[^>]*?(\d)>", name)
            out["dweights_out" if role and role.group(1) == "1"
                else "dweights_in"] += ms
        else:
            for k_ in ("upv", "dx", "combine", "dw"):
                if f"moe_bwd_{k_}" in name:
                    out[k_] += ms
                    break
    return out


def _rates(flops: int, device_ms: float) -> dict:
    """Achieved TFLOP/s of float32 work and of the TF32 work that runs it
    (three TF32 products a float32 one); None when the trace held no
    device time."""
    if device_ms <= 0:
        return {"float32_tflops": None, "tf32_tflops": None}
    return {"float32_tflops": flops / device_ms / 1e9,
            "tf32_tflops": 3 * flops / device_ms / 1e9}


SCAN_STEPS = tuple(f"ssd_scan_kernel_{step}"
                   for step in ("cumsum", "cb", "states", "pass", "y"))


def _scan_step(name: str) -> str:
    """The step of the SSD scan a CUDA kernel name belongs to
    (csrc/mamba_scan.cu runs five kernels a call), or "other"."""
    for step in SCAN_STEPS:
        if step in name:
            return step[len("ssd_scan_kernel_"):]
    return "other"


def _median_steps(steps, reps=PIPELINE_REPS) -> list:
    """Run the callables of `steps` in order, `reps` times, each step ending
    in a synchronize; the median host seconds of each step. A step gets the
    previous step's result."""
    import torch
    times = []
    for _ in range(reps):
        out, row = None, []
        for step in steps:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = step(out)
            torch.cuda.synchronize()
            row.append(time.perf_counter() - t0)
        times.append(row)
    return [float(t) for t in np.median(np.asarray(times), axis=0)]


def _lowering_mismatches(low, s) -> list:
    """The fields of the device lowering `low` that differ from the host
    lowering of schedule `s` (its tiles, `shard()` and the kernels'
    streams) in dtype, shape or any bit."""
    from repro_torch.sched.kernels import _flat_slot_cost
    sh = s.shard(p=low.p, superstep=low.superstep)
    host = {"item_id": s.tiles.item_id, "seg_start": s.tiles.seg_start,
            "seg_len": s.tiles.seg_len, "tile_cost": s.tile_cost(),
            "worker": sh.worker, "block_perm": sh.block_perm,
            "rowid": sh.shard_item_id(s.item_id),
            "blkid": sh.kernel_block_ids(),
            "slot_cost": _flat_slot_cost(s.slot_cost(), sh.n_tiles_padded)}
    dev = {"item_id": low.schedule.item_id,
           "seg_start": low.schedule.seg_start,
           "seg_len": low.schedule.seg_len, "tile_cost": low.tile_cost,
           "worker": low.worker, "block_perm": low.block_perm,
           "rowid": low.rowid, "blkid": low.blkid,
           "slot_cost": low.slot_cost}
    bad = [] if low.schedule.width == s.width else ["width"]
    for name, want in host.items():
        got = dev[name].cpu().numpy()
        want = np.ascontiguousarray(want)
        if got.dtype != want.dtype or got.shape != want.shape \
                or got.tobytes() != want.tobytes():
            bad.append(name)
    return bad


def _sm_clock_mhz() -> float:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"],
        check=True, capture_output=True, text=True, timeout=60)
    return float(out.stdout.split()[0])


def once_ms(fn):
    """CUDA-event milliseconds of one call of fn, and its result."""
    import torch
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    stop.record()
    stop.synchronize()
    return start.elapsed_time(stop), out


def phase_pipeline(sm_count):
    """The schedule pipeline on the card. Its main path, counted:
    `LoopScheduler(backend="torch")` -> schedule -> `device_lowering()` ->
    `pack_csr_torch` -> `ich_spmv_sharded` on the device lowering at
    wikipedia (y and costs == the host-built op's, bit for bit), and
    `device_lowering()` of every other main path's schedule. Then each
    lowering against the host's element for element, with and without
    `n_steps=`; the device pack against the host pack; the host and device
    pipelines timed per shape; and `segment_fold` / `lpt_assign` at
    wikipedia's full size against np.bincount / partition_tiles and their
    plain versions, timed."""
    import torch
    from repro_torch.core import tiling_torch as TT
    from repro_torch.core.tiling import block_chains
    from repro_torch.kernels.ich_spmv import ich_spmv as KS
    from repro_torch.kernels.lpt import lpt as L
    from repro_torch.sched import LoopScheduler, NnzCosts, registry

    w = SHAPES["wikipedia"]
    indptr = w["csr"][0]

    # ---- this slice's main path, counted ----
    L.reset_launches()
    KS.reset_launches()
    t0 = time.perf_counter()
    s_t = LoopScheduler(p=sm_count, backend="torch").schedule(
        NnzCosts(indptr))
    low = s_t.device_lowering()
    csr = [torch.from_numpy(a).cuda() for a in w["csr"]]
    vals, cols = TT.pack_csr_torch(*csr, low.schedule,
                                   pad_tiles_to=low.superstep)
    y, costs = KS.ich_spmv_sharded(vals, cols, low.rowid, low.blkid, w["x"],
                                   indptr.size - 1, low.p, low.superstep,
                                   slot_cost=low.slot_cost)
    lows = {"wikipedia": low}
    lows.update({name: sh["schedule"].device_lowering()
                 for name, sh in SHAPES.items() if name != "wikipedia"})
    torch.cuda.synchronize()
    t_path = time.perf_counter() - t0
    launches = {**L.LAUNCHES,
                "ich_spmv_sharded": KS.LAUNCHES["ich_spmv_sharded"]}
    log(phase="pipeline_main_path", seconds=t_path, launches=launches,
        shapes=list(lows), backend=s_t.backend)
    for name, count in launches.items():
        check(count > 0, f"{name} launched on the pipeline path")
    check(np.array_equal(s_t.item_id, w["schedule"].item_id),
          "backend='torch' tiles == host tiles")
    check(torch.equal(y, w["y"]) and torch.equal(costs, w["costs"]),
          "ich_spmv_sharded on the device lowering == the host op, bit "
          "for bit")
    check(torch.equal(vals, w["op"].vals) and torch.equal(cols, w["op"].cols),
          "pack_csr_torch == host pack_csr at wikipedia, bit for bit")
    del vals, cols, y, costs, csr

    # ---- every main path's lowering == the host's, element for element ----
    for name, sh in SHAPES.items():
        s, low = sh["schedule"], lows[name]
        again = TT.lower_schedule_torch(
            s.sizes, s.costs, p=low.p, superstep=low.superstep,
            rows_per_tile=s.rows_per_tile, width=s.width, eps=s.band_eps,
            n_steps=low.n_steps)
        bad, bad_again = _lowering_mismatches(low, s), \
            _lowering_mismatches(again, s)
        log(phase="pipeline_lowering_check", shape=name, items=s.n_items,
            tiles=s.n_tiles, width=s.width, p=low.p, steps=low.n_steps,
            mismatched=bad, mismatched_with_n_steps=bad_again)
        check(not bad and not bad_again,
              f"{name}: device lowering == host lowering element for "
              "element, with and without n_steps=")
    del lows, again

    # ---- host and device pipelines, timed per shape ----
    for name, sh in SHAPES.items():
        s, entry = sh["schedule"], registry.get(sh["workload"])
        B = s.superstep
        host = _median_steps([
            lambda _: LoopScheduler(cache_size=0, **sh["sched"]).schedule(
                entry.costs(*sh["inputs"])),
            lambda s_h: (s_h.shard(), s_h)[1],
            lambda s_h: entry.build(s_h, *sh["inputs"])])

        def lower():
            return TT.lower_schedule_torch(
                s.sizes, s.costs, p=s.p, superstep=B,
                rows_per_tile=s.rows_per_tile, width=s.width,
                eps=s.band_eps)

        upload = (lambda _: [torch.from_numpy(a).cuda() for a in sh["csr"]]) \
            if sh["csr"] is not None else (lambda _: None)
        dev = _median_steps([
            upload, lambda c: (c, lower()),
            lambda c_low: (TT.pack_csr_torch(*c_low[0], c_low[1].schedule,
                                             pad_tiles_to=B)
                           if c_low[0] is not None else None)])
        by_name = device_ms_by_kernel(lower)
        chain = block_chains(s.item_id, B)
        log(phase="pipeline_timing", shape=name, tiles=s.n_tiles,
            blocks=int(chain.size), chains=int(chain[-1]) + 1,
            longest_chain_blocks=int(np.bincount(chain).max()),
            host_schedule_s=host[0], host_shard_s=host[1],
            host_pack_upload_s=host[2], host_total_s=sum(host),
            device_upload_csr_s=dev[0], device_lower_s=dev[1],
            device_pack_s=dev[2] if sh["csr"] is not None else None,
            device_total_s=sum(dev), speedup=sum(host) / sum(dev),
            lowering_device_ms=sum(by_name.values()),
            lpt_assign_ms=sum(v for k, v in by_name.items()
                              if "lpt_assign_" in k),
            segment_fold_ms=sum(v for k, v in by_name.items()
                                if "segment_fold_kernel" in k),
            device_ms=by_name, reps=PIPELINE_REPS)

    return lpt_kernels(w["schedule"], launches)


def lpt_kernels(s, launches) -> list:
    """Both kernels of `csrc/lpt.cu` at the lowering of the host schedule
    `s` (wikipedia's): against np.bincount / partition_tiles and their
    plain versions, the same bits twice, lpt_assign's rounds, each call's
    device time apart from the host's enqueue, timed, and their bounds.
    `launches`: the counts of the main path's run."""
    import torch
    from repro_torch.core.tiling import block_chains
    from repro_torch.kernels.lpt import lpt as L

    B, p, T = s.superstep, s.p, s.n_tiles
    tc = s.tile_cost()
    chain = block_chains(s.item_id, B)
    n_blocks, n_real = chain.size, int(chain[-1]) + 1
    blk = np.arange(T) // B
    bcost = np.bincount(blk, weights=tc, minlength=n_blocks)
    ccost = np.bincount(chain, weights=bcost, minlength=n_blocks)
    order = np.argsort(-ccost + 0.0, kind="stable")
    dev = {k: torch.from_numpy(np.ascontiguousarray(a)).cuda() for k, a in
           (("tc", tc), ("blk", blk), ("chain", chain), ("bcost", bcost),
            ("ccost", ccost), ("order", order))}
    fold = (dev["tc"], dev["blk"], n_blocks)
    chain_fold = (dev["bcost"], dev["chain"], n_blocks)
    lpt = (dev["ccost"], dev["order"],
           torch.tensor([n_real]).cuda(), p)
    got_b, got_c = L.segment_fold(*fold), L.segment_fold(*chain_fold)
    got_w = L.lpt_assign(*lpt)
    rounds = int(L.LAST_ROUNDS)
    worker = np.repeat(got_w.cpu().numpy()[chain], B)[:T]
    check(got_b.cpu().numpy().tobytes() == bcost.tobytes()
          and got_c.cpu().numpy().tobytes() == ccost.tobytes(),
          "segment_fold == np.bincount bit for bit at wikipedia")
    check(np.array_equal(worker, s.shard().worker),
          "lpt_assign == partition_tiles at wikipedia")
    check(torch.equal(L.segment_fold(*fold), got_b)
          and torch.equal(L.segment_fold(*chain_fold), got_c)
          and torch.equal(L.lpt_assign(*lpt), got_w),
          "segment_fold and lpt_assign: the same bits twice at wikipedia")
    plain_b = L.segment_fold_plain(*fold)
    check(torch.equal(got_b, plain_b)
          and torch.equal(got_c, L.segment_fold_plain(*chain_fold)),
          "segment_fold == plain at wikipedia")
    lpt_plain_ms, plain_w = once_ms(lambda: L.lpt_assign_plain(*lpt))
    check(torch.equal(got_w, plain_w), "lpt_assign == plain at wikipedia")
    index_add = torch.zeros_like(dev["ccost"]).index_add_(
        0, dev["blk"], dev["tc"])
    ms = {"segment_fold": timed_ms(lambda: L.segment_fold(*fold)),
          "lpt_assign": timed_ms(lambda: L.lpt_assign(*lpt))}
    log(phase="segment_fold_calls", block_fold_values=T,
        block_fold_ms=ms["segment_fold"], chain_fold_values=n_blocks,
        chain_fold_ms=timed_ms(lambda: L.segment_fold(*chain_fold)),
        longest_chain_blocks=int(np.bincount(chain).max()),
        index_add_bits_equal=bool(torch.equal(index_add, got_b)))
    # each call's device time: the kernel apart from any other launch (the
    # output fill, the scratch), beside the host's microseconds to enqueue
    split = {}
    for label, fn, kernel in (
            ("block_fold", lambda: L.segment_fold(*fold),
             "segment_fold_kernel"),
            ("chain_fold", lambda: L.segment_fold(*chain_fold),
             "segment_fold_kernel"),
            ("lpt_assign", lambda: L.lpt_assign(*lpt), "lpt_assign_")):
        by_name = device_ms_by_kernel(fn, expect=(kernel,))
        k = sum(v for name, v in by_name.items() if kernel in name)
        split[label] = {"kernel_ms": k, "other_ms": sum(by_name.values()) - k,
                        "host_enqueue_us": enqueue_us(fn),
                        "device_ms": by_name}
    log(phase="lpt_kernels_split", **split)
    plain_ms = {"segment_fold": timed_ms(lambda: L.segment_fold_plain(*fold)),
                "lpt_assign": lpt_plain_ms}
    library_ms = {"segment_fold": timed_ms(lambda: torch.zeros_like(
        dev["ccost"]).index_add_(0, dev["blk"], dev["tc"])),
        "lpt_assign": None}
    clock_mhz = _sm_clock_mhz()
    latency_ms = rounds * LPT_ROUND_CYCLES / (clock_mhz * 1e3)
    check(-(-n_real // min(p, L.ROUND_WINDOW)) <= rounds <= n_real,
          "lpt_assign: between one round per window and one per chain")
    log(phase="lpt_assign_rounds", chains=n_real, workers=p, rounds=rounds,
        chains_per_round=n_real / rounds,
        round_cycles_assumed=LPT_ROUND_CYCLES, sm_clock_mhz=clock_mhz,
        latency_bound_ms=latency_ms, ms=ms["lpt_assign"],
        device_ms=split["lpt_assign"]["kernel_ms"],
        block_fold_device_ms=split["block_fold"]["kernel_ms"],
        chain_fold_device_ms=split["chain_fold"]["kernel_ms"])
    bytes_ = {"segment_fold": T * 16 + n_blocks * 8,
              "lpt_assign": n_blocks * 12 + n_real * 8 + 8}
    # float64 adds: one a value folded, one a chain placed
    flops = {"segment_fold": T, "lpt_assign": n_real}
    out = []
    for name in ("segment_fold", "lpt_assign"):
        entry = kernel_entry(name, launches=launches[name], err=0.0,
                             ms=ms[name], plain_ms=plain_ms[name],
                             library_ms=library_ms[name],
                             bytes_=bytes_[name], flops=flops[name],
                             peak=F64_FLOPS)
        if name == "lpt_assign":
            entry["latency_bound_ms"] = latency_ms
            entry["rounds"] = rounds
        out.append(entry)
    return out


def phase_recovery(sm_count):
    """Sharded recovery on the card at the main paths' shapes, counted:
    SpMV (wikipedia), a BFS step from the mid-depth frontier of each graph
    and K-Means (kdd_cup), each with two workers' sets dead ((0,) and two)
    and with a ragged checkpoint (worker w done through (7 w) mod (S_B + 1)
    steps) or none. `reshard_survivors` plans; the kernel runs the
    completed-prefix layout (its -1 steps) and the survivor layout (p - k
    rows: p - k CTAs for SpMV and BFS); `combine` must give the fault-free
    output's bits, and each run's cost stream must sum per worker to its
    layout's worker_cost. Logs p_rec, S_rec, the redo share of blocks,
    each run's time and makespan_model."""
    import torch
    from repro_torch.kernels.ich_bfs import ich_bfs as KB
    from repro_torch.kernels.ich_kmeans import ich_kmeans as KK
    from repro_torch.kernels.ich_spmv import ich_spmv as KS
    from repro_torch.robust import CheckpointLog
    from repro_torch.sched.kernels import _sharded_slot_cost

    def put(a):
        return torch.from_numpy(np.ascontiguousarray(a)).cuda()

    def flat(op, kernel, payload, tail):
        """Layout -> a call of a flat-payload sharded kernel (rows 2, 4)."""
        def runner(sh):
            rowid = put(sh.shard_item_id(op.schedule.item_id))
            blkid = put(sh.kernel_block_ids())
            return lambda: kernel(*payload, rowid, blkid, *tail, sh.p,
                                  op.superstep, slot_cost=op.slot_cost)
        return runner

    def kmeans(op, pts, cent):
        """Layout -> a call of the sharded K-Means kernel (row 6)."""
        s = op.schedule

        def runner(sh):
            rowid = put(sh.shard_item_id(s.item_id))
            slot = put(_sharded_slot_cost(s.slot_cost(), sh))
            return lambda: KK.ich_kmeans_assign_sharded(
                pts, cent, rowid, sh.p, op.superstep, slot_cost=slot)
        return runner

    for K in (KS, KB, KK):
        K.reset_launches()
    t0 = time.perf_counter()
    w = SHAPES["wikipedia"]
    op = w["op"]
    cases = [("spmv", op, KS, flat(op, KS.ich_spmv_sharded,
                                   (op.vals, op.cols), (w["x"], op.n_rows)),
              w["y"], op.vals)]
    for kind in GRAPHS:
        b = SHAPES[f"bfs_{kind}"]
        op, level = b["op"], b["level"]
        d = int(level.max()) // 2
        f = (level == d).float()
        v = ((level >= 0) & (level <= d)).float()
        cases.append((f"bfs_{kind}", op, KB, flat(
            op, KB.ich_bfs_step_sharded, (op.mask, op.cols), (f, v, op.n)),
            op.step(f, v), op.mask))
    k = SHAPES["kmeans"]
    cases.append(("kmeans", k["op"], None, kmeans(k["op"], k["pts"],
                                                  k["cent"]),
                  k["op"](k["pts"], k["cent"]), None))
    for label, op, K, runner, full, payload in cases:
        s, sh = op.schedule, op.shards
        tc = s.tile_cost()
        n_blocks = -(-s.n_tiles // sh.superstep)
        clean = float(sh.worker_cost(tc).max())
        full_ms = timed_ms(runner(sh), iters=5)
        for dead in ((0,), (0, sh.p // 2)):
            for ragged in (True, False):
                ckpt = None
                if ragged:
                    ckpt = CheckpointLog()
                    for wk in range(sh.p):
                        ckpt.mark_through(wk, (7 * wk) % (sh.n_steps + 1))
                t1 = time.perf_counter()
                plan = s.reshard_survivors(dead=dead, checkpoint=ckpt)
                t_plan = time.perf_counter() - t1
                outs, run_ms = [], []
                for layout in (plan.done_shards, plan.shards):
                    fn = runner(layout)
                    res, c = fn()
                    expect = layout.worker_cost(tc)
                    if K is None:   # float costs: float32 stream vs float64
                        ok = np.allclose(c.double().sum(dim=1).cpu().numpy(),
                                         expect, rtol=COST_RTOL, atol=0)
                    else:
                        ok = np.array_equal(c.cpu().numpy().sum(axis=1),
                                            expect.astype(np.float32))
                    check(ok, f"recovery {label} dead={dead}: per-worker "
                          "cost sums == the layout's worker_cost")
                    outs.append(res)
                    run_ms.append(timed_ms(fn, iters=5))
                check(torch.equal(plan.combine(*outs), full),
                      f"recovery {label} dead={dead} checkpoint="
                      f"{'ragged' if ragged else 'none'}: combine == the "
                      "fault-free bits")
                extra = {}
                if K is not None:
                    T_pad, R, W = payload.shape
                    extra["ctas_rec"] = K.sharded_launch_shape(
                        plan.p_rec, plan.shards.n_steps, sh.superstep, R,
                        W)["ctas"]
                    check(extra["ctas_rec"] == plan.p_rec,
                          f"recovery {label}: the survivor walk launches "
                          "p - k CTAs")
                mm = plan.makespan_model(tc)
                log(phase="recovery", workload=label, dead=list(dead),
                    checkpoint="ragged" if ragged else "none", p=sh.p,
                    p_rec=plan.p_rec, steps=sh.n_steps,
                    steps_done=plan.done_shards.n_steps,
                    steps_rec=plan.shards.n_steps,
                    redo_share=plan.redo_blocks.size / n_blocks,
                    lost_share=plan.lost_blocks.size / n_blocks,
                    redo_items=int(plan.redo_items.sum()), plan_s=t_plan,
                    full_ms=full_ms, done_ms=run_ms[0], rec_ms=run_ms[1],
                    makespan_model=mm, clean_makespan=clean,
                    model_inflation=mm["makespan"] / clean, **extra)
    torch.cuda.synchronize()
    launches = {"ich_spmv_sharded": KS.LAUNCHES["ich_spmv_sharded"],
                "ich_bfs_step_sharded": KB.LAUNCHES["ich_bfs_step_sharded"],
                "ich_kmeans_assign_sharded":
                    KK.LAUNCHES["ich_kmeans_assign_sharded"]}
    log(phase="recovery_path", seconds=time.perf_counter() - t0,
        launches=launches)
    for name, count in launches.items():
        check(count > 0, f"{name} launched on the recovery path")


def timed_phase(fn, *args):
    """fn(*args), logged as `phase_seconds` with its wall seconds."""
    t0 = time.perf_counter()
    out = fn(*args)
    log(phase="phase_seconds", name=fn.__name__,
        seconds=time.perf_counter() - t0)
    return out


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    from repro_torch.device import card_identity
    # the dry run's processes run on the host beside the kernels' build
    cli = start_dryrun_cli()
    try:
        return _phases(card_identity, cli)
    finally:
        for proc in cli[0].values():    # none outlives the script
            if proc.poll() is None:
                proc.kill()
                proc.wait()


def _phases(card_identity, cli) -> int:
    """Every phase in order, the kernels line, the card's line, the last
    line."""
    import torch
    sm_count = timed_phase(phase_environment)
    for phase in (phase_small, phase_small_bfs_kmeans, phase_small_moe,
                  phase_small_lm):
        timed_phase(phase)
    kernels = []
    for phase in (phase_main, phase_bfs, phase_kmeans, phase_moe):
        kernels += timed_phase(phase, sm_count)
    sched_kernels = timed_phase(phase_pipeline, sm_count)
    timed_phase(phase_recovery, sm_count)
    SHAPES.clear()
    for phase in (phase_zamba2, phase_xlstm, phase_dense, phase_moe_lm,
                  phase_whisper, phase_vlm, phase_train,
                  phase_train_vlm_encdec, phase_train_ssm,
                  phase_train_moe, phase_train_mesh):
        kernels += timed_phase(phase)
    kernels += timed_phase(phase_tp_dryrun, cli)
    kernels += timed_phase(phase_tp_recurrent)
    kernels += sched_kernels
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card_identity(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
