#!/usr/bin/env python3
"""Smoke run of the PyTorch port (`src/repro_torch`) on one CUDA card.

    python3 chip_smoke.py            # from the repository root

It drives the port's main paths — COMM-RAND training through `GNNTrainer`
of GraphSAGE, GCN and GAT, and GraphSAGE reading its layer-0 features
through the device-resident feature cache (paper §6.5), at the paper's
full model width on a Reddit-shaped graph; and LM serving (prefill plus
greedy decode) of gemma3-1b, of the mixture-of-experts qwen2-moe-a2.7b and
of the attention-free rwkv6-7b at full width — and holds every
hand-written kernel of those paths against its plain PyTorch version on
the card. Set-up builds one `presampled_freq` cache plan (frac 0.2) for
the cached run and prints its host time. Phases (any failure fails the
run, exit code != 0):

  1. device   torch / CUDA versions, the card, its power limit; TF32 off
  2. build    nvcc builds the kernels from `src/repro_torch/csrc`, one
              nvcc per source, all started together (timed)
  3. kernels  every kernel of each model's train step at that step's
              shapes, taken from a real batch: GraphSAGE's (fwd, bwd_dx;
              GCN's are the same), GAT's head-folded ones (fwd, bwd_dx,
              bwd_dw, with softmax weights) and the cached gather at the
              batch's input level (`node_ids`, the plan above): max error
              against the plain version (exactly 0 for the cached gather,
              a copy, whose autograd backward is also held against the
              plain one, and for fwd, held bit for bit against the plain
              version that adds in its order, `gather_agg_ref_ordered`),
              bit-determinism over two launches, and ms (CUDA
              events around 10 back-to-back calls, median of 5) beside the
              plain version, the equivalent PyTorch calls where there are
              any (fwd: `embedding_bag` and a CSR `torch.sparse.mm`, the
              faster counted; dw: `torch.sparse.sampled_addmm`;
              `index_select`; for bwd_dx `index_add_` of the pre-multiplied
              rows, which is atomic and so not deterministic), and the
              bound (compulsory bytes at 3.35 TB/s, flops at 67 TFLOP/s
              float32). At layer 0 of SAGE and GAT, `[3 reuse]` times fwd
              (and GAT's dw) at the real index, with no reuse (a distinct
              row per edge), with all reuse (idx % 4096) and with the
              destination rows permuted: where the layer stands between
              the L2 cache's floors. bwd_dx is
              checked per launch as the step makes it (SAGE: the aggregate
              and the self rows of layers 1 and 2; GAT: the folded
              aggregate, z_self and e_src of all three layers): through the
              layer's plan (one sort, shared by the aggregate and e_src) or,
              for the self rows, on the sort-free sorted path; bit-equal to
              the CPU plain version on every row of at most 64 edges,
              within tolerance on longer ones; its ms split into the
              kernel's and the plan's (counted once per layer)
  4. train    GraphSAGE (20 steps), cached GraphSAGE (10 steps), GCN and
              GAT (10 steps each), each followed by one `evaluate` of 3
              validation batches, on the reddit-602 graph with the same
              policy, caps and batches; the kernels' launch counters are
              zeroed just before each run and read just after, and must
              equal 3 per step + 3 per eval batch (forward), 4 per step
              (bwd_dx: the aggregate and the self-row gather at layers 1
              and 2; 9 for GAT: the aggregate, z_self and e_src at all
              three layers, whose layer 0 differentiates its projection),
              3 per step for GAT's bwd_dw, and 1 per step and
              eval batch for the cached gather in the cached run (0 in any
              other); the cached run's losses must equal the uncached
              GraphSAGE run's first 10 bit for bit, and its hits + misses
              the valid input nodes of its batches; then 3 more steps of
              each run under torch.profiler: CUDA kernels by device time
              per step and the device's idle share of an unprofiled step
              (no PyTorch `indexing_backward` kernel may show: every row
              gather's backward is the bwd_dx kernel), bwd_dx's own kernels
              and its sorts per step (2 for SAGE, cached SAGE and GCN, 3
              for GAT: one plan per layer whose input needs dx, also
              counted over each run); a second GAT trainer
              from the same seed repeats the run's first 3 losses bit for
              bit; last, a fresh uncached and a fresh cached GraphSAGE trainer
              take 10 steps in turns on the same batches (the cache's cost
              per step, without drift between runs)
  5. card vs CPU  5 guarded steps of GraphSAGE, of cached GraphSAGE and of
              GAT on the tiny graph, same parameters and batches on the
              card and on the CPU, agree within rtol 1e-4
  6. serve    gemma3-1b at full width (26 layers, d_model 1152, 4 query
              heads over 1 KV head of 256, vocab 262144; 999,826,048
              random parameters drawn as phase 7 draws them):
              `flash_attention_fwd` at the q, k, v a real prefill hands
              it at a global layer (5) and a local one (0, window 512),
              at a ragged length (2047) and in float32 — the route (bf16
              on the tensor-core kernel, float32 on the SIMT one), max
              error against the plain version (2e-2 bf16, 2e-5 float32)
              and, on the tensor-core route, against the emulation of its
              rounding points (p_bf16) within 2^-7 |emu| + 2^-10 max|v|,
              bit-identical relaunch, ms and TFLOP/s beside the plain
              version, `scaled_dot_product_attention` (its backend logged)
              and the bound (compulsory bytes at 3.35 TB/s, unmasked-pair
              flops at the bf16 tensor-core peak, or float32's); then one
              prefill
              and one decode step alone, and `generate` with batch 4,
              prompt 2048 and 32 greedy tokens, each with its launch
              counters zeroed just before and read just after: exactly 26
              per prefill, 0 per decode step, 0 for the other kernels;
              prefill and decode ms and tokens/s, KV cache MiB, peak
              memory, and one prefill and one decode step under
              torch.profiler (kernels by device time and launches, the
              flash kernel's share, the idle share; the prefill's flash
              time must be the tensor-core kernel's, and the SIMT kernel
              must not show); last,
              reduced gemma3-1b in float32 served on the card and on the
              CPU: prefill and 8 decode steps' logits within rtol 1e-4,
              greedy ids equal; and reduced gemma3-1b in bf16 at head_dim
              64 (the tensor-core flash route in every prefill layer):
              prefill and 8 decode steps' logits on the same tokens within
              5e-2 x max |logit| of the CPU bf16 model
  7. serve    qwen2-moe-a2.7b at full width (24 layers, d_model 2048, 16
              heads over 16 KV heads of 128 with qkv bias, 60 experts
              top-4 of d_ff 1408 plus a 5632-wide shared expert, vocab
              152064; 14,316,308,480 parameters drawn by a seeded
              generator on the card directly in bf16, norms and router
              float32): `moe_gmm_fwd` at the inputs a real prefill (C
              688, two dispatch groups of 344) and a real decode step (C
              8) hand the MoE layer's two ops at layer 0 (the gated one
              and the down product, both spied): gate, up and down with
              float32 output, in float32 at both gates, at a ragged shape
              (C 344, d 2040, f 1400) and at odd widths — the route each
              took (bf16 prefill and ragged: tensor_core; decode and odd
              widths: mma_sync; float32: simt), max error within 1e-3 x
              max |plain| (bf16) or 2e-5 x max |plain| (float32),
              bit-identical relaunch, ms beside the plain version,
              `torch.bmm` and the bound; then the layer's own launches,
              gated (h in bf16) and down (bf16 out), dense and with the
              path's real `rows`: the bf16 output equal to the float32
              one cast, the gated one to the composite of the same
              route's float32 outputs (elements that differ counted, at
              most one bf16 ulp), with `rows` equal to dense at the real
              rows and with one expert emptied and one full, ms dense
              and with rows, plain, `torch.bmm` of the same products,
              bounds dense and occupied (the rows and experts that hold
              tokens), TFLOP/s, decode's occupied experts and weight
              bytes read — and `flash_attention_fwd` at layer 0's q, k,
              v (D 128, 16 heads over 16; the tensor-core route, checked
              as in phase 6); then phase 6's serving run through
              `generate`: exactly 48 gmm (all tensor_core) and 24 flash
              launches per prefill, 48 gmm (all mma_sync) and 0 flash per
              decode step, 0 gather; the profile (the prefill's gmm time
              in the tensor-core kernel, decode's in the mma.sync one,
              never the float32 one; the tensor-core flash kernel's share,
              no SIMT flash kernel); reduced qwen2-moe-a2.7b in float32 on
              the card and on the CPU within rtol 1e-4, greedy ids equal;
              reduced qwen2-moe-a2.7b in bf16 at head_dim 64 with a
              prefill of 2 x 64 tokens (expert capacity 40: the grouped
              matmul's tensor-core route; decode's capacity 8 takes
              mma_sync) held as gemma3-1b's bf16 run
  8. serve    rwkv6-7b at full width (32 layers, d_model 4096, 64 WKV
              heads of 64, relu² channel mix of d_ff 14336, vocab 65536,
              untied head; 7,534,546,944 parameters drawn on the card in
              bf16, the norms, decay LoRA, bonus u and head norm ln_x
              float32): `wkv6_fwd` at the r, k, v, logw, u a real prefill
              hands it at layer 0 (T 2048, from zeros), at a ragged T
              (2047), at T 1 and at T 2048 from the prefill's non-zero
              final state, in float32, and at batch 1 with the head cut to
              N 32 (32 of the kernel's 64 columns empty, 32 blocks for
              132 SMs) — max error of the output and
              of the final state within 2e-5 x max |plain| (bf16 inputs
              as float32: both sides work in float32 from the same
              values), bit-identical relaunch, ms beside the plain
              version and the bound (the causal work only; no PyTorch call
              computes WKV6: library_ms null); then phase 6's serving run
              through `generate`: exactly 32 `wkv6_fwd` launches per
              prefill, 0 per decode step (the recurrence in plain
              PyTorch), 0 flash, gmm and gather; the state cache's MiB;
              the profile (the kernel's share); reduced rwkv6-7b in
              float32 on the card and on the CPU within rtol 1e-4, greedy
              ids equal

  9. resume and the dynamic cache, on the reddit-602 graph after phase 5
              (run between phases 5 and 6, while the graph is loaded):
              (a) GraphSAGE 2 epochs (302 steps) with `cache` a dynamic
              CLOCK state seeded from phase 4's plan (46,593 slots), the
              static plan and the uncached run on the same batches: the
              302 losses bit-identical across the three, epoch 0's hits
              and misses equal between dynamic and static, both runs'
              epoch-1 hit rates printed, launches exactly 3 fwd, 4 bwd_dx
              and 1 cached gather a step and 2 `clock_refill` (one per
              epoch boundary, words resident in shared memory); the
              first boundary's refill again on its pre-refill state
              (spied): equal to the trainer's, and to the plain walk and
              row copy on a CPU copy, slot for slot and row for row; then
              a synthetic CLOCK state at ogbn-products' scale with
              uniform counts (N 2,449,029, C 489,805, words streamed):
              card = plain walk on a CPU copy, rows on the card, relaunch
              bit-identical; for both, `dynamic.refill` whole on the host
              clock (synced), split into the candidate sort and the C
              call (events), its prepare / walk / apply kernels
              (profiler), the admitted count's read and the clone and row
              copy; the admitted rows, the walk's steps and visits, the
              windows its warp decided (the kernel's count, equal to the
              windowed plain decomposition's), ns a visit and a window,
              the plain walk's ms, the bounds; (b) resume:
              checkpoints every 100 steps, a trainer stops at 100, a
              fresh one resumes and crosses the refill to 230, a third
              resumes at 200 and runs to 230: each one's losses equal
              (a)'s bit for bit, and its weights and CLOCK state (rows
              too) at 230 equal (a)'s; a
              save's and a restore's ms and MB; (c) chaos: a NaN burst at
              steps 16-17 with GuardConfig(max_consecutive_skips=1) and a
              checkpoint every 10 steps over 40 steps makes exactly one
              rollback and (a)'s losses; `cache_corrupt` at epoch 0's
              refill degrades to the uncached gather and the losses stay
              the uncached run's; (d) phase 5's tiny run with the dynamic
              cache saves on the card, a CPU trainer restores it (weights
              and CLOCK state equal) and both take 5 more steps within
              rtol 1e-4
  10. the async pipeline and the tracer, on the reddit-602 graph after
              phase 9 (`repro_torch.pipeline`, `repro_torch.obs`): (a) 40
              GraphSAGE steps with `pipeline="async"` against 40 with
              "sync" on the same cursor, losses bit-identical and launches
              exactly 3 fwd and 4 bwd_dx a step; then async with phase 9's
              dynamic CLOCK state, `run_epoch` (151 steps) and 9 more,
              against 160 sync steps: the epoch's mean loss, the 9 losses,
              the CLOCK state and weights at 160 equal, 1 `clock_refill`;
              (b) paired timing sync, async, sync, async on the same
              batches (20 steps of `train_steps(1)` for the median step,
              then one `train_steps(20)`), the queue's `queue_get_wait` a
              step from the span tracer, 3 profiled steps of each for the
              device idle share; the device epoch order's ms (events)
              against numpy's (host), `builder.build` and `stage_times`;
              (c) a traced async epoch with the dynamic cache, guard and
              checkpoints off: `obs.report.analyze` finds overlap > 0, no
              mid-epoch sync, no conformance problem, and the epoch equals
              the untraced one (mean loss, CLOCK state, weights); (d) the
              watchdog: a `batch_build` fault mid-epoch and (after
              `prime()`, `stall_timeout_s` 1.0) a `producer_hang` each make
              exactly 1 producer restart and sync's losses; a build that
              always fails exhausts the 3-restart budget and raises the
              real `InjectedFault`
  11. the prior-work policies, samplers and baselines (paper §6.3), on
              the reddit-602 graph after phase 10: (a) the uniform, full
              and labor samplers on the card against their plain runs on a
              CPU copy of the graph at the hop shapes of a LABOR batch at
              its calibrated caps (the same uniforms, the same ranks): src
              and mask equal; the LABOR ranks of every node equal on card,
              CPU and numpy; (b) GraphSAGE with `make_policy("labor")` at
              its calibrated caps, 20 sync steps, then 20 async steps on
              the same cursor with bit-identical losses, 3 fwd and 4 bwd_dx
              a step, the ranks hashed once an epoch a stream, caps, step
              times, idle share; (c) 5 steps of rand roots through a policy
              binding the `full` sampler at fanout (10, 10, 10); (d)
              `train_clustergcn`, 1 epoch at 2 communities a part: epoch
              time, parts, caps, peak memory, 3 fwd and 5 bwd_dx a part
              (a layer's virtual-row means, their segment sum, and the
              backward of layers 1 and 2) and 3 fwd and 3 bwd_dx an
              evaluated union, one bwd_dx plan a part, a second run's loss and
              accuracy bit-identical, a profiled part step with no atomic
              scatter or index backward kernel; (e) `train_fullbatch`, 3
              epochs: the same checks (one plan for the run), the
              validation accuracy curve, two fresh trainers' losses
              bit-identical, and gather_agg fwd (layer 0), the segment
              sum and bwd_dx (layer 1) at the full batch's virtual rows
              against their plain versions, with CSR `torch.sparse.mm`
              and the bound; (f) `gather_mean` at that shape against its
              plain version
  12. the chaos soak and LM training, after phase 8: (a)
              `resilience.soak` on the tiny graph at its own configuration
              (comm_rand x LABOR, dynamic:degree_hot cache, guarded, async):
              the fault-free sync reference, then one fault of each of the
              five classes, each `ok` (fired, its meter engaged, losses
              and parameter digest bit-identical), with its seconds; (b)
              the flash kernels at gemma3-1b's training shapes (batch 4 x
              4096, 4 heads over 1 KV head of 256) on a global (causal)
              and a local (window 512) layer, bf16 and float32: the
              forward's lse against `attention_lse_ref`, serving's output
              bit-identical with and without the lse pointer,
              `flash_attention_bwd` against `flash_attention_bwd_ref`
              (float32 within rtol 1e-4 of max |grad|, bf16 within 2e-2 of
              it), a bit-identical relaunch, ms beside the plain version,
              SDPA's backward and the bound; bwd_dx at the token
              embedding's shape; (c) gemma3-1b at full width, float32
              masters, bf16 compute, remat, AdamW lr 1e-3, 6 steps at
              batch 4 x 4096 of `SyntheticTokens`: finite losses, exact
              launches a step (52 flash forwards, 26 backwards, 1 bwd_dx),
              median step ms on the host clock through a read of the loss,
              peak GiB, a profiled step's kernel ms and idle share with no
              `indexing_backward` kernel, and a second run from the same
              seed with bit-identical losses; (d) reduced gemma3-1b in
              float32, 5 steps on the card and on the CPU within rtol
              1e-4; (e) `LMTrainer` on the reduced config: 6 steps with a
              checkpoint every 3, a new trainer resuming for 3 more, the 9
              losses bit-identical to an uninterrupted run

  13. the analysis gate, after phase 11 on its graph: (a) the op audit
              (`repro_torch.analysis.op_audit`) on the card at the tiny
              graph's shapes — donation, kernels (gather_agg and
              gather_cached forward and backward launch their kernels, as
              `LAUNCHES` and the profiler's kernel names show, with no
              sync, no float64 and no feature-shaped fallback; the csrc
              sources make no blocking runtime call), device_order,
              fused_build, train_step (hash-stable records, eval and
              `train_steps` syncs only in their windows) each ok,
              sharded_step waiting for ROADMAP item 10; (b) the sync
              gate: an 8-byte position (pageable) and an epoch's order
              (page-locked) copied to the card behind a running kernel
              return while it runs; 10 steps each of GraphSAGE sync and
              async, with the
              phase-4 plan as a static cache, with it as a dynamic cache
              across the end of epoch 0 and its refill, GCN, GAT and
              LABOR (phase 11's caps), at the phase-4 widths on the
              reddit-602 graph, from fresh trainers; each run ungated,
              then gated under `torch.cuda.set_sync_debug_mode("error")`
              (the sync run evaluates 3 batches too): the allowed syncs
              by window equal `promised_reads`, losses (and the eval)
              bit-identical to the ungated run's, launches exactly phase
              4's counts a step, median step ms gated and ungated; (c)
              the repairs: with the parent's per-batch root copy, and with
              the parent's AdamW (`torch.tensor(b, device=)` bases), a
              gated GraphSAGE step raises; 10 ungated steps of parent and
              change in turns, twice each: losses bit-identical, median ms

It prints the `{"kernels": [...]}` line before the last, and as the last
line `{"ok": true, "device": {...}}`. Without a CUDA device, or outside a
checkout of the repository, it exits non-zero and prints no result.
"""
from __future__ import annotations

import contextlib
import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

HBM_BYTES_PER_S = 3.35e12     # H100 SXM device memory (NVIDIA data sheet)
F32_FLOPS_PER_S = 67e12       # H100 SXM float32 outside the tensor cores
BF16_FLOPS_PER_S = 989e12     # H100 SXM dense bf16 tensor cores (NVIDIA
#                               data sheet)
EVAL_BATCHES, CPU_STEPS = 3, 5
CACHE_FRAC = 0.2
# the runs of the main path: the config trained at full width
# (repro_torch.configs.CONFIGS), its steps, the bwd_dx / bwd_dw launches
# each step makes, and whether layer 0 reads through the feature cache
RUNS = {"graphsage": ("graphsage", 20, 4, 0, False),
        "graphsage_cached": ("graphsage", 10, 4, 0, True),
        "gcn": ("gcn", 10, 4, 0, False),
        "gat": ("gat", 10, 9, 3, False)}
# bwd_dx plans (one sort each) per train step: one per layer whose input
# needs dx (SAGE's and GCN's layer 0 reads the feature matrix); the self
# rows' backward sorts nothing
PLANS_PER_STEP = {"graphsage": 2, "graphsage_cached": 2, "gcn": 2, "gat": 3}
# the CUDA kernels of a bwd_dx call (one cooperative kernel for a small
# call, else the rows and combine kernels) and of its plan (the ids to
# sort, CUB's radix sort, the run offsets)
DX_KERNELS = ("bwd_dx_kernel", "bwd_dx_rows_kernel", "bwd_dx_combine_kernel",
              "bwd_dx_iota_kernel", "bwd_dx_plan_kernel")
# every CUB radix sort (torch.sort's and a plan's) launches one of these
SORT_KERNEL = "RadixSortHistogramKernel"
# LM serving: the reference's prefill_32k shape (32 x 32768,
# `src/repro/configs/base.py:146-151`) cut to batch 4 x prompt 2048 to fit
# this script's time limit, then 32 greedy tokens
SERVE = "gemma3-1b_serve"
SERVE_BATCH, SERVE_PROMPT, SERVE_NEW = 4, 2048, 32
SERVE_GLOBAL, SERVE_LOCAL = 5, 0       # layers whose attention is checked
# MoE serving: qwen2-moe-a2.7b at the same batch, prompt and tokens
MOE = "qwen2-moe-a2.7b"
MOE_SERVE, MOE_DECODE = f"{MOE}_serve", f"{MOE}_decode"
# RWKV serving: rwkv6-7b at the same batch, prompt and tokens
RWKV = "rwkv6-7b"
RWKV_SERVE = f"{RWKV}_serve"
SERVE_PARAMS = {"gemma3-1b": 999_826_048, MOE: 14_316_308_480,
                RWKV: 7_534_546_944}
# LM training: the reference's train_4k shape (batch 256 x 4096,
# `src/repro/configs/base.py:147`) cut to the batch one card holds with
# float32 masters, AdamW moments and remat: 4 x 4096, 6 steps
TRAIN = "gemma3-1b_train"
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 4, 4096, 6
# what one reading of each path sums over
PER = {**{run: "train step" for run in RUNS}, SERVE: "prefill",
       MOE_SERVE: "prefill", MOE_DECODE: "decode step",
       RWKV_SERVE: "prefill", "graphsage_dynamic": "epoch-boundary refill",
       TRAIN: "train step"}
DEVICE = "cuda"
# the CUDA names of the flash kernels: the bf16 prefills must spend their
# attention time in the tensor-core one and never in the SIMT one
FLASH_TC, FLASH_SIMT = "flash_fwd_tc_kernel", "flash_fwd_kernel"
# ... and of the grouped matmul's routes: the qwen2-moe prefill must run
# the tensor-core one only, its decode step the mma.sync one only
GMM_TC, GMM_MMA, GMM_SIMT = "gmm_tc_kernel", "gmm_mma_kernel", \
    "gmm_f32_kernel"
# ... and of the flash backward's routes: the bf16 train step must spend
# its backward time in the tensor-core kernels and never in the SIMT ones
BWD_TC = ("dkdv_tc_kernel", "dq_tc_kernel")
BWD_SIMT = ("::dkdv_kernel", "::dq_kernel")
REPLACES = {
    "gather_agg_fwd": "src/repro/kernels/gather_agg/kernel.py:56",
    "gather_agg_bwd_dx": "src/repro/kernels/gather_agg/kernel.py:101",
    "gather_agg_bwd_dw": "src/repro/kernels/gather_agg/kernel.py:151",
    "gather_cached_fwd": "src/repro/kernels/gather_cached/kernel.py:44",
    "flash_attention_fwd": "src/repro/kernels/flash_attention/kernel.py:65",
    "moe_gmm_fwd": "src/repro/kernels/moe_gmm/kernel.py:27",
    "wkv6_fwd": "src/repro/kernels/rwkv6_chunk/kernel.py:55",
    "clock_refill": "src/repro/featcache/dynamic.py:184 (_refill_jit: a "
                    "jitted lax.scan, not a Pallas kernel)",
    "flash_attention_bwd": "src/repro/models/lm/attention.py:107 "
                           "(_flash_bwd: a jnp custom VJP, not a Pallas "
                           "kernel)",
}
SOURCES = {"gather_agg_fwd": "src/repro_torch/csrc/gather_agg.cu",
           "gather_agg_bwd_dx": "src/repro_torch/csrc/gather_agg.cu",
           "gather_agg_bwd_dw": "src/repro_torch/csrc/gather_agg.cu",
           "gather_cached_fwd": "src/repro_torch/csrc/gather_cached.cu",
           "flash_attention_fwd": "src/repro_torch/csrc/flash_attention.cu",
           "moe_gmm_fwd": "src/repro_torch/csrc/moe_gmm.cu",
           "wkv6_fwd": "src/repro_torch/csrc/wkv6.cu",
           "clock_refill": "src/repro_torch/csrc/clock_refill.cu",
           "flash_attention_bwd":
               "src/repro_torch/csrc/flash_attention_bwd.cu"}


def log(msg: str) -> None:
    print(msg, flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {msg}")


def kernel_modules():
    """The wrapper modules of every kernel; each counts its launches."""
    from repro_torch.kernels.clock_refill import kernel as walk_kernel
    from repro_torch.kernels.flash_attention import kernel as flash_kernel
    from repro_torch.kernels.gather_agg import kernel
    from repro_torch.kernels.gather_cached import kernel as cached_kernel
    from repro_torch.kernels.moe_gmm import kernel as gmm_kernel
    from repro_torch.kernels.rwkv6_chunk import kernel as wkv_kernel
    return (kernel, cached_kernel, flash_kernel, gmm_kernel, wkv_kernel,
            walk_kernel)


def reset_launches() -> None:
    for m in kernel_modules():
        m.reset_launches()


def read_launches():
    return {k: n for m in kernel_modules() for k, n in m.LAUNCHES.items()}


def reddit_spec():
    """Reddit's node count, feature width and class count; the average
    degree is cut from about 492 to 50 to bound host set-up time."""
    from repro_torch.graphs.synthetic import SBMSpec
    return SBMSpec("reddit-602", 232_965, 50, 50.0, 0.9, 602, 41,
                   train_frac=0.66, val_frac=0.10, seed=1)


# ---------------------------------------------------------------------------
# phase 1 / 2
# ---------------------------------------------------------------------------
def phase_device(torch) -> str:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    name = torch.cuda.get_device_name(0)
    log(f"[1 device] python {sys.version.split()[0]}  torch "
        f"{torch.__version__}  cuda {torch.version.cuda}  card {name}  "
        f"count {torch.cuda.device_count()}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    log(smi)
    return name


def phase_build() -> float:
    from repro_torch.kernels import build
    t0 = time.perf_counter()
    build.build_all()
    dt = time.perf_counter() - t0
    log(f"[2 build] nvcc {build.NVCC_FLAGS[1]}: {dt:.2f} s")
    return dt


# ---------------------------------------------------------------------------
# phase 3: the kernels at the main path's shapes
# ---------------------------------------------------------------------------
def cuda_ms(torch, fn, reps: int = 10, rounds: int = 5,
            warmup: int = 3) -> float:
    """Device time per call: CUDA events around `reps` back-to-back calls,
    the median over `rounds`."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(rounds):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return statistics.median(times)


def host_ms(torch, fn, reps: int = 100) -> float:
    """Host time per call: `reps` back-to-back calls on the host clock with
    no synchronise between them (the launches queue up). A kernel whose
    `cuda_ms` is no larger than this is waiting on the host."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    dt = (time.perf_counter() - t0) / reps * 1e3
    torch.cuda.synchronize()
    return dt


def typical_batch(trainer):
    """The batch of median footprint among five spread over epoch 0: the
    caps fit the largest batches, and a comm_rand batch's real node count
    varies with the communities its roots come from."""
    stream = trainer.stream
    roots = stream.root_batches(0)
    cands = []
    for pos in sorted({round(k * (len(roots) - 1) / 4) for k in range(5)}):
        b = stream.build(roots[pos], 0, pos)
        cands.append((int(b.num_unique), pos, b))
    cands.sort(key=lambda c: c[0])
    n, pos, batch = cands[len(cands) // 2]
    log(f"[3 kernels] input-level nodes of batches "
        f"{[(c[1], c[0]) for c in sorted(cands, key=lambda c: c[1])]} "
        f"(cap {stream.caps[-1]}); timing batch {pos} ({n} nodes)")
    return batch


def self_gather(torch, i, tag, x, idx, g, plan=None):
    """The bwd_dx launch of a row gather's backward: fanout 1, unit
    weights, x viewed as (n_src, F); `gather_sorted_rows` (the self rows,
    no plan) or `gather_rows` through the layer's `plan`."""
    M = idx.numel()
    return {"layer": f"{i} {tag}", "x": x.reshape(x.shape[0], -1),
            "idx": torch.clamp(idx.reshape(M, 1).to(torch.int32), 0,
                               x.shape[0] - 1).contiguous(),
            "w": None, "g": g.reshape(M, -1), "needs_fwd": False,
            "needs_dx": True, "needs_dw": False, "plan": plan}


def dx_plan(torch, key, idx, n_src, heads=1):
    """What the main path hands bwd_dx as its plan: the layer's `DxPlan`
    of src_pos (`key` names it: built once per layer, shared by the
    launches that name the same key), folded to `heads`."""
    return {"key": key, "idx": torch.clamp(idx.to(torch.int32), 0,
                                           n_src - 1).contiguous(),
            "n_src": n_src, "heads": heads}


def main_path_layers(torch, trainer, batch):
    """The (x, idx, w) each SAGE layer hands `gather_agg` in a train step,
    from a real batch: layer 0 gathers from the global feature matrix
    through composed ids; layers 1 and 2 from hidden activations (random
    values of the real width, from a seeded generator), whose self rows'
    gather (`gather_sorted_rows`, no plan) also takes a bwd_dx launch; the
    aggregate's takes the layer's plan. GCN's calls have the same shapes,
    with degree-normalised weights."""
    gen = torch.Generator(device=trainer.device).manual_seed(0)
    layers = []
    x = trainer.feats
    for i, block in enumerate(batch.blocks):
        if i == 0:
            gid = torch.clamp(batch.node_ids, max=x.shape[0] - 1)
            idx = gid[block.src_pos]
        else:
            x = torch.randn((batch.blocks[i - 1].src_pos.shape[0],
                             trainer.cfg.hidden_dim), generator=gen,
                            device=trainer.device)
            idx = block.src_pos
        m = block.edge_mask.to(torch.float32)
        w = m / torch.clamp(m.sum(dim=1, keepdim=True), min=1.0)
        idx = torch.clamp(idx.to(torch.int32), 0, x.shape[0] - 1)
        g = torch.randn((idx.shape[0], x.shape[1]), generator=gen,
                        device=trainer.device)
        layers.append({"layer": i, "x": x, "idx": idx.contiguous(),
                       "w": w.contiguous(), "g": g, "needs_fwd": True,
                       "needs_dx": i > 0, "needs_dw": False,
                       "plan": dx_plan(torch, f"sage {i}", idx, x.shape[0])})
        if i > 0:
            layers.append(self_gather(torch, i, "self", x, block.self_pos,
                                      torch.randn_like(g)))
    return layers


def gat_layers(torch, trainer, batch, cfg):
    """The (zf, idx2, alpha) each GAT layer hands `gather_agg` in a train
    step, from a real batch: row s*H + h of zf is head h of source s
    (random values of the real width, from a seeded generator),
    idx2 = src_pos * H + h, and alpha a softmax over the row's unmasked
    neighbours and its self slot (masked slots exactly 0), as `gat_layer`
    makes it. g is the cotangent of the (n_dst*H, dh) out; every layer
    differentiates zf (z = x W, at layer 0 too) and alpha, and takes two
    more bwd_dx launches for its row gathers z_self = z[self_pos]
    (`gather_sorted_rows`, no plan) and e_src = s_src[src_pos]
    (`gather_rows`); e_src and the aggregate (folded to H heads) share the
    layer's one plan of src_pos."""
    gen = torch.Generator(device=trainer.device).manual_seed(1)
    H = cfg.gat_heads
    dims = [cfg.in_dim] + [cfg.hidden_dim] * (cfg.num_layers - 1) \
        + [cfg.num_classes]
    heads = torch.arange(H, dtype=torch.int32, device=trainer.device)
    n_src = batch.node_ids.shape[0]
    layers = []
    for i, block in enumerate(batch.blocks):
        dh = max(dims[i + 1] // H, 1)
        zf = torch.randn((n_src * H, dh), generator=gen,
                         device=trainer.device)
        n_dst, r = block.src_pos.shape
        idx = (block.src_pos[:, None, :] * H + heads[None, :, None])
        idx = torch.clamp(idx.reshape(n_dst * H, r), 0, n_src * H - 1)
        e = torch.randn((n_dst, H, r + 1), generator=gen,
                        device=trainer.device)
        e[:, :, :r].masked_fill_(~block.edge_mask[:, None, :], -1e30)
        w = torch.softmax(e, dim=-1)[:, :, :r].reshape(n_dst * H, r)
        g = torch.randn((n_dst * H, dh), generator=gen,
                        device=trainer.device)
        plan = dx_plan(torch, f"gat {i}", block.src_pos, n_src)
        layers.append({"layer": i, "x": zf, "idx": idx.contiguous(),
                       "w": w.contiguous(), "g": g, "needs_fwd": True,
                       "needs_dx": True, "needs_dw": True,
                       "plan": {**plan, "heads": H}})
        layers.append(self_gather(
            torch, i, "z_self", zf.reshape(n_src, H * dh), block.self_pos,
            torch.randn((n_dst, H * dh), generator=gen,
                        device=trainer.device)))
        layers.append(self_gather(
            torch, i, "e_src", torch.randn((n_src, H), generator=gen,
                                           device=trainer.device),
            block.src_pos, torch.randn((n_dst, r, H), generator=gen,
                                       device=trainer.device), plan))
        n_src = n_dst
    return layers


def _bound_ms(n_bytes: float, flops: float,
              flops_per_s: float = F32_FLOPS_PER_S):
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / flops_per_s * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else
                                 "operations")


def csr_of(torch, idx, values, n_src):
    """The CSR matrix (n_dst, n_src) whose row i holds `values[i, j]` at
    column idx[i, j]: the index as it is (repeated and unsorted columns),
    built outside any timed call."""
    n_dst, r = idx.shape
    crow = torch.arange(0, n_dst * r + 1, r, dtype=torch.int32,
                        device=idx.device)
    return torch.sparse_csr_tensor(crow, idx.reshape(-1),
                                   values.reshape(-1), (n_dst, n_src),
                                   check_invariants=False)


def check_fwd(torch, L):
    """Bit for bit against the plain version that adds in the kernel's own
    order (`gather_agg_ref_ordered`); its difference from the unordered
    plain version (`gather_agg_ref`) is printed. Library calls: one
    `embedding_bag` and one CSR `torch.sparse.mm` (cuSPARSE SpMM); the
    faster is `library_ms`."""
    import torch.nn.functional as Fn

    from repro_torch.kernels.gather_agg import kernel, ref
    x, idx, w = L["x"], L["idx"], L["w"]
    n_dst, r = idx.shape
    F = x.shape[1]
    out = kernel.gather_agg_fwd(x, idx, w)
    want = ref.gather_agg_ref_ordered(x, idx, w)
    err = (out - want).abs().max().item()
    plain_err = (out - ref.gather_agg_ref(x, idx, w)).abs().max().item()
    check(torch.isfinite(out).all().item(), "fwd: non-finite")
    check(torch.equal(out, want),
          f"fwd differs from the ordered plain version (max abs err {err})")
    check(torch.equal(out, kernel.gather_agg_fwd(x, idx, w)),
          "fwd differs between launches")
    idx64 = idx.long()
    lib = Fn.embedding_bag(idx64, x, per_sample_weights=w, mode="sum")
    lib_err = (lib - want).abs().max().item()
    A = csr_of(torch, idx, w, x.shape[0])
    spmm_err = (torch.sparse.mm(A, x) - want).abs().max().item()
    rows = torch.unique(idx).numel()
    b_ms, b_by = _bound_ms(rows * F * 4 + idx.numel() * 8 + n_dst * F * 4,
                           2.0 * n_dst * r * F)
    libs = {"embedding_bag": cuda_ms(torch, lambda: Fn.embedding_bag(
                idx64, x, per_sample_weights=w, mode="sum")),
            "sparse.mm": cuda_ms(torch, lambda: torch.sparse.mm(A, x))}
    h_ms = host_ms(torch, lambda: kernel.gather_agg_fwd(x, idx, w))
    return {"max_abs_err": err, "bound_ms": b_ms, "bound_by": b_by,
            "ms": cuda_ms(torch, lambda: kernel.gather_agg_fwd(x, idx, w)),
            "plain_ms": cuda_ms(torch, lambda: ref.gather_agg_ref(x, idx, w)),
            "library_ms": min(libs.values()), "libraries": libs,
            "note": f"x {x.shape[0]}x{F} idx {n_dst}x{r} rows read {rows}  "
                    f"host_ms {h_ms:.4f}  "
                    f"bit-equal to the ordered plain version (unordered: "
                    f"{plain_err:.3e}); embedding_bag {libs['embedding_bag']:.4f}"
                    f" ms (err {lib_err:.3e}), CSR sparse.mm "
                    f"{libs['sparse.mm']:.4f} ms (err {spmm_err:.3e})"}


def reuse_probe(torch, L, kinds):
    """What the L2 cache is worth to fwd (and dw) at a layer's shapes: ms at
    (a) the real index, (b) no reuse (every edge on its own row of a table
    of n_dst * r rows, in random order), (c) all reuse (idx % 4096: rows
    that fit the L2), (d) the destination rows randomly permuted (what the
    level order is worth). Nothing is checked: it reads where a layer
    stands between its floors."""
    from repro_torch.kernels.gather_agg import kernel
    x, idx, w, g = L["x"], L["idx"], L["w"], L["g"]
    n_dst, r = idx.shape
    gen = torch.Generator(device=x.device).manual_seed(5)
    table = torch.randn((n_dst * r, x.shape[1]), generator=gen,
                        device=x.device)
    perm = torch.randperm(n_dst, generator=gen, device=x.device)
    cases = {
        "(a) real": (x, idx, w, g),
        "(b) no reuse": (table, torch.randperm(
            n_dst * r, generator=gen, device=x.device).to(torch.int32)
            .reshape(n_dst, r), w, g),
        "(c) idx % 4096": (x, (idx % 4096).contiguous(), w, g),
        "(d) rows permuted": (x, idx[perm].contiguous(), w[perm].contiguous(),
                              g[perm].contiguous())}
    got = {}
    for name, kind in (("gather_agg_fwd", "fwd"), ("gather_agg_bwd_dw", "dw")):
        if kind not in kinds:
            continue
        got[name] = {
            case: cuda_ms(torch, (lambda a=a: kernel.gather_agg_fwd(
                a[0], a[1], a[2])) if kind == "fwd" else
                (lambda a=a: kernel.gather_agg_bwd_dw(a[0], a[1], a[3])))
            for case, a in cases.items()}
    del table
    return got


_PLANS = {}      # phase 3: the plan of each (path, layer), built once


def dx_launch(torch, L):
    """The bwd_dx call the main path makes for entry L, as a closure, and
    the plan ms it adds (the first entry of a plan's key only)."""
    from repro_torch.kernels.gather_agg import kernel
    idx, w, g = L["idx"], L["w"], L["g"]
    n_src = L["x"].shape[0]
    spec = L.get("plan")
    if spec is None:
        return (lambda: kernel.gather_agg_bwd_dx_sorted(idx, w, g, n_src),
                0.0, "sorted (no plan)")
    plan_ms = 0.0
    if spec["key"] not in _PLANS:
        _PLANS[spec["key"]] = kernel.bwd_dx_plan(spec["idx"], spec["n_src"])
        plan_ms = cuda_ms(torch, lambda: kernel.bwd_dx_plan(spec["idx"],
                                                            spec["n_src"]))
    plan = _PLANS[spec["key"]].folded(spec["heads"])
    return (lambda: kernel.gather_agg_bwd_dx(idx, w, g, n_src, plan),
            plan_ms, f"plan {spec['key']!r} x {spec['heads']} heads")


def check_dx(torch, L):
    """bwd_dx as the main path calls it, against the CPU plain version
    (index_add_ in edge order): rows of at most BWD_CHUNK edges bit for
    bit, longer ones within a tolerance that grows with the edges on the
    row; bit-identical relaunch. ms = the kernel's ms + the plan's ms at
    the plan's first launch (one plan per layer)."""
    from repro_torch.kernels.gather_agg import kernel, ref
    idx, w, g = L["idx"], L["w"], L["g"]
    n_src, F = L["x"].shape
    n_dst, r = idx.shape
    call, plan_ms, how = dx_launch(torch, L)
    dx = call()
    want = ref.gather_agg_bwd_dx_ref(idx.cpu(), None if w is None else
                                     w.cpu(), g.cpu(), n_src)
    got = dx.cpu()
    err = (got - want).abs().max().item()
    count = torch.bincount(idx.reshape(-1).long().cpu(), minlength=n_src)
    short = count <= kernel.BWD_CHUNK
    weighted = idx.reshape(-1) if w is None else idx[w != 0]
    terms = int(torch.bincount(weighted.long()).max())
    tol = max(1e-5, 1e-7 * terms)
    check(torch.isfinite(got).all().item(), "bwd_dx: non-finite")
    check(torch.equal(got[short], want[short]),
          f"bwd_dx differs from the CPU on rows of <= {kernel.BWD_CHUNK} "
          f"edges ({int((got[short] != want[short]).sum())} elements)")
    check(torch.allclose(got, want, rtol=tol, atol=tol),
          f"bwd_dx max abs err {err} (tol {tol})")
    check(torch.equal(dx, call()), "bwd_dx differs between launches")
    del got, want
    # compulsory bytes: g, idx (and w) read once, dx written once
    b_ms, b_by = _bound_ms(n_dst * F * 4 + idx.numel() * (4 if w is None
                                                          else 8)
                           + n_src * F * 4, 2.0 * n_dst * r * F)
    # the library call: one index_add_ of the rows w g, multiplied
    # beforehand (atomics: neither deterministic nor ordered)
    contrib = (g if w is None else
               (w[..., None] * g[:, None, :])).reshape(-1, F)
    flat, acc = idx.reshape(-1).long(), torch.zeros_like(dx)
    k_ms = cuda_ms(torch, call)
    return {"max_abs_err": err, "bound_ms": b_ms, "bound_by": b_by,
            "ms": k_ms + plan_ms, "kernel_ms": k_ms, "plan_ms": plan_ms,
            "plain_ms": cuda_ms(torch, lambda: ref.gather_agg_bwd_dx_ref(
                idx, w, g, n_src)),
            "library_ms": cuda_ms(torch, lambda: acc.index_add_(
                0, flat, contrib)),
            "note": f"dx {n_src}x{F} edges {n_dst}x{r}, {how} (at most "
                    f"{terms} weighted edges on a row, "
                    f"{int((~short).sum())} rows over {kernel.BWD_CHUNK}; "
                    f"bit-equal to the CPU on the {int(short.sum())} others;"
                    f" tol {tol:.1e}); kernel_ms {k_ms:.4f} plan_ms "
                    f"{plan_ms:.4f}; library: index_add_ of the "
                    f"pre-multiplied rows, atomic, not deterministic"}


def check_dw(torch, L):
    """Each dw entry is an F-term dot summed in another order than the
    plain version's: the two differ by at most
    2 * F * eps * sum_k |g[i, k] * x[idx[i, j], k]| (`scale` below). The
    library call: `torch.sparse.sampled_addmm` (cuSPARSE SDDMM) of the
    index's pattern with g and x^T, beta 0."""
    from repro_torch.kernels.gather_agg import kernel, ref
    x, idx, g = L["x"], L["idx"], L["g"]
    n_dst, r = idx.shape
    F = x.shape[1]
    eps = torch.finfo(torch.float32).eps
    dw = kernel.gather_agg_bwd_dw(x, idx, g)
    want = ref.gather_agg_bwd_dw_ref(x, idx, g)
    scale = ref.gather_agg_bwd_dw_ref(x.abs(), idx, g.abs())
    err = (dw - want).abs().max().item()
    check(torch.isfinite(dw).all().item(), "bwd_dw: non-finite")
    check(((dw - want).abs() <= 2 * F * eps * scale).all().item(),
          f"bwd_dw max abs err {err}")
    check(torch.equal(dw, kernel.gather_agg_bwd_dw(x, idx, g)),
          "bwd_dw differs between launches")
    A = csr_of(torch, idx, torch.ones(idx.shape, device=x.device),
               x.shape[0])
    xt = x.t()
    sddmm = torch.sparse.sampled_addmm(A, g, xt, beta=0.0)
    sddmm_err = (sddmm.values().reshape(n_dst, r) - want).abs().max().item()
    rows = torch.unique(idx).numel()
    b_ms, b_by = _bound_ms(n_dst * F * 4 + rows * F * 4 + idx.numel() * 8,
                           2.0 * n_dst * r * F)
    h_ms = host_ms(torch, lambda: kernel.gather_agg_bwd_dw(x, idx, g))
    return {"max_abs_err": err, "bound_ms": b_ms, "bound_by": b_by,
            "ms": cuda_ms(torch, lambda: kernel.gather_agg_bwd_dw(x, idx, g)),
            "plain_ms": cuda_ms(torch, lambda: ref.gather_agg_bwd_dw_ref(
                x, idx, g)),
            "library_ms": cuda_ms(torch, lambda: torch.sparse.sampled_addmm(
                A, g, xt, beta=0.0)),
            "note": f"zf {x.shape[0]}x{F} idx {n_dst}x{r} rows read {rows}  "
                    f"host_ms {h_ms:.4f}  "
                    f"library: sampled_addmm (err {sddmm_err:.3e})"}


def cached_layer(torch, trainer, batch, plan):
    """What the cached run hands `gather_cached` at layer 0 of a train
    step: the plan on the card, the global features and the batch's
    input-level ids (padded with the sentinel N)."""
    return {"layer": 0, "cache": plan.cache, "x": trainer.feats,
            "pos": plan.pos, "ids": batch.node_ids.to(torch.int32)}


def check_cached(torch, L):
    """A copy: the kernel must equal the plain version bit for bit and
    relaunch bit-identically. Its autograd backward (two fanout-1 bwd_dx
    launches) is held against autograd of the plain version within
    check_dx's tolerance: a row sums one cotangent per id on it (padding
    ids all land on the clipped row)."""
    from repro_torch.featcache import cache_stats, gather_cached
    from repro_torch.kernels.gather_cached import kernel, ref
    cache, feats, pos, ids = L["cache"], L["x"], L["pos"], L["ids"]
    N, F = feats.shape
    M = ids.shape[0]
    out = kernel.gather_cached_fwd(cache, feats, pos, ids)
    want = ref.gather_cached_ref(cache, feats, pos, ids)
    err = (out - want).abs().max().item()
    check(torch.equal(out, want), f"gather_cached_fwd max abs err {err}")
    check(torch.equal(out, kernel.gather_cached_fwd(cache, feats, pos, ids)),
          "gather_cached_fwd differs between launches")
    gid = ids.long().clamp(0, N - 1)
    check(torch.equal(torch.index_select(feats, 0, gid), want),
          "index_select differs from the plain version")
    g = torch.randn((M, F), device=feats.device,
                    generator=torch.Generator(device=feats.device)
                    .manual_seed(2))
    grads = []
    for fn in (lambda c, f: gather_cached(c, f, pos, ids)[0],
               lambda c, f: ref.gather_cached_ref(c, f, pos, ids)):
        c = cache.clone().requires_grad_()
        f = feats.clone().requires_grad_()
        (fn(c, f) * g).sum().backward()
        grads.append((c.grad, f.grad))
        del c, f
    terms = int(torch.bincount(gid).max())
    tol = max(1e-5, 1e-7 * terms)
    bwd_err = max((a - b).abs().max().item() for a, b in zip(*grads))
    for a, b in zip(*grads):
        check(torch.allclose(a, b, rtol=tol, atol=tol),
              f"gather_cached backward max abs err {bwd_err} (tol {tol})")
    del grads
    hits, misses = (int(t) for t in cache_stats(pos, ids, N))
    rows = torch.unique(gid).numel()
    # each distinct row read once (and its pos entry), each id read and
    # each output row written once
    b_ms, b_by = _bound_ms(rows * (F * 4 + 4) + M * 4 + M * F * 4, 0.0)
    return {"max_abs_err": err, "bound_ms": b_ms, "bound_by": b_by,
            "ms": cuda_ms(torch, lambda: kernel.gather_cached_fwd(
                cache, feats, pos, ids)),
            "plain_ms": cuda_ms(torch, lambda: ref.gather_cached_ref(
                cache, feats, pos, ids)),
            "library_ms": cuda_ms(torch, lambda: torch.index_select(
                feats, 0, gid)),
            "note": f"cache {cache.shape[0]}x{F} feats {N}x{F} ids {M} "
                    f"({hits} hits, {misses} misses, {M - hits - misses} "
                    f"padding; rows read {rows}); backward max abs err "
                    f"{bwd_err:.3e} (rtol = atol = {tol:.1e}); library: "
                    f"index_select"}


CHECKS = (("gather_agg_fwd", check_fwd, "needs_fwd"),
          ("gather_agg_bwd_dx", check_dx, "needs_dx"),
          ("gather_agg_bwd_dw", check_dw, "needs_dw"))
CACHED_CHECKS = (("gather_cached_fwd", check_cached, None),)


def phase_kernels(torch, path, layers, checks=CHECKS):
    """Every kernel a model's train step launches, at that step's shapes:
    max error against the plain version (a check failure ends the run),
    bit-identical relaunch, ms, plain ms, library ms and bound. Returns
    {kernel: readings summed over the layers (max_abs_err: the largest)}."""
    totals = {}
    for L in layers:
        if L["layer"] == 0 and checks is CHECKS:
            kinds = ("fwd", "dw") if L["needs_dw"] else ("fwd",)
            for name, ms in reuse_probe(torch, L, kinds).items():
                log(f"[3 reuse] {name} {path} layer 0 ms: " + "  ".join(
                    f"{case} {t:.4f}" for case, t in ms.items()))
        for name, fn, key in checks:
            if key is not None and not L[key]:
                continue
            got = fn(torch, L)
            log(f"[3 kernels] {name} {path} layer {L['layer']}: "
                f"{got['note']}  max_abs_err {got['max_abs_err']:.3e}  "
                f"bit-identical relaunch True  ms {got['ms']:.4f}  "
                f"plain_ms {got['plain_ms']:.4f}  library_ms "
                + ("null (no single PyTorch call computes it)"
                   if got["library_ms"] is None
                   else f"{got['library_ms']:.4f}")
                + f"  bound_ms {got['bound_ms']:.4f} ({got['bound_by']})")
            t = totals.setdefault(name, {
                "ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0,
                "max_abs_err": 0.0, "bound_by": set(),
                "library_ms": None if got["library_ms"] is None else 0.0,
                **{k: 0.0 for k in ("kernel_ms", "plan_ms") if k in got}})
            for k in ("ms", "plain_ms", "bound_ms", "kernel_ms", "plan_ms"):
                if k in got:
                    t[k] += got[k]
            if got["library_ms"] is not None:
                t["library_ms"] += got["library_ms"]
            for lib, ms in got.get("libraries", {}).items():
                t.setdefault("libraries", {}).setdefault(lib, 0.0)
                t["libraries"][lib] += ms
            t["max_abs_err"] = max(t["max_abs_err"], got["max_abs_err"])
            t["bound_by"].add(got["bound_by"])
    for name, t in totals.items():
        t["bound_by"] = "/".join(sorted(t["bound_by"]))
        if "plan_ms" not in t:
            libs = "  ".join(f"{k} {v:.4f}" for k, v in
                             t.get("libraries", {}).items())
            log(f"[3 kernels] {name} {path} per step: ms {t['ms']:.4f}  "
                f"library_ms "
                + ("null" if t["library_ms"] is None
                   else f"{t['library_ms']:.4f}")
                + (f" ({libs})" if libs else "")
                + f"  plain_ms {t['plain_ms']:.4f}  bound_ms "
                f"{t['bound_ms']:.4f}")
        if "plan_ms" in t:
            log(f"[3 kernels] {name} {path} per step: ms {t['ms']:.4f} = "
                f"kernels {t['kernel_ms']:.4f} + plans {t['plan_ms']:.4f}"
                f"  library_ms {t['library_ms']:.4f}  plain_ms "
                f"{t['plain_ms']:.4f}  bound_ms {t['bound_ms']:.4f}")
    return totals


# ---------------------------------------------------------------------------
# phase 4: the main path
# ---------------------------------------------------------------------------
def epoch_hit_rate(torch, trainer):
    """The cache plan's hit rate over every batch of epoch 0, from the
    device counters (`cache_stats`) of the batches the stream builds (pure
    in the cursor; nothing is trained)."""
    from repro_torch.featcache import cache_stats
    stream = trainer.stream
    roots = stream.root_batches(0)
    tot = torch.zeros(2, dtype=torch.int64, device=trainer.device)
    for p in range(len(roots)):
        ids = stream.build(roots[p], 0, p).node_ids
        tot += torch.stack(cache_stats(trainer.cache.pos, ids,
                                       trainer.graph.num_nodes))
    hits, misses = tot.tolist()
    return hits, misses, len(roots)


def phase_train(torch, graph, trainer, name, reference=None):
    """One run of the main path. A cached run's losses must equal the
    uncached run's on the same batches bit for bit (`reference`: that
    run's losses and step times)."""
    _, steps, dx_per_step, dw_per_step, cached = RUNS[name]
    bs = trainer.tcfg.batch_size
    val = graph.val_ids[:EVAL_BATCHES * bs]
    n_eval = -(-len(val) // bs)
    if name == "graphsage":
        # the batch build alone (pure in the cursor: it disturbs nothing)
        build_ms = []
        for pos in range(1, 6):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            trainer.stream.build(trainer.stream.root_batches(0)[pos], 0, pos)
            torch.cuda.synchronize()
            build_ms.append((time.perf_counter() - t0) * 1e3)
        log(f"[4 train] batch build alone: median "
            f"{statistics.median(build_ms):.2f} ms over 5 batches")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()                             # counts start here
    losses, step_ms = [], []
    for _ in range(steps):
        t0 = time.perf_counter()
        losses += trainer.train_steps(1)         # ends in one loss read
        step_ms.append((time.perf_counter() - t0) * 1e3)
    ev = trainer.evaluate(val)
    torch.cuda.synchronize()
    launches = read_launches()                   # ... and are read here
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    skipped = int(trainer.skips)
    log(f"[4 train] {name}: {steps} steps: first loss {losses[0]:.4f}  "
        f"last loss {losses[-1]:.4f}  median step "
        f"{statistics.median(step_ms):.2f} ms (first {step_ms[0]:.2f} ms)  "
        f"eval {n_eval} batches: loss {ev['loss']:.4f} acc {ev['acc']:.4f}"
        f"  peak memory {peak:.2f} GiB  skipped steps {skipped}  "
        f"launches {launches}")
    check(all(map(math.isfinite, losses)), f"{name}: non-finite loss")
    check(losses[-1] < losses[0], f"{name}: loss did not fall")
    check(math.isfinite(ev["loss"]), f"{name}: non-finite eval loss")
    check(skipped == 0, f"{name}: {skipped} skipped steps")
    want = {"gather_agg_fwd": 3 * steps + 3 * n_eval,
            "gather_agg_bwd_dx": dx_per_step * steps,
            "gather_agg_bwd_dw": dw_per_step * steps,
            "gather_cached_fwd": steps + n_eval if cached else 0,
            "flash_attention_fwd": 0, "flash_attention_bwd": 0,
            "moe_gmm_fwd": 0, "wkv6_fwd": 0, "clock_refill": 0}
    check(launches == want, f"{name}: launches {launches} != {want}")
    from repro_torch.kernels.gather_agg import kernel
    plans = kernel.PLANS["gather_agg_bwd_dx"]
    log(f"[4 train] {name}: bwd_dx plans (sorts) {plans} = "
        f"{plans / steps:g} a step")
    check(plans == PLANS_PER_STEP[name] * steps,
          f"{name}: {plans} bwd_dx plans != {PLANS_PER_STEP[name]} a step")
    if cached:
        meter = trainer.cache_meter
        # the valid input nodes of the run's batches, rebuilt (the build
        # is pure in the cursor)
        roots = trainer.stream.root_batches(0)
        valid = sum(int(trainer.stream.build(roots[p], 0, p).num_unique)
                    for p in range(steps))
        log(f"[4 train] {name}: {trainer.cache.describe()}  hit rate "
            f"{meter.hit_rate:.4f} ({meter.hits} hits, {meter.misses} "
            f"misses over {valid} valid input nodes of {steps} batches)")
        check(meter.total == valid,
              f"{name}: hits + misses {meter.total} != valid ids {valid}")
        ref_losses, ref_ms = reference
        ref = torch.tensor(ref_losses[:steps], dtype=torch.float64)
        check(torch.equal(torch.tensor(losses, dtype=torch.float64), ref),
              f"{name}: losses {losses} != uncached {ref_losses}")
        log(f"[4 train] {name}: {steps} losses bit-identical to the "
            f"uncached run's; median step {statistics.median(step_ms):.2f} "
            f"ms vs {statistics.median(ref_ms[:steps]):.2f} ms uncached on "
            f"the same {steps} batches")
        t0 = time.perf_counter()
        hits, misses, n = epoch_hit_rate(torch, trainer)
        log(f"[4 train] {name}: over all {n} batches of epoch 0 (built, not "
            f"trained): hit rate {hits / max(hits + misses, 1):.4f} "
            f"({hits} hits, {misses} misses; {time.perf_counter() - t0:.1f}"
            f" s)")
    return launches, step_ms, losses


def phase_paired(torch, make_trainer, plan, steps: int = 10):
    """What the cache costs per step, without the drift between runs made
    minutes apart: a fresh uncached and a fresh cached GraphSAGE trainer
    step through the same batches in turns (which one goes first
    alternates), each step ending in its loss read; the losses must agree
    bit for bit."""
    pair = (("uncached", make_trainer(None)), ("cached", make_trainer(plan)))
    ms = {name: [] for name, _ in pair}
    for k in range(steps):
        got = {}
        for name, trainer in (pair if k % 2 == 0 else pair[::-1]):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            got[name] = trainer.train_steps(1)
            ms[name].append((time.perf_counter() - t0) * 1e3)
        check(got["uncached"] == got["cached"],
              f"paired step {k}: losses {got} differ")
    med = {name: statistics.median(v) for name, v in ms.items()}
    log(f"[4 paired] graphsage vs graphsage_cached, {steps} steps each on "
        f"the same batches in turns: median step {med['uncached']:.2f} ms "
        f"uncached, {med['cached']:.2f} ms cached "
        f"({med['cached'] - med['uncached']:+.2f} ms); losses "
        f"bit-identical; per step uncached "
        f"{[round(t, 2) for t in ms['uncached']]} cached "
        f"{[round(t, 2) for t in ms['cached']]}")


def profile_kernels(torch, fn):
    """(CUDA kernels by self device time as (name, us, calls), wall ms) of
    one call of `fn` under torch.profiler."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    dev = [(e.key, e.self_device_time_total, e.count)
           for e in prof.key_averages() if e.self_device_time_total > 0
           and e.device_type == torch.autograd.DeviceType.CUDA]
    return sorted(dev, key=lambda d: -d[1]), wall_ms


def phase_profile(torch, trainer, name, step_ms: float, steps: int = 3,
                  top: int = 8):
    """Where a model's step goes: `steps` more train steps (after the
    launch counts were read) under torch.profiler; prints the CUDA kernels
    by device time per step and the device's idle share of a step,
    1 - kernel ms per step / the unprofiled median step `step_ms` (the
    profiler's own host overhead stretches its wall time, printed too)."""
    dev, wall_ms = profile_kernels(torch, lambda: trainer.train_steps(steps))
    busy_ms = sum(t for _, t, _ in dev) / steps / 1e3
    log(f"[4 profile] {name}: {steps} steps, kernels {busy_ms:.2f} ms/step, "
        f"device idle share {1 - busy_ms / step_ms:.3f} of the unprofiled "
        f"median step {step_ms:.2f} ms (profiled wall "
        f"{wall_ms / steps:.2f} ms/step)")
    for key, t, n in dev[:top]:
        log(f"[4 profile] {name}: {t / steps / 1e3:8.3f} ms/step  "
            f"{n / steps:6.1f} calls/step  {key[:110]}")
    slow = [key for key, _, _ in dev if "indexing_backward" in key]
    check(not slow, f"{name}: PyTorch's index backward ran: {slow}")
    # bwd_dx's own kernels, and its sorts: a step's radix sorts less the
    # batch build's (profiled alone), one per plan
    dx = [(k, t, n) for k, t, n in dev if any(d in k for d in DX_KERNELS)]
    for key, t, n in dx:
        log(f"[4 profile] {name}: bwd_dx {t / steps / 1e3:8.3f} ms/step  "
            f"{n / steps:6.1f} calls/step  {key[:90]}")
    dx_ms = sum(t for _, t, _ in dx) / steps / 1e3
    plan_calls = sum(n for k, _, n in dx if DX_KERNELS[4] in k) / steps

    def sorts(prof):
        return sum(n for k, _, n in prof if SORT_KERNEL in k)

    def most_sorts(fn, tries: int = 3):
        # a short profile now and then loses kernel records (seen: the
        # batch build's 3 sorts read as 2, a plan's 1 as 0); a lost record
        # only lowers a count, so the largest of a few profiles is the count
        return max(sorts(profile_kernels(torch, fn)[0]) for _ in range(tries))

    stream = trainer.stream
    build = most_sorts(lambda: stream.build(stream.root_batches(0)[1], 0, 1))
    from repro_torch.kernels.gather_agg import kernel
    idx = stream.build(stream.root_batches(0)[1], 0, 1).blocks[-1].src_pos
    n = int(idx.max()) + 1
    plan = most_sorts(lambda: kernel.bwd_dx_plan(idx, n))
    dx_sorts = sorts(dev) / steps - build
    log(f"[4 profile] {name}: bwd_dx kernels {dx_ms:.3f} ms/step "
        f"({dx_ms / busy_ms:.3f} of the kernel time), plans "
        f"{plan_calls:g}/step; radix sorts {sorts(dev) / steps:g}/step = "
        f"batch build {build} + bwd_dx plans {dx_sorts:g} (one "
        f"plan alone: {plan})")
    check(plan == 1 and plan_calls == PLANS_PER_STEP[name] and
          dx_sorts == PLANS_PER_STEP[name],
          f"{name}: {plan_calls} plans and {dx_sorts} plan sorts a step, "
          f"want {PLANS_PER_STEP[name]}")


def phase_relaunch(trainer_of, losses, name, steps: int = 3):
    """A second trainer from the same seed repeats the run's first `steps`
    losses bit for bit: every kernel of the step sums in a fixed order."""
    got = trainer_of().train_steps(steps)
    check(got == losses[:steps], f"{name}: relaunch losses {got} != "
          f"{losses[:steps]}")
    log(f"[4 train] {name}: a second trainer from the same seed repeats "
        f"the first {steps} losses bit for bit {got}")


# ---------------------------------------------------------------------------
# phase 5: card vs CPU on the tiny graph
# ---------------------------------------------------------------------------
def phase_card_vs_cpu(torch, g, model, cache=None):
    from repro_torch.configs import GNNConfig, TrainConfig
    from repro_torch.train.gnn_loop import GNNTrainer
    cfg = GNNConfig("tiny", model, 2, 32, g.feat_dim, g.num_classes,
                    fanout=(5, 5), dropout=0.0)
    tcfg = TrainConfig(batch_size=256)
    cpu = GNNTrainer(g, cfg, tcfg, "comm_rand", seed=0, cache=cache,
                     device="cpu")
    gpu = GNNTrainer(g, cfg, tcfg, "comm_rand", seed=0, caps=cpu.caps,
                     eval_caps=cpu.eval_caps, cache=cache, device=DEVICE)
    if cache is not None:
        check(torch.equal(cpu.cache.pos, gpu.cache.pos.cpu()),
              "card and CPU built other cache plans")
    for a, b in zip(cpu.params.parameters(), gpu.params.parameters()):
        check(torch.equal(a, b.cpu()), "card and CPU start from other params")
    # the stream's generators are the device's own, so both steps take the
    # CPU stream's batches
    it = iter(cpu.stream)
    worst = 0.0
    for _ in range(CPU_STEPS):
        b = next(it)
        lc, _ = cpu.train_step(b, tcfg.learning_rate)
        lg, _ = gpu.train_step(b.to(DEVICE), tcfg.learning_rate)
        lc, lg = float(lc), float(lg)
        worst = max(worst, abs(lg - lc) / abs(lc))
        check(abs(lg - lc) <= 1e-4 * abs(lc), f"card {lg} vs CPU {lc}")
    label = model if cache is None else f"{model} cache={cache}"
    log(f"[5 card vs cpu] {label}: {CPU_STEPS} steps on tiny: max "
        f"relative loss difference {worst:.3e} (limit 1e-4)")


# ---------------------------------------------------------------------------
# phase 9: resume and the dynamic cache (reddit-602 GraphSAGE)
# ---------------------------------------------------------------------------
DYN = "graphsage_dynamic"
RESUME_EVERY, RESUME_END = 100, 230     # checkpoints at 100 and 200
CHAOS_STEPS, CHAOS_EVERY, CHAOS_BURST = 40, 10, (15, 2)


class RefillSpy:
    """Wraps `featcache.dynamic.refill` (the trainer calls it through the
    module) and keeps every call's input state and result."""

    def __init__(self):
        from repro_torch.featcache import dynamic
        self.mod, self.orig, self.calls = dynamic, dynamic.refill, []

    def __enter__(self):
        def spy(state, feats):
            out = self.orig(state, feats)
            self.calls.append((state, out))
            return out
        self.mod.refill = spy
        return self

    def __exit__(self, *exc):
        self.mod.refill = self.orig


def cache_fields(cache):
    from repro_torch.featcache.dynamic import DynamicCacheState
    return {f: getattr(cache, f).clone()
            for f in DynamicCacheState.DATA_FIELDS}


def same_fields(torch, a, b) -> bool:
    return a.keys() == b.keys() and all(
        a[f].dtype == b[f].dtype and torch.equal(a[f], b[f]) for f in a)


def params_of(trainer):
    return [p.detach().clone() for p in trainer.params.parameters()]


def run_steps_tracked(trainer, n: int) -> list:
    """Losses of global steps 1..n, stepping one `train_steps(1)` at a
    time; a rollback rewinds the step counter and the replay overwrites."""
    losses, iters = {}, 0
    while trainer.global_step < n:
        prev = trainer.global_step
        (loss,) = trainer.train_steps(1)
        if trainer.global_step == prev + 1:
            losses[trainer.global_step] = loss
        iters += 1
        check(iters <= 4 * n, f"stuck at step {trainer.global_step}")
    return [losses[i] for i in range(1, n + 1)]


# the kernels of one `clock_refill` C call, by stage
REFILL_STAGES = {"prepare": ("clock_pack_kernel", "clock_scan_kernel",
                             "clock_runs_kernel"),
                 "walk": ("clock_walk_kernel",),
                 "apply": ("clock_apply_kernel",)}
PRODUCTS_F = 100                        # ogbn-products' feature width


def refill_args(state, feats) -> tuple:
    """`ops.clock_refill`'s arguments for a `DynamicCacheState`."""
    return (state.cache, state.pos, state.slot_ids, state.refbit,
            state.slot_freq, state.freq, state.hand, feats)


def refill_reading(torch, tag, state, feats, n, rows, walk):
    """Times of one refill of `state` (`n`, `rows`, `walk` its result on
    the card, already checked): `dynamic.refill` whole on the host clock
    (synced: the span, the op, the counters' reset); its split into the
    candidate sort, the C call's prepare / walk / apply kernels
    (torch.profiler), the admitted count's read and the clone and row
    copy; the windows the kernel's warp decided, held against the
    windowed decomposition on a CPU copy (steps, visits, windows); the
    plain walk; the walk's bound. Returns the reading."""
    from repro_torch.featcache import dynamic
    from repro_torch.kernels.clock_refill import kernel as walk_kernel
    from repro_torch.kernels.clock_refill import ops as refill_ops
    from repro_torch.kernels.clock_refill.ref import (clock_refill_ref,
                                                      clock_walk_windows)
    cache, pos, slot_ids, refbit, slot_freq, freq, hand, _ = refill_args(
        state, feats)
    N, C, F = pos.shape[0], slot_ids.shape[0], feats.shape[1]
    ms = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        dynamic.refill(state, feats)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    cand = refill_ops.refill_candidates(pos, freq, C)
    wargs = (pos, slot_ids, refbit, slot_freq, hand, *cand)
    sort_ms = cuda_ms(torch, lambda: refill_ops.refill_candidates(
        pos, freq, C), reps=5, rounds=3)
    call_ms = cuda_ms(torch, lambda: walk_kernel.clock_refill(*wargs),
                      reps=5, rounds=3, warmup=1)
    prof, _ = profile_kernels(torch, lambda: walk_kernel.clock_refill(*wargs))
    stage_ms = {st: sum(us for name, us, _ in prof
                        if any(k in name for k in names)) / 1e3
                for st, names in REFILL_STAGES.items()}
    rounds = torch.full((1,), -1, dtype=torch.int64, device=pos.device)
    walk_kernel.clock_refill(*wargs, rounds=rounds)
    windows = int(rounds)                    # the warp's own count
    reads = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        int(walk.n_admitted)
        reads.append((time.perf_counter() - t0) * 1e3)
    slots, nodes = walk.adm_slots[:n].long(), walk.adm_nodes[:n].long()

    def copy():
        out = cache.clone()
        out.index_copy_(0, slots, feats.index_select(0, nodes))
        return out
    check(torch.equal(copy(), rows), f"{tag}: the row copy differs")
    copy_ms = cuda_ms(torch, copy, reps=3, rounds=3)
    cpu_wargs = [a.cpu() for a in wargs]
    t0 = time.perf_counter()
    clock_refill_ref(*cpu_wargs)
    plain_ms = (time.perf_counter() - t0) * 1e3
    width = walk_kernel.window()
    plan = clock_walk_windows(cpu_wargs[2].numpy(), cpu_wargs[3].numpy(),
                              int(cpu_wargs[4]), cpu_wargs[6].numpy(), width)
    steps = int(walk.steps)
    check(plan.visits == steps + n and len(plan.adm_slots) == n and
          plan.windows == windows,
          f"{tag}: windowed decomposition at {width} visits a window: "
          f"{plan.visits} visits, {len(plan.adm_slots)} admitted, "
          f"{plan.windows} windows; the card {steps} + {n}, {windows}")
    used = min(len(cand[0]), n + 1)          # candidates the walk read
    walk_bytes = 4 * (2 * N + 6 * C + 2 * used + 2 * n + 2)
    copy_bytes = 2 * n * F * 4               # read a feature row, write it
    bound, by = _bound_ms(walk_bytes, steps)
    optin = torch.cuda.get_device_properties(0).shared_memory_per_block_optin
    where = walk_kernel.home(C, optin)
    log(f"[9 refill] {tag}: {n} of {C} slots admitted (N {N}, F {F}), "
        f"walk steps {steps}, visits {plan.visits}, windows {windows} (the "
        f"kernel's count, {width} visits a window at most; the CPU "
        f"decomposition agrees); dynamic.refill {statistics.median(ms):.3f} "
        f"ms (host clock, synced; {[round(t, 3) for t in ms]}): candidate "
        f"sort {sort_ms:.4f} ms, the C call {call_ms:.4f} ms (events; "
        f"profiler: prepare {stage_ms['prepare']:.4f}, walk "
        f"{stage_ms['walk']:.4f}, apply {stage_ms['apply']:.4f}), the "
        f"admitted count's read {statistics.median(reads):.4f} ms (host), "
        f"clone and row copy {copy_ms:.4f} ms ({copy_bytes / 1e6:.1f} MB, "
        f"bound {copy_bytes / HBM_BYTES_PER_S * 1e3:.4f} ms); walk "
        f"{stage_ms['walk'] * 1e6 / max(plan.visits, 1):.2f} ns a visit, "
        f"{stage_ms['walk'] * 1e6 / max(windows, 1):.1f} ns a window; "
        f"plain walk on the CPU {plain_ms:.1f} ms; walk bound "
        f"{bound:.4f} ms ({by}); words {where}")
    return {"ms": call_ms, "plain_ms": plain_ms, "bound_ms": bound,
            "bound_by": by, "library_ms": None,
            "refill_ms": statistics.median(ms), "sort_ms": sort_ms,
            "stage_ms": stage_ms, "read_ms": statistics.median(reads),
            "copy_ms": copy_ms, "admitted": n, "walk_steps": steps,
            "visits": plan.visits, "windows": windows, "window": width,
            "home": where,
            "row_copy_bound_ms": copy_bytes / HBM_BYTES_PER_S * 1e3}


def check_walk_equal(torch, tag, walk, walk_c, n):
    for f in walk._fields:
        a, b = getattr(walk, f).cpu(), getattr(walk_c, f)
        if f.startswith("adm"):
            a, b = a[:n], b[:n]
        check(torch.equal(a, b), f"{tag}: clock_refill {f}: card != plain")


def check_refill(torch, pre, post, admitted, feats):
    """The boundary refill again on its pre-refill state: the kernel's
    output equals the trainer's and a relaunch's, and the plain version
    on a CPU copy, slot for slot and row for row; then the same on a
    synthetic CLOCK state at ogbn-products' scale with uniform counts
    (rows checked on the card). Returns the reading."""
    from repro_torch.featcache.dynamic import DynamicCacheState
    from repro_torch.kernels.clock_refill import ops as refill_ops
    from repro_torch.kernels.clock_refill.ref import (PRODUCTS,
                                                      clock_refill_ref,
                                                      clock_state)
    args = refill_args(pre, feats)
    rows, walk, n = refill_ops.clock_refill(*args)
    check(n == admitted and torch.equal(rows, post.cache) and
          all(torch.equal(getattr(walk, f), getattr(post, f))
              for f in ("pos", "slot_ids", "refbit", "hand")),
          "the refill relaunched differs from the trainer's")
    t0 = time.perf_counter()
    rows_c, walk_c, n_c = refill_ops.clock_refill(*(a.cpu() for a in args))
    plain_op_ms = (time.perf_counter() - t0) * 1e3
    check(n_c == n, f"admitted {n} on the card, {n_c} on the CPU")
    check_walk_equal(torch, "reddit-602", walk, walk_c, n)
    err = float((rows.cpu() - rows_c).abs().max())
    check(err == 0.0, f"refilled rows differ from the plain version by {err}")
    reading = refill_reading(torch, "reddit-602 epoch 0's end", pre, feats,
                             n, rows, walk)
    log(f"[9 dynamic] refill at epoch 0's end: card = plain, slot for slot "
        f"and row for row; relaunch bit-identical; the whole plain refill "
        f"on the CPU {plain_op_ms:.1f} ms")

    st = clock_state(*PRODUCTS, 0, DEVICE)
    gen = torch.Generator(device=DEVICE).manual_seed(0)
    pfeats = torch.randn((PRODUCTS[0], PRODUCTS_F), generator=gen,
                         device=DEVICE)
    pstate = DynamicCacheState(cache=pfeats[st["slot_ids"].long()], **st,
                               capacity=PRODUCTS[1], policy="synthetic")
    pargs = refill_args(pstate, pfeats)
    prows, pwalk, pn = refill_ops.clock_refill(*pargs)
    again = refill_ops.clock_refill(*pargs)
    check(again[2] == pn and torch.equal(again[0], prows) and all(
        torch.equal(getattr(pwalk, f), getattr(again[1], f))
        for f in ("pos", "slot_ids", "refbit", "slot_freq", "hand", "steps")),
        "products-scale: the relaunch differs")
    cand = refill_ops.refill_candidates(st["pos"], st["freq"], PRODUCTS[1])
    pwalk_c = clock_refill_ref(*(t.cpu() for t in (
        st["pos"], st["slot_ids"], st["refbit"], st["slot_freq"],
        st["hand"], *cand)))
    check(int(pwalk_c.n_admitted) == pn,
          f"products-scale: admitted {pn} on the card, "
          f"{int(pwalk_c.n_admitted)} on the CPU")
    check_walk_equal(torch, "products-scale", pwalk, pwalk_c, pn)
    reading["products"] = refill_reading(
        torch, f"products-scale synthetic, uniform counts (N {PRODUCTS[0]}, "
        f"C {PRODUCTS[1]}, hit and miss counts < {PRODUCTS[2]})", pstate,
        pfeats, pn, prows, pwalk)
    log(f"[9 dynamic] products-scale refill: card = plain on a CPU copy, "
        f"slot for slot; rows equal the feature rows on the card; relaunch "
        f"bit-identical")
    reading["max_abs_err"] = err
    del pfeats, pstate, pargs, prows, again
    torch.cuda.empty_cache()
    return reading


def phase_dynamic(torch, graph, policy, plan, caps, eval_caps):
    """(a) two epochs of GraphSAGE with the dynamic CLOCK cache, seeded
    from the phase-4 plan, beside the static plan and the uncached run on
    the same batches; (b) resume from checkpoints at 100 and 200; (c) a
    NaN burst and a corrupted refill. Returns (launches, reading)."""
    import shutil
    from repro_torch.configs import CONFIGS, TrainConfig
    from repro_torch.kernels.clock_refill import kernel as walk_kernel
    from repro_torch.resilience import FaultPlan, FaultSpec, GuardConfig
    from repro_torch.resilience import faults
    from repro_torch.train import checkpoint as ckpt
    from repro_torch.train.gnn_loop import GNNTrainer

    def make(cache, **kw):
        return GNNTrainer(graph, CONFIGS["graphsage"], TrainConfig(), policy,
                          caps=caps, eval_caps=eval_caps, seed=0,
                          device=DEVICE, cache=cache, **kw)

    def fresh():
        return plan.to(DEVICE).to_dynamic()

    t_phase = time.perf_counter()
    # (a) -------------------------------------------------------------------
    dyn = make(fresh())
    nb = dyn.stream.num_batches(0)
    steps = 2 * nb
    torch.cuda.synchronize()
    reset_launches()                             # counts start here
    with RefillSpy() as spy:
        t0 = time.perf_counter()
        m0 = dyn.cache_meter.mark()
        losses = dyn.train_steps(nb)
        m1 = dyn.cache_meter.mark()
        losses += dyn.train_steps(RESUME_END - nb)
        at_end = (cache_fields(dyn.cache), params_of(dyn))
        losses += dyn.train_steps(steps - RESUME_END)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launches = read_launches()                   # ... and are read here
    m2 = dyn.cache_meter.mark()
    want = {k: 0 for k in launches}
    want.update(gather_agg_fwd=3 * steps, gather_agg_bwd_dx=4 * steps,
                gather_cached_fwd=steps, clock_refill=2)
    check(launches == want, f"{DYN}: launches {launches} != {want}")
    optin = torch.cuda.get_device_properties(0).shared_memory_per_block_optin
    home = walk_kernel.home(dyn.cache.capacity, optin)
    check(len(spy.calls) == 2 and walk_kernel.SMEM[home] == 2,
          f"{DYN}: {len(spy.calls)} refills, words {walk_kernel.SMEM} "
          f"(expected {home})")
    check(all(map(math.isfinite, losses)), f"{DYN}: non-finite loss")
    log(f"[9 dynamic] {DYN}: {steps} steps ({nb} a epoch) in {wall:.1f} s "
        f"({wall / steps * 1e3:.2f} ms a step, 2 refills inside): loss "
        f"{losses[0]:.4f} -> {losses[-1]:.4f}; launches {launches}")
    stat = make(plan.to(DEVICE))
    t0 = time.perf_counter()
    s0 = stat.cache_meter.mark()
    ls = stat.train_steps(nb)
    s1 = stat.cache_meter.mark()
    ls += stat.train_steps(nb)
    s2 = stat.cache_meter.mark()
    wall_static = time.perf_counter() - t0
    del stat
    plain = make(None)
    t0 = time.perf_counter()
    uncached = plain.train_steps(steps)
    wall_plain = time.perf_counter() - t0
    del plain
    check(ls == losses and uncached == losses,
          f"{DYN}: losses differ from the static or the uncached run's")
    log(f"[9 dynamic] the same {steps} steps: static plan {wall_static:.1f} "
        f"s ({wall_static / steps * 1e3:.2f} ms a step), uncached "
        f"{wall_plain:.1f} s ({wall_plain / steps * 1e3:.2f} ms a step)")

    def window(a, b):
        hits, misses = b[0] - a[0], b[1] - a[1]
        return hits, misses, hits / max(hits + misses, 1)

    d0, d1, t0_, t1_ = window(m0, m1), window(m1, m2), window(s0, s1), \
        window(s1, s2)
    check(d0 == t0_, f"epoch 0: dynamic {d0} != static {t0_}")
    log(f"[9 dynamic] hit rate epoch 0: dynamic {d0[2]:.4f} = static "
        f"{t0_[2]:.4f} ({d0[0]} hits, {d0[1]} misses: same residency, same "
        f"batches); epoch 1: dynamic {d1[2]:.4f} ({d1[0]} hits, {d1[1]} "
        f"misses) vs static {t1_[2]:.4f} ({t1_[0]} hits, {t1_[1]} misses); "
        f"rows admitted over both boundaries {dyn.cache_meter.refills}; "
        f"{steps} losses bit-identical across dynamic, static and "
        f"uncached")
    (pre, (post, admitted)) = spy.calls[0]
    reading = check_refill(torch, pre, post, admitted, dyn.feats)
    del dyn, spy, pre, post
    torch.cuda.empty_cache()

    # (b) -------------------------------------------------------------------
    root = ROOT / "build" / "phase9"
    shutil.rmtree(root, ignore_errors=True)
    d = str(root / "resume")

    def resumed():
        t0 = time.perf_counter()
        tr = make(fresh(), ckpt_dir=d, ckpt_every=RESUME_EVERY)
        return tr, (time.perf_counter() - t0) * 1e3

    b1, _ = resumed()
    check(b1.global_step == 0, "a checkpoint existed before the run")
    got = b1.train_steps(RESUME_EVERY)
    check(got == losses[:RESUME_EVERY], "resume run 1: losses differ")
    del b1
    b2, _ = resumed()
    check(b2.global_step == RESUME_EVERY and
          b2.stream.cursor.state() == {"epoch": 0, "pos": RESUME_EVERY},
          f"resumed at {b2.global_step} {b2.stream.cursor.state()}")
    got = b2.train_steps(RESUME_END - RESUME_EVERY)
    check(got == losses[RESUME_EVERY:RESUME_END], "resume run 2: losses")
    check(same_fields(torch, cache_fields(b2.cache), at_end[0]) and
          all(torch.equal(a, b) for a, b in zip(params_of(b2), at_end[1])),
          "resume run 2: state at 230 differs")
    del b2
    b3, _ = resumed()
    check(b3.global_step == 2 * RESUME_EVERY, f"resumed at {b3.global_step}")
    got = b3.train_steps(RESUME_END - 2 * RESUME_EVERY)
    check(got == losses[2 * RESUME_EVERY:RESUME_END], "resume run 3")
    check(same_fields(torch, cache_fields(b3.cache), at_end[0]) and
          all(torch.equal(a, b) for a, b in zip(params_of(b3), at_end[1])),
          "resume run 3: state at 230 differs")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    b3.save()
    save_ms = (time.perf_counter() - t0) * 1e3
    step_dir = Path(d) / f"step_{RESUME_END:09d}"
    mb = sum(f.stat().st_size for f in step_dir.iterdir()) / 1e6
    t0 = time.perf_counter()
    ckpt.restore(d, RESUME_END, b3._state())
    torch.cuda.synchronize()
    restore_ms = (time.perf_counter() - t0) * 1e3
    del b3
    log(f"[9 resume] stop at {RESUME_EVERY} (mid-epoch 0), resume to "
        f"{RESUME_END} across the refill at {nb} (checkpoint at "
        f"{2 * RESUME_EVERY}), resume at {2 * RESUME_EVERY} to "
        f"{RESUME_END}: losses bit-identical to (a); weights and CLOCK "
        f"state (pos, slot_ids, refbit, slot_freq, freq, hand, rows) "
        f"torch.equal to (a)'s at step {RESUME_END}; a save {save_ms:.1f} "
        f"ms for {mb:.1f} MB, a restore {restore_ms:.1f} ms")

    # (c) -------------------------------------------------------------------
    guarded = make(fresh(), ckpt_dir=str(root / "chaos"),
                   ckpt_every=CHAOS_EVERY,
                   guard=GuardConfig(max_consecutive_skips=1))
    burst = FaultPlan(specs=(FaultSpec("step_nonfinite", *CHAOS_BURST),))
    t0 = time.perf_counter()
    with faults.inject(burst):
        got = run_steps_tracked(guarded, CHAOS_STEPS)
    chaos_s = time.perf_counter() - t0
    meter = guarded.guard_meter.counts()
    check(len(burst.fired("step_nonfinite")) == CHAOS_BURST[1] and
          meter["rollbacks"] == 1 and got == losses[:CHAOS_STEPS],
          f"step_nonfinite: fired {burst.fired()}, meter {meter}")
    del guarded
    corrupt = make(fresh())
    plan_c = FaultPlan(specs=(FaultSpec("cache_corrupt", 0),))
    with faults.inject(plan_c):
        got = corrupt.train_steps(nb + 9)
    check(plan_c.fired("cache_corrupt") and corrupt.cache is None and
          corrupt.guard_meter.cache_degradations == 1 and
          got == uncached[:nb + 9],
          f"cache_corrupt: meter {corrupt.guard_meter.counts()}")
    log(f"[9 chaos] step_nonfinite at steps {CHAOS_BURST[0] + 1}-"
        f"{sum(CHAOS_BURST)} with GuardConfig(max_consecutive_skips=1), "
        f"ckpt_every {CHAOS_EVERY}: meter {meter} ({chaos_s:.1f} s), the "
        f"{CHAOS_STEPS} losses bit-identical to the fault-free run; "
        f"cache_corrupt at epoch 0's refill: degraded at step "
        f"{corrupt.cache_meter.degraded_at}, the {nb + 9} losses equal the "
        f"uncached run's")
    del corrupt
    shutil.rmtree(root, ignore_errors=True)
    torch.cuda.empty_cache()
    log(f"[9 done] phase 9: {time.perf_counter() - t_phase:.1f} s")
    return launches, {"clock_refill": reading}


def phase_card_to_cpu(torch, g):
    """(d) phase 5's tiny GraphSAGE with the dynamic cache trains 3 steps
    on the card and saves; a CPU trainer restores the checkpoint (weights,
    AdamW's state, CLOCK state) and both take 5 more steps on the same
    batches within phase 5's tolerance."""
    import shutil
    from repro_torch.configs import GNNConfig, TrainConfig
    from repro_torch.featcache.dynamic import DynamicCacheState
    from repro_torch.train.gnn_loop import GNNTrainer
    cfg = GNNConfig("tiny", "sage", 2, 32, g.feat_dim, g.num_classes,
                    fanout=(5, 5), dropout=0.0)
    tcfg = TrainConfig(batch_size=256)
    d = ROOT / "build" / "phase9_card_to_cpu"
    shutil.rmtree(d, ignore_errors=True)
    src = GNNTrainer(g, cfg, tcfg, "comm_rand", seed=0, device="cpu")

    def make(device):
        return GNNTrainer(g, cfg, tcfg, "comm_rand", seed=0, caps=src.caps,
                          eval_caps=src.eval_caps, cache="dynamic",
                          ckpt_dir=str(d), device=device)

    it = iter(src.stream)
    batches = [next(it) for _ in range(3 + CPU_STEPS)]
    gpu = make(DEVICE)
    for b in batches[:3]:
        gpu.train_step(b.to(DEVICE), tcfg.learning_rate)
    gpu.global_step = 3
    gpu.save()
    cpu = make("cpu")
    check(cpu.global_step == 3, f"the CPU trainer resumed at "
          f"{cpu.global_step}")
    check(all(torch.equal(a, b.cpu()) for a, b in
              zip(cpu.params.parameters(), gpu.params.parameters())) and
          all(torch.equal(getattr(cpu.cache, f),
                          getattr(gpu.cache, f).cpu())
              for f in DynamicCacheState.DATA_FIELDS),
          "the CPU restored other weights or cache state")
    worst = 0.0
    for b in batches[3:]:
        lc = float(cpu.train_step(b, tcfg.learning_rate)[0])
        lg = float(gpu.train_step(b.to(DEVICE), tcfg.learning_rate)[0])
        worst = max(worst, abs(lg - lc) / abs(lc))
        check(abs(lg - lc) <= 1e-4 * abs(lc), f"card {lg} vs CPU {lc}")
    shutil.rmtree(d, ignore_errors=True)
    log(f"[9 card to cpu] tiny sage cache=dynamic: saved on the card at "
        f"step 3, restored on the CPU (weights and CLOCK state equal); "
        f"{CPU_STEPS} more steps: max relative loss difference "
        f"{worst:.3e} (limit 1e-4)")


# ---------------------------------------------------------------------------
# phase 10: the async pipeline and the tracer (reddit-602 GraphSAGE)
# ---------------------------------------------------------------------------
ASYNC, ASYNC_DYN = "graphsage_async", "graphsage_async_dynamic"
ASYNC_STEPS, PAIR_STEPS, DYN_STEPS = 40, 20, 160   # (a), (b) a run, (a) dyn
WATCH_AT, WATCH_STEPS, HANG_TIMEOUT_S = 6, 12, 1.0  # (d)


def span_ms(events, name):
    """(total, mean) ms of the `name` spans among `events`."""
    durs = [e["dur"] / 1e3 for e in events if e.get("name") == name]
    return sum(durs), (statistics.mean(durs) if durs else 0.0)


def phase_async(torch, graph, policy, plan, caps, eval_caps):
    """(a) async against sync on the same cursor: 40 GraphSAGE steps with
    their launch counts, then 160 steps with phase 9's dynamic CLOCK state
    across epoch 0's boundary; (b) paired timing, sync, async, sync,
    async, and a profile of each; the device order against the numpy one;
    the build's stages; (c) a traced async epoch through the analyzer's
    gates; (d) the producer watchdog. Returns the launches of (a)'s two
    async runs by path."""
    import shutil
    import numpy as np
    from repro_torch.configs import CONFIGS, TrainConfig
    from repro_torch.obs import report, trace
    from repro_torch.pipeline import OrderSpec, device_epoch_order, \
        stage_times
    from repro_torch.pipeline.device_order import epoch_words_for
    from repro_torch.resilience import FaultPlan, FaultSpec, InjectedFault
    from repro_torch.resilience import faults
    from repro_torch.train.gnn_loop import GNNTrainer

    lr = TrainConfig().learning_rate

    def make(pipeline, cache=None):
        return GNNTrainer(graph, CONFIGS["graphsage"], TrainConfig(), policy,
                          caps=caps, eval_caps=eval_caps, seed=0,
                          device=DEVICE, cache=cache, pipeline=pipeline)

    def fresh():
        return plan.to(DEVICE).to_dynamic()

    t_phase = time.perf_counter()
    runs = {}
    # (a) -------------------------------------------------------------------
    sync = make("sync")
    want_a = sync.train_steps(ASYNC_STEPS)
    asyn = make("async")
    torch.cuda.synchronize()
    reset_launches()                             # counts start here
    got = asyn.train_steps(ASYNC_STEPS)
    torch.cuda.synchronize()
    runs[ASYNC] = read_launches()                # ... and are read here
    expect = {k: 0 for k in runs[ASYNC]}
    expect.update(gather_agg_fwd=3 * ASYNC_STEPS,
                  gather_agg_bwd_dx=4 * ASYNC_STEPS)
    check(runs[ASYNC] == expect,
          f"{ASYNC}: launches {runs[ASYNC]} != {expect}")
    check(got == want_a, f"{ASYNC}: losses differ from sync's")
    log(f"[10 async] {ASYNC_STEPS} GraphSAGE steps, pipeline='async' vs "
        f"'sync' on the same cursor: losses bit-identical ({got[0]:.4f} -> "
        f"{got[-1]:.4f}); launches {runs[ASYNC]}")

    # (b) -------------------------------------------------------------------
    timing = {"sync": [], "async": []}
    for rnd in range(2):
        losses = {}
        for name, tr in (("sync", sync), ("async", asyn)):
            with trace.enabled(None) as tracer:
                per, ls = [], []
                for _ in range(PAIR_STEPS):
                    t0 = time.perf_counter()
                    ls += tr.train_steps(1)      # ends in one loss read
                    per.append((time.perf_counter() - t0) * 1e3)
                t0 = time.perf_counter()
                ls += tr.train_steps(PAIR_STEPS)  # one read at the end
                window = (time.perf_counter() - t0) * 1e3 / PAIR_STEPS
                evs = tracer.events()
            losses[name] = ls
            timing[name].append({
                "median_ms": statistics.median(per), "window_ms": window,
                "get_wait_ms": span_ms(evs, "queue_get_wait")[0]
                / (2 * PAIR_STEPS),
                # the host's own share: the step's dispatch, the build's
                "step_span_ms": span_ms(evs, "train_step")[1],
                "build_span_ms": span_ms(evs, "producer_build")[1]})
        check(losses["sync"] == losses["async"],
              f"paired round {rnd}: losses differ")
    for name, tr in (("sync", sync), ("async", asyn)):
        step = statistics.median(r["median_ms"] for r in timing[name])
        dev, _ = profile_kernels(torch, lambda: tr.train_steps(3))
        busy = sum(t for _, t, _ in dev) / 3 / 1e3
        for r in timing[name]:
            r["kernels_ms"], r["idle"] = busy, 1 - busy / step
    for rnd in range(2):
        for name in ("sync", "async"):
            r = timing[name][rnd]
            log(f"[10 paired] run {2 * rnd + (name == 'async') + 1} "
                f"{name:5s}: median step {r['median_ms']:.2f} ms "
                f"(train_steps(1), {PAIR_STEPS} steps), "
                f"{r['window_ms']:.2f} ms a step over train_steps("
                f"{PAIR_STEPS}); queue_get_wait {r['get_wait_ms']:.3f} ms "
                f"a step; train_step span (host dispatch) "
                f"{r['step_span_ms']:.2f} ms, producer_build span "
                f"{r['build_span_ms']:.2f} ms; kernels {r['kernels_ms']:.2f} "
                f"ms/step, device idle share {r['idle']:.3f} (3 profiled "
                f"steps)")
    spec = OrderSpec.for_policy(graph, policy, DEVICE)
    words = epoch_words_for(0, 1)
    dev_ms = cuda_ms(torch, lambda: device_epoch_order(spec, words),
                     reps=5, rounds=3)
    from repro_torch.batching.order import make_batches
    np_ms = []
    for e in range(1, 4):
        t0 = time.perf_counter()
        make_batches(policy.epoch_order(
            graph.train_ids, graph.communities,
            np.random.default_rng((0, e))), TrainConfig().batch_size)
        np_ms.append((time.perf_counter() - t0) * 1e3)
    st = sync.stream
    stages = stage_times(st.g, st.root_batches(0)[1], st.labels, st.fanouts,
                         st.caps, st.sampler, seed=0, epoch=0, pos=1)
    build_ms = cuda_ms(torch, lambda: asyn.stream.builder.build(0, 1),
                       reps=3, rounds=3)
    log(f"[10 order] epoch order of {len(graph.train_ids)} roots: on the "
        f"device {dev_ms:.3f} ms (events), numpy + make_batches "
        f"{statistics.median(np_ms):.3f} ms (host, "
        f"{[round(t, 3) for t in np_ms]}); builder.build {build_ms:.3f} ms "
        f"(events); stages (best of 10, events) roots "
        f"{stages['roots_us']:.1f} us, sample {stages['sample_us']:.1f} us, "
        f"dedup {stages['dedup_us']:.1f} us")
    asyn.stream.close()
    del sync, asyn
    torch.cuda.empty_cache()

    # (a) with the dynamic cache --------------------------------------------
    sd = make("sync", fresh())
    nb = sd.stream.num_batches(0)
    want = sd.train_steps(DYN_STEPS)
    want_state = (cache_fields(sd.cache), params_of(sd))
    del sd
    ad = make("async", fresh())
    torch.cuda.synchronize()
    reset_launches()                             # counts start here
    ep = ad.run_epoch(lr)
    snap = (cache_fields(ad.cache), params_of(ad))
    rest = ad.train_steps(DYN_STEPS - nb)
    torch.cuda.synchronize()
    runs[ASYNC_DYN] = read_launches()            # ... and are read here
    ad.stream.close()
    expect = {k: 0 for k in runs[ASYNC_DYN]}
    expect.update(gather_agg_fwd=3 * DYN_STEPS,
                  gather_agg_bwd_dx=4 * DYN_STEPS,
                  gather_cached_fwd=DYN_STEPS, clock_refill=1)
    check(runs[ASYNC_DYN] == expect,
          f"{ASYNC_DYN}: launches {runs[ASYNC_DYN]} != {expect}")
    mean0 = float(np.mean(np.asarray(want[:nb], np.float32)))
    check(ep["loss"] == mean0 and rest == want[nb:],
          f"{ASYNC_DYN}: losses differ from the sync dynamic run's")
    check(same_fields(torch, cache_fields(ad.cache), want_state[0]) and
          all(torch.equal(a, b) for a, b in zip(params_of(ad),
                                                want_state[1])),
          f"{ASYNC_DYN}: state at {DYN_STEPS} differs from sync's")
    log(f"[10 async] {ASYNC_DYN}: run_epoch ({nb} steps, the refill in the "
        f"last) + {DYN_STEPS - nb} steps, async vs sync: epoch-0 mean loss "
        f"{ep['loss']:.6f} and the {DYN_STEPS - nb} losses after it "
        f"bit-identical; CLOCK state and weights at {DYN_STEPS} equal; "
        f"launches {runs[ASYNC_DYN]}")
    del ad

    # (c) -------------------------------------------------------------------
    root = ROOT / "build" / "phase10"
    shutil.rmtree(root, ignore_errors=True)
    path = str(root / "trace.jsonl")
    td = make("async", fresh())
    with trace.enabled(path, run="chip_smoke", pipeline="async") as tracer:
        ep_t = td.run_epoch(lr)
        tracer.flush()
    td.stream.close()
    events = report.load_trace(path)
    rep = report.analyze(events)
    check(not rep["conformance_problems"],
          f"trace: {rep['conformance_problems'][:3]}")
    check(rep["overlap"]["overlap_frac"] > 0, f"overlap {rep['overlap']}")
    check(rep["mid_epoch_sync_count"] == 0, "mid-epoch syncs " + str(
        [e["mid_epoch_sync_names"] for e in rep["epochs"]]))
    check(ep_t["loss"] == ep["loss"] and
          same_fields(torch, cache_fields(td.cache), snap[0]) and
          all(torch.equal(a, b) for a, b in zip(params_of(td), snap[1])),
          "the traced epoch differs from the untraced one")
    (dev_span,) = [e for e in events if e["name"] == "device_steps"]
    ov = rep["overlap"]
    stalls = ", ".join(f"{k}: {v['total_s']:.3f} s"
                       for k, v in sorted(rep["stalls"].items()))
    log(f"[10 trace] traced async epoch ({nb} steps, dynamic cache, guard "
        f"and checkpoints off): {rep['n_events']} events, "
        f"{rep['n_threads']} threads, {rep['wall_s']:.2f} s; overlap_frac "
        f"{ov['overlap_frac']:.3f} (producer busy "
        f"{ov['producer_busy_s']:.3f} s, steps {ov['consumer_busy_s']:.3f} "
        f"s); stalls {{{stalls}}}; "
        f"sync sites {sorted(rep['sync_sites'])}; mid-epoch syncs 0; "
        f"device_steps per_step_us {dev_span['args']['per_step_us']:.1f}; "
        f"mean loss equal to the untraced epoch's, state equal")
    log(f"[10 trace] hub.export() keys {sorted(td.hub.export())}; metrics "
        f"{sorted(td.hub.snapshot())}")
    shutil.rmtree(root, ignore_errors=True)
    del td
    torch.cuda.empty_cache()

    # (d) -------------------------------------------------------------------
    base = want_a[:WATCH_STEPS]
    outcomes = []
    for site in ("batch_build", "producer_hang"):
        w = make("async")
        if site == "producer_hang":
            w.stream.prime()
            w.stream.stall_timeout_s = HANG_TIMEOUT_S
        fplan = FaultPlan(specs=(FaultSpec(site, WATCH_AT),))
        t0 = time.perf_counter()
        with faults.inject(fplan):
            got = w.train_steps(WATCH_STEPS)
        w.stream.close()
        dt = time.perf_counter() - t0
        m = w.guard_meter.counts()
        check(len(fplan.fired(site)) == 1 and w.stream.restarts == 1 and
              m["producer_restarts"] == 1 and got == base,
              f"{site}: fired {fplan.fired()}, meter {m}")
        outcomes.append(f"{site} at build {WATCH_AT}: 1 restart, "
                        f"{WATCH_STEPS} losses = sync's ({dt:.2f} s)")
    w.stream.stall_timeout_s = 60.0
    fplan = FaultPlan(specs=(FaultSpec("batch_build", 0, 100),))
    raised = None
    with faults.inject(fplan):
        try:
            w.train_steps(3)
        except InjectedFault as exc:             # the real producer error
            raised = exc
    m = w.guard_meter.counts()
    budget = w.stream.max_restarts
    check(raised is not None and raised.site == "batch_build" and
          w.stream.restarts == 1 + budget and
          m["producer_restarts"] == 1 + budget,
          f"budget: raised {raised!r}, meter {m}")
    w.stream.close()
    del w
    torch.cuda.empty_cache()
    log(f"[10 watchdog] {'; '.join(outcomes)} (stall_timeout_s "
        f"{HANG_TIMEOUT_S} after prime()); a build failing every time: "
        f"{budget} restarts, then the real error raised: {raised!r}")
    log(f"[10 done] phase 10: {time.perf_counter() - t_phase:.1f} s")
    return runs


# ---------------------------------------------------------------------------
# phase 11: the prior-work policies, samplers and baselines (paper §6.3)
# ---------------------------------------------------------------------------
LABOR, LABOR_ASYNC = "graphsage_labor", "graphsage_labor_async"
FULL_RUN, CGCN, FULLBATCH = "graphsage_full", "clustergcn", "fullbatch"
LABOR_STEPS, FULL_STEPS, CGCN_PPB, FB_EPOCHS = 20, 5, 2, 3
LABOR_CAPS: list = []           # phase 11's calibrated caps, for phase 13
# CUDA kernels of PyTorch's index backward and of its atomic scatters
# (index_add_, scatter_add_, index_put_ with accumulate): a subgraph step
# may launch none of them
ATOMIC_KERNELS = ("indexing_backward", "indexFunc", "scatter_gather",
                  "scatter_add", "index_put")


def sampler_checks(torch, graph, trainer):
    """(a) uniform, full and labor on the card against their plain runs on
    a CPU copy of the graph, at the hop shapes of a LABOR batch at the
    calibrated caps (fanout 10): the same uniforms (drawn on the host) and
    the same ranks; `src` and `mask` equal element for element. The epoch's
    ranks of every node equal the CPU's and the numpy mirror's bit for
    bit."""
    from repro_torch import sampling
    from repro_torch.batching.stream import shared_words
    from repro_torch.graphs.csr import DeviceGraph
    g_dev, g_cpu = trainer.g, DeviceGraph.from_graph(graph, "cpu")
    lab = sampling.LaborSampler()
    words = shared_words(0, 0)
    ranks = trainer.stream.epoch_ctx(0)
    ranks_cpu = lab.epoch_ctx(words, g_cpu)
    check(torch.equal(ranks.cpu(), ranks_cpu) and torch.equal(
        ranks_cpu, torch.as_tensor(lab.epoch_ranks_np(words,
                                                      graph.num_nodes))),
          "LABOR ranks: card, CPU and numpy differ")
    rank_ms = cuda_ms(torch, lambda: lab.epoch_ctx(words, g_dev))
    distinct = torch.unique(ranks).numel()
    log(f"[11 samplers] LABOR ranks of all {graph.num_nodes} nodes: card = "
        f"CPU = numpy bit for bit ({distinct} distinct values); "
        f"{rank_ms:.4f} ms on the card, once an epoch")
    stream = trainer.stream
    levels = stream.build(stream.root_batches(0)[0], 0, 0).levels
    gen = torch.Generator().manual_seed(11)
    fan = trainer.fanouts[0]
    for h in range(len(trainer.fanouts)):
        nodes = levels[h]
        M = nodes.shape[0]
        u = torch.rand((M, fan), generator=gen)
        cases = (("uniform", sampling.UniformSampler(), (u,), {}),
                 ("full", sampling.FullNeighborhoodSampler(), (), {}),
                 ("labor", lab, (), {"ranks": ranks_cpu}))
        times = []
        for name, s, args, kw in cases:
            dargs = tuple(a.to(DEVICE) for a in args)
            dkw = {k: v.to(DEVICE) for k, v in kw.items()}
            got = s.sample(g_dev, nodes, fan, *dargs, **dkw)
            want = s.sample(g_cpu, nodes.cpu(), fan, *args, **kw)
            check(all(torch.equal(a.cpu(), b) for a, b in zip(got, want)),
                  f"{name} sampler: card != CPU at hop {h} (M {M})")
            ms = cuda_ms(torch, lambda: s.sample(g_dev, nodes, fan, *dargs,
                                                 **dkw), reps=3, rounds=3)
            times.append(f"{name} {ms:.4f} ms")
        log(f"[11 samplers] hop {h}: {M} rows x fanout {fan}: src and mask "
            f"card = CPU for uniform, full and labor; {', '.join(times)}")


def count_calls(cls, name):
    """Wrap `cls.name` to count its calls; returns (counter, undo)."""
    orig, calls = getattr(cls, name), []

    def wrapped(*a, **k):
        calls.append(1)
        return orig(*a, **k)

    setattr(cls, name, wrapped)
    return calls, lambda: setattr(cls, name, orig)


def timed_steps(torch, trainer, steps):
    """`steps` guarded steps, each ending in its loss read: (losses, ms)."""
    losses, ms = [], []
    for _ in range(steps):
        t0 = time.perf_counter()
        losses += trainer.train_steps(1)
        ms.append((time.perf_counter() - t0) * 1e3)
    return losses, ms


def idle_share(torch, fn, step_ms: float, steps: int):
    """Kernel ms a step of `steps` calls of `fn` under torch.profiler, and
    1 - that / the unprofiled `step_ms`; the kernels by device time."""
    dev, _ = profile_kernels(torch, fn)
    busy = sum(t for _, t, _ in dev) / steps / 1e3
    return busy, 1 - busy / step_ms, dev


def expect_launches(fwd, dx):
    want = {k: 0 for k in read_launches()}
    want.update(gather_agg_fwd=fwd, gather_agg_bwd_dx=dx)
    return want


def phase_labor(torch, graph, caps, eval_caps):
    """(a) the samplers on the card against the CPU; (b) GraphSAGE at full
    width with `make_policy("labor")` at its calibrated caps: 20 sync steps,
    then 20 async steps on the same cursor with bit-identical losses, 3
    fwd and 4 bwd_dx a step, the ranks hashed once an epoch a stream;
    (c) 5 steps of `rand` roots through a policy that binds the `full`
    sampler at fanout (10, 10, 10). Returns the runs' launches."""
    from dataclasses import dataclass

    from repro_torch import sampling
    from repro_torch.batching import CommRandPolicy, make_policy
    from repro_torch.configs import CONFIGS, TrainConfig
    from repro_torch.train.gnn_loop import GNNTrainer

    cfg, tcfg = CONFIGS["graphsage"], TrainConfig()
    runs = {}
    calls, undo = count_calls(sampling.LaborSampler, "epoch_ctx")
    try:
        t0 = time.perf_counter()
        lab = GNNTrainer(graph, cfg, tcfg, make_policy("labor"),
                         eval_caps=eval_caps, seed=0, device=DEVICE)
        set_up = time.perf_counter() - t0
        LABOR_CAPS.extend(lab.caps)             # phase 13 reuses them
        check(lab.sampler.name == "labor", "labor binds another sampler")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()                         # counts start here
        losses, ms = timed_steps(torch, lab, LABOR_STEPS)
        torch.cuda.synchronize()
        runs[LABOR] = read_launches()            # ... and are read here
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        want = expect_launches(3 * LABOR_STEPS, 4 * LABOR_STEPS)
        check(runs[LABOR] == want, f"{LABOR}: launches {runs[LABOR]}")
        check(all(map(math.isfinite, losses)), f"{LABOR}: non-finite loss")
        # one hash of the ranks for each epoch the steps touched
        epochs = (LABOR_STEPS - 1) // lab.stream.num_batches() + 1
        check(len(calls) == epochs,
              f"{LABOR}: ranks hashed {len(calls)} times in {epochs} epochs")
        step = statistics.median(ms)
        busy, idle, _ = idle_share(torch, lambda: lab.train_steps(3), step,
                                   3)
        log(f"[11 labor] {LABOR}: caps {lab.caps} (comm_rand's {caps}), "
            f"trainer set-up (calibration, upload) "
            f"{set_up:.1f} s; {LABOR_STEPS} sync steps: loss "
            f"{losses[0]:.4f} -> {losses[-1]:.4f}, median step {step:.2f} "
            f"ms (first {ms[0]:.2f}), kernels {busy:.2f} ms a step, idle "
            f"share {idle:.3f}; peak {peak:.2f} GiB; ranks hashed "
            f"{len(calls)} time(s) in {epochs} epoch(s); launches "
            f"{runs[LABOR]}")
        asyn = GNNTrainer(graph, cfg, tcfg, make_policy("labor"),
                          caps=lab.caps, eval_caps=eval_caps, seed=0,
                          device=DEVICE, pipeline="async")
        try:
            torch.cuda.synchronize()
            reset_launches()                     # counts start here
            got, ms_a = timed_steps(torch, asyn, LABOR_STEPS)
            torch.cuda.synchronize()
            runs[LABOR_ASYNC] = read_launches()  # ... and are read here
            busy_a, idle_a, _ = idle_share(
                torch, lambda: asyn.train_steps(3),
                statistics.median(ms_a), 3)
        finally:
            asyn.stream.close()
        check(got == losses, f"{LABOR_ASYNC}: losses differ from sync's")
        check(runs[LABOR_ASYNC] == want,
              f"{LABOR_ASYNC}: launches {runs[LABOR_ASYNC]}")
        # the producer may build ahead into the next epoch
        check(0 <= len(calls) - 2 * epochs <= 1,
              f"async: ranks hashed {len(calls) - epochs} times")
        log(f"[11 labor] {LABOR_ASYNC}: {LABOR_STEPS} async steps on the "
            f"same cursor: losses bit-identical to sync's, median step "
            f"{statistics.median(ms_a):.2f} ms, kernels {busy_a:.2f} ms a "
            f"step, idle share {idle_a:.3f}; ranks hashed "
            f"{len(calls) - epochs} time(s), "
            f"launches {runs[LABOR_ASYNC]}")
        sampler_checks(torch, graph, lab)
        del lab, asyn
    finally:
        undo()
    torch.cuda.empty_cache()

    @dataclass(frozen=True)
    class FullRand(CommRandPolicy):
        """rand roots, every neighbor up to the fanout (no draws)."""

        def sampler_spec(self):
            return ("full", {})

    full = GNNTrainer(graph, cfg, tcfg, FullRand("rand"),
                      eval_caps=eval_caps, seed=0, device=DEVICE)
    check(full.sampler.name == "full", "the full sampler is not bound")
    torch.cuda.synchronize()
    reset_launches()                             # counts start here
    losses, ms = timed_steps(torch, full, FULL_STEPS)
    torch.cuda.synchronize()
    runs[FULL_RUN] = read_launches()             # ... and are read here
    check(runs[FULL_RUN] == expect_launches(3 * FULL_STEPS, 4 * FULL_STEPS),
          f"{FULL_RUN}: launches {runs[FULL_RUN]}")
    check(all(map(math.isfinite, losses)), f"{FULL_RUN}: non-finite loss")
    step = statistics.median(ms)
    busy, idle, _ = idle_share(torch, lambda: full.train_steps(3), step, 3)
    log(f"[11 full] {FULL_RUN}: caps {full.caps}; {FULL_STEPS} steps: loss "
        f"{losses[0]:.4f} -> {losses[-1]:.4f}, median step {step:.2f} ms, "
        f"kernels {busy:.2f} ms a step, idle share {idle:.3f}; launches "
        f"{runs[FULL_RUN]}")
    del full
    torch.cuda.empty_cache()
    return runs


def subgraph_profile(torch, tag, tr, batch, epoch_of):
    """A subgraph trainer's step on `batch`: the median of 5 unprofiled
    steps (each ending in its loss read), then 2 steps under
    torch.profiler; no atomic scatter or index backward kernel may run."""
    ms = []
    for j in range(5):
        t0 = time.perf_counter()
        float(tr.step(batch, *epoch_of(j)))
        ms.append((time.perf_counter() - t0) * 1e3)
    step = statistics.median(ms)
    busy, idle, dev = idle_share(
        torch, lambda: [tr.step(batch, *epoch_of(5 + j)) for j in range(2)],
        step, 2)
    bad = [k for k, _, _ in dev if any(a in k for a in ATOMIC_KERNELS)]
    check(not bad, f"{tag}: atomic scatter or index backward ran: {bad}")
    log(f"[11 {tag}] a step on one batch: median {step:.2f} ms, kernels "
        f"{busy:.2f} ms, idle share {idle:.3f}; no atomic scatter or index "
        f"backward kernel")
    for key, t, n in dev[:6]:
        log(f"[11 {tag}] {t / 2 / 1e3:8.3f} ms/step  {n / 2:5.1f} "
            f"calls/step  {key[:100]}")
    return step


def phase_clustergcn(torch, graph):
    """(d) `train_clustergcn`, 1 epoch at parts_per_batch 2: its epoch
    time, parts, caps and peak memory; launches a part: 3 fwd and 3 bwd_dx
    in the forward (a layer's virtual-row means and their segment sum),
    2 bwd_dx in the backward (layer 0 reads the feature matrix, so its
    input needs no dx), and 3 fwd and 3 bwd_dx an evaluated union; one
    bwd_dx plan a part; a second run's loss and accuracy bit-identical; a
    profiled part step."""
    import numpy as np

    from repro_torch.configs import CONFIGS, TrainConfig
    from repro_torch.kernels.gather_agg import kernel
    from repro_torch.train import baselines

    cfg, tcfg = CONFIGS["graphsage"], TrainConfig()
    cap_n, cap_e = baselines.clustergcn_caps(graph, CGCN_PPB)
    # the unions the run draws: one epoch's, then the evaluation's
    rng = np.random.default_rng((0, 0))
    parts = baselines.clustergcn_batches(graph, CGCN_PPB, rng)
    evals = baselines.clustergcn_batches(graph, CGCN_PPB, rng)
    val = np.zeros(graph.num_nodes, bool)
    val[graph.val_ids] = True
    n_eval = sum(bool(val[np.asarray(p)[:cap_n]].any()) for p in evals)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()                             # counts start here
    t0 = time.perf_counter()
    res = baselines.train_clustergcn(graph, cfg, tcfg, CGCN_PPB, seed=0,
                                     epochs=1, device=DEVICE)
    wall = time.perf_counter() - t0
    torch.cuda.synchronize()
    launches = read_launches()                   # ... and are read here
    plans = kernel.PLANS["gather_agg_bwd_dx"]
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    want = expect_launches(3 * len(parts) + 3 * n_eval,
                           5 * len(parts) + 3 * n_eval)
    check(launches == want, f"{CGCN}: launches {launches} != {want}")
    check(plans == len(parts), f"{CGCN}: {plans} plans for {len(parts)} "
          f"parts")
    check(math.isfinite(res["loss"]), f"{CGCN}: non-finite loss")
    again = baselines.train_clustergcn(graph, cfg, tcfg, CGCN_PPB, seed=0,
                                       epochs=1, device=DEVICE)
    check(again["loss"] == res["loss"] and
          again["val_acc"] == res["val_acc"],
          f"{CGCN}: relaunch {again} != {res}")
    sizes = [len(p) for p in parts]
    log(f"[11 clustergcn] 1 epoch, {CGCN_PPB} communities a part: "
        f"{len(parts)} parts of {min(sizes)}-{max(sizes)} nodes, caps "
        f"(cap_n {cap_n}, cap_e {cap_e}); per-epoch time "
        f"{res['per_epoch_time_s'] * 1e3:.1f} ms (the call {wall:.2f} s "
        f"with its evaluation of {n_eval} unions); loss {res['loss']:.4f}, "
        f"val acc {res['val_acc']:.4f}; peak {peak:.2f} GiB; launches "
        f"{launches} = 3 fwd + 5 bwd_dx a part, 3 fwd + 3 bwd_dx an "
        f"evaluated union; "
        f"{plans} plans (one a part); a second run: loss and val acc "
        f"bit-identical")
    tr = baselines.SubgraphTrainer(graph, cfg, tcfg, seed=0, device=DEVICE)
    build_ms = []
    for p in parts[:5]:
        t0 = time.perf_counter()
        batch = baselines.induced_subgraph(graph, p, cap_n, cap_e, DEVICE)
        torch.cuda.synchronize()
        build_ms.append((time.perf_counter() - t0) * 1e3)
    log(f"[11 clustergcn] induced subgraph on the host and its upload: "
        f"median {statistics.median(build_ms):.1f} ms a part; the table of "
        f"the last {tuple(batch.nbr.shape)} ({int(batch.nbr_mask.sum())} "
        f"edges)")
    subgraph_profile(torch, "clustergcn", tr, batch, lambda j: (0, j))
    del tr, batch
    torch.cuda.empty_cache()
    return {CGCN: launches}


def csr_rows(torch, rows, cols, vals, shape):
    """The CSR matrix of `shape` holding vals at (rows, cols), rows
    non-decreasing; built outside any timed call."""
    crow = torch.zeros(shape[0] + 1, dtype=torch.int64, device=rows.device)
    crow[1:] = torch.cumsum(torch.bincount(rows.long(), minlength=shape[0]),
                            0)
    return torch.sparse_csr_tensor(crow, cols.long(), vals, shape,
                                   check_invariants=False)


def full_shape_kernels(torch, tr, batch):
    """The kernels of a full-batch step at the shapes the step hands them
    (`models.gnn.fullgraph`: V virtual rows of 32 slots): gather_agg_fwd
    (each virtual row's mean, layer 0, F 602) bit for bit against the plain
    version that adds in its order; the segment sum of the virtual rows
    into the N + 1 rows (the sort-free bwd_dx kernel, F 602) and bwd_dx
    through the batch's plan (layer 1, F 256, a seeded g) against the
    plain scatter-add column by column (`index_add_`, atomic: within a
    tolerance); relaunches bit-identical; ms, plain ms, the CSR
    `torch.sparse.mm` computing the same function, and the bound (inputs
    and output moved once at 3.35 TB/s against 2 flops a real edge and
    feature at 67 TFLOP/s). Then the whole aggregation (the two calls)
    against one CSR `sparse.mm` of the N x N mean matrix, and (f)
    `gather_mean` against its plain version, row chunk by chunk."""
    from repro_torch.kernels.gather_agg import kernel, ref
    from repro_torch.kernels.gather_mean.ops import gather_mean
    from repro_torch.kernels.gather_mean.ref import gather_mean_ref
    n = batch.nodes.shape[0]
    idx, mask = batch.nbr.contiguous(), batch.nbr_mask
    V, W = idx.shape
    m = mask.to(torch.float32)
    w = (m / torch.clamp(m.sum(dim=1, keepdim=True), min=1.0)).contiguous()
    seg = batch.owner.reshape(-1, 1).contiguous()
    share = batch.share.reshape(-1, 1).contiguous()
    edges = int(mask.sum())
    x = (tr._inputs(batch) * batch.node_mask[:, None]).contiguous()
    F = x.shape[1]
    vrow = torch.arange(V, device=idx.device)[:, None].expand(V, W)[mask]
    src, val = idx[mask], w[mask]
    # fwd: the virtual rows' means
    out = kernel.gather_agg_fwd(x, idx, w)
    want = ref.gather_agg_ref_ordered(x, idx, w)
    err = (out - want).abs().max().item()
    check(torch.equal(out, want), f"fwd at the full batch: max abs err {err}")
    check(torch.equal(out, kernel.gather_agg_fwd(x, idx, w)),
          "fwd at the full batch differs between launches")
    A = csr_rows(torch, vrow, src, val, (V, n))
    lib_err = (torch.sparse.mm(A, x) - want).abs().max().item()
    b_ms, b_by = _bound_ms(n * F * 4 + idx.numel() * 8 + V * F * 4,
                           2.0 * edges * F)
    fwd = {"max_abs_err": err, "bound_ms": b_ms, "bound_by": b_by,
           "ms": cuda_ms(torch, lambda: kernel.gather_agg_fwd(x, idx, w)),
           "plain_ms": cuda_ms(torch, lambda: ref.gather_agg_ref_ordered(
               x, idx, w), reps=1, rounds=3),
           "library_ms": cuda_ms(torch, lambda: torch.sparse.mm(A, x))}
    log(f"[11 kernels] gather_agg_fwd at the full batch's layer 0: x "
        f"{n}x{F}, {V} virtual rows of {W} slots ({edges} edges, "
        f"{idx.numel() - edges} padded slots): bit-equal to the ordered "
        f"plain version, relaunch bit-identical; ms {fwd['ms']:.4f}  "
        f"plain_ms {fwd['plain_ms']:.4f} (ordered)  CSR sparse.mm "
        f"{fwd['library_ms']:.4f} (err {lib_err:.3e})  bound_ms "
        f"{b_ms:.4f} ({b_by})")
    # the segment sum into the rows
    agg = kernel.gather_agg_bwd_dx_sorted(seg, share, out, n)
    S = csr_rows(torch, batch.owner, torch.arange(V, device=idx.device),
                 batch.share, (n, V))
    seg_want = ref.gather_agg_bwd_dx_ref(seg, share, out, n)
    seg_err = (agg - seg_want).abs().max().item()
    check(torch.allclose(agg, seg_want, rtol=1e-5, atol=1e-6),
          f"segment sum at the full batch: max abs err {seg_err}")
    check(torch.equal(agg, kernel.gather_agg_bwd_dx_sorted(seg, share, out,
                                                           n)),
          "segment sum differs between launches")
    seg_ms = cuda_ms(torch, lambda: kernel.gather_agg_bwd_dx_sorted(
        seg, share, out, n))
    sb_ms, _ = _bound_ms(V * F * 4 + V * 8 + n * F * 4, 2.0 * V * F)
    seg_plain = cuda_ms(torch, lambda: ref.gather_agg_bwd_dx_ref(
        seg, share, out, n))
    seg_lib = cuda_ms(torch, lambda: torch.sparse.mm(S, out))
    log(f"[11 kernels] segment sum (sorted bwd_dx, fanout 1) of the "
        f"{V} virtual-row means into {n} rows, F {F}: max abs err "
        f"{seg_err:.3e} against the plain index_add_, relaunch "
        f"bit-identical; ms {seg_ms:.4f}  plain_ms {seg_plain:.4f}  CSR "
        f"sparse.mm {seg_lib:.4f}  bound_ms {sb_ms:.4f}")
    # the whole aggregation against one sparse.mm of the mean matrix
    dst = batch.owner.long()[:, None].expand(V, W)[mask]
    deg = torch.bincount(dst, minlength=n).to(torch.float32)
    order = torch.argsort(dst, stable=True)
    M = csr_rows(torch, dst[order], src[order],
                 1.0 / deg[dst[order]], (n, n))
    whole = fwd["ms"] + seg_ms
    m_ms = cuda_ms(torch, lambda: torch.sparse.mm(M, x))
    m_err = (torch.sparse.mm(M, x) - agg).abs().max().item()
    log(f"[11 kernels] the whole mean aggregation at layer 0: the two "
        f"calls {whole:.4f} ms against one CSR sparse.mm of the {n}x{n} "
        f"mean matrix {m_ms:.4f} ms (max abs diff {m_err:.3e})")
    # (f) the shim at the same shape
    got = gather_mean(x, idx, mask)
    check(torch.equal(got, out), "gather_mean != gather_agg with its w")
    step = 16384
    plain = torch.cat([gather_mean_ref(x, idx[s:s + step], mask[s:s + step])
                       for s in range(0, V, step)])
    g_err = (got - plain).abs().max().item()
    scale = plain.abs().max().item()
    check(g_err <= 1e-5 * scale + 1e-6, f"gather_mean max abs err {g_err}")
    log(f"[11 gather_mean] at the full batch's layer 0: equal to "
        f"gather_agg_fwd with w = mask / count bit for bit; against its "
        f"plain version (row chunks of {step}) max abs err {g_err:.3e} "
        f"(tol 1e-5 x {scale:.3e} + 1e-6)")
    del out, want, plain, got, x, A, agg, seg_want, M
    # bwd_dx through the batch's plan at layer 1's width
    H = 256
    g = torch.randn((V, H), generator=torch.Generator(
        device=idx.device).manual_seed(7), device=idx.device)
    plan = kernel.bwd_dx_plan(idx, n)
    plan_ms = cuda_ms(torch, lambda: kernel.bwd_dx_plan(idx, n), reps=3,
                      rounds=3)
    dx = kernel.gather_agg_bwd_dx(idx, w, g, n, plan)

    def plain_dx():
        acc = torch.zeros((n, H), device=g.device)
        for j in range(W):
            acc.index_add_(0, idx[:, j].long(), w[:, j, None] * g)
        return acc

    want = plain_dx()
    terms = int(torch.bincount(idx[w != 0].long()).max())
    tol = max(1e-5, 1e-7 * terms)
    err = (dx - want).abs().max().item()
    check(torch.allclose(dx, want, rtol=tol, atol=tol),
          f"bwd_dx at the full batch: max abs err {err} (tol {tol})")
    check(torch.equal(dx, kernel.gather_agg_bwd_dx(idx, w, g, n, plan)),
          "bwd_dx at the full batch differs between launches")
    order = torch.argsort(src, stable=True)
    At = csr_rows(torch, src[order], vrow[order], val[order], (n, V))
    lib_err = (torch.sparse.mm(At, g) - want).abs().max().item()
    b_ms, b_by = _bound_ms(V * H * 4 + idx.numel() * 8 + n * H * 4,
                           2.0 * edges * H)
    k_ms = cuda_ms(torch, lambda: kernel.gather_agg_bwd_dx(idx, w, g, n,
                                                           plan))
    dxr = {"max_abs_err": err, "bound_ms": b_ms, "bound_by": b_by,
           "ms": k_ms, "plan_ms": plan_ms,
           "plain_ms": cuda_ms(torch, plain_dx, reps=1, rounds=3),
           "library_ms": cuda_ms(torch, lambda: torch.sparse.mm(At, g))}
    log(f"[11 kernels] gather_agg_bwd_dx at the full batch's layer 1: dx "
        f"{n}x{H} from {V} virtual rows of {W} slots, at most {terms} "
        f"weighted edges on a row: max abs err {err:.3e} against the plain "
        f"column-by-column index_add_ (tol {tol:.1e}), relaunch "
        f"bit-identical; ms {k_ms:.4f} (its plan {plan_ms:.4f}, built once "
        f"for every step on the batch)  plain_ms {dxr['plain_ms']:.4f}  CSR "
        f"sparse.mm of the transpose {dxr['library_ms']:.4f} (err "
        f"{lib_err:.3e})  bound_ms {b_ms:.4f} ({b_by})")
    return {"gather_agg_fwd": fwd, "gather_agg_bwd_dx": dxr}


def phase_fullbatch(torch, graph):
    """(e) `train_fullbatch`, 3 epochs: epoch time, peak memory, the
    validation accuracy curve; 3 fwd and 5 bwd_dx a step and 3 fwd and 3
    bwd_dx an evaluation, one plan for the run; a second run's curve
    bit-identical; two fresh trainers' step losses bit-identical; a
    profiled step; the kernels at the full batch's shapes and (f)
    `gather_mean`."""
    import numpy as np

    from repro_torch.configs import CONFIGS, TrainConfig
    from repro_torch.kernels.gather_agg import kernel
    from repro_torch.train import baselines

    cfg, tcfg = CONFIGS["graphsage"], TrainConfig()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()                             # counts start here
    t0 = time.perf_counter()
    res = baselines.train_fullbatch(graph, cfg, tcfg, seed=0,
                                    epochs=FB_EPOCHS, device=DEVICE)
    wall = time.perf_counter() - t0
    torch.cuda.synchronize()
    launches = read_launches()                   # ... and are read here
    plans = kernel.PLANS["gather_agg_bwd_dx"]
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    want = expect_launches(6 * FB_EPOCHS, 8 * FB_EPOCHS)
    check(launches == want, f"{FULLBATCH}: launches {launches} != {want}")
    check(plans == 1, f"{FULLBATCH}: {plans} plans, want 1 for the run")
    again = baselines.train_fullbatch(graph, cfg, tcfg, seed=0,
                                      epochs=FB_EPOCHS, device=DEVICE)
    check(again["val_acc_curve"] == res["val_acc_curve"],
          f"{FULLBATCH}: relaunch curve {again['val_acc_curve']}")
    log(f"[11 fullbatch] {FB_EPOCHS} epochs (one step each): per-epoch time "
        f"{res['per_epoch_time_s'] * 1e3:.1f} ms (the call {wall:.2f} s with "
        f"the host build and the evaluations); val acc curve "
        f"{[round(a, 4) for a in res['val_acc_curve']]}; peak {peak:.2f} "
        f"GiB; launches {launches} = 3 fwd + 5 bwd_dx a step, 3 fwd + 3 "
        f"bwd_dx an evaluation; {plans} plan for the run; a second run's "
        f"curve bit-identical")
    t0 = time.perf_counter()
    batch = baselines.induced_subgraph(graph, np.arange(graph.num_nodes),
                                       graph.num_nodes + 1,
                                       graph.num_edges + 1, DEVICE)
    torch.cuda.synchronize()
    log(f"[11 fullbatch] the full graph's induced subgraph and table "
        f"{tuple(batch.nbr.shape)} on the host and its upload: "
        f"{time.perf_counter() - t0:.2f} s")
    trs = [baselines.SubgraphTrainer(graph, cfg, tcfg, seed=0, device=DEVICE)
           for _ in range(2)]
    losses = [[float(tr.step(batch, e, 0)) for e in range(2)] for tr in trs]
    check(losses[0] == losses[1], f"{FULLBATCH}: relaunch losses {losses}")
    log(f"[11 fullbatch] two fresh trainers, 2 steps each: losses "
        f"bit-identical {losses[0]}")
    del trs[1]
    subgraph_profile(torch, "fullbatch", trs[0], batch,
                     lambda j: (2 + j, 0))
    readings = full_shape_kernels(torch, trs[0], batch)
    del trs, batch
    torch.cuda.empty_cache()
    return {FULLBATCH: launches}, readings


def phase_prior_work(torch, graph, caps, eval_caps):
    """Phase 11 on the reddit-602 graph (`caps`: comm_rand's, printed
    beside LABOR's): returns the launches of its runs by path and the
    full-batch shapes' kernel readings."""
    t_phase = time.perf_counter()
    runs = phase_labor(torch, graph, caps, eval_caps)
    runs.update(phase_clustergcn(torch, graph))
    fb_runs, readings = phase_fullbatch(torch, graph)
    runs.update(fb_runs)
    log(f"[11 done] phase 11: {time.perf_counter() - t_phase:.1f} s")
    return runs, readings


# ---------------------------------------------------------------------------
# phase 13: the analysis gate on the card
# ---------------------------------------------------------------------------
GATE_STEPS = 10
# the GNN paths run under the sync gate: (config, policy, pipeline, cache)
GATED = {"gate_sage_sync": ("graphsage", "comm_rand", "sync", None),
         "gate_sage_async": ("graphsage", "comm_rand", "async", None),
         "gate_sage_static": ("graphsage", "comm_rand", "sync", "static"),
         "gate_sage_dynamic": ("graphsage", "comm_rand", "sync", "dynamic"),
         "gate_gcn": ("gcn", "comm_rand", "sync", None),
         "gate_gat": ("gat", "comm_rand", "sync", None),
         "gate_labor": ("graphsage", "labor", "sync", None)}
# the dynamic run starts this many steps before the end of epoch 0, so
# that its steps cross the boundary and its refill
GATE_BEFORE_BOUNDARY = 5


def phase_gate_audit(torch):
    """(a) the op audit (`repro_torch.analysis.op_audit`) on the card at
    the tiny graph's shapes: every section ok, `kernels` run (not
    skipped)."""
    from repro_torch.analysis import op_audit
    t0 = time.perf_counter()
    rep = op_audit.audit_all(device=DEVICE)
    for section in op_audit.SECTIONS:
        log(f"[13 audit] {section:12s} "
            f"{op_audit.section_status(rep[section])}")
    k = rep["kernels"]
    check("skipped" not in k, "the kernels section skipped on the card")
    for name in ("gather_agg", "gather_cached"):
        log(f"[13 audit] kernels {name}: launches {k[name]['launches']}  "
            f"profiled {k[name]['profiled']} (trace kernels "
            f"{k[name]['trace_kernels']}, windows {k[name]['windows']})  "
            f"syncs {k[name]['syncs']}  "
            f"feature gathers {k[name]['feature_gathers']}  "
            f"indexing_backward {k[name]['indexing_backward']}")
    ts = rep["train_step"]
    log(f"[13 audit] train_step: {ts['ops']} ops, hash stable "
        f"{ts['stable']}; eval {ts['eval']['ops']} ops, allowed "
        f"{ts['eval']['allowed_syncs']}; train_steps(2) windows "
        f"{ts['loop']['windows']} promised {ts['loop']['promised']}; "
        f"csrc blocking calls {k['sources']['blocking_calls']}")
    for section in op_audit.SECTIONS:
        check(rep[section]["ok"], f"audit section {section}: "
              f"{json.dumps(rep[section], default=str)[:2000]}")
    log(f"[13 audit] {time.perf_counter() - t0:.1f} s")


def phase_gate_copies(torch):
    """The host-to-device copies the repaired paths make, each behind a
    running kernel (a ~0.25 s `torch.cuda._sleep`): a batch's 8-byte
    position from pageable memory (`batch_roots`) and an epoch's order of
    151 x 1024 roots from page-locked memory (`to_device_int32`) must each
    return while the kernel still runs (`query()` False): neither waits
    for the device. Each is made once before, so that allocation is not
    timed."""
    import numpy as np
    from repro_torch.batching.stream import batch_roots, to_device_int32
    n = 151 * 1024
    order = torch.zeros(n, dtype=torch.int32, device=DEVICE)
    host = np.zeros(n, np.int32)
    for what, fn in (
            ("a position, 8 B pageable", lambda: batch_roots(order, 7, 1024)),
            (f"an epoch's order, {n * 4} B page-locked",
             lambda: to_device_int32(host, order.device))):
        fn()
        torch.cuda.synchronize()
        torch.cuda._sleep(500_000_000)
        t0 = time.perf_counter()
        fn()
        ms = (time.perf_counter() - t0) * 1e3
        running = not torch.cuda.current_stream().query()
        torch.cuda.synchronize()
        log(f"[13 copies] {what}: the host call {ms:.3f} ms behind a "
            f"running kernel, which still runs after it: {running}")
        check(running, f"{what}: the copy waited for the device")


def gate_want(name: str, steps: int, n_eval: int):
    """The launches `steps` train steps and `n_eval` eval batches of run
    `name` make (phase 4's counts; the dynamic run refills once)."""
    config, _, _, cache = GATED[name]
    dx, dw = {"graphsage": (4, 0), "gcn": (4, 0), "gat": (9, 3)}[config]
    want = {k: 0 for k in read_launches()}
    want.update(gather_agg_fwd=3 * (steps + n_eval),
                gather_agg_bwd_dx=dx * steps, gather_agg_bwd_dw=dw * steps)
    if cache is not None:
        want["gather_cached_fwd"] = steps + n_eval
    if cache == "dynamic":
        want["clock_refill"] = 1
    return want


def gated_run(torch, graph, name, make, val):
    """`GATE_STEPS` steps of run `name` ungated from one fresh trainer,
    then gated from another: allowed syncs by window equal to
    `promised_reads`, losses bit-identical, launches as phase 4 counts
    them; the sync run also evaluates `val` on both. Returns the gated
    run's launches."""
    from repro_torch.analysis.sync_gate import sync_gate
    evaluate = name == "gate_sage_sync"
    n_eval = -(-len(val) // 1024) if evaluate else 0
    out = {}
    for gated in (False, True):
        tr = make()
        try:
            promised, losses, ms = {}, [], []
            torch.cuda.synchronize()
            reset_launches()                     # counts start here
            gate_or_not = sync_gate() if gated else contextlib.nullcontext()
            with gate_or_not as gate:
                for _ in range(GATE_STEPS):
                    for k, n in tr.promised_reads(1).items():
                        promised[k] = promised.get(k, 0) + n
                    t0 = time.perf_counter()
                    losses += tr.train_steps(1)
                    ms.append((time.perf_counter() - t0) * 1e3)
                ev = tr.evaluate(val) if evaluate else None
            torch.cuda.synchronize()
            launches = read_launches()           # ... and are read here
            if evaluate:
                promised["eval"] = 1
            out[gated] = (losses, ms, ev, launches,
                          gate.counts() if gated else None, promised,
                          tr.cache_meter.refills)
        finally:
            if tr.pipeline == "async":
                tr.stream.close()
            del tr
            torch.cuda.empty_cache()
    (lu, msu, evu, _, _, _, _), (lg, msg, evg, launches, counts, promised,
                                 refills) = out[False], out[True]
    want = gate_want(name, GATE_STEPS, n_eval)
    log(f"[13 gate] {name}: {GATE_STEPS} steps under "
        f"set_sync_debug_mode('error'): allowed syncs {counts} (promised "
        f"{promised}); median step {statistics.median(msg):.2f} ms gated "
        f"vs {statistics.median(msu):.2f} ms ungated (first "
        f"{msg[0]:.2f} / {msu[0]:.2f}); loss {lg[0]:.4f} -> {lg[-1]:.4f}"
        f"{'; refilled ' + str(refills) + ' rows' if refills else ''}; "
        f"launches {launches}")
    check(counts == promised,
          f"{name}: allowed syncs {counts} != promised {promised}")
    check(lg == lu, f"{name}: gated losses {lg} != ungated {lu}")
    check(all(map(math.isfinite, lg)), f"{name}: non-finite loss")
    check(evg == evu, f"{name}: gated eval {evg} != ungated {evu}")
    check(launches == want, f"{name}: launches {launches} != {want}")
    return launches


def _parent_take(self, epoch, pos):
    """`BatchStream._take` as it was before the gate: the batch's roots
    copied from pageable host memory with a blocking `.to(device)`."""
    import numpy as np
    from repro_torch.batching.stream import build_at
    import torch
    roots = torch.as_tensor(np.asarray(self.root_batches(epoch)[pos]),
                            dtype=torch.int32)
    return build_at(self.g, roots.to(self.device), self.labels,
                    self.fanouts, self.caps, self.sampler, self.seed, epoch,
                    pos, self.epoch_ctx(epoch))


def _parent_adamw_update(grads, state, params, *, lr, b1=0.9, b2=0.999,
                         eps=1e-8, weight_decay=0.0):
    """`optim.adamw.update` as it was before the gate: the bias
    corrections' bases made with `torch.tensor(b, device=)`, a blocking
    host-to-device copy each."""
    import torch
    from repro_torch.optim.adamw import tree_leaves, tree_unflatten
    count = state["count"] + 1
    c = count.to(torch.float32)
    bc1 = 1.0 - torch.pow(torch.tensor(b1, dtype=torch.float32,
                                       device=c.device), c)
    bc2 = 1.0 - torch.pow(torch.tensor(b2, dtype=torch.float32,
                                       device=c.device), c)
    new_p, new_m, new_v = [], [], []
    for g, m, v, p in zip(tree_leaves(grads), tree_leaves(state["m"]),
                          tree_leaves(state["v"]), tree_leaves(params)):
        g = g.to(torch.float32)
        m = b1 * m + (1 - b1) * g
        v = b2 * v + (1 - b2) * torch.square(g)
        step = (m / bc1) / (torch.sqrt(v / bc2) + eps) \
            + weight_decay * p.to(torch.float32)
        new_p.append((p - lr * step).to(p.dtype))
        new_m.append(m)
        new_v.append(v)
    return tree_unflatten(params, new_p), {
        "m": tree_unflatten(params, new_m), "v": tree_unflatten(params, new_v),
        "count": count}


def _parents(root: bool, adamw: bool) -> contextlib.ExitStack:
    """The pre-gate code paths (`root`: the per-batch root copy; `adamw`:
    the bases' copies) patched in for the block."""
    from unittest import mock

    from repro_torch.batching.stream import BatchStream
    from repro_torch.optim import adamw as adamw_module
    stack = contextlib.ExitStack()
    if root:
        stack.enter_context(mock.patch.object(BatchStream, "_take",
                                              _parent_take))
    if adamw:
        stack.enter_context(mock.patch.object(adamw_module, "update",
                                              _parent_adamw_update))
    return stack


def phase_gate_repairs(torch, make):
    """(c) what the gate found, against the repairs: with the parent's
    root copy, and with the parent's AdamW, a gated GraphSAGE step raises;
    then 10 ungated steps each of parent (both) and change in turns
    (parent, change, change, parent) on fresh trainers from one seed:
    losses bit-identical, median step ms."""
    from repro_torch.analysis.sync_gate import sync_gate
    for what in ("root", "adamw"):
        tr = make()
        try:
            with _parents(what == "root", what == "adamw"):
                with sync_gate():
                    tr.train_steps(1)
            raise AssertionError(f"the gate let the parent's {what} pass")
        except RuntimeError as e:
            check("synchroniz" in str(e), f"parent {what}: {e}")
            log(f"[13 repair] parent {what}: the gated step raises "
                f"({str(e).splitlines()[0][:80]})")
        finally:
            del tr
    ms, losses = {"parent": [], "change": []}, {}
    for kind in ("parent", "change", "change", "parent"):
        tr = make()
        with (_parents(True, True) if kind == "parent" else
              contextlib.nullcontext()):
            got, step_ms = timed_steps(torch, tr, GATE_STEPS)
        del tr
        torch.cuda.empty_cache()
        ms[kind] += step_ms
        check(losses.setdefault(kind, got) == got,
              f"{kind}: losses differ between two runs")
    check(losses["parent"] == losses["change"],
          "the repairs changed the losses")
    log(f"[13 repair] graphsage sync, {GATE_STEPS} steps x 2 runs each, in "
        f"turns: median step parent {statistics.median(ms['parent']):.2f} "
        f"ms, change {statistics.median(ms['change']):.2f} ms (means "
        f"{statistics.mean(ms['parent']):.2f}, "
        f"{statistics.mean(ms['change']):.2f}); losses bit-identical")


def phase_gate(torch, graph, policy, plan, caps, eval_caps):
    """Phase 13: (a) the op audit on the card; (b) the sync gate over every
    GNN path at full width on the reddit-602 graph, from the graph, caps
    and cache plan earlier phases built. Returns the gated runs'
    launches."""
    from repro_torch.batching import Cursor, make_policy
    from repro_torch.configs import CONFIGS, TrainConfig
    from repro_torch.featcache import dynamic
    from repro_torch.train.gnn_loop import GNNTrainer
    t_phase = time.perf_counter()
    phase_gate_audit(torch)
    phase_gate_copies(torch)
    check(bool(LABOR_CAPS), "phase 11 left no LABOR caps")
    val = graph.val_ids[:EVAL_BATCHES * TrainConfig().batch_size]
    runs = {}
    for name, (config, pol, pipeline, cache) in GATED.items():
        def make(config=config, pol=pol, pipeline=pipeline, cache=cache):
            c = None
            if cache == "static":
                c = plan.to(DEVICE)
            elif cache == "dynamic":
                c = dynamic.from_plan(plan.to(DEVICE))
            labor = pol == "labor"
            tr = GNNTrainer(graph, CONFIGS[config], TrainConfig(),
                            make_policy("labor") if labor else policy,
                            caps=tuple(LABOR_CAPS) if labor else caps,
                            eval_caps=eval_caps, seed=0, device=DEVICE,
                            cache=c, pipeline=pipeline)
            if cache == "dynamic":
                tr.stream.cursor = Cursor(
                    0, tr.stream.num_batches() - GATE_BEFORE_BOUNDARY)
            return tr
        runs[name] = gated_run(torch, graph, name, make, val)
        if name == "gate_sage_sync":
            phase_gate_repairs(torch, make)
    log(f"[13 done] phase 13: {time.perf_counter() - t_phase:.1f} s")
    return runs


# ---------------------------------------------------------------------------
# phase 6: LM serving (gemma3-1b prefill + greedy decode)
# ---------------------------------------------------------------------------
def serve_model(torch, arch, tag):
    """Full-width `arch` as the serve CLI draws it: weights from a seeded
    generator on the card, directly in the compute dtype (bf16; the
    leaves the reference uses in float32 stay float32), one layer slice
    at a time. Its parameter count must be `SERVE_PARAMS[arch]`."""
    from repro_torch.configs import LM_CONFIGS
    from repro_torch.models.lm import transformer
    cfg = LM_CONFIGS[arch]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params = transformer.init(
        cfg, torch.Generator(device=DEVICE).manual_seed(0),
        max_seq=SERVE_PROMPT + SERVE_NEW, device=DEVICE,
        dtype=getattr(torch, cfg.dtype))
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    n = transformer.param_count(params)
    check(n == SERVE_PARAMS[arch], f"{arch}: {n} params, not "
          f"{SERVE_PARAMS[arch]}")
    tokens = torch.randint(0, cfg.vocab_size, (SERVE_BATCH, SERVE_PROMPT),
                           generator=torch.Generator().manual_seed(1))
    ffn = (f"{cfg.num_experts} experts top-{cfg.top_k} of d_ff "
           f"{cfg.moe_d_ff}, shared expert {cfg.shared_d_ff}" if cfg.moe
           else f"d_ff {cfg.d_ff}")
    glob = [i for i in range(cfg.num_layers) if cfg.is_global_layer(i)]
    mixer = (f"{cfg.num_heads} WKV heads of {cfg.head_dim}, {cfg.act} "
             f"channel mix of" if cfg.rwkv else
             f"heads {cfg.num_heads} over {cfg.num_kv_heads} KV of "
             f"{cfg.head_dim}{' (qkv bias)' if cfg.qkv_bias else ''},")
    pos = "" if cfg.rwkv else (
        f", RoPE theta {cfg.rope_theta:g}, window {cfg.window}, global "
        f"layers {glob if cfg.window else 'all'}")
    kept = []
    transformer._tree_map(lambda p, t: kept.append(
        t.numel() if t.dtype == torch.float32 else 0), params)
    log(f"[{tag} serve] {cfg.name}: {cfg.num_layers} layers, d_model "
        f"{cfg.d_model}, {mixer} {ffn}, vocab {cfg.padded_vocab}{pos}: {n} "
        f"params ({sum(kept)} float32), init {dt:.1f} s ({cfg.dtype} on the "
        f"card; {torch.cuda.memory_allocated() / 2 ** 30:.2f} GiB)")
    return cfg, params, tokens.to(DEVICE)


def capture_attention(torch, cfg, params, tokens, layers):
    """The (q, k, v, mask keywords) a real prefill hands the flash kernel
    at `layers`, taken by wrapping the function the transformer calls
    (this prefill is not a counted run)."""
    from repro_torch.models.lm import transformer
    real, calls, seen = transformer.flash_attention, [], {}

    def spy(q, k, v, **kw):
        if len(calls) in layers:
            seen[len(calls)] = (q.clone(), k.clone(), v.clone(), kw)
        calls.append(len(calls))
        return real(q, k, v, **kw)

    transformer.flash_attention = spy
    try:
        with torch.no_grad():
            transformer.prefill(cfg, params, {"tokens": tokens})
    finally:
        transformer.flash_attention = real
    check(len(calls) == cfg.num_layers,
          f"prefill made {len(calls)} attention calls")
    return seen


def sdpa_backend(torch, fn) -> str:
    """The backend `scaled_dot_product_attention` dispatched to: the aten
    op under it, read from a CPU-side profile of one call."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
        torch.cuda.synchronize()
    ops = sorted({e.key for e in prof.key_averages()
                  if e.key.startswith("aten::_scaled_dot_product")})
    return "/".join(ops) or "unknown"


def check_flash(torch, label, q, k, v, kw, tag="6"):
    """flash_attention_fwd against its plain version at one shape: the
    route it took (bf16 must take the tensor-core kernel, float32 the
    SIMT one), max error (2e-2 bf16, 2e-5 float32, the reference's
    tolerances), on the tensor-core route also the error against the
    emulation of its rounding points (`attention_ref(..., p_bf16=True,
    kv_tile=...)`) within 2^-7 |emulation| + 2^-10 max|v| (one output ulp
    plus weights that round the other way: `tests/test_torch_gpu.py`
    derives it), bit-identical relaunch, ms and TFLOP/s, plain ms, SDPA ms
    and the bound."""
    import torch.nn.functional as Fn

    from repro_torch.kernels.flash_attention import kernel, ref
    B, Sq, H, D = q.shape
    Skv = k.shape[1]
    routes = dict(kernel.ROUTES)
    out = kernel.flash_attention_fwd(q, k, v, **kw)
    route = [r for r, n in kernel.ROUTES.items() if n != routes[r]]
    want_route = ["tensor_core" if q.dtype == torch.bfloat16 else "simt"]
    check(route == want_route, f"flash {label}: route {route}, not "
          f"{want_route}")
    want = ref.attention_ref(q, k, v, **kw)
    err = (out.float() - want.float()).abs().max().item()
    tol = 2e-2 if q.dtype == torch.bfloat16 else 2e-5
    check(bool(torch.isfinite(out).all()), f"flash {label}: non-finite")
    check(torch.allclose(out.float(), want.float(), rtol=tol, atol=tol),
          f"flash {label}: max abs err {err} (tol {tol})")
    emu_text = ""
    if route == ["tensor_core"]:
        emu = ref.attention_ref(q, k, v, p_bf16=True,
                                kv_tile=kernel.tc_kv_tile(D), **kw).float()
        diff = (out.float() - emu).abs()
        v_max = float(v.float().abs().max())
        ratio = float((diff / (2.0 ** -7 * emu.abs() + 2.0 ** -10 * v_max))
                      .max())
        emu_text = (f"  vs the p_bf16 emulation: max abs err "
                    f"{float(diff.max()):.3e}, {ratio:.3f} of its bound "
                    f"2^-7 |emu| + 2^-10 max|v| (max|v| {v_max:.3f})")
        check(ratio <= 1.0, f"flash {label}: {ratio} of the emulation's "
              f"bound")
        del emu, diff
    check(torch.equal(out, kernel.flash_attention_fwd(q, k, v, **kw)),
          f"flash {label}: differs between launches")
    mask = ref._mask(torch.arange(Sq, device=q.device) + kw["q_offset"],
                     torch.arange(Skv, device=q.device), causal=kw["causal"],
                     window=kw["window"], is_global=kw["is_global"])
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    if kw["is_global"] and kw["q_offset"] == 0 and Sq == Skv:
        def sdpa():
            return Fn.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                                   enable_gqa=True)
    else:
        def sdpa():
            return Fn.scaled_dot_product_attention(qt, kt, vt,
                                                   attn_mask=mask,
                                                   enable_gqa=True)
    lib_err = (sdpa().transpose(1, 2).float() - want.float()).abs().max()
    backend = sdpa_backend(torch, sdpa)
    pairs = int(mask.sum())                 # unmasked (q, kv) per head
    peak = BF16_FLOPS_PER_S if q.dtype == torch.bfloat16 else \
        F32_FLOPS_PER_S
    flops = 4.0 * D * pairs * B * H
    b_ms, b_by = _bound_ms(
        (2 * q.numel() + 2 * k.numel()) * q.element_size(), flops, peak)
    got = {"max_abs_err": err, "bound_ms": b_ms, "bound_by": b_by,
           "route": route[0],
           "ms": cuda_ms(torch, lambda: kernel.flash_attention_fwd(
               q, k, v, **kw)),
           "plain_ms": cuda_ms(torch, lambda: ref.attention_ref(
               q, k, v, **kw)),
           "library_ms": cuda_ms(torch, sdpa)}
    got["tflops"] = flops / got["ms"] / 1e9
    log(f"[{tag} kernels] flash_attention_fwd {label}: q {tuple(q.shape)} k "
        f"{tuple(k.shape)} {str(q.dtype)[6:]} {kw}  route {route[0]}  "
        f"unmasked pairs per head {pairs}  max_abs_err {err:.3e} (tol "
        f"{tol:.0e}){emu_text}  bit-identical relaunch True  ms "
        f"{got['ms']:.4f} ({got['tflops']:.1f} TFLOP/s; the bound's "
        f"{flops / b_ms / 1e9:.1f})  plain_ms {got['plain_ms']:.4f}  "
        f"library_ms {got['library_ms']:.4f} (scaled_dot_product_attention "
        f"via {backend}, err {float(lib_err):.3e})  bound_ms {b_ms:.4f} "
        f"({b_by})")
    return got


def phase_flash(torch, cfg, params, tokens):
    """The kernel at the serving shapes, from a real prefill: the global
    layer, the local one, a ragged length (2047) at the local layer, and
    the global layer in float32. Returns the readings of one prefill (4
    global + 22 local launches: ms, plain, library and bound summed that
    way) with each shape's readings beside them."""
    seen = capture_attention(torch, cfg, params, tokens,
                             (SERVE_GLOBAL, SERVE_LOCAL))
    qg, kg, vg, kwg = seen[SERVE_GLOBAL]
    ql, kl, vl, kwl = seen[SERVE_LOCAL]
    check(kwg["is_global"] and not kwl["is_global"],
          "the captured layers are not global and local")
    kwg, kwl = dict(kwg, q_offset=0), dict(kwl, q_offset=0)
    n = SERVE_PROMPT - 1
    shapes = {
        "global": check_flash(torch, "global layer 5", qg, kg, vg, kwg),
        "local": check_flash(torch, "local layer 0", ql, kl, vl, kwl),
        "ragged": check_flash(torch, f"local layer 0, S {n}",
                              ql[:, :n].contiguous(), kl[:, :n].contiguous(),
                              vl[:, :n].contiguous(), kwl),
        "float32": check_flash(torch, "global layer 5, float32", qg.float(),
                               kg.float(), vg.float(), kwg)}
    n_glob = sum(cfg.is_global_layer(i) for i in range(cfg.num_layers))
    n_loc = cfg.num_layers - n_glob
    per_prefill = {k: n_glob * shapes["global"][k] + n_loc *
                   shapes["local"][k]
                   for k in ("ms", "plain_ms", "library_ms", "bound_ms")}
    return {"flash_attention_fwd": {
        **per_prefill,
        "max_abs_err": max(r["max_abs_err"] for r in shapes.values()),
        "bound_by": "/".join(sorted({shapes[k]["bound_by"]
                                     for k in ("global", "local")})),
        "shapes": shapes}}


def step_inputs(torch, cfg, logits, pcache):
    """One decode step's inputs after a prefill of the serving prompt: a
    bf16 cache one position longer holding the prefill's keys and values
    (or RWKV's float32 state and bf16 token shifts), and each sequence's
    greedy token."""
    from repro_torch.models.lm import transformer
    cache = transformer.fill_cache(cfg, transformer.init_cache(
        cfg, SERVE_BATCH, SERVE_PROMPT + 1, torch.bfloat16, DEVICE), pcache)
    return cache, torch.argmax(logits[:, -1], dim=-1, keepdim=True)


def phase_serve(torch, cfg, params, tokens, run, tag, per_prefill,
                per_step, routes=None):
    """The serving path through `generate`: batch 4, prompt 2048, 32
    greedy tokens. `per_prefill` / `per_step` ({kernel: launches}, every
    other kernel 0) are what one prefill and one decode step must launch:
    each is read alone first (a prefill, then one decode step on its
    cache), then over `generate`, its counters zeroed just before and read
    just after: exactly one prefill's and 32 decode steps' worth.
    `routes` (module, {route: launches} of a prefill, ... of a step), if
    given, must equal that kernel module's `ROUTES` after each."""
    from repro_torch.launch.serve import generate
    from repro_torch.train.train_step import (make_decode_step,
                                              make_prefill_step)

    def want(per, n=1):
        return {k: per.get(k, 0) * n for k in read_launches()}

    def check_routes(i, n=1, label=""):
        if routes is not None:
            module, per = routes[0], routes[i]
            want_r = {k: per.get(k, 0) * n for k in module.ROUTES}
            check(module.ROUTES == want_r, f"{run} {label}: routes "
                  f"{module.ROUTES} != {want_r}")

    prefill, decode = make_prefill_step(cfg), make_decode_step(cfg)
    torch.cuda.synchronize()
    reset_launches()
    logits, pcache = prefill(params, {"tokens": tokens})
    torch.cuda.synchronize()
    alone = read_launches()
    check_routes(1, label="one prefill")
    check(bool(torch.isfinite(logits).all()), "prefill: non-finite logits")
    check(tuple(logits.shape) == (SERVE_BATCH, 1, cfg.padded_vocab),
          f"prefill logits {tuple(logits.shape)}")
    cache, tok = step_inputs(torch, cfg, logits, pcache)
    del pcache
    reset_launches()
    logits, _ = decode(params, cache, tok, SERVE_PROMPT)
    torch.cuda.synchronize()
    step = read_launches()
    check_routes(2, label="one decode step")
    check(bool(torch.isfinite(logits).all()), "decode: non-finite logits")
    del logits, cache
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()                             # counts start here
    res = generate(cfg, params, tokens, SERVE_NEW, device=DEVICE)
    launches = read_launches()                   # ... and are read here
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    if routes is not None:
        gen_routes = dict(routes[0].ROUTES)
        for k in gen_routes:
            want_r = routes[1].get(k, 0) + SERVE_NEW * routes[2].get(k, 0)
            check(gen_routes[k] == want_r, f"{run}: route {k} "
                  f"{gen_routes[k]} != {want_r} over generate")
    check(alone == want(per_prefill),
          f"one prefill: launches {alone} != {want(per_prefill)}")
    check(step == want(per_step),
          f"one decode step: launches {step} != {want(per_step)}")
    total = {k: n + SERVE_NEW * want(per_step)[k]
             for k, n in want(per_prefill).items()}
    check(launches == total, f"{run}: launches {launches} != {total} (one "
          f"prefill and {SERVE_NEW} decode steps)")
    ids = res.ids
    check(tuple(ids.shape) == (SERVE_BATCH, SERVE_NEW + 1),
          f"ids {tuple(ids.shape)}")
    check(bool(((ids >= 0) & (ids < cfg.padded_vocab)).all()),
          "ids out of the vocabulary")
    n_pf = SERVE_BATCH * SERVE_PROMPT
    cache = (f"state cache {res.cache_bytes / 2 ** 20:.1f} MiB (s float32, "
             f"token shifts bf16)" if cfg.rwkv else
             f"KV cache {res.cache_bytes / 2 ** 20:.1f} MiB (bf16, length "
             f"{SERVE_PROMPT + SERVE_NEW})")
    log(f"[{tag} serve] {run}: batch {SERVE_BATCH} x prompt {SERVE_PROMPT}, "
        f"{SERVE_NEW} greedy tokens: prefill {res.prefill_ms:.2f} ms "
        f"({n_pf / res.prefill_ms * 1e3:.0f} tok/s)  decode "
        f"{res.decode_ms_per_step:.2f} ms/step "
        f"({SERVE_BATCH / res.decode_ms_per_step * 1e3:.0f} tok/s)  {cache}"
        f"  peak memory {peak:.2f} GiB  launches "
        f"{launches} (one prefill alone: {alone}; one decode step alone: "
        f"{step}){'' if routes is None else f'  routes {gen_routes}'}  ids "
        f"seq 0 {ids[0, :8].tolist()}...")
    return launches, res


def phase_serve_profile(torch, cfg, params, tokens, res, run, tag, shares,
                        step_shares=None, absent=(), prefill_absent=(),
                        step_absent=(), top: int = 8):
    """One more prefill and one more decode step under torch.profiler:
    CUDA kernels by device time, the share of each hand-written kernel of
    `shares` ({label: a substring of its CUDA name}; each must show in the
    prefill), and the device's idle share of the unprofiled prefill / mean
    decode step of `res`, 1 - kernel ms / that time. The decode step must
    show each kernel of `step_shares` (same form) and no kernel of
    `shares` whose label it lacks. No kernel whose name holds a substring
    of `absent` may show in either, of `prefill_absent` in the prefill, of
    `step_absent` in the decode step."""
    step_shares = step_shares or {}
    from repro_torch.train.train_step import make_decode_step
    from repro_torch.train.train_step import make_prefill_step
    prefill, decode = make_prefill_step(cfg), make_decode_step(cfg)
    out = {}

    def share(dev, busy, shares=shares):
        got = {label: sum(t for k, t, _ in dev if sub in k) / 1e3
               for label, sub in shares.items()}
        return got, ", ".join(f"{label} {ms:.2f} ms (share {ms / busy:.3f})"
                              for label, ms in got.items())

    dev, wall = profile_kernels(
        torch, lambda: out.update(zip(("logits", "pcache"), prefill(
            params, {"tokens": tokens}))))
    busy = sum(t for _, t, _ in dev) / 1e3
    got, text = share(dev, busy)
    for label, ms in got.items():
        check(ms > 0, f"the profiled prefill shows no {label} kernel")
    for sub in (*absent, *prefill_absent):
        check(not any(sub in k for k, _, _ in dev),
              f"the profiled prefill shows {sub}")
    log(f"[{tag} profile] {run} prefill: kernels {busy:.2f} ms in "
        f"{sum(n for _, _, n in dev)} launches, {text}, device idle share "
        f"{1 - busy / res.prefill_ms:.3f} of the unprofiled prefill "
        f"{res.prefill_ms:.2f} ms (profiled wall {wall:.2f} ms)")
    for key, t, n in dev[:top]:
        log(f"[{tag} profile] {run} prefill: {t / 1e3:8.3f} ms  {n:4d} "
            f"calls  {key[:110]}")
    cache, tok = step_inputs(torch, cfg, out["logits"], out.pop("pcache"))
    dev, wall = profile_kernels(
        torch, lambda: decode(params, cache, tok, SERVE_PROMPT))
    busy = sum(t for _, t, _ in dev) / 1e3
    got, text = share(dev, busy, {**shares, **step_shares})
    for sub in (*absent, *step_absent):
        check(not any(sub in k for k, _, _ in dev),
              f"the profiled decode step shows {sub}")
    for label in {**shares, **step_shares}:
        shown = got[label] > 0
        check(shown == (label in step_shares),
              f"the profiled decode step {'shows' if shown else 'lacks'} "
              f"the {label} kernel")
    log(f"[{tag} profile] {run} decode step: kernels {busy:.2f} ms in "
        f"{sum(n for _, _, n in dev)} launches, {text}, device idle share "
        f"{1 - busy / res.decode_ms_per_step:.3f} of the unprofiled mean "
        f"step {res.decode_ms_per_step:.2f} ms (profiled wall {wall:.2f} "
        f"ms)")
    for key, t, n in dev[:top]:
        log(f"[{tag} profile] {run} decode: {t / 1e3:8.3f} ms  {n:4d} calls"
            f"  {key[:110]}")


def serve_logits(torch, cfg, params, tokens, steps, device):
    """Prefill, then `steps` greedy decode steps against a float32 cache:
    the logits of each token, on `device`."""
    from repro_torch.models.lm import transformer
    params = transformer.cast_params(cfg, params, device)
    tokens = tokens.to(device)
    with torch.no_grad():
        logits, pcache = transformer.prefill(cfg, params, {"tokens": tokens})
        B, P = tokens.shape
        cache = transformer.fill_cache(cfg, transformer.init_cache(
            cfg, B, P + steps, torch.float32, device), pcache)
        out = [logits[:, -1]]
        for t in range(steps):
            tok = torch.argmax(logits[:, -1], dim=-1, keepdim=True)
            logits, cache = transformer.decode_step(cfg, params, cache, tok,
                                                    P + t)
            out.append(logits[:, -1])
    return [o.cpu() for o in out]


def phase_serve_card_vs_cpu(torch, arch, tag, steps: int = 8):
    """The reduced config of `arch` in float32, same parameters and
    prompts, served on the card (the kernels) and on the CPU (their plain
    versions): the prefill and `steps` decode steps' logits through a
    float32 cache, and the greedy ids of `generate`, whose bf16 cache
    rounds keys that differ by a float32 ulp to neighbouring bf16 values
    now and then."""
    from repro_torch.configs import LM_CONFIGS
    from repro_torch.launch.serve import generate
    from repro_torch.models.lm import transformer
    cfg = LM_CONFIGS[arch].reduced().scaled(dtype="float32")
    params = transformer.init(cfg, torch.Generator().manual_seed(0),
                              device="cpu")
    tokens = torch.randint(0, cfg.vocab_size, (2, 40),
                           generator=torch.Generator().manual_seed(1))
    worst = 0.0
    for a, b in zip(serve_logits(torch, cfg, params, tokens, steps, DEVICE),
                    serve_logits(torch, cfg, params, tokens, steps, "cpu")):
        worst = max(worst, float(((a - b).abs() / (b.abs() + 1e-5)).max()))
        check(torch.allclose(a, b, rtol=1e-4, atol=1e-5),
              f"serve card vs CPU: max abs err {(a - b).abs().max()}")
    cpu = generate(cfg, params, tokens, steps, device="cpu")
    gpu = generate(cfg, params, tokens, steps, device=DEVICE)
    check(torch.equal(gpu.ids.cpu(), cpu.ids), "serve card vs CPU: ids")
    log(f"[{tag} card vs cpu] {cfg.name} float32: prefill + {steps} decode "
        f"steps, logits within rtol 1e-4 / atol 1e-5 (max |d| / (|cpu| + "
        f"1e-5) {worst:.3e}); `generate` greedy ids equal "
        f"{cpu.ids[0].tolist()}")


class TopkReplay:
    """Stands in for `torch` inside `models/lm/moe.py`: its first run
    records each layer's top-k expert choices, a later run takes the same
    choices (its own probabilities gathered at them) and counts the tokens
    whose own choice differs. Routing is discontinuous: two devices whose
    hidden states differ by bf16 rounding pick other experts for
    near-ties, so the logits are held on the same choices."""

    def __init__(self, torch):
        self.torch = torch
        self.seen, self.at, self.flips, self.tokens = [], None, 0, 0

    def __getattr__(self, name):
        return getattr(self.torch, name)

    def topk(self, probs, k, dim=-1):
        torch = self.torch
        v, i = torch.topk(probs, k, dim=dim)
        if self.at is None:
            self.seen.append(i.cpu())
            return v, i
        want = self.seen[self.at].to(i.device)
        self.at += 1
        differ = (torch.sort(i, dim)[0] != torch.sort(want, dim)[0]).any(dim)
        self.flips += int(differ.sum())
        self.tokens += differ.numel()
        return torch.gather(probs, dim, want), want


def teacher_logits(torch, cfg, params, tokens, feed, device):
    """Prefill `tokens`, then one decode step per column of `feed` (the
    same tokens on both devices, so that no argmax tie sends them down
    other paths) against a cache in the compute dtype: the last logits of
    the prefill and of each step, float32 on the CPU."""
    from repro_torch.models.lm import transformer
    params = transformer.cast_params(cfg, params, device)
    dt = getattr(torch, cfg.dtype)
    with torch.no_grad():
        logits, pcache = transformer.prefill(
            cfg, params, {"tokens": tokens.to(device)})
        B, P = tokens.shape
        cache = transformer.fill_cache(cfg, transformer.init_cache(
            cfg, B, P + feed.shape[1], dt, device), pcache)
        out = [logits[:, -1]]
        for t in range(feed.shape[1]):
            logits, cache = transformer.decode_step(
                cfg, params, cache, feed[:, t:t + 1].to(device), P + t)
            out.append(logits[:, -1])
    return [o.float().cpu() for o in out]


def phase_bf16_card_vs_cpu(torch, arch, tag, steps: int = 8):
    """The reduced config of `arch` in bf16 at head_dim 64, so that every
    prefill layer's flash launch takes the tensor-core kernel and (MoE) a
    prefill of 2 x 64 tokens gives an expert capacity of 40, which the
    grouped matmul's tensor-core kernel takes (decode's 8 takes mma_sync):
    prefill and `steps` decode steps' logits on the same tokens and (MoE)
    the same expert choices (`TopkReplay`; the tokens whose own choice
    differs on the card are counted) within 5e-2 x max |logit| of the CPU
    bf16 model (the bound of the CPU tests against JAX in bf16), the
    routes counted."""
    from repro_torch.configs import LM_CONFIGS
    from repro_torch.kernels.flash_attention import kernel as flash_kernel
    from repro_torch.kernels.moe_gmm import kernel as gmm_kernel
    from repro_torch.models.lm import moe, transformer
    cfg = LM_CONFIGS[arch].reduced().scaled(head_dim=64)
    check(cfg.dtype == "bfloat16", f"{cfg.name} computes in {cfg.dtype}")
    params = transformer.init(cfg, torch.Generator().manual_seed(0),
                              device="cpu")
    gen = torch.Generator().manual_seed(1)
    tokens = torch.randint(0, cfg.vocab_size, (2, 64), generator=gen)
    feed = torch.randint(0, cfg.vocab_size, (2, steps), generator=gen)
    replay = TopkReplay(torch)
    moe.torch = replay
    try:
        cpu = teacher_logits(torch, cfg, params, tokens, feed, "cpu")
        replay.at = 0
        reset_launches()
        card = teacher_logits(torch, cfg, params, tokens, feed, DEVICE)
    finally:
        moe.torch = torch
    check(replay.at == len(replay.seen), f"{cfg.name}: top-k calls differ")
    routes = {"flash": dict(flash_kernel.ROUTES)}
    check(routes["flash"] == {"tensor_core": cfg.num_layers, "simt": 0},
          f"{cfg.name} bf16: flash routes {routes['flash']}")
    if cfg.moe:
        routes["moe_gmm"] = dict(gmm_kernel.ROUTES)
        want = {"tensor_core": 2 * cfg.num_layers,
                "mma_sync": 2 * cfg.num_layers * steps, "simt": 0}
        check(routes["moe_gmm"] == want,
              f"{cfg.name} bf16: moe_gmm routes {routes['moe_gmm']}")
    worst = 0.0
    for a, b in zip(card, cpu):
        check(bool(torch.isfinite(a).all()), f"{cfg.name} bf16: non-finite")
        ratio = float((a - b).abs().max()) / float(b.abs().max())
        check(ratio <= 5e-2, f"{cfg.name} bf16: max |d| / max |logit| "
              f"{ratio} > 5e-2")
        worst = max(worst, ratio)
    log(f"[{tag} card vs cpu] {cfg.name} bf16, head_dim 64: prefill 2 x 64 "
        f"+ {steps} decode steps, logits within 5e-2 x max |logit| of the "
        f"CPU bf16 model (worst max |d| / max |logit| {worst:.3e}); routes "
        f"{routes}" + (f"; on the CPU's expert choices: the card's own "
                       f"differ for {replay.flips} of {replay.tokens} "
                       f"token-layers" if cfg.moe else ""))


# ---------------------------------------------------------------------------
# phase 7: MoE serving (qwen2-moe-a2.7b prefill + greedy decode)
# ---------------------------------------------------------------------------
def capture_gmm(torch, cfg, params, tokens):
    """The calls a real prefill and a real decode step (position 2048, on
    the prefill's cache) make at layer 0 to the two grouped-matmul ops the
    MoE layer calls, the gated one (x, wg, wu; rows) and the down product
    (h, wd; rows, out_dtype), whatever their signatures: each as (args,
    keywords), x and h cloned, taken by wrapping both functions (these
    runs are not counted). Each pass must call them 2 times per layer,
    gated then down."""
    from repro_torch.models.lm import moe, transformer
    names = ("moe_gmm_gated", "moe_gmm")
    real = {n: getattr(moe, n) for n in names}
    seen, order = {}, []

    def spy(name):
        def call(*args, **kw):
            if name not in seen:
                seen[name] = ((args[0].clone(), *args[1:]), dict(kw))
            order.append(name)
            return real[name](*args, **kw)
        return call

    got = {}
    for n in names:
        setattr(moe, n, spy(n))
    try:
        with torch.no_grad():
            logits, pcache = transformer.prefill(cfg, params,
                                                 {"tokens": tokens})
            check(order == list(names) * cfg.num_layers,
                  f"prefill: gmm calls {order[:4]}... ({len(order)})")
            got["prefill"] = dict(seen)
            seen.clear()
            order.clear()
            cache, tok = step_inputs(torch, cfg, logits, pcache)
            del pcache
            transformer.decode_step(cfg, params, cache, tok, SERVE_PROMPT)
            check(order == list(names) * cfg.num_layers,
                  f"decode: gmm calls {order[:4]}... ({len(order)})")
            got["decode"] = dict(seen)
    finally:
        for n in names:
            setattr(moe, n, real[n])
    return got


def check_gmm(torch, label, x, w, want_route):
    """moe_gmm_fwd (float32 output) against its plain version at one
    shape: the route it took, max error within 1e-3 * max |plain| (bf16
    inputs) or 2e-5 * max |plain| (float32), bit-identical relaunch, ms,
    plain ms, `torch.bmm` ms (cuBLAS, output in the input dtype) and the
    bound."""
    from repro_torch.kernels.moe_gmm import kernel, ref
    E, C, d = x.shape
    f = w.shape[2]
    routes = dict(kernel.ROUTES)
    out = kernel.moe_gmm_fwd(x, w)
    route = [r for r, n in kernel.ROUTES.items() if n != routes[r]]
    check(route == [want_route], f"gmm {label}: route {route}, not "
          f"{want_route}")
    want = ref.moe_gmm_ref(x, w)
    err = (out - want).abs().max().item()
    scale = want.abs().max().item()
    rel = 1e-3 if x.dtype == torch.bfloat16 else 2e-5
    check(bool(torch.isfinite(out).all()), f"gmm {label}: non-finite")
    check(err <= rel * scale, f"gmm {label}: max abs err {err} > {rel} * "
          f"{scale}")
    check(torch.equal(out, kernel.moe_gmm_fwd(x, w)),
          f"gmm {label}: differs between launches")
    lib_err = (torch.bmm(x, w).float() - want).abs().max().item()
    peak = BF16_FLOPS_PER_S if x.dtype == torch.bfloat16 else \
        F32_FLOPS_PER_S
    b_ms, b_by = _bound_ms(x.numel() * x.element_size()
                           + w.numel() * w.element_size() + E * C * f * 4,
                           2.0 * E * C * d * f, peak)
    got = {"max_abs_err": err, "bound_ms": b_ms, "bound_by": b_by,
           "route": want_route,
           "ms": cuda_ms(torch, lambda: kernel.moe_gmm_fwd(x, w)),
           "plain_ms": cuda_ms(torch, lambda: ref.moe_gmm_ref(x, w)),
           "library_ms": cuda_ms(torch, lambda: torch.bmm(x, w))}
    log(f"[7 kernels] moe_gmm_fwd {label}: x {tuple(x.shape)} w "
        f"{tuple(w.shape)} {str(x.dtype)[6:]}  route {want_route}  "
        f"max_abs_err {err:.3e} (tol {rel:.0e} x max |plain| {scale:.3e})  "
        f"bit-identical relaunch True  ms {got['ms']:.4f}  plain_ms "
        f"{got['plain_ms']:.4f}  library_ms {got['library_ms']:.4f} "
        f"(torch.bmm, err {lib_err:.3e})  bound_ms {b_ms:.4f} ({b_by}; "
        f"{2.0 * E * C * d * f / got['ms'] / 1e9:.1f} TFLOP/s)")
    return got


def _occupied(torch, rows, C):
    """Occupied rows and experts of a `rows` (E, G) over capacity C."""
    G = rows.shape[1]
    occ_rows = int(rows.clamp(max=C // G).sum())
    return occ_rows, int((rows.sum(1) > 0).sum())


def _gmm_bounds(torch, x, ws, rows, out_bytes):
    """(dense bound, occupied bound), each (ms, by), of one launch over x
    and the weights `ws`: dense, every row and expert; occupied, the rows
    `rows` names as non-zero and the weights of the experts that hold
    one (what this run's data needs); the output is written whole."""
    E, C, d = x.shape
    f = ws[0].shape[2]
    occ_rows, occ_e = _occupied(torch, rows, C)
    out = E * C * f * out_bytes
    w_bytes = d * f * 2 * len(ws)
    dense = _bound_ms(E * C * d * 2 + E * w_bytes + out,
                      2.0 * E * C * d * f * len(ws), BF16_FLOPS_PER_S)
    occ = _bound_ms(occ_rows * d * 2 + occ_e * w_bytes + out
                    + rows.numel() * 4,
                    2.0 * occ_rows * d * f * len(ws), BF16_FLOPS_PER_S)
    return dense, occ


def check_gmm_epilogues(torch, path, x, wg, wu, h, wd, rows, want_route):
    """The layer's two launches at one path's real layer-0 inputs: the
    gated one (x, wg, wu) and the down product in the compute dtype (h,
    wd), each dense and with the path's real `rows`, on `want_route`.
    Checks: the output in x's dtype equals the same route's float32
    output cast, bit for bit; the gated one the composite of the same
    route's two float32 outputs (`.to`, `F.silu`, `*` on the card), the
    elements that differ counted and at most one bf16 ulp; with `rows`
    equal to dense (torch.equal) at the real rows, and with one occupied
    expert set to 0 rows (its input zeroed) and one other to C, for both
    launches and the float32 epilogue; bit-identical relaunches. Times
    (ms dense / with rows, plain, `torch.bmm` of the same products,
    bounds dense / occupied, TFLOP/s)."""
    import torch.nn.functional as Fn

    from repro_torch.kernels.moe_gmm import kernel, ref
    dt = x.dtype
    E, C, d = x.shape
    G = rows.shape[1]
    f = wg.shape[2]
    occ_rows, occ_e = _occupied(torch, rows, C)

    def gated(a=x, r=None):
        return kernel.moe_gmm_gated_fwd(a, wg, wu, rows=r)

    def down(a=h, r=None):
        return kernel.moe_gmm_fwd(a, wd, rows=r, out_dtype=dt)

    routes = dict(kernel.ROUTES)
    hg, og = gated(), down()
    check(kernel.ROUTES == dict(routes, **{want_route: routes[want_route]
                                           + 2}),
          f"gmm {path} epilogues: routes {kernel.ROUTES} (was {routes})")
    # bf16 epilogue: the float32 output rounded once
    check(torch.equal(og, kernel.moe_gmm_fwd(h, wd).to(dt)),
          f"gmm {path} down: bf16 out != float32 out .to(bf16)")
    # gated epilogue: the layer's former composite on the same route
    comp = Fn.silu(kernel.moe_gmm_fwd(x, wg).to(dt)) * \
        kernel.moe_gmm_fwd(x, wu).to(dt)
    differ = hg != comp                  # +0 and -0 compare equal here
    n_diff = int(differ.sum())
    ulps = int((hg.view(torch.int16).int() - comp.view(torch.int16).int())
               [differ].abs().max()) if n_diff else 0
    check(ulps <= 1, f"gmm {path} gated: {ulps} bf16 ulps from the "
          f"composite")
    del comp
    # rows: the real ones, then one occupied expert emptied and one full
    e0 = int(torch.argmax(rows.sum(1)))
    e1 = (e0 + 1) % E
    rows2 = rows.clone()
    rows2[e0], rows2[e1] = 0, C // G
    x2, h2 = x.clone(), h.clone()
    x2[e0], h2[e0] = 0, 0
    g32 = kernel.moe_gmm_fwd(x, wg)
    for name, a, b in (
            ("gated", gated(r=rows), hg), ("down", down(r=rows), og),
            ("float32 gate", kernel.moe_gmm_fwd(x, wg, rows=rows), g32),
            ("gated, expert emptied / full", gated(x2, rows2), gated(x2)),
            ("down, expert emptied / full", down(h2, rows2), down(h2))):
        check(torch.equal(a, b), f"gmm {path} {name}: rows != dense")
    check(torch.equal(gated(r=rows), hg) and torch.equal(down(r=rows), og),
          f"gmm {path}: differs between launches")
    del x2, h2, g32, rows2
    got = {}
    for name, ws, fn, plain, lib, out_b in (
            ("gated", (wg, wu), gated,
             lambda: ref.moe_gmm_gated_ref(x, wg, wu),
             lambda: (torch.bmm(x, wg), torch.bmm(x, wu)), 2),
            ("down", (wd,), down, lambda: ref.moe_gmm_ref(h, wd, dt),
             lambda: torch.bmm(h, wd), 2)):
        a = x if name == "gated" else h
        (dense_ms_b, dense_by), (occ_ms_b, occ_by) = _gmm_bounds(
            torch, a, ws, rows, out_b)
        flops = 2.0 * E * C * a.shape[2] * ws[0].shape[2] * len(ws)
        occ_flops = flops * occ_rows / (E * C)
        r = {"ms_dense": cuda_ms(torch, fn),
             "ms": cuda_ms(torch, lambda: fn(r=rows)),
             "plain_ms": cuda_ms(torch, plain),
             "library_ms": cuda_ms(torch, lib),
             "bound_dense_ms": dense_ms_b, "bound_ms": occ_ms_b,
             "bound_by": occ_by, "route": want_route}
        got[name] = r
        w_read = occ_e * a.shape[2] * ws[0].shape[2] * 2 * len(ws)
        tf_dense = flops / r["ms_dense"] / 1e9
        tf_occ = occ_flops / r["ms"] / 1e9
        log(f"[7 kernels] moe_gmm_fwd {path} layer 0 {name} "
            f"({'silu(x wg) * (x wu)' if name == 'gated' else 'h wd'}, out "
            f"{str(dt)[6:]}): x {tuple(a.shape)} route {want_route}  rows "
            f"{occ_rows} of {E * C} occupied, {occ_e} of {E} experts (G "
            f"{G})  ms dense {r['ms_dense']:.4f} ({tf_dense:.1f} TFLOP/s)"
            f"  ms with rows {r['ms']:.4f} ({tf_occ:.1f} occupied TFLOP/s; "
            f"weights read "
            f"{w_read / 1e6:.1f} MB)  plain_ms {r['plain_ms']:.4f}  "
            f"library_ms {r['library_ms']:.4f} (torch.bmm x{len(ws)})  "
            f"bound_ms dense {dense_ms_b:.4f} ({dense_by}), occupied "
            f"{occ_ms_b:.4f} ({occ_by})")
    log(f"[7 kernels] moe_gmm_fwd {path} layer 0 epilogues: bf16 out == "
        f"float32 out .to(bf16) True; gated vs the composite (.to, F.silu, "
        f"*): {n_diff} of {hg.numel()} elements differ, max {ulps} bf16 "
        f"ulp; rows == dense True (real rows; expert {e0} emptied, {e1} "
        f"full); bit-identical relaunch True")
    got["gated_diff"] = n_diff
    return got


def phase_moe_kernels(torch, cfg, params, tokens):
    """moe_gmm_fwd at the inputs a real prefill (C 688: 2 groups of 344)
    and a real decode step (C 8) hand it at layer 0: gate, up and down
    with float32 output against the plain version; in float32 at the
    prefill's and the decode step's gate (simt); at a ragged shape (C 344,
    d 2040, f 1400: no tile divides d or f) and at odd widths (mma_sync);
    then the layer's own launches, the gated one and the down product in
    bf16, with their epilogue and `rows` checks and times; then
    flash_attention_fwd at layer 0's real q, k, v. The prefill's bf16
    calls must take the tensor_core route, decode's mma_sync. Returns the
    readings of one prefill and of one decode step (every layer's two
    launches have layer 0's shapes: ms with rows, plain, library and the
    occupied bound summed over the 2 x 24), each shape's beside them."""
    got = capture_gmm(torch, cfg, params, tokens)
    bf16_route = {"prefill": "tensor_core", "decode": "mma_sync"}
    shapes, layer = {}, {}
    for path, calls in got.items():
        (x, wg, wu), kwg = calls["moe_gmm_gated"]
        (h, wd), kwd = calls["moe_gmm"]
        rows = kwg["rows"]
        check(torch.equal(rows, kwd["rows"]) and rows.dtype == torch.int32,
              f"{path}: the two launches' rows differ")
        check(kwd["out_dtype"] == x.dtype, f"{path}: down out_dtype "
              f"{kwd['out_dtype']}")
        for name, a, w in (("gate", x, wg), ("up", x, wu), ("down", h, wd)):
            shapes[f"{path} {name}"] = check_gmm(
                torch, f"{path} layer 0 {name}", a, w, bf16_route[path])
        shapes[f"{path} gate float32"] = check_gmm(
            torch, f"{path} layer 0 gate, float32", x.float(), wg.float(),
            "simt")
        layer[path] = check_gmm_epilogues(torch, path, x, wg, wu, h, wd,
                                          rows, bf16_route[path])
    x, wg = got["prefill"]["moe_gmm_gated"][0][:2]
    shapes["ragged"] = check_gmm(
        torch, "ragged, prefill gate cut to C 344, d 2040, f 1400",
        x[:, :344, :2040].contiguous(), wg[:, :2040, :1400].contiguous(),
        "tensor_core")
    gen = torch.Generator(device=DEVICE).manual_seed(2)
    shapes["odd widths"] = check_gmm(
        torch, "odd widths (element-wise loads)",
        torch.randn((4, 344, 1001), generator=gen, device=DEVICE,
                    dtype=torch.bfloat16),
        torch.randn((4, 1001, 703), generator=gen, device=DEVICE,
                    dtype=torch.bfloat16), "mma_sync")
    del got, x, wg
    readings = {}
    for path, run in (("prefill", MOE_SERVE), ("decode", MOE_DECODE)):
        per = [layer[path]["gated"], layer[path]["down"]]
        readings[run] = {"moe_gmm_fwd": {
            **{k: cfg.num_layers * sum(r[k] for r in per)
               for k in ("ms", "ms_dense", "plain_ms", "library_ms",
                         "bound_ms", "bound_dense_ms")},
            "route": bf16_route[path],
            "max_abs_err": max(r["max_abs_err"] for r in shapes.values()),
            "bound_by": "/".join(sorted({r["bound_by"] for r in per})),
            "gated_vs_composite_elements_differing": layer[path][
                "gated_diff"],
            "shapes": {**{k: v for k, v in shapes.items()
                          if path == "prefill" or k.startswith(path)},
                       **{f"{path} layer 0 {k}": v
                          for k, v in layer[path].items() if k != "gated_diff"}}}}
        log(f"[7 kernels] moe_gmm_fwd per {PER[run]} ({2 * cfg.num_layers} "
            f"launches of layer 0's shapes, with rows): ms "
            f"{readings[run]['moe_gmm_fwd']['ms']:.3f} (dense "
            f"{readings[run]['moe_gmm_fwd']['ms_dense']:.3f})  plain_ms "
            f"{readings[run]['moe_gmm_fwd']['plain_ms']:.3f}  library_ms "
            f"{readings[run]['moe_gmm_fwd']['library_ms']:.3f} (torch.bmm of "
            f"the 3 products)  bound_ms occupied "
            f"{readings[run]['moe_gmm_fwd']['bound_ms']:.3f} (dense "
            f"{readings[run]['moe_gmm_fwd']['bound_dense_ms']:.3f})")
    seen = capture_attention(torch, cfg, params, tokens, (0,))
    q, k, v, kw = seen[0]
    fl = check_flash(torch, f"{MOE} layer 0", q, k, v,
                     dict(kw, q_offset=0), tag="7")
    readings[MOE_SERVE]["flash_attention_fwd"] = {
        **{key: cfg.num_layers * fl[key]
           for key in ("ms", "plain_ms", "library_ms", "bound_ms")},
        "max_abs_err": fl["max_abs_err"], "bound_by": fl["bound_by"],
        "shapes": {"layer 0": fl}}
    return readings


# ---------------------------------------------------------------------------
# phase 8: RWKV serving (rwkv6-7b prefill + greedy decode)
# ---------------------------------------------------------------------------
def capture_wkv(torch, cfg, params, tokens):
    """The (r, k, v, logw, u, s0) a real prefill hands `wkv6` at layer 0,
    taken by wrapping the function the time mix calls (this prefill is not
    counted). It must call it once per layer."""
    from repro_torch.models.lm import rwkv6, transformer
    real, seen, n = rwkv6.wkv6, [], [0]

    def spy(*args):
        if n[0] == 0:
            seen.extend(None if a is None else a.clone() for a in args)
        n[0] += 1
        return real(*args)

    rwkv6.wkv6 = spy
    try:
        with torch.no_grad():
            transformer.prefill(cfg, params, {"tokens": tokens})
    finally:
        rwkv6.wkv6 = real
    check(n[0] == cfg.num_layers, f"prefill made {n[0]} wkv6 calls")
    return seen


def check_wkv(torch, label, r, k, v, logw, u, s0=None):
    """wkv6_fwd against its plain version (`wkv6_fwd_ref`: the chunked form
    on float32 casts, the scan where 16 does not divide T) at one shape:
    output and final state within 2e-5 x max |plain|, bf16 inputs as
    float32 ones (both sides work in float32 from the same values),
    bit-identical relaunch, ms, plain ms and the bound: each input read
    and each output written once at 3.35 TB/s, against the causal work of
    the chunked form at 67 TFLOP/s float32. A step of a (batch, head)
    takes 4 N^2 flops for reading and updating the state, 2 (C + 1) N for
    its row of the causal score tile (diagonal included) and that row's
    product with v, and N^2 / C for the state's decay once a chunk of
    C = 16; the tile's upper half is zero and not counted. No single
    PyTorch call computes WKV6, so there is no library time."""
    from repro_torch.kernels.rwkv6_chunk import kernel, ref
    B, T, H, N = r.shape
    out, s_f = kernel.wkv6_fwd(r, k, v, logw, u, s0)
    want, want_s = ref.wkv6_fwd_ref(r, k, v, logw, u, s0)
    rel = 2e-5
    errs = {}
    for name, got, exp in (("out", out, want), ("s_final", s_f, want_s)):
        err = (got - exp).abs().max().item()
        scale = exp.abs().max().item()
        check(bool(torch.isfinite(got).all()), f"wkv6 {label}: non-finite "
              f"{name}")
        check(err <= rel * scale, f"wkv6 {label}: {name} max abs err {err} "
              f"> {rel} * {scale}")
        errs[name] = (err, scale)
    again = kernel.wkv6_fwd(r, k, v, logw, u, s0)
    check(torch.equal(out, again[0]) and torch.equal(s_f, again[1]),
          f"wkv6 {label}: differs between launches")
    del again, want, want_s
    n_bytes = (3 * r.numel() * r.element_size() + 4 * logw.numel()
               + 4 * u.numel() + (0 if s0 is None else 4 * s0.numel())
               + 4 * out.numel() + 4 * s_f.numel())
    C = 16
    flops = (4.0 * N * N + 2.0 * (C + 1) * N + N * N / C) * B * H * T
    b_ms, b_by = _bound_ms(n_bytes, flops)
    got = {"max_abs_err": max(e for e, _ in errs.values()), "bound_ms": b_ms,
           "bound_by": b_by, "library_ms": None,
           "ms": cuda_ms(torch, lambda: kernel.wkv6_fwd(r, k, v, logw, u,
                                                        s0)),
           "plain_ms": cuda_ms(torch, lambda: ref.wkv6_fwd_ref(
               r, k, v, logw, u, s0), reps=1, rounds=3, warmup=1)}
    log(f"[8 kernels] wkv6_fwd {label}: r {tuple(r.shape)} "
        f"{str(r.dtype)[6:]} s0 {'given' if s0 is not None else 'zeros'}  "
        f"max_abs_err out {errs['out'][0]:.3e} (tol {rel:.0e} x max |plain| "
        f"{errs['out'][1]:.3e}), s_final {errs['s_final'][0]:.3e} (x "
        f"{errs['s_final'][1]:.3e})  bit-identical relaunch True  ms "
        f"{got['ms']:.4f}  plain_ms {got['plain_ms']:.4f}  library_ms null "
        f"(no single PyTorch call computes WKV6)  bound_ms {b_ms:.4f} "
        f"({b_by}; {n_bytes / 1e6:.1f} MB, {flops / 1e9:.2f} GFLOP; "
        f"{flops / got['ms'] / 1e9:.1f} TFLOP/s)")
    return got, s_f


def phase_rwkv_kernels(torch, cfg, params, tokens):
    """wkv6_fwd at the inputs a real prefill hands it at layer 0 (T 2048,
    from zeros), at a ragged T (2047), at T 1 and at T 2048 from the
    prefill's final state (non-zero), in float32, and at batch 1 with the
    first half of each head's channels (N 32). Returns the readings
    of one prefill (32 launches of layer 0's shape: ms, plain and bound
    summed), each shape's beside them."""
    r, k, v, logw, u, s0 = capture_wkv(torch, cfg, params, tokens)
    check(s0 is None, "the prefill handed wkv6 a state")
    shapes = {}
    shapes["prefill"], s_f = check_wkv(torch, "prefill layer 0", r, k, v,
                                       logw, u)
    n = SERVE_PROMPT - 1
    shapes["ragged"], _ = check_wkv(
        torch, f"layer 0, T {n}", *(t[:, :n].contiguous()
                                    for t in (r, k, v, logw)), u)
    shapes["T 1"], _ = check_wkv(
        torch, "layer 0, T 1, from the prefill's state",
        *(t[:, :1].contiguous() for t in (r, k, v, logw)), u, s_f)
    shapes["state"], _ = check_wkv(
        torch, "layer 0, from the prefill's state", r, k, v, logw, u, s_f)
    shapes["float32"], _ = check_wkv(torch, "prefill layer 0, float32",
                                     r.float(), k.float(), v.float(), logw,
                                     u)
    n = cfg.head_dim // 2
    shapes["B 1, N 32"], _ = check_wkv(
        torch, f"layer 0, batch 1, N {n}",
        *(t[:1, ..., :n].contiguous() for t in (r, k, v, logw)),
        u[:, :n].contiguous())
    one = shapes["prefill"]
    return {"wkv6_fwd": {
        **{key: cfg.num_layers * one[key]
           for key in ("ms", "plain_ms", "bound_ms")},
        "library_ms": None, "bound_by": one["bound_by"],
        "max_abs_err": max(x["max_abs_err"] for x in shapes.values()),
        "shapes": shapes}}


# ---------------------------------------------------------------------------
# phase 12: the chaos soak, then LM training on gemma3-1b at full width
# ---------------------------------------------------------------------------
def phase_soak(torch):
    """`resilience.soak` as its driver runs it (`run_all`: one fault-free
    sync reference, then each scenario against it), each scenario timed.
    Returns the launch counts of the whole soak."""
    from repro_torch.core.reorder import prepare
    from repro_torch.graphs import synthetic
    from repro_torch.resilience import faults, soak
    g = prepare(synthetic.load("tiny"), oracle=True)
    reset_launches()
    t0 = time.perf_counter()
    ref = soak.run_reference(g, device=DEVICE)
    log(f"[12 soak] {g.name}: fault-free sync reference, {soak.N_STEPS} "
        f"steps of 2-layer SAGE (hidden 16), comm_rand x LABOR, "
        f"dynamic:degree_hot cache, guard {soak.GUARD}: "
        f"{time.perf_counter() - t0:.2f} s")
    for site in faults.FAULT_SITES:
        t0 = time.perf_counter()
        res = soak.run_scenario(g, site, ref=ref, device=DEVICE)
        dt = time.perf_counter() - t0
        log(f"[12 soak] {site}: {json.dumps(res.summary())}  {dt:.2f} s")
        check(res.ok and res.fired >= 1
              and res.meter[soak.EXPECT_METER[site]] >= 1,
              f"soak {site}: {res.summary()}")
    return read_launches()


def tc_bwd_visits(B, Sq, Skv, H, D, kw):
    """The work the tensor-core backward's blocks do, from its skip
    arithmetic (`csrc/flash_attention_bwd.cu`): (64-row Q tiles the dk / dv
    kernel's 64-key tiles visit, KV tiles of BK keys the dq kernel's
    128-row blocks visit), summed over the grid."""
    causal, window, is_global, off = (kw["causal"], kw["window"],
                                      kw["is_global"], kw["q_offset"])
    p_last = off + Sq - 1
    hi = min(Skv - 1, p_last) if causal else Skv - 1
    keep_all = (0 if is_global else max(0, p_last - window + 1)) > hi
    kv = 0
    for k0 in range(0, Skv, 64):
        i_lo, i_hi = 0, Sq - 1
        if not keep_all:
            if causal:
                i_lo = max(i_lo, k0 - off)
            if not is_global:
                i_hi = min(i_hi, min(k0 + 64, Skv) - 1 + window - 1 - off)
        kv += i_hi // 64 - i_lo // 64 + 1 if i_lo <= i_hi else 0
    bk = 32 if D >= 256 else 64
    dq = 0
    for q0 in range(0, Sq, 128):
        t_lo, t_hi = 0, -(-Skv // bk)
        if not keep_all:
            first, last = off + q0, off + min(q0 + 128, Sq) - 1
            top = min(Skv - 1, last) if causal else Skv - 1
            bot = 0 if is_global else max(0, first - window + 1)
            t_lo = bot // bk
            t_hi = top // bk + 1 if bot <= top else t_lo
        dq += t_hi - t_lo
    return kv * B * H, dq * B * H


def check_flash_bwd(torch, label, q, k, v, dout, kw):
    """The training forward (with lse) and `flash_attention_bwd` at one
    shape against their plain versions; ms, plain ms, SDPA's ms and the
    bounds of both. bf16 takes the backward's tensor-core route: it is
    also held to the float32 emulation of its rounding points
    (`pds_bf16`) within 4e-3 of the largest |grad|, and the SIMT kernel
    (its parent, which bf16 at other head dims still takes) is timed on
    the same inputs in this call. Returns (fwd readings, bwd readings)."""
    import torch.nn.functional as Fn

    from repro_torch.kernels.flash_attention import kernel, ref
    B, Sq, H, D = q.shape
    Skv = k.shape[1]
    bf16 = q.dtype == torch.bfloat16
    serve = kernel.flash_attention_fwd(q, k, v, **kw)
    out, lse = kernel.flash_attention_fwd(q, k, v, return_lse=True, **kw)
    check(torch.equal(serve, out), f"flash {label}: the output differs "
          f"with the lse pointer")
    del serve
    want_lse = ref.attention_lse_ref(q, k, **kw)
    lse_err = (lse - want_lse).abs().max().item()
    check(lse_err <= 1e-4, f"flash {label}: lse max abs err {lse_err}")
    del want_lse
    kind = kernel.bwd_route(q, k, v, out, dout)
    check(kind == ("tensor_core" if bf16 else "simt"),
          f"flash {label}: the backward takes the {kind} route")
    routes = dict(kernel.BWD_ROUTES)
    got = kernel.flash_attention_bwd(q, k, v, out, lse, dout, **kw)
    check(kernel.BWD_ROUTES[kind] == routes[kind] + 1,
          f"flash {label}: backward routes {kernel.BWD_ROUTES}")
    want = ref.flash_attention_bwd_ref(q, k, v, out, lse, dout, **kw)
    emu_rel = []
    if bf16:
        emu = ref.flash_attention_bwd_ref(
            *(t.float() for t in (q, k, v, out)), lse, dout.float(),
            pds_bf16=True, **kw)
        for name, a, e in zip(("dq", "dk", "dv"), got, emu):
            err = (a.float() - e).abs().max().item()
            scale = e.abs().max().item()
            check(err <= 4e-3 * scale, f"flash {label}: {name} max abs err "
                  f"{err} > 4e-3 x {scale} against the emulation")
            emu_rel.append(err / scale)
        del emu
    errs, rel = [], []
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        scale = b.float().abs().max().item()
        err = (a.float() - b.float()).abs().max().item()
        check(bool(torch.isfinite(a).all()), f"flash {label}: {name} "
              f"non-finite")
        if bf16:
            check(err <= 2e-2 * scale, f"flash {label}: {name} max abs err "
                  f"{err} > 2e-2 x {scale}")
        else:
            check(torch.allclose(a, b, rtol=1e-4, atol=1e-4 * scale),
                  f"flash {label}: {name} max abs err {err} (max {scale})")
        errs.append(err)
        rel.append(err / scale)
    again = kernel.flash_attention_bwd(q, k, v, out, lse, dout, **kw)
    check(all(torch.equal(a, b) for a, b in zip(got, again)),
          f"flash {label}: backward differs between launches")
    del got, want, again
    mask = ref._mask(torch.arange(Sq, device=q.device) + kw["q_offset"],
                     torch.arange(Skv, device=q.device), causal=kw["causal"],
                     window=kw["window"], is_global=kw["is_global"])
    pairs = int(mask.sum())
    peak = BF16_FLOPS_PER_S if bf16 else F32_FLOPS_PER_S
    es = q.element_size()
    # the backward's least work: 5 products of length D per unmasked pair
    # (s, dp, dv, dq, dk); bytes: q, k, v, out, dout and lse read once,
    # dq, dk, dv written once
    bwd_b_ms, bwd_b_by = _bound_ms(
        (4 * q.numel() + 4 * k.numel()) * es + lse.numel() * 4,
        10.0 * D * pairs * B * H, peak)
    fwd_b_ms, fwd_b_by = _bound_ms(
        (2 * q.numel() + 2 * k.numel()) * es + lse.numel() * 4,
        4.0 * D * pairs * B * H, peak)
    qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_(True)
                  for t in (q, k, v))
    if kw["is_global"]:
        o = Fn.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                            enable_gqa=True)
    else:
        o = Fn.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask,
                                            enable_gqa=True)
    dot = dout.transpose(1, 2)

    def sdpa_fwd():
        with torch.no_grad():
            if kw["is_global"]:
                return Fn.scaled_dot_product_attention(
                    qt, kt, vt, is_causal=True, enable_gqa=True)
            return Fn.scaled_dot_product_attention(
                qt, kt, vt, attn_mask=mask, enable_gqa=True)

    def bwd():
        return kernel.flash_attention_bwd(q, k, v, out, lse, dout, **kw)

    def simt_bwd():
        return kernel._launch_bwd("simt", q, k, v, out, lse, dout, **kw)

    def plain_bwd():
        return ref.flash_attention_bwd_ref(q, k, v, out, lse, dout, **kw)

    def fwd():
        return kernel.flash_attention_fwd(q, k, v, return_lse=True, **kw)

    def plain_fwd():
        return (ref.attention_ref(q, k, v, **kw),
                ref.attention_lse_ref(q, k, **kw))

    # the parent (SIMT) and the change in turns: parent, change, parent
    simt_ms = [cuda_ms(torch, simt_bwd, reps=1, rounds=3, warmup=1)] \
        if bf16 else []
    b = {"max_abs_err": max(errs), "rel_err": max(rel), "route": kind,
         "bound_ms": bwd_b_ms, "bound_by": bwd_b_by,
         "ms": cuda_ms(torch, bwd, reps=3, rounds=3, warmup=1),
         "plain_ms": cuda_ms(torch, plain_bwd, reps=1, rounds=3, warmup=1),
         "library_ms": cuda_ms(torch, lambda: torch.autograd.grad(
             o, (qt, kt, vt), dot, retain_graph=True), reps=3, rounds=3,
             warmup=1)}
    f = {"max_abs_err": lse_err, "bound_ms": fwd_b_ms, "bound_by": fwd_b_by,
         "ms": cuda_ms(torch, fwd, reps=3, rounds=3, warmup=1),
         "plain_ms": cuda_ms(torch, plain_fwd, reps=1, rounds=3, warmup=1),
         "library_ms": cuda_ms(torch, sdpa_fwd, reps=3, rounds=3, warmup=1)}
    if bf16:
        simt_ms.append(cuda_ms(torch, simt_bwd, reps=1, rounds=3, warmup=1))
        b["simt_ms"] = min(simt_ms)
        b["emu_rel_err"] = max(emu_rel)
        # the tail: ms a block's unit of work on one SM, each kernel apart
        # (a local layer's blocks carry equal work, a global one's do not):
        # 10 calls in one profiler window, each kernel's time over the
        # launches the trace holds. Late in a long run a short window
        # misses its first launches, so it opens with a ~50 ms sleep
        # kernel; a kernel the trace does not show is "not measured"
        from torch.profiler import ProfilerActivity, profile
        calls = 10
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            torch.cuda._sleep(100_000_000)
            for _ in range(calls):
                bwd()
            torch.cuda.synchronize()
        dev = [(e.key, e.device_time_total, e.count)
               for e in prof.key_averages()]
        sms = torch.cuda.get_device_properties(0).multi_processor_count
        visits = dict(zip(("dkdv_tc_kernel", "dq_tc_kernel"),
                          tc_bwd_visits(B, Sq, Skv, H, D, kw)))
        split = []
        for name in ("delta_kernel", *visits):
            seen = sum(n for key, _, n in dev if name in key)
            if seen == 0:
                b[f"{name}_ms"] = None
                split.append(f"{name} not measured (not in the trace)")
                continue
            ms = sum(t for key, t, _ in dev if name in key) / 1e3 / seen
            b[f"{name}_ms"] = ms
            per = (f" ({visits[name]} tile visits, "
                   f"{ms * 1e3 * sms / visits[name]:.3f} us a visit on one "
                   f"of {sms} SMs)" if name in visits else "")
            split.append(f"{name} {ms:.4f} ms a launch ({seen} of {calls} in "
                         f"the trace){per}")
        log(f"[12 kernels] flash_attention_bwd {label} split: "
            f"{'; '.join(split)}")
    backend = sdpa_backend(torch, sdpa_fwd)
    tflops = 10.0 * D * pairs * B * H / b["ms"] / 1e9
    log(f"[12 kernels] flash {label}: q {tuple(q.shape)} k {tuple(k.shape)} "
        f"{str(q.dtype)[6:]} {kw}  unmasked pairs per head {pairs}  lse "
        f"max abs err {lse_err:.3e}  serving output bit-identical without "
        f"lse  fwd+lse ms {f['ms']:.4f} (plain {f['plain_ms']:.4f}, SDPA "
        f"{f['library_ms']:.4f} via {backend}, bound {fwd_b_ms:.4f} "
        f"{fwd_b_by})")
    parent = ""
    if bf16:
        parent = (f"  against the emulation {max(emu_rel):.2e} of max "
                  f"|grad| (tol 4e-3)  SIMT parent ms "
                  f"{', '.join(f'{t:.4f}' for t in simt_ms)} ("
                  f"{10.0 * D * pairs * B * H / b['simt_ms'] / 1e9:.1f} "
                  f"TFLOP/s)")
    log(f"[12 kernels] flash_attention_bwd {label}: route {kind}  dq/dk/dv "
        f"max abs err {', '.join(f'{e:.3e}' for e in errs)} "
        f"({max(rel):.2e} of max |grad|)  bit-identical relaunch True  ms "
        f"{b['ms']:.4f} ({tflops:.1f} TFLOP/s of the 5 products){parent}  "
        f"plain_ms {b['plain_ms']:.4f}  library_ms {b['library_ms']:.4f} "
        f"(SDPA backward)  bound_ms {bwd_b_ms:.4f} ({bwd_b_by})")
    del o, qt, kt, vt
    return f, b


def phase_flash_train(torch, cfg):
    """(b): both flash kernels at the training shapes, global and local
    layers, bf16 and float32; per train step sums over the layers (each
    forward launches twice under remat, each backward once)."""
    gen = torch.Generator(device=DEVICE).manual_seed(12)
    B, S, H, KH, D = (TRAIN_BATCH, TRAIN_SEQ, cfg.num_heads,
                      cfg.num_kv_heads, cfg.head_dim)
    shapes = {}
    for dtype in (torch.bfloat16, torch.float32):
        q, dout = (torch.randn((B, S, H, D), generator=gen, device=DEVICE)
                   .to(dtype) for _ in range(2))
        k, v = (torch.randn((B, S, KH, D), generator=gen, device=DEVICE)
                .to(dtype) for _ in range(2))
        for layer in ("global", "local"):
            kw = dict(causal=True, window=cfg.window,
                      is_global=layer == "global", q_offset=0)
            name = f"{layer} {str(dtype)[6:]}"
            shapes[name] = check_flash_bwd(torch, name, q, k, v, dout, kw)
        del q, k, v, dout
        torch.cuda.empty_cache()
    n_glob = sum(cfg.is_global_layer(i) for i in range(cfg.num_layers))
    n_loc = cfg.num_layers - n_glob
    out = {}
    for i, (kname, per) in enumerate((("flash_attention_fwd", 2),
                                      ("flash_attention_bwd", 1))):
        g, lo = shapes["global bfloat16"][i], shapes["local bfloat16"][i]
        out[kname] = {
            **{k: per * (n_glob * g[k] + n_loc * lo[k])
               for k in ("ms", "plain_ms", "library_ms", "bound_ms",
                         "simt_ms") if k in g},
            "max_abs_err": max(r[i]["max_abs_err"] for r in shapes.values()),
            "bound_by": "/".join(sorted({g["bound_by"], lo["bound_by"]})),
            "shapes": {n: r[i] for n, r in shapes.items()}}
    bwd = out["flash_attention_bwd"]
    log(f"[12 kernels] flash_attention_bwd per train step ({n_glob} global "
        f"+ {n_loc} local bf16 layers): ms {bwd['ms']:.2f} (SIMT parent "
        f"{bwd['simt_ms']:.2f})  SDPA backward {bwd['library_ms']:.2f}  "
        f"bound {bwd['bound_ms']:.3f}")
    return out


def phase_lm_train(torch, cfg):
    """(c): gemma3-1b at full width, 6 steps of the train step at batch 4
    x 4096, then the same 6 from a second draw of the same seed."""
    from repro_torch.configs import TrainConfig
    from repro_torch.data.pipeline import LMStream, SyntheticTokens
    from repro_torch.models.lm import transformer
    from repro_torch.optim import adamw
    from repro_torch.train.train_step import make_train_step
    corpus = SyntheticTokens(cfg.vocab_size, num_docs=4096,
                             doc_len=2 * TRAIN_SEQ)
    it = iter(LMStream(corpus, TRAIN_BATCH, TRAIN_SEQ))
    data = [{"tokens": torch.from_numpy(t).to(DEVICE),
             "labels": torch.from_numpy(lb).to(DEVICE)}
            for t, lb in (next(it) for _ in range(TRAIN_STEPS))]
    tcfg = TrainConfig(learning_rate=1e-3)
    step = make_train_step(cfg, tcfg)

    def run(timed):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params = transformer.init(
            cfg, torch.Generator(device=DEVICE).manual_seed(0),
            device=DEVICE)
        opt = adamw.init(params)
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        losses, ms = [], []
        if timed:
            torch.cuda.reset_peak_memory_stats()
            reset_launches()
        for batch in data:
            t0 = time.perf_counter()
            params, opt, m = step(params, opt, batch)
            losses.append(float(m["loss"]))
            ms.append((time.perf_counter() - t0) * 1e3)
        return params, opt, losses, ms, init_s

    params, opt, losses, ms, init_s = run(True)
    launches = read_launches()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    L = cfg.num_layers
    want = {k: 0 for k in launches}
    want.update(flash_attention_fwd=2 * L * TRAIN_STEPS,
                flash_attention_bwd=L * TRAIN_STEPS,
                gather_agg_bwd_dx=TRAIN_STEPS)
    check(launches == want, f"{TRAIN}: launches {launches} != {want}")
    from repro_torch.kernels.flash_attention import kernel as flash_kernel
    bwd_routes = dict(flash_kernel.BWD_ROUTES)
    check(bwd_routes == {"tensor_core": L * TRAIN_STEPS, "simt": 0},
          f"{TRAIN}: backward routes {bwd_routes}")
    check(all(math.isfinite(x) for x in losses), f"{TRAIN}: losses "
          f"{losses}")
    n = transformer.param_count(params)
    med = statistics.median(ms)
    log(f"[12 train] {TRAIN}: {L} layers, d_model {cfg.d_model}, heads "
        f"{cfg.num_heads} over {cfg.num_kv_heads} KV of {cfg.head_dim}, "
        f"d_ff {cfg.d_ff}, vocab {cfg.padded_vocab}, window {cfg.window}: "
        f"{n} float32 params (init {init_s:.2f} s on the card); batch "
        f"{TRAIN_BATCH} x {TRAIN_SEQ}, {cfg.dtype} compute, remat, chunked "
        f"CE, clip {tcfg.grad_clip}, AdamW lr {tcfg.learning_rate} wd "
        f"{tcfg.weight_decay}")
    log(f"[12 train] {TRAIN}: losses {losses}; step ms (host clock through "
        f"the loss's read) {[round(x, 2) for x in ms]}, median "
        f"{med:.2f} (steps 2-6: {statistics.median(ms[1:]):.2f}); "
        f"{TRAIN_BATCH * TRAIN_SEQ / med * 1e3:.0f} tokens/s; peak "
        f"{peak:.2f} GiB; launches a step: flash fwd "
        f"{launches['flash_attention_fwd'] / TRAIN_STEPS:g}, flash bwd "
        f"{launches['flash_attention_bwd'] / TRAIN_STEPS:g} (all "
        f"tensor_core), bwd_dx "
        f"{launches['gather_agg_bwd_dx'] / TRAIN_STEPS:g}, others 0")
    dev, wall_ms = profile_kernels(
        torch, lambda: step(params, opt, data[0])[2]["loss"].item())
    busy = sum(t for _, t, _ in dev) / 1e3
    log(f"[12 profile] {TRAIN}: one step, kernels {busy:.2f} ms, device "
        f"idle share {1 - busy / med:.3f} of the median step {med:.2f} ms "
        f"(profiled wall {wall_ms:.2f} ms)")
    for key, t, calls in dev[:12]:
        log(f"[12 profile] {TRAIN}: {t / 1e3:9.3f} ms  {calls:5d} calls  "
            f"{key[:100]}")
    for tag, names in (("flash bwd", (*BWD_TC, "delta_kernel")),
                       ("flash fwd", (FLASH_TC, FLASH_SIMT)),
                       ("bwd_dx", DX_KERNELS)):
        rows = [(k, t, c) for k, t, c in dev if any(x in k for x in names)]
        kinds = sorted({k.split("<")[0][-30:] for k, _, _ in rows})
        log(f"[12 profile] {TRAIN}: {tag} "
            f"{sum(t for _, t, _ in rows) / 1e3:.3f} ms in "
            f"{sum(c for _, _, c in rows)} kernels ({', '.join(kinds)})")
    groups = {"matmul": ("nvjet", "gemm", "cutlass", "sm90_xmma"),
              "flash": ("flash_fwd", *BWD_TC, "delta_kernel"),
              "elementwise and reductions": ("at::native",)}
    split = {g: sum(t for k, t, _ in dev if any(x in k for x in names))
             / 1e3 for g, names in groups.items()}
    log(f"[12 profile] {TRAIN}: by kind "
        f"{', '.join(f'{g} {t:.1f} ms' for g, t in split.items())}, other "
        f"{busy - sum(split.values()):.1f} ms")
    slow = [k for k, _, _ in dev if "indexing_backward" in k]
    check(not slow, f"{TRAIN}: PyTorch's index backward ran: {slow}")
    check(not any(FLASH_SIMT in k for k, _, _ in dev),
          f"{TRAIN}: the bf16 forward took the SIMT kernel")
    check(not any(x in k for k, _, _ in dev for x in BWD_SIMT),
          f"{TRAIN}: the bf16 backward took the SIMT kernels")
    # the backward of `gather_rows(embed, tokens)` as the step calls it:
    # fanout 1, unit weights, the tokens' own plan
    tok = data[0]["tokens"].reshape(-1, 1).to(torch.int32).contiguous()
    embed_rows = check_dx(torch, {
        "idx": tok, "w": None, "x": params["embed"],
        "g": torch.randn((tok.shape[0], cfg.d_model),
                         generator=torch.Generator(device=DEVICE)
                         .manual_seed(5), device=DEVICE),
        "plan": {"key": TRAIN, "idx": tok,
                 "n_src": params["embed"].shape[0], "heads": 1}})
    log(f"[12 kernels] gather_agg_bwd_dx (the token embedding's backward): "
        f"ms {embed_rows['ms']:.4f} plain_ms {embed_rows['plain_ms']:.4f} "
        f"library_ms {embed_rows['library_ms']:.4f} bound_ms "
        f"{embed_rows['bound_ms']:.4f} ({embed_rows['bound_by']}) "
        f"max_abs_err {embed_rows['max_abs_err']:.3e}; {embed_rows['note']}")
    del params, opt
    torch.cuda.empty_cache()
    again = run(False)[2]
    check(again == losses, f"{TRAIN}: relaunch losses {again} != {losses}")
    log(f"[12 train] {TRAIN}: a second draw from the same seed repeats the "
        f"{TRAIN_STEPS} losses bit for bit")
    torch.cuda.empty_cache()
    return launches, embed_rows


def phase_lm_small(torch):
    """(d) the reduced config in float32 on the card against the CPU;
    (e) `LMTrainer` resume on the card."""
    import shutil

    from repro_torch.configs import LM_CONFIGS, TrainConfig
    from repro_torch.data.pipeline import LMStream, SyntheticTokens
    from repro_torch.models.lm import transformer
    from repro_torch.optim import adamw
    from repro_torch.train.lm_loop import LMTrainer
    from repro_torch.train.train_step import make_train_step
    cfg = LM_CONFIGS["gemma3-1b"].reduced()
    f32 = cfg.scaled(dtype="float32")
    it = iter(LMStream(SyntheticTokens(cfg.vocab_size, 256, 128), 8, 64))
    data = [next(it) for _ in range(5)]
    step = make_train_step(f32, TrainConfig(learning_rate=1e-3))
    params = transformer.init(f32, torch.Generator().manual_seed(0),
                              device="cpu")
    losses = {}
    for dev in ("cpu", DEVICE):
        p = adamw.tree_map(lambda t: t.to(dev), params)
        opt = adamw.init(p)
        losses[dev] = []
        for toks, labels in data:
            p, opt, m = step(p, opt, {"tokens": torch.from_numpy(toks).to(dev),
                                      "labels": torch.from_numpy(labels)
                                      .to(dev)})
            losses[dev].append(float(m["loss"]))
    worst = max(abs(a - b) / abs(b) for a, b in zip(losses[DEVICE],
                                                   losses["cpu"]))
    check(worst <= 1e-4, f"reduced card vs cpu: {losses}")
    log(f"[12 card vs cpu] {f32.name} float32, 5 steps: card {losses[DEVICE]}"
        f" cpu {losses['cpu']}, max rel diff {worst:.2e} (tol 1e-4)")

    d = ROOT / "build" / "phase12"
    shutil.rmtree(d, ignore_errors=True)

    def trainer(ckpt):
        return LMTrainer(cfg, TrainConfig(learning_rate=1e-3), LMStream(
            SyntheticTokens(cfg.vocab_size, 256, 128), 8, 64),
            ckpt_dir=ckpt, ckpt_every=3, device=DEVICE)

    full = trainer(None).run(9)["losses"]
    a = trainer(str(d))
    first = a.run(6)["losses"]
    del a
    b = trainer(str(d))
    check(b.step == 6, f"LMTrainer resumed at {b.step}, not 6")
    rest = b.run(3)["losses"]
    check(first + rest == full, f"LMTrainer resume: {first + rest} != "
          f"{full}")
    shutil.rmtree(d, ignore_errors=True)
    log(f"[12 resume] LMTrainer {cfg.name} ({cfg.dtype}) on the card: 6 "
        f"steps (checkpoints at 3 and 6), a new trainer resumed at step 6 "
        f"and ran 3 more: the 9 losses equal an uninterrupted run's bit for "
        f"bit {full}")


def phase_lm(torch, runs, readings):
    """Phase 12."""
    from repro_torch.configs import LM_CONFIGS
    t0 = time.perf_counter()
    runs["chaos_soak"] = phase_soak(torch)
    t1 = time.perf_counter()
    cfg = LM_CONFIGS["gemma3-1b"]
    readings[TRAIN] = phase_flash_train(torch, cfg)
    t2 = time.perf_counter()
    runs[TRAIN], readings[TRAIN]["gather_agg_bwd_dx"] = \
        phase_lm_train(torch, cfg)
    t3 = time.perf_counter()
    phase_lm_small(torch)
    log(f"[12 done] soak {t1 - t0:.1f} s, flash kernels {t2 - t1:.1f} s, "
        f"full-width training {t3 - t2:.1f} s, reduced card vs cpu and "
        f"resume {time.perf_counter() - t3:.1f} s; phase "
        f"{time.perf_counter() - t0:.1f} s")


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: PyTorch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    try:
        import repro_torch  # noqa: F401
    except ImportError:
        print("chip_smoke: run it from a checkout of the repository "
              "(src/repro_torch not found)", file=sys.stderr)
        return 2
    t_start = time.perf_counter()
    kind = phase_device(torch)
    phase_build()

    from repro_torch import featcache
    from repro_torch.batching import make_policy
    from repro_torch.configs import CONFIGS, TrainConfig
    from repro_torch.core.reorder import prepare
    from repro_torch.graphs import synthetic
    from repro_torch.train.gnn_loop import GNNTrainer
    t0 = time.perf_counter()
    graph = prepare(synthetic.generate(reddit_spec()), oracle=True)
    t1 = time.perf_counter()
    policy = make_policy("comm_rand", mix=0.125, p=1.0)
    trainer = GNNTrainer(graph, CONFIGS["graphsage"], TrainConfig(), policy,
                         seed=0, device=DEVICE)
    log(f"[setup] {graph.name}: {graph.num_nodes} nodes, {graph.num_edges} "
        f"edges, feats {graph.features.shape}  generate+prepare "
        f"{t1 - t0:.1f} s  trainer (caps, upload) "
        f"{time.perf_counter() - t1:.1f} s  caps {trainer.caps}  eval caps "
        f"{trainer.eval_caps}")
    # the cache plan of the cached run, built on the host and kept there
    # until that run, so that no other run's peak memory holds it
    t0 = time.perf_counter()
    plan = featcache.build_plan(
        graph, "presampled_freq", frac=CACHE_FRAC, policy=policy,
        batch_size=trainer.tcfg.batch_size, fanouts=trainer.fanouts, seed=0,
        device="cpu")
    log(f"[setup] cache plan {plan.describe()} ({plan.capacity} of "
        f"{graph.num_nodes} rows, {plan.cache.numel() * 4 / 1e6:.1f} MB): "
        f"{time.perf_counter() - t0:.1f} s on the host")

    batch = typical_batch(trainer)
    readings = {
        "graphsage": phase_kernels(torch, "graphsage",
                                   main_path_layers(torch, trainer, batch)),
        "graphsage_cached": phase_kernels(
            torch, "graphsage_cached",
            [cached_layer(torch, trainer, batch, plan.to(DEVICE))],
            CACHED_CHECKS),
        "gat": phase_kernels(torch, "gat", gat_layers(torch, trainer, batch,
                                                      CONFIGS["gat"]))}
    del batch
    # the other runs reuse GraphSAGE's caps: same policy, sampler, batches
    caps, eval_caps = trainer.caps, trainer.eval_caps
    runs, losses, step_ms = {}, {}, {}
    for name, (config, _, _, _, cached) in RUNS.items():
        if trainer is None:
            trainer = GNNTrainer(graph, CONFIGS[config], TrainConfig(),
                                 policy, caps=caps, eval_caps=eval_caps,
                                 seed=0, device=DEVICE,
                                 cache=plan.to(DEVICE) if cached else None)
        runs[name], step_ms[name], losses[name] = phase_train(
            torch, graph, trainer, name,
            (losses.get("graphsage"), step_ms.get("graphsage")))
        phase_profile(torch, trainer, name,
                      statistics.median(step_ms[name]))
        trainer = None                   # each run's peak memory alone
        if name == "gat":
            torch.cuda.empty_cache()
            phase_relaunch(lambda: GNNTrainer(
                graph, CONFIGS[config], TrainConfig(), policy, caps=caps,
                eval_caps=eval_caps, seed=0, device=DEVICE), losses[name],
                name)
        torch.cuda.empty_cache()
    phase_paired(torch, lambda cache: GNNTrainer(
        graph, CONFIGS["graphsage"], TrainConfig(), policy, caps=caps,
        eval_caps=eval_caps, seed=0, device=DEVICE,
        cache=None if cache is None else cache.to(DEVICE)), plan)
    tiny = prepare(synthetic.load("tiny"), oracle=True)
    for model, cache in (("sage", None), ("sage", "presampled_freq"),
                         ("gat", None)):
        phase_card_vs_cpu(torch, tiny, model, cache)
    runs[DYN], readings[DYN] = phase_dynamic(torch, graph, policy, plan,
                                             caps, eval_caps)
    phase_card_to_cpu(torch, tiny)
    runs.update(phase_async(torch, graph, policy, plan, caps, eval_caps))
    prior_runs, readings[FULLBATCH] = phase_prior_work(torch, graph, caps,
                                                       eval_caps)
    runs.update(prior_runs)
    runs.update(phase_gate(torch, graph, policy, plan, caps, eval_caps))

    del graph, tiny, plan
    torch.cuda.empty_cache()
    cfg, params, tokens = serve_model(torch, "gemma3-1b", "6")
    readings[SERVE] = phase_flash(torch, cfg, params, tokens)
    runs[SERVE], res = phase_serve(
        torch, cfg, params, tokens, SERVE, "6",
        {"flash_attention_fwd": cfg.num_layers}, {})
    phase_serve_profile(torch, cfg, params, tokens, res, SERVE, "6",
                        {"flash": FLASH_TC}, absent=(FLASH_SIMT,))
    del params
    torch.cuda.empty_cache()
    phase_serve_card_vs_cpu(torch, "gemma3-1b", "6")
    phase_bf16_card_vs_cpu(torch, "gemma3-1b", "6")

    cfg, params, tokens = serve_model(torch, MOE, "7")
    readings.update(phase_moe_kernels(torch, cfg, params, tokens))
    from repro_torch.kernels.moe_gmm import kernel as gmm_kernel
    runs[MOE_SERVE], res = phase_serve(
        torch, cfg, params, tokens, MOE_SERVE, "7",
        {"flash_attention_fwd": cfg.num_layers,
         "moe_gmm_fwd": 2 * cfg.num_layers},
        {"moe_gmm_fwd": 2 * cfg.num_layers},
        (gmm_kernel, {"tensor_core": 2 * cfg.num_layers},
         {"mma_sync": 2 * cfg.num_layers}))
    phase_serve_profile(torch, cfg, params, tokens, res, MOE_SERVE, "7",
                        {"flash": FLASH_TC, "moe_gmm": GMM_TC},
                        {"moe_gmm": GMM_MMA},
                        absent=(FLASH_SIMT, GMM_SIMT),
                        prefill_absent=(GMM_MMA,), step_absent=(GMM_TC,))
    del params
    torch.cuda.empty_cache()
    phase_serve_card_vs_cpu(torch, MOE, "7")
    phase_bf16_card_vs_cpu(torch, MOE, "7")

    cfg, params, tokens = serve_model(torch, RWKV, "8")
    readings[RWKV_SERVE] = phase_rwkv_kernels(torch, cfg, params, tokens)
    runs[RWKV_SERVE], res = phase_serve(
        torch, cfg, params, tokens, RWKV_SERVE, "8",
        {"wkv6_fwd": cfg.num_layers}, {})
    phase_serve_profile(torch, cfg, params, tokens, res, RWKV_SERVE, "8",
                        {"wkv6": "wkv6_chunk_kernel"})
    del params
    torch.cuda.empty_cache()
    phase_serve_card_vs_cpu(torch, RWKV, "8")
    phase_lm(torch, runs, readings)

    kernels = []
    for name in REPLACES:
        by_path = {p: r[name] for p, r in readings.items() if name in r}
        top = next(iter(by_path))  # the first run whose readings it has
        kernels.append({
            "name": name, "route": "cuda", "source": SOURCES[name],
            "replaces": REPLACES[name],
            "launches": sum(r[name] for r in runs.values()),
            "launches_by_path": {p: r[name] for p, r in runs.items()},
            "ok": True, "deterministic": True,
            **{k: by_path[top][k] for k in ("ms", "plain_ms", "bound_ms",
                                            "bound_by", "library_ms")},
            "max_abs_err": max(r["max_abs_err"] for r in by_path.values()),
            "shapes": f"ms, plain_ms, bound_ms, library_ms: sum over the "
                      f"launches of one {top} {PER[top]}; max_abs_err: the "
                      f"largest at every shape checked",
            "readings_by_path": by_path})
    log(f"[done] {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
