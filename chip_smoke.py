#!/usr/bin/env python3
"""Smoke run of the PyTorch/H100 port (``horovod_tpu_torch``) on one card,
and of its Adasum, hierarchical, collective, context-parallel,
expert-parallel, model-parallel (Llama, Mixtral, BERT) and pipeline paths
across up to four cards where the machine has them.

    python3 chip_smoke.py

Phases, one line each; any failure raises and the script exits nonzero.
They run in this order: 1 and 2; the one-card phases (5-12, 14, 16) on
card 0; then the multi-card phases (3, 4, 13, 15, 17-20), each printing its
seconds, and the whole script's. On four cards or more, the 2-rank worlds
of phases 18 and 19 run on cards 2 and 3 beside the one-card phases
(``LANE_PHASES``), and phases 13, 15 and 17 start their 4-rank world alone:
it splits every axis their 2-rank world splits (``FOUR_ALONE``).

1. device  — requires CUDA; prints the card's name and power limit as
   ``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`` gives
   them.
2. build   — builds ``horovod_tpu_torch/ops/csrc/*.cu`` with nvcc for sm_90a
   into ``horovod_tpu_torch/_build/``, prints what ``-Xptxas -v`` says of
   each kernel, and requires no ptxas warning, no C75xx note (wgmma
   serialized) and 0 spill bytes in the tensor-core kernels.
3. adasum  — the Adasum path, ``DistributedOptimizer(AdamW, op=Adasum)``,
   needs two ranks: Adasum in a world of one is identity, so on one card
   the phase prints that and runs nothing. With 2 or more cards it starts
   a world of n ranks over NCCL (n the largest power of 2 at most
   min(4, cards), one card each, the port's ``HOROVOD_*`` environment) and
   trains the model of phase 7 for 3 steps, a different batch per rank.
   It requires log2(n) launches of B4 and of B5 per rank per step, finite
   losses, parameters bit-identical across the ranks, and rank 0's first
   combined gradient within tolerance of the plain butterfly of the
   gathered local gradients. Prints the step time and the third step's
   device time by kernel group.
4. collectives — the hierarchical all-reduce and the rest of the
   collective surface; like phase 3 it needs two ranks, prints that on one
   card and runs nothing, and otherwise starts its own NCCL world of n
   ranks, declared 2 cross x n/2
   intra (``HOROVOD_LOCAL_SIZE``: 2 x 2 on 4 cards, 2 x 1 on 2) with
   ``HOROVOD_HIERARCHICAL_ALLREDUCE=1``.
   (a) ``DistributedOptimizer(AdamW)`` on the model of phase 7, a
   different batch per rank, 3 steps: finite losses, parameters
   bit-identical across ranks, B1-B3 at least once a layer a step, one
   intra-node reduce-scatter, one cross-node all-reduce and one intra-node
   all-gather per bucket per step (and one each for the loss), and the
   first step's reduced gradient per element within 2^-21 sum_i |g_i| / n
   of a flat ``dist.all_reduce`` of the same local gradients (each side
   sums n <= 4 terms with n - 1 roundings of 2^-24 of the summed
   magnitudes; dividing by 2 or 4 is exact). Then 12 steps in turns, flat
   and hierarchical, for the step time and tokens/s/GPU of each.
   (b) ``hierarchical_adasum`` of each rank's flat f32 gradient
   (1,486,901,248 elements): log2(cross) launches of B4 and of B5 a rank,
   and rank 0's result within 1e-5 (|ref| + RMS(ref)) of the sum within
   each node combined by the plain butterfly, shard by shard (the JAX
   function's coefficients are per intra shard); then timed in a second
   call.
   (c) The surface at realistic sizes, each against a plain construction
   and then timed, with nccl-tests' algorithm and bus bandwidths:
   ``reducescatter`` of that gradient (within 2^-21 sum_i |x_i| of a flat
   all-reduce's slice) and ``allgather`` of its shards (bit-exact against
   broadcasts from each rank), the flat and the hierarchical all-reduce of
   it; ``alltoall`` of Mixtral-8x7B's dispatch buffer, [8, 1280, 4096] bf16
   a rank (bit-exact against point-to-point sends); ``grouped_broadcast``
   of a parameter list of the model's shapes (bit-exact against the root's
   seeded list); ``allgather_v`` and ``alltoall_v`` with uneven sizes
   (bit-exact); ``join_allreduce`` with the last rank out of data; and
   ``broadcast_object`` and ``allgather_object`` of a nested dict.
5. kernels — each flash-attention kernel (B1 forward, B2 dQ, B3 dK/dV)
   against its plain PyTorch version on the same inputs: at the training
   shape (B=2, T=2048, H=32, D=128, causal) in bf16 (the tensor-core
   kernels) and again in f32 (the CUDA-core kernels), at a small f32
   non-causal case with a key-padding bias and a ragged T=1000 (D=64), and
   at a small bf16 non-causal case (D=64, Tq=100, Tk=300, a key-padding
   bias, one batch row that sees no key: its l and o must be exactly 0).
   Times each kernel at the bf16 training shape beside its bound, its
   achieved TFLOP/s and share of the bound, its plain version and
   ``F.scaled_dot_product_attention`` (the yardstick; the port never calls
   it).
6. model   — a small f32 Llama (head dim 64) on the card: logits and
   gradients with flash on (the kernels) agree with flash off.
7. train   — the main path: ``init()`` (an NCCL world of one), the
   Llama-3-8B-width model cut to 2 layers, ``create_train_state`` (parameter
   broadcast), ``DistributedOptimizer(AdamW)`` for 4 steps at batch 2 x 2048
   tokens, the last under ``torch.profiler``. Requires finite, falling
   losses, each kernel launched at least twice (once per layer) per step,
   and one all-reduce launched per fusion bucket per step (counted where
   ``allreduce_async_`` hands it to ``torch.distributed``). Prints the step
   time and tokens/s, and the profiled step's device time by kernel group.
8. adasum-kernels — the Adasum kernels (B4 the three sums, B5 the combine)
   against their plain PyTorch versions. Main-path case: the flat f32
   gradients (1,486,901,248 elements each, in ``DistributedOptimizer``
   order) of the same model on two seeded batches, the pair two ranks
   exchange at the butterfly's first level. Edge cases: n = 65,536 and
   1,000,003, a = 0 (the combine is b), a = b (it is a), orthogonal vectors
   (it is a + b), and misaligned slices. Times both at the main-path shape
   beside their bounds, their plain versions and their yardsticks (three
   ``torch.dot`` calls for B4, ``torch.add(a.mul(ca), b, alpha=cb)`` for
   B5; the port calls neither).
9. resnet  — the ResNet path, as ``bench.py`` runs it: ``init()`` (an NCCL
   world of one), ``ResNet50(stem="space_to_depth")`` with SyncBatchNorm,
   bf16 compute and f32 parameters, channels_last,
   ``DistributedOptimizer(SGD(lr 0.1, momentum 0.9))``, a seeded synthetic
   batch of 128 x 224 x 224 x 3 images and 1000-class labels, 4 steps, the
   last under ``torch.profiler``. Requires finite losses, one all-reduce per
   fusion bucket per step, and BatchNorm running statistics that moved and
   are finite. Prints images/s/GPU, the step time, peak memory and the
   profiled step's device time by kernel group.
10. bert    — the BERT path: ``bert_large()`` at full depth (24 layers), 8 x
   512 tokens with a key-padding mask whose rows hold 512, 480, ..., 288
   real tokens, pads labelled -1 and 15 % of the real positions MLM labels
   (``benchmarks/bert.py``), ``DistributedOptimizer(AdamW(1e-4),
   compression=Compression.bf16)``, flash attention by the automatic rule;
   4 steps, the last profiled. Requires finite, falling losses, B1, B2 and
   B3 each launched 24 times a step, and one all-reduce per bucket per
   step. Prints tokens/s/GPU, the step time, peak memory and the breakdown.
11. bert-kernels — B1, B2 and B3 against their plain versions at BERT's
   shape (B=8, T=512, H=16, D=64, not causal, the key-padding bias of phase
   10), in bf16 and again in f32, at the tolerances below; times each beside
   its bound, its plain version and ``F.scaled_dot_product_attention`` with
   the same additive mask, and names the SDPA back end that mask selects.
   Then the same at H=8, the heads a rank holds at tp 2 (phase 20).
12. crossover — one BERT-Large layer's attention (B=8, H=16, D=64, bf16, a
   ragged mask), forward and backward, through the flash kernels and through
   the materialised softmax of ``models/bert.py``, at T = 128, 256, 512 and
   1024: the shortest T from which flash is faster (``models/_flash.py``'s
   ``AUTO_MIN_SEQ``).
13. context — context-parallel training (``attention_impl`` "ring" and
   "ulysses", ``make_gspmd_train_step``); like phase 4 it needs two
   ranks: on one card it prints that and runs nothing. On 2 cards it
   starts an NCCL world of 2, on 4 one of 4, and trains the
   Llama-3-8B-width model cut to 2 layers, at its full T = 8192 tokens a
   sequence, on ``{"sp": n}`` and, on 4 cards, ``{"dp": 2, "sp": 2}``: one
   sequence a dp row, remat "dots" (the default), AdamW, 4 steps, the last
   under ``torch.profiler`` on the last rank (the slowest). Rank 0
   first runs the dense model (no mesh, B1-B3 over the whole sequence) on
   the same global batch and weights. Requires B1 launched 2 (r + 1) times
   a layer a step on the rank at sp index r under the ring (its forward,
   then its recompute) and never under Ulysses, B2 and B3 never (the
   ring's residual backward is the plain recompute, as in JAX), finite
   losses, parameters bit-identical on every rank, the first loss within
   1e-3 relative of the dense model's and each reduced gradient of the
   first step within 2^-4 normwise (||g - ref|| / ||ref||) of the dense
   model's. Both models compute in bf16, and the two attentions round
   differently (the ring merges f32 partials of bf16 outputs, Ulysses
   casts a materialised f32 softmax to bf16); their differences pass
   through the rest of the model, so the gradients are held normwise
   (the element-wise ratio is printed beside it). Losing the K/V
   cotangents of the other ranks' queries would put half the attention
   weights' gradient off, about 0.5 normwise. Prints the step time,
   tokens/s/GPU and the peak memory.
14. longctx — remat on one card: the same model, 1 x 8192 tokens, AdamW,
   4 steps under each arm of ``with_remat_policy`` (none, dots, dots_attn,
   attn, full), each from the same weights, the last profiled. Requires per step B1 launched
   twice a layer under dots and full (forward and recompute) and once
   under the others, B2 and B3 once a layer; each arm's gradients on the
   same batch within 2^-7 (|ref| + RMS(ref)) per element, one bf16 ulp, of
   the none arm's (the recompute repeats the same products; the
   embedding's scatter-add is not ordered); and peak memory
   (``max_memory_allocated`` over the arm's steps) with none >= dots_attn
   >= dots > full. Then B1, B2 and B3 at the phase's shape (B=1, T=8192,
   H=32, D=128, causal, bf16) and B1 at the ring's shapes (T_local 4096 and
   2048, causal and not) against their plain versions (8 heads at a time)
   at the tolerances below, each timed beside its bound, its plain version
   and ``F.scaled_dot_product_attention``.

15. mixtral-ep — expert-parallel Mixtral training; it needs two ranks: on
   one card it prints that and runs nothing. On 2 cards it starts an NCCL
   world of 2 (``{"ep": 2}``), on 4 one of 4 (``{"ep": 4}``, ``{"dp": 2,
   "ep": 2}``). The model is
   ``mixtral_8x7b()`` cut to 2 layers (vocab 32000, dim 4096, 32 / 8 heads
   of 128, hidden 14336, 8 experts top-2, rope theta 1e6), remat "dots",
   each rank with its own 2 x 2048 tokens, AdamW(1e-4) through
   ``make_gspmd_train_step(aux_weight=0.02)`` with the groups of
   ``mesh_param_groups``, 4 steps, the last profiled on the last rank.
   Each rank first runs the whole model (all 8 experts, no mesh, from the
   same seed) on every rank's shard in turn and averages the losses and
   gradients: the reference. Requires B1/B2/B3 launched 4/2/2 a step (B1's
   forward and its recompute), finite losses, dense parameters
   bit-identical on every rank and each expert slice across its replica
   set (the ranks with its ep index), the first loss within 1e-3 relative
   of the reference, and each rank's first reduced gradients (dense, and
   its own experts') within 2^-4 normwise of the reference's: both compute
   in bf16, and the batched expert products change shape with ep. Prints
   the step time, tokens/s/GPU, peak memory, the all-to-alls a step and
   their bytes, and the profiled step's device time.
16. mixtral — the same model on one card, an NCCL world of one: block 0's
   routing, dispatch, experts and combine at the main path's shapes with
   two backward passes, whose plan and dispatch and combine gradients must
   be bit-identical; then 4 steps of exact AdamW(1e-4) with aux weight
   0.02 (the last profiled): finite, falling losses and B1/B2/B3 4/2/2 a
   step; then, from the same weights, 8 steps of ``deferred_pair(1e-4,
   every=4)`` through ``make_gspmd_deferred_train_step``: on each skip
   step no expert bank has a ``.grad``, and the banks and their moments
   are bit-identical across each window's skip steps (held against a
   host copy); each apply step changes them. Prints tokens/s/GPU, the
   step time (skip and apply apart), peak memory, the entries each expert
   kept and the dropped share, and the device time by kernel group and by
   op of the MoE layers alone (the expert ``bmm`` s, routing and gathers,
   the exchange: ``moe_op_events``).

17. model-parallel — fsdp and tp (``parallel/sharding.py``); it needs two
   ranks: on one card it prints that and runs nothing. On 2 cards it
   starts an NCCL world of 2, on 4 one of 4.
   (a) Parity at 2 layers of the Llama-3-8B widths, remat dots, 2 x 2048
   tokens a data shard, AdamW(1e-4), one step on each mesh: ``{"fsdp": 2}``
   and ``{"tp": 2}`` on 2 cards; ``{"fsdp": 4}``, ``{"dp": 2, "tp": 2}``,
   ``{"fsdp": 2, "tp": 2}`` and ``{"tp": 4}`` on 4. Each rank first runs
   the whole model (no mesh, the same seed, whose values the sharded model
   holds block by block) over the same global batch, one data shard at a
   time, on its own card, and keeps its block of each gradient. Requires
   the first loss within 1e-3 relative of the whole model's, each gathered
   gradient (its blocks' squared errors and norms summed over the world,
   each block counted once) within 2^-5 normwise, every block
   bit-identical on the ranks that hold it, and per step the collectives
   and B1-B3 launches that ``mp_expected`` derives from the code.
   (b) ``llama3_8b()`` at its full 32 layers on 4 cards, on ``{"fsdp": 4}``
   and ``{"fsdp": 2, "tp": 2}``, 4 steps of 2 x 2048 tokens a data shard,
   the last profiled on rank 0: finite, falling losses, the expected
   collectives and B1/B2/B3 64/32/32 a step, blocks bit-identical; prints
   the step time, tokens/s/GPU, MFU against 989 TFLOP/s with the FLOPs of
   ``model_flops``, the worst rank's peak memory and the device time by
   group, NCCL apart.
18. pipeline — ``make_pipeline_train_step`` over ``{"pp": n}`` (2, and 4
   on 4 cards), each stage one block of the Llama-3-8B widths in bf16 with
   remat off, M = 8 microbatches of [1, 2048, 4096] and their targets, a
   mean-squared loss, AdamW(1e-4), 3 steps of GPipe and of 1F1B, and on 4
   cards GPipe on ``{"dp": 2, "pp": 2}``; like phase 17 it needs two
   ranks. Rank 0 composes every stage in sequence on its card over the
   same microbatches (every dp shard's): the first loss within 1e-3
   relative and each stage's gradient (gathered to rank 0) within 2^-5
   normwise. Requires per step B1 once a microbatch (GPipe, and 1F1B's last
   stage) or twice (1F1B's other stages: its forward and its recompute),
   B2 and B3 once. Prints the step time and the measured bubble, 1 - M t /
   step with t one microbatch's stage forward and backward (1F1B: plus
   its forward), against (n - 1) / (M + n - 1) for GPipe and 2 (n - 1) /
   (M + 2 (n - 1)) for 1F1B. On ``{"pp": 2}`` it then runs ``pair=``:
   ``deferred_pair(1e-4, every=2)`` naming each stage's MLP, 4 steps of
   GPipe and of 1F1B, whose skip steps must leave the MLP bit-unchanged
   and without a gradient and whose apply steps must move it, at the same
   B1-B3 launches. Phases 17 to 20 print their seconds.
19. mixtral-mp — Mixtral on fsdp, ep and tp (``models/mixtral.py``: each
   rank holds ``[E/ep, D/fsdp, M/tp]`` of each bank); like phase 17 it
   needs two ranks. (a) Parity at 2 layers of the Mixtral-8x7B widths in
   bf16 with no drops (capacity factor E / top_k) and no aux loss, remat
   dots, one AdamW(1e-4) step on ``{"fsdp": 2}`` and ``{"tp": 2}`` (a
   world of 2) and ``{"fsdp": 2, "ep": 2}`` and ``{"ep": 2, "tp": 2}`` (a
   world of 4), against the whole model on each rank's card over the
   global batch, with phase 17's gates, the collectives and B1-B3 that
   ``mixtral_mp_expected`` derives, and the tp ranks of each row routing
   alike (``router_load``). The fsdp and ep cells route by their own
   router; the tp cells replay the whole model's plan (``routing_plan``:
   the tp partial sums round the router's input apart from the whole
   model's, which flips near-tied choices). Each cell prints how many of
   its token routings (tokens x layers, every data shard) its own router
   chose apart from the whole model's. (b) On 4
   cards, ``mixtral_8x7b()`` at 6 of its 32 layers (full depth does not
   fit 4 cards), 2 x 2048 tokens a data shard, aux weight 0.02, 4 steps of
   ``moe_adamw("adamw")`` on ``{"fsdp": 2, "ep": 2}`` and on ``{"ep": 2,
   "tp": 2}`` (the last profiled on rank 0), then 4 of
   ``make_gspmd_deferred_train_step(deferred_pair(every=2))`` on
   ``{"fsdp": 2, "ep": 2}``: finite losses (falling in the first two),
   the expected collectives every step (the skip steps post no bank
   reduce-scatter), blocks bit-identical on their holders, skip steps
   leaving the banks bit-unchanged without a gradient and apply steps
   moving them. Prints the step time, tokens/s/GPU, MFU by active
   parameters (``mixtral_active_flops``: top-2 of 8 experts), the worst
   rank's peak memory and the profiled step's device time by group.
20. bert-mp — BERT on dp, fsdp and tp (``models/bert.py``,
   ``train.losses.mlm_loss_sums``); like phase 17 it needs two ranks. On
   ``{"dp": 2, "tp": 2}`` and ``{"fsdp": 4}`` (4 cards; ``{"tp": 2}`` and
   ``{"fsdp": 2}`` on 2), 8 x 512 tokens a data shard with 15 % masked,
   remat off, AdamW(1e-4): parity at 2 layers against the whole model over
   the global batch and its global masked count (phase 17's gates; the key
   projection's bias, whose gradient is 0 in exact arithmetic, reported
   apart), then BERT-Large at its 24 layers for 4 steps, the last
   profiled, with the collectives of ``bert_mp_expected`` and B1-B3 once a
   layer a step on the ``16 / tp`` local heads. Prints the same rates.

After phase 5, B1, B2 and B3 are also held and timed at the tp-local head
counts of the main shape (16 heads at tp 2, 8 at tp 4: ``tp-kernels``).

Then one ``{"kernels": [...]}`` JSON line, the ``nvidia-smi`` line again, and
last ``{"ok": true, "device": {...}}``. A kernel's ``launches`` are those of
its main path alone: phase 7's run for B1-B3, phase 3's for B4 and B5 (0 on
one card). ``launches_by_path`` gives each path's own count beside it, each
read from a run whose counts were set to 0 just before it: ``train`` (phase
7), ``bert`` (phase 10), ``adasum`` (phase 3), ``collectives`` (phase 4,
its three checked steps for B1-B3 and its ``hierarchical_adasum`` call for
B4 and B5), ``longctx`` (phase 14, every arm's steps), ``context``
(phase 13, rank 0's checked steps), ``mixtral`` (phase 16, its exact-AdamW
steps), ``mixtral-ep`` (phase 15, rank 0's steps), ``model-parallel``
(phase 17, rank 0's parity steps at 2 layers), ``pipeline`` (phase 18,
rank 0's steps before ``pair=``), ``mixtral-mp`` (phase 19, rank 0's
second step on ``{"fsdp": 2, "ep": 2}`` at 6 layers; on 2 cards its parity
steps) and ``bert-mp`` (phase 20, rank 0's second step of its first
24-layer run).

Tolerances are per element: ``|kernel - plain| <= r * (|plain| + RMS)``,
with RMS that of the compared plain tensor. Both sides sum in f32, in
different orders, and round once to the output type.

- bf16 outputs, r = 2^-7: two roundings of nearly equal f32 values land at
  most one bf16 ulp apart, and one ulp is at most 2^-7 of the element's
  magnitude. The RMS term covers elements near zero, where the f32
  summation-order difference (about 1e-6 of the summed magnitudes) can
  exceed the rounding step.
- f32 outputs and the f32 statistics m and l, r = 5e-5: f32 summation-order
  differences over at most 2048 terms are near 1e-6 of the summed
  magnitudes; 5e-5 leaves a margin of more than ten.

The bf16 B1, B2 and B3 feed P and dS to their second products as bf16 hi
+ lo pairs, about 16 bits, so their sums stay within about 2^-16 of the f32
ones and the two bounds above hold for them too.

The Adasum kernels:

- B4's three sums within 1e-6 of the sums of their terms' magnitudes
  (sum |a_i b_i|, sum a_i^2, sum b_i^2). Both sides sum in f64 in different
  orders and round once to f32, so they differ by at most about one f32
  rounding (6e-8 of the magnitude). Its coefficients within 1e-5 relative.
- B5, given the same coefficients, per element within 2^-22 (|ca a| + |cb
  b|): both sides round ca a, cb b and their sum once each, so expect 0.
- The Adasum path's combined gradient within 1e-5 (|ref| + RMS(ref)) of the
  plain butterfly: the two differ only in the order of the f64 sums, which
  can move a coefficient by one f32 rounding.
"""

import contextlib
import dataclasses
import gc
import json
import math
import os
import socket
import subprocess
import sys
import tempfile
import time

H100_BF16_FLOPS = 989e12   # dense bf16 tensor-core peak, SXM, 700 W
H100_F32_FLOPS = 67e12     # f32 outside the tensor cores
H100_BYTES_PER_S = 3.35e12
T_START = time.perf_counter()
FA_SOURCE = "horovod_tpu_torch/ops/csrc/flash_attention.cu"
#: The bf16 B1, B2 and B3, which the main path runs, on the tensor cores.
SM90_SOURCE = "horovod_tpu_torch/ops/csrc/flash_attention_sm90.cuh"
FUSED_SOURCE = "horovod_tpu_torch/ops/csrc/fused.cu"
SOURCES = {"fa_fwd": SM90_SOURCE, "fa_bwd_dq": SM90_SOURCE,
           "fa_bwd_dkv": SM90_SOURCE, "norms_dot": FUSED_SOURCE,
           "combine": FUSED_SOURCE}
REPLACES = {"fa_fwd": "horovod_tpu/ops/flash_attention.py:57",
            "fa_bwd_dq": "horovod_tpu/ops/flash_attention.py:323",
            "fa_bwd_dkv": "horovod_tpu/ops/flash_attention.py:357",
            "norms_dot": "horovod_tpu/ops/fused.py:45",
            "combine": "horovod_tpu/ops/fused.py:101"}
#: Products each kernel does per visible (q, k) pair and head dim, 2 FLOP each.
PRODUCTS = {"fa_fwd": 2, "fa_bwd_dq": 3, "fa_bwd_dkv": 4}


def log(phase, msg):
    print(f"[{phase}] {msg}", flush=True)


#: ptxas lines worth printing; C75xx notes that wgmma was serialized.
PTXAS_LINES = ("registers", "spill", "Compiling", "arning", "C75")


def check_ptxas(build_log):
    """Fail if ptxas spilled in a tensor-core kernel, warned, or serialized
    a wgmma (its C75xx notes); an empty log (the library was already built)
    has nothing to check."""
    kernel = None
    for line in build_log.splitlines():
        if "Compiling entry function" in line:
            kernel = line.split("'")[1]
        elif "arning" in line or "C75" in line:
            raise AssertionError(f"ptxas: {line.strip()}")
        elif (kernel and "sm90" in kernel and "spill" in line and
              "0 bytes spill stores, 0 bytes spill loads" not in line):
            raise AssertionError(f"ptxas on {kernel}: {line.strip()}")


def smi_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def time_ms(fn, iters=5):
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def fa_flops(name, B, H, Tq, Tk, D, causal):
    """Operations of a flash kernel's products over the visible (q, k)
    pairs, 2 a multiply-add."""
    pairs = (sum(min(Tk, t + 1) for t in range(Tq)) if causal
             else Tq * Tk)
    return 2 * PRODUCTS[name] * pairs * D * B * H


def bound(name, B, H, Tq, Tk, D, causal, itemsize):
    """Least time (ms) the card needs for the kernel's work on these shapes:
    the larger of its operations over the peak rate of the input type and
    its bytes (each input read once, each output written once) over the
    memory rate."""
    flops = fa_flops(name, B, H, Tq, Tk, D, causal)
    rows = B * H * D * itemsize
    stats = B * H * Tq * 4
    if name == "fa_fwd":
        nbytes = (2 * Tq + 2 * Tk) * rows + 2 * stats
    elif name == "fa_bwd_dq":
        nbytes = (3 * Tq + 2 * Tk) * rows + 3 * stats
    else:
        nbytes = (2 * Tq + 4 * Tk) * rows + 3 * stats
    peak = H100_BF16_FLOPS if itemsize == 2 else H100_F32_FLOPS
    t_ops, t_bytes = flops / peak, nbytes / H100_BYTES_PER_S
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def check(what, a, ref, dtype):
    """Hold ``a`` to ``ref`` element by element at the tolerance stated in
    the module doc; return ``(max |a - ref|, largest error / tolerance)``."""
    ref = ref.float()
    rms = ref.square().mean().sqrt().item()
    if not rms > 0.0:
        raise AssertionError(f"{what}: the plain version is all zero")
    r = 2 ** -7 if dtype == "bf16" else 5e-5
    err = (a.float() - ref).abs()
    ratio = err / (r * (ref.abs() + rms))
    worst = int(ratio.argmax())
    if not ratio.max().item() <= 1.0:
        raise AssertionError(
            f"{what}: |kernel - plain| = {err.reshape(-1)[worst].item():.3e} at "
            f"plain = {ref.reshape(-1)[worst].item():.3e} exceeds "
            f"{r:.3g} * (|plain| + RMS {rms:.3e})")
    return err.max().item(), ratio.max().item()


def kernel_case(fa, torch, *, B, Tq, Tk, H, D, dtype, causal, lengths,
                seed):
    """Run B1, B2 and B3 and their plain versions on one case; return the
    worst error of each kernel and the inputs for timing."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    mk = lambda T: torch.randn((B, T, H, D), generator=gen, device="cuda",
                               dtype=dtype)
    q, k, v, do = mk(Tq), mk(Tk), mk(Tk), mk(Tq)
    bias = None
    if lengths is not None:
        keep = (torch.arange(Tk, device="cuda")[None, :]
                < torch.tensor(lengths, device="cuda")[:, None])
        bias = torch.where(keep, 0.0, fa.NEG_INF).float().contiguous()
    kw = dict(causal=causal, scale=D ** -0.5)
    tag = "bf16" if dtype == torch.bfloat16 else "f32"
    o, m, l = fa.fa_fwd(q, k, v, bias, **kw)
    ro, rm, rl = fa._reference_partial(q, k, v, bias, **kw)
    # Per kernel, the (max error, error / tolerance) of its output with the
    # largest error relative to its tolerance.
    worst = lambda *pairs: max(pairs, key=lambda p: p[1])
    errs = {"fa_fwd": worst(check("B1 o", o, ro, tag),
                            check("B1 m", m, rm, "f32"),
                            check("B1 l", l, rl, "f32"))}
    if lengths is not None and 0 in lengths:
        row = list(lengths).index(0)
        if l[row].abs().max().item() != 0.0 or o[row].abs().max().item() != 0.0:
            raise AssertionError("B1: a row that sees no key must get l = 0 "
                                 "and output 0")
    dsum = fa._row_dsum(do, o)
    args = (q, k, v, do, m, l, dsum, bias)
    dq = fa.fa_bwd_dq(*args, **kw)
    errs["fa_bwd_dq"] = check("B2 dq", dq, fa._plain_bwd_dq(*args, **kw), tag)
    dk, dv = fa.fa_bwd_dkv(*args, **kw)
    rdk, rdv = fa._plain_bwd_dkv(*args, **kw)
    errs["fa_bwd_dkv"] = worst(check("B3 dk", dk, rdk, tag),
                               check("B3 dv", dv, rdv, tag))
    torch.cuda.synchronize()
    return errs, args, kw


def time_kernels(fa, torch, args, kw):
    """ms of each kernel, its plain version, and the nearest PyTorch call
    (SDPA forward for B1; SDPA backward, which yields dQ, dK and dV
    together, for B2 and B3)."""
    import torch.nn.functional as F
    q, k, v, do, m, l, dsum, bias = args
    ms = {
        "fa_fwd": (time_ms(lambda: fa.fa_fwd(q, k, v, bias, **kw), 20),
                   time_ms(lambda: fa._reference_partial(q, k, v, bias,
                                                         **kw), 2)),
        "fa_bwd_dq": (time_ms(lambda: fa.fa_bwd_dq(*args, **kw), 20),
                      time_ms(lambda: fa._plain_bwd_dq(*args, **kw), 2)),
        "fa_bwd_dkv": (time_ms(lambda: fa.fa_bwd_dkv(*args, **kw), 20),
                       time_ms(lambda: fa._plain_bwd_dkv(*args, **kw), 2)),
    }
    qt, kt, vt = (t.transpose(1, 2).contiguous().requires_grad_()
                  for t in (q, k, v))
    dot = do.transpose(1, 2).contiguous()
    mask = None if bias is None else bias.to(q.dtype)[:, None, None, :]
    sdpa = lambda: F.scaled_dot_product_attention(
        qt, kt, vt, attn_mask=mask, is_causal=kw["causal"],
        scale=kw["scale"])
    with torch.no_grad():
        lib_fwd = time_ms(sdpa)
    out = sdpa()
    lib_bwd = time_ms(lambda: torch.autograd.grad(
        out, (qt, kt, vt), dot, retain_graph=True))
    library = {"fa_fwd": lib_fwd, "fa_bwd_dq": lib_bwd,
               "fa_bwd_dkv": lib_bwd}
    return ms, library, (sdpa, (qt, kt, vt), dot)


def sdpa_backend(torch, sdpa, inputs, dot):
    """The device kernels of one SDPA forward and backward, longest first:
    their names say which back end the inputs selected."""
    from torch.autograd import DeviceType
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        torch.autograd.grad(sdpa(), inputs, dot)
        torch.cuda.synchronize()
    names = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            names[e.name[:80]] = (names.get(e.name[:80], 0.0)
                                  + e.time_range.elapsed_us())
    return [n for n, _ in sorted(names.items(), key=lambda x: -x[1])[:3]]


def small_model_check(torch, hvd_llama):
    """Flash on (the f32, D=64 kernels) against flash off on a small Llama:
    logits and every parameter's gradient, element by element, within
    ``1e-4 * (|plain| + RMS)``. Whole models: the kernels' f32 differences
    pass through every later layer and its gradient, so the bound is twice
    the kernels' own. Returns the largest error / tolerance."""
    def close(what, a, ref):
        err = (a - ref).abs()
        tol = 1e-4 * (ref.abs() + ref.square().mean().sqrt())
        ratio = (err / tol.clamp_min(1e-30)).max().item()
        if not bool((err <= tol).all()):
            raise AssertionError(f"{what}: |flash - plain| reaches "
                                 f"{ratio:.3f} of its bound")
        return ratio

    from horovod_tpu_torch.train import next_token_loss
    base = hvd_llama.LlamaConfig(vocab_size=512, dim=256, n_layers=2,
                                 n_heads=4, n_kv_heads=2, hidden_dim=512,
                                 max_seq_len=256, dtype=torch.float32,
                                 remat=False)
    gen = torch.Generator(device="cuda").manual_seed(3)
    tokens = torch.randint(0, 512, (2, 200), generator=gen, device="cuda")
    out = {}
    for flash in (False, True):
        model = hvd_llama.Llama(dataclasses.replace(base, use_flash=flash),
                                device="cuda", seed=1)
        logits = model(tokens)
        next_token_loss(logits, tokens).backward()
        out[flash] = (logits.detach(),
                      {n: p.grad for n, p in model.named_parameters()})
    err = close("small-model logits", out[True][0], out[False][0])
    for name, g in out[False][1].items():
        err = max(err, close(f"small-model grad {name}", out[True][1][name],
                             g))
    return err


def expected_buckets(model, threshold, itemsize=4):
    """Bucket count for the model's parameters on a wire of ``itemsize``
    bytes an element (4: f32; 2: bf16 compression), packed in reverse order
    up to ``threshold`` bytes (0: one per tensor), computed here apart from
    the port's planner."""
    sizes = [p.numel() * itemsize for p in model.parameters()]
    if threshold == 0:
        return len(sizes)
    count, fill = 0, None
    for nbytes in reversed(sizes):
        if fill is not None and fill + nbytes <= threshold:
            fill += nbytes
        else:
            count, fill = count + 1, nbytes
    return count


#: Kernel-name fragments of each group in the profiled step's device time.
GROUPS = (("B1 fa_fwd", ("fa_fwd_kernel",)),
          ("B2 fa_bwd_dq", ("fa_bwd_dq_kernel",)),
          ("B3 fa_bwd_dkv", ("fa_bwd_dkv_kernel",)),
          ("B4 norms_dot", ("norms_dot_partial_kernel",
                            "norms_dot_final_kernel")),
          ("B5 combine", ("combine_kernel",)),
          ("matmul", ("nvjet", "gemm", "xmma", "cutlass", "sm90_")),
          ("foreach (AdamW)", ("multi_tensor_apply",)),
          ("nccl", ("nccl",)))
#: The groups of the ResNet and BERT steps: cuDNN's convolutions (before
#: the matmul group, whose fragments their names share), and the
#: reductions and elementwise passes of BatchNorm, LayerNorm and casts.
MODEL_GROUPS = (GROUPS[:5] + (("conv (cuDNN)", ("fprop", "dgrad", "wgrad",
                                                "conv")),)
                + GROUPS[5:] + (("reductions", ("reduce_kernel",)),
                                ("elementwise", ("elementwise",))))


def device_breakdown(prof, wall_s, groups=GROUPS):
    """The profiled step's device time: each kernel group's ms and share of
    the summed kernel time, the rest with its largest kernels, and the
    device's idle share of the step's host-clock wall time (1 - union of
    kernel intervals / wall)."""
    from torch.autograd import DeviceType
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)]
    if not kernels:
        return "the profiler saw no device time: not measured"
    ms = dict.fromkeys([g for g, _ in groups] + ["other"], 0.0)
    other, spans = {}, []
    for e in kernels:
        t = e.time_range.elapsed_us() / 1e3
        group = next((g for g, frags in groups
                      if any(f in e.name.lower() for f in frags)), "other")
        ms[group] += t
        if group == "other":
            other[e.name[:100]] = other.get(e.name[:100], 0.0) + t
        spans.append((e.time_range.start, e.time_range.end))
    busy_us, end = 0.0, -math.inf
    for a, b in sorted(spans):
        if b > end:
            busy_us += b - max(a, end)
            end = b
    total = sum(ms.values())
    parts = "; ".join(f"{g} {t:.1f} ms ({t / total:.1%})"
                      for g, t in ms.items())
    top = "\n".join(f"    other: {t:.2f} ms  {name}" for name, t in
                    sorted(other.items(), key=lambda x: -x[1])[:8])
    return (f"kernels {total:.1f} ms summed over {len(kernels)} launches: "
            f"{parts}; device busy {busy_us / 1e3:.1f} ms, idle "
            f"{1 - busy_us / 1e3 / (wall_s * 1e3):.1%} of the step\n{top}")


def fused_bound(name, n):
    """Least time (ms) for B4 (``name`` "norms_dot": reads a and b) or B5
    ("combine": reads a and b, writes out) on n f32 elements: the larger of
    the bytes over the memory rate and the f32 operations (3 products and 3
    sums a pair for B4, 2 products and a sum for B5) over the f32 rate."""
    nbytes = (2 if name == "norms_dot" else 3) * 4 * n
    flops = (6 if name == "norms_dot" else 3) * n
    t_ops, t_bytes = flops / H100_F32_FLOPS, nbytes / H100_BYTES_PER_S
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


CHUNK = 1 << 26  # elements per chunk of the f64 checks, to bound scratch


def magnitude_sums(torch, a, b):
    """(sum |a_i b_i|, sum a_i^2, sum b_i^2) in f64: B4's tolerance scale."""
    acc = torch.zeros(3, dtype=torch.float64, device=a.device)
    for i in range(0, a.numel(), CHUNK):
        x, y = a[i:i + CHUNK].double(), b[i:i + CHUNK].double()
        acc += torch.stack([(x * y).abs().sum(), x @ x, y @ y])
    return acc.tolist()


def fused_check(fused, torch, what, a, b):
    """B4 and B5 against their plain versions on one pair, at the
    tolerances of the module doc. Returns ``{kernel: (max error, error /
    tolerance)}`` and B4's device buffer ``[a.b, |a|^2, |b|^2, ca, cb]``."""
    ratio = lambda err, tol: 0.0 if err == 0 else err / tol
    stats = fused._norms_dot_kernel(a, b)
    plain = fused._plain_norms_dot(a, b)
    b4 = []
    for name, got, want, mag in zip(("a.b", "|a|^2", "|b|^2"),
                                    stats[:3].tolist(), plain,
                                    magnitude_sums(torch, a, b)):
        err = abs(got - want.item())
        if not err <= 1e-6 * mag:
            raise AssertionError(f"B4 {what} {name}: kernel {got!r}, plain "
                                 f"{want.item()!r}, over 1e-6 * {mag:.4e}")
        b4.append((err, ratio(err, 1e-6 * mag)))
    for got, want in zip(stats[3:].tolist(),
                         fused.adasum_coefficients(*plain)):
        want = want.item()
        if not abs(got - want) <= 1e-5 * abs(want):
            raise AssertionError(f"B4 {what} coefficient: kernel {got!r}, "
                                 f"plain {want!r}")
    out = fused._combine_kernel(a, b, stats)
    ca, cb = stats[3], stats[4]
    worst = (0.0, 0.0)
    for i in range(0, a.numel(), CHUNK):
        x, y = a[i:i + CHUNK], b[i:i + CHUNK]
        err = (out[i:i + CHUNK] - fused._plain_scale_add(x, y, ca, cb)).abs()
        tol = 2 ** -22 * ((ca * x).abs() + (cb * y).abs())
        bad = err > tol
        if bool(bad.any()):
            j = int(bad.nonzero()[0])
            raise AssertionError(f"B5 {what}: element {i + j} off by "
                                 f"{err[j].item():.3e}, tolerance "
                                 f"{tol[j].item():.3e}")
        e = err.max().item()
        r = torch.where(err == 0, 0.0, err / tol).max().item()
        worst = (max(worst[0], e), max(worst[1], r))
    return {"norms_dot": max(b4, key=lambda p: p[1]),
            "combine": worst}, stats, out


def fused_edge_cases(fused, torch):
    """B4 and B5 on the edge cases of the module doc; the identities the
    combine must meet hold exactly. Returns the worst (error, error /
    tolerance) of each kernel."""
    gen = torch.Generator(device="cuda").manual_seed(5)
    mk = lambda n: torch.randn(n, generator=gen, device="cuda")
    half = torch.arange(70_000, device="cuda") < 35_000
    cases = {"n65536": (mk(65536), mk(65536)),
             "ragged 1000003": (mk(1_000_003), mk(1_000_003)),
             "a = 0": (torch.zeros(70_001, device="cuda"), mk(70_001)),
             "orthogonal": (mk(70_000) * half, mk(70_000) * ~half),
             "misaligned slices": (mk(300_003)[1:-1], mk(300_004)[3:])}
    x = mk(70_001)
    cases["a = b"] = (x, x.clone())
    worst = {"norms_dot": (0.0, 0.0), "combine": (0.0, 0.0)}
    for what, (a, b) in cases.items():
        errs, _, out = fused_check(fused, torch, what, a, b)
        for k, e in errs.items():
            worst[k] = max(worst[k], e, key=lambda p: p[1])
        want = {"a = 0": (b, "b"), "a = b": (a, "a"),
                "orthogonal": (a + b, "a + b")}.get(what)
        if want is not None and not torch.equal(out, want[0]):
            raise AssertionError(f"combine {what}: not exactly {want[1]}")
        if not torch.equal(fused.fused_combine(a, b),
                           fused.fused_combine(b, a)):
            raise AssertionError(f"combine {what}: not symmetric")
    return worst


def flat_gradient(torch, model, cfg, seed, next_token_loss):
    """The model's gradient on one seeded batch of 2 x 2048 tokens,
    flattened in ``DistributedOptimizer`` order (the parameters' order)
    into one f32 vector."""
    model.zero_grad(set_to_none=True)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    tokens = torch.randint(0, cfg.vocab_size, (2, 2048), generator=gen,
                           device="cuda")
    next_token_loss(model(tokens), tokens).backward()
    return torch.cat([p.grad.reshape(-1) for p in model.parameters()])


def time_fused(fused, torch, a, b, stats, out):
    """ms of B4 and B5 at the main-path shape, of their plain versions, and
    of their yardsticks."""
    ca, cb = stats[3], stats[4]
    cb_f = cb.item()
    ms = {"norms_dot": (time_ms(lambda: fused._norms_dot_kernel(a, b)),
                        time_ms(lambda: fused._plain_norms_dot(a, b), 2)),
          "combine": (time_ms(lambda: fused._combine_kernel(a, b, stats,
                                                            out)),
                      time_ms(lambda: fused._plain_scale_add(a, b, ca, cb),
                              2))}
    library = {"norms_dot": time_ms(lambda: (torch.dot(a, b), torch.dot(a, a),
                                             torch.dot(b, b))),
               "combine": time_ms(lambda: torch.add(a.mul(ca), b,
                                                    alpha=cb_f))}
    return ms, library


def plain_butterfly(fused, vecs):
    """Position 0's result of the butterfly over ``vecs`` (one per rank),
    with the plain combine. After the level at distance d every aligned
    block of 2d positions holds one value, so this is the pairwise tree;
    the vectors are consumed to bound memory."""
    while len(vecs) > 1:
        nxt = []
        while vecs:
            a, b = vecs.pop(0), vecs.pop(0)
            nxt.append(fused._plain_combine(a, b))
            del a, b
        vecs = nxt
    return vecs[0]


def close_per_element(torch, got, ref, r):
    """Largest ``|got - ref| / (r (|ref| + RMS(ref)))``, chunk by chunk."""
    sq = sum(ref[i:i + CHUNK].double().square().sum().item()
             for i in range(0, ref.numel(), CHUNK))
    rms = math.sqrt(sq / ref.numel())
    worst = (0.0, 0.0)
    for i in range(0, ref.numel(), CHUNK):
        g, w = got[i:i + CHUNK].double(), ref[i:i + CHUNK].double()
        err = (g - w).abs()
        worst = (max(worst[0], err.max().item()),
                 max(worst[1], (err / (r * (w.abs() + rms))).max().item()))
    return worst


def adasum_worker(out_dir):
    """One rank of the ``adasum`` phase; writes ``rank<r>.json``."""
    import torch
    import torch.distributed as dist
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.models import llama as hvd_llama
    from horovod_tpu_torch.ops import fused
    from horovod_tpu_torch.train import (create_train_state, make_train_step,
                                         next_token_loss)
    torch.backends.cuda.matmul.allow_tf32 = False
    hvd.init()
    rank, n = hvd.rank(), hvd.size()
    cfg = dataclasses.replace(hvd_llama.llama3_8b(), n_layers=2,
                              use_flash=True, remat=False)
    model = hvd_llama.Llama(cfg, seed=rank)  # the broadcast makes them equal
    params = list(model.parameters())
    opt = hvd.DistributedOptimizer(
        torch.optim.AdamW(params, lr=1e-4, weight_decay=1e-4),
        named_parameters=model.named_parameters(), op=hvd.Adasum)
    state = create_train_state(model, opt)
    step = make_train_step(model, opt, next_token_loss)
    gen = torch.Generator(device="cuda").manual_seed(1000 + rank)
    tokens = torch.randint(0, cfg.vocab_size, (2, 2048), generator=gen,
                           device="cuda")
    kept = {}
    synchronize = opt.synchronize

    def keep_first_step():
        """The first step's local and combined gradients, flattened."""
        first = not kept
        if first:
            kept["local"] = torch.cat([p.grad.reshape(-1) for p in params])
        synchronize()
        if first:
            kept["combined"] = torch.cat([p.grad.reshape(-1) for p in params])

    opt.synchronize = keep_first_step
    torch.cuda.reset_peak_memory_stats()
    losses, times, launches = [], [], []
    for i in range(3):
        fused.reset_launch_counts()
        torch.cuda.synchronize()
        with (torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA])
              if i == 2 and rank == 0 else contextlib.nullcontext()) as prof:
            t = time.perf_counter()
            state, loss = step(state, tokens, tokens)
            losses.append(loss.item())
            times.append(time.perf_counter() - t)
        launches.append([fused.fused_norms_dot.launches,
                         fused.fused_combine.launches])
    res = {"rank": rank, "size": n, "losses": losses, "times": times,
           "launches": launches,
           "peak_gb": torch.cuda.max_memory_allocated() / 1e9}
    if rank == 0:
        res["profile"] = device_breakdown(prof, times[-1])
    differ = 0
    for p in params:
        buf = p.detach().clone()
        dist.broadcast(buf, 0)
        differ += int(not torch.equal(buf, p))
    res["params_differing_from_rank0"] = differ
    local, combined = kept.pop("local"), kept.pop("combined")
    del state, step, opt, model, params, buf, synchronize, keep_first_step
    gc.collect()
    torch.cuda.empty_cache()
    gathered = ([torch.empty_like(local) for _ in range(n)] if rank == 0
                else None)
    dist.gather(local, gathered, dst=0)
    del local
    if rank == 0:
        ref = plain_butterfly(fused, gathered)
        res["grad_err"], res["grad_err_over_tol"] = close_per_element(
            torch, combined, ref, 1e-5)
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(res, f)
    hvd.shutdown()
    return 0


#: On four cards or more, the phases whose 4-rank world splits every axis
#: their 2-rank world splits run the 4-rank world alone: ``context`` (sp
#: on ``{"dp": 2, "sp": 2}``), ``mixtral-ep`` (ep on ``{"dp": 2, "ep":
#: 2}``) and ``model-parallel`` (fsdp and tp on ``{"fsdp": 2, "tp": 2}``).
FOUR_ALONE = ("context", "mixtral-ep", "model-parallel")
#: On four cards or more, the 2-rank worlds of these phases run on cards 2
#: and 3 while this process runs the one-card phases on card 0
#: (:func:`prefetch_worlds`).
LANE_PHASES = ("pipeline", "mixtral-mp")
#: Worlds started ahead of their phase: phase -> slot (prefetch_worlds).
_PREFETCHED = {}


def world_sizes(phase, cards):
    """The worlds a multi-rank phase starts on ``cards`` cards (2 or
    more): 2 ranks, and on four cards 4 too (4 alone for FOUR_ALONE)."""
    if cards < 4:
        return [2]
    return [4] if phase in FOUR_ALONE else [2, 4]


def prefetch_worlds(phases):
    """Start the 2-rank worlds of ``phases``, one after another, on cards 2
    and 3, in a thread of their own; ``run_world(phase, 2)`` then waits
    for its world and returns its ranks (or raises its error). Returns the
    thread: join it before any world takes those cards again. It is not a
    daemon, so an error in this process waits for its worlds to stop."""
    import threading
    slots = {phase: {"done": threading.Event()} for phase in phases}
    _PREFETCHED.update(slots)

    def lane():
        for phase, slot in slots.items():
            t0 = time.perf_counter()
            try:
                slot["ranks"] = _run_world(
                    phase, 2, {"CUDA_VISIBLE_DEVICES": "2,3"})
            except Exception as e:  # raised by the phase that reads it
                slot["error"] = e
            slot["seconds"] = time.perf_counter() - t0
            slot["done"].set()

    thread = threading.Thread(target=lane, name="two-rank worlds")
    thread.start()
    return thread


def run_world(phase, n, env=None, limit=900):
    """Run ``--<phase>-worker`` in an NCCL world of n processes, one card
    each, with the port's ``HOROVOD_*`` environment and ``env``; return each
    rank's ``rank<r>.json``. A rank that fails fails the phase, with the end
    of its log; every process is stopped before this returns. A world that
    :func:`prefetch_worlds` started is waited for instead."""
    slot = _PREFETCHED.pop(phase, None) if n == 2 else None
    if slot is None:
        return _run_world(phase, n, env, limit)
    slot["done"].wait()
    if "error" in slot:
        raise slot["error"]
    log(phase, f"2 ranks, on cards 2 and 3 beside the one-card phases: "
               f"{slot['seconds']:.1f} s")
    return slot["ranks"]


def _run_world(phase, n, env=None, limit=900):
    """:func:`run_world`'s world."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    with tempfile.TemporaryDirectory() as d:
        base = dict(os.environ, HOROVOD_COORDINATOR_ADDR=f"127.0.0.1:{port}",
                    HOROVOD_NUM_PROCESSES=str(n), **(env or {}))
        procs, logs = [], []
        try:
            for r in range(n):
                logs.append(open(os.path.join(d, f"rank{r}.log"), "w"))
                procs.append(subprocess.Popen(
                    [sys.executable, os.path.abspath(__file__),
                     f"--{phase}-worker", d],
                    env=dict(base, HOROVOD_PROCESS_ID=str(r)),
                    stdout=logs[-1], stderr=subprocess.STDOUT))
            deadline = time.monotonic() + limit
            # Poll every rank: one that fails leaves the others waiting in
            # a collective, so stop at the first failure, not at the limit.
            while True:
                codes = [p.poll() for p in procs]
                bad = [r for r, c in enumerate(codes) if c not in (None, 0)]
                if bad or None not in codes or time.monotonic() > deadline:
                    break
                time.sleep(0.5)
            bad = bad or [r for r, c in enumerate(codes) if c is None]
            if bad:
                r = bad[0]
                with open(os.path.join(d, f"rank{r}.log")) as f:
                    tail = f.read()[-4000:]
                what = ("timed out" if codes[r] is None
                        else f"exited {codes[r]}")
                raise AssertionError(f"{phase} rank {r} {what}:\n{tail}")
        finally:
            for p in procs:
                p.kill()
                p.wait()
            for f in logs:
                f.close()
        ranks = []
        for r in range(n):
            with open(os.path.join(d, f"rank{r}.json")) as f:
                ranks.append(json.load(f))
    return ranks


def adasum_phase(torch, card):
    """The ``adasum`` phase (module doc). Returns rank 0's launches of B4
    and B5 over its steps, or zeros on one card."""
    cards = torch.cuda.device_count()
    n = 1 << (min(4, cards).bit_length() - 1)
    if n < 2:
        log("adasum", "one card: Adasum of a single contribution is that "
                      "contribution (horovod_tpu/collectives/adasum.py:"
                      "108-117), so in a world of one the butterfly and its "
                      "kernels do not run; the phase needs 2 or more cards")
        return {"norms_dot": 0, "combine": 0}
    ranks = run_world("adasum", n)
    levels = n.bit_length() - 1
    for res in ranks:
        if res["launches"] != [[levels, levels]] * 3:
            raise AssertionError(f"rank {res['rank']}: B4/B5 launches per "
                                 f"step {res['launches']}, expected "
                                 f"{levels} each")
        if not all(math.isfinite(x) for x in res["losses"]):
            raise AssertionError(f"non-finite loss: {res['losses']}")
        if res["params_differing_from_rank0"]:
            raise AssertionError(f"rank {res['rank']}: "
                                 f"{res['params_differing_from_rank0']} "
                                 "parameters differ from rank 0's")
    r0 = ranks[0]
    if not r0["grad_err_over_tol"] <= 1.0:
        raise AssertionError(f"combined gradient off the plain butterfly: "
                             f"{r0['grad_err_over_tol']:.3f} of tolerance")
    log("adasum", f"{n} ranks over NCCL, DistributedOptimizer(AdamW, "
                  f"op=Adasum), 2-layer llama3_8b width: losses "
                  f"{r0['losses']}; step {r0['times'][1] * 1e3:.1f} ms "
                  f"(first {r0['times'][0] * 1e3:.1f} ms, profiled "
                  f"{r0['times'][2] * 1e3:.1f} ms); "
                  f"{2 * 2048 / r0['times'][1]:.0f} tokens/s/GPU; B4/B5 "
                  f"launches per step {r0['launches'][0]}; parameters "
                  f"bit-identical on every rank; step-1 combined gradient "
                  f"vs plain butterfly max err {r0['grad_err']:.2e}, err/tol "
                  f"{r0['grad_err_over_tol']:.3f} (tolerance 1e-5 (|ref| + "
                  f"RMS(ref)) per element); peak "
                  f"{r0['peak_gb']:.1f} GB; on {card}")
    log("adasum", f"rank 0, step 3 under torch.profiler: {r0['profile']}")
    return {"norms_dot": sum(x[0] for x in r0["launches"]),
            "combine": sum(x[1] for x in r0["launches"])}


#: Bus-bandwidth factor of each timed collective, as nccl-tests define it:
#: busbw = algbw * factor(n), algbw = bytes / time.
BUS_FACTOR = {"allreduce": lambda n: 2 * (n - 1) / n,
              "reducescatter": lambda n: (n - 1) / n,
              "allgather": lambda n: (n - 1) / n,
              "alltoall": lambda n: (n - 1) / n,
              "broadcast": lambda n: 1.0}


def summation_bound(torch, got, ref, absum, scale):
    """Largest ``|got - ref| / (2^-21 * absum * scale)``, chunk by chunk:
    two sums of the same n <= 4 terms in other orders differ by at most
    2 (n - 1) roundings of 2^-24 of the summed magnitudes ``absum``, under
    2^-21 of them. Where ``absum`` is 0 both must be exactly 0."""
    worst = (0.0, 0.0)
    for i in range(0, ref.numel(), CHUNK):
        err = (got[i:i + CHUNK] - ref[i:i + CHUNK]).abs()
        tol = 2 ** -21 * scale * absum[i:i + CHUNK]
        if not bool((err[tol == 0] == 0).all()):
            raise AssertionError("a sum of zeros came out nonzero")
        worst = (max(worst[0], err.max().item()),
                 max(worst[1], (err / tol.clamp_min(1e-38)).max().item()))
    return worst


def collectives_worker(out_dir):
    """One rank of the ``collectives`` phase; writes ``rank<r>.json``."""
    import torch
    import torch.distributed as dist
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.collectives import ops
    from horovod_tpu_torch.core.config import Config
    from horovod_tpu_torch.models import llama as hvd_llama
    from horovod_tpu_torch.ops import flash_attention as fa
    from horovod_tpu_torch.ops import fused
    from horovod_tpu_torch.optimizer.functions import (allgather_object,
                                                       broadcast_object)
    from horovod_tpu_torch.train import (create_train_state, make_train_step,
                                         next_token_loss)
    torch.backends.cuda.matmul.allow_tf32 = False
    hvd.init()
    rank, n = hvd.rank(), hvd.size()
    cross, intra = hvd.cross_size(), hvd.local_size()
    res = {"rank": rank, "size": n, "layout": [cross, intra]}
    stages = ops.hierarchical_allreduce_async_.launches

    # (a) Hierarchical Average at full width, 3 checked steps.
    cfg = dataclasses.replace(hvd_llama.llama3_8b(), n_layers=2,
                              use_flash=True, remat=False)
    res["n_layers"] = cfg.n_layers
    model = hvd_llama.Llama(cfg, seed=rank)  # the broadcast makes them equal
    params = list(model.parameters())
    shapes = [tuple(p.shape) for p in params]
    opt = hvd.DistributedOptimizer(
        torch.optim.AdamW(params, lr=1e-4, weight_decay=1e-4),
        named_parameters=model.named_parameters())
    res["buckets"] = len(opt.buckets)
    res["expected_buckets"] = expected_buckets(
        model, Config.from_env().fusion_threshold_bytes)
    state = create_train_state(model, opt)
    step = make_train_step(model, opt, next_token_loss)
    gen = torch.Generator(device="cuda").manual_seed(2000 + rank)
    tokens = torch.randint(0, cfg.vocab_size, (2, 2048), generator=gen,
                           device="cuda")
    kept = {}
    synchronize = opt.synchronize

    def keep_first_step():
        """The first step's local and reduced gradients, flattened. The
        hierarchical stages only read the gradients until synchronize()
        writes the results back."""
        first = not kept
        if first:
            kept["local"] = torch.cat([p.grad.reshape(-1) for p in params])
        synchronize()
        if first:
            kept["reduced"] = torch.cat([p.grad.reshape(-1) for p in params])

    opt.synchronize = keep_first_step
    losses, times, fa_launches, stage_launches = [], [], [], []
    for _ in range(3):
        fa.reset_launch_counts()
        before = dict(stages)
        torch.cuda.synchronize()
        t = time.perf_counter()
        state, loss = step(state, tokens, tokens)
        losses.append(loss.item())
        times.append(time.perf_counter() - t)
        fa_launches.append({k: f.launches for k, f in fa.KERNELS.items()})
        stage_launches.append([stages[k] - before[k]
                               for k in ops.HIER_STAGES])
    opt.synchronize = synchronize
    res.update(losses=losses, times=times, fa_launches=fa_launches,
               stage_launches=stage_launches)
    turns = {"flat": [], "hierarchical": []}
    for mode in ("flat", "hierarchical", "hierarchical", "flat") * 3:
        with ops.hierarchical_override(mode == "hierarchical"):
            torch.cuda.synchronize()
            t = time.perf_counter()
            state, loss = step(state, tokens, tokens)
            loss.item()
            turns[mode].append(time.perf_counter() - t)
    res["turns"] = turns
    differ = 0
    for p in params:
        buf = p.detach().clone()
        dist.broadcast(buf, 0)
        differ += int(not torch.equal(buf, p))
    res["params_differing_from_rank0"] = differ
    res["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    local, reduced = kept.pop("local"), kept.pop("reduced")
    res["grad_elements"] = local.numel()
    del state, step, opt, model, params, buf, synchronize, keep_first_step
    gc.collect()
    torch.cuda.empty_cache()
    flat = local.clone()
    dist.all_reduce(flat)
    flat.div_(n)
    absum = local.abs()
    dist.all_reduce(absum)
    res["grad_err"], res["grad_err_over_tol"] = summation_bound(
        torch, reduced, flat, absum, 1 / n)
    del flat, absum, reduced
    torch.cuda.empty_cache()

    # (b) hierarchical_adasum over the flat gradient.
    fused.reset_launch_counts()
    torch.cuda.synchronize()
    t = time.perf_counter()
    combined = hvd.hierarchical_adasum(local)
    torch.cuda.synchronize()
    res["adasum_first_s"] = time.perf_counter() - t
    res["adasum_launches"] = [fused.fused_norms_dot.launches,
                              fused.fused_combine.launches]
    gathered = ([torch.empty_like(local) for _ in range(n)] if rank == 0
                else None)
    dist.gather(local, gathered, dst=0)
    if rank == 0:
        sums = []
        for c in range(cross):  # the sum within each node, node by node
            first = gathered[c * intra]
            for i in range(1, intra):
                first.add_(gathered[c * intra + i])
            sums.append(first)
        del gathered, first
        # The butterfly runs on each node's shard: coefficients per shard,
        # as the JAX package's hierarchical_adasum computes them.
        m = local.numel() // intra
        ref = torch.cat([plain_butterfly(fused, [x[i * m:(i + 1) * m]
                                                 for x in sums])
                         for i in range(intra)])
        del sums
        res["adasum_err"], res["adasum_err_over_tol"] = close_per_element(
            torch, combined, ref, 1e-5)
        del ref
    del combined
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    t = time.perf_counter()  # again, past the groups' first use
    hvd.hierarchical_adasum(local)
    torch.cuda.synchronize()
    res["adasum_s"] = time.perf_counter() - t
    gc.collect()
    torch.cuda.empty_cache()

    # (c) The surface at realistic sizes, each against a plain
    # construction, then timed (CUDA events, all ranks in step).
    def bandwidth(kind, nbytes, ms):
        algbw = nbytes / (ms * 1e-3) / 1e9
        return {"ms": ms, "bytes": nbytes, "algbw": algbw,
                "busbw": algbw * BUS_FACTOR[kind](n)}

    bw = {}
    for mode in ("flat", "hierarchical"):
        with ops.hierarchical_override(mode == "hierarchical"):
            bw[f"allreduce ({mode})"] = bandwidth(
                "allreduce", local.numel() * 4,
                time_ms(lambda: hvd.allreduce(local, hvd.Average), 3))
    m = local.numel() // n
    shard = hvd.reducescatter(local, hvd.Sum)
    full = local.clone()
    dist.all_reduce(full)
    absum = local.abs()
    dist.all_reduce(absum)
    res["rs_err"], res["rs_err_over_tol"] = summation_bound(
        torch, shard, full[rank * m:(rank + 1) * m],
        absum[rank * m:(rank + 1) * m], 1.0)
    del full, absum
    bw["reducescatter"] = bandwidth(
        "reducescatter", local.numel() * 4,
        time_ms(lambda: hvd.reducescatter(local, hvd.Sum), 3))
    del local
    torch.cuda.empty_cache()
    got = hvd.allgather(shard)
    want = torch.empty_like(got)
    for p in range(n):
        buf = shard.clone() if p == rank else torch.empty_like(shard)
        dist.broadcast(buf, p)
        want[p * m:(p + 1) * m] = buf
    res["allgather_exact"] = bool(torch.equal(got, want))
    del got, want, buf
    bw["allgather"] = bandwidth("allgather", shard.numel() * 4 * n,
                                time_ms(lambda: hvd.allgather(shard), 3))
    del shard
    torch.cuda.empty_cache()

    dispatch = torch.randn((8, 1280, 4096), generator=gen, device="cuda",
                           dtype=torch.bfloat16)
    got = hvd.alltoall(dispatch)
    want = torch.empty_like(dispatch)
    c = dispatch.shape[0] // n
    p2p = []
    for p in range(n):
        part = slice(p * c, (p + 1) * c)
        if p == rank:
            want[part] = dispatch[part]
        else:
            p2p += [dist.P2POp(dist.isend, dispatch[part].clone(), p),
                    dist.P2POp(dist.irecv, want[part], p)]
    for work in dist.batch_isend_irecv(p2p):
        work.wait()
    res["alltoall_exact"] = bool(torch.equal(got, want))
    bw["alltoall"] = bandwidth("alltoall", dispatch.numel() * 2,
                               time_ms(lambda: hvd.alltoall(dispatch)))
    del dispatch, got, want, p2p

    def param_list(seed):
        g = torch.Generator(device="cuda").manual_seed(seed)
        return [torch.randn(s, generator=g, device="cuda") for s in shapes]

    mine = param_list(3000 + rank)
    got = hvd.grouped_broadcast(mine, 0)
    want = param_list(3000)
    res["broadcast_exact"] = all(bool(torch.equal(a, b))
                                 for a, b in zip(got, want))
    del got, want
    bw["grouped_broadcast"] = bandwidth(
        "broadcast", sum(t.numel() for t in mine) * 4,
        time_ms(lambda: hvd.grouped_broadcast(mine, 0), 3))
    del mine
    torch.cuda.empty_cache()

    rows, width = 4096, 4096
    valid = [rows - 1024 * r - 7 * r for r in range(n)]

    def padded(r):
        g = torch.Generator(device="cuda").manual_seed(4000 + r)
        x = torch.randn((rows, width), generator=g, device="cuda",
                        dtype=torch.bfloat16)
        return x, torch.cat([x[:valid[r]], x.new_zeros(rows - valid[r],
                                                       width)])

    mine = padded(rank)[0]
    got, sizes = hvd.allgather_v(mine, valid[rank])
    want = torch.cat([padded(r)[1] for r in range(n)])
    res["allgather_v_exact"] = (bool(torch.equal(got, want))
                                and sizes.tolist() == valid)
    bw["allgather_v"] = bandwidth(
        "allgather", got.numel() * 2,
        time_ms(lambda: hvd.allgather_v(mine, valid[rank])))
    del mine, got, want
    splits = [[256 * (1 + (r + p) % n) for p in range(n)] for r in range(n)]
    cap = 256 * n

    def sent(r):
        g = torch.Generator(device="cuda").manual_seed(5000 + r)
        return torch.randn((sum(splits[r]), width), generator=g,
                           device="cuda", dtype=torch.bfloat16)

    mine = sent(rank)
    got, recv_splits = hvd.alltoall_v(mine, splits[rank], max_split=cap)
    want = torch.zeros((n * cap, width), device="cuda", dtype=torch.bfloat16)
    for p in range(n):
        off, cnt = sum(splits[p][:rank]), splits[p][rank]
        want[p * cap:p * cap + cnt] = sent(p)[off:off + cnt]
    res["alltoall_v_exact"] = (bool(torch.equal(got, want))
                               and recv_splits.tolist()
                               == [splits[p][rank] for p in range(n)])
    bw["alltoall_v"] = bandwidth(
        "alltoall", got.numel() * 2,
        time_ms(lambda: hvd.alltoall_v(mine, splits[rank], max_split=cap)))
    del mine, got, want

    def jvec(r):
        g = torch.Generator(device="cuda").manual_seed(6000 + r)
        return torch.randn(1 << 24, generator=g, device="cuda")

    got = hvd.join_allreduce(jvec(rank), rank != n - 1)
    live = [jvec(r) for r in range(n - 1)]
    ref = sum(live) / (n - 1)
    absum = sum(v.abs() for v in live) / (n - 1) + ref.abs()
    res["join_err"], res["join_err_over_tol"] = summation_bound(
        torch, got, ref, absum, 1.0)
    del got, live, ref, absum

    def obj(r):
        return {"epoch": 7 + r, "rank": r,
                "metrics": {"loss": [0.5 * r, None], "ok": r % 2 == 0},
                "tag": ("resume", r)}

    res["objects_exact"] = (broadcast_object(obj(rank), n - 1) == obj(n - 1)
                            and allgather_object(obj(rank))
                            == [obj(r) for r in range(n)])
    res["bandwidth"] = bw
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(res, f)
    hvd.shutdown()
    return 0


def collectives_phase(torch, card):
    """The ``collectives`` phase (module doc). Returns rank 0's launches of
    B1-B5 on its paths, or zeros on one card."""
    cards = torch.cuda.device_count()
    n = 1 << (min(4, cards).bit_length() - 1)
    if n < 2:
        log("collectives", "one card: the hierarchical paths and the "
                           "collectives between ranks need 2 or more cards; "
                           "in a world of one every collective of the port "
                           "is the identity or a single-rank all-reduce, so "
                           "the phase runs nothing here")
        return dict.fromkeys(["fa_fwd", "fa_bwd_dq", "fa_bwd_dkv",
                              "norms_dot", "combine"], 0)
    ranks = run_world("collectives", n, {
        "HOROVOD_LOCAL_SIZE": str(n // 2),
        "HOROVOD_HIERARCHICAL_ALLREDUCE": "1"})
    r0 = ranks[0]
    cross, intra = r0["layout"]
    levels = cross.bit_length() - 1
    stages = [r0["expected_buckets"] + 1] * 3  # the buckets and the loss
    for res in ranks:
        if res["layout"] != [2, n // 2]:
            raise AssertionError(f"layout {res['layout']}, declared "
                                 f"2 x {n // 2}")
        if res["buckets"] != res["expected_buckets"]:
            raise AssertionError(f"{res['buckets']} buckets, expected "
                                 f"{res['expected_buckets']}")
        if not all(math.isfinite(x) for x in res["losses"]):
            raise AssertionError(f"non-finite loss: {res['losses']}")
        if res["params_differing_from_rank0"]:
            raise AssertionError(f"rank {res['rank']}: "
                                 f"{res['params_differing_from_rank0']} "
                                 "parameters differ from rank 0's")
        for launched in res["fa_launches"]:
            if min(launched.values()) < res["n_layers"]:
                raise AssertionError(f"flash kernels per step {launched}, "
                                     "expected once a layer at least")
        if res["stage_launches"] != [stages] * 3:
            raise AssertionError(f"rank {res['rank']}: stages per step "
                                 f"{res['stage_launches']}, expected "
                                 f"{stages}")
        if res["adasum_launches"] != [levels, levels]:
            raise AssertionError(f"rank {res['rank']}: B4/B5 launches "
                                 f"{res['adasum_launches']}, expected "
                                 f"{levels} each")
        for key in ("grad", "rs", "join"):
            if not res[f"{key}_err_over_tol"] <= 1.0:
                raise AssertionError(f"rank {res['rank']}: {key} off by "
                                     f"{res[f'{key}_err_over_tol']:.3f} of "
                                     "its tolerance")
        for key in ("allgather", "alltoall", "broadcast", "allgather_v",
                    "alltoall_v", "objects"):
            if not res[f"{key}_exact"]:
                raise AssertionError(f"rank {res['rank']}: {key} differs "
                                     "from its plain construction")
    if not r0["adasum_err_over_tol"] <= 1.0:
        raise AssertionError(f"hierarchical_adasum off the plain "
                             f"composition: {r0['adasum_err_over_tol']:.3f} "
                             "of tolerance")
    med = lambda xs: sorted(xs)[len(xs) // 2]
    flat_s, hier_s = med(r0["turns"]["flat"]), med(r0["turns"]["hierarchical"])
    log("collectives", f"{n} ranks over NCCL declared {cross} x {intra} "
                       f"(HOROVOD_LOCAL_SIZE={intra}), "
                       f"HOROVOD_HIERARCHICAL_ALLREDUCE=1, "
                       f"DistributedOptimizer(AdamW), 2-layer llama3_8b "
                       f"width: losses {r0['losses']}; stages per step "
                       f"{r0['stage_launches'][0]} ({r0['buckets']} buckets "
                       f"and the loss); B1-B3 per step "
                       f"{r0['fa_launches'][0]}; parameters bit-identical "
                       f"on every rank; step-1 reduced gradient vs flat "
                       f"dist.all_reduce max err {r0['grad_err']:.2e}, "
                       f"err/tol {r0['grad_err_over_tol']:.3f} (tolerance "
                       f"2^-21 sum_i |g_i| / n per element); peak "
                       f"{r0['peak_gb']:.1f} GB; on {card}")
    log("collectives", f"step in turns, 6 each: hierarchical "
                       f"{hier_s * 1e3:.1f} ms, "
                       f"{2 * 2048 / hier_s:.0f} tokens/s/GPU; flat "
                       f"{flat_s * 1e3:.1f} ms, {2 * 2048 / flat_s:.0f} "
                       f"tokens/s/GPU (median; hierarchical "
                       f"{sorted(round(t * 1e3, 1) for t in r0['turns']['hierarchical'])}, "
                       f"flat {sorted(round(t * 1e3, 1) for t in r0['turns']['flat'])} ms; "
                       f"first checked step {r0['times'][0] * 1e3:.1f} ms); "
                       f"on {card}")
    log("collectives", f"hierarchical_adasum of the flat f32 gradient "
                       f"({r0['grad_elements']:,} elements): "
                       f"{r0['adasum_s'] * 1e3:.1f} ms on the host clock "
                       f"(first call, with the cross group's setup, "
                       f"{r0['adasum_first_s'] * 1e3:.1f} ms); B4/B5 "
                       f"launches {r0['adasum_launches']} "
                       f"a rank ({levels} level(s) across {cross} nodes); "
                       f"vs the intra sum then the plain butterfly max err "
                       f"{r0['adasum_err']:.2e}, err/tol "
                       f"{r0['adasum_err_over_tol']:.3f} (tolerance 1e-5 "
                       f"(|ref| + RMS(ref)))")
    log("collectives", f"reducescatter of the flat gradient vs the slice of "
                       f"a flat all-reduce: max err {r0['rs_err']:.2e}, "
                       f"err/tol {r0['rs_err_over_tol']:.3f}; join_allreduce "
                       f"with rank {n - 1} out of data: err/tol "
                       f"{r0['join_err_over_tol']:.3f}; allgather, alltoall, "
                       f"grouped_broadcast, allgather_v, alltoall_v and the "
                       f"object helpers bit-exact against their plain "
                       f"constructions on every rank")
    for name, b in r0["bandwidth"].items():
        log("collectives", f"{name}: {b['bytes'] / 1e9:.3f} GB in "
                           f"{b['ms']:.3f} ms, algbw {b['algbw']:.1f} GB/s, "
                           f"busbw {b['busbw']:.1f} GB/s ({n} ranks); on "
                           f"{card}")
    total = {k: sum(x[k] for x in r0["fa_launches"])
             for k in r0["fa_launches"][0]}
    total.update(norms_dot=r0["adasum_launches"][0],
                 combine=r0["adasum_launches"][1])
    return total


#: The remat arms of the ``longctx`` phase (``with_remat_policy``'s
#: vocabulary) and B1's launches per layer per step under each: the
#: forward, and under "dots" and "full", whose policies do not save B1's
#: outputs, its recompute in backward.
ARMS = ("none", "dots", "dots_attn", "attn", "full")
B1_PER_LAYER = {"none": 1, "dots": 2, "dots_attn": 1, "attn": 1, "full": 2}
#: Gates of the ``context`` phase against the dense single-rank model.
CP_LOSS_RTOL = 1e-3
CP_GRAD_NORMWISE = 2 ** -4


def host_grads(model):
    """The model's gradients, copied to the host, by parameter name."""
    return {n: p.grad.to("cpu") for n, p in model.named_parameters()}


def grad_gaps(torch, model, ref):
    """Each gradient of ``model`` against ``ref`` (on the host), tensor by
    tensor on the card: the largest ``|g - ref| / (2^-7 (|ref| +
    RMS(ref)))``, the largest normwise ``||g - ref|| / ||ref||``, and how
    many tensors are bit-identical."""
    per_elem, normwise, equal = 0.0, 0.0, 0
    for name, p in model.named_parameters():
        want = ref[name].to(p.device)
        got = p.grad.float()
        err = (got - want).abs()
        rms = want.square().mean().sqrt()
        per_elem = max(per_elem, (err / (2 ** -7 * (want.abs() + rms))
                                  .clamp_min(1e-38)).max().item())
        normwise = max(normwise, (err.norm() / want.norm()).item())
        equal += int(torch.equal(got, want))
        del want, got, err
    return per_elem, normwise, equal


def context_worker(out_dir):
    """One rank of the ``context`` phase; writes ``rank<r>.json``."""
    import torch
    import torch.distributed as dist
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.models import llama as hvd_llama
    from horovod_tpu_torch.ops import flash_attention as fa
    from horovod_tpu_torch.parallel import axis_size, create_mesh
    from horovod_tpu_torch.train import (create_train_state,
                                         make_gspmd_train_step,
                                         next_token_loss, shard_tokens)
    torch.backends.cuda.matmul.allow_tf32 = False
    hvd.init()
    rank, n = hvd.rank(), hvd.size()
    layouts = [{"sp": n}] + ([{"dp": 2, "sp": n // 2}] if n >= 4 else [])
    runs = []
    for axes in layouts:
        mesh = create_mesh(axes)
        dp, sp = axis_size(mesh, "dp"), axis_size(mesh, "sp")
        for impl in ("ring", "ulysses"):
            cfg = dataclasses.replace(hvd_llama.llama3_8b(), n_layers=2,
                                      use_flash=True, attention_impl=impl)
            T = cfg.max_seq_len
            gen = torch.Generator(device="cuda").manual_seed(0)
            tokens = torch.randint(0, cfg.vocab_size, (dp, T),
                                   generator=gen, device="cuda")
            model = hvd_llama.Llama(cfg, seed=0)
            res = {"axes": axes, "impl": impl, "dp": dp, "sp": sp,
                   "sp_index": mesh.axis("sp").index, "T": T,
                   "n_layers": cfg.n_layers}
            ref = None
            if rank == 0:
                # The dense model on the whole batch: no ambient mesh, so
                # attention is B1-B3 over all T; no optimizer hooks yet.
                dense = next_token_loss(model(tokens), tokens)
                dense.backward()
                res["dense_loss"] = dense.item()
                ref = host_grads(model)
                model.zero_grad(set_to_none=True)
            opt = hvd.DistributedOptimizer(
                torch.optim.AdamW(model.parameters(), lr=1e-4,
                                  weight_decay=1e-4),
                named_parameters=model.named_parameters())
            state = create_train_state(model, opt)
            step = make_gspmd_train_step(model, opt, mesh)
            shard = shard_tokens(tokens, mesh)
            synchronize = opt.synchronize

            def check_first_step():
                """The first step's reduced gradient against the dense
                model's, before the update."""
                synchronize()
                if ref is not None and "grad" not in res:
                    res["grad"] = grad_gaps(torch, model, ref)

            opt.synchronize = check_first_step
            torch.cuda.reset_peak_memory_stats()
            losses, times, launches = [], [], []
            for i in range(4):
                fa.reset_launch_counts()
                torch.cuda.synchronize()
                with (torch.profiler.profile(activities=[
                        torch.profiler.ProfilerActivity.CPU,
                        torch.profiler.ProfilerActivity.CUDA])
                      if i == 3 and rank == n - 1
                      else contextlib.nullcontext()) as prof:
                    t = time.perf_counter()
                    state, loss = step(state, shard)
                    losses.append(loss.item())
                    times.append(time.perf_counter() - t)
                launches.append({k: f.launches
                                 for k, f in fa.KERNELS.items()})
            if rank == n - 1:
                res["profile"] = device_breakdown(prof, times[-1],
                                                  MODEL_GROUPS)
            differ = 0
            for p in model.parameters():
                buf = p.detach().clone()
                dist.broadcast(buf, 0)
                differ += int(not torch.equal(buf, p))
            res.update(losses=losses, times=times, launches=launches,
                       params_differing_from_rank0=differ,
                       peak_gb=torch.cuda.max_memory_allocated() / 1e9)
            runs.append(res)
            del (state, step, opt, model, ref, shard, synchronize,
                 check_first_step, buf, prof)
            gc.collect()
            torch.cuda.empty_cache()
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump({"rank": rank, "size": n, "runs": runs}, f)
    hvd.shutdown()
    return 0


def context_phase(torch, card):
    """The ``context`` phase (module doc). Returns rank 0's launches of
    B1-B3 over its checked steps, or zeros on one card."""
    zeros = dict.fromkeys(["fa_fwd", "fa_bwd_dq", "fa_bwd_dkv"], 0)
    cards = torch.cuda.device_count()
    if cards < 2:
        log("context", "one card: context parallelism shards the sequence "
                       "over an sp axis of 2 or more ranks; on one card "
                       "the phase runs nothing")
        return zeros
    total = dict(zeros)
    for n in world_sizes("context", cards):
        env = ({"CUDA_VISIBLE_DEVICES": ",".join(map(str, range(n)))}
               if n < cards else None)
        ranks = run_world("context", n, env)
        for res in ranks:
            for run in res["runs"]:
                what = (f"{n} ranks, {run['axes']}, {run['impl']}, rank "
                        f"{res['rank']}")
                b1 = (2 * (run["sp_index"] + 1) * run["n_layers"]
                      if run["impl"] == "ring" else 0)
                want = {"fa_fwd": b1, "fa_bwd_dq": 0, "fa_bwd_dkv": 0}
                if run["launches"] != [want] * len(run["launches"]):
                    raise AssertionError(f"{what}: B1-B3 launches per step "
                                         f"{run['launches']}, expected "
                                         f"{want}")
                if not all(math.isfinite(x) for x in run["losses"]):
                    raise AssertionError(f"{what}: non-finite loss "
                                         f"{run['losses']}")
                if run["params_differing_from_rank0"]:
                    raise AssertionError(
                        f"{what}: {run['params_differing_from_rank0']} "
                        "parameters differ from rank 0's")
        for i, run in enumerate(ranks[0]["runs"]):
            what = f"{n} ranks, {run['axes']}, {run['impl']}"
            rel = abs(run["losses"][0] - run["dense_loss"]) / run["dense_loss"]
            per_elem, normwise, equal = run["grad"]
            if not rel <= CP_LOSS_RTOL:
                raise AssertionError(f"{what}: first loss {run['losses'][0]}"
                                     f" vs dense {run['dense_loss']}")
            if not normwise <= CP_GRAD_NORMWISE:
                raise AssertionError(f"{what}: gradient off the dense "
                                     f"model's by {normwise:.4f} normwise")
            timed = sorted(run["times"][1:-1])
            step_s = timed[len(timed) // 2]
            b1 = [r["runs"][i]["launches"][0]["fa_fwd"] for r in ranks]
            log("context", f"{what} over NCCL, llama3_8b width, 2 layers, "
                           f"T = {run['T']} ({run['T'] // run['sp']} a "
                           f"rank), remat dots, AdamW: losses "
                           f"{run['losses']}; first vs the dense model "
                           f"{run['dense_loss']:.6f} (rel {rel:.2e}, gate "
                           f"{CP_LOSS_RTOL}); step-1 gradient vs dense: "
                           f"normwise {normwise:.2e} (gate 2^-4), per "
                           f"element {per_elem:.3f} of 2^-7 (|ref| + RMS), "
                           f"{equal} tensors bit-equal; step "
                           f"{step_s * 1e3:.1f} ms (first "
                           f"{run['times'][0] * 1e3:.1f} ms); "
                           f"{run['dp'] * run['T'] / n / step_s:.0f} "
                           f"tokens/s/GPU; B1 per step by rank {b1}; "
                           f"parameters bit-identical on every rank; peak "
                           f"{run['peak_gb']:.1f} GB; on {card}")
            log("context", f"{what}, rank {n - 1} (the last on sp), step 4 "
                           f"under torch.profiler: "
                           f"{ranks[-1]['runs'][i]['profile']}")
            for k in total:
                total[k] += sum(x[k] for x in run["launches"])
    return total


def long_case(fa, torch, *, B, T, H, D, causal, backward, seed):
    """B1 (and with ``backward`` B2 and B3) at a long-context shape in bf16
    against the plain versions, which run 8 heads at a time to bound their
    [T, T] f32 scores; returns the worst error of each kernel and the ms of
    each, its plain version and SDPA."""
    import torch.nn.functional as F
    gen = torch.Generator(device="cuda").manual_seed(seed)
    mk = lambda: torch.randn((B, T, H, D), generator=gen, device="cuda",
                             dtype=torch.bfloat16)
    q, k, v, do = mk(), mk(), mk(), mk()
    kw = dict(causal=causal, scale=D ** -0.5)
    heads = [slice(h, h + 8) for h in range(0, H, 8)]

    def plain(fn, *args, dims):
        parts = [fn(*(a[:, h] if a.dim() == 3 else a[:, :, h]
                      for a in args), **kw) for h in heads]
        if isinstance(parts[0], tuple):
            return tuple(torch.cat(p, dim=d) for p, d in zip(zip(*parts),
                                                             dims))
        return torch.cat(parts, dim=dims[0])

    worst = lambda *pairs: max(pairs, key=lambda p: p[1])
    o, m, l = fa.fa_fwd(q, k, v, **kw)
    ro, rm, rl = plain(fa._reference_partial, q, k, v, dims=(2, 1, 1))
    errs = {"fa_fwd": worst(check("B1 o", o, ro, "bf16"),
                            check("B1 m", m, rm, "f32"),
                            check("B1 l", l, rl, "f32"))}
    del ro, rm, rl
    ms = {"fa_fwd": (time_ms(lambda: fa.fa_fwd(q, k, v, **kw), 10),
                     time_ms(lambda: plain(fa._reference_partial, q, k, v,
                                           dims=(2, 1, 1)), 1))}
    qt, kt, vt = (t.transpose(1, 2).contiguous().requires_grad_()
                  for t in (q, k, v))
    sdpa = lambda: F.scaled_dot_product_attention(
        qt, kt, vt, is_causal=causal, scale=kw["scale"])
    with torch.no_grad():
        library = {"fa_fwd": time_ms(sdpa)}
    if backward:
        dsum = fa._row_dsum(do, o)
        args = (q, k, v, do, m, l, dsum)
        dq = fa.fa_bwd_dq(*args, **kw)
        errs["fa_bwd_dq"] = check("B2 dq", dq, plain(fa._plain_bwd_dq, *args,
                                                      dims=(2,)), "bf16")
        dk, dv = fa.fa_bwd_dkv(*args, **kw)
        rdk, rdv = plain(fa._plain_bwd_dkv, *args, dims=(2, 2))
        errs["fa_bwd_dkv"] = worst(check("B3 dk", dk, rdk, "bf16"),
                                   check("B3 dv", dv, rdv, "bf16"))
        del dq, dk, dv, rdk, rdv
        ms["fa_bwd_dq"] = (time_ms(lambda: fa.fa_bwd_dq(*args, **kw), 10),
                           time_ms(lambda: plain(fa._plain_bwd_dq, *args,
                                                 dims=(2,)), 1))
        ms["fa_bwd_dkv"] = (time_ms(lambda: fa.fa_bwd_dkv(*args, **kw), 10),
                            time_ms(lambda: plain(fa._plain_bwd_dkv, *args,
                                                  dims=(2, 2)), 1))
        out = sdpa()
        dot = do.transpose(1, 2).contiguous()
        library["fa_bwd_dq"] = library["fa_bwd_dkv"] = time_ms(
            lambda: torch.autograd.grad(out, (qt, kt, vt), dot,
                                        retain_graph=True))
    torch.cuda.synchronize()
    return errs, ms, library


def longctx_phase(torch, card, fmt):
    """The ``longctx`` phase (module doc). Returns the launches of B1-B3
    over every arm's steps."""
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.models import llama as hvd_llama
    from horovod_tpu_torch.ops import flash_attention as fa
    from horovod_tpu_torch.train import (create_train_state,
                                         make_train_step, next_token_loss)
    hvd.init()
    base = dataclasses.replace(hvd_llama.llama3_8b(), n_layers=2,
                               use_flash=True)
    T, layers, n_steps = base.max_seq_len, base.n_layers, 4
    gen = torch.Generator(device="cuda").manual_seed(0)
    tokens = torch.randint(0, base.vocab_size, (1, T), generator=gen,
                           device="cuda")
    ref, peaks, total = None, {}, dict.fromkeys(fa.KERNELS, 0)
    for arm in ARMS:
        cfg = hvd_llama.with_remat_policy(base, arm)
        model = hvd_llama.Llama(cfg, seed=0)
        next_token_loss(model(tokens), tokens).backward()
        if ref is None:
            ref, gaps = host_grads(model), (0.0, 0.0, None)
        else:
            gaps = grad_gaps(torch, model, ref)
            if not gaps[0] <= 1.0:
                raise AssertionError(f"longctx {arm}: gradient off the none "
                                     f"arm's by {gaps[0]:.3f} of 2^-7 "
                                     "(|ref| + RMS(ref))")
        model.zero_grad(set_to_none=True)
        opt = hvd.DistributedOptimizer(
            torch.optim.AdamW(model.parameters(), lr=1e-4,
                              weight_decay=1e-4),
            named_parameters=model.named_parameters())
        state = create_train_state(model, opt)
        step = make_train_step(model, opt, next_token_loss)
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        fa.reset_launch_counts()
        state, losses, times, prof = run_steps(torch, step, state, tokens,
                                               tokens, n_steps)
        launches = {k: f.launches for k, f in fa.KERNELS.items()}
        peaks[arm] = torch.cuda.max_memory_allocated()
        want = {"fa_fwd": B1_PER_LAYER[arm] * layers * n_steps,
                "fa_bwd_dq": layers * n_steps, "fa_bwd_dkv": layers * n_steps}
        if launches != want:
            raise AssertionError(f"longctx {arm}: launches {launches} in "
                                 f"{n_steps} steps, expected {want}")
        if not all(math.isfinite(x) for x in losses):
            raise AssertionError(f"longctx {arm}: non-finite loss {losses}")
        for k in total:
            total[k] += launches[k]
        timed = sorted(times[1:-1])
        step_s = timed[len(timed) // 2]
        grad = ("the reference" if gaps[2] is None else
                f"vs none: per element {gaps[0]:.3f} of 2^-7 (|ref| + RMS), "
                f"normwise {gaps[1]:.2e}, {gaps[2]} tensors bit-equal")
        log("longctx", f"remat {arm}: llama3_8b width, 2 layers, 1 x {T} "
                       f"tokens, AdamW: losses {losses}; step "
                       f"{step_s * 1e3:.1f} ms (first "
                       f"{times[0] * 1e3:.1f} ms); {T / step_s:.0f} "
                       f"tokens/s/GPU; peak {peaks[arm] / 1e9:.2f} GB; "
                       f"launches per step "
                       f"{ {k: v // n_steps for k, v in launches.items()} }; "
                       f"gradient {grad}; on {card}")
        log("longctx", f"remat {arm}, step {n_steps} under torch.profiler, "
                       f"{times[-1] * 1e3:.1f} ms on the host clock: "
                       f"{device_breakdown(prof, times[-1], MODEL_GROUPS)}")
        del state, step, opt, model, prof
        gc.collect()
        torch.cuda.empty_cache()
    if not (peaks["none"] >= peaks["dots_attn"] >= peaks["dots"]
            > peaks["full"]):
        raise AssertionError(f"longctx: peak bytes by arm {peaks}, expected "
                             "none >= dots_attn >= dots > full")
    hvd.shutdown()
    del ref
    gc.collect()
    torch.cuda.empty_cache()
    cases = [(T, True, True)] + [(T // n, c, False) for n in (2, 4)
                                 for c in (True, False)]
    for t, causal, backward in cases:
        errs, ms, library = long_case(fa, torch, B=1, T=t, H=32, D=128,
                                      causal=causal, backward=backward,
                                      seed=t + causal)
        gc.collect()
        torch.cuda.empty_cache()
        for name, (err, ratio) in errs.items():
            bnd = bound(name, 1, 32, t, t, 128, causal, 2)
            tflops = fa_flops(name, 1, 32, t, t, 128, causal) / (
                ms[name][0] * 1e-3) / 1e12
            log("longctx-kernels", f"{name} at B=1, T={t}, H=32, D=128, "
                                   f"{'causal' if causal else 'not causal'}"
                                   f", bf16: max err {err:.2e}, err/tol "
                                   f"{ratio:.3f}; {ms[name][0]:.4f} ms, "
                                   f"{tflops:.1f} TFLOP/s, "
                                   f"{bnd[0] / ms[name][0]:.1%} of its "
                                   f"bound ({bnd[0]:.4f} ms by {bnd[1]}); "
                                   f"plain {ms[name][1]:.3f} ms; SDPA "
                                   f"{library[name]:.4f} ms; on {card}")
    return total


def run_steps(torch, step, state, batch, labels, n_steps):
    """``n_steps`` train steps, the last under ``torch.profiler``; returns
    the state, the losses, each step's host-clock seconds and the profile."""
    losses, times = [], []
    for i in range(n_steps):
        torch.cuda.synchronize()
        with (torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA])
              if i == n_steps - 1 else contextlib.nullcontext()) as prof:
            t = time.perf_counter()
            state, loss = step(state, batch, labels)
            losses.append(loss.item())
            times.append(time.perf_counter() - t)
    return state, losses, times, prof


def check_allreduces(launches, model, n_steps, itemsize=4):
    """One all-reduce per fusion bucket per step in a world of one, where
    the gradient buckets are the step's only all-reduces (the loss and the
    BatchNorm statistics are averaged only across more than one rank, and
    SyncBatchNorm syncs nothing)."""
    from horovod_tpu_torch.core.config import Config
    threshold = Config.from_env().fusion_threshold_bytes
    want = expected_buckets(model, threshold, itemsize)
    if launches != want * n_steps:
        raise AssertionError(
            f"{launches} all-reduces launched in {n_steps} steps, expected "
            f"{want} a step for HOROVOD_FUSION_THRESHOLD={threshold}")
    return want


def resnet_phase(torch, card):
    """The ``resnet`` phase (module doc)."""
    import torch.nn.functional as F
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.collectives.ops import allreduce_async_
    from horovod_tpu_torch.models.resnet import ResNet50
    from horovod_tpu_torch.train import (batch_stats, create_train_state,
                                         make_train_step)
    hvd.init()
    model = ResNet50(stem="space_to_depth", sync_batch_norm=True, seed=0)
    opt = hvd.DistributedOptimizer(
        torch.optim.SGD(model.parameters(), lr=0.1, momentum=0.9),
        named_parameters=model.named_parameters())
    state = create_train_state(model, opt)
    step = make_train_step(model, opt, F.cross_entropy)
    batch = 128
    gen = torch.Generator(device="cuda").manual_seed(0)
    images = torch.randn((batch, 224, 224, 3), generator=gen, device="cuda")
    labels = torch.randint(0, 1000, (batch,), generator=gen, device="cuda")
    before = [b.clone() for b in batch_stats(model)]
    torch.cuda.reset_peak_memory_stats()
    n_steps = 4
    allreduce_async_.launches = 0
    state, losses, times, prof = run_steps(torch, step, state, images,
                                           labels, n_steps)
    launches = allreduce_async_.launches
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"resnet: non-finite loss: {losses}")
    buckets = check_allreduces(launches, model, n_steps)
    stats = batch_stats(model)
    moved = sum(int(not torch.equal(a, b)) for a, b in zip(stats, before))
    if moved != len(stats) or not all(bool(b.isfinite().all())
                                      for b in stats):
        raise AssertionError(f"resnet: {moved} of {len(stats)} BatchNorm "
                             "running statistics moved, or one is not "
                             "finite")
    timed = times[1:-1]
    step_s = sorted(timed)[len(timed) // 2]
    log("resnet", f"ResNet-50 (space_to_depth stem, SyncBatchNorm, bf16, "
                  f"channels_last), images "
                  f"{' x '.join(map(str, images.shape))}, "
                  f"{hvd.size()} rank(s) over NCCL, SGD(0.1, momentum 0.9): "
                  f"losses {losses}; step {step_s * 1e3:.1f} ms (first "
                  f"{times[0] * 1e3:.1f} ms); {batch / step_s:.1f} "
                  f"images/s/GPU; {buckets} buckets, {launches} all-reduces "
                  f"launched; {len(stats)} BatchNorm statistics moved, "
                  f"finite; peak {peak_gb:.1f} GB; on {card}")
    log("resnet", f"step {n_steps} under torch.profiler, "
                  f"{times[-1] * 1e3:.1f} ms on the host clock: "
                  f"{device_breakdown(prof, times[-1], MODEL_GROUPS)}")
    hvd.shutdown()


def bert_batch(torch, vocab, B=8, T=512, seed=0):
    """Seeded tokens, the key-padding mask (row i holds 512 - 32 i real
    tokens) and MLM labels: 15 % of the real positions carry a token, every
    other position -1 (``benchmarks/bert.py``)."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    tokens = torch.randint(0, vocab, (B, T), generator=gen, device="cuda")
    lengths = torch.tensor([T - T // 16 * i for i in range(B)],
                           device="cuda")
    mask = torch.arange(T, device="cuda")[None, :] < lengths[:, None]
    raw = torch.randint(0, vocab, (B, T), generator=gen, device="cuda")
    picked = (torch.rand((B, T), generator=gen, device="cuda") < 0.15) & mask
    return tokens, mask, torch.where(picked, raw, -1), lengths.tolist()


def bert_phase(torch, card):
    """The ``bert`` phase (module doc)."""
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.collectives.ops import allreduce_async_
    from horovod_tpu_torch.models.bert import Bert, bert_large
    from horovod_tpu_torch.ops import flash_attention as fa
    from horovod_tpu_torch.train import (create_train_state,
                                         make_train_step, masked_label_loss)
    hvd.init()
    cfg = dataclasses.replace(bert_large(), remat=False)
    model = Bert(cfg, seed=0)
    opt = hvd.DistributedOptimizer(
        torch.optim.AdamW(model.parameters(), lr=1e-4, weight_decay=1e-4),
        named_parameters=model.named_parameters(),
        compression=hvd.Compression.bf16)
    state = create_train_state(model, opt)
    step = make_train_step(model, opt, masked_label_loss)
    tokens, mask, labels, lengths = bert_batch(torch, cfg.vocab_size)
    torch.cuda.reset_peak_memory_stats()
    n_steps = 4
    fa.reset_launch_counts()
    allreduce_async_.launches = 0
    state, losses, times, prof = run_steps(torch, step, state,
                                           (tokens, mask), labels, n_steps)
    launches = {name: fn.launches for name, fn in fa.KERNELS.items()}
    allreduces = allreduce_async_.launches
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"bert: non-finite loss: {losses}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"bert: loss did not fall: {losses}")
    for name, n in launches.items():
        if n != cfg.n_layers * n_steps:
            raise AssertionError(f"bert: {name} launched {n} times in "
                                 f"{n_steps} steps of a {cfg.n_layers}-layer "
                                 "model, expected once a layer a step")
    buckets = check_allreduces(allreduces, model, n_steps, itemsize=2)
    timed = times[1:-1]
    step_s = sorted(timed)[len(timed) // 2]
    n_tok = tokens.numel()
    log("bert", f"BERT-Large, {cfg.n_layers} layers, {tokens.shape[0]} x "
                f"{tokens.shape[1]} tokens, real lengths {lengths}, "
                f"{hvd.size()} rank(s) over NCCL, AdamW(1e-4), bf16 wire: "
                f"losses {losses}; step {step_s * 1e3:.1f} ms (first "
                f"{times[0] * 1e3:.1f} ms); {n_tok / step_s:.0f} "
                f"tokens/s/GPU; kernel launches {launches}; {buckets} "
                f"buckets, {allreduces} all-reduces launched; peak "
                f"{peak_gb:.1f} GB; on {card}")
    log("bert", f"step {n_steps} under torch.profiler, "
                f"{times[-1] * 1e3:.1f} ms on the host clock: "
                f"{device_breakdown(prof, times[-1], MODEL_GROUPS)}")
    hvd.shutdown()
    return launches


def bert_kernels_phase(torch, card, fmt):
    """The ``bert-kernels`` phase (module doc)."""
    from horovod_tpu_torch.ops import flash_attention as fa
    B, T, D = 8, 512, 64
    lengths = [T - T // 16 * i for i in range(B)]
    # all 16 heads, then the 8 a rank holds at tp 2 (bert-mp)
    for H in (16, 8):
        shape = dict(B=B, Tq=T, Tk=T, H=H, D=D, causal=False,
                     lengths=lengths, seed=3)
        errs, args, kw = kernel_case(fa, torch, dtype=torch.bfloat16,
                                     **shape)
        f32_errs, _, _ = kernel_case(fa, torch, dtype=torch.float32,
                                     **shape)
        log("bert-kernels", f"agree with plain at B={B}, T={T}, H={H}, "
                            f"D={D}, not causal, real lengths {lengths}: "
                            f"bf16 {fmt(errs)}; f32 {fmt(f32_errs)}")
        ms, library, sdpa = time_kernels(fa, torch, args, kw)
        backend = sdpa_backend(torch, *sdpa)
        for name in fa.KERNELS:
            bnd = bound(name, B, H, T, T, D, False, 2)
            tflops = fa_flops(name, B, H, T, T, D, False) / (
                ms[name][0] * 1e-3) / 1e12
            log("bert-kernels", f"{name} at H={H}: {ms[name][0]:.4f} ms, "
                                f"{tflops:.1f} TFLOP/s, "
                                f"{bnd[0] / ms[name][0]:.1%} of its bound "
                                f"({bnd[0]:.4f} ms by {bnd[1]}); plain "
                                f"{ms[name][1]:.3f} ms; SDPA with the mask "
                                f"{library[name]:.4f} ms; on {card}")
        log("bert-kernels", f"SDPA with an additive bf16 mask at H={H} runs"
                            f" {backend}")
        del args, kw, sdpa
        torch.cuda.empty_cache()


def crossover_phase(torch, card):
    """The ``crossover`` phase (module doc): the shortest T of the sweep
    from which flash stays faster."""
    from horovod_tpu_torch.models.bert import attention
    B, H, D = 8, 16, 64
    gen = torch.Generator(device="cuda").manual_seed(4)
    rows, faster = [], []
    for T in (128, 256, 512, 1024):
        mk = lambda: torch.randn((B, T, H, D), generator=gen, device="cuda",
                                 dtype=torch.bfloat16)
        q, k, v = (mk().requires_grad_() for _ in range(3))
        do = mk()
        mask = (torch.arange(T, device="cuda")[None, :]
                < torch.tensor([T - T // 16 * i for i in range(B)],
                               device="cuda")[:, None])
        t = {}
        for flash in (False, True):
            def run():
                o = attention(q, k, v, mask, use_flash=flash,
                              dtype=torch.bfloat16)
                torch.autograd.grad(o, (q, k, v), do)
            t[flash] = time_ms(run, 10)
        rows.append(f"T={T}: flash {t[True]:.3f} ms, materialised "
                    f"{t[False]:.3f} ms ({t[False] / t[True]:.2f}x)")
        faster.append((T, t[True] < t[False]))
    cross = next((T for i, (T, _) in enumerate(faster)
                  if all(f for _, f in faster[i:])), None)
    log("crossover", f"one BERT-Large layer's attention, forward + backward, "
                     f"B={B}, H={H}, D={D}, bf16, ragged mask: "
                     f"{'; '.join(rows)}; flash faster from T={cross}; on "
                     f"{card}")


#: The ``mixtral`` and ``mixtral-ep`` phases: Mixtral-8x7B's widths cut to
#: 2 layers, remat "dots" (the config's default), 2 x 2048 tokens a rank,
#: the router aux loss at the bench's weight.
MIXTRAL_B, MIXTRAL_T = 2, 2048
MIXTRAL_AUX = 0.02
#: B1, B2 and B3 launches a step of the 2-layer model under remat "dots":
#: B1's forward and its recompute, B2 and B3 once a layer.
MIXTRAL_LAUNCHES = {"fa_fwd": 4, "fa_bwd_dq": 2, "fa_bwd_dkv": 2}
#: Gates of the ``mixtral-ep`` phase against the whole model on each shard.
EP_LOSS_RTOL = 1e-3
EP_GRAD_NORMWISE = 2 ** -4
#: The MoE's own device time, by the CPU op that launched the kernels.
MOE_OPS = (("expert bmm", ("aten::bmm",)),
           ("routing and gathers", ("aten::sort", "aten::bincount",
                                    "aten::index", "aten::index_select",
                                    "aten::scatter_", "aten::cumsum",
                                    "aten::gather", "aten::one_hot",
                                    "aten::_softmax")),
           ("expert all-to-all", ("hvd::expert_alltoall",)))
#: The profiler range of ``MoEMLP.forward``.
MOE_SCOPE = "hvd::moe"


def moe_op_events(prof, groups=MOE_OPS):
    """The events of ``prof`` that run a named op of ``groups`` inside the
    MoE layers, with their group: under a ``MOE_SCOPE`` range (the forward
    and its recompute) or in the backward of an autograd node that an op
    in such a range made. An event belongs to the nearest of its ancestors
    that decides: a ``MOE_SCOPE`` range, a backward node (matched to its
    forward op by thread and sequence number), or an op that made a node
    outside the MoE (the embedding lookup, the loss's target gather, the
    attention a backward node recomputes). An op inside another named op
    counts once."""
    names = {n: g for g, ns in groups for n in ns}
    events = prof.events()

    def ancestors(e):
        p = e.cpu_parent
        while p is not None:
            yield p
            p = p.cpu_parent

    def key(e):  # a backward event carries its forward op's thread
        return (e.fwd_thread or e.thread, e.sequence_nr)

    moe = {key(e) for e in events if e.sequence_nr >= 0
           and any(a.name == MOE_SCOPE for a in ancestors(e))}

    def in_moe(e):
        for a in ancestors(e):
            if a.name == MOE_SCOPE:
                return True
            if (a.name.startswith("autograd::engine::evaluate_function")
                    or a.sequence_nr >= 0 and key(a) not in moe):
                return key(a) in moe
        return False

    return [(names[e.name], e) for e in events if e.name in names
            and not any(a.name in names for a in ancestors(e))
            and in_moe(e)]


def op_device_ms(prof, groups=MOE_OPS):
    """Device time of the kernels launched under the MoE's named CPU ops
    (and their children), by group (:func:`moe_op_events`)."""
    ms = dict.fromkeys([g for g, _ in groups], 0.0)
    for g, e in moe_op_events(prof, groups):
        ms[g] += e.device_time_total / 1e3
    return "; ".join(f"{g} {t:.2f} ms" for g, t in ms.items())


def mixtral_model(torch, mesh=None):
    """The phases' model and a seeded batch maker."""
    from horovod_tpu_torch.models import mixtral
    cfg = dataclasses.replace(mixtral.mixtral_8x7b(), n_layers=2,
                              use_flash=True)
    return cfg, mixtral.Mixtral(cfg, seed=0, mesh=mesh)


def mixtral_tokens(torch, cfg, rows, seed=0):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    return torch.randint(0, cfg.vocab_size, (rows, MIXTRAL_T), generator=gen,
                         device="cuda")


def moe_backward_twice(torch, model, tokens):
    """Block 0's MoE at the main path's shapes: its input from a forward of
    ``tokens``, then the router, dispatch, experts and combine, and the
    backward of a seeded cotangent, twice. Returns whether the routing plan
    and the gradients through the dispatch and the combine (the tokens', the
    expert buffers', the expert outputs' and the combine weights') came out
    bit-identical."""
    from horovod_tpu_torch.parallel import moe as pmoe
    moe = model.blocks[0].moe
    seen = {}
    hook = moe.register_forward_hook(
        lambda m, args, out: seen.setdefault("x", args[0].detach()))
    with torch.no_grad():
        model(tokens)
    hook.remove()
    x, c = seen["x"], moe.c
    B, T, D = x.shape
    C = max(1, int(c.capacity_factor * c.top_k * B * T / c.n_experts))
    gen = torch.Generator(device="cuda").manual_seed(1)
    cot = torch.randn(B * T, D, generator=gen, device="cuda")
    runs = []
    for _ in range(2):
        tok = x.reshape(B * T, D).clone().requires_grad_()
        r = pmoe.topk_router_sorted(moe.router(tok), c.n_experts, C, c.top_k)
        buf = pmoe.sorted_dispatch(tok, r, c.n_experts, C)
        out = moe.experts(buf)
        y = pmoe.sorted_combine(out, r, B * T)
        grads = torch.autograd.grad((y.float() * cot).sum(),
                                    [tok, buf, out, r.weight])
        runs.append([r.dest, r.slot_entry, *grads])
    return all(torch.equal(a, b) for a, b in zip(*runs))


def expert_tensors(model, opt):
    """Every expert bank tensor and its optimizer state tensors."""
    import torch
    from horovod_tpu_torch.optimizer import is_expert_param
    out = []
    for name, p in model.named_parameters():
        if is_expert_param(name):
            out.append((name, p))
            out += [(f"{name}/{k}", v) for k, v in sorted(opt.state[p].items())
                    if torch.is_tensor(v)]
    return out


def mixtral_phase(torch, card):
    """The ``mixtral`` phase (module doc). Returns the launches of B1-B3
    over its exact-AdamW steps."""
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.models.mixtral import router_load
    from horovod_tpu_torch.ops import flash_attention as fa
    from horovod_tpu_torch.optimizer import deferred_pair, is_expert_param
    from horovod_tpu_torch.parallel import create_mesh
    from horovod_tpu_torch.train import (create_gspmd_train_state,
                                         make_gspmd_deferred_train_step,
                                         make_gspmd_train_step,
                                         mesh_param_groups)
    hvd.init()
    mesh = create_mesh({"dp": 1})
    cfg, model = mixtral_model(torch)
    n_params = sum(p.numel() for p in model.parameters())
    tokens = mixtral_tokens(torch, cfg, MIXTRAL_B)
    if not moe_backward_twice(torch, model, tokens):
        raise AssertionError("two backward passes of the dispatch and "
                             "combine differ")
    model.zero_grad(set_to_none=True)
    opt = hvd.DistributedOptimizer(
        torch.optim.AdamW(mesh_param_groups(model, mesh), lr=1e-4,
                          weight_decay=1e-4),
        named_parameters=model.named_parameters())
    state = create_gspmd_train_state(model, opt, mesh)
    step = make_gspmd_train_step(model, opt, mesh, aux_weight=MIXTRAL_AUX)
    torch.cuda.reset_peak_memory_stats()
    losses, times, launches = [], [], []
    for i in range(4):
        fa.reset_launch_counts()
        torch.cuda.synchronize()
        with (torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA])
              if i == 3 else contextlib.nullcontext()) as prof:
            t = time.perf_counter()
            state, loss = step(state, tokens)
            losses.append(loss.item())
            times.append(time.perf_counter() - t)
        launches.append({k: f.launches for k, f in fa.KERNELS.items()})
    peak = torch.cuda.max_memory_allocated() / 1e9
    kept, dropped = router_load(model)
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"mixtral: non-finite loss {losses}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"mixtral: loss did not fall: {losses}")
    if launches != [MIXTRAL_LAUNCHES] * 4:
        raise AssertionError(f"mixtral: B1-B3 launches per step {launches},"
                             f" expected {MIXTRAL_LAUNCHES}")
    timed = sorted(times[1:-1])
    step_s = timed[len(timed) // 2]
    entries = cfg.top_k * MIXTRAL_B * MIXTRAL_T
    log("mixtral", f"mixtral_8x7b width, 2 layers ({n_params:,} "
                   f"parameters), 1 rank over NCCL, {MIXTRAL_B} x "
                   f"{MIXTRAL_T} tokens, remat dots, exact AdamW(1e-4), "
                   f"aux weight {MIXTRAL_AUX}: losses {losses}; step "
                   f"{step_s * 1e3:.1f} ms (first {times[0] * 1e3:.1f} ms)"
                   f"; {MIXTRAL_B * MIXTRAL_T / step_s:.0f} tokens/s/GPU; "
                   f"B1-B3 per step {launches[0]}; (token, choice) "
                   f"entries kept per expert over both layers {kept}, "
                   f"dropped {dropped} of {entries * cfg.n_layers} "
                   f"({dropped / (entries * cfg.n_layers):.2%}); dispatch "
                   f"and combine backward bit-identical twice; peak "
                   f"{peak:.1f} GB; on {card}")
    log("mixtral", f"step 4 under torch.profiler, {times[-1] * 1e3:.1f} ms "
                   f"on the host clock: "
                   f"{device_breakdown(prof, times[-1], MODEL_GROUPS)}")
    log("mixtral", f"step 4 by op: {op_device_ms(prof)}")
    total = {k: sum(x[k] for x in launches) for k in MIXTRAL_LAUNCHES}
    del state, step, opt, model, prof
    gc.collect()
    torch.cuda.empty_cache()

    # The deferred pair from the same weights: 3 skip steps, 1 apply, twice.
    cfg, model = mixtral_model(torch)
    pair = deferred_pair(1e-4, every=4)
    state = create_gspmd_train_state(model, pair.apply, mesh)
    step = make_gspmd_deferred_train_step(model, pair, mesh,
                                          aux_weight=MIXTRAL_AUX)
    opt = state.optimizer
    torch.cuda.reset_peak_memory_stats()
    dlosses, dtimes, snap = [], [], None
    for i in range(2 * pair.every):
        skip = (i + 1) % pair.every != 0
        if i % pair.every == 0:
            snap = [(n, t.detach().to("cpu", copy=True))
                    for n, t in expert_tensors(model, opt)]
        torch.cuda.synchronize()
        t = time.perf_counter()
        state, loss = step(state, tokens)
        dlosses.append(loss.item())
        dtimes.append(time.perf_counter() - t)
        experts = [p for n, p in model.named_parameters()
                   if is_expert_param(n)]
        if skip and any(p.grad is not None for p in experts):
            raise AssertionError(f"deferred step {i + 1}: an expert bank "
                                 "has a gradient on a skip step")
        if i % pair.every == pair.every - 2:
            now = expert_tensors(model, opt)
            if [n for n, _ in now] != [n for n, _ in snap] or not all(
                    torch.equal(a.to("cpu"), b)
                    for (_, a), (_, b) in zip(now, snap)):
                raise AssertionError(f"deferred steps {i - 1}-{i + 1}: the "
                                     "expert bank or its moments changed "
                                     "on a skip step")
        if not skip and torch.equal(experts[0].to("cpu"), snap[0][1]):
            raise AssertionError(f"deferred step {i + 1}: the apply step "
                                 "left the expert bank unchanged")
    del snap
    dpeak = torch.cuda.max_memory_allocated() / 1e9
    if not all(math.isfinite(x) for x in dlosses):
        raise AssertionError(f"mixtral deferred: non-finite loss {dlosses}")
    skips = sorted(t for i, t in enumerate(dtimes)
                   if (i + 1) % pair.every and i > 0)
    applies = [t for i, t in enumerate(dtimes) if (i + 1) % pair.every == 0]
    log("mixtral", f"deferred_pair(1e-4, every={pair.every}) from the same "
                   f"weights: losses {dlosses}; skip step "
                   f"{skips[len(skips) // 2] * 1e3:.1f} ms (median of "
                   f"{len(skips)}), apply steps "
                   f"{[round(t * 1e3, 1) for t in applies]} ms; expert "
                   f"banks without a gradient and, with their moments, "
                   f"bit-identical across each window's skip steps; peak "
                   f"{dpeak:.1f} GB; on {card}")
    hvd.shutdown()
    del state, step, opt, model, tokens
    gc.collect()
    torch.cuda.empty_cache()
    return total


def mixtral_ep_worker(out_dir):
    """One rank of the ``mixtral-ep`` phase; writes ``rank<r>.json``."""
    import torch
    import torch.distributed as dist
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.collectives import ops
    from horovod_tpu_torch.ops import flash_attention as fa
    from horovod_tpu_torch.optimizer import is_expert_param
    from horovod_tpu_torch.parallel import axis_size, create_mesh
    from horovod_tpu_torch.parallel import moe as pmoe
    from horovod_tpu_torch.train import (create_gspmd_train_state,
                                         make_gspmd_train_step,
                                         mesh_param_groups, next_token_loss,
                                         shard_tokens)
    torch.backends.cuda.matmul.allow_tf32 = False
    hvd.init()
    rank, n = hvd.rank(), hvd.size()
    layouts = [{"ep": n}] + ([{"dp": 2, "ep": n // 2}] if n >= 4 else [])
    runs = []
    for axes in layouts:
        mesh = create_mesh(axes)
        ep, e = axis_size(mesh, "ep"), mesh.axis("ep").index
        # The reference: the whole model (every expert, no mesh) on each
        # rank's shard in turn, losses and gradients averaged. Every rank
        # runs it, and keeps the dense gradients and its own experts'.
        cfg, whole = mixtral_model(torch)
        tokens = mixtral_tokens(torch, cfg, MIXTRAL_B * n)
        ref_losses = []
        for s in range(n):
            part = tokens[s * MIXTRAL_B:(s + 1) * MIXTRAL_B]
            loss = next_token_loss(whole(part), part) + MIXTRAL_AUX * \
                torch.stack(whole.sown_losses["router_aux"]).sum()
            (loss / n).backward()
            ref_losses.append(loss.item())
        lo, hi = e * cfg.n_experts // ep, (e + 1) * cfg.n_experts // ep
        ref = {name: (p.grad[lo:hi] if is_expert_param(name) else p.grad
                      ).to("cpu") for name, p in whole.named_parameters()}
        del whole, loss
        gc.collect()
        torch.cuda.empty_cache()

        cfg, model = mixtral_model(torch, mesh)
        opt = hvd.DistributedOptimizer(
            torch.optim.AdamW(mesh_param_groups(model, mesh), lr=1e-4,
                              weight_decay=1e-4),
            named_parameters=model.named_parameters())
        state = create_gspmd_train_state(model, opt, mesh)
        step = make_gspmd_train_step(model, opt, mesh,
                                     aux_weight=MIXTRAL_AUX)
        shard = shard_tokens(tokens, mesh)
        res = {"axes": axes, "ep": ep, "ep_index": e,
               "ref_loss": sum(ref_losses) / n, "n_layers": cfg.n_layers,
               "a2a_bytes": 0}
        synchronize = opt.synchronize

        def check_first_step():
            """The first step's reduced gradients against the reference,
            before the update."""
            synchronize()
            if "grad" not in res:
                res["grad"] = grad_gaps(torch, model, ref)

        opt.synchronize = check_first_step
        torch.cuda.reset_peak_memory_stats()
        losses, times, launches, a2a = [], [], [], []
        for i in range(4):
            fa.reset_launch_counts()
            pmoe.expert_alltoall.launches = 0
            torch.cuda.synchronize()
            with (torch.profiler.profile(activities=[
                    torch.profiler.ProfilerActivity.CPU,
                    torch.profiler.ProfilerActivity.CUDA])
                  if i == 3 and rank == n - 1
                  else contextlib.nullcontext()) as prof:
                t = time.perf_counter()
                state, loss = step(state, shard)
                losses.append(loss.item())
                times.append(time.perf_counter() - t)
            launches.append({k: f.launches for k, f in fa.KERNELS.items()})
            a2a.append(pmoe.expert_alltoall.launches)
        if rank == n - 1:
            res["profile"] = device_breakdown(prof, times[-1], MODEL_GROUPS)
            res["by_op"] = op_device_ms(prof)
        # an exchange moves this rank's [E, C, D] buffer in the compute dtype
        c = model.blocks[0].moe.c
        C = max(1, int(c.capacity_factor * c.top_k * shard.numel()
                       / c.n_experts))
        res["a2a_bytes"] = c.n_experts * C * c.dim * 2
        # replicas: dense parameters equal on every rank, each expert slice
        # across the ranks that hold it
        rs = pmoe.expert_replica_set(mesh)
        differ = 0
        for name, p in model.named_parameters():
            buf = p.detach().clone()
            if is_expert_param(name):
                ops.broadcast_(buf, rs.ranks[0], process_set=rs)
            else:
                dist.broadcast(buf, 0)
            differ += int(not torch.equal(buf, p))
        res.update(losses=losses, times=times, launches=launches,
                   alltoalls=a2a, params_differing=differ,
                   replica_set=list(rs.ranks),
                   peak_gb=torch.cuda.max_memory_allocated() / 1e9)
        runs.append(res)
        del (state, step, opt, model, ref, shard, synchronize,
             check_first_step, buf, prof, tokens)
        gc.collect()
        torch.cuda.empty_cache()
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump({"rank": rank, "size": n, "runs": runs}, f)
    hvd.shutdown()
    return 0


def mixtral_ep_phase(torch, card):
    """The ``mixtral-ep`` phase (module doc). Returns rank 0's launches of
    B1-B3 over its steps, or zeros on one card."""
    zeros = dict.fromkeys(MIXTRAL_LAUNCHES, 0)
    cards = torch.cuda.device_count()
    if cards < 2:
        log("mixtral-ep", "one card: expert parallelism shards the experts "
                          "over an ep axis of 2 or more ranks; on one card "
                          "the phase runs nothing")
        return zeros
    total = dict(zeros)
    for n in world_sizes("mixtral-ep", cards):
        env = ({"CUDA_VISIBLE_DEVICES": ",".join(map(str, range(n)))}
               if n < cards else None)
        ranks = run_world("mixtral-ep", n, env)
        for res in ranks:
            for run in res["runs"]:
                what = f"{n} ranks, {run['axes']}, rank {res['rank']}"
                if run["launches"] != [MIXTRAL_LAUNCHES] * 4:
                    raise AssertionError(f"{what}: B1-B3 launches per step "
                                         f"{run['launches']}, expected "
                                         f"{MIXTRAL_LAUNCHES}")
                if not all(math.isfinite(x) for x in run["losses"]):
                    raise AssertionError(f"{what}: non-finite loss "
                                         f"{run['losses']}")
                if run["params_differing"]:
                    raise AssertionError(
                        f"{what}: {run['params_differing']} parameters differ"
                        " from their replicas'")
                rel = abs(run["losses"][0] - run["ref_loss"]) / run["ref_loss"]
                if not rel <= EP_LOSS_RTOL:
                    raise AssertionError(f"{what}: first loss "
                                         f"{run['losses'][0]} vs the whole "
                                         f"model's {run['ref_loss']}")
                if not run["grad"][1] <= EP_GRAD_NORMWISE:
                    raise AssertionError(f"{what}: gradient off the whole "
                                         f"model's by {run['grad'][1]:.4f} "
                                         "normwise")
        for i, run in enumerate(ranks[0]["runs"]):
            what = f"{n} ranks, {run['axes']}"
            timed = sorted(run["times"][1:-1])
            step_s = timed[len(timed) // 2]
            worst = max(r["runs"][i]["grad"][1] for r in ranks)
            rel = abs(run["losses"][0] - run["ref_loss"]) / run["ref_loss"]
            log("mixtral-ep", f"{what} over NCCL, mixtral_8x7b width, 2 "
                              f"layers, {MIXTRAL_B} x {MIXTRAL_T} tokens a "
                              f"rank, remat dots, AdamW: losses "
                              f"{run['losses']}; first vs the whole model "
                              f"{run['ref_loss']:.6f} (rel {rel:.2e}, gate "
                              f"{EP_LOSS_RTOL}); step-1 gradients vs the "
                              f"whole model's, worst rank normwise "
                              f"{worst:.2e} (gate 2^-4), rank 0 per element "
                              f"{run['grad'][0]:.3f} of 2^-7 (|ref| + RMS); "
                              f"step {step_s * 1e3:.1f} ms (first "
                              f"{run['times'][0] * 1e3:.1f} ms); "
                              f"{MIXTRAL_B * MIXTRAL_T / step_s:.0f} "
                              f"tokens/s/GPU; {run['alltoalls'][1]} "
                              f"all-to-alls a step of "
                              f"{run['a2a_bytes'] / 1e6:.1f} MB a rank each "
                              f"({run['alltoalls'][1] * run['a2a_bytes'] / 1e6:.0f}"
                              f" MB a step); expert replica sets like "
                              f"{run['replica_set']}; replicas bit-identical"
                              f"; peak {run['peak_gb']:.1f} GB; on {card}")
            last = ranks[-1]["runs"][i]
            log("mixtral-ep", f"{what}, rank {n - 1}, step 4 under "
                              f"torch.profiler: {last['profile']}")
            log("mixtral-ep", f"{what}, rank {n - 1}, step 4 by op: "
                              f"{last['by_op']}")
            for k in total:
                total[k] += sum(x[k] for x in run["launches"])
    return total


#: The model-parallel phase's gates: the first loss against the whole
#: model's, relative, and each gathered gradient, normwise.
MP_LOSS_RTOL = 1e-3
MP_GRAD_NORMWISE = 2 ** -5
#: Tokens a data shard (rows x sequence) in the model-parallel phase.
MP_B, MP_T = 2, 2048
MP_PARITY_MESHES = {2: [{"fsdp": 2}, {"tp": 2}],
                    4: [{"fsdp": 4}, {"dp": 2, "tp": 2},
                        {"fsdp": 2, "tp": 2}, {"tp": 4}]}
MP_FULL_MESHES = [{"fsdp": 4}, {"fsdp": 2, "tp": 2}]


def mp_expected(axes, n_layers):
    """The collectives a step of the Llama implies under remat dots
    (``parallel/sharding.py``), per rank: each of a layer's 9 fsdp-sharded
    parameters (7 weights, 2 norm scales) gathered in the forward and again
    in the recompute, the final norm and the head once, each reduce-scattered
    once; over tp one all-reduce for the embedding, 2 a layer forward, 2
    backward, 1 a layer in the recompute (the all-reduce after ``w2`` ends
    the block, and the recompute stops once the saved tensors the backward
    needs are rebuilt: ``torch.utils.checkpoint``'s early stop), 1 before the
    head backward and 2 for the loss. B1 twice a layer (forward and
    recompute), B2 and B3 once."""
    L = n_layers
    fsdp, tp = axes.get("fsdp", 1) > 1, axes.get("tp", 1) > 1
    return ({"all_gather": (18 * L + 2) * fsdp,
             "reduce_scatter": (9 * L + 2) * fsdp,
             "tp_all_reduce": (5 * L + 4) * tp, "all_to_all": 0},
            {"fa_fwd": 2 * L, "fa_bwd_dq": L, "fa_bwd_dkv": L})


def model_flops(cfg, T):
    """Model FLOPs a token (no recompute): 6 x the parameters of the
    products (each layer's seven weights and the head) and the causal
    attention, 6 x layers x dim x T (half of 12 L d T)."""
    hd = cfg.dim // cfg.n_heads
    layer = (cfg.dim * (cfg.n_heads + 2 * cfg.n_kv_heads) * hd
             + cfg.n_heads * hd * cfg.dim + 3 * cfg.dim * cfg.hidden_dim)
    n = cfg.n_layers * layer + cfg.vocab_size * cfg.dim
    return 6 * n + 6 * cfg.n_layers * cfg.dim * T


def _mp_train(torch, hvd, mesh, cfg, tokens, n_steps, profile, first=None):
    """``n_steps`` GSPMD steps of the Llama ``cfg`` built under ``mesh``
    (seed 0), AdamW(1e-4) (:func:`_gspmd_steps`)."""
    from horovod_tpu_torch.models import llama as hvd_llama
    from horovod_tpu_torch.train import (create_gspmd_train_state,
                                         make_gspmd_train_step,
                                         mesh_param_groups, shard_tokens)
    model = hvd_llama.Llama(cfg, seed=0, mesh=mesh)
    opt = hvd.DistributedOptimizer(
        torch.optim.AdamW(mesh_param_groups(model, mesh), lr=1e-4,
                          weight_decay=1e-4),
        named_parameters=model.named_parameters())
    state = create_gspmd_train_state(model, opt, mesh)
    step = make_gspmd_train_step(model, opt, mesh)
    res = _gspmd_steps(torch, hvd, mesh, model, state, step,
                       shard_tokens(tokens, mesh), n_steps, profile, first)
    # the model, its optimizer and their cycles go before the next run
    del state, step, opt, model
    gc.collect()
    torch.cuda.empty_cache()
    return res


def model_parallel_worker(out_dir):
    """One rank of the ``model-parallel`` phase; writes ``rank<r>.json``."""
    import torch
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.models import llama as hvd_llama
    from horovod_tpu_torch.parallel import create_mesh, sharding
    from horovod_tpu_torch.train import vocab_parallel_nll
    torch.backends.cuda.matmul.allow_tf32 = False
    hvd.init()
    rank, n = hvd.rank(), hvd.size()
    runs = []
    for axes in MP_PARITY_MESHES[n]:
        t0 = time.perf_counter()
        mesh = create_mesh(axes)
        shards = axes.get("dp", 1) * axes.get("fsdp", 1)
        cfg = dataclasses.replace(hvd_llama.llama3_8b(), n_layers=2,
                                  use_flash=True)
        gen = torch.Generator(device="cuda").manual_seed(0)
        tokens = torch.randint(0, cfg.vocab_size, (MP_B * shards, MP_T),
                               generator=gen, device="cuda")
        # The whole model on this rank's card, over the global batch one
        # data shard at a time; keep this rank's block of each gradient.
        whole = hvd_llama.Llama(cfg, seed=0, mesh=None)
        places = {k: sharding.placement(mesh, hvd_llama.logical_names(k),
                                        p.shape)
                  for k, p in whole.named_parameters()}
        count = tokens.shape[0] * (MP_T - 1)
        ref_loss = 0.0
        for d in range(shards):
            rows = tokens[d * MP_B:(d + 1) * MP_B]
            nll = vocab_parallel_nll(whole(rows)[:, :-1], rows[:, 1:]).sum()
            (nll / count).backward()
            ref_loss += nll.item() / count
        ref = {k: places[k].block(p.grad).clone()
               for k, p in whole.named_parameters()}
        del whole, nll
        gc.collect()
        torch.cuda.empty_cache()

        res = _mp_train(torch, hvd, mesh, cfg, tokens, 1, False,
                        lambda m: _block_gaps(torch, m, ref, n))
        want_counts, want_launches = mp_expected(axes, cfg.n_layers)
        res.update(axes=axes, ref_loss=ref_loss, want_counts=want_counts,
                   want_launches=want_launches,
                   seconds=time.perf_counter() - t0)
        runs.append(res)
        del ref, places
        gc.collect()
        torch.cuda.empty_cache()
    full = []
    for axes in (MP_FULL_MESHES if n == 4 else []):
        t0 = time.perf_counter()
        mesh = create_mesh(axes)
        shards = axes.get("dp", 1) * axes.get("fsdp", 1)
        cfg = dataclasses.replace(hvd_llama.llama3_8b(), use_flash=True)
        gen = torch.Generator(device="cuda").manual_seed(1)
        tokens = torch.randint(0, cfg.vocab_size, (MP_B * shards, MP_T),
                               generator=gen, device="cuda")
        res = _mp_train(torch, hvd, mesh, cfg, tokens, 4, rank == 0)
        want_counts, want_launches = mp_expected(axes, cfg.n_layers)
        res.update(axes=axes, want_counts=want_counts,
                   want_launches=want_launches, shards=shards,
                   flops_per_token=model_flops(cfg, MP_T),
                   seconds=time.perf_counter() - t0)
        full.append(res)
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump({"rank": rank, "size": n, "runs": runs, "full": full}, f)
    hvd.shutdown()
    return 0


def _check_mp_run(what, run):
    """A run's per-step gates: B1-B3 launches, collectives (``want_counts``
    the same every step, or a list of each step's), finite losses, blocks
    bit-identical on their holders."""
    if run["launches"] != [run["want_launches"]] * len(run["launches"]):
        raise AssertionError(f"{what}: B1-B3 launches per step "
                             f"{run['launches']}, expected "
                             f"{run['want_launches']}")
    want = run["want_counts"]
    if run["counts"] != (want if isinstance(want, list)
                         else [want] * len(run["counts"])):
        raise AssertionError(f"{what}: collectives per step {run['counts']},"
                             f" expected {run['want_counts']}")
    if not all(math.isfinite(x) for x in run["losses"]):
        raise AssertionError(f"{what}: non-finite loss {run['losses']}")
    if run["params_differing"]:
        raise AssertionError(f"{what}: {run['params_differing']} blocks "
                             "differ from their first holder's")


def model_parallel_phase(torch, card):
    """The ``model-parallel`` phase (module doc). Returns rank 0's launches
    of B1-B3 over its parity steps, or zeros on one card."""
    total = dict.fromkeys(["fa_fwd", "fa_bwd_dq", "fa_bwd_dkv"], 0)
    cards = torch.cuda.device_count()
    if cards < 2:
        log("model-parallel", "one card: fsdp and tp split the model over "
                              "2 or more ranks; on one card the phase runs "
                              "nothing")
        return total
    for n in world_sizes("model-parallel", cards):
        t0 = time.perf_counter()
        env = ({"CUDA_VISIBLE_DEVICES": ",".join(map(str, range(n)))}
               if n < cards else None)
        ranks = run_world("model-parallel", n, env)
        for res in ranks:
            for run in res["runs"] + res["full"]:
                _check_mp_run(f"{n} ranks, {run['axes']}, rank "
                              f"{res['rank']}", run)
        for i, run in enumerate(ranks[0]["runs"]):
            what = f"{n} ranks, {run['axes']}, 2 layers"
            rel = abs(run["losses"][0] - run["ref_loss"]) / run["ref_loss"]
            worst, whole, _, _ = run["first"]
            if not rel <= MP_LOSS_RTOL:
                raise AssertionError(f"{what}: first loss {run['losses'][0]}"
                                     f" vs the whole model's "
                                     f"{run['ref_loss']}")
            if not worst <= MP_GRAD_NORMWISE:
                raise AssertionError(f"{what}: a gathered gradient is off "
                                     f"the whole model's by {worst:.4f} "
                                     "normwise")
            log("model-parallel", f"{what}, {MP_B} x {MP_T} tokens a data "
                                  f"shard, remat dots, AdamW(1e-4), one step"
                                  f": loss {run['losses'][0]:.6f} vs the "
                                  f"whole model's {run['ref_loss']:.6f} (rel"
                                  f" {rel:.2e}, gate {MP_LOSS_RTOL}); "
                                  f"gathered gradients vs the whole model's:"
                                  f" worst tensor {worst:.2e} normwise, all "
                                  f"{whole:.2e} (gate 2^-5); collectives "
                                  f"{run['counts'][0]}; B1-B3 "
                                  f"{run['launches'][0]}; blocks "
                                  f"bit-identical on their holders; peak "
                                  f"{run['peak_gb']:.1f} GB; "
                                  f"{run['seconds']:.1f} s; on {card}")
            for k in total:
                total[k] += run["launches"][0][k]
        for j, run in enumerate(ranks[0]["full"]):
            what = f"{n} ranks, {run['axes']}, llama3_8b, 32 layers"
            if not run["losses"][-1] < run["losses"][0]:
                raise AssertionError(f"{what}: loss did not fall: "
                                     f"{run['losses']}")
            timed = sorted(run["times"][1:-1])
            step_s = timed[len(timed) // 2]
            tokens = run["shards"] * MP_B * MP_T / n
            mfu = tokens * run["flops_per_token"] / step_s / H100_BF16_FLOPS
            peak = max(r["full"][j]["peak_gb"] for r in ranks)
            log("model-parallel", f"{what}, {MP_B} x {MP_T} tokens a data "
                                  f"shard, remat dots, AdamW(1e-4): losses "
                                  f"{run['losses']}; step "
                                  f"{step_s * 1e3:.1f} ms (first "
                                  f"{run['times'][0] * 1e3:.1f} ms, "
                                  f"profiled {run['times'][-1] * 1e3:.1f} "
                                  f"ms); {tokens / step_s:.0f} tokens/s/GPU;"
                                  f" MFU {mfu:.1%} of 989 TFLOP/s at "
                                  f"{run['flops_per_token'] / 1e9:.1f} "
                                  f"GFLOP a token; peak {peak:.1f} GB (worst"
                                  f" rank); collectives a step "
                                  f"{run['counts'][0]}; B1-B3 a step "
                                  f"{run['launches'][0]}; blocks "
                                  f"bit-identical on their holders; "
                                  f"{run['seconds']:.1f} s; on {card}")
            log("model-parallel", f"{what}, rank 0, step 4 under "
                                  f"torch.profiler: {run['profile']}")
        log("model-parallel", f"{n} ranks: {time.perf_counter() - t0:.1f} s")
    return total


#: The pipeline phase's microbatches, each [1, PP_T, dim].
PP_M, PP_T = 8, 2048


def _pp_stage(torch, cfg, seed):
    """One Llama block (stage), its dense weights drawn as the Llama draws
    them from a generator seeded with ``seed``."""
    from horovod_tpu_torch.models import llama as hvd_llama
    blk = hvd_llama.Block(cfg, "cuda")
    gen = torch.Generator(device="cuda").manual_seed(seed)
    with torch.no_grad():
        for mod in blk.modules():
            if isinstance(mod, hvd_llama.Dense):
                hvd_llama._lecun_normal_(mod.weight, gen)
    return blk


def pipeline_worker(out_dir):
    """One rank of the ``pipeline`` phase; writes ``rank<r>.json``."""
    import torch
    import torch.distributed as dist
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.models import llama as hvd_llama
    from horovod_tpu_torch.ops import flash_attention as fa
    from horovod_tpu_torch.optimizer import deferred_pair, optimizer_for
    from horovod_tpu_torch.parallel import create_mesh
    from horovod_tpu_torch.train import (create_pipeline_train_state,
                                         make_pipeline_train_step)
    torch.backends.cuda.matmul.allow_tf32 = False
    hvd.init()
    rank, n = hvd.rank(), hvd.size()
    cfg = dataclasses.replace(hvd_llama.llama3_8b(), use_flash=True,
                              remat=False)
    pos = torch.arange(PP_T, device="cuda")[None]
    stage_fn = lambda blk, x: blk(x, pos)
    mse = lambda y, t: (y.float() - t.float()).square().mean()
    cases = [("gpipe", None), ("1f1b", None)] + (
        [("gpipe", 2)] if n == 4 else [])
    runs = []
    for schedule, dp in cases:
        t0 = time.perf_counter()
        axes = {"pp": n} if dp is None else {"dp": dp, "pp": n // dp}
        mesh = create_mesh(axes)
        pp = mesh.axis("pp")
        dpi = mesh.axis("dp").index if dp else 0
        gen = torch.Generator(device="cuda").manual_seed(7)
        shape = ((dp or 1) * PP_M, 1, PP_T, cfg.dim)
        xs = torch.randn(shape, generator=gen, device="cuda",
                         dtype=cfg.dtype)
        ts = torch.randn(shape, generator=gen, device="cuda",
                         dtype=cfg.dtype)
        x, t = xs[dpi * PP_M:(dpi + 1) * PP_M], ts[dpi * PP_M:(dpi + 1) * PP_M]
        blk = _pp_stage(torch, cfg, 100 + pp.index)
        params = list(blk.parameters())
        # One stage's forward, and forward and backward, on one microbatch.
        with torch.no_grad():
            t_f = time_ms(lambda: stage_fn(blk, x[0]), 3)
        t_fb = time_ms(lambda: torch.autograd.grad(
            mse(stage_fn(blk, x[0]), t[0]), params), 3)
        opt = torch.optim.AdamW(params, lr=1e-4, weight_decay=1e-4)
        state = create_pipeline_train_state(blk, opt)
        step = make_pipeline_train_step(
            stage_fn, (lambda y, tt: mse(y, tt)), opt, mesh=mesh,
            schedule=schedule, dp_axis_name="dp" if dp else None)
        opt_step, kept = opt.step, []

        def keep_first(*a, **k):
            if not kept:
                kept.append(torch.cat([p.grad.reshape(-1).float()
                                       for p in params]))
            return opt_step(*a, **k)

        opt.step = keep_first
        losses, times, launches = [], [], []
        for _ in range(3):
            fa.reset_launch_counts()
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            state, loss = step(state, x, t)
            losses.append(loss.item())
            times.append(time.perf_counter() - t1)
            launches.append({k: f.launches for k, f in fa.KERNELS.items()})
        res = {"schedule": schedule, "dp": dp, "axes": axes, "n": pp.size,
               "losses": losses, "times": times, "launches": launches,
               "t_f": t_f, "t_fb": t_fb, "stage": pp.index}
        grads = kept.pop()
        every = ([torch.empty_like(grads) for _ in range(n)] if rank == 0
                 else None)
        dist.gather(grads, every, dst=0)
        del state, step, opt, blk, params, grads, keep_first, opt_step
        gc.collect()
        torch.cuda.empty_cache()
        if rank == 0:
            # The stages composed in sequence on this card, over every dp
            # shard's microbatches: the mean loss and its gradients.
            blocks = [_pp_stage(torch, cfg, 100 + s) for s in range(pp.size)]
            ref_loss = 0.0
            for mb in range(xs.shape[0]):
                h = xs[mb]
                for b in blocks:
                    h = stage_fn(b, h)
                lv = mse(h, ts[mb]) / xs.shape[0]
                lv.backward()
                ref_loss += lv.item()
            stage_of = [r // (dp or 1) for r in range(n)]  # pp-major grid
            gaps = []
            for r, g in enumerate(every):
                want = torch.cat([p.grad.reshape(-1).float()
                                  for p in blocks[stage_of[r]].parameters()])
                gaps.append(((g - want).norm() / want.norm()).item())
            res.update(ref_loss=ref_loss, grad_normwise=gaps)
            del blocks, every
            gc.collect()
            torch.cuda.empty_cache()
        res["seconds"] = time.perf_counter() - t0
        runs.append(res)
    pairs = []
    for schedule in (("gpipe", "1f1b") if n == 2 else ()):
        # pair= on {"pp": 2}: deferred_pair(every=2) naming each stage's
        # MLP, which skip steps must leave bit-unchanged, without a
        # gradient, and apply steps must move.
        t0 = time.perf_counter()
        mesh = create_mesh({"pp": n})
        pp = mesh.axis("pp")
        gen = torch.Generator(device="cuda").manual_seed(9)
        shape = (PP_M, 1, PP_T, cfg.dim)
        x = torch.randn(shape, generator=gen, device="cuda", dtype=cfg.dtype)
        t = torch.randn(shape, generator=gen, device="cuda", dtype=cfg.dtype)
        blk = _pp_stage(torch, cfg, 100 + pp.index)
        pair = deferred_pair(1e-4, every=2,
                             is_expert=lambda name: name.startswith("mlp."))
        opt = optimizer_for(pair.apply, blk.named_parameters())
        state = create_pipeline_train_state(blk, opt)
        step = make_pipeline_train_step(
            stage_fn, (lambda y, tt: mse(y, tt)), opt, mesh=mesh,
            schedule=schedule, pair=pair)
        mlp = list(blk.mlp.parameters())
        losses, times, launches, kept, moved = [], [], [], True, True
        for i in range(4):
            before = [p.detach().clone() for p in mlp]
            fa.reset_launch_counts()
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            state, loss = step(state, x, t)
            losses.append(loss.item())
            times.append(time.perf_counter() - t1)
            launches.append({k: f.launches for k, f in fa.KERNELS.items()})
            same = [p.grad is None and torch.equal(p, w)
                    for p, w in zip(mlp, before)]
            if (i + 1) % 2:
                kept &= all(same)
            else:
                moved &= not any(torch.equal(p, w)
                                 for p, w in zip(mlp, before))
        pairs.append({"schedule": schedule, "axes": {"pp": n},
                      "stage": pp.index, "n": pp.size, "losses": losses,
                      "times": times, "launches": launches,
                      "frozen_kept": kept, "applies_moved": moved,
                      "seconds": time.perf_counter() - t0})
        del state, step, opt, blk, mlp, before, x, t
        gc.collect()
        torch.cuda.empty_cache()
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump({"rank": rank, "size": n, "runs": runs, "pairs": pairs}, f)
    hvd.shutdown()
    return 0


def pipeline_phase(torch, card):
    """The ``pipeline`` phase (module doc). Returns rank 0's launches of
    B1-B3 over its steps, or zeros on one card."""
    total = dict.fromkeys(["fa_fwd", "fa_bwd_dq", "fa_bwd_dkv"], 0)
    cards = torch.cuda.device_count()
    if cards < 2:
        log("pipeline", "one card: a pipeline needs a pp axis of 2 or more "
                        "ranks; on one card the phase runs nothing")
        return total
    for n in world_sizes("pipeline", cards):
        t0 = time.perf_counter()
        env = ({"CUDA_VISIBLE_DEVICES": ",".join(map(str, range(n)))}
               if n < cards else None)
        ranks = run_world("pipeline", n, env)
        for i, run in enumerate(ranks[0]["runs"]):
            what = f"{n} ranks, {run['axes']}, {run['schedule']}"
            stages = run["n"]
            for r in ranks:
                rr = r["runs"][i]
                last = rr["stage"] == stages - 1
                b1 = PP_M if (run["schedule"] == "gpipe" or last) \
                    else 2 * PP_M
                want = {"fa_fwd": b1, "fa_bwd_dq": PP_M, "fa_bwd_dkv": PP_M}
                if rr["launches"] != [want] * 3:
                    raise AssertionError(f"{what}, rank {r['rank']}: B1-B3 "
                                         f"per step {rr['launches']}, "
                                         f"expected {want}")
                if not all(math.isfinite(x) for x in rr["losses"]):
                    raise AssertionError(f"{what}: non-finite loss "
                                         f"{rr['losses']}")
            rel = abs(run["losses"][0] - run["ref_loss"]) / run["ref_loss"]
            if not rel <= MP_LOSS_RTOL:
                raise AssertionError(f"{what}: loss {run['losses'][0]} vs "
                                     f"the sequential {run['ref_loss']}")
            if not max(run["grad_normwise"]) <= MP_GRAD_NORMWISE:
                raise AssertionError(f"{what}: stage gradients off the "
                                     f"sequential ones by "
                                     f"{run['grad_normwise']} normwise")
            step_ms = sorted(run["times"][1:])[0] * 1e3
            if run["schedule"] == "gpipe":
                busy = PP_M * run["t_fb"]
                theory = (stages - 1) / (PP_M + stages - 1)
            else:
                busy = PP_M * (run["t_f"] + run["t_fb"])
                theory = 2 * (stages - 1) / (PP_M + 2 * (stages - 1))
            log("pipeline", f"{what}, one llama3_8b block a stage, bf16, "
                            f"remat off, M = {PP_M} x [1, {PP_T}, 4096], "
                            f"AdamW(1e-4): losses {run['losses']}; first vs "
                            f"the blocks in sequence {run['ref_loss']:.6f} "
                            f"(rel {rel:.2e}, gate {MP_LOSS_RTOL}); stage "
                            f"gradients normwise by rank "
                            f"{[f'{g:.2e}' for g in run['grad_normwise']]} "
                            f"(gate 2^-5); step {step_ms:.1f} ms (first "
                            f"{run['times'][0] * 1e3:.1f}); one microbatch's"
                            f" stage forward {run['t_f']:.2f} ms, forward "
                            f"and backward {run['t_fb']:.2f} ms; measured "
                            f"bubble {1 - busy / step_ms:.1%} vs "
                            f"{theory:.1%} in theory; B1-B3 a step on rank "
                            f"0 {run['launches'][0]}; {run['seconds']:.1f} "
                            f"s; on {card}")
            for k in total:
                total[k] += run["launches"][0][k]
        for i, run in enumerate(ranks[0]["pairs"]):
            what = f"{n} ranks, {run['axes']}, {run['schedule']}, pair="
            for r in ranks:
                rr = r["pairs"][i]
                last = rr["stage"] == rr["n"] - 1
                b1 = PP_M if (run["schedule"] == "gpipe" or last) \
                    else 2 * PP_M
                want = {"fa_fwd": b1, "fa_bwd_dq": PP_M, "fa_bwd_dkv": PP_M}
                if rr["launches"] != [want] * 4:
                    raise AssertionError(f"{what}, rank {r['rank']}: B1-B3 "
                                         f"per step {rr['launches']}, "
                                         f"expected {want}")
                if not all(math.isfinite(x) for x in rr["losses"]):
                    raise AssertionError(f"{what}: non-finite loss "
                                         f"{rr['losses']}")
                if not (rr["frozen_kept"] and rr["applies_moved"]):
                    raise AssertionError(f"{what}, rank {r['rank']}: a skip "
                                         "step moved the MLP or gave it a "
                                         "gradient, or an apply step left "
                                         "it")
            log("pipeline", f"{what}deferred_pair(1e-4, every=2) naming each"
                            f" stage's MLP, 4 steps: losses {run['losses']};"
                            f" steps "
                            f"{[round(x * 1e3, 1) for x in run['times']]}"
                            f" ms (skip, apply, skip, apply); skip steps "
                            f"leave the MLP bit-unchanged with no gradient, "
                            f"apply steps move it; {run['seconds']:.1f} s; "
                            f"on {card}")
        log("pipeline", f"{n} ranks: {time.perf_counter() - t0:.1f} s")
    return total


def _block_gaps(torch, model, ref, n, zero=()):
    """Per gradient of ``model`` against ``ref`` (this rank's blocks of the
    whole model's gradients), its squared error and squared norm summed
    over the blocks, each block counted once (divided by its holders),
    summed over the world: the worst gathered gradient's normwise gap, all
    of them together, and the norm of the gradients named by a suffix in
    ``zero``, which are 0 in exact arithmetic (BERT's key bias: a bias
    added to every key adds the same to each score of a row, which the
    softmax cancels) and so have no relative gap; the first two leave them
    out."""
    import torch.distributed as dist
    from horovod_tpu_torch.parallel import sharding
    sums, zeros, names = [], [], []
    for k, p in model.named_parameters():
        place = sharding.placement_of(p)
        holders = n // math.prod(a.size for a in (place.axes if place
                                                  else ()) if a is not None)
        g, want = p.grad.float(), ref[k]
        if k.endswith(tuple(zero)):
            zeros.append(g.square().sum() / holders)
            continue
        sums += [(g - want).square().sum() / holders,
                 want.square().sum() / holders]
        names.append(k)
    sums = torch.stack(sums + (zeros or [g.new_zeros(())]))
    dist.all_reduce(sums)
    m = len(sums) - max(1, len(zeros))
    per = (sums[0:m:2] / sums[1:m:2]).sqrt()
    return [per.max().item(), (sums[0:m:2].sum()
                               / sums[1:m:2].sum()).sqrt().item(),
            sums[m:].sum().sqrt().item(), names[int(per.argmax())]]


def _blocks_differing(torch, hvd, mesh, model):
    """How many of ``model``'s blocks differ from their first holder's."""
    from horovod_tpu_torch.parallel import sharding
    differ = 0
    for p in model.parameters():
        rs = sharding.replica_set(mesh, sharding.holder_axes(p))
        buf = p.detach().clone()
        hvd.broadcast_(buf, rs.ranks[0] if rs is not None else 0,
                       process_set=rs)
        differ += int(not torch.equal(buf, p.detach()))
    return differ


def _gspmd_steps(torch, hvd, mesh, model, state, step, batch, n_steps,
                 profile, first=None, bank=(), every=None):
    """``n_steps`` of ``step`` on this rank's ``batch``, the last under
    ``torch.profiler`` when ``profile``; ``first(model)`` runs on the first
    step's reduced gradients before the update. With ``every`` (a deferred
    cadence), checks that each skip step leaves ``bank`` without a
    gradient and bit-unchanged and each apply step moves it. Returns the
    run's record."""
    from horovod_tpu_torch.ops import flash_attention as fa
    from horovod_tpu_torch.parallel import moe, sharding
    opt = state.optimizer
    synchronize, done = opt.synchronize, []

    def check_first_step():
        synchronize()
        if first is not None and not done:
            done.append(first(model))

    opt.synchronize = check_first_step
    torch.cuda.reset_peak_memory_stats()
    res = {"losses": [], "times": [], "launches": [], "counts": [],
           "skips_ok": True, "applies_moved": True}
    prof = None
    for i in range(n_steps):
        before = [p.detach().clone() for p in bank] if every else []
        fa.reset_launch_counts()
        sharding.reset_counts()
        moe.expert_alltoall.launches = 0
        torch.cuda.synchronize()
        with (torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA])
              if profile and i == n_steps - 1
              else contextlib.nullcontext()) as prof:
            t = time.perf_counter()
            state, loss = step(state, batch)
            res["losses"].append(loss.item())
            res["times"].append(time.perf_counter() - t)
        res["launches"].append({k: f.launches for k, f in fa.KERNELS.items()})
        res["counts"].append(dict(sharding.counts,
                                  all_to_all=moe.expert_alltoall.launches))
        if every and (i + 1) % every:
            res["skips_ok"] &= all(p.grad is None and torch.equal(p, w)
                                   for p, w in zip(bank, before))
        elif every:
            res["applies_moved"] &= all(not torch.equal(p, w)
                                        for p, w in zip(bank, before))
        del before
    res["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    if prof is not None:
        res["profile"] = device_breakdown(prof, res["times"][-1],
                                          MODEL_GROUPS)
    res["params_differing"] = _blocks_differing(torch, hvd, mesh, model)
    res["first"] = done[0] if done else None
    opt.synchronize = synchronize
    del state, step, opt, prof, synchronize, check_first_step
    gc.collect()
    torch.cuda.empty_cache()
    return res


def _step_rates(run, n, tokens_a_step, flops_per_token):
    """The median timed step (the first and the profiled last left out),
    tokens/s/GPU and MFU against ``H100_BF16_FLOPS``."""
    timed = sorted(run["times"][1:-1]) or sorted(run["times"])
    step_s = timed[len(timed) // 2]
    per_gpu = tokens_a_step / n / step_s
    return step_s, per_gpu, per_gpu * flops_per_token / H100_BF16_FLOPS


def _data_shards(axes):
    return math.prod(axes.get(a, 1) for a in ("dp", "fsdp", "ep"))


def _ref_blocks(model, grads):
    """This rank's block of each whole gradient in ``grads``, as ``model``
    (built under a mesh) holds its parameters."""
    from horovod_tpu_torch.parallel import sharding
    out = {}
    for k, p in model.named_parameters():
        place = sharding.placement_of(p)
        out[k] = (place.block(grads[k]) if place else grads[k]).clone()
    return out


#: The ``mixtral-mp`` phase: Mixtral-8x7B's widths at 6 of its 32 layers
#: on 4 cards (full depth, 46.7 B parameters, holds 747 GB of f32
#: parameters, gradients and AdamW moments: no layout of 4 cards fits it;
#: at 8 layers a rank ran out of its 80 GB in AdamW's foreach update, with
#: 67.6 GB allocated), 2 x 2048 tokens a data shard, remat "dots", aux
#: weight 0.02.
MMP_LAYERS = 6
MMP_PARITY_MESHES = {2: [{"fsdp": 2}, {"tp": 2}],
                     4: [{"fsdp": 2, "ep": 2}, {"ep": 2, "tp": 2}]}
MMP_FULL_MESHES = [{"fsdp": 2, "ep": 2}, {"ep": 2, "tp": 2}]
#: The deferred run's mesh and cadence.
MMP_DEFERRED, MMP_EVERY = {"fsdp": 2, "ep": 2}, 2


def mixtral_mp_expected(axes, n_layers, skip=False):
    """The collectives a step of the Mixtral implies under remat dots, per
    rank (``parallel/sharding.py``, ``parallel/moe.py``), derived as
    ``mp_expected`` derives the Llama's: each of a layer's 10 fsdp-sharded
    parameters (2 norm scales, 4 attention weights, the router, the 3
    banks) gathered in the forward and again in the recompute, the final
    norm and the head once, each reduce-scattered once (on a deferred skip
    step the 3 banks take no gradient: no reduce-scatter); the expert
    exchange 2 a layer forward and 2 backward (the policy saves its
    outputs, so the recompute does not exchange again); over tp one
    all-reduce for the embedding, 2 a layer forward (after ``wo`` and the
    experts' ``w2``), 2 backward (``copy_to_tp`` before ``wq``/``wk``/
    ``wv`` and before the experts' ``w1``/``w3``) and 2 in the recompute
    (the combine saves the experts' output, so the recompute runs through
    both), 1 before the head backward and 2 for the loss. B1 twice a
    layer (forward and recompute), B2 and B3 once."""
    L = n_layers
    fsdp, ep, tp = (axes.get(a, 1) > 1 for a in ("fsdp", "ep", "tp"))
    return ({"all_gather": (20 * L + 2) * fsdp,
             "reduce_scatter": ((7 if skip else 10) * L + 2) * fsdp,
             "tp_all_reduce": (6 * L + 4) * tp,
             "all_to_all": 4 * L * ep},
            {"fa_fwd": 2 * L, "fa_bwd_dq": L, "fa_bwd_dkv": L})


def mixtral_active_flops(cfg, T):
    """Model FLOPs a token by active parameters (no recompute, no capacity
    padding): 6 x (each layer's attention weights, its router and the
    top_k of its n_experts experts' three weights, and the head) plus the
    causal attention, 6 x layers x dim x T."""
    hd = cfg.dim // cfg.n_heads
    layer = (cfg.dim * (cfg.n_heads + 2 * cfg.n_kv_heads) * hd
             + cfg.n_heads * hd * cfg.dim + cfg.dim * cfg.n_experts
             + cfg.top_k * 3 * cfg.dim * cfg.hidden_dim)
    n = cfg.n_layers * layer + cfg.vocab_size * cfg.dim
    return 6 * n + 6 * cfg.n_layers * cfg.dim * T


@contextlib.contextmanager
def routing_plan(torch, model, mode, plan):
    """Within the block, each MoE layer of ``model`` (``i``, its index
    among them) routes through ``parallel.moe.topk_router_sorted`` as
    ``mode`` says: ``"record"`` keeps its top-k choices, ``[T, k]``, in
    ``plan[i]``; ``"compare"`` counts in ``plan["flips"][i]`` the tokens
    whose chosen experts differ from ``plan[i]``; ``"force"`` counts them
    too, then routes each token to ``plan[i]``'s experts, with the gates
    of its own router's probabilities there (the router's ``torch.sort``
    answers with the plan's order). A forced layer computes the recorded
    model's routing function on its own inputs: a split that moves a bf16
    rounding cannot flip a near-tied choice. Each call of a layer
    (remat's recompute too) reads and writes the same entry."""
    from horovod_tpu_torch.models import mixtral
    from horovod_tpu_torch.parallel import moe
    index = {id(m): i for i, m in enumerate(
        m for m in model.modules() if isinstance(m, mixtral.MoEMLP))}
    route, forward, layer = moe.topk_router_sorted, mixtral.MoEMLP.forward, []

    def moe_forward(self, x):
        layer.append(index[id(self)])
        try:
            return forward(self, x)
        finally:
            layer.pop()

    def router(logits, num_experts, capacity, top_k=2):
        i = layer[-1]
        with torch.no_grad():
            own = torch.sort(torch.softmax(logits.float(), dim=-1), dim=-1,
                             descending=True, stable=True)[1][:, :top_k]
        if mode == "record":
            plan[i] = own
            return route(logits, num_experts, capacity, top_k)
        want = plan[i]
        plan["flips"][i] = int((own.sort(-1)[0] != want.sort(-1)[0])
                               .any(-1).sum())
        if mode == "compare":
            return route(logits, num_experts, capacity, top_k)
        rest = torch.ones(want.shape[0], num_experts, dtype=torch.bool,
                          device=want.device).scatter_(1, want, False)
        order = torch.cat([want, torch.arange(
            num_experts, device=want.device).expand(want.shape[0], -1)[rest]
            .view(want.shape[0], -1)], 1)

        class Replayed:
            """``torch`` but for ``sort``, which gives the plan's order."""

            def __getattr__(self, name):
                return getattr(torch, name)

            def sort(self, probs, **_):
                return probs.gather(-1, order), order

        moe.torch = Replayed()
        try:
            return route(logits, num_experts, capacity, top_k)
        finally:
            moe.torch = torch

    moe.topk_router_sorted, mixtral.MoEMLP.forward = router, moe_forward
    try:
        yield plan
    finally:
        moe.topk_router_sorted, mixtral.MoEMLP.forward = route, forward


def mixtral_mp_worker(out_dir):
    """One rank of the ``mixtral-mp`` phase; writes ``rank<r>.json``."""
    import torch
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.models import mixtral
    from horovod_tpu_torch.optimizer import (deferred_pair, is_expert_param,
                                             moe_adamw)
    from horovod_tpu_torch.parallel import create_mesh
    from horovod_tpu_torch.train import (create_gspmd_train_state,
                                         make_gspmd_deferred_train_step,
                                         make_gspmd_train_step,
                                         mesh_param_groups, shard_tokens,
                                         vocab_parallel_nll)
    torch.backends.cuda.matmul.allow_tf32 = False
    hvd.init()
    rank, n = hvd.rank(), hvd.size()
    base = dataclasses.replace(mixtral.mixtral_8x7b(), use_flash=True)
    runs = []
    for axes in MMP_PARITY_MESHES[n]:
        t0 = time.perf_counter()
        mesh = create_mesh(axes)
        shards = _data_shards(axes)
        # No drops (capacity factor E / top_k) and no aux loss: each rank's
        # routing is then the whole model's on its tokens, if the router
        # sees the same input. bf16, the compute of the timed runs. Under
        # tp the router's input differs from the whole model's by the bf16
        # rounding of the tp partial sums, which flips near-tied top-2
        # choices, and a flipped token moves the router's gradient (0.17
        # normwise on {"tp": 2}): the tp cells replay the whole model's
        # plan (routing_plan). Every cell counts the tokens its own router
        # would route apart from the whole model's.
        cfg = dataclasses.replace(base, n_layers=2, capacity_factor=float(
            base.n_experts // base.top_k))
        gen = torch.Generator(device="cuda").manual_seed(0)
        tokens = torch.randint(0, cfg.vocab_size, (MP_B * shards, MP_T),
                               generator=gen, device="cuda")
        whole = mixtral.Mixtral(cfg, seed=0, mesh=None)
        count = tokens.shape[0] * (MP_T - 1)
        ref_loss, plans = 0.0, []
        for d in range(shards):
            rows = tokens[d * MP_B:(d + 1) * MP_B]
            with routing_plan(torch, whole, "record", {}) as plan:
                nll = vocab_parallel_nll(whole(rows)[:, :-1],
                                         rows[:, 1:]).sum()
                (nll / count).backward()
            plans.append(plan)
            ref_loss += nll.item() / count
        grads = {k: p.grad for k, p in whole.named_parameters()}
        del whole, nll
        gc.collect()
        torch.cuda.empty_cache()
        model = mixtral.Mixtral(cfg, seed=0, mesh=mesh)
        ref = _ref_blocks(model, grads)
        del grads
        gc.collect()
        torch.cuda.empty_cache()
        opt = hvd.DistributedOptimizer(
            torch.optim.AdamW(mesh_param_groups(model, mesh), lr=1e-4,
                              weight_decay=1e-4),
            named_parameters=model.named_parameters())
        state = create_gspmd_train_state(model, opt, mesh)
        step = make_gspmd_train_step(model, opt, mesh)
        batch = shard_tokens(tokens, mesh)
        # this rank's data shard: the whole model's plan for its rows
        d = next(d for d in range(shards)
                 if torch.equal(tokens[d * MP_B:(d + 1) * MP_B], batch))
        forced = "tp" in axes
        with routing_plan(torch, model, "force" if forced else "compare",
                          dict(plans[d], flips={})) as plan:
            res = _gspmd_steps(torch, hvd, mesh, model, state, step, batch,
                               1, False,
                               lambda m: _block_gaps(torch, m, ref, n))
        want_counts, want_launches = mixtral_mp_expected(axes, cfg.n_layers)
        res.update(axes=axes, ref_loss=ref_loss, want_counts=want_counts,
                   want_launches=want_launches, forced=forced,
                   flips=sum(plan["flips"].values()),
                   routed=cfg.n_layers * batch.numel(),
                   load=mixtral.router_load(model),
                   coords={a: mesh.axis(a).index for a in mesh.axis_names},
                   seconds=time.perf_counter() - t0)
        del plans, plan, batch
        runs.append(res)
        del state, step, opt, model, ref
        gc.collect()
        torch.cuda.empty_cache()
    full = []
    cases = ([(axes, None) for axes in MMP_FULL_MESHES]
             + [(MMP_DEFERRED, MMP_EVERY)]) if n == 4 else []
    for axes, every in cases:
        t0 = time.perf_counter()
        mesh = create_mesh(axes)
        shards = _data_shards(axes)
        cfg = dataclasses.replace(base, n_layers=MMP_LAYERS)
        gen = torch.Generator(device="cuda").manual_seed(1)
        tokens = torch.randint(0, cfg.vocab_size, (MP_B * shards, MP_T),
                               generator=gen, device="cuda")
        model = mixtral.Mixtral(cfg, seed=0, mesh=mesh)
        if every:
            pair = deferred_pair(1e-4, every=every)
            state = create_gspmd_train_state(model, pair.apply, mesh)
            step = make_gspmd_deferred_train_step(model, pair, mesh,
                                                  aux_weight=MIXTRAL_AUX)
        else:
            state = create_gspmd_train_state(model, moe_adamw(1e-4), mesh)
            step = make_gspmd_train_step(model, state.optimizer, mesh,
                                         aux_weight=MIXTRAL_AUX)
        bank = [p for k, p in model.named_parameters()
                if is_expert_param(k)]
        res = _gspmd_steps(torch, hvd, mesh, model, state, step,
                           shard_tokens(tokens, mesh), 4,
                           rank == 0 and not every, bank=bank, every=every)
        res.update(axes=axes, every=every, shards=shards,
                   n_layers=cfg.n_layers,
                   want_counts=[mixtral_mp_expected(
                       axes, cfg.n_layers, every and (i + 1) % every)[0]
                       for i in range(4)],
                   want_launches=mixtral_mp_expected(axes,
                                                     cfg.n_layers)[1],
                   flops_per_token=mixtral_active_flops(cfg, MP_T),
                   load=mixtral.router_load(model),
                   coords={a: mesh.axis(a).index for a in mesh.axis_names},
                   seconds=time.perf_counter() - t0)
        full.append(res)
        del state, step, model, bank
        gc.collect()
        torch.cuda.empty_cache()
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump({"rank": rank, "size": n, "runs": runs, "full": full}, f)
    hvd.shutdown()
    return 0


def _tp_peers_route_alike(what, ranks, key, i):
    """The tp ranks of each row routed their (shared) tokens alike."""
    for r in ranks:
        run = r[key][i]
        if "tp" not in run["coords"]:
            continue
        for q in ranks:
            other = q[key][i]
            if all(other["coords"][a] == run["coords"][a]
                   for a in run["coords"] if a != "tp") \
                    and other["load"] != run["load"]:
                raise AssertionError(f"{what}: tp peers routed apart: "
                                     f"{run['load']} vs {other['load']}")


def mixtral_mp_phase(torch, card):
    """The ``mixtral-mp`` phase (module doc). Returns rank 0's launches of
    B1-B3 in the second step of its first full-width run (unprofiled; its
    counts set to 0 just before it), or over its parity steps where there
    is no full-width run (2 cards), or zeros on one card."""
    total = dict.fromkeys(["fa_fwd", "fa_bwd_dq", "fa_bwd_dkv"], 0)
    failed = []
    cards = torch.cuda.device_count()
    if cards < 2:
        log("mixtral-mp", "one card: fsdp, tp and ep split the model over 2 "
                          "or more ranks; on one card the phase runs "
                          "nothing")
        return total
    for n in world_sizes("mixtral-mp", cards):
        t0 = time.perf_counter()
        env = ({"CUDA_VISIBLE_DEVICES": ",".join(map(str, range(n)))}
               if n < cards else None)
        ranks = run_world("mixtral-mp", n, env)
        for res in ranks:
            for run in res["runs"]:
                _check_mp_run(f"{n} ranks, {run['axes']}, rank "
                              f"{res['rank']}", run)
            for run in res["full"]:
                what = (f"{n} ranks, {run['axes']}, every {run['every']}, "
                        f"rank {res['rank']}")
                _check_mp_run(what, run)
                if run["every"] and not (run["skips_ok"]
                                         and run["applies_moved"]):
                    raise AssertionError(f"{what}: a skip step moved or "
                                         "took a gradient for the bank, or "
                                         "an apply step left it")
        for i, run in enumerate(ranks[0]["runs"]):
            what = f"{n} ranks, {run['axes']}, 2 layers"
            _tp_peers_route_alike(what, ranks, "runs", i)
            rel = abs(run["losses"][0] - run["ref_loss"]) / run["ref_loss"]
            worst, whole, _, worst_name = run["first"]
            # every reading is printed before the phase fails
            if not rel <= MP_LOSS_RTOL:
                failed.append(f"{what}: first loss {run['losses'][0]} vs "
                              f"the whole model's {run['ref_loss']}")
            if not worst <= MP_GRAD_NORMWISE:
                failed.append(f"{what}: a gathered gradient is off the "
                              f"whole model's by {worst:.4f} normwise "
                              f"({worst_name})")
            # tokens x layers whose top-2 set left the whole model's, over
            # the data shards (a tp row shares its tokens: its first rank)
            rows = [r["runs"][i] for r in ranks
                    if r["runs"][i]["coords"].get("tp", 0) == 0]
            apart = (f"{sum(x['flips'] for x in rows)} of "
                     f"{sum(x['routed'] for x in rows)} token routings")
            routing = (f"the whole model's plan replayed ({apart} would "
                       f"have chosen apart)" if run["forced"] else
                       f"its own routing ({apart} chose apart from the "
                       f"whole model)")
            log("mixtral-mp", f"{what}, {MP_B} x {MP_T} tokens a data shard,"
                              f" bf16, no drops, no aux, remat dots, "
                              f"AdamW(1e-4), one step, {routing}: loss "
                              f"{run['losses'][0]:.6f} vs the "
                              f"whole model's {run['ref_loss']:.6f} (rel "
                              f"{rel:.2e}, gate {MP_LOSS_RTOL}); gathered "
                              f"gradients vs the whole model's: worst tensor"
                              f" {worst:.2e} normwise ({worst_name}), all "
                              f"{whole:.2e} (gate 2^-5); collectives "
                              f"{run['counts'][0]}; "
                              f"B1-B3 {run['launches'][0]}; blocks "
                              f"bit-identical on their holders; tp peers "
                              f"route alike; peak {run['peak_gb']:.1f} GB; "
                              f"{run['seconds']:.1f} s; on {card}")
            if not ranks[0]["full"]:
                for k in total:
                    total[k] += run["launches"][0][k]
        if ranks[0]["full"]:
            total = dict(ranks[0]["full"][0]["launches"][1])
        for j, run in enumerate(ranks[0]["full"]):
            what = (f"{n} ranks, {run['axes']}, mixtral_8x7b width, "
                    f"{run['n_layers']} of 32 layers")
            _tp_peers_route_alike(what, ranks, "full", j)
            peak = max(r["full"][j]["peak_gb"] for r in ranks)
            if run["every"]:
                skip = [t for i, t in enumerate(run["times"]) if i % 2 == 0]
                apply = [t for i, t in enumerate(run["times"]) if i % 2]
                log("mixtral-mp", f"{what}, deferred_pair(1e-4, every="
                                  f"{run['every']}), aux 0.02: losses "
                                  f"{run['losses']}; skip steps "
                                  f"{[round(t * 1e3, 1) for t in skip]} ms, "
                                  f"apply steps "
                                  f"{[round(t * 1e3, 1) for t in apply]} ms;"
                                  f" collectives a step {run['counts']}; "
                                  f"skip steps leave the bank bit-unchanged "
                                  f"with no gradient, apply steps move it; "
                                  f"peak {peak:.1f} GB (worst rank); "
                                  f"{run['seconds']:.1f} s; on {card}")
                continue
            if not run["losses"][-1] < run["losses"][0]:
                raise AssertionError(f"{what}: loss did not fall: "
                                     f"{run['losses']}")
            step_s, per_gpu, mfu = _step_rates(
                run, n, run["shards"] * MP_B * MP_T, run["flops_per_token"])
            log("mixtral-mp", f"{what}, {MP_B} x {MP_T} tokens a data shard,"
                              f" remat dots, aux 0.02, moe_adamw(adamw): "
                              f"losses {run['losses']}; step "
                              f"{step_s * 1e3:.1f} ms (first "
                              f"{run['times'][0] * 1e3:.1f} ms, profiled "
                              f"{run['times'][-1] * 1e3:.1f} ms); "
                              f"{per_gpu:.0f} tokens/s/GPU; MFU {mfu:.1%} of "
                              f"989 TFLOP/s by active parameters (top-2 of 8"
                              f" experts: mixtral_active_flops, "
                              f"{run['flops_per_token'] / 1e9:.2f} GFLOP a "
                              f"token); peak {peak:.1f} GB (worst rank); "
                              f"collectives a step {run['counts'][1]} "
                              f"(expected {run['want_counts'][1]}); B1-B3 a "
                              f"step "
                              f"{run['launches'][1]}; blocks bit-identical "
                              f"on their holders; tp peers route alike; "
                              f"{run['seconds']:.1f} s; on {card}")
            log("mixtral-mp", f"{what}, rank 0, step 4 under "
                              f"torch.profiler: {run['profile']}")
        log("mixtral-mp", f"{n} ranks: {time.perf_counter() - t0:.1f} s")
    if failed:
        raise AssertionError("; ".join(failed))
    return total


#: The ``bert-mp`` phase: BERT-Large (24 layers) with the masked-LM loss,
#: 8 x 512 tokens a data shard, 15 % of them masked, remat off (as phase
#: 10), AdamW(1e-4).
BMP_B, BMP_T = 8, 512
BMP_MESHES = {2: [{"tp": 2}, {"fsdp": 2}],
              4: [{"dp": 2, "tp": 2}, {"fsdp": 4}]}


def bert_mp_expected(axes, n_layers):
    """The collectives a step of BERT implies with remat off, per rank:
    over tp one all-reduce for the table, 4 a layer (after ``wo`` and
    ``ffn_out`` forward, ``copy_to_tp`` before ``wq``/``wk``/``wv`` and
    before ``ffn_in`` backward), 1 before the tied head's backward and 2
    for the loss; under fsdp each layer's 6 dense weights and
    ``mlm_transform``'s gathered once and reduce-scattered once (the
    tables, biases and LayerNorms are whole). B1, B2 and B3 once a
    layer."""
    L = n_layers
    fsdp, tp = axes.get("fsdp", 1) > 1, axes.get("tp", 1) > 1
    return ({"all_gather": (6 * L + 1) * fsdp,
             "reduce_scatter": (6 * L + 1) * fsdp,
             "tp_all_reduce": (4 * L + 4) * tp, "all_to_all": 0},
            {"fa_fwd": L, "fa_bwd_dq": L, "fa_bwd_dkv": L})


def bert_flops(cfg, T):
    """Model FLOPs a token: 6 x the parameters of the products (each
    layer's four attention weights and two FFN weights, ``mlm_transform``
    and the tied head) plus the bidirectional attention, 12 x layers x dim
    x T."""
    layer = 4 * cfg.dim * cfg.dim + 2 * cfg.dim * cfg.hidden_dim
    n = cfg.n_layers * layer + cfg.dim * cfg.dim + cfg.vocab_size * cfg.dim
    return 6 * n + 12 * cfg.n_layers * cfg.dim * T


def bert_mp_batch(torch, cfg, rows, seed):
    """Seeded tokens, MLM labels and a 15 % mask, ``[rows, BMP_T]``."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    shape = (rows, BMP_T)
    tokens = torch.randint(0, cfg.vocab_size, shape, generator=gen,
                           device="cuda")
    labels = torch.randint(0, cfg.vocab_size, shape, generator=gen,
                           device="cuda")
    mask = torch.rand(shape, generator=gen, device="cuda") < 0.15
    return tokens, labels, mask


def bert_mp_worker(out_dir):
    """One rank of the ``bert-mp`` phase; writes ``rank<r>.json``."""
    import torch
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.models.bert import Bert, bert_large
    from horovod_tpu_torch.parallel import create_mesh
    from horovod_tpu_torch.train import (create_gspmd_train_state,
                                         make_gspmd_train_step,
                                         mesh_param_groups, mlm_loss_sums,
                                         shard_tokens)
    torch.backends.cuda.matmul.allow_tf32 = False
    hvd.init()
    rank, n = hvd.rank(), hvd.size()
    base = dataclasses.replace(bert_large(), remat=False, use_flash=True)
    runs, full = [], []
    for axes in BMP_MESHES[n]:
        for layers in (2, base.n_layers):
            t0 = time.perf_counter()
            mesh = create_mesh(axes)
            shards = _data_shards(axes)
            cfg = dataclasses.replace(base, n_layers=layers)
            batch = bert_mp_batch(torch, cfg, BMP_B * shards, layers)
            ref, ref_loss = None, None
            if layers == 2:
                # The whole model over the global batch, one data shard at
                # a time, divided by the global masked count.
                whole = Bert(cfg, seed=0, mesh=None)
                count = batch[2].sum()
                ref_loss = 0.0
                for d in range(shards):
                    part = tuple(t[d * BMP_B:(d + 1) * BMP_B] for t in batch)
                    total, _ = mlm_loss_sums(whole(part[0]), part)
                    (total / count).backward()
                    ref_loss += (total / count).item()
                grads = {k: p.grad for k, p in whole.named_parameters()}
                del whole, total
            model = Bert(cfg, seed=0, mesh=mesh)
            if layers == 2:
                ref = _ref_blocks(model, grads)
                del grads
            gc.collect()
            torch.cuda.empty_cache()
            opt = hvd.DistributedOptimizer(
                torch.optim.AdamW(mesh_param_groups(model, mesh), lr=1e-4,
                                  weight_decay=1e-4),
                named_parameters=model.named_parameters())
            state = create_gspmd_train_state(model, opt, mesh)
            step = make_gspmd_train_step(model, opt, mesh,
                                         loss_fn=mlm_loss_sums)
            shard = tuple(shard_tokens(t, mesh) for t in batch)
            res = _gspmd_steps(
                torch, hvd, mesh, model, state, step, shard,
                1 if layers == 2 else 4, rank == 0 and layers > 2,
                (lambda m: _block_gaps(torch, m, ref, n, ("wk.bias",)))
                if ref else None)
            want_counts, want_launches = bert_mp_expected(axes, layers)
            res.update(axes=axes, ref_loss=ref_loss, shards=shards,
                       want_counts=want_counts, want_launches=want_launches,
                       flops_per_token=bert_flops(cfg, BMP_T),
                       n_layers=layers, seconds=time.perf_counter() - t0)
            (runs if layers == 2 else full).append(res)
            del state, step, opt, model, ref, shard, batch
            gc.collect()
            torch.cuda.empty_cache()
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump({"rank": rank, "size": n, "runs": runs, "full": full}, f)
    hvd.shutdown()
    return 0


def bert_mp_phase(torch, card):
    """The ``bert-mp`` phase (module doc). Returns rank 0's launches of
    B1-B3 in the second step of its first 24-layer run (unprofiled; its
    counts set to 0 just before it), or zeros on one card."""
    total = dict.fromkeys(["fa_fwd", "fa_bwd_dq", "fa_bwd_dkv"], 0)
    cards = torch.cuda.device_count()
    if cards < 2:
        log("bert-mp", "one card: fsdp and tp split the model over 2 or "
                       "more ranks; on one card the phase runs nothing")
        return total
    n = 4 if cards >= 4 else 2
    t0 = time.perf_counter()
    env = ({"CUDA_VISIBLE_DEVICES": ",".join(map(str, range(n)))}
           if n < cards else None)
    ranks = run_world("bert-mp", n, env)
    for res in ranks:
        for run in res["runs"] + res["full"]:
            _check_mp_run(f"{n} ranks, {run['axes']}, {run['n_layers']} "
                          f"layers, rank {res['rank']}", run)
    for i, run in enumerate(ranks[0]["runs"]):
        what = f"{n} ranks, {run['axes']}, BERT-Large widths, 2 layers"
        rel = abs(run["losses"][0] - run["ref_loss"]) / run["ref_loss"]
        worst, whole, key_bias, worst_name = run["first"]
        if not rel <= MP_LOSS_RTOL:
            raise AssertionError(f"{what}: first loss {run['losses'][0]} vs "
                                 f"the whole model's {run['ref_loss']}")
        if not worst <= MP_GRAD_NORMWISE:
            raise AssertionError(f"{what}: a gathered gradient is off the "
                                 f"whole model's by {worst:.4f} normwise "
                                 f"({worst_name})")
        log("bert-mp", f"{what}, {BMP_B} x {BMP_T} tokens a data shard, 15 %"
                       f" masked, MLM loss over the global count, AdamW(1e-4)"
                       f", one step: loss {run['losses'][0]:.6f} vs the whole"
                       f" model's {run['ref_loss']:.6f} (rel {rel:.2e}, gate "
                       f"{MP_LOSS_RTOL}); gathered gradients vs the whole "
                       f"model's: worst tensor {worst:.2e} normwise "
                       f"({worst_name}), all {whole:.2e} (gate 2^-5; the key "
                       f"biases, 0 in exact "
                       f"arithmetic, apart: norm {key_bias:.2e}); "
                       f"collectives "
                       f"{run['counts'][0]}; B1-B3 {run['launches'][0]}; "
                       f"blocks bit-identical on their holders; "
                       f"{run['seconds']:.1f} s; on {card}")
    total = dict(ranks[0]["full"][0]["launches"][1])
    for j, run in enumerate(ranks[0]["full"]):
        what = (f"{n} ranks, {run['axes']}, BERT-Large, {run['n_layers']} "
                f"layers")
        if not run["losses"][-1] < run["losses"][0]:
            raise AssertionError(f"{what}: loss did not fall: "
                                 f"{run['losses']}")
        step_s, per_gpu, mfu = _step_rates(
            run, n, run["shards"] * BMP_B * BMP_T, run["flops_per_token"])
        peak = max(r["full"][j]["peak_gb"] for r in ranks)
        log("bert-mp", f"{what}, {BMP_B} x {BMP_T} tokens a data shard, "
                       f"remat off, AdamW(1e-4): losses {run['losses']}; "
                       f"step {step_s * 1e3:.1f} ms (first "
                       f"{run['times'][0] * 1e3:.1f} ms, profiled "
                       f"{run['times'][-1] * 1e3:.1f} ms); {per_gpu:.0f} "
                       f"tokens/s/GPU; MFU {mfu:.1%} of 989 TFLOP/s at "
                       f"{run['flops_per_token'] / 1e9:.2f} GFLOP a token "
                       f"(bert_flops); peak {peak:.1f} GB (worst rank); "
                       f"collectives a step {run['counts'][0]}; B1-B3 a step"
                       f" {run['launches'][0]}; blocks bit-identical on "
                       f"their holders; {run['seconds']:.1f} s; on {card}")
        log("bert-mp", f"{what}, rank 0, step 4 under torch.profiler: "
                       f"{run['profile']}")
    log("bert-mp", f"{n} ranks: {time.perf_counter() - t0:.1f} s")
    return total


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.collectives.ops import allreduce_async_
    from horovod_tpu_torch.core.config import Config
    from horovod_tpu_torch.models import llama as hvd_llama
    from horovod_tpu_torch.ops import _build
    from horovod_tpu_torch.ops import flash_attention as fa
    from horovod_tpu_torch.ops import fused
    from horovod_tpu_torch.train import (create_train_state, make_train_step,
                                         next_token_loss)

    # Plain references in full f32 (no TF32), hopper-kernels guide §6.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = smi_line()
    kind = torch.cuda.get_device_name(0)
    log("device", f"{card} | torch {torch.__version__} cuda "
                  f"{torch.version.cuda} | count {torch.cuda.device_count()}")

    t0 = time.perf_counter()
    _build.build()
    log("build", f"{time.perf_counter() - t0:.1f} s "
                 f"(nvcc {_build.build_seconds:.1f} s)")
    for line in _build.build_log.splitlines():
        if any(w in line for w in PTXAS_LINES):
            print("  " + line.strip())
    check_ptxas(_build.build_log)
    # the one-card phases on card 0; on four cards, beside them, the 2-rank
    # worlds of LANE_PHASES on cards 2 and 3
    lane = (prefetch_worlds(LANE_PHASES) if torch.cuda.device_count() >= 4
            else None)
    t_one = time.perf_counter()

    big = dict(B=2, Tq=2048, Tk=2048, H=32, D=128, causal=True,
               lengths=None, seed=0)
    errs, args, kw = kernel_case(fa, torch, dtype=torch.bfloat16, **big)
    f32_errs, _, _ = kernel_case(fa, torch, dtype=torch.float32, **big)
    torch.cuda.empty_cache()
    small_errs, _, _ = kernel_case(
        fa, torch, B=2, Tq=1000, Tk=1000, H=4, D=64, dtype=torch.float32,
        causal=False, lengths=[1000, 613], seed=1)
    small_bf16_errs, _, _ = kernel_case(
        fa, torch, B=2, Tq=100, Tk=300, H=4, D=64, dtype=torch.bfloat16,
        causal=False, lengths=[217, 0], seed=2)
    fmt = lambda e: {n: f"max err {err:.2e}, err/tol {ratio:.3f}"
                     for n, (err, ratio) in e.items()}
    log("kernels", f"agree with plain: training shape bf16 {fmt(errs)}; "
                   f"training shape f32 {fmt(f32_errs)}; small "
                   f"f32/bias/ragged {fmt(small_errs)}; small bf16/bias/"
                   f"ragged/no-key row {fmt(small_bf16_errs)}")
    ms, library, _ = time_kernels(fa, torch, args, kw)
    bounds = {name: bound(name, 2, 32, 2048, 2048, 128, True, 2)
              for name in fa.KERNELS}
    for name in fa.KERNELS:
        tflops = fa_flops(name, 2, 32, 2048, 2048, 128, True) / (
            ms[name][0] * 1e-3) / 1e12
        log("kernels", f"{name}: {ms[name][0]:.4f} ms, {tflops:.1f} TFLOP/s, "
                       f"{bounds[name][0] / ms[name][0]:.1%} of its bound "
                       f"({bounds[name][0]:.4f} ms by {bounds[name][1]}); "
                       f"plain {ms[name][1]:.3f} ms; library "
                       f"{library[name]:.4f} ms; on {card}")
    del args
    torch.cuda.empty_cache()
    for heads in (16, 8):  # the tp-local heads of llama3_8b at tp 2 and 4
        tp_errs, tp_args, tp_kw = kernel_case(
            fa, torch, dtype=torch.bfloat16, **dict(big, H=heads))
        tp_ms, tp_lib, _ = time_kernels(fa, torch, tp_args, tp_kw)
        for name in fa.KERNELS:
            bnd = bound(name, 2, heads, 2048, 2048, 128, True, 2)
            tflops = fa_flops(name, 2, heads, 2048, 2048, 128, True) / (
                tp_ms[name][0] * 1e-3) / 1e12
            log("tp-kernels", f"{name} at B=2, T=2048, H={heads}, D=128, "
                              f"causal, bf16: {tp_ms[name][0]:.4f} ms, "
                              f"{tflops:.1f} TFLOP/s, "
                              f"{bnd[0] / tp_ms[name][0]:.1%} of its bound "
                              f"({bnd[0]:.4f} ms by {bnd[1]}); plain "
                              f"{tp_ms[name][1]:.3f} ms; SDPA "
                              f"{tp_lib[name]:.4f} ms; agrees with plain: "
                              f"{fmt({name: tp_errs[name]})[name]}; on "
                              f"{card}")
        del tp_args
        torch.cuda.empty_cache()

    log("model", f"small f32 Llama, flash on vs off: worst err/tol "
                 f"{small_model_check(torch, hvd_llama):.3f}")

    hvd.init()
    cfg = dataclasses.replace(hvd_llama.llama3_8b(), n_layers=2,
                              use_flash=True, remat=False)
    model = hvd_llama.Llama(cfg, seed=0)
    opt = hvd.DistributedOptimizer(
        torch.optim.AdamW(model.parameters(), lr=1e-4, weight_decay=1e-4),
        named_parameters=model.named_parameters())
    state = create_train_state(model, opt)
    step = make_train_step(model, opt, next_token_loss)
    batch, seq = 2, 2048
    gen = torch.Generator(device="cuda").manual_seed(0)
    tokens = torch.randint(0, cfg.vocab_size, (batch, seq), generator=gen,
                           device="cuda")
    torch.cuda.reset_peak_memory_stats()
    n_steps = 4  # the last one under the profiler
    fa.reset_launch_counts()
    allreduce_async_.launches = 0
    state, losses, times, prof = run_steps(torch, step, state, tokens,
                                           tokens, n_steps)
    launches = {name: fn.launches for name, fn in fa.KERNELS.items()}
    allreduces = allreduce_async_.launches
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"non-finite loss: {losses}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"loss did not fall: {losses}")
    for name, n in launches.items():
        if n < cfg.n_layers * n_steps:
            raise AssertionError(f"{name} launched {n} times in {n_steps} "
                                 f"steps of a {cfg.n_layers}-layer model")
    threshold = Config.from_env().fusion_threshold_bytes
    want = check_allreduces(allreduces, model, n_steps)
    timed = times[1:-1]
    step_s = sorted(timed)[len(timed) // 2]
    log("train", f"llama3_8b width, 2 layers, {hvd.size()} rank(s) over "
                 f"NCCL: losses {losses}; step {step_s * 1e3:.1f} ms "
                 f"(first {times[0] * 1e3:.1f} ms); "
                 f"{batch * seq / step_s:.0f} tokens/s/GPU; "
                 f"{want} buckets at threshold {threshold}, {allreduces} "
                 f"all-reduces launched; kernel launches {launches}; "
                 f"peak {peak_gb:.1f} GB; on {card}")
    log("profile", f"step {n_steps} under torch.profiler, "
                   f"{times[-1] * 1e3:.1f} ms on the host clock: "
                   f"{device_breakdown(prof, times[-1])}")
    hvd.shutdown()
    del state, step, opt, model, tokens, prof
    gc.collect()
    torch.cuda.empty_cache()

    grad_model = hvd_llama.Llama(cfg, seed=0)
    a = flat_gradient(torch, grad_model, cfg, 1, next_token_loss)
    b = flat_gradient(torch, grad_model, cfg, 2, next_token_loss)
    del grad_model
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    fused_errs, stats, out = fused_check(fused, torch, "main path", a, b)
    edge_errs = fused_edge_cases(fused, torch)
    torch.cuda.synchronize()
    log("adasum-kernels", f"agree with plain: main path (flat gradients of "
                          f"two batches, n = {a.numel():,}) {fmt(fused_errs)}"
                          f"; edge cases {fmt(edge_errs)}; coefficients "
                          f"ca {stats[3].item():.6f} cb {stats[4].item():.6f}"
                          f" (tolerances: B4 sums 1e-6 x the sums of their "
                          f"terms' magnitudes, coefficients 1e-5 relative, "
                          f"B5 2^-22 (|ca a| + |cb b|) per element)")
    fms, flib = time_fused(fused, torch, a, b, stats, out)
    fbounds = {name: fused_bound(name, a.numel()) for name in fused.KERNELS}
    yardstick = {"norms_dot": "3 x torch.dot",
                 "combine": "torch.add(a.mul(ca), b, alpha=cb)"}
    for name in fused.KERNELS:
        log("adasum-kernels", f"{name}: {fms[name][0]:.3f} ms (bound "
                              f"{fbounds[name][0]:.3f} ms by "
                              f"{fbounds[name][1]}; plain {fms[name][1]:.3f} "
                              f"ms; {yardstick[name]} {flib[name]:.3f} ms); "
                              f"peak {torch.cuda.max_memory_allocated() / 1e9:.1f}"
                              f" GB; on {card}")
    del a, b, out, stats
    gc.collect()
    torch.cuda.empty_cache()

    resnet_phase(torch, card)
    gc.collect()
    torch.cuda.empty_cache()
    bert_launches = bert_phase(torch, card)
    gc.collect()
    torch.cuda.empty_cache()
    bert_kernels_phase(torch, card, fmt)
    crossover_phase(torch, card)
    gc.collect()
    torch.cuda.empty_cache()
    longctx_launches = longctx_phase(torch, card, fmt)
    gc.collect()
    torch.cuda.empty_cache()
    mixtral_launches = mixtral_phase(torch, card)
    gc.collect()
    torch.cuda.empty_cache()
    log("one-card", f"phases 5-12, 14 and 16: "
                    f"{time.perf_counter() - t_one:.1f} s; this process "
                    f"keeps {torch.cuda.memory_reserved() / 1e9:.1f} GB "
                    f"reserved on card 0")
    if lane is not None:
        lane.join()
    phase_s = {}

    def timed(name, phase):
        t0 = time.perf_counter()
        out = phase(torch, card)
        phase_s[name] = round(time.perf_counter() - t0, 1)
        log(name, f"phase {phase_s[name]} s")
        return out

    adasum_launches = timed("adasum", adasum_phase)
    collectives_launches = timed("collectives", collectives_phase)
    context_launches = timed("context", context_phase)
    ep_launches = timed("mixtral-ep", mixtral_ep_phase)
    mp_launches = timed("model-parallel", model_parallel_phase)
    pp_launches = timed("pipeline", pipeline_phase)
    mmp_launches = timed("mixtral-mp", mixtral_mp_phase)
    bmp_launches = timed("bert-mp", bert_mp_phase)
    log("phases", f"multi-card phases {phase_s}; whole script "
                  f"{time.perf_counter() - T_START:.1f} s")
    errs.update(fused_errs)
    ms.update(fms)
    library.update(flib)
    bounds.update(fbounds)
    by_path = {name: {"train": count, "bert": bert_launches[name],
                      "collectives": collectives_launches[name],
                      "longctx": longctx_launches[name],
                      "context": context_launches[name],
                      "mixtral": mixtral_launches[name],
                      "mixtral-ep": ep_launches[name],
                      "model-parallel": mp_launches[name],
                      "pipeline": pp_launches[name],
                      "mixtral-mp": mmp_launches[name],
                      "bert-mp": bmp_launches[name]}
               for name, count in launches.items()}
    by_path.update({name: {"adasum": count,
                           "collectives": collectives_launches[name]}
                    for name, count in adasum_launches.items()})
    launches.update(adasum_launches)

    kernels = [{
        "name": name, "route": "cuda", "source": SOURCES[name],
        "replaces": REPLACES[name], "launches": launches[name],
        "launches_by_path": by_path[name],
        "max_abs_err": errs[name][0], "err_over_tol": errs[name][1],
        "ms": ms[name][0],
        "plain_ms": ms[name][1], "bound_ms": bounds[name][0],
        "bound_by": bounds[name][1], "library_ms": library[name],
    } for name in [*fa.KERNELS, *fused.KERNELS]]
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--adasum-worker"]:
        sys.exit(adasum_worker(sys.argv[2]))
    if sys.argv[1:2] == ["--collectives-worker"]:
        sys.exit(collectives_worker(sys.argv[2]))
    if sys.argv[1:2] == ["--context-worker"]:
        sys.exit(context_worker(sys.argv[2]))
    if sys.argv[1:2] == ["--mixtral-ep-worker"]:
        sys.exit(mixtral_ep_worker(sys.argv[2]))
    if sys.argv[1:2] == ["--model-parallel-worker"]:
        sys.exit(model_parallel_worker(sys.argv[2]))
    if sys.argv[1:2] == ["--pipeline-worker"]:
        sys.exit(pipeline_worker(sys.argv[2]))
    if sys.argv[1:2] == ["--mixtral-mp-worker"]:
        sys.exit(mixtral_mp_worker(sys.argv[2]))
    if sys.argv[1:2] == ["--bert-mp-worker"]:
        sys.exit(bert_mp_worker(sys.argv[2]))
    sys.exit(main())
