#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``paddle_tpu_torch``) on one GPU and check it.

    python3 chip_smoke.py [--seed N] [--phases 1,2,13]

``--phases`` runs the listed phases only (phase 1, the build, always
runs; phases 5 and 6 run together); the default runs every phase. A
skipped phase is logged as skipped and its entries in the ``steps`` and
``kernels`` lines are null; the last line is the same.

Phases, each of which fails the run (non-zero exit, no result line):

1. Device: the card's name and power limit, torch/CUDA versions, and the
   build of every kernel from ``paddle_tpu_torch/kernels/csrc`` (one
   ``nvcc`` per source, all started together), with ptxas's register and
   spill lines for every kernel and head dim, and any wgmma that ptxas
   serialized.
2. Kernels against their plain PyTorch versions on the card, on the
   served and trained shapes, the reference kernel tests' cases and odd
   lengths, in bf16 (the forward, dQ and dK/dV tensor-core kernels) and
   float32 (the CUDA-core kernels), each within a stated tolerance, the
   Delta that dQ
   returns against ``rowsum(O * dO)``, and the autograd Function's
   gradients against autograd of the written-out attention; each kernel
   (CUDA events and profiled device time), its plain version and one
   PyTorch library call (a yardstick only) timed at the main paths'
   shapes, beside the roofline bound, in bf16 and (the CUDA-core
   variants) float32.
3. The served path: GPT-small (vocab 50304, hidden 768, 12 layers, 12
   heads, seq 1024) with seeded random weights behind
   ``serving.Engine.from_layer(..., bucket_ladder=(1, 4), passes=("bf16",))``,
   fed concurrent requests. Launch counts are zeroed just before and read
   just after, and every launch must be on the bf16 variant; outputs are
   checked for shape and finiteness, a float32 engine is held against the
   same model run on the CPU, and the bf16 logits against the float32
   ones.
4. The trained path: the same GPT-small trained eagerly for 12 steps (2
   warm-up, 10 timed) on one seeded batch of 8 x 1024 tokens with the
   recipe of the JAX package's ``bench.py``: bf16 parameters,
   ``auto_cast(dtype="bfloat16")``, ``AdamW(multi_precision=True)``,
   ``ClipGradByGlobalNorm(1.0)`` and a ``LinearWarmup`` rate. Launch
   counts are zeroed just before and read just after: each kernel must
   launch 12 times a step, all on the bf16 variant. Losses must be finite
   and fall; a float32 step on the card (kernels) is held against the same
   step on the CPU (plain versions); the bf16 loss of step 1 against the
   float32 loss. Step time, tokens/s and MFU (the port's ``StepTimer``),
   peak memory and one profiled step (device busy time, idle share, each
   kernel's device time per launch) are printed; the profiled step must
   launch each kernel 12 times (the wrappers' counts) and its trace show
   each kernel's CUDA function, at most that often (a trace drops a
   record now and then).
5. BERT-base (``bert_base``, vocab 30720 as in ``bench.py``): a float32
   step on the card (no hand-written kernel: BERT's seq 512 stays below
   the flash gate) held against the same step on the CPU at 2 x 128, the
   loss, every gradient and every AdamW update.
6. BERT-base with ``bench.py``'s accelerator recipe (batch 16, seq 512,
   dropout 0, bf16 parameters, ``AdamW(lr=1e-4, multi_precision=True)``,
   ``auto_cast`` in bf16): (a) eagerly, 2 warm-up and 10 timed steps; (b) as
   the k-step program ``jit.to_static(one_step, scan_steps=20)`` replayed
   from a CUDA graph, one warm-up call and timed calls; (c) the k-step
   program's 20 losses and final parameters against 20 eager steps from
   the same weights; (d) ``bench.py``'s default structure,
   ``jit.to_static(k_steps)``, whose one graph holds all 20 steps. Step
   time, tokens/s, MFU, peak memory, device time by kernel kind and the
   idle share of one profiled eager step and one profiled call of each
   program; the bf16 loss of step 1 against the float32 loss; losses finite
   and falling; a dropout draw under capture advances per inner step (or
   raises, where this torch cannot register the package's generator with a
   graph).
7. GPT-small trained through the k-step program with phase 4's recipe
   (the scheduler stepped between calls): its losses and parameters
   against the same eager steps, and one replayed call profiled, which
   must launch each kernel (bf16 variant) layers x k times: the kernel
   nodes of the captured graph times the call's replays of it, exactly;
   its trace must show each kernel's CUDA function, at most that often.
8. Data parallelism and recompute on a one-rank NCCL mesh (the code a
   larger world runs, at dp = 1): (a) BERT-base with phase 6's recipe
   through ``to_static(one_step, scan_steps=20, dp_axis="dp")`` in nine
   arms, each against its control over two calls, bitwise unless a bound
   is stated: ZeRO-1, ZeRO-2, ZeRO-3 with prefetch on and off and
   ``enable_recompute`` full, selective and offload on every encoder layer
   against the replicated control; ZeRO-2 with ``accumulate_steps=4``
   against the accumulating control, with two witnesses: the same pair
   with float32 parameters (bitwise) and a window that keeps only its last
   micro step (beyond the bound). Each arm's step time, tokens/s, MFU,
   working set, reserved memory, ``_zero_state_bytes`` and idle share; each
   ZeRO arm's collectives counted exactly (the memcpy nodes of its captured
   graph and what Python issued) against what its stage implies, with the
   profiler's count of one call beside. (b) GPT-small with phase 7's
   recipe, ZeRO-3, prefetch and full recompute on every block through
   ``to_static(scan_steps=10, dp_axis="dp")``, bitwise against the same
   program without either; a profiled replayed call must launch the bf16
   forward kernel 2 x layers x k times and dQ and dK/dV layers x k times
   (counted as in phase 7).
   (c) BERT-base with dropout 0.1 and full or selective recompute, bitwise
   against the same program without recompute; the attention gate writes
   out inputs the kernels do not take.
9. Step checkpoints (``checkpoint.CheckpointManager``) on the one-rank
   mesh, written to the card's machine's disk under the checkout: (a)
   BERT-base with phase 6's recipe through ``to_static(one_step,
   scan_steps=20, dp_axis="dp")``, replicated, ZeRO-1, ZeRO-3 with prefetch
   and ZeRO-2 with ``accumulate_steps=4``: call 1, a save, everything
   freed, fresh objects from another seed, a restore and call 2, whose
   losses and parameters must be bitwise an uninterrupted run's; (b)
   GPT-small with phase 8b's program: a restore into the same objects,
   whose graph stays captured, replays calls 2 and 3 bitwise, with each
   kernel at phase 8b's count in the profiled call 3 (counted as in
   phase 7) and
   the step's time before and after the restore; (c) BERT-base with
   dropout 0.1 resumed bitwise, in place and into fresh objects (the
   generators' states ride the checkpoint); (d) a fault at every kill
   point of the checkpoint core never leaves a checkpoint that restores
   other than exactly the previous or the new state, and a flipped byte
   falls back to the previous step; (e) ``amp.GradScaler`` inside the
   captured program, a step with an inf skipped on the device, bitwise
   against the same eager steps and again after an in-place restore. Each
   save and restore: bytes, seconds, GB/s, the share of the copies between
   the card and the host, and the checkpoint spans.
10. GPT-3 1.3B (``gpt3_1p3b``: vocab 50304, hidden 2048, 24 layers, 16
   heads, head dim 128, seq 1024; seeded random weights, dropout 0) under
   the fleet's hybrid parallelism on a one-rank NCCL world (``fleet.init``
   with every degree 1 and ``strategy.sharding``: one-rank groups on every
   axis, the code a larger world runs), with phase 4's recipe at GPT-3
   XL's rate on 8 x 1024 tokens a step: (a) the ``use_mp`` model under
   ``TensorParallel`` against the plain model from the same weights over
   two eager steps (losses and every gradient, bitwise), then 2 warm-up and
   5 timed eager steps, each kernel 24 launches a step on the bf16 variant;
   (b) the same step through ``to_static(one_step, scan_steps=4,
   dp_axis="dp")`` with ZeRO-1, bitwise against 4 eager steps, each kernel
   24 x 4 nodes in the replayed call (counted as in phase 7) and one
   profiled call; (c) ``build_pipeline_layer(cfg, 1)`` under
   ``PipelineParallel`` (4 microbatches of 2 x 1024) against plain
   accumulation, bitwise, with the reference's schedule, and
   ``build_gpt_1f1b_step`` at pp = 1 within its stated bound; (d) ring and
   Ulysses attention and MoE on one-rank groups in bf16 against their dense
   forms; (e) a float32 two-layer step on the card against the CPU. Step
   time, tokens/s, MFU, working set, reserved memory and idle share beside
   the card's name and power limit. Phase 2 also checks and times the
   three kernels at GPT-3 1.3B's shape [8, 1024, 16, 128].
11. Convolutional networks (no hand-written kernel runs on this path;
   each flash kernel's launches are counted and must be 0): ResNet-50
   (``vision.models.resnet50``, 1000 classes, 25.6 M parameters, seeded
   random weights, images and labels) with ``benchmarks/run_all.py``'s
   recipe (64 x 3 x 224 x 224, ``Momentum(lr=0.1, momentum=0.9)``, bf16
   ``auto_cast``) and PaddleClas's ``L2Decay(1e-4)`` and ``PiecewiseDecay``:
   (a1) a float32 step on the card against the CPU at batch 2: the loss,
   the gradients' distance from the CPU's float64 gradients against the
   CPU float32's, the Momentum step and the running statistics; (a2) the bf16
   step's first loss against float32's; (a3) 2 warm-up and 10 timed eager
   steps; (a4) ``to_static(one_step, scan_steps=4)`` against the same eager
   steps over two calls with the rate stepped between them, bitwise
   (losses, parameters, velocities, ``_mean``, ``_variance``; cuDNN
   deterministic), then the program timed (cuDNN autotuned); (a5) one
   profiled call. Step time, images/s, MFU from the multiply-adds of the
   layer shapes (checked against the closed form), working set, reserved
   memory, idle share and device time by kind. (b) LeNet, five float32
   Momentum steps on the synthetic MNIST, card against CPU. (c) ResNet-50
   in eval mode behind ``Engine.from_layer(..., bucket_ladder=(1, 16, 64),
   passes=("bf16",))`` under concurrent requests: latency, device and
   host-copy ms per bucket, the float32 engine against the CPU and bf16
   against float32. Phases 10 and 11 start with a census of the memory
   that earlier phases left allocated.
12. Serving from saved artifacts: each model saved with ``jit.save(...,
   input_spec=[InputSpec([None, ...])])`` (a ``torch.export`` program,
   the flash forward as the operator ``paddle_tpu_torch::flash_attention_fwd``)
   and served by ``serving.Engine(path)``, one CUDA graph a bucket
   captured at load. A bf16 input off a 16-byte base runs on the kernel
   after one copy (counted). (a) GPT-small cast to bf16 at buckets 1 and 4
   under concurrent requests: exactly 12 forward launches a forward from
   the graphs' kernel nodes x replays, all bf16; logits against phase 3's
   ``from_layer`` engine on the same weights within the bf16 bound (bitwise
   or not printed); each bucket's replay bitwise against the same engine's
   eager forward in the order 4, 1, 4; a fresh process that imports the
   inference API only serves the artifact to the parent's digest. (b) The
   float32 artifact on the CUDA-core forward (12 a forward) against the
   CPU, and served on the CPU from the card's save. (c) BERT-base (vocab
   30720, seq 512) at bucket 16 with all outputs and with
   ``outputs=["output_1"]`` (NSP: the MLM head leaves the graph), NSP rows
   bitwise. (d) ResNet-50 at 224, bf16, buckets 1, 16, 64, against
   phase 11's ``from_layer`` engine; no flash launch. Each arm: request
   latency, device and host-copy ms per bucket, capture ms,
   ``memory_stats()``, bucket-1 latency with the graph and eagerly, and
   ``health()`` before and after ``close()``. Phases 3 and 11c serve through
   captured graphs too, their launches counted from the graphs.
13. YOLOv3 detection, ``BASELINE.md`` config 5, at
   ``benchmarks/run_all.py:255-330``'s recipe (a ResNet-18 trunk and a
   ``Conv2D(512, 255, 1)`` head, batch 8 at 320, 416 and 512, 50 boxes, 80
   classes, bf16 ``auto_cast``, ``Momentum`` over ``backbone.parameters() +
   head.parameters()``): (a) ``yolov3_loss`` in float32 at [8, 255, 13, 13]
   card against CPU (the loss and its gradient), a bf16 input under
   ``auto_cast`` against float32, ``yolo_box`` and ``box_coder`` card
   against CPU; (b) one warm-up a size, then 4 x (320, 416, 512) through
   ``to_static(train_step)``: exactly one CUDA graph a size, the losses,
   parameters, statistics and velocities bitwise against the same eager
   steps under deterministic algorithms, then eager and captured steps
   timed over the mixed traffic (images/s, ms a size, first call a size,
   MFU from the layer shapes, working set, one profiled step's idle share
   and device time by kind); (c) the trained trunk, head and ``yolo_box``
   served in eval through ``Engine.from_layer`` at 416, buckets 1 and 8,
   float32, with the host's ``multiclass_nms`` on each result: the
   decoded boxes and scores against the CPU, latency per bucket split
   into the device step and the NMS. No flash kernel may launch.
14. The imperative surface (``Tensor``, autograd, ``PyLayer``, the vision
   functionals, sparse embeddings), one JSON line of its results: (a) the
   nine vision functionals and ``LocalResponseNorm`` at their users'
   shapes (a spatial transformer at [64, 64, 56, 56], a deformable
   ResNet-50 stage-3 conv, TSM's shift, ResNet-50 stage shapes), float32
   forwards and gradients against the CPU; (b) GPT-small with phase 4's
   recipe fed ``to_tensor`` ids: 2 x 10 eager steps bitwise against the
   same steps fed plain tensors, and two calls of ``to_static(one_step,
   scan_steps=10)`` with ``Tensor`` inputs bitwise against them, 12
   launches of each flash kernel a step and 120 in the replayed call; then
   the eager step timed with plain and with ``Tensor`` inputs in turns;
   (c) ``grad(create_graph=True)`` to third order, a gradient penalty
   through a convolutional critic, a ``PyLayer`` and ``no_grad`` against
   the CPU, and ``get_rng_state``/``set_rng_state`` repeating draws
   bitwise; (d) sparse embeddings at ``bench_ctr``'s sizes (a 2,000,000 x
   64 table, 16 slots, batch 1024, Zipf-1.2 ids) with ``SGD`` and
   ``Adam(lazy_mode=True)``: captured steps bitwise against eager steps
   under deterministic algorithms, the untouched rows and their moments
   unchanged, sparse SGD against the dense update, and each step timed
   sparse against dense. No flash kernel may launch in (a), (c) or (d).
15. The runtime services on GPT-small with phase 4's recipe: (a) the
   tracer (default categories), a run-log, the flight recorder and
   ``profiler.Profiler(state="All")`` on for 10 eager steps and two calls
   of ``to_static(one_step, scan_steps=10)``, bitwise against the same
   steps with everything off, 12 launches of each flash kernel a step and
   120 in the replayed call, the chrome trace holding the host spans, the
   per-op events and the kernels' device events under the reference's
   names, ``compile_stall_frac`` above 0 in the window of the capture and
   0 after; (b) the sampled op observer at rate 1.0 counting each kernel
   12 times a step, then the eager step off, at 0.01 and at 1.0 timed in
   turns; (c)
   ``FLAGS_check_nan_inf=1``: the eager step timed, the steps and the
   k-step program bitwise against (a)'s, a NaN written into one weight
   raising at the first op that holds it; (d) the state ledger of the
   model and its AdamW against the tensors' bytes, the serving buckets in
   the program registry; (e) a fault at a checkpoint kill point leaving
   one flight dump, a real out-of-memory error classified; (f) two ranks
   of ``testing.pod_fixture`` on the card under ``VirtualPod``, rank 1
   SIGKILLed and respawned: the survivor re-forms, the world heals to 2,
   the losses within 1e-6 of the fixture's control on the card; once
   with the reference's MLP (liveness at the fixture's size) and once
   with GPT-small replicas, AdamW with float32 masters, whose survivor
   and replacement restore the whole state from the pod checkpoint.
16. CTR through the parameter server (``distributed.ps``,
   ``models.ctr``), no hand-written kernel on this path (each flash
   kernel's launches are counted and must be 0): (a) the native PS service
   built with g++ (build time printed), a server on port 0 with sparse SGD
   and Adam tables, a dense table and a spilled table: fresh rows bitwise
   the server's float32 rule (and the reference's float64 mirror's gap),
   three Adam pushes against numpy, dense pushes and deltas, 500 rows past
   a 64-row budget, a save/load round trip bitwise; (b) bench_hbm_cache
   at its sizes (vocab 200,000, dim 64, 30 batches of 4096, capacity 2^18,
   SGD 0.1): the direct path (a loopback TCP pull and push a batch) and
   the cached path (``build_pass``, then ``run_fused_pass``: one CUDA
   graph of one batch, replayed 30 times, after a warm-up pass), the
   passes bitwise against the same body run eagerly (deterministic
   algorithms), the server's rows bitwise the device table after
   ``end_pass``; ms a batch of each path and the hit rate; (c) bench_ctr
   at its accelerator sizes (``WideAndDeep``: vocab 2,000,000, dim 64, 16
   slots, batch 1024, hidden (512, 256), k 16, Zipf-1.2 ids of seed 3, the
   (10 + 1) x 16 batches as run_all.py feeds them, capacity 2^18, sparse SGD
   0.05, dense ``Adam(1e-3)``) through ``train_ctr_windows(prefetch=True,
   depth=2, flush=True)`` with a ``WriteBackQueue`` and a
   ``SyncCommunicator``, then with ``prefetch=False``: losses finite and
   falling, both runs bitwise alike (losses, dense parameters, the
   server's rows), lookups/s, overlap efficiency, pull and wait ms, hits,
   misses, evictions, capture time, the cache's and the program's memory
   and one profiled window (device busy, idle share, top kernels); (d)
   a small ``WideAndDeep`` on the card against the CPU within stated
   float32 bounds; (e) one server and two worker processes of
   ``testing.ps_fixture`` through the fleet (``init(is_collective=
   False)`` ... ``shutdown_servers``) in sync mode, the workers' dense math
   on the card: losses finite and falling, final dense parameters equal.
17. One JSON line with every kernel of the paths, then the result line.

Imports nothing of JAX and nothing of the JAX package.
"""
import argparse
import contextlib
import copy
import json
import re
import subprocess
import sys
import threading
import time

import numpy as np
import torch

# Tolerances, fixed before any run: kernel vs its plain version on the
# same inputs. Both accumulate in float32 and differ only in summation
# order, so float32 outputs agree to ~1e-6; a bfloat16 O may differ by one
# rounding step of bfloat16 (2^-8 relative).
TOL = {torch.float32: {"o_atol": 1e-4, "o_rtol": 0.0, "lse_atol": 1e-4},
       torch.bfloat16: {"o_atol": 1e-2, "o_rtol": 1e-2, "lse_atol": 1e-4}}
# Backward kernels vs their plain version, per output (dQ, dK, dV):
# float32 sums in another order; bf16 outputs may differ by one rounding
# step of bf16 (2^-8 relative) of values up to ~5.
BWD_TOL = {torch.float32: {"atol": 1e-4, "rtol": 1e-4},
           torch.bfloat16: {"atol": 1e-2, "rtol": 1e-2}}
# The Function's float32 gradients vs autograd of the written-out
# attention (s = 256): the same math in another order.
FUNC_TOL = 1e-4
# float32 engine on the card vs the same model on the CPU: float32 sums in
# another order through 12 layers.
FP32_REL_MAX_TOL = 2e-4     # max |diff| / max |reference logit|
# bf16-served logits vs float32 logits of the same model and ids.
BF16_REL_L2_TOL = 5e-2      # ||diff||_2 / ||reference||_2
# float32 training step, card (kernels, cuBLAS) vs CPU (plain versions):
# the loss and every gradient differ only by float32 summation order
# (relative ~1e-6; ``wte``'s gradient also sums the embedding backward with
# atomics on the card); the tolerances leave 10-100x.
STEP_LOSS_REL_TOL = 1e-5
STEP_GRAD_REL_L2_TOL = 1e-4
# ... and the AdamW update p_new - p_old: Adam moves each element by about
# the learning rate whatever its gradient's size, so an element whose
# gradient is within float32 noise of zero may step the other way (one
# such element in a 768-vector gives a relative L2 of 0.07). The key
# third of each qkv.bias has an exactly zero gradient (a bias on k adds
# the same q.b to every score of a row, which the softmax cancels): both
# sides step on rounding noise there, held only to two Adam steps apart.
STEP_UPDATE_REL_L2_TOL = 0.1
ZERO_GRAD_UPDATE_MAX = 2.2  # x the learning rate
# bf16 AMP loss of the first step vs the float32 loss on the same batch
# and weights: logits of size ~30 rounded to bf16 (2^-8) through 12 layers.
AMP_LOSS_REL_TOL = 1e-2
# The k-step program (CUDA-graph replays) vs the same steps run eagerly
# from the same weights: the same kernels in the same order on the same
# inputs, so the losses and the parameters are expected to be bitwise
# equal; the tolerance is 0.
KSTEP_MAX_ABS_TOL = 0.0

# Published H100 SXM peaks (dense), for the roofline bound.
PEAK_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}

SEQ = 1024
TRAIN_BATCH = 8     # 8 x 1024 tokens a step
TRAIN_STEPS, WARMUP_STEPS = 12, 2
# GPT-3 Small's (125M) published peak rate, Brown et al. 2020, table 2.1
PEAK_LR, START_LR = 6e-4, 6e-5
# BERT-base with bench.py's accelerator recipe (bench.py:107-109,138-161)
BERT_VOCAB, BERT_BATCH, BERT_SEQ, BERT_LR = 30720, 16, 512, 1e-4
BERT_F32_BATCH, BERT_F32_SEQ = 2, 128  # the float32 card-vs-CPU step
KSTEP = 20                    # bench.py's k on an accelerator
KSTEP_TIMED_CALLS = 3
GPT_KSTEP = 10                # phase 7: 10 steps a call, full depth
# phase 10: GPT-3 1.3B (BASELINE.md config 4) at full width and depth
GPT3_BATCH, GPT3_HEADS, GPT3_HEAD_DIM = 8, 16, 128
SOURCES = {name: f"paddle_tpu_torch/kernels/csrc/{name}.cu" for name in (
    "flash_attention_fwd", "flash_attention_bwd",   # float32: CUDA cores
    "flash_attention_fwd_sm90",                     # bf16: tensor cores
    "flash_attention_bwd_dq_sm90", "flash_attention_bwd_dkv_sm90")}
# Each kernel's source per dtype variant; the main paths run bf16. "kernel"
# is the bf16 variant's CUDA function name as the profiler reports it,
# "cuda_core" the CUDA-core kernel's (float32, and bf16 off the main path).
KERNELS = [
    {"name": "flash_attention_fwd", "route": "cuda",
     "source": SOURCES["flash_attention_fwd_sm90"],
     "replaces": "paddle_tpu/kernels/flash_attention.py:35",
     "variants": {"bf16": SOURCES["flash_attention_fwd_sm90"],
                  "float32": SOURCES["flash_attention_fwd"]},
     "kernel": "flash_fwd_sm90_kernel", "cuda_core": "flash_fwd_kernel"},
    {"name": "flash_attention_bwd_dq", "route": "cuda",
     "source": SOURCES["flash_attention_bwd_dq_sm90"],
     "replaces": "paddle_tpu/kernels/flash_attention.py:111",
     "variants": {"bf16": SOURCES["flash_attention_bwd_dq_sm90"],
                  "float32": SOURCES["flash_attention_bwd"]},
     "kernel": "flash_bwd_dq_sm90_kernel",
     "cuda_core": "flash_bwd_dq_kernel"},
    {"name": "flash_attention_bwd_dkv", "route": "cuda",
     "source": SOURCES["flash_attention_bwd_dkv_sm90"],
     "replaces": "paddle_tpu/kernels/flash_attention.py:146",
     "variants": {"bf16": SOURCES["flash_attention_bwd_dkv_sm90"],
                  "float32": SOURCES["flash_attention_bwd"]},
     "kernel": "flash_bwd_dkv_sm90_kernel",
     "cuda_core": "flash_bwd_dkv_kernel"},
]


def log(*a):
    print(*a, flush=True)


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()
    return out[0] if out else ""


def ptxas_report(build_log):
    """One line per compiled kernel from ``nvcc -Xptxas=-v``: its name and
    template arguments (element type, head dim, warpgroups), registers and
    spills; and ptxas's notes of wgmma it had to serialize."""
    out, name, spill = [], None, ""
    for line in build_log.splitlines():
        if "serialized" in line:
            out.append("WARNING " + line.split(":", 1)[1].strip()[:160])
        m = re.search(r"_kernelI((?:13__nv_bfloat16|f|Li\d+E)+)E", line)
        if "Compiling entry" in line and m:
            head = line[:m.start() + len("_kernel")]
            # the mangled name is preceded by its length
            n = next(n for n in range(7, len(head))
                     if head[:-n].endswith(str(n)))
            args = ["bf16" if a == "13__nv_bfloat16" else "f32" if a == "f"
                    else a[2:-1] for a in
                    re.findall(r"13__nv_bfloat16|f|Li\d+E", m[1])]
            name = f"{head[-n:]}<{', '.join(args)}>"
        elif "spill" in line:
            spill = line.split(":")[-1].strip()
        elif "registers" in line and name:
            out.append(f"{name}: {line.split(':', 1)[1].strip()}; {spill}")
            name = None
    return out


def cuda_time_ms(fn, iters, warmup=3):
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, kernel, iters=20, attempts=3):
    """Device time per launch of the CUDA function named ``kernel``, from
    ``torch.profiler`` over ``iters`` calls of ``fn``. A profiler run on
    the card now and then records no device activity; it is tried again up
    to ``attempts`` times (None if none saw a launch)."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(attempts):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        times = [e.time_range.elapsed_us() for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA
                 and kernel in e.name]
        if times:
            return sum(times) / len(times) / 1e3
    return None


def fmt_ms(ms):
    return "not measured" if ms is None else f"{ms:.4f} ms"


def flash_bound(b, s_q, s_k, h, d, dtype, causal):
    """Least time for one forward: bytes (q, k, v read once; O and lse
    written once) over the memory rate, and the QK^T + PV operations that
    the causal mask leaves over the peak for the input type."""
    esize = torch.tensor([], dtype=dtype).element_size()
    nbytes = (b * h * d * (2 * s_q + 2 * s_k)) * esize + b * h * s_q * 4
    pairs = s_q * (s_q + 1) // 2 if causal else s_q * s_k
    flops = 4 * b * h * d * pairs
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def bwd_bound(b, s, h, d, dtype, n_in, n_out, products):
    """Least time for backward work at causal [b, s, h, d]: ``n_in``
    [b, s, h, d] tensors read once (plus lse and delta, float32) and
    ``n_out`` written once, over the memory rate, and ``products``
    causal-half products (2 * b*h*d * s(s+1)/2 operations each) over the
    peak for the input type."""
    esize = torch.tensor([], dtype=dtype).element_size()
    nbytes = b * h * s * d * esize * (n_in + n_out) + 2 * b * h * s * 4
    flops = products * 2 * b * h * d * (s * (s + 1) // 2)
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def qkv_views(gen, b, h, d, dtype):
    """The model's layout: q/k/v as strided views of one fused QKV."""
    x = torch.randn(b, SEQ, 3, h, d, generator=gen, device="cuda")
    return x.to(dtype).unbind(2)


def rand(gen, b, s, h, d, dtype):
    return torch.randn(b, s, h, d, generator=gen, device="cuda").to(dtype)


def flash_cases(gen):
    """(label, dtype, causal, (q, k, v)): the main paths' shapes, the
    reference kernel tests' cases and the ragged length at the other head
    dims."""
    cases = []
    for dtype in (torch.bfloat16, torch.float32):
        for b in (TRAIN_BATCH, 4, 1):  # trained, and the served buckets
            label = "train" if b == TRAIN_BATCH else f"served b={b}"
            cases.append((label, dtype, True,
                          qkv_views(gen, b, 12, 64, dtype)))
        for s in (128, 384, 200):
            for causal in (False, True):
                cases.append((f"s={s}", dtype, causal,
                              [rand(gen, 2, s, 2, 64, dtype)
                               for _ in range(3)]))
        for d in (32, 128):
            for causal in (False, True):
                cases.append((f"s=200 d={d}", dtype, causal,
                              [rand(gen, 2, 200, 2, d, dtype)
                               for _ in range(3)]))
        for causal in (False, True):  # lse/Delta rows not 16-byte aligned
            cases.append(("s=201", dtype, causal,
                          [rand(gen, 2, 201, 3, 64, dtype)
                           for _ in range(3)]))
        cases.append(("cross 128x320", dtype, False,
                      [rand(gen, 1, 128, 2, 32, dtype)]
                      + [rand(gen, 1, 320, 2, 32, dtype) for _ in range(2)]))
    return cases


def time_flash_fwd(fa, gen, b):
    """The forward kernel (event and profiled device time), its plain
    version and the library call at [b, 1024, 12, 64] bf16 causal."""
    q, k, v = qkv_views(gen, b, 12, 64, torch.bfloat16)
    ms = cuda_time_ms(lambda: fa.flash_attention_fwd(q, k, v, causal=True), 50)
    dev_ms = device_ms(lambda: fa.flash_attention_fwd(q, k, v, causal=True),
                       KERNELS[0]["kernel"])
    plain_ms = cuda_time_ms(
        lambda: fa.flash_attention_fwd_reference(q, k, v, causal=True), 5, 1)
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    library_ms = cuda_time_ms(
        lambda: torch.nn.functional.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True), 50)
    bound_ms, bound_by = flash_bound(b, SEQ, SEQ, 12, 64, torch.bfloat16,
                                     True)
    log(f"  flash fwd [{b}, {SEQ}, 12, 64] bf16 causal: kernel "
        f"{ms:.4f} ms (events), {fmt_ms(dev_ms)} (profiled device time), "
        f"plain {plain_ms:.4f} ms, "
        f"library (F.scaled_dot_product_attention) {library_ms:.4f} ms, "
        f"bound {bound_ms:.4f} ms ({bound_by})")
    return {"ms": ms, "device_ms": dev_ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": library_ms}


def check_flash(fa, failures, gen):
    """Forward kernel vs plain version on every case; returns the
    training-shape bf16 error and timings (served-shape timings printed)."""
    train_err = None
    for label, dtype, causal, (q, k, v) in flash_cases(gen):
        o, lse = fa.flash_attention_fwd(q, k, v, causal=causal)
        torch.cuda.synchronize()
        variant = fa._variant(dtype, q.shape[-1])
        ro, rlse = fa.flash_attention_fwd_reference(q, k, v, causal=causal)
        tol = TOL[dtype]
        o_err = (o.float() - ro.float()).abs()
        o_ok = bool((o_err <= tol["o_atol"] + tol["o_rtol"]
                     * ro.float().abs()).all())
        lse_err = (lse - rlse).abs().max().item()
        ok = (o_ok and lse_err <= tol["lse_atol"]
              and bool(torch.isfinite(o.float()).all()))
        log(f"  flash fwd {label:<14} {str(dtype):<14} {variant:<11} "
            f"causal={causal!s:<5} O max_abs_err={o_err.max().item():.3e} "
            f"(tol {tol['o_atol']:g} + {tol['o_rtol']:g}*|ref|)  "
            f"lse max_abs_err={lse_err:.3e} (tol {tol['lse_atol']:g})  "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            failures.append(f"flash fwd {label} {dtype} causal={causal}")
        if label == "train" and dtype == torch.bfloat16:
            train_err = o_err.max().item()
    time_flash_fwd(fa, gen, 4)  # the served bucket-4 shape, as before
    return dict(time_flash_fwd(fa, gen, TRAIN_BATCH), max_abs_err=train_err)


def time_f32_variants(fa, gen):
    """The float32 (CUDA-core) variant of each kernel at the training shape
    [8, 1024, 12, 64] causal: CUDA events (the float32 dQ route also runs
    the torch Delta before its kernel, timed with it) and the profiler's
    device time per launch, beside its bound at the dense float32 peak of
    the CUDA cores and the library's float32 time for the same work
    (``F.scaled_dot_product_attention``'s forward; its backward for dQ, dK
    and dV together)."""
    b, h, d, dt = TRAIN_BATCH, 12, 64, torch.float32
    q, k, v = qkv_views(gen, b, h, d, dt)
    o, lse = fa.flash_attention_fwd(q, k, v, causal=True)
    do = rand(gen, b, SEQ, h, d, dt)
    _, delta = fa.flash_attention_bwd_dq(q, k, v, o, do, lse, True)
    qt, kt, vt = (x.detach().transpose(1, 2).requires_grad_() for x in
                  (q, k, v))
    lib_fwd_ms = cuda_time_ms(
        lambda: torch.nn.functional.scaled_dot_product_attention(
            qt.detach(), kt.detach(), vt.detach(), is_causal=True), 10)
    lib_out = torch.nn.functional.scaled_dot_product_attention(
        qt, kt, vt, is_causal=True)
    lib_bwd_ms = cuda_time_ms(lambda: torch.autograd.grad(
        lib_out, (qt, kt, vt), do.transpose(1, 2), retain_graph=True), 10)
    log(f"  library float32 [{b}, {SEQ}, {h}, {d}] causal: "
        f"F.scaled_dot_product_attention forward {lib_fwd_ms:.4f} ms, its "
        f"backward (dQ, dK, dV) {lib_bwd_ms:.4f} ms")
    library = {"flash_attention_fwd": lib_fwd_ms,
               "flash_attention_bwd_dq": lib_bwd_ms,
               "flash_attention_bwd_dkv": lib_bwd_ms}
    names = {meta["name"]: meta["cuda_core"] for meta in KERNELS}
    scale = d ** -0.5
    calls = {
        "flash_attention_fwd": (
            lambda: fa.flash_attention_fwd(q, k, v, causal=True),
            lambda: fa.flash_attention_fwd_reference(q, k, v, causal=True),
            flash_bound(b, SEQ, SEQ, h, d, dt, True)),
        "flash_attention_bwd_dq": (
            lambda: fa.flash_attention_bwd_dq(q, k, v, o, do, lse, True),
            lambda: fa.flash_attention_bwd_dq_reference(
                q, k, v, o, do, lse, True, scale),
            bwd_bound(b, SEQ, h, d, dt, 5, 1, 3)),
        "flash_attention_bwd_dkv": (
            lambda: fa.flash_attention_bwd_dkv(q, k, v, do, lse, delta, True),
            lambda: fa.flash_attention_bwd_dkv_reference(
                q, k, v, do, lse, delta, True, scale),
            bwd_bound(b, SEQ, h, d, dt, 4, 2, 4))}
    out = {}
    for name, (fn, plain, (bound_ms, bound_by)) in calls.items():
        ms = cuda_time_ms(fn, 10)
        dev_ms = device_ms(fn, names[name] + "<", iters=5)
        plain_ms = cuda_time_ms(plain, 3, 1)
        out[name] = {"ms": ms, "device_ms": dev_ms, "plain_ms": plain_ms,
                     "bound_ms": bound_ms, "bound_by": bound_by,
                     "library_ms": library[name]}
        log(f"  {name} float32 [{b}, {SEQ}, {h}, {d}] causal: kernel "
            f"{ms:.4f} ms (events), {fmt_ms(dev_ms)} (profiled device "
            f"time), plain {plain_ms:.4f} ms, bound {bound_ms:.4f} ms "
            f"({bound_by}, {PEAK_FLOPS[dt]:g} FLOP/s), library "
            f"{library[name]:.4f} ms")
    return out


def written_out_attention(q, k, v, causal):
    """Plain full attention on [B, S, H, D] (float32, autograd)."""
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    s = torch.matmul(qt, kt.transpose(-1, -2)) / q.shape[-1] ** 0.5
    if causal:
        keep = torch.ones(s.shape[-2:], dtype=torch.bool,
                          device=s.device).tril()
        s = s.masked_fill(~keep, float("-inf"))
    return torch.matmul(torch.softmax(s, dim=-1), vt).transpose(1, 2)


def check_flash_bwd(fa, failures, gen):
    """dQ and dK/dV kernels vs their plain versions on every case, the
    Function's gradients vs autograd of the written-out attention, and
    timings at the training shape; returns per-kernel JSON fields."""
    errs = {}
    for label, dtype, causal, (q, k, v) in flash_cases(gen):
        if label.startswith("served"):
            continue  # serving runs no backward
        o, lse = fa.flash_attention_fwd(q, k, v, causal=causal)
        do = rand(gen, *q.shape, dtype)
        dq, delta = fa.flash_attention_bwd_dq(q, k, v, o, do, lse, causal)
        got = (dq, *fa.flash_attention_bwd_dkv(q, k, v, do, lse, delta,
                                               causal))
        torch.cuda.synchronize()
        scale = q.shape[-1] ** -0.5
        want_dq, want_delta = fa.flash_attention_bwd_dq_reference(
            q, k, v, o, do, lse, causal, scale)
        want = (want_dq, *fa.flash_attention_bwd_dkv_reference(
                    q, k, v, do, lse, want_delta, causal, scale))
        tol = BWD_TOL[dtype]
        # delta is float32 whatever the input: float32's bound
        d_tol = BWD_TOL[torch.float32]
        d_err = (delta - want_delta).abs()
        ok = bool((d_err <= d_tol["atol"] + d_tol["rtol"] * want_delta.abs())
                  .all())
        parts = [f"delta {d_err.max().item():.3e}"]
        for name, g, w in zip(("dQ", "dK", "dV"), got, want):
            err = (g.float() - w.float()).abs()
            ok &= bool((err <= tol["atol"] + tol["rtol"] * w.float().abs())
                       .all()) and bool(torch.isfinite(g.float()).all())
            parts.append(f"{name} {err.max().item():.3e}")
            if label == "train" and dtype == torch.bfloat16:
                errs[name] = err.max().item()
        log(f"  flash bwd {label:<14} {str(dtype):<14} "
            f"{fa._variant(dtype, q.shape[-1]):<11} causal={causal!s:<5} "
            f"max_abs_err {', '.join(parts)} (tol {tol['atol']:g} + "
            f"{tol['rtol']:g}*|ref|; delta {d_tol['atol']:g} + "
            f"{d_tol['rtol']:g}*|ref|)  {'ok' if ok else 'FAIL'}")
        if not ok:
            failures.append(f"flash bwd {label} {dtype} causal={causal}")

    # the autograd Function vs autograd of the written-out attention
    q, k, v = (rand(gen, 2, 256, 2, 64, torch.float32).requires_grad_()
               for _ in range(3))
    do = rand(gen, 2, 256, 2, 64, torch.float32)
    out = fa.flash_attention_bshd(q, k, v, causal=True)
    got = torch.autograd.grad(out, (q, k, v), do)
    want = torch.autograd.grad(written_out_attention(q, k, v, True),
                               (q, k, v), do)
    fn_ok = type(out.grad_fn).__name__ == "FlashAttentionBackward"
    worst = 0.0
    for g, w in zip(got, want):
        err = (g - w).abs()
        worst = max(worst, err.max().item())
        fn_ok &= bool((err <= FUNC_TOL + FUNC_TOL * w.abs()).all())
    log(f"  FlashAttention grads vs autograd of the written-out attention "
        f"(f32, s=256, causal): max_abs_err {worst:.3e} (tol {FUNC_TOL:g} "
        f"+ {FUNC_TOL:g}*|ref|) {'ok' if fn_ok else 'FAIL'}")
    if not fn_ok:
        failures.append("FlashAttention gradients")

    # timings at the training shape, bf16 causal
    b, h, d, dt = TRAIN_BATCH, 12, 64, torch.bfloat16
    x = torch.randn(b, SEQ, 3, h, d, generator=gen, device="cuda").to(dt)
    q, k, v = x.unbind(2)
    o, lse = fa.flash_attention_fwd(q, k, v, causal=True)
    do = rand(gen, b, SEQ, h, d, dt)
    _, delta = fa.flash_attention_bwd_dq(q, k, v, o, do, lse, True)
    scale = d ** -0.5
    dq_args = (q, k, v, o, do, lse, True)
    args = (q, k, v, do, lse, delta, True)
    calls = {"dq": (lambda: fa.flash_attention_bwd_dq(*dq_args),
                    lambda: fa.flash_attention_bwd_dq_reference(*dq_args,
                                                                scale)),
             "dkv": (lambda: fa.flash_attention_bwd_dkv(*args),
                     lambda: fa.flash_attention_bwd_dkv_reference(*args,
                                                                  scale))}
    out = {}
    for key, meta in (("dq", KERNELS[1]), ("dkv", KERNELS[2])):
        kernel, plain = calls[key]
        out[key] = {"ms": cuda_time_ms(kernel, 20),
                    "device_ms": device_ms(kernel, meta["kernel"]),
                    "plain_ms": cuda_time_ms(plain, 3, 1)}
    # the torch Delta that the float32 route still runs before its dQ
    delta_ms = cuda_time_ms(lambda: fa.attention_delta(o, do), 20)
    # yardstick: F.scaled_dot_product_attention's backward (dQ, dK and dV
    # together), replayed on one retained graph so that only the backward
    # runs and the host's autograd work per call stays small
    xl = x.detach().requires_grad_()
    qt, kt, vt = (t.transpose(1, 2) for t in xl.unbind(2))
    lib_out = torch.nn.functional.scaled_dot_product_attention(
        qt, kt, vt, is_causal=True)
    library_ms = cuda_time_ms(lambda: torch.autograd.grad(
        lib_out, (qt, kt, vt), do.transpose(1, 2), retain_graph=True), 20)
    # dQ reads q, k, v, O, dO and lse and writes dQ and Delta; dK/dV reads
    # q, k, v, dO, lse and Delta and writes dK and dV
    bounds = {"dq": bwd_bound(b, SEQ, h, d, dt, 5, 1, 3),
              "dkv": bwd_bound(b, SEQ, h, d, dt, 4, 2, 4)}
    whole_ms, whole_by = bwd_bound(b, SEQ, h, d, dt, 5, 3, 5)
    for key, label in (("dq", "dQ"), ("dkv", "dK/dV")):
        bound_ms, bound_by = bounds[key]
        out[key].update(bound_ms=bound_ms, bound_by=bound_by,
                        library_ms=library_ms)
        log(f"  flash bwd {label} [{b}, {SEQ}, {h}, {d}] bf16 causal: kernel "
            f"{out[key]['ms']:.4f} ms (events), "
            f"{fmt_ms(out[key]['device_ms'])} (profiled device time), "
            f"plain {out[key]['plain_ms']:.4f} ms, "
            f"bound {bound_ms:.4f} ms ({bound_by})")
    out["dq"]["max_abs_err"] = errs["dQ"]
    out["dkv"]["max_abs_err"] = max(errs["dK"], errs["dV"])
    ours = out["dq"]["ms"] + out["dkv"]["ms"]
    dev = [out[key]["device_ms"] for key in ("dq", "dkv")]
    log(f"  flash bwd whole [{b}, {SEQ}, {h}, {d}] bf16 causal: kernels "
        f"dQ + dK/dV {ours:.4f} ms events, "
        f"{fmt_ms(None if None in dev else sum(dev))} device (Delta inside "
        f"dQ; the float32 route's torch Delta would add {delta_ms:.4f} "
        f"ms); library (F.scaled_dot_product_attention backward) "
        f"{library_ms:.4f} ms: kernels / library {ours / library_ms:.3f}; "
        f"bound {whole_ms:.4f} ms ({whole_by})")
    return out


def check_gpt3_shape(fa, failures, gen):
    """The three kernels at GPT-3 1.3B's training shape [8, 1024, 16, 128]
    (bf16, causal; q/k/v strided views of one fused QKV, as the model
    gives them): each against its plain version within the bf16 bounds,
    timed (CUDA events and profiled device time) beside its plain version,
    the library call and its bound. Returns {kernel name: fields}."""
    b, h, d, dt = GPT3_BATCH, GPT3_HEADS, GPT3_HEAD_DIM, torch.bfloat16
    x = torch.randn(b, SEQ, 3, h, d, generator=gen, device="cuda").to(dt)
    q, k, v = x.unbind(2)
    do = rand(gen, b, SEQ, h, d, dt)
    scale = d ** -0.5
    o, lse = fa.flash_attention_fwd(q, k, v, causal=True)
    dq, delta = fa.flash_attention_bwd_dq(q, k, v, o, do, lse, True)
    dk, dv = fa.flash_attention_bwd_dkv(q, k, v, do, lse, delta, True)
    torch.cuda.synchronize()
    ro, rlse = fa.flash_attention_fwd_reference(q, k, v, causal=True)
    rdq, rdelta = fa.flash_attention_bwd_dq_reference(q, k, v, o, do, lse,
                                                      True, scale)
    rdk, rdv = fa.flash_attention_bwd_dkv_reference(q, k, v, do, lse, rdelta,
                                                    True, scale)

    def err(got, want, tol):
        e = (got.float() - want.float()).abs()
        ok = bool((e <= tol["atol"] + tol["rtol"] * want.float().abs()).all()
                  and torch.isfinite(got.float()).all())
        return e.max().item(), ok

    fwd_tol = {"atol": TOL[dt]["o_atol"], "rtol": TOL[dt]["o_rtol"]}
    checks = {"flash_attention_fwd": [("O", o, ro, fwd_tol),
                                      ("lse", lse, rlse,
                                       {"atol": TOL[dt]["lse_atol"],
                                        "rtol": 0.0})],
              "flash_attention_bwd_dq": [("dQ", dq, rdq, BWD_TOL[dt]),
                                         ("Delta", delta, rdelta,
                                          BWD_TOL[torch.float32])],
              "flash_attention_bwd_dkv": [("dK", dk, rdk, BWD_TOL[dt]),
                                          ("dV", dv, rdv, BWD_TOL[dt])]}
    out = {}
    for name, parts in checks.items():
        worst, all_ok, text = 0.0, True, []
        for label, got, want, tol in parts:
            e, ok = err(got, want, tol)
            all_ok &= ok
            text.append(f"{label} {e:.3e} (tol {tol['atol']:g} + "
                        f"{tol['rtol']:g}*|ref|)")
            if label not in ("lse", "Delta"):
                worst = max(worst, e)
        log(f"  {name} [{b}, {SEQ}, {h}, {d}] bf16 causal vs plain: "
            f"max_abs_err {', '.join(text)} {'ok' if all_ok else 'FAIL'}")
        if not all_ok:
            failures.append(f"{name} at [{b}, {SEQ}, {h}, {d}] disagrees "
                            f"with its plain version")
        out[name] = {"max_abs_err": worst}
    del ro, rlse, rdq, rdk, rdv
    calls = {
        "flash_attention_fwd": (
            lambda: fa.flash_attention_fwd(q, k, v, causal=True),
            lambda: fa.flash_attention_fwd_reference(q, k, v, causal=True)),
        "flash_attention_bwd_dq": (
            lambda: fa.flash_attention_bwd_dq(q, k, v, o, do, lse, True),
            lambda: fa.flash_attention_bwd_dq_reference(q, k, v, o, do, lse,
                                                        True, scale)),
        "flash_attention_bwd_dkv": (
            lambda: fa.flash_attention_bwd_dkv(q, k, v, do, lse, delta, True),
            lambda: fa.flash_attention_bwd_dkv_reference(
                q, k, v, do, lse, delta, True, scale))}
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    lib_fwd = cuda_time_ms(lambda: torch.nn.functional
                           .scaled_dot_product_attention(qt, kt, vt,
                                                         is_causal=True), 20)
    xl = x.detach().requires_grad_()
    ql, kl, vl = (t.transpose(1, 2) for t in xl.unbind(2))
    lib_out = torch.nn.functional.scaled_dot_product_attention(
        ql, kl, vl, is_causal=True)
    lib_bwd = cuda_time_ms(lambda: torch.autograd.grad(
        lib_out, (ql, kl, vl), do.transpose(1, 2), retain_graph=True), 20)
    bounds = {"flash_attention_fwd": flash_bound(b, SEQ, SEQ, h, d, dt, True),
              "flash_attention_bwd_dq": bwd_bound(b, SEQ, h, d, dt, 5, 1, 3),
              "flash_attention_bwd_dkv": bwd_bound(b, SEQ, h, d, dt, 4, 2, 4)}
    for meta in KERNELS:
        name = meta["name"]
        kernel, plain = calls[name]
        bound_ms, bound_by = bounds[name]
        out[name].update(
            shape=[b, SEQ, h, d], ms=cuda_time_ms(kernel, 20),
            device_ms=device_ms(kernel, meta["kernel"]),
            plain_ms=cuda_time_ms(plain, 3, 1), bound_ms=bound_ms,
            bound_by=bound_by,
            library_ms=lib_fwd if name == "flash_attention_fwd" else lib_bwd)
        r = out[name]
        log(f"  {name} [{b}, {SEQ}, {h}, {d}] bf16 causal: kernel "
            f"{r['ms']:.4f} ms (events), {fmt_ms(r['device_ms'])} (profiled "
            f"device time), plain {r['plain_ms']:.4f} ms, library "
            f"{r['library_ms']:.4f} ms ("
            f"{'forward' if name == 'flash_attention_fwd' else 'whole backward'}"
            f"), bound {bound_ms:.4f} ms ({bound_by}), kernel / bound "
            f"{r['ms'] / bound_ms:.2f}")
    return out


def serve(model, serving, requests, spec, out_tail, buckets, failures,
          batch_timeout_ms=50.0):
    """A served path: a bf16 engine at ``buckets`` (one CUDA graph a
    bucket) fed a burst of concurrent requests, each result checked for
    shape (rows x ``out_tail``), dtype and finiteness, then 3 sequential
    requests of each bucket's size (the first request's first row
    repeated) for latency. Returns the engine's stats after the burst and
    at the end, per-bucket latencies, the burst's results and the kernel
    launches of the graph replays (``count_replays.launches``)."""
    with inspect_capture():  # the engine captures its graphs at load
        engine = serving.Engine.from_layer(
            model, spec, bucket_ladder=buckets, passes=("bf16",),
            batch_timeout_ms=batch_timeout_ms, device="cuda")
    counter = count_replays(engine)
    burst, latency = {}, {}

    def traffic():
        results = concurrent_requests(engine, requests)
        burst.update(engine.stats())
        latency.update((bucket, sequential_ms(engine, requests[0][:1].repeat(
            bucket, axis=0))) for bucket in engine.bucket_ladder)
        return [o[0] for o in results]

    try:
        results = counter.run(traffic)  # one run: it counts every replay
        for req, out in zip(requests, results):
            want = (req.shape[0], *out_tail)
            if out is None or out.shape != want or out.dtype != np.float32:
                failures.append(f"served output shape/dtype "
                                f"{None if out is None else out.shape} != {want}")
            elif not np.isfinite(out).all():
                failures.append("served output has non-finite values")
        stats = engine.stats()
    finally:
        engine.close()
    return burst, stats, latency, results, counter.launches()


def concurrent_requests(engine, requests):
    """Each request from its own thread at once; their results in order."""
    results = [None] * len(requests)

    def call(i):
        results[i] = engine.predict(requests[i])

    threads = [threading.Thread(target=call, args=(i,))
               for i in range(len(requests))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
        if t.is_alive():
            raise RuntimeError("a served request did not finish")
    return results


def sequential_ms(engine, batch, n=3):
    """Latency in ms of ``n`` requests of ``batch`` one after another."""
    times = []
    for _ in range(n):
        t0 = time.perf_counter()
        engine.predict(batch)
        times.append((time.perf_counter() - t0) * 1e3)
    return times


def make_optimizer(model, peak_lr=PEAK_LR, start_lr=START_LR):
    """The recipe's optimizer: AdamW with float32 masters for bf16
    parameters, decay on the weight matrices and embeddings only, a global
    norm clip at 1.0 and a linear warm-up over the warm-up steps."""
    from paddle_tpu_torch import nn, optimizer
    sched = optimizer.lr.LinearWarmup(peak_lr, WARMUP_STEPS, start_lr,
                                      peak_lr)
    opt = optimizer.AdamW(
        learning_rate=sched, parameters=model.parameters(),
        multi_precision=True, grad_clip=nn.ClipGradByGlobalNorm(1.0),
        apply_decay_param_fun=lambda n: not (n.endswith(".bias")
                                             or ".ln" in n))
    return opt, sched


def key_bias_split(name, x, hidden):
    """(the part of a tensor compared elementwise, and the key third of a
    qkv.bias, whose gradient is exactly zero, or None)."""
    if name.endswith("qkv.bias"):
        return (torch.cat([x[:hidden], x[2 * hidden:]]),
                x[hidden:2 * hidden])
    return x, None


def f32_step(model, make_opt, run_loss):
    """One float32 training step of ``model`` on its device: (loss, grads,
    updates p_new - p_old), all on the CPU. ``run_loss(model, device)``
    gives the loss, ``make_opt(model)`` the optimizer."""
    model.train()
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    opt = make_opt(model)
    loss = run_loss(model, model.parameters()[0].device)
    loss.backward()
    grads = {n: p.grad.detach().cpu() for n, p in model.named_parameters()}
    opt.step()
    updates = {n: (p.detach() - before[n]).cpu()
               for n, p in model.named_parameters()}
    return loss.item(), grads, updates


def check_f32_step(model, make_opt, run_loss, lr, label, failures):
    """A float32 step on the card vs the same step on the CPU: the loss,
    every gradient and every update (``lr`` the step's learning rate)."""
    t0 = time.perf_counter()
    card = f32_step(copy.deepcopy(model), make_opt, run_loss)
    t1 = time.perf_counter()
    cpu = f32_step(copy.deepcopy(model).to("cpu"), make_opt, run_loss)
    log(f"  float32 step, {label}: card {t1 - t0:.2f} s, CPU "
        f"{time.perf_counter() - t1:.2f} s (set-up included)")
    hidden = model.config.hidden_size
    loss_rel = abs(card[0] - cpu[0]) / abs(cpu[0])
    ok = loss_rel <= STEP_LOSS_REL_TOL
    worst_grad = max((float((card[1][n] - g).norm() / g.norm()), n)
                     for n, g in cpu[1].items())
    ok &= worst_grad[0] <= STEP_GRAD_REL_L2_TOL
    worst_upd, worst_zero = (0.0, ""), 0.0
    for n, u in cpu[2].items():
        mine, zero = key_bias_split(n, card[2][n], hidden)
        theirs, zero_cpu = key_bias_split(n, u, hidden)
        worst_upd = max(worst_upd, (float((mine - theirs).norm()
                                          / theirs.norm()), n))
        if zero is not None:
            worst_zero = max(worst_zero,
                             float((zero - zero_cpu).abs().max()) / lr)
    ok &= worst_upd[0] <= STEP_UPDATE_REL_L2_TOL
    ok &= worst_zero <= ZERO_GRAD_UPDATE_MAX
    log(f"  float32 step card vs CPU: loss {card[0]:.6f} vs {cpu[0]:.6f} "
        f"(rel {loss_rel:.3e}, tol {STEP_LOSS_REL_TOL:g}); worst grad rel "
        f"L2 {worst_grad[0]:.3e} ({worst_grad[1]}, tol "
        f"{STEP_GRAD_REL_L2_TOL:g}); worst update rel L2 {worst_upd[0]:.3e} "
        f"({worst_upd[1]}, tol {STEP_UPDATE_REL_L2_TOL:g}); key bias "
        f"update max diff {worst_zero:.3f} x lr (tol "
        f"{ZERO_GRAD_UPDATE_MAX:g}) {'ok' if ok else 'FAIL'}")
    if not ok:
        failures.append(f"float32 training step ({label}): card disagrees "
                        f"with CPU")


def profile_step(step_fn):
    """One step under torch.profiler: device busy time and launches by
    kernel and the device's idle share of the step's wall time (None if the
    profiler saw no device activity)."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()  # the trace starts on an idle device
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step_fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    by_name, counts = {}, {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            by_name[e.name] = (by_name.get(e.name, 0.0)
                               + e.time_range.elapsed_us())
            counts[e.name] = counts.get(e.name, 0) + 1
    busy_us = sum(by_name.values())
    if not busy_us:
        return None
    return (wall_us, busy_us, sorted(by_name.items(), key=lambda kv: -kv[1]),
            counts)


def train(model, ids, fa, failures):
    """The trained path: float32 step check, then the bf16 recipe for
    ``TRAIN_STEPS`` steps with launch counts zeroed just before and read
    just after. Returns the launch counts."""
    from paddle_tpu_torch import amp
    from paddle_tpu_torch.observability import StepTimer
    cfg = model.config

    def gpt_loss(m, device):
        ids1 = torch.from_numpy(ids[:1]).to(device)
        return m.loss(m(ids1), ids1)

    check_f32_step(model, lambda m: make_optimizer(m)[0], gpt_loss,
                   START_LR, "GPT-small batch 1", failures)
    ids_t = torch.from_numpy(ids).to(model.parameters()[0].device)
    model.train()
    with torch.no_grad():
        loss32 = model.loss(model(ids_t), ids_t).item()

    model.to("bfloat16")
    opt, sched = make_optimizer(model)
    timer = StepTimer(window=TRAIN_STEPS - WARMUP_STEPS,
                      tokens_per_step=ids.size,
                      flops_per_token=model.flops_per_token(SEQ),
                      peak_flops=PEAK_FLOPS[torch.bfloat16])

    def one_step():
        with amp.auto_cast(enable=True, dtype="bfloat16"):
            loss = model.loss(model(ids_t), ids_t)
        loss.backward()
        opt.step()
        opt.clear_grad()
        sched.step()
        return loss.item()  # the host waits for the step here

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    counters = (fa.flash_attention_fwd, fa.flash_attention_bwd_dq,
                fa.flash_attention_bwd_dkv)
    fa.reset_launch_counts()
    losses, tel = [], None
    for step in range(TRAIN_STEPS):
        if step == WARMUP_STEPS:
            timer.start()
        losses.append(one_step())
        if step >= WARMUP_STEPS:
            tel = timer.step()
    launches = {c.__name__: c.launches for c in counters}
    bf16_launches = {c.__name__: c.variant_launches["bf16"] for c in counters}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    log(f"  losses: {[round(x, 4) for x in losses]}")
    want = cfg.num_layers * TRAIN_STEPS
    for name, n in launches.items():
        log(f"  {name} launches: {n} over {TRAIN_STEPS} steps "
            f"({n / TRAIN_STEPS:g} a step; want {cfg.num_layers}), "
            f"{bf16_launches[name]} of them on the bf16 variant")
        if n != want:
            failures.append(f"{name} launched {n} times, not {want}")
        if bf16_launches[name] != n:
            failures.append(f"{name}: {n - bf16_launches[name]} training "
                            f"launches off the bf16 variant")
    if not all(np.isfinite(losses)):
        failures.append("a training loss is not finite")
    if not losses[-1] < losses[0]:
        failures.append(f"loss did not fall: {losses[0]} -> {losses[-1]}")
    amp_rel = abs(losses[0] - loss32) / abs(loss32)
    ok = amp_rel <= AMP_LOSS_REL_TOL
    log(f"  bf16 AMP loss of step 1 {losses[0]:.6f} vs float32 loss "
        f"{loss32:.6f}: rel {amp_rel:.3e} (tol {AMP_LOSS_REL_TOL:g}) "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        failures.append("bf16 AMP loss disagrees with the float32 loss")
    log(f"  {card_line()}")
    log(f"  StepTimer over {tel['window_steps']} steps: step "
        f"{tel['step_time_ms']:.3f} ms, {tel['tokens_per_s']:.1f} tokens/s, "
        f"MFU {tel['mfu']:.4f} (flops_per_token "
        f"{model.flops_per_token(SEQ)}, peak {PEAK_FLOPS[torch.bfloat16]:g} "
        f"FLOP/s: H100 SXM dense bf16)")
    log(f"  peak device memory (max_memory_allocated): {peak_gb:.3f} GB")
    def counted_step():  # the wrappers count the profiled step exactly
        fa.reset_launch_counts()
        return one_step()

    prof = report_profile("training step", profile_retry(counted_step),
                          failures)
    check_launches("profiled step", {c.__name__: c.launches
                                     for c in counters},
                   {c.__name__: c.launches - c.variant_launches["bf16"]
                    for c in counters}, prof,
                   {c.__name__: cfg.num_layers for c in counters}, failures,
                   by="by the wrappers")
    step_ms = {}  # device ms per launch of each kernel in the profiled step
    if prof is not None:
        for meta in KERNELS:
            hits = [(us, prof["counts"][n]) for n, us in prof["top"]
                    if meta["kernel"] in n]
            us = sum(u for u, _ in hits)
            n = sum(c for _, c in hits)
            if n:
                step_ms[meta["name"]] = us / n / 1e3
            log(f"  profiled step: {meta['name']} ({meta['kernel']}) "
                f"{fmt_ms(us / n / 1e3 if n else None)} device time per "
                f"launch over the {n} the trace shows")
    return launches, bf16_launches, step_ms, tel["step_time_ms"]


def report_profile(label, prof, failures, kinds=None):
    """Print a profiled run's wall, device busy time, idle share, device
    time by kernel kind (``kinds``, default ``KINDS``) and largest kernels;
    returns them (with the launches and device time by kernel name and
    kind) or None."""
    if prof is None:
        failures.append(f"the profiled {label} recorded no device activity "
                        f"in 3 attempts")
        return None
    wall_us, busy_us, top, counts = prof
    idle = 1 - busy_us / wall_us
    log(f"  profiled {label}: wall {wall_us / 1e3:.3f} ms, device busy "
        f"{busy_us / 1e3:.3f} ms, idle share {idle:.4f}")
    by_kind = {}
    for name, us in top:
        kind = next((k for k, keys in kinds or KINDS
                     if any(w in name for w in keys)), "other")
        by_kind[kind] = by_kind.get(kind, 0.0) + us
    log("    device time by kind: " + ", ".join(
        f"{k} {us / 1e3:.3f} ms ({us / busy_us:.1%})"
        for k, us in sorted(by_kind.items(), key=lambda kv: -kv[1])))
    for name, us in top[:12]:
        log(f"    {us / 1e3:9.3f} ms {us / busy_us:7.2%}  {name[:110]}")
    return {"wall_ms": wall_us / 1e3, "busy_ms": busy_us / 1e3,
            "idle": idle, "counts": counts, "top": top,
            "by_kind_ms": {k: us / 1e3 for k, us in by_kind.items()}}


# Kernel kinds of a profiled run, by substrings of the CUDA function name
# (first match wins).
KINDS = [("attention kernels (hand-written)", ("flash_",)),
         ("GEMM", ("nvjet", "gemm", "cutlass", "xmma", "cublas")),
         ("reductions and softmax", ("reduce_kernel", "softmax")),
         ("copies and casts", ("copy",)),
         ("LayerNorm", ("layer_norm", "LayerNorm", "GammaBeta")),
         ("embedding, gather, scatter, index", ("embedding", "gather",
                                                "scatter", "index")),
         ("elementwise", ("elementwise",))]


def profile_retry(fn):
    for _ in range(3):  # a profiler session now and then records nothing
        prof = profile_step(fn)
        if prof is not None:
            return prof
    return None


def compare_runs(label, want_losses, got_losses, want_model, got_model,
                 failures, want_opt=None, got_opt=None):
    """The k-step program's losses, final parameters and buffers (and, given
    the two optimizers, every slot of their state) against the eager
    run's, within ``KSTEP_MAX_ABS_TOL``."""
    loss_diff = float((got_losses.float() - want_losses.float()).abs().max())
    worst = (0.0, "")

    def diff(a, b):
        return float((a.detach().float() - b.detach().float()).abs().max())

    for (n, p), q in zip(want_model.named_parameters(),
                         got_model.parameters()):
        worst = max(worst, (diff(p, q), n))
        for slot in want_opt._slot_names() if want_opt is not None else ():
            worst = max(worst, (diff(want_opt._get_accumulator(slot, p),
                                     got_opt._get_accumulator(slot, q)),
                                f"{n}.{slot}"))
    for (n, b), c in zip(want_model.named_buffers(), got_model.buffers()):
        worst = max(worst, (diff(b, c), n))
    what = "parameters" + (", buffers" if list(want_model.buffers())
                           else "") + (" and optimizer state"
                                       if want_opt is not None else "")
    ok = loss_diff <= KSTEP_MAX_ABS_TOL and worst[0] <= KSTEP_MAX_ABS_TOL
    ok &= bool(torch.isfinite(got_losses).all())
    log(f"  {label}: k-step vs eager, {got_losses.numel()} losses max |diff| "
        f"{loss_diff:.3e}, {what} max |diff| {worst[0]:.3e} ({worst[1]}) "
        f"(tol {KSTEP_MAX_ABS_TOL:g}: bitwise) {'ok' if ok else 'FAIL'}")
    if not ok:
        failures.append(f"{label}: the k-step program disagrees with the "
                        f"same eager steps")


def timed_eager(one_step, steps, warmup, tokens, flops_per_token):
    """``steps`` eager steps (each ends when the host reads its loss) with
    a StepTimer over those after ``warmup``: (losses, telemetry, peak GB)."""
    from paddle_tpu_torch.observability import StepTimer
    timer = StepTimer(window=steps - warmup, tokens_per_step=tokens,
                      flops_per_token=flops_per_token,
                      peak_flops=PEAK_FLOPS[torch.bfloat16])
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    losses, tel = [], None
    for step in range(steps):
        if step == warmup:
            timer.start()
        losses.append(one_step().item())
        if step >= warmup:
            tel = timer.step()
    peak = (torch.cuda.max_memory_allocated() - before) / 1e9
    log(f"  eager steps: peak memory above the {before / 1e9:.3f} GB "
        f"allocated before them: {peak:.3f} GB")
    return losses, tel, peak


def first_kstep_call(label, call):
    """The first call of a k-step program (inner step 0 eagerly, the
    capture, k - 1 replays): its output, and its memory: the peak allocated
    during the call above what was allocated before it (the program's
    working set: the eager step's activations and the graph's pool)."""
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = call()
    torch.cuda.synchronize()
    peak = (torch.cuda.max_memory_allocated() - before) / 1e9
    log(f"  {label}: first call (eager warm-up, capture, replays) "
        f"{time.perf_counter() - t0:.3f} s; peak memory above the "
        f"{before / 1e9:.3f} GB allocated before it: {peak:.3f} GB; "
        f"reserved {torch.cuda.memory_reserved() / 1e9:.3f} GB")
    return out, peak


def timed_kstep(call, k, calls, tokens_per_step, flops_per_token):
    """``calls`` calls of a k-step program (each ends when the host reads
    its [k] losses) with a StepTimer marking each call as k steps:
    (losses by call, telemetry)."""
    from paddle_tpu_torch.observability import StepTimer
    timer = StepTimer(window=calls, flops_per_token=flops_per_token,
                      peak_flops=PEAK_FLOPS[torch.bfloat16])
    torch.cuda.synchronize()
    timer.start()
    out, tel = [], None
    for _ in range(calls):
        out.append(call().cpu())  # the host reads the k losses once a call
        tel = timer.step(tokens=k * tokens_per_step)
    return out, tel


def log_rate(label, tel, k, flops_per_token, peak_gb, prof):
    step_ms = tel["step_time_ms"] / k
    idle = "not measured" if prof is None else f"{prof['idle']:.4f}"
    log(f"  {label}: step {step_ms:.3f} ms ({k} a mark, StepTimer over "
        f"{tel['window_steps']} marks), {tel['tokens_per_s']:.1f} tokens/s, "
        f"MFU {tel['mfu']:.4f} (flops_per_token {flops_per_token}, peak "
        f"{PEAK_FLOPS[torch.bfloat16]:g} FLOP/s: H100 SXM dense bf16), peak "
        f"memory above what was allocated before {peak_gb:.3f} GB, idle share "
        f"{idle}")
    return {"step_ms": step_ms, "tokens_per_s": tel["tokens_per_s"],
            "mfu": tel["mfu"], "peak_gb_above_before": peak_gb,
            "idle_share": None if prof is None else prof["idle"],
            "profiled_busy_ms": None if prof is None else prof["busy_ms"],
            "profiled_wall_ms": None if prof is None else prof["wall_ms"]}


def bench_one_step(pt, model, opt):
    """bench.py's one_step: forward and loss under bf16 auto_cast, backward,
    the AdamW step and clear_grad; returns the loss tensor."""
    def one_step(ids, tok, labels, nsp):
        with pt.amp.auto_cast(enable=True, dtype="bfloat16"):
            logits, nsp_logits = model(ids, tok)
            loss = model.loss(logits, nsp_logits, labels, nsp)
        loss.backward()
        opt.step()
        opt.clear_grad()
        return loss
    return one_step


def check_dropout_under_capture(pt, failures):
    """A dropout draw inside the k-step program on the card: each inner
    step and each call draws a new mask, or the capture raises."""
    from paddle_tpu_torch import jit
    from paddle_tpu_torch.nn import functional as F
    pt.seed(7)
    step = jit.to_static(lambda x: F.dropout(x, 0.5), scan_steps=4)
    x = torch.ones(4, 8, 256, device="cuda")
    try:
        masks = torch.cat([step(x) != 0 for _ in range(3)])
    except NotImplementedError as e:
        log(f"  dropout under capture raises, as it must without a "
            f"graph-safe generator: {e}")
        return
    distinct = len({tuple(m.flatten().tolist()) for m in masks.cpu()})
    keep = float(masks.float().mean())
    ok = distinct == masks.shape[0] and abs(keep - 0.5) < 0.05
    log(f"  dropout under capture: {distinct} distinct masks over "
        f"{masks.shape[0]} inner steps (3 calls x 4), keep rate {keep:.4f} "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        failures.append("dropout masks repeat under the captured program")


def bert(pt, fa, seed, failures):
    """Phases 5 and 6: BERT-base, float32 card vs CPU, then bench.py's
    recipe eagerly and through the k-step program."""
    from paddle_tpu_torch import jit, optimizer
    from paddle_tpu_torch.models.bert import (BertForPretraining, bert_base,
                                              synthetic_mlm_batch)
    cfg = bert_base(vocab_size=BERT_VOCAB, hidden_dropout=0.0,
                    attention_dropout=0.0)
    pt.seed(seed)
    base = BertForPretraining(cfg, device="cuda")
    fpt = base.flops_per_token(BERT_SEQ)
    log(f"  model: vocab {cfg.vocab_size} hidden {cfg.hidden_size} layers "
        f"{cfg.num_layers} heads {cfg.num_heads}, "
        f"{sum(p.numel() for p in base.parameters())} parameters "
        f"({len(list(base.parameters()))} tensors), flops_per_token"
        f"({BERT_SEQ}) {fpt}")

    small = synthetic_mlm_batch(BERT_F32_BATCH, BERT_F32_SEQ, BERT_VOCAB,
                                seed=seed + 2)

    def bert_loss(m, device):
        t = [torch.from_numpy(a).to(device) for a in small]
        return m.loss(*m(t[0], t[1]), t[2], t[3])

    log(f"phase 5: BERT-base float32 step, card vs CPU, "
        f"{BERT_F32_BATCH} x {BERT_F32_SEQ}")
    check_f32_step(base, lambda m: optimizer.AdamW(
        parameters=m.parameters(), learning_rate=BERT_LR), bert_loss,
        BERT_LR, f"BERT-base {BERT_F32_BATCH} x {BERT_F32_SEQ}", failures)

    log(f"phase 6: BERT-base, bench.py's recipe: {BERT_BATCH} x {BERT_SEQ}, "
        f"bf16 parameters, AdamW(lr={BERT_LR:g}, multi_precision=True), "
        f"bf16 auto_cast; eager, then to_static(one_step, "
        f"scan_steps={KSTEP})")
    batches = [synthetic_mlm_batch(BERT_BATCH, BERT_SEQ, BERT_VOCAB,
                                   seed=seed + 10 + i) for i in range(KSTEP)]
    stacked = [torch.from_numpy(np.stack(col)).cuda() for col in zip(*batches)]
    first = [t[0] for t in stacked]
    with torch.no_grad():
        loss32 = base.loss(*base(first[0], first[1]), first[2],
                           first[3]).item()
    base.to("bfloat16")
    twin_eager, twin_kstep = copy.deepcopy(base), copy.deepcopy(base)
    tokens = BERT_BATCH * BERT_SEQ

    def adamw(m):
        return optimizer.AdamW(parameters=m.parameters(),
                               learning_rate=BERT_LR, multi_precision=True)

    # (a) eager: 2 warm-up and 10 timed steps on one batch
    step_a = bench_one_step(pt, base, adamw(base))
    fa.reset_launch_counts()
    losses, tel, peak = timed_eager(lambda: step_a(*first), TRAIN_STEPS,
                                    WARMUP_STEPS, tokens, fpt)
    launches = sum(w.launches for w in (fa.flash_attention_fwd,
                                        fa.flash_attention_bwd_dq,
                                        fa.flash_attention_bwd_dkv))
    log(f"  (a) eager losses: {[round(x, 4) for x in losses]}")
    log(f"  (a) hand-written kernel launches: {launches} (BERT's seq "
        f"{BERT_SEQ} stays below the flash gate of 1024: none expected)")
    if launches:
        failures.append(f"BERT launched {launches} flash kernels at seq "
                        f"{BERT_SEQ}")
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        failures.append(f"BERT eager losses not finite and falling: "
                        f"{losses}")
    amp_rel = abs(losses[0] - loss32) / abs(loss32)
    ok = amp_rel <= AMP_LOSS_REL_TOL
    log(f"  bf16 AMP loss of step 1 {losses[0]:.6f} vs float32 loss "
        f"{loss32:.6f}: rel {amp_rel:.3e} (tol {AMP_LOSS_REL_TOL:g}) "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        failures.append("BERT bf16 AMP loss disagrees with the float32 loss")
    prof = report_profile("eager BERT step", profile_retry(
        lambda: step_a(*first).item()), failures)
    log(f"  {card_line()}")
    eager = log_rate("(a) BERT-base eager", tel, 1, fpt, peak, prof)

    # (c) equivalence: 20 eager steps vs one call of the k-step program,
    # from the same weights, on 20 different microbatches
    step_e = bench_one_step(pt, twin_eager, adamw(twin_eager))
    want = torch.stack([step_e(*(t[i] for t in stacked))
                        for i in range(KSTEP)]).detach()
    program = jit.to_static(bench_one_step(pt, twin_kstep, adamw(twin_kstep)),
                            scan_steps=KSTEP)
    got, peak = first_kstep_call("(b) BERT-base k-step",
                                 lambda: program(*stacked))
    compare_runs("(c) BERT-base", want, got, twin_eager, twin_kstep,
                 failures)
    del twin_eager, step_e

    # (b) the k-step program, timed
    calls, tel = timed_kstep(lambda: program(*stacked), KSTEP,
                             KSTEP_TIMED_CALLS, tokens, fpt)
    prof = report_profile(f"k-step BERT call ({KSTEP} steps)", profile_retry(
        lambda: program(*stacked).cpu()), failures)
    kstep_losses = torch.cat([got.cpu()] + calls)
    log(f"  (b) k-step losses, first and last of each call: "
        f"{[(round(float(c[0]), 4), round(float(c[-1]), 4)) for c in [got.cpu()] + calls]}")
    if (not bool(torch.isfinite(kstep_losses).all())
            or not kstep_losses[-1] < kstep_losses[0]):
        failures.append("BERT k-step losses not finite and falling")
    kstep = log_rate(f"(b) BERT-base k-step (scan_steps={KSTEP}, CUDA graph)",
                     tel, KSTEP, fpt, peak, prof)
    log(f"  BERT-base step: eager {eager['step_ms']:.3f} ms, k-step "
        f"{kstep['step_ms']:.3f} ms ({eager['step_ms'] / kstep['step_ms']:.2f}x)")

    # (d) bench.py's default structure, to_static(k_steps): one program
    # whose graph holds all k steps (on one repeated batch), against the
    # k-step program's graph of one step replayed k times
    del program, twin_kstep
    unrolled_model = copy.deepcopy(base)
    one = bench_one_step(pt, unrolled_model, adamw(unrolled_model))

    def k_steps(ids, tok, labels, nsp):
        for _ in range(KSTEP):
            loss = one(ids, tok, labels, nsp)
        return loss

    unrolled = jit.to_static(k_steps)
    last, upeak = first_kstep_call(f"(d) to_static(k_steps), {KSTEP} steps "
                                   f"in one graph", lambda: unrolled(*first))
    calls, tel = timed_kstep(lambda: unrolled(*first).reshape(1), KSTEP,
                             KSTEP_TIMED_CALLS, tokens, fpt)
    uprof = report_profile(f"to_static(k_steps) BERT call ({KSTEP} steps)",
                           profile_retry(lambda: unrolled(*first).item()),
                           failures)
    if not all(bool(torch.isfinite(c).all()) for c in [last.cpu()] + calls):
        failures.append("BERT to_static(k_steps) loss not finite")
    whole = log_rate(f"(d) BERT-base to_static(k_steps) ({KSTEP} steps, one "
                     f"graph)", tel, KSTEP, fpt, upeak, uprof)
    check_dropout_under_capture(pt, failures)
    return {"eager": eager, "kstep": kstep, "unrolled_graph": whole}


def gpt_kstep(pt, fa, seed, eager_step_ms, failures):
    """Phase 7: GPT-small through the k-step program with phase 4's recipe;
    returns the profiled replayed call's launches by kernel and timings."""
    from paddle_tpu_torch import jit
    from paddle_tpu_torch.models.gpt import (GPTForCausalLM, gpt_small,
                                             synthetic_lm_batch)
    k = GPT_KSTEP
    cfg = gpt_small(hidden_dropout=0.0, attention_dropout=0.0)
    pt.seed(seed + 3)
    model = GPTForCausalLM(cfg, device="cuda").to("bfloat16")
    twin = copy.deepcopy(model)
    stacked = torch.from_numpy(np.stack([
        synthetic_lm_batch(TRAIN_BATCH, SEQ, cfg.vocab_size, seed=seed + 30 + i)
        for i in range(k)])).cuda()

    def body_for(m):
        opt, sched = make_optimizer(m)

        def one_step(ids):
            with pt.amp.auto_cast(enable=True, dtype="bfloat16"):
                loss = m.loss(m(ids), ids)
            loss.backward()
            opt.step()
            opt.clear_grad()
            return loss
        return one_step, sched

    eager_step, eager_sched = body_for(model)
    body, sched = body_for(twin)
    program = jit.to_static(body, scan_steps=k)
    want, got = [], []
    for call in range(2):  # the scheduler steps between calls on both sides
        want += [eager_step(stacked[i]).detach() for i in range(k)]
        eager_sched.step()
        if call == 0:
            with inspect_capture():  # its graph keeps its nodes
                out, peak = first_kstep_call("GPT-small k-step",
                                             lambda: program(stacked))
        else:
            out = program(stacked)
        got.append(out)
        sched.step()
    compare_runs(f"GPT-small, 2 calls of scan_steps={k}", torch.stack(want),
                 torch.cat(got), model, twin, failures)
    del model, eager_step

    calls, tel = timed_kstep(lambda: program(stacked), k,
                             KSTEP_TIMED_CALLS, stacked[0].numel(),
                             twin.flops_per_token(SEQ))
    losses = torch.cat([g.cpu() for g in got] + calls)
    if not bool(torch.isfinite(losses).all()) or not losses[-1] < losses[0]:
        failures.append("GPT k-step losses not finite and falling")
    fa.reset_launch_counts()
    replays = count_replays(program)
    prof = report_profile(f"k-step GPT call ({k} steps)", profile_retry(
        lambda: replays.run(lambda: program(stacked).cpu())), failures)
    counted = sum(w.launches for w in (fa.flash_attention_fwd,
                                       fa.flash_attention_bwd_dq,
                                       fa.flash_attention_bwd_dkv))
    log(f"  wrapper launch counts over the replayed calls: {counted} (a "
        f"replay runs no Python; the graph's nodes count below)")
    launches, off = replays.launches()
    check_launches("replayed GPT k-step call", launches, off, prof,
                   {meta["name"]: cfg.num_layers * k for meta in KERNELS},
                   failures)
    rate = log_rate(f"GPT-small k-step (scan_steps={k}, CUDA graph)", tel, k,
                    twin.flops_per_token(SEQ), peak, prof)
    if eager_step_ms is not None:  # phase 4 ran
        log(f"  GPT-small step: eager (phase 4) {eager_step_ms:.3f} ms, "
            f"k-step {rate['step_ms']:.3f} ms "
            f"({eager_step_ms / rate['step_ms']:.2f}x)")
    return launches, rate


# ---- phase 8: ZeRO data parallelism and activation recompute ----------------

# NCCL at one rank implements a reduce-scatter or an all-gather as one
# device-to-device copy of the whole payload (no ring kernel runs): a
# captured graph holds each as one memcpy node of the payload's bytes,
# which tell the collectives apart (a bucket of r rows reduce-scatters
# r x 1024 float32 gradients and all-gathers r x 1024 bf16 parameters).
ZERO_ACCUM = 4               # bench.py --accumulate for the ZeRO-2 arm
# ZeRO-2/3 accumulation windows fold float32 mean shards of each micro
# step, where the accumulating control sums the micro steps' gradients on
# the parameters, in their dtype (the reference's tolerance-level case).
# With float32 parameters both sums are float32, in one order at one rank,
# so that witness pair is held bitwise over every window. With bf16
# parameters the first window's losses precede any update and are bitwise,
# and the second window's are one update apart, held to
# ZERO_ACCUM_LOSS_REL; the later windows' losses are reported. The float32
# masters are held: the arm's distance from the control's masters over the
# distance the control's masters travelled (L2), within
# ZERO_ACCUM_MASTER_REL. A window that keeps only its last micro step's
# gradients (the control's body clearing them before that step's backward)
# must land beyond the bound, so the bound tells a wrong window apart. The
# bound sits between the two readings of the first run of this check at
# seed 0 (the arm 0.201, the wrong window 0.753; both runs are
# deterministic), 1.7x the one and 2.2x below the other.
ZERO_ACCUM_LOSS_REL = 1e-3
ZERO_ACCUM_MASTER_REL = 0.35
BF16_STEP = 2.0 ** -8
RECOMPUTE_DROPOUT = 0.1      # the recompute-with-dropout check's rate
RECOMPUTE_DROPOUT_K = 4


def device_copies_by_bytes(fn):
    """{bytes: count} of the device-to-device copies in one call of ``fn``,
    from the profiler's trace (CUDA activity only)."""
    import collections
    import os
    import tempfile
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    return collections.Counter(
        e["args"]["bytes"] for e in events
        if e.get("cat") == "gpu_memcpy" and "DtoD" in e.get("name", "")
        and "bytes" in e.get("args", {}))


class inspect_capture:
    """Within the block, every CUDA graph a program captures keeps its
    nodes (``keep_graph=True``; the graph is instantiated at its first
    replay) and the collectives Python issues while it is captured are
    counted (``collective.counts()``)."""

    def __enter__(self):
        from paddle_tpu_torch.distributed import collective
        self.graphs, self.counts = [], []
        self.saved = torch.cuda.CUDAGraph, torch.cuda.graph
        graph_cls, graph_ctx = self.saved
        graphs, counts = self.graphs, self.counts

        def keep_graph():
            g = graph_cls(keep_graph=True)
            graphs.append(g)
            return g

        class counted(graph_ctx):
            def __enter__(self):
                collective.reset_counts()
                return super().__enter__()

            def __exit__(self, *exc):
                out = super().__exit__(*exc)
                counts.append(collective.counts())
                return out

        torch.cuda.CUDAGraph, torch.cuda.graph = keep_graph, counted
        return self

    def __exit__(self, *exc):
        torch.cuda.CUDAGraph, torch.cuda.graph = self.saved
        return False


def graph_dot(graph):
    """The nodes of a kept graph as CUDA's DOT print (``debug_dump``),
    one string a node."""
    import os
    import tempfile
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "graph.dot")
        graph.debug_dump(path)
        with open(path) as f:
            return f.read().split("];")


def graph_copies(graph):
    """{bytes: count} of the memcpy nodes of a kept graph."""
    import collections
    widths = collections.Counter()
    for node in graph_dot(graph):
        if "\nMEMCPY" in node:
            m = re.search(r"\{Width \| (\d+)\}", node)
            if m is None:
                raise RuntimeError("a memcpy node of the graph without its "
                                   "extent: " + node[:200])
            widths[int(m.group(1))] += 1
    return widths


class count_replays:
    """Each kernel's launches in a call of ``program`` (whose graphs were
    captured under ``inspect_capture``), exactly: ``run`` makes the call
    and counts the replays of each captured unit; ``launches`` then reads
    the kernel nodes of each unit's graph, on the bf16 and on the
    CUDA-core variant, times its replays. Returns ({kernel: launches},
    {kernel: launches off the bf16 variant})."""

    def __init__(self, program):
        self.units = list(program._programs.values())
        self.replays = [0] * len(self.units)

    def run(self, call):
        self.replays = replays = [0] * len(self.units)

        def counted(i, replay):
            def wrapper(*args):
                replays[i] += 1
                return replay(*args)
            return wrapper

        for i, unit in enumerate(self.units):
            unit.replay = counted(i, unit.replay)
        try:
            return call()
        finally:
            for unit in self.units:
                del unit.replay  # the class's method again

    def launches(self):
        launches = {meta["name"]: 0 for meta in KERNELS}
        off = dict(launches)
        for unit, n in zip(self.units, self.replays):
            if not n:
                continue
            nodes = graph_dot(unit.graph)
            for meta in KERNELS:
                launches[meta["name"]] += n * sum(meta["kernel"] in node
                                                  for node in nodes)
                off[meta["name"]] += n * sum(meta["cuda_core"] in node
                                             for node in nodes)
        return launches, off


def check_launches(label, exact, off, prof, want, failures,
                   by="from the graph"):
    """Each kernel's launches in a profiled call: ``exact`` (the wrappers'
    counts of an eager call, or a replayed call's from its graph:
    ``count_replays``) must be ``want`` with none off the bf16
    variant, and the profiler's trace of the same call must show the
    kernel's CUDA function, at most that often (the trace drops a record
    now and then; the shortfall is printed)."""
    counts = {} if prof is None else prof["counts"]
    for meta in KERNELS:
        name = meta["name"]
        seen = sum(c for fn, c in counts.items() if meta["kernel"] in fn)
        ok = exact[name] == want[name] and not off[name] and (
            0 < seen <= exact[name])
        log(f"  {label}: {name} ({meta['kernel']}) {exact[name]} launches "
            f"{by} (want {want[name]}), {off[name]} on the "
            f"CUDA-core variant; the profiler's trace shows {seen} "
            f"({exact[name] - seen} records dropped) {'ok' if ok else 'FAIL'}")
        if not ok:
            failures.append(f"{label}: {meta['kernel']} launched "
                            f"{exact[name]} times ({off[name]} off the bf16 "
                            f"variant), the profiler saw {seen}; want "
                            f"{want[name]}")


def init_dp_mesh():
    """A one-rank NCCL process group on this card (its rendezvous on a free
    localhost port) and the dp mesh over it: the card runs the code that a
    larger world runs, at dp = 1."""
    from paddle_tpu_torch.distributed import parallel_env
    parallel_env.init_parallel_env(device="cuda")
    return parallel_env.set_mesh(parallel_env.make_mesh({"dp": 1}))


def compare_arm(label, want_losses, got_losses, want_params, model,
                failures):
    """An arm's losses and final parameters against its control's,
    bitwise. Returns the max diffs."""
    loss_diff = float((got_losses.float() - want_losses.float()).abs().max())
    loss_rel_diff = float(((got_losses.float() - want_losses.float()).abs()
                           / want_losses.float().abs()).max())
    worst = (0.0, "")
    for (n, p), q in zip(model.named_parameters(), want_params):
        worst = max(worst, (float((p.detach().float() - q.float()).abs()
                                  .max()), n))
    ok = (loss_diff == 0.0 and worst[0] == 0.0
          and bool(torch.isfinite(got_losses).all()))
    log(f"  {label}: {got_losses.numel()} losses max |diff| {loss_diff:.3e} "
        f"(relative {loss_rel_diff:.3e}), parameters max |diff| "
        f"{worst[0]:.3e} ({worst[1]}) (tol 0: bitwise) "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        failures.append(f"{label}: disagrees with its control")
        log(f"    control losses {want_losses.tolist()}")
        log(f"    arm losses     {got_losses.tolist()}")
    return {"loss_max_abs_diff": loss_diff, "param_max_abs_diff": worst[0],
            "bitwise": ok}


def masters_of(opt, model):
    """The optimizer's float32 masters, flat, in the model's parameter
    order (under ZeRO at one rank a bucket's shard is the whole bucket)."""
    if opt._zero is None:
        parts = [opt._accumulators[("master", id(p))]
                 for p in model.parameters()]
    else:
        seg = {}
        for b in opt._zero.buckets:
            for p, s in zip(b.params, b.segments(b.stores["master"])):
                seg[id(p)] = s
        parts = [seg[id(p)] for p in model.parameters()]
    return torch.cat([t.detach().reshape(-1).float() for t in parts])


def zero_bert_arms(pt, fa, seed, failures):
    """Phase 8a: bench.py's BERT-base recipe through to_static(one_step,
    scan_steps=20, dp_axis="dp") on the one-rank mesh: the nine arms, each
    against its control over two calls, then each timed and profiled; two
    witnesses of the accumulation windows (float32 parameters; a window
    that keeps only its last micro step)."""
    import gc

    from paddle_tpu_torch import jit, optimizer
    from paddle_tpu_torch.distributed import collective
    from paddle_tpu_torch.models.bert import (BertForPretraining, bert_base,
                                              synthetic_mlm_batch)
    cfg = bert_base(vocab_size=BERT_VOCAB, hidden_dropout=0.0,
                    attention_dropout=0.0)
    pt.seed(seed + 4)
    base = BertForPretraining(cfg, device="cuda").to("bfloat16")
    start = torch.cat([p.detach().float().reshape(-1)
                       for p in base.parameters()])
    fpt = base.flops_per_token(BERT_SEQ)
    tokens = BERT_BATCH * BERT_SEQ
    batches = [synthetic_mlm_batch(BERT_BATCH, BERT_SEQ, BERT_VOCAB,
                                   seed=seed + 50 + i) for i in range(KSTEP)]
    stacked = [torch.from_numpy(np.stack(col)).cuda() for col in zip(*batches)]

    def build(stage=0, prefetch=None, remat=None, accumulate=None,
              fp32=False, last_micro_only=False, measure=True):
        model = copy.deepcopy(base)
        if fp32:
            model = model.float()
        if remat is not None:
            for layer in model.bert.layers:  # bench.py --remat
                layer.enable_recompute(remat)
        opt = optimizer.AdamW(parameters=model.parameters(),
                              learning_rate=BERT_LR, multi_precision=True)
        if stage:
            opt._zero_enable(axis="dp", stage=stage, prefetch=prefetch)
        body = bench_one_step(pt, model, opt)
        if last_micro_only:
            def body(*batch, one_step=body):
                # a no-op in a window's micro steps; before the window's
                # last backward it drops the earlier micro steps' gradients
                opt.clear_grad()
                return one_step(*batch)
        program = jit.to_static(body, scan_steps=KSTEP, dp_axis="dp",
                                accumulate_steps=accumulate)
        return program, model, opt

    def two_calls(label, program):
        """Two calls: the first with its capture inspected, the second
        (replays only) with the collectives Python issues counted."""
        with inspect_capture() as seen:
            first, peak = first_kstep_call(label, lambda: program(*stacked))
        collective.reset_counts()
        second = program(*stacked)
        torch.cuda.synchronize()
        return (torch.cat([first, second]).cpu(), peak, seen,
                collective.counts())

    acc = f"accumulate_steps={ZERO_ACCUM}"
    arms = [("replicated control", {}, None),
            ("ZeRO-1", dict(stage=1), "control"),
            ("ZeRO-2", dict(stage=2), "control"),
            (f"accumulating control ({acc})", dict(accumulate=ZERO_ACCUM),
             None),
            (f"ZeRO-2, {acc}", dict(stage=2, accumulate=ZERO_ACCUM),
             "accumulating"),
            (f"accumulating control ({acc}), last micro step only",
             dict(accumulate=ZERO_ACCUM, last_micro_only=True,
                  measure=False), "accumulating"),
            (f"accumulating control ({acc}), float32 parameters",
             dict(accumulate=ZERO_ACCUM, fp32=True, measure=False), None),
            (f"ZeRO-2, {acc}, float32 parameters",
             dict(stage=2, accumulate=ZERO_ACCUM, fp32=True, measure=False),
             "accumulating float32"),
            ("ZeRO-3, prefetch on", dict(stage=3, prefetch=True), "control"),
            ("ZeRO-3, prefetch off", dict(stage=3, prefetch=False),
             "control"),
            ("recompute full", dict(remat="full"), "control"),
            ("recompute selective", dict(remat="selective"), "control"),
            ("recompute offload", dict(remat="offload"), "control")]
    controls, results = {}, {}
    for label, kw, against in arms:
        log(f"  -- BERT-base arm: {label}")
        try:
            results[label] = bert_arm(label, kw, against, build, two_calls,
                                      controls, stacked, start, tokens, fpt,
                                      failures)
        except Exception as e:  # noqa: BLE001 -- reported as a failure
            import traceback
            traceback.print_exc()
            failures.append(f"BERT arm {label} raised {type(e).__name__}: "
                            f"{e}")
        gc.collect()
        torch.cuda.empty_cache()
    check_collectives(results, failures)
    return results


def bert_arm(label, kw, against, build, two_calls, controls, stacked, start,
             tokens, fpt, failures):
    """One arm of phase 8a: two calls against its control (or kept as a
    control), the collectives of its captured unit and of a replayed call,
    then (``measure``) timed calls, a profiled call, the profiler's device
    copies of one call by size, and its memory."""
    kw = dict(kw)
    measure = kw.pop("measure", True)
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    program, model, opt = build(**kw)
    torch.cuda.synchronize()
    state_gb = (torch.cuda.memory_allocated() - before) / 1e9
    losses, peak, seen, call_counts = two_calls(label, program)
    if len(seen.graphs) != 1:
        raise RuntimeError(f"{label}: {len(seen.graphs)} graphs captured, "
                           "not one")
    res = {"graph_copies": graph_copies(seen.graphs[0]),
           "capture_counts": seen.counts[0], "call_counts": call_counts}
    masters = None if kw.get("fp32") else masters_of(opt, model)
    if against is None:
        key = ("control" if not kw.get("accumulate") else "accumulating"
               + (" float32" if kw.get("fp32") else ""))
        controls[key] = (losses, [p.detach().clone()
                                  for p in model.parameters()], masters,
                         res["graph_copies"])
    elif kw.get("accumulate") and not kw.get("fp32"):
        res.update(compare_window_arm(label, controls[against], losses,
                                      masters, start,
                                      kw.get("last_micro_only"), failures))
    else:
        res.update(compare_arm(f"{label} vs its control",
                               controls[against][0], losses,
                               controls[against][1], model, failures))
    if against is not None:
        res["control_graph_copies"] = controls[against][3]
    if not bool(torch.isfinite(losses).all()) or not losses[-1] < losses[0]:
        failures.append(f"BERT {label}: losses not finite and falling")
    if not measure:
        return res
    calls, tel = timed_kstep(lambda: program(*stacked), KSTEP,
                             KSTEP_TIMED_CALLS, tokens, fpt)
    prof = report_profile(f"BERT {label} call ({KSTEP} steps)",
                          profile_retry(lambda: program(*stacked).cpu()),
                          failures)
    res.update(log_rate(f"BERT-base {label}", tel, KSTEP, fpt, peak,
                        prof))
    layout = opt.zero_layout()
    res.update(state_bytes=opt._zero_state_bytes(),
               reserved_gb=torch.cuda.memory_reserved() / 1e9,
               model_and_state_gb=state_gb,
               bucket_rows=None if layout is None else layout["bucket_rows"],
               prefetch=None if layout is None else layout["prefetch"],
               stage=None if layout is None else layout["stage"],
               profiled_copies=device_copies_by_bytes(
                   lambda: program(*stacked)))
    log(f"  {label}: _zero_state_bytes {res['state_bytes']} "
        f"({res['state_bytes'] / 1e9:.3f} GB); the model and optimizer "
        f"state {state_gb:.3f} GB; reserved {res['reserved_gb']:.3f} GB; "
        f"buckets {None if layout is None else layout['n_buckets']}")
    return res


def compare_window_arm(label, control, losses, masters, start,
                       last_micro_only, failures):
    """An arm over accumulation windows against the accumulating control
    (bf16 parameters): the first window's losses bitwise (no update yet),
    the second's within ZERO_ACCUM_LOSS_REL (one update apart), the later
    windows' reported; the masters' distance from the control's over the
    control's travel within ZERO_ACCUM_MASTER_REL, or, for the window that
    keeps only its last micro step, beyond it."""
    a = ZERO_ACCUM
    want_losses, _, want_masters, _ = control
    rel = (losses - want_losses).abs() / want_losses.abs()
    first_bitwise = bool(torch.equal(losses[:a], want_losses[:a]))
    second = float(rel[a:2 * a].max())
    travel = float((want_masters - start).norm())
    master_rel = float((masters - want_masters).norm()) / travel
    master_max = float((masters - want_masters).abs().max())
    if last_micro_only:
        ok = master_rel > ZERO_ACCUM_MASTER_REL
        verdict = f"beyond the bound {ZERO_ACCUM_MASTER_REL:g}, as it must be"
    else:
        ok = (first_bitwise and second <= ZERO_ACCUM_LOSS_REL
              and master_rel <= ZERO_ACCUM_MASTER_REL)
        verdict = (f"first window's {a} losses bitwise {first_bitwise}; "
                   f"second window's max relative diff {second:.3e} (tol "
                   f"{ZERO_ACCUM_LOSS_REL:g}); masters within the bound "
                   f"{ZERO_ACCUM_MASTER_REL:g}")
    log(f"  {label} vs the accumulating control: masters' L2 distance "
        f"{master_rel:.4e} of the control's travel ({travel:.4e}), max "
        f"|diff| {master_max:.3e} ({master_max / BERT_LR:.3f} x lr); "
        f"{verdict}; the losses' relative diff by window "
        f"{[round(float(w.max()), 5) for w in rel.split(a)]} "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        failures.append(f"{label}: outside its bound against the "
                        f"accumulating control")
    return {"window_bitwise": first_bitwise,
            "second_window_rel_diff": second,
            "loss_max_rel_diff": float(rel.max()),
            "master_rel_l2": master_rel, "master_max_abs_diff": master_max}


def implied_collectives(label, res):
    """What a ZeRO arm's stage implies, for its bucket rows r: per captured
    unit, {bytes: copies} (a reduce-scatter of r x 1024 float32 and an
    all-gather of r x 1024 bf16 per bucket and step: ZeRO-1/2 after the
    update, ZeRO-3 before the forward, bucket 0 at the tail with prefetch;
    over windows of a steps, a reduce-scatters and one all-gather) and the
    Python-issued collectives of a call beyond the replays (ZeRO-3 gathers
    the buckets not current at its end: all but bucket 0 with prefetch;
    every program all-reduces its loss over the ranks)."""
    import collections
    rows = res["bucket_rows"]
    a = ZERO_ACCUM if "accumulate" in label else 1
    unit = collections.Counter()
    for r in rows:
        unit[r * 1024 * 4] += a
        unit[r * 1024 * 2] += 1
    end_rows = []
    if res["stage"] == 3:
        end_rows = rows[1:] if res["prefetch"] else rows
    call_end = {"all_reduce": 1}
    if end_rows:
        call_end["all_gather"] = len(end_rows)
    capture = {"reduce_scatter": a * len(rows), "all_gather": len(rows)}
    return unit, capture, call_end, [r * 1024 * 2 for r in end_rows], a


def check_collectives(results, failures):
    """Each ZeRO arm's collectives, counted exactly: the memcpy nodes of
    its captured unit beyond its control's (every collective is one node at
    one rank) and the collectives Python issued during that capture, both
    against the unit the stage implies, and the collectives Python issues
    in a replayed call (at its end) against what that implies. A call runs
    units x the unit plus those. The profiler's count of the same copies in
    one call is reported beside (its trace drops records)."""
    import collections
    for label, res in results.items():
        if not res.get("bucket_rows"):
            continue
        unit, capture, call_end, end_copies, a = implied_collectives(label,
                                                                     res)
        nodes = collections.Counter(res["graph_copies"])
        nodes.subtract(res["control_graph_copies"])
        nodes = {b: n for b, n in nodes.items() if n}
        captured = {kind: calls for kind, (calls, _)
                    in res["capture_counts"].items()}
        issued = {kind: calls for kind, (calls, _)
                  in res["call_counts"].items()}
        ok = (nodes == dict(unit) and captured == capture
              and issued == call_end)
        units = KSTEP // a
        per_call = collections.Counter({b: units * n for b, n in unit.items()})
        per_call.update(end_copies)
        seen = res.pop("profiled_copies", {})
        control_seen = next((r.get("profiled_copies", {}) for lb, r in
                             results.items() if not r.get("bucket_rows")
                             and ("accumulat" in lb) == (a > 1)), {})
        profiled = sum(seen.get(b, 0) - control_seen.get(b, 0)
                       for b in per_call)
        log(f"  {label}: collectives of a captured unit ({a} step"
            f"{'s' if a > 1 else ''}): {sum(nodes.values())} memcpy nodes "
            f"beyond the control's graph, {sum(unit.values())} implied, by "
            f"size equal {nodes == dict(unit)}; Python issued {captured} "
            f"under capture (implied {capture}) and {issued} in a replayed "
            f"call (implied {call_end}); a call runs "
            f"{sum(per_call.values())} reduce-scatter and all-gather copies "
            f"({units} replays of the unit and {len(end_copies)} at the "
            f"end); the profiler's trace of one call held {profiled} of them "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            log(f"    graph nodes beyond the control {nodes}, implied "
                f"{dict(unit)}")
            failures.append(f"{label}: the collectives of a call differ "
                            f"from what the stage implies")
        res["collectives"] = {"unit_nodes": sum(nodes.values()),
                              "per_call": sum(per_call.values()),
                              "profiled": profiled}
    for res in results.values():  # not for the JSON line
        for key in ("graph_copies", "control_graph_copies", "capture_counts",
                    "call_counts", "profiled_copies"):
            res.pop(key, None)


def check_recompute_dropout(pt, seed, failures):
    """Phase 8c: BERT-base with dropout through to_static(one_step,
    scan_steps=4, dp_axis="dp") with full and with selective recompute on
    every encoder layer, bitwise against the same program without
    recompute over two calls (the eager first unit, the capture and the
    replays): the recomputation takes back the forward's draws."""
    import gc

    from paddle_tpu_torch import jit, optimizer
    from paddle_tpu_torch.models.bert import (BertForPretraining, bert_base,
                                              synthetic_mlm_batch)
    k = RECOMPUTE_DROPOUT_K
    cfg = bert_base(vocab_size=BERT_VOCAB, hidden_dropout=RECOMPUTE_DROPOUT,
                    attention_dropout=RECOMPUTE_DROPOUT)
    pt.seed(seed + 7)
    base = BertForPretraining(cfg, device="cuda").to("bfloat16")
    batches = [synthetic_mlm_batch(BERT_BATCH, BERT_SEQ, BERT_VOCAB,
                                   seed=seed + 80 + i) for i in range(k)]
    stacked = [torch.from_numpy(np.stack(col)).cuda() for col in zip(*batches)]
    runs = {}
    for policy in (None, "full", "selective"):
        gc.collect()
        torch.cuda.empty_cache()
        model = copy.deepcopy(base)
        if policy is not None:
            for layer in model.bert.layers:
                layer.enable_recompute(policy)
        opt = optimizer.AdamW(parameters=model.parameters(),
                              learning_rate=BERT_LR, multi_precision=True)
        program = jit.to_static(bench_one_step(pt, model, opt), scan_steps=k,
                                dp_axis="dp")
        pt.seed(seed + 8)  # the dropout draws
        losses = torch.cat([program(*stacked), program(*stacked)]).cpu()
        runs[policy] = (losses, model)
        del program, opt
    want, control = runs.pop(None)
    params = [p.detach() for p in control.parameters()]
    for policy, (losses, model) in runs.items():
        compare_arm(f"dropout {RECOMPUTE_DROPOUT:g}, recompute {policy} vs "
                    f"none, 2 calls of scan_steps={k}", want, losses,
                    params, model, failures)


def check_attention_gate(fa, failures):
    """F1 on the card: inputs the kernels do not take (float16, head dim
    96) are written out, launching no kernel and raising nothing."""
    from paddle_tpu_torch.nn import functional as F
    fa.reset_launch_counts()
    cases = {"float16": torch.randn(1, SEQ, 2, 64, device="cuda",
                                    dtype=torch.float16),
             "head dim 96": torch.randn(1, SEQ, 2, 96, device="cuda",
                                        dtype=torch.bfloat16)}
    ok = True
    for label, q in cases.items():
        out = F.scaled_dot_product_attention(q, q, q, is_causal=True)
        ok &= (not fa.supports(q, q, q) and out.shape == q.shape
               and bool(torch.isfinite(out.float()).all()))
    ok &= fa.flash_attention_fwd.launches == 0
    log(f"  attention gate: float16 and head dim 96 at seq {SEQ} written "
        f"out, {fa.flash_attention_fwd.launches} kernel launches "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        failures.append("the attention gate sent unsupported inputs to the "
                        "kernels")


def gpt_zero3_recompute(pt, fa, seed, failures):
    """Phase 8b: GPT-small through to_static(scan_steps=10, dp_axis="dp")
    with ZeRO-3, prefetch and full recompute on every block, against the
    same program without ZeRO and recompute; one replayed call profiled.
    Returns the wrappers' launch counts over the arm's first call (counts
    zeroed just before, read just after: the eager unit) and the profiled
    replay's."""
    from paddle_tpu_torch import jit
    from paddle_tpu_torch.models.gpt import (GPTForCausalLM, gpt_small,
                                             synthetic_lm_batch)
    k = GPT_KSTEP
    cfg = gpt_small(hidden_dropout=0.0, attention_dropout=0.0)
    pt.seed(seed + 5)
    control_model = GPTForCausalLM(cfg, device="cuda").to("bfloat16")
    model = copy.deepcopy(control_model)
    stacked = torch.from_numpy(np.stack([
        synthetic_lm_batch(TRAIN_BATCH, SEQ, cfg.vocab_size, seed=seed + 60 + i)
        for i in range(k)])).cuda()

    def program_for(m, zero):
        opt, sched = make_optimizer(m)
        if zero:
            for blk in m.gpt.blocks:
                blk.enable_recompute("full")
            opt._zero_enable(axis="dp", stage=3, prefetch=True)

        def one_step(ids):
            with pt.amp.auto_cast(enable=True, dtype="bfloat16"):
                loss = m.loss(m(ids), ids)
            loss.backward()
            opt.step()
            opt.clear_grad()
            return loss
        return jit.to_static(one_step, scan_steps=k, dp_axis="dp"), sched, opt

    control, csched, _ = program_for(control_model, False)
    program, sched, opt = program_for(model, True)
    want, got = [], []
    counted = {}
    for call in range(2):  # the schedulers step between calls
        want.append(control(stacked))
        csched.step()
        if call == 0:
            fa.reset_launch_counts()
            with inspect_capture():  # its graph keeps its nodes
                out, peak = first_kstep_call("GPT-small ZeRO-3 + recompute",
                                             lambda: program(stacked))
            counted = {w.__name__: w.launches for w in (
                fa.flash_attention_fwd, fa.flash_attention_bwd_dq,
                fa.flash_attention_bwd_dkv)}
        else:
            out = program(stacked)
        got.append(out)
        sched.step()
    res = compare_arm(f"GPT-small ZeRO-3 + prefetch + full recompute, 2 calls "
                      f"of scan_steps={k}, vs the replicated program",
                      torch.cat(want).cpu(), torch.cat(got).cpu(),
                      [p.detach() for p in control_model.parameters()], model,
                      failures)
    want_eager = {"flash_attention_fwd": 2 * cfg.num_layers,
                  "flash_attention_bwd_dq": cfg.num_layers,
                  "flash_attention_bwd_dkv": cfg.num_layers}
    log(f"  wrapper launch counts over the arm's first call (its eager "
        f"inner step; the capture and replays count nothing): {counted} "
        f"(want {want_eager})")
    if counted != want_eager:
        failures.append(f"GPT ZeRO-3 + recompute: wrapper launches "
                        f"{counted}, not {want_eager}")
    del control
    calls, tel = timed_kstep(lambda: program(stacked), k, KSTEP_TIMED_CALLS,
                             stacked[0].numel(), model.flops_per_token(SEQ))
    replays = count_replays(program)
    prof = report_profile(f"GPT-small ZeRO-3 + recompute call ({k} steps)",
                          profile_retry(lambda: replays.run(
                              lambda: program(stacked).cpu())), failures)
    launches, off = replays.launches()
    check_launches("replayed GPT ZeRO-3 + recompute call", launches, off,
                   prof, {meta["name"]: per_step * cfg.num_layers * k
                          for meta, per_step in zip(KERNELS, (2, 1, 1))},
                   failures)
    res.update(log_rate(f"GPT-small ZeRO-3 + recompute (scan_steps={k})", tel,
                        k, model.flops_per_token(SEQ), peak, prof))
    res.update(state_bytes=opt._zero_state_bytes(),
               reserved_gb=torch.cuda.memory_reserved() / 1e9)
    return counted, launches, res


def phase8(pt, fa, seed, failures):
    """Phase 8 on a one-rank NCCL mesh, torn down at the end; a phase that
    raises is a failure and the next one still runs."""
    import traceback
    log("phase 8: ZeRO-1/2/3 and recompute through to_static(..., "
        "dp_axis=\"dp\") on a one-rank NCCL mesh")
    init_dp_mesh()
    out = [{}, {}, {}, {}]
    try:
        for i, fn in ((0, lambda: zero_bert_arms(pt, fa, seed, failures)),
                      (1, lambda: gpt_zero3_recompute(pt, fa, seed,
                                                      failures)),
                      (None, lambda: check_recompute_dropout(pt, seed,
                                                             failures)),
                      (None, lambda: check_attention_gate(fa, failures))):
            try:
                r = fn()
            except Exception as e:  # noqa: BLE001 -- reported as a failure
                traceback.print_exc()
                failures.append(f"phase 8 raised {type(e).__name__}: {e}")
                continue
            if i == 0:
                out[0] = r
            elif i == 1:
                out[1:] = r
    finally:
        torch.distributed.destroy_process_group()
    log(f"  {card_line()}")
    return tuple(out)


# ---- phase 9: step checkpoints ----------------------------------------------

# Checkpoints are written under the checkout (a git-ignored directory that
# the phase removes at its end): the card's machine's own filesystem.
CKPT_DIR = ".chip_smoke_checkpoints"


def ckpt_dir(name):
    import os
    return os.path.join(os.path.dirname(os.path.abspath(__file__)), CKPT_DIR,
                        name)


def slug(label):
    return re.sub(r"[^0-9A-Za-z]+", "_", label).strip("_").lower()


def free_cuda():
    import gc
    gc.collect()
    torch.cuda.empty_cache()


def memory_census(label):
    """What the card holds at a phase boundary: the bytes allocated, and
    the live CUDA tensors that Python's collector reaches, one a storage,
    grouped by shape and dtype, largest first; then the same after
    clearing cuBLAS's workspaces (one for each stream that ran a product:
    every program's stream keeps its own; nothing replays an earlier
    phase's graph after its boundary). Returns (allocated before, tensors
    reached, allocated after), in bytes."""
    import gc
    import warnings
    free_cuda()
    before = torch.cuda.memory_allocated()
    storages = {}
    with warnings.catch_warnings():  # deprecated names the walk touches
        warnings.simplefilter("ignore")
        objects = [o for o in gc.get_objects()
                   if isinstance(o, torch.Tensor) and o.is_cuda]
    for obj in objects:
        try:
            storage = obj.untyped_storage()
            key, nbytes = storage.data_ptr(), storage.nbytes()
        except Exception:  # noqa: BLE001 -- a tensor without a storage
            continue
        if nbytes and key not in storages:
            storages[key] = (nbytes, (tuple(obj.shape),
                                      str(obj.dtype).replace("torch.", "")))
    del objects
    reached = sum(b for b, _ in storages.values())
    log(f"  memory at {label}: {before / 1e9:.3f} GB allocated, "
        f"{reached / 1e9:.3f} GB of it in {len(storages)} live tensors "
        f"that Python reaches")
    groups = {}
    for nbytes, group in storages.values():
        n, total = groups.get(group, (0, 0))
        groups[group] = (n + 1, total + nbytes)
    for (shape, dtype), (n, total) in sorted(
            groups.items(), key=lambda kv: -kv[1][1])[:8]:
        log(f"    {total / 1e9:.3f} GB in {n} x {list(shape)} {dtype}")
    torch._C._cuda_clearCublasWorkspaces()
    free_cuda()
    after = torch.cuda.memory_allocated()
    log(f"  memory at {label} after clearing cuBLAS's workspaces: "
        f"{after / 1e9:.3f} GB allocated, "
        f"{torch.cuda.memory_reserved() / 1e9:.3f} GB reserved")
    return before, reached, after


class ckpt_io:
    """One save or restore: host seconds (the card synchronized at both
    ends), the bytes of the checkpoint, and the copies between the card and
    the host that it made (``checkpoint_d2h_*`` and ``checkpoint_h2d_*``,
    counted while tracing's ``checkpoint`` category is on)."""

    KEYS = ("checkpoint_bytes_written_total", "checkpoint_d2h_ns",
            "checkpoint_d2h_bytes", "checkpoint_h2d_ns",
            "checkpoint_h2d_bytes")

    def __init__(self, kind, root):
        self.kind, self.root = kind, root

    def __enter__(self):
        from paddle_tpu_torch import monitor
        from paddle_tpu_torch.observability import tracing
        torch.cuda.synchronize()
        self.before = {k: monitor.stat_get(k) for k in self.KEYS}
        self.n_spans = len(tracing.spans())
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        import os
        from paddle_tpu_torch import monitor
        from paddle_tpu_torch.checkpoint import core
        from paddle_tpu_torch.observability import tracing
        torch.cuda.synchronize()
        self.seconds = time.perf_counter() - self.t0
        d = {k: monitor.stat_get(k) - self.before[k] for k in self.KEYS}
        self.spans = {}  # the checkpoint spans' seconds, by name
        for sp in tracing.spans()[self.n_spans:]:
            name = sp["name"].split("/", 1)[1]
            self.spans[name] = (self.spans.get(name, 0.0)
                                + (sp["t1"] - sp["t0"]) / 1e9)
        step = core.latest_step(self.root)
        folder = os.path.join(self.root, core.step_dirname(step))
        self.bytes = sum(os.path.getsize(os.path.join(folder, f))
                         for f in os.listdir(folder))
        copy = "d2h" if self.kind == "save" else "h2d"
        self.copy_s = d[f"checkpoint_{copy}_ns"] / 1e9
        self.copy_bytes = d[f"checkpoint_{copy}_bytes"]
        self.written = d["checkpoint_bytes_written_total"]
        return False

    def line(self):
        what = ("device-to-host" if self.kind == "save"
                else "host-to-device")
        spans = ", ".join(f"{k} {v:.3f} s" for k, v in self.spans.items())
        rate = self.bytes / self.seconds / 1e9
        share = self.copy_s / self.seconds
        return (f"{self.kind} {self.bytes} bytes ({self.bytes / 1e9:.3f} GB) "
                f"in {self.seconds:.3f} s = {rate:.3f} GB/s; {what} copies "
                f"{self.copy_bytes} bytes in {self.copy_s:.3f} s ({share:.1%} "
                f"of the {self.kind}); spans: {spans}")

    def record(self):
        return {"bytes": self.bytes, "seconds": self.seconds,
                "gb_per_s": self.bytes / self.seconds / 1e9,
                "copy_seconds": self.copy_s, "copy_bytes": self.copy_bytes,
                "copy_share": self.copy_s / self.seconds,
                "span_seconds": self.spans}


def bert_batches(seed, k, offset):
    from paddle_tpu_torch.models.bert import synthetic_mlm_batch
    batches = [synthetic_mlm_batch(BERT_BATCH, BERT_SEQ, BERT_VOCAB,
                                   seed=seed + offset + i) for i in range(k)]
    return [torch.from_numpy(np.stack(col)).cuda() for col in zip(*batches)]


def bert_program(pt, cfg, init_seed, k, stage=0, prefetch=None,
                 accumulate=None):
    """bench.py's BERT-base recipe through to_static(one_step,
    scan_steps=k, dp_axis="dp"), from the package's seed ``init_seed``."""
    from paddle_tpu_torch import jit, optimizer
    from paddle_tpu_torch.models.bert import BertForPretraining
    pt.seed(init_seed)
    model = BertForPretraining(cfg, device="cuda").to("bfloat16")
    opt = optimizer.AdamW(parameters=model.parameters(),
                          learning_rate=BERT_LR, multi_precision=True)
    if stage:
        opt._zero_enable(axis="dp", stage=stage, prefetch=prefetch)
    program = jit.to_static(bench_one_step(pt, model, opt), scan_steps=k,
                            dp_axis="dp", accumulate_steps=accumulate)
    return program, model, opt


def manager_for(root, model, opt, keep_last_n=1):
    from paddle_tpu_torch import checkpoint
    return checkpoint.CheckpointManager(root, keep_last_n=keep_last_n) \
        .add_model(model).add_optimizer(opt)


def ckpt_bert_resume(pt, seed, failures):
    """Phase 9a: each arm runs two calls uninterrupted; then again call 1,
    a save, everything freed, fresh objects from another seed, a restore
    and call 2, whose losses and final parameters must be the
    uninterrupted run's, bitwise."""
    import shutil
    from paddle_tpu_torch.models.bert import bert_base
    cfg = bert_base(vocab_size=BERT_VOCAB, hidden_dropout=0.0,
                    attention_dropout=0.0)
    call1 = bert_batches(seed, KSTEP, 50)
    call2 = bert_batches(seed, KSTEP, 90)
    arms = [("replicated control", {}), ("ZeRO-1", dict(stage=1)),
            ("ZeRO-3, prefetch on", dict(stage=3, prefetch=True)),
            (f"ZeRO-2, accumulate_steps={ZERO_ACCUM}",
             dict(stage=2, accumulate=ZERO_ACCUM))]
    out = {}
    for label, kw in arms:
        program, model, opt = bert_program(pt, cfg, seed + 4, KSTEP, **kw)
        program(*call1)
        want = program(*call2).cpu()
        want_params = [p.detach().clone() for p in model.parameters()]
        del program, model, opt
        free_cuda()
        root = ckpt_dir("bert_" + slug(label))
        program, model, opt = bert_program(pt, cfg, seed + 4, KSTEP, **kw)
        program(*call1)
        with ckpt_io("save", root) as save:
            manager_for(root, model, opt).save(1)
        del program, model, opt
        free_cuda()
        program, model, opt = bert_program(pt, cfg, seed + 99, KSTEP, **kw)
        with ckpt_io("restore", root) as rest:
            meta = manager_for(root, model, opt).restore()
        got = program(*call2).cpu()
        res = compare_arm(
            f"BERT-base {label}: call 2 of scan_steps={KSTEP} resumed into "
            f"fresh objects (another seed) vs the uninterrupted run", want,
            got, want_params, model, failures)
        if meta["step"] != 1:
            failures.append(f"BERT {label}: restored step {meta['step']}")
        log(f"    {save.line()}")
        log(f"    {rest.line()}")
        res.update(save=save.record(), restore=rest.record())
        out[label] = res
        del program, model, opt, want_params
        free_cuda()
        shutil.rmtree(root, ignore_errors=True)
    return out


def ckpt_gpt_in_place(pt, fa, seed, failures):
    """Phase 9b: GPT-small with phase 8b's program (ZeRO-3, prefetch, full
    recompute, scan_steps=10, dp_axis="dp"): call 1, a save, calls 2 and
    3; a restore into the same objects (the graph stays captured), call 2
    again, bitwise, and call 3 again under the profiler, bitwise, which
    must launch each kernel at phase 8b's count. Returns the
    wrappers' launch counts over call 1 (counts zeroed just before it,
    read just after: its eager inner step) and the profiled replay's."""
    from paddle_tpu_torch import jit
    from paddle_tpu_torch.models.gpt import (GPTForCausalLM, gpt_small,
                                             synthetic_lm_batch)
    k = GPT_KSTEP
    cfg = gpt_small(hidden_dropout=0.0, attention_dropout=0.0)
    pt.seed(seed + 5)
    model = GPTForCausalLM(cfg, device="cuda").to("bfloat16")
    opt, sched = make_optimizer(model)
    for blk in model.gpt.blocks:
        blk.enable_recompute("full")
    opt._zero_enable(axis="dp", stage=3, prefetch=True)

    def one_step(ids):
        with pt.amp.auto_cast(enable=True, dtype="bfloat16"):
            loss = model.loss(model(ids), ids)
        loss.backward()
        opt.step()
        opt.clear_grad()
        return loss
    program = jit.to_static(one_step, scan_steps=k, dp_axis="dp")

    def batch(offset):
        return torch.from_numpy(np.stack([
            synthetic_lm_batch(TRAIN_BATCH, SEQ, cfg.vocab_size,
                               seed=seed + offset + i)
            for i in range(k)])).cuda()
    call1, call2, call3 = batch(60), batch(100), batch(140)
    wrappers = (fa.flash_attention_fwd, fa.flash_attention_bwd_dq,
                fa.flash_attention_bwd_dkv)
    fa.reset_launch_counts()
    with inspect_capture():  # its graph keeps its nodes
        program(call1)
    torch.cuda.synchronize()
    counted = {w.__name__: w.launches for w in wrappers}
    want_eager = {"flash_attention_fwd": 2 * cfg.num_layers,
                  "flash_attention_bwd_dq": cfg.num_layers,
                  "flash_attention_bwd_dkv": cfg.num_layers}
    log(f"  GPT-small call 1: wrapper launch counts (its eager inner step) "
        f"{counted} (want {want_eager})")
    if counted != want_eager:
        failures.append(f"phase 9b: wrapper launches {counted}, not "
                        f"{want_eager}")
    sched.step()
    root = ckpt_dir("gpt")
    mgr = manager_for(root, model, opt)
    with ckpt_io("save", root) as save:
        mgr.save(1)
    graphs = {key: p.graph for key, p in program._programs.items()}

    def timed_call(ids):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses = program(ids).cpu()
        return losses, (time.perf_counter() - t0) * 1e3 / k

    def params():
        return [p.detach().clone() for p in model.parameters()]

    before, before_ms = timed_call(call2)
    before_params = params()
    sched.step()
    third = program(call3).cpu()  # the uninterrupted run's call 3
    third_params = params()
    sched.step()
    with ckpt_io("restore", root) as rest:
        mgr.restore()
    after, after_ms = timed_call(call2)
    res = compare_arm("GPT-small ZeRO-3 + prefetch + full recompute: call 2 "
                      "replayed again after a restore into the same objects "
                      "vs its first run", before, after, before_params,
                      model, failures)
    same_graphs = {key: p.graph for key, p in program._programs.items()}
    recaptured = (same_graphs.keys() != graphs.keys() or any(
        same_graphs[key] is not g for key, g in graphs.items()))
    log(f"  step time of call 2: before the restore {before_ms:.3f} ms, after "
        f"it {after_ms:.3f} ms (replays of the graph captured in call 1, "
        f"re-captured: {recaptured})")
    if recaptured:
        failures.append("phase 9b: the restore made the program capture "
                        "again")
    want_n = {meta["name"]: per_step * cfg.num_layers * k
              for meta, per_step in zip(KERNELS, (2, 1, 1))}
    # Call 3 after the restored run's call 2, profiled: the graph's buffers
    # hold call 2's values, so a kernel that did not run would show in its
    # losses and parameters against the uninterrupted call 3. The
    # profiler's trace now and then records nothing: up to three profiled
    # calls (each from a restore and call 2), until one trace holds device
    # activity.
    replays = count_replays(program)
    for attempt in range(3):
        if attempt:
            mgr.restore()
            program(call2)
        sched.step()
        got = []
        prof = profile_step(lambda: replays.run(
            lambda: got.append(program(call3).cpu())))
        if not (torch.equal(got[0], third) and all(
                torch.equal(p, q) for p, q in zip(model.parameters(),
                                                  third_params))):
            failures.append("phase 9b: the restored run's call 3 disagrees "
                            "with the uninterrupted run's")
        if prof is not None:
            break
    prof = report_profile("GPT-small call 3 replayed after a restore and "
                          "call 2", prof, failures)
    launches, off = replays.launches()
    check_launches("call 3 of the restored run, replayed (bitwise against "
                   "the uninterrupted call 3; want phase 8b's counts)",
                   launches, off, prof, want_n, failures)
    log(f"    {save.line()}")
    log(f"    {rest.line()}")
    res.update(save=save.record(), restore=rest.record(),
               step_ms_before_restore=before_ms,
               step_ms_after_restore=after_ms, recaptured=recaptured)
    del program, model, opt, mgr
    free_cuda()
    return counted, launches, res


def ckpt_dropout(pt, seed, failures):
    """Phase 9c: BERT-base with dropout 0.1 through the k-step program:
    call 1, a save (the generators' states with it), call 2; a restore into
    the same objects (the generator is registered with the captured graph)
    and call 2 again; a restore into fresh objects and call 2 there. Both
    must be the first call 2, bitwise."""
    from paddle_tpu_torch.models.bert import bert_base
    k = RECOMPUTE_DROPOUT_K
    cfg = bert_base(vocab_size=BERT_VOCAB, hidden_dropout=RECOMPUTE_DROPOUT,
                    attention_dropout=RECOMPUTE_DROPOUT)
    call1, call2 = bert_batches(seed, k, 120), bert_batches(seed, k, 130)
    program, model, opt = bert_program(pt, cfg, seed + 7, k)
    program(*call1)
    root = ckpt_dir("dropout")
    mgr = manager_for(root, model, opt)
    mgr.save(1)
    want = program(*call2).cpu()
    want_params = [p.detach().clone() for p in model.parameters()]
    mgr.restore()
    got = program(*call2).cpu()
    res = {"in_place": compare_arm(
        f"dropout {RECOMPUTE_DROPOUT:g}: call 2 after a restore into the same "
        f"objects (Generator.set_state on the generator registered with the "
        f"captured graph, torch {torch.__version__}) vs its first run", want,
        got, want_params, model, failures)}
    del program, model, opt
    free_cuda()
    program, model, opt = bert_program(pt, cfg, seed + 99, k)
    manager_for(root, model, opt).restore()
    got = program(*call2).cpu()
    res["fresh"] = compare_arm(
        f"dropout {RECOMPUTE_DROPOUT:g}: call 2 after a restore into fresh "
        f"objects (a new program: an eager first step, then its capture) vs "
        f"the uninterrupted call 2", want, got, want_params, model, failures)
    del program, model, opt, want_params
    free_cuda()
    return res


def ckpt_net(pt, init_seed):
    """A two-layer MLP on the card (1024 -> 2048 -> 1024, float32), from
    the package's seed ``init_seed``."""
    from paddle_tpu_torch import nn

    class Net(nn.Layer):
        def __init__(self):
            super().__init__()
            self.up = nn.Linear(1024, 2048, device="cuda")
            self.down = nn.Linear(2048, 1024, device="cuda")

        def forward(self, x):
            return self.down(torch.relu(self.up(x)))

    pt.seed(init_seed)
    return Net()


def ckpt_scaler(pt, seed, failures):
    """Phase 9e: amp.GradScaler inside the captured k-step program (the
    scale, its counts and the found-inf flag on the device, a step that
    overflows skipped on the device): two calls of scan_steps=4, an inf in
    the gradients of call 1's second step, bitwise against the same eight
    eager steps (losses, parameters, the scaler's state, 7 updates); then
    a restore into the same objects, scaler included, replays call 2
    bitwise. The inf enters the step's gradients only (``PoisonGrad``), so
    the losses stay finite."""
    from paddle_tpu_torch import amp, checkpoint, jit, optimizer
    k = 4
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed + 13)
    xs = torch.randn(2, k, 64, 1024, device="cuda", generator=gen)
    poison = torch.ones(2, k, device="cuda")
    poison[0, 1] = float("inf")

    class PoisonGrad(torch.autograd.Function):
        """The identity forward; the backward multiplies the gradient by
        ``p`` (inf makes every parameter's gradient non-finite)."""

        @staticmethod
        def forward(ctx, h, p):
            ctx.save_for_backward(p)
            return h.view_as(h)

        @staticmethod
        def backward(ctx, g):
            (p,) = ctx.saved_tensors
            return g * p, None

    def build():
        net = ckpt_net(pt, seed + 12)
        opt = optimizer.AdamW(parameters=net.parameters(), learning_rate=1e-3)
        sc = amp.GradScaler(init_loss_scaling=2.0 ** 10, incr_every_n_steps=2,
                            decr_every_n_nan_or_inf=1)

        def one(x, p):
            loss = PoisonGrad.apply(net(x), p).square().mean()
            sc.scale(loss).backward()
            sc.step(opt)
            opt.clear_grad()
            return loss
        return one, net, opt, sc

    def scaler_state(sc, opt):
        return (sc.get_init_loss_scaling(), int(sc._good_steps),
                int(sc._bad_steps), int(opt._step_count))

    one, net, opt, sc = build()
    want = torch.stack([one(xs[c, i], poison[c, i]).detach()
                        for c in range(2) for i in range(k)]).view(2, k).cpu()
    want_params = [p.detach().clone() for p in net.parameters()]
    want_state = scaler_state(sc, opt)
    one, net, opt, sc = build()
    program = jit.to_static(one, scan_steps=k)
    first = program(xs[0], poison[0]).cpu()
    root = ckpt_dir("scaler")
    mgr = checkpoint.CheckpointManager(root).add_model(net) \
        .add_optimizer(opt).add_scaler(sc)
    mgr.save(1)
    second = program(xs[1], poison[1]).cpu()
    state = scaler_state(sc, opt)
    res = {"program": compare_arm(
        "GradScaler inside the captured program (an inf gradient at call "
        "1's step 2) vs the same eager steps", want,
        torch.stack([first, second]),
        want_params, net, failures)}
    ok = state == want_state and want_state[3] == 2 * k - 1
    log(f"  the scaler after 8 steps: (scale, good, bad, updates) {state}, "
        f"eager {want_state} {'ok' if ok else 'FAIL'}")
    if not ok:
        failures.append("phase 9e: the scaler's state under the program "
                        "differs from the eager steps'")
    mgr.restore()
    again = program(xs[1], poison[1]).cpu()
    res["in_place"] = compare_arm(
        "GradScaler: call 2 replayed after a restore into the same objects "
        "vs its first run", second, again, want_params, net, failures)
    res["state"] = state
    del program, net, opt, sc, mgr
    return res


def ckpt_crash(pt, seed, failures):
    """Phase 9d: a fault at every kill point of the checkpoint core, in a
    save through CheckpointManager of a model and optimizer on the card;
    restore into fresh objects must give exactly the state of the previous
    save (a kill before the publish) or of the new one (after it). Then a
    flipped byte in the newest checkpoint's payload: restore falls back to
    the previous step, exactly, and counts it; asking for the corrupt step
    raises."""
    import os
    from paddle_tpu_torch import checkpoint, monitor, optimizer
    from paddle_tpu_torch.checkpoint import core
    from paddle_tpu_torch.testing import faults

    def build(init_seed):
        net = ckpt_net(pt, init_seed)
        return net, optimizer.AdamW(parameters=net.parameters(),
                                    learning_rate=1e-3)

    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    x = torch.randn(64, 1024, device="cuda", generator=gen)
    net, opt = build(seed + 11)

    def snapshot(n, o):
        return ([p.detach().clone() for p in n.parameters()]
                + [t.clone() for t in o._accumulators.values()]
                + [o._step_count.clone()])

    def train():
        net(x).square().mean().backward()
        opt.step()
        opt.clear_grad()
        return snapshot(net, opt)

    after_publish = {"checkpoint/after_publish", "checkpoint/before_gc"}
    verdicts = {}
    for kp in core.KILL_POINTS:
        root = ckpt_dir("crash_" + slug(kp))
        first = train()
        manager_for(root, net, opt, keep_last_n=2).save(1)
        second = train()
        faults.inject(kp)
        try:
            manager_for(root, net, opt, keep_last_n=2).save(2)
            raised = False
        except faults.FaultInjected:
            raised = True
        faults.clear()
        fresh, fresh_opt = build(seed + 99)
        meta = manager_for(root, fresh, fresh_opt).restore()
        want_step = 2 if kp in after_publish else 1
        want = second if want_step == 2 else first
        exact = all(torch.equal(a, b) for a, b in
                    zip(snapshot(fresh, fresh_opt), want))
        verdicts[kp] = raised and meta["step"] == want_step and exact
        log(f"  kill at {kp}: save raised {raised}; restore took step "
            f"{meta['step']} (want {want_step}), the saved state exactly "
            f"{exact} {'ok' if verdicts[kp] else 'FAIL'}")
    root = ckpt_dir("corrupt")
    first = train()
    manager_for(root, net, opt, keep_last_n=2).save(1)
    train()
    manager_for(root, net, opt, keep_last_n=2).save(2)
    with open(os.path.join(root, core.step_dirname(2), "optimizer_opt.pkl"),
              "r+b") as f:
        f.seek(100)
        byte = f.read(1)
        f.seek(100)
        f.write(bytes([byte[0] ^ 0xFF]))
    skipped = monitor.stat_get("checkpoint_corrupt_skipped_total")
    fresh, fresh_opt = build(seed + 99)
    meta = manager_for(root, fresh, fresh_opt).restore()
    skipped = monitor.stat_get("checkpoint_corrupt_skipped_total") - skipped
    exact = all(torch.equal(a, b) for a, b in
                zip(snapshot(fresh, fresh_opt), first))
    try:
        manager_for(root, fresh, fresh_opt).restore(step=2)
        refused = False
    except checkpoint.CheckpointCorruptError:
        refused = True
    ok = meta["step"] == 1 and exact and skipped == 1 and refused
    log(f"  a flipped byte in step 2's optimizer payload: restore took step "
        f"{meta['step']} (want 1), exactly {exact}, counted {skipped} skip, "
        f"restore(step=2) refused {refused} {'ok' if ok else 'FAIL'}")
    verdicts["corrupt payload"] = ok
    bad = [kp for kp, v in verdicts.items() if not v]
    if bad:
        failures.append(f"phase 9d: a torn or wrong checkpoint at {bad}")
    return verdicts


def phase9(pt, fa, seed, failures):
    """Phase 9 on a one-rank NCCL mesh, torn down at the end, with tracing's
    checkpoint category on (its counters time the copies); the checkpoint
    directory is removed at the end. A part that raises is a failure and
    the next one still runs."""
    import shutil
    import traceback
    from paddle_tpu_torch.observability import tracing
    log("phase 9: step checkpoints (CheckpointManager) around the k-step "
        "programs on a one-rank NCCL mesh")
    init_dp_mesh()
    tracing.enable(categories=["checkpoint"])
    out = {}
    try:
        for key, fn in (
                ("bert_resume", lambda: ckpt_bert_resume(pt, seed, failures)),
                ("gpt_in_place", lambda: ckpt_gpt_in_place(pt, fa, seed,
                                                           failures)),
                ("dropout", lambda: ckpt_dropout(pt, seed, failures)),
                ("crash", lambda: ckpt_crash(pt, seed, failures)),
                ("scaler", lambda: ckpt_scaler(pt, seed, failures))):
            log(f"  -- {key}")
            try:
                out[key] = fn()
            except Exception as e:  # noqa: BLE001 -- reported as a failure
                traceback.print_exc()
                failures.append(f"phase 9 ({key}) raised "
                                f"{type(e).__name__}: {e}")
            free_cuda()
    finally:
        tracing.disable()
        torch.distributed.destroy_process_group()
        shutil.rmtree(ckpt_dir(""), ignore_errors=True)
    log(f"  {card_line()}")
    return out


# ---- phase 10: GPT-3 1.3B under the fleet's hybrid parallelism --------------

GPT3_KSTEP = 4
GPT3_STEPS, GPT3_WARMUP = 7, 2     # (a): 2 warm-up and 5 timed eager steps
GPT3_MICRO = 4                     # (c): 4 microbatches of 2 x 1024
# GPT-3 XL's (1.3B) published peak rate, Brown et al. 2020, table 2.1
GPT3_PEAK_LR, GPT3_START_LR = 2e-4, 2e-5
GPT3_F32_BATCH, GPT3_F32_SEQ = 2, 128   # (e): the float32 card-vs-CPU step
# (a) the use_mp model under TensorParallel against the plain model from
# the same weights, bf16: at one rank every all-reduce is a copy and the
# row-parallel bias joins after the reduction as F.linear adds it after the
# product, so the two run the same kernels in the same order: bitwise
# (the CPU twin in tests/test_torch_fleet.py is bitwise too).
# (c) PipelineParallel at pp = 1 runs the plain accumulation's kernels in
# its order (F0 B0 F1 B1 ...): bitwise. build_gpt_1f1b_step at pp = 1
# recomputes each microbatch's stage through functional_call and sums the
# four microbatches' gradients in the parameters' dtype (bf16, as the
# reference accumulates), scaling by 1/4 after, where plain accumulation
# scales each microbatch's loss first: gradients within 2e-2 relative L2
# (a few bf16 rounding steps of 2^-8), the loss within 1e-5 relative
# (float32 sums of the microbatch losses in another order).
F1B_LOSS_REL, F1B_GRAD_REL = 1e-5, 2e-2
# (d) ring and Ulysses attention (float32 math on bf16 inputs, bf16 out)
# against the written-out float32 attention: one bf16 rounding step (2^-8)
# of values up to ~4; MoE on a one-rank ep group against its dense form:
# the same kernels, the all-to-all a copy: bitwise.
SP_ATOL, SP_RTOL = 1e-2, 1e-2


def lm_loss(logits, labels):
    """``GPTForCausalLM.loss`` for a PipelineLayer's logits: positions
    0..S-2 against labels 1..S-1."""
    from paddle_tpu_torch.nn import functional as F
    v = logits.shape[-1]
    return F.cross_entropy(logits[:, :-1].reshape(-1, v),
                           labels[:, 1:].reshape(-1).long())


def gpt3_cfg(**kw):
    from paddle_tpu_torch.models.gpt import gpt3_1p3b
    return gpt3_1p3b(hidden_dropout=0.0, attention_dropout=0.0, **kw)


def gpt3_model(pt, seed, use_mp=False):
    from paddle_tpu_torch.models.gpt import GPTForCausalLM
    pt.seed(seed)
    return GPTForCausalLM(gpt3_cfg(use_mp=use_mp),
                          device="cuda").to("bfloat16")


def gpt3_ids(seed, batch=GPT3_BATCH):
    from paddle_tpu_torch.models.gpt import synthetic_lm_batch
    return torch.from_numpy(synthetic_lm_batch(
        batch, SEQ, gpt3_cfg().vocab_size, seed=seed)).cuda()


def amp_step(pt, forward, model, opt, keep_grads=False):
    """The recipe's step: forward and loss under bf16 auto_cast, backward,
    the optimizer step and clear_grad; returns the loss (and the gradients
    before the step, cloned, with ``keep_grads``)."""
    def one_step(ids):
        with pt.amp.auto_cast(enable=True, dtype="bfloat16"):
            loss = model.loss(forward(ids), ids)
        loss.backward()
        grads = ({n: p.grad.clone() for n, p in model.named_parameters()}
                 if keep_grads else None)
        opt.step()
        opt.clear_grad()
        return (loss, grads) if keep_grads else loss
    return one_step


def gpt3_tensor_parallel(pt, fa, seed, hcg, failures):
    """(a) the use_mp model under TensorParallel against the plain model
    over two eager steps, then its timed eager steps."""
    import copy as _copy
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.distributed.fleet.base import fleet_base
    from paddle_tpu_torch.distributed.fleet.meta_parallel import \
        TensorParallel
    ids = gpt3_ids(seed + 100)
    plain = gpt3_model(pt, seed + 100)
    mp = gpt3_model(pt, seed + 100, use_mp=True)
    mp.set_state_dict(plain.state_dict())
    tp = TensorParallel(mp, hcg)
    # (a) replicates the optimizer state: the strategy without sharding
    replicated = _copy.deepcopy(fleet_base._strategy)
    replicated.sharding = False
    opt_p, sched_p = make_optimizer(plain, GPT3_PEAK_LR, GPT3_START_LR)
    inner, sched_m = make_optimizer(mp, GPT3_PEAK_LR, GPT3_START_LR)
    opt_m = fleet.distributed_optimizer(inner, replicated)
    step_p = amp_step(pt, plain, plain, opt_p, keep_grads=True)
    step_m = amp_step(pt, tp, mp, opt_m, keep_grads=True)
    loss_diff, worst = 0.0, (0.0, "")
    for _ in range(2):
        lp, gp = step_p(ids)
        lm, gm = step_m(ids)
        loss_diff = max(loss_diff, float((lp - lm).detach().abs()))
        for n, g in gp.items():
            worst = max(worst, (float((g.float() - gm[n].float()).abs()
                                      .max()), n))
        del gp, gm
        sched_p.step()
        sched_m.step()
    params = max(float((p.float() - q.float()).abs().max())
                 for p, q in zip(plain.parameters(), mp.parameters()))
    ok = loss_diff == 0.0 and worst[0] == 0.0 and params == 0.0
    log(f"  (a) use_mp GPT-3 1.3B under TensorParallel vs the plain model, 2 "
        f"eager steps: losses max |diff| {loss_diff:.3e}, gradients max "
        f"|diff| {worst[0]:.3e} ({worst[1]}), parameters after max |diff| "
        f"{params:.3e} (tol 0: bitwise) {'ok' if ok else 'FAIL'}")
    if not ok:
        failures.append("phase 10a: the use_mp model under TensorParallel "
                        "disagrees with the plain model")
    del plain, opt_p, step_p
    free_cuda()

    step = amp_step(pt, tp, mp, opt_m)
    counters = (fa.flash_attention_fwd, fa.flash_attention_bwd_dq,
                fa.flash_attention_bwd_dkv)
    fa.reset_launch_counts()
    losses, tel, peak = timed_eager(lambda: step(ids), GPT3_STEPS,
                                    GPT3_WARMUP, ids.numel(),
                                    mp.flops_per_token(SEQ))
    launches = {c.__name__: c.launches for c in counters}
    for c in counters:
        want = gpt3_cfg().num_layers * GPT3_STEPS
        ok = c.launches == want and c.variant_launches["bf16"] == want
        log(f"  (a) {c.__name__}: {c.launches} launches over {GPT3_STEPS} "
            f"steps (want {want}: 24 a step), {c.variant_launches['bf16']} "
            f"on the bf16 variant {'ok' if ok else 'FAIL'}")
        if not ok:
            failures.append(f"phase 10a: {c.__name__} launched {c.launches}"
                            f" times, not {want}, all bf16")
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        failures.append(f"phase 10a: losses not finite and falling: "
                        f"{losses}")
    log(f"  (a) losses: {[round(x, 4) for x in losses]}")
    prof = report_profile("GPT-3 1.3B eager step", profile_retry(
        lambda: step(ids).item()), failures)
    rate = log_rate("GPT-3 1.3B eager (TensorParallel, mp = 1)", tel, 1,
                    mp.flops_per_token(SEQ), peak, prof)
    rate["reserved_gb"] = torch.cuda.memory_reserved() / 1e9
    log(f"  (a) reserved memory {rate['reserved_gb']:.3f} GB; "
        f"{card_line()}")
    return launches, rate


def gpt3_kstep(pt, fa, seed, hcg, failures):
    """(b) the same step through to_static(scan_steps=4, dp_axis="dp") with
    ZeRO-1 (strategy.sharding), against 4 eager steps of the same arm."""
    from paddle_tpu_torch import jit
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.distributed.fleet.meta_parallel import \
        TensorParallel
    k = GPT3_KSTEP
    stacked = torch.stack([gpt3_ids(seed + 200 + i) for i in range(k)])

    def arm():
        mp = gpt3_model(pt, seed + 200, use_mp=True)
        tp = TensorParallel(mp, hcg)
        inner, sched = make_optimizer(mp, GPT3_PEAK_LR, GPT3_START_LR)
        opt = fleet.distributed_optimizer(inner)  # ZeRO-1 over dp
        return mp, amp_step(pt, tp, mp, opt), opt

    mp, step, opt = arm()
    layout = opt.zero_layout()
    want = torch.stack([step(stacked[i]).detach() for i in range(k)])
    want_params = [p.detach().cpu() for p in mp.parameters()]
    names = [n for n, _ in mp.named_parameters()]
    del mp, step, opt
    free_cuda()
    mp, step, opt = arm()
    program = jit.to_static(step, scan_steps=k, dp_axis="dp")
    with inspect_capture():
        got, peak = first_kstep_call("(b) GPT-3 1.3B k-step",
                                     lambda: program(stacked))
    loss_diff = float((got.float() - want.float()).abs().max())
    worst = max((float((p.detach().cpu().float() - q.float()).abs().max()),
                 n) for n, p, q in zip(names, mp.parameters(), want_params))
    ok = loss_diff == 0.0 and worst[0] == 0.0
    log(f"  (b) ZeRO {layout['stage']} over {layout['axis']!r} (degree "
        f"{layout['degree']}, {layout['n_buckets']} buckets); k-step vs 4 "
        f"eager steps: losses max |diff| {loss_diff:.3e}, parameters max "
        f"|diff| {worst[0]:.3e} ({worst[1]}) (tol 0: bitwise) "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        failures.append("phase 10b: the k-step program disagrees with the "
                        "same eager steps")
    del want_params
    fa.reset_launch_counts()
    replays = count_replays(program)
    prof = report_profile(f"GPT-3 1.3B k-step call ({k} steps)",
                          profile_retry(lambda: replays.run(
                              lambda: program(stacked).cpu())), failures)
    launches, off = replays.launches()
    check_launches("(b) replayed GPT-3 1.3B k-step call", launches, off, prof,
                   {meta["name"]: gpt3_cfg().num_layers * k
                    for meta in KERNELS}, failures)
    calls, tel = timed_kstep(lambda: program(stacked), k, 2,
                             stacked[0].numel(), mp.flops_per_token(SEQ))
    losses = torch.cat([got.cpu()] + calls)
    if not bool(torch.isfinite(losses).all()):
        failures.append("phase 10b: k-step losses not finite")
    rate = log_rate(f"GPT-3 1.3B k-step (scan_steps={k}, ZeRO-1, CUDA "
                    "graph)", tel, k, mp.flops_per_token(SEQ), peak, prof)
    rate["reserved_gb"] = torch.cuda.memory_reserved() / 1e9
    log(f"  (b) reserved memory {rate['reserved_gb']:.3f} GB; "
        f"{card_line()}")
    return launches, rate


def gpt3_pipeline(pt, seed, hcg, failures):
    """(c) PipelineParallel at pp = 1 and build_gpt_1f1b_step at pp = 1
    against plain accumulation of the same microbatches."""
    import copy as _copy
    from paddle_tpu_torch.distributed.fleet.base import fleet_base
    from paddle_tpu_torch.distributed.fleet.meta_parallel import \
        PipelineParallel
    from paddle_tpu_torch.models.gpt import (GPTForCausalLM,
                                             build_gpt_1f1b_step,
                                             build_pipeline_layer)
    ids = gpt3_ids(seed + 300)
    strategy = _copy.deepcopy(fleet_base._strategy)
    strategy.pipeline_configs = {"accumulate_steps": GPT3_MICRO,
                                 "micro_batch_size": GPT3_BATCH // GPT3_MICRO}

    def layer():
        pt.seed(seed + 300)
        pl = build_pipeline_layer(gpt3_cfg(), 1, loss_fn=lm_loss,
                                  device="cuda").to("bfloat16")
        return pl, make_optimizer(pl, GPT3_PEAK_LR, GPT3_START_LR)[0]

    pl, opt = layer()
    pipe = PipelineParallel(pl, hcg, strategy)
    with pt.amp.auto_cast(enable=True, dtype="bfloat16"):
        loss = pipe.train_batch((ids, ids), opt)
    got = [p.detach().cpu() for p in pl.parameters()]
    schedule = list(pipe._last_schedule)
    del pl, opt, pipe
    free_cuda()
    pl, opt = layer()
    total = torch.zeros((), device="cuda")
    with pt.amp.auto_cast(enable=True, dtype="bfloat16"):
        for x in ids.chunk(GPT3_MICRO):
            micro = lm_loss(pl(x), x) / GPT3_MICRO
            micro.backward()
            total += micro.detach().float()
    opt.step()
    loss_diff = float((loss - total).abs())
    worst = max(float((p.detach().cpu().float() - q.float()).abs().max())
                for p, q in zip(pl.parameters(), got))
    want_schedule = [(kind, m) for m in range(GPT3_MICRO) for kind in "FB"]
    ok = loss_diff == 0.0 and worst == 0.0 and schedule == want_schedule
    log(f"  (c) PipelineParallel (pp = 1, {GPT3_MICRO} microbatches of "
        f"{GPT3_BATCH // GPT3_MICRO} x {SEQ}) vs plain accumulation: loss "
        f"{float(loss):.6f} max |diff| {loss_diff:.3e}, parameters after "
        f"the step max |diff| {worst:.3e} (tol 0: bitwise); schedule "
        f"{schedule} (the reference's for S = 1, M = {GPT3_MICRO}) "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        failures.append("phase 10c: the pipeline disagrees with plain "
                        "accumulation or the reference's schedule")
    del pl, opt, got
    free_cuda()

    pt.seed(seed + 301)
    model = GPTForCausalLM(gpt3_cfg(), device="cuda").to("bfloat16")
    run, (sp, fp, lp, _) = build_gpt_1f1b_step(model, axis_pp="pp")
    micro = ids.view(GPT3_MICRO, GPT3_BATCH // GPT3_MICRO, SEQ)
    with pt.amp.auto_cast(enable=True, dtype="bfloat16"):
        f_loss, (gP, gF, gL) = run(micro, micro)
        acc = torch.zeros((), device="cuda")
        for x in micro:
            part = model.loss(model(x), x) / GPT3_MICRO
            part.backward()
            acc += part.detach().float()
    loss_rel = float((f_loss - acc).abs() / acc)
    pairs = [(g, p.grad) for blk, pblk in zip(gP, sp)
             for g, p in zip(blk, pblk)]
    pairs += [(gF[1], fp[1].grad), (gL[0], lp[0].grad), (gL[1], lp[1].grad),
              (gF[0] + gL[2], fp[0].grad)]  # the tied wte: both parts
    grad_rel = max(float((a.float() - b.float()).norm() / b.float().norm())
                   for a, b in pairs)
    ok = loss_rel <= F1B_LOSS_REL and grad_rel <= F1B_GRAD_REL
    log(f"  (c) build_gpt_1f1b_step (pp = 1, {GPT3_MICRO} microbatches) vs "
        f"plain accumulation: loss rel {loss_rel:.3e} (tol "
        f"{F1B_LOSS_REL:g}), worst gradient rel L2 {grad_rel:.3e} (tol "
        f"{F1B_GRAD_REL:g}) {'ok' if ok else 'FAIL'}")
    if not ok:
        failures.append("phase 10c: build_gpt_1f1b_step disagrees with "
                        "plain accumulation")


def gpt3_sequence_expert(pt, seed, failures):
    """(d) ring and Ulysses attention on a one-rank sp group at [1, 1024,
    16, 128] against the written-out attention; moe_ffn on a one-rank ep
    group (4 experts, 2048 -> 8192) against its dense form; bf16."""
    from paddle_tpu_torch.distributed import collective
    from paddle_tpu_torch.parallel import (moe_ffn, ring_attention,
                                           ulysses_attention)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed + 400)
    sp = collective.new_group([0], axis_name="sp")
    q, k, v = (rand(gen, 1, SEQ, GPT3_HEADS, GPT3_HEAD_DIM, torch.bfloat16)
               for _ in range(3))
    want = written_out_attention(q.float(), k.float(), v.float(), True)
    for name, fn in (("ring_attention", ring_attention),
                     ("ulysses_attention", ulysses_attention)):
        out = fn(q, k, v, group=sp, causal=True)
        err = (out.float() - want).abs()
        ok = bool((err <= SP_ATOL + SP_RTOL * want.abs()).all()) and \
            out.dtype == torch.bfloat16
        log(f"  (d) {name} (one-rank sp group, [1, {SEQ}, {GPT3_HEADS}, "
            f"{GPT3_HEAD_DIM}] bf16, causal) vs the written-out attention: "
            f"max_abs_err {err.max().item():.3e} (tol {SP_ATOL:g} + "
            f"{SP_RTOL:g}*|ref|) {'ok' if ok else 'FAIL'}")
        if not ok:
            failures.append(f"phase 10d: {name} disagrees with the "
                            "written-out attention")
    h, f, e = 2048, 8192, 4
    x = torch.randn(SEQ, h, generator=gen, device="cuda").bfloat16()
    ws = [torch.randn(*shape, generator=gen, device="cuda").mul(scale)
          .bfloat16() for shape, scale in (
              ((h, e), 0.05), ((e, h, f), h ** -0.5), ((e, f), 0.02),
              ((e, f, h), f ** -0.5), ((e, h), 0.02))]
    ep = collective.new_group([0], axis_name="ep")
    y1, aux1 = moe_ffn(x, *ws, group=ep)
    y0, aux0 = moe_ffn(x, *ws)
    diff = float((y1.float() - y0.float()).abs().max())
    ok = diff == 0.0 and float(aux1) == float(aux0) and bool(
        torch.isfinite(y1.float()).all())
    log(f"  (d) moe_ffn (one-rank ep group, {e} experts, {h} -> {f}, {SEQ} "
        f"tokens, bf16) vs its dense form: max |diff| {diff:.3e}, aux "
        f"{float(aux1):.6f} vs {float(aux0):.6f} (tol 0: bitwise) "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        failures.append("phase 10d: moe_ffn at ep = 1 disagrees with its "
                        "dense form")


def gpt3_f32_step(pt, seed, failures):
    """(e) a float32 GPT-3 1.3B of two layers: one step on the card against
    the same step on the CPU."""
    from paddle_tpu_torch.models.gpt import (GPTForCausalLM, gpt3_1p3b,
                                             synthetic_lm_batch)
    cfg = gpt3_1p3b(num_layers=2, hidden_dropout=0.0, attention_dropout=0.0)
    pt.seed(seed + 500)
    model = GPTForCausalLM(cfg, device="cuda")
    ids = synthetic_lm_batch(GPT3_F32_BATCH, GPT3_F32_SEQ, cfg.vocab_size,
                             seed=seed + 500)

    def loss_fn(m, device):
        x = torch.from_numpy(ids).to(device)
        return m.loss(m(x), x)

    check_f32_step(model, lambda m: make_optimizer(
        m, GPT3_PEAK_LR, GPT3_START_LR)[0], loss_fn, GPT3_START_LR,
        f"GPT-3 1.3B width, 2 layers, {GPT3_F32_BATCH} x {GPT3_F32_SEQ}",
        failures)


def phase10(pt, fa, seed, failures):
    """Phase 10: GPT-3 1.3B under the fleet's hybrid parallelism on a
    one-rank NCCL world (every axis a one-rank group), torn down at the
    end. A part that raises is a failure and the next one still runs."""
    import traceback
    from paddle_tpu_torch.distributed import fleet
    log("phase 10: GPT-3 1.3B (vocab 50304, hidden 2048, 24 layers, 16 "
        "heads, seq 1024) under fleet hybrid parallelism at degree 1")
    census = memory_census("the start of phase 10")
    strategy = fleet.DistributedStrategy()
    strategy.hybrid_configs = {"dp_degree": 1, "mp_degree": 1,
                               "pp_degree": 1, "sharding_degree": 1}
    strategy.sharding = True
    hcg = fleet.init(is_collective=True, strategy=strategy)
    cfg = gpt3_cfg()
    n = sum(p.numel() for p in gpt3_model(pt, seed).parameters())
    free_cuda()
    fpt = 6 * n + 12 * cfg.num_layers * cfg.hidden_size * SEQ
    log(f"  {n} parameters, flops_per_token 6 N + 12 L h S = {fpt} "
        f"({fpt * GPT3_BATCH * SEQ:.4g} FLOP a step of {GPT3_BATCH} x "
        f"{SEQ} tokens); mesh {hcg.mesh}")
    out = {"parameters": n, "flops_per_token": fpt,
           "memory_at_start_gb": [round(b / 1e9, 3) for b in census]}
    try:
        for key, fn in (
                ("tensor_parallel", lambda: gpt3_tensor_parallel(
                    pt, fa, seed, hcg, failures)),
                ("kstep", lambda: gpt3_kstep(pt, fa, seed, hcg, failures)),
                ("pipeline", lambda: gpt3_pipeline(pt, seed, hcg, failures)),
                ("sequence_expert", lambda: gpt3_sequence_expert(
                    pt, seed, failures)),
                ("float32", lambda: gpt3_f32_step(pt, seed, failures))):
            log(f"  -- {key}")
            t0 = time.perf_counter()
            try:
                out[key] = fn()
            except Exception as e:  # noqa: BLE001 -- reported as a failure
                traceback.print_exc()
                failures.append(f"phase 10 ({key}) raised "
                                f"{type(e).__name__}: {e}")
            free_cuda()
            log(f"  -- {key}: {time.perf_counter() - t0:.1f} s")
    finally:
        from paddle_tpu_torch.distributed import parallel_env
        from paddle_tpu_torch.distributed.fleet.base import topology
        topology.set_hybrid_communicate_group(None)
        parallel_env.set_mesh(None)
        torch.distributed.destroy_process_group()
    log(f"  {card_line()}")
    return out


# ---- phase 11: convolutional networks ---------------------------------------
#
# ResNet-50 (BASELINE.md config 2) with benchmarks/run_all.py's accelerator
# recipe (:45-85: batch 64 at 224 x 224, 1000 classes, Momentum(lr=0.1,
# momentum=0.9), bf16 auto_cast) and PaddleClas ResNet50.yaml's L2Decay(1e-4)
# and Piecewise rate (values 0.1, 0.01, 0.001, 0.0001 at decay_epochs 30, 60,
# 90, the epochs cut to one k-step call each: boundaries [1, 2, 3]). Seeded
# random images and labels; nothing else cut: full width and depth. NCHW
# throughout (channels_last is a later question).
RESNET_BATCH, RESNET_SIZE, RESNET_CLASSES = 64, 224, 1000
RESNET_MOMENTUM, RESNET_DECAY = 0.9, 1e-4
RESNET_BOUNDARIES, RESNET_VALUES = [1, 2, 3], [0.1, 0.01, 0.001, 0.0001]
RESNET_STAGES = [3, 4, 6, 3]     # ResNet-50's bottleneck blocks a stage
RESNET_KSTEP = 4
RESNET_F32_BATCH = 2             # (a1): the float32 card-vs-CPU step
RESNET_BUCKETS = (1, 16, 64)
LENET_BATCH, LENET_STEPS, LENET_LR = 64, 5, 0.01
# Phase 11's tolerances, fixed before its first run.
# cuDNN: the checks ((a1), (a4), (b) and the served float32 check) run with
# torch.backends.cudnn.deterministic = True and benchmark = False: cuDNN's
# heuristics pick deterministic algorithms (no atomics), the same for the
# eager steps and the captured graph, so (a4) is held bitwise
# (KSTEP_MAX_ABS_TOL). The timed runs ((a3), the timed k-step program,
# serving) use benchmark = True and deterministic = False; the eager step
# that every program runs before its capture autotunes each shape, so no
# autotuning happens inside a capture.
# (b) LeNet: float32 (TF32 off), card vs CPU, float32 summation order: each
# loss within STEP_LOSS_REL_TOL, the first step's gradients together within
# VISION_GRAD_REL_L2_TOL (relative L2), each gradient, each update over the
# steps and each running statistic within VISION_TENSOR_REL_L2_TOL.
VISION_GRAD_REL_L2_TOL = 1e-4
VISION_TENSOR_REL_L2_TOL = 1e-3
# (a1) ResNet-50, float32 card vs CPU at 2 x 224 x 224. ResNet-50's
# gradients at its initialization are ill-conditioned in float32: on the
# CPU, float32 against float64 from the same weights and images differs by
# 3.0e-2 relative L2 over all gradients (worst tensor 3.7e-2, a BatchNorm
# bias), so no float32 implementation meets the LeNet bound, and the first
# run of this phase, which held ResNet-50 to it, failed at 2.6e-2 with the
# loss within 1.4e-6. So the card is held to the CPU's own float32 error:
# its gradients' distance from the CPU's float64 gradients (relative L2
# over all of them) within VISION_F64_FACTOR x the CPU float32 gradients'
# distance from the same. The loss within STEP_LOSS_REL_TOL; the running
# statistics within VISION_TENSOR_REL_L2_TOL; the first Momentum step exact
# to VISION_UPDATE_REL_MAX of each tensor's largest element against p -
# lr * (g + decay * p) computed on the host from the card's own gradient
# (separate kernels round as the host does).
VISION_F64_FACTOR = 4.0
VISION_UPDATE_REL_MAX = 2.0 ** -22
# (a2): the bf16 AMP loss of the first step against float32's: bf16
# products through 53 convolutions and BatchNorms (2e-2 as in the port's
# CPU tests of ResNet under auto_cast).
RESNET_AMP_LOSS_REL_TOL = 2e-2
# Kernel kinds of a profiled convolutional step (first match wins).
VISION_KINDS = [
    ("attention kernels (hand-written)", ("flash_",)),
    ("BatchNorm running statistics (var_mean)", ("Welford",)),
    ("BatchNorm", ("batch_norm", "batchnorm", "BatchNorm", "bn_fw", "bn_bw",
                   "bn_")),
    ("convolution", ("fprop", "dgrad", "wgrad", "conv", "Conv", "implicit",
                     "cudnn", "winograd", "nchwToNhwc", "nhwcToNchw")),
    ("GEMM", ("nvjet", "gemm", "cutlass", "xmma", "cublas")),
    ("pooling", ("pool",)),
    ("reductions", ("reduce_kernel",)),
    ("copies and casts", ("copy",)),
    ("elementwise", ("elementwise",))]


class cudnn_mode:
    """``deterministic`` (the checks) or autotuned (the timed runs)."""

    def __init__(self, deterministic):
        self.deterministic = deterministic

    def __enter__(self):
        self.saved = (torch.backends.cudnn.deterministic,
                      torch.backends.cudnn.benchmark)
        torch.backends.cudnn.deterministic = self.deterministic
        torch.backends.cudnn.benchmark = not self.deterministic

    def __exit__(self, *exc):
        (torch.backends.cudnn.deterministic,
         torch.backends.cudnn.benchmark) = self.saved
        return False


def resnet_closed_form_macs(stages, size, classes, width=64, expansion=4):
    """Multiply-adds of one image's forward through a bottleneck ResNet
    from its configuration alone: the 7 x 7 stem, the 3 x 3 max pool, each
    block's 1 x 1, 3 x 3 (the stride, as the reference's BottleneckBlock)
    and 1 x 1 convolutions and its first block's projection, the fc."""
    s = (size + 2 * 3 - 7) // 2 + 1
    macs = s * s * width * 3 * 7 * 7
    s = (s + 2 - 3) // 2 + 1
    cin = width
    for i, (blocks, planes) in enumerate(zip(stages, (64, 128, 256, 512))):
        for j in range(blocks):
            so = (s - 1) // (2 if i and not j else 1) + 1
            macs += s * s * cin * planes + so * so * planes * planes * 9
            macs += so * so * planes * planes * expansion
            if not j:
                macs += so * so * cin * planes * expansion
            cin, s = planes * expansion, so
    return macs + cin * classes


def layer_macs(model, size):
    """Multiply-adds of one image's forward, from the shapes that the
    model's convolutions and linear layers see (forward hooks, batch 1, on
    the model's device)."""
    from paddle_tpu_torch import nn
    total = [0]

    def hook(layer, inputs, out):
        if isinstance(layer, nn.Linear):  # [in, out]
            total[0] += layer.weight.numel()
        else:  # each output element: in/groups x kh x kw products
            total[0] += out[0].numel() * layer.weight[0].numel()

    layers = [m for m in model.modules()
              if isinstance(m, (nn.Conv2D, nn.Linear))]
    handles = [m.register_forward_hook(hook) for m in layers]
    was_training = model.training
    try:
        with torch.no_grad():
            model.eval()(torch.zeros(1, 3, size, size,
                                     device=model.parameters()[0].device))
    finally:
        model.train(was_training)
        for h in handles:
            h.remove()
    return total[0], len(layers)


def resnet_optimizer(model):
    """PaddleClas's ResNet-50 optimizer: Momentum with L2Decay and the
    Piecewise rate."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch import optimizer
    sched = optimizer.lr.PiecewiseDecay(RESNET_BOUNDARIES, RESNET_VALUES)
    opt = optimizer.Momentum(learning_rate=sched, momentum=RESNET_MOMENTUM,
                             parameters=model.parameters(),
                             weight_decay=pt.L2Decay(RESNET_DECAY))
    return opt, sched


def vision_one_step(model, opt):
    """run_all.py's train_step: forward and loss under bf16 auto_cast,
    backward, the optimizer's step; returns the loss (a device tensor)."""
    from paddle_tpu_torch import amp
    from paddle_tpu_torch.nn import functional as F

    def one_step(x, y):
        with amp.auto_cast(enable=True, dtype="bfloat16"):
            loss = F.cross_entropy(model(x), y)
        loss.backward()
        opt.step()
        opt.clear_grad()
        return loss
    return one_step


def vision_f32_step(model, make_opt, x, y, steps=1):
    """``steps`` float32 steps of ``model`` on its device: (losses,
    gradients of the first step, parameters before and after, buffers
    after), on the CPU."""
    from paddle_tpu_torch.nn import functional as F
    model.train()
    dev = model.parameters()[0].device
    before = {n: p.detach().cpu().clone() for n, p in model.named_parameters()}
    opt = make_opt(model)
    losses, grads = [], None
    for i in range(steps):
        loss = F.cross_entropy(model(x[i].to(dev)), y[i].to(dev))
        loss.backward()
        if grads is None:
            grads = {n: p.grad.detach().cpu()
                     for n, p in model.named_parameters()}
        opt.step()
        opt.clear_grad()
        losses.append(loss.item())
    after = {n: p.detach().cpu() for n, p in model.named_parameters()}
    buffers = {n: b.detach().cpu().clone() for n, b in model.named_buffers()}
    return losses, grads, before, after, buffers


def rel_l2(a, b):
    return float((a - b).norm() / b.norm().clamp_min(1e-30))


def flat(tensors, names):
    return torch.cat([tensors[n].flatten().double() for n in names])


def float64_grads(model, x, y):
    """The first step's gradients in float64 on the CPU (torch's cross
    entropy, no float32 anywhere)."""
    m = copy.deepcopy(model).to("cpu").double().train()
    torch.nn.functional.cross_entropy(m(x.cpu().double()), y.cpu()) \
        .backward()
    return {n: p.grad for n, p in m.named_parameters()}


def check_vision_f32(model, make_opt, x, y, label, failures, steps=1,
                     momentum_step=None):
    """float32 steps on the card (cuDNN deterministic) against the same
    steps on the CPU. With ``momentum_step=(lr, decay)`` (one step, (a1)):
    the gradients against float64's, the step against the host's; else
    (LeNet) the gradients and updates against the CPU's directly."""
    t0 = time.perf_counter()
    with cudnn_mode(deterministic=True):
        card = vision_f32_step(copy.deepcopy(model), make_opt, x, y, steps)
    t1 = time.perf_counter()
    cpu = vision_f32_step(copy.deepcopy(model).to("cpu"), make_opt, x, y,
                          steps)
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(card[0], cpu[0]))
    names = list(cpu[1])
    ok = loss_rel <= STEP_LOSS_REL_TOL and all(np.isfinite(card[0]))
    msg = (f"losses {[round(v, 6) for v in card[0]]} vs "
           f"{[round(v, 6) for v in cpu[0]]} (worst rel {loss_rel:.3e}, tol "
           f"{STEP_LOSS_REL_TOL:g})")
    buf = max(((rel_l2(card[4][n], t), n) for n, t in cpu[4].items()),
              default=(0.0, ""))
    if momentum_step is None:
        grad_all = rel_l2(flat(card[1], names), flat(cpu[1], names))
        grad = max((rel_l2(card[1][n], cpu[1][n]), n) for n in names)
        upd = max((rel_l2(card[3][n] - card[2][n], cpu[3][n] - cpu[2][n]),
                   n) for n in names)
        ok &= grad_all <= VISION_GRAD_REL_L2_TOL and max(
            grad[0], upd[0], buf[0]) <= VISION_TENSOR_REL_L2_TOL
        msg += (f"; all gradients rel L2 {grad_all:.3e} (tol "
                f"{VISION_GRAD_REL_L2_TOL:g}); worst gradient {grad[0]:.3e} "
                f"({grad[1]}), update {upd[0]:.3e} ({upd[1]}), buffer "
                f"{buf[0]:.3e} ({buf[1]}) (tol {VISION_TENSOR_REL_L2_TOL:g})")
    else:
        lr, decay = momentum_step
        g64 = flat(float64_grads(model, x[0], y[0]), names)
        d_card = rel_l2(flat(card[1], names), g64)
        d_cpu = rel_l2(flat(cpu[1], names), g64)
        worst = 0.0
        for n in names:
            p0, g = card[2][n], card[1][n]
            want = p0 - lr * (g + decay * p0)
            worst = max(worst, float((card[3][n] - want).abs().max()
                                     / p0.abs().max()))
        ok &= d_card <= VISION_F64_FACTOR * d_cpu
        ok &= buf[0] <= VISION_TENSOR_REL_L2_TOL
        ok &= worst <= VISION_UPDATE_REL_MAX
        between = rel_l2(flat(card[1], names), flat(cpu[1], names))
        msg += (f"; all gradients rel L2 from float64: card {d_card:.3e}, "
                f"CPU float32 {d_cpu:.3e} (tol {VISION_F64_FACTOR:g} x the "
                f"CPU's), card vs CPU {between:.3e}; worst buffer {buf[0]:.3e} "
                f"({buf[1]}, tol {VISION_TENSOR_REL_L2_TOL:g}); the Momentum "
                f"step against p - lr (g + decay p) from the card's gradient:"
                f" max |diff| / max |p| {worst:.3e} (tol "
                f"{VISION_UPDATE_REL_MAX:.3g})")
    log(f"  {label}: card {t1 - t0:.2f} s, CPU {time.perf_counter() - t1:.2f}"
        f" s; {msg} {'ok' if ok else 'FAIL'}")
    if not ok:
        failures.append(f"phase 11: {label}: card disagrees with CPU")
    return card[0]


def flash_launches(fa):
    return {w.__name__: w.launches for w in (
        fa.flash_attention_fwd, fa.flash_attention_bwd_dq,
        fa.flash_attention_bwd_dkv)}


def no_flash_in_trace(label, prof, failures):
    seen = 0 if prof is None else sum(
        c for name, c in prof["counts"].items()
        if any(m["kernel"] in name or m["cuda_core"] in name
               for m in KERNELS))
    log(f"  {label}: flash kernels in the profiler's trace: {seen} (none "
        f"expected) {'ok' if not seen else 'FAIL'}")
    if seen:
        failures.append(f"{label}: the trace shows {seen} flash kernels")


def resnet_training(pt, fa, seed, failures):
    """(a): ResNet-50 trained, float32 card vs CPU, bf16 eager and the
    k-step program."""
    from paddle_tpu_torch import jit
    from paddle_tpu_torch.vision.models import resnet50
    pt.seed(seed + 600)
    base = resnet50(num_classes=RESNET_CLASSES, device="cuda")
    n = sum(p.numel() for p in base.parameters())
    cpu_model = copy.deepcopy(base).to("cpu")
    macs, n_layers = layer_macs(cpu_model, RESNET_SIZE)
    closed = resnet_closed_form_macs(RESNET_STAGES, RESNET_SIZE,
                                     RESNET_CLASSES)
    fpi = 3 * 2 * macs  # FLOP an image of a training step
    log(f"  model: {n} parameters in {len(list(base.parameters()))} tensors, "
        f"{len(list(base.buffers()))} running statistics; {macs} "
        f"multiply-adds an image forward from the shapes of its {n_layers} "
        f"convolutions and fc (on the CPU; closed form {closed}: "
        f"{'ok' if macs == closed else 'FAIL'}); a training step 3 x 2 x "
        f"MACs = {fpi} FLOP an image")
    if macs != closed:
        failures.append(f"phase 11: layer MACs {macs} != closed form "
                        f"{closed}")
    del cpu_model
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed + 601)

    def images(b):
        return (torch.rand(b, 3, RESNET_SIZE, RESNET_SIZE, generator=gen,
                           device="cuda"),
                torch.randint(0, RESNET_CLASSES, (b,), generator=gen,
                              device="cuda"))

    # (a1) float32 step, card vs CPU
    x1, y1 = images(RESNET_F32_BATCH)
    check_vision_f32(base, lambda m: resnet_optimizer(m)[0], [x1], [y1],
                     f"(a1) float32 step at {RESNET_F32_BATCH} x 3 x "
                     f"{RESNET_SIZE} x {RESNET_SIZE}", failures,
                     momentum_step=(RESNET_VALUES[0], RESNET_DECAY))
    start = copy.deepcopy(base)  # the state every run below starts from
    x, y = images(RESNET_BATCH)
    with cudnn_mode(deterministic=True), torch.no_grad():
        loss32 = torch.nn.functional.cross_entropy(
            copy.deepcopy(base)(x), y).item()

    # (a3) eager: 2 warm-up and 10 timed steps, autotuned cuDNN
    fa.reset_launch_counts()
    opt, _ = resnet_optimizer(base)
    step = vision_one_step(base, opt)
    with cudnn_mode(deterministic=False):
        losses, tel, peak = timed_eager(lambda: step(x, y), TRAIN_STEPS,
                                        WARMUP_STEPS, RESNET_BATCH, fpi)
        prof = report_profile("eager ResNet-50 step", profile_retry(
            lambda: step(x, y).item()), failures, kinds=VISION_KINDS)
    log(f"  (a3) eager losses: {[round(v, 4) for v in losses]}")
    no_flash_in_trace("(a3) profiled eager step", prof, failures)
    if not all(np.isfinite(losses)):
        failures.append(f"phase 11: ResNet-50 eager losses not finite: "
                        f"{losses}")
    amp_rel = abs(losses[0] - loss32) / abs(loss32)
    ok = amp_rel <= RESNET_AMP_LOSS_REL_TOL
    log(f"  (a2) bf16 AMP loss of step 1 {losses[0]:.6f} vs float32 loss "
        f"{loss32:.6f}: rel {amp_rel:.3e} (tol {RESNET_AMP_LOSS_REL_TOL:g}) "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        failures.append("phase 11: ResNet-50 bf16 AMP loss disagrees with "
                        "the float32 loss")
    log(f"  {card_line()}")
    eager = log_rate("(a3) ResNet-50 eager (tokens = images)", tel, 1, fpi,
                     peak, prof)
    eager["by_kind_ms"] = None if prof is None else prof["by_kind_ms"]
    eager["reserved_gb"] = torch.cuda.memory_reserved() / 1e9
    eager["losses"] = losses

    # (a4) the k-step program against the same eager steps, bitwise, over
    # two calls with the rate stepped between them
    data = [images(RESNET_BATCH) for _ in range(2 * RESNET_KSTEP)]
    stacked = [tuple(torch.stack(col) for col in zip(
        *data[c * RESNET_KSTEP:(c + 1) * RESNET_KSTEP])) for c in range(2)]
    twin_e, twin_k = copy.deepcopy(start), copy.deepcopy(start)
    opt_e, sched_e = resnet_optimizer(twin_e)
    opt_k, sched_k = resnet_optimizer(twin_k)
    with cudnn_mode(deterministic=True):
        step_e = vision_one_step(twin_e, opt_e)
        want = []
        for c in range(2):
            want += [step_e(xs, ys).detach() for xs, ys in zip(*stacked[c])]
            sched_e.step()
        program = jit.to_static(vision_one_step(twin_k, opt_k),
                                scan_steps=RESNET_KSTEP)
        with inspect_capture():
            got1, _ = first_kstep_call("(a4) ResNet-50 k-step, deterministic",
                                       lambda: program(*stacked[0]))
        sched_k.step()
        counter = count_replays(program)
        got2 = counter.run(lambda: program(*stacked[1]))
        nodes, off = counter.launches()
    compare_runs("(a4) ResNet-50", torch.stack(want),
                 torch.cat([got1, got2]), twin_e, twin_k, failures, opt_e,
                 opt_k)
    log(f"  (a4) flash kernel nodes in the replayed call's graph: {nodes} "
        f"(+{off} CUDA-core; none expected)")
    if any(nodes.values()) or any(off.values()):
        failures.append(f"phase 11: the ResNet-50 graph holds flash kernels "
                        f"{nodes}")
    del twin_e, twin_k, program, step_e, opt_e, opt_k

    # the k-step program timed, autotuned cuDNN; (a5) one profiled call
    timed = copy.deepcopy(start)
    opt_t, _ = resnet_optimizer(timed)
    with cudnn_mode(deterministic=False):
        prog_t = jit.to_static(vision_one_step(timed, opt_t),
                               scan_steps=RESNET_KSTEP)
        _, kpeak = first_kstep_call("(a4) ResNet-50 k-step, timed program",
                                    lambda: prog_t(*stacked[0]))
        calls, ktel = timed_kstep(lambda: prog_t(*stacked[0]), RESNET_KSTEP,
                                  KSTEP_TIMED_CALLS, RESNET_BATCH, fpi)
        kprof = report_profile(f"(a5) k-step ResNet-50 call ({RESNET_KSTEP} "
                               f"steps)", profile_retry(
                                   lambda: prog_t(*stacked[0]).cpu()),
                               failures, kinds=VISION_KINDS)
    no_flash_in_trace("(a5) profiled k-step call", kprof, failures)
    if kprof is not None:
        for kind in ("GEMM", "convolution", "elementwise"):
            names = [(us, n) for n, us in kprof["top"] if next(
                (k for k, keys in VISION_KINDS
                 if any(w in n for w in keys)), "other") == kind][:3]
            log(f"    largest {kind} kernels: " + "; ".join(
                f"{us / 1e3:.3f} ms {n[:90]}" for us, n in names))
    if not all(bool(torch.isfinite(c).all()) for c in calls):
        failures.append("phase 11: ResNet-50 k-step losses not finite")
    kstep = log_rate(f"(a4) ResNet-50 k-step (scan_steps={RESNET_KSTEP}, "
                     f"CUDA graph; tokens = images)", ktel, RESNET_KSTEP, fpi,
                     kpeak, kprof)
    kstep["by_kind_ms"] = None if kprof is None else kprof["by_kind_ms"]
    kstep["reserved_gb"] = torch.cuda.memory_reserved() / 1e9
    log(f"  ResNet-50 step: eager {eager['step_ms']:.3f} ms, k-step "
        f"{kstep['step_ms']:.3f} ms; images/s {eager['tokens_per_s']:.1f} / "
        f"{kstep['tokens_per_s']:.1f}")
    del prog_t, timed, opt_t, start
    return base, {"parameters": n, "macs_per_image": macs,
                  "flops_per_image_step": fpi, "eager": eager,
                  "kstep": kstep}


def resnet_serving(serving, model, seed, failures):
    """(c): ResNet-50 in eval mode behind a bf16 engine at buckets (1, 16,
    64) under concurrent requests, then sequential requests per bucket;
    the float32 engine against the CPU, bf16 against float32."""
    rng = np.random.RandomState(seed + 602)
    spec = [([None, 3, RESNET_SIZE, RESNET_SIZE], "float32")]
    rows = [1, 16, 64, 5, 9, 2]
    requests = [rng.rand(r, 3, RESNET_SIZE, RESNET_SIZE).astype("float32")
                for r in rows]
    with cudnn_mode(deterministic=False):
        burst, stats, latency, results, (graph, off) = serve(
            model, serving, requests, spec, (RESNET_CLASSES,),
            RESNET_BUCKETS, failures, batch_timeout_ms=2.0)
    replayed = {name: graph[name] + off[name] for name in graph}
    ok = not any(replayed.values())
    log(f"  (c) flash kernel nodes x replays of the captured graphs: "
        f"{replayed} (none expected) {'ok' if ok else 'FAIL'}")
    if not ok:
        failures.append(f"phase 11: ResNet-50's served graphs launch flash "
                        f"kernels {replayed}")
    log(f"  (c) engine stats after the burst: batches by bucket "
        f"{burst['batches_by_bucket']}, multi-request batches "
        f"{burst['multi_request_batches']}")
    out = {}
    for bucket in stats["bucket_ladder"]:
        n = stats["batches_by_bucket"][bucket]
        dev = stats["device_ms_by_bucket"][bucket] / max(n, 1)
        cp = stats["copy_ms_by_bucket"][bucket] / max(n, 1)
        best = min(latency[bucket])
        log(f"  (c) bucket {bucket}: request latency ms "
            f"{[round(t, 3) for t in latency[bucket]]}, {bucket / best * 1e3:.1f}"
            f" images/s at best; mean device step {dev:.3f} ms, mean host copy "
            f"of the [{bucket}, {RESNET_CLASSES}] logits {cp:.3f} ms over {n} "
            f"batches")
        out[bucket] = {"latency_ms": latency[bucket], "device_ms": dev,
                       "copy_ms": cp, "batches": n}
    with cudnn_mode(deterministic=True):
        with serving.Engine.from_layer(model, spec, bucket_ladder=(1,),
                                       device="cuda") as e32:
            (got32,) = e32.predict(requests[0])
    cpu = copy.deepcopy(model).to("cpu").eval()
    with torch.inference_mode():
        want = cpu(torch.from_numpy(requests[0])).numpy()
    del cpu
    rel_max = float(np.abs(got32 - want).max() / np.abs(want).max())
    ok = rel_max <= FP32_REL_MAX_TOL
    log(f"  (c) float32 engine (card) vs CPU eval forward: max|diff|/max|ref|"
        f" = {rel_max:.3e} (tol {FP32_REL_MAX_TOL:g}) {'ok' if ok else 'FAIL'}")
    if not ok:
        failures.append("phase 11: the float32 ResNet-50 engine disagrees "
                        "with the CPU")
    rel = float(np.linalg.norm(results[0] - got32) / np.linalg.norm(got32))
    ok = rel <= BF16_REL_L2_TOL
    log(f"  (c) bf16 served vs float32 logits: rel L2 {rel:.3e} (tol "
        f"{BF16_REL_L2_TOL:g}) {'ok' if ok else 'FAIL'}")
    if not ok:
        failures.append("phase 11: bf16 served ResNet-50 logits outside the "
                        "bf16 bound")
    return out


def lenet_card_vs_cpu(pt, seed, failures):
    """(b): LeNet on the synthetic MNIST, float32 steps card vs CPU."""
    from paddle_tpu_torch import optimizer
    from paddle_tpu_torch.vision import datasets
    from paddle_tpu_torch.vision.models import LeNet
    data = datasets.MNIST(mode="train")
    x = [torch.from_numpy(np.stack([data[i][0] for i in range(
        s * LENET_BATCH, (s + 1) * LENET_BATCH)])) for s in range(LENET_STEPS)]
    y = [torch.from_numpy(np.stack([data[i][1] for i in range(
        s * LENET_BATCH, (s + 1) * LENET_BATCH)])) for s in range(LENET_STEPS)]
    pt.seed(seed + 603)
    model = LeNet(device="cuda")
    losses = check_vision_f32(
        model, lambda m: optimizer.Momentum(learning_rate=LENET_LR,
                                            momentum=0.9,
                                            parameters=m.parameters()),
        x, y, f"(b) LeNet, {LENET_STEPS} float32 steps of {LENET_BATCH} "
        f"synthetic MNIST images", failures, steps=LENET_STEPS)
    return {"losses": losses}


def phase11(pt, fa, seed, failures):
    """Phase 11: convolutional networks. A part that raises is a failure
    and the next one still runs."""
    import traceback
    from paddle_tpu_torch import serving
    log(f"phase 11: ResNet-50 ({RESNET_CLASSES} classes, {RESNET_BATCH} x 3 "
        f"x {RESNET_SIZE} x {RESNET_SIZE}, run_all.py's recipe with "
        f"PaddleClas's L2Decay and Piecewise rate) trained and served, LeNet "
        f"trained")
    census = memory_census("the start of phase 11")
    out = {"memory_at_start_gb": [round(b / 1e9, 3) for b in census]}
    fa.reset_launch_counts()
    model = None
    t0 = time.perf_counter()
    try:
        model, out["resnet50"] = resnet_training(pt, fa, seed, failures)
    except Exception as e:  # noqa: BLE001 -- reported as a failure
        traceback.print_exc()
        failures.append(f"phase 11 (training) raised {type(e).__name__}: {e}")
    trained = flash_launches(fa)
    log(f"  -- training: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    fa.reset_launch_counts()
    try:
        if model is not None:
            out["serving"] = resnet_serving(serving, model, seed, failures)
    except Exception as e:  # noqa: BLE001 -- reported as a failure
        traceback.print_exc()
        failures.append(f"phase 11 (serving) raised {type(e).__name__}: {e}")
    served = flash_launches(fa)
    del model
    free_cuda()
    log(f"  -- serving: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    fa.reset_launch_counts()
    try:
        out["lenet"] = lenet_card_vs_cpu(pt, seed, failures)
    except Exception as e:  # noqa: BLE001 -- reported as a failure
        traceback.print_exc()
        failures.append(f"phase 11 (LeNet) raised {type(e).__name__}: {e}")
    lenet = flash_launches(fa)
    log(f"  -- LeNet: {time.perf_counter() - t0:.1f} s")
    for label, counts in (("ResNet-50 training", trained),
                          ("ResNet-50 serving", served), ("LeNet", lenet)):
        ok = not any(counts.values())
        log(f"  flash kernel launches, {label}: {counts} (none expected) "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            failures.append(f"phase 11: {label} launched flash kernels "
                            f"{counts}")
    out["flash_launches"] = {"resnet50_training": trained,
                             "resnet50_serving": served, "lenet": lenet}
    free_cuda()
    log(f"  {card_line()}")
    return out


# ---- phase 12: serving from saved artifacts ----------------------------------
#
# Tolerances, fixed before the phase's first run. (a) GPT-small's bf16
# artifact against the from_layer engine (the bf16 pass) on the same
# weights: both bf16 through 12 layers, the exported program's aten ops
# possibly decomposed otherwise, so within BF16_REL_L2_TOL (whether they
# are bitwise is printed); a bucket's graph replay against the same
# engine's eager forward of the same batch: the same kernels on the same
# inputs, bitwise; the fresh process's digest: the same program replayed
# at the same bucket on the same card, equal. (b) The float32 artifact
# against the CPU forward: FP32_REL_MAX_TOL, as phase 3. (c) BERT-base's
# NSP rows, all outputs against outputs=["output_1"]: the pruned graph
# runs the NSP head's kernels on the same inputs, bitwise. (d) ResNet-50's
# bf16 artifact against phase 11's from_layer engine (the bf16 pass) on the
# same weights: BF16_REL_L2_TOL.
ART_DIR = ".chip_smoke_artifacts"   # git-ignored, removed at the end

# A fresh process that serves an artifact with nothing of the model: it
# imports the inference API only and prints its logits' digest.
ART_CHILD = r"""
import hashlib, json, sys
import numpy as np
from paddle_tpu_torch import inference
prefix, ids_path = sys.argv[1], sys.argv[2]
cfg = inference.Config(prefix + ".pdmodel", prefix + ".pdiparams")
cfg.enable_use_gpu(100, 0)
cfg.enable_serving_engine(bucket_ladder=(1, 4))
with inference.create_predictor(cfg) as pred:
    pred.get_input_handle(pred.get_input_names()[0]).copy_from_cpu(
        np.load(ids_path))
    (out,) = pred.run()
print(json.dumps({
    "digest": hashlib.sha256(out.tobytes()).hexdigest(),
    "shape": list(out.shape), "dtype": str(out.dtype),
    "model_modules": sorted(n for n in sys.modules
                            if n.startswith("paddle_tpu_torch.models"))}))
"""


def art_path(name):
    import os
    return os.path.join(os.path.dirname(os.path.abspath(__file__)), ART_DIR,
                        name)


def save_artifact(jit, layer, name, spec):
    """``jit.save`` of ``layer`` under ART_DIR: (prefix, seconds, bytes of
    the .pdmodel and the .pdiparams)."""
    import os
    prefix = art_path(name)
    t0 = time.perf_counter()
    jit.save(layer, prefix, input_spec=spec)
    secs = time.perf_counter() - t0
    sizes = [os.path.getsize(prefix + s) for s in (".pdmodel", ".pdiparams")]
    log(f"  saved {name}: {secs:.2f} s, .pdmodel {sizes[0]} bytes, "
        f".pdiparams {sizes[1]} bytes")
    return prefix, secs, sizes


def load_engine(serving, prefix, **kw):
    """``Engine(prefix, ...)`` with its graphs kept (inspect_capture):
    (engine, seconds to load)."""
    t0 = time.perf_counter()
    with inspect_capture():
        engine = serving.Engine(prefix, device="cuda", **kw)
    return engine, time.perf_counter() - t0


def per_bucket(engine, batches, n=3):
    """``n`` sequential requests of each bucket's batch: latency ms and the
    mean device and host-copy ms of those batches (engine stats)."""
    out = {}
    for bucket, batch in batches.items():
        s0 = engine.stats()
        lat = sequential_ms(engine, batch, n)
        s1 = engine.stats()
        nb = s1["batches_by_bucket"][bucket] - s0["batches_by_bucket"][bucket]
        out[bucket] = {"latency_ms": lat, "device_ms": (
            s1["device_ms_by_bucket"][bucket]
            - s0["device_ms_by_bucket"][bucket]) / max(nb, 1),
            "copy_ms": (s1["copy_ms_by_bucket"][bucket]
                        - s0["copy_ms_by_bucket"][bucket]) / max(nb, 1)}
        log(f"    bucket {bucket}: request latency ms "
            f"{[round(t, 3) for t in lat]}, device {out[bucket]['device_ms']:.3f}"
            f" ms, host copy {out[bucket]['copy_ms']:.3f} ms")
    return out


def graph_vs_eager(engine, batches, order, label, failures):
    """Each bucket in ``order``: the graph's replay against the same
    engine's eager forward of the same batch (its measuring seam), bitwise;
    then the bucket-1 latency both ways. Returns the latencies."""
    for bucket in order:
        engine._graphs_on = True
        replayed = engine.predict(batches[bucket])
        engine._graphs_on = False
        eager = engine.predict(batches[bucket])
        engine._graphs_on = True
        same = all(np.array_equal(a, b) for a, b in zip(replayed, eager))
        log(f"  {label}: bucket {bucket} graph replay vs eager forward: "
            f"{'bitwise' if same else 'DIFFER'}")
        if not same:
            failures.append(f"phase 12 {label}: bucket {bucket}'s graph "
                            "replay is not bitwise the eager forward")
    one = batches[min(batches)]
    graph_ms = sequential_ms(engine, one, 5)
    engine._graphs_on = False
    eager_ms = sequential_ms(engine, one, 5)
    engine._graphs_on = True
    log(f"  {label}: bucket-1 request latency ms, graph "
        f"{[round(t, 3) for t in graph_ms]} vs eager "
        f"{[round(t, 3) for t in eager_ms]} (median {np.median(graph_ms):.3f} "
        f"vs {np.median(eager_ms):.3f})")
    return {"graph_ms": graph_ms, "eager_ms": eager_ms}


def engine_report(engine, label):
    """Capture time, memory_stats() and health() of a loaded engine."""
    stats = engine.stats()
    mem = engine.memory_stats()
    log(f"  {label}: capture ms by bucket "
        f"{ {b: round(v, 1) for b, v in stats['capture_ms'].items()} }, "
        f"warm-up ms { {b: round(v, 1) for b, v in stats['warmup_ms'].items()} }")
    for b, m in mem.items():
        log(f"    memory_stats bucket {b}: {m}")
    return {"capture_ms": stats["capture_ms"], "warmup_ms": stats["warmup_ms"],
            "memory_stats": mem}


def close_with_health(engine, label, failures):
    before = engine.health()
    engine.close()
    after = engine.health()
    log(f"  {label}: health before close {before['status']} "
        f"(ready {before['ready']}), after {after['status']}")
    if before["status"] != "ok" or after["status"] != "closed":
        failures.append(f"phase 12 {label}: health {before['status']} -> "
                        f"{after['status']}, want ok -> closed")
    return {"before": before["status"], "after": after["status"]}


def rel_l2(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def art_gpt(pt, fa, serving, seed, failures):
    """(a) and (b): GPT-small's bf16 and float32 artifacts."""
    import hashlib
    import os
    from paddle_tpu_torch import jit
    from paddle_tpu_torch.models.gpt import (GPTForCausalLM, gpt_small,
                                             synthetic_lm_batch)
    out = {}
    cfg = gpt_small(hidden_dropout=0.0, attention_dropout=0.0)
    pt.seed(seed + 1200)
    model = GPTForCausalLM(cfg, device="cuda").eval()
    spec = [jit.InputSpec([None, SEQ], "int32", "ids")]
    rows = [1, 3, 2, 2, 1]
    ids = synthetic_lm_batch(sum(rows), SEQ, cfg.vocab_size, seed=seed + 1201)
    offs = np.cumsum([0] + rows)
    requests = [ids[a:b] for a, b in zip(offs[:-1], offs[1:])]
    f32_prefix, out["f32_save_s"], _ = save_artifact(jit, model, "gpt_f32",
                                                     spec)
    cpu = copy.deepcopy(model).to("cpu")
    with torch.inference_mode():
        want32 = cpu(torch.from_numpy(ids[:1])).numpy()
    del cpu
    # phase 3's served path on the same weights: the bf16 pass
    with serving.Engine.from_layer(model, spec, bucket_ladder=(1, 4),
                                   passes=("bf16",), device="cuda") as ref:
        want16 = [o[0] for o in concurrent_requests(ref, requests)]
    model.to(torch.bfloat16)
    prefix, out["bf16_save_s"], out["bf16_bytes"] = save_artifact(
        jit, model, "gpt_bf16", spec)
    del model
    free_cuda()

    # (a) the bf16 artifact behind the engine
    fa.reset_launch_counts()
    engine, out["bf16_load_s"] = load_engine(serving, prefix,
                                             bucket_ladder=(1, 4),
                                             batch_timeout_ms=50.0)
    warm = flash_launches(fa)
    warm_bf16 = fa.flash_attention_fwd.variant_launches["bf16"]
    counter = count_replays(engine)
    batches = {1: ids[:1], 4: ids[:4]}
    # one run: it counts every replay of the burst and the timed requests
    got, timed = counter.run(lambda: (
        [o[0] for o in concurrent_requests(engine, requests)],
        per_bucket(engine, batches)))
    stats = engine.stats()
    graph, off = counter.launches()
    out["bf16_graph_launches"] = graph
    log(f"  (a) GPT-small bf16 artifact: loaded in {out['bf16_load_s']:.2f} s;"
        f" burst batches by bucket {stats['batches_by_bucket']}")
    want = {"flash_attention_fwd": cfg.num_layers * stats["batches"],
            "flash_attention_bwd_dq": 0, "flash_attention_bwd_dkv": 0}
    ok = (graph == want and not any(off.values())
          and warm["flash_attention_fwd"] == cfg.num_layers * 2 == warm_bf16
          and not warm["flash_attention_bwd_dq"]
          and not warm["flash_attention_bwd_dkv"])
    log(f"  (a) flash launches: {graph} from the graphs' kernel nodes x "
        f"replays over {stats['batches']} batches (want {want}), {off} on "
        f"the CUDA-core variant; eager warm-up {warm} ({warm_bf16} bf16) = "
        f"{graph['flash_attention_fwd'] / max(stats['batches'], 1):g} a "
        f"forward {'ok' if ok else 'FAIL'}")
    if not ok:
        failures.append(f"phase 12 (a): flash launches {graph} ({off} off "
                        f"the bf16 variant), warm-up {warm}; want {want}")
    rels = [rel_l2(g, w) for g, w in zip(got, want16)]
    bitwise = all(np.array_equal(g, w) for g, w in zip(got, want16))
    finite = all(np.isfinite(g).all() and g.shape == (r, SEQ, cfg.vocab_size)
                 for g, r in zip(got, rows))
    ok = finite and max(rels) <= BF16_REL_L2_TOL
    log(f"  (a) artifact logits vs the from_layer engine (bf16 pass, same "
        f"weights): rel L2 max {max(rels):.3e} (tol {BF16_REL_L2_TOL:g}), "
        f"bitwise {bitwise}, shapes and finiteness {'ok' if finite else 'FAIL'}"
        f" {'ok' if ok else 'FAIL'}")
    if not ok:
        failures.append("phase 12 (a): GPT-small's artifact disagrees with "
                        "the from_layer engine")
    out["vs_from_layer"] = {"rel_l2_max": max(rels), "bitwise": bitwise}
    out["bf16_buckets"] = timed
    out["bf16_graph_vs_eager"] = graph_vs_eager(engine, batches, (4, 1, 4),
                                                "(a)", failures)
    out["bf16_engine"] = engine_report(engine, "(a)")
    # a fresh process serves the same artifact at bucket 4
    ids_path = art_path("gpt_ids4.npy")
    np.save(ids_path, ids[:4])
    (parent,) = engine.predict(ids[:4])
    digest = hashlib.sha256(parent.tobytes()).hexdigest()
    out["bf16_health"] = close_with_health(engine, "(a)", failures)
    del engine
    free_cuda()
    t0 = time.perf_counter()
    res = subprocess.run(
        [sys.executable, "-c", ART_CHILD, prefix, ids_path],
        env=dict(os.environ, PYTHONPATH=os.path.dirname(
            os.path.abspath(__file__))), capture_output=True, text=True,
        timeout=600)
    child_s = time.perf_counter() - t0
    child = None
    if res.returncode == 0:
        child = json.loads(res.stdout.strip().splitlines()[-1])
    ok = child is not None and child["digest"] == digest \
        and not child["model_modules"]
    log(f"  (a) fresh process ({child_s:.1f} s): digest "
        f"{None if child is None else child['digest'][:16]} vs parent "
        f"{digest[:16]}, model modules imported "
        f"{None if child is None else child['model_modules']} "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        failures.append("phase 12 (a): the fresh process's logits differ "
                        f"(rc {res.returncode}: {res.stderr[-800:]})")
    out["fresh_process"] = {"seconds": child_s, "equal": ok}

    # (b) the float32 artifact: the CUDA-core forward
    fa.reset_launch_counts()
    engine, load_s = load_engine(serving, f32_prefix, bucket_ladder=(1,))
    counter = count_replays(engine)
    (got32,) = counter.run(lambda: engine.predict(ids[:1]))
    graph, off = counter.launches()
    n = engine.stats()["batches"]
    rel_max = float(np.abs(got32 - want32).max() / np.abs(want32).max())
    ok = (rel_max <= FP32_REL_MAX_TOL and not any(graph.values())
          and off == {"flash_attention_fwd": cfg.num_layers * n,
                      "flash_attention_bwd_dq": 0,
                      "flash_attention_bwd_dkv": 0})
    log(f"  (b) float32 artifact (loaded in {load_s:.2f} s) vs the CPU "
        f"forward: max|diff|/max|ref| {rel_max:.3e} (tol "
        f"{FP32_REL_MAX_TOL:g}); CUDA-core forward launches {off} over {n} "
        f"batches from the graph, bf16 {graph} {'ok' if ok else 'FAIL'}")
    if not ok:
        failures.append("phase 12 (b): the float32 artifact disagrees with "
                        "the CPU or left the CUDA-core forward")
    out["f32_launches"] = off
    out["f32_rel_max"] = rel_max
    engine.close()
    del engine
    free_cuda()
    # the same artifact, saved from the card, served on the CPU: the
    # devices baked into the program move with it
    on_cpu = jit.load(f32_prefix, device="cpu")(ids[:1]).numpy()
    rel_cpu = float(np.abs(on_cpu - want32).max() / np.abs(want32).max())
    ok = rel_cpu <= FP32_REL_MAX_TOL
    log(f"  (b) the float32 artifact saved on the card, served on the CPU "
        f"(jit.load(device='cpu')) vs the CPU forward: max|diff|/max|ref| "
        f"{rel_cpu:.3e}, bitwise {bool(np.array_equal(on_cpu, want32))} "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        failures.append("phase 12 (b): the float32 artifact served on the "
                        "CPU disagrees with the CPU forward")
    out["f32_on_cpu_rel_max"] = rel_cpu
    return out


def art_bert(pt, serving, seed, failures):
    """(c): BERT-base's bf16 artifact at bucket 16, all outputs and
    ``outputs=["output_1"]`` (NSP)."""
    from paddle_tpu_torch import jit
    from paddle_tpu_torch.models.bert import BertForPretraining, bert_base
    pt.seed(seed + 1210)
    cfg = bert_base(vocab_size=BERT_VOCAB, hidden_dropout=0.0,
                    attention_dropout=0.0)
    model = BertForPretraining(cfg, device="cuda").eval().to(torch.bfloat16)
    prefix, _, _ = save_artifact(
        jit, model, "bert_bf16",
        [jit.InputSpec([None, BERT_SEQ], "int32", "input_ids")])
    del model
    free_cuda()
    ids = np.random.RandomState(seed + 1211).randint(
        0, BERT_VOCAB, (BERT_BATCH, BERT_SEQ)).astype("int32")
    out, results = {}, {}
    for arm, kw in (("all outputs", {}),
                    ("NSP only", {"outputs": ["output_1"]})):
        engine, load_s = load_engine(serving, prefix,
                                     bucket_ladder=(BERT_BATCH,), **kw)
        nodes = len(graph_dot(engine._programs[BERT_BATCH].graph))
        log(f"  (c) BERT-base {arm}: outputs {engine.output_names}, loaded "
            f"in {load_s:.2f} s, {nodes} nodes in the bucket's graph")
        results[arm] = engine.predict(ids)
        out[arm] = {"outputs": engine.output_names, "graph_nodes": nodes,
                    "buckets": per_bucket(engine, {BERT_BATCH: ids}),
                    **engine_report(engine, f"(c) {arm}")}
        engine.close()
        del engine
        free_cuda()
    nsp_all, nsp_only = results["all outputs"][1], results["NSP only"][0]
    ok = (np.array_equal(nsp_all, nsp_only) and nsp_only.shape == (
        BERT_BATCH, 2) and results["all outputs"][0].shape == (
        BERT_BATCH, BERT_SEQ, BERT_VOCAB))
    log(f"  (c) NSP rows, all outputs vs NSP only: "
        f"{'bitwise' if ok else 'DIFFER'}")
    if not ok:
        failures.append("phase 12 (c): BERT-base's NSP-only rows differ from "
                        "the full-output engine's")
    return out


def art_resnet(pt, fa, serving, seed, failures):
    """(d): ResNet-50's bf16 artifact at buckets 1, 16, 64 against phase
    11's from_layer engine on the same weights."""
    from paddle_tpu_torch import jit, nn
    from paddle_tpu_torch.vision.models import resnet50

    class Bf16Input(nn.Layer):
        """The bf16 network behind a float32 feed (numpy has no bf16)."""

        def __init__(self, inner):
            super().__init__()
            self.inner = inner

        def forward(self, x):
            return self.inner(x.to(torch.bfloat16))

    pt.seed(seed + 1220)
    model = resnet50(num_classes=RESNET_CLASSES, device="cuda").eval()
    rng = np.random.RandomState(seed + 1221)
    rows = [1, 16, 64, 5]
    requests = [rng.rand(r, 3, RESNET_SIZE, RESNET_SIZE).astype("float32")
                for r in rows]
    spec = [jit.InputSpec([None, 3, RESNET_SIZE, RESNET_SIZE], "float32",
                          "image")]
    out = {}
    with cudnn_mode(deterministic=False):
        with serving.Engine.from_layer(model, spec,
                                       bucket_ladder=RESNET_BUCKETS,
                                       passes=("bf16",), device="cuda",
                                       batch_timeout_ms=2.0) as ref:
            want = [o[0] for o in concurrent_requests(ref, requests)]
        prefix, _, _ = save_artifact(jit, Bf16Input(model.to(torch.bfloat16)),
                                     "resnet50_bf16", spec)
        del model
        free_cuda()
        fa.reset_launch_counts()
        engine, load_s = load_engine(serving, prefix,
                                     bucket_ladder=RESNET_BUCKETS,
                                     batch_timeout_ms=2.0)
        counter = count_replays(engine)
        batches = {b: requests[2][:b] for b in RESNET_BUCKETS}
        got, out["buckets"] = counter.run(lambda: (
            [o[0] for o in concurrent_requests(engine, requests)],
            per_bucket(engine, batches)))
        graph, off = counter.launches()
        out["graph_vs_eager"] = graph_vs_eager(engine, batches, (16, 1, 64),
                                               "(d)", failures)
        out.update(engine_report(engine, "(d)"))
        out["health"] = close_with_health(engine, "(d)", failures)
        del engine
    rels = [rel_l2(g, w) for g, w in zip(got, want)]
    wrappers = flash_launches(fa)
    ok = (max(rels) <= BF16_REL_L2_TOL and not any(graph.values())
          and not any(off.values()) and not any(wrappers.values()))
    log(f"  (d) ResNet-50 bf16 artifact (loaded in {load_s:.2f} s) vs the "
        f"from_layer engine (bf16 pass): rel L2 max {max(rels):.3e} (tol "
        f"{BF16_REL_L2_TOL:g}); flash launches {wrappers} (wrappers) and "
        f"{graph}, {off} (graphs), none expected {'ok' if ok else 'FAIL'}")
    if not ok:
        failures.append("phase 12 (d): ResNet-50's artifact disagrees with "
                        "the from_layer engine or launched flash kernels")
    out["rel_l2_max"] = max(rels)
    free_cuda()
    return out


def check_realigned(fa, failures, gen):
    """The forward operator on bf16 q/k/v whose base is 2 bytes off 16
    (TMA cannot load them; the exported program cannot re-route): each is
    copied to fresh storage, counted in ``realigned``, and the kernel runs,
    within TOL[bf16] of the plain version on the same values."""
    b, h, d = 2, 12, 64
    n = b * SEQ * h * d
    flat = torch.randn(3 * n + 8, device="cuda", generator=gen).to(
        torch.bfloat16)
    q, k, v = (flat[1 + i * n:1 + (i + 1) * n].view(b, SEQ, h, d)
               for i in range(3))
    fa.reset_launch_counts()
    o, lse = fa.flash_attention_fwd(q, k, v, causal=True)
    counts = (fa.flash_attention_fwd.launches,
              fa.flash_attention_fwd.variant_launches["bf16"],
              fa.flash_attention_fwd.realigned)
    ro, rl = fa.flash_attention_fwd_reference(q, k, v, True)
    tol = TOL[torch.bfloat16]
    err = float((o.float() - ro.float()).abs().max())
    ok = (counts == (1, 1, 3) and torch.allclose(
        o.float(), ro.float(), atol=tol["o_atol"], rtol=tol["o_rtol"])
        and float((lse - rl).abs().max()) <= tol["lse_atol"])
    log(f"  misaligned bf16 q/k/v: launches, bf16 launches, inputs copied "
        f"{counts} (want (1, 1, 3)); max |O - plain| {err:.3e} "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        failures.append(f"phase 12: the misaligned forward {counts}, "
                        f"max |O - plain| {err:.3e}")


def phase12(pt, fa, seed, failures):
    """Phase 12: serving from saved artifacts (``jit.save`` ->
    ``serving.Engine(path)``, one CUDA graph a bucket). A part that raises
    is a failure and the next one still runs. Returns the numbers and the
    flash launches of the artifact paths."""
    import shutil
    import traceback
    from paddle_tpu_torch import serving
    log("phase 12: serving from saved artifacts (jit.save -> Engine(path), "
        "one CUDA graph a bucket)")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed + 1230)
    check_realigned(fa, failures, gen)
    out = {}
    for key, part in (("gpt_small", lambda: art_gpt(pt, fa, serving, seed,
                                                    failures)),
                      ("bert_base", lambda: art_bert(pt, serving, seed,
                                                     failures)),
                      ("resnet50", lambda: art_resnet(pt, fa, serving, seed,
                                                      failures))):
        t0 = time.perf_counter()
        try:
            out[key] = part()
        except Exception as e:  # noqa: BLE001 -- reported as a failure
            traceback.print_exc()
            failures.append(f"phase 12 ({key}) raised {type(e).__name__}: "
                            f"{e}")
        log(f"  -- {key}: {time.perf_counter() - t0:.1f} s")
        free_cuda()
    shutil.rmtree(art_path(""), ignore_errors=True)
    gpt = out.get("gpt_small", {})
    launches = {
        "artifact_gpt_small_bf16_graphs": gpt.get("bf16_graph_launches"),
        "artifact_gpt_small_float32_graphs": gpt.get("f32_launches")}
    log(f"  {card_line()}")
    return out, launches


# ---- phase 13: YOLOv3 detection (BASELINE.md config 5) ----------------------
#
# benchmarks/run_all.py:255-330's accelerator recipe, nothing cut: a
# resnet18(num_classes=0, with_pool=False) trunk and a Conv2D(512, 3 x 85, 1)
# head, Momentum(0.01, 0.9) over backbone.parameters() + head.parameters(),
# bf16 auto_cast, yolov3_loss(ignore_thresh=0.7, downsample_ratio=32).mean(),
# batch 8 at 320, 416 and 512 (one warm-up a size, then 4 x (320, 416, 512)
# in that order), 80 classes, ragged boxes padded to 50, images and boxes
# made from the seed as bench_detection makes them. Served: the trained
# trunk and head with yolo_box (conf_thresh 0.01) at 416, buckets 1 and 8,
# then the host's multiclass_nms with PaddleDetection YOLOv3's eval settings.
DET_SIZES, DET_BATCH, DET_ITERS = (320, 416, 512), 8, 4
DET_CLASSES, DET_BOXES = 80, 50
DET_ANCHORS, DET_MASK = [116, 90, 156, 198, 373, 326], [0, 1, 2]
DET_IGNORE, DET_DOWNSAMPLE, DET_LR, DET_MOMENTUM = 0.7, 32, 0.01, 0.9
DET_SERVE_SIZE, DET_BUCKETS, DET_CONF = 416, (1, 8), 0.01
DET_NMS = dict(score_threshold=0.01, nms_top_k=1000, keep_top_k=100,
               nms_threshold=0.45, background_label=-1)
# Phase 13's tolerances, fixed before its first run.
# (a) yolov3_loss in float32 at [8, 255, 13, 13], card against CPU: the
# same ops, float32 sums in another order (a per-image loss sums ~5e4
# terms): the loss within DET_LOSS_REL_TOL (max over images, relative), the
# gradient with respect to x within DET_GRAD_REL_L2_TOL (relative L2).
# bf16 under auto_cast against float32 from the same input: the
# predictions rounded to bf16 (2^-8): DET_AMP_LOSS_REL_TOL. yolo_box's
# boxes and scores and box_coder's decode, card against CPU: float32
# elementwise math (exp, sigmoid to a few ulp): DET_OP_REL_MAX_TOL of the
# largest value.
DET_LOSS_REL_TOL = 1e-5
DET_GRAD_REL_L2_TOL = 1e-4
DET_AMP_LOSS_REL_TOL = 2e-2
DET_OP_REL_MAX_TOL = 1e-5
# (b) the captured steps against the same eager steps from the same
# weights: the same kernels on the same inputs under deterministic cuDNN
# and torch.use_deterministic_algorithms (the loss gather's backward, an
# accumulating index_put, sorts instead of adding atomically: boxes that
# share a cell would otherwise sum in any order): KSTEP_MAX_ABS_TOL (0).
# (c) the float32 engine's decoded boxes and scores against the same layer
# on the CPU (TF32 off): FP32_REL_MAX_TOL of the largest value, as phase 3.
DET_KINDS = VISION_KINDS[:-1] + [
    ("gather, scatter, index (the loss)", ("index", "scatter", "gather")),
    VISION_KINDS[-1]]


def det_batches(seed):
    """{size: (images, boxes, labels)} on the card, drawn as
    bench_detection draws them (one RandomState in size order)."""
    rng = np.random.RandomState(seed)
    out = {}
    for size in DET_SIZES:
        img = rng.rand(DET_BATCH, 3, size, size).astype("float32")
        gtb = np.zeros((DET_BATCH, DET_BOXES, 4), np.float32)
        for i in range(DET_BATCH):
            k = rng.randint(1, 20)
            cxy = rng.rand(k, 2) * 0.8 + 0.1
            wh = rng.rand(k, 2) * 0.2 + 0.05
            gtb[i, :k] = np.concatenate([cxy, wh], 1)
        gtl = rng.randint(0, DET_CLASSES, (DET_BATCH, DET_BOXES))
        out[size] = tuple(torch.from_numpy(a).to("cuda") for a in
                          (img, gtb, gtl.astype("int64")))
    return out


def det_order():
    """The warm-ups (one a size), then 4 x (320, 416, 512)."""
    return list(DET_SIZES) + [DET_SIZES[i % len(DET_SIZES)]
                              for i in range(DET_ITERS * len(DET_SIZES))]


def det_model(pt, seed):
    from paddle_tpu_torch import nn
    from paddle_tpu_torch.vision.models import resnet18
    pt.seed(seed)
    backbone = resnet18(num_classes=0, with_pool=False, device="cuda")
    head = nn.Conv2D(512, len(DET_MASK) * (5 + DET_CLASSES), 1,
                     device="cuda")
    return backbone, head


def det_step(backbone, head):
    """run_all.py's train_step and its optimizer: Momentum over
    ``backbone.parameters() + head.parameters()`` (the lists of the
    reference's Layer)."""
    from paddle_tpu_torch import amp, optimizer
    from paddle_tpu_torch.vision.ops import yolov3_loss
    params = backbone.parameters() + head.parameters()
    opt = optimizer.Momentum(parameters=params, learning_rate=DET_LR,
                             momentum=DET_MOMENTUM)

    def train_step(img, gtb, gtl):
        with amp.auto_cast(enable=True, dtype="bfloat16"):
            pred = head(backbone(img))
            loss = yolov3_loss(pred, gtb, gtl, DET_ANCHORS, DET_MASK,
                               DET_CLASSES, ignore_thresh=DET_IGNORE,
                               downsample_ratio=DET_DOWNSAMPLE).mean()
        loss.backward()
        opt.step()
        opt.clear_grad()
        return loss
    return train_step, opt


class deterministic_algorithms:
    """``torch.use_deterministic_algorithms`` (and cuDNN's deterministic
    mode) within the block."""

    def __enter__(self):
        import os
        self.saved = (torch.are_deterministic_algorithms_enabled(),
                      os.environ.get("CUBLAS_WORKSPACE_CONFIG"))
        os.environ["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"
        torch.use_deterministic_algorithms(True)
        self.cudnn = cudnn_mode(deterministic=True)
        self.cudnn.__enter__()

    def __exit__(self, *exc):
        import os
        self.cudnn.__exit__(*exc)
        torch.use_deterministic_algorithms(self.saved[0])
        if self.saved[1] is None:
            os.environ.pop("CUBLAS_WORKSPACE_CONFIG", None)
        else:
            os.environ["CUBLAS_WORKSPACE_CONFIG"] = self.saved[1]
        return False


def det_ops(failures, seed):
    """(a): the detection ops, card against CPU."""
    from paddle_tpu_torch import amp
    from paddle_tpu_torch.vision import ops
    rng = np.random.RandomState(seed + 1300)
    hw = DET_SERVE_SIZE // DET_DOWNSAMPLE
    x = rng.randn(DET_BATCH, len(DET_MASK) * (5 + DET_CLASSES), hw,
                  hw).astype(np.float32)
    gtb, gtl = (t.cpu() for t in det_batches(seed)[DET_SERVE_SIZE][1:])
    args = (DET_ANCHORS, DET_MASK, DET_CLASSES, DET_IGNORE, DET_DOWNSAMPLE)
    out = {}

    def loss_and_grad(device, dtype=torch.float32, autocast=False):
        xt = torch.from_numpy(x).to(device, dtype).requires_grad_(True)
        with amp.auto_cast(enable=autocast, dtype="bfloat16"):
            loss = ops.yolov3_loss(xt, gtb.to(device), gtl.to(device), *args)
        loss.sum().backward()
        return loss.detach().float().cpu().numpy(), xt.grad.float().cpu()

    card, card_g = loss_and_grad("cuda")
    cpu, cpu_g = loss_and_grad("cpu")
    rel = float(np.max(np.abs(card - cpu) / np.abs(cpu)))
    grel = rel_l2(card_g, cpu_g)
    ok = rel <= DET_LOSS_REL_TOL and grel <= DET_GRAD_REL_L2_TOL
    log(f"  (a) yolov3_loss float32 [{DET_BATCH}, {x.shape[1]}, {hw}, {hw}],"
        f" {DET_BOXES} boxes, {DET_CLASSES} classes, card vs CPU: loss rel "
        f"{rel:.3e} (tol {DET_LOSS_REL_TOL:g}), d/dx rel L2 {grel:.3e} (tol "
        f"{DET_GRAD_REL_L2_TOL:g}) {'ok' if ok else 'FAIL'}")
    if not ok:
        failures.append("phase 13: yolov3_loss on the card disagrees with "
                        "the CPU")
    # a bf16 head's output under auto_cast, as config 5 feeds the loss
    bf16, _ = loss_and_grad("cuda", torch.bfloat16, autocast=True)
    arel = float(np.max(np.abs(bf16 - card) / np.abs(card)))
    ok = arel <= DET_AMP_LOSS_REL_TOL
    log(f"  (a) yolov3_loss of a bf16 input under bf16 auto_cast vs "
        f"float32: rel {arel:.3e} (tol {DET_AMP_LOSS_REL_TOL:g}) "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        failures.append("phase 13: bf16 yolov3_loss outside its bound")
    xc = torch.from_numpy(x).cuda()
    ms = cuda_time_ms(lambda: ops.yolov3_loss(
        xc.requires_grad_(True), gtb.cuda(), gtl.cuda(), *args).sum()
        .backward(), 20)
    log(f"  (a) yolov3_loss forward + backward on the card: {ms:.4f} ms "
        f"(CUDA events)")
    out.update(loss_rel=rel, grad_rel_l2=grel, amp_rel=arel,
               fwd_bwd_ms=ms)

    img = torch.tensor([[416, 416], [320, 480]] * (DET_BATCH // 2),
                       dtype=torch.int32)
    (cb, cs), (hb, hs) = (ops.yolo_box(torch.from_numpy(x).to(d),
                                       img.to(d), DET_ANCHORS, DET_CLASSES,
                                       DET_CONF, DET_DOWNSAMPLE)
                          for d in ("cuda", "cpu"))
    prior = torch.from_numpy(np.sort(rng.rand(64, 4).astype(np.float32),
                                     axis=1))
    deltas = torch.from_numpy(rng.randn(16, 64, 4).astype(np.float32) * 0.5)
    var = torch.full((64, 4), 0.1)
    cd, hd = (ops.box_coder(prior.to(d), var.to(d), deltas.to(d),
                            "decode_center_size") for d in ("cuda", "cpu"))
    for label, got, want in (("yolo_box boxes", cb, hb),
                             ("yolo_box scores", cs, hs),
                             ("box_coder decode", cd, hd)):
        err = float((got.cpu() - want).abs().max() / want.abs().max())
        ok = err <= DET_OP_REL_MAX_TOL
        log(f"  (a) {label} card vs CPU: max|diff|/max|ref| {err:.3e} (tol "
            f"{DET_OP_REL_MAX_TOL:g}) {'ok' if ok else 'FAIL'}")
        if not ok:
            failures.append(f"phase 13: {label} disagrees with the CPU")
        out[label.replace(" ", "_") + "_rel"] = err
    return out


def det_macs(backbone, head, size):
    """Multiply-adds of one image's forward at ``size`` from the layer
    shapes (phase 11's ``layer_macs`` on a CPU copy)."""
    from paddle_tpu_torch import nn
    model = nn.Sequential(copy.deepcopy(backbone).to("cpu"),
                          copy.deepcopy(head).to("cpu"))
    return layer_macs(model, size)[0]


def det_training(pt, fa, seed, failures):
    """(b): config 5 trained eagerly and through one CUDA graph a size."""
    from paddle_tpu_torch import jit
    base_bb, base_head = det_model(pt, seed + 1310)
    n = sum(p.numel() for p in base_bb.parameters() + base_head.parameters())
    macs = {s: det_macs(base_bb, base_head, s) for s in DET_SIZES}
    fpi = {s: 3 * 2 * m for s, m in macs.items()}
    log(f"  (b) model: {n} parameters; multiply-adds an image forward "
        f"{macs}; a training step 3 x 2 x MACs an image")
    data = det_batches(seed)
    order = det_order()
    out = {"parameters": n, "macs_per_image": macs}

    def twin():
        return copy.deepcopy(base_bb), copy.deepcopy(base_head)

    # the captured steps against the same eager steps, bitwise
    (bb_e, hd_e), (bb_g, hd_g) = twin(), twin()
    fa.reset_launch_counts()
    with deterministic_algorithms():
        step_e, opt_e = det_step(bb_e, hd_e)
        want = [step_e(*data[s]).detach() for s in order]
        step_g, opt_g = det_step(bb_g, hd_g)
        prog = jit.to_static(step_g)
        with inspect_capture():
            got = [prog(*data[s]) for s in order[:len(DET_SIZES)]]
        counter = count_replays(prog)
        got += counter.run(lambda: [prog(*data[s])
                                    for s in order[len(DET_SIZES):]])
    eager_launches = flash_launches(fa)
    nodes, off = counter.launches()
    compiles = len(prog._programs)
    ok = compiles == len(DET_SIZES)
    log(f"  (b) captured programs (compiles): {compiles}, one a size (want "
        f"{len(DET_SIZES)}) {'ok' if ok else 'FAIL'}")
    if not ok:
        failures.append(f"phase 13: {compiles} captured programs, want "
                        f"{len(DET_SIZES)}")
    want_l, got_l = torch.stack(want), torch.stack(got)
    compare_runs("(b) config 5, graphs vs eager", want_l, got_l,
                 torch.nn.ModuleList([bb_e, hd_e]),
                 torch.nn.ModuleList([bb_g, hd_g]), failures, opt_e, opt_g)
    losses = [float(v) for v in want_l]
    log(f"  (b) losses in order {order}: {[round(v, 4) for v in losses]}")
    if not all(np.isfinite(losses)):
        failures.append(f"phase 13: losses not finite: {losses}")
    out.update(compiles=compiles, losses=losses)
    del bb_e, hd_e, bb_g, hd_g, prog, step_e, step_g, opt_e, opt_g, counter

    # timed: eager and graphs over the mixed traffic, autotuned cuDNN
    with cudnn_mode(deterministic=False):
        for arm in ("eager", "graphs"):
            bb, hd = twin()
            step, _ = det_step(bb, hd)
            run = step if arm == "eager" else jit.to_static(step)
            torch.cuda.synchronize()
            before = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            first_ms = {}
            for s in DET_SIZES:  # warm-up: autotune, capture
                t0 = time.perf_counter()
                run(*data[s]).item()
                first_ms[s] = (time.perf_counter() - t0) * 1e3
            peak = (torch.cuda.max_memory_allocated() - before) / 1e9
            timed = order[len(DET_SIZES):]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for s in timed:
                loss = run(*data[s])
            loss.item()
            wall = time.perf_counter() - t0
            images = DET_BATCH * len(timed)
            flop = sum(fpi[s] * DET_BATCH for s in timed)
            per_size = {}
            for s in DET_SIZES:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(3):
                    loss = run(*data[s])
                loss.item()
                per_size[s] = (time.perf_counter() - t0) / 3 * 1e3
            prof = report_profile(
                f"(b) config 5 {arm} step at {DET_SERVE_SIZE}", profile_retry(
                    lambda: run(*data[DET_SERVE_SIZE]).item()), failures,
                kinds=DET_KINDS)
            no_flash_in_trace(f"(b) profiled {arm} step", prof, failures)
            rate = {"images_per_s": images / wall,
                    "mfu": flop / wall / PEAK_FLOPS[torch.bfloat16],
                    "ms_by_size": per_size, "first_call_ms": first_ms,
                    "working_set_gb": peak,
                    "idle_share": None if prof is None else prof["idle"],
                    "by_kind_ms": None if prof is None else
                    prof["by_kind_ms"]}
            if arm == "graphs":
                rate["compiles"] = len(run._programs)
            log(f"  (b) {arm}: {rate['images_per_s']:.1f} images/s over "
                f"{len(timed)} steps of mixed sizes, MFU {rate['mfu']:.4f} "
                f"(3 x 2 x layer MACs, {PEAK_FLOPS[torch.bfloat16]:g} FLOP/s"
                f"); ms a step by size {{"
                + ", ".join(f"{s}: {ms:.3f}" for s, ms in per_size.items())
                + f"}}; first call by size (autotune"
                f"{', capture' if arm == 'graphs' else ''}) {{"
                + ", ".join(f"{s}: {ms:.1f}" for s, ms in first_ms.items())
                + f"}} ms; working set {peak:.3f} GB; {card_line()}")
            out[arm] = rate
            del bb, hd, step, run
    graphs_launches = flash_launches(fa)
    out["flash"] = {"eager_wrappers": eager_launches,
                    "graph_nodes_x_replays": nodes, "off_variant": off,
                    "timed_wrappers": graphs_launches}
    return base_bb, base_head, out


def detector(backbone, head):
    """The served detector in eval mode: the trunk, the head and
    yolo_box, returning the boxes [N, M, 4] and the scores [N, M,
    classes]."""
    from paddle_tpu_torch import nn
    from paddle_tpu_torch.vision.ops import yolo_box

    class Detector(nn.Layer):
        def __init__(self):
            super().__init__()
            self.backbone, self.head = backbone, head

        def forward(self, img, im_size):
            return yolo_box(self.head(self.backbone(img)), im_size,
                            DET_ANCHORS, DET_CLASSES, DET_CONF,
                            DET_DOWNSAMPLE)

    return Detector().eval()


def det_serving(serving, backbone, head, seed, failures):
    """(c): the trained detector served at 416, buckets 1 and 8, float32,
    NMS on the host; the engine's boxes and scores against the CPU."""
    from paddle_tpu_torch.vision.ops import multiclass_nms
    det = detector(backbone, head)
    rng = np.random.RandomState(seed + 1320)
    s = DET_SERVE_SIZE
    spec = [([None, 3, s, s], "float32"), ([None, 2], "int32")]
    with cudnn_mode(deterministic=True), inspect_capture():
        engine = serving.Engine.from_layer(det, spec,
                                           bucket_ladder=DET_BUCKETS,
                                           device="cuda")
    counter = count_replays(engine)
    out = {}
    try:
        def request(rows):
            return (rng.rand(rows, 3, s, s).astype("float32"),
                    np.tile(np.array([[s, s]], np.int32), (rows, 1)))

        first = request(1)

        def traffic():
            res = {}
            for bucket in DET_BUCKETS:
                lat, nms_ms, kept = [], [], []
                for i in range(4):
                    req = first if (bucket == 1 and i == 0) else \
                        request(bucket)
                    t0 = time.perf_counter()
                    boxes, scores = engine.predict(*req)
                    t1 = time.perf_counter()
                    dets, counts = multiclass_nms(
                        torch.from_numpy(boxes),
                        torch.from_numpy(scores).transpose(1, 2), **DET_NMS)
                    t2 = time.perf_counter()
                    lat.append((t2 - t0) * 1e3)
                    nms_ms.append((t2 - t1) * 1e3)
                    kept.append(counts.tolist())
                    if bucket == 1 and i == 0:
                        res["first"] = (boxes, scores)
                res[bucket] = (lat, nms_ms, kept)
            return res

        with cudnn_mode(deterministic=True):
            res = counter.run(traffic)
        stats = engine.stats()
        for bucket in DET_BUCKETS:
            lat, nms_ms, kept = res[bucket]
            n = stats["batches_by_bucket"][bucket]
            dev = stats["device_ms_by_bucket"][bucket] / max(n, 1)
            cp = stats["copy_ms_by_bucket"][bucket] / max(n, 1)
            log(f"  (c) bucket {bucket}: request latency ms (engine + host "
                f"NMS) {[round(t, 3) for t in lat]}; host multiclass_nms ms "
                f"{[round(t, 3) for t in nms_ms]}; mean device step "
                f"{dev:.3f} ms, host copy {cp:.3f} ms over {n} batches; "
                f"detections kept per image {kept[0][:8]}")
            out[bucket] = {"latency_ms": lat, "nms_ms": nms_ms,
                           "device_ms": dev, "copy_ms": cp, "batches": n}
        out["capture_ms"] = stats["capture_ms"]
    finally:
        engine.close()
    nodes, off = counter.launches()
    cpu = detector(copy.deepcopy(backbone).to("cpu"),
                   copy.deepcopy(head).to("cpu"))
    with torch.inference_mode():
        want = [t.numpy() for t in cpu(*(torch.from_numpy(a)
                                          for a in first))]
    for label, got, ref in zip(("boxes", "scores"), res["first"], want):
        err = float(np.abs(got - ref).max() / np.abs(ref).max())
        ok = err <= FP32_REL_MAX_TOL
        log(f"  (c) float32 engine {label} vs the CPU layer: max|diff|/"
            f"max|ref| {err:.3e} (tol {FP32_REL_MAX_TOL:g}) "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            failures.append(f"phase 13: served {label} disagree with the CPU")
        out[f"{label}_rel_max"] = err
    out["flash_graph_nodes_x_replays"] = {k: nodes[k] + off[k] for k in nodes}
    return out


def phase13(pt, fa, seed, failures):
    """Phase 13: YOLOv3 detection, BASELINE.md config 5. A part that raises
    is a failure and the next one still runs."""
    import traceback
    from paddle_tpu_torch import serving
    log(f"phase 13: YOLOv3 detection (config 5): resnet18 trunk + "
        f"Conv2D(512, {len(DET_MASK) * (5 + DET_CLASSES)}, 1), batch "
        f"{DET_BATCH} at {DET_SIZES}, {DET_BOXES} boxes, {DET_CLASSES} "
        f"classes, bf16 AMP, Momentum; served at {DET_SERVE_SIZE}")
    t_phase = time.perf_counter()
    census = memory_census("the start of phase 13")
    out = {"memory_at_start_gb": [round(b / 1e9, 3) for b in census]}
    fa.reset_launch_counts()
    bb = hd = None
    for key, part in (("ops", lambda: det_ops(failures, seed)),
                      ("training", lambda: det_training(pt, fa, seed,
                                                        failures)),
                      ("serving", lambda: det_serving(serving, bb, hd, seed,
                                                      failures))):
        if key == "serving" and bb is None:
            continue
        t0 = time.perf_counter()
        try:
            res = part()
            if key == "training":
                bb, hd, res = res
            out[key] = res
        except Exception as e:  # noqa: BLE001 -- reported as a failure
            traceback.print_exc()
            failures.append(f"phase 13 ({key}) raised {type(e).__name__}: "
                            f"{e}")
        log(f"  -- {key}: {time.perf_counter() - t0:.1f} s")
    counts = flash_launches(fa)
    flash = out.get("training", {}).get("flash", {})
    graphs = flash.get("graph_nodes_x_replays", {})
    served = out.get("serving", {}).get("flash_graph_nodes_x_replays", {})
    total = {k: counts[k] + graphs.get(k, 0) + served.get(k, 0)
             for k in counts}
    ok = not any(total.values())
    log(f"  flash kernel launches on the detection path: wrappers {counts}, "
        f"graph nodes x replays {graphs} (training) {served} (serving): "
        f"{total} (none expected) {'ok' if ok else 'FAIL'}")
    if not ok:
        failures.append(f"phase 13: the detection path launched flash "
                        f"kernels {total}")
    out["flash_launches"] = {"detection": total}
    del bb, hd
    free_cuda()
    out["seconds"] = time.perf_counter() - t_phase
    log(f"  phase 13: {out['seconds']:.1f} s; {card_line()}")
    return out


# ---- phase 14: the imperative surface ---------------------------------------

# float32 card vs CPU in (a) and (c): the same ops, cuDNN and ATen on the
# card, in another order (and, in the gradients of the gathers, atomics):
# the max |card - CPU| over the max |CPU| of each output, fixed before any
# run.
SURFACE_FWD_TOL = 1e-5
SURFACE_GRAD_TOL = 1e-4
# A batch whose samples are independent (each sample's output and its
# gradients depend on that sample alone) is rerun on the CPU for its first
# samples only.
SURFACE_CPU_SAMPLES = 4
# (d): bench_ctr's accelerator sizes (benchmarks/run_all.py:419).
CTR_VOCAB, CTR_DIM, CTR_SLOTS, CTR_BATCH = 2_000_000, 64, 16, 1024
CTR_HIDDEN = (512, 256)
CTR_STEPS, CTR_TIMED, CTR_WARMUP = 8, 10, 2
CTR_SGD_LR, CTR_ADAM_LR = 0.05, 1e-3
# sparse against dense SGD over CTR_STEPS steps from one table: the
# touched rows' updates differ by the order in which the cotangents of
# equal ids are summed (float32) and what that moves downstream: the L2
# of the two updates' difference over the L2 of the dense update.
CTR_SPARSE_DENSE_TOL = 1e-4
SURFACE_TIMED = (3, 10)  # (b): 3 alternations of 10 steps an arm


def max_rel(card, cpu):
    """max |card - cpu| / max |cpu| (float32, on the CPU)."""
    a, b = card.detach().float().cpu(), cpu.detach().float().cpu()
    return float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)


def check_card_vs_cpu(label, card, cpu, tol, failures):
    worst = max((max_rel(a, b), i) for i, (a, b) in enumerate(zip(card, cpu)))
    ok = worst[0] <= tol
    log(f"  {label}: card vs CPU max rel {worst[0]:.3e} (output {worst[1]}"
        f", tol {tol:g}) {'ok' if ok else 'FAIL'}")
    if not ok:
        failures.append(f"phase 14: {label} disagrees with the CPU "
                        f"({worst[0]:.3e} > {tol:g})")
    return worst[0]


def seeded(gen, shape, lo=None, hi=None):
    """float32 on the CPU from ``gen``: normal, or uniform in [lo, hi)."""
    if lo is None:
        return torch.randn(shape, generator=gen)
    return lo + (hi - lo) * torch.rand(shape, generator=gen)


def outputs_and_grads(fn, inputs, cot):
    """fn's output and the gradients of sum(out * cot) with respect to
    every input that requires grad."""
    out = fn(*inputs)
    wrt = [x for x in inputs if isinstance(x, torch.Tensor)
           and x.requires_grad]
    grads = torch.autograd.grad((out * cot).sum(), wrt)
    return [out, *grads]


def boundary_free_grid(gen, n, h, w, height, width, align_corners):
    """A normalized sampling grid [n, h, w, (x, y)] whose pixel
    coordinates (some outside the input, for the padding modes) keep 0.05
    pixel from every integer and half-integer, where bilinear weights
    switch corners and nearest rounding switches pixels: there the card's
    and the CPU's rounding of the same coordinate may pick differently."""
    def coords(size, shape):
        whole = torch.randint(-3, size + 2, shape, generator=gen).float()
        frac = 0.05 + 0.4 * torch.rand(shape, generator=gen)
        frac = frac + 0.5 * (torch.rand(shape, generator=gen) < 0.5)
        pix = whole + frac
        if align_corners:
            return pix / (size - 1) * 2 - 1
        return (2 * pix + 1) / size - 1
    return torch.stack([coords(width, (n, h, w)), coords(height, (n, h, w))],
                       dim=-1)


def surface_vision(pt, seed, failures):
    """(a): the vision functionals on the card at their users' shapes,
    against the CPU, float32: each output and the gradients of sum(out *
    c) for a seeded c with respect to every input."""
    F = pt.nn.functional
    gen = torch.Generator().manual_seed(seed + 1401)
    n, c, h, w = 64, 64, 56, 56  # a spatial transformer's feature map
    eye = torch.tensor([[1.0, 0, 0], [0, 1.0, 0]]).expand(n, 2, 3)
    cases = {}
    for ac in (True, False):
        cases[f"affine_grid [{n}, 2, 3] -> [{n}, {h}, {w}, 2] "
              f"align_corners={ac}"] = (
            lambda theta, ac=ac: F.affine_grid(theta, [theta.shape[0], c, h,
                                                       w], align_corners=ac),
            [eye + 0.3 * seeded(gen, (n, 2, 3))], None)
    for mode in ("bilinear", "nearest"):
        for pad in ("zeros", "border"):
            for ac in (True, False):
                cases[f"grid_sample {mode} {pad} align_corners={ac} "
                      f"[{n}, {c}, {h}, {w}]"] = (
                    lambda x, g, mode=mode, pad=pad, ac=ac: F.grid_sample(
                        x, g, mode=mode, padding_mode=pad, align_corners=ac),
                    [seeded(gen, (n, c, h, w)),
                     boundary_free_grid(gen, n, h, w, h, w, ac)],
                    SURFACE_CPU_SAMPLES)
    # the transformer whole: bilinear is continuous in the coordinates, so
    # its output and input gradient are compared (its grid gradient is
    # the cases above, on grids clear of the pixel boundaries)
    cases[f"spatial transformer affine_grid + grid_sample bilinear "
          f"[{n}, {c}, {h}, {w}]"] = (
        lambda x, theta: F.grid_sample(
            x, F.affine_grid(theta, [x.shape[0], c, h, w])),
        [seeded(gen, (n, c, h, w)), eye + 0.3 * seeded(gen, (n, 2, 3))],
        SURFACE_CPU_SAMPLES, (0,))
    cases["deformable_conv v2 [16, 256, 14, 14] -> 256, 3x3"] = (
        lambda x, off, wt, b, m: F.deformable_conv(x, off, wt, b, padding=1,
                                                   mask=m),
        [seeded(gen, (16, 256, 14, 14)), 2.0 * seeded(gen, (16, 18, 14, 14)),
         0.02 * seeded(gen, (256, 256, 3, 3)), seeded(gen, (256,)),
         seeded(gen, (16, 9, 14, 14), 0.0, 1.0)], None)
    cases["temporal_shift [8*8, 256, 56, 56] seg_num=8"] = (
        lambda x: F.temporal_shift(x, 8), [seeded(gen, (64, 256, 56, 56))],
        8)
    cases["channel_shuffle [32, 256, 56, 56] groups=8"] = (
        lambda x: F.channel_shuffle(x, 8), [seeded(gen, (32, 256, 56, 56))],
        SURFACE_CPU_SAMPLES)
    cases["space_to_depth [32, 256, 56, 56] blocksize=2"] = (
        lambda x: F.space_to_depth(x, 2), [seeded(gen, (32, 256, 56, 56))],
        SURFACE_CPU_SAMPLES)
    cases["affine_channel [32, 512, 28, 28]"] = (
        F.affine_channel, [seeded(gen, (32, 512, 28, 28)),
                           seeded(gen, (512,)), seeded(gen, (512,))], None)
    cases["local_response_norm [32, 256, 56, 56] size=5"] = (
        lambda x: F.local_response_norm(x, 5, alpha=1e-3, k=2.0),
        [seeded(gen, (32, 256, 56, 56))], SURFACE_CPU_SAMPLES)
    cases["lrn [32, 1024, 14, 14] n=5"] = (
        lambda x: F.lrn(x, 5, alpha=1e-4), [seeded(gen, (32, 1024, 14, 14))],
        SURFACE_CPU_SAMPLES)
    cases["LocalResponseNorm [32, 2048, 7, 7] size=3"] = (
        pt.nn.LocalResponseNorm(3, alpha=1e-3),
        [seeded(gen, (32, 2048, 7, 7))], SURFACE_CPU_SAMPLES)
    out = {}
    for label, (fn, host, k, *diff) in cases.items():
        wrt = diff[0] if diff else range(len(host))
        card_in = [x.cuda().requires_grad_(i in wrt)
                   for i, x in enumerate(host)]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        card_out = fn(*card_in)
        cot = seeded(gen, tuple(card_out.shape))
        card = [card_out] + list(torch.autograd.grad(
            (card_out * cot.cuda()).sum(),
            [x for x in card_in if x.requires_grad]))
        torch.cuda.synchronize()
        card_ms = (time.perf_counter() - t0) * 1e3
        cpu_in = [(x[:k] if k else x).detach().clone().requires_grad_(
            y.requires_grad) for x, y in zip(host, card_in)]
        cpu = outputs_and_grads(fn, cpu_in, cot[:k] if k else cot)
        if k:
            card = [t[:k] for t in card]
        fwd = check_card_vs_cpu(f"(a) {label} forward", card[:1], cpu[:1],
                                SURFACE_FWD_TOL, failures)
        grad = check_card_vs_cpu(f"(a) {label} gradients", card[1:],
                                 cpu[1:], SURFACE_GRAD_TOL, failures)
        out[label] = {"forward_max_rel": fwd, "grad_max_rel": grad,
                      "card_fwd_bwd_ms_first_call": card_ms,
                      "cpu_samples": k or "all"}
        del card, cpu, card_in
    return out


def gpt_tensor_surface(pt, fa, seed, failures):
    """(b): GPT-small through the Tensor surface, against the same steps
    fed plain tensors and against its k-step program; then the eager
    step's dispatch cost, plain against Tensor inputs."""
    from paddle_tpu_torch import jit
    from paddle_tpu_torch.core.tensor import unwrap
    from paddle_tpu_torch.models.gpt import synthetic_lm_batch
    k = GPT_KSTEP
    cfg, base = gpt_small_model(pt, seed + 1410)
    base.to("bfloat16")
    host = np.stack([synthetic_lm_batch(TRAIN_BATCH, SEQ, cfg.vocab_size,
                                        seed=seed + 1420 + i)
                     for i in range(k)])

    def recipe(m):
        opt, sched = make_optimizer(m)

        def one_step(ids):
            with pt.amp.auto_cast(enable=True, dtype="bfloat16"):
                loss = m.loss(m(ids), ids)
            loss.backward()
            opt.step()
            opt.clear_grad()
            return loss
        return one_step, sched

    plain_ids = [torch.from_numpy(b).cuda() for b in host]
    tensor_ids = [pt.to_tensor(b) for b in host]
    runs, out = {}, {}
    for arm, feed in (("plain", plain_ids), ("tensor", tensor_ids)):
        m = copy.deepcopy(base)
        step, sched = recipe(m)
        fa.reset_launch_counts()
        losses = []
        for call in range(2):  # the scheduler steps after each k steps
            for i in range(k):
                loss = step(feed[i])
                losses.append(loss.detach())
            sched.step()
        torch.cuda.synchronize()
        if arm == "tensor":
            ok = type(feed[0]) is pt.Tensor and type(loss) is pt.Tensor
            log(f"  (b) Tensor arm: ids {type(feed[0]).__module__}."
                f"{type(feed[0]).__name__}, loss "
                f"{type(loss).__module__}.{type(loss).__name__} "
                f"{'ok' if ok else 'FAIL'}")
            if not ok:
                failures.append("phase 14 (b): the Tensor surface did not "
                                "return Tensor")
            out["eager_launches"] = flash_launches(fa)
        runs[arm] = (unwrap(torch.stack(losses)), m)
    compare_runs("(b) GPT-small, Tensor inputs vs plain inputs, 2 x 10 "
                 "eager steps", runs["plain"][0], runs["tensor"][0],
                 runs["plain"][1], runs["tensor"][1], failures)
    want = cfg.num_layers * 2 * k
    for name, n in out["eager_launches"].items():
        ok = n == want
        log(f"  (b) {name}: {n} launches over {2 * k} eager steps with "
            f"Tensor inputs ({n / (2 * k):g} a step; want "
            f"{cfg.num_layers}) {'ok' if ok else 'FAIL'}")
        if not ok:
            failures.append(f"phase 14 (b): {name} launched {n} times, "
                            f"not {want}")
    # the k-step program with Tensor inputs, against the eager steps
    twin = copy.deepcopy(base)
    body, sched = recipe(twin)
    program = jit.to_static(body, scan_steps=k)
    stacked = pt.to_tensor(host)
    got = []
    with inspect_capture():
        got.append(program(stacked))
    sched.step()
    fa.reset_launch_counts()
    replays = count_replays(program)
    got.append(replays.run(lambda: program(stacked)))
    sched.step()
    compare_runs(f"(b) GPT-small, to_static(one_step, scan_steps={k}) "
                 f"with Tensor inputs vs the eager steps",
                 runs["plain"][0],
                 unwrap(torch.cat([g.detach() for g in got])),
                 runs["plain"][1], twin, failures)
    ok = type(got[0]) is pt.Tensor
    log(f"  (b) the k-step program returns {type(got[0]).__name__} "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        failures.append("phase 14 (b): the k-step program did not return "
                        "Tensor")
    launches, off = replays.launches()
    for name, n in launches.items():
        ok = n == cfg.num_layers * k and not off[name]
        log(f"  (b) replayed k-step call: {name} {n} launches from the "
            f"graph (want {cfg.num_layers * k}), {off[name]} off the bf16 "
            f"variant {'ok' if ok else 'FAIL'}")
        if not ok:
            failures.append(f"phase 14 (b): the replayed call launched "
                            f"{name} {n} times, not {cfg.num_layers * k}")
    out["kstep_call_launches"] = launches
    del program, twin, body, runs
    free_cuda()

    # dispatch cost: the eager step with plain and with Tensor inputs, in
    # turns on one model
    m = copy.deepcopy(base)
    step, _ = recipe(m)
    for i in range(2):
        step(plain_ids[i]).item()  # warm-up
    # the arms alternate step by step (which goes first alternating too),
    # so the host's drift reaches both alike; each adjacent pair gives a
    # ratio
    reps, n = SURFACE_TIMED
    feeds = {"plain": plain_ids, "tensor": tensor_ids}
    times = {"plain": [], "tensor": []}
    for rep in range(reps):
        for i in range(n):
            for arm in (("plain", "tensor") if i % 2 else ("tensor",
                                                            "plain")):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                step(feeds[arm][i % k]).item()
                times[arm].append((time.perf_counter() - t0) * 1e3)
    med = {arm: float(np.median(v)) for arm, v in times.items()}
    ratio = med["tensor"] / med["plain"]
    pairs = float(np.median(np.array(times["tensor"]) /
                            np.array(times["plain"])))
    log(f"  (b) eager GPT-small step, {reps} x {n} steps an arm, the arms "
        f"in turns step by step: plain inputs median {med['plain']:.3f} ms, "
        f"Tensor inputs median {med['tensor']:.3f} ms, ratio {ratio:.4f}; "
        f"median of the adjacent pairs' ratios {pairs:.4f}; {card_line()}")
    out.update(step_ms_plain_median=med["plain"],
               step_ms_tensor_median=med["tensor"], tensor_over_plain=ratio,
               tensor_over_plain_paired_median=pairs,
               step_ms_plain=times["plain"], step_ms_tensor=times["tensor"])
    del m, base
    free_cuda()
    return out


def surface_autograd(pt, seed, failures):
    """(c): higher-order gradients, a gradient penalty, a PyLayer, no_grad
    and the RNG state on the card, against the CPU."""
    gen = torch.Generator().manual_seed(seed + 1430)
    out = {}
    x_host = seeded(gen, (4096,), 0.5, 1.5)

    def orders(device):
        x = pt.to_tensor(x_host, place=device, stop_gradient=False)
        y = (pt.tanh(x) * x * x * x).sum()
        (g1,) = pt.grad(y, [x], create_graph=True)
        (g2,) = pt.grad(g1.sum(), [x], create_graph=True)
        (g3,) = pt.grad(g2.sum(), [x])
        return [g1, g2, g3]

    out["third_order"] = check_card_vs_cpu(
        "(c) grad(create_graph=True) to third order [4096]", orders("cuda"),
        orders("cpu"), SURFACE_GRAD_TOL, failures)

    nn = pt.nn

    class Critic(nn.Layer):
        """A small convolutional critic: two strided convolutions with
        tanh (smooth, so the card's and the CPU's rounding move no
        activation across a kink) and a linear score."""

        def __init__(self):
            super().__init__()
            self.c1 = nn.Conv2D(3, 64, 4, stride=2, padding=1, device="cuda")
            self.c2 = nn.Conv2D(64, 128, 4, stride=2, padding=1,
                                device="cuda")
            self.fc = nn.Linear(128 * 8 * 8, 1, device="cuda")

        def forward(self, x):
            h = torch.tanh(self.c2(torch.tanh(self.c1(x))))
            return self.fc(h.flatten(1))

    pt.seed(seed + 1431)
    disc = Critic()
    images = seeded(gen, (16, 3, 32, 32))

    def penalty(d, device):
        x = pt.to_tensor(images, place=device, stop_gradient=False)
        score = d(x).sum()
        (gx,) = pt.grad(score, [x], create_graph=True)
        norm = (gx * gx).sum(axis=[1, 2, 3]).sqrt()
        p = ((norm - 1.0) ** 2).mean()
        p.backward()
        # the score's bias moves no input gradient: no gradient (zeros)
        return [p] + [torch.zeros_like(q) if q.grad is None else q.grad
                      for q in d.parameters()]

    cpu_d = copy.deepcopy(disc).to("cpu")
    out["gradient_penalty"] = check_card_vs_cpu(
        "(c) gradient penalty (||grad_x D(x)|| - 1)^2 through Conv2D, tanh "
        "and Linear [16, 3, 32, 32]", penalty(disc, "cuda"),
        penalty(cpu_d, "cpu"), SURFACE_GRAD_TOL, failures)

    class Swish(pt.autograd.PyLayer):
        @staticmethod
        def forward(ctx, v):
            s = pt.nn.functional.tanh(v) * 0.5 + 0.5  # sigmoid
            ctx.save_for_backward(v, s)
            return v * s

        @staticmethod
        def backward(ctx, dy):
            v, s = ctx.saved_tensor
            return dy * (s + v * s * (1 - s))

    def pylayer(device):
        v = pt.to_tensor(x_host, place=device, stop_gradient=False)
        y = Swish.apply(v * 2.0)
        (gv,) = pt.grad((y * y).sum(), [v])
        return [y, gv]

    out["pylayer"] = check_card_vs_cpu("(c) PyLayer (swish, its own "
                                       "backward) [4096]", pylayer("cuda"),
                                       pylayer("cpu"), SURFACE_GRAD_TOL,
                                       failures)
    v = pt.to_tensor(x_host, place="cuda", stop_gradient=False)
    with pt.no_grad():
        off = v * 2
    ok = not off.requires_grad and off.grad_fn is None and (v * 2).grad_fn \
        is not None
    log(f"  (c) no_grad on the card: no graph recorded inside, one outside "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        failures.append("phase 14 (c): no_grad recorded a graph")
    ones = pt.to_tensor(np.ones((256, 256), np.float32))

    def draws():
        return [pt.rand([1024]), pt.randn([32, 32]),
                pt.nn.functional.dropout(ones, p=0.3)]

    state = pt.get_rng_state()
    first = draws()
    pt.set_rng_state(state)
    again = draws()
    ok = all(torch.equal(a, b) for a, b in zip(first, again)) and \
        not torch.equal(first[0], draws()[0])
    log(f"  (c) get_rng_state/set_rng_state on the card: rand, randn and "
        f"dropout repeat bitwise after set_rng_state "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        failures.append("phase 14 (c): set_rng_state did not repeat the "
                        "draws")
    out["rng_state_repeats"] = ok
    return out


def ctr_batches(n_batches, seed, zipf=1.2):
    """``paddle_tpu/models/ctr.py:96-115``'s synthetic_ctr_batches at
    CTR_BATCH x CTR_SLOTS over CTR_VOCAB: Zipf-skewed ids (rank r drawn as
    1/r^zipf, shuffled over the vocabulary) and labels from a hidden
    per-key scorer."""
    rng = np.random.RandomState(seed)
    p = 1.0 / np.arange(1, CTR_VOCAB + 1, dtype=np.float64) ** zipf
    p /= p.sum()
    perm = np.random.RandomState(11).permutation(CTR_VOCAB)
    scorer = np.random.RandomState(1).randn(CTR_VOCAB).astype(np.float32)
    out = []
    for _ in range(n_batches):
        ranks = rng.choice(CTR_VOCAB, (CTR_BATCH, CTR_SLOTS), p=p)
        ids = perm[ranks].astype(np.int64)
        label = (scorer[ids].mean(axis=1) > 0.0).astype(np.float32)
        out.append((ids, label.reshape(-1, 1)))
    return out


def ctr_model(pt, seed):
    """The deep and wide halves of the reference's WideAndDeep
    (``paddle_tpu/models/ctr.py:39-94``) over the port's
    ``Embedding(sparse=True)`` and ``Linear``: a [vocab, dim] table and an
    MLP over the slots' concatenated rows, plus a [vocab, 1] table summed
    over the slots."""
    nn = pt.nn

    class WideDeep(nn.Layer):
        def __init__(self):
            super().__init__()
            init = nn.ParamAttr(initializer=nn.initializer.Normal(0.0, 0.05))
            self.emb = nn.Embedding(CTR_VOCAB, CTR_DIM, sparse=True,
                                    weight_attr=init, device="cuda")
            self.wide = nn.Embedding(CTR_VOCAB, 1, sparse=True,
                                     weight_attr=init, device="cuda")
            widths = [CTR_SLOTS * CTR_DIM, *CTR_HIDDEN]
            self.deep = nn.LayerList([nn.Linear(a, b, device="cuda")
                                      for a, b in zip(widths, widths[1:])])
            self.head = nn.Linear(widths[-1], 1, device="cuda")

        def forward(self, ids):
            h = self.emb(ids).reshape(ids.shape[0], -1)
            for fc in self.deep:
                h = torch.relu(fc(h))
            return self.head(h) + self.wide(ids).sum(1)

    pt.seed(seed)
    return WideDeep()


def set_sparse(model, sparse):
    model.emb._sparse = model.wide._sparse = sparse
    return model


def ctr_step(pt, model, kind):
    opt = (pt.optimizer.SGD(learning_rate=CTR_SGD_LR,
                            parameters=model.parameters()) if kind == "SGD"
           else pt.optimizer.Adam(learning_rate=CTR_ADAM_LR, lazy_mode=True,
                                  parameters=model.parameters()))

    def one_step(ids, labels):
        loss = torch.nn.functional.binary_cross_entropy_with_logits(
            model(ids), labels)
        loss.backward()
        opt.step()
        opt.clear_grad()
        return loss
    return one_step, opt


def surface_sparse(pt, fa, seed, failures):
    """(d): sparse embeddings at bench_ctr's sizes, SGD and Adam(lazy_mode),
    eager against captured, untouched rows, sparse against dense."""
    from paddle_tpu_torch import jit
    t0 = time.perf_counter()
    data = [(torch.from_numpy(i).cuda(), torch.from_numpy(y).cuda())
            for i, y in ctr_batches(CTR_STEPS + CTR_TIMED + CTR_WARMUP,
                                    seed + 1440)]
    log(f"  (d) {len(data)} batches of {CTR_BATCH} x {CTR_SLOTS} Zipf-1.2 "
        f"ids over {CTR_VOCAB}: {time.perf_counter() - t0:.1f} s")
    base = ctr_model(pt, seed + 1441)
    table_gb = base.emb.weight.numel() * 4 / 1e9
    steps = data[:CTR_STEPS]
    touched = torch.zeros(CTR_VOCAB, dtype=torch.bool,
                          device=base.emb.weight.device)
    for ids, _ in steps:
        touched[ids.reshape(-1)] = True
    n_touched = int(touched.sum())
    log(f"  (d) model: table [{CTR_VOCAB}, {CTR_DIM}] float32 "
        f"({table_gb:.3f} GB), wide [{CTR_VOCAB}, 1], MLP "
        f"{CTR_SLOTS * CTR_DIM} -> {CTR_HIDDEN} -> 1; {n_touched} rows "
        f"touched by the {CTR_STEPS} checked steps")
    out = {"table_gb": table_gb, "rows_touched": n_touched}
    finals = {}
    for kind in ("SGD", "Adam"):
        with deterministic_algorithms():
            m_e = copy.deepcopy(base)
            step_e, opt_e = ctr_step(pt, m_e, kind)
            want = torch.stack([step_e(*b).detach() for b in steps])
            m_g = copy.deepcopy(base)
            step_g, opt_g = ctr_step(pt, m_g, kind)
            prog = jit.to_static(step_g)
            got = torch.stack([prog(*b) for b in steps])
            compiles = len(prog._programs)
        compare_runs(f"(d) {kind} sparse, {CTR_STEPS} steps through one "
                     f"CUDA graph ({compiles} captured)", want, got, m_e,
                     m_g, failures, opt_e, opt_g)
        bad = []
        for name in ("emb", "wide"):
            table = getattr(m_g, name).weight.detach()
            start = getattr(base, name).weight.detach()
            if not torch.equal(table[~touched], start[~touched]):
                bad.append(f"{name} rows")
            for slot in opt_g._slot_names():
                acc = opt_g._get_accumulator(slot, getattr(m_g, name).weight)
                if bool(acc[~touched].any()):
                    bad.append(f"{name}.{slot}")
            if torch.equal(table[touched], start[touched]):
                bad.append(f"{name}: no touched row moved")
        log(f"  (d) {kind}: the {CTR_VOCAB - n_touched} untouched rows of "
            f"both tables and of every accumulator bitwise as they were "
            f"{'ok' if not bad else 'FAIL ' + str(bad)}")
        if bad:
            failures.append(f"phase 14 (d) {kind}: untouched rows changed "
                            f"or touched ones did not: {bad}")
        finals[kind] = m_e
        out[kind] = {"losses": [float(v) for v in want],
                     "compiles": compiles}
        del m_g, prog, step_g, opt_g, step_e, opt_e
        free_cuda()

    # the touched rows of sparse SGD against the dense update
    m_d = set_sparse(copy.deepcopy(base), False)
    step_d, _ = ctr_step(pt, m_d, "SGD")
    for b in steps:
        step_d(*b)
    start = base.emb.weight.detach()[touched]
    upd_s = finals["SGD"].emb.weight.detach()[touched] - start
    upd_d = m_d.emb.weight.detach()[touched] - start
    rel = float((upd_s - upd_d).norm() / upd_d.norm())
    ok = rel <= CTR_SPARSE_DENSE_TOL and torch.equal(
        m_d.emb.weight.detach()[~touched], base.emb.weight.detach()[~touched])
    log(f"  (d) sparse vs dense SGD over {CTR_STEPS} steps: the touched "
        f"rows' updates differ by rel L2 {rel:.3e} (tol "
        f"{CTR_SPARSE_DENSE_TOL:g}) {'ok' if ok else 'FAIL'}")
    if not ok:
        failures.append(f"phase 14 (d): sparse SGD disagrees with the dense "
                        f"update ({rel:.3e})")
    out["sgd_sparse_vs_dense_rel_l2"] = rel
    del m_d, step_d, finals
    free_cuda()

    # timed: sparse against dense, each optimizer, eager, default kernels
    timed = data[CTR_STEPS:]
    for kind in ("SGD", "Adam"):
        for sparse in (True, False):
            m = set_sparse(copy.deepcopy(base), sparse)
            step, opt = ctr_step(pt, m, kind)
            torch.cuda.synchronize()
            before = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            ms = []
            for i, b in enumerate(timed):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                step(*b).item()
                if i >= CTR_WARMUP:
                    ms.append((time.perf_counter() - t0) * 1e3)
            peak = (torch.cuda.max_memory_allocated() - before) / 1e9
            state = sum(t.numel() * t.element_size()
                        for t in opt._accumulators.values()) / 1e9
            arm = f"{kind} {'sparse' if sparse else 'dense'}"
            med = float(np.median(ms))
            log(f"  (d) {arm}: step median {med:.3f} ms over {len(ms)} "
                f"steps ({CTR_BATCH * CTR_SLOTS * 2} lookups a step); "
                f"working set above the model and optimizer state "
                f"{peak:.3f} GB; optimizer state {state:.3f} GB; "
                f"{card_line()}")
            out[arm] = {"step_ms_median": med, "step_ms": ms,
                        "working_set_gb": peak, "optimizer_state_gb": state}
            del m, step, opt
            free_cuda()
    for kind in ("SGD", "Adam"):
        s, d = out[f"{kind} sparse"], out[f"{kind} dense"]
        log(f"  (d) {kind}: sparse / dense step "
            f"{s['step_ms_median'] / d['step_ms_median']:.3f}, working set "
            f"{s['working_set_gb']:.3f} vs {d['working_set_gb']:.3f} GB")
    del base
    free_cuda()
    return out


def phase14(pt, fa, seed, failures):
    """Phase 14: the imperative surface (Tensor, autograd, PyLayer, the
    vision functionals, sparse embeddings). A part that raises is a
    failure and the next one still runs."""
    import traceback
    log("phase 14: the imperative surface: the vision functionals, "
        "GPT-small through Tensor inputs, autograd, sparse embeddings at "
        "bench_ctr's sizes")
    t_phase = time.perf_counter()
    out, launches = {}, {}
    for key, part in (("vision", lambda: surface_vision(pt, seed, failures)),
                      ("gpt_tensor_surface",
                       lambda: gpt_tensor_surface(pt, fa, seed, failures)),
                      ("autograd", lambda: surface_autograd(pt, seed,
                                                            failures)),
                      ("sparse_ctr", lambda: surface_sparse(pt, fa, seed,
                                                            failures))):
        t0 = time.perf_counter()
        if key != "gpt_tensor_surface":
            fa.reset_launch_counts()
        try:
            out[key] = part()
        except Exception as e:  # noqa: BLE001 -- reported as a failure
            traceback.print_exc()
            failures.append(f"phase 14 ({key}) raised {type(e).__name__}: "
                            f"{e}")
        if key != "gpt_tensor_surface":
            counts = flash_launches(fa)
            launches[f"imperative_{key}"] = counts
            ok = not any(counts.values())
            log(f"  -- {key}: flash launches {counts} (none expected) "
                f"{'ok' if ok else 'FAIL'}")
            if not ok:
                failures.append(f"phase 14 ({key}) launched flash kernels "
                                f"{counts}")
        log(f"  -- {key}: {time.perf_counter() - t0:.1f} s")
        free_cuda()
    gpt = out.get("gpt_tensor_surface", {})
    launches["tensor_surface_eager_20_steps"] = gpt.get("eager_launches", {})
    launches["tensor_surface_kstep_call"] = gpt.get("kstep_call_launches",
                                                    {})
    out["seconds"] = time.perf_counter() - t_phase
    log(f"  phase 14: {out['seconds']:.1f} s; {card_line()}")
    log(json.dumps({"imperative_surface": out}))
    return launches


# ---- phase 15: runtime services --------------------------------------------

OBSERVED_TIMED = (3, 4)   # (b): 3 alternations of 4 steps an arm
POD_LOSS_TOL = 1e-6       # (f): the pod's losses against its control
# (f)'s runs: (POD_FIX_MODEL, steps, checkpoint every, the kill's hit of
# pod/mid_step, heal by step)
POD_RUNS = {"liveness_mlp": ("mlp", 10, 3, 5, 7),
            "state_gpt_small": ("gpt_small", 5, 2, 4, 4)}
RUNTIME_DIR = ".chip_smoke_runtime"  # run-log, flight dumps, traces


def runtime_dir(name):
    import os
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        RUNTIME_DIR, name)
    os.makedirs(path, exist_ok=True)
    return path


def observed_recipe(pt, m, span=False):
    """Phase 4's recipe around ``m``: (one_step, the scheduler); with
    ``span`` each step is a ``step`` span of the tracer."""
    from paddle_tpu_torch import observability
    opt, sched = make_optimizer(m)

    def one_step(ids):
        with (observability.trace_span("train/step", cat="step") if span
              else contextlib.nullcontext()):
            with pt.amp.auto_cast(enable=True, dtype="bfloat16"):
                loss = m.loss(m(ids), ids)
            loss.backward()
            opt.step()
            opt.clear_grad()
        return loss
    return one_step, sched, opt


def observed_run(pt, fa, base, feed, stacked, k, label, failures,
                 profile=None, timer=None):
    """10 eager steps, then two calls of ``to_static(scan_steps=k)`` (the
    capture, then a replayed call counted from its graph) on a copy of
    ``base``: (losses, model, eager launches, replayed-call launches,
    StepTimer marks). ``profile`` wraps the eager steps."""
    from paddle_tpu_torch import jit
    m = copy.deepcopy(base)
    step, sched, _opt = observed_recipe(pt, m, span=True)
    fa.reset_launch_counts()
    losses = []
    with (profile if profile is not None else contextlib.nullcontext()):
        for i in range(k):
            losses.append(step(feed[i]).detach())
        torch.cuda.synchronize()
    eager = flash_launches(fa)
    sched.step()
    program = jit.to_static(step, scan_steps=k)
    marks = []
    if timer is not None:
        torch.cuda.synchronize()
        timer.start()
    with inspect_capture():
        losses.append(program(stacked).detach())
    if timer is not None:
        losses[-1].cpu()
        marks.append(timer.step())
    sched.step()
    replays = count_replays(program)
    losses.append(replays.run(lambda: program(stacked)).detach())
    if timer is not None:
        losses[-1].cpu()
        marks.append(timer.step())
    sched.step()
    launches, off = replays.launches()
    from paddle_tpu_torch.observability import memory
    mem = program.export_memory_stats()
    reg = memory.program_memory()
    ok = len(mem) == 1 and all(
        v["temp_bytes"] > 0 and v["output_bytes"] > 0 and reg.get(entry) == v
        for entry, v in mem.items())
    log(f"  {label}: the program's memory_stats {mem} (in the registry) "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        failures.append(f"phase 15 {label}: StaticFunction.memory_stats "
                        f"{mem} / the registry disagree")
    for name, n in eager.items():
        ok = n == base.config.num_layers * k
        log(f"  {label}: {name} {n} launches in {k} eager steps (want "
            f"{base.config.num_layers * k}) {'ok' if ok else 'FAIL'}")
        if not ok:
            failures.append(f"phase 15 {label}: {name} launched {n} times "
                            f"in {k} eager steps")
    for name, n in launches.items():
        ok = n == base.config.num_layers * k and not off[name]
        log(f"  {label}: replayed k-step call: {name} {n} launches from the "
            f"graph (want {base.config.num_layers * k}) "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            failures.append(f"phase 15 {label}: the replayed call launched "
                            f"{name} {n} times")
    del program
    return (torch.cat([x.reshape(-1) for x in losses]), m, eager, launches,
            marks)


def runtime_everything_on(pt, fa, base, feed, stacked, k, failures):
    """(a): the tracer (default categories), a run-log, the flight
    recorder and ``profiler.Profiler(state="All")`` on, against the same
    steps with everything off: bitwise, and the same launches."""
    import os
    from paddle_tpu_torch import observability, profiler
    from paddle_tpu_torch.observability import flight, runlog
    from paddle_tpu_torch.observability.step import StepTimer
    off = observed_run(pt, fa, base, feed, stacked, k, "(a) everything off",
                       failures)
    observability.tracing.reset()
    observability.enable()
    log_ = runlog.start_run(dir=runtime_dir("runlog"))
    flight.install(runtime_dir("flight_a"))
    prof = profiler.Profiler(state="All")
    timer = StepTimer(window=1, publish_as=None)
    try:
        on = observed_run(pt, fa, base, feed, stacked, k, "(a) everything on",
                          failures, profile=prof, timer=timer)
    finally:
        observability.disable()
        runlog.stop_run()
        flight.uninstall()
    compare_runs(f"(a) everything on vs off, {k} eager steps and 2 calls of "
                 f"to_static(scan_steps={k})", off[0], on[0], off[1], on[1],
                 failures)
    ok = on[2] == off[2] and on[3] == off[3]
    log(f"  (a) launches on {on[2]} / {on[3]} vs off {off[2]} / {off[3]} "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        failures.append("phase 15 (a): launches differ with everything on")
    # the chrome trace: host spans, per-op events, the kernels' device
    # events under the reference's names
    path = os.path.join(runtime_dir("trace"), "phase15a.json")
    n_events = observability.export_chrome_trace(path)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    spans = sum(e["name"] == "train/step" for e in events)
    ops = sum(e["cat"] == "op" for e in events)
    device = {name: sum(e["name"] == name and e["cat"] == "kernel"
                        for e in events)
              for name in set(fa.CUDA_FUNCTIONS.values())}
    host_kernels = {name: sum(e["name"] == name and e["cat"] == "op"
                              for e in events)
                    for name in set(fa.CUDA_FUNCTIONS.values())}
    # the k eager steps, and the program's first call runs the body's
    # Python twice (its eager warm-up step and the capture); a replay
    # runs none
    ok = spans == k + 2 and ops > 0 and all(device.values()) and all(
        n == base.config.num_layers * k for n in host_kernels.values())
    log(f"  (a) chrome trace: {n_events} events, {spans} train/step spans "
        f"(want {k + 2}), "
        f"{ops} op events (kernels as ops {host_kernels}), device events "
        f"{device} (the trace may drop a record) {'ok' if ok else 'FAIL'}")
    if not ok:
        failures.append("phase 15 (a): the chrome trace lacks host spans, "
                        "op events or the kernels' device events")
    fracs = [m["compile_stall_frac"] for m in on[4]]
    ok = fracs[0] > 0 and fracs[1] == 0
    log(f"  (a) compile_stall_frac: {fracs[0]:.4f} in the window with the "
        f"capture, {fracs[1]:.4f} in the replayed call's "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        failures.append(f"phase 15 (a): compile_stall_frac {fracs}")
    with open(log_.path) as f:
        n_records = sum(1 for _ in f)
    log(f"  (a) run-log {os.path.basename(log_.path)}: {n_records} records")
    return off, {"eager_launches": on[2], "kstep_call_launches": on[3],
                 "chrome_events": n_events, "device_events": device,
                 "compile_stall_frac": fracs}


def runtime_sampled(pt, fa, base, feed, eager_ms, failures):
    """(b): the sampled op observer at rate 1.0 (the kernels' per-op
    counters), then the eager step off, at 0.01 and at 1.0, in turns."""
    from paddle_tpu_torch import monitor, observability
    m = copy.deepcopy(base)
    step, _, _ = observed_recipe(pt, m)
    for i in range(2):
        step(feed[i]).item()  # warm-up
    before = dict(monitor.stats())
    observability.enable(categories=["dispatch"], dispatch_sample_rate=1.0)
    try:
        step(feed[2]).item()
    finally:
        observability.disable()
    after = monitor.stats()
    per_op = {key: after[key] - before.get(key, 0) for key in after
              if key.startswith("dispatch_op_sampled{")
              and after[key] != before.get(key, 0)}
    kern = {name: per_op.get(f'dispatch_op_sampled{{op="{name}"}}', 0)
            for name in flash_launches(fa)}
    ok = all(n == base.config.num_layers for n in kern.values())
    log(f"  (b) rate 1.0: {len(per_op)} op names, "
        f"{sum(per_op.values())} ops in one step; the kernels {kern} (want "
        f"{base.config.num_layers} each) {'ok' if ok else 'FAIL'}")
    if not ok:
        failures.append(f"phase 15 (b): the sampled observer counted the "
                        f"kernels {kern}")
    top = sorted(per_op.items(), key=lambda kv: -kv[1])[:8]
    log(f"  (b) most frequent ops at rate 1.0: "
        + ", ".join(f"{k.split('=')[1][1:-2]} {v}" for k, v in top))
    rates = {"off": None, "rate_0.01": 0.01, "rate_1.0": 1.0}
    reps, n = OBSERVED_TIMED
    times = {arm: [] for arm in rates}
    order = list(rates)
    for rep in range(reps):
        for i in range(n):
            for arm in (order if (rep * n + i) % 2 == 0 else order[::-1]):
                if rates[arm] is not None:
                    observability.enable(categories=["dispatch"],
                                         dispatch_sample_rate=rates[arm])
                try:
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    step(feed[i % len(feed)]).item()
                    times[arm].append((time.perf_counter() - t0) * 1e3)
                finally:
                    if rates[arm] is not None:
                        observability.disable()
    med = {arm: float(np.median(v)) for arm, v in times.items()}
    log("  (b) eager GPT-small step, medians of "
        f"{reps} x {n} steps an arm in turns: "
        + ", ".join(f"{arm} {ms:.3f} ms" for arm, ms in med.items())
        + f"; {card_line()}")
    log(f"  (b) the eager step with no observer {med['off']:.3f} ms; phase "
        f"4's eager step "
        + ("not run" if eager_ms is None else f"{eager_ms:.3f} ms"))
    del m
    return {"kernel_ops_rate_1": kern, "step_ms_median": med,
            "step_ms": times}


def runtime_nan_check(pt, fa, base, feed, stacked, k, control, failures):
    """(c): FLAGS_check_nan_inf=1: the eager steps and the k-step program
    bitwise against (a)'s run with everything off, the eager step's time;
    then a NaN written into one layer's weight raises at the first op
    whose output holds it."""
    pt.set_flags({"FLAGS_check_nan_inf": 1})
    try:
        m = copy.deepcopy(base)
        step, _, _ = observed_recipe(pt, m)
        ms = []
        for i in range(2):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            step(feed[i]).item()
            ms.append((time.perf_counter() - t0) * 1e3)
        log(f"  (c) eager step with FLAGS_check_nan_inf=1: "
            + ", ".join(f"{x:.1f}" for x in ms) + f" ms; {card_line()}")
        del m, step
        free_cuda()
        got = observed_run(pt, fa, base, feed, stacked, k,
                           "(c) FLAGS_check_nan_inf=1", failures)
        compare_runs(f"(c) FLAGS_check_nan_inf=1 vs (a) everything off, {k} "
                     f"eager steps and 2 calls of to_static(scan_steps={k})",
                     control[0], got[0], control[1], got[1], failures)
        del got
        free_cuda()
        bad = copy.deepcopy(base)
        step, _, _ = observed_recipe(pt, bad)
        w = dict(bad.named_parameters())["gpt.blocks.5.fc1.weight"]
        with torch.no_grad():
            w[7, 11] = float("nan")
        try:
            step(feed[0])
        except FloatingPointError as e:
            msg = str(e)
        else:
            msg = None
        ok = msg is not None and msg.startswith("Operator `")
        op = msg.split("`")[1] if ok else None
        log(f"  (c) NaN in gpt.blocks.5.fc1.weight: "
            + (f"FloatingPointError at op {op!r}: {msg}" if ok
               else "no FloatingPointError") + (" ok" if ok else " FAIL"))
        if not ok:
            failures.append("phase 15 (c): a NaN weight raised no "
                            "FloatingPointError")
        del bad, step
    finally:
        pt.set_flags({"FLAGS_check_nan_inf": 0})
    return {"step_ms": ms, "nan_op": op}


def runtime_memory(pt, serving, seed, failures):
    """(d): the state ledger of GPT-small and its AdamW, each category
    against its tensors' bytes; the serving buckets in the program
    registry."""
    import gc
    from paddle_tpu_torch.observability import memory
    gc.collect()
    before = memory.state_ledger()
    cfg, model = gpt_small_model(pt, seed + 1530)
    model.to("bfloat16")
    opt, _ = make_optimizer(model)
    gc.collect()
    led = memory.state_ledger()
    cats = {}
    for c, v in led["categories"].items():
        w = before["categories"].get(c, {"bytes": 0, "count": 0})
        if v["bytes"] - w["bytes"]:
            cats[c] = v["bytes"] - w["bytes"]
    want = {"param": sum(p.nbytes for p in model.parameters()),
            "master": sum(t.nbytes for (s, _), t in opt._accumulators.items()
                          if s == "master"),
            "opt_moment": sum(t.nbytes for (s, _), t in
                              opt._accumulators.items() if s != "master")}
    allocated = torch.cuda.memory_allocated()
    ok = all(cats.get(c) == n for c, n in want.items())
    ok &= led["total_bytes"] <= allocated
    log(f"  (d) state ledger of GPT-small + AdamW (bytes by category): "
        f"{cats}; want {want}; total {led['total_bytes']} <= allocated "
        f"{allocated} {'ok' if ok else 'FAIL'}")
    if not ok:
        failures.append("phase 15 (d): the state ledger disagrees with the "
                        "tensors' bytes")
    del opt
    model.to("float32")
    engine = serving.Engine.from_layer(
        model, [([None, SEQ], "int32")], bucket_ladder=(1, 4),
        passes=("bf16",), device="cuda")
    try:
        stats = engine.memory_stats()
        reg = memory.program_memory()
        ok = all(reg.get(f"serving_b{b}") == stats[b] for b in (1, 4))
        log(f"  (d) program registry: serving_b1 peak "
            f"{reg.get('serving_b1', {}).get('peak_bytes')} B, serving_b4 "
            f"peak {reg.get('serving_b4', {}).get('peak_bytes')} B, equal to "
            f"memory_stats() {'ok' if ok else 'FAIL'}")
        if not ok:
            failures.append("phase 15 (d): the program registry disagrees "
                            "with Engine.memory_stats()")
    finally:
        engine.close()
    del model, engine
    free_cuda()
    return {"ledger_bytes": cats, "programs": {
        b: stats[b]["peak_bytes"] for b in (1, 4)}}


def runtime_flight(pt, seed, failures):
    """(e): a FaultInjected at a checkpoint kill point of a GPT-small save
    leaves one dump (the span ring, the memory section, the lockwatch
    section); a real torch.OutOfMemoryError is classified as one."""
    import os
    import shutil
    from paddle_tpu_torch import _lockwatch, observability
    from paddle_tpu_torch.checkpoint import CheckpointManager
    from paddle_tpu_torch.observability import flight, memory
    from paddle_tpu_torch.testing import faults
    root, dumps = ckpt_dir("runtime_flight"), runtime_dir("flight_e")
    shutil.rmtree(dumps, ignore_errors=True)
    was = _lockwatch.enable()
    cfg, model = gpt_small_model(pt, seed + 1540)
    model.to("bfloat16")
    opt, _ = make_optimizer(model)
    flight.install(dumps)
    observability.enable()
    try:
        mgr = CheckpointManager(root).add_model(model).add_optimizer(opt)
        with faults.scoped("checkpoint/data_partial"):
            try:
                mgr.save(1)
                raised = None
            except faults.FaultInjected as e:
                raised = e
        files = sorted(f for f in os.listdir(dumps) if f.endswith(".json"))
        rec = {}
        if len(files) == 1:
            with open(os.path.join(dumps, files[0])) as f:
                rec = json.load(f)
        ok = (raised is not None and len(files) == 1
              and rec.get("kill_point") == "checkpoint/data_partial"
              and rec["spans"] and "state" in rec.get("memory", {})
              and "lockwatch" in rec)
        log(f"  (e) FaultInjected at checkpoint/data_partial of a GPT-small "
            f"save: {len(files)} dump(s), {len(rec.get('spans', []))} spans "
            f"(last {rec.get('spans', [{}])[-1].get('name')}), memory "
            f"section {sorted(rec.get('memory', {}))}, lockwatch section "
            f"{'lockwatch' in rec} {'ok' if ok else 'FAIL'}")
        if not ok:
            failures.append("phase 15 (e): the kill point left no complete "
                            "flight dump")
        try:
            torch.empty(1 << 44, dtype=torch.uint8, device="cuda")
            oom = None
        except torch.OutOfMemoryError as e:
            oom = e
        path = flight.dump("unhandled_exception", exc=oom)
        with open(path) as f:
            tag = json.load(f)["reason"]
        ok = oom is not None and memory.is_oom_error(oom) and tag == "oom"
        log(f"  (e) torch.OutOfMemoryError ({str(oom).splitlines()[0][:80]}"
            f"...): is_oom_error {memory.is_oom_error(oom)}, dump reason "
            f"{tag!r} {'ok' if ok else 'FAIL'}")
        if not ok:
            failures.append("phase 15 (e): an out-of-memory error was not "
                            "classified")
    finally:
        observability.disable()
        flight.uninstall()
        if not was:
            _lockwatch.disable()
        shutil.rmtree(root, ignore_errors=True)
    del model, opt
    free_cuda()
    return {"dump_spans": len(rec.get("spans", []))}


def runtime_pod(failures):
    """(f): two ranks of ``testing.pod_fixture`` on the card under
    ``VirtualPod`` with a restart policy, rank 1 SIGKILLed at
    ``pod/mid_step``: detection, re-formation at world 1, the survivor's
    restore, the replacement's rejoin; every loss against the fixture's
    control on the card. Once with the reference's MLP (the pod's
    liveness and control at the fixture's size), once with GPT-small
    replicas (their restore moves the whole model and AdamW state)."""
    import os
    import shutil
    from paddle_tpu_torch.distributed.restart import RestartPolicy
    from paddle_tpu_torch.testing import pod_fixture
    from paddle_tpu_torch.testing.virtual_pod import VirtualPod
    out = {}
    for arm, (model, steps, every, kill_at, heal_by) in POD_RUNS.items():
        work = runtime_dir("pod")
        shutil.rmtree(work, ignore_errors=True)
        root = os.path.join(work, "ckpt")
        env = {"POD_FIX_CKPT_ROOT": root, "POD_FIX_MODEL": model,
               "POD_FIX_STEPS": str(steps), "POD_FIX_CKPT_EVERY": str(every),
               "POD_FIX_TARGET_WORLD": "2",
               "POD_FIX_HEAL_BY_STEP": str(heal_by),
               "POD_FIX_HEAL_TIMEOUT": "90", "POD_FIX_DEVICE": "cuda"}
        t0 = time.time()
        vp = VirtualPod(2, pod_fixture.__file__, workdir=work, env=env,
                        kill=(1, "pod/mid_step", kill_at),
                        restart=RestartPolicy(max_restarts=2, base_delay=0.2,
                                              seed=0))
        exits = vp.run(timeout=240)
        wall = time.time() - t0
        r0 = vp.log(0)
        text = r0 + vp.log(1)
        losses = {}
        for s, v in re.findall(r"^LOSS (\d+) (\S+)$", text, re.M):
            losses.setdefault(int(s), []).append(float(v))
        control = pod_fixture.control(steps, device="cuda", model=model)
        free_cuda()
        worst = max((abs(v - control[s]) for s, vs in losses.items()
                     for v in vs), default=float("inf"))
        step_bytes = {}
        for d in os.listdir(root) if os.path.isdir(root) else ():
            if not d.startswith("step_"):
                continue
            files = [os.path.join(dp, f) for dp, _, fs in
                     os.walk(os.path.join(root, d)) for f in fs]
            step_bytes[d] = sum(os.path.getsize(f) for f in files)

        def stamps(pattern):
            return [float(t) for t in
                    re.findall(pattern + r".* t=([0-9.]+)", r0)]
        killed = vp.exit_history[0] if vp.exit_history else None
        detected = stamps(r"FAILURE_DETECTED")
        shrunk = stamps(r"REFORMED rank=0 world=1 gen=1 dir=shrink")
        grown = stamps(r"REFORMED rank=0 world=2 gen=2 dir=grow")
        resumed = stamps(r"RESUME_FROM \d+")
        ok = (killed is not None and killed.signal == "SIGKILL"
              and exits[0].returncode == 0 and exits[1].returncode == 0
              and exits[1].incarnation == 2
              and all((detected, shrunk, grown)) and len(resumed) == 2
              and sorted(losses) == list(range(steps))
              and worst <= POD_LOSS_TOL and "DONE rank=0 world=2" in r0)
        times = {}
        if ok:
            # rank 0 resumes twice: after the shrink, after the grow
            times = {"detect_s": detected[0] - killed.t_reaped,
                     "reform_s": shrunk[0] - detected[0],
                     "restore_s": resumed[0] - shrunk[0],
                     "recover_s": resumed[0] - killed.t_reaped,
                     "heal_s": grown[0] - killed.t_reaped,
                     "grow_restore_s": resumed[1] - grown[0]}
        log(f"  (f) {arm}: virtual pod on the card: exits {exits}; losses "
            f"of {len(losses)} steps, worst |diff| against the control on "
            f"the card {worst:.3e} (tol {POD_LOSS_TOL:g}); "
            + ", ".join(f"{k} {v:.3f}" for k, v in times.items())
            + f"; checkpoint bytes a step {step_bytes}; {wall:.1f} s "
            f"{'ok' if ok else 'FAIL'}; {card_line()}")
        if not ok:
            log(vp.tail_logs(6000))
            failures.append(f"phase 15 (f) {arm}: the virtual pod did not "
                            "heal within its control")
        shutil.rmtree(work, ignore_errors=True)
        out[arm] = dict(times, worst_loss_diff=worst, seconds=wall,
                        checkpoint_bytes=step_bytes)
    return out


def phase15(pt, fa, serving, seed, eager_ms, failures):
    """Phase 15: the runtime services on GPT-small at full width. A part
    that raises is a failure and the next one still runs."""
    import traceback
    from paddle_tpu_torch.models.gpt import synthetic_lm_batch
    log("phase 15: runtime services on GPT-small: everything on against "
        "off, the sampled op observer, FLAGS_check_nan_inf, memory, the "
        "flight recorder, the virtual pod")
    t_phase = time.perf_counter()
    k = GPT_KSTEP
    cfg, base = gpt_small_model(pt, seed + 1500)
    base.to("bfloat16")
    host = np.stack([synthetic_lm_batch(TRAIN_BATCH, SEQ, cfg.vocab_size,
                                        seed=seed + 1510 + i)
                     for i in range(k)])
    feed = [torch.from_numpy(b).cuda() for b in host]
    stacked = torch.from_numpy(host).cuda()
    out, launches, control = {}, {}, [None]

    def everything_on():
        control[0], res = runtime_everything_on(pt, fa, base, feed, stacked,
                                                k, failures)
        launches["observed_eager_10_steps"] = res["eager_launches"]
        launches["observed_kstep_call"] = res["kstep_call_launches"]
        return res

    parts = (("everything_on", everything_on),
             ("sampled_observer", lambda: runtime_sampled(
                 pt, fa, base, feed, eager_ms, failures)),
             ("nan_check", lambda: runtime_nan_check(
                 pt, fa, base, feed, stacked, k, control[0], failures)),
             ("memory", lambda: runtime_memory(pt, serving, seed, failures)),
             ("flight", lambda: runtime_flight(pt, seed, failures)),
             ("pod", lambda: runtime_pod(failures)))
    for key, part in parts:
        t0 = time.perf_counter()
        try:
            if key == "nan_check" and control[0] is None:
                raise RuntimeError("(a) did not run, so (c) has no control")
            out[key] = part()
        except Exception as e:  # noqa: BLE001 -- reported as a failure
            traceback.print_exc()
            failures.append(f"phase 15 ({key}) raised {type(e).__name__}: "
                            f"{e}")
        log(f"  -- {key}: {time.perf_counter() - t0:.1f} s")
        free_cuda()
    del base, control
    import os
    import shutil
    shutil.rmtree(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                               RUNTIME_DIR), ignore_errors=True)
    out["seconds"] = time.perf_counter() - t_phase
    log(f"  phase 15: {out['seconds']:.1f} s; {card_line()}")
    log(json.dumps({"runtime_services": out}, default=str))
    return launches


# ---- phase 16: CTR through the parameter server ----------------------------

PS_DIR = ".chip_smoke_ps"  # spill files and snapshots, removed at the end
# (b): bench_hbm_cache's sizes (benchmarks/run_all.py:342, 365).
HBM_VOCAB, HBM_DIM, HBM_BATCH, HBM_STEPS = 200_000, 64, 4096, 30
HBM_CAPACITY, HBM_LR = 1 << 18, 0.1
# (c): bench_ctr's accelerator sizes (benchmarks/run_all.py:418-420, with
# phase 14's CTR_VOCAB, CTR_DIM, CTR_SLOTS, CTR_BATCH and CTR_HIDDEN): k
# steps a window; run_all.py's bench_ctr feeds (windows + 1) * k batches.
PSCTR_K, PSCTR_WINDOWS, PSCTR_CAPACITY = 16, 10, 1 << 18
PSCTR_SPARSE_LR, PSCTR_DENSE_LR, PSCTR_SEED = 0.05, 1e-3, 3
# The same recipe with a cache below its working set: 185,752 distinct ids
# (seed 3) against 131,071 rows; each window's ~32,000 ids and the two
# planned ahead fit. With no free rows kept ahead (the watermark at 0; by
# default the consumer's drain evicts ahead, 164,867 rows in a run, and
# the planner then never has to), every eviction is the planner's:
# deferred on its thread, written back by the consumer's flush, and a
# missed key whose write-back is still pending moves instead of a pull.
PSCTR_EVICT_CAPACITY, PSCTR_EVICT_WATERMARK = 1 << 17, (0.0, 0.0)
# The recipe's windows learn for three windows and then oscillate, in the
# JAX package as in the port (tools/ctr_window_losses.py): the check is
# that the first PSCTR_FALLING windows' mean losses fall strictly.
PSCTR_FALLING = 3
# Whole windows profiled after a run (take, feeds, replay, drain, loss
# read, end_pass): the recipe's last ones.
PSCTR_PROFILE_WINDOWS = 3
# (d): a small WideAndDeep, the same windows on the card and on the CPU.
# Dense SGD: Adam turns summation-order noise in near-zero gradient
# components into steps of the rate's size, SGD moves each parameter by
# its gradient; float32 on both sides (TF32 off), so the runs differ only
# in summation order: the losses' relative difference, the dense
# parameters' relative L2 and the server rows' absolute difference.
PS_SMALL = dict(vocab=20_000, dim=16, slots=4, batch=128, hidden=(64, 32),
                k=4, windows=3)
PS_SMALL_LR = 0.05
PS_CARD_CPU_LOSS_REL, PS_CARD_CPU_PARAM_REL, PS_CARD_CPU_ROW_ABS = \
    2e-5, 2e-5, 1e-6
# (a): the Adam rule in numpy float32 against the server's (std::pow in
# the bias corrections may round differently from numpy's power).
PS_ADAM_REL = 1e-6
# (e): the fixture's cluster on the card: one server, two workers, sync.
PS_CLUSTER_STEPS = 200


def ps_dir(name):
    import os
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), PS_DIR,
                        name)
    os.makedirs(path, exist_ok=True)
    return path


def ps_server(ps, tables):
    srv = ps.PsServer(tables, port=0)
    cli = ps.PsClient([f"127.0.0.1:{srv.start()}"])
    for t in tables:
        if t.kind == "sparse":
            cli.register_sparse(t.table_id, t.dim)
    return srv, cli


def ps_close(srv, cli):
    cli.stop_servers()
    cli.close()
    srv.stop()


def ps_check(label, ok, failures, detail=""):
    log(f"  {label}{': ' + detail if detail else ''} "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        failures.append(f"phase 16 {label}")
    return ok


def ps_service(pt, failures):
    """(a): the native service: its build, fresh rows against the server's
    float32 rule (bitwise) and the reference's float64 mirror, a sparse
    Adam push against numpy, dense tables, a spilled table, a save/load
    round trip."""
    from paddle_tpu_torch import _native
    from paddle_tpu_torch.distributed import ps
    from paddle_tpu_torch.distributed.ps.embedding import (
        deterministic_init, server_init_rows)
    t0 = time.perf_counter()
    _native.lib()
    build_s = time.perf_counter() - t0
    log(f"  (a) PS service: g++ build {build_s:.2f} s "
        f"({'built' if _native.build_seconds else 'cached'}: "
        f"{_native.library_path()}); {card_line()}")
    work = ps_dir("service")

    def tables(spill):
        return [ps.TableConfig(1000, "sparse", 8, "sgd", lr=0.5,
                               init_range=0.2, seed=7),
                ps.TableConfig(1001, "sparse", 3, "adam", lr=0.1,
                               init_range=0.0),
                ps.TableConfig(0, "dense", 0, "sgd", lr=0.1),
                ps.TableConfig(1002, "sparse", 4, "sgd", lr=0.1,
                               init_range=0.1, seed=1000,
                               mem_budget_rows=64, spill_path=spill)]

    keys = np.arange(1, 4097, dtype=np.uint64) * np.uint64(7919)
    spill_keys = np.arange(500, dtype=np.uint64)
    adam_key = np.array([5], np.uint64)
    srv, cli = ps_server(ps, tables(f"{work}/spill_a"))
    out = {"build_s": build_s}
    try:
        rows = cli.pull_sparse(1000, keys)
        mirror = deterministic_init(7, keys, 8, 0.2)
        gap = float(np.abs(rows - mirror).max())
        ps_check("(a) 4096 fresh rows bitwise the server's float32 rule",
                 np.array_equal(rows, server_init_rows(7, keys, 8, 0.2)),
                 failures, f"the reference's float64 mirror within "
                 f"{gap:.3e}")
        p = np.zeros(3, np.float32)
        m, v = np.zeros(3, np.float32), np.zeros(3, np.float32)
        b1, b2, lr, eps = (np.float32(x) for x in (0.9, 0.999, 0.1, 1e-8))
        one = np.float32(1)
        for t in range(1, 4):
            g = np.full(3, t, np.float32)
            cli.push_sparse_grad(1001, adam_key, g.reshape(1, 3))
            m = b1 * m + (one - b1) * g
            v = b2 * v + (one - b2) * g * g
            bc1 = one - np.power(b1, np.float32(t))
            bc2 = one - np.power(b2, np.float32(t))
            p = p - lr * (m / bc1) / (np.sqrt(v / bc2) + eps)
        got = cli.pull_sparse(1001, adam_key)[0]
        rel = float(np.abs(got - p).max() / np.abs(p).max())
        ps_check("(a) three sparse Adam pushes against the numpy float32 "
                 "rule", rel <= PS_ADAM_REL, failures,
                 f"max rel {rel:.3e} (tol {PS_ADAM_REL:g})")
        cli.register_dense(0, 4)
        init = np.arange(4, dtype=np.float32)
        cli.pull_dense_init(0, init)
        cli.push_dense_grad(0, np.ones(4, np.float32))
        cli.push_dense_delta(0, np.full(4, 0.5, np.float32))
        want = init - np.float32(0.1) * np.float32(1) + np.float32(0.5)
        ps_check("(a) dense init, SGD push and delta",
                 np.array_equal(cli.pull_dense(0), want), failures)
        cli.push_sparse_grad(1002, spill_keys,
                             np.ones((500, 4), np.float32))
        in_mem, spilled, fails = cli.sparse_spill_info(1002)[0]
        spilled_rows = cli.pull_sparse(1002, spill_keys)
        ps_check("(a) spilled table: 500 rows past a 64-row budget, pulled "
                 "back bitwise", in_mem <= 64 and in_mem + spilled == 500
                 and fails == 0 and np.array_equal(
                     spilled_rows, server_init_rows(1000, spill_keys, 4, 0.1)
                     - np.float32(0.1)), failures,
                 f"{in_mem} in memory, {spilled} spilled")
        state = [cli.pull_sparse(1000, keys), cli.pull_sparse(1001, adam_key),
                 cli.pull_dense(0), spilled_rows]
        t0 = time.perf_counter()
        cli.save(f"{work}/snap")
        out["save_s"] = time.perf_counter() - t0
    finally:
        ps_close(srv, cli)
    srv, cli = ps_server(ps, tables(f"{work}/spill_b"))
    try:
        cli.register_dense(0, 4)
        t0 = time.perf_counter()
        cli.load(f"{work}/snap")
        out["load_s"] = time.perf_counter() - t0
        again = [cli.pull_sparse(1000, keys), cli.pull_sparse(1001, adam_key),
                 cli.pull_dense(0), cli.pull_sparse(1002, spill_keys)]
        ps_check("(a) save, a fresh server, load: every table bitwise",
                 all(np.array_equal(a, b) for a, b in zip(state, again)),
                 failures, f"save {out['save_s'] * 1e3:.1f} ms, load "
                 f"{out['load_s'] * 1e3:.1f} ms")
    finally:
        ps_close(srv, cli)
    return out


def ps_hbm_cache(pt, seed, failures):
    """(b): bench_hbm_cache at its sizes: the direct path (a TCP pull and
    push a batch) and the cached path (build_pass, then run_fused_pass as
    one CUDA graph replayed 30 times after a warm-up pass), the program
    bitwise against the same body run eagerly batch by batch, and the
    server rows bitwise the device rows after end_pass."""
    from paddle_tpu_torch.distributed import ps
    tables = [ps.TableConfig(t, "sparse", HBM_DIM, "sgd", lr=HBM_LR,
                             init_range=0.1, seed=1000)
              for t in (1000, 1001, 1002)]
    rng = np.random.RandomState(seed + 1600)
    batches = [rng.randint(0, HBM_VOCAB, HBM_BATCH).astype(np.int64)
               for _ in range(HBM_STEPS)]
    all_ids = np.concatenate(batches)
    srv, cli = ps_server(ps, tables)
    out = {}
    try:
        t0 = time.perf_counter()
        for ids in batches:
            keys = np.unique(ids).astype(np.uint64)
            rows = cli.pull_sparse(1000, keys)
            cli.push_sparse_grad(1000, keys, np.ones_like(rows))
        direct_s = time.perf_counter() - t0
        cache, twin = (ps.HbmEmbeddingCache(cli, t, HBM_DIM, HBM_CAPACITY,
                                            optimizer="sgd", lr=HBM_LR,
                                            device="cuda")
                       for t in (1001, 1002))
        t0 = time.perf_counter()
        staged = cache.build_pass(all_ids)
        build_s = time.perf_counter() - t0
        twin.build_pass(all_ids)

        def emb_loss(e):
            return e.sum()

        with deterministic_algorithms():
            t0 = time.perf_counter()
            first = cache.run_fused_pass(batches, emb_loss)
            first_s = time.perf_counter() - t0
            want = [twin._fused_pass(batches, emb_loss, None, program=False)
                    for _ in range(2)]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            timed = cache.run_fused_pass(batches, emb_loss)
            cached_s = time.perf_counter() - t0
        ps_check("(b) two fused passes (one CUDA graph) bitwise the same body "
                 "eager: losses and table",
                 np.array_equal(first, want[0])
                 and np.array_equal(timed, want[1])
                 and torch.equal(cache.table, twin.table), failures,
                 f"{len(cache._fused_progs)} program")
        n_dirty = cache.end_pass()
        keys = np.fromiter(cache._slots, np.uint64)
        slots = torch.tensor(list(cache._slots.values()),
                             device=cache.device)
        server = cli.pull_sparse(1001, keys)
        device = cache.table.index_select(0, slots).cpu().numpy()
        ps_check(f"(b) after end_pass the server's {keys.size} rows bitwise "
                 f"the device table's", np.array_equal(server, device),
                 failures, f"{n_dirty} rows written back")
        out = {"direct_ms_per_batch": direct_s / HBM_STEPS * 1e3,
               "cached_ms_per_batch": cached_s / HBM_STEPS * 1e3,
               "first_pass_s": first_s, "build_pass_s": build_s,
               "staged_rows": staged,
               "rows_per_batch": int(np.unique(batches[0]).size),
               "losses_finite": bool(np.isfinite(timed).all())}
        ps_check("(b) losses finite", out["losses_finite"], failures)
        log(f"  (b) bench_hbm_cache ({HBM_STEPS} batches of {HBM_BATCH} ids "
            f"over {HBM_VOCAB}, dim {HBM_DIM}, capacity {HBM_CAPACITY}): "
            f"direct {out['direct_ms_per_batch']:.3f} ms a batch (TCP pull + "
            f"push on loopback), cached {out['cached_ms_per_batch']:.3f} ms "
            f"a batch (one run_fused_pass, deterministic algorithms), "
            f"{direct_s / cached_s:.2f}x; build_pass {build_s:.3f} s for "
            f"{staged} rows; first pass (eager step, capture, replays) "
            f"{first_s:.3f} s (build_pass stages every id of the pass: "
            f"no miss can happen); {card_line()}")
        del cache, twin
    finally:
        ps_close(srv, cli)
    return out


def ps_ctr_arm(pt, batches, prefetch, seed, device="cuda", small=None,
               profile=False, capacity=PSCTR_CAPACITY,
               watermark=(0.0, 0.15)):
    """One run of train_ctr_windows on a fresh server: the losses, the
    dense parameters, the server's rows of every id after the flush and
    the run's figures. With ``profile``, PSCTR_PROFILE_WINDOWS whole
    windows of the same recipe run under the profiler after it."""
    import torch as _torch
    from paddle_tpu_torch import monitor
    from paddle_tpu_torch.distributed import ps
    from paddle_tpu_torch.distributed.ps.communicator import \
        SyncCommunicator
    from paddle_tpu_torch.distributed.ps.embedding import reset_registry
    from paddle_tpu_torch.models import ctr
    from paddle_tpu_torch.observability import tracing
    cfg = small or dict(vocab=CTR_VOCAB, dim=CTR_DIM, slots=CTR_SLOTS,
                        hidden=CTR_HIDDEN, k=PSCTR_K)
    reset_registry()
    srv, cli = ps_server(ps, [
        ps.TableConfig(1000, "sparse", cfg["dim"], "sgd",
                       lr=PSCTR_SPARSE_LR, init_range=0.05, seed=1000),
        ps.TableConfig(1001, "sparse", 1, "sgd", lr=PSCTR_SPARSE_LR,
                       init_range=0.05, seed=1001)])
    wb = ps.WriteBackQueue(cli)
    out = {}
    try:
        pt.seed(seed)
        model = ctr.WideAndDeep(cfg["vocab"], dim=cfg["dim"],
                                slots=cfg["slots"], hidden=cfg["hidden"],
                                cached=True, capacity=capacity,
                                optimizer="sgd", lr=PSCTR_SPARSE_LR,
                                writeback=wb, watermark=watermark,
                                device=device)
        if small is not None:
            model.load_state_dict(small["state"])
            opt = pt.optimizer.SGD(parameters=model.parameters(),
                                   learning_rate=PS_SMALL_LR)
        else:
            opt = pt.optimizer.Adam(parameters=model.parameters(),
                                    learning_rate=PSCTR_DENSE_LR)
        ps.bind_model(model, SyncCommunicator(cli, n_workers=1))
        step = ctr.build_ctr_scan_step(model, opt, cfg["k"])
        stats = ("hit", "miss", "evict", "deferred_evict", "resurrect")
        before = {k: monitor.stat_get(f"hbm_cache_{k}") for k in stats}
        tracing.enable(categories=["jit"])
        compile_ns = monitor.stat_get("jit_compile_ns")
        if device != "cpu":
            _torch.cuda.synchronize()
        t0 = time.perf_counter()
        r = ctr.train_ctr_windows(model, opt, batches, k=cfg["k"],
                                  prefetch=prefetch, depth=2, flush=True,
                                  step=step)
        if device != "cpu":
            _torch.cuda.synchronize()
        out["wall_s"] = time.perf_counter() - t0
        out["capture_ms"] = (monitor.stat_get("jit_compile_ns")
                             - compile_ns) / 1e6
        tracing.disable()
        out.update({k: monitor.stat_get(f"hbm_cache_{k}") - v
                    for k, v in before.items()})
        out.update(losses=np.asarray(r["losses"]), windows=r["windows"],
                   lookups=r["lookups"],
                   overlap_efficiency=r["overlap_efficiency"],
                   pull_ms=r["pull_s"] * 1e3, wait_ms=r["wait_s"] * 1e3)
        out["dense"] = [p.detach().cpu().clone() for p in model.parameters()]
        ids = np.unique(np.concatenate([b[0].ravel() for b in batches]))
        out["rows"] = [cli.pull_sparse(t, ids.astype(np.uint64))
                       for t in (1000, 1001)]
        caches = model.caches()
        out["device_rows_are_server_rows"] = all(
            np.array_equal(c.table.index_select(0, _torch.tensor(
                list(c._slots.values()), device=c.device)).cpu().numpy(),
                cli.pull_sparse(c.table_id, np.fromiter(c._slots, np.uint64)))
            for c in caches)
        out["cache_bytes"] = sum(
            t.numel() * t.element_size() for c in caches
            for t in (c.table, c.staged, c.delta, getattr(c, "m", None),
                      getattr(c, "v", None), getattr(c, "t", None))
            if t is not None)
        if device != "cpu":
            out["program_memory"] = step.memory_stats()
        if profile:
            tail = batches[-PSCTR_PROFILE_WINDOWS * cfg["k"]:]
            out["profile"] = profile_retry(lambda: ctr.train_ctr_windows(
                model, opt, tail, k=cfg["k"], prefetch=prefetch, depth=2,
                flush=True, step=step))
        del model, opt, step, caches
    finally:
        wb.stop(flush=False)
        ps_close(srv, cli)
    return out


def ps_resurrection(failures):
    """A directed deferred eviction and resurrection on the card (the
    reference's ``test_async_cache`` scenario): keys 1 and 2 trained, a
    planned window that evicts both with their deltas still on the card, a
    second plan that wants key 1 back before the first one's installs ran.
    Row 1 must move on the card with its local training, row 2's delta
    reach the server, and after end_pass the server hold row 1 as the
    card does, each bitwise in float32."""
    from paddle_tpu_torch import monitor
    from paddle_tpu_torch.distributed import ps
    from paddle_tpu_torch.distributed.ps.embedding import server_init_rows
    dim, lr = 4, np.float32(0.1)
    srv, cli = ps_server(ps, [ps.TableConfig(1000, "sparse", dim, "sgd",
                                             lr=0.1, init_range=0.1,
                                             seed=1000)])
    try:
        cache = ps.HbmEmbeddingCache(cli, 1000, dim, 7, optimizer="sgd",
                                     lr=0.1, device="cuda")
        cache.lookup(torch.tensor([[1, 2]], device="cuda")).sum().backward()
        cache.apply_grads()
        before = monitor.stat_get("hbm_cache_resurrect")
        plan1 = cache.plan_window(np.array([[3, 4, 5, 6, 7]], np.int64),
                                  bucket=8)
        deferred = 1 not in cache._slots and bool(cache._pending_evict)
        plan2 = cache.plan_window(np.array([[1]], np.int64), bucket=2)
        moved = 1 in cache._slots and bool(cache._pending_copy)
        plan2.feeds()
        row1 = cache.table[cache._slots[1]].cpu().numpy()
        init = server_init_rows(1000, np.array([1, 2], np.uint64), dim, 0.1)
        trained = init + (-lr)  # a gradient of ones, SGD on the card
        row2_server = cli.pull_sparse(1000, np.array([2], np.uint64))[0]
        cache.end_pass()
        row1_server = cli.pull_sparse(1000, np.array([1], np.uint64))[0]
        row1_after = cache.table[cache._slots[1]].cpu().numpy()
        plan1.release()
        plan2.release()
        n = monitor.stat_get("hbm_cache_resurrect") - before
        ps_check("(c) a directed resurrection on the card: key 1 evicted "
                 "with its delta pending, planned again, moved with its "
                 "training; key 2's delta on the server; after end_pass the "
                 "server's row 1 the card's (bitwise)",
                 deferred and moved and n == 1
                 and np.array_equal(row1, trained[0])
                 and np.array_equal(row2_server,
                                    init[1] + (trained[1] - init[1]))
                 and np.array_equal(row1_server, row1_after), failures,
                 f"deferred {deferred}, moved {moved}, resurrections {n}")
    finally:
        ps_close(srv, cli)


def ps_bench_ctr(pt, seed, failures):
    """(c): bench_ctr at its accelerator sizes through train_ctr_windows
    (prefetch on, depth 2, a WriteBackQueue and a SyncCommunicator): one
    timed run with torch's default algorithms (the one a user runs; whole
    windows of it profiled after), then two under deterministic
    algorithms, prefetch on and off, bitwise the same losses, dense
    parameters and server rows; then the same pair with a cache below the
    working set and no rows kept free ahead, whose planner evicts; then a
    directed resurrection."""
    from paddle_tpu_torch.models import ctr
    t0 = time.perf_counter()
    batches = ctr.synthetic_ctr_batches((PSCTR_WINDOWS + 1) * PSCTR_K,
                                        batch_size=CTR_BATCH,
                                        slots=CTR_SLOTS, vocab=CTR_VOCAB,
                                        seed=PSCTR_SEED)
    log(f"  (c) {len(batches)} batches of {CTR_BATCH} x {CTR_SLOTS} Zipf-1.2 "
        f"ids over {CTR_VOCAB} (seed {PSCTR_SEED}): "
        f"{time.perf_counter() - t0:.1f} s")
    timed = ps_ctr_arm(pt, batches, True, seed + 1610, profile=True)
    free_cuda()
    arms = {}
    with deterministic_algorithms():
        for capacity in (PSCTR_CAPACITY, PSCTR_EVICT_CAPACITY):
            for prefetch in (True, False):
                roomy = capacity == PSCTR_CAPACITY
                arms[capacity, prefetch] = ps_ctr_arm(
                    pt, batches, prefetch, seed + 1610, capacity=capacity,
                    profile=prefetch and roomy,
                    **({} if roomy else dict(
                        watermark=PSCTR_EVICT_WATERMARK)))
                free_cuda()
    k = PSCTR_K

    def means(a):
        return [float(a["losses"][i:i + k].mean())
                for i in range(0, len(a["losses"]), k)]

    def falling(a):
        m = means(a)[:PSCTR_FALLING]
        return all(x > y for x, y in zip(m, m[1:]))

    def same(a, b):
        return (np.array_equal(a["losses"], b["losses"])
                and all(torch.equal(x, y) for x, y in zip(a["dense"],
                                                          b["dense"]))
                and all(np.array_equal(x, y) for x, y in zip(a["rows"],
                                                             b["rows"])))

    runs = [timed, *arms.values()]
    ps_check(f"(c) {len(timed['losses'])} losses finite (all five runs), the "
             f"first {PSCTR_FALLING} windows' means falling strictly",
             all(bool(np.isfinite(a["losses"]).all()) and falling(a)
                 for a in runs), failures,
             "window means " + " ".join(f"{m:.4f}" for m in means(timed)))
    for capacity in (PSCTR_CAPACITY, PSCTR_EVICT_CAPACITY):
        on, off = arms[capacity, True], arms[capacity, False]
        cache = (f"capacity {capacity}" if capacity == PSCTR_CAPACITY else
                 f"capacity {capacity}, watermark {PSCTR_EVICT_WATERMARK}")
        ps_check(f"(c) {cache}: prefetch on bitwise prefetch off "
                 f"(deterministic algorithms): losses, dense parameters, "
                 f"the server's rows after the flush", same(on, off),
                 failures, f"{on['rows'][0].shape[0]} ids; evictions "
                 f"{on['evict']} / {off['evict']} (deferred "
                 f"{on['deferred_evict']} / {off['deferred_evict']}), "
                 f"resurrections {on['resurrect']} / {off['resurrect']}, "
                 f"hits {on['hit']} / {off['hit']}, misses {on['miss']} / "
                 f"{off['miss']}")
    ps_check("(c) device rows are the server's after the flush (all five "
             "runs)", all(a["device_rows_are_server_rows"] for a in runs),
             failures)
    small = [arms[PSCTR_EVICT_CAPACITY, p] for p in (True, False)]
    ps_check(f"(c) capacity {PSCTR_EVICT_CAPACITY} evicts through the "
             f"planner (deferred evictions in both runs)",
             all(a["evict"] > 0 and a["deferred_evict"] > 0 for a in small),
             failures)
    evict_gap = float(np.abs(small[0]["losses"]
                             - arms[PSCTR_CAPACITY, True]["losses"]).max())
    ps_resurrection(failures)

    def rate(a):
        return a["lookups"] / a["wall_s"]

    det = {f"{c}_{'on' if p else 'off'}": rate(a)
           for (c, p), a in arms.items()}
    log(f"  (c) bench_ctr: {timed['windows']} windows of {k} steps, "
        f"{timed['lookups']} lookups in {timed['wall_s']:.3f} s: "
        f"{rate(timed):.1f} lookups/s (deterministic algorithms, capacity "
        f"and prefetch: " + ", ".join(f"{n} {v:.1f}" for n, v in det.items())
        + f"); overlap efficiency {timed['overlap_efficiency']:.4f}, pull "
        f"{timed['pull_ms']:.1f} ms, wait {timed['wait_ms']:.1f} ms; hits "
        f"{timed['hit']}, misses {timed['miss']}, evictions "
        f"{timed['evict']}; capture {timed['capture_ms']:.1f} ms; cache "
        f"state {timed['cache_bytes'] / 1e6:.1f} MB; the evicting run's "
        f"losses against the roomy run's: max |diff| {evict_gap:.3e}; "
        f"{card_line()}")
    for label, st in timed["program_memory"].items():
        log(f"    captured program {label}: "
            + ", ".join(f"{k2} {v / 1e6:.1f} MB" for k2, v in st.items()))
    profs = {}
    for key, arm, how in (("default", timed, "default algorithms"),
                          ("deterministic", arms[PSCTR_CAPACITY, True],
                           "deterministic algorithms")):
        prof = report_profile(
            f"(c) {PSCTR_PROFILE_WINDOWS} whole windows after the run (take, "
            f"feeds, replay, drain, loss read, end_pass; {how})",
            arm["profile"], failures)
        if prof is not None:
            profs[key] = {k2: prof[k2] for k2 in
                          ("wall_ms", "busy_ms", "idle", "by_kind_ms")}
            profs[key]["top"] = prof["top"][:8]
    res = {key: timed[key] for key in (
        "wall_s", "capture_ms", "hit", "miss", "evict", "windows",
        "lookups", "overlap_efficiency", "pull_ms", "wait_ms",
        "cache_bytes", "program_memory")}
    res.update(lookups_per_s=rate(timed), lookups_per_s_deterministic=det,
               overlap_efficiency_deterministic=arms[
                   PSCTR_CAPACITY, True]["overlap_efficiency"],
               window_loss_means=means(timed),
               evicting={f"prefetch_{'on' if p else 'off'}": {
                   k2: arms[PSCTR_EVICT_CAPACITY, p][k2] for k2 in (
                       "hit", "miss", "evict", "deferred_evict",
                       "resurrect", "overlap_efficiency", "wall_s")}
                   for p in (True, False)},
               evicting_loss_gap=evict_gap, profile=profs)
    return res


def ps_card_vs_cpu(pt, seed, failures):
    """(d): the same small windows through the port on the card and on the
    CPU, from the same dense weights."""
    from paddle_tpu_torch.distributed.ps.embedding import reset_registry
    from paddle_tpu_torch.models import ctr
    c = PS_SMALL
    batches = ctr.synthetic_ctr_batches(c["windows"] * c["k"],
                                        batch_size=c["batch"],
                                        slots=c["slots"], vocab=c["vocab"],
                                        seed=PSCTR_SEED)
    reset_registry()
    pt.seed(seed + 1620)
    state = {k2: v.clone() for k2, v in ctr.WideAndDeep(
        c["vocab"], dim=c["dim"], slots=c["slots"], hidden=c["hidden"],
        cached=False, device="cpu").state_dict().items()}
    small = dict(c, state=state)
    card, cpu = (ps_ctr_arm(pt, batches, True, seed + 1620, device=dev,
                            small=small) for dev in ("cuda", "cpu"))
    loss_rel = float(np.abs(card["losses"] - cpu["losses"]).max()
                     / np.abs(cpu["losses"]).max())
    param_rel = max(float((a - b).norm() / b.norm())
                    for a, b in zip(card["dense"], cpu["dense"]))
    row_abs = max(float(np.abs(a - b).max())
                  for a, b in zip(card["rows"], cpu["rows"]))
    ps_check(f"(d) {len(cpu['losses'])} steps card vs CPU (vocab "
             f"{c['vocab']}, dim {c['dim']}, {c['slots']} slots, batch "
             f"{c['batch']}, hidden {c['hidden']}, k {c['k']})",
             loss_rel <= PS_CARD_CPU_LOSS_REL
             and param_rel <= PS_CARD_CPU_PARAM_REL
             and row_abs <= PS_CARD_CPU_ROW_ABS, failures,
             f"losses rel {loss_rel:.3e} (tol {PS_CARD_CPU_LOSS_REL:g}), "
             f"dense rel L2 {param_rel:.3e} (tol {PS_CARD_CPU_PARAM_REL:g}),"
             f" server rows abs {row_abs:.3e} (tol {PS_CARD_CPU_ROW_ABS:g}); "
             f"{card_line()}")
    return {"loss_rel": loss_rel, "param_rel_l2": param_rel,
            "row_abs": row_abs}


def ps_cluster(failures):
    """(e): one server process and two worker processes of
    ``testing.ps_fixture`` through the fleet in sync mode, the workers'
    dense math on the card; worker 0 saves the tables
    (``save_persistables``) after training."""
    import os
    root = os.path.dirname(os.path.abspath(__file__))
    snap = os.path.join(ps_dir("cluster"), "snap")

    def spawn(role, endpoint, wid=0):
        env = {k2: v for k2, v in os.environ.items()
               if not k2.startswith(("PADDLE_", "PS_"))}
        env.update(PYTHONPATH=root, PYTHONFAULTHANDLER="1", PS_ROLE=role,
                   PS_MODE="sync", PADDLE_PSERVER_ENDPOINTS=endpoint,
                   TRAINING_ROLE="PSERVER" if role == "server" else
                   "TRAINER", PADDLE_PSERVER_ID="0",
                   PADDLE_TRAINER_ID=str(wid), PADDLE_TRAINERS_NUM="2",
                   PS_FIX_DEVICE="cuda", PS_FIX_STEPS=str(PS_CLUSTER_STEPS),
                   PS_SAVE=snap)
        return subprocess.Popen(
            [sys.executable, "-m", "paddle_tpu_torch.testing.ps_fixture"],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            env=env, cwd=root)

    t0 = time.perf_counter()
    procs = [spawn("server", "127.0.0.1:0")]
    outs = []
    try:
        line = procs[0].stdout.readline()
        if not line.startswith("SERVER_READY"):
            raise RuntimeError(f"the PS server did not start: {line}"
                               + procs[0].stderr.read()[-3000:])
        endpoint = f"127.0.0.1:{line.split()[1]}"
        procs += [spawn("worker", endpoint, w) for w in (0, 1)]
        for w in procs[1:]:
            o, e = w.communicate(timeout=300)
            if w.returncode != 0:
                raise RuntimeError(f"a PS worker failed: {e[-3000:]}")
            outs.append(o)
        procs[0].wait(timeout=60)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    wall = time.perf_counter() - t0
    losses = [np.array([float(v) for v in re.findall(r"^LOSS \d+ (\S+)$", o,
                                                     re.M)]) for o in outs]
    digests = {m.group(1) for o in outs
               for m in [re.search(r"^PARAMS (\S+)$", o, re.M)] if m}
    saved = re.search(r"^SPARSE_SIZE (\d+)$", outs[0], re.M)
    rows = int(saved.group(1)) if saved else 0
    ok = (procs[0].returncode == 0 and rows > 0
          and os.path.getsize(snap + ".0") > 0
          and all(len(ls) == PS_CLUSTER_STEPS and np.isfinite(ls).all()
                  and ls[-10:].mean() < ls[:5].mean() for ls in losses)
          and len(digests) == 1)
    ps_check(f"(e) 1 server + 2 workers, sync, {PS_CLUSTER_STEPS} steps "
             f"through the fleet (workers on the card)", ok, failures,
             "losses " + ", ".join(f"{ls[:5].mean():.4f} -> "
                                   f"{ls[-10:].mean():.4f}" for ls in losses)
             + f", final dense parameters equal: {len(digests) == 1}; "
             f"snapshot of {rows} sparse rows, "
             f"{os.path.getsize(snap + '.0') if rows else 0} B; {wall:.1f} s; "
             f"{card_line()}")
    return {"seconds": wall, "snapshot_rows": rows,
            "loss_first5": [float(ls[:5].mean())
                                             for ls in losses],
            "loss_last10": [float(ls[-10:].mean()) for ls in losses]}


def phase16(pt, fa, seed, failures):
    """Phase 16: CTR through the parameter server. A part that raises is a
    failure and the next one still runs."""
    import os
    import shutil
    import traceback
    log("phase 16: CTR through the parameter server: the native service, "
        "bench_hbm_cache, bench_ctr, card vs CPU, the fleet's cluster")
    t_phase = time.perf_counter()
    out, launches = {}, {}
    for key, part in (("service", lambda: ps_service(pt, failures)),
                      ("hbm_cache", lambda: ps_hbm_cache(pt, seed, failures)),
                      ("bench_ctr", lambda: ps_bench_ctr(pt, seed, failures)),
                      ("card_vs_cpu", lambda: ps_card_vs_cpu(pt, seed,
                                                             failures)),
                      ("cluster", lambda: ps_cluster(failures))):
        t0 = time.perf_counter()
        fa.reset_launch_counts()
        try:
            out[key] = part()
        except Exception as e:  # noqa: BLE001 -- reported as a failure
            traceback.print_exc()
            failures.append(f"phase 16 ({key}) raised {type(e).__name__}: "
                            f"{e}")
        counts = flash_launches(fa)
        launches[f"ps_{key}"] = counts
        ok = not any(counts.values())
        log(f"  -- {key}: flash launches {counts} (none expected) "
            f"{'ok' if ok else 'FAIL'}; {time.perf_counter() - t0:.1f} s")
        if not ok:
            failures.append(f"phase 16 ({key}) launched flash kernels "
                            f"{counts}")
        free_cuda()
    shutil.rmtree(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                               PS_DIR), ignore_errors=True)
    out["seconds"] = time.perf_counter() - t_phase
    log(f"  phase 16: {out['seconds']:.1f} s; {card_line()}")
    log(json.dumps({"parameter_server": out}, default=str))
    return launches


def gpt_small_model(pt, seed):
    from paddle_tpu_torch.models.gpt import GPTForCausalLM, gpt_small
    pt.seed(seed)
    cfg = gpt_small(hidden_dropout=0.0, attention_dropout=0.0)
    return cfg, GPTForCausalLM(cfg, device="cuda")


def phase3(pt, fa, serving, seed, failures):
    """Phase 3: GPT-small served; returns the config, the model (phase 4
    trains it) and the forward's launches on the served path."""
    from paddle_tpu_torch.models.gpt import synthetic_lm_batch
    log("phase 3: GPT-small served through the engine (bf16, buckets 1, 4)")
    cfg, model = gpt_small_model(pt, seed)
    n_params = sum(p.numel() for p in model.parameters())
    log(f"  model: vocab {cfg.vocab_size} hidden {cfg.hidden_size} layers "
        f"{cfg.num_layers} heads {cfg.num_heads} seq {SEQ}, "
        f"{n_params} parameters")
    rows = [1, 3, 2, 2, 1]
    ids_all = synthetic_lm_batch(sum(rows), SEQ, cfg.vocab_size,
                                 seed=seed)
    offs = np.cumsum([0] + rows)
    ids_by_req = [ids_all[a:b] for a, b in zip(offs[:-1], offs[1:])]

    fa.reset_launch_counts()
    burst, stats, latency, results, (graph, off) = serve(
        model, serving, ids_by_req, [([None, SEQ], "int32")],
        (SEQ, cfg.vocab_size), (1, 4), failures)
    # the warm-up forwards run eagerly (the wrappers count them); the
    # served batches replay the captured graphs (their kernel nodes x
    # replays)
    warm = fa.flash_attention_fwd.launches
    warm_bf16 = fa.flash_attention_fwd.variant_launches["bf16"]
    replayed = graph["flash_attention_fwd"]
    served_launches = warm + replayed
    log(f"  engine stats after the burst: {burst}")
    log(f"  engine stats at the end: {stats}")
    if burst["batches_by_bucket"].get(4, 0) < 1:
        failures.append("no batch of the burst coalesced into bucket 4")
    if warm != cfg.num_layers * stats["warmup_runs"] or warm != warm_bf16:
        failures.append(f"warm-up flash launches {warm} ({warm_bf16} bf16) "
                        f"!= {cfg.num_layers} x {stats['warmup_runs']}")
    if replayed != cfg.num_layers * stats["batches"] or replayed == 0 \
            or any(off.values()) or graph["flash_attention_bwd_dq"] \
            or graph["flash_attention_bwd_dkv"]:
        failures.append(f"served flash launches from the graphs {graph} "
                        f"({off} off the bf16 variant) != {cfg.num_layers} "
                        f"x {stats['batches']} batches of the forward")
    log(f"  flash launches: {warm} in {stats['warmup_runs']} eager warm-up "
        f"forwards (wrappers, {warm_bf16} bf16) + {replayed} in "
        f"{stats['batches']} served batches (kernel nodes x replays of the "
        f"captured graphs, {off['flash_attention_fwd']} on the CUDA-core "
        f"variant) = {served_launches / max(stats['warmup_runs'] + stats['batches'], 1):g}"
        f" per forward; graph capture ms by bucket {stats['capture_ms']}")
    for bucket, times in latency.items():
        best = min(times)
        log(f"  bucket {bucket}: request latency ms {[round(t, 3) for t in times]}"
            f", tokens/s at best {bucket * SEQ / best * 1e3:.1f}")
    for bucket in stats["bucket_ladder"]:
        n = stats["batches_by_bucket"][bucket]
        if n:
            log(f"  bucket {bucket}: mean device step "
                f"{stats['device_ms_by_bucket'][bucket] / n:.3f} ms, mean "
                f"host copy {stats['copy_ms_by_bucket'][bucket] / n:.3f} ms "
                f"over {n} batches")

    # float32 engine vs the same model on the CPU, one 1-row request
    ids1 = ids_by_req[0][:1]
    with serving.Engine.from_layer(model, [([None, SEQ], "int32")],
                                   bucket_ladder=(1,), device="cuda") as e32:
        (got32,) = e32.predict(ids1)
    del e32  # its float32 snapshot of the model would outlive every phase
    model_cpu = copy.deepcopy(model).to("cpu").eval()
    with torch.inference_mode():
        want = model_cpu(torch.from_numpy(ids1)).numpy()
    del model_cpu
    rel_max = float(np.abs(got32 - want).max() / np.abs(want).max())
    ok = rel_max <= FP32_REL_MAX_TOL
    log(f"  fp32 engine (card) vs CPU forward: max|diff|/max|ref| = "
        f"{rel_max:.3e} (tol {FP32_REL_MAX_TOL:g}) {'ok' if ok else 'FAIL'}")
    if not ok:
        failures.append("fp32 engine disagrees with the CPU forward")
    got16 = results[0][:1]
    rel_l2 = float(np.linalg.norm(got16 - got32) / np.linalg.norm(got32))
    top1 = float((got16.argmax(-1) == got32.argmax(-1)).mean())
    ok = rel_l2 <= BF16_REL_L2_TOL
    log(f"  bf16 served vs fp32 logits: rel L2 = {rel_l2:.3e} (tol "
        f"{BF16_REL_L2_TOL:g}), top-1 agreement {top1:.4f} "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        failures.append("bf16 served logits outside the bf16 bound")

    return cfg, model, served_launches


def parse_phases(text):
    """``--phases``: a comma-separated list of phase numbers (1 always
    runs); None (every phase) when not given."""
    if text is None:
        return set(range(1, LAST_PHASE + 1))
    try:
        phases = {int(v) for v in text.split(",") if v.strip()}
    except ValueError:
        raise SystemExit(f"--phases: not a list of numbers: {text!r}")
    bad = sorted(n for n in phases if not 1 <= n <= LAST_PHASE)
    if bad:
        raise SystemExit(f"--phases: no phase {bad} (1-{LAST_PHASE})")
    return phases | {1}


LAST_PHASE = 16
TIMING_KEYS = ("ms", "device_ms", "plain_ms", "bound_ms", "bound_by",
               "library_ms", "max_abs_err")


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--phases", default=None,
                    help="comma-separated phase numbers to run (default: "
                    "all; phase 1 always runs)")
    args = ap.parse_args()
    phases = parse_phases(args.phases)

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    try:
        import paddle_tpu_torch as pt
        from paddle_tpu_torch import serving
        from paddle_tpu_torch.kernels import _build
        from paddle_tpu_torch.kernels import flash_attention as fa
        from paddle_tpu_torch.models.gpt import synthetic_lm_batch
    except ImportError as e:
        print(f"chip_smoke: the paddle_tpu_torch package is missing ({e})",
              file=sys.stderr)
        return 2
    # float32 products in full float32 on both sides of every comparison
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    failures = []

    def on(n, what):
        if n in phases:
            return True
        log(f"phase {n}: skipped ({what}; --phases {args.phases})")
        return False

    # ---- 1. device and build
    log(card_line())
    log(f"torch {torch.__version__} cuda {torch.version.cuda} device "
        f"{torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")
    t0 = time.perf_counter()
    _build.build(list(SOURCES))  # one nvcc per source, all at once
    log(f"kernel build: {time.perf_counter() - t0:.2f} s")
    for name in SOURCES:
        for line in ptxas_report(_build.build_log(name)):
            log(f"  ptxas {line}")
    names = [meta["name"] for meta in KERNELS]
    none = dict.fromkeys(names)

    # ---- 2. kernels vs their plain versions
    blank = dict.fromkeys(TIMING_KEYS)
    flash, flash_bwd = blank, {"dq": blank, "dkv": blank}
    f32_times, gpt3_shape = {n: {} for n in names}, none
    if on(2, "kernels vs plain versions"):
        log("phase 2: kernels vs plain versions on the card")
        gen = torch.Generator(device="cuda")
        gen.manual_seed(args.seed)
        flash = check_flash(fa, failures, gen)
        flash_bwd = check_flash_bwd(fa, failures, gen)
        f32_times = time_f32_variants(fa, gen)
        gpt3_shape = check_gpt3_shape(fa, failures, gen)

    # ---- 3. the served path
    model, served_launches = None, None
    if on(3, "GPT-small served"):
        cfg, model, served_launches = phase3(pt, fa, serving, args.seed,
                                             failures)

    # ---- 4. the trained path
    trained, trained_bf16, step_ms, eager_ms = none, none, {}, None
    if on(4, "GPT-small trained eagerly"):
        if model is None:
            cfg, model = gpt_small_model(pt, args.seed)
        log(f"phase 4: GPT-small trained, {TRAIN_STEPS} steps "
            f"({WARMUP_STEPS} warm-up) of {TRAIN_BATCH} x {SEQ} tokens, bf16 "
            f"AMP, AdamW with float32 masters")
        train_ids = synthetic_lm_batch(TRAIN_BATCH, SEQ, cfg.vocab_size,
                                       seed=args.seed + 1)
        trained, trained_bf16, step_ms, eager_ms = train(model, train_ids,
                                                         fa, failures)
    del model

    # ---- 5 and 6. BERT-base, float32 card vs CPU, then eager and k-step
    bert_rates = None
    if on(5, "BERT-base float32 card vs CPU, with phase 6") | on(
            6, "BERT-base bench recipe, with phase 5"):
        bert_rates = bert(pt, fa, args.seed, failures)

    # ---- 7. GPT-small through the k-step program
    kstep_launches, gpt_rate = none, None
    if on(7, "GPT-small k-step"):
        log(f"phase 7: GPT-small trained through to_static(one_step, "
            f"scan_steps={GPT_KSTEP}), {TRAIN_BATCH} x {SEQ} tokens a step, "
            f"phase 4's recipe")
        kstep_launches, gpt_rate = gpt_kstep(pt, fa, args.seed, eager_ms,
                                             failures)

    # ---- 8. data parallelism (ZeRO) and recompute, one-rank NCCL mesh
    zero_rates, zr_counted, zr_launches, zr_rate = None, none, none, None
    if on(8, "ZeRO and recompute"):
        zero_rates, zr_counted, zr_launches, zr_rate = phase8(
            pt, fa, args.seed, failures)

    # ---- 9. step checkpoints around the k-step programs
    ckpt, ck_counted, ck_launches, ck_gpt = None, {}, {}, None
    if on(9, "step checkpoints"):
        ckpt = phase9(pt, fa, args.seed, failures)
        ck_counted, ck_launches, ck_gpt = ckpt.pop("gpt_in_place",
                                                   ({}, {}, {}))

    # ---- 10. GPT-3 1.3B under the fleet's hybrid parallelism
    gpt3, gpt3_tp, gpt3_tp_rate, gpt3_ks, gpt3_ks_rate = (None, {}, None,
                                                          {}, None)
    if on(10, "GPT-3 1.3B hybrid"):
        gpt3 = phase10(pt, fa, args.seed, failures)
        gpt3_tp, gpt3_tp_rate = gpt3.pop("tensor_parallel", ({}, None))
        gpt3_ks, gpt3_ks_rate = gpt3.pop("kstep", ({}, None))

    # ---- 11. convolutional networks: ResNet-50 trained and served, LeNet
    vision, vision_launches = None, {}
    if on(11, "convolutional networks"):
        vision = phase11(pt, fa, args.seed, failures)
        vision_launches = vision.pop("flash_launches", {})

    # ---- 12. serving from saved artifacts
    artifacts, art_launches = None, {}
    if on(12, "serving from saved artifacts"):
        artifacts, art_launches = phase12(pt, fa, args.seed, failures)

    # ---- 13. YOLOv3 detection, BASELINE.md config 5
    detection, det_launches = None, {}
    if on(13, "YOLOv3 detection"):
        detection = phase13(pt, fa, args.seed, failures)
        det_launches = detection.pop("flash_launches", {})

    # ---- 14. the imperative surface
    surface_launches = {}
    if on(14, "the imperative surface"):
        surface_launches = phase14(pt, fa, args.seed, failures)

    # ---- 15. runtime services
    runtime_launches = {}
    if on(15, "runtime services"):
        runtime_launches = phase15(pt, fa, serving, args.seed, eager_ms,
                                   failures)

    # ---- 16. CTR through the parameter server
    ps_launches = {}
    if on(16, "CTR through the parameter server"):
        ps_launches = phase16(pt, fa, args.seed, failures)

    # ---- kernels line and result (a skipped phase's entries are null)
    timings = [flash, flash_bwd["dq"], flash_bwd["dkv"]]
    by_path = [{"serving": served_launches}, {}, {}]
    for paths, meta in zip(by_path, KERNELS):
        paths.update({path: (counts or {}).get(meta["name"])
                      for path, counts in art_launches.items()})
    kernels = []
    for meta, timing, paths in zip(KERNELS, timings, by_path):
        name = meta["name"]
        n = trained[name]
        f32 = f32_times[name]
        kernels.append(dict(
            {k: v for k, v in meta.items()
             if k not in ("variants", "cuda_core")},
            launches=n, **timing, step_device_ms=step_ms.get(name),
            launches_by_path=dict(
                paths, training=n, training_kstep_call=kstep_launches[name],
                zero3_recompute_first_call=zr_counted[name],
                zero3_recompute_kstep_call=zr_launches[name],
                checkpoint_first_call=ck_counted.get(name),
                checkpoint_restored_kstep_call=ck_launches.get(name),
                gpt3_1p3b_tensor_parallel_eager=gpt3_tp.get(name),
                gpt3_1p3b_kstep_call=gpt3_ks.get(name),
                **{path: counts.get(name)
                   for path, counts in vision_launches.items()},
                **{path: counts.get(name)
                   for path, counts in det_launches.items()},
                **{path: counts.get(name)
                   for path, counts in surface_launches.items()},
                **{f"runtime_{path}": counts.get(name)
                   for path, counts in runtime_launches.items()},
                **{path: counts.get(name)
                   for path, counts in ps_launches.items()}),
            gpt3_1p3b=gpt3_shape[name],
            variants={dt: dict(
                source=src,
                training_launches=(
                    None if n is None else trained_bf16[name] if dt == "bf16"
                    else n - trained_bf16[name]),
                **({} if dt == "bf16" else f32))
                      for dt, src in meta["variants"].items()},
            shape=[TRAIN_BATCH, SEQ, 12, 64], dtype="bf16"))
    log(json.dumps({"steps": {"bert_base": bert_rates,
                              "gpt_small_kstep": gpt_rate,
                              "gpt_small_eager_step_ms": eager_ms,
                              "bert_base_dp_arms": zero_rates,
                              "gpt_small_zero3_recompute": zr_rate,
                              "gpt3_1p3b_tensor_parallel_eager":
                                  gpt3_tp_rate,
                              "gpt3_1p3b_kstep": gpt3_ks_rate,
                              "gpt3_1p3b": gpt3, "vision": vision,
                              "detection": detection},
                    "artifacts": artifacts,
                    "checkpoints": None if ckpt is None else dict(
                        ckpt, gpt_small_in_place=ck_gpt)}))
    log(json.dumps({"kernels": kernels}))
    if failures:
        print("chip_smoke FAILED: " + "; ".join(failures), file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
