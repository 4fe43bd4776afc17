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
   larger world runs, at dp = 1): (a) BERT-base (6 of its 12 encoder
   layers since phase 17 came: ``ZERO_BERT_LAYERS``) with phase 6's recipe
   through ``to_static(one_step, scan_steps=20, dp_axis="dp")`` in nine
   arms, each against its control over two calls, bitwise unless a bound
   is stated: ZeRO-1, ZeRO-2, ZeRO-3 with prefetch on and off and
   ``enable_recompute`` full, selective and offload on every encoder layer
   against the replicated control; ZeRO-2 with ``accumulate_steps=4``
   against the accumulating control, with two witnesses: the same pair
   with float32 parameters (bitwise, under torch's deterministic
   algorithms) and a window that keeps only its last
   micro step (beyond the bound). Each arm's step time, tokens/s, MFU,
   working set, reserved memory, ``_zero_state_bytes`` and idle share; each
   ZeRO arm's collectives counted exactly (the memcpy nodes of its captured
   graph and what Python issued) against what its stage implies, with the
   profiler's count of one call beside. (b) GPT-small (4 of its 12 layers
   since phase 21 came, 2 since phase 22: ``ZERO_GPT_LAYERS``) with phase
   7's recipe,
   ZeRO-3, prefetch and full recompute on every block through
   ``to_static(scan_steps=10, dp_axis="dp")``, bitwise against the same
   program without either; a profiled replayed call must launch the bf16
   forward kernel 2 x layers x k times and dQ and dK/dV layers x k times
   (counted as in phase 7).
   (c) BERT-base (4 of its 12 layers since phase 21 came, 2 since phase
   22: ``DROPOUT_BERT_LAYERS``) with dropout 0.1 and full or selective
   recompute, bitwise against the same program without recompute; the
   attention gate writes out inputs the kernels do not take.
9. Step checkpoints (``checkpoint.CheckpointManager``) on the one-rank mesh,
   written to the card's machine's disk under the checkout: (a) BERT-base (6
   of its 12 encoder layers since phase 18 came, 2 since phase 21:
   ``CKPT_BERT_LAYERS``) with phase 6's recipe through ``to_static(one_step,
   scan_steps=20, dp_axis="dp")``, replicated, ZeRO-1, ZeRO-3 with prefetch
   and ZeRO-2 with ``accumulate_steps=4``: call 1, a save, everything freed,
   fresh objects from another seed, a restore and call 2, whose losses and
   parameters must be bitwise an uninterrupted run's; (b) GPT-small with
   phase 8b's program: a restore into the same objects, whose graph stays
   captured, replays calls 2 and 3 bitwise, with each kernel at phase 8b's
   count in the profiled call 3 (counted as in phase 7) and the step's time
   before and after the restore; (c) BERT-base (``DROPOUT_BERT_LAYERS``)
   with dropout 0.1 resumed bitwise, in place and into fresh objects (the
   generators' states ride the checkpoint); (d) a fault at every kill point
   of the checkpoint core never leaves a checkpoint that restores other than
   exactly the previous or the new state, and a flipped byte falls back to
   the previous step; (e) ``amp.GradScaler`` inside the captured program, a
   step with an inf skipped on the device, bitwise against the same eager
   steps and again after an in-place restore. Each save and restore: bytes,
   seconds, GB/s, the share of the copies between the card and the host, and
   the checkpoint spans.
10. GPT-3 1.3B (``gpt3_1p3b``: vocab 50304, hidden 2048, 16 heads, head
   dim 128, seq 1024; 6 of its 24 layers since phase 21 came:
   ``GPT3_LAYERS``; seeded random weights, dropout 0) under
   the fleet's hybrid parallelism on a one-rank NCCL world (``fleet.init``
   with every degree 1 and ``strategy.sharding``: one-rank groups on every
   axis, the code a larger world runs), with phase 4's recipe at GPT-3
   XL's rate on 8 x 1024 tokens a step: (a) the ``use_mp`` model under
   ``TensorParallel`` against the plain model from the same weights over
   two eager steps (losses and every gradient, bitwise), then 2 warm-up and
   5 timed eager steps, each kernel one launch a layer a step on the bf16
   variant;
   (b) the same step through ``to_static(one_step, scan_steps=4,
   dp_axis="dp")`` with ZeRO-1, bitwise against 4 eager steps, each kernel
   layers x 4 nodes in the replayed call (counted as in phase 7) and one
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
   after one copy (counted). (a) GPT-small (6 of its 12 layers since phase
   21 came: ``ART_GPT_LAYERS``) cast to bf16 at buckets 1 and 4
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
15. The runtime services on GPT-small (6 of its 12 layers since phase 21
   came, 3 since phase 22: ``RUNTIME_GPT_LAYERS``) with phase 4's recipe:
   (a) the
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
17. The nn layer library (``nn``'s layers and functionals, the
   schedulers, ``ops.sequence``): (a) Transformer-base (``nn.Transformer()``
   at its defaults, a shared 37,000 x 512 embedding scaled by sqrt(512)
   with sinusoid positions and tied to the output projection) on 128
   seeded sentence pairs a step (lengths in [16, 64], padded to 64), a
   padding mask and the causal mask, label smoothing 0.1 through
   ``label_smooth(one_hot(...))`` and a soft-label ``cross_entropy``,
   ``Adam(0.9, 0.98, 1e-9)`` over ``NoamDecay(512, 4000)``, bf16
   ``auto_cast``, dropout 0.1: eager steps, then two calls of
   ``to_static(one_step, scan_steps=4)`` with the scheduler stepped
   between calls, bitwise against the same eager steps (losses,
   parameters, moments; the dropout drawn inside the graph); step ms,
   target tokens/s, MFU (``nmt_flops``), capture ms, one profiled step and
   call; (b) beam search (beam 4, batch 32, at most 64 steps) of the
   trained model in float32 through ``BeamSearchDecoder`` and
   ``dynamic_decode`` over the decoder's (``Cache``, ``StaticCache``)
   states: the ids and lengths equal the CPU's from the same weights;
   decode ms and generated tokens/s; (c) a 6-layer ``TransformerEncoder``
   (d 512, 8 heads) at 8 x 1024 in bf16 without a mask: 6 forward, 6 dQ
   and 6 dK/dV flash launches a forward-backward, output and gradients
   within stated bounds of the same layers with an all-zero additive mask
   (the written-out branch); (d) Zaremba et al.'s large LSTM LM (vocab
   10,000, 2 x 1500, dropout 0.65, batch 20, unroll 35, SGD 1.0 under
   ``ClipGradByGlobalNorm(10.0)``): eager steps and two calls of
   ``to_static(scan_steps=4)`` bitwise, words/s; (e) every newly ported
   functional and layer on the card against the CPU in float32, and the
   draws' moments. No flash kernel may launch in (a), (b), (d), (e).
18. The rest of the parameter server (no hand-written kernel on these
   paths: each flash kernel's launches are counted and must be 0): (a) TDM
   retrieval at UserBehavior's size (Zhu et al., KDD 2018): a
   ``TreeIndex`` over item ids 1..4,162,024 (branch 2, height 23), its
   feeds checked on a 1/64 subtree against a per-node recomputation; the
   two-tower score of the JAX package's TDM test (987,994 users, node and
   user embeddings 24 wide, Adam) on 4 seeded batches of 1,024 (user,
   item) pairs from ``tdm_sampler`` (up to 6 negatives a layer), cycled
   for 20 steps; one step against the CPU, the losses falling; beam
   retrieval (beam 200) down the tree through ``tdm_child`` for 32 users,
   the children scored on the card, the ids against the CPU's; (b)
   GraphSAGE (Hamilton et al., NeurIPS 2017) through the graph PS at
   Reddit's size: 232,965 nodes with 602 float32 features, 41 planted
   classes, edges at the paper's average degree of 492 loaded through
   ``add_edges``; two mean aggregators (samples 25 and 10 through
   ``sample_khop``, 128 wide, self and neighbour halves concatenated),
   batch 512, Adam at 0.01, features pulled for unique ids: the sampler
   against ``deterministic_sample_indices`` on 1,000 nodes, one step
   against the CPU, 10 steps with the card's idle share; (c) the
   heterogeneous PS at bench_ctr's accelerator size: a host worker's
   ``SparseEmbedding`` over the PS (vocab 2,000,000, dim 64, 16 slots,
   batch 1024, Zipf-1.2 ids of seed 3) ships [1024, 1024] activations
   through ``HeterClient`` to a ``start_heter_server`` trainer whose deep
   tower (512, 256) runs forward, backward and SGD on the card, 30
   requests, bitwise against a control that calls the tower directly; (d)
   the seven CTR tail ops with their gradients, card against CPU; (e)
   ``HbmEmbeddingCache`` sharded over a one-rank NCCL mesh axis at phase
   16 (b)'s sizes, bitwise the unsharded cache.
19. The high-level training loop (``hapi``, ``io``, ``vision.transforms``,
   ``metric``; no hand-written kernel on these paths: each flash kernel's
   launches are counted and must be 0): (a) config 1, LeNet on the
   synthetic MNIST (4096 images, batch 64, 2 epochs, Adam) through
   ``Model(net).prepare(opt, CrossEntropyLoss(), Accuracy()).fit`` on two
   forked workers over the shared-memory rings, the first steps' losses
   against the same fit on the CPU, the accuracy above a floor, evaluate,
   predict and a save/load round trip predicting bitwise; (b) ResNet-50 at
   224, batch 64, float32, Momentum, fit by six workers running
   ``RandomCrop``, ``RandomHorizontalFlip``, ``ToTensor`` and ``Normalize``
   on seeded uint8 HWC images of 256-320 px, evaluated through ``Resize``
   and ``CenterCrop``: images/s of the whole fit, the steady step, the
   consumer's wait a batch and its share, the ring's MB/s, ``Resize`` ms an
   image, the captured graphs; (c) VGG-16 and MobileNetV2 at 224, batch
   64: fit steps, a predict, the first forward loss against the CPU; (d)
   ResNet-50 after ``convert_sync_batchnorm`` under ``DataParallel`` with
   ``Momentum`` under ZeRO-1 in the k-step program on a one-rank NCCL
   group, bitwise plain BatchNorm with the replicated ``Momentum``, and
   ``SyncBatchNorm``'s all-reduce path forced at one rank in a replayed
   CUDA graph against BatchNorm; (e) the transposed convolutions and
   ``max_pool2d_with_index``/``max_unpool2d`` after a ReLU (ties), card
   against CPU with their gradients, the mask equal.
20. The optimizer breadth, on the one-rank NCCL group (``fleet.init``):
   (a) GPT-small (float32 parameters, bf16 ``auto_cast``, 8 x 1024 tokens)
   through ``fleet.distributed_optimizer(Adam)`` with ``lamb``,
   ``gradient_merge`` (k_steps 2, avg) and ``amp``: the stack's names, one
   captured call of 4 micro-steps (two merged updates) bitwise the same
   eager micro-steps, the flash kernels 12 a micro-step (the wrappers'
   counts over the eager micro-steps, the graph's nodes over a replayed
   call), the first loss at batch 1 against the CPU, ms a micro-step
   against phase 7's; (b) BERT-base (``ZERO_BERT_LAYERS``) with bench.py's
   recipe as the k-step program, ``fuse_accumulators`` bitwise the plain
   AdamW, each arm's step ms, optimizer launches a step and elementwise
   share, and a fused checkpoint resumed bitwise into fresh objects; (c) a
   2-layer GPT at full width under each of the eleven optimizers and
   ``ModelAverage``, ``ExponentialMovingAverage`` and ``LookAhead(k=2)``:
   3 eager steps bitwise one captured call, the first update against the
   CPU's, and the eight elementwise optimizers under ZeRO-1/2/3 bitwise
   replicated; (d) ResNet-50 at 224, batch 64, float32, under
   ``strategy.dgc`` (Momentum to DGC, sparsity 0.999, rampup_begin_step 2)
   and ``strategy.lars``, a captured call across the rampup bitwise eager,
   step ms and DGC's top-k ms; (e) a 2-layer BERT pruned 2:4 by
   ``sparsity.prune_model`` through ``asp``, ``fp16_allreduce``,
   ``localsgd`` (k_steps 2) and ``sharding`` (stage 1), a captured call
   bitwise eager, every masked weight exactly 0 and ``check_sparsity``
   holding. (b), (d) and (e) launch no flash kernel (counted).
21. The smaller modules: (a) GPT-small at full width and depth with
   phase 4's recipe, every ``Linear`` (48) swapped by
   ``ImperativeQuantAware(weight_quantize_type="channel_wise_abs_max")``:
   eager QAT steps, each flash kernel 12 launches a step (bf16), the first
   loss against the unquantized model's from the same weights, the step's
   ms in turns with the plain step's (and phase 4's), a profiled QAT
   step's device-to-host copies at most the plain step's; (a2) a 2-layer
   GPT at full width, one float32 QAT step at 1 x 1024 card against CPU:
   the loss, the scales and every fake-quant level (one-level flips
   counted and bounded); (b) ResNet-50 at 224, float32, ``PTQ(abs_max)``
   over 4 x 16 seeded images, ``save_quantized_model``, served by
   ``inference.Predictor`` and ``serving.Engine(path)`` at buckets 1 and
   8: top-1 agreement with the float model >= 0.75 and mean relative logit
   gap < 0.5, the served logits against the frozen model's eager forward,
   the sidecar equal to ``quant_scales()``; ``percentile`` over 2 x 8
   and its host seconds; (c) ONNX: LeNet's file evaluated by the tests'
   numpy evaluator against the card's forward, ResNet-50's (batch 1, 224)
   nodes counted (53 ``Conv``), GPT-small refused naming the flash
   operator; (d) a BiLSTM-CRF tagger at Lample et al.'s widths on the
   synthetic Conll05st, a few SGD steps through ``linear_chain_crf``, the
   held-out loss card against CPU, ``crf_decoding`` and ``viterbi_decode``
   paths equal on both devices and across the two layouts; (e) the 19
   ``linalg`` functions batched in float32 and float64, the device ops of
   the op tail, the segment ops, ``softmax_mask_fuse(_upper_triangle)`` at
   [8, 12, 1024, 1024] in bf16 and float32 and the distributions, card
   against CPU; a custom op built with ``g++`` at run time, forward and
   backward against its formula, refused inside a CUDA-graph capture.
   Only (a) and (a2) launch flash kernels (counted).
22. The static graph: (a) GPT-small at full width and depth, bf16
   parameters, recorded into a ``static.Program`` (``static.data``,
   ``model.loss``, ``AdamW(multi_precision=True).minimize``) and trained
   by ``Executor.run`` (an eager warm-up step and the capture, then
   replays) against as many eager steps of an identical copy: losses and
   every parameter bitwise, each flash kernel 12 kernel nodes a replayed
   step (all bf16), one device-to-host copy a run, the step's ms in turns
   with the eager step's; (b) the float32 forward Program of GPT-small
   served by ``Engine.from_program(passes=("bf16",), bucket_ladder=(1,))``:
   bitwise ``Executor.run`` of the bf16-passed program, within the bf16
   bound of the float32 program, 12 bf16 forward launches a request;
   LeNet through ``save_inference_model`` -> ``load_inference_model`` ->
   ``Engine(path)`` at buckets 1 and 8 bitwise ``Executor.run``; (c)
   greedy decoding under ``to_static`` at the large LSTM LM's width
   (batch 32, 64 steps, a data-dependent ``while``): the warm-up's host
   read takes the AST fallback and the loop becomes a WHILE conditional
   node (``kernels/csrc/graph_while.cu``); its ids against the card's
   eager decode and the CPU's, a replay at half the length, the node's
   set-condition kernel's runs as the card counted them, and the memory of
   the graph and its body's pool returned when the program is dropped;
   Fibonacci loops (``a, b = a + b, a``, by ``while_loop`` and through
   dy2static) captured as WHILE nodes, exactly the host's; a Program with
   ``cond``, ``switch_case`` and a bounded differentiable ``while_loop``
   trained 3 steps, card against CPU at 1e-5, its branches IF nodes; the
   captured gradient of ``cond(f > 0, 2x, sqrt(x))`` at 0 the taken
   branch's; (d) the reference transpiler test's model, 12 sync steps
   with SGD and with Adam against a PS server of this process, within
   2e-4 of the local program on the card.
23. One JSON line with each phase's seconds beside the card's name and
   power limit, one JSON line with every kernel of the paths (the WHILE
   node's extension among them), then the result line.

Imports nothing of JAX and nothing of the JAX package.
"""
import argparse
import contextlib
import copy
import json
import math
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
    "flash_attention_bwd_dq_sm90", "flash_attention_bwd_dkv_sm90",
    "graph_while")}                                 # conditional nodes
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
# Phase 8a's thirteen BERT-base arms run 6 of BERT-base's 12 encoder
# layers (its widths, batch, seq and k unchanged) since the script took
# phase 17: of two whole runs at 12 layers (NVIDIA H100 80GB HBM3 at
# 700.00 W both), one took 879.8 s and the other, on a slower host,
# 1073.5 s, past the 1000 s the script is held to; phase 8a was the
# largest part (phase 8: 222.7 s of the 879.8).
ZERO_BERT_LAYERS = 6
# Phase 9a's four BERT-base arms run 6 of its 12 encoder layers too (its
# widths, batch, seq and k unchanged) since the script took phase 18: the
# whole script from a checkout of that slice ran 956.5 s of command (NVIDIA
# H100 80GB HBM3, 700.00 W), past the 950 s kept under the 1000 s limit;
# phase 9 was 129.0 s of it, most of that the 12-layer arms' programs,
# saves and restores. Since the script took phase 21 they run 4 (bitwise
# checks, whatever the depth): with phase 21 the whole run came to an
# estimated 977 s by the script's clock against the 950 s kept under the
# limit, phase 9 86.6 s of PR 18's 939.9 s; 2 since, for
# DROPOUT_BERT_LAYERS' reason.
CKPT_BERT_LAYERS = 2
# Phase 8b's GPT-small program (ZeRO-3, prefetch, full recompute), which
# phase 9b restores in place, runs 6 of its 12 layers at full width, batch,
# seq and k since the script took phase 21, for CKPT_BERT_LAYERS' reason:
# both are held bitwise against their controls at any depth; 4 since, for
# DROPOUT_BERT_LAYERS' reason; 2 since the script took phase 22 (the static
# graph, ~48 s alone), for the same 1000 s.
ZERO_GPT_LAYERS = 2
# ZeRO-2/3 accumulation windows fold float32 mean shards of each micro
# step, where the accumulating control sums the micro steps' gradients on
# the parameters, in their dtype (the reference's tolerance-level case).
# With float32 parameters both sums are float32, in one order at one rank,
# so that witness pair is held bitwise over every window, both arms under
# torch.use_deterministic_algorithms (deterministic_algorithms): BERT's
# token-type ids are all 0, so one embedding row takes all 8192 tokens'
# gradients, and torch's default CUDA embedding backward adds a row's
# partial sums in no fixed order (tools/embedding_determinism.py, on the
# H100 with torch 2.11: 3000 repeated calls on one gradient all differed
# from the first in default mode, none under deterministic algorithms).
# With float32 parameters that last ulp reaches the update: 5 of 40 runs
# of the float32 arms (the controls and ZeRO-2, with and without
# accumulation, 40 steps each) ended one ulp apart in one element of the
# token-type table, none of 40 under deterministic algorithms; the pair
# disagreed in one whole run of the script. A bf16 parameter hides it
# unless its master sits within that ulp of a bf16 rounding boundary, so
# the measured bf16 arms run as bench.py runs them. With bf16
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
# Phases 8c and 9c (BERT-base with dropout, recompute and resume, each held
# bitwise against its control, whatever the depth) run 4 of its 12 encoder
# layers since the script took phase 21: the final tree's whole runs took
# 1089.6 and 1031.0 s by the script's clock on slower hosts (894.3 s on a
# faster one; NVIDIA H100 80GB HBM3, 700.00 W), against the 950 s kept
# under the 1000 s limit and the runner's 1200 s. 2 since the script took
# phase 22 (the static graph, ~48 s alone), for the same 1000 s.
DROPOUT_BERT_LAYERS = 2


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
    cfg = bert_base(vocab_size=BERT_VOCAB, num_layers=ZERO_BERT_LAYERS,
                    hidden_dropout=0.0, attention_dropout=0.0)
    log(f"  BERT-base at {ZERO_BERT_LAYERS} of its 12 encoder layers "
        f"(ZERO_BERT_LAYERS), its widths, batch {BERT_BATCH} x {BERT_SEQ}")
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
             dict(accumulate=ZERO_ACCUM, fp32=True, measure=False,
                  deterministic=True), None),
            (f"ZeRO-2, {acc}, float32 parameters",
             dict(stage=2, accumulate=ZERO_ACCUM, fp32=True, measure=False,
                  deterministic=True), "accumulating float32"),
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
    mode = (deterministic_algorithms() if kw.pop("deterministic", False)
            else contextlib.nullcontext())
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    with mode:
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
    cfg = bert_base(vocab_size=BERT_VOCAB, num_layers=DROPOUT_BERT_LAYERS,
                    hidden_dropout=RECOMPUTE_DROPOUT,
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
    cfg = gpt_small(num_layers=ZERO_GPT_LAYERS, hidden_dropout=0.0,
                    attention_dropout=0.0)
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
    cfg = bert_base(vocab_size=BERT_VOCAB, num_layers=CKPT_BERT_LAYERS,
                    hidden_dropout=0.0, attention_dropout=0.0)
    log(f"  BERT-base at {CKPT_BERT_LAYERS} of its 12 encoder layers "
        f"(CKPT_BERT_LAYERS), its widths, batch {BERT_BATCH} x {BERT_SEQ}")
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
    cfg = gpt_small(num_layers=ZERO_GPT_LAYERS, hidden_dropout=0.0,
                    attention_dropout=0.0)
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
    cfg = bert_base(vocab_size=BERT_VOCAB, num_layers=DROPOUT_BERT_LAYERS,
                    hidden_dropout=RECOMPUTE_DROPOUT,
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
# Phase 10's GPT-3 1.3B runs 12 of its 24 layers (width, heads, batch, seq
# and k unchanged, every layer through the three flash kernels at head dim
# 128) since the script took phase 21: with it, the whole run came to an
# estimated 977 s by the script's clock (NVIDIA H100 80GB HBM3, 700.00 W),
# past the 950 s kept under the 1000 s limit; phase 10 was 47.9 s of PR
# 18's whole run, most of it the 24-layer eager, k-step and 1F1B arms; 6
# since, for DROPOUT_BERT_LAYERS' reason.
GPT3_LAYERS = 6
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
    return gpt3_1p3b(**dict(dict(num_layers=GPT3_LAYERS, hidden_dropout=0.0,
                                 attention_dropout=0.0), **kw))


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
# Phase 12's GPT-small artifacts, (a) and (b), hold 6 of its 12 layers at
# full width and seq, each through the flash forward, since the script
# took phase 21: the whole run's 939.9 s (PR 18's final tree, NVIDIA H100
# 80GB HBM3 at 700.00 W) left no room for it under 950 s, and phase 12
# was 107.4 s of it, most of that GPT-small's saves, engines and CPU
# forwards. (a) and (b) are held within bounds (BF16_REL_L2_TOL,
# FP32_REL_MAX_TOL) whose rounding grows with depth, so this path keeps
# its 6 layers when the script takes later phases.
ART_GPT_LAYERS = 6

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
    cfg = gpt_small(num_layers=ART_GPT_LAYERS, hidden_dropout=0.0,
                    attention_dropout=0.0)
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


def max_rel(card, cpu, dtype=torch.float32):
    """max |card - cpu| / max |cpu| (tensors or arrays; in ``dtype``, on
    the CPU)."""
    a = torch.as_tensor(card).detach().to("cpu", dtype)
    b = torch.as_tensor(cpu).detach().to("cpu", dtype)
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
# Phase 15's GPT-small (parts (a)-(e)) runs 6 of its 12 layers, at full
# width, batch, seq and k, every layer still through the three flash
# kernels, since the script took phase 21: PR 18's final whole run took
# 939.9 s by the script's clock against the 950 s kept under the 1000 s
# limit (NVIDIA H100 80GB HBM3, 700.00 W), and phase 15 was 99.0 s of it.
# 3 since the script took phase 22 (the static graph, ~48 s alone): its
# arms hold observers on against off at tolerance 0, at any depth.
RUNTIME_GPT_LAYERS = 3


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
    log(f"  (b) the eager step with no observer {med['off']:.3f} ms "
        f"({base.config.num_layers} layers); phase 4's eager step (12) "
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
        poisoned = f"gpt.blocks.{RUNTIME_GPT_LAYERS - 1}.fc1.weight"
        w = dict(bad.named_parameters())[poisoned]
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
        log(f"  (c) NaN in {poisoned}: "
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
    cfg, model = gpt_small_model(pt, seed + 1530, RUNTIME_GPT_LAYERS)
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
    cfg, model = gpt_small_model(pt, seed + 1540, RUNTIME_GPT_LAYERS)
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
    cfg, base = gpt_small_model(pt, seed + 1500, RUNTIME_GPT_LAYERS)
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


# ---- phase 17: the nn layer library ---------------------------------------------

# (a) Transformer-base NMT (Vaswani et al., 2017): nn.Transformer() at its
# defaults, one shared 37,000 x 512 embedding (the paper's shared BPE
# vocabulary, section 5.1) scaled by sqrt(512) with sinusoid positions and
# tied to the output projection; 128 sentence pairs a step, each side's
# lengths drawn in [16, 64] and padded to 64 with id 0; label smoothing 0.1
# (section 5.4); Adam(0.9, 0.98, 1e-9) over NoamDecay(512, 4000) (section
# 5.3); bf16 auto_cast.
NMT_VOCAB, NMT_D, NMT_BATCH, NMT_LEN = 37_000, 512, 128, (16, 64)
NMT_PAD, NMT_BOS, NMT_EOS = 0, 1, 2
NMT_SMOOTHING, NMT_WARMUP = 0.1, 4000
NMT_K = 4               # inner steps of the k-step program; 2 calls compared
NMT_TIMED = (5, 3)      # eager steps timed, k-step calls timed
# (b) beam search over the trained model in float32, card against CPU.
BEAM, BEAM_BATCH, BEAM_STEPS = 4, 32, 64
# (c) the flash kernels through MultiHeadAttention: a 6-layer
# TransformerEncoder (d 512, 8 heads, head dim 64, dropout 0) at 8 x 1024,
# bf16, no mask, against the same layers with an all-zero additive mask
# (the written-out branch). The written-out branch rounds its logits and
# probabilities to bf16, the kernels keep them in float32: the bounds are
# relative L2, the output's and every gradient's together (the input's and
# the parameters', but the key projections' biases, whose gradient is
# exactly zero: softmax cancels a key bias, so both sides hold rounding
# noise there). The CPU's plain twin of the kernels against the written-out
# bf16 branch, 6 layers at 1 x 1024: 6.0e-3 and 4.8e-2.
ENC_LAYERS, ENC_BATCH, ENC_SEQ = 6, 8, 1024
ENC_OUT_REL, ENC_GRAD_REL = 2e-2, 1e-1
# (d) the "large" LSTM language model of Zaremba et al., 2014
# (arXiv:1409.2329): vocab 10,000, Embedding -> 2-layer LSTM(1500,
# dropout 0.65) -> Linear, batch 20, unroll 35, SGD at 1.0 with
# ClipGradByGlobalNorm(10.0), float32; each batch starts from zero states.
LM_VOCAB, LM_HIDDEN, LM_BATCH, LM_UNROLL = 10_000, 1500, 20, 35
LM_DROPOUT, LM_CLIP, LM_K = 0.65, 10.0, 4
LM_TIMED = (5, 3)
# (e) every new layer and functional, card against CPU, float32 (TF32 off):
# max |card - cpu| / max |cpu| of each output and each gradient.
NN_FWD_TOL, NN_GRAD_TOL = 1e-5, 1e-4
NN_DEVICE = "cuda"  # the card; its CPU twin in (b) and (e) is "cpu"


def sinusoid(n, d):
    """The Transformer's position table [n, d]: sin on even, cos on odd
    columns."""
    pos = np.arange(n)[:, None]
    ang = pos / np.power(10000.0, 2 * np.arange(d // 2)[None, :] / d)
    out = np.zeros((n, d), np.float32)
    out[:, 0::2], out[:, 1::2] = np.sin(ang), np.cos(ang)
    return torch.from_numpy(out)


def nmt_model(pt, device, **kw):
    """Transformer-base with a shared, scaled embedding and a tied output
    projection, from the package's public names."""
    from paddle_tpu_torch import nn
    from paddle_tpu_torch.nn import functional as F

    class NMT(nn.Layer):
        def __init__(self):
            super().__init__()
            # N(0, d^-1/2): the usual start of a shared embedding scaled
            # by sqrt(d) (tensor2tensor, fairseq)
            self.emb = nn.Embedding(NMT_VOCAB, NMT_D, device=device,
                                    weight_attr=pt.ParamAttr(
                                        initializer=nn.initializer.Normal(
                                            0.0, NMT_D ** -0.5)))
            self.transformer = nn.Transformer(device=device, **kw)
            self.register_buffer("pos", sinusoid(256, NMT_D).to(device),
                                 persistable=False)

        def embed(self, ids, start=0):
            x = self.emb(ids) * NMT_D ** 0.5
            return x + self.pos[start:start + ids.shape[1]].to(x.dtype)

        def logits(self, h):
            return F.linear(h, self.emb.weight.T)

        def forward(self, src, tgt_in, src_mask, tgt_mask):
            h = self.transformer(self.embed(src), self.embed(tgt_in),
                                 src_mask, tgt_mask, src_mask)
            return self.logits(h)

    return NMT()


def pad_mask(src):
    """The additive [B, 1, 1, S] mask of the padding."""
    return torch.where(src == NMT_PAD, -1e9, 0.0)[:, None, None, :]


def nmt_batches(seed, n, batch=NMT_BATCH):
    """n batches of (src [B, 64], tgt [B, 65]): ids in [3, vocab), each
    side's length drawn in [16, 64] and padded with 0; tgt starts with
    BOS (its input is tgt[:, :-1], its labels tgt[:, 1:])."""
    r = np.random.RandomState(seed)
    lo, hi = NMT_LEN
    out = []
    for _ in range(n):
        src = r.randint(3, NMT_VOCAB, (batch, hi))
        tgt = r.randint(3, NMT_VOCAB, (batch, hi + 1))
        tgt[:, 0] = NMT_BOS
        for row, (ls, lt) in enumerate(zip(r.randint(lo, hi + 1, batch),
                                           r.randint(lo, hi + 1, batch))):
            src[row, ls:] = NMT_PAD
            tgt[row, lt + 1:] = NMT_PAD
        out.append((src, tgt))
    return out


def nmt_flops(model, src_len, tgt_len, batch):
    """FLOP of one step over the padded batch: 6 x (the encoder's matrices
    x source tokens + the decoder's x target tokens + the tied projection
    d x V x target tokens) + the attention products, 12 x d x (6 S^2 + 6
    T^2 + 6 T S) x batch (2 x 2 products forward, 3x with the backward)."""
    t = model.transformer
    mats = lambda m: sum(p.numel() for n, p in m.named_parameters()  # noqa
                         if p.dim() == 2)
    s_tok, t_tok = batch * src_len, batch * tgt_len
    enc, dec = t.encoder.num_layers, t.decoder.num_layers
    attn = 12 * NMT_D * batch * (enc * src_len ** 2 + dec * tgt_len ** 2
                                 + dec * tgt_len * src_len)
    return (6 * (mats(t.encoder) * s_tok + mats(t.decoder) * t_tok
                 + NMT_D * NMT_VOCAB * t_tok) + attn)


def nmt_loss(pt, logits, labels):
    """Label smoothing 0.1 as ``label_smooth(one_hot(...))`` into a
    soft-label cross entropy, the padding weighted out, over the real
    target tokens."""
    from paddle_tpu_torch.nn import functional as F
    with pt.amp.auto_cast(enable=True, dtype="bfloat16"):
        soft = F.label_smooth(F.one_hot(labels, NMT_VOCAB),
                              epsilon=NMT_SMOOTHING)
        per = F.cross_entropy(logits, soft, soft_label=True,
                              reduction="none")
    weight = (labels != NMT_PAD).float()
    return (per * weight).sum() / weight.sum()


def nmt_step(pt, model, opt, causal):
    def one_step(src, tgt):
        with pt.amp.auto_cast(enable=True, dtype="bfloat16"):
            logits = model(src, tgt[:, :-1], pad_mask(src), causal)
        loss = nmt_loss(pt, logits, tgt[:, 1:])
        loss.backward()
        opt.step()
        opt.clear_grad()
        return loss
    return one_step


def nmt_loss_ms(pt, tgt):
    """The label-smoothed loss's forward and backward alone, from bf16
    logits of the step's shape (CUDA events over 5 calls)."""
    labels = tgt[:, 1:]
    logits = torch.randn(*labels.shape, NMT_VOCAB, device=labels.device,
                         dtype=torch.bfloat16, requires_grad=True)

    def run():
        nmt_loss(pt, logits, labels).backward()
        logits.grad = None

    if labels.device.type != "cuda":
        return None
    return cuda_time_ms(run, 5, warmup=1)


def nn_transformer_base(pt, fa, seed, failures):
    """(a): Transformer-base trained eagerly and through the k-step
    program, bitwise over two calls with dropout 0.1 drawn inside the
    graph; returns the trained model and the numbers."""
    from paddle_tpu_torch import jit, monitor, optimizer
    from paddle_tpu_torch.observability import tracing
    pt.seed(seed + 170)
    base = nmt_model(pt, NN_DEVICE)
    n_params = sum(p.numel() for p in base.parameters())
    batches = nmt_batches(seed + 171, NMT_K)
    real = [int((t[:, 1:] != NMT_PAD).sum()) for _, t in batches]
    log(f"  Transformer-base: {n_params} parameters (the embedding shared "
        f"and tied), {NMT_BATCH} pairs a step padded to {NMT_LEN[1]}, "
        f"real tokens a step: source "
        f"{int((batches[0][0] != NMT_PAD).sum())}, target {real[0]}")
    causal = pt.core.tensor.unwrap(
        pt.nn.Transformer.generate_square_subsequent_mask(NMT_LEN[1],
                                                          device=NN_DEVICE))
    dev = [(torch.from_numpy(s).to(NN_DEVICE),
            torch.from_numpy(t).to(NN_DEVICE)) for s, t in batches]

    def arm(model):
        sched = optimizer.lr.NoamDecay(d_model=NMT_D,
                                       warmup_steps=NMT_WARMUP)
        opt = optimizer.Adam(learning_rate=sched, beta1=0.9, beta2=0.98,
                             epsilon=1e-9, parameters=model.parameters())
        return nmt_step(pt, model, opt, causal), sched, opt

    eager_model, program_model = copy.deepcopy(base), base
    eager_step, eager_sched, eager_opt = arm(eager_model)
    body, sched, opt = arm(program_model)
    program = jit.to_static(body, scan_steps=NMT_K)
    stacked = [torch.stack([d[j] for d in dev[:NMT_K]]) for j in (0, 1)]
    pt.seed(seed + 172)  # the dropout draws of the eager steps
    want = []
    for call in range(2):  # the scheduler steps between calls, both sides
        want += [eager_step(*dev[i]).detach() for i in range(NMT_K)]
        eager_sched.step()
    pt.seed(seed + 172)  # the same draws inside the graph
    got = []
    tracing.enable(categories=["jit"])  # the capture's jit_compile_ns
    compile_ns = monitor.stat_get("jit_compile_ns")
    try:
        out, peak = first_kstep_call("Transformer-base k-step",
                                     lambda: program(*stacked))
    finally:
        capture_ms = (monitor.stat_get("jit_compile_ns") - compile_ns) / 1e6
        tracing.disable()
    got.append(out)
    sched.step()
    got.append(program(*stacked))
    sched.step()
    compare_runs(f"Transformer-base, dropout 0.1, 2 calls of "
                 f"scan_steps={NMT_K}", torch.stack(want), torch.cat(got),
                 eager_model, program_model, failures, eager_opt, opt)
    # timing: eager steps, then calls of the program
    flops = nmt_flops(base, NMT_LEN[1], NMT_LEN[1], NMT_BATCH)
    toks = real[0]
    _, tel_e, peak_e = timed_eager(lambda: eager_step(*dev[0]),
                                   NMT_TIMED[0] + 1, 1, toks, flops / toks)
    eager = log_rate("Transformer-base eager", tel_e, 1, flops / toks,
                     peak_e, report_profile(
                         "eager Transformer-base step", profile_retry(
                             lambda: eager_step(*dev[0]).item()),
                         failures))
    calls, tel = timed_kstep(lambda: program(*stacked), NMT_K, NMT_TIMED[1],
                             toks, flops / toks)
    prof = report_profile(f"k-step Transformer-base call ({NMT_K} steps)",
                          profile_retry(lambda: program(*stacked).cpu()),
                          failures)
    kstep = log_rate(f"Transformer-base k-step (scan_steps={NMT_K}, CUDA "
                     f"graph)", tel, NMT_K, flops / toks, peak, prof)
    losses = torch.cat([g.cpu() for g in got] + calls)
    ok = bool(torch.isfinite(losses).all())
    loss_ms = nmt_loss_ms(pt, dev[0][1])
    log(f"  Transformer-base: FLOP a step {flops:.4e} (the padded batch; "
        f"formula in nmt_flops), target tokens/s counts the {toks} real "
        f"target tokens a step; capture {fmt_ms(capture_ms)}; the loss "
        f"alone (one_hot, label_smooth, the soft-label cross entropy and "
        f"their backward from bf16 logits) {fmt_ms(loss_ms)} a step; "
        f"losses finite {ok} (first {float(losses[0]):.4f}, last "
        f"{float(losses[-1]):.4f})")
    if not ok:
        failures.append("phase 17 (a): Transformer-base losses not finite")
    del eager_model, eager_step, program, body
    return program_model, {"parameters": n_params, "flop_a_step": flops,
                           "real_target_tokens": toks, "eager": eager,
                           "kstep": kstep, "capture_ms": capture_ms,
                           "loss_ms": loss_ms}


def beam_cell(model):
    """The decoder of ``model`` as a beam-search cell over the states
    [memory mask, per-layer (Cache, StaticCache)]."""
    def cell(inputs, states):
        mask, caches = states
        step = caches[0][0].k.shape[1]
        x = inputs * NMT_D ** 0.5 + model.pos[step:step + 1].to(inputs.dtype)
        out, new = model.transformer.decoder(x[:, None], None, None, mask,
                                             caches)
        return out[:, 0], [mask, new]
    return cell


def beam_decode(pt, model, src):
    """Beam search (BEAM wide, BEAM_STEPS at most) of ``src`` through
    ``model``'s decoder with its caches: (ids [B, T, beam], scores,
    lengths)."""
    nn = pt.nn
    with torch.no_grad():
        mask = pad_mask(src)
        memory = model.transformer.encoder(model.embed(src), mask)
        caches = [(layer.self_attn.gen_cache(memory),
                   layer.cross_attn.gen_cache(
                       memory, type=nn.MultiHeadAttention.StaticCache))
                  for layer in model.transformer.decoder.layers]
        dec = nn.BeamSearchDecoder(beam_cell(model), NMT_BOS, NMT_EOS, BEAM,
                                   embedding_fn=model.emb,
                                   output_fn=model.logits)
        (ids, scores), _, lengths = nn.dynamic_decode(
            dec, [mask, caches], max_step_num=BEAM_STEPS)
    return ids, scores, lengths


def nn_beam(pt, model, seed, failures):
    """(b): the trained model beam-decodes on the card in float32; the
    same decode on the CPU from the same weights gives the same ids."""
    model.eval()
    src = torch.from_numpy(nmt_batches(seed + 173, 1, BEAM_BATCH)[0][0])
    beam_decode(pt, model, src.to(NN_DEVICE))  # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ids, scores, lengths = beam_decode(pt, model, src.to(NN_DEVICE))
    torch.cuda.synchronize()
    ms = 1e3 * (time.perf_counter() - t0)
    steps = ids.shape[1]
    generated = BEAM_BATCH * BEAM * steps
    t0 = time.perf_counter()
    cpu_model = copy.deepcopy(model).to("cpu")
    want = beam_decode(pt, cpu_model, src)
    cpu_s = time.perf_counter() - t0
    del cpu_model
    same = torch.equal(ids.cpu(), want[0])
    rows = int((ids.cpu() == want[0]).all(-1).all(-1).sum())
    score_diff = float((scores.cpu() - want[1]).abs().max())
    ok = same and torch.equal(lengths.cpu(), want[2])
    log(f"  beam search (beam {BEAM}, batch {BEAM_BATCH}, at most "
        f"{BEAM_STEPS} steps), float32: {steps} steps in {ms:.1f} ms on the "
        f"card ({generated / ms * 1e3:.1f} generated tokens/s, beam x "
        f"batch x steps); ids equal the CPU's: {same} ({rows} of "
        f"{BEAM_BATCH} rows), lengths equal, scores max |diff| "
        f"{score_diff:.3e}; the CPU's decode {cpu_s:.1f} s "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        failures.append("phase 17 (b): the card's beam-decoded ids differ "
                        "from the CPU's")
    return {"decode_ms": ms, "steps": steps,
            "generated_tokens_per_s": generated / ms * 1e3,
            "rows_equal": rows, "score_max_abs_diff": score_diff}


def nn_flash_encoder(pt, fa, seed, failures):
    """(c): a 6-layer TransformerEncoder at 8 x 1024 in bf16 without a
    mask launches 6 forward, 6 dQ and 6 dK/dV flash kernels a
    forward-backward step, and agrees with the same layers given an
    all-zero additive mask (the written-out branch)."""
    from paddle_tpu_torch import nn
    pt.seed(seed + 174)
    enc = nn.TransformerEncoder(nn.TransformerEncoderLayer(
        NMT_D, 8, 2048, dropout=0.0, device=NN_DEVICE), ENC_LAYERS)
    with torch.no_grad():  # the stack's copies start alike: set them apart
        for p in enc.parameters():
            p.add_(0.02 * torch.randn(p.shape, device=NN_DEVICE,
                                      generator=pt.core.random
                                      .default_generator(NN_DEVICE)))
    enc = enc.to("bfloat16")
    gen = torch.Generator(device=NN_DEVICE)
    gen.manual_seed(seed + 175)
    x = torch.randn(ENC_BATCH, ENC_SEQ, NMT_D, device=NN_DEVICE,
                    generator=gen).to(torch.bfloat16)
    cot = torch.randn(x.shape, device=NN_DEVICE, generator=gen).to(x.dtype)
    zero = torch.zeros(1, 1, 1, ENC_SEQ, device=NN_DEVICE, dtype=x.dtype)
    names = ["input"] + [n for n, _ in enc.named_parameters()]

    def step(mask):
        xi = x.clone().requires_grad_(True)
        out = enc(xi, mask)
        grads = torch.autograd.grad((out.float() * cot.float()).sum(),
                                    [xi] + enc.parameters())
        return out, grads

    step(None)  # warm-up
    fa.reset_launch_counts()
    out, grads = step(None)
    counts = flash_launches(fa)
    want_out, want_grads = step(zero)
    written = flash_launches(fa)
    keep = [i for i, n in enumerate(names) if not n.endswith("k_proj.bias")]

    def flat(gs):
        return torch.cat([gs[i].float().flatten() for i in keep])

    out_rel = rel_l2(out.detach().float().cpu(),
                     want_out.detach().float().cpu())
    grad_rel = rel_l2(flat(grads).cpu(), flat(want_grads).cpu())
    want = {meta["name"]: ENC_LAYERS for meta in KERNELS}
    ok = (counts == want and written == counts and out_rel <= ENC_OUT_REL
          and grad_rel <= ENC_GRAD_REL)
    ms = cuda_time_ms(lambda: step(None), 5, warmup=1)
    log(f"  seq-{ENC_SEQ} encoder ({ENC_LAYERS} layers, {ENC_BATCH} x "
        f"{ENC_SEQ}, d {NMT_D}, 8 heads, bf16, no mask): flash launches a "
        f"forward-backward {counts} (want {ENC_LAYERS} each); with the "
        f"zero mask none more ({written}); against the written-out branch "
        f"output rel L2 {out_rel:.3e} (tol {ENC_OUT_REL:g}), gradients rel "
        f"L2 {grad_rel:.3e} (tol {ENC_GRAD_REL:g}); forward-backward "
        f"{ms:.3f} ms {'ok' if ok else 'FAIL'}")
    if not ok:
        failures.append(f"phase 17 (c): the seq-{ENC_SEQ} encoder's flash "
                        f"launches {counts} or its agreement with the "
                        f"written-out branch ({out_rel:.3e}, {grad_rel:.3e})")
    return counts, {"step_ms": ms, "out_rel_l2": out_rel,
                    "grad_rel_l2": grad_rel}


def lm_model(pt, device):
    """Zaremba et al.'s large LSTM LM from the package's public names."""
    from paddle_tpu_torch import nn

    class LM(nn.Layer):
        def __init__(self):
            super().__init__()
            self.emb = nn.Embedding(LM_VOCAB, LM_HIDDEN, device=device)
            self.lstm = nn.LSTM(LM_HIDDEN, LM_HIDDEN, num_layers=2,
                                dropout=LM_DROPOUT, device=device)
            self.out = nn.Linear(LM_HIDDEN, LM_VOCAB, device=device)

        def forward(self, ids):
            y, _ = self.lstm(self.emb(ids))
            return self.out(y)

    return LM()


def nn_lstm_lm(pt, seed, failures):
    """(d): the LSTM LM trained eagerly and through the k-step program,
    bitwise over two calls (dropout 0.65 drawn inside the graph)."""
    from paddle_tpu_torch import jit, nn, optimizer
    from paddle_tpu_torch.nn import functional as F
    pt.seed(seed + 176)
    base = lm_model(pt, NN_DEVICE)
    r = np.random.RandomState(seed + 177)
    ids = torch.from_numpy(r.randint(0, LM_VOCAB, (
        LM_K, LM_BATCH, LM_UNROLL + 1))).to(NN_DEVICE)

    def arm(model):
        opt = optimizer.SGD(learning_rate=1.0, parameters=model.parameters(),
                            grad_clip=nn.ClipGradByGlobalNorm(LM_CLIP))

        def one_step(batch):
            logits = model(batch[:, :-1])
            loss = F.cross_entropy(logits.reshape(-1, LM_VOCAB),
                                   batch[:, 1:].reshape(-1))
            loss.backward()
            opt.step()
            opt.clear_grad()
            return loss
        return one_step

    eager_model = copy.deepcopy(base)
    eager_step, body = arm(eager_model), arm(base)
    program = jit.to_static(body, scan_steps=LM_K)
    pt.seed(seed + 178)
    want = [eager_step(ids[i]).detach() for _ in range(2)
            for i in range(LM_K)]
    pt.seed(seed + 178)
    out, peak = first_kstep_call("LSTM LM k-step", lambda: program(ids))
    got = [out, program(ids)]
    compare_runs(f"LSTM LM, dropout {LM_DROPOUT}, 2 calls of "
                 f"scan_steps={LM_K}", torch.stack(want), torch.cat(got),
                 eager_model, base, failures)
    words = LM_BATCH * LM_UNROLL
    # 6 x the matrices' parameters (the embedding is a lookup) x words
    flops = 6 * sum(p.numel() for n, p in base.named_parameters()
                    if p.dim() == 2 and not n.startswith("emb")) * words
    _, tel_e, peak_e = timed_eager(lambda: eager_step(ids[0]),
                                   LM_TIMED[0] + 1, 1, words, flops / words)
    eager = log_rate("LSTM LM eager", tel_e, 1, flops / words, peak_e,
                     report_profile("eager LSTM LM step", profile_retry(
                         lambda: eager_step(ids[0]).item()), failures))
    calls, tel = timed_kstep(lambda: program(ids), LM_K, LM_TIMED[1], words,
                             flops / words)
    prof = report_profile(f"k-step LSTM LM call ({LM_K} steps)",
                          profile_retry(lambda: program(ids).cpu()),
                          failures)
    kstep = log_rate(f"LSTM LM k-step (scan_steps={LM_K}, CUDA graph)", tel,
                     LM_K, flops / words, peak, prof)
    losses = torch.cat([g.cpu() for g in got] + calls)
    ok = bool(torch.isfinite(losses).all())
    log(f"  LSTM LM: words/s eager {eager['tokens_per_s']:.1f}, k-step "
        f"{kstep['tokens_per_s']:.1f} ({words} words a step); recurrence: a "
        f"loop of torch's fused lstm_cell over {LM_UNROLL} steps x 2 "
        f"layers; losses finite {ok} (first {float(losses[0]):.4f}, last "
        f"{float(losses[-1]):.4f})")
    if not ok:
        failures.append("phase 17 (d): LSTM LM losses not finite")
    return {"eager": eager, "kstep": kstep, "flop_a_step": flops}


def nn_surface_cases(F, S):
    """(e)'s functionals: name -> (fn(*tensors), input makers); each
    maker takes a CPU generator and returns a float32 tensor (its
    gradient is compared) or an integer one."""
    def f(*shape, lo=None, hi=None):
        return lambda g: seeded(g, shape, lo, hi)

    def i(high, *shape):
        return lambda g: torch.randint(0, high, shape, generator=g)

    def const(t):
        return lambda g: t

    x = f(3, 4, 5)
    lengths = const(torch.tensor([4, 1, 3]))
    cases = {name: (getattr(F, name), [x]) for name in (
        "relu6", "sigmoid", "silu", "swish", "mish", "selu", "tanhshrink",
        "hardsigmoid", "hardswish", "softsign", "log_sigmoid", "softmax",
        "log_softmax")}
    cases.update({
        "leaky_relu": (lambda v: F.leaky_relu(v, 0.1), [x]),
        "elu": (lambda v: F.elu(v, 0.5), [x]),
        "celu": (lambda v: F.celu(v, 0.7), [x]),
        "hardshrink": (lambda v: F.hardshrink(v, 0.3), [x]),
        "softshrink": (lambda v: F.softshrink(v, 0.3), [x]),
        "hardtanh": (lambda v: F.hardtanh(v, -0.5, 0.7), [x]),
        "softplus": (lambda v: F.softplus(v, 2.0, 3.0), [x]),
        "thresholded_relu": (lambda v: F.thresholded_relu(v, 0.4), [x]),
        "prelu": (F.prelu, [f(2, 3, 4), f(3, lo=0.1, hi=0.5)]),
        "glu": (lambda v: F.glu(v, 1), [f(2, 6, 3)]),
        "maxout": (lambda v: F.maxout(v, 3), [f(2, 6, 3)]),
        "gumbel_softmax_from_noise": (
            F.activation.gumbel_softmax_from_noise, [x, x]),
        "alpha_dropout_from_mask": (
            lambda v, u: F.common.alpha_dropout_from_mask(v, u > 0.3, 0.3),
            [x, f(3, 4, 5, lo=0.0, hi=1.0)]),
        "one_hot": (lambda v: F.one_hot(v, 7), [i(9, 4, 3)]),
        "label_smooth": (lambda v: F.label_smooth(v, epsilon=0.2),
                         [f(4, 7, lo=0.0, hi=1.0)]),
        "interpolate_bilinear": (lambda v: F.interpolate(
            v, size=[7, 5], mode="bilinear"), [f(2, 3, 4, 6)]),
        "interpolate_bicubic": (lambda v: F.interpolate(
            v, size=[3, 9], mode="bicubic"), [f(2, 3, 6, 6)]),
        "interpolate_nearest": (lambda v: F.interpolate(
            v, scale_factor=2), [f(2, 3, 3, 4)]),
        "upsample_align_corners": (lambda v: F.upsample(
            v, size=[5, 7], mode="bilinear", align_corners=True),
            [f(2, 3, 3, 4)]),
        "unfold": (lambda v: F.unfold(v, [3, 2], 1, 1), [f(2, 3, 5, 6)]),
        "cosine_similarity": (F.cosine_similarity, [f(4, 6), f(4, 6)]),
        "bilinear": (F.bilinear, [f(3, 4), f(3, 5), f(6, 4, 5), f(6)]),
        "normalize": (F.normalize, [f(3, 6)]),
        "pixel_shuffle": (lambda v: F.pixel_shuffle(v, 2), [f(2, 8, 3, 3)]),
        "cross_entropy_soft_smoothing": (lambda v, t: F.cross_entropy(
            v, t.softmax(-1), soft_label=True, label_smoothing=0.1),
            [f(6, 7), f(6, 7)]),
        "cross_entropy_hard_smoothing": (lambda v, t: F.cross_entropy(
            v, t, label_smoothing=0.1), [f(6, 7), i(7, 6)]),
        "cross_entropy_probabilities": (lambda v, t: F.cross_entropy(
            v.softmax(-1), t, use_softmax=False), [f(6, 7), i(7, 6)]),
        "softmax_with_cross_entropy": (F.softmax_with_cross_entropy,
                                       [f(5, 6), i(6, 5, 1)]),
        "nll_loss": (F.nll_loss, [f(6, 5), i(5, 6)]),
        "mse_loss": (F.mse_loss, [f(4, 5), f(4, 5)]),
        "l1_loss": (F.l1_loss, [f(4, 5), f(4, 5)]),
        "smooth_l1_loss": (F.smooth_l1_loss, [f(4, 5), f(4, 5)]),
        "binary_cross_entropy": (F.binary_cross_entropy, [
            f(4, 5, lo=0.05, hi=0.95), f(4, 5, lo=0.0, hi=1.0)]),
        "binary_cross_entropy_with_logits": (
            F.binary_cross_entropy_with_logits, [f(4, 5), f(4, 5, lo=0.0,
                                                           hi=1.0)]),
        "kl_div": (lambda v, t: F.kl_div(v.log_softmax(-1), t.softmax(-1)),
                   [f(4, 5), f(4, 5)]),
        "center_loss": (lambda v, c: F.center_loss(
            v, torch.tensor([0, 2, 2, 3, 0, 0], device=v.device), 4, 0.3,
            c.detach().clone()), [f(6, 3), f(4, 3)]),
        "margin_ranking_loss": (lambda a, b, t: F.margin_ranking_loss(
            a, b, t.sign()), [f(6), f(6), f(6)]),
        "hinge_embedding_loss": (lambda a, t: F.hinge_embedding_loss(
            a, t.sign()), [f(6), f(6)]),
        "cosine_embedding_loss": (lambda a, b, t: F.cosine_embedding_loss(
            a, b, t.sign()), [f(5, 4), f(5, 4), f(5)]),
        "triplet_margin_loss": (F.triplet_margin_loss, [f(5, 4), f(5, 4),
                                                        f(5, 4)]),
        "square_error_cost": (F.square_error_cost, [f(4, 3), f(4, 3)]),
        "sigmoid_focal_loss": (F.sigmoid_focal_loss, [
            f(6, 3), f(6, 3, lo=0.0, hi=1.0)]),
        "ctc_loss": (lambda v: F.ctc_loss(
            v, torch.tensor([[1, 2, 2], [3, 1, 0]], device=v.device),
            torch.tensor([7, 5], device=v.device),
            torch.tensor([3, 2], device=v.device)), [f(7, 2, 5)]),
        "rank_loss": (F.rank_loss, [f(5, 1, lo=0.0, hi=1.0), f(5, 1),
                                    f(5, 1)]),
        "margin_rank_loss": (F.margin_rank_loss, [f(5, 1), f(5, 1),
                                                  f(5, 1)]),
        "huber_loss": (lambda a, b: F.huber_loss(a, b, 0.5), [f(6, 1),
                                                              f(6, 1)]),
        "log_loss": (F.log_loss, [f(6, 1, lo=0.05, hi=0.95),
                                  f(6, 1, lo=0.0, hi=1.0)]),
        "bpr_loss": (F.bpr_loss, [f(4, 5), i(5, 4, 1)]),
        "npair_loss": (lambda a, p: F.npair_loss(
            a, p, torch.tensor([0, 1, 0, 2, 1, 2], device=a.device)),
            [f(6, 4), f(6, 4)]),
        "hsigmoid_loss": (lambda v, lab, w, b: F.hsigmoid_loss(
            v, lab, 6, w, b), [f(5, 4), i(6, 5, 1), f(5, 4), f(5)]),
        "teacher_student_sigmoid_loss": (F.teacher_student_sigmoid_loss,
                                         [f(8, 1), f(8, 1)]),
        "hinge_loss": (F.hinge_loss, [f(6, 1), f(6, 1, lo=0.0, hi=1.0)]),
        "nce_from_samples": (lambda v, lab, w, b: F.loss.nce_from_samples(
            v, lab, w, b, torch.tensor([2, 7, 2, 0], device=v.device),
            torch.full((9,), 1 / 9, device=v.device), 4),
            [f(4, 3), i(9, 4, 1), f(9, 3), f(9)]),
        "sampled_softmax_from_samples": (
            lambda v, lab: F.loss.sampled_softmax_from_samples(
                v, lab, torch.tensor([1, 7, 5, 3], device=v.device), 4),
            [f(4, 12), i(12, 4, 1)]),
        "rms_norm": (F.rms_norm, [f(3, 8), f(8)]),
        "instance_norm": (F.instance_norm, [f(2, 3, 4, 5), f(3), f(3)]),
        "group_norm": (lambda v, w, b: F.group_norm(v, 3, w, b),
                       [f(2, 6, 3, 3), f(6), f(6)]),
        "sequence_reverse": (lambda v, n: S.sequence_reverse(v, n),
                             [f(3, 4, 2), lengths]),
        "sequence_softmax": (S.sequence_softmax, [f(3, 4), lengths]),
        "sequence_pool_max": (lambda v, n: S.sequence_pool(v, n, "max"),
                              [f(3, 4, 2), lengths]),
        "sequence_pool_sqrt": (lambda v, n: S.sequence_pool(v, n, "sqrt"),
                               [f(3, 4, 2), lengths]),
        "sequence_last_step": (S.sequence_last_step, [f(3, 4, 2), lengths]),
        "sequence_mask": (lambda n: S.sequence_mask(n, 5), [lengths]),
        "sequence_expand": (S.sequence_expand, [f(3, 2), lengths]),
        "sequence_enumerate": (lambda v: S.sequence_enumerate(v, 3),
                               [i(9, 3, 5)]),
        "gather_tree": (S.gather_tree, [i(9, 5, 2, 3), i(3, 5, 2, 3)]),
        "row_conv": (S.row_conv, [f(3, 4, 2), f(2, 2)]),
        "sequence_conv": (lambda v, w, n: S.sequence_conv(
            v, w, 3, lengths=n), [f(3, 4, 2), f(6, 5), lengths]),
        "sequence_reshape": (lambda v: S.sequence_reshape(v, 4),
                             [f(3, 4, 6)]),
        "sequence_scatter": (lambda v, u: S.sequence_scatter(
            v, torch.tensor([[0, 2], [5, 5], [1, 3]], device=v.device), u),
            [f(3, 6), f(3, 2)]),
        "im2sequence": (lambda v: S.im2sequence(v, [2, 3], [1, 2], 1),
                        [f(2, 3, 5, 6)]),
        "ctc_align": (lambda v: S.ctc_align(v, None)[0], [i(4, 3, 7)]),
    })
    return cases


def nn_layer_cases(nn):
    """(e)'s layers: name -> (maker(device), input makers)."""
    def f(*shape):
        return lambda g: seeded(g, shape)

    def i(high, *shape):
        return lambda g: torch.randint(0, high, shape, generator=g)

    def u(*shape):
        return lambda g: seeded(g, shape, 0.05, 0.95)

    acts = {n: (lambda d, n=n: getattr(nn, n)(), [f(3, 5)]) for n in (
        "ReLU6", "Sigmoid", "Tanh", "GELU", "Silu", "Swish", "Mish",
        "LeakyReLU", "ELU", "SELU", "Hardtanh", "Hardsigmoid", "Hardswish",
        "Softplus", "Softshrink", "Hardshrink", "Tanhshrink", "Softsign",
        "LogSigmoid", "Softmax", "LogSoftmax", "ThresholdedReLU")}
    return dict(acts, **{
        "PReLU": (lambda d: nn.PReLU(3, device=d), [f(2, 3, 4)]),
        "Maxout": (lambda d: nn.Maxout(2), [f(2, 4, 3)]),
        "Flatten": (lambda d: nn.Flatten(), [f(2, 3, 4)]),
        "Identity": (lambda d: nn.Identity(), [f(2, 3)]),
        "Upsample": (lambda d: nn.Upsample([5, 7], mode="bilinear"),
                     [f(2, 3, 4, 4)]),
        "Pad1D": (lambda d: nn.Pad1D([1, 2], mode="reflect"), [f(2, 3, 5)]),
        "Pad2D": (lambda d: nn.Pad2D([1, 0, 2, 1]), [f(2, 3, 4, 4)]),
        "CosineSimilarity": (lambda d: nn.CosineSimilarity(), [f(3, 6),
                                                               f(3, 6)]),
        "Bilinear": (lambda d: nn.Bilinear(3, 4, 5, device=d),
                     [f(2, 3), f(2, 4)]),
        "PixelShuffle": (lambda d: nn.PixelShuffle(3), [f(1, 9, 2, 2)]),
        "RMSNorm": (lambda d: nn.RMSNorm(6, device=d), [f(2, 3, 6)]),
        "GroupNorm": (lambda d: nn.GroupNorm(2, 4, device=d),
                      [f(2, 4, 3, 3)]),
        "InstanceNorm1D": (lambda d: nn.InstanceNorm1D(3, device=d),
                           [f(2, 3, 7)]),
        "InstanceNorm3D": (lambda d: nn.InstanceNorm3D(2, device=d),
                           [f(2, 2, 3, 3, 2)]),
        "CrossEntropyLoss": (lambda d: nn.CrossEntropyLoss(
            label_smoothing=0.1), [f(5, 4), i(4, 5)]),
        "MSELoss": (lambda d: nn.MSELoss(), [f(4, 3), f(4, 3)]),
        "L1Loss": (lambda d: nn.L1Loss(), [f(4, 3), f(4, 3)]),
        "NLLLoss": (lambda d: nn.NLLLoss(), [f(5, 4), i(4, 5)]),
        "BCELoss": (lambda d: nn.BCELoss(), [u(3, 4), u(3, 4)]),
        "BCEWithLogitsLoss": (lambda d: nn.BCEWithLogitsLoss(),
                              [f(3, 4), f(3, 4)]),
        "CTCLoss": (lambda d: nn.CTCLoss(), [
            f(5, 2, 4), lambda g: torch.tensor([[1, 2], [3, 3]]),
            lambda g: torch.tensor([5, 4]), lambda g: torch.tensor([2, 2])]),
        "Dropout2D_eval": (lambda d: nn.Dropout2D(0.5).eval(),
                           [f(2, 3, 4, 4)]),
        "AlphaDropout_eval": (lambda d: nn.AlphaDropout(0.3).eval(),
                              [f(3, 4)]),
        "KLDivLoss": (lambda d: nn.KLDivLoss(), [f(2, 3), f(2, 3)]),
        "SmoothL1Loss": (lambda d: nn.SmoothL1Loss(), [f(4, 3), f(4, 3)]),
        "MarginRankingLoss": (lambda d: nn.MarginRankingLoss(),
                              [f(5), f(5), f(5)]),
        "Unfold": (lambda d: nn.Unfold([2, 2], strides=2), [f(2, 3, 4, 4)]),
        "UpsamplingBilinear2D": (lambda d: nn.UpsamplingBilinear2D(
            scale_factor=2), [f(1, 2, 3, 3)]),
        "UpsamplingNearest2D": (lambda d: nn.UpsamplingNearest2D([5, 4]),
                                [f(1, 2, 3, 3)]),
        "CosineEmbeddingLoss": (lambda d: nn.CosineEmbeddingLoss(),
                                [f(4, 3), f(4, 3), f(4)]),
        "TripletMarginLoss": (lambda d: nn.TripletMarginLoss(),
                              [f(4, 3), f(4, 3), f(4, 3)]),
        "SpectralNorm": (lambda d: nn.SpectralNorm([6, 4], device=d),
                         [f(6, 4)]),
        "SimpleRNN": (lambda d: nn.SimpleRNN(4, 6, 2, device=d),
                      [f(3, 5, 4)]),
        "LSTM_bidirect": (lambda d: nn.LSTM(4, 6, 2, "bidirect", device=d),
                          [f(3, 5, 4)]),
        "GRU": (lambda d: nn.GRU(4, 6, device=d), [f(3, 5, 4)]),
        "SimpleRNNCell": (lambda d: nn.SimpleRNNCell(4, 6, device=d),
                          [f(3, 4), f(3, 6)]),
        "LSTMCell": (lambda d: nn.LSTMCell(4, 6, device=d), [f(3, 4)]),
        "GRUCell": (lambda d: nn.GRUCell(4, 6, device=d), [f(3, 4),
                                                            f(3, 6)]),
        "RNN": (lambda d: nn.RNN(nn.GRUCell(4, 6, device=d)), [f(3, 5, 4)]),
        "BiRNN": (lambda d: nn.BiRNN(nn.LSTMCell(4, 6, device=d),
                                     nn.LSTMCell(4, 6, device=d)),
                  [f(3, 5, 4)]),
        "MultiHeadAttention": (lambda d: nn.MultiHeadAttention(
            16, 4, device=d), [f(2, 5, 16), f(2, 7, 16), f(2, 7, 16)]),
        "TransformerEncoderLayer": (lambda d: nn.TransformerEncoderLayer(
            16, 4, 32, dropout=0.0, normalize_before=True, device=d),
            [f(2, 5, 16)]),
        "TransformerDecoderLayer": (lambda d: nn.TransformerDecoderLayer(
            16, 4, 32, dropout=0.0, device=d), [f(2, 4, 16), f(2, 5, 16)]),
        "Transformer": (lambda d: nn.Transformer(
            16, 4, 2, 2, 32, dropout=0.0, device=d),
            [f(2, 5, 16), f(2, 4, 16)]),
    })


def compared_parameters(layer):
    """The parameters whose gradients (e) compares: all but the key
    projections' biases, whose gradient is exactly zero (softmax cancels
    a key bias), so the card and the CPU each hold rounding noise there."""
    return [p for n, p in layer.named_parameters()
            if not n.endswith("k_proj.bias")]


def first_output(out):
    """A layer's output, or the first of its (output, states)."""
    while isinstance(out, (tuple, list)):
        out = out[0]
    return out


def nn_card_vs_cpu(pt, seed, failures):
    """(e): every newly ported functional and layer once on the card
    against the CPU, float32: each output and the gradients of sum(out *
    c) for every float input and parameter."""
    from paddle_tpu_torch import nn
    from paddle_tpu_torch.nn import functional as F
    from paddle_tpu_torch.ops import sequence as S
    gen = torch.Generator()
    worst, bad, n = (0.0, ""), [], 0

    def run(fn, inputs, device, params=()):
        ins = [x.detach().clone().to(device).requires_grad_(
            x.is_floating_point()) for x in inputs]
        out = first_output(fn(*ins))
        if not out.is_floating_point():
            return [out]
        cot = torch.linspace(-1.0, 1.0, out.numel()).reshape(out.shape)
        wrt = [x for x in ins if x.requires_grad] + [
            p for p in params if p.requires_grad]
        if not wrt:
            return [out]
        grads = torch.autograd.grad((out * cot.to(device)).sum(), wrt,
                                    allow_unused=True)
        return [out] + [g for g in grads if g is not None]

    def check(name, cpu, card):
        nonlocal worst, n
        n += 1
        errs = [max_rel(a, b) if a.is_floating_point()
                else float(not torch.equal(a.cpu(), b)) for a, b in
                zip(card, cpu)]
        tols = [NN_FWD_TOL] + [NN_GRAD_TOL] * (len(errs) - 1)
        if len(card) != len(cpu) or any(e > t for e, t in zip(errs, tols)):
            bad.append(f"{name} {[f'{e:.2e}' for e in errs]}")
        worst = max(worst, (max(errs), name))

    for name, (fn, makers) in nn_surface_cases(F, S).items():
        gen.manual_seed(seed + n)
        inputs = [b(gen) for b in makers]
        check(name, run(fn, inputs, "cpu"), run(fn, inputs, NN_DEVICE))
    for name, (build, makers) in nn_layer_cases(nn).items():
        gen.manual_seed(seed + n)
        inputs = [b(gen) for b in makers]
        pt.seed(seed + n)
        layer = build("cpu")
        card = copy.deepcopy(layer).to(NN_DEVICE)
        check(name, run(layer, inputs, "cpu", compared_parameters(layer)),
              run(card, inputs, NN_DEVICE, compared_parameters(card)))
    ok = not bad
    log(f"  {n} new functionals and layers on the card against the CPU, "
        f"float32: worst max rel {worst[0]:.3e} ({worst[1]}; tol "
        f"{NN_FWD_TOL:g} outputs, {NN_GRAD_TOL:g} gradients) "
        f"{'ok' if ok else 'FAIL: ' + '; '.join(bad)}")
    if not ok:
        failures.append(f"phase 17 (e): {len(bad)} functionals or layers "
                        f"disagree with the CPU: {'; '.join(bad)[:400]}")
    return {"cases": n, "worst_max_rel": worst[0], "worst_case": worst[1]}


def gumbel_moments(F, rows, n, device):
    """gumbel_softmax's draws at zero logits, held by their moments: the
    argmax of each row is uniform over its ``n`` classes (hard), and
    ``log y`` less its row mean is ``g - mean(g)`` for the row's standard
    Gumbel draws ``g``, whose variance is ``pi^2/6 (1 - 1/n)`` and skewness
    ``1.13955 (1 - 2/n) / sqrt(1 - 1/n)``. A missing, untransformed or
    sign-flipped draw fails one of them. Returns (worst class frequency's
    distance from 1/n, variance, its want, skewness, its want)."""
    hard = F.gumbel_softmax(torch.zeros(rows, n, device=device), hard=True)
    freq = hard.argmax(-1).bincount(minlength=n).double() / rows
    c = torch.log(F.gumbel_softmax(torch.zeros(rows, n, device=device)))
    c = (c - c.mean(-1, keepdim=True)).double()
    var = float(c.var())
    skew = float((c - c.mean()).pow(3).mean()) / max(var, 1e-12) ** 1.5
    want_var = math.pi ** 2 / 6 * (1 - 1 / n)
    want_skew = 1.13955 * (1 - 2 / n) / math.sqrt(1 - 1 / n)
    return (float((freq - 1 / n).abs().max()), var, want_var, skew,
            want_skew)


def nn_draws(pt, failures):
    """(e), the draws on the card: dropout2d drops whole channels at its
    rate, alpha_dropout keeps the mean and variance, gumbel_softmax's
    draws have the Gumbel distribution's moments."""
    from paddle_tpu_torch.nn import functional as F
    x = torch.ones(200, 200, 6, device=NN_DEVICE)
    y = F.dropout2d(x[..., None], p=0.3)[..., 0]
    per_channel = (y.amin(-1) == y.amax(-1)).all()
    dropped = float((y[..., 0] == 0).float().mean())
    z = F.alpha_dropout(torch.randn(400, 400, device=NN_DEVICE), p=0.2)
    # 20,000 rows of 50: a class's frequency has sd 0.001, the variance's
    # estimate about 0.004 and the skewness's about 0.01
    freq_err, var, want_var, skew, want_skew = gumbel_moments(
        F, 20000, 50, NN_DEVICE)
    ok = (bool(per_channel) and abs(dropped - 0.3) < 0.03
          and abs(float(z.mean())) < 0.03 and abs(float(z.std()) - 1) < 0.03
          and freq_err < 0.005 and abs(var - want_var) < 0.05
          and abs(skew - want_skew) < 0.1)
    log(f"  draws on the card: dropout2d drops {dropped:.4f} of the "
        f"channels whole (p 0.3), alpha_dropout mean {float(z.mean()):.4f} "
        f"std {float(z.std()):.4f}; gumbel_softmax over 20000 x 50 zeros: "
        f"hard argmax class frequency within {freq_err:.5f} of 1/50 (tol "
        f"0.005), centred log-output variance {var:.4f} (want "
        f"{want_var:.4f}, tol 0.05), skewness {skew:.4f} (want "
        f"{want_skew:.4f}, tol 0.1) {'ok' if ok else 'FAIL'}")
    if not ok:
        failures.append("phase 17 (e): a draw on the card is off its "
                        "moments")


def phase17(pt, fa, seed, failures):
    """Phase 17: the nn layer library on the card. A part that raises is
    a failure and the next one still runs. Returns each part's flash
    launches."""
    import traceback
    log("phase 17: the nn layer library: Transformer-base trained and "
        "beam-decoded, the flash kernels through MultiHeadAttention, the "
        "large LSTM LM, every new layer card vs CPU")
    t_phase = time.perf_counter()
    out, launches, trained = {}, {}, {}

    def base():
        trained["model"], res = nn_transformer_base(pt, fa, seed, failures)
        return res

    def beam():
        if "model" not in trained:
            raise RuntimeError("no trained model: (a) failed")
        return nn_beam(pt, trained.pop("model"), seed, failures)

    def encoder():
        counts, res = nn_flash_encoder(pt, fa, seed, failures)
        launches["nn_encoder_seq1024_step"] = counts
        return res

    parts = (("transformer_base", base, 0), ("beam_decode", beam, 0),
             ("encoder_seq1024", encoder, None),
             ("lstm_lm", lambda: nn_lstm_lm(pt, seed, failures), 0),
             ("card_vs_cpu", lambda: (nn_draws(pt, failures),
                                      nn_card_vs_cpu(pt, seed,
                                                     failures))[1], 0))
    for key, part, want in parts:
        t0 = time.perf_counter()
        fa.reset_launch_counts()
        try:
            out[key] = part()
        except Exception as e:  # noqa: BLE001 -- reported as a failure
            traceback.print_exc()
            failures.append(f"phase 17 ({key}) raised {type(e).__name__}: "
                            f"{e}")
        if want is not None:  # the parts below the flash gate
            counts = flash_launches(fa)
            launches[f"nn_{key}"] = counts
            ok = not any(counts.values())
            log(f"  -- {key}: flash launches {counts} (none expected: "
                f"seq below {1024}) {'ok' if ok else 'FAIL'}")
            if not ok:
                failures.append(f"phase 17 ({key}) launched flash kernels "
                                f"{counts}")
        log(f"  -- {key}: {time.perf_counter() - t0:.1f} s")
        free_cuda()
    out["seconds"] = time.perf_counter() - t_phase
    log(f"  phase 17: {out['seconds']:.1f} s; {card_line()}")
    log(json.dumps({"nn_library": out}, default=str))
    return launches


# ---- phase 18: the rest of the parameter server -----------------------------

# (a) TDM (Zhu et al., "Learning Tree-based Deep Model for Recommender
# Systems", KDD 2018) at the size of Alibaba's UserBehavior log: its item and
# user counts, node and user embeddings 24 wide (the paper's setup), branch
# 2. This script's choices: batches of 1,024 seeded (user, item) pairs, up
# to 6 negatives a layer capped at the layer's size - 1, Adam at 0.05 (the
# JAX package's TDM test's rate), 20 steps over 4 fixed batches, beam 200.
TDM_ITEMS, TDM_USERS, TDM_DIM, TDM_BRANCH = 4_162_024, 987_994, 24, 2
TDM_BATCH, TDM_BATCHES, TDM_STEPS, TDM_NEG, TDM_LR = 1024, 4, 20, 6, 0.05
TDM_BEAM, TDM_QUERIES = 200, 32
TDM_SUBTREE_LAYER = 6   # the last of its 2^6 subtrees: the ragged edge
# (b) GraphSAGE (Hamilton et al., "Inductive Representation Learning on
# Large Graphs", NeurIPS 2017) at the Reddit graph's size: nodes, features,
# classes and the average degree (section 4.1); two mean aggregators with
# samples 25 and 10, 128 wide, batch 512, Adam at 0.01 (the authors'
# supervised defaults). Labels are planted: each class adds a seeded
# centroid to its nodes' features. Degrees are log-normal (sigma 1) around
# the mean; destinations uniform.
SAGE_NODES, SAGE_FEAT, SAGE_CLASSES, SAGE_DEGREE = 232_965, 602, 41, 492
SAGE_FANOUT, SAGE_DIM, SAGE_BATCH, SAGE_LR = (25, 10), 128, 512, 0.01
SAGE_STEPS, SAGE_CHECK_NODES = 10, 1000
SAGE_NODE_CHUNK, SAGE_EDGE_CHUNK = 20_000, 1 << 23
SAGE_LOAD_BUDGET_S = 45.0
# (c) the heterogeneous PS at bench_ctr's accelerator size (phase 14's
# CTR_VOCAB, CTR_DIM, CTR_SLOTS, CTR_BATCH, CTR_HIDDEN; ids as phase 16
# (c)'s), the tower's update SGD at CTR_SGD_LR, the sparse table's too.
HETER_REQUESTS = 30
# One step card against CPU (a, b): the loss and the gradients, each
# device's own, within REST_STEP_REL (max |card - cpu| / max |cpu|), and
# the parameters after the Adam step, both devices stepping from the card's
# gradient, within it too. (From each its own gradient, Adam's first step
# moves an element by lr * g / (|g| + eps): an element whose gradient is
# near eps, or rounding noise, moves by a share of the rate that the
# rounding picks, so that comparison would hold the rounding, not the
# step.)
REST_STEP_REL = 1e-5
# (d) the CTR tail ops, card against CPU, float32 (TF32 off).
TAIL_REL = 1e-5
REST_DEVICE = "cuda"  # the card; the CPU twins are "cpu"


def rest_sync():
    if REST_DEVICE != "cpu":
        torch.cuda.synchronize()


def rest_check(label, ok, failures, detail=""):
    log(f"  {label}{': ' + detail if detail else ''} "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        failures.append(f"phase 18 {label}")
    return ok


def step_gap(card, cpu):
    """``card``/``cpu``: [(gradient, parameter after the step)] of one
    step. Returns the gradients' and the parameters' max rel."""
    return (max(max_rel(gc, gp) for (gc, _), (gp, _) in zip(card, cpu)),
            max(max_rel(pc, pp) for (_, pc), (_, pp) in zip(card, cpu)))


def tdm_subtree_check(tree, travel, info, failures):
    """The feeds of the last subtree below layer TDM_SUBTREE_LAYER against
    the JAX package's per-node algorithm run node by node over the tree's
    scalar accessors."""
    b = tree.branch
    root = tree.get_layer_codes(TDM_SUBTREE_LAYER)[-1]
    first_leaf = (b ** (tree.height - 1) - 1) // (b - 1)
    codes, frontier = [root], [root]
    while frontier:
        frontier = [k for c in frontier for k in tree.get_children_codes(c)]
        codes += frontier
    bad_info = bad_travel = 0
    for code in codes:
        (emb,) = tree.get_nodes([code])
        item = code - first_leaf + 1 if code >= first_leaf else 0
        (parent,) = tree.get_nodes([(code - 1) // b]) if code > 0 else (0,)
        row = [item, tree.layer_of(code), parent]
        row += tree.get_nodes(tree.get_children_codes(code))
        row += [0] * (3 + b - len(row))
        bad_info += int(info[emb].tolist() != row)
        if item:
            path = tree.get_nodes(tree.get_travel_codes(item, 1))[::-1]
            bad_travel += int(travel[item].tolist() != path)
    leaves = sum(1 for c in codes if c >= first_leaf)
    return rest_check(
        f"(a) the last 1/{b ** TDM_SUBTREE_LAYER} subtree ({len(codes)} "
        f"nodes, {leaves} leaves): tree_info and travel rows against a "
        f"per-node recomputation", bad_info == 0 and bad_travel == 0,
        failures, f"{bad_info} tree_info rows and {bad_travel} travel rows "
        f"differ")


def tdm_model(pt, n_emb, device, state=None):
    pt.seed(4)
    node = pt.nn.Embedding(n_emb, TDM_DIM, device=device)
    user = pt.nn.Embedding(TDM_USERS + 1, TDM_DIM, device=device)
    if state is not None:
        with torch.no_grad():
            node.weight.copy_(state[0])
            user.weight.copy_(state[1])
    opt = pt.optimizer.Adam(parameters=[node.weight, user.weight],
                            learning_rate=TDM_LR)
    return node, user, opt


def tdm_loss(pt, node, user, users, out, labels, mask):
    """The two-tower score of the JAX package's TDM test: the user's and
    the node's embeddings dotted, BCE over the sampler's labels, masked."""
    from paddle_tpu_torch.core.tensor import unwrap
    from paddle_tpu_torch.nn import functional as F
    u = unwrap(user(users))
    nodes = unwrap(node(out))
    logits = (nodes * u.unsqueeze(1)).sum(-1)
    m = mask.float()
    return (unwrap(F.binary_cross_entropy_with_logits(
        logits, labels.float(), reduction="none")) * m).sum() / m.sum()


def tdm_retrieve(pt, info, first, node_w, user_w, uids):
    """Beam search (beam TDM_BEAM) down the tree through ``tdm_child`` for
    the users ``uids`` at once, scored on ``node_w``'s device in float64
    (exact products of float32, so the card's and the CPU's orders agree):
    the retrieved leaf ids [Q, TDM_BEAM]."""
    from paddle_tpu_torch.core.tensor import unwrap
    dev = node_w.device
    u = user_w[torch.as_tensor(uids, device=dev)].double()
    frontier = torch.as_tensor(first, device=dev)[None, :].expand(
        len(uids), -1).contiguous()
    while True:
        child, leaf = (unwrap(v).reshape(len(uids), -1) for v in
                       pt.ops.tdm_child(frontier, info, TDM_BRANCH))
        valid = child != 0
        scores = (node_w[child].double() * u[:, None, :]).sum(-1)
        scores = torch.where(valid, scores, torch.full_like(scores,
                                                            -math.inf))
        top = scores.topk(min(TDM_BEAM, child.shape[1]), dim=1).indices
        keep = child.gather(1, top)
        if bool((leaf.gather(1, top).bool() | ~valid.gather(1, top)).all()):
            return keep
        frontier = keep


def rest_tdm(pt, seed, failures):
    """(a): TDM at UserBehavior's size."""
    from paddle_tpu_torch.core.tensor import unwrap
    from paddle_tpu_torch.distributed.fleet import TreeIndex
    t0 = time.perf_counter()
    tree = TreeIndex.from_items(np.arange(1, TDM_ITEMS + 1), TDM_BRANCH)
    build_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    travel = tree.travel_array(1)
    layer_flat, offsets = tree.layer_array(1)
    info = tree.tree_info_array()
    arrays_s = time.perf_counter() - t0
    n_emb = tree.emb_id_count()
    log(f"  (a) TreeIndex over {TDM_ITEMS} items, branch {TDM_BRANCH}: "
        f"height {tree.height}, {n_emb - 1} embedding ids; from_items "
        f"{build_s:.3f} s, travel/layer/tree_info arrays {arrays_s:.3f} s")
    tdm_subtree_check(tree, travel, info, failures)
    counts = np.diff(offsets).tolist()
    negs = [min(TDM_NEG, c - 1) for c in counts]
    rng = np.random.RandomState(seed + 1800)
    users = rng.randint(1, TDM_USERS + 1, (TDM_BATCHES, TDM_BATCH))
    items = rng.randint(1, TDM_ITEMS + 1, (TDM_BATCHES, TDM_BATCH))
    batches, sample_s = [], []
    for i in range(TDM_BATCHES):
        t0 = time.perf_counter()
        got = pt.ops.tdm_sampler(torch.as_tensor(items[i][:, None],
                                                 device=REST_DEVICE),
                                 negs, counts, travel,
                                 layer_flat, layer_offsets=offsets,
                                 seed=seed + i)
        out, labels, mask = (unwrap(v) for v in got)
        rest_sync()
        sample_s.append(time.perf_counter() - t0)
        batches.append((torch.as_tensor(users[i], device=REST_DEVICE), out,
                        labels, mask))
    width = batches[0][1].shape[1]
    _u, out, labels, _m = batches[0]
    positives = out[labels.bool()].view(TDM_BATCH, -1).cpu().numpy()
    rest_check(f"(a) tdm_sampler: {TDM_BATCH} x {width} ids a batch on the "
               f"card, int64, every row's positives its item's travel path",
               all(b[1].device.type == REST_DEVICE
                   and b[1].dtype == torch.int64 for b in batches)
               and np.array_equal(positives, travel[items[0]]),
               failures, f"{np.mean(sample_s) * 1e3:.1f} ms a batch "
               f"(negatives {negs[:3]}... up to {TDM_NEG})")
    node, user, opt = tdm_model(pt, n_emb, REST_DEVICE)
    table_bytes = sum(p.numel() * p.element_size()
                      for p in (node.weight, user.weight))
    # one step on the card and on the CPU from the same weights
    cpu_node, cpu_user, cpu_opt = tdm_model(
        pt, n_emb, "cpu", (node.weight.detach().cpu(),
                           user.weight.detach().cpu()))
    ub, out, labels, mask = batches[0]
    rows_n = torch.unique(out)
    rows_u = torch.unique(ub)
    steps, card_grads = {}, None
    for dev, (nd, us, op) in ((REST_DEVICE, (node, user, opt)),
                              ("cpu", (cpu_node, cpu_user, cpu_opt))):
        t0 = time.perf_counter()
        loss = tdm_loss(pt, nd, us, ub.to(dev), out.to(dev),
                        labels.to(dev), mask.to(dev))
        loss.backward()
        grads = [nd.weight.grad[rows_n.to(dev)].clone(),
                 us.weight.grad[rows_u.to(dev)].clone()]
        with torch.no_grad():
            if card_grads is None:
                card_grads = [p.grad.cpu() for p in (nd.weight, us.weight)]
            else:  # the CPU steps from the card's gradient
                for p, grad in zip((nd.weight, us.weight), card_grads):
                    p.grad.copy_(grad)
        op.step()
        op.clear_grad()
        steps[dev] = (float(loss.detach()), [
            (g, p.detach()[r.to(dev)].clone()) for g, p, r in
            zip(grads, (nd.weight, us.weight), (rows_n, rows_u))],
            time.perf_counter() - t0)
    del cpu_node, cpu_user, cpu_opt
    loss_rel = abs(steps[REST_DEVICE][0] - steps["cpu"][0]) / abs(
        steps["cpu"][0])
    g_rel, p_rel = step_gap(steps[REST_DEVICE][1], steps["cpu"][1])
    rest_check(f"(a) one step card vs CPU ({rows_n.numel()} node rows and "
               f"{rows_u.numel()} user rows touched)",
               max(loss_rel, g_rel, p_rel) <= REST_STEP_REL, failures,
               f"loss rel {loss_rel:.3e}, touched rows' gradients rel "
               f"{g_rel:.3e}, the rows after Adam from the card's gradient "
               f"rel {p_rel:.3e} (tol {REST_STEP_REL:g}); CPU step "
               f"{steps['cpu'][2]:.2f} s")
    losses = [steps[REST_DEVICE][0]]
    rest_sync()
    t0 = time.perf_counter()
    for step in range(1, TDM_STEPS):
        ub, out, labels, mask = batches[step % TDM_BATCHES]
        loss = tdm_loss(pt, node, user, ub, out, labels, mask)
        loss.backward()
        opt.step()
        opt.clear_grad()
        losses.append(float(loss.detach()))
    step_ms = (time.perf_counter() - t0) * 1e3 / (TDM_STEPS - 1)
    first, last = np.mean(losses[:4]), np.mean(losses[-4:])
    rest_check(f"(a) {TDM_STEPS} steps over {TDM_BATCHES} batches: losses "
               f"finite, the last 4's mean below the first 4's",
               bool(np.isfinite(losses).all()) and last < first, failures,
               f"{first:.4f} -> {last:.4f}")
    uids = rng.randint(1, TDM_USERS + 1, TDM_QUERIES)
    first_ids = tree.get_nodes(tree.get_children_codes(0))
    with torch.no_grad():
        tdm_retrieve(pt, info, first_ids, node.weight, user.weight, uids[:2])
        rest_sync()
        t0 = time.perf_counter()
        got = tdm_retrieve(pt, info, first_ids, node.weight, user.weight,
                           uids)
        rest_sync()
        retrieve_ms = (time.perf_counter() - t0) * 1e3
        want = tdm_retrieve(pt, info, first_ids, node.weight.cpu(),
                            user.weight.cpu(), uids)
    leaf_ok = bool((info[got.cpu().numpy().ravel(), 0] != 0).all())
    rest_check(f"(a) beam {TDM_BEAM} retrieval for {TDM_QUERIES} users: "
               f"{TDM_BEAM} leaves each, the ids equal the CPU's",
               torch.equal(got.cpu(), want) and leaf_ok
               and tuple(got.shape) == (TDM_QUERIES, TDM_BEAM), failures,
               f"{retrieve_ms:.1f} ms, {retrieve_ms / TDM_QUERIES:.2f} ms a "
               f"user")
    res = {"from_items_s": build_s, "arrays_s": arrays_s,
           "height": tree.height, "emb_ids": n_emb - 1,
           "sampler_ms_per_batch": float(np.mean(sample_s)) * 1e3,
           "sample_width": width, "step_ms": step_ms,
           "steps_per_s": 1e3 / step_ms, "loss_first4": first,
           "loss_last4": last, "retrieve_ms": retrieve_ms,
           "retrieve_ms_per_user": retrieve_ms / TDM_QUERIES,
           "table_bytes": table_bytes, "adam_state_bytes": 2 * table_bytes,
           "card_vs_cpu": {"loss_rel": loss_rel, "grad_rel": g_rel,
                           "param_rel": p_rel}}
    log(f"  (a) TDM: tree {build_s:.3f} s + arrays {arrays_s:.3f} s; "
        f"sampler {res['sampler_ms_per_batch']:.1f} ms a batch of "
        f"{TDM_BATCH} x {width}; device step {step_ms:.2f} ms "
        f"({res['steps_per_s']:.1f} steps/s, the loss read each step); "
        f"retrieval {res['retrieve_ms_per_user']:.2f} ms a user; tables "
        f"{table_bytes / 1e9:.3f} GB (+ {2 * table_bytes / 1e9:.3f} GB of "
        f"Adam moments); {card_line()}")
    del node, user, opt, batches
    return res


def sage_graph(seed):
    """Reddit-sized synthetic graph: features [N, F] with a planted class
    centroid, labels [N], log-normal degrees around SAGE_DEGREE, their
    offsets and uniform destinations (edges grouped by source)."""
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, SAGE_CLASSES, SAGE_NODES)
    centroids = rng.standard_normal((SAGE_CLASSES, SAGE_FEAT),
                                    dtype=np.float32)
    feats = rng.standard_normal((SAGE_NODES, SAGE_FEAT), dtype=np.float32)
    feats += centroids[labels]
    deg = np.exp(np.log(SAGE_DEGREE) - 0.5 + rng.standard_normal(SAGE_NODES))
    deg = np.clip(np.rint(deg), 1, SAGE_NODES - 1).astype(np.int64)
    offsets = np.concatenate([[0], np.cumsum(deg)])
    dst = rng.integers(0, SAGE_NODES, offsets[-1], dtype=np.uint64)
    return feats, labels, deg, offsets, dst


class SageModel:
    """Two GraphSAGE mean aggregators (concat of the self and neighbour
    halves, no bias, ReLU after the first), the output L2-normalised and a
    dense layer to the classes: the authors' supervised model."""

    def __init__(self, pt, device, state=None):
        pt.seed(5)
        nn = pt.nn
        D = SAGE_DIM
        self.layers = nn.LayerList([
            nn.Linear(SAGE_FEAT, D, bias_attr=False, device=device),
            nn.Linear(SAGE_FEAT, D, bias_attr=False, device=device),
            nn.Linear(2 * D, D, bias_attr=False, device=device),
            nn.Linear(2 * D, D, bias_attr=False, device=device),
            nn.Linear(2 * D, SAGE_CLASSES, device=device)])
        if state is not None:
            with torch.no_grad():
                for p, v in zip(self.params(), state):
                    p.copy_(v)
        self.opt = pt.optimizer.Adam(parameters=self.params(),
                                     learning_rate=SAGE_LR)

    def params(self):
        return list(self.layers.parameters())

    def loss(self, x0, x1, x2, y):
        s1, n1, s2, n2, pred = self.layers
        B, k1, k2 = x0.shape[0], SAGE_FANOUT[0], SAGE_FANOUT[1]
        h0 = torch.relu(torch.cat([s1(x0), n1(x1.view(B, k1, -1).mean(1))],
                                  -1))
        h1 = torch.relu(torch.cat([s1(x1), n1(x2.view(B * k1, k2, -1)
                                               .mean(1))], -1))
        out = torch.cat([s2(h0), n2(h1.view(B, k1, -1).mean(1))], -1)
        out = out / out.norm(dim=1, keepdim=True).clamp_min(1e-12)
        return torch.nn.functional.cross_entropy(pred(out), y)


def sage_batch(g, rng, labels, step):
    """One batch: the nodes, their 2-hop samples, the unique ids' features
    pulled once; returns the host arrays and the sample and pull seconds."""
    batch = rng.choice(SAGE_NODES, SAGE_BATCH, replace=False).astype(
        np.uint64)
    t0 = time.perf_counter()
    hops = g.sample_khop(batch, SAGE_FANOUT, seed=100 + step)
    t1 = time.perf_counter()
    ids = np.concatenate([batch, hops[0][0].ravel(), hops[1][0].ravel()])
    uniq, inv = np.unique(ids, return_inverse=True)
    feats = g.node_feat(uniq)
    t2 = time.perf_counter()
    return (feats, inv, labels[batch.astype(np.int64)], uniq.size,
            t1 - t0, t2 - t1)


def sage_inputs(feats, inv, y, device):
    x = torch.from_numpy(feats).to(device).index_select(
        0, torch.from_numpy(inv).to(device))
    B, k1 = SAGE_BATCH, SAGE_FANOUT[0]
    return (x[:B], x[B:B + B * k1], x[B + B * k1:],
            torch.from_numpy(y).to(device))


def rest_graphsage(pt, seed, failures):
    """(b): GraphSAGE through the graph PS at Reddit's size."""
    from paddle_tpu_torch.distributed import ps
    from paddle_tpu_torch.distributed.ps.graph import \
        deterministic_sample_indices
    t0 = time.perf_counter()
    feats, labels, deg, offsets, dst = sage_graph(seed + 1810)
    gen_s = time.perf_counter() - t0
    srv = ps.PsServer([ps.TableConfig(7, "graph", SAGE_FEAT)], port=0)
    cli = ps.PsClient([f"127.0.0.1:{srv.start()}"])
    g = ps.GraphPsClient(cli, 7, SAGE_FEAT)
    try:
        t0 = time.perf_counter()
        ids = np.arange(SAGE_NODES, dtype=np.uint64)
        for a in range(0, SAGE_NODES, SAGE_NODE_CHUNK):
            g.add_nodes(ids[a:a + SAGE_NODE_CHUNK],
                        feats[a:a + SAGE_NODE_CHUNK])
        nodes_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        cuts = np.searchsorted(offsets, np.arange(
            SAGE_EDGE_CHUNK, offsets[-1], SAGE_EDGE_CHUNK))
        bounds = [0, *sorted(set(int(c) for c in cuts)), SAGE_NODES]
        for a, b in zip(bounds, bounds[1:]):
            if a < b:
                g.add_edges(np.repeat(ids[a:b], deg[a:b]),
                            dst[offsets[a]:offsets[b]])
        edges_s = time.perf_counter() - t0
        n_edges = int(offsets[-1])
        budget = ("within" if nodes_s + edges_s <= SAGE_LOAD_BUDGET_S
                  else "OVER")
        rest_check(f"(b) graph loaded: {SAGE_NODES} nodes x {SAGE_FEAT} "
                   f"features, {n_edges} edges (mean degree "
                   f"{n_edges / SAGE_NODES:.1f})",
                   g.node_count() == SAGE_NODES, failures,
                   f"generated {gen_s:.1f} s; nodes {nodes_s:.1f} s, edges "
                   f"{edges_s:.1f} s ({n_edges / edges_s / 1e6:.2f} M edges/s"
                   f"; {budget} the {SAGE_LOAD_BUDGET_S:g} s budget)")
        rng = np.random.RandomState(seed + 1811)
        check = rng.choice(SAGE_NODES, SAGE_CHECK_NODES, replace=False)
        nbrs, _w, cnt = g.sample_neighbors(check, SAGE_FANOUT[0], seed=77)
        bad = 0
        for i, v in enumerate(check):
            idx = deterministic_sample_indices(77, int(v), int(deg[v]),
                                               SAGE_FANOUT[0])
            want = dst[offsets[v]:offsets[v + 1]][idx]
            bad += int(cnt[i] != len(idx)
                       or not np.array_equal(nbrs[i, :len(idx)], want))
        rest_check(f"(b) the server's samples of {SAGE_CHECK_NODES} nodes "
                   f"(k {SAGE_FANOUT[0]}) equal deterministic_sample_indices",
                   bad == 0, failures, f"{bad} differ")
        # one step on the card and on the CPU from the same weights
        model = SageModel(pt, REST_DEVICE)
        twin = SageModel(pt, "cpu", [p.detach().cpu()
                                     for p in model.params()])
        feats_b, inv, y, _n, _s, _p = sage_batch(g, rng, labels, 0)
        steps, card_grads = {}, None
        for dev, m in ((REST_DEVICE, model), ("cpu", twin)):
            loss = m.loss(*sage_inputs(feats_b, inv, y, dev))
            loss.backward()
            grads = [p.grad.clone() for p in m.params()]
            with torch.no_grad():
                if card_grads is None:
                    card_grads = [g.cpu() for g in grads]
                else:  # the CPU steps from the card's gradient
                    for p, grad in zip(m.params(), card_grads):
                        p.grad.copy_(grad)
            m.opt.step()
            m.opt.clear_grad()
            steps[dev] = (float(loss.detach()), [
                (gr, p.detach().clone()) for gr, p in zip(grads,
                                                          m.params())])
        loss_rel = abs(steps[REST_DEVICE][0] - steps["cpu"][0]) / abs(
            steps["cpu"][0])
        g_rel, p_rel = step_gap(steps[REST_DEVICE][1], steps["cpu"][1])
        rest_check("(b) one step card vs CPU", max(loss_rel, g_rel, p_rel)
                   <= REST_STEP_REL, failures,
                   f"loss rel {loss_rel:.3e}, gradients rel {g_rel:.3e}, "
                   f"parameters after Adam from the card's gradient rel "
                   f"{p_rel:.3e} (tol {REST_STEP_REL:g})")
        del twin
        losses, sample_s, pull_s, uniq = [steps[REST_DEVICE][0]], [], [], []
        dev_ms = []

        def steps_fn():
            for step in range(1, SAGE_STEPS):
                fb, inv_b, yb, n_u, s_s, p_s = sage_batch(g, rng, labels,
                                                          step)
                sample_s.append(s_s)
                pull_s.append(p_s)
                uniq.append(n_u)
                t0 = time.perf_counter()
                loss = model.loss(*sage_inputs(fb, inv_b, yb, REST_DEVICE))
                loss.backward()
                model.opt.step()
                model.opt.clear_grad()
                losses.append(float(loss.detach()))
                dev_ms.append((time.perf_counter() - t0) * 1e3)

        t0 = time.perf_counter()
        prof = profile_step(steps_fn)
        wall = time.perf_counter() - t0
        idle = None if prof is None else 1 - prof[1] / prof[0]
        first, last = np.mean(losses[:3]), np.mean(losses[-3:])
        rest_check(f"(b) {SAGE_STEPS} steps: losses finite, the last 3's "
                   f"mean below the first 3's",
                   bool(np.isfinite(losses).all()) and last < first,
                   failures, f"{first:.4f} -> {last:.4f}")
        rest_check("(b) the profiler saw the steps' device work",
                   prof is not None, failures)
        res = {"generate_s": gen_s, "load_nodes_s": nodes_s,
               "load_edges_s": edges_s, "edges": n_edges,
               "edges_per_s": n_edges / edges_s,
               "sample_ms": float(np.mean(sample_s)) * 1e3,
               "pull_ms": float(np.mean(pull_s)) * 1e3,
               "unique_ids": float(np.mean(uniq)),
               "pull_mb": float(np.mean(uniq)) * SAGE_FEAT * 4 / 1e6,
               "device_step_ms": float(np.mean(dev_ms)),
               "steps_s": wall, "idle": idle,
               "nodes_per_s": SAGE_BATCH * (SAGE_STEPS - 1) / wall,
               "loss_first3": first, "loss_last3": last,
               "card_vs_cpu": {"loss_rel": loss_rel, "grad_rel": g_rel,
                               "param_rel": p_rel}}
        log(f"  (b) GraphSAGE: load {nodes_s + edges_s:.1f} s "
            f"({res['edges_per_s'] / 1e6:.2f} M edges/s); a batch: sampling "
            f"{res['sample_ms']:.1f} ms, feature pull {res['pull_ms']:.1f} "
            f"ms ({res['unique_ids']:.0f} unique ids, {res['pull_mb']:.0f} "
            f"MB), device step (host to device copy, gather, forward, "
            f"backward, Adam) {res['device_step_ms']:.1f} ms; "
            f"{SAGE_STEPS - 1} profiled steps {wall:.2f} s, idle share "
            f"{idle if idle is None else round(idle, 4)}, "
            f"{res['nodes_per_s']:.0f} nodes/s; {card_line()}")
        del model
        return res
    finally:
        ps_close(srv, cli)


def heter_tower(pt, seed):
    """bench_ctr's deep tower on the card with its SGD update, and the
    handler that runs forward, backward and the update per request."""
    from paddle_tpu_torch.nn import functional as F
    pt.seed(seed)
    dims = [CTR_SLOTS * CTR_DIM, *CTR_HIDDEN]
    layers = pt.nn.LayerList([pt.nn.Linear(a, b, device=REST_DEVICE)
                              for a, b in zip(dims, dims[1:])]
                             + [pt.nn.Linear(dims[-1], 1, device=REST_DEVICE)])
    opt = pt.optimizer.SGD(parameters=layers.parameters(),
                           learning_rate=CTR_SGD_LR)
    times = []

    def handler(acts, labels):
        t0 = time.perf_counter()
        a = torch.from_numpy(acts).to(REST_DEVICE).requires_grad_()
        h = a
        for fc in layers[:-1]:
            h = torch.relu(fc(h))
        loss = F.binary_cross_entropy_with_logits(
            layers[-1](h), torch.from_numpy(labels).to(REST_DEVICE))
        loss.backward()
        opt.step()
        opt.clear_grad()
        out = float(loss.detach()), a.grad.cpu().numpy()
        times.append((t0, time.perf_counter()))
        return out

    return layers, handler, times


def heter_worker(ps, cli, table_id, batches, exchange):
    """The host worker's sparse stage over ``batches``; ``exchange(acts,
    labels)`` reaches the tower. Returns the losses and per request the
    (lookup, exchange, push) seconds and the exchange's start and end."""
    from paddle_tpu_torch.distributed.ps.communicator import SyncCommunicator
    from paddle_tpu_torch.distributed.ps.embedding import flush_sparse_grads
    comm = SyncCommunicator(cli, n_workers=1)
    emb = ps.SparseEmbedding([CTR_VOCAB, CTR_DIM], table_id=table_id,
                             init_range=0.05, device="cpu")
    emb.bind(comm)
    losses, spans = [], []
    for ids, label in batches:
        t0 = time.perf_counter()
        acts = emb(torch.from_numpy(ids)).reshape(CTR_BATCH,
                                                  CTR_SLOTS * CTR_DIM)
        t1 = time.perf_counter()
        loss, dacts = exchange(acts.detach().numpy(), label)
        t2 = time.perf_counter()
        acts.backward(torch.from_numpy(dacts))
        flush_sparse_grads(comm)
        comm.step()
        t3 = time.perf_counter()
        losses.append(loss)
        spans.append((t1 - t0, t2 - t1, t3 - t2, t1, t2))
    comm.stop()
    return losses, spans


def rest_heter(pt, seed, failures):
    """(c): the heterogeneous PS at bench_ctr's accelerator size."""
    from paddle_tpu_torch.distributed import ps
    from paddle_tpu_torch.distributed.ps.embedding import reset_registry
    from paddle_tpu_torch.models import ctr
    batches = ctr.synthetic_ctr_batches(HETER_REQUESTS, batch_size=CTR_BATCH,
                                        slots=CTR_SLOTS, vocab=CTR_VOCAB,
                                        seed=PSCTR_SEED)
    tables = [ps.TableConfig(t, "sparse", CTR_DIM, "sgd", lr=CTR_SGD_LR,
                             init_range=0.05, seed=1000)
              for t in (1000, 1001)]
    srv, cli = ps_server(ps, tables)
    reset_registry()
    tower, handler, times = heter_tower(pt, seed + 1820)
    twin, twin_handler, _ = heter_tower(pt, seed + 1820)
    hsrv, port = ps.start_heter_server(handler)
    client = ps.HeterClient(f"127.0.0.1:{port}")
    try:
        with deterministic_algorithms():
            t0 = time.perf_counter()
            losses, spans = heter_worker(ps, cli, 1000, batches,
                                         client.send_and_recv)
            wall = time.perf_counter() - t0
            t0 = time.perf_counter()
            want, direct = heter_worker(ps, cli, 1001, batches, twin_handler)
            direct_wall = time.perf_counter() - t0
        keys = np.unique(np.concatenate([b[0].ravel() for b in batches]))
        rows_same = np.array_equal(cli.pull_sparse(1000, keys),
                                   cli.pull_sparse(1001, keys))
        params_same = all(torch.equal(a, b) for a, b in
                          zip(tower.parameters(), twin.parameters()))
        rest_check(f"(c) {HETER_REQUESTS} requests through the heter "
                   f"channel bitwise the tower called directly: losses, "
                   f"dense parameters, the server's {keys.size} rows",
                   losses == want and params_same and rows_same
                   and bool(np.isfinite(losses).all()), failures,
                   f"losses {losses[0]:.4f} -> {losses[-1]:.4f}")
    finally:
        client.stop_server()
        client.close()
        hsrv.stop()
        ps_close(srv, cli)
        reset_registry()
    sp = np.asarray([s[:3] for s in spans]) * 1e3
    out_ms = [(h0 - s[3]) * 1e3 for s, (h0, _h1) in zip(spans, times)]
    back_ms = [(s[4] - h1) * 1e3 for s, (_h0, h1) in zip(spans, times)]
    trainer_ms = [(h1 - h0) * 1e3 for h0, h1 in times]
    res = {"requests_per_s": HETER_REQUESTS / wall,
           "ms_per_request": wall * 1e3 / HETER_REQUESTS,
           "sparse_lookup_ms": float(sp[:, 0].mean()),
           "sparse_push_ms": float(sp[:, 2].mean()),
           "wire_out_ms": float(np.mean(out_ms)),
           "trainer_ms": float(np.mean(trainer_ms)),
           "wire_back_ms": float(np.mean(back_ms)),
           "direct_ms_per_request": direct_wall * 1e3 / HETER_REQUESTS,
           "direct_tower_ms": float(np.mean([d[1] for d in direct])) * 1e3,
           "frame_mb": CTR_BATCH * CTR_SLOTS * CTR_DIM * 4 / 1e6}
    log(f"  (c) heter: {res['requests_per_s']:.2f} requests/s, "
        f"{res['ms_per_request']:.1f} ms a request: sparse lookup "
        f"{res['sparse_lookup_ms']:.1f} ms, wire to the trainer "
        f"{res['wire_out_ms']:.1f} ms, trainer {res['trainer_ms']:.1f} ms, "
        f"wire back {res['wire_back_ms']:.1f} ms, sparse backward and push "
        f"{res['sparse_push_ms']:.1f} ms ({res['frame_mb']:.1f} MB of "
        f"activations each way); the control calling the tower directly "
        f"{res['direct_ms_per_request']:.1f} ms a request; {card_line()}")
    return res


def tail_cases(pt, gen):
    """(name, fn, inputs, indices of the differentiated inputs) at the
    sizes this phase checks."""
    def f(*shape):
        return seeded(gen, shape)

    def i(lo, hi, *shape):
        return torch.randint(lo, hi, shape, generator=gen)

    ro = torch.zeros(4096, 7, dtype=torch.int32)
    ro[:, 0] = i(0, 4, 4096).int()
    ro[:, 1::2] = i(0, 4, 4096, 3).int()
    ro[:, 2::2] = i(0, 4096, 4096, 3).int()
    tokens = i(1, 5000, 256, 32)
    tokens[:, 24:] = 0
    edges = torch.zeros(16, 64, 2, dtype=torch.int32)
    for b in range(16):
        for n in range(int(i(8, 64, 1))):
            edges[b, n] = torch.tensor([int(i(1, n + 2, 1)), n + 2])
    return [
        ("rank_attention", lambda x, r, p: pt.ops.rank_attention(
            x, r, p, max_rank=3), [f(4096, 64), ro, f(64 * 9, 64)], [0, 2]),
        ("search_pyramid_hash", lambda t, w: pt.ops.search_pyramid_hash(
            t, w, num_emb=128, space_len=100_000, pyramid_layer=4,
            rand_len=16, seed=3), [tokens, f(100_000, 16)], [1]),
        ("tree_conv", lambda n, e, w: pt.ops.tree_conv(n, e, w, max_depth=3),
         [f(16, 64, 64), edges, f(64, 3, 32, 4)], [0, 2]),
        ("var_conv_2d", lambda x, r, c, w: pt.ops.var_conv_2d(
            x, r, c, w, 8, 16), [f(32, 8, 64, 64), i(1, 65, 32),
                                 i(1, 65, 32), f(16, 8, 3, 3)], [0, 3]),
        ("bilateral_slice", lambda x, g, gr: pt.ops.bilateral_slice(
            x, g, gr, True), [f(4, 3, 256, 256),
                              seeded(gen, (4, 256, 256), 0.0, 1.0),
                              f(4, 12, 8, 16, 16)], [0, 1, 2])]


def rest_ctr_tail(pt, seed, failures):
    """(d): the seven CTR tail ops with their gradients, card against
    CPU."""
    from paddle_tpu_torch.core.tensor import unwrap
    gen = torch.Generator()
    gen.manual_seed(seed + 1830)
    res = {}
    for name, fn, inputs, diff in tail_cases(pt, gen):
        runs = {}
        for dev in (REST_DEVICE, "cpu"):
            xs = [x.to(dev).requires_grad_(k in diff)
                  for k, x in enumerate(inputs)]
            t0 = time.perf_counter()
            out = unwrap(fn(*xs))
            cot = seeded(torch.Generator().manual_seed(seed), out.shape).to(
                dev)
            grads = torch.autograd.grad((out * cot).sum(),
                                        [xs[k] for k in diff])
            if dev == REST_DEVICE:
                rest_sync()
            runs[dev] = ([out, *grads], (time.perf_counter() - t0) * 1e3)
        rel = max(max_rel(a, b) for a, b in zip(runs[REST_DEVICE][0],
                                                  runs["cpu"][0]))
        rest_check(f"(d) {name} {list(inputs[0].shape)}: output and "
                   f"{len(diff)} gradients card vs CPU", rel <= TAIL_REL,
                   failures, f"max rel {rel:.3e} (tol {TAIL_REL:g}); card "
                   f"{runs[REST_DEVICE][1]:.1f} ms with the host half, CPU "
                   f"{runs['cpu'][1]:.1f} ms")
        res[name] = {"max_rel": rel, "card_ms": runs[REST_DEVICE][1],
                     "cpu_ms": runs["cpu"][1]}
    x = seeded(gen, (4096, 64)).to(REST_DEVICE).requires_grad_()
    out = unwrap(pt.ops.shuffle_batch(x))
    cot = seeded(gen, (4096, 64)).to(REST_DEVICE)
    (gx,) = torch.autograd.grad((out * cot).sum(), [x])
    perm_ok = (torch.equal(out.detach().sort(0).values, x.detach().sort(
        0).values) and torch.equal(gx.sort(0).values, cot.sort(0).values)
        and not torch.equal(out.detach(), x.detach()))
    rest_check("(d) shuffle_batch [4096, 64] on the card: the output's and "
               "the gradient's rows a permutation of the input's and the "
               "cotangent's", perm_ok, failures)
    tags = torch.randint(0, 20, (4096, 4), generator=gen)
    ins = seeded(gen, (4096, 64))
    filt = torch.tensor([1, 5, 7])
    card = [unwrap(v) for v in pt.ops.filter_by_instag(
        ins.to(REST_DEVICE), tags.to(REST_DEVICE), filt.to(REST_DEVICE))]
    cpu = [unwrap(v) for v in pt.ops.filter_by_instag(ins, tags, filt)]
    rest_check(f"(d) filter_by_instag [4096, 64]: {cpu[0].shape[0]} rows "
               f"kept, equal to the CPU's",
               all(a.device.type == REST_DEVICE and torch.equal(a.cpu(), b)
                   for a, b in zip(card, cpu)), failures)
    return res


def rest_sharded_cache(pt, seed, failures):
    """(e): the cache sharded over a one-rank NCCL mesh axis at phase 16
    (b)'s sizes against the unsharded cache: two fused passes (one CUDA
    graph each) with SGD, and five eager lookup/apply steps with Adam."""
    import torch.distributed as dist
    from paddle_tpu_torch.distributed import parallel_env, ps
    if not dist.is_initialized():
        parallel_env.init_parallel_env(device=REST_DEVICE)
    mesh = parallel_env.make_mesh({"mp": 1})
    tables = [ps.TableConfig(t, "sparse", HBM_DIM, "sgd", lr=HBM_LR,
                             init_range=0.1, seed=1000)
              for t in (1001, 1002, 1003, 1004)]
    rng = np.random.RandomState(seed + 1840)
    batches = [rng.randint(0, HBM_VOCAB, HBM_BATCH).astype(np.int64)
               for _ in range(HBM_STEPS)]
    all_ids = np.concatenate(batches)
    srv, cli = ps_server(ps, tables)
    res = {}
    try:
        def cache(t, opt, **kw):
            return ps.HbmEmbeddingCache(cli, t, HBM_DIM, HBM_CAPACITY,
                                        optimizer=opt, lr=HBM_LR,
                                        device=REST_DEVICE, **kw)

        plain, shard = cache(1001, "sgd"), cache(1002, "sgd", mesh=mesh,
                                                 mesh_axis="mp")

        def emb_loss(e):
            return e.sum()

        losses, ms = {}, {}
        with deterministic_algorithms():
            for name, c in (("plain", plain), ("sharded", shard)):
                c.build_pass(all_ids)
                first = c.run_fused_pass(batches, emb_loss)
                rest_sync()
                t0 = time.perf_counter()
                second = c.run_fused_pass(batches, emb_loss)
                ms[name] = (time.perf_counter() - t0) * 1e3 / HBM_STEPS
                losses[name] = (first, second)
        same = (all(np.array_equal(a, b) for a, b in
                    zip(losses["plain"], losses["sharded"]))
                and torch.equal(plain.table, shard.table))
        plain.end_pass()
        shard.end_pass()
        keys = np.fromiter(plain._slots, np.uint64)
        rows_same = np.array_equal(cli.pull_sparse(1001, keys),
                                   cli.pull_sparse(1002, keys))
        rest_check(f"(e) sharded over a one-rank NCCL axis: two fused passes "
                   f"of {HBM_STEPS} x {HBM_BATCH} ids (SGD) bitwise the "
                   f"unsharded cache: losses, table, the server's "
                   f"{keys.size} rows after end_pass", same and rows_same
                   and shard.table.shape[0] == HBM_CAPACITY, failures,
                   f"{ms['plain']:.3f} ms a batch unsharded, "
                   f"{ms['sharded']:.3f} ms sharded (masks and an "
                   f"all-reduce a gather)")
        del plain, shard
        pa, sa = cache(1003, "adam"), cache(1004, "adam", mesh=mesh,
                                            mesh_axis="mp")
        adam_same = True
        with deterministic_algorithms():
            for ids in batches[:5]:
                outs = []
                for c in (pa, sa):
                    out = c.lookup(torch.from_numpy(ids).to(REST_DEVICE))
                    (out * out).sum().backward()
                    c.apply_grads()
                    outs.append(out.detach())
                adam_same &= torch.equal(*outs)
        adam_same &= all(torch.equal(getattr(pa, k), getattr(sa, k))
                         for k in ("table", "m", "v", "t"))
        rest_check("(e) five eager lookup/apply steps with Adam: the "
                   "sharded cache bitwise the unsharded one (lookups, "
                   "table, moments, steps)", adam_same, failures)
        res = {"plain_ms_per_batch": ms["plain"],
               "sharded_ms_per_batch": ms["sharded"],
               "rows_written_back": int(keys.size)}
        del pa, sa
    finally:
        ps_close(srv, cli)
    return res


def phase18(pt, fa, seed, failures):
    """Phase 18: the rest of the parameter server. A part that raises is a
    failure and the next one still runs. Returns each part's flash
    launches."""
    import traceback
    log("phase 18: the rest of the parameter server: TDM retrieval at "
        "UserBehavior's size, GraphSAGE through the graph PS at Reddit's, "
        "the heterogeneous PS at bench_ctr's, the CTR tail ops card vs CPU, "
        "the cache sharded over a mesh axis")
    t_phase = time.perf_counter()
    out, launches = {}, {}
    for key, part in (("tdm", lambda: rest_tdm(pt, seed, failures)),
                      ("graphsage", lambda: rest_graphsage(pt, seed,
                                                           failures)),
                      ("heter", lambda: rest_heter(pt, seed, failures)),
                      ("ctr_tail", lambda: rest_ctr_tail(pt, seed,
                                                         failures)),
                      ("sharded_cache", lambda: rest_sharded_cache(
                          pt, seed, failures))):
        t0 = time.perf_counter()
        fa.reset_launch_counts()
        try:
            out[key] = part()
        except Exception as e:  # noqa: BLE001 -- reported as a failure
            traceback.print_exc()
            failures.append(f"phase 18 ({key}) raised {type(e).__name__}: "
                            f"{e}")
        counts = flash_launches(fa)
        launches[f"ps_rest_{key}"] = counts
        ok = not any(counts.values())
        log(f"  -- {key}: flash launches {counts} (none expected) "
            f"{'ok' if ok else 'FAIL'}; {time.perf_counter() - t0:.1f} s")
        if not ok:
            failures.append(f"phase 18 ({key}) launched flash kernels "
                            f"{counts}")
        free_cuda()
    out["seconds"] = time.perf_counter() - t_phase
    log(f"  phase 18: {out['seconds']:.1f} s; {card_line()}")
    log(json.dumps({"ps_rest": out}, default=str))
    return launches


# ---- phase 19: the high-level training loop ----------------------------------
#
# Phase 19's sizes and tolerances, fixed before its first run.
# (a) config 1 (BASELINE.md): LeNet on the synthetic MNIST (4096 images),
# batch 64, 2 epochs, Adam 1e-3, through Model.fit on two ring workers; the
# first HAPI_CPU_STEPS losses against the same fit on the CPU (the same
# weights and order, cuDNN deterministic, TF32 off) within HAPI_LOSS_REL
# each (float32 in another summation order; Adam moves a parameter by about
# the rate whatever its gradient's size, so the gap can grow a little a
# step); evaluate's accuracy at least HAPI_ACC_FLOOR (the synthetic bars
# are separable); a save/load round trip predicts bitwise.
# (b) ResNet-50 at 224, batch 64, float32 (hapi ignores amp_configs, as
# the reference does), Momentum at PaddleClas's 0.1 scaled by 64 / 256
# with L2Decay(1e-4), fed by
# HAPI_WORKERS workers from seeded uint8 HWC images of IMG_SIDE_RANGE px:
# RandomCrop(224), RandomHorizontalFlip, ToTensor, Normalize to train (the
# batches copied to the card one ahead, prefetch_to_device) and
# Resize(256), CenterCrop(224) to evaluate; losses finite. (a) also holds
# an epoch with prefetch_to_device bitwise the plain copy's.
# (c) VGG-16 and MobileNetV2 at 224, batch 64: HAPI_ZOO_STEPS fit steps and
# a predict; the first step's forward loss on HAPI_ZOO_CPU_BATCH images
# (train mode, dropout 0) against the CPU within ZOO_LOSS_REL.
# (d) ResNet-50 (convert_sync_batchnorm, DataParallel) with Momentum under
# ZeRO-1 in to_static(scan_steps=SYNC_K, dp_axis="dp") on a one-rank NCCL
# group, two calls, bitwise against plain BatchNorm with the replicated
# Momentum (at one rank SyncBatchNorm is BatchNorm, as torch's own is); and
# SyncBatchNorm's collective path forced at one rank inside a replayed CUDA
# graph against BatchNorm: output, gradients and running buffers within
# SYNC_BN_REL (E[x^2] - E[x]^2 against cuDNN's variance, float32).
# (e) the new ops on the card against the CPU, float32: output and every
# gradient within NEW_OPS_REL (max |diff| / max |ref|), or, where the CPU's
# own float32 result is farther than that from float64, the card's
# distance from float64 within VISION_F64_FACTOR x the CPU's (phase 11's
# rule: the first run failed one case at 1.575e-05 against 1e-05, a
# transposed convolution whose weight gradient sums 200,704 products); the
# max-pool mask equal.
HAPI_DEVICE = "cuda"  # the card; the CPU twins are "cpu"
HAPI_LENET_EPOCHS, HAPI_BATCH = 2, 64
HAPI_CPU_STEPS = 5
HAPI_LOSS_REL = 1e-3
HAPI_ACC_FLOOR = 0.9
HAPI_WORKERS = 6
IMG_SIDE_RANGE = (256, 320)
HAPI_RESNET_STEPS = 12
HAPI_EVAL_IMAGES = 128
HAPI_ZOO_STEPS = 3
HAPI_ZOO_CPU_BATCH = 2
ZOO_LOSS_REL = 1e-4
SYNC_K = 2
SYNC_BN_REL = 1e-4
NEW_OPS_REL = 1e-5
IMAGENET_MEAN = [0.485, 0.456, 0.406]
IMAGENET_STD = [0.229, 0.224, 0.225]


def step_clock():
    """A hapi callback that keeps each training step's end time and
    loss."""
    from paddle_tpu_torch.hapi.callbacks import Callback

    class StepClock(Callback):
        def __init__(self):
            self.ends, self.losses = [], []

        def on_batch_end(self, mode, step, logs=None):
            if mode == "train":
                self.ends.append(time.perf_counter())
                self.losses.append(logs["loss"])

        def steady_ms(self, skip=2):
            """The median step after the first ``skip`` (the capture)."""
            gaps = np.diff(self.ends[skip:])
            return float(np.median(gaps) * 1e3) if len(gaps) else None

    return StepClock()


class ImageSet:
    """Seeded uint8 HWC images of decoded-ImageNet sizes (sides in
    IMG_SIDE_RANGE), 1000 classes: views of one seeded pixel pool, made in
    bulk; ``transform`` runs where the sample is read (a worker)."""

    def __init__(self, n, seed, transform):
        rng = np.random.RandomState(seed)
        lo, hi = IMG_SIDE_RANGE
        self.sides = rng.randint(lo, hi + 1, (n, 2))
        self.pool = rng.randint(0, 256, (hi * hi * 3 * 4,), dtype=np.uint8)
        self.offs = rng.randint(0, hi * hi * 3 * 3, n)
        self.labels = rng.randint(0, 1000, n).astype(np.int64)
        self.transform = transform

    def __len__(self):
        return len(self.labels)

    def image(self, i):
        h, w = self.sides[i]
        return self.pool[self.offs[i]:self.offs[i] + h * w * 3].reshape(
            h, w, 3)

    def __getitem__(self, i):
        return self.transform(self.image(i)), self.labels[i]


def hapi_lenet(pt, seed, failures, tmp):
    """(a): config 1 through Model.fit on the ring workers."""
    from paddle_tpu_torch import hapi, io, metric, nn, optimizer
    from paddle_tpu_torch.vision import datasets
    from paddle_tpu_torch.vision.models import LeNet
    data = datasets.MNIST(mode="train")
    pt.seed(seed + 1900)
    net = LeNet(device=HAPI_DEVICE)
    start = copy.deepcopy(net).to("cpu")

    def model_of(network):
        m = hapi.Model(network)
        m.prepare(optimizer.Adam(learning_rate=1e-3,
                                 parameters=network.parameters()),
                  nn.CrossEntropyLoss(), metric.Accuracy())
        return m

    res = {}
    with cudnn_mode(deterministic=True):
        model = model_of(net)
        clock = step_clock()
        loader = io.DataLoader(data, batch_size=HAPI_BATCH, shuffle=True,
                               num_workers=2, places=HAPI_DEVICE)
        np.random.seed(seed + 1901)
        t0 = time.perf_counter()
        model.fit(loader, epochs=HAPI_LENET_EPOCHS, verbose=0,
                  callbacks=[clock])
        fit_s = time.perf_counter() - t0
        # the CPU twin: the same weights, the same draws (two workers draw
        # the epoch's seed and then its order, as on the card)
        cpu = model_of(start)
        cpu_loader = io.DataLoader(data, batch_size=HAPI_BATCH, shuffle=True,
                                   num_workers=2, places="cpu")
        np.random.seed(seed + 1901)
        cpu_losses = []
        for x, y in cpu_loader:
            cpu_losses.append(cpu.train_batch([x], [y])[0][0])
            if len(cpu_losses) == HAPI_CPU_STEPS:
                break
        ev = model.evaluate(data, batch_size=HAPI_BATCH, verbose=0)
        pred = model.predict(data, batch_size=256, stack_outputs=True)[0]
        path = f"{tmp}/lenet"
        model.save(path)
        pt.seed(seed + 1902)
        again = model_of(LeNet(device=HAPI_DEVICE))
        again.load(path)
        pred2 = again.predict(data, batch_size=256, stack_outputs=True)[0]
    gaps = [abs(a - b) / abs(b) for a, b in zip(
        clock.losses[:HAPI_CPU_STEPS], cpu_losses)]
    ok = max(gaps) <= HAPI_LOSS_REL
    log(f"  (a) LeNet: {len(clock.losses)} steps in {fit_s:.3f} s "
        f"({len(clock.losses) * HAPI_BATCH / fit_s:.1f} images/s, steady "
        f"step {clock.steady_ms():.3f} ms); the first {HAPI_CPU_STEPS} losses "
        f"{[round(v, 6) for v in clock.losses[:HAPI_CPU_STEPS]]} vs the CPU's "
        f"{[round(v, 6) for v in cpu_losses]}: max rel {max(gaps):.3e} "
        f"(tol {HAPI_LOSS_REL:g}) {'ok' if ok else 'FAIL'}")
    if not ok:
        failures.append("phase 19 (a): LeNet's losses disagree with the CPU")
    acc = ev.get("acc")
    ok = acc is not None and acc >= HAPI_ACC_FLOOR and np.isfinite(
        clock.losses).all() and clock.losses[-1] < clock.losses[0]
    log(f"  (a) evaluate {ev} (accuracy floor {HAPI_ACC_FLOOR}); losses "
        f"{clock.losses[0]:.4f} -> {clock.losses[-1]:.4f} "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        failures.append(f"phase 19 (a): LeNet did not learn ({ev})")
    # prefetch_to_device: pinned copies one batch ahead on a side stream,
    # the same batches as the plain copy
    epochs = []
    for ahead in (False, True):
        np.random.seed(seed + 1903)
        epochs.append(list(io.DataLoader(
            data, batch_size=HAPI_BATCH, shuffle=True, num_workers=2,
            places=HAPI_DEVICE, prefetch_to_device=ahead)))
    ahead_ok = len(epochs[0]) == len(epochs[1]) == len(data) // HAPI_BATCH \
        and all(b[0].is_cuda and torch.equal(a[0], b[0])
                and torch.equal(a[1], b[1])
                for a, b in zip(*epochs))
    log(f"  (a) an epoch with prefetch_to_device (pinned, side stream, one "
        f"batch ahead) equals the plain copy's: {ahead_ok} "
        f"{'ok' if ahead_ok else 'FAIL'}")
    if not ahead_ok:
        failures.append("phase 19 (a): prefetch_to_device changed the "
                        "batches")
    same = pred.shape == (len(data), 10) and np.array_equal(pred, pred2)
    log(f"  (a) predict {pred.shape}; save/load round trip predicts "
        f"bitwise: {same} {'ok' if same else 'FAIL'}; captures "
        f"{model.captures()}; ring {loader.last_stats}")
    if not same:
        failures.append("phase 19 (a): the loaded LeNet predicts otherwise")
    res.update(fit_s=fit_s, steps=len(clock.losses),
               steady_step_ms=clock.steady_ms(), eval=ev,
               loss_gap=max(gaps), captures=model.captures())
    return res


def ring_report(label, loader, fit_s):
    st = loader.last_stats or {}
    n = max(st.get("batches", 0), 1)
    wait_s = st.get("wait_ns", 0) / 1e9
    mb_s = st.get("bytes", 0) / 1e6 / max(st.get("read_ns", 1) / 1e9, 1e-9)
    log(f"  {label}: ring {st.get('batches')} batches, "
        f"{st.get('bytes', 0) / 1e6:.1f} MB read at {mb_s:.1f} MB/s; the "
        f"consumer waited {wait_s / n * 1e3:.3f} ms a batch, "
        f"{wait_s / fit_s:.4f} of the fit's time")
    return {"ring_mb_s": mb_s, "wait_ms_per_batch": wait_s / n * 1e3,
            "wait_share": wait_s / fit_s, "ring": st}


def hapi_resnet(pt, seed, failures, vision):
    """(b): ResNet-50 through Model.fit at 224, fed by ring workers."""
    import os
    from paddle_tpu_torch import hapi, io, metric, nn, optimizer
    from paddle_tpu_torch.vision import transforms as T
    from paddle_tpu_torch.vision.models import resnet50
    train_tf = T.Compose([T.RandomCrop(224), T.RandomHorizontalFlip(),
                          T.ToTensor(), T.Normalize(IMAGENET_MEAN,
                                                    IMAGENET_STD)])
    eval_tf = T.Compose([T.Resize(256), T.CenterCrop(224), T.ToTensor(),
                         T.Normalize(IMAGENET_MEAN, IMAGENET_STD)])
    t0 = time.perf_counter()
    train = ImageSet(HAPI_RESNET_STEPS * HAPI_BATCH, seed + 1910, train_tf)
    evals = ImageSet(HAPI_EVAL_IMAGES, seed + 1911, eval_tf)
    made = time.perf_counter() - t0
    t0 = time.perf_counter()
    for i in range(16):
        T.Resize(256)(evals.image(i))
    resize_ms = (time.perf_counter() - t0) / 16 * 1e3
    pt.seed(seed + 1912)
    net = resnet50(device=HAPI_DEVICE)
    model = hapi.Model(net)
    model.prepare(optimizer.Momentum(
        learning_rate=0.1 * HAPI_BATCH / 256, momentum=0.9,
        parameters=net.parameters(),
        weight_decay=pt.L2Decay(1e-4)), nn.CrossEntropyLoss(),
        metric.Accuracy(topk=(1, 5)), amp_configs={"level": "O1"})
    clock = step_clock()
    loader = io.DataLoader(train, batch_size=HAPI_BATCH, shuffle=True,
                           num_workers=HAPI_WORKERS, places=HAPI_DEVICE,
                           prefetch_to_device=True)
    with cudnn_mode(deterministic=False):
        t0 = time.perf_counter()
        model.fit(loader, epochs=1, verbose=0, callbacks=[clock])
        fit_s = time.perf_counter() - t0
        ev = model.evaluate(evals, batch_size=HAPI_BATCH, num_workers=2,
                            verbose=0)
    ok = np.isfinite(clock.losses).all() and np.isfinite(ev["loss"]).all()
    steady = clock.steady_ms()
    steady_rate = HAPI_BATCH / steady * 1e3
    kstep = ((vision or {}).get("resnet50") or {}).get("kstep") or {}
    log(f"  (b) ResNet-50: {HAPI_WORKERS} workers (os.cpu_count() "
        f"{os.cpu_count()}); images made in {made:.2f} s; {len(clock.losses)} "
        f"steps in {fit_s:.3f} s = {len(clock.losses) * HAPI_BATCH / fit_s:.1f}"
        f" images/s of the whole fit (the workers' fork, the first batch and "
        f"the first step's capture included); steady step {steady:.3f} ms = "
        f"{steady_rate:.1f} images/s (float32) against phase 11's bf16 "
        f"k-step {kstep.get('step_ms')} ms on the same shape; Resize(256) "
        f"{resize_ms:.3f} ms an image; captures {model.captures()}; losses "
        f"{[round(v, 4) for v in clock.losses]}; evaluate {ev} "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        failures.append("phase 19 (b): ResNet-50's losses are not finite")
    ring = ring_report("(b) ResNet-50 fit", loader, fit_s)
    return dict(ring, fit_s=fit_s, images_per_s=len(clock.losses) *
                HAPI_BATCH / fit_s, steady_step_ms=steady,
                steady_images_per_s=steady_rate,
                phase11_kstep_ms=kstep.get("step_ms"), resize_ms=resize_ms,
                captures=model.captures(), eval=ev, workers=HAPI_WORKERS,
                cpu_count=os.cpu_count())


def zoo_loss(net, x, y):
    """The training forward's loss with every dropout at rate 0."""
    from paddle_tpu_torch import nn
    from paddle_tpu_torch.nn import functional as F
    net.train()
    saved = {}
    for m in net.modules():
        if isinstance(m, nn.Dropout):
            saved[m] = m.p
            m.p = 0.0
    with torch.no_grad():
        loss = F.cross_entropy(net(x), y)
    for m, p in saved.items():
        m.p = p
    return loss


def hapi_zoo(pt, seed, failures):
    """(c): VGG-16 and MobileNetV2 at 224 through fit and predict."""
    from paddle_tpu_torch import hapi, io, nn, optimizer
    from paddle_tpu_torch.vision import transforms as T
    from paddle_tpu_torch.vision.models import mobilenet_v2, vgg16
    tf = T.Compose([T.RandomCrop(224), T.RandomHorizontalFlip(),
                    T.ToTensor(), T.Normalize(IMAGENET_MEAN, IMAGENET_STD)])
    data = ImageSet(HAPI_ZOO_STEPS * HAPI_BATCH, seed + 1920, tf)
    gen = torch.Generator().manual_seed(seed + 1921)
    xs = torch.randn(HAPI_ZOO_CPU_BATCH, 3, 224, 224, generator=gen)
    ys = torch.randint(0, 1000, (HAPI_ZOO_CPU_BATCH,), generator=gen)
    out = {}
    for name, build in (("vgg16", vgg16), ("mobilenet_v2", mobilenet_v2)):
        pt.seed(seed + 1922)
        net = build(device=HAPI_DEVICE)
        with cudnn_mode(deterministic=True):
            card = float(zoo_loss(net, xs.cuda(), ys.cuda()))
        cpu = float(zoo_loss(copy.deepcopy(net).to("cpu"), xs, ys))
        rel = abs(card - cpu) / abs(cpu)
        model = hapi.Model(net)
        model.prepare(optimizer.Momentum(learning_rate=0.01, momentum=0.9,
                                         parameters=net.parameters()),
                      nn.CrossEntropyLoss())
        clock = step_clock()
        loader = io.DataLoader(data, batch_size=HAPI_BATCH, shuffle=True,
                               num_workers=HAPI_WORKERS, places=HAPI_DEVICE)
        with cudnn_mode(deterministic=False):
            t0 = time.perf_counter()
            model.fit(loader, epochs=1, verbose=0, callbacks=[clock])
            fit_s = time.perf_counter() - t0
            pred = model.predict(io.Subset(data, range(HAPI_BATCH)),
                                 batch_size=HAPI_BATCH,
                                 stack_outputs=True)[0]
        ok = (rel <= ZOO_LOSS_REL and np.isfinite(clock.losses).all()
              and pred.shape == (HAPI_BATCH, 1000)
              and np.isfinite(pred).all())
        log(f"  (c) {name}: forward loss on {HAPI_ZOO_CPU_BATCH} images "
            f"{card:.6f} vs the CPU's {cpu:.6f}: rel {rel:.3e} (tol "
            f"{ZOO_LOSS_REL:g}); {len(clock.losses)} fit steps in "
            f"{fit_s:.3f} s (losses {[round(v, 4) for v in clock.losses]}, "
            f"steady {clock.steady_ms(1)} ms); predict {pred.shape}; "
            f"captures {model.captures()} {'ok' if ok else 'FAIL'}")
        if not ok:
            failures.append(f"phase 19 (c): {name} failed its checks")
        out[name] = dict(ring_report(f"(c) {name} fit", loader, fit_s),
                         cpu_rel=rel, fit_s=fit_s,
                         steady_step_ms=clock.steady_ms(1),
                         losses=clock.losses)
        del model, net, loader
        free_cuda()
    return out


def sync_arm(pt, start, x, y, sync, zero):
    """Two calls of to_static(scan_steps=SYNC_K, dp_axis="dp") from
    ``start``: (losses, the model)."""
    from paddle_tpu_torch import DataParallel, jit, nn, optimizer
    from paddle_tpu_torch.nn import functional as F
    net = copy.deepcopy(start)
    if sync:
        net = nn.SyncBatchNorm.convert_sync_batchnorm(net)
    model = DataParallel(net)
    opt = optimizer.Momentum(learning_rate=0.1, momentum=0.9,
                             parameters=model.parameters(),
                             weight_decay=pt.L2Decay(1e-4))
    if zero:
        opt._zero_enable(axis="dp", stage=1)

    def one(xb, yb):
        loss = F.cross_entropy(model(xb), yb)
        loss.backward()
        opt.step()
        opt.clear_grad()
        return loss
    step = jit.to_static(one, scan_steps=SYNC_K, dp_axis="dp")
    losses = [step(x[c], y[c]) for c in range(2)]
    return torch.cat(losses), net


def hapi_sync(pt, seed, failures):
    """(d): SyncBatchNorm and Momentum under ZeRO-1 at degree 1."""
    import torch.distributed as dist
    from paddle_tpu_torch import jit, nn
    from paddle_tpu_torch.distributed import collective, parallel_env
    from paddle_tpu_torch.vision.models import resnet50
    if not dist.is_initialized():
        parallel_env.init_parallel_env(device=HAPI_DEVICE)
    saved = parallel_env.current_mesh()
    parallel_env.set_mesh(parallel_env.make_mesh({"dp": 1}))
    out = {}
    try:
        pt.seed(seed + 1930)
        start = resnet50(device=HAPI_DEVICE)
        gen = torch.Generator(device="cuda").manual_seed(seed + 1931)
        x = torch.rand(2, SYNC_K, HAPI_BATCH, 3, 224, 224, generator=gen,
                       device="cuda")
        y = torch.randint(0, 1000, (2, SYNC_K, HAPI_BATCH), generator=gen,
                          device="cuda")
        with cudnn_mode(deterministic=True):
            want, plain = sync_arm(pt, start, x, y, sync=False, zero=False)
            got, synced = sync_arm(pt, start, x, y, sync=True, zero=True)
        n_sync = sum(isinstance(m, nn.SyncBatchNorm)
                     for m in synced.modules())
        same = torch.equal(want, got) and all(
            torch.equal(a, b) for a, b in zip(plain.state_dict().values(),
                                              synced.state_dict().values()))
        log(f"  (d) ResNet-50 with {n_sync} SyncBatchNorm layers, Momentum "
            f"under ZeRO-1, to_static(scan_steps={SYNC_K}, dp_axis='dp') on "
            f"a one-rank NCCL group, two calls: losses "
            f"{[round(v, 5) for v in got.tolist()]}; bitwise the plain "
            f"BatchNorm and replicated Momentum (losses, parameters, running "
            f"statistics): {same} {'ok' if same else 'FAIL'}")
        if not same or n_sync != 53:
            failures.append("phase 19 (d): SyncBatchNorm + ZeRO-1 differs "
                            "from BatchNorm + replicated Momentum")
        del start, plain, synced
        free_cuda()
        # the collective path itself, forced at one rank, in a CUDA graph
        bn = nn.BatchNorm2D(256, device=HAPI_DEVICE)
        with torch.no_grad():
            bn.weight.uniform_(0.5, 1.5, generator=gen)
            bn.bias.uniform_(-0.5, 0.5, generator=gen)
        sbn = nn.SyncBatchNorm.convert_sync_batchnorm(copy.deepcopy(bn))
        sbn._force_sync = True
        xs = torch.randn(2, HAPI_BATCH, 256, 56, 56, generator=gen,
                         device="cuda")
        cot = torch.randn(HAPI_BATCH, 256, 56, 56, generator=gen,
                          device="cuda")

        def fwd_bwd(layer):
            def body(xb):
                xb = xb.detach().requires_grad_(True)
                y_ = layer(xb)
                gx, gw, gb = torch.autograd.grad(
                    (y_ * cot).sum(), [xb, layer.weight, layer.bias])
                return y_.detach(), gx, gw, gb
            return body
        prog = jit.to_static(fwd_bwd(sbn))
        prog(xs[0])  # the eager warm-up and the capture
        collective.reset_counts()
        got = prog(xs[1])  # replayed
        replay_calls = collective.counts()
        eager = fwd_bwd(bn)
        eager(xs[0])
        want = eager(xs[1])
        rels = [max_rel(a, b) for a, b in zip(got, want)] + [
            max_rel(sbn._mean, bn._mean), max_rel(sbn._variance,
                                                  bn._variance)]
        ok = max(rels) <= SYNC_BN_REL
        log(f"  (d) SyncBatchNorm's all-reduce path in a replayed CUDA graph "
            f"vs BatchNorm at [{HAPI_BATCH}, 256, 56, 56]: max rel (output, "
            f"dx, dweight, dbias, mean, variance) "
            f"{[f'{r:.2e}' for r in rels]} (tol {SYNC_BN_REL:g}) "
            f"{'ok' if ok else 'FAIL'}; collectives issued by Python in the "
            f"replayed call {replay_calls} (none: the graph holds them)")
        if not ok:
            failures.append("phase 19 (d): SyncBatchNorm's collective path "
                            "disagrees with BatchNorm")
        out.update(bitwise=same, sync_layers=n_sync, forced_rel=rels)
    finally:
        parallel_env.set_mesh(saved)
    return out


def new_op_cases(F, gen):
    """(label, fn, inputs) of the transposed convolutions and the max-pool
    indices at a decoder's shapes."""
    relu = torch.relu(seeded(gen, (HAPI_BATCH, 64, 56, 56)))
    return [
        ("conv2d_transpose [64, 256, 28, 28] k4 s2 p1", lambda x, w, b:
         F.conv2d_transpose(x, w, b, stride=2, padding=1),
         [seeded(gen, (HAPI_BATCH, 256, 28, 28)),
          seeded(gen, (256, 128, 4, 4), -0.05, 0.05),
          seeded(gen, (128,))]),
        ("conv2d_transpose uneven pads, groups 2, NHWC", lambda x, w, b:
         F.conv2d_transpose(x, w, b, stride=2, padding=[1, 0, 2, 1],
                            output_padding=1, groups=2, data_format="NHWC"),
         [seeded(gen, (16, 28, 28, 64)),
          seeded(gen, (64, 32, 3, 3), -0.1, 0.1), seeded(gen, (64,))]),
        ("conv1d_transpose [64, 128, 256] k3 s2", lambda x, w, b:
         F.conv1d_transpose(x, w, b, stride=2, padding=1, output_padding=1),
         [seeded(gen, (HAPI_BATCH, 128, 256)),
          seeded(gen, (128, 64, 3), -0.1, 0.1), seeded(gen, (64,))]),
        ("conv3d_transpose [8, 32, 8, 16, 16] k3 s2", lambda x, w, b:
         F.conv3d_transpose(x, w, b, stride=2, padding=1, output_padding=1),
         [seeded(gen, (8, 32, 8, 16, 16)),
          seeded(gen, (32, 16, 3, 3, 3), -0.1, 0.1), seeded(gen, (16,))]),
        ("max_pool2d_with_index 3x3 s2 p1 ceil + max_unpool2d after ReLU",
         lambda x: F.max_unpool2d(*F.max_pool2d_with_index(
             x, 3, 2, 1, ceil_mode=True), 3, 2, 1, output_size=(56, 56)),
         [relu]),
    ]


def hapi_new_ops(pt, seed, failures):
    """(e): the transposed convolutions and the max-pool indices, card vs
    CPU."""
    from paddle_tpu_torch.nn import functional as F
    gen = torch.Generator().manual_seed(seed + 1940)
    out = {}
    with cudnn_mode(deterministic=True):
        for label, fn, inputs in new_op_cases(F, gen):
            cpu_in = [t.clone().requires_grad_(True) for t in inputs]
            card_in = [t.cuda().requires_grad_(True) for t in inputs]
            f64_in = [t.double().requires_grad_(True) for t in inputs]
            probe = fn(*cpu_in)
            cot = seeded(gen, tuple(probe.shape))
            want = outputs_and_grads(fn, cpu_in, cot)
            got = outputs_and_grads(fn, card_in, cot.cuda())
            exact = outputs_and_grads(fn, f64_in, cot.double())
            rels = [max_rel(a, b) for a, b in zip(got, want)]
            card64 = [max_rel(a, b) for a, b in zip(got, exact)]
            cpu64 = [max_rel(a, b) for a, b in zip(want, exact)]
            ok = all(r <= NEW_OPS_REL or c <= VISION_F64_FACTOR * e
                     for r, c, e in zip(rels, card64, cpu64))
            rel = max(rels)
            log(f"  (e) {label}: output and {len(want) - 1} gradients, card "
                f"vs CPU max rel {[f'{r:.2e}' for r in rels]} (tol "
                f"{NEW_OPS_REL:g}); from float64: card "
                f"{[f'{r:.2e}' for r in card64]}, CPU float32 "
                f"{[f'{r:.2e}' for r in cpu64]} (factor "
                f"{VISION_F64_FACTOR:g}) {'ok' if ok else 'FAIL'}")
            if not ok:
                failures.append(f"phase 19 (e): {label} disagrees with the "
                                f"CPU ({rel:.3e})")
            out[label] = rel
        x = inputs[0].detach()
        _, m_cpu = F.max_pool2d(x, 3, 2, 1, ceil_mode=True, return_mask=True)
        _, m_card = F.max_pool2d(x.cuda(), 3, 2, 1, ceil_mode=True,
                                 return_mask=True)
        zero_windows = int((F.max_pool2d(x, 3, 2, 1, ceil_mode=True) == 0)
                           .sum())
        same = torch.equal(m_cpu, m_card.cpu())
        log(f"  (e) max-pool mask card == CPU: {same} ({zero_windows} "
            f"all-zero windows after the ReLU: ties) "
            f"{'ok' if same else 'FAIL'}")
        if not same:
            failures.append("phase 19 (e): the max-pool mask differs")
    return out


def phase19(pt, fa, seed, failures, vision=None):
    """Phase 19: the high-level training loop. A part that raises is a
    failure and the next one still runs. Returns each part's flash
    launches."""
    import shutil
    import tempfile
    import traceback
    log("phase 19: the high-level training loop: hapi.Model over io's "
        "DataLoader on shared-memory workers with vision.transforms; LeNet "
        "(config 1), ResNet-50, VGG-16, MobileNetV2; SyncBatchNorm and "
        "Momentum under ZeRO-1; the transposed convolutions and max-pool "
        "indices")
    t_phase = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_hapi_")
    out, launches = {}, {}
    try:
        for key, part in (("lenet", lambda: hapi_lenet(pt, seed, failures,
                                                       tmp)),
                          ("resnet50", lambda: hapi_resnet(pt, seed, failures,
                                                           vision)),
                          ("zoo", lambda: hapi_zoo(pt, seed, failures)),
                          ("sync_bn_zero", lambda: hapi_sync(pt, seed,
                                                             failures)),
                          ("new_ops", lambda: hapi_new_ops(pt, seed,
                                                           failures))):
            t0 = time.perf_counter()
            fa.reset_launch_counts()
            try:
                out[key] = part()
            except Exception as e:  # noqa: BLE001 -- reported as a failure
                traceback.print_exc()
                failures.append(f"phase 19 ({key}) raised "
                                f"{type(e).__name__}: {e}")
            counts = flash_launches(fa)
            launches[f"hapi_{key}"] = counts
            ok = not any(counts.values())
            log(f"  -- {key}: flash launches {counts} (none expected) "
                f"{'ok' if ok else 'FAIL'}; {time.perf_counter() - t0:.1f} s")
            if not ok:
                failures.append(f"phase 19 ({key}) launched flash kernels "
                                f"{counts}")
            free_cuda()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    out["seconds"] = time.perf_counter() - t_phase
    log(f"  phase 19: {out['seconds']:.1f} s; {card_line()}")
    log(json.dumps({"hapi": out}, default=str))
    return launches


# ---- phase 20: the optimizer breadth ------------------------------------------

P20_LR = 1e-4                 # (a) Adam's rate, which lamb takes over
P20_GPT_K = 4                 # (a) micro-steps a call: 2 merged updates
P20_GM_K = 2                  # (a) gradient_merge k_steps
P20_BERT_K = 10               # (b) inner steps of the BERT k-step program
P20_SWEEP_LAYERS = 2          # (c) GPT at full width, 2 of its 12 layers
P20_SWEEP_STEPS = 3           # (c) steps a run (one captured call)
P20_RESNET_K = 4              # (d) steps across DGC's rampup boundary
P20_DGC_RAMPUP = 2            # (d) rampup_begin_step
P20_ASP_K = 4                 # (e) steps a call (two localsgd windows)
# (a) the first loss at batch 1: bf16 auto_cast on the card against float32
# on the CPU, the bound of the other bf16-vs-float32 losses
P20_CPU_LOSS_REL = AMP_LOSS_REL_TOL
# (c) the first step on the card against the CPU: the relative L2 of the
# update (new - old, all parameters) against the CPU's from the same
# weights and batch. Both gradients are float32 (the card's through the
# CUDA-core flash kernels); an update that normalises the gradient (Adam's
# kin at step 1 is near lr * sign(g)) turns their rounding apart where g is
# near 0, so this is a bound on the rule, not on the rounding: a different
# rule misses by O(1).
P20_UPDATE_REL = 1e-2


def p20_fleet(**fields):
    """``fleet.init`` with a strategy of ``fields`` on the one-rank NCCL
    group; returns (fleet, strategy)."""
    from paddle_tpu_torch.distributed import fleet
    s = fleet.DistributedStrategy()
    for key, value in fields.items():
        setattr(s, key, value)
    fleet.init(is_collective=True, strategy=s)
    return fleet, s


def p20_bitwise(label, want_losses, got_losses, want_params, got_params,
                failures):
    """Losses and parameters of two runs equal bit for bit."""
    worst = (float((want_losses.float() - got_losses.float()).abs().max()),
             "losses")
    for (n, a), b in zip(want_params, got_params):
        worst = max(worst, (float((a.detach().float()
                                   - b.detach().float()).abs().max()), n))
    ok = worst[0] == 0.0 and bool(torch.isfinite(got_losses).all())
    log(f"  {label}: max |diff| {worst[0]:.3e} ({worst[1]}) (bitwise) "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        failures.append(f"{label}: not bitwise ({worst[1]} "
                        f"{worst[0]:.3e})")
    return ok


def p20_no_flash(label, fa, failures, phase=20):
    counts = flash_launches(fa)
    ok = not any(counts.values())
    log(f"  {label}: flash launches {counts} (none expected) "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        failures.append(f"phase {phase} {label} launched flash kernels "
                        f"{counts}")
    return counts


def p20_gpt_stack(pt, fa, seed, gpt_rate, failures):
    """(a) GPT-small through lamb + gradient_merge + amp, one captured call
    of P20_GPT_K micro-steps; returns each kernel's launches in the eager
    micro-steps (the wrappers' counts)."""
    from paddle_tpu_torch import jit, optimizer
    from paddle_tpu_torch.models.gpt import (GPTForCausalLM, gpt_small,
                                             synthetic_lm_batch)
    fleet, strategy = p20_fleet(
        lamb=True, gradient_merge=True, amp=True,
        gradient_merge_configs={"k_steps": P20_GM_K, "avg": True})
    cfg = gpt_small(hidden_dropout=0.0, attention_dropout=0.0)
    k = P20_GPT_K
    pt.seed(seed + 20)
    model = GPTForCausalLM(cfg, device="cuda")  # float32 parameters
    twin = copy.deepcopy(model)
    start = {n: t.detach().cpu().clone() for n, t in model.state_dict()
             .items()}
    stacked = torch.from_numpy(np.stack([
        synthetic_lm_batch(TRAIN_BATCH, SEQ, cfg.vocab_size,
                           seed=seed + 200 + i) for i in range(k)])).cuda()

    def body_for(m):
        opt = fleet.distributed_optimizer(optimizer.Adam(
            learning_rate=P20_LR, parameters=m.parameters()), strategy)

        def one_step(ids):
            with pt.amp.auto_cast(enable=True, dtype="bfloat16"):
                loss = m.loss(m(ids), ids)
            opt.scale(loss).backward()
            opt.step()
            opt.clear_grad()
            return loss
        return one_step, opt

    # the first loss at batch 1 against the CPU, from the same weights
    ids1 = stacked[0][:1]
    with torch.no_grad(), pt.amp.auto_cast(enable=True, dtype="bfloat16"):
        card = float(model.loss(model(ids1), ids1))
    cpu_model = GPTForCausalLM(cfg, device="cpu")
    cpu_model.load_state_dict(start)
    with torch.no_grad():
        ids_cpu = ids1.cpu()
        cpu = float(cpu_model.loss(cpu_model(ids_cpu), ids_cpu))
    del cpu_model
    rel = abs(card - cpu) / abs(cpu)
    ok = rel <= P20_CPU_LOSS_REL
    log(f"  (a) first loss at batch 1: card (bf16 auto_cast) {card:.6f}, CPU "
        f"(float32) {cpu:.6f}, rel {rel:.2e} (bound {P20_CPU_LOSS_REL:g}) "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        failures.append(f"(a) first loss {rel:.2e} from the CPU's")

    eager_step, eager_opt = body_for(model)
    names = eager_opt._meta_optimizer_names
    fa.reset_launch_counts()  # the main path's eager micro-steps
    want = torch.stack([eager_step(stacked[i]).detach() for i in range(k)])
    launches = flash_launches(fa)
    merged = int(eager_opt._step_count)
    body, opt = body_for(twin)
    program = jit.to_static(body, scan_steps=k)
    with inspect_capture():
        got, peak = first_kstep_call("(a) GPT-small, lamb + gradient_merge "
                                     "+ amp", lambda: program(stacked))
    p20_bitwise(f"(a) GPT-small, {k} micro-steps: one captured call vs "
                f"eager", want, got, list(model.named_parameters()),
                list(twin.parameters()), failures)
    inner = type(opt._inner_opt._inner._inner).__name__  # amp, merge, lamb
    ok = (names == ["lamb", "gradient_merge", "amp"] and inner == "Lamb"
          and merged == k // P20_GM_K == int(opt._step_count))
    log(f"  (a) stack {names}, inner {inner}, merged updates {merged} eager "
        f"/ {int(opt._step_count)} captured in {k} micro-steps "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        failures.append(f"(a) stack {names} or its {merged} updates")
    want_each = cfg.num_layers * k
    for name, n in launches.items():
        ok = n == want_each
        log(f"  (a) {name}: {n} launches in the {k} eager micro-steps "
            f"(wrappers' counts; want {want_each}) {'ok' if ok else 'FAIL'}")
        if not ok:
            failures.append(f"(a) {name} launched {n} times, want "
                            f"{want_each}")
    replays = count_replays(program)
    replays.run(lambda: program(stacked).cpu())
    graph, off = replays.launches()
    for meta in KERNELS:
        name = meta["name"]
        n = graph[name] + off[name]
        ok = n == want_each
        log(f"  (a) {name}: {n} launches in a replayed call, from its graph "
            f"({graph[name]} bf16, {off[name]} CUDA-core; want {want_each}) "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            failures.append(f"(a) replayed call: {name} {n}, want "
                            f"{want_each}")
    calls, tel = timed_kstep(lambda: program(stacked), k, 2,
                             stacked[0].numel(), twin.flops_per_token(SEQ))
    step_ms = tel["step_time_ms"] / k
    versus = ("phase 7 not run" if gpt_rate is None else
              f"phase 7's AdamW k-step {gpt_rate['step_ms']:.3f} ms")
    log(f"  (a) {step_ms:.3f} ms a micro-step (float32 parameters, lamb, "
        f"gradient_merge, amp; {versus}); peak memory of the first call "
        f"{peak:.3f} GB; {card_line()}")
    losses = torch.cat([got.cpu()] + calls)
    if not bool(torch.isfinite(losses).all()):
        failures.append("(a) losses not finite")
    return launches, {"step_ms": step_ms, "peak_gb": peak,
                      "cpu_loss_rel": rel, "stack": names}


def p20_fused_bert(pt, fa, seed, failures):
    """(b) BERT-base (ZERO_BERT_LAYERS) with bench.py's recipe as the
    k-step program, plain against fuse_accumulators."""
    from paddle_tpu_torch import jit, optimizer
    from paddle_tpu_torch.models.bert import BertForPretraining, bert_base
    k = P20_BERT_K
    cfg = bert_base(vocab_size=BERT_VOCAB, num_layers=ZERO_BERT_LAYERS,
                    hidden_dropout=0.0, attention_dropout=0.0)
    pt.seed(seed + 21)
    base = BertForPretraining(cfg, device="cuda").to("bfloat16")
    stacked = bert_batches(seed + 2100, k, 0)
    later = bert_batches(seed + 2200, k, 0)

    def build(fused):
        model = copy.deepcopy(base)
        opt = optimizer.AdamW(parameters=model.parameters(),
                              learning_rate=BERT_LR, multi_precision=True,
                              fuse_accumulators=fused)
        return (jit.to_static(bench_one_step(pt, model, opt), scan_steps=k),
                model, opt)

    out, runs = {}, {}
    t0 = time.perf_counter()
    for fused in (False, True):
        label = "fused" if fused else "plain"
        program, model, opt = build(fused)
        first, _ = first_kstep_call(f"(b) BERT-base {label}",
                                    lambda: program(*stacked))
        runs[label] = (program, model, opt, first.cpu(),
                       [p.detach().clone() for p in model.parameters()])
        _, tel = timed_kstep(lambda: program(*stacked), k, 2,
                             BERT_BATCH * BERT_SEQ,
                             model.flops_per_token(BERT_SEQ))
        prof = report_profile(f"(b) {label} call ({k} steps)", profile_retry(
            lambda: program(*stacked).cpu()), failures)
        # the optimizer's launches in one eager step, its gradients from
        # one eager backward
        with pt.amp.auto_cast(enable=True, dtype="bfloat16"):
            ids, tok, labels, nsp = (t[0] for t in stacked)
            logits, nsp_logits = model(ids, tok)
            model.loss(logits, nsp_logits, labels, nsp).backward()
        opt_prof = profile_step(opt.step)
        opt.clear_grad()
        opt_launches = None if opt_prof is None else sum(opt_prof[3].values())
        busy = None if prof is None else prof["busy_ms"]
        share = (None if prof is None else
                 prof["by_kind_ms"].get("elementwise", 0.0) / busy)
        out[label] = {"step_ms": tel["step_time_ms"] / k,
                      "optimizer_launches": opt_launches,
                      "elementwise_share": share}
        log(f"  (b) BERT-base {label}: {out[label]['step_ms']:.3f} ms a step, "
            f"{opt_launches} kernel launches in one optimizer step, "
            f"elementwise share of the call's device time "
            f"{'not measured' if share is None else f'{share:.4f}'}; "
            f"{card_line()}")
    (_, m0, _, l0, s0), (_, m1, o1, l1, s1) = runs["plain"], runs["fused"]
    p20_bitwise("(b) BERT-base first call: fused vs plain", l0, l1,
                [(n, t) for (n, _), t in zip(m0.named_parameters(), s0)], s1,
                failures)
    log(f"  (b) the two arms: {time.perf_counter() - t0:.1f} s")
    # a fused checkpoint resumes bitwise into a fresh fused optimizer
    import shutil
    t0 = time.perf_counter()
    root = ckpt_dir("phase20_fused")
    shutil.rmtree(root, ignore_errors=True)
    program1 = runs["fused"][0]
    manager_for(root, m1, o1).save(1)
    program2, m2, o2 = build(True)
    with torch.no_grad():  # other weights: the restore must write them
        for p in m2.parameters():
            p.mul_(0.5)
    manager_for(root, m2, o2).restore()
    want = program1(*later).cpu()
    got = program2(*later).cpu()
    p20_bitwise("(b) fused checkpoint restored into fresh objects, the next "
                "call", want, got, list(m1.named_parameters()),
                list(m2.parameters()), failures)
    shutil.rmtree(root, ignore_errors=True)
    log(f"  (b) the checkpoint: {time.perf_counter() - t0:.1f} s")
    return out


P20_SWEEP = {
    # name: (the optimizer from its parameters, the wrapper's own step)
    "Adagrad": lambda o, ps: o.Adagrad(1e-3, parameters=ps),
    "RMSProp": lambda o, ps: o.RMSProp(1e-4, momentum=0.9, centered=True,
                                       parameters=ps),
    "Adadelta": lambda o, ps: o.Adadelta(1.0, parameters=ps),
    "Adamax": lambda o, ps: o.Adamax(1e-4, parameters=ps),
    "DecayedAdagrad": lambda o, ps: o.DecayedAdagrad(1e-3, parameters=ps),
    "ProximalGD": lambda o, ps: o.ProximalGD(1e-2, l1=1e-4, l2=1e-4,
                                             parameters=ps),
    "ProximalAdagrad": lambda o, ps: o.ProximalAdagrad(
        1e-3, l1=1e-5, l2=1e-5, parameters=ps),
    "Ftrl": lambda o, ps: o.Ftrl(1e-2, l1=1e-4, parameters=ps),
    "Lamb": lambda o, ps: o.Lamb(1e-3, parameters=ps),
    "Lars": lambda o, ps: o.Lars(1e-2, parameters=ps),
    "Dpsgd": lambda o, ps: o.Dpsgd(1e-2, clip=1.0, batch_size=8.0,
                                   sigma=1.0, parameters=ps),
}
P20_ELEMENTWISE = ("Adagrad", "RMSProp", "Adadelta", "Adamax",
                   "DecayedAdagrad", "ProximalGD", "ProximalAdagrad", "Ftrl")


def p20_wrapped(name, o, params):
    """(optimizer, the step after it) of a sweep arm: one of P20_SWEEP, or
    Adam under ModelAverage, ExponentialMovingAverage or LookAhead(k=2)."""
    if name in P20_SWEEP:
        return P20_SWEEP[name](o, params), lambda: None
    adam = o.Adam(1e-4, parameters=params)
    if name == "LookAhead":
        return o.LookAhead(adam, alpha=0.5, k=2), lambda: None
    if name == "ModelAverage":
        ma = o.ModelAverage(parameters=params, min_average_window=2,
                            max_average_window=4)
        return adam, ma.step
    ema = o.ExponentialMovingAverage(0.9)
    return adam, lambda: ema.update(params)


def p20_sweep(pt, fa, seed, failures):
    """(c) a 2-layer GPT at full width under every optimizer and averaging
    wrapper, eagerly and as one captured call; the first step against the
    CPU's; the elementwise eight under ZeRO-1/2/3 at one rank."""
    from paddle_tpu_torch import jit
    from paddle_tpu_torch import optimizer as o
    from paddle_tpu_torch.distributed import parallel_env
    from paddle_tpu_torch.models.gpt import (GPTForCausalLM, gpt_small,
                                             synthetic_lm_batch)
    cfg = gpt_small(num_layers=P20_SWEEP_LAYERS, hidden_dropout=0.0,
                    attention_dropout=0.0)
    n = P20_SWEEP_STEPS
    pt.seed(seed + 22)
    base = GPTForCausalLM(cfg, device="cuda")  # float32: CUDA-core flash
    stacked = torch.from_numpy(np.stack([
        synthetic_lm_batch(1, SEQ, cfg.vocab_size, seed=seed + 220 + i)
        for i in range(n)])).cuda()
    # the CPU's first step: its float32 gradient from the same weights
    # (its token embedding, 38.6 M of the 53.6 M parameters, left out of
    # the comparison: a CPU step over it would cost seconds an arm)
    t0 = time.perf_counter()
    cpu_model = copy.deepcopy(base).to("cpu")
    ids = stacked[0].cpu()
    cpu_model.loss(cpu_model(ids), ids).backward()
    compared = [i for i, (n, _) in enumerate(cpu_model.named_parameters())
                if "word_embeddings" not in n and "wte" not in n]
    cpu_params = list(cpu_model.parameters())
    cpu_start = [cpu_params[i].detach().clone() for i in compared]
    cpu_grads = [cpu_params[i].grad.clone() for i in compared]
    log(f"  (c) the CPU's gradient at batch 1: {time.perf_counter() - t0:.1f}"
        f" s; {len(compared)} of {len(cpu_params)} parameters compared")
    del cpu_model, cpu_params

    def run(name, steps, program=False, stage=0):
        model = copy.deepcopy(base)
        params = list(model.parameters())
        opt, after = p20_wrapped(name, o, params)
        if stage:
            opt._zero_enable(axis="dp", stage=stage)

        def body(ids):
            loss = model.loss(model(ids), ids)
            loss.backward()
            opt.step()
            after()
            opt.clear_grad()
            return loss

        pt.seed(seed + 23)  # Dpsgd's draws from here on both sides
        if program:
            losses = jit.to_static(body, scan_steps=steps)(stacked[:steps])
            return losses.detach(), model, None
        first, losses = None, []
        for i in range(steps):
            losses.append(body(stacked[i]).detach())
            if i == 0:
                first = [params[j].detach().cpu().clone() for j in compared]
        return torch.stack(losses), model, first

    out = {}
    t0 = time.perf_counter()
    names = list(P20_SWEEP) + ["ModelAverage", "ExponentialMovingAverage",
                               "LookAhead"]
    for name in names:
        fa.reset_launch_counts()
        want, eager, first = run(name, n)
        counts = flash_launches(fa)
        got, captured, _ = run(name, n, program=True)
        p20_bitwise(f"(c) {name}: {n} steps, one captured call vs eager",
                    want, got, list(eager.named_parameters()),
                    list(captured.parameters()), failures)
        ok = all(c == cfg.num_layers * n for c in counts.values())
        if not ok:
            failures.append(f"(c) {name}: flash launches {counts}")
        rel = None
        if name != "Dpsgd":  # its noise: the card's and the CPU's Philox
            params = [torch.nn.Parameter(t.clone()) for t in cpu_start]
            for p, g in zip(params, cpu_grads):
                p.grad = g.clone()
            cpu_opt, _ = p20_wrapped(name, o, params)
            cpu_opt.step()
            num = sum(float(((c - s) - (q.detach() - s)).square().sum())
                      for c, q, s in zip(first, params, cpu_start))
            den = sum(float((q.detach() - s).square().sum())
                      for q, s in zip(params, cpu_start))
            rel = (num / max(den, 1e-30)) ** 0.5
            if not rel <= P20_UPDATE_REL:
                failures.append(f"(c) {name}: first update {rel:.2e} from "
                                f"the CPU's")
        out[name] = {"update_rel_vs_cpu": rel, "flash": counts}
        log(f"  (c) {name}: flash launches {counts} over {n} eager steps; "
            f"first update vs CPU rel L2 "
            f"{'not compared (noise)' if rel is None else f'{rel:.2e}'} "
            f"(bound {P20_UPDATE_REL:g}) "
            f"{'ok' if ok and (rel is None or rel <= P20_UPDATE_REL) else 'FAIL'}")
        del eager, captured
    log(f"  (c) the {len(names)} arms: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    if parallel_env.current_mesh() is None:
        init_dp_mesh()
    for name in P20_ELEMENTWISE:
        want_losses, want, _ = run(name, n)
        for stage in (1, 2, 3):
            got_losses, got, _ = run(name, n, stage=stage)
            p20_bitwise(f"(c) {name} ZeRO-{stage} at one rank vs replicated",
                        want_losses, got_losses,
                        list(want.named_parameters()),
                        list(got.parameters()), failures)
            del got
        free_cuda()
    log(f"  (c) the ZeRO arms: {time.perf_counter() - t0:.1f} s")
    return out


def p20_resnet(pt, fa, seed, failures):
    """(d) ResNet-50 at 224, batch 64, float32, under strategy.dgc
    (Momentum to DGC) and strategy.lars, as the k-step program across the
    rampup boundary against eager steps; step ms, DGC's top-k ms."""
    from paddle_tpu_torch import jit
    from paddle_tpu_torch.nn import functional as F
    from paddle_tpu_torch.vision.models import resnet50
    k = P20_RESNET_K
    pt.seed(seed + 24)
    base = resnet50(num_classes=RESNET_CLASSES, device="cuda")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed + 240)
    x = torch.randn(k, RESNET_BATCH, 3, RESNET_SIZE, RESNET_SIZE,
                    device="cuda", generator=gen)
    y = torch.randint(0, RESNET_CLASSES, (k, RESNET_BATCH), device="cuda",
                      generator=gen)
    out = {}
    for label, fields in (
            ("dgc", dict(dgc=True, dgc_configs={
                "rampup_begin_step": P20_DGC_RAMPUP, "sparsity": [0.999]})),
            ("lars", dict(lars=True))):
        fleet, strategy = p20_fleet(**fields)

        def build():
            model = copy.deepcopy(base)
            opt, _ = resnet_optimizer(model)
            opt = fleet.distributed_optimizer(opt, strategy)

            def body(xb, yb):
                loss = F.cross_entropy(model(xb), yb)
                loss.backward()
                opt.step()
                opt.clear_grad()
                return loss
            return body, model, opt

        body, model, opt = build()
        pbody, pmodel, popt = build()
        program = jit.to_static(pbody, scan_steps=k)
        # deterministic cuDNN algorithms (no atomics) on both sides, as
        # phase 11's checks: DGC's top-k turns a last-bit difference of a
        # gradient into another selection
        with cudnn_mode(deterministic=True):
            want = torch.stack([body(x[i], y[i]).detach()
                                for i in range(k)])
            got = program(x, y)
        p20_bitwise(f"(d) ResNet-50 {label}: {k} steps across the rampup, "
                    f"one captured call vs eager", want, got,
                    list(model.named_parameters()),
                    list(pmodel.parameters()), failures)
        step_ms = cuda_time_ms(lambda: program(x, y), iters=2,
                               warmup=0) / k  # the graph's algorithms
        inner = opt._inner_opt
        res = {"stack": opt._meta_optimizer_names,
               "optimizer": type(inner).__name__, "step_ms": step_ms}
        if label == "dgc":
            pairs = [(inner._get_accumulator("dgc_v", p).abs().reshape(-1),
                      inner._k_of(p.numel())) for p in model.parameters()]
            topk_ms = cuda_time_ms(lambda: [torch.topk(v, kk)
                                            for v, kk in pairs], iters=10)
            big = max(model.parameters(), key=lambda p: p.numel())
            res.update(topk_ms=topk_ms, topk_share=topk_ms / step_ms,
                       largest=[list(big.shape), inner._k_of(big.numel())])
        out[label] = res
        log(f"  (d) ResNet-50 {label}: stack {res['stack']} -> "
            f"{res['optimizer']}, {step_ms:.3f} ms a step (float32, batch "
            f"{RESNET_BATCH}, one captured call of {k}, deterministic "
            f"cuDNN)"
            + (f", the top-k of every parameter {res['topk_ms']:.3f} ms a "
               f"step ({res['topk_share']:.1%}); the largest "
               f"{res['largest'][0]} keeps k = {res['largest'][1]}"
               if label == "dgc" else "") + f"; {card_line()}")
        del body, model, opt, pbody, pmodel, popt, program
        free_cuda()
    return out


def p20_asp_stack(pt, fa, seed, failures):
    """(e) a 2-layer BERT pruned 2:4 through asp, fp16_allreduce, localsgd
    and sharding (stage 1) at one rank, one captured call against eager."""
    from paddle_tpu_torch import jit, optimizer, sparsity
    from paddle_tpu_torch.models.bert import (BertForPretraining, bert_base,
                                              synthetic_mlm_batch)
    k = P20_ASP_K
    fleet, strategy = p20_fleet(asp=True, fp16_allreduce=True, localsgd=True,
                                localsgd_configs={"k_steps": 2},
                                sharding=True,
                                sharding_configs={"stage": 1})
    cfg = bert_base(vocab_size=BERT_VOCAB, num_layers=2, hidden_dropout=0.0,
                    attention_dropout=0.0)
    pt.seed(seed + 25)
    base = BertForPretraining(cfg, device="cuda")
    batches = [synthetic_mlm_batch(4, BERT_SEQ, BERT_VOCAB,
                                   seed=seed + 250 + i) for i in range(k)]
    stacked = [torch.from_numpy(np.stack(col)).cuda() for col in zip(*batches)]

    def build():
        model = copy.deepcopy(base)
        masks = sparsity.prune_model(model)
        opt = fleet.distributed_optimizer(optimizer.AdamW(
            learning_rate=1e-4, parameters=model.parameters()), strategy)

        def body(ids, tok, labels, nsp):
            logits, nsp_logits = model(ids, tok)
            loss = model.loss(logits, nsp_logits, labels, nsp)
            loss.backward()
            opt.step()
            opt.clear_grad()
            return loss
        return body, model, opt, masks

    body, model, opt, masks = build()
    want = torch.stack([body(*(t[i] for t in stacked)).detach()
                        for i in range(k)])
    pbody, pmodel, popt, pmasks = build()
    got = jit.to_static(pbody, scan_steps=k)(*stacked)
    p20_bitwise(f"(e) BERT 2 layers, asp + fp16_allreduce + localsgd + "
                f"sharding: one captured call of {k} vs eager", want, got,
                list(model.named_parameters()), list(pmodel.parameters()),
                failures)
    masked = [p for p in pmodel.parameters()
              if sparsity.ASPHelper._mask_of(p) is not None]
    zeros = all(bool((p[sparsity.ASPHelper._mask_of(p) == 0] == 0).all())
                for p in masked)
    held = all(sparsity.check_sparsity(p) for p in masked)
    names = popt._meta_optimizer_names
    supported = [p for p in pmodel.parameters()
                 if not getattr(p, "is_bias", False) and p.dim() >= 2]
    ok = (zeros and held and len(masked) == len(supported) > 0
          and all(id(p) in pmasks for p in masked)
          and names == ["sharding", "fp16_allreduce", "localsgd", "asp"])
    log(f"  (e) stack {names}; {len(masked)} pruned weights: every masked "
        f"weight exactly 0 {zeros}, check_sparsity {held} "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        failures.append(f"(e) masks or stack: zeros {zeros}, 2:4 {held}, "
                        f"{names}")
    return {"stack": names, "pruned": len(masked)}


def phase20(pt, fa, seed, failures, gpt_rate=None):
    """Phase 20: the optimizer breadth. A part that raises is a failure
    and the next one still runs. Returns each part's flash launches."""
    import traceback
    log("phase 20: the optimizer breadth: the meta-optimizer stack, "
        "fuse_accumulators, the eleven optimizers and the averaging "
        "wrappers, DGC and LARS on ResNet-50, ASP with sparsity")
    t_phase = time.perf_counter()
    out, launches = {}, {}
    parts = (("gpt_stack", True, lambda: p20_gpt_stack(pt, fa, seed, gpt_rate,
                                                       failures)),
             ("fused_bert", False, lambda: p20_fused_bert(pt, fa, seed,
                                                          failures)),
             ("sweep", True, lambda: p20_sweep(pt, fa, seed, failures)),
             ("resnet50", False, lambda: p20_resnet(pt, fa, seed, failures)),
             ("asp_stack", False, lambda: p20_asp_stack(pt, fa, seed,
                                                        failures)))
    for key, flash, part in parts:
        t0 = time.perf_counter()
        fa.reset_launch_counts()
        try:
            res = part()
            if key == "gpt_stack":
                counts, res = res
                launches["optimizer_stack_gpt_eager"] = counts
            out[key] = res
        except Exception as e:  # noqa: BLE001 -- reported as a failure
            traceback.print_exc()
            failures.append(f"phase 20 ({key}) raised "
                            f"{type(e).__name__}: {e}")
        if not flash:
            launches[f"optimizers_{key}"] = p20_no_flash(f"({key})", fa,
                                                         failures)
        log(f"  -- {key}: {time.perf_counter() - t0:.1f} s")
        free_cuda()
    out["seconds"] = time.perf_counter() - t_phase
    log(f"  phase 20: {out['seconds']:.1f} s; {card_line()}")
    log(json.dumps({"optimizers": out}, default=str))
    return launches


# ---- phase 21: the smaller modules ----------------------------------------

P21_QAT_STEPS = 3        # (a) eager QAT steps counted (after one warm-up)
P21_TIMED = (3, 2)       # (a) 3 alternations of 2 steps, plain and QAT
# (a) the QAT model's first loss against the unquantized model's first loss
# from the same weights and batch: 8-bit fake-quant of every Linear's input
# and weight moves the logits of a freshly initialized GPT-small (loss
# ~ln 50304) by well under 1%.
P21_QAT_LOSS_REL = 2e-2
P21_F32_LAYERS = 2       # (a2) GPT at full width, 2 of its 12 layers
# (a2) one QAT step card against CPU in float32 at 1 x 1024: the loss,
# and every fake-quant level. A level is round(x / s): an input that
# differs by rounding (another summation order) flips a level where it
# sits on a midpoint, one level at most. Inputs and scales "agree" within
# P21_F32_ROUNDING of the input's largest element (the float32 card-vs-CPU
# bound of the repo's other checks); among agreeing elements an input
# within that distance of a midpoint may flip: at most 127 x 1e-5 levels,
# a share well under P21_FLIP_SHARE. A flip moves its element by a whole
# level, so what follows it is counted, not bounded, and the loss holds it.
P21_F32_LOSS_REL = 1e-4
P21_F32_ROUNDING = 1e-5
P21_FLIP_SHARE = 1e-3
P21_CALIB = (4, 16)      # (b) abs_max calibration: batches x images
P21_PCT = (2, 8)         # (b) percentile calibration: batches x images
P21_EVAL = 16            # (b) images the bars are read on
P21_TOP1, P21_GAP = 0.75, 0.5  # (b) the reference's bars
# (b) the served logits (CUDA graphs of the artifact) against the frozen
# model's eager forward on the card: the same float32 ops, cuDNN may pick
# other convolution algorithms in a capture (max |diff| / max |logit|).
P21_SERVED_REL = 1e-4
# (c) LeNet's .onnx evaluated in numpy against the card's forward (float32
# sums in another order).
P21_ONNX_REL, P21_ONNX_ABS = 1e-5, 1e-6
# (d) the BiLSTM-CRF tagger at Lample et al.'s widths (NAACL 2016, sec. 4):
# 100-d word embeddings, one BiLSTM of 100 a direction, dropout 0.5, SGD
# 0.01, gradient norm clipped at 5.0; the character LSTM dropped. Batch 64
# of the synthetic Conll05st (3,000 words, 20 labels, lengths 5-40).
TAG_EMB, TAG_HIDDEN, TAG_DROPOUT = 100, 100, 0.5
TAG_LR, TAG_CLIP, TAG_BATCH, TAG_STEPS = 0.01, 5.0, 64, 5
# (d) the evaluation loss card against CPU (float32 LSTM loops of up to 40
# steps in another order); the decoded paths exact.
TAG_LOSS_REL = 1e-4
# (e) card against CPU: float32 within 1e-4 of the largest element (cuSOLVER
# and cuBLAS against LAPACK, other algorithms), float64 within 1e-10; the
# condition number 1e-3 (it divides singular values); the fused softmaxes
# 1e-6 absolute in float32, 1e-2 in bf16 (one bf16 rounding of a value
# below 1 either side); the custom op exact (one C function on the host).
P21_SWEEP_TOL = {torch.float32: 1e-4, torch.float64: 1e-10}
P21_COND_TOL = 1e-3
P21_SOFTMAX_TOL = {torch.float32: 1e-6, torch.bfloat16: 1e-2}
P21_LINALG_BATCH, P21_LINALG_N = 32, 16

P21_CUSTOM_OP_SRC = r"""
#include <cstdint>
extern "C" {
// y = x^2 + 1
void sq1_forward(const float* x, float* y, int64_t n) {
  for (int64_t i = 0; i < n; ++i) y[i] = x[i] * x[i] + 1.0f;
}
void sq1_backward(const float* x, const float* gy, float* gx, int64_t n) {
  for (int64_t i = 0; i < n; ++i) gx[i] = 2.0f * x[i] * gy[i];
}
}
"""


def p21_check(label, ok, failures, detail=""):
    log(f"  {label}{': ' + detail if detail else ''} "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        failures.append(f"phase 21 {label}" + (f": {detail}" if detail
                                                else ""))
    return ok


def host_copies(prof):
    """Device-to-host copies in a profiled run (``report_profile``'s)."""
    return None if prof is None else sum(
        n for name, n in prof["counts"].items() if "DtoH" in name)


def p21_qat_gpt(pt, fa, seed, eager_ms, failures):
    """(a): QAT of GPT-small at full width and depth with phase 4's recipe,
    against the plain model from the same weights."""
    from paddle_tpu_torch import amp
    from paddle_tpu_torch import quantization as Q
    from paddle_tpu_torch.models.gpt import synthetic_lm_batch
    cfg, model = gpt_small_model(pt, seed + 2100)
    model.to("bfloat16")
    ids = torch.from_numpy(synthetic_lm_batch(
        TRAIN_BATCH, SEQ, cfg.vocab_size, seed=seed + 2101)).cuda()

    def stepper(m):
        opt, sched = make_optimizer(m)

        def one_step():
            with amp.auto_cast(enable=True, dtype="bfloat16"):
                loss = m.loss(m(ids), ids)
            loss.backward()
            opt.step()
            opt.clear_grad()
            sched.step()
            return loss.item()
        return one_step

    plain = copy.deepcopy(model)
    Q.ImperativeQuantAware(
        weight_quantize_type="channel_wise_abs_max").quantize(model)
    n_quant = sum(isinstance(s, Q.QuantizedLinear) for s in model.sublayers())
    p21_check("(a) Linears swapped", n_quant == 4 * cfg.num_layers, failures,
              f"{n_quant} QuantizedLinear (want {4 * cfg.num_layers}; the "
              f"tied LM head is no Linear)")
    plain_step, qat_step = stepper(plain), stepper(model)
    fa.reset_launch_counts()
    losses = [qat_step() for _ in range(P21_QAT_STEPS)]
    counts = flash_launches(fa)
    bf16 = {w.__name__: w.variant_launches["bf16"] for w in (
        fa.flash_attention_fwd, fa.flash_attention_bwd_dq,
        fa.flash_attention_bwd_dkv)}
    want = cfg.num_layers * P21_QAT_STEPS
    p21_check("(a) flash launches over the QAT steps",
              all(n == want for n in counts.values()) and bf16 == counts,
              failures, f"{counts} in {P21_QAT_STEPS} steps, {bf16} bf16 "
              f"(want {want} each, {cfg.num_layers} a step)")
    first_plain = plain_step()
    rel = abs(losses[0] - first_plain) / abs(first_plain)
    p21_check("(a) QAT first loss vs the plain model's", rel <=
              P21_QAT_LOSS_REL and all(np.isfinite(losses)), failures,
              f"{losses[0]:.6f} vs {first_plain:.6f}, rel {rel:.3e} (tol "
              f"{P21_QAT_LOSS_REL:g}); QAT losses "
              f"{[round(x, 4) for x in losses]}")
    reps, n = P21_TIMED
    times = {"plain": [], "qat": []}
    for rep in range(reps):
        for arm in (("plain", "qat") if rep % 2 == 0 else ("qat", "plain")):
            step = plain_step if arm == "plain" else qat_step
            for _ in range(n):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                step()
                times[arm].append((time.perf_counter() - t0) * 1e3)
    med = {arm: float(np.median(v)) for arm, v in times.items()}
    log(f"  (a) eager step ms, medians of {reps} x {n} in turns: plain "
        f"{med['plain']:.3f}, QAT {med['qat']:.3f} "
        f"({med['qat'] / med['plain']:.3f}x); phase 4's eager step "
        + ("not run" if eager_ms is None else f"{eager_ms:.3f} ms")
        + f"; {card_line()}")
    plain_prof = report_profile("plain step", profile_retry(plain_step),
                                failures)
    prof = report_profile("QAT step", profile_retry(qat_step), failures)
    copies = {"plain": host_copies(plain_prof), "qat": host_copies(prof)}
    p21_check("(a) device-to-host copies of a profiled step",
              copies["qat"] is not None and copies["plain"] is not None
              and copies["qat"] <= copies["plain"], failures,
              f"QAT {copies['qat']}, plain {copies['plain']}")
    del plain, model
    free_cuda()
    return counts, {"step_ms_median": med, "step_ms": times,
                    "first_loss": losses[0], "plain_first_loss": first_plain,
                    "first_loss_rel": rel, "host_copies": copies,
                    "quantized_linears": n_quant, "launches": counts,
                    "phase4_eager_ms": eager_ms,
                    "idle": None if prof is None else prof["idle"],
                    "by_kind_ms": None if prof is None else prof["by_kind_ms"],
                    "plain_by_kind_ms": None if plain_prof is None
                    else plain_prof["by_kind_ms"]}


def p21_qat_f32(pt, seed, failures):
    """(a2): a 2-layer GPT at full width, one float32 QAT step at 1 x 1024,
    card against CPU: the loss, and every fake-quant call's input, scale
    and levels. A call whose scale agrees to float32 rounding is compared
    element by element where the two inputs agree to rounding: a flip
    there is a rounding flip (bounded, one level at most). A flip moves an
    element by a whole level (scale / 127), so the calls after the first
    flips see inputs that differ by more than rounding; those are counted
    as downstream and held by the loss."""
    from paddle_tpu_torch import optimizer
    from paddle_tpu_torch import quantization as Q
    from paddle_tpu_torch.models.gpt import (GPTForCausalLM, gpt_small,
                                             synthetic_lm_batch)
    pt.seed(seed + 2120)
    cfg = gpt_small(num_layers=P21_F32_LAYERS, hidden_dropout=0.0,
                    attention_dropout=0.0)
    card = GPTForCausalLM(cfg, device="cuda")
    cpu = copy.deepcopy(card).to("cpu")
    ids = synthetic_lm_batch(1, SEQ, cfg.vocab_size, seed=seed + 2121)
    runs = {}
    for label, m in (("card", card), ("cpu", cpu)):
        Q.ImperativeQuantAware(
            weight_quantize_type="channel_wise_abs_max").quantize(m)
        calls = []
        orig = Q._quantize

        def spy(x, scale, bits):
            qmax = float(2 ** (bits - 1) - 1)
            dt = Q._fq_dtype(x, scale)
            with torch.no_grad():
                s = scale.to(dt) / qmax
                lv = torch.clamp(torch.round(x.detach().to(dt) / s), -qmax,
                                 qmax).to(torch.int16)
                calls.append((x.detach().float().cpu(), scale.detach()
                              .float().cpu(), lv.cpu()))
            return orig(x, scale, bits)

        Q._quantize = spy
        try:
            dev = m.parameters()[0].device
            t = torch.from_numpy(ids).to(dev)
            opt = optimizer.SGD(learning_rate=0.1, parameters=m.parameters())
            loss = m.loss(m(t), t)
            loss.backward()
            opt.step()
        finally:
            Q._quantize = orig
        runs[label] = (loss.item(), calls)
    (lc, card_calls), (lp, cpu_calls) = runs["card"], runs["cpu"]
    agreeing = downstream = flips = worse = 0
    first_downstream = None
    for i, ((xc, sc, lvc), (xp, sp, lvp)) in enumerate(zip(card_calls,
                                                           cpu_calls)):
        scale_ok = bool(torch.all((sc - sp).abs()
                                  <= P21_F32_ROUNDING * sp.abs()))
        near = (xc - xp).abs() <= P21_F32_ROUNDING * xp.abs().max()
        if not scale_ok:
            downstream += lvp.numel()
            first_downstream = i if first_downstream is None \
                else first_downstream
            continue
        d = (lvc.int() - lvp.int()).abs()
        agreeing += int(near.sum())
        downstream += int((~near).sum())
        flips += int((d[near] == 1).sum())
        worse += int((d[near] > 1).sum())
    rel = abs(lc - lp) / abs(lp)
    ok = (rel <= P21_F32_LOSS_REL and worse == 0
          and len(card_calls) == len(cpu_calls)
          and flips <= P21_FLIP_SHARE * max(agreeing, 1)
          and first_downstream != 0 and agreeing > 0)
    total = sum(c[2].numel() for c in cpu_calls)
    p21_check("(a2) float32 QAT step card vs CPU", ok, failures,
              f"loss {lc:.6f} vs {lp:.6f} (rel {rel:.3e}, tol "
              f"{P21_F32_LOSS_REL:g}); {len(cpu_calls)} fake-quant calls, "
              f"{total} levels: {agreeing} with inputs and scale agreeing "
              f"to rounding, of them {flips} one-level flips (share "
              f"{flips / max(agreeing, 1):.2e}, tol {P21_FLIP_SHARE:g}) and "
              f"{worse} of more; {downstream} downstream of a flip (first "
              f"call with another scale: {first_downstream})")
    del card, cpu, runs, card_calls, cpu_calls
    free_cuda()
    return {"loss_rel": rel, "levels": total, "agreeing": agreeing,
            "flips": flips, "more_than_one": worse,
            "downstream": downstream, "first_downstream_call":
                first_downstream}


def p21_ptq_resnet(pt, serving, seed, failures):
    """(b): PTQ of ResNet-50 at 224 (float32), saved as the quantized
    artifact and served by ``inference.Predictor`` and ``serving.Engine``;
    then ``percentile`` calibration's host seconds."""
    from paddle_tpu_torch import inference, jit
    from paddle_tpu_torch import quantization as Q
    from paddle_tpu_torch.vision.models import resnet50
    pt.seed(seed + 2130)
    model = resnet50(device="cuda").eval()
    pct_model = copy.deepcopy(model)
    rng = np.random.RandomState(seed + 2131)

    def images(n):
        return torch.from_numpy(rng.rand(n, 3, 224, 224).astype(
            np.float32)).cuda()

    calib = [(images(P21_CALIB[1]),) for _ in range(P21_CALIB[0])]
    x = images(P21_EVAL)
    with torch.no_grad():
        float_logits = model(x).cpu().numpy()
    t0 = time.perf_counter()
    Q.PTQ(algo="abs_max").quantize(model, calib)
    calib_s = time.perf_counter() - t0
    with torch.no_grad():
        frozen = model(x).cpu().numpy()
    prefix = art_path("resnet50_ptq")
    t0 = time.perf_counter()
    Q.ImperativeQuantAware.save_quantized_model(
        model, prefix, input_spec=[jit.InputSpec([None, 3, 224, 224],
                                                 "float32", "image")])
    save_s = time.perf_counter() - t0
    records = {name: sub.quant_scales() for name, sub in
               model.named_sublayers(include_self=True)
               if isinstance(sub, Q._QuantLayerMixin)}
    p21_check("(b) the sidecar equals quant_scales()",
              Q.load_quant_scales(prefix) == records and len(records) == 54,
              failures, f"{len(records)} layers (53 Conv2D + the fc)")
    t0 = time.perf_counter()
    pred = inference.create_predictor(inference.Config(
        prefix + ".pdmodel", prefix + ".pdiparams"))
    load_s = {"predictor": time.perf_counter() - t0}
    pred.get_input_handle(pred.get_input_names()[0]).copy_from_cpu(
        x.cpu().numpy())
    pred.run()
    served = pred.get_output_handle(pred.get_output_names()[0]).copy_to_cpu()
    pred.close()
    t0 = time.perf_counter()
    with serving.Engine(prefix, bucket_ladder=(1, 8), device="cuda") as eng:
        load_s["engine"] = time.perf_counter() - t0
        (b1,) = eng.predict(x[:1].cpu().numpy())
        (b8,) = eng.predict(x[:8].cpu().numpy())
    agree = float((served.argmax(-1) == float_logits.argmax(-1)).mean())
    gap = float(np.abs(served - float_logits).mean()
                / (np.abs(float_logits).mean() + 1e-6))
    p21_check("(b) PTQ ResNet-50 served vs the float model", agree >= P21_TOP1
              and gap < P21_GAP, failures, f"top-1 agreement {agree:.4f} "
              f"(>= {P21_TOP1}), mean relative logit gap {gap:.4f} (< "
              f"{P21_GAP})")
    rels = {"predictor": max_rel(served, frozen),
            "engine_bucket_1": max_rel(b1, frozen[:1]),
            "engine_bucket_8": max_rel(b8, frozen[:8])}
    p21_check("(b) served logits vs the frozen model's eager forward",
              max(rels.values()) <= P21_SERVED_REL, failures,
              ", ".join(f"{k} {v:.3e}" for k, v in rels.items())
              + f" (tol {P21_SERVED_REL:g})")
    pct = [(images(P21_PCT[1]),) for _ in range(P21_PCT[0])]
    t0 = time.perf_counter()
    Q.PTQ(algo="percentile").quantize(pct_model, pct)
    pct_s = time.perf_counter() - t0
    pct_scales = [float(s._act_scale) for s in pct_model.sublayers()
                  if isinstance(s, Q._QuantLayerMixin)]
    p21_check("(b) percentile calibration", all(
        np.isfinite(pct_scales)) and min(pct_scales) > 0, failures,
        f"{P21_PCT[0]} batches of {P21_PCT[1]}: {pct_s:.2f} s on the host "
        f"(np.quantile over each layer's samples), abs_max over "
        f"{P21_CALIB[0]} x {P21_CALIB[1]}: {calib_s:.2f} s, the artifact's "
        f"save {save_s:.2f} s, loads {load_s}; {card_line()}")
    del model, pct_model
    free_cuda()
    return {"top1_agreement": agree, "logit_gap": gap, "served_rel": rels,
            "percentile_s": pct_s, "abs_max_calib_s": calib_s,
            "save_s": save_s, "load_s": load_s}


def p21_onnx(pt, seed, failures):
    """(c): LeNet's and ResNet-50's ONNX files; GPT-small's refusal."""
    import collections
    import os
    from paddle_tpu_torch import jit, onnx
    from paddle_tpu_torch.models.gpt import GPTForCausalLM, gpt_small
    from paddle_tpu_torch.vision.models import LeNet, resnet50
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(
        __file__)), "tests"))
    from test_torch_onnx import run_onnx  # numpy only
    out = {}
    pt.seed(seed + 2140)
    lenet = LeNet(device="cuda").eval()
    t0 = time.perf_counter()
    path = onnx.export(lenet, art_path("lenet"), input_spec=[
        jit.InputSpec([None, 1, 28, 28], "float32", "image")])
    out["lenet_export_s"] = time.perf_counter() - t0
    x = np.random.RandomState(seed + 2141).randn(1, 1, 28, 28).astype(
        np.float32)
    with torch.no_grad():
        want = lenet(torch.from_numpy(x).cuda()).cpu().numpy()
    (got,) = run_onnx(path, x)
    err = float(np.abs(got - want).max())
    bound = P21_ONNX_REL * float(np.abs(want).max()) + P21_ONNX_ABS
    kinds = collections.Counter(n[0] for n in onnx.read_model(path)["nodes"])
    p21_check("(c) LeNet's .onnx (numpy evaluator) vs the card's forward",
              err <= bound and got.shape == want.shape, failures,
              f"max |diff| {err:.3e} (bound {bound:.3e}); nodes {dict(kinds)}")
    out["lenet_max_abs_err"] = err
    net = resnet50(device="cuda").eval()
    t0 = time.perf_counter()
    path = onnx.export(net, art_path("resnet50"), input_spec=[
        jit.InputSpec([1, 3, 224, 224], "float32", "image")])
    out["resnet50_export_s"] = time.perf_counter() - t0
    model = onnx.read_model(path)
    kinds = collections.Counter(n[0] for n in model["nodes"])
    out["resnet50_nodes"] = dict(kinds)
    p21_check("(c) ResNet-50's .onnx", kinds["Conv"] == 53 and
              model["opset"] == 13 and len(model["inputs"]) == 1, failures,
              f"{sum(kinds.values())} nodes by type {dict(kinds)}, "
              f"{len(model['initializers'])} initializers, export "
              f"{out['resnet50_export_s']:.2f} s")
    del net, lenet
    gpt = GPTForCausalLM(gpt_small(hidden_dropout=0.0, attention_dropout=0.0),
                         device="cuda").eval()
    raised = None
    try:
        onnx.export(gpt, art_path("gpt"), input_spec=[
            jit.InputSpec([1, SEQ], "int64", "ids")])
    except onnx.UnsupportedPrimitive as e:
        raised = str(e)
    p21_check("(c) GPT-small refused by name", raised is not None and
              "paddle_tpu_torch::flash_attention_fwd" in raised, failures,
              repr(raised))
    del gpt
    free_cuda()
    return out


def tagger_model(pt, vocab, n_tags, device):
    """Lample et al.'s BiLSTM-CRF without its character LSTM."""
    from paddle_tpu_torch import nn
    from paddle_tpu_torch.nn import initializer as I

    class Tagger(nn.Layer):
        def __init__(self):
            super().__init__()
            self.emb = nn.Embedding(vocab, TAG_EMB, device=device)
            self.drop = nn.Dropout(TAG_DROPOUT)
            self.lstm = nn.LSTM(TAG_EMB, TAG_HIDDEN, direction="bidirect",
                                device=device)
            self.proj = nn.Linear(2 * TAG_HIDDEN, n_tags, device=device)
            # fluid's [N + 2, N] layout: start, stop, then the square
            self.trans = self.create_parameter(
                [n_tags + 2, n_tags], device=device,
                default_initializer=I.Uniform(-0.1, 0.1))

        def forward(self, words):
            h, _ = self.lstm(self.drop(self.emb(words)))
            return self.proj(self.drop(h))

    return Tagger()


def tagger_batch(data, start):
    rows = [data[i] for i in range(start, start + TAG_BATCH)]
    T = max(len(r[0]) for r in rows)
    words = np.zeros((TAG_BATCH, T), np.int64)
    labels = np.zeros((TAG_BATCH, T), np.int64)
    for i, (w, _, lab) in enumerate(rows):
        words[i, :len(w)], labels[i, :len(lab)] = w, lab
    lens = np.array([len(r[0]) for r in rows], np.int64)
    return words, labels, lens


def p21_tagger(pt, seed, failures):
    """(d): the BiLSTM-CRF tagger trained through ``linear_chain_crf``,
    decoded through ``crf_decoding`` and ``viterbi_decode``, card vs CPU."""
    from paddle_tpu_torch import nn, optimizer, text
    data = text.Conll05st(mode="train")
    n_tags, vocab = len(data.label_dict), len(data.word_dict)
    pt.seed(seed + 2150)
    model = tagger_model(pt, vocab, n_tags, "cuda")
    opt = optimizer.SGD(learning_rate=TAG_LR, parameters=model.parameters(),
                        grad_clip=nn.ClipGradByGlobalNorm(TAG_CLIP))

    def batch_on(b, dev):
        return [torch.from_numpy(a).to(dev) for a in b]

    def nll(m, words, labels, lens):
        return text.linear_chain_crf(m(words), labels, m.trans, lens).mean()

    model.train()
    losses, t0 = [], time.perf_counter()
    for step in range(TAG_STEPS):
        w, lab, ln = batch_on(tagger_batch(data, step * TAG_BATCH), "cuda")
        loss = nll(model, w, lab, ln)
        loss.backward()
        opt.step()
        opt.clear_grad()
        losses.append(loss.item())
    train_ms = (time.perf_counter() - t0) * 1e3 / TAG_STEPS
    model.eval()
    cpu = copy.deepcopy(model).to("cpu")
    held = tagger_batch(data, TAG_STEPS * TAG_BATCH)
    with torch.no_grad():
        wc, lc, nc = batch_on(held, "cuda")
        wp, lp, np_ = batch_on(held, "cpu")
        em_card, em_cpu = model(wc), cpu(wp)
        loss_card = float(text.linear_chain_crf(em_card, lc, model.trans,
                                                nc).mean())
        loss_cpu = float(text.linear_chain_crf(em_cpu, lp, cpu.trans,
                                               np_).mean())
        # the same emissions decoded on both devices
        shared = em_cpu.to("cuda")
        paths_card = text.crf_decoding(shared, model.trans, length=nc).cpu()
        paths_cpu = text.crf_decoding(em_cpu, cpu.trans, length=np_)
        own = text.crf_decoding(em_card, model.trans, length=nc).cpu()
        # viterbi_decode in its [N, N] layout with BOS and EOS as the last
        # two tags, the CRF's start and stop rows moved there
        full = torch.full((n_tags + 2, n_tags + 2), -1e4)
        tr = cpu.trans.detach()
        full[:n_tags, :n_tags] = tr[2:]
        full[n_tags, :n_tags] = tr[0]
        full[:n_tags, n_tags + 1] = tr[1]
        pot = torch.cat([em_cpu, torch.full(em_cpu.shape[:2] + (2,), -1e4)],
                        dim=-1)
        vs_card, vp_card = text.viterbi_decode(pot.cuda(), full.cuda(), nc)
        vs_cpu, vp_cpu = text.viterbi_decode(pot, full, np_)
    rel = abs(loss_card - loss_cpu) / abs(loss_cpu)
    inside = torch.arange(held[0].shape[1])[None, :] < torch.from_numpy(
        held[2])[:, None]
    same_crf = torch.equal(paths_card, paths_cpu)
    same_vit = torch.equal(vp_card.cpu(), vp_cpu) and torch.equal(
        vs_card.cpu(), vs_cpu)
    layouts = torch.equal(torch.where(inside, vp_cpu, 0), paths_cpu)
    agree_own = float((own == paths_cpu)[inside].float().mean())
    ok = (rel <= TAG_LOSS_REL and same_crf and same_vit and layouts
          and all(np.isfinite(losses)))
    p21_check("(d) BiLSTM-CRF card vs CPU", ok, failures,
              f"{TAG_STEPS} SGD steps of {TAG_BATCH} sentences "
              f"({train_ms:.1f} ms a step), losses "
              f"{[round(x, 4) for x in losses]}; held-out loss {loss_card:.6f}"
              f" vs {loss_cpu:.6f} (rel {rel:.3e}, tol {TAG_LOSS_REL:g}); "
              f"crf_decoding paths equal {same_crf}, viterbi_decode paths "
              f"and scores equal {same_vit}, the two layouts' paths equal "
              f"{layouts}; each device's own emissions agree on "
              f"{agree_own:.4f} of the tags")
    del model, cpu
    free_cuda()
    return {"losses": losses, "step_ms": train_ms, "loss_rel": rel,
            "own_emissions_agreement": agree_own}


def p21_linalg_cases(L, dtype, gen):
    """name -> (call(*inputs) -> comparable tensors, inputs on the CPU)."""
    b, n = P21_LINALG_BATCH, P21_LINALG_N

    def rnd(*shape):
        return torch.randn(*shape, generator=gen, dtype=torch.float64).to(
            dtype)

    eye = torch.eye(n, dtype=dtype)
    sq = rnd(b, n, n) + n ** 0.5 * eye
    spd = sq @ sq.mT / n + eye
    chol = torch.linalg.cholesky(spd)
    tall = rnd(4 * n, n)

    def recon_svd(a):
        u, s, v = L.svd(a)
        return [s, u @ (s.unsqueeze(-1) * v)]

    def recon_eigh(a):
        w, q = L.eigh(a)
        return [w, q @ (w.unsqueeze(-1) * q.mT)]

    def recon_qr(a):
        q, r = L.qr(a)
        return [q @ r, r.abs()]

    def eig_sorted(a):
        w = L.eig(a)[0].as_subclass(torch.Tensor)  # torch's .real, .imag
        key = torch.round(w.real.double() * 1e3) * 1e6 + w.imag.double()
        w = torch.gather(w, -1, torch.argsort(key, dim=-1))
        return [w.real, w.imag]

    def eigvals_sorted(a):
        w = L.eigvals(a).as_subclass(torch.Tensor)
        key = torch.round(w.real.double() * 1e3) * 1e6 + w.imag.double()
        w = torch.gather(w, -1, torch.argsort(key, dim=-1))
        return [w.real, w.imag]

    return {
        "cholesky": (lambda a: [L.cholesky(a)], [spd]),
        "inv": (lambda a: [L.inv(a)], [sq]),
        "det": (lambda a: [L.det(a)], [sq]),
        "slogdet": (lambda a: [L.slogdet(a)], [sq]),
        "svd": (recon_svd, [rnd(b, 2 * n, n)]),
        "eig": (eig_sorted, [sq]),
        "eigh": (recon_eigh, [spd]),
        "eigvals": (eigvals_sorted, [sq]),
        "eigvalsh": (lambda a: [L.eigvalsh(a)], [spd]),
        "solve": (lambda a, y: [L.solve(a, y)], [sq, rnd(b, n, 4)]),
        "triangular_solve": (lambda a, y: [L.triangular_solve(a, y)],
                             [torch.triu(sq), rnd(b, n, 4)]),
        "lstsq": (lambda a, y: list(L.lstsq(a, y))[:2] + [
            L.lstsq(a, y)[3]], [tall, rnd(4 * n, 3)]),
        "matrix_power": (lambda a: [L.matrix_power(a / n ** 0.5, 3)], [sq]),
        "pinv": (lambda a: [L.pinv(a)], [rnd(b, 2 * n, n)]),
        "qr": (recon_qr, [rnd(b, 2 * n, n)]),
        "matrix_rank": (lambda a: [L.matrix_rank(a)], [sq]),
        "norm": (lambda a: [L.norm(a)], [sq]),
        "cond": (lambda a: [L.cond(a)], [sq]),
        "multi_dot": (lambda a, c, d: [L.multi_dot([a, c, d])],
                      [rnd(n, 2 * n), rnd(2 * n, n), rnd(n, 3)]),
        "cholesky_solve": (lambda y, f: [L.cholesky_solve(y, f)],
                           [rnd(b, n, 4), chol]),
    }


def p21_sweep(pt, seed, failures):
    """(e): linalg, the op tail, the segment ops, the fused softmaxes and
    the distributions card against CPU; the custom op built at run time."""
    import os
    import tempfile
    from paddle_tpu_torch import distribution as D
    from paddle_tpu_torch import incubate, linalg
    from paddle_tpu_torch.ops import misc_tail as M
    out = {"worst": {}}
    gen = torch.Generator().manual_seed(seed + 2160)
    bad = []

    def compare(name, card, cpu, tol):
        worst = max((max_rel(c, p, torch.float64)
                     for c, p in zip(card, cpu)), default=0.0)
        out["worst"][name] = worst
        if not worst <= tol:
            bad.append(f"{name} {worst:.3e} (tol {tol:g})")

    for dtype in (torch.float32, torch.float64):
        for name, (call, inputs) in p21_linalg_cases(linalg, dtype,
                                                     gen).items():
            tol = P21_COND_TOL if name == "cond" else P21_SWEEP_TOL[dtype]
            tag = f"linalg.{name} {str(dtype)[6:]}"
            compare(tag, call(*[x.cuda() for x in inputs]), call(*inputs),
                    tol)

    def f32(*shape):
        return torch.randn(*shape, generator=gen)

    ids = torch.randint(0, 64, (64, 512), generator=gen)
    probs = torch.rand(4096, 64, generator=gen)
    probs /= probs.sum(1, keepdim=True)
    u = torch.rand(4096, generator=gen)
    tail = {
        "mean_iou": (lambda p, q: list(M.mean_iou(p, q, 64)), [ids, torch.roll(
            ids, 1, 0)]),
        "diag_embed": (lambda x: [M.diag_embed(x, offset=1)], [f32(64, 256)]),
        "bilinear_tensor_product": (
            lambda x, y, w: [M.bilinear_tensor_product(x, y, w)],
            [f32(512, 64), f32(512, 48), f32(32, 64, 48)]),
        "shard_index": (lambda i: [M.shard_index(i, 64, 4, 1)], [ids]),
        "sampling_id": (lambda p, v: [M._sample_ids(p, v)], [probs, u]),
        "match_matrix_tensor": (lambda x, y, w: [M.match_matrix_tensor(
            x, y, w)[0]], [f32(16, 32, 64), f32(16, 40, 64),
                           f32(64, 4, 64)]),
        "add_position_encoding": (lambda x: [M.add_position_encoding(
            x, 0.5, 2.0)], [f32(16, 512, 256)]),
        "batch_fc": (lambda x, w, c: [M.batch_fc(x, w, c)],
                     [f32(16, 512, 64), f32(16, 64, 32), f32(16, 1, 32)]),
        "polygon_box_transform": (lambda x: [M.polygon_box_transform(x)],
                                  [f32(8, 8, 128, 128)]),
        "correlation": (lambda a, c: [M.correlation(a, c, 4, 1, 4, 1, 2)],
                        [f32(4, 64, 48, 64), f32(4, 64, 48, 64)]),
        "sequence_topk_avg_pooling": (
            lambda x, n: [M.sequence_topk_avg_pooling(x, n, [1, 3, 5])],
            [f32(64, 8, 100), torch.randint(1, 100, (64,), generator=gen)]),
    }
    seg = torch.sort(torch.randint(0, 4096, (100_000,), generator=gen)
                     ).values
    data = f32(100_000, 64)
    for kind in ("sum", "mean", "max", "min"):
        fn = getattr(incubate, f"segment_{kind}")
        tail[f"segment_{kind}"] = (lambda d, s, fn=fn: [fn(d, s)], [data, seg])
    for name, (call, inputs) in tail.items():
        compare(name, call(*[x.cuda() for x in inputs]), call(*inputs),
                P21_SWEEP_TOL[torch.float32])
    del data, seg

    x = f32(TRAIN_BATCH, 12, SEQ, SEQ)
    mask = torch.where(torch.rand(TRAIN_BATCH, 1, SEQ, SEQ, generator=gen)
                       < 0.1, -1e4, 0.0)
    for dtype in (torch.bfloat16, torch.float32):
        xd, md = x.to(dtype), mask.to(dtype)
        got = incubate.softmax_mask_fuse_upper_triangle(xd.cuda()).cpu()
        want = incubate.softmax_mask_fuse_upper_triangle(xd)
        err = float((got.float() - want.float()).abs().max())
        got = incubate.softmax_mask_fuse(xd.cuda(), md.cuda()).cpu()
        want = incubate.softmax_mask_fuse(xd, md)
        err = max(err, float((got.float() - want.float()).abs().max()))
        del got, want
        name = f"softmax_mask_fuse {str(dtype)[6:]} [8, 12, 1024, 1024]"
        out["worst"][name] = err
        if not err <= P21_SOFTMAX_TOL[dtype]:
            bad.append(f"{name} {err:.3e} (tol {P21_SOFTMAX_TOL[dtype]:g})")
    del x, mask
    free_cuda()

    loc, scale, value = f32(64, 1), f32(64, 1).abs() + 0.5, f32(64, 256)
    logits, logits2 = f32(256, 100), f32(256, 100)
    cls = torch.randint(0, 100, (256,), generator=gen)

    def dist_outputs(dev):
        n1 = D.Normal(loc.to(dev), scale.to(dev))
        n2 = D.Normal(loc.to(dev) + 0.3, scale.to(dev) * 1.7)
        uni = D.Uniform(loc.to(dev), loc.to(dev) + scale.to(dev))
        c1, c2 = D.Categorical(logits.to(dev)), D.Categorical(logits2.to(dev))
        v = value.to(dev)
        lp = uni.log_prob(v)
        inside = torch.isfinite(lp)
        return [n1.log_prob(v), n1.probs(v), n1.entropy(), n1.kl_divergence(
            n2), torch.where(inside, lp, torch.zeros_like(lp)),
            inside.float(), uni.probs(v), uni.entropy(),
            c1.log_prob(cls.to(dev)), c1.probs(cls.to(dev)), c1.entropy(),
            c1.kl_divergence(c2)]

    compare("distributions", dist_outputs("cuda"), dist_outputs("cpu"),
            P21_SWEEP_TOL[torch.float32])
    draws = D.Normal(torch.zeros(()).cuda(), torch.ones(())
                     .cuda()).sample([1_000_000], seed=seed + 1)
    moments = (float(draws.mean()), float(draws.std()))
    if not (abs(moments[0]) < 0.01 and abs(moments[1] - 1) < 0.01
            and draws.is_cuda):
        bad.append(f"Normal draws' moments {moments}")

    with tempfile.TemporaryDirectory() as tmp:
        src = os.path.join(tmp, "sq1.cc")
        with open(src, "w") as f:
            f.write(P21_CUSTOM_OP_SRC)
        so = os.path.join(tmp, "sq1.so")
        t0 = time.perf_counter()
        subprocess.run(["g++", "-O2", "-fPIC", "-shared", src, "-o", so],
                       check=True, timeout=120)
        build_s = time.perf_counter() - t0
        op = incubate.load_custom_op(so, "sq1")
        xc = torch.randn(1 << 20, generator=gen).cuda().requires_grad_(True)
        y = op(xc)
        g = torch.randn(1 << 20, generator=gen).cuda()
        y.backward(g)
        ok_op = (y.is_cuda and torch.equal(y.detach(), xc.detach() ** 2 + 1)
                 and torch.equal(xc.grad, 2 * xc.detach() * g))
        raised = None
        graph = torch.cuda.CUDAGraph()
        try:
            with torch.cuda.graph(graph):
                op(xc.detach())
        except RuntimeError as e:
            raised = str(e)
        torch.cuda.synchronize()
    ok_op &= raised is not None and "'sq1'" in raised
    if not ok_op:
        bad.append(f"custom op (raised under capture: {raised!r})")
    log(f"  (e) custom op: built with g++ in {build_s:.2f} s, forward and "
        f"backward on 2^20 card elements against x^2 + 1 and 2 x g exact, "
        f"under capture: {raised!r}")
    worst = sorted(out["worst"].items(), key=lambda kv: -kv[1])[:6]
    p21_check("(e) the sweep card vs CPU", not bad, failures,
              f"{len(out['worst'])} comparisons; the largest relative "
              f"errors {[(k, f'{v:.2e}') for k, v in worst]}"
              + (f"; outside their bounds: {bad}" if bad else ""))
    out["custom_op_build_s"] = build_s
    out["normal_draw_moments"] = moments
    return out


def phase21(pt, fa, serving, seed, failures, eager_ms=None):
    """Phase 21: the smaller modules. A part that raises is a failure and
    the next one still runs. Returns each part's flash launches."""
    import os
    import shutil
    import traceback
    log("phase 21: the smaller modules: QAT of GPT-small, PTQ of ResNet-50 "
        "served, ONNX, the BiLSTM-CRF tagger, the op sweep")
    t_phase = time.perf_counter()
    os.makedirs(art_path(""), exist_ok=True)  # the ONNX files and artifact
    out, launches = {}, {}
    parts = (("qat_gpt", True, lambda: p21_qat_gpt(pt, fa, seed, eager_ms,
                                                   failures)),
             # float32 at seq 1024: the CUDA-core flash kernels (counted)
             ("qat_f32", True, lambda: p21_qat_f32(pt, seed, failures)),
             ("ptq_resnet50", False, lambda: p21_ptq_resnet(
                 pt, serving, seed, failures)),
             ("onnx", False, lambda: p21_onnx(pt, seed, failures)),
             ("tagger", False, lambda: p21_tagger(pt, seed, failures)),
             ("sweep", False, lambda: p21_sweep(pt, seed, failures)))
    for key, flash, part in parts:
        t0 = time.perf_counter()
        fa.reset_launch_counts()
        try:
            res = part()
            if key == "qat_gpt":
                counts, res = res
                launches["quantization_qat_gpt_eager"] = counts
            out[key] = res
        except Exception as e:  # noqa: BLE001 -- reported as a failure
            traceback.print_exc()
            failures.append(f"phase 21 ({key}) raised "
                            f"{type(e).__name__}: {e}")
        if not flash:
            launches[f"smaller_modules_{key}"] = p20_no_flash(
                f"({key})", fa, failures, phase=21)
        elif key != "qat_gpt":
            launches[f"smaller_modules_{key}"] = flash_launches(fa)
        out.setdefault("part_seconds", {})[key] = time.perf_counter() - t0
        log(f"  -- {key}: {time.perf_counter() - t0:.1f} s")
        free_cuda()
    shutil.rmtree(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                               ART_DIR), ignore_errors=True)
    out["seconds"] = time.perf_counter() - t_phase
    log(f"  phase 21: {out['seconds']:.1f} s; {card_line()}")
    log(json.dumps({"smaller_modules": out}, default=str))
    return launches


# ---- phase 22: the static graph ---------------------------------------------
# (a) GPT-small (full width and depth, bf16 parameters) recorded into a
# static.Program with AdamW(multi_precision=True).minimize and trained by
# Executor.run: the first run is an eager warm-up step and the capture,
# every later run a replay. P22_STEPS runs against as many eager steps of
# an identical copy: losses and every parameter bitwise (tolerance 0, as
# phase 7's k-step).
P22_STEPS = 4
P22_LR = 6e-4
P22_TIMED = (3, 2)   # 3 alternations of 2 steps, executor and eager
# (c) greedy decoding under to_static through a data-dependent while (a
# WHILE node): the large LSTM LM's width (phase 17), batch 32, 64 steps;
# the CPU decodes the first P22_DECODE_CPU_ROWS rows (rows are
# independent) and must give the same ids.
P22_DECODE_BATCH, P22_DECODE_STEPS, P22_DECODE_CPU_ROWS = 32, 64, 4
P22_DECODE_TIMED = 3  # timed calls of each, after an untimed one
# Fibonacci loops (a, b = a + b, a) captured as WHILE nodes, at these trip
# counts, against the host's, exactly (int64)
P22_FIB_TRIPS = (40, 21)
# a Program with cond, switch_case and a bounded differentiable
# while_loop, 3 SGD steps on the card against the same program on the
# CPU (float32, TF32 off): losses within 1e-5 relative
P22_CF_WIDTH, P22_CF_BATCH, P22_CF_LOSS_REL = 256, 64, 1e-5
# (d) the reference's transpiler test model, 12 sync steps against a PS
# server in this process, within the reference's own bound of the local
# program on the card
P22_PS_STEPS, P22_PS_REL = 12, 2e-4
P22_DIR = ".chip_smoke_static"   # git-ignored, removed at the end
P22_LM = []  # the decode's model (module-level: the AST fallback reads it)


def p22_check(label, ok, failures, detail=""):
    log(f"  {label}{': ' + detail if detail else ''} "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        failures.append(f"phase 22 {label}" + (f": {detail}" if detail
                                                else ""))
    return ok


def p22_gpt_program(pt, fa, seed, failures):
    """(a): returns ({kernel: launches in the replayed steps}, timings)."""
    from paddle_tpu_torch import static
    from paddle_tpu_torch.models.gpt import synthetic_lm_batch
    from paddle_tpu_torch.core.tensor import host_array
    cfg, model = gpt_small_model(pt, seed)
    model.to(torch.bfloat16)
    eager = copy.deepcopy(model)
    prog = static.Program()
    t0 = time.perf_counter()
    with static.program_guard(prog):
        ids = static.data("ids", [TRAIN_BATCH, SEQ], "int64")
        loss = model.loss(model(ids), ids)
        pt.optimizer.AdamW(learning_rate=P22_LR,
                           multi_precision=True).minimize(loss)
    torch.cuda.synchronize()
    build_ms = (time.perf_counter() - t0) * 1e3
    names = prog.op_names()
    log(f"  (a) GPT-small recorded: {len(names)} ops "
        f"({names.count('scaled_dot_product_attention')} attention), build "
        f"{build_ms:.1f} ms")
    eopt = pt.optimizer.AdamW(learning_rate=P22_LR, multi_precision=True,
                              parameters=eager.parameters())
    batches = [synthetic_lm_batch(TRAIN_BATCH, SEQ, cfg.vocab_size,
                                  seed=seed + 40 + i)
               for i in range(P22_STEPS + 2 * P22_TIMED[1])]
    exe = static.Executor()

    def run(b):
        return exe.run(prog, feed={"ids": b}, fetch_list=[loss])[0]

    def eager_step(b):
        t = torch.from_numpy(b).cuda().long()
        out = eager.loss(eager(t), t)
        out.backward()
        eopt.step()
        eopt.clear_grad()
        return out

    got, want = [], []
    launches = {meta["name"]: 0 for meta in KERNELS}
    off = dict(launches)
    with inspect_capture():
        t0 = time.perf_counter()
        got.append(run(batches[0]))
        first_ms = (time.perf_counter() - t0) * 1e3
        program = next(iter(prog._compiled.values()))
        counter = count_replays(program)
        for b in batches[1:P22_STEPS]:
            got.append(counter.run(lambda: run(b)))
            n, o = counter.launches()
            for k in launches:
                launches[k] += n[k]
                off[k] += o[k]
    for b in batches[:P22_STEPS]:
        want.append(host_array(eager_step(b)))
    same_loss = all(np.array_equal(g, w) for g, w in zip(got, want))
    p22_check(f"(a) {P22_STEPS} Executor.run steps vs {P22_STEPS} eager "
              f"steps: losses bitwise", same_loss, failures,
              f"{[float(g) for g in got]} vs {[float(w) for w in want]}")
    same = [name for (name, p), q in zip(model.named_parameters(),
                                          eager.parameters())
            if not torch.equal(p, q)]
    p22_check("(a) every parameter bitwise after the steps", not same,
              failures, f"{len(same)} differ {same[:3]}")
    replays = P22_STEPS - 1
    for meta in KERNELS:
        k = meta["name"]
        p22_check(f"(a) {k}: {launches[k]} kernel nodes x replays in "
                  f"{replays} replayed steps", launches[k] ==
                  cfg.num_layers * replays and not off[k], failures,
                  f"want {cfg.num_layers} a step, {off[k]} off bf16")
    # a replayed run's device-to-host copies (the one fetch)
    prof = report_profile("(a) Executor.run step", profile_step(
        lambda: run(batches[P22_STEPS])), failures)
    copies = host_copies(prof)
    p22_check("(a) device-to-host copies in a run", copies == 1, failures,
              f"{copies} (one fetch, return_numpy=True)")
    exe_ms, eager_ms = [], []
    k = P22_STEPS
    for _ in range(P22_TIMED[0]):
        for label, fn, sink in (("eager", eager_step, eager_ms),
                                ("executor", run, exe_ms)):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for i in range(P22_TIMED[1]):
                fn(batches[k + i])
            torch.cuda.synchronize()
            sink.append((time.perf_counter() - t0) * 1e3 / P22_TIMED[1])
    log(f"  (a) step ms in turns: executor {[round(v, 3) for v in exe_ms]}, "
        f"eager {[round(v, 3) for v in eager_ms]}; first run (an eager "
        f"warm-up step and the capture) {first_ms:.1f} ms")
    del model, eager, eopt, prog, exe
    free_cuda()
    return launches, {"executor_step_ms": exe_ms, "eager_step_ms": eager_ms,
                      "first_run_ms": first_ms, "build_ms": build_ms,
                      "host_copies": copies}


def p22_serving(pt, fa, serving, seed, failures):
    """(b): returns {kernel: launches in one served request}."""
    import shutil
    from paddle_tpu_torch import static
    from paddle_tpu_torch.models.gpt import synthetic_lm_batch
    from paddle_tpu_torch.vision.models import LeNet
    cfg, model = gpt_small_model(pt, seed + 1)
    model.eval()
    prog = static.Program()
    with static.program_guard(prog):
        ids = static.data("ids", [None, SEQ], "int32")
        logits = model(ids)
    req = synthetic_lm_batch(1, SEQ, cfg.vocab_size, seed=seed + 2).astype(
        np.int32)
    with inspect_capture():
        eng = serving.Engine.from_program(prog, [logits], passes=("bf16",),
                                          bucket_ladder=(1,))
    with eng:
        counter = count_replays(eng)
        (got,) = counter.run(lambda: eng.predict(req))
        launches, off = counter.launches()
    exe = static.Executor()
    built = serving.build_serving_program(prog, [logits], passes=("bf16",))
    (ex,) = exe.run(built, feed={"ids": req}, fetch_list=[logits],
                    return_numpy=False)
    (f32,) = exe.run(prog, feed={"ids": req}, fetch_list=[logits])
    p22_check("(b) Engine.from_program(passes=('bf16',)) vs Executor.run of "
              "the bf16-passed program: logits bitwise",
              np.array_equal(got, ex.float().cpu().numpy()), failures)
    rel = float(np.linalg.norm(got - f32) / np.linalg.norm(f32))
    p22_check("(b) served bf16 vs the float32 program", rel <=
              BF16_REL_L2_TOL, failures,
              f"rel L2 {rel:.3e} (tol {BF16_REL_L2_TOL:g})")
    p22_check("(b) bf16 forward kernel a request",
              launches["flash_attention_fwd"] == cfg.num_layers
              and not off["flash_attention_fwd"], failures,
              f"{launches['flash_attention_fwd']} (want {cfg.num_layers}), "
              f"{off['flash_attention_fwd']} off bf16")
    del eng, built, model, prog
    free_cuda()
    # LeNet: save_inference_model -> load_inference_model -> Engine(path)
    torch.manual_seed(seed)
    net = LeNet(device="cuda").eval()
    lp = static.Program()
    with static.program_guard(lp):
        img = static.data("img", [None, 1, 28, 28], "float32")
        out = net(img)
    shutil.rmtree(P22_DIR, ignore_errors=True)
    path = f"{P22_DIR}/lenet"
    x = np.random.RandomState(seed).rand(8, 1, 28, 28).astype(np.float32)
    with cudnn_mode(deterministic=True):
        static.save_inference_model(path, [img], [out], exe, program=lp)
        layer, feeds, fetches = static.load_inference_model(path, exe)
        want = [exe.run(lp, feed={"img": x[:n]}, fetch_list=[out])[0]
                for n in (1, 8)]
        with serving.Engine(path, bucket_ladder=(1, 8)) as eng:
            served = [eng.predict(x[:n])[0] for n in (1, 8)]
    p22_check("(b) LeNet inference model served at buckets 1 and 8 vs "
              "Executor.run", all(np.array_equal(a, b) for a, b in
                                  zip(served, want)) and feeds == ["img"],
              failures)
    shutil.rmtree(P22_DIR, ignore_errors=True)
    return launches


def p22_greedy(h, c, tok, n):
    """Greedy decoding for ``n`` steps through a data-dependent while (the
    shape of tests/test_dy2static.py:174): embedding, the 2-layer LSTM,
    the head's argmax, the id written at column i."""
    lm = P22_LM[0]
    tokens = torch.zeros((tok.shape[0], P22_DECODE_STEPS), dtype=torch.int64,
                         device=tok.device)
    i = torch.zeros((), dtype=torch.int64, device=tok.device)
    while i < n:
        y, (h, c) = lm.lstm(lm.emb(tok)[:, None, :], (h, c))
        tok = torch.argmax(lm.out(y[:, 0, :]), dim=-1)
        idx = torch.zeros((tok.shape[0], 1), dtype=torch.int64,
                          device=tok.device) + i
        tokens = torch.scatter(tokens, 1, idx, tok[:, None])
        i = i + 1
    return tokens


def p22_cf_loss(pt, nn_cf, x, flag, k, n, w):
    """cond, switch_case and a bounded differentiable while_loop."""
    h = pt.matmul(x, w)
    h = nn_cf.cond(flag > 0, lambda: pt.tanh(h), lambda: h * 0.5)
    h = nn_cf.switch_case(k, {0: lambda: h + 1.0, 1: lambda: h * 2.0},
                          default=lambda: h - 1.0)
    i0 = pt.zeros([], dtype="int32", device=x.device)
    _, h = nn_cf.while_loop(
        lambda i, a: i < n,
        lambda i, a: [i + 1, pt.tanh(pt.matmul(a, w)) * 0.5 + x],
        [i0, h], maximum_trip_count=4)
    return pt.mean(h * h)


def p22_cf_train(pt, device, w0, feeds):
    from paddle_tpu_torch import static
    from paddle_tpu_torch.nn import control_flow as nn_cf
    prog = static.Program()
    with static.program_guard(prog):
        x = static.data("x", [P22_CF_BATCH, P22_CF_WIDTH], "float32",
                        device=device)
        flag = static.data("flag", [], "float32", device=device)
        k = static.data("k", [], "int32", device=device)
        n = static.data("n", [], "int32", device=device)
        w = static.create_parameter([P22_CF_WIDTH, P22_CF_WIDTH], "float32",
                                    device=device)
        w.set_value(w0)
        loss = p22_cf_loss(pt, nn_cf, x, flag, k, n, w)
        pt.optimizer.SGD(learning_rate=0.05).minimize(loss)
    exe = static.Executor(device)
    return prog, [float(exe.run(prog, feed=f, fetch_list=[loss])[0])
                  for f in feeds]


def p22_fib_loop(a, b, n):
    """Fibonacci by while_loop: the body hands ``a`` back in ``b``'s
    position, so the captured iteration must read it before writing."""
    from paddle_tpu_torch.nn import control_flow as nn_cf
    i = torch.zeros((), dtype=torch.int64, device=a.device)
    _, a, b = nn_cf.while_loop(lambda i, a, b: i < n,
                               lambda i, a, b: [i + 1, a + b, a], [i, a, b])
    return a, b


def p22_fib_py(a, b, n):
    """The same loop in Python, captured through dy2static."""
    i = torch.zeros((), dtype=torch.int64, device=a.device)
    while i < n:
        a, b = a + b, a
        i = i + 1
    return a, b


def p22_reserved():
    """The allocator's reserved bytes once the dead are collected, cuBLAS's
    per-stream workspaces cleared and the cache emptied (no live graph of
    this phase replays after it)."""
    free_cuda()
    torch.cuda.synchronize()
    torch._C._cuda_clearCublasWorkspaces()
    torch.cuda.empty_cache()
    return torch.cuda.memory_reserved()


def p22_permuting_loops(jit, graph_while, failures):
    """(c): loops whose body hands a variable back in another's position,
    captured as WHILE nodes, against the host's Fibonacci, exactly."""
    a0 = torch.arange(1, 5, dtype=torch.int64, device="cuda")
    b0 = torch.zeros(4, dtype=torch.int64, device="cuda")
    for fn in (p22_fib_loop, p22_fib_py):
        program = jit.to_static(fn)
        graph_while.reset_launch_counts()
        bad = []
        with torch.no_grad():
            for trips in P22_FIB_TRIPS:
                a, b = a0.cpu().numpy(), b0.cpu().numpy()
                for _ in range(trips):
                    a, b = a + b, a
                n = torch.full((), trips, dtype=torch.int64, device="cuda")
                for call in range(2):  # the first at the first trip count
                    got = program(a0, b0, n)  # is the warm-up and capture
                    if not (np.array_equal(got[0].cpu().numpy(), a) and
                            np.array_equal(got[1].cpu().numpy(), b)):
                        bad.append((trips, call))
        whiles = graph_while.nodes["while"]
        p22_check(f"(c) {fn.__name__}: a + b, a through the WHILE node vs "
                  f"the host, at {P22_FIB_TRIPS} trips",
                  not bad and whiles >= 1, failures,
                  f"{whiles} WHILE nodes; differing (trips, call): {bad}")
        del program


def p22_control_flow(pt, seed, failures):
    """(c): returns the WHILE node's entry of the kernels line."""
    from paddle_tpu_torch import jit, static
    from paddle_tpu_torch.kernels import graph_while
    from paddle_tpu_torch.nn import control_flow as nn_cf
    torch.manual_seed(seed)
    lm = lm_model(pt, "cuda").eval()
    P22_LM[:] = [lm]
    b, steps = P22_DECODE_BATCH, P22_DECODE_STEPS
    g = torch.Generator(device="cuda").manual_seed(seed)
    h0 = torch.randn(2, b, LM_HIDDEN, device="cuda", generator=g) * 0.5
    c0 = torch.randn(2, b, LM_HIDDEN, device="cuda", generator=g) * 0.5
    tok0 = torch.randint(0, LM_VOCAB, (b,), device="cuda", generator=g)
    n = torch.full((), steps, dtype=torch.int64, device="cuda")

    def timed(fn):
        """ms of each of P22_DECODE_TIMED calls, after one untimed."""
        out = fn()
        ms = []
        for _ in range(P22_DECODE_TIMED):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
        return out, ms

    with torch.no_grad():
        want, eager_ms = timed(lambda: p22_greedy(h0, c0, tok0, n))
        reserved = [p22_reserved()]
        program = jit.to_static(p22_greedy)
        graph_while.reset_launch_counts()
        first = program(h0, c0, tok0, n)   # eager warm-up, then the capture
        whiles = graph_while.nodes["while"]
        got, replay_ms = timed(lambda: program(h0, c0, tok0, n))
        short = program(h0, c0, tok0, torch.full_like(n, steps // 2))
        sets = graph_while.launch_counts()["while"]
        first, got, short = first.clone(), got.clone(), short.clone()
    transformed = getattr(program._fn, "_jst_transformed", False)
    p22_check("(c) greedy decode through the WHILE node vs the card's "
              "eager decode: ids equal", torch.equal(got, want) and
              torch.equal(first, want) and whiles >= 1 and transformed,
              failures, f"{int((got != want).sum())} ids differ, {whiles} "
              f"WHILE nodes, AST fallback taken: {transformed}")
    p22_check("(c) the replay's trip count follows the data (n = "
              f"{steps // 2})", torch.equal(short[:, :steps // 2],
                                           want[:, :steps // 2])
              and not short[:, steps // 2:].any(), failures)
    # the set-condition kernel runs once before each replay's loop and
    # once after each trip: the untimed and timed replays at n = steps,
    # then one at steps // 2 (the warm-up runs the loop on the host)
    want_sets = (1 + P22_DECODE_TIMED) * (steps + 1) + steps // 2 + 1
    p22_check("(c) the WHILE node's set-condition kernel runs, counted on "
              "the card", sets == want_sets, failures,
              f"{sets} (want {want_sets})")
    reserved.append(torch.cuda.memory_reserved())
    del program
    reserved.append(p22_reserved())
    p22_check("(c) dropping the decode's program returns the memory of its "
              "graph and the WHILE body's pool", reserved[2] <= reserved[0],
              failures, f"reserved bytes before it {reserved[0]}, with it "
              f"{reserved[1]}, after dropping it {reserved[2]}")
    rows = P22_DECODE_CPU_ROWS
    lm_cpu = copy.deepcopy(lm).cpu()
    P22_LM[:] = [lm_cpu]
    with torch.no_grad():
        cpu = p22_greedy(h0[:, :rows].cpu(), c0[:, :rows].cpu(),
                         tok0[:rows].cpu(), n.cpu())
    P22_LM[:] = []
    p22_check(f"(c) the first {rows} rows' ids vs the CPU's decode",
              torch.equal(cpu, got[:rows].cpu()), failures)
    log(f"  (c) decode {b} x {steps} steps: eager "
        f"{[round(v, 2) for v in eager_ms]} ms, captured replays "
        f"{[round(v, 2) for v in replay_ms]} ms")
    # the bound of the decode's work: every step reads the LSTM's and the
    # head's weights and does their products for the batch
    params = sum(p.numel() for name, p in lm.named_parameters()
                 if not name.startswith("emb"))
    bytes_ = steps * (params * 4 + b * LM_HIDDEN * 4) + want.numel() * 8
    ops = steps * 2 * b * params
    bound_ms = max(bytes_ / PEAK_BYTES_PER_S, ops / PEAK_FLOPS[
        torch.float32]) * 1e3
    bound_by = ("bytes" if bytes_ / PEAK_BYTES_PER_S >= ops / PEAK_FLOPS[
        torch.float32] else "operations")
    del lm, lm_cpu
    free_cuda()
    p22_permuting_loops(jit, graph_while, failures)

    # a Program with cond, switch_case and a bounded while, card vs CPU;
    # the cond flips and the switch moves between the replays
    w0 = (np.random.RandomState(seed).randn(P22_CF_WIDTH, P22_CF_WIDTH)
          * (0.5 / math.sqrt(P22_CF_WIDTH))).astype(np.float32)
    rng = np.random.RandomState(seed + 1)
    feeds = [{"x": rng.randn(P22_CF_BATCH, P22_CF_WIDTH).astype(np.float32),
              "flag": np.float32(f), "k": np.int32(kk), "n": np.int32(nn)}
             for f, kk, nn in ((1.0, 0, 2), (-1.0, 1, 3), (1.0, 2, 2))]
    graph_while.reset_launch_counts()
    prog, card = p22_cf_train(pt, "cuda", w0, feeds)
    ifs = graph_while.nodes["if"]
    _, cpu_losses = p22_cf_train(pt, "cpu", w0, feeds)
    rel = max(abs(a - b) / abs(b) for a, b in zip(card, cpu_losses))
    p22_check("(c) cond + switch_case + bounded while_loop program, 3 steps "
              "card vs CPU", rel <= P22_CF_LOSS_REL and ifs >= 5, failures,
              f"losses {card} vs {cpu_losses}, max rel {rel:.2e} (tol "
              f"{P22_CF_LOSS_REL:g}); {ifs} IF nodes captured")
    # the taken branch's gradient through the captured IF chain: the
    # untaken one (sqrt at 0) has an infinite derivative
    gp = static.Program()
    with static.program_guard(gp):
        x = static.data("x", [3], "float32")
        f = static.data("f", [], "float32")
        out = nn_cf.cond(f > 0, lambda: (x * 2.0).sum(),
                         lambda: torch.sqrt(x).sum())
    (grad,) = static.gradients(out, [x])
    exe = static.Executor()
    zero = np.zeros(3, np.float32)
    runs = [exe.run(gp, feed={"x": zero, "f": np.float32(v)},
                    fetch_list=[grad])[0] for v in (1.0, 1.0, -1.0, 1.0)]
    p22_check("(c) d/dx of cond(f > 0, 2x, sqrt(x)) at x = 0, captured: the "
              "taken branch's", all(np.array_equal(r, [2.0, 2.0, 2.0])
                                    for r in (runs[0], runs[1], runs[3]))
              and np.isinf(runs[2]).all(), failures,
              f"{[r.tolist() for r in runs]}")
    return {"name": "graph_while", "route": "cuda",
            "source": "paddle_tpu_torch/kernels/csrc/graph_while.cu",
            "replaces": "paddle_tpu/nn/control_flow.py:326",
            "launches": sets, "max_abs_err": float(
                (got - want).abs().max()), "ms": min(replay_ms),
            "plain_ms": min(eager_ms), "bound_ms": bound_ms,
            "bound_by": bound_by,
            "library_ms": None}


def p22_ps_model(pt, static, optimizer, device):
    prog = static.Program()
    with static.program_guard(prog):
        x = static.data("x", [None, 4], "float32", device=device)
        y = static.data("y", [None, 1], "float32", device=device)
        w = static.create_parameter([4, 8], "float32", name="w",
                                    device=device)
        w2 = static.create_parameter([8, 1], "float32", name="w2",
                                     device=device)
        w.set_value(np.random.RandomState(3).randn(4, 8).astype(np.float32)
                    * 0.5)
        w2.set_value(np.random.RandomState(4).randn(8, 1).astype(np.float32)
                     * 0.5)
        out = pt.matmul(pt.nn.functional.relu(pt.matmul(x, w)), w2)
        loss = ((out - y) ** 2).mean()
        (pt.optimizer.SGD(learning_rate=0.1) if optimizer == "sgd"
         else pt.optimizer.Adam(learning_rate=0.05)).minimize(loss)
    return prog, loss


def p22_transpiler(pt, failures):
    """(d): the transpiled trainer against a PS server of this process."""
    from paddle_tpu_torch import static
    rng = np.random.RandomState(5)
    w_true = np.random.RandomState(1).randn(4, 1).astype(np.float32)
    xs = [rng.rand(8, 4).astype(np.float32) for _ in range(P22_PS_STEPS)]
    batches = [{"x": x, "y": x @ w_true} for x in xs]
    for optimizer in ("sgd", "adam"):
        prog, loss = p22_ps_model(pt, static, optimizer, "cuda")
        exe = static.Executor()
        local = [float(exe.run(prog, feed=f, fetch_list=[loss])[0])
                 for f in batches]
        tables = static.DistributeTranspiler().transpile(
            0, program=p22_ps_model(pt, static, optimizer, "cuda")[0],
            pservers="127.0.0.1:1")._tables
        srv = static.PsServerProgram("127.0.0.1:0", tables)
        port = srv.start()
        prog, loss = p22_ps_model(pt, static, optimizer, "cuda")
        try:
            t = static.DistributeTranspiler()
            t.transpile(0, program=prog, pservers=f"127.0.0.1:{port}")
            trainer = t.get_trainer_program()
            got = [float(exe.run(trainer, feed=f, fetch_list=[loss])[0])
                   for f in batches]
        finally:
            if prog._ps_ctx is not None:
                prog._ps_ctx.stop()
            srv.server.stop()
        rel = max(abs(a - b) / abs(b) for a, b in zip(got, local))
        p22_check(f"(d) transpiled {optimizer} trainer, {P22_PS_STEPS} sync "
                  f"steps vs the local program", rel <= P22_PS_REL, failures,
                  f"max rel {rel:.2e} (tol {P22_PS_REL:g}); losses "
                  f"{got[0]:.5f} -> {got[-1]:.5f}")


def phase22(pt, fa, serving, seed, failures):
    """Phase 22: the static graph on the card. Returns ({path: {kernel:
    launches}}, the WHILE node's kernels-line entry, timings)."""
    log("phase 22: the static graph: GPT-small trained and served from "
        "Programs, control flow on conditional nodes, dy2static, the "
        "transpiler")
    seconds = {}
    t0 = time.perf_counter()
    a_launches, timings = p22_gpt_program(pt, fa, seed, failures)
    seconds["a"], t0 = time.perf_counter() - t0, time.perf_counter()
    b_launches = p22_serving(pt, fa, serving, seed, failures)
    seconds["b"], t0 = time.perf_counter() - t0, time.perf_counter()
    graph_while = p22_control_flow(pt, seed, failures)
    seconds["c"], t0 = time.perf_counter() - t0, time.perf_counter()
    p22_transpiler(pt, failures)
    seconds["d"] = time.perf_counter() - t0
    log(f"  phase 22 seconds by part: "
        f"{ {k: round(v, 1) for k, v in seconds.items()} }")
    return ({"static_program_train_replays": a_launches,
             "static_program_served_request": b_launches}, graph_while,
            dict(timings, seconds=seconds))


def gpt_small_model(pt, seed, num_layers=12):
    from paddle_tpu_torch.models.gpt import GPTForCausalLM, gpt_small
    pt.seed(seed)
    cfg = gpt_small(num_layers=num_layers, hidden_dropout=0.0,
                    attention_dropout=0.0)
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


LAST_PHASE = 22
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
    t_start = time.perf_counter()
    seconds = {}  # each phase's wall seconds, by label
    clock = {"label": None, "t0": None}

    def close_phase():
        if clock["label"] is not None:
            s = time.perf_counter() - clock["t0"]
            seconds[clock["label"]] = s
            log(f"phase {clock['label']}: {s:.1f} s; {card_line()}")
            clock["label"] = None

    def on(n, what, label=None):
        """Whether phase ``n`` runs; the previous phase's clock stops and,
        if it runs, this one's starts."""
        close_phase()
        if n in phases:
            clock["label"], clock["t0"] = label or str(n), time.perf_counter()
            return True
        log(f"phase {n}: skipped ({what}; --phases {args.phases})")
        return False

    # ---- 1. device and build
    on(1, "device and build")
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
    if on(5 if 5 in phases else 6, "BERT-base, phases 5 and 6 together",
          label="5-6"):
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

    # ---- 17. the nn layer library
    nn_launches = {}
    if on(17, "the nn layer library"):
        nn_launches = phase17(pt, fa, args.seed, failures)

    # ---- 18. the rest of the parameter server
    rest_launches = {}
    if on(18, "the rest of the parameter server"):
        rest_launches = phase18(pt, fa, args.seed, failures)
    # ---- 19. the high-level training loop
    hapi_launches = {}
    if on(19, "the high-level training loop"):
        hapi_launches = phase19(pt, fa, args.seed, failures, vision)
    # ---- 20. the optimizer breadth
    optimizer_launches = {}
    if on(20, "the optimizer breadth"):
        optimizer_launches = phase20(pt, fa, args.seed, failures, gpt_rate)
    # ---- 21. the smaller modules
    small_launches = {}
    if on(21, "the smaller modules"):
        small_launches = phase21(pt, fa, serving, args.seed, failures,
                                 eager_ms)
    # ---- 22. the static graph
    static_launches, while_entry, static_timings = {}, None, None
    if on(22, "the static graph"):
        static_launches, while_entry, static_timings = phase22(
            pt, fa, serving, args.seed, failures)
    close_phase()
    log(json.dumps({"phase_seconds": seconds, "total_seconds":
                    time.perf_counter() - t_start, "card": card_line()}))

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
                   for path, counts in ps_launches.items()},
                **{path: counts.get(name)
                   for path, counts in nn_launches.items()},
                **{path: counts.get(name)
                   for path, counts in rest_launches.items()},
                **{path: counts.get(name)
                   for path, counts in hapi_launches.items()},
                **{path: counts.get(name)
                   for path, counts in optimizer_launches.items()},
                **{path: counts.get(name)
                   for path, counts in small_launches.items()},
                **{path: counts.get(name)
                   for path, counts in static_launches.items()}),
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
    kernels.append(while_entry or {
        "name": "graph_while", "route": "cuda",
        "source": SOURCES["graph_while"],
        "replaces": "paddle_tpu/nn/control_flow.py:326", "launches": None,
        **{k: None for k in TIMING_KEYS}})
    log(json.dumps({"static_graph": static_timings}))
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
