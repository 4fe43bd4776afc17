#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``paddle_tpu_torch``) on one GPU and check it.

    python3 chip_smoke.py [--seed N]

Phases, each of which fails the run (non-zero exit, no result line):

1. Device: the card's name and power limit, torch/CUDA versions, and the
   build of every kernel from ``paddle_tpu_torch/kernels/csrc`` (one
   ``nvcc`` per source, all started together), with ptxas's register and
   spill lines.
2. Kernels against their plain PyTorch versions on the card, on the
   served and trained shapes and the reference kernel tests' cases, each
   within a stated tolerance, and the autograd Function's gradients
   against autograd of the written-out attention; each kernel, its plain
   version and one PyTorch library call (a yardstick only) timed with CUDA
   events at the main paths' shapes, beside the roofline bound.
3. The served path: GPT-small (vocab 50304, hidden 768, 12 layers, 12
   heads, seq 1024) with seeded random weights behind
   ``serving.Engine.from_layer(..., bucket_ladder=(1, 4), passes=("bf16",))``,
   fed concurrent requests. Launch counts are zeroed just before and read
   just after; outputs are checked for shape and finiteness, a float32
   engine is held against the same model run on the CPU, and the bf16
   logits against the float32 ones.
4. The trained path: the same GPT-small trained eagerly for 12 steps (2
   warm-up, 10 timed) on one seeded batch of 8 x 1024 tokens with the
   recipe of the JAX package's ``bench.py``: bf16 parameters,
   ``auto_cast(dtype="bfloat16")``, ``AdamW(multi_precision=True)``,
   ``ClipGradByGlobalNorm(1.0)`` and a ``LinearWarmup`` rate. Launch
   counts are zeroed just before and read just after: each kernel must
   launch 12 times a step. Losses must be finite and fall; a float32 step
   on the card (kernels) is held against the same step on the CPU (plain
   versions); the bf16 loss of step 1 against the float32 loss. Step
   time, tokens/s and MFU (the port's ``StepTimer``) and peak memory are
   printed.
5. One JSON line with every kernel of the paths, then the result line.

Imports nothing of JAX and nothing of the JAX package.
"""
import argparse
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

# Published H100 SXM peaks (dense), for the roofline bound.
PEAK_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}

SEQ = 1024
TRAIN_BATCH = 8     # 8 x 1024 tokens a step
TRAIN_STEPS, WARMUP_STEPS = 12, 2
# GPT-3 Small's (125M) published peak rate, Brown et al. 2020, table 2.1
PEAK_LR, START_LR = 6e-4, 6e-5
SOURCES = {"flash_attention_fwd": "paddle_tpu_torch/kernels/csrc/"
                                  "flash_attention_fwd.cu",
           "flash_attention_bwd": "paddle_tpu_torch/kernels/csrc/"
                                  "flash_attention_bwd.cu"}
KERNELS = [
    {"name": "flash_attention_fwd", "route": "cuda",
     "source": SOURCES["flash_attention_fwd"],
     "replaces": "paddle_tpu/kernels/flash_attention.py:35"},
    {"name": "flash_attention_bwd_dq", "route": "cuda",
     "source": SOURCES["flash_attention_bwd"],
     "replaces": "paddle_tpu/kernels/flash_attention.py:111"},
    {"name": "flash_attention_bwd_dkv", "route": "cuda",
     "source": SOURCES["flash_attention_bwd"],
     "replaces": "paddle_tpu/kernels/flash_attention.py:146"},
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
    """One line per compiled kernel from ``nvcc -Xptxas=-v``: its name,
    element type and head dim, registers and spills."""
    out, name, spill = [], None, ""
    for line in build_log.splitlines():
        m = re.search(r"(?<=\d)([a-z_]+_kernel)I(13__nv_bfloat16|f)Li(\d+)E",
                      line)
        if "Compiling entry" in line and m:
            dtype = "f32" if m[2] == "f" else "bf16"
            name = f"{m[1]}<{dtype}, D={m[3]}>"
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
    """(label, dtype, causal, (q, k, v)): the main paths' shapes and the
    reference kernel tests' cases."""
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
        cases.append(("cross 128x320", dtype, False,
                      [rand(gen, 1, 128, 2, 32, dtype)]
                      + [rand(gen, 1, 320, 2, 32, dtype) for _ in range(2)]))
    return cases


def time_flash_fwd(fa, gen, b):
    """The forward kernel, its plain version and the library call at
    [b, 1024, 12, 64] bf16 causal."""
    q, k, v = qkv_views(gen, b, 12, 64, torch.bfloat16)
    ms = cuda_time_ms(lambda: fa.flash_attention_fwd(q, k, v, causal=True), 50)
    plain_ms = cuda_time_ms(
        lambda: fa.flash_attention_fwd_reference(q, k, v, causal=True), 5, 1)
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    library_ms = cuda_time_ms(
        lambda: torch.nn.functional.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True), 50)
    bound_ms, bound_by = flash_bound(b, SEQ, SEQ, 12, 64, torch.bfloat16,
                                     True)
    log(f"  flash fwd [{b}, {SEQ}, 12, 64] bf16 causal: kernel "
        f"{ms:.4f} ms, plain {plain_ms:.4f} ms, "
        f"library (F.scaled_dot_product_attention) {library_ms:.4f} ms, "
        f"bound {bound_ms:.4f} ms ({bound_by})")
    return {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": library_ms}


def check_flash(fa, failures, gen):
    """Forward kernel vs plain version on every case; returns the
    training-shape bf16 error and timings (served-shape timings printed)."""
    train_err = None
    for label, dtype, causal, (q, k, v) in flash_cases(gen):
        o, lse = fa.flash_attention_fwd(q, k, v, causal=causal)
        torch.cuda.synchronize()
        ro, rlse = fa.flash_attention_fwd_reference(q, k, v, causal=causal)
        tol = TOL[dtype]
        o_err = (o.float() - ro.float()).abs()
        o_ok = bool((o_err <= tol["o_atol"] + tol["o_rtol"]
                     * ro.float().abs()).all())
        lse_err = (lse - rlse).abs().max().item()
        ok = (o_ok and lse_err <= tol["lse_atol"]
              and bool(torch.isfinite(o.float()).all()))
        log(f"  flash fwd {label:<14} {str(dtype):<14} causal={causal!s:<5} "
            f"O max_abs_err={o_err.max().item():.3e} "
            f"(tol {tol['o_atol']:g} + {tol['o_rtol']:g}*|ref|)  "
            f"lse max_abs_err={lse_err:.3e} (tol {tol['lse_atol']:g})  "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            failures.append(f"flash fwd {label} {dtype} causal={causal}")
        if label == "train" and dtype == torch.bfloat16:
            train_err = o_err.max().item()
    time_flash_fwd(fa, gen, 4)  # the served bucket-4 shape, as before
    return dict(time_flash_fwd(fa, gen, TRAIN_BATCH), max_abs_err=train_err)


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
        delta = fa.attention_delta(o, do)
        got = (fa.flash_attention_bwd_dq(q, k, v, do, lse, delta, causal),
               *fa.flash_attention_bwd_dkv(q, k, v, do, lse, delta, causal))
        torch.cuda.synchronize()
        scale = q.shape[-1] ** -0.5
        want = (fa.flash_attention_bwd_dq_reference(
                    q, k, v, do, lse, delta, causal, scale),
                *fa.flash_attention_bwd_dkv_reference(
                    q, k, v, do, lse, delta, causal, scale))
        tol = BWD_TOL[dtype]
        parts, ok = [], True
        for name, g, w in zip(("dQ", "dK", "dV"), got, want):
            err = (g.float() - w.float()).abs()
            ok &= bool((err <= tol["atol"] + tol["rtol"] * w.float().abs())
                       .all()) and bool(torch.isfinite(g.float()).all())
            parts.append(f"{name} {err.max().item():.3e}")
            if label == "train" and dtype == torch.bfloat16:
                errs[name] = err.max().item()
        log(f"  flash bwd {label:<14} {str(dtype):<14} causal={causal!s:<5} "
            f"max_abs_err {', '.join(parts)} (tol {tol['atol']:g} + "
            f"{tol['rtol']:g}*|ref|)  {'ok' if ok else 'FAIL'}")
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
    delta = fa.attention_delta(o, do)
    scale = d ** -0.5
    args = (q, k, v, do, lse, delta, True)
    out = {
        "dq": {"ms": cuda_time_ms(lambda: fa.flash_attention_bwd_dq(*args),
                                  20),
               "plain_ms": cuda_time_ms(
                   lambda: fa.flash_attention_bwd_dq_reference(
                       *args, scale), 3, 1)},
        "dkv": {"ms": cuda_time_ms(
                    lambda: fa.flash_attention_bwd_dkv(*args), 20),
                "plain_ms": cuda_time_ms(
                    lambda: fa.flash_attention_bwd_dkv_reference(
                        *args, scale), 3, 1)},
    }
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
    bounds = {"dq": bwd_bound(b, SEQ, h, d, dt, 4, 1, 3),
              "dkv": bwd_bound(b, SEQ, h, d, dt, 4, 2, 4)}
    whole_ms, whole_by = bwd_bound(b, SEQ, h, d, dt, 5, 3, 5)
    for key, label in (("dq", "dQ"), ("dkv", "dK/dV")):
        bound_ms, bound_by = bounds[key]
        out[key].update(bound_ms=bound_ms, bound_by=bound_by,
                        library_ms=library_ms)
        log(f"  flash bwd {label} [{b}, {SEQ}, {h}, {d}] bf16 causal: kernel "
            f"{out[key]['ms']:.4f} ms, plain {out[key]['plain_ms']:.4f} ms, "
            f"bound {bound_ms:.4f} ms ({bound_by})")
    out["dq"]["max_abs_err"] = errs["dQ"]
    out["dkv"]["max_abs_err"] = max(errs["dK"], errs["dV"])
    log(f"  flash bwd whole [{b}, {SEQ}, {h}, {d}] bf16 causal: kernels "
        f"{out['dq']['ms'] + out['dkv']['ms']:.4f} ms + delta "
        f"{delta_ms:.4f} ms; library (F.scaled_dot_product_attention "
        f"backward) {library_ms:.4f} ms; bound {whole_ms:.4f} ms "
        f"({whole_by})")
    return out


def serve(model, serving, ids_by_req, failures):
    """The main path: a bf16 engine at buckets (1, 4) fed a burst of
    concurrent requests, then sequential requests per bucket for latency.
    Returns the engine's stats, per-bucket latencies and the results."""
    cfg = model.config
    engine = serving.Engine.from_layer(
        model, [([None, SEQ], "int32")], bucket_ladder=(1, 4),
        passes=("bf16",), batch_timeout_ms=50.0, device="cuda")
    try:
        results = [None] * len(ids_by_req)

        def call(i):
            results[i] = engine.predict(ids_by_req[i])[0]

        threads = [threading.Thread(target=call, args=(i,))
                   for i in range(len(ids_by_req))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
            if t.is_alive():
                raise RuntimeError("a served request did not finish")
        for ids, out in zip(ids_by_req, results):
            want = (ids.shape[0], SEQ, cfg.vocab_size)
            if out is None or out.shape != want or out.dtype != np.float32:
                failures.append(f"served output shape/dtype "
                                f"{None if out is None else out.shape} != {want}")
            elif not np.isfinite(out).all():
                failures.append("served output has non-finite values")
        burst = engine.stats()

        latency = {}
        for bucket in engine.bucket_ladder:
            ids = ids_by_req[0][:1].repeat(bucket, axis=0)
            times = []
            for _ in range(3):
                t0 = time.perf_counter()
                engine.predict(ids)
                times.append((time.perf_counter() - t0) * 1e3)
            latency[bucket] = times
        stats = engine.stats()
    finally:
        engine.close()
    return burst, stats, latency, results


def make_optimizer(model):
    """The recipe's optimizer: AdamW with float32 masters for bf16
    parameters, decay on the weight matrices and embeddings only, a global
    norm clip at 1.0 and a linear warm-up over the warm-up steps."""
    from paddle_tpu_torch import nn, optimizer
    sched = optimizer.lr.LinearWarmup(PEAK_LR, WARMUP_STEPS, START_LR,
                                      PEAK_LR)
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


def f32_step(model, ids):
    """One float32 training step of ``model`` on its device: (loss, grads,
    updates p_new - p_old), all on the CPU."""
    model.train()
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    opt, _ = make_optimizer(model)
    ids_t = torch.from_numpy(ids).to(before["gpt.wte.weight"].device)
    loss = model.loss(model(ids_t), ids_t)
    loss.backward()
    grads = {n: p.grad.detach().cpu() for n, p in model.named_parameters()}
    opt.step()
    updates = {n: (p.detach() - before[n]).cpu()
               for n, p in model.named_parameters()}
    return loss.item(), grads, updates


def check_f32_step(model, ids, failures):
    """A float32 step on the card (kernels) vs the same step on the CPU
    (plain versions): the loss, every gradient and every update."""
    t0 = time.perf_counter()
    card = f32_step(copy.deepcopy(model), ids)
    t1 = time.perf_counter()
    cpu = f32_step(copy.deepcopy(model).to("cpu"), ids)
    log(f"  float32 step, batch {ids.shape[0]}: card {t1 - t0:.2f} s, CPU "
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
                             float((zero - zero_cpu).abs().max()) / START_LR)
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
        failures.append("float32 training step: card disagrees with CPU")


def profile_step(step_fn):
    """One step under torch.profiler: device busy time by kernel and the
    device's idle share of the step's wall time (None if the profiler saw
    no device activity)."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step_fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    by_name = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            by_name[e.name] = (by_name.get(e.name, 0.0)
                               + e.time_range.elapsed_us())
    busy_us = sum(by_name.values())
    if not busy_us:
        return None
    return wall_us, busy_us, sorted(by_name.items(), key=lambda kv: -kv[1])


def train(model, ids, fa, failures):
    """The trained path: float32 step check, then the bf16 recipe for
    ``TRAIN_STEPS`` steps with launch counts zeroed just before and read
    just after. Returns the launch counts."""
    from paddle_tpu_torch import amp
    from paddle_tpu_torch.observability import StepTimer
    cfg = model.config

    check_f32_step(model, ids[:1], failures)
    ids_t = torch.from_numpy(ids).to(next(model.parameters()).device)
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
    for c in counters:
        c.launches = 0
    losses, tel = [], None
    for step in range(TRAIN_STEPS):
        if step == WARMUP_STEPS:
            timer.start()
        losses.append(one_step())
        if step >= WARMUP_STEPS:
            tel = timer.step()
    launches = {c.__name__: c.launches for c in counters}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    log(f"  losses: {[round(x, 4) for x in losses]}")
    want = cfg.num_layers * TRAIN_STEPS
    for name, n in launches.items():
        log(f"  {name} launches: {n} over {TRAIN_STEPS} steps "
            f"({n / TRAIN_STEPS:g} a step; want {cfg.num_layers})")
        if n != want:
            failures.append(f"{name} launched {n} times, not {want}")
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
    try:
        prof = profile_step(one_step)
    except Exception as e:  # a measurement, not a check of the path
        log(f"  profiler: not measured ({type(e).__name__}: {e})")
        prof = None
    if prof is None:
        log("  profiler: no device activity recorded; idle share not "
            "measured")
    else:
        wall_us, busy_us, top = prof
        log(f"  profiled step: wall {wall_us / 1e3:.3f} ms, device busy "
            f"{busy_us / 1e3:.3f} ms, idle share "
            f"{1 - busy_us / wall_us:.4f}")
        for name, us in top[:12]:
            log(f"    {us / 1e3:9.3f} ms {us / busy_us:7.2%}  {name[:110]}")
    return launches


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    try:
        import paddle_tpu_torch as pt
        from paddle_tpu_torch import serving
        from paddle_tpu_torch.kernels import _build
        from paddle_tpu_torch.kernels import flash_attention as fa
        from paddle_tpu_torch.models.gpt import (GPTForCausalLM, gpt_small,
                                                 synthetic_lm_batch)
    except ImportError as e:
        print(f"chip_smoke: the paddle_tpu_torch package is missing ({e})",
              file=sys.stderr)
        return 2
    # float32 products in full float32 on both sides of every comparison
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    failures = []

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

    # ---- 2. kernels vs their plain versions
    log("phase 2: kernels vs plain versions on the card")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(args.seed)
    flash = check_flash(fa, failures, gen)
    flash_bwd = check_flash_bwd(fa, failures, gen)

    # ---- 3. the served path
    log("phase 3: GPT-small served through the engine (bf16, buckets 1, 4)")
    pt.seed(args.seed)
    cfg = gpt_small(hidden_dropout=0.0, attention_dropout=0.0)
    model = GPTForCausalLM(cfg, device="cuda")
    n_params = sum(p.numel() for p in model.parameters())
    log(f"  model: vocab {cfg.vocab_size} hidden {cfg.hidden_size} layers "
        f"{cfg.num_layers} heads {cfg.num_heads} seq {SEQ}, "
        f"{n_params} parameters")
    rows = [1, 3, 2, 2, 1]
    ids_all = synthetic_lm_batch(sum(rows), SEQ, cfg.vocab_size,
                                 seed=args.seed)
    offs = np.cumsum([0] + rows)
    ids_by_req = [ids_all[a:b] for a, b in zip(offs[:-1], offs[1:])]

    fa.flash_attention_fwd.launches = 0
    burst, stats, latency, results = serve(model, serving, ids_by_req,
                                           failures)
    launches = served_launches = fa.flash_attention_fwd.launches
    forwards = stats["warmup_runs"] + stats["batches"]
    log(f"  engine stats after the burst: {burst}")
    log(f"  engine stats at the end: {stats}")
    if burst["batches_by_bucket"].get(4, 0) < 1:
        failures.append("no batch of the burst coalesced into bucket 4")
    if launches != cfg.num_layers * forwards or launches == 0:
        failures.append(f"flash launches {launches} != {cfg.num_layers} x "
                        f"{forwards} forwards")
    log(f"  flash launches: {launches} over {forwards} forwards "
        f"({stats['warmup_runs']} warm-up + {stats['batches']} served "
        f"batches) = {launches / max(forwards, 1):g} per forward")
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

    # ---- 4. the trained path
    log(f"phase 4: GPT-small trained, {TRAIN_STEPS} steps ({WARMUP_STEPS} "
        f"warm-up) of {TRAIN_BATCH} x {SEQ} tokens, bf16 AMP, AdamW with "
        f"float32 masters")
    train_ids = synthetic_lm_batch(TRAIN_BATCH, SEQ, cfg.vocab_size,
                                   seed=args.seed + 1)
    trained = train(model, train_ids, fa, failures)

    # ---- 5. kernels line and result
    timings = [flash, flash_bwd["dq"], flash_bwd["dkv"]]
    by_path = [{"serving": served_launches}, {}, {}]
    kernels = []
    for meta, timing, paths in zip(KERNELS, timings, by_path):
        n = trained[meta["name"]]
        kernels.append(dict(meta, launches=n, **timing,
                            launches_by_path=dict(paths, training=n),
                            shape=[TRAIN_BATCH, SEQ, 12, 64]))
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
