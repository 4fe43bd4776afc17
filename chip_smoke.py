#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``paddle_tpu_torch``) on one GPU and check it.

    python3 chip_smoke.py [--seed N]

Phases, each of which fails the run (non-zero exit, no result line):

1. Device: the card's name and power limit, torch/CUDA versions, and the
   build of every kernel of the served path from ``paddle_tpu_torch/kernels/
   csrc`` (one ``nvcc`` per source, all started together).
2. Kernels against their plain PyTorch versions on the card, on the
   served path's shapes and the reference kernel tests' cases, each within
   a stated tolerance; the kernel, its plain version and one PyTorch
   library call (a yardstick only) timed with CUDA events at the served
   shape, beside the roofline bound.
3. The served path: GPT-small (vocab 50304, hidden 768, 12 layers, 12
   heads, seq 1024) with seeded random weights behind
   ``serving.Engine.from_layer(..., bucket_ladder=(1, 4), passes=("bf16",))``,
   fed concurrent requests. Launch counts are zeroed just before and read
   just after; outputs are checked for shape and finiteness, a float32
   engine is held against the same model run on the CPU, and the bf16
   logits against the float32 ones.
4. One JSON line with every kernel of the path, then the result line.

Imports nothing of JAX and nothing of the JAX package.
"""
import argparse
import copy
import json
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
# float32 engine on the card vs the same model on the CPU: float32 sums in
# another order through 12 layers.
FP32_REL_MAX_TOL = 2e-4     # max |diff| / max |reference logit|
# bf16-served logits vs float32 logits of the same model and ids.
BF16_REL_L2_TOL = 5e-2      # ||diff||_2 / ||reference||_2

# Published H100 SXM peaks (dense), for the roofline bound.
PEAK_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}

SEQ = 1024
FLASH = {"name": "flash_attention_fwd", "route": "cuda",
         "source": "paddle_tpu_torch/kernels/csrc/flash_attention_fwd.cu",
         "replaces": "paddle_tpu/kernels/flash_attention.py:35"}


def log(*a):
    print(*a, flush=True)


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()
    return out[0] if out else ""


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


def check_flash(fa, failures, gen):
    """Kernel vs plain version on the served shapes and the reference
    tests' cases; returns the served-shape bf16 error and timings."""
    def qkv_views(b, h, d, dtype):
        # the model's layout: q/k/v are strided views of one fused QKV
        x = torch.randn(b, SEQ, 3, h, d, generator=gen, device="cuda")
        return x.to(dtype).unbind(2)

    def rand(b, s, h, d, dtype):
        return torch.randn(b, s, h, d, generator=gen, device="cuda").to(dtype)

    cases = []
    for dtype in (torch.bfloat16, torch.float32):
        for b in (4, 1):  # the served buckets
            cases.append((f"served b={b}", dtype, True,
                          qkv_views(b, 12, 64, dtype)))
        for s in (128, 384, 200):
            for causal in (False, True):
                cases.append((f"s={s}", dtype, causal,
                              [rand(2, s, 2, 64, dtype) for _ in range(3)]))
        cases.append(("cross 128x320", dtype, False,
                      [rand(1, 128, 2, 32, dtype)]
                      + [rand(1, 320, 2, 32, dtype) for _ in range(2)]))
    served_err = None
    for label, dtype, causal, (q, k, v) in cases:
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
        log(f"  flash {label:<14} {str(dtype):<14} causal={causal!s:<5} "
            f"O max_abs_err={o_err.max().item():.3e} "
            f"(tol {tol['o_atol']:g} + {tol['o_rtol']:g}*|ref|)  "
            f"lse max_abs_err={lse_err:.3e} (tol {tol['lse_atol']:g})  "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            failures.append(f"flash {label} {dtype} causal={causal}")
        if label == "served b=4" and dtype == torch.bfloat16:
            served_err = o_err.max().item()

    # timing at the served shape and dtype (bucket 4, bf16, causal)
    q, k, v = qkv_views(4, 12, 64, torch.bfloat16)
    ms = cuda_time_ms(lambda: fa.flash_attention_fwd(q, k, v, causal=True), 50)
    plain_ms = cuda_time_ms(
        lambda: fa.flash_attention_fwd_reference(q, k, v, causal=True), 5, 1)
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    library_ms = cuda_time_ms(
        lambda: torch.nn.functional.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True), 50)
    bound_ms, bound_by = flash_bound(4, SEQ, SEQ, 12, 64, torch.bfloat16, True)
    log(f"  flash served shape [4, {SEQ}, 12, 64] bf16 causal: kernel "
        f"{ms:.4f} ms, plain {plain_ms:.4f} ms, "
        f"library (F.scaled_dot_product_attention) {library_ms:.4f} ms, "
        f"bound {bound_ms:.4f} ms ({bound_by})")
    return {"max_abs_err": served_err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": library_ms}


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
    _build.build(["flash_attention_fwd"])
    log(f"kernel build: {time.perf_counter() - t0:.2f} s")
    for line in _build.build_log("flash_attention_fwd").splitlines():
        if "registers" in line or "spill" in line:
            log("  ptxas:", line.strip())

    # ---- 2. kernels vs their plain versions
    log("phase 2: kernels vs plain versions on the card")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(args.seed)
    flash = check_flash(fa, failures, gen)

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
    launches = fa.flash_attention_fwd.launches
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

    # ---- 4. kernels line and result
    log(json.dumps({"kernels": [dict(FLASH, launches=launches, **flash)]}))
    if failures:
        print("chip_smoke FAILED: " + "; ".join(failures), file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
