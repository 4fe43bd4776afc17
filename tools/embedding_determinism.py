"""Run-to-run bitwise repeatability on the card of torch's embedding
backward and of ``chip_smoke.py`` phase 8a's float32 BERT-base arms, in
torch's default mode and under ``torch.use_deterministic_algorithms``.

1. ``embedding_dense_backward`` called ``--calls`` times on one gradient
   ``[16, 512, 768]`` with the ids of phase 8a's first batch (token type:
   all 0; positions: each id 16 times; words: drawn from 30,720): how many
   calls differ from the first.
2. Phase 8a's BERT-base (``ZERO_BERT_LAYERS`` layers, float32 parameters,
   bf16 ``auto_cast``, 2 calls of 20 steps through ``to_static``) in four
   arms (the replicated and the accumulating control, ZeRO-2 without and
   with ``accumulate_steps=4``), each ``--reps`` times: how many runs end
   with other parameters than the arm's first run, and which elements
   differ.

    PYTHONPATH=. python3 tools/embedding_determinism.py [--calls N] [--reps N]
"""
import argparse
import copy
import gc

import numpy as np
import torch

import chip_smoke as cs

ARMS = (("control", 0, None), ("accumulating control", 0, cs.ZERO_ACCUM),
        ("ZeRO-2", 2, None), ("ZeRO-2 accumulating", 2, cs.ZERO_ACCUM))


def embedding_calls(calls, batch):
    ids, tok = (torch.from_numpy(x).cuda() for x in batch[:2])
    pos = torch.arange(cs.BERT_SEQ, device="cuda").expand_as(ids)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    grad = torch.randn(*ids.shape, 768, device="cuda", generator=gen)
    for name, idx, rows in (("token type", tok, 2),
                            ("position", pos, cs.BERT_SEQ),
                            ("word", ids, cs.BERT_VOCAB)):
        for det in (False, True):
            torch.use_deterministic_algorithms(det)
            back = torch.ops.aten.embedding_dense_backward
            ref = back(grad, idx, rows, -1, False)
            bad = sum(not torch.equal(back(grad, idx, rows, -1, False), ref)
                      for _ in range(calls))
            print(f"embedding backward, {name} ({rows} rows), deterministic "
                  f"{det}: {bad} of {calls} calls differ from the first",
                  flush=True)
    torch.use_deterministic_algorithms(False)


def arm_run(pt, base, stacked, stage, accumulate):
    from paddle_tpu_torch import jit, optimizer
    model = copy.deepcopy(base).float()
    opt = optimizer.AdamW(parameters=model.parameters(),
                          learning_rate=cs.BERT_LR, multi_precision=True)
    if stage:
        opt._zero_enable(axis="dp", stage=stage, prefetch=None)
    program = jit.to_static(cs.bench_one_step(pt, model, opt),
                            scan_steps=cs.KSTEP, dp_axis="dp",
                            accumulate_steps=accumulate)
    losses = torch.cat([program(*stacked).cpu() for _ in range(2)])
    params = {n: p.detach().cpu().clone()
              for n, p in model.named_parameters()}
    del program, model, opt
    gc.collect()
    torch.cuda.empty_cache()
    return losses, params


def arms(pt, reps, batches):
    from paddle_tpu_torch.models.bert import BertForPretraining, bert_base
    cfg = bert_base(vocab_size=cs.BERT_VOCAB,
                    num_layers=cs.ZERO_BERT_LAYERS, hidden_dropout=0.0,
                    attention_dropout=0.0)
    pt.seed(4)
    base = BertForPretraining(cfg, device="cuda").to("bfloat16")
    stacked = [torch.from_numpy(np.stack(col)).cuda()
               for col in zip(*batches)]
    for det in (False, True):
        first, odd = {}, {}
        for rep in range(reps):
            for label, stage, acc in ARMS:
                if det:
                    with cs.deterministic_algorithms():
                        losses, params = arm_run(pt, base, stacked, stage,
                                                 acc)
                else:
                    losses, params = arm_run(pt, base, stacked, stage, acc)
                ref = first.setdefault(label, (losses, params))
                diff = [f"{n}[{int(torch.nonzero(params[n] != q)[0][0])}"
                        f"...] ({int((params[n] != q).sum())} elements)"
                        for n, q in ref[1].items()
                        if not torch.equal(params[n], q)]
                if diff or not torch.equal(losses, ref[0]):
                    odd.setdefault(label, []).append((rep, diff))
        for label, _, _ in ARMS:
            runs = odd.get(label, [])
            print(f"{label}, deterministic {det}: {len(runs)} of {reps} runs "
                  f"differ from the first; {runs}", flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--calls", type=int, default=3000)
    ap.add_argument("--reps", type=int, default=10)
    args = ap.parse_args()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.models.bert import synthetic_mlm_batch
    print(f"{cs.card_line()}; torch {torch.__version__}", flush=True)
    batches = [synthetic_mlm_batch(cs.BERT_BATCH, cs.BERT_SEQ, cs.BERT_VOCAB,
                                   seed=50 + i) for i in range(cs.KSTEP)]
    embedding_calls(args.calls, batches[0])
    cs.init_dp_mesh()
    try:
        arms(pt, args.reps, batches)
    finally:
        torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
