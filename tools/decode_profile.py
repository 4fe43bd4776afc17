"""Where a captured greedy decode's time goes on the card: the decode of
``chip_smoke.py`` phase 22 (c) (the large LSTM LM's width, batch 32, 64
steps, a data-dependent ``while`` that ``to_static`` captures as a WHILE
conditional node), one replay and one eager decode each under
``torch.profiler``: wall and device-busy ms, and device ms by kernel.
Then, to split a WHILE trip's cost from its body's, the ms of a replay
(median of several) of: the decode through the WHILE node; the same 64
steps unrolled into one plain graph (no conditional node); and a WHILE
node whose body only counts (64 trips).

    PYTHONPATH=. python3 tools/decode_profile.py
"""
import subprocess
import time

import torch
from torch.profiler import ProfilerActivity, profile

import chip_smoke as cs
from paddle_tpu_torch import jit


def profiled(label, fn):
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    by_name, counts = {}, {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            by_name[e.name] = by_name.get(e.name, 0.0) + \
                e.time_range.elapsed_us() / 1e3
            counts[e.name] = counts.get(e.name, 0) + 1
    busy = sum(by_name.values())
    print(f"{label}: wall {wall:.2f} ms, device busy {busy:.2f} ms, "
          f"{sum(counts.values())} kernels")
    for name, ms in sorted(by_name.items(), key=lambda kv: -kv[1])[:10]:
        print(f"  {ms:8.3f} ms {counts[name]:5d} x  {name[:100]}")


def unrolled(h, c, tok):
    """The decode's steps, unrolled on the host: no data-dependent loop."""
    lm = cs.P22_LM[0]
    tokens = torch.zeros((tok.shape[0], cs.P22_DECODE_STEPS),
                         dtype=torch.int64, device=tok.device)
    for s in range(cs.P22_DECODE_STEPS):
        y, (h, c) = lm.lstm(lm.emb(tok)[:, None, :], (h, c))
        tok = torch.argmax(lm.out(y[:, 0, :]), dim=-1)
        tokens[:, s] = tok
    return tokens


def counter(i, n):
    """A WHILE node whose body only counts."""
    while i < n:
        i = i + 1
    return i


def replay_ms(fn, reps=7):
    """Median wall ms of ``reps`` calls (each synchronized), after one."""
    fn()
    ms = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    return sorted(ms)[len(ms) // 2]


def main():
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.manual_seed(0)
    lm = cs.lm_model(None, "cuda").eval()
    cs.P22_LM[:] = [lm]
    b, steps = cs.P22_DECODE_BATCH, cs.P22_DECODE_STEPS
    g = torch.Generator(device="cuda").manual_seed(0)
    h0 = torch.randn(2, b, cs.LM_HIDDEN, device="cuda", generator=g) * 0.5
    c0 = torch.randn(2, b, cs.LM_HIDDEN, device="cuda", generator=g) * 0.5
    tok0 = torch.randint(0, cs.LM_VOCAB, (b,), device="cuda", generator=g)
    n = torch.full((), steps, dtype=torch.int64, device="cuda")
    program = jit.to_static(cs.p22_greedy)
    with torch.no_grad():
        program(h0, c0, tok0, n)  # the eager warm-up and the capture
        profiled("eager decode", lambda: cs.p22_greedy(h0, c0, tok0, n))
        profiled("captured replay (WHILE node)",
                 lambda: program(h0, c0, tok0, n))
        flat = jit.to_static(unrolled)
        count = jit.to_static(counter)
        i0 = torch.zeros((), dtype=torch.int64, device="cuda")
        assert torch.equal(flat(h0, c0, tok0), program(h0, c0, tok0, n))
        for label, fn in (
                ("WHILE decode, 64 trips", lambda: program(h0, c0, tok0, n)),
                ("unrolled decode, one plain graph",
                 lambda: flat(h0, c0, tok0)),
                ("WHILE node counting to 64", lambda: count(i0, n)),
                ("eager decode", lambda: cs.p22_greedy(h0, c0, tok0, n))):
            print(f"{label}: median {replay_ms(fn):.3f} ms")


if __name__ == "__main__":
    main()
