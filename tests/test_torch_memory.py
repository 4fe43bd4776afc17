"""Memory accounting (``observability.memory``) against the reference.

- The state ledger of the same small GPT (2 layers, width 64) in bf16 with
  ``AdamW(multi_precision=True)``: every category's per-rank and global
  bytes and count equal the reference's (exactly: bytes do not depend on
  the backend), with surviving gradients after a backward too, and under
  ZeRO-1 at dp 2 over gloo (two ranks of the port's ``spawn``) against the
  reference's ZeRO-1 on a two-device mesh. The one category left out is
  ``rng``, which holds a torch generator's state where the reference holds
  a jax key (8 bytes).
- The program registry, its gauges and ``program_stats``/``peak_bytes``
  as the reference's.
- ``StepTimer`` writes the run-log's ``step`` events, with a
  ``memory_snapshot`` once a window.
"""
import gc
import json

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu_torch as pt
from paddle_tpu.distributed import parallel_env as ref_env
from paddle_tpu.models.gpt import GPTConfig as RefConfig
from paddle_tpu.models.gpt import GPTForCausalLM as RefGPT
from paddle_tpu.observability import memory as ref_memory
from paddle_tpu_torch.models.gpt import GPTConfig, GPTForCausalLM
from paddle_tpu_torch.observability import export, memory

SMALL = dict(vocab_size=128, hidden_size=64, num_layers=2, num_heads=2,
             max_seq_len=128, hidden_dropout=0.0, attention_dropout=0.0)
IDS = np.random.RandomState(3).randint(0, 128, (2, 64)).astype(np.int64)


def _delta(before, after, skip=("rng",)):
    out = {}
    for cat, v in after["categories"].items():
        if cat in skip:
            continue
        w = before["categories"].get(cat, {"bytes": 0, "global_bytes": 0,
                                           "count": 0})
        d = {k: v[k] - w[k] for k in ("bytes", "global_bytes", "count")}
        if any(d.values()):
            out[cat] = d
    return out


def _ledger(mod):
    gc.collect()
    return mod.state_ledger()


def _reference(dp=None, backward=False):
    before = _ledger(ref_memory)
    paddle.seed(0)
    model = RefGPT(RefConfig(**SMALL))
    model.to("bfloat16")
    opt = paddle.optimizer.AdamW(learning_rate=1e-3,
                                 parameters=model.parameters(),
                                 multi_precision=True)
    if dp:
        ref_env.set_mesh(ref_env.make_mesh({"dp": dp}))
        try:
            opt._zero_enable(axis="dp", stage=1)
        finally:
            ref_env.set_mesh(None)
    if backward:
        with paddle.amp.auto_cast(enable=True, dtype="bfloat16"):
            ids = paddle.to_tensor(IDS)
            model.loss(model(ids), ids).backward()
    out = _delta(before, _ledger(ref_memory))
    del model, opt
    return out


def _port(backward=False):
    before = _ledger(memory)
    pt.seed(0)
    model = GPTForCausalLM(GPTConfig(**SMALL), device="cpu")
    model.to("bfloat16")
    opt = pt.optimizer.AdamW(learning_rate=1e-3,
                             parameters=model.parameters(),
                             multi_precision=True)
    if backward:
        with pt.amp.auto_cast(enable=True, dtype="bfloat16"):
            ids = torch.from_numpy(IDS)
            model.loss(model(ids), ids).backward()
    led = _ledger(memory)
    out = _delta(before, led)
    del model, opt
    return out, led


@pytest.mark.parametrize("backward", [False, True],
                         ids=["state", "with_grads"])
def test_state_ledger_bytes_equal_the_reference(backward):
    want = _reference(backward=backward)
    got, led = _port(backward=backward)
    assert got == want
    assert {"param", "opt_moment", "master", "lr"} <= set(got)
    assert ("grad" in got) == backward
    # params, masters and moments are the sums of their tensors' nbytes
    n = sum(int(np.prod(s)) for s in
            (e["shape"] for e in led["entries"] if e["category"] == "param"))
    assert got["param"]["bytes"] == 2 * n  # bf16
    assert got["master"]["bytes"] == 2 * got["param"]["bytes"]
    assert got["opt_moment"]["bytes"] == 2 * got["master"]["bytes"]


def _rank_ledger():
    """One gloo rank: the same model, ZeRO-1 over dp = 2; the ledger's
    categories (this rank's bytes)."""
    from paddle_tpu_torch.distributed import parallel_env
    torch.set_num_threads(1)
    before = _ledger(memory)
    pt.seed(0)
    model = GPTForCausalLM(GPTConfig(**SMALL), device="cpu")
    model.to("bfloat16")
    opt = pt.optimizer.AdamW(learning_rate=1e-3,
                             parameters=model.parameters(),
                             multi_precision=True)
    parallel_env.set_mesh(parallel_env.make_mesh({"dp": 2}))
    opt._zero_enable(axis="dp", stage=1)
    out = _delta(before, _ledger(memory))
    del model, opt
    return out


def test_zero1_ledger_at_dp2_equals_the_reference():
    ctx = pt.distributed.spawn(_rank_ledger, nprocs=2, backend="cpu",
                               timeout=120)
    got = [r[2] for r in ctx.results]
    want = _reference(dp=2)
    assert got[0] == got[1] == want
    assert want["zero_moment"]["global_bytes"] == \
        2 * want["zero_moment"]["bytes"]
    assert "opt_moment" not in want and "master" not in want


def test_program_registry_and_gauges():
    stats = {"argument_bytes": 100, "output_bytes": 40, "temp_bytes": 60,
             "alias_bytes": 0, "generated_code_bytes": 0}
    got = memory.program_stats(stats)
    assert got["peak_bytes"] == ref_memory.peak_bytes(dict(
        stats, host_offload_bytes=0)) == 200
    memory.record_program_memory("serving_b4", got)
    assert memory.program_memory()["serving_b4"]["peak_bytes"] == 200
    gauges = export.gauges()
    for kind in memory.MEMORY_KINDS + ("peak",):
        key = f'program_hbm_bytes{{entry="serving_b4",kind="{kind}"}}'
        assert key in gauges
    with pytest.raises(memory.MemoryAttributionError):
        memory.program_stats({"argument_bytes": 1})
    led = memory.export_state_ledger(rank=3)
    assert 'state_resident_bytes_total{rank="3"}' in export.gauges()
    assert led["total_bytes"] >= 0
    snap = memory.snapshot()
    assert set(snap) == {"state", "programs"}
    assert "serving_b4" in snap["programs"]


def test_steptimer_writes_step_events_and_a_window_snapshot(tmp_path):
    from paddle_tpu_torch.observability import StepTimer, runlog
    log = runlog.start_run(dir=str(tmp_path))
    try:
        timer = StepTimer(window=2, tokens_per_step=8)
        for _ in range(5):
            timer.step()
    finally:
        runlog.stop_run()
    with open(log.path) as f:
        events = [json.loads(line) for line in f]
    kinds = [e.get("event") for e in events if e["kind"] == "event"]
    steps = [e for e in events if e.get("event") == "step"]
    assert len(steps) == 4
    assert {"compile_stall_frac", "data_wait_frac", "tokens_per_s"} <= \
        set(steps[-1])
    assert kinds.count("memory_snapshot") == 2
