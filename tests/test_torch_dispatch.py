"""The op-observer seam (``core.dispatch``) and ``FLAGS_check_nan_inf``
against the reference.

- The same NaN- or Inf-producing ``ops`` call raises ``FloatingPointError``
  in both packages with the same message (op name, output index, count,
  shape, dtype): compared as strings.
- A clean step of a small GPT (2 layers, width 64, 2 heads) is bitwise the
  same with the check on and off (tolerance 0), and a NaN written into a
  weight raises at the first op whose output holds it.
- An observer registered on the main thread sees the ops of a worker
  thread; with no observer no torch mode is active during a step, and a
  kernel entry point's only extra work is one global read.
- At sample rate 1.0 the sampled observer counts the same op names as
  the reference's for a battery of ``ops`` calls, and the three flash
  kernels under the reference's names; below 1.0 it samples the same
  ops as the reference (exact counts), and an unsampled torch call never
  enters the observers.
- Nothing is observed inside a capture scope (``static_scope``).
"""
import dis
import sys
import threading

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu_torch as pt
from paddle_tpu import monitor as ref_monitor
from paddle_tpu import observability as ref_obs
from paddle_tpu_torch import monitor, observability, ops
from paddle_tpu_torch.core import dispatch
from paddle_tpu_torch.kernels import flash_attention as fa
from paddle_tpu_torch.models.gpt import GPTConfig, GPTForCausalLM

SMALL = dict(vocab_size=128, hidden_size=64, num_layers=2, num_heads=2,
             max_seq_len=128, hidden_dropout=0.0, attention_dropout=0.0)


@pytest.fixture(autouse=True)
def _clean():
    torch.set_num_threads(2)
    yield
    pt.set_flags({"FLAGS_check_nan_inf": 0})
    paddle.set_flags({"FLAGS_check_nan_inf": 0})
    observability.disable()
    ref_obs.disable()
    assert dispatch._OBSERVER_LIST is None


def _ref_tensor(a):
    return paddle.to_tensor(a)


def _port_tensor(a):
    return pt.to_tensor(torch.from_numpy(np.array(a)), place="cpu")


NAN_CASES = [
    ("log", lambda m, t: m.log(t(np.array([-1.0, 2.0], np.float32)))),
    ("sqrt", lambda m, t: m.sqrt(t(np.array([[4.0, -9.0, -1.0]],
                                            np.float32)))),
    ("divide", lambda m, t: m.divide(t(np.array([1.0, 0.0], np.float32)),
                                     t(np.array([0.0, 0.0], np.float32)))),
    ("exp", lambda m, t: m.exp(t(np.array([1000.0, 1.0], np.float32)))),
]


@pytest.mark.parametrize("case", NAN_CASES, ids=[c[0] for c in NAN_CASES])
def test_nan_check_raises_the_reference_message(case):
    name, call = case
    paddle.set_flags({"FLAGS_check_nan_inf": 1})
    with pytest.raises(FloatingPointError) as want:
        call(paddle, _ref_tensor)
    paddle.set_flags({"FLAGS_check_nan_inf": 0})
    pt.set_flags({"FLAGS_check_nan_inf": 1})
    with pytest.raises(FloatingPointError) as got:
        call(pt, _port_tensor)
    pt.set_flags({"FLAGS_check_nan_inf": 0})
    assert str(got.value) == str(want.value)
    assert f"Operator `{name}`" in str(got.value)
    # off again: the same call returns its non-finite values
    assert not np.isfinite(call(pt, _port_tensor).numpy()).all()


def test_flags_round_trip_and_no_mode_when_off():
    assert pt.get_flags("FLAGS_check_nan_inf") == {"FLAGS_check_nan_inf": 0}
    pt.set_flags({"FLAGS_check_nan_inf": True})
    assert pt.get_flags(["FLAGS_check_nan_inf"])["FLAGS_check_nan_inf"] == 1
    assert "nan_inf" in dispatch._OBSERVERS
    assert torch._C._len_torch_function_stack() == 1
    pt.set_flags({"FLAGS_check_nan_inf": 0})
    assert dispatch._OBSERVER_LIST is None
    assert torch._C._len_torch_function_stack() == 0


def _gpt(seed=0):
    pt.seed(seed)
    torch.manual_seed(seed)
    model = GPTForCausalLM(GPTConfig(**SMALL), device="cpu")
    opt = pt.optimizer.AdamW(learning_rate=1e-3,
                             parameters=model.parameters())
    return model, opt


def _ids():
    return torch.from_numpy(np.random.RandomState(3).randint(
        0, SMALL["vocab_size"], (2, 64)).astype(np.int64))


def _step(model, opt, ids):
    loss = model.loss(model(ids), ids)
    loss.backward()
    opt.step()
    opt.clear_grad()
    return loss.detach()


def test_clean_gpt_step_is_bitwise_with_the_check_on():
    ids = _ids()
    model, opt = _gpt()
    want = [_step(model, opt, ids) for _ in range(2)]
    want_params = [p.detach().clone() for p in model.parameters()]
    model, opt = _gpt()
    pt.set_flags({"FLAGS_check_nan_inf": 1})
    got = [_step(model, opt, ids) for _ in range(2)]
    pt.set_flags({"FLAGS_check_nan_inf": 0})
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    for a, b in zip(model.parameters(), want_params):
        assert torch.equal(a.detach(), b)


def test_nan_in_a_weight_names_the_first_op_holding_it():
    """The port's ``Linear`` multiplies with ``matmul`` (torch's name: the
    models' insides are torch calls); the NaN weight's product is the
    first output that holds it."""
    model, _ = _gpt()
    w = dict(model.named_parameters())["gpt.blocks.1.fc1.weight"]
    with torch.no_grad():
        w[3, 5] = float("nan")
    pt.set_flags({"FLAGS_check_nan_inf": 1})
    with pytest.raises(FloatingPointError,
                       match=r"Operator `matmul` output 0 contains \d+ "
                             r"NaN/Inf value\(s\) \(shape \(2, 64, 256\), "
                             r"dtype float32\)"):
        model(_ids())


class _Recorder:
    def __init__(self):
        self.seen = []

    def begin(self, name):
        self.seen.append((threading.current_thread().name, name))

    def end(self, token, name, outputs):
        pass


def test_observer_sees_ops_on_another_thread():
    rec = _Recorder()
    dispatch.add_observer("test", rec)
    try:
        out = []
        worker = threading.Thread(
            target=lambda: out.append(torch.relu(torch.ones(3) - 2.0)),
            name="worker")
        worker.start()
        worker.join()
        torch.tanh(torch.ones(2))
    finally:
        dispatch.remove_observer("test")
    worker_ops = [n for t, n in rec.seen if t == "worker"]
    assert "relu" in worker_ops and "ones" in worker_ops
    assert ("MainThread", "tanh") in rec.seen
    # removed: no thread observes any more
    n = len(rec.seen)
    threading.Thread(target=lambda: torch.relu(torch.ones(1))).start()
    torch.relu(torch.ones(1))
    assert len(rec.seen) == n


def test_removal_leaves_no_hook_and_workers_resync():
    """Removing the last observer clears every pending profile hook (one
    left behind keeps CPython's call instrumentation on for all threads);
    a worker that took the mode drops it at ``sync_thread``."""
    import queue
    jobs, done = queue.Queue(), queue.Queue()

    def worker():
        while True:
            job = jobs.get()
            if job is None:
                return
            dispatch.sync_thread()
            done.put((job(), torch._C._len_torch_function_stack()))
    t = threading.Thread(target=worker)
    t.start()
    rec = _Recorder()
    dispatch.add_observer("test", rec)
    try:
        jobs.put(lambda: torch.relu(torch.ones(1)))
        assert done.get(timeout=30)[1] == 1
    finally:
        dispatch.remove_observer("test")
    assert sys.getprofile() is None and threading.getprofile() is None
    jobs.put(lambda: torch.relu(torch.ones(1)))
    assert done.get(timeout=30)[1] == 0
    jobs.put(None)
    t.join()
    assert [n for _, n in rec.seen].count("relu") == 1


def test_no_torch_mode_during_an_unobserved_step():
    model, opt = _gpt()
    stacks = []
    model.register_forward_hook(
        lambda *_: stacks.append(torch._C._len_torch_function_stack()))
    _step(model, opt, _ids())
    assert stacks == [0]


@pytest.mark.parametrize("entry", ["flash_attention_fwd",
                                   "flash_attention_bwd_dq",
                                   "flash_attention_bwd_dkv"])
def test_kernel_entry_point_costs_one_global_read(entry):
    """The observer check is the entry point's only reference to the seam
    (``_dispatch._OBSERVER_LIST``), and with no observer the call enters
    no function of ``core.dispatch``."""
    fn = getattr(fa, entry)
    reads = [i.argval for i in dis.get_instructions(fn)
             if i.opname in ("LOAD_GLOBAL", "LOAD_ATTR")
             and i.argval in ("_dispatch", "_OBSERVER_LIST")]
    assert reads.count("_OBSERVER_LIST") == 1
    called = []

    def prof(frame, event, arg):
        if event == "call" and frame.f_globals.get("__name__") == \
                dispatch.__name__:
            called.append(frame.f_code.co_name)
    gen = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(1, 64, 2, 32, generator=gen) for _ in range(3))
    o, lse = fa.flash_attention_fwd(q, k, v, causal=True)
    sys.setprofile(prof)
    try:
        if entry == "flash_attention_fwd":
            fa.flash_attention_fwd(q, k, v, causal=True)
        elif entry == "flash_attention_bwd_dq":
            fa.flash_attention_bwd_dq(q, k, v, o, o, lse, causal=True)
        else:
            _, delta = fa.flash_attention_bwd_dq(q, k, v, o, o, lse, True)
            fa.flash_attention_bwd_dkv(q, k, v, o, lse, delta, causal=True)
    finally:
        sys.setprofile(None)
    assert called == []


def _sampled(stats):
    return {k: v for k, v in stats.items()
            if k.startswith("dispatch_op_sampled{")}


def _delta(before, after):
    return {k: v - before.get(k, 0) for k, v in after.items()
            if v - before.get(k, 0)}


BATTERY = [
    ("exp", lambda m, a: m.exp(a)), ("log", lambda m, a: m.log(a)),
    ("sqrt", lambda m, a: m.sqrt(a)), ("tanh", lambda m, a: m.tanh(a)),
    ("abs", lambda m, a: m.abs(a)), ("add", lambda m, a: m.add(a, a)),
    ("subtract", lambda m, a: m.subtract(a, a)),
    ("multiply", lambda m, a: m.multiply(a, a)),
    ("divide", lambda m, a: m.divide(a, a)),
    ("maximum", lambda m, a: m.maximum(a, a)),
    ("matmul", lambda m, a: m.matmul(a, a)),
    ("clip", lambda m, a: m.clip(a, 0.2, 0.8)),
    ("pow", lambda m, a: m.pow(a, 2.0)),
    ("sum", lambda m, a: m.sum(a)), ("mean", lambda m, a: m.mean(a)),
    ("reshape", lambda m, a: m.reshape(a, [9])),
    ("transpose", lambda m, a: m.transpose(a, [1, 0])),
    ("concat", lambda m, a: m.concat([a, a])),
]


def test_sampled_observer_counts_the_reference_op_names():
    x = np.random.RandomState(0).rand(3, 3).astype(np.float32) + 0.1
    ref_obs.enable(categories=["dispatch"], dispatch_sample_rate=1.0)
    before = _sampled(ref_monitor.stats())
    ra = _ref_tensor(x)
    for _, call in BATTERY:
        call(paddle, ra)
    want = _delta(before, _sampled(ref_monitor.stats()))
    ref_obs.disable()
    observability.enable(categories=["dispatch"], dispatch_sample_rate=1.0)
    before = _sampled(monitor.stats())
    pa = _port_tensor(x)
    for _, call in BATTERY:
        call(pt, pa)
    got = _delta(before, _sampled(monitor.stats()))
    observability.disable()
    names = {f'dispatch_op_sampled{{op="{n}"}}' for n, _ in BATTERY}
    assert names <= set(want)
    assert {k: v for k, v in got.items() if k in names} == \
        {k: v for k, v in want.items() if k in names}


@pytest.mark.parametrize("rate", [0.2, 1 / 7])
def test_sampled_observer_samples_the_reference_ops(rate):
    """Below rate 1.0 the same ops are sampled as in the reference: one
    in ``period``, counted from the registration."""
    x = np.random.RandomState(0).rand(3, 3).astype(np.float32) + 0.1
    ra, pa = _ref_tensor(x), _port_tensor(x)
    ref_obs.enable(categories=["dispatch"], dispatch_sample_rate=rate)
    before = _sampled(ref_monitor.stats())
    for _ in range(3):
        for _, call in BATTERY:
            call(paddle, ra)
    want = _delta(before, _sampled(ref_monitor.stats()))
    ref_obs.disable()
    observability.enable(categories=["dispatch"], dispatch_sample_rate=rate)
    before = _sampled(monitor.stats())
    for _ in range(3):
        for _, call in BATTERY:
            call(pt, pa)
    got = _delta(before, _sampled(monitor.stats()))
    observability.disable()
    assert got == want
    assert sum(got.values()) == len(BATTERY) * 3 // round(1 / rate)


def test_unsampled_torch_calls_skip_the_observers(monkeypatch):
    """With only the sampler registered, the mode's handler returns for
    every op but the sampled ones before it enters the observers."""
    entered = []
    real = dispatch._observed
    monkeypatch.setattr(dispatch, "_observed",
                        lambda *a, **k: entered.append(a[0]) or real(*a, **k))
    a = torch.ones(4)
    observability.enable(categories=["dispatch"], dispatch_sample_rate=0.1)
    try:
        for _ in range(50):
            torch.relu(a)
    finally:
        observability.disable()
    assert entered == ["relu"] * 5


def test_flash_kernels_report_under_the_reference_names():
    observability.enable(categories=["dispatch"], dispatch_sample_rate=1.0)
    before = _sampled(monitor.stats())
    gen = torch.Generator().manual_seed(1)
    q, k, v = (torch.randn(1, 64, 2, 32, generator=gen, requires_grad=True)
               for _ in range(3))
    fa.flash_attention_bshd(q, k, v, causal=True).sum().backward()
    got = _delta(before, _sampled(monitor.stats()))
    observability.disable()
    for name in ("flash_attention_fwd", "flash_attention_bwd_dq",
                 "flash_attention_bwd_dkv"):
        assert got[f'dispatch_op_sampled{{op="{name}"}}'] == 1, got
    # one op each: nothing inside a kernel's plain version is counted
    assert not any("matmul" in key for key in got)


def test_nothing_is_observed_in_a_capture_scope():
    rec = _Recorder()
    a = _port_tensor(np.ones(2, np.float32))
    dispatch.add_observer("test", rec)
    try:
        with dispatch.static_scope():
            torch.relu(torch.ones(2))
            ops.exp(a)
        torch.relu(torch.ones(2))
    finally:
        dispatch.remove_observer("test")
    assert [n for _, n in rec.seen] == ["ones", "relu"]


def test_call_op_runs_a_function_as_one_named_op():
    rec = _Recorder()
    a = _port_tensor(np.ones(2, np.float32))
    dispatch.add_observer("test", rec)
    try:
        out = pt.call_op(lambda a: torch.tanh(a) * 2, a,
                         op_name="scaled_tanh")
    finally:
        dispatch.remove_observer("test")
    assert isinstance(out, pt.Tensor)
    assert [n for _, n in rec.seen] == ["scaled_tanh"]
    assert dispatch.op_display_name(torch.tanh) == "tanh"
    assert pt.unwrap(out).__class__ is torch.Tensor
