"""Activation recompute (``paddle_tpu_torch.recompute`` and
``Layer.enable_recompute``) on the CPU.

- ``full`` and ``selective`` (and ``offload``, which falls back to
  ``selective`` here) are bitwise against no recompute in float32 on
  ``test_torch_bert.py``'s tiny BERT: the same ops on the same inputs, the
  products ``selective`` keeps reused as computed. With dropout the
  recomputation takes back what the forward's random ops drew and draws
  nothing itself: still bitwise, and the package's generator ends where it
  ends without recompute.
- Against the reference's ``paddle_tpu.recompute`` on the same weights and
  batch: the loss 1e-5 relative and every gradient 1e-4 relative L2, the
  bounds of ``test_torch_bert.py`` for the same float32 math in another
  order.
- Under ``to_static(scan_steps=2, dp_axis="dp")`` with ZeRO-3 at dp = 2
  (gloo ranks, ``test_torch_zero.spawn``): bitwise against the same
  program without recompute.
"""
import warnings

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import paddle_tpu_torch
from paddle_tpu_torch import amp, jit, optimizer, recompute
from paddle_tpu_torch.models import bert

SEQ, BATCH = 64, 2
TINY = dict(vocab_size=512, hidden_size=64, num_layers=2, num_heads=4,
            intermediate_size=128, max_position_embeddings=SEQ,
            hidden_dropout=0.0, attention_dropout=0.0)
F32_REL, F32_GRAD_REL = 1e-5, 1e-4


@pytest.fixture(autouse=True)
def _threads():
    # one intra-op thread: the gradients of this model depend on how many
    # threads split each reduction (measured: 1, 2, 3, 4 and 8 threads give
    # five different sums), and with one thread every reduction runs in
    # one order whatever else the process's OpenMP pool does; the arms
    # compared bitwise below then differ only in what recompute changes
    torch.set_num_threads(1)


def _model(**extra):
    paddle_tpu_torch.seed(0)
    return bert.BertForPretraining(bert.BertConfig(**dict(TINY, **extra)),
                                   device="cpu")


def _batch():
    return [torch.from_numpy(a) for a in bert.synthetic_mlm_batch(
        BATCH, SEQ, TINY["vocab_size"], seed=1)]


def _loss_and_grads(model, policy, bf16=False):
    if policy is not None:
        for layer in model.bert.layers:
            layer.enable_recompute(policy)
    ids, tok, labels, nsp = _batch()
    paddle_tpu_torch.seed(5)  # the dropout masks
    with amp.auto_cast(enable=bf16, dtype="bfloat16"):
        loss = model.loss(*model(ids, tok), labels, nsp)
    loss.backward()
    return loss.detach(), {n: p.grad for n, p in model.named_parameters()}


def _assert_same(got, want):
    assert torch.equal(got[0], want[0])
    for n, g in want[1].items():
        assert torch.equal(got[1][n], g), n


@pytest.mark.parametrize("policy", ["full", "selective"])
@pytest.mark.parametrize("dropout", [0.0, 0.1])
def test_recompute_is_bitwise_against_none(policy, dropout):
    extra = dict(hidden_dropout=dropout, attention_dropout=dropout)
    want = _loss_and_grads(_model(**extra), None)
    _assert_same(_loss_and_grads(_model(**extra), policy), want)


def test_recompute_under_bf16_autocast_is_bitwise():
    """The backward recomputes under the forward's auto_cast state."""
    want = _loss_and_grads(_model(), None, bf16=True)
    _assert_same(_loss_and_grads(_model(), "full", bf16=True), want)


def test_offload_falls_back_loudly_on_the_cpu():
    assert not recompute.host_offload_available("cpu")
    want = _loss_and_grads(_model(), None)
    with pytest.warns(UserWarning, match="falling back to 'selective'"):
        got = _loss_and_grads(_model(), "offload")
    _assert_same(got, want)
    with pytest.raises(RuntimeError, match="pinned host memory"):
        recompute.resolve_policy("offload", strict=True, device="cpu")
    assert recompute.resolve_policy("offload", device="cuda")[1] == "offload"


def test_offload_parks_the_products_in_host_buffers(monkeypatch):
    """The offload path itself, forced on the CPU (as if the CPU had host
    memory beside it): the products go to the host pool in the forward and
    come back in the backward, bitwise."""
    monkeypatch.setattr(recompute, "host_offload_available",
                        lambda device=None: True)
    w = torch.randn(32, 32, requires_grad=True)
    x = torch.randn(8, 32)

    def seg(v):
        return torch.tanh(v @ w).sum()

    def run(offload):
        w.grad = None
        if offload is None:
            loss = seg(x)
        else:
            loss = recompute.recompute(seg, x, policy="offload")
        loss.backward()
        return loss.detach(), w.grad.clone()

    want = run(None)
    before = recompute._host_pool.allocated
    got = run(True)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert recompute._host_pool.allocated - before in (0, 8 * 32 * 4)
    assert run(True)[1].equal(want[1])  # the buffer is reused
    assert recompute._host_pool.allocated - before == 8 * 32 * 4


class _CountRandom(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.draws = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.draws += torch.Tag.nondeterministic_seeded in func.tags
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("policy", ["full", "selective"])
def test_the_recomputation_draws_nothing(policy):
    """The backward reuses the forward's dropout draws: no random op runs
    in it, and the package's generator ends where it ends without
    recompute."""
    extra = dict(hidden_dropout=0.1, attention_dropout=0.1)
    states = []
    for pol in (None, policy):
        model = _model(**extra)
        if pol is not None:
            for layer in model.bert.layers:
                layer.enable_recompute(pol)
        ids, tok, labels, nsp = _batch()
        paddle_tpu_torch.seed(5)
        loss = model.loss(*model(ids, tok), labels, nsp)
        with _CountRandom() as count:
            loss.backward()
        assert count.draws == 0
        states.append(paddle_tpu_torch.core.random.default_generator(
            "cpu").get_state())
    assert torch.equal(states[0], states[1])


class _CountMM(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.mm = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default):
            self.mm += 1
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("policy, extra", [("none", 0), ("full", 8),
                                           ("selective", 0)])
def test_policy_decides_what_the_backward_recomputes(policy, extra):
    """The matrix products the backward runs beyond the plain backward's:
    ``full`` reruns each layer's four (qkv, out, fc1, fc2) in both layers;
    ``selective`` keeps them all."""
    model = _model()
    if policy != "none":
        for layer in model.bert.layers:
            layer.enable_recompute(policy)
    ids, tok, labels, nsp = _batch()
    loss = model.loss(*model(ids, tok), labels, nsp)
    with _CountMM() as count:
        loss.backward()
    plain = _model()
    plain_loss = plain.loss(*plain(ids, tok), labels, nsp)
    with _CountMM() as base:
        plain_loss.backward()
    assert count.mm - base.mm == extra


def test_policy_names():
    assert recompute.POLICIES == ("none", "full", "selective", "offload")
    assert recompute.resolve_policy("none") == (None, "none")
    assert recompute.resolve_policy("full")[1] == "full"
    assert recompute.resolve_policy("selective")[1] == "selective"
    custom = recompute.products_without_batch_dims_saveable
    assert recompute.resolve_policy(custom) == (
        custom, "products_without_batch_dims_saveable")
    with pytest.raises(ValueError, match="unknown recompute policy"):
        recompute.resolve_policy("everything")
    with pytest.raises(ValueError, match="unknown recompute policy"):
        recompute.recompute(lambda x: x, torch.ones(2), policy="bogus")
    with pytest.raises(ValueError, match="unknown recompute policy"):
        _model().bert.layers[0].enable_recompute("bogus")
    with pytest.raises(TypeError, match="callable"):
        recompute.recompute(3)


def test_wrapper_and_immediate_forms():
    w = torch.randn(4, 4, requires_grad=True)
    x = torch.randn(3, 4)

    def fn(v, scale=1.0):
        return (torch.relu(v @ w) * scale).sum()

    wrapped = recompute.recompute(fn, policy="selective")
    assert wrapped._recompute_policy == "selective"
    for loss in (wrapped(x, scale=2.0),
                 recompute.recompute(fn, x, policy="full", scale=2.0)):
        w.grad = None
        loss.backward()
        g = w.grad.clone()
        w.grad = None
        fn(x, scale=2.0).backward()
        assert torch.equal(g, w.grad)


def test_eval_and_no_grad_run_the_layer_plainly(monkeypatch):
    calls = []
    real = recompute._segment_call
    monkeypatch.setattr(recompute, "_segment_call",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    model = _model()
    layer = model.bert.layers[0].enable_recompute("full")
    x = torch.randn(BATCH, SEQ, TINY["hidden_size"])
    layer.eval()
    with torch.no_grad():
        want = layer(x)
    layer.train()
    with torch.no_grad():
        layer(x)
    assert calls == []
    assert torch.equal(layer(x), want)  # training, dropout 0: one segment
    assert calls == [1]
    layer.disable_recompute()
    layer(x)
    assert calls == [1] and "forward" not in layer.__dict__


def test_forward_hooks_run_once_a_call():
    model = _model()
    layer = model.bert.layers[0].enable_recompute("full")
    seen = []
    layer.register_forward_pre_hook(lambda m, inp: seen.append("pre"))
    layer.register_forward_post_hook(lambda m, inp, out: seen.append("post"))
    out = layer(torch.randn(BATCH, SEQ, TINY["hidden_size"]))
    out.sum().backward()
    assert seen == ["pre", "post"]


def test_matches_the_reference_recompute():
    import paddle_tpu as paddle
    from test_torch_bert import _pair
    ref, port = _pair()
    for layer in ref.bert.layers:
        layer.enable_recompute("full")
    ids, tok, labels, nsp = (a.numpy() for a in _batch())
    want = ref.loss(*ref(paddle.to_tensor(ids), paddle.to_tensor(tok)),
                    paddle.to_tensor(labels), paddle.to_tensor(nsp))
    want.backward()
    got, grads = _loss_and_grads(port, "full")
    assert abs(float(got) - float(want)) <= F32_REL * abs(float(want))
    ref_grads = {n: np.asarray(p.grad.numpy())
                 for n, p in ref.named_parameters()}
    for n, g in grads.items():
        diff = np.linalg.norm(g.numpy() - ref_grads[n])
        assert diff <= F32_GRAD_REL * max(np.linalg.norm(ref_grads[n]),
                                          1e-30), n


# -- under the dp program with ZeRO-3, on gloo ranks --------------------------

def rank_task(task, data):
    """One rank of the dp = 2 check: the tiny BERT's k=2 program with
    ZeRO-3, with and without full recompute on every encoder layer."""
    k = 2
    batches = [bert.synthetic_mlm_batch(4, SEQ, TINY["vocab_size"],
                                        seed=30 + i) for i in range(k)]
    stacked = [torch.from_numpy(np.stack(col)) for col in zip(*batches)]
    runs = []
    for policy in (None, "full"):
        model = _model(hidden_dropout=0.1, attention_dropout=0.1)
        if policy:
            for layer in model.bert.layers:
                layer.enable_recompute(policy)
        opt = optimizer.AdamW(parameters=model.parameters(),
                              learning_rate=1e-3)
        opt._zero_enable(axis="dp", stage=3)

        def one(ids, tok, labels, nsp, model=model, opt=opt):
            loss = model.loss(*model(ids, tok), labels, nsp)
            loss.backward()
            opt.step()
            opt.clear_grad()
            return loss
        step = jit.to_static(one, scan_steps=k, dp_axis="dp")
        paddle_tpu_torch.seed(9)
        losses = [step(*stacked), step(*stacked)]
        runs.append((losses, [p.detach().clone()
                              for p in model.parameters()]))
    (want, want_p), (got, got_p) = runs
    return {"losses": [t.numpy() for t in got],
            "bitwise": all(torch.equal(a, b) for a, b in zip(got, want))
            and all(torch.equal(a, b) for a, b in zip(got_p, want_p))}


def test_recompute_under_the_zero3_dp_program(tmp_path):
    from test_torch_zero import _inputs, spawn
    _inputs(tmp_path / "inputs.npz")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        out = spawn(tmp_path, 2, "recompute_dp2")
    assert out["bitwise"]
    assert all(np.isfinite(l).all() for l in out["losses"])
