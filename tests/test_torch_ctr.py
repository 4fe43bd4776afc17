"""``models.ctr`` and ``binary_cross_entropy_with_logits`` against the
reference, on the CPU.

- ``WideAndDeep``'s dense weights carry across with ``bridge`` (the same
  structured names); its sparse tables need no carrying: both packages'
  servers initialize every row from ``(seed, key)`` with one splitmix
  code, and their rows are asserted bitwise equal.
- Uncached eager steps (per-batch PS pulls and pushes, dense SGD) and the
  cached k-step windows (``train_ctr_windows``, dense Adam): losses, dense
  parameters and the servers' rows afterwards within ``RTOL`` of the
  reference's (float32 in two libraries; the rows' updates are the
  server's own rule in both).
- The losses within ``BCE_RTOL`` of the reference's, with ``weight``,
  ``pos_weight`` and each reduction, and their gradients.
"""
import gc

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.distributed import ps as ref_ps
from paddle_tpu.distributed.ps.communicator import \
    SyncCommunicator as RefSync
from paddle_tpu.distributed.ps.embedding import \
    flush_sparse_grads as ref_flush
from paddle_tpu.distributed.ps.embedding import \
    reset_registry as ref_reset
from paddle_tpu.models import ctr as ref_ctr
import paddle_tpu_torch as pt
from paddle_tpu_torch import bridge
from paddle_tpu_torch.distributed import ps
from paddle_tpu_torch.distributed.ps.communicator import SyncCommunicator
from paddle_tpu_torch.distributed.ps.embedding import (flush_sparse_grads,
                                                       reset_registry)
from paddle_tpu_torch.models import ctr
from paddle_tpu_torch.nn import functional as F

RTOL, ATOL = 1e-4, 1e-6
BCE_RTOL = 1e-6
VOCAB, DIM, SLOTS, HIDDEN, BATCH, K, NB = 500, 8, 4, (32, 16), 32, 4, 8


@pytest.fixture(autouse=True)
def _threads():
    torch.set_num_threads(2)
    yield
    # the registries hold the embedding layers, and through their
    # communicators the dense parameters: drop them, so no later test
    # of this process sees them in the state ledger
    reset_registry()
    ref_reset()
    gc.collect()


def _tables(pkg, dense=False):
    """The deep and wide tables; with ``dense`` one dense SGD table per
    dense parameter (the Downpour path trains those on the server too)."""
    return [pkg.TableConfig(1000, "sparse", DIM, "sgd", lr=0.05,
                            init_range=0.05, seed=1000),
            pkg.TableConfig(1001, "sparse", 1, "sgd", lr=0.05,
                            init_range=0.05, seed=1001)] + [
        pkg.TableConfig(i, "dense", 0, "sgd", lr=0.05)
        for i in range(2 * len(HIDDEN) + 2 if dense else 0)]


def _batches():
    return ctr.synthetic_ctr_batches(NB, batch_size=BATCH, slots=SLOTS,
                                     vocab=VOCAB, seed=3)


class _Run:
    """One package's server, client, model and communicator."""

    def __init__(self, pkg, model_mod, cached, state=None, dense=False,
                 **kw):
        (reset_registry if pkg is ps else ref_reset)()
        self.pkg = pkg
        self.srv = pkg.PsServer(_tables(pkg, dense), port=0)
        self.cli = pkg.PsClient([f"127.0.0.1:{self.srv.start()}"])
        if pkg is ps:
            kw["device"] = "cpu"
        else:
            paddle.seed(0)
        self.model = model_mod.WideAndDeep(
            VOCAB, dim=DIM, slots=SLOTS, hidden=HIDDEN, cached=cached,
            capacity=1 << 10, optimizer="sgd", lr=0.05, **kw)
        if state is not None:
            bridge.load_reference_state(self.model, state)
        self.comm = (SyncCommunicator if pkg is ps else RefSync)(
            self.cli, n_workers=1)
        pkg.bind_model(self.model, self.comm)

    def rows(self):
        return [self.cli.pull_sparse(t, np.arange(VOCAB, dtype=np.uint64))
                for t in (1000, 1001)]

    def dense(self):
        return [np.asarray(p.detach().numpy() if self.pkg is ps
                           else p.numpy()) for p in self.model.parameters()]

    def close(self):
        self.cli.stop_servers()
        self.cli.close()
        self.srv.stop()


def _state(run):
    return {k: np.asarray(v) for k, v in run.model.state_dict().items()}


def test_bridge_names_and_both_servers_rows_are_equal():
    ref = _Run(ref_ps, ref_ctr, cached=False)
    try:
        state = _state(ref)
        port = _Run(ps, ctr, cached=False, state=state)
        try:
            assert list(port.model.state_dict()) == list(state)
            for name, t in port.model.state_dict().items():
                np.testing.assert_array_equal(t.numpy(), state[name])
            for a, b in zip(port.rows(), ref.rows()):
                np.testing.assert_array_equal(a, b)
        finally:
            port.close()
    finally:
        ref.close()


def _eager_port(run, batches):
    """The Downpour sync step: pull, forward, backward, push, pull."""
    model, comm = run.model, run.comm
    comm.init_params()
    losses = []
    for ids, label in batches:
        loss = F.binary_cross_entropy_with_logits(
            model(pt.to_tensor(ids, place="cpu")),
            pt.to_tensor(label, place="cpu"))
        loss.backward()
        flush_sparse_grads(comm)
        comm.step()
        losses.append(float(loss.detach()))
    return losses


def _eager_ref(run, batches):
    model, comm = run.model, run.comm
    comm.init_params()
    losses = []
    for ids, label in batches:
        loss = paddle.nn.functional.binary_cross_entropy_with_logits(
            model(paddle.to_tensor(ids)), paddle.to_tensor(label))
        loss.backward()
        ref_flush(comm)
        comm.step()
        losses.append(float(loss.numpy()))
    return losses


def _compare(port, ref, port_losses, ref_losses):
    np.testing.assert_allclose(port_losses, ref_losses, rtol=RTOL)
    for a, b in zip(port.dense(), ref.dense()):
        np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL)
    for a, b in zip(port.rows(), ref.rows()):
        np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL)


def test_uncached_eager_steps_match_the_reference():
    batches = _batches()[:5]
    ref = _Run(ref_ps, ref_ctr, cached=False, dense=True)
    try:
        state = _state(ref)
        ref_losses = _eager_ref(ref, batches)
        port = _Run(ps, ctr, cached=False, state=state, dense=True)
        try:
            port_losses = _eager_port(port, batches)
            _compare(port, ref, port_losses, ref_losses)
            assert np.mean(port_losses[-2:]) < np.mean(port_losses[:2])
        finally:
            port.close()
    finally:
        ref.close()


@pytest.mark.parametrize("prefetch", [True, False])
def test_train_ctr_windows_matches_the_reference(prefetch):
    ref = _Run(ref_ps, ref_ctr, cached=True)
    try:
        state = _state(ref)
        r = ref_ctr.train_ctr_windows(
            ref.model, paddle.optimizer.Adam(
                parameters=ref.model.parameters(), learning_rate=0.001),
            _batches(), k=K, prefetch=False, flush=True)
        port = _Run(ps, ctr, cached=True, state=state)
        try:
            opt = pt.optimizer.Adam(parameters=port.model.parameters(),
                                    learning_rate=0.001)
            got = ctr.train_ctr_windows(port.model, opt, _batches(), k=K,
                                        prefetch=prefetch, flush=True)
            assert got["windows"] == r["windows"] == NB // K
            assert got["lookups"] == r["lookups"]
            _compare(port, ref, got["losses"], r["losses"])
            # the caches' device rows are the server's after the flush
            for c in port.model.caches():
                slots = list(c._slots.values())
                keys = np.fromiter(c._slots, np.uint64)
                np.testing.assert_array_equal(
                    c.table.numpy()[slots], port.cli.pull_sparse(
                        c.table_id, keys))
        finally:
            port.close()
    finally:
        ref.close()


def test_the_k_step_body_refuses_raw_ids():
    run = _Run(ps, ctr, cached=True)
    try:
        opt = pt.optimizer.SGD(parameters=run.model.parameters(),
                               learning_rate=0.01)
        model = run.model

        def bad(ids, labels):
            return F.binary_cross_entropy_with_logits(model(ids), labels)

        step = pt.jit.to_static(bad, scan_steps=2)
        ids = torch.zeros((2, BATCH, SLOTS), dtype=torch.int64)
        with pytest.raises(RuntimeError, match="prebuilt"):
            step(ids, torch.zeros((2, BATCH, 1)))
        assert not pt.jit.in_tracing()
        del opt
    finally:
        run.close()


@pytest.mark.parametrize("reduction", ["mean", "sum", "none"])
@pytest.mark.parametrize("weighted", [False, True])
def test_bce_with_logits_matches_the_reference(reduction, weighted):
    rng = np.random.RandomState(0)
    z = (rng.randn(6, 3) * 4).astype(np.float32)
    t = (rng.rand(6, 3) > 0.5).astype(np.float32)
    w = rng.rand(6, 3).astype(np.float32) if weighted else None
    pw = (rng.rand(3) * 3).astype(np.float32) if weighted else None
    cot = np.asarray(rng.randn(*((6, 3) if reduction == "none" else ())),
                     np.float32)

    rz = paddle.to_tensor(z, stop_gradient=False)
    rk = {"weight": paddle.to_tensor(w), "pos_weight": paddle.to_tensor(pw)} \
        if weighted else {}
    rl = paddle.nn.functional.binary_cross_entropy_with_logits(
        rz, paddle.to_tensor(t), reduction=reduction, **rk)
    paddle.ops.sum(rl * paddle.to_tensor(cot)).backward()

    pz = pt.to_tensor(z, place="cpu", stop_gradient=False)
    pk = {"weight": pt.to_tensor(w, place="cpu"),
          "pos_weight": pt.to_tensor(pw, place="cpu")} if weighted else {}
    pl = F.binary_cross_entropy_with_logits(
        pz, pt.to_tensor(t, place="cpu"), reduction=reduction, **pk)
    (pl * pt.to_tensor(cot, place="cpu")).sum().backward()
    assert type(pl) is pt.Tensor
    np.testing.assert_allclose(pl.numpy(), np.asarray(rl.numpy()),
                               rtol=BCE_RTOL, atol=1e-7)
    np.testing.assert_allclose(pz.grad.numpy(), np.asarray(rz.grad),
                               rtol=BCE_RTOL, atol=1e-7)
