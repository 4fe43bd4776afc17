"""The port's heterogeneous PS channel against the reference's, on the CPU
(``tests/test_parameter_server.py``'s heter pipeline, with the trainer in
a thread of the test's process: the reference's test is marked slow for
its two subprocesses).

- The frame: both packages write the same bytes for the same arrays, and
  each package's client works against the other package's server, reply
  for reply.
- A handler that raises on the trainer raises on the client, and the
  channel goes on serving; ``stop`` ends the accepting thread.
- 30 batches of the pipeline (a worker's sparse stage on the port's PS,
  the dense stage behind ``start_heter_server``): losses, dense
  parameters and the server's rows exactly those of a control in the
  same process that calls the same handler directly, and the loss falls.
"""
import gc
import socket
import threading

import numpy as np
import pytest
import torch

from paddle_tpu.distributed.ps import heter as ref_heter
import paddle_tpu_torch as pt
from paddle_tpu_torch.distributed import ps
from paddle_tpu_torch.distributed.ps import heter
from paddle_tpu_torch.distributed.ps.communicator import SyncCommunicator
from paddle_tpu_torch.distributed.ps.embedding import (flush_sparse_grads,
                                                       reset_registry)
from paddle_tpu_torch.nn import functional as F

VOCAB, DIM, SLOTS, BATCH, STEPS = 40, 4, 3, 32, 30


@pytest.fixture(autouse=True)
def _release():
    yield
    # the layers a test built may sit in reference cycles: collect them,
    # so no later test of this process finds them in the state ledger
    gc.collect()


def _frame(module, arrays):
    a, b = socket.socketpair()
    try:
        module._send_arrays(a, arrays)
        a.shutdown(socket.SHUT_WR)
        out = b""
        while True:
            chunk = b.recv(1 << 16)
            if not chunk:
                return out
            out += chunk
    finally:
        a.close()
        b.close()


def test_both_packages_write_the_same_frame():
    arrays = [np.random.RandomState(0).randn(7, 5).astype(np.float32),
              np.arange(3, dtype=np.int64), np.zeros(()),
              np.asarray("HETER_ERROR: x")]
    for n in (1, 2, 4):
        got = _frame(heter, arrays[:n])
        assert got == _frame(ref_heter, arrays[:n])
        assert int.from_bytes(got[:4], "little") == 0x31485450


def _echo(acts, labels):
    """A handler whose reply is a function of the request."""
    return float(acts.sum() + labels.sum()), acts * 2.0 + labels.mean()


@pytest.mark.parametrize("server", ["reference", "port"])
def test_each_client_against_the_other_packages_server(server):
    mod = ref_heter if server == "reference" else heter
    srv, port = mod.start_heter_server(_echo)
    r = np.random.RandomState(1)
    clients = [heter.HeterClient(f"127.0.0.1:{port}"),
               ref_heter.HeterClient(f"127.0.0.1:{port}")]
    try:
        for _ in range(3):
            acts = r.randn(8, 6).astype(np.float32)
            labels = r.rand(8, 1).astype(np.float32)
            want = _echo(acts, labels)
            for c in clients:
                loss, dacts = c.send_and_recv(acts, labels)
                assert loss == want[0]
                np.testing.assert_array_equal(dacts, want[1])
        # a tensor goes over as its host array
        loss, _ = clients[0].send_and_recv(torch.from_numpy(acts),
                                           torch.from_numpy(labels))
        assert loss == want[0]
    finally:
        clients[1].stop_server()
        for c in clients:
            c.close()
        srv.stop()


def test_a_trainer_side_failure_raises_on_the_client():
    def handler(acts, labels):
        if acts.shape[0] != 4:
            raise ValueError(f"bad batch {acts.shape[0]}")
        return 1.0, torch.zeros(4, 2)

    srv, port = heter.start_heter_server(handler)
    c = heter.HeterClient(f"127.0.0.1:{port}")
    try:
        with pytest.raises(RuntimeError, match="HETER_ERROR: bad batch 3"):
            c.send_and_recv(np.zeros((3, 2), np.float32),
                            np.zeros((3, 1), np.float32))
        loss, dacts = c.send_and_recv(np.zeros((4, 2), np.float32),
                                      np.zeros((4, 1), np.float32))
        assert loss == 1.0 and dacts.shape == (4, 2)
    finally:
        c.stop_server()
        c.close()
        srv.stop()


def test_stop_ends_serve_forever():
    """``stop`` wakes the accepting thread (a close alone leaves it blocked
    in ``accept``, holding the handler and the trainer's model)."""
    srv = heter.HeterServer(_echo)
    th = threading.Thread(target=srv.serve_forever, daemon=True)
    th.start()
    heter.HeterClient(f"127.0.0.1:{srv.port}").close()
    srv.stop()
    th.join(timeout=10)
    assert not th.is_alive()


def _trainer(seed):
    """The reference test's dense stage on the CPU: its handler runs the
    forward, the backward and an SGD update per request."""
    pt.seed(seed)
    dense = pt.nn.Sequential(pt.nn.Linear(SLOTS * DIM, 16, device="cpu"),
                             pt.nn.ReLU(),
                             pt.nn.Linear(16, 1, device="cpu"))
    opt = pt.optimizer.SGD(parameters=dense.parameters(), learning_rate=0.2)

    def handler(acts, labels):
        a = torch.from_numpy(acts.astype(np.float32)).requires_grad_()
        loss = F.binary_cross_entropy_with_logits(dense(a),
                                                  torch.from_numpy(labels))
        loss.backward()
        opt.step()
        opt.clear_grad()
        return float(loss.detach()), a.grad.numpy()

    return dense, handler


def _worker(cli, table_id, exchange):
    """The worker's sparse stage for STEPS batches; ``exchange(acts,
    labels)`` reaches the dense stage. Returns the losses."""
    reset_registry()
    comm = SyncCommunicator(cli, n_workers=1)
    emb = ps.SparseEmbedding([VOCAB, DIM], table_id=table_id, device="cpu")
    emb.bind(comm)
    w_id = np.random.RandomState(42).randn(VOCAB).astype(np.float32)
    rng = np.random.RandomState(0)
    losses = []
    for _ in range(STEPS):
        ids = rng.randint(0, VOCAB, (BATCH, SLOTS)).astype(np.int64)
        labels = (w_id[ids[:, 0]] > 0).astype(np.float32).reshape(-1, 1)
        acts = emb(torch.from_numpy(ids)).reshape(BATCH, SLOTS * DIM)
        loss, dacts = exchange(acts.detach().numpy(), labels)
        acts.backward(torch.from_numpy(dacts))
        flush_sparse_grads(comm)
        comm.step()
        losses.append(loss)
    comm.stop()
    return np.asarray(losses)


def test_the_worker_trainer_pipeline_equals_an_in_process_control():
    tables = [ps.TableConfig(t, "sparse", DIM, "sgd", lr=0.2,
                             init_range=0.1, seed=1000) for t in (1000, 1001)]
    pss = ps.PsServer(tables, port=0)
    cli = ps.PsClient([f"127.0.0.1:{pss.start()}"])
    for t in (1000, 1001):
        cli.register_sparse(t, DIM)
    dense, handler = _trainer(1)
    control, control_handler = _trainer(1)
    srv, port = heter.start_heter_server(handler)
    client = heter.HeterClient(f"127.0.0.1:{port}")
    try:
        losses = _worker(cli, 1000, client.send_and_recv)
        want = _worker(cli, 1001, control_handler)
        np.testing.assert_array_equal(losses, want)
        assert np.mean(losses[-5:]) < np.mean(losses[:5])
        for a, b in zip(dense.parameters(), control.parameters()):
            assert torch.equal(a, b)
        keys = np.arange(VOCAB, dtype=np.uint64)
        np.testing.assert_array_equal(cli.pull_sparse(1000, keys),
                                      cli.pull_sparse(1001, keys))
        assert cli.sparse_size(1000) == VOCAB
    finally:
        client.stop_server()
        client.close()
        srv.stop()
        for t in srv._threads:  # the tower is freed once they are done
            t.join(timeout=30)
        cli.stop_servers()
        cli.close()
        pss.stop()
        reset_registry()
