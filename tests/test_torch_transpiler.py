"""The parameter-server transpiler and the fleet 1.x facade on the CPU
(``static.transpiler``, ``incubate.fleet``).

The reference's test model (``tests/test_distribute_transpiler.py``): a
trainer program against a native PS server in this process (port 0; the
library holds one server a process), its gradients from the replay,
pushed and pulled through the sync communicator. Losses within 2e-4
relative of the untranspiled local program (the reference's own bound:
the servers apply the rule in float32 in another order), and the local
program within 1e-5 relative of ``paddle_tpu``'s on the same weights.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as ref
import paddle_tpu.static as rstatic
import paddle_tpu_torch as pt
import paddle_tpu_torch.static as static

CPU = "cpu"
W = np.random.RandomState(3).randn(4, 8).astype(np.float32) * 0.5
W2 = np.random.RandomState(4).randn(8, 1).astype(np.float32) * 0.5


@pytest.fixture(autouse=True)
def _threads():
    torch.set_num_threads(2)


def _build(pkg=pt, st=static, optimizer="sgd", bn=None):
    kw = {"device": CPU} if st is static else {}
    prog = st.Program()
    with st.program_guard(prog):
        rows = None if bn is None else 8  # a batch norm trains on 8 rows
        x = st.data("x", [rows, 4], "float32", **kw)
        y = st.data("y", [rows, 1], "float32", **kw)
        w = st.create_parameter([4, 8], "float32", name="w", **kw)
        w2 = st.create_parameter([8, 1], "float32", name="w2", **kw)
        w.set_value(W)
        w2.set_value(W2)
        h = pkg.matmul(bn(x) if bn is not None else x, w)
        out = pkg.matmul(pkg.nn.functional.relu(h), w2)
        loss = ((out - y) ** 2).mean()
        opt = (pkg.optimizer.SGD(learning_rate=0.1) if optimizer == "sgd"
               else pkg.optimizer.Adam(learning_rate=0.05))
        opt.minimize(loss)
    return prog, loss


def _batches(n, seed=5):
    rng = np.random.RandomState(seed)
    w_true = np.random.RandomState(1).randn(4, 1).astype(np.float32)
    out = []
    for _ in range(n):
        x = rng.rand(8, 4).astype(np.float32)
        out.append((x, x @ w_true))
    return out


def _train(prog, loss, exe, steps):
    return [float(exe.run(prog, feed={"x": x, "y": y}, fetch_list=[loss])[0])
            for x, y in _batches(steps)]


def _server(prog):
    """A server for ``prog``'s tables on a free port of this process."""
    tables = static.DistributeTranspiler().transpile(
        0, program=prog, pservers="127.0.0.1:1")._tables
    srv = static.PsServerProgram("127.0.0.1:0", tables)
    return srv, srv.start()


@pytest.mark.parametrize("optimizer", ["sgd", "adam"])
def test_trainer_program_matches_the_local_program(optimizer):
    local = _train(*_build(optimizer=optimizer), static.Executor(CPU), 12)
    reference = _train(*_build(ref, rstatic, optimizer=optimizer),
                       rstatic.Executor(), 12)
    np.testing.assert_allclose(local, reference, rtol=1e-5)

    srv, port = _server(_build(optimizer=optimizer)[0])
    prog, loss = _build(optimizer=optimizer)
    try:
        t = static.DistributeTranspiler()
        t.transpile(trainer_id=0, program=prog,
                    pservers=f"127.0.0.1:{port}", trainers=1)
        trainer = t.get_trainer_program()
        assert trainer._optimizer is None  # the rule runs on the server
        exe = static.Executor(CPU)
        assert exe.run(t.get_startup_program()) == []
        losses = _train(trainer, loss, exe, 12)
    finally:
        if prog._ps_ctx is not None:
            prog._ps_ctx.stop()
        srv.server.stop()
    np.testing.assert_allclose(losses, local, rtol=2e-4)
    assert np.mean(losses[-3:]) < np.mean(losses[:3])


def test_batchnorm_statistics_move_on_the_trainer():
    bn = pt.nn.BatchNorm1D(4, device=CPU)
    srv, port = _server(_build(bn=pt.nn.BatchNorm1D(4, device=CPU))[0])
    prog, loss = _build(bn=bn)
    try:
        t = static.DistributeTranspiler()
        t.transpile(0, program=prog, pservers=f"127.0.0.1:{port}")
        before = bn._mean.clone()
        _train(t.get_trainer_program(), loss, static.Executor(CPU), 3)
        assert not torch.equal(bn._mean, before)
    finally:
        prog._ps_ctx.stop()
        srv.server.stop()


def test_refusals():
    prog, _ = _build()
    with pytest.raises(ValueError, match="endpoint"):
        static.DistributeTranspiler().transpile(0, program=prog, pservers="")
    with pytest.raises(RuntimeError, match="optimizer"):
        static.DistributeTranspiler().transpile(
            0, program=static.Program(), pservers="127.0.0.1:1")
    for make, match in (
            (lambda: pt.optimizer.AdamW(learning_rate=0.1), "AdamW"),
            (lambda: pt.optimizer.SGD(learning_rate=pt.optimizer.lr.StepDecay(
                learning_rate=0.1, step_size=2)), "LRScheduler")):
        p = static.Program()
        with static.program_guard(p):
            x = static.data("x", [None, 4], "float32", device=CPU)
            w = static.create_parameter([4, 1], "float32", device=CPU)
            make().minimize((pt.matmul(x, w) ** 2).mean())
        with pytest.raises(NotImplementedError, match=match):
            static.DistributeTranspiler().transpile(
                0, program=p, pservers="127.0.0.1:1")
    cfg = static.DistributeTranspilerConfig()
    with pytest.warns(UserWarning, match="no effect"):
        cfg.slice_var_up = False
    assert cfg.min_block_size == 8192


def test_fleet1x_facade_worker_side(monkeypatch):
    from paddle_tpu_torch.distributed.fleet.base.role_maker import \
        PaddleCloudRoleMaker
    from paddle_tpu_torch.incubate.fleet import fleet
    srv, port = _server(_build()[0])
    for k, v in {"TRAINING_ROLE": "TRAINER", "PADDLE_TRAINER_ID": "0",
                 "PADDLE_TRAINERS_NUM": "1",
                 "PADDLE_PSERVER_ENDPOINTS": f"127.0.0.1:{port}"}.items():
        monkeypatch.setenv(k, v)
    try:
        fleet.init(PaddleCloudRoleMaker(is_collective=False))
        assert fleet.is_worker() and not fleet.is_server()
        assert fleet.server_endpoints(to_string=True) == f"127.0.0.1:{port}"
        prog = static.Program()
        with static.program_guard(prog):
            x = static.data("x", [None, 4], "float32", device=CPU)
            y = static.data("y", [None, 1], "float32", device=CPU)
            w = static.create_parameter([4, 8], "float32", device=CPU)
            w2 = static.create_parameter([8, 1], "float32", device=CPU)
            w.set_value(W)
            w2.set_value(W2)
            out = pt.matmul(pt.nn.functional.relu(pt.matmul(x, w)), w2)
            loss = ((out - y) ** 2).mean()
            fleet.distributed_optimizer(
                pt.optimizer.SGD(learning_rate=0.1)).minimize(loss)
        fleet.init_worker()
        losses = _train(fleet.main_program(), loss, static.Executor(CPU), 8)
        assert losses[-1] < losses[0]
        fleet.stop_worker()
    finally:
        srv.server.stop()
