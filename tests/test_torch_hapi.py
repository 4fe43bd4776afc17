"""``hapi`` of the port against the reference's, on the CPU.

- LeNet on a slice of the synthetic MNIST (256 training and 128 evaluation
  images, batch 32, two epochs, ``Adam(1e-3)``, ``CrossEntropyLoss``,
  ``Accuracy``) from the reference's weights through ``prepare``, ``fit``
  (evaluating after each epoch), ``evaluate`` and ``predict`` in both
  packages: each batch's loss within 1e-5 relative of the reference's
  (float32, the same math in another summation order), the metric's value
  after each batch and after ``evaluate`` equal, ``predict``'s logits
  within 1e-4 of the largest.
- Each callback against the reference's on the same logs: the values it
  keeps and what it prints or writes, exactly.
- ``Model.save`` in one package and ``load`` in the other: the network's
  parameters and buffers equal, the step count and rate carried.
- ``summary``'s totals and table and ``flops`` equal the reference's;
  ``hub`` loads from a local ``hubconf.py`` and refuses the download
  sources, as the reference does.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu_torch as pt
from paddle_tpu.hapi import callbacks as RC
from paddle_tpu_torch.bridge import load_reference_state
from paddle_tpu_torch.hapi import callbacks as TC

LOSS_REL = 1e-5
PRED_TOL = 1e-4
BATCH, EPOCHS = 32, 2


def _state(layer):
    return {k: np.asarray(v.numpy()) for k, v in layer.state_dict().items()}


class Recorder:
    """A callback (of either package) that keeps every batch's logs."""

    def __init__(self, base):
        self.batches, self.evals = [], []
        self.cb = type("Rec", (base,), {
            "on_batch_end": lambda cb, mode, step, logs=None:
                self.batches.append((mode, step, dict(logs or {}))),
            "on_eval_end": lambda cb, logs=None:
                self.evals.append(dict(logs or {}))})()


def _fit(M, net, train, evals):
    model = M.Model(net)
    model.prepare(M.optimizer.Adam(learning_rate=1e-3,
                                   parameters=net.parameters()),
                  M.nn.CrossEntropyLoss(), M.metric.Accuracy(topk=(1, 2)))
    rec = Recorder(M.hapi.callbacks.Callback)
    np.random.seed(21)
    history = model.fit(train, evals, batch_size=BATCH, epochs=EPOCHS,
                        verbose=0, callbacks=[rec.cb])
    ev = model.evaluate(evals, batch_size=64, verbose=0)
    pred = model.predict(evals, batch_size=50, stack_outputs=True)[0]
    return model, rec, history, ev, pred


@pytest.fixture(scope="module")
def runs():
    paddle.seed(17)
    ref_net = paddle.vision.models.LeNet()
    port_net = load_reference_state(pt.vision.models.LeNet(device="cpu"),
                                    _state(ref_net))
    out = {}
    for key, M, net in (("ref", paddle, ref_net), ("port", pt, port_net)):
        data = M.vision.datasets.MNIST(mode="train")
        train = M.io.Subset(data, range(256))
        evals = M.io.Subset(data, range(256, 384))
        out[key] = _fit(M, net, train, evals)
    return out


def test_fit_losses_and_metrics_match_the_reference(runs):
    got, want = runs["port"][1], runs["ref"][1]
    train = [b for b in got.batches if b[0] == "train"]
    assert len(train) == EPOCHS * 256 // BATCH
    assert [b[:2] for b in got.batches] == [b[:2] for b in want.batches]
    for (_, _, g), (_, _, w) in zip(got.batches, want.batches):
        assert set(g) == set(w)
        assert abs(g["loss"] - w["loss"]) <= LOSS_REL * abs(w["loss"])
        for name in ("acc_top1", "acc_top2"):
            if name in w:
                assert g[name] == w[name]
    assert len(got.evals) == EPOCHS
    for g, w in zip(got.evals, want.evals):
        assert g["acc_top1"] == w["acc_top1"]


def test_history_evaluate_and_predict_match_the_reference(runs):
    _, _, g_hist, g_ev, g_pred = runs["port"]
    _, _, w_hist, w_ev, w_pred = runs["ref"]
    assert [h["step"] for h in g_hist] == [h["step"] for h in w_hist]
    assert g_ev["acc_top1"] == w_ev["acc_top1"]
    assert g_ev["acc_top2"] == w_ev["acc_top2"]
    assert abs(g_ev["loss"][0] - w_ev["loss"][0]) <= LOSS_REL * abs(
        w_ev["loss"][0])
    assert g_pred.shape == w_pred.shape == (128, 10)
    assert np.abs(g_pred - w_pred).max() <= PRED_TOL * np.abs(w_pred).max()


def test_batch_entry_points_and_no_captures_on_the_cpu(runs):
    model = runs["port"][0]
    x = torch.rand(4, 1, 28, 28)
    y = torch.randint(0, 10, (4, 1))
    losses, metrics = model.train_batch([x], [y])
    assert isinstance(losses[0], float) and len(metrics) == 1
    losses, metrics = model.eval_batch([x], [y])
    assert isinstance(losses[0], float)
    (out,) = model.predict_batch([x])
    assert isinstance(out, np.ndarray) and out.shape == (4, 10)
    assert model.captures() == {"train": 0, "eval": 0}
    assert model.parameters()[0] is model.network.parameters()[0]


def test_save_in_one_package_load_in_the_other(runs, tmp_path):
    port, ref = runs["port"][0], runs["ref"][0]
    port.save(str(tmp_path / "port"))
    ref.save(str(tmp_path / "ref"))
    paddle.seed(3)
    ref_fresh = paddle.Model(paddle.vision.models.LeNet())
    ref_fresh.prepare(paddle.optimizer.Adam(
        parameters=ref_fresh.network.parameters()))
    ref_fresh.load(str(tmp_path / "port"))
    for k, v in _state(ref_fresh.network).items():
        np.testing.assert_array_equal(
            v, port.network.state_dict()[k].numpy())
    port_fresh = pt.Model(pt.vision.models.LeNet(device="cpu"))
    port_fresh.prepare(pt.optimizer.Adam(
        parameters=port_fresh.network.parameters()))
    port_fresh.load(str(tmp_path / "ref"))
    for k, v in _state(ref.network).items():
        np.testing.assert_array_equal(
            port_fresh.network.state_dict()[k].numpy(), v)
    assert int(port_fresh._optimizer.state_dict()["@step"]) == int(
        np.asarray(ref._optimizer.state_dict()["@step"]))
    port_fresh.load(str(tmp_path / "port"), reset_optimizer=True)


def test_summary_and_flops_match_the_reference(capsys):
    paddle.seed(1)
    ref_net = paddle.vision.models.LeNet()
    port_net = pt.vision.models.LeNet(device="cpu")
    want = paddle.summary(ref_net, (1, 1, 28, 28))
    want_text = capsys.readouterr().out
    got = pt.summary(port_net, (1, 1, 28, 28))
    assert got == want and capsys.readouterr().out == want_text
    assert pt.Model(port_net).summary() == want
    assert pt.flops(port_net, [1, 1, 28, 28]) == paddle.flops(
        ref_net, [1, 1, 28, 28]) == 0


# -- callbacks -------------------------------------------------------------------

class _Holder:
    def __init__(self, opt):
        self._optimizer = opt


def _ref_params():
    return paddle.nn.Linear(2, 2).parameters()


def _port_params():
    return [torch.nn.Parameter(torch.zeros(2))]


def _opts(lr=0.1):
    ref = paddle.optimizer.SGD(learning_rate=lr, parameters=_ref_params())
    port = pt.optimizer.SGD(learning_rate=lr, parameters=_port_params())
    return ref, port


VALUES = [1.0, 0.9, 0.95, 0.97, 0.96, 0.99, 0.5, 0.6, 0.7]


@pytest.mark.parametrize("mode", ["min", "max"])
def test_early_stopping_matches_the_reference(mode):
    ref = RC.EarlyStopping(monitor="loss", mode=mode, patience=2,
                           min_delta=0.01)
    port = TC.EarlyStopping(monitor="loss", mode=mode, patience=2,
                            min_delta=0.01)
    for epoch, v in enumerate(VALUES):
        ref.on_epoch_end(epoch, {"loss": v})
        port.on_epoch_end(epoch, {"loss": v})
        assert (port.best, port.wait, port.stopped_epoch) == (
            ref.best, ref.wait, ref.stopped_epoch)
    port.on_epoch_end(99, {"acc": 1.0})  # no monitored value: no change
    assert port.stopped_epoch == ref.stopped_epoch


def test_reduce_lr_on_plateau_matches_the_reference(capsys):
    ref_opt, port_opt = _opts()
    ref = RC.ReduceLROnPlateau(factor=0.5, patience=1, cooldown=1,
                               min_lr=0.02)
    port = TC.ReduceLROnPlateau(factor=0.5, patience=1, cooldown=1,
                                min_lr=0.02)
    ref.set_model(_Holder(ref_opt))
    port.set_model(_Holder(port_opt))
    for epoch, v in enumerate(VALUES):
        ref.on_epoch_end(epoch, {"loss": [v]})
        want_text = capsys.readouterr().out
        port.on_epoch_end(epoch, {"loss": [v]})
        assert capsys.readouterr().out == want_text
        assert port_opt.get_lr() == pytest.approx(ref_opt.get_lr(),
                                                  rel=1e-7)


@pytest.mark.parametrize("by_step", [True, False])
def test_lr_scheduler_callback_steps_the_rate(by_step):
    lrs = {}
    for key, M, C in (("ref", paddle, RC), ("port", pt, TC)):
        sched = M.optimizer.lr.StepDecay(0.1, step_size=2, gamma=0.5)
        params = _ref_params() if key == "ref" else _port_params()
        opt = M.optimizer.SGD(learning_rate=sched, parameters=params)
        cb = C.LRScheduler(by_step=by_step, by_epoch=not by_step)
        cb.set_model(_Holder(opt))
        seen = []
        for epoch in range(3):
            for step in range(2):
                cb.on_batch_end("train", step)
                cb.on_batch_end("eval", step)
                seen.append(opt.get_lr())
            cb.on_epoch_end(epoch)
            seen.append(opt.get_lr())
        lrs[key] = seen
    np.testing.assert_allclose(lrs["port"], lrs["ref"], rtol=1e-7)


def test_prog_bar_logger_prints_the_references_lines(capsys):
    logs = [{"loss": 1.234567, "step": 0, "acc": 0.5},
            {"loss": 0.5, "step": 3}]
    lines = {}
    for key, C in (("ref", RC), ("port", TC)):
        cb = C.ProgBarLogger(log_freq=3, verbose=1)
        cb.on_epoch_begin(2)
        for i, l in enumerate(logs):
            cb.on_batch_end("train", l["step"], l)
        lines[key] = capsys.readouterr().out
    assert lines["port"] == lines["ref"] and lines["port"].count("\n") == 2


def test_visualdl_writes_the_references_tsv(tmp_path):
    for key, C in (("ref", RC), ("port", TC)):
        cb = C.VisualDL(str(tmp_path / key))
        for step in range(3):
            cb.on_batch_end("train", step, {"loss": 1.0 / (step + 1),
                                            "acc": [0.25 * step],
                                            "name": "skipped"})
        cb.on_batch_end("eval", 0, {"loss": 9.0})
        cb.on_epoch_end(0, {"loss": 0.5})
        cb.on_eval_end({"loss": [0.75], "acc": 0.5})
        del cb
    for name in ("train.tsv", "train_epoch.tsv", "eval.tsv"):
        assert (tmp_path / "port" / name).read_text() == (
            tmp_path / "ref" / name).read_text()


def test_model_checkpoint_and_telemetry_through_fit(tmp_path):
    data = pt.vision.datasets.MNIST(mode="train")
    net = pt.vision.models.LeNet(device="cpu")
    model = pt.Model(net)
    model.prepare(pt.optimizer.SGD(learning_rate=0.01,
                                   parameters=net.parameters()),
                  pt.nn.CrossEntropyLoss())
    tele = TC.TelemetryCallback(examples_per_batch=16, export_freq=2)
    model.fit(pt.io.Subset(data, range(64)), batch_size=16, epochs=2,
              verbose=0, callbacks=[TC.ModelCheckpoint(1, str(tmp_path)),
                                    tele])
    for epoch in (0, 1):
        assert (tmp_path / f"{epoch}.pdparams").exists()
        assert (tmp_path / f"{epoch}.pdopt").exists()
    assert tele.last_telemetry is not None
    saved = pt.load(str(tmp_path / "1.pdparams"), place="cpu")
    for k, v in net.state_dict().items():
        assert torch.equal(saved[k], v)


HUBCONF = '''
"""A local hub."""
dependencies = ["numpy"]


def lenet(num_classes=10):
    """LeNet of the port on the CPU."""
    import paddle_tpu_torch
    return paddle_tpu_torch.vision.models.LeNet(num_classes, device="cpu")


def _private():
    pass
'''


def test_hub_over_a_local_hubconf(tmp_path):
    (tmp_path / "hubconf.py").write_text(HUBCONF)
    repo = str(tmp_path)
    assert pt.hapi.hub.list(repo) == paddle.hapi.hub.list(repo) == ["lenet"]
    assert pt.hapi.hub.help(repo, "lenet") == "LeNet of the port on the CPU."
    net = pt.hapi.hub.load(repo, "lenet", num_classes=4)
    assert net.num_classes == 4
    with pytest.raises(RuntimeError, match="only source='local'"):
        pt.hapi.hub.load(repo, "lenet", source="github")
    with pytest.raises(RuntimeError, match="no callable entry point"):
        pt.hapi.hub.load(repo, "nope")
    with pytest.raises(FileNotFoundError):
        pt.hapi.hub.list(str(tmp_path / "missing"))
