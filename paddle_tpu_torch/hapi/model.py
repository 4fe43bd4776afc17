"""The high-level ``Model`` (counterpart: ``paddle_tpu/hapi/model.py``).

``prepare`` wraps the train step (forward, loss, backward, the optimizer's
step, clear) and the forward of ``evaluate``/``predict`` each in a
``jit.StaticFunction``, as the reference compiles them with ``to_static``:
on the CPU each runs as a plain call; on the card each is a CUDA graph,
captured at its first call for each input signature (a trailing partial
batch, ``evaluate``'s batch) and replayed after (``captures``). As in the
reference, every train and eval batch reads its loss and outputs back to
the host for the metrics and the logs.

``fit``, ``evaluate`` and ``predict`` build a ``DataLoader`` on the
network's device from a dataset (``num_workers`` forked workers over the
shared-memory rings when above 0), or take a ``DataLoader`` as given.
``amp_configs`` is taken and ignored, as in the reference. ``flops``
returns what the reference's returns: 0.
"""
import os

import numpy as np
import torch

from ..core.autograd import no_grad
from ..core.tensor import host_array
from ..io import DataLoader
from ..jit.to_static import StaticFunction
from . import callbacks as cbks_mod


def _first(v):
    return v[0] if isinstance(v, (list, tuple)) else v


class Model:
    def __init__(self, network, inputs=None, labels=None):
        self.network = network
        self._inputs = inputs
        self._labels = labels
        self._optimizer = None
        self._loss = None
        self._metrics = []
        self._train_step_fn = None
        self._eval_fn = None

    def prepare(self, optimizer=None, loss=None, metrics=None,
                amp_configs=None):
        self._optimizer = optimizer
        self._loss = loss
        self._metrics = metrics if isinstance(metrics, (list, tuple)) else (
            [metrics] if metrics else [])

        def _step(x, y):
            out = self.network(x)
            loss_val = self._loss(out, y)
            loss_val.backward()
            self._optimizer.step()
            self._optimizer.clear_grad()
            return loss_val, out

        def _fwd(x):
            return self.network(x)

        self._train_step_fn = StaticFunction(_step)
        self._eval_fn = StaticFunction(_fwd, donate_state=False)
        return self

    def captures(self):
        """The CUDA graphs captured so far, by program (0 on the CPU)."""
        return {name: len(fn._programs) if fn is not None else 0
                for name, fn in (("train", self._train_step_fn),
                                 ("eval", self._eval_fn))}

    def _device(self):
        p = next(iter(self.network.parameters()), None)
        return p.device if p is not None else torch.device("cpu")

    def _loader(self, data, batch_size, num_workers, **kw):
        if isinstance(data, DataLoader):
            return data
        return DataLoader(data, batch_size=batch_size,
                          num_workers=num_workers, places=self._device(),
                          **kw)

    def _update_metrics(self, out, y):
        values = []
        for m in self._metrics:
            m.update(m.compute(out, y))
            values.append(m.accumulate())
        return values

    # -- one batch ---------------------------------------------------------
    def train_batch(self, inputs, labels=None):
        from ..observability import tracing as _obs
        self.network.train()
        x, y = _first(inputs), _first(labels)
        with _obs.trace_span("hapi/train_batch", cat="step"):
            loss, out = self._train_step_fn(x, y)
        metrics = self._update_metrics(out, y)
        losses = [float(loss.detach())]
        return (losses, metrics) if metrics else losses

    def eval_batch(self, inputs, labels=None):
        self.network.eval()
        x, y = _first(inputs), _first(labels)
        with no_grad():
            out = self._eval_fn(x)
            loss = self._loss(out, y) if self._loss else None
        metrics = self._update_metrics(out, y)
        losses = [float(loss)] if loss is not None else []
        return (losses, metrics) if metrics else losses

    def predict_batch(self, inputs):
        self.network.eval()
        with no_grad():
            out = self._eval_fn(_first(inputs))
        return [host_array(out)]

    # -- loops -------------------------------------------------------------
    def fit(self, train_data=None, eval_data=None, batch_size=1, epochs=1,
            eval_freq=1, log_freq=10, save_dir=None, save_freq=1, verbose=2,
            drop_last=False, shuffle=True, num_workers=0, callbacks=None):
        train_loader = self._loader(train_data, batch_size, num_workers,
                                    shuffle=shuffle, drop_last=drop_last)
        cbks = cbks_mod.CallbackList(
            callbacks or [cbks_mod.ProgBarLogger(log_freq, verbose)])
        cbks.set_model(self)
        cbks.on_begin("train")
        history = []
        for epoch in range(epochs):
            cbks.on_epoch_begin(epoch)
            self.network.train()
            for m in self._metrics:
                m.reset()
            logs = {}
            for step, batch in enumerate(train_loader):
                res = self.train_batch([batch[0]], [batch[1]])
                losses, metrics = res if isinstance(res, tuple) else (res, [])
                logs = {"loss": losses[0], "step": step}
                for m, v in zip(self._metrics, metrics):
                    for n, val in zip(m.name(),
                                      v if isinstance(v, list) else [v]):
                        logs[n] = val
                cbks.on_batch_end("train", step, logs)
            history.append(logs)
            if eval_data is not None and (epoch + 1) % eval_freq == 0:
                self.evaluate(eval_data, batch_size=batch_size,
                              num_workers=num_workers, verbose=0,
                              _cbks=cbks)
            if save_dir and (epoch + 1) % save_freq == 0:
                self.save(f"{save_dir}/{epoch}")
            cbks.on_epoch_end(epoch, logs)
        cbks.on_end("train")
        return history

    def evaluate(self, eval_data, batch_size=1, log_freq=10, verbose=2,
                 num_workers=0, callbacks=None, _cbks=None):
        loader = self._loader(eval_data, batch_size, num_workers)
        cbks = _cbks  # fit() forwards its live callback list
        if cbks is None and callbacks:
            cbks = cbks_mod.CallbackList(callbacks)
            cbks.set_model(self)
        for m in self._metrics:
            m.reset()
        if cbks is not None:
            cbks.on_eval_begin()
        losses = []
        for step, batch in enumerate(loader):
            res = self.eval_batch([batch[0]], [batch[1]])
            batch_losses = res[0] if isinstance(res, tuple) else res
            if batch_losses:
                losses.append(batch_losses[0])
            if cbks is not None:
                cbks.on_batch_end("eval", step,
                                  {"loss": losses[-1]} if losses else {})
        out = {"loss": [float(np.mean(losses))] if losses else []}
        for m in self._metrics:
            vals = m.accumulate()
            for n, v in zip(m.name(),
                            vals if isinstance(vals, list) else [vals]):
                out[n] = v
        if cbks is not None:
            cbks.on_eval_end(out)
        return out

    def predict(self, test_data, batch_size=1, num_workers=0,
                stack_outputs=False, callbacks=None, verbose=1):
        loader = self._loader(test_data, batch_size, num_workers)
        outputs = []
        for batch in loader:
            x = batch[0] if isinstance(batch, (tuple, list)) else batch
            outputs.append(self.predict_batch([x])[0])
        if stack_outputs:
            return [np.concatenate(outputs, axis=0)]
        return [outputs]

    # -- state -------------------------------------------------------------
    def save(self, path, training=True):
        """``path.pdparams`` (and ``path.pdopt`` with ``training``) in the
        reference's container, so either package loads them."""
        from ..serialization import save as p_save
        p_save(self.network.state_dict(), path + ".pdparams")
        if training and self._optimizer is not None:
            p_save(self._optimizer.state_dict(), path + ".pdopt")

    def load(self, path, skip_mismatch=False, reset_optimizer=False):
        """Copy what :meth:`save` (either package's) wrote into the network
        and, unless ``reset_optimizer``, the optimizer, in place."""
        from ..serialization import load as p_load
        self.network.set_state_dict(p_load(path + ".pdparams",
                                           return_numpy=True))
        if not reset_optimizer and self._optimizer is not None and \
                os.path.exists(path + ".pdopt"):
            self._optimizer.set_state_dict(p_load(path + ".pdopt",
                                                  return_numpy=True))

    def parameters(self, *args, **kwargs):
        return self.network.parameters(*args, **kwargs)

    def summary(self, input_size=None, dtype="float32"):
        return summary(self.network, input_size, dtype)


def summary(net, input_size, dtypes="float32"):
    """Print each parameter's count and the totals (the reference's
    table); returns ``{"total_params", "trainable_params"}``."""
    total, trainable = 0, 0
    lines = ["-" * 64, f"{'Layer (type)':<30}{'Param #':>14}", "-" * 64]
    for name, p in net.named_parameters():
        n = p.numel()
        total += n
        if getattr(p, "trainable", p.requires_grad):
            trainable += n
        lines.append(f"{name:<38}{n:>14,}")
    lines += ["-" * 64,
              f"Total params: {total:,}",
              f"Trainable params: {trainable:,}",
              f"Non-trainable params: {total - trainable:,}", "-" * 64]
    print("\n".join(lines))
    return {"total_params": total, "trainable_params": trainable}


def flops(net, input_size, custom_ops=None, print_detail=False):
    """The reference's ``flops``: 0 (no per-layer counter)."""
    return 0
