"""hapi callbacks (counterpart: ``paddle_tpu/hapi/callbacks.py``).

``ProgBarLogger`` prints a line every ``log_freq`` steps; ``ModelCheckpoint``
saves at the end of every ``save_freq``-th epoch; ``EarlyStopping`` and
``ReduceLROnPlateau`` watch a logged value at each epoch's end;
``LRScheduler`` steps the optimizer's scheduler after each training step or
epoch (a rate on the device, set between steps); ``TelemetryCallback``
drives an ``observability.StepTimer`` through ``fit`` and exports its
gauges; ``VisualDL`` writes its scalars as TSV lines (step, tag, value)
under ``log_dir``, as the reference does where the visualdl package is
absent."""



class Callback:
    def set_model(self, model):
        self.model = model

    def set_params(self, params):
        self.params = params

    def on_begin(self, mode, logs=None):
        pass

    def on_end(self, mode, logs=None):
        pass

    def on_epoch_begin(self, epoch, logs=None):
        pass

    def on_epoch_end(self, epoch, logs=None):
        pass

    def on_batch_begin(self, mode, step, logs=None):
        pass

    def on_batch_end(self, mode, step, logs=None):
        pass

    def on_eval_begin(self, logs=None):
        pass

    def on_eval_end(self, logs=None):
        pass


class CallbackList:
    def __init__(self, callbacks):
        self.callbacks = list(callbacks)

    def set_model(self, model):
        for c in self.callbacks:
            c.set_model(model)

    def __getattr__(self, name):
        def call(*args, **kwargs):
            for c in self.callbacks:
                getattr(c, name)(*args, **kwargs)
        return call


class ProgBarLogger(Callback):
    def __init__(self, log_freq=10, verbose=2):
        self.log_freq = log_freq
        self.verbose = verbose

    def on_epoch_begin(self, epoch, logs=None):
        self.epoch = epoch

    def on_batch_end(self, mode, step, logs=None):
        if self.verbose and step % self.log_freq == 0:
            items = " - ".join(f"{k}: {v:.4f}" if isinstance(v, float)
                               else f"{k}: {v}" for k, v in (logs or {}).items())
            print(f"Epoch {self.epoch} step {step}: {items}")


class ModelCheckpoint(Callback):
    def __init__(self, save_freq=1, save_dir=None):
        self.save_freq = save_freq
        self.save_dir = save_dir

    def on_epoch_end(self, epoch, logs=None):
        if self.save_dir and epoch % self.save_freq == 0:
            self.model.save(f"{self.save_dir}/{epoch}")


class EarlyStopping(Callback):
    def __init__(self, monitor="loss", mode="auto", patience=0, verbose=1,
                 min_delta=0, baseline=None, save_best_model=True):
        self.monitor = monitor
        self.patience = patience
        self.min_delta = min_delta
        self.best = None
        self.wait = 0
        self.stopped_epoch = 0
        self.mode = "min" if mode in ("auto", "min") else "max"

    def on_epoch_end(self, epoch, logs=None):
        value = (logs or {}).get(self.monitor)
        if value is None:
            return
        better = (self.best is None
                  or (self.mode == "min" and value < self.best - self.min_delta)
                  or (self.mode == "max" and value > self.best + self.min_delta))
        if better:
            self.best = value
            self.wait = 0
        else:
            self.wait += 1
            if self.wait >= self.patience:
                self.stopped_epoch = epoch


class LRScheduler(Callback):
    def __init__(self, by_step=True, by_epoch=False):
        self.by_step = by_step
        self.by_epoch = by_epoch

    def on_epoch_end(self, epoch, logs=None):
        if self.by_epoch:
            sched = getattr(self.model._optimizer, "_lr", None)
            if sched is not None and sched.scheduler is not None:
                sched.scheduler.step()

    def on_batch_end(self, mode, step, logs=None):
        if self.by_step and mode == "train":
            sched = getattr(self.model._optimizer, "_lr", None)
            if sched is not None and sched.scheduler is not None:
                sched.scheduler.step()


class ReduceLROnPlateau(Callback):
    """Shrink the lr when a monitored metric stops improving (reference:
    hapi/callbacks.py ReduceLROnPlateau:956)."""

    def __init__(self, monitor="loss", factor=0.1, patience=10, verbose=1,
                 mode="auto", min_delta=1e-4, cooldown=0, min_lr=0):
        self.monitor = monitor
        self.factor = factor
        self.patience = patience
        self.verbose = verbose
        self.min_delta = min_delta
        self.cooldown = cooldown
        self.min_lr = min_lr
        self.mode = "min" if mode in ("auto", "min") else "max"
        self.best = None
        self.wait = 0
        self.cooldown_counter = 0

    def on_epoch_end(self, epoch, logs=None):
        value = (logs or {}).get(self.monitor)
        if value is None:
            return
        try:
            value = float(value[0] if hasattr(value, "__len__") else value)
        except (TypeError, ValueError):
            return
        if self.cooldown_counter > 0:
            self.cooldown_counter -= 1
            self.wait = 0
        better = (self.best is None
                  or (self.mode == "min"
                      and value < self.best - self.min_delta)
                  or (self.mode == "max"
                      and value > self.best + self.min_delta))
        if better:
            self.best = value
            self.wait = 0
        elif self.cooldown_counter <= 0:
            self.wait += 1
            if self.wait >= self.patience:
                opt = self.model._optimizer
                old = opt.get_lr()
                new = max(old * self.factor, self.min_lr)
                if old - new > 1e-12:
                    opt.set_lr(new)
                    if self.verbose:
                        print(f"Epoch {epoch}: reducing learning rate "
                              f"from {old:.6g} to {new:.6g}.")
                self.cooldown_counter = self.cooldown
                self.wait = 0


class TelemetryCallback(Callback):
    """Per-step telemetry for ``Model.fit`` (observability layer).

    Aggregates a sliding window of training steps into tokens/s,
    examples/s, an MFU estimate, compile-stall and data-wait fractions
    (see observability/step.py) and publishes them as export gauges so a
    metrics scrape (``observability.export.start_http_server`` /
    ``prometheus_text``) always sees fresh numbers. Optionally writes
    Prometheus-text / JSON snapshots every ``export_freq`` steps.

    ``tokens_per_batch``: tokens consumed per train step (sequence models).
    ``examples_per_batch``: examples consumed per train step; not
    inferred from the loader — pass it explicitly or the examples/s
    gauge is simply omitted.
    ``flops_per_step``: dense FLOPs per optimizer step; when None and
    ``tokens_per_batch`` is set, estimated as ``6 * n_params * tokens``
    (the standard dense-transformer rule of thumb).
    ``flops_per_token``: per-model override (``model.flops_per_token(seq)``)
    — exact attention-aware MFU accounting; takes precedence over the
    6*N*T estimate.
    """

    def __init__(self, tokens_per_batch=None, examples_per_batch=None,
                 flops_per_step=None, flops_per_token=None, window=20,
                 export_freq=10, prom_path=None, json_path=None,
                 peak_flops=None):
        self.tokens_per_batch = tokens_per_batch
        self.examples_per_batch = examples_per_batch
        self.flops_per_step = flops_per_step
        if flops_per_token is not None and not tokens_per_batch:
            # the override scales by the window's token throughput; with
            # no token counts it would silently produce no MFU gauge
            raise ValueError(
                "TelemetryCallback(flops_per_token=...) requires "
                "tokens_per_batch")
        self.flops_per_token = flops_per_token
        self.window = window
        self.export_freq = max(1, int(export_freq))
        self.prom_path = prom_path
        self.json_path = json_path
        self.peak_flops = peak_flops
        self.timer = None
        self.last_telemetry = None

    def _n_params(self):
        try:
            import numpy as np
            return int(sum(np.prod(p.shape)
                           for p in self.model.parameters()))
        except Exception:
            return 0

    def on_begin(self, mode, logs=None):
        if mode != "train":
            return
        from ..observability.step import StepTimer
        flops = self.flops_per_step
        if (flops is None and self.flops_per_token is None
                and self.tokens_per_batch):
            n = self._n_params()
            flops = 6.0 * n * self.tokens_per_batch if n else None
        self.timer = StepTimer(window=self.window,
                               tokens_per_step=self.tokens_per_batch,
                               examples_per_step=self.examples_per_batch,
                               flops_per_step=flops,
                               flops_per_token=self.flops_per_token,
                               peak_flops=self.peak_flops).start()

    def on_epoch_begin(self, epoch, logs=None):
        # re-anchor: the gap since the last train step is eval/save wall
        # time (and its dataloader waits), not the first step of this
        # epoch — without this the window telemetry absorbs it
        if self.timer is not None and epoch > 0:
            self.timer.start()

    def on_batch_end(self, mode, step, logs=None):
        if mode != "train" or self.timer is None:
            return
        self.last_telemetry = self.timer.step()
        if (self.timer.total_steps % self.export_freq == 0
                and self.last_telemetry is not None):
            self._export()

    def on_end(self, mode, logs=None):
        if mode != "train":
            return
        if self.last_telemetry is not None:
            self._export()

    def _export(self):
        from ..observability import export as export_mod
        if self.prom_path:
            export_mod.write_prometheus(self.prom_path)
        if self.json_path:
            export_mod.write_json(self.json_path)


class VisualDL(Callback):
    """Scalar logging callback (reference: hapi/callbacks.py VisualDL:841).
    The visualdl package is not in this environment, so scalars are written
    as TSV lines (step, tag, value) under log_dir — the same data stream a
    LogWriter would receive; point any scalar viewer at it."""

    def __init__(self, log_dir):
        import os
        self.log_dir = log_dir
        os.makedirs(log_dir, exist_ok=True)
        self._files = {}
        self._steps = {}

    def _write(self, mode, tag, value, step):
        import os
        f = self._files.get(mode)
        if f is None:
            f = open(os.path.join(self.log_dir, f"{mode}.tsv"), "a")
            self._files[mode] = f
        f.write(f"{step}\t{tag}\t{value}\n")
        f.flush()

    def _log(self, mode, logs, step):
        for k, v in (logs or {}).items():
            try:
                val = float(v[0] if hasattr(v, "__len__") else v)
            except (TypeError, ValueError):
                continue
            self._write(mode, f"{mode}/{k}", val, step)

    def on_batch_end(self, mode, step, logs=None):
        if mode == "train":
            self._steps[mode] = self._steps.get(mode, 0) + 1
            self._log(mode, logs, self._steps[mode])

    def on_epoch_end(self, epoch, logs=None):
        self._log("train_epoch", logs, epoch)

    def on_eval_end(self, logs=None):
        self._steps["eval"] = self._steps.get("eval", 0) + 1
        self._log("eval", logs, self._steps["eval"])

    def __del__(self):
        for f in self._files.values():
            try:
                f.close()
            except Exception:
                pass
