"""Optimizer, Adam and AdamW (counterpart:
``paddle_tpu/optimizer/optimizer.py``).

The reference's ``step`` order: clip the (param, grad) pairs, count the
step, cast each low-precision gradient to float32, run the update on the
float32 master where ``multi_precision`` keeps one, and cast the result back
into the parameter. Moments and masters are float32 and are the only state
kept from step to step; the update runs in place on them (the reference's
arrays are immutable and it rebinds them instead).

The step count (``@step``, int32) and the learning rate (``@lr``, float32)
are scalar tensors on the parameters' device, as in the reference; Adam's
bias correction and AdamW's ``lr * coeff`` are computed from them on the
device, in float32. So a step never reads the host, and a step captured
into a CUDA graph (``jit.to_static`` on the card) counts its steps and
reads a rate set between replays.

Parameters are named by ``p.param_name`` where set (``Layer.parameters()``
sets the structured ``state_dict`` name), else ``param_<i>`` in order; the
names key ``state_dict`` and are what AdamW's ``apply_decay_param_fun``
receives.
Not ported: ZeRO sharding, sparse (row) gradients and coalesced
accumulator stores (``fuse_accumulators``); asking for them raises.
"""
import numpy as np
import torch

from ..nn.clip import ClipGradBase
from ..regularizer import L1Decay, L2Decay
from .lr import LRScheduler


def _capturing(t):
    return t.is_cuda and torch.cuda.is_current_stream_capturing()


def _host_scalar(v):
    return v.item() if isinstance(v, torch.Tensor) else np.asarray(v).item()


class _LRValue:
    """The learning rate as a float32 scalar tensor on the parameters'
    device (the reference's stateful lr tensor). A bound scheduler writes
    each new rate into it in place; :meth:`value` is the host's copy."""

    def __init__(self, lr, device):
        self.scheduler = lr if isinstance(lr, LRScheduler) else None
        self.tensor = torch.zeros((), dtype=torch.float32, device=device)
        self.set(lr.get_lr() if self.scheduler is not None else lr)
        if self.scheduler is not None:
            self.scheduler._bind(self)

    def value(self):
        return self._host

    def set(self, v):
        if _capturing(self.tensor):
            raise RuntimeError(
                "the learning rate was set inside a captured program, which "
                "would replay this one rate on every call; step the "
                "scheduler between calls of the program")
        self._host = float(np.float32(v))
        self.tensor.fill_(self._host)


class Optimizer:
    def __init__(self, learning_rate=0.001, parameters=None, weight_decay=None,
                 grad_clip=None, name=None, fuse_accumulators=False):
        if fuse_accumulators:
            raise NotImplementedError(
                "fuse_accumulators (coalesced accumulator stores) is not "
                "ported")
        if parameters is None:
            raise ValueError("parameters are required (the static-graph "
                             "minimize path is not ported)")
        parameters = list(parameters)
        if parameters and isinstance(parameters[0], dict):
            self._param_groups = [dict(g, params=list(g["params"]))
                                  for g in parameters]
        else:
            self._param_groups = [{"params": parameters}]
        if grad_clip is not None and not isinstance(grad_clip, ClipGradBase):
            raise TypeError(f"grad_clip must be a ClipGradBase, got "
                            f"{type(grad_clip).__name__}")
        first = next(self._parameters(), None)
        device = first.device if first is not None else torch.device("cpu")
        self._lr = _LRValue(learning_rate, device)
        self._weight_decay = self._wd_value(weight_decay)
        self._grad_clip = grad_clip
        self._accumulators = {}  # (slot, id(param)) -> float32 tensor
        self._names = {}  # id(param) -> name
        self._step_count = torch.zeros((), dtype=torch.int32, device=device)
        for i, p in enumerate(self._parameters()):
            self._names[id(p)] = getattr(p, "param_name", None) or f"param_{i}"
            self._create_accumulators(p)

    @staticmethod
    def _wd_value(weight_decay):
        if weight_decay is None:
            return 0.0
        if isinstance(weight_decay, (L2Decay, L1Decay)):
            return weight_decay
        return float(weight_decay)

    # -- accumulator management ------------------------------------------
    def _add_accumulator(self, slot, param, fill=0.0, dtype=None):
        key = (slot, id(param))
        if key not in self._accumulators:
            self._accumulators[key] = torch.full(
                param.shape, fill, dtype=dtype or torch.float32,
                device=param.device)
        return self._accumulators[key]

    def _get_accumulator(self, slot, param):
        return self._accumulators[(slot, id(param))]

    def _maybe_master(self, param):
        """The float32 master copy of a low-precision parameter, created
        on first use, when ``multi_precision`` is set (else None)."""
        if not getattr(self, "_multi_precision", False):
            return None
        if param.dtype not in (torch.bfloat16, torch.float16):
            return None
        key = ("master", id(param))
        t = self._accumulators.get(key)
        if t is None:
            t = self._accumulators[key] = param.detach().float().clone()
        return t

    def _create_accumulators(self, param):
        pass  # subclasses pre-create slots here

    # -- API --------------------------------------------------------------
    def get_lr(self):
        return self._lr.value()

    def set_lr(self, value):
        self._lr.set(value)

    def _parameters(self):
        for group in self._param_groups:
            yield from group["params"]

    def clear_grad(self, set_to_zero=False):
        for p in self._parameters():
            p.grad = None

    def _decayed_grad(self, value, g):
        """L2/L1 decay folded into the gradient (the reference's
        regularizer path; AdamW's decoupled decay replaces it)."""
        reg = self._weight_decay
        if isinstance(reg, L2Decay):
            return g + reg.coeff * value
        if isinstance(reg, L1Decay):
            return g + reg.coeff * torch.sign(value)
        if isinstance(reg, float) and reg != 0.0:
            return g + reg * value
        return g

    def _zero_enable(self, *args, **kwargs):
        raise NotImplementedError("ZeRO sharding is not ported yet")

    @torch.no_grad()
    def step(self):
        params_grads = [(p, p.grad) for p in self._parameters()
                        if p.requires_grad and p.grad is not None]
        if any(g.is_sparse for _, g in params_grads):
            raise NotImplementedError("sparse gradients are not ported")
        if self._grad_clip is not None:
            params_grads = self._grad_clip(params_grads)
        self._step_count.add_(1)
        self._prepare_step(self._lr.tensor)
        for p, g in params_grads:
            if g.dtype in (torch.bfloat16, torch.float16):
                g = g.float()
            # the update runs on the float32 master where one is kept; the
            # low-precision parameter only receives the cast result
            value = self._maybe_master(p)
            if value is None:
                value = p if p.dtype == torch.float32 else p.float()
            self._apply_one(p, value, g)
            if value is not p:
                p.copy_(value)

    def _prepare_step(self, lr):
        """Per-step scalars the updates share, from the lr tensor ``lr``
        and the step tensor (on the device)."""

    def _apply_one(self, p, value, g):
        """Update ``value`` (float32: the master or the parameter) in place
        from gradient ``g``, at the rates :meth:`_prepare_step` set."""
        raise NotImplementedError

    def state_dict(self):
        """``{"<param name>.<slot>": tensor, "@step", "@lr"[,
        "LR_Scheduler"]}``, as the reference keys it."""
        out = {f"{self._names[pid]}.{slot}": t
               for (slot, pid), t in self._accumulators.items()}
        out["@step"] = self._step_count.detach().clone()
        out["@lr"] = self._lr.tensor.detach().clone()
        if self._lr.scheduler is not None:
            out["LR_Scheduler"] = self._lr.scheduler.state_dict()
        return out

    def set_state_dict(self, state):
        """Load what :meth:`state_dict` gives (tensors or numpy arrays);
        keys of no accumulator here are skipped, as in the reference."""
        by_name = {f"{self._names[pid]}.{slot}": t
                   for (slot, pid), t in self._accumulators.items()}
        for k, v in state.items():
            if k == "@step":
                self._step_count.fill_(int(_host_scalar(v)))
            elif k == "@lr":
                self._lr.set(_host_scalar(v))
            elif k == "LR_Scheduler" and self._lr.scheduler is not None:
                self._lr.scheduler.set_state_dict(v)
            elif k in by_name:
                with torch.no_grad():
                    by_name[k].copy_(torch.as_tensor(np.array(v)))


class Adam(Optimizer):
    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=None,
                 grad_clip=None, lazy_mode=False, multi_precision=False,
                 name=None, fuse_accumulators=False):
        self._beta1, self._beta2, self._eps = beta1, beta2, epsilon
        self._multi_precision = multi_precision
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         fuse_accumulators=fuse_accumulators)

    def _create_accumulators(self, param):
        self._add_accumulator("moment1", param)
        self._add_accumulator("moment2", param)
        self._maybe_master(param)

    def _prepare_step(self, lr):
        # the bias-corrected rate, in float32 from the step count, as the
        # reference takes it
        t = self._step_count.float()
        self._lr_t = lr * torch.sqrt(1.0 - self._beta2 ** t) / (
            1.0 - self._beta1 ** t)

    def _moments(self, p, g):
        m = self._get_accumulator("moment1", p)
        v = self._get_accumulator("moment2", p)
        m.mul_(self._beta1).add_(g, alpha=1 - self._beta1)
        v.mul_(self._beta2).addcmul_(g, g, value=1 - self._beta2)
        return m, v

    def _update(self, value, m, v):
        """value -= lr_t * m / (sqrt(v) + eps), in the reference's order."""
        value.addcdiv_(m * self._lr_t, v.sqrt().add_(self._eps), value=-1.0)

    def _apply_one(self, p, value, g):
        m, v = self._moments(p, self._decayed_grad(value, g))
        self._update(value, m, v)


class AdamW(Adam):
    """Adam with decoupled weight decay ``p -= lr * coeff * p`` for the
    parameters whose name ``apply_decay_param_fun`` accepts (all if
    None)."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=0.01,
                 grad_clip=None, apply_decay_param_fun=None,
                 multi_precision=False, lazy_mode=False, name=None,
                 fuse_accumulators=False):
        self._coeff = (weight_decay if isinstance(weight_decay, float)
                       else getattr(weight_decay, "coeff", 0.01))
        self._decay_fn = apply_decay_param_fun
        super().__init__(learning_rate, beta1, beta2, epsilon, parameters,
                         None, grad_clip, multi_precision=multi_precision,
                         fuse_accumulators=fuse_accumulators)

    def _prepare_step(self, lr):
        super()._prepare_step(lr)
        self._lr_coeff = lr * self._coeff

    def _apply_one(self, p, value, g):
        m, v = self._moments(p, g)
        decay = self._decay_fn is None or self._decay_fn(self._names[id(p)])
        if decay:
            wd = value * self._lr_coeff  # from the value before the step
        self._update(value, m, v)
        if decay:
            value.sub_(wd)
