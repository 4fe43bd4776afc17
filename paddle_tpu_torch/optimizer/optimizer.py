"""Optimizer and the reference's fifteen optimizers (counterpart:
``paddle_tpu/optimizer/optimizer.py``): SGD, Momentum, Adam, AdamW,
Adagrad, RMSProp, Adadelta, Adamax, DecayedAdagrad, ProximalGD,
ProximalAdagrad and Ftrl (elementwise: each has ``_apply_flat``, so ZeRO
runs it on flat shards), and Lamb, Lars and Dpsgd (whole-tensor norms or
noise draws: ``_zero_compatible = False``).

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

A parameter made with a ``ParamAttr`` carries its own ``regularizer``,
which replaces the optimizer's ``weight_decay`` for it, and a
``learning_rate`` factor (``p.optimize_attr``) that scales the rate for it:
the update runs once per distinct factor with the scaled rate, a device
tensor like the rate itself. ZeRO's flat stores take neither (enabling it
over such a parameter raises).

Parameters are named by ``p.param_name`` where set (``Layer.parameters()``
sets the structured ``state_dict`` name), else (or where an earlier
parameter took the name) ``param_<i>`` in order; the names key
``state_dict`` and are what AdamW's ``apply_decay_param_fun`` receives.

Inside a step program with a dp axis (``jit.to_static(..., dp_axis=)``)
the step first reduces every gradient over the mesh's group, a float32
mean all-reduce per parameter (``_reduce_dp_grads``: the replicated
control). In an accumulation window's micro steps ``step`` and
``clear_grad`` return at once, so the gradients accumulate; the window's
last step scales them 1/a after the reduction and before the clip.
``_zero_enable`` partitions the state instead (ZeRO-1/2/3, ``zero.py``).

A parameter looked up by ``embedding(sparse=True)`` carries a sparse
gradient (a ``SelectedRows``, ``core.tensor.grad_of``). The step applies it
row by row after the dense updates (:meth:`Optimizer._apply_sparse`, the
reference's ``_apply_sparse``): the update formula runs on the gathered
rows of the parameter, its master and its accumulators, and the results
are scattered back, so untouched rows and their accumulators stay
bitwise as they were (``lazy_mode`` semantics; the reference applies a
sparse gradient so whatever ``lazy_mode`` says, and so does the port).
A sparse gradient under a dp axis or under ZeRO raises, as in the
reference.

``fuse_accumulators=True`` keeps each slot in one float32 ``[rows, 1024]``
store (``zero.FusedState``: ZeRO's layout at degree 1), every parameter's
accumulator a view of its segment, and the low-precision parameters'
float32 masters in one more store. A step then runs the update once over
each whole store (``_apply_flat``), elementwise math that is bitwise the
per-parameter update; parameters with a per-parameter rate or
regularizer, and the whole-tensor optimizers, step per parameter on the
views. The reference's ``Momentum`` and ``Adagrad`` take no
``fuse_accumulators`` keyword, and neither do the port's:
``Optimizer._fuse()`` lays out any optimizer's stores after construction.
"""
import numpy as np
import torch

from ..core.selected_rows import SelectedRows
from ..core.tensor import clear_grads, grad_of
from ..distributed import collective, parallel_env
from ..nn.clip import ClipGradBase
from ..regularizer import L1Decay, L2Decay
from .lr import LRScheduler


def _capturing(t):
    return t.is_cuda and torch.cuda.is_current_stream_capturing()


def _lr_scale(p):
    """The parameter's learning-rate factor (``ParamAttr.learning_rate``)."""
    return getattr(p, "optimize_attr", {}).get("learning_rate", 1.0)


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
    # ZeRO (zero.ZeroState) once _zero_enable() partitions the state; an
    # optimizer whose update is not elementwise cannot run on a flat shard
    _zero = None
    _zero_compatible = True
    # whether the update folds a regularizer into the gradient (AdamW's
    # decoupled decay does not, as in the reference)
    _reads_regularizer = True

    # fuse_accumulators' stores (zero.FusedState), until ZeRO supersedes them
    _fused = None
    # the per-parameter float32 slots an update reads (besides the master)
    _SLOTS = ()
    # owners per parameter (fleet's sharding of the non-flat optimizers:
    # meta_optimizers.sharding.shard_optimizer_state): a rank updates the
    # parameters it owns, after the clip saw every gradient
    _owners = None

    def __init__(self, learning_rate=0.001, parameters=None, weight_decay=None,
                 grad_clip=None, name=None, fuse_accumulators=False):
        if parameters is None:
            from ..static.program import recording
            if not recording():
                raise ValueError(
                    "parameters are required outside a static program "
                    "(under program_guard, minimize adopts the program's)")
            parameters = []
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
        self._fills = {}  # slot -> the value it starts at
        self._fuse_acc = bool(fuse_accumulators)
        self._names = {}  # id(param) -> name
        self._step_count = torch.zeros((), dtype=torch.int32, device=device)
        used = set()
        for i, p in enumerate(self._parameters()):
            name = getattr(p, "param_name", None)
            if not name or name in used:
                # the lists of two layers (``a.parameters() +
                # b.parameters()``) may repeat a structured name
                name = f"param_{i}"
            used.add(name)
            self._names[id(p)] = name
            self._create_accumulators(p)
        if self._fuse_acc:
            self._fuse()
        from ..observability import memory
        memory.register_optimizer(self)  # the state ledger's walk

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
        self._fills[slot] = fill
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
        for slot in self._SLOTS:
            self._add_accumulator(slot, param)
        self._maybe_master(param)

    def _slots_of(self, p):
        return {slot: self._accumulators[(slot, id(p))]
                for slot in self._SLOTS}

    def _fuse(self):
        """Move every slot and master into fused ``[rows, 1024]`` stores
        (``fuse_accumulators``); returns the number of stores."""
        from .zero import FusedState
        if self._zero is not None:
            raise RuntimeError("ZeRO already holds this optimizer's state")
        if self._fused is None:
            self._fuse_acc = True
            self._fused = FusedState(self)
        return len(self._fused.stores)

    def _master_of(self, p):
        """The float32 master of ``p`` that the next step reads its value
        from, or None (a parameter without one holds its own value). Under
        ZeRO with masters or at stage 3 the value lives in a sharded store,
        and writing it from outside the step is not ported."""
        zero = self._zero
        if zero is not None and (zero.stage == 3 or any(
                b.has_master for b in zero.buckets)):
            raise NotImplementedError(
                "writing parameters from outside the step (LookAhead, ASP) "
                "under ZeRO with float32 masters or at stage 3, whose "
                "values live in sharded stores, is not ported")
        return self._accumulators.get(("master", id(p)))

    # -- API --------------------------------------------------------------
    def get_lr(self):
        return self._lr.value()

    def set_lr(self, value):
        self._lr.set(value)

    def _parameters(self):
        for group in self._param_groups:
            yield from group["params"]

    def clear_grad(self, set_to_zero=False):
        acc = parallel_env.current_accum()
        if acc is not None and acc[0] == "accum":
            return  # an accumulation window's gradients outlive its steps
        clear_grads(self._parameters())

    clear_gradients = clear_grad

    def _decayed_grad(self, value, g, p=None):
        """L2/L1 decay folded into the gradient: parameter ``p``'s own
        regularizer, else the optimizer's (the reference's regularizer
        path; AdamW's decoupled decay replaces it)."""
        reg = getattr(p, "regularizer", None) or self._weight_decay
        if isinstance(reg, L2Decay):
            return g + reg.coeff * value
        if isinstance(reg, L1Decay):
            return g + reg.coeff * torch.sign(value)
        if isinstance(reg, float) and reg != 0.0:
            return g + reg * value
        return g

    # -- data parallelism -------------------------------------------------
    def _reduce_dp_grads(self, axis):
        """The replicated control under a dp axis: each gradient as a
        float32 mean over the mesh's group, one all-reduce per parameter.
        Returns the (param, reduced gradient) pairs; ``p.grad`` keeps the
        local gradient (a float32 mean does not fit a bf16 ``grad``)."""
        mesh = parallel_env.current_mesh()
        group = parallel_env.axis_group(mesh, axis)
        degree = parallel_env.axis_degree(mesh, axis)
        out = []
        for p in self._parameters():
            g = grad_of(p) if p.requires_grad else None
            if g is None:
                continue
            if isinstance(g, SelectedRows):
                raise NotImplementedError(
                    "sparse (SelectedRows) gradients cannot be reduced over "
                    "a dp axis, as in the reference")
            g = g.float()
            collective.all_reduce(g, group=group)
            out.append((p, g.div_(degree)))
        return out

    def _zero_enable(self, axis=None, mesh=None, stage=1, comm_buffer_mb=None,
                     last_comm_buffer_mb=None, prefetch=None):
        """Partition this optimizer's state for ZeRO data parallelism over
        one mesh axis (``zero.ZeroState``): moments and float32 masters in
        per-bucket flat ``[rows, 1024]`` stores of which each rank keeps
        ``rows/degree``; stage 2 frees each gradient once its bucket is
        reduced and keeps a sharded accumulator for accumulation windows;
        stage 3 also keeps the parameters sharded and gathers them before
        each step's forward. ``prefetch`` (default on) issues bucket i+1's
        reduce-scatter before bucket i's update and, at stage 3, refills
        bucket 0's parameters at the step's tail. Returns the number of
        sharded stores; enabling again with other settings raises."""
        from .zero import ZeroState
        if self._zero is not None:
            return self._zero.reenable(axis, stage, comm_buffer_mb, prefetch)
        self._zero = ZeroState(self, axis, mesh, stage, comm_buffer_mb,
                               last_comm_buffer_mb, prefetch)
        self._fused = None  # superseded: the state moved into ZeRO's stores
        return self._zero.n_sharded

    def _zero_state_bytes(self):
        """Per-rank bytes of the optimizer state: the shards of the ZeRO
        stores, or every accumulator without ZeRO."""
        if self._zero is not None:
            return self._zero.state_bytes()
        tensors = (self._fused.stores.values() if self._fused is not None
                   else self._accumulators.values())
        return sum(t.numel() * t.element_size() for t in tensors)

    def zero_layout(self):
        """The active ZeRO layout (``stage``, ``axis``, ``degree``,
        ``n_buckets``, ``prefetch``, ``comm_buffer_mb``, ``bucket_rows``,
        ``shard_rows``, ``store_names``, ``state_bytes``), or None."""
        return None if self._zero is None else self._zero.layout()

    @torch.no_grad()
    def step(self):
        acc = parallel_env.current_accum()
        if self._zero is not None:
            if any(isinstance(grad_of(p), SelectedRows)
                   for p in self._parameters()):
                raise NotImplementedError(
                    "the ZeRO sharded step does not take sparse "
                    "(SelectedRows) gradients, as in the reference")
            if acc is not None and acc[0] == "accum":
                return self._zero.accum_fold()
            return self._zero.step()
        if acc is not None and acc[0] == "accum":
            return  # the window's last step updates
        axis = parallel_env.current_dp_axis()
        if axis is not None:
            params_grads = self._reduce_dp_grads(axis)
        else:
            params_grads = [(p, g) for p, g in (
                (p, grad_of(p)) for p in self._parameters()
                if p.requires_grad) if g is not None]
        if any(isinstance(g, torch.Tensor) and g.is_sparse
               for _, g in params_grads):
            raise NotImplementedError(
                "torch sparse (COO) gradients are not taken: the port's "
                "sparse gradients are SelectedRows (embedding(sparse=True))")
        if acc is not None and acc[1] > 1:
            # the window's gradients are sums of a micro-batch means: the
            # big batch's mean, before the clip
            params_grads = [(p, _grad_div(g, acc[1]))
                            for p, g in params_grads]
        if self._grad_clip is not None:
            params_grads = self._grad_clip(params_grads)
        if self._owners is not None:
            own, me = self._owners["owners"], self._owners["rank"]
            params_grads = [(p, g) for p, g in params_grads
                            if own.get(id(p), me) == me]
        self._step_count.add_(1)
        by_scale = {}
        sparse = []
        for p, g in params_grads:
            if isinstance(g, SelectedRows):
                sparse.append((p, g))
                continue
            by_scale.setdefault(_lr_scale(p), []).append((p, g))
        if self._fused is not None and self._fused.flat and by_scale:
            # one update over each whole store (every rate factor is 1)
            self._prepare_step(self._lr.tensor)
            self._fused.step(by_scale.pop(1.0))
        for scale, pairs in by_scale.items():
            lr = self._lr.tensor
            self._prepare_step(lr if scale == 1.0 else lr * scale)
            for p, g in pairs:
                if g.dtype in (torch.bfloat16, torch.float16):
                    g = g.float()
                # the update runs on the float32 master where one is kept;
                # the low-precision parameter only receives the cast result
                value = self._maybe_master(p)
                if value is None:
                    value = p if p.dtype == torch.float32 else p.float()
                self._apply_one(p, value, g)
                if value is not p:
                    p.copy_(value)
        for p, g in sparse:
            lr = self._lr.tensor
            scale = _lr_scale(p)
            self._prepare_step(lr if scale == 1.0 else lr * scale)
            self._apply_sparse(p, g)

    def _apply_sparse(self, p, rows):
        """Apply the ``SelectedRows`` gradient ``rows`` to the rows it
        names (the reference's ``_apply_sparse``): gather those rows of
        the parameter (of its float32 master where one is kept) and of its
        accumulators, run :meth:`_apply_one` on them, and scatter them
        back. The padding rows of ``merge_add`` (index ``height``) are
        dropped on the device without a host read: each is aimed at the
        smallest real row and carries that row's new value (or, with no
        real row, the old value of the row it is aimed at), so every write
        to a row writes the same bits."""
        height = rows.height
        idx = rows.rows
        g = rows.values.float()
        k = idx.shape[0]
        valid = idx < height
        first = torch.argmin(idx)  # the smallest row: real whenever any is
        anchor = idx.min().clamp(max=height - 1)
        target = torch.where(valid, idx, anchor)
        source = torch.where(valid, torch.arange(k, device=idx.device),
                             first)
        keep_new = valid[source].unsqueeze(-1)

        def scatter(full, old, new):
            picked = torch.where(keep_new, new[source], old[source])
            full.index_copy_(0, target, picked.to(full.dtype))

        master = self._maybe_master(p)
        whole = master if master is not None else p
        old = whole.index_select(0, target).float()
        value = old.clone()
        slots = {key: acc for key, acc in self._accumulators.items()
                 if key[1] == id(p) and key[0] != "master"}
        gathered = {key: acc.index_select(0, target)
                    for key, acc in slots.items()}
        before = {key: t.clone() for key, t in gathered.items()}
        self._accumulators.update(gathered)
        try:
            self._apply_one(p, value, g)
        finally:
            self._accumulators.update(slots)
        for key, acc in slots.items():
            scatter(acc, before[key], gathered[key])
        scatter(whole, old, value)
        if master is not None:
            scatter(p, old, value)

    minimize_step = step

    def minimize(self, loss, startup_program=None, parameters=None,
                 no_grad_set=None):
        """The dygraph ``minimize``: backward, step, clear the gradients.
        Under ``static.program_guard`` it makes this the program's
        optimizer instead: the Executor's training step minimizes
        ``loss``, and this optimizer adopts the program's trainable
        parameters (its rate and step move to their device)."""
        from ..static import program as _program
        if _program.recording():
            return self._minimize_program(_program.default_main_program(),
                                          loss)
        loss.backward()
        self.step()
        self.clear_grad()
        return None, None

    def _minimize_program(self, prog, loss):
        if self._fuse_acc or self._fused is not None:
            raise NotImplementedError(
                "fuse_accumulators=True is a dygraph/to_static feature; the "
                "static Program executor keeps per-parameter accumulators")
        train = [p for _s, p in sorted(prog.params.items())
                 if isinstance(p, torch.nn.Parameter) and p.requires_grad]
        known = {id(p) for p in self._parameters()}
        fresh = [p for p in train if id(p) not in known]
        if fresh:
            if not known:  # built without parameters: take their device
                dev = fresh[0].device
                self._lr.tensor = self._lr.tensor.to(dev)
                self._step_count = self._step_count.to(dev)
            self._param_groups.append({"params": fresh})
            used = set(self._names.values())
            for i, p in enumerate(fresh, start=len(known)):
                name = getattr(p, "param_name", None)
                if not name or name in used:
                    name = f"param_{i}"
                used.add(name)
                self._names[id(p)] = name
                self._create_accumulators(p)
        prog._optimizer = self
        prog._loss_slot = prog._slot_of(loss, create=False)
        return None, None

    def _prepare_step(self, lr):
        """Per-step scalars the updates share, from the lr tensor ``lr``
        and the step tensor (on the device)."""

    def _apply_one(self, p, value, g):
        """Update ``value`` (float32: the master or the parameter) in place
        from gradient ``g``, at the rates :meth:`_prepare_step` set."""
        raise NotImplementedError

    def _slot_names(self):
        """The per-parameter float32 state slots besides the master."""
        return sorted({slot for slot, _ in self._accumulators
                       if slot != "master"})

    def state_dict(self):
        """``{"<param name>.<slot>": tensor, "@step", "@lr"[,
        "LR_Scheduler"]}``, as the reference keys it; under ZeRO this
        rank's shard of each store by its name (``zero_<slot>_b<i>``)."""
        out = {f"{self._names[pid]}.{slot}": t
               for (slot, pid), t in self._accumulators.items()}
        if self._zero is not None:
            out.update(self._zero.stores_by_name())
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
        if self._zero is not None:
            by_name.update(self._zero.stores_by_name())
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


def _grad_div(g, a):
    if isinstance(g, SelectedRows):
        return SelectedRows(g.rows, g.values / a, g.height)
    return g / a


class _Elementwise(Optimizer):
    """An elementwise update at the plain rate: ``_apply_one`` is
    ``_apply_flat`` on the parameter's own slots, and ZeRO-1/2/3 and the
    fused stores run ``_apply_flat`` over flat rows."""

    def _prepare_step(self, lr):
        self._lr_t = lr

    def _apply_one(self, p, value, g):
        self._apply_flat(value, g, self._slots_of(p), decay=None, p=p)


class SGD(_Elementwise):
    """``p -= lr * g``, the L2/L1 decay folded into ``g``."""

    def _apply_flat(self, value, g, slots, decay, p=None):
        value.sub_(self._lr_t * self._decayed_grad(value, g, p))


class Momentum(_Elementwise):
    """``v = momentum * v + g``, then ``p -= lr * v`` (with
    ``use_nesterov``, ``p -= lr * (g + momentum * v)``), the L2/L1 decay
    folded into ``g``; the float32 ``velocity`` slot, and a float32 master
    of each low-precision parameter with ``multi_precision``. Elementwise,
    so ZeRO-1/2/3 keep the velocity as a flat sharded store."""

    _SLOTS = ("velocity",)

    def __init__(self, learning_rate=0.001, momentum=0.9, parameters=None,
                 use_nesterov=False, weight_decay=None, grad_clip=None,
                 multi_precision=False, name=None):
        self._momentum = momentum
        self._nesterov = use_nesterov
        self._multi_precision = multi_precision
        super().__init__(learning_rate, parameters, weight_decay, grad_clip)

    def _apply_flat(self, value, g, slots, decay, p=None):
        g = self._decayed_grad(value, g, p)
        v = slots["velocity"]
        v.mul_(self._momentum).add_(g)
        if self._nesterov:
            value.sub_(self._lr_t * (g + self._momentum * v))
        else:
            value.sub_(self._lr_t * v)


class Adam(Optimizer):
    _SLOTS = ("moment1", "moment2")

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=None,
                 grad_clip=None, lazy_mode=False, multi_precision=False,
                 name=None, fuse_accumulators=False):
        self._beta1, self._beta2, self._eps = beta1, beta2, epsilon
        self._multi_precision = multi_precision
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         fuse_accumulators=fuse_accumulators)

    def _prepare_step(self, lr):
        # the bias-corrected rate, in float32 from the step count, as the
        # reference takes it
        t = self._step_count.float()
        self._lr_t = lr * torch.sqrt(1.0 - self._beta2 ** t) / (
            1.0 - self._beta1 ** t)

    def _moments(self, m, v, g):
        m.mul_(self._beta1).add_(g, alpha=1 - self._beta1)
        v.mul_(self._beta2).addcmul_(g, g, value=1 - self._beta2)

    def _update(self, value, m, v):
        """value -= lr_t * m / (sqrt(v) + eps), in the reference's order."""
        value.addcdiv_(m * self._lr_t, v.sqrt().add_(self._eps), value=-1.0)

    def _apply_one(self, p, value, g):
        self._apply_flat(value, g, self._slots_of(p), decay=None, p=p)

    def _apply_flat(self, value, g, slots, decay, p=None):
        """The update on ``value`` with its state ``slots`` (by slot name),
        elementwise: a parameter ``p`` or a ZeRO shard of flat rows alike.
        ``decay`` is AdamW's (True, False or a 0/1 row mask)."""
        m, v = slots["moment1"], slots["moment2"]
        self._moments(m, v, self._decayed_grad(value, g, p))
        self._update(value, m, v)


class AdamW(Adam):
    """Adam with decoupled weight decay ``p -= lr * coeff * p`` for the
    parameters whose name ``apply_decay_param_fun`` accepts (all if
    None); no regularizer, a parameter's own included, as in the
    reference."""

    _reads_regularizer = False

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

    def _decays(self, name):
        return self._decay_fn is None or bool(self._decay_fn(name))

    def _apply_one(self, p, value, g):
        self._apply_flat(value, g, self._slots_of(p),
                         decay=self._decays(self._names[id(p)]))

    def _apply_flat(self, value, g, slots, decay, p=None):
        m, v = slots["moment1"], slots["moment2"]
        self._moments(m, v, g)
        if decay is not False:
            wd = value * self._lr_coeff  # from the value before the step
            if decay is not True:
                wd.mul_(decay)  # a 0/1 row mask: exact
        self._update(value, m, v)
        if decay is not False:
            value.sub_(wd)


# -- the elementwise optimizers of the reference's tail ----------------------
# Each keeps the reference's order of operations (float32 results agree
# to rounding).

class Adagrad(_Elementwise):
    """``acc += g^2``, ``p -= lr * g / (sqrt(acc) + eps)``; the slot
    starts at ``initial_accumulator_value``."""

    _SLOTS = ("moment",)

    def __init__(self, learning_rate, epsilon=1e-6, parameters=None,
                 weight_decay=None, grad_clip=None,
                 initial_accumulator_value=0.0, name=None):
        self._eps = epsilon
        self._init_acc = initial_accumulator_value
        super().__init__(learning_rate, parameters, weight_decay, grad_clip)

    def _create_accumulators(self, param):
        self._add_accumulator("moment", param, fill=self._init_acc)

    def _apply_flat(self, value, g, slots, decay, p=None):
        g = self._decayed_grad(value, g, p)
        acc = slots["moment"]
        acc.add_(g.square())
        value.sub_(self._lr_t * g / (acc.sqrt() + self._eps))


class RMSProp(_Elementwise):
    """The mean square (and, ``centered``, the mean gradient) with decay
    ``rho``; ``mom = momentum * mom + lr * g / sqrt(denom + eps)``,
    ``p -= mom``."""

    def __init__(self, learning_rate, rho=0.95, epsilon=1e-6, momentum=0.0,
                 centered=False, parameters=None, weight_decay=None,
                 grad_clip=None, name=None):
        self._rho, self._eps = rho, epsilon
        self._momentum, self._centered = momentum, centered
        self._SLOTS = ("mean_square", "momentum") + (
            ("mean_grad",) if centered else ())
        super().__init__(learning_rate, parameters, weight_decay, grad_clip)

    def _apply_flat(self, value, g, slots, decay, p=None):
        g = self._decayed_grad(value, g, p)
        ms, mom = slots["mean_square"], slots["momentum"]
        ms.copy_(self._rho * ms + (1 - self._rho) * g.square())
        denom = ms
        if self._centered:
            mg = slots["mean_grad"]
            mg.copy_(self._rho * mg + (1 - self._rho) * g)
            denom = ms - mg.square()
        mom.copy_(self._momentum * mom
                  + self._lr_t * g / (denom + self._eps).sqrt())
        value.sub_(mom)


class Adadelta(_Elementwise):
    _SLOTS = ("avg_squared_grad", "avg_squared_update")

    def __init__(self, learning_rate=0.001, epsilon=1e-6, rho=0.95,
                 parameters=None, weight_decay=None, grad_clip=None,
                 name=None):
        self._rho, self._eps = rho, epsilon
        super().__init__(learning_rate, parameters, weight_decay, grad_clip)

    def _apply_flat(self, value, g, slots, decay, p=None):
        g = self._decayed_grad(value, g, p)
        asg, asu = slots["avg_squared_grad"], slots["avg_squared_update"]
        asg.copy_(self._rho * asg + (1 - self._rho) * g.square())
        update = ((asu + self._eps).sqrt() / (asg + self._eps).sqrt()) * g
        asu.copy_(self._rho * asu + (1 - self._rho) * update.square())
        value.sub_(self._lr_t * update)


class Adamax(_Elementwise):
    """The infinity-norm Adam; the rate's bias correction ``1 - beta1^t``
    from the device step count."""

    _SLOTS = ("moment", "inf_norm")

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=None,
                 grad_clip=None, name=None):
        self._beta1, self._beta2, self._eps = beta1, beta2, epsilon
        super().__init__(learning_rate, parameters, weight_decay, grad_clip)

    def _prepare_step(self, lr):
        t = self._step_count.float()
        self._lr_t = lr / (1.0 - self._beta1 ** t)

    def _apply_flat(self, value, g, slots, decay, p=None):
        g = self._decayed_grad(value, g, p)
        m, u = slots["moment"], slots["inf_norm"]
        m.copy_(self._beta1 * m + (1 - self._beta1) * g)
        u.copy_(torch.maximum(self._beta2 * u, g.abs()))
        value.sub_(self._lr_t * m / (u + self._eps))


class DecayedAdagrad(_Elementwise):
    """``acc = decay * acc + (1 - decay) * g^2``,
    ``p -= lr * g / (sqrt(acc) + eps)``."""

    _SLOTS = ("moment",)

    def __init__(self, learning_rate, decay=0.95, epsilon=1e-6,
                 parameters=None, weight_decay=None, grad_clip=None,
                 name=None):
        self._decay, self._eps = decay, epsilon
        super().__init__(learning_rate, parameters, weight_decay, grad_clip)

    def _apply_flat(self, value, g, slots, decay, p=None):
        g = self._decayed_grad(value, g, p)
        acc = slots["moment"]
        acc.copy_(self._decay * acc + (1 - self._decay) * g.square())
        value.sub_(self._lr_t * g / (acc.sqrt() + self._eps))


class ProximalGD(_Elementwise):
    """A gradient step, then the l1/l2 proximal operator."""

    def __init__(self, learning_rate, l1=0.0, l2=0.0, parameters=None,
                 weight_decay=None, grad_clip=None, name=None):
        self._l1, self._l2 = l1, l2
        super().__init__(learning_rate, parameters, weight_decay, grad_clip)

    def _prox(self, prox, step_lr):
        return (torch.sign(prox)
                * (prox.abs() - step_lr * self._l1).clamp_min(0.0)
                / (1.0 + step_lr * self._l2))

    def _apply_flat(self, value, g, slots, decay, p=None):
        g = self._decayed_grad(value, g, p)
        value.copy_(self._prox(value - self._lr_t * g, self._lr_t))


class ProximalAdagrad(ProximalGD):
    """The proximal step at an Adagrad-scaled rate."""

    _SLOTS = ("moment",)

    def __init__(self, learning_rate, l1=0.0, l2=0.0, epsilon=1e-10,
                 parameters=None, weight_decay=None, grad_clip=None,
                 name=None):
        self._eps = epsilon
        super().__init__(learning_rate, l1, l2, parameters, weight_decay,
                         grad_clip)

    def _apply_flat(self, value, g, slots, decay, p=None):
        g = self._decayed_grad(value, g, p)
        acc = slots["moment"]
        acc.add_(g.square())
        lr_t = self._lr_t / (acc.sqrt() + self._eps)
        value.copy_(self._prox(value - lr_t * g, lr_t))


class Ftrl(_Elementwise):
    """FTRL-proximal at ``lr_power``. Where ``|linear| <= l1`` the weight
    is exactly 0; the quotient of the other branch, 0/0 there with
    ``l2 = 0`` and a zero gradient history, is selected away as in the
    reference (no epsilon)."""

    _SLOTS = ("squared", "linear")

    def __init__(self, learning_rate, l1=0.0, l2=0.0, lr_power=-0.5,
                 parameters=None, weight_decay=None, grad_clip=None,
                 name=None):
        self._l1, self._l2, self._lr_power = l1, l2, lr_power
        super().__init__(learning_rate, parameters, weight_decay, grad_clip)

    def _apply_flat(self, value, g, slots, decay, p=None):
        g = self._decayed_grad(value, g, p)
        sq, lin = slots["squared"], slots["linear"]
        lr = self._lr_t
        new_sq = sq + g.square()
        pw = -self._lr_power
        sigma = (new_sq ** pw - sq ** pw) / lr
        lin.copy_(lin + g - sigma * value)
        sq.copy_(new_sq)
        x = self._l1 * torch.sign(lin) - lin
        y = new_sq ** pw / lr + 2.0 * self._l2
        value.copy_(torch.where(lin.abs() > self._l1, x / y, 0.0))


# -- the whole-tensor optimizers ------------------------------------------------

class _NamedParam:
    """What ``exclude_from_weight_decay_fn`` receives: the parameter,
    whose ``name`` reads the optimizer's name for it (torch keeps
    ``Tensor.name`` for itself; the reference's functions read
    ``p.name``)."""

    def __init__(self, p, name):
        self._p, self.name = p, name

    def __getattr__(self, attr):
        return getattr(self._p, attr)


class Lamb(Optimizer):
    """Adam's moments with the bias correction from the device step count,
    the decay ``lamb_weight_decay * p`` added to the update unless
    ``exclude_from_weight_decay_fn(p)``, and the trust ratio
    ``|p| / |r|`` (1 where either norm is 0): whole-tensor norms, so no
    ZeRO."""

    _zero_compatible = False
    _SLOTS = ("moment1", "moment2")

    def __init__(self, learning_rate=0.001, lamb_weight_decay=0.01, beta1=0.9,
                 beta2=0.999, epsilon=1e-6, parameters=None, grad_clip=None,
                 exclude_from_weight_decay_fn=None, name=None):
        self._beta1, self._beta2, self._eps = beta1, beta2, epsilon
        self._lamb_wd = lamb_weight_decay
        self._exclude_fn = exclude_from_weight_decay_fn
        super().__init__(learning_rate, parameters, None, grad_clip)
        self._excluded = {
            id(p): self._exclude_fn is not None and bool(self._exclude_fn(
                _NamedParam(p, self._names[id(p)])))
            for p in self._parameters()}

    def _prepare_step(self, lr):
        t = self._step_count.float()
        self._lr_t = lr
        self._bc1 = 1.0 - self._beta1 ** t
        self._bc2 = 1.0 - self._beta2 ** t

    def _apply_one(self, p, value, g):
        m, v = self._get_accumulator("moment1", p), \
            self._get_accumulator("moment2", p)
        m.copy_(self._beta1 * m + (1 - self._beta1) * g)
        v.copy_(self._beta2 * v + (1 - self._beta2) * g.square())
        r = (m / self._bc1) / ((v / self._bc2).sqrt() + self._eps)
        if not self._excluded[id(p)]:
            r = r + self._lamb_wd * value
        w_norm = value.square().sum().sqrt()
        r_norm = r.square().sum().sqrt()
        ratio = torch.where((w_norm > 0) & (r_norm > 0), w_norm / r_norm,
                            1.0)
        value.sub_(self._lr_t * ratio * r)


class Lars(Momentum):
    """LARS: the local rate ``coeff * |p| / (|g| + wd * |p| + 1e-12)`` (1
    where either norm is 0) scales the momentum's input. As in the
    reference, ``exclude_from_weight_decay`` is taken and not applied
    (ROADMAP §3 records the gap)."""

    _zero_compatible = False

    def __init__(self, learning_rate=0.001, momentum=0.9, lars_coeff=0.001,
                 lars_weight_decay=0.0005, parameters=None, grad_clip=None,
                 exclude_from_weight_decay=None, multi_precision=False,
                 name=None):
        self._lars_coeff = lars_coeff
        self._lars_wd = lars_weight_decay
        super().__init__(learning_rate, momentum, parameters, False, None,
                         grad_clip, multi_precision=multi_precision)

    def _apply_one(self, p, value, g):
        w_norm = value.square().sum().sqrt()
        g_norm = g.square().sum().sqrt()
        local_lr = torch.where(
            (w_norm > 0) & (g_norm > 0),
            self._lars_coeff * w_norm
            / (g_norm + self._lars_wd * w_norm + 1e-12), 1.0)
        v = self._get_accumulator("velocity", p)
        v.copy_(self._momentum * v + self._lr_t * local_lr * (
            g + self._lars_wd * value))
        value.sub_(v)


class Dpsgd(Optimizer):
    """Differentially private SGD: each gradient clipped to norm ``clip``,
    Gaussian noise of scale ``sigma / batch_size`` added, then the SGD
    step. The noise draws from the package's generator
    (``core.random.draw_generator``), reproducible under ``seed``; torch's
    Philox and the reference's threefry give different draws."""

    _zero_compatible = False

    def __init__(self, learning_rate=0.001, clip=10.0, batch_size=16.0,
                 sigma=1.0, parameters=None, grad_clip=None, name=None):
        self._clip, self._bs, self._sigma = clip, batch_size, sigma
        super().__init__(learning_rate, parameters, None, grad_clip)

    def _prepare_step(self, lr):
        self._lr_t = lr

    def _apply_one(self, p, value, g):
        from ..core import random as core_random
        norm = g.square().sum().sqrt()
        scale = (self._clip / (norm + 1e-12)).clamp_max(1.0)
        noise = torch.randn(g.shape, dtype=torch.float32, device=g.device,
                            generator=core_random.draw_generator(g.device))
        value.sub_(self._lr_t * (g * scale + noise * (self._sigma
                                                       / self._bs)))
