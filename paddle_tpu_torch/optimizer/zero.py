"""ZeRO-1/2/3 data parallelism for the port's optimizers (counterpart: the
``_zero_*`` methods of ``paddle_tpu/optimizer/optimizer.py``).

The parameters are split into buckets (``distributed.bucketing``, the
reference's assignment). Every per-parameter tensor of a bucket shares one
flat ``[rows, 1024]`` layout: each parameter a row-aligned segment, the
rows padded to a multiple of the degree, so rank r owns rows
``[r * rows/degree, (r + 1) * rows/degree)`` of every store. The stores
(``moment1``, ``moment2``, the float32 ``master`` of low-precision
parameters, stage 2/3's window accumulator ``gacc`` and stage 3's
``param``) hold only those rows.

Each bucket also has one full ``[rows, 1024]`` parameter buffer in the
parameters' dtype, and every parameter is a view of its segment there, so
an all-gather into the buffer writes the parameters themselves. At stages
1/2 the buffer is the parameters' only copy and stays. At stage 3 it holds
memory only from the gather before a step's forward to the bucket's
reduction after its backward: the step releases it there (its storage
resized to nothing) and the next step's gather allocates it again. Inside a
captured CUDA graph the allocation comes from the graph's pool, so every
replay finds it at the capture's address. With ``prefetch``, bucket 0's
buffer is the reference's prefetch slot and stays. A program's call
releases the buffers before its first step and gathers them after its
last, so the parameters read between calls are current; outside a program
every step ends gathered. Each step's float32 gradient rows of a bucket are
allocated for its reduction and dropped after it.

A step, per bucket:

1. the gradients are copied into the float32 rows (zeros where a parameter
   has none) and reduce-scattered over the mesh's group; the shard is
   divided by the degree (a mean), plus the window accumulator at stages
   2/3, over the window's length;
2. the clip on the shard (global norm: per-parameter sums of squares of
   each rank's part, all-reduced, summed in the per-parameter control's
   order; value: elementwise), then the optimizer's elementwise update
   (``_apply_flat``) on the shard of the moments and the master;
3. stages 1/2 all-gather the new parameters into the buffer; stage 3
   writes its own rows of the ``param`` store and gathers the buffer
   before the next step's forward (``jit.to_static``'s step hook).

Elementwise math on a shard is the math on the whole, so the losses and
parameters equal the replicated control's (``Optimizer._reduce_dp_grads``)
bit for bit wherever the group's sums are, which gloo and NCCL give at two
ranks (a + b = b + a) and trivially at one. The exceptions are the
reference's: the global-norm clip above one rank (summation order) and
stage 2/3 windows, which sum float32 mean shards where the control sums
the gradients in the parameters' dtype.

``prefetch`` (default on) changes the order only: bucket i+1's
reduce-scatter is issued (asynchronously) before bucket i's update math,
and at stage 3 bucket 0's all-gather runs at the tail of the step, so the
next step's forward finds bucket 0 gathered. The clip's norm needs every
shard first, so the global-norm clip keeps the serial order.
"""
import weakref

import numpy as np
import torch
import torch.distributed as dist

from ..distributed import bucketing, collective, parallel_env
from ..nn.clip import ClipGradByGlobalNorm, ClipGradByValue
from .optimizer import _lr_scale

_FLAT_LANES = 1024  # the reference's row width


class _Bucket:
    """One bucket's layout and its tensors."""

    def __init__(self, index, params, degree, rank):
        self.index = index
        self.params = list(params)
        self.degree, self.rank = degree, rank
        self.sizes = [max(p.numel(), 1) for p in self.params]
        self.shapes = [tuple(p.shape) for p in self.params]
        self.n_rows = [-(-n // _FLAT_LANES) for n in self.sizes]
        self.row_offs = list(np.cumsum([0] + self.n_rows[:-1]))
        used = sum(self.n_rows)
        self.pad_rows = (-used) % degree
        self.rows = used + self.pad_rows
        self.stores = {}
        self.buffer = None  # the full parameters (see _build)
        self.kept = True  # whether the buffer never releases its memory

    def release(self):
        """Stage 3: free the full buffer's memory. The parameters, views of
        it, are not readable until :meth:`materialize` and a gather."""
        if not self.kept:
            self.buffer.untyped_storage().resize_(0)

    def materialize(self):
        """Give the full buffer its memory back (contents undefined)."""
        storage = self.buffer.untyped_storage()
        nbytes = self.buffer.numel() * self.buffer.element_size()
        if storage.nbytes() != nbytes:
            storage.resize_(nbytes)

    @property
    def shard_rows(self):
        return self.rows // self.degree

    def segments(self, full):
        """Per-parameter views of a full ``[rows, 1024]`` tensor."""
        flat = full.view(-1)
        return [flat[o * _FLAT_LANES:o * _FLAT_LANES + n].view(shape)
                for o, n, shape in zip(self.row_offs, self.sizes,
                                       self.shapes)]

    def local(self, full):
        """This rank's rows of a full ``[rows, ...]`` tensor."""
        r = self.shard_rows
        return full[self.rank * r:(self.rank + 1) * r]

    def local_parts(self, shard):
        """For each parameter, the flat part of it that ``shard`` (this
        rank's rows) holds, or None."""
        lo = self.rank * self.shard_rows * _FLAT_LANES
        hi = lo + self.shard_rows * _FLAT_LANES
        flat = shard.view(-1)
        parts = []
        for o, n in zip(self.row_offs, self.sizes):
            a, b = max(o * _FLAT_LANES, lo), min(o * _FLAT_LANES + n, hi)
            parts.append(flat[a - lo:b - lo] if a < b else None)
        return parts

    def flatten(self, values, dtype, device):
        """Per-parameter tensors -> the full ``[rows, 1024]`` layout."""
        full = torch.zeros(self.rows, _FLAT_LANES, dtype=dtype, device=device)
        for seg, v in zip(self.segments(full), values):
            seg.copy_(v)
        return full


def _decay_rows(opt, b, device):
    """AdamW's ``apply_decay_param_fun`` over bucket ``b``: True, False or
    this rank's rows of a 0/1 row mask (None for other optimizers)."""
    decays = getattr(opt, "_decays", None)
    if decays is None:
        return None
    flags = [decays(opt._names[id(p)]) for p in b.params]
    if all(flags):
        return True
    if not any(flags):
        return False
    mask = torch.zeros(b.rows, 1, device=device)
    for o, n, f in zip(b.row_offs, b.n_rows, flags):
        mask[o:o + n] = float(f)
    return b.local(mask).clone()


def _hold(b, absent, tensors):
    """(view, copy) of each absent parameter's rows of ``tensors``."""
    held = []
    for i in absent:
        for t in tensors:
            part = b.local_parts(t)[i]
            if part is not None:
                held.append((part, part.clone()))
    return held


class FusedState:
    """``fuse_accumulators``: the optimizer's state in coalesced stores
    (``Optimizer._fused``), the reference's ``_FlatStore`` layout: one
    float32 ``[rows, 1024]`` store per slot over every parameter in order,
    each parameter's rows filled with the slot's start value, and each
    accumulator a view of its segment. The float32 masters of the
    low-precision parameters make one more store (``master``), which the
    reference keeps per parameter. A step with ``flat`` set runs
    ``_apply_flat`` once over each store: a bucket at degree 1 with no
    collective, as ZeRO's shard update (bitwise the per-parameter update);
    a parameter without a gradient keeps its rows."""

    def __init__(self, opt):
        params = list(opt._parameters())
        if not params:
            raise ValueError("fuse_accumulators needs parameters")
        self.opt = opt
        self.device = params[0].device
        self.layout = b = _Bucket(0, params, 1, 0)
        self.slots = opt._slot_names()
        self.stores = {}
        with torch.no_grad():
            for slot in self.slots + ["master"]:
                keys = [(slot, id(p)) for p in params]
                if not any(k in opt._accumulators for k in keys):
                    continue
                fill = opt._fills.get(slot, 0.0)
                store = torch.zeros(b.rows, _FLAT_LANES, device=self.device)
                for o, n in zip(b.row_offs, b.n_rows):
                    store[o:o + n] = fill
                for k, seg in zip(keys, b.segments(store)):
                    old = opt._accumulators.get(k)
                    if old is not None:
                        seg.copy_(old)
                        opt._accumulators[k] = seg
                self.stores[slot] = store
        self.masters = [opt._accumulators.get(("master", id(p)))
                        for p in params]
        self.all_master = all(m is not None for m in self.masters)
        self.flat = opt._zero_compatible and not any(
            _lr_scale(p) != 1.0 or (opt._reads_regularizer and getattr(
                p, "regularizer", None) is not None) for p in params)
        self.decay = _decay_rows(opt, b, self.device)
        self.index = {id(p): i for i, p in enumerate(params)}

    def step(self, pairs):
        """One update over the whole stores from the dense (param, float
        gradient) ``pairs``, at the rates ``_prepare_step`` set."""
        b, opt = self.layout, self.opt
        grads = torch.zeros(b.rows, _FLAT_LANES, device=self.device)
        segs = b.segments(grads)
        present = [False] * len(b.params)
        for p, g in pairs:
            i = self.index[id(p)]
            segs[i].copy_(g)
            present[i] = True
        if self.all_master:
            value = self.stores["master"]
        else:
            value = torch.zeros(b.rows, _FLAT_LANES, device=self.device)
            for p, m, seg in zip(b.params, self.masters,
                                 b.segments(value)):
                seg.copy_(p if m is None else m)
        slots = {s: self.stores[s] for s in self.slots}
        absent = [i for i, has in enumerate(present) if not has]
        held = _hold(b, absent, [value, *slots.values()])
        opt._apply_flat(value, grads, slots, decay=self.decay)
        for view, old in held:
            view.copy_(old)  # a parameter without a gradient holds still
        for p, m, seg, has in zip(b.params, self.masters, b.segments(value),
                                  present):
            if has:
                if m is not None and not self.all_master:
                    m.copy_(seg)
                p.copy_(seg)


class ZeroState:
    """The partitioned state of one optimizer (``Optimizer._zero``)."""

    def __init__(self, opt, axis, mesh, stage, comm_buffer_mb,
                 last_comm_buffer_mb, prefetch):
        if not opt._zero_compatible:
            raise NotImplementedError(
                f"{type(opt).__name__} has a non-elementwise update "
                "(norm/trust-ratio or RNG terms) and cannot run sharded; "
                "ZeRO supports the elementwise optimizers (SGD, Momentum, "
                "the Adam family)")
        for p in opt._parameters():
            attrs = [a for a, on in (
                ("learning_rate", _lr_scale(p) != 1.0),
                ("regularizer", opt._reads_regularizer
                 and getattr(p, "regularizer", None) is not None)) if on]
            if attrs and p.requires_grad:
                raise NotImplementedError(
                    f"param {opt._names[id(p)]} has a per-parameter "
                    f"{' and '.join(attrs)} (ParamAttr), which ZeRO's flat "
                    "stores do not take; leave it at the default or run "
                    "without ZeRO")
        clip = opt._grad_clip
        if clip is not None and not isinstance(
                clip, (ClipGradByGlobalNorm, ClipGradByValue)):
            raise NotImplementedError(
                f"{type(clip).__name__} needs per-parameter norms, which a "
                "flat bucket shard cannot reassemble; ZeRO composes with "
                "ClipGradByGlobalNorm and ClipGradByValue")
        mesh = mesh if mesh is not None else parallel_env.current_mesh()
        if mesh is None:
            raise RuntimeError("ZeRO needs an active mesh "
                               "(distributed.set_mesh(make_mesh(...)))")
        axis = axis or "dp"
        if axis not in mesh.axis_names:
            raise ValueError(f"mesh {mesh.axis_names} has no axis {axis!r}")
        if int(stage) not in (1, 2, 3):
            raise ValueError(f"ZeRO stage must be 1, 2 or 3, got {stage}")
        params = [p for p in opt._parameters() if p.requires_grad]
        if not params:
            raise ValueError("ZeRO sharding needs trainable parameters")
        for p in params:
            if getattr(p, "_zero_owner", None) is not None:
                raise NotImplementedError(
                    f"param {opt._names[id(p)]} already carries a ZeRO "
                    "layout of another optimizer; ZeRO shards parameters "
                    "that nothing else lays out")
        if len({p.device for p in params}) != 1:
            raise ValueError("ZeRO needs every parameter on one device")
        self.opt, self.axis = opt, axis
        self.stage = int(stage)
        self.group = parallel_env.axis_group(mesh, axis)
        self.degree = parallel_env.axis_degree(mesh, axis)
        self.rank = dist.get_rank(self.group)
        self.comm_buffer_mb = float(
            bucketing.DEFAULT_COMM_BUFFER_MB if comm_buffer_mb is None
            else comm_buffer_mb)
        self.prefetch = True if prefetch is None else bool(prefetch)
        self.device = params[0].device
        self._program = None  # the step program that steps this state
        self.slots = opt._slot_names()
        self.buckets = [
            self._build(i, ps) for i, ps in enumerate(bucketing.bucket_params(
                params, self.comm_buffer_mb, last_comm_buffer_mb))]
        self.n_sharded = sum(len(b.stores) for b in self.buckets)
        if self.stage == 3:
            from ..jit.to_static import (register_call_begin_hook,
                                         register_call_end_hook,
                                         register_step_hook)
            # released before a call's first step, gathered before each
            # step's forward and once at the end of each call, so that the
            # parameters read between calls are current
            register_call_begin_hook(self.release_for)
            register_step_hook(self.gather_for)
            register_call_end_hook(self.gather_for)

    def _build(self, index, params):
        """Lay one bucket out: its stores (migrating the optimizer's state),
        the parameter buffer the parameters become views of, and the step's
        scratch tensors."""
        opt, dev = self.opt, self.device
        b = _Bucket(index, params, self.degree, self.rank)
        dtypes = {p.dtype for p in params}
        if len(dtypes) != 1:
            raise NotImplementedError(
                f"ZeRO bucket {index} mixes parameter dtypes "
                f"{sorted(map(str, dtypes))}: its parameters are views of "
                "one buffer, so a bucket takes one dtype (cast the model "
                "to one dtype before enabling)")
        b.param_dtype = params[0].dtype
        b.has_master = (getattr(opt, "_multi_precision", False)
                        and any(p.dtype in (torch.bfloat16, torch.float16)
                                for p in params))
        f32 = torch.float32
        with torch.no_grad():
            for slot in self.slots:
                vals = [opt._accumulators.pop((slot, id(p)), None)
                        for p in params]
                vals = [torch.zeros(s, device=dev) if v is None else v
                        for v, s in zip(vals, b.shapes)]
                b.stores[slot] = b.local(b.flatten(vals, f32, dev)).clone()
            if b.has_master:
                vals = [opt._accumulators.pop(("master", id(p)), None)
                        for p in params]
                vals = [p.float() if v is None else v
                        for v, p in zip(vals, params)]
                b.stores["master"] = b.local(b.flatten(vals, f32,
                                                       dev)).clone()
            else:
                for p in params:
                    opt._accumulators.pop(("master", id(p)), None)
            if self.stage >= 2:
                b.stores["gacc"] = torch.zeros(b.shard_rows, _FLAT_LANES,
                                               device=dev)
            b.buffer = b.flatten(params, b.param_dtype, dev)
            if self.stage == 3:
                b.stores["param"] = b.local(b.buffer).clone()
                b.kept = self.prefetch and index == 0  # the prefetch slot
            else:  # what this rank contributes to the all-gather
                b.send = torch.empty(b.shard_rows, _FLAT_LANES,
                                     dtype=b.param_dtype, device=dev)
            for p, seg in zip(params, b.segments(b.buffer)):
                p.data = seg  # the parameter is its segment of the buffer
                p._zero_owner = self
        b.grad_shard = torch.empty(b.shard_rows, _FLAT_LANES, device=dev)
        b.decay = _decay_rows(opt, b, dev)
        return b

    def reenable(self, axis, stage, comm_buffer_mb, prefetch):
        same = (axis in (None, self.axis) and int(stage) == self.stage
                and (comm_buffer_mb is None
                     or float(comm_buffer_mb) == self.comm_buffer_mb)
                and (prefetch is None or bool(prefetch) == self.prefetch))
        if not same:
            raise RuntimeError(
                f"ZeRO already enabled with axis={self.axis!r} "
                f"stage={self.stage} comm_buffer_mb={self.comm_buffer_mb} "
                f"prefetch={self.prefetch}; enabling again with (axis="
                f"{axis!r}, stage={stage}, comm_buffer_mb={comm_buffer_mb}, "
                f"prefetch={prefetch}) would keep the old layout: build a "
                "new optimizer")
        return self.n_sharded

    # -- accounting --------------------------------------------------------
    def _store_items(self):
        for b in self.buckets:
            for slot, t in b.stores.items():
                yield f"zero_{slot}_b{b.index}", t

    def stores_by_name(self):
        return dict(self._store_items())

    def state_bytes(self):
        return sum(t.numel() * t.element_size()
                   for _, t in self._store_items())

    def layout(self):
        names = [n for n, _ in self._store_items()]
        if self.stage == 3 and self.prefetch:
            # bucket 0's full buffer, which stays between steps (not state:
            # the reference leaves it out of the state bytes too)
            names.append("zero3_prefetch_slot")
        return {"stage": self.stage, "axis": self.axis,
                "degree": self.degree, "n_buckets": len(self.buckets),
                "prefetch": self.prefetch,
                "comm_buffer_mb": self.comm_buffer_mb,
                "bucket_rows": [b.rows for b in self.buckets],
                "shard_rows": [b.shard_rows for b in self.buckets],
                "store_names": names, "state_bytes": self.state_bytes()}

    # -- the step ----------------------------------------------------------
    def _check_axis(self):
        """Whether a step program with this state's axis runs the step
        (which it then owns); raises for a program with another axis."""
        cur = parallel_env.current_dp_axis()
        if cur is not None and cur != self.axis:
            raise RuntimeError(f"ZeRO state is sharded over {self.axis!r} "
                               f"but the step program binds dp axis {cur!r}")
        if cur is None:
            return False
        self._program = weakref.ref(parallel_env.current_program())
        return True

    def _reduce(self, b, async_op):
        """Copy the bucket's gradients into float32 rows and issue the
        reduce-scatter into its shard; returns (work, which parameters had
        a gradient, the rows, which must live until the work is waited).
        Stage 2/3 drop each gradient here, and stage 3 the full
        parameters: the backward has used them."""
        present = []
        grads = torch.zeros(b.rows, _FLAT_LANES, device=self.device)
        for p, seg in zip(b.params, b.segments(grads)):
            g = p.grad
            present.append(g is not None)
            if g is None:
                seg.zero_()
            else:
                if g.is_sparse:
                    raise NotImplementedError(
                        "ZeRO does not support sparse gradients")
                seg.copy_(g)
                if self.stage >= 2:
                    p.grad = None
        b.release()  # stage 3 (no-op otherwise)
        work = collective.reduce_scatter_flat(b.grad_shard, grads,
                                              self.group, async_op=async_op)
        return work, present, grads

    def _normalize(self, b, window):
        """The reduced sum -> the gradient the update takes: the mean over
        the group, plus the window's accumulated means, over its length."""
        g = b.grad_shard.div_(self.degree)
        if window is not None:
            if self.stage >= 2:
                g.add_(b.stores["gacc"])
            g.div_(window)
        return g

    def accum_fold(self):
        """A micro step of an accumulation window. Stage 1: nothing (the
        gradients accumulate on the parameters). Stages 2/3: reduce the
        micro step's gradients now and fold the mean shard into ``gacc``,
        so no full gradient outlives its step."""
        if self.stage < 2:
            return
        if not self._check_axis():
            raise NotImplementedError(
                "ZeRO stage>=2 gradient accumulation runs inside the step "
                f"program (to_static(..., scan_steps=k, dp_axis="
                f"{self.axis!r}, accumulate_steps=a))")
        for b in self.buckets:
            self._reduce(b, async_op=False)
            b.stores["gacc"].add_(b.grad_shard.div_(self.degree))

    def step(self):
        opt = self.opt
        in_program = self._check_axis()
        acc = parallel_env.current_accum()
        window = acc[1] if acc is not None and acc[1] > 1 else None
        clip = opt._grad_clip
        serial = isinstance(clip, ClipGradByGlobalNorm) or not self.prefetch
        gathers = []
        if serial:
            present = []
            for b in self.buckets:
                present.append(self._reduce(b, async_op=False)[1])
            grads = [self._normalize(b, window) for b in self.buckets]
            scale = (self._clip_scale(clip, present)
                     if isinstance(clip, ClipGradByGlobalNorm) else None)
            self._begin(opt)
            for b, g, pr in zip(self.buckets, grads, present):
                gathers.append(self._update(b, g, pr, scale))
        else:
            self._begin(opt)
            nxt = self._reduce(self.buckets[0], async_op=True)
            for i, b in enumerate(self.buckets):
                work, present, rows = nxt  # rows live until the wait
                if i + 1 < len(self.buckets):
                    nxt = self._reduce(self.buckets[i + 1], async_op=True)
                work.wait()
                del rows
                g = self._normalize(b, window)
                gathers.append(self._update(b, g, present, None))
        for work in gathers:
            if work is not None:
                work.wait()
        if self.stage >= 2 and window is not None:
            for b in self.buckets:
                b.stores["gacc"].zero_()
        if self.stage == 3 and not in_program:
            self._gather(self.buckets)

    def _begin(self, opt):
        opt._step_count.add_(1)
        opt._prepare_step(opt._lr.tensor)

    def _clip_scale(self, clip, present):
        """Global norm over the shards: each parameter's sum of squares of
        the part this rank holds, all-reduced across the group and summed
        in parameter order, as the per-parameter control sums them."""
        parts, params = [], []
        for b, pr in zip(self.buckets, present):
            for p, part, has in zip(b.params, b.local_parts(b.grad_shard),
                                    pr):
                if has:
                    parts.append(part.square().sum() if part is not None
                                 else b.grad_shard.new_zeros(()))
                    params.append(p)
        if not parts:
            return None
        sq = torch.stack(parts)
        collective.all_reduce(sq, group=self.group)
        global_norm = clip._total_sq(params, sq).sqrt()
        return clip.clip_norm / global_norm.clamp_min(clip.clip_norm)

    def _update(self, b, g, present, scale):
        """Clip and update one bucket's shard, then publish it; returns the
        all-gather's work handle, if one was issued."""
        opt = self.opt
        clip = opt._grad_clip
        if scale is not None:
            g.mul_(scale)
        elif isinstance(clip, ClipGradByValue):
            g.clamp_(clip.min, clip.max)
        if b.has_master:
            value = b.stores["master"]
        elif self.stage == 3:
            value = b.stores["param"]
        else:
            value = b.local(b.buffer)
        work = value if value.dtype == torch.float32 else value.float()
        slots = {s: b.stores[s] for s in self.slots}
        absent = [i for i, has in enumerate(present) if not has]
        held = _hold(b, absent, [work, *slots.values()])
        opt._apply_flat(work, g, slots, decay=b.decay)
        for view, old in held:
            view.copy_(old)  # a parameter without a gradient holds still
        if self.stage == 3:
            if work is not b.stores["param"]:
                b.stores["param"].copy_(work)
            if self.prefetch and b.index == 0:
                return collective.all_gather_flat(
                    b.buffer, b.stores["param"], self.group, async_op=True)
            return None
        b.send.copy_(work)
        return collective.all_gather_flat(b.buffer, b.send, self.group,
                                          async_op=True)

    # -- checkpoints ---------------------------------------------------------
    def gather_shards(self, store):
        """Every rank's shard of ``store`` (this state's ``[shard_rows,
        1024]`` tensor), in rank order; every rank of the group calls it."""
        if self.degree == 1:
            return [store]
        full = torch.empty((self.degree * store.shape[0], *store.shape[1:]),
                           dtype=store.dtype, device=store.device)
        collective.all_gather_flat(full, store, self.group)
        return list(full.chunk(self.degree))

    def refresh_parameters(self):
        """After a restore wrote the stores: stage 3 gathers every
        parameter buffer from its ``param`` store again (bucket 0's too,
        the prefetch slot), in place, so the next forward, eager or
        replayed, reads the restored parameters. Stages 1/2 keep the
        parameters themselves, which the model section restores."""
        if self.stage == 3:
            self._gather(self.buckets)

    # -- stage 3: the parameters ---------------------------------------------
    def _gather(self, buckets):
        for b in buckets:
            b.materialize()
            collective.all_gather_flat(b.buffer, b.stores["param"],
                                       self.group)

    def _pending(self):
        """The buckets a step must gather: all but bucket 0 under prefetch
        (the previous step's tail refilled it)."""
        return self.buckets[1:] if self.prefetch else self.buckets

    def _steps(self, axis, program):
        """Whether ``program`` is the one that steps this state. Only that
        program releases and gathers: the buffers are current before its
        first step and after each of its calls, so any other program finds
        them so."""
        return (axis == self.axis and self._program is not None
                and self._program() is program)

    def gather_for(self, axis, program):
        """The program's step and call-end hook: fill the parameter buffers
        that are not current."""
        if self._steps(axis, program):
            self._gather(self._pending())

    def release_for(self, axis, program):
        """The program's call-begin hook: free the buffers that the call's
        first step gathers again (outside any capture, so a graph never
        frees memory it did not allocate)."""
        if self._steps(axis, program):
            for b in self._pending():
                b.release()
