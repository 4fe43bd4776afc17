"""The static graph (counterpart: ``paddle_tpu/static``): a Program
records the torch calls of a build between ``program_guard``'s bounds and
the Executor replays it, on the card as one CUDA graph per cache key
(``program.py``); the pass registry and feed/fetch pruning
(``passes.py``); the parameter-server transpiler (``transpiler.py``); the
training checkpoint of a Program (:func:`save`/:func:`load`) and its
inference artifact (:func:`save_inference_model`, which is ``jit.save``'s
``.pdmodel`` pair).
"""
import io as _io
import json as _json

import numpy as np
import torch

from .. import nn  # noqa: F401  (paddle.static.nn)
from ..jit.to_static import InputSpec  # noqa: F401
from .passes import apply_pass, list_passes, prune, register_pass  # noqa: F401
from .program import (Block, Executor, Operator, Program,  # noqa: F401
                      append_backward, data, default_main_program,
                      default_startup_program, global_scope, gradients,
                      name_scope, program_guard, recording)
from .transpiler import (DistributeTranspiler,  # noqa: F401
                         DistributeTranspilerConfig, PsServerProgram)

__all__ = ["Program", "program_guard", "default_main_program",
           "default_startup_program", "data", "Executor", "global_scope",
           "name_scope", "append_backward", "gradients", "Block", "Operator",
           "InputSpec", "apply_pass", "register_pass", "list_passes", "prune",
           "DistributeTranspiler", "DistributeTranspilerConfig",
           "PsServerProgram", "save", "load", "create_parameter",
           "save_inference_model", "load_inference_model", "py_func", "nn"]

_STATIC_MODE = [False]


def _enable_static(flag=True):
    _STATIC_MODE[0] = bool(flag)


def _static_mode():
    return _STATIC_MODE[0]


def _np(t):
    """A tensor's values as numpy (bfloat16 as its uint16 bits)."""
    t = t.detach()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).cpu().numpy().view(np.uint16)
    return t.cpu().numpy()


def _set(t, value):
    src = torch.from_numpy(np.ascontiguousarray(value))
    if t.dtype == torch.bfloat16 and src.dtype == torch.int16:
        src = src.view(torch.bfloat16)
    with torch.no_grad():
        torch.Tensor.copy_(t, src.to(t.device).reshape(t.shape).to(t.dtype))


def _npz(path, arrays):
    buf = _io.BytesIO()
    np.savez(buf, **arrays)
    with open(path, "wb") as f:
        f.write(buf.getvalue())


def save(program, model_path, protocol=4):
    """The program's training state for a resume (``fluid/io.py``
    save:1840): ``{path}.pdparams`` (its parameters, buffers and
    constants), ``{path}.pdopt`` (the optimizer's slots, ``@step`` and
    ``@lr``, and its scheduler), both numpy npz, and ``{path}.pdmeta``
    (JSON: their keys), keyed by the program's slots. Slot numbers follow
    the recorder, so these files do not cross to the reference."""
    params = {str(s): _np(t) for s, t in sorted(program.params.items())}
    _npz(model_path + ".pdparams",
         {f"p{i}": v for i, v in enumerate(params.values())})
    opt_state = {}
    opt = program._optimizer
    if opt is not None:
        slot_of = {id(t): s for s, t in program.params.items()}
        for (acc, pid), t in sorted(opt._accumulators.items(),
                                    key=lambda kv: str(kv[0])):
            s = slot_of.get(pid)
            if s is not None:
                opt_state[f"{s}.{acc}"] = _np(t)
        opt_state["@step"] = _np(opt._step_count)
        opt_state["@lr"] = np.asarray(opt._lr.value(), np.float32)
        sched = opt._lr.scheduler
        if sched is not None:
            sd = sched.state_dict()
            opt_state["@sched.last_epoch"] = np.asarray(
                sd.get("last_epoch", -1))
            opt_state["@sched.last_lr"] = np.asarray(
                sd.get("last_lr", opt.get_lr()))
    _npz(model_path + ".pdopt",
         {f"o{i}": v for i, v in enumerate(opt_state.values())})
    with open(model_path + ".pdmeta", "w") as f:
        _json.dump({"params": list(params), "opt": list(opt_state),
                    "dtypes": {k: str(t.dtype) for k, t in zip(
                        params, (program.params[int(s)] for s in params))}},
                   f)


def load(program, model_path, executor=None, var_list=None):
    """Restore what :func:`save` wrote, in place (``fluid/io.py``
    load:1948): a captured program keeps reading the same tensors."""
    with open(model_path + ".pdmeta") as f:
        meta = _json.load(f)
    data_ = np.load(model_path + ".pdparams")
    for i, slot in enumerate(meta["params"]):
        t = program.params.get(int(slot))
        if t is not None:
            _set(t, data_[f"p{i}"])
    opt = program._optimizer
    if opt is None or not meta["opt"]:
        return
    odata = np.load(model_path + ".pdopt")
    id_of = {s: id(t) for s, t in program.params.items()}
    sched_state = {}
    for i, key in enumerate(meta["opt"]):
        v = odata[f"o{i}"]
        if key == "@step":
            _set(opt._step_count, v)
        elif key == "@lr":
            opt._lr.set(float(v))
        elif key.startswith("@sched."):
            sched_state[key[len("@sched."):]] = v.item()
        else:
            s, acc = key.split(".", 1)
            t = opt._accumulators.get((acc, id_of.get(int(s))))
            if t is not None:
                _set(t, v)
    if sched_state and opt._lr.scheduler is not None:
        opt._lr.scheduler.set_state_dict(sched_state)


def create_parameter(shape, dtype="float32", name=None, attr=None,
                     is_bias=False, default_initializer=None, device=None):
    """A parameter drawn by ``attr``'s initializer, else
    ``default_initializer``, else Xavier (zeros for a bias), on ``device``
    (default: the card)."""
    from ..nn import initializer as I
    from ..nn.layer.layers import ParamAttr
    from ..core.tensor import Parameter
    attr = ParamAttr._to_attr(attr)
    init = (getattr(attr, "initializer", None) or default_initializer
            or (I.Constant(0.0) if is_bias else I.XavierNormal()))
    p = Parameter(init(list(shape), dtype, device=device),
                  trainable=getattr(attr, "trainable", True))
    from ..core.tensor import _auto_name
    p.param_name = p._attr_name = (name or getattr(attr, "name", None)
                                   or _auto_name("create_parameter"))
    return p


def save_inference_model(path_prefix, feed_vars, fetch_vars, executor,
                         program=None):
    """The program pruned to ``feed_vars`` -> ``fetch_vars``, in its
    evaluation variant, as ``jit.save``'s artifact (``fluid/io.py:1246``):
    its forward replays the pruned program over the program's parameters
    and constants; a feed dimension declared ``None`` is the artifact's
    batch axis."""
    from ..jit.io import save as _jit_save
    feed_vars = list(feed_vars)
    fetch_vars = list(fetch_vars)
    prog = (program or default_main_program()).clone(for_test=True)
    prog = prune(prog, fetch_vars)
    layer = prog.as_layer(feed_vars, fetch_vars)
    specs = []
    for v in feed_vars:
        _slot, shape, dtype = prog.feed_vars[v.name]
        specs.append(InputSpec([None if s == -1 else s for s in shape],
                               dtype=dtype, name=v.name))
    _jit_save(layer, path_prefix, input_spec=specs)


def load_inference_model(path_prefix, executor):
    """``(program, feed names, fetch names)`` of :func:`save_inference_model`'s
    artifact; the program is ``jit.load``'s ``ServedLayer``, on the
    executor's device."""
    from ..jit.io import load as _jit_load
    layer = _jit_load(path_prefix, device=getattr(executor, "device", None))
    return layer, layer.input_names, layer.output_names


def py_func(func, x, out, backward_func=None, skip_vars_in_backward_input=None):
    """A host Python callback inside the computation
    (``operators/py_func_op.cc``): ``func`` gets and returns numpy arrays,
    ``out`` declares the results' shapes and dtypes (``InputSpec``s or
    template tensors), ``backward_func`` gets the inputs that are not
    skipped, the outputs and the outputs' gradients and returns one
    gradient per input. A host read: it cannot run inside a CUDA graph.
    Under ``program_guard`` it is one recorded op."""
    from ..core import dispatch
    prog = dispatch.recorder()
    if prog is not None:
        out_ = prog._record(_py_func, (func, x, out, backward_func,
                                       skip_vars_in_backward_input), {},
                            "py_func", plain_body=True)
        if out_ is not prog.NOT_RECORDED:
            return out_
    return _py_func(func, x, out, backward_func, skip_vars_in_backward_input)


def _py_func(func, x, out, backward_func, skip_vars_in_backward_input):
    from ..core.dtype import convert_dtype
    from ..core.tensor import Tensor, unwrap, wrap
    xs = list(x) if isinstance(x, (list, tuple)) else [x]
    outs = out if isinstance(out, (list, tuple)) else [out]
    single = not isinstance(out, (list, tuple))
    specs = [(tuple(o.shape), convert_dtype(o.dtype)) for o in outs]
    vals = [unwrap(v) for v in xs]
    device = next((v.device for v in vals if isinstance(v, torch.Tensor)),
                  torch.device("cpu"))

    def host(fn, arrays):
        return fn(*[a.detach().cpu().numpy() if isinstance(a, torch.Tensor)
                    else np.asarray(a) for a in arrays])

    def forward(*args):
        res = host(func, args)
        res = res if isinstance(res, (list, tuple)) else [res]
        return tuple(torch.as_tensor(np.asarray(r)).to(device, dt)
                     .reshape(shape) for r, (shape, dt) in zip(res, specs))

    diff = [i for i, v in enumerate(vals) if isinstance(v, torch.Tensor)
            and v.requires_grad]
    if backward_func is None or not diff or not torch.is_grad_enabled():
        with torch.no_grad():
            res = forward(*vals)
        res = wrap(list(res)) if any(type(v) is Tensor for v in xs) \
            else list(res)
        return res[0] if single else res
    skip = set()
    if skip_vars_in_backward_input is not None:
        sk = (skip_vars_in_backward_input
              if isinstance(skip_vars_in_backward_input, (list, tuple))
              else [skip_vars_in_backward_input])
        skip = {id(t) for t in sk}
    keep = [i for i, t in enumerate(xs) if id(t) not in skip]

    class _PyFunc(torch.autograd.Function):
        @staticmethod
        def forward(ctx, *args):
            res = forward(*args)
            ctx.save_for_backward(*args, *res)
            return res

        @staticmethod
        def backward(ctx, *cots):
            saved = ctx.saved_tensors
            ins, res = saved[:len(vals)], saved[len(vals):]
            grads = host(backward_func,
                         [ins[i] for i in keep] + list(res) + list(cots))
            grads = grads if isinstance(grads, (list, tuple)) else [grads]
            if len(grads) == len(diff) and len(diff) != len(vals):
                full = [None] * len(vals)
                for i, g in zip(diff, grads):
                    full[i] = g
                grads = full
            if len(grads) != len(vals):
                raise ValueError(
                    f"backward_func returned {len(grads)} grads for "
                    f"{len(vals)} inputs ({len(diff)} differentiable)")
            return tuple(None if g is None or i not in diff else
                         torch.as_tensor(np.asarray(g)).to(
                             ins[i].device, ins[i].dtype).reshape(
                             ins[i].shape)
                         for i, g in enumerate(grads))

    res = list(_PyFunc.apply(*vals))
    res = wrap(res) if any(type(v) is Tensor for v in xs) else res
    return res[0] if single else res
