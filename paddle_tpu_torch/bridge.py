"""Weight and optimizer-state bridge from the reference package.

``load_reference_state(module, state)`` takes the reference model's
``state_dict`` as numpy arrays (``{name: np.asarray(t.numpy())}``), checks
that the names and shapes equal the module's own, and copies the values
onto each parameter's device and dtype. Both packages keep the same
structured names and layouts (``Linear`` weights are ``[in, out]``), so
the copy needs no transposes. Under tensor parallelism a sliced parameter
(``split_axis`` set, see ``fleet.meta_parallel.mp_layers``) takes its
rank's slice of the full array: a fused QKV's columns are ordered (q|k|v,
heads, head_dim), so each rank takes whole heads of each of q, k and v (a
re-layout, not the reference's contiguous thirds of the columns);
``full_state_dict`` gathers the slices back into the reference's full
layout (``gather_full``: one tensor, in its own dtype, which step
checkpoints save). A ``PipelineLayer`` takes the names of the stage it
holds and skips the other stages'. Wrappers (``DataParallel``, ``TensorParallel``,
...) load into the layer they wrap.

``load_reference_optimizer_state(optimizer, state, names)`` does the same
for an optimizer: the reference keys its state by its own parameter names
(``"<p.name>.moment1"``, ``.moment2``, ``.master``, ``@step``, ``@lr``);
``names`` maps those to structured names, which key the port's state.
``optimizer_state_numpy`` gives the port's state back as numpy arrays.
This module never imports the reference.
"""
import numpy as np
import torch


def _inner(module):
    from .distributed.parallel import _LayerWrapper
    while isinstance(module, _LayerWrapper):
        module = module._layers
    return module


def _sliced(t):
    from .distributed.fleet.meta_parallel.mp_layers import is_sliced
    return is_sliced(t)


def _split_view(shape, t):
    """``shape`` with the split dim viewed as (groups, degree, chunk)."""
    ax, g, n = t.split_axis, t.split_groups, t.split_degree
    return (*shape[:ax], g, n, shape[ax] // (g * n), *shape[ax + 1:])


def local_slice(full, t):
    """This rank's slice of the full array ``full`` for the sliced
    parameter ``t``."""
    full = np.asarray(full)
    if not _sliced(t):
        return full
    ax = t.split_axis
    v = full.reshape(_split_view(full.shape, t))
    v = np.take(v, t.split_rank, axis=ax + 1)
    return v.reshape(tuple(t.shape))


def _full_shape(t):
    shape = list(t.shape)
    if _sliced(t):
        shape[t.split_axis] *= t.split_degree
    return tuple(shape)


def load_reference_state(module, state):
    """Copy ``state`` ({name: numpy array}) into ``module``'s parameters
    and buffers, each sliced parameter its rank's slice; raises
    ``ValueError`` on any missing or extra name or any shape mismatch,
    before anything is copied. A ``PipelineLayer`` skips the names of the
    stages it does not hold."""
    module = _inner(module)
    own = module.state_dict(keep_vars=True)
    missing = sorted(set(own) - set(state))
    extra = sorted(set(state) - set(own))
    other_stage = getattr(module, "other_stage", None)
    if other_stage is not None:
        extra = [n for n in extra if not other_stage(n)]
    if missing or extra:
        raise ValueError(f"state names differ: missing {missing}, "
                         f"unexpected {extra}")
    bad = [(n, tuple(np.shape(state[n])), _full_shape(t))
           for n, t in own.items()
           if tuple(np.shape(state[n])) != _full_shape(t)]
    if bad:
        raise ValueError("shape mismatch (name, given, expected): "
                         + ", ".join(map(str, bad)))
    with torch.no_grad():
        for name, t in own.items():
            t.copy_(torch.from_numpy(np.array(local_slice(state[name], t),
                                              copy=True)))
    return module


def gather_full(t, like=None, group=None):
    """The full layout of ``t``, this rank's slice of the sliced parameter
    ``like`` (default ``t``; an optimizer slot passes its parameter),
    gathered from the mp group (``group``, default the fleet topology's)
    and laid back, in ``t``'s dtype, bit for bit (a 16-bit float is
    gathered widened to float32, exact both ways). ``t`` itself where
    ``like`` is not split. Every rank of the group calls it."""
    from .distributed import collective
    from .distributed.fleet.meta_parallel.mp_layers import \
        model_parallel_group
    like = t if like is None else like
    if not _sliced(like) or like.split_degree == 1:
        return t
    x = t.detach()
    wide = x.float() if x.dtype in (torch.bfloat16, torch.float16) else x
    parts = []
    collective.all_gather(parts, wide.contiguous(),
                          group=group or model_parallel_group())
    # [n, *local] -> the split dim as (groups, n, chunk) -> full
    ax, g, n = like.split_axis, like.split_groups, like.split_degree
    shape = list(x.shape)
    v = torch.stack(parts).reshape(n, *shape[:ax], g, shape[ax] // g,
                                   *shape[ax + 1:])
    return v.movedim(0, ax + 1).reshape(_full_shape(like)).to(x.dtype)


def full_state_dict(module, group=None):
    """``module``'s state in the reference's full layout ({name: numpy
    array}, bfloat16 widened to float32): each sliced parameter gathered
    from the mp group (``group``, default the fleet topology's) and laid
    back. Every rank of the group calls it."""
    out = {}
    for name, p in _inner(module).state_dict(keep_vars=True).items():
        t = gather_full(p.detach(), p, group)
        if t.dtype == torch.bfloat16:
            t = t.float()  # numpy has no bfloat16
        out[name] = t.cpu().numpy().copy()
    return out


_META = ("@step", "@lr", "LR_Scheduler")


def optimizer_state_numpy(optimizer):
    """The optimizer's ``state_dict`` with every tensor as a numpy array
    (keys ``"<structured name>.<slot>"``, ``@step``, ``@lr``)."""
    return {k: (v.detach().cpu().numpy() if isinstance(v, torch.Tensor)
                else v) for k, v in optimizer.state_dict().items()}


def load_reference_optimizer_state(optimizer, state, names):
    """Copy a reference optimizer's ``state`` (its ``state_dict`` as numpy,
    keyed ``"<reference name>.<slot>"``) into ``optimizer``, renaming each
    parameter by ``names`` ({reference name: structured name}). Raises
    ``ValueError`` before anything is copied if a slot is missing on either
    side or a shape differs."""
    renamed = {}
    for key, value in state.items():
        if key in _META:
            renamed[key] = value
            continue
        ref_name, slot = key.rsplit(".", 1)
        if ref_name not in names:
            raise ValueError(f"no structured name for reference parameter "
                             f"{ref_name!r}")
        renamed[f"{names[ref_name]}.{slot}"] = value
    own = {k: v for k, v in optimizer.state_dict().items() if k not in _META}
    theirs = {k for k in renamed if k not in _META}
    missing, extra = sorted(set(own) - theirs), sorted(theirs - set(own))
    if missing or extra:
        raise ValueError(f"optimizer slots differ: missing {missing}, "
                         f"unexpected {extra}")
    bad = [(k, tuple(np.shape(renamed[k])), tuple(t.shape))
           for k, t in own.items()
           if tuple(np.shape(renamed[k])) != tuple(t.shape)]
    if bad:
        raise ValueError("shape mismatch (slot, given, expected): "
                         + ", ".join(map(str, bad)))
    optimizer.set_state_dict(renamed)
    return optimizer
