"""Weight and optimizer-state bridge from the reference package.

``load_reference_state(module, state)`` takes the reference model's
``state_dict`` as numpy arrays (``{name: np.asarray(t.numpy())}``), checks
that the names and shapes equal the module's own, and copies the values
onto each parameter's device and dtype. Both packages keep the same
structured names and layouts (``Linear`` weights are ``[in, out]``), so
the copy needs no transposes.

``load_reference_optimizer_state(optimizer, state, names)`` does the same
for an optimizer: the reference keys its state by its own parameter names
(``"<p.name>.moment1"``, ``.moment2``, ``.master``, ``@step``, ``@lr``);
``names`` maps those to structured names, which key the port's state.
``optimizer_state_numpy`` gives the port's state back as numpy arrays.
This module never imports the reference.
"""
import numpy as np
import torch


def load_reference_state(module, state):
    """Copy ``state`` ({name: numpy array}) into ``module``'s parameters
    and buffers; raises ``ValueError`` on any missing or extra name or any
    shape mismatch, before anything is copied."""
    own = module.state_dict(keep_vars=True)
    missing = sorted(set(own) - set(state))
    extra = sorted(set(state) - set(own))
    if missing or extra:
        raise ValueError(f"state names differ: missing {missing}, "
                         f"unexpected {extra}")
    bad = [(n, tuple(np.shape(state[n])), tuple(t.shape))
           for n, t in own.items() if tuple(np.shape(state[n])) != tuple(t.shape)]
    if bad:
        raise ValueError("shape mismatch (name, given, expected): "
                         + ", ".join(map(str, bad)))
    with torch.no_grad():
        for name, t in own.items():
            t.copy_(torch.from_numpy(np.array(state[name], copy=True)))
    return module


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
