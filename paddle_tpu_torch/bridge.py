"""Weight bridge from the reference package.

``load_reference_state(module, state)`` takes the reference model's
``state_dict`` as numpy arrays (``{name: np.asarray(t.numpy())}``), checks
that the names and shapes equal the module's own, and copies the values
onto each parameter's device and dtype. Both packages keep the same
structured names and layouts (``Linear`` weights are ``[in, out]``), so
the copy needs no transposes. This module never imports the reference.
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
