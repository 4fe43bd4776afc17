"""The registry of stateful tensors (counterpart:
``paddle_tpu/core/state.py``, the reference's Scope of persistable
variables).

Every ``Parameter`` registers here when it is made, held weakly: an entry
leaves when its tensor is collected. The reference's ``to_static``
threads the registry through its compiled step; the port's programs
update state in place and need no threading, so nothing in the port reads
the registry yet: it is the list of live state that a walker of it (item
16's memory ledger) will read.
"""
import weakref

_registry = {}  # uid -> weakref to Tensor
_next_uid = 0


def register(tensor):
    global _next_uid
    uid = _next_uid
    _next_uid += 1
    _registry[uid] = weakref.ref(
        tensor, lambda _ref, _uid=uid: _registry.pop(_uid, None))
    return uid


def unregister(uid):
    _registry.pop(uid, None)


def snapshot():
    """Sorted list of (uid, Tensor) for all live stateful tensors."""
    out = []
    for uid, ref in sorted(_registry.items()):
        t = ref()
        if t is not None:
            out.append((uid, t))
    return out
