"""Conditional nodes inside a captured CUDA graph: IF and WHILE
(``csrc/graph_while.cu``; counterpart: ``lax.cond``/``lax.switch`` and
``lax.while_loop`` in ``paddle_tpu/nn/control_flow.py``).

Both run under ``torch.cuda.graph``. :func:`if_body` adds an IF node on
the capturing stream and captures its block into the node's body;
:func:`while_node` adds a WHILE node and captures one loop iteration into
its body, whose last act recomputes the predicate in place (the kernel
that sets the node's condition from it ends the body). A replay then
takes the branch, or runs as many iterations as the data asks, with no
host round trip.

A body is captured from a second stream straight into the node's body
graph, so it is not part of the graph's own capture and torch's allocator
would not serve it from the graph's pool: within a body this thread's
allocations come from a private pool (``torch.cuda.MemPool``), one a
body, that the parent ``torch.cuda.CUDAGraph`` keeps and drops with
itself, so no block a captured body reads is handed to anyone else while
the graph lives. A capture that may hold conditional nodes therefore
names its graph: ``with torch.cuda.graph(g), graph_while.bodies_of(g):``.
(torch's own ``begin_capture_to_if_node`` serves its IF bodies from the
graph's pool, but the card's torch has none.)

Counts: :data:`nodes` holds the conditional nodes added to captured
graphs, by kind; :func:`launch_counts` reads how many times the card ran
the kernel that sets a node's condition (once upstream of each node a
replay reaches, and for WHILE once more after every iteration), counted
by the kernel itself.

There is no plain version on the CPU: control flow over CPU tensors is
Python (``nn.control_flow``). Without conditional nodes (a driver or
runtime before CUDA 12.4) these raise; a loop never runs as a host loop
in the capture's place.
"""
import contextlib
import ctypes

import torch

from . import _build

__all__ = ["while_node", "if_body", "bodies_of", "supported", "nodes",
           "launch_counts", "reset_launch_counts"]

_PTR = ctypes.c_void_p
_IF, _WHILE = 0, 1
nodes = {"while": 0, "if": 0}  # conditional nodes added to captured graphs
# capturing stream (its handle) -> the CUDAGraph that keeps the pools of
# the bodies captured from it; a body's own stream is entered while it is
# captured, so a node inside a body finds the same graph
_OWNERS = {}


def _counts(reset, device):
    lib = _lib()
    out = (ctypes.c_ulonglong * 2)()
    with torch.cuda.device(device):
        _check(lib, lib.graph_while_launch_counts(out, int(reset)),
               "reading the launch counts")
    return {"if": int(out[0]), "while": int(out[1])}


def launch_counts(device=None):
    """{"if": n, "while": n}: the set-condition kernel's runs on ``device``
    since the last reset (synchronous; outside a capture)."""
    return _counts(False, device)


def reset_launch_counts(device=None):
    """Set :data:`nodes` and ``device``'s launch counts to 0."""
    nodes["while"] = nodes["if"] = 0
    _counts(True, device)


@contextlib.contextmanager
def bodies_of(graph):
    """Inside ``torch.cuda.graph(graph)``: the conditional nodes captured
    in the block keep their bodies' memory on ``graph``, released when the
    graph is."""
    key = torch.cuda.current_stream().cuda_stream
    if not torch.cuda.is_current_stream_capturing():
        raise RuntimeError("bodies_of(graph) goes inside the graph's capture")
    _OWNERS[key] = graph
    try:
        yield
    finally:
        del _OWNERS[key]


def _lib():
    lib = _build.load("graph_while")
    if not getattr(lib, "_bound", False):
        lib.graph_while_error_string.argtypes = [ctypes.c_int]
        lib.graph_while_error_string.restype = ctypes.c_char_p
        lib.graph_while_versions.argtypes = [ctypes.POINTER(ctypes.c_int)] * 2
        lib.graph_while_launch_counts.argtypes = [
            ctypes.POINTER(ctypes.c_ulonglong), ctypes.c_int]
        lib.graph_cond_begin.argtypes = [
            _PTR, _PTR, ctypes.c_int, ctypes.POINTER(_PTR),
            ctypes.POINTER(ctypes.c_ulonglong)]
        lib.graph_cond_capture_body.argtypes = [_PTR, _PTR]
        lib.graph_cond_end_body.argtypes = [_PTR, ctypes.c_ulonglong, _PTR]
        for fn in (lib.graph_while_versions, lib.graph_while_launch_counts,
                   lib.graph_cond_begin, lib.graph_cond_capture_body,
                   lib.graph_cond_end_body):
            fn.restype = ctypes.c_int
        lib._bound = True
    return lib


def _check(lib, code, what):
    if code:
        raise RuntimeError(f"graph_while: {what} failed: "
                           f"{lib.graph_while_error_string(code).decode()}")


def versions():
    """(driver, runtime) CUDA versions as ints (12040 is 12.4)."""
    lib = _lib()
    d, r = ctypes.c_int(), ctypes.c_int()
    _check(lib, lib.graph_while_versions(ctypes.byref(d), ctypes.byref(r)),
           "cudaDriverGetVersion")
    return d.value, r.value


def supported():
    """Whether this driver and runtime can add conditional nodes."""
    return min(versions()) >= 12040


@contextlib.contextmanager
def _body(pred, kind):
    if not (pred.is_cuda and pred.dim() == 0 and pred.dtype == torch.bool):
        raise ValueError("a conditional node's predicate must be a 0-d bool "
                         "CUDA tensor")
    if not torch.cuda.is_current_stream_capturing():
        raise RuntimeError("conditional nodes are added to a graph under "
                           "capture; outside one, branch or loop on the host")
    if not supported():
        d, r = versions()
        raise RuntimeError(
            f"conditional nodes need CUDA >= 12.4; this driver is {d}, the "
            f"runtime {r}. Control flow over a device predicate cannot be "
            f"captured here (a bounded while_loop can: maximum_trip_count)")
    device = pred.device
    parent = torch.cuda.current_stream(device)
    owner = _OWNERS.get(parent.cuda_stream)
    if owner is None:
        raise RuntimeError(
            "a conditional node's body needs memory that lives as long as "
            "its graph: capture with `with torch.cuda.graph(g), "
            "graph_while.bodies_of(g):` (jit.to_static and the serving "
            "engine do)")
    lib = _lib()
    body_graph, handle = _PTR(), ctypes.c_ulonglong()
    _check(lib, lib.graph_cond_begin(
        _PTR(parent.cuda_stream), _PTR(pred.data_ptr()), kind,
        ctypes.byref(body_graph), ctypes.byref(handle)), "adding the node")
    nodes["while" if kind == _WHILE else "if"] += 1
    child = torch.cuda.Stream(device)
    _check(lib, lib.graph_cond_capture_body(_PTR(child.cuda_stream),
                                            body_graph),
           "capturing the body")
    pool = torch.cuda.MemPool()
    owner.__dict__.setdefault("_conditional_body_pools", []).append(pool)
    _OWNERS[child.cuda_stream] = owner
    try:
        with torch.cuda.stream(child), torch.cuda.use_mem_pool(pool, device):
            yield
    finally:
        del _OWNERS[child.cuda_stream]
        _check(lib, lib.graph_cond_end_body(
            _PTR(child.cuda_stream), handle,
            _PTR(pred.data_ptr() if kind == _WHILE else None)),
            "ending the body")


@contextlib.contextmanager
def if_body(pred):
    """Capture the block into an IF node of the graph being captured: at
    replay it runs only where the 0-d bool ``pred`` holds."""
    with _body(pred, _IF):
        yield


def while_node(pred, body):
    """Under a capture: ``while pred: body()``, as one WHILE node of the
    capturing graph. ``pred`` is a 0-d bool tensor on the card holding the
    loop's first predicate; ``body()`` runs one iteration, updating the
    loop's state in place, and recomputes ``pred`` in place."""
    with _body(pred, _WHILE):
        body()
