"""Custom C ops (counterpart: ``paddle_tpu/incubate/custom_op.py``; the
reference framework's `paddle/fluid/framework/custom_operator.cc:511` and
`paddle/fluid/extension/`): a user compiles a shared library against a C
ABI, and ``load_custom_op`` binds it with ctypes as a differentiable op.

The reference runs the library's functions on the host through
``jax.pure_callback``; the port runs them on the host too: the op (a
``torch.autograd.Function``) copies its input to the host as float32,
calls ``<name>_forward`` and copies the result back to the input's
device. The backward calls ``<name>_backward``, or raises the reference's
``NotImplementedError`` when the library exports none. A host call cannot
be recorded into a CUDA graph, so under a capture the op raises by name
(the reference's op also runs under ``jit``).

C ABI (v1: elementwise, float32, shape-preserving)::

    // y[i] = f(x[i]); n = element count
    void <name>_forward(const float* x, float* y, int64_t n);
    // optional: grad_x[i] = df(x[i]) * grad_y[i]
    void <name>_backward(const float* x, const float* gy, float* gx,
                         int64_t n);

Build (plain C symbols, no framework headers)::

    g++ -O2 -fPIC -shared my_op.cc -o my_op.so

Load::

    op = paddle_tpu_torch.incubate.load_custom_op("./my_op.so", "my_relu")
    y = op(x)   # differentiable if my_relu_backward is exported
"""
import ctypes

import numpy as np
import torch

from ..core.dispatch import call_op
from ..core.enforce import NotFoundError, enforce_not_none

__all__ = ["load_custom_op"]

_FP = ctypes.POINTER(ctypes.c_float)


def _bind(lib, sym):
    try:
        fn = getattr(lib, sym)
    except AttributeError:
        return None
    fn.restype = None
    return fn


def _host_f32(t):
    return np.ascontiguousarray(t.detach().to("cpu", torch.float32).numpy())


def _no_capture(name):
    if torch.cuda.is_available() and torch.cuda.is_current_stream_capturing():
        raise RuntimeError(
            f"custom op {name!r} runs its C function on the host and cannot "
            "be recorded into a CUDA graph; call it outside the capture")


def load_custom_op(so_path, name):
    """dlopen ``so_path``, bind ``<name>_forward`` (and ``<name>_backward``
    where exported) and return a differentiable op."""
    lib = ctypes.CDLL(so_path)
    fwd = enforce_not_none(
        _bind(lib, f"{name}_forward"),
        f"custom op library {so_path!r} does not export "
        f"'{name}_forward(const float*, float*, int64_t)'",
        NotFoundError)
    bwd = _bind(lib, f"{name}_backward")

    class _Op(torch.autograd.Function):
        @staticmethod
        def forward(ctx, v):
            _no_capture(name)
            x = _host_f32(v)
            y = np.empty_like(x)
            fwd(x.ctypes.data_as(_FP), y.ctypes.data_as(_FP),
                ctypes.c_int64(x.size))
            ctx.save_for_backward(v)
            return torch.from_numpy(y).to(v.device)

        @staticmethod
        def backward(ctx, g):
            if bwd is None:
                raise NotImplementedError(
                    f"custom op {name!r}: no '{name}_backward' symbol "
                    "exported")
            _no_capture(name)
            (v,) = ctx.saved_tensors
            x, gy = _host_f32(v), _host_f32(g)
            gx = np.empty_like(x)
            bwd(x.ctypes.data_as(_FP), gy.ctypes.data_as(_FP),
                gx.ctypes.data_as(_FP), ctypes.c_int64(x.size))
            return torch.from_numpy(gx).to(device=v.device, dtype=v.dtype)

    def custom(x):
        return call_op(_Op.apply, x, op_name=f"custom_{name}")

    custom.__name__ = f"custom_{name}"
    custom.has_backward = bwd is not None
    return custom
