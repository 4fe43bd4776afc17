"""auto_cast: op-level autocast to bf16 (counterpart:
``paddle_tpu/amp/auto_cast.py``).

The reference's seam is ``dispatch.call_op``, which consults the active
state before every op. The port has no dispatcher: its own functionals on
the training path (``linear``, ``matmul``, ``embedding``, ``layer_norm``,
``scaled_dot_product_attention``, ``cross_entropy``) call
:func:`cast_inputs` and :func:`downcast_dtype` with their op name. The lists
are the reference's. ``torch.autocast`` is not used: its lists differ (it
runs ``layer_norm`` in float32 and returns float32, so the residual stream
would leave bf16 after the first norm, where the reference casts back).
"""
import threading
from contextlib import contextmanager

import torch

from ..core.dtype import convert_dtype

white_list = {
    "matmul", "mm", "bmm", "linear", "conv1d", "conv2d", "conv3d",
    "conv1d_transpose", "conv2d_transpose", "conv3d_transpose", "einsum",
    "flash_attention", "scaled_dot_product_attention", "addmm", "dot",
    # embedding seeds the residual stream: an fp32 lookup would keep every
    # downstream add/norm in fp32
    "embedding",
}
black_list = {
    "softmax", "log_softmax", "bce", "bce_with_logits",
    "layer_norm", "batch_norm", "group_norm", "instance_norm", "rms_norm",
    "sum", "mean", "logsumexp", "norm", "exp", "log", "mse_loss", "l1_loss",
    "kl_div", "cumsum",
}
# Ops that compute in fp32 (inputs promoted, above) but whose output
# re-enters the low-precision stream when a low-precision input reached
# them; autograd casts their gradients back symmetrically.
downcast_out_list = {
    "layer_norm", "batch_norm", "group_norm", "instance_norm", "rms_norm",
    "softmax", "log_softmax", "sequence_softmax",
}


class _AmpState(threading.local):
    def __init__(self):
        self.enabled = False
        self.dtype = torch.bfloat16
        self.level = "O1"
        self.custom_white = set()
        self.custom_black = set()


_state = _AmpState()


def get_amp_state():
    return _state


def _cast(t, src, dst):
    if isinstance(t, torch.Tensor) and t.dtype == src:
        return t.to(dst)
    return t


def cast_inputs(op_name, *tensors):
    """The op's inputs as the active state wants them: allow-listed ops
    (and every op at level O2) get their float32 inputs in the AMP dtype,
    block-listed ops their AMP-dtype inputs in float32; anything else (ints,
    ``None``, other dtypes) passes through."""
    if not _state.enabled:
        return tensors
    if op_name in _state.custom_black or op_name in black_list:
        return tuple(_cast(t, _state.dtype, torch.float32) for t in tensors)
    if (op_name in _state.custom_white or op_name in white_list
            or _state.level == "O2"):
        return tuple(_cast(t, torch.float32, _state.dtype) for t in tensors)
    return tensors


def downcast_dtype(op_name, *tensors):
    """The dtype the op's output goes back to, or None: AMP on, the op in
    ``downcast_out_list`` and one of its (uncast) inputs in the AMP
    dtype."""
    if not _state.enabled or op_name not in downcast_out_list:
        return None
    for t in tensors:
        if isinstance(t, torch.Tensor) and t.dtype == _state.dtype:
            return _state.dtype
    return None


@contextmanager
def auto_cast(enable=True, custom_white_list=None, custom_black_list=None,
              level="O1", dtype="bfloat16"):
    prev = (_state.enabled, _state.dtype, _state.level, _state.custom_white,
            _state.custom_black)
    _state.enabled = enable
    _state.dtype = convert_dtype(dtype)
    _state.level = level
    _state.custom_white = set(custom_white_list or ())
    _state.custom_black = set(custom_black_list or ())
    try:
        yield
    finally:
        (_state.enabled, _state.dtype, _state.level, _state.custom_white,
         _state.custom_black) = prev
