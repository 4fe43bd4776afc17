"""layer_norm (counterpart: ``paddle_tpu/nn/functional/norm.py``)."""
import torch

from ...amp.auto_cast import cast_inputs, downcast_dtype


def layer_norm(x, normalized_shape, weight=None, bias=None, epsilon=1e-5):
    """Normalise over the trailing ``normalized_shape`` dims with the
    population variance, then scale and shift. Under ``auto_cast`` it
    computes in float32 and casts back to the AMP dtype when ``x`` or a
    parameter came in it (the reference's block and downcast lists)."""
    if isinstance(normalized_shape, int):
        normalized_shape = [normalized_shape]
    out_dtype = downcast_dtype("layer_norm", x, weight, bias)
    x, weight, bias = cast_inputs("layer_norm", x, weight, bias)
    out = torch.nn.functional.layer_norm(x, list(normalized_shape), weight,
                                         bias, epsilon)
    return out if out_dtype is None else out.to(out_dtype)
