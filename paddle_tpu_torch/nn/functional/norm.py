"""layer_norm (counterpart: ``paddle_tpu/nn/functional/norm.py``)."""
import torch


def layer_norm(x, normalized_shape, weight=None, bias=None, epsilon=1e-5):
    """Normalise over the trailing ``normalized_shape`` dims with the
    population variance, then scale and shift."""
    if isinstance(normalized_shape, int):
        normalized_shape = [normalized_shape]
    return torch.nn.functional.layer_norm(x, list(normalized_shape), weight,
                                          bias, epsilon)
