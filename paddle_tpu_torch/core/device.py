"""The device rule (counterpart of ``paddle_tpu/core/device.py``).

Every entry point runs on ``cuda`` unless its caller passes
``device="cpu"``. With no GPU present and no explicit CPU request the
entry point raises: nothing drifts onto the CPU by itself.
"""
import torch


def resolve_device(device=None):
    """``None`` -> the current CUDA device (raises without one); an explicit
    ``"cpu"``/``"cuda[:i]"``/``torch.device`` is taken as given, and a CUDA
    request without a GPU raises."""
    if device is None:
        device = "cuda"
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run on "
                "the CPU")
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
    elif device.type != "cpu":
        raise ValueError(f"unsupported device {device!s}; use 'cuda' or "
                         "'cpu'")
    return device
