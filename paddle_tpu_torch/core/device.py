"""The device rule and the places (counterpart of
``paddle_tpu/core/device.py``).

Every entry point runs on ``cuda`` unless its caller passes
``device="cpu"``, or :func:`set_device` chose the CPU. With no GPU present
and no request for the CPU the entry point raises: nothing drifts onto the
CPU by itself.

The reference's accelerator is the TPU; the port's is the card. So
``"tpu[:i]"``, ``"gpu[:i]"`` and ``"cuda[:i]"`` all name ``cuda:i``,
``TPUPlace(i)`` names ``cuda:i`` and ``is_compiled_with_tpu()`` answers
whether the card is there (ROADMAP §3, deliberate differences).
"""
import torch

_ACCELERATOR = ("tpu", "gpu", "cuda")


class Place:
    def __init__(self, kind: str, device_id: int = 0):
        self.kind = kind
        self.device_id = device_id

    def __repr__(self):
        return f"Place({self.kind}:{self.device_id})"

    def __eq__(self, other):
        return (isinstance(other, Place) and self.kind == other.kind
                and self.device_id == other.device_id)

    def is_tpu_place(self):
        return self.kind in _ACCELERATOR

    def is_cpu_place(self):
        return self.kind == "cpu"


def TPUPlace(device_id=0):
    """The card ``device_id`` (``cuda:device_id``)."""
    return Place("tpu", device_id)


def CPUPlace():
    return Place("cpu", 0)


_current = None  # the Place set_device chose; None: the card


def _torch_device(kind, index):
    if kind == "cpu":
        return torch.device("cpu")
    if kind in _ACCELERATOR:
        return torch.device("cuda", index)
    raise ValueError(f"unsupported device {kind!r}; use 'tpu', 'gpu', "
                     "'cuda' or 'cpu' (with ':<index>')")


def _parse(device):
    kind, _, idx = str(device).partition(":")
    return Place(kind, int(idx) if idx else 0)


def set_device(device):
    """Make ``device`` what :func:`resolve_device` gives for ``None``:
    ``"cpu"``, or the card as ``"tpu[:i]"``, ``"gpu[:i]"`` or
    ``"cuda[:i]"`` (which raise without a GPU). Returns its ``Place``."""
    global _current
    place = _parse(device)
    resolve_device(_torch_device(place.kind, place.device_id))  # validates
    _current = place
    return _current


def get_device():
    """``"<kind>:<index>"`` of the current device: what :func:`set_device`
    chose, else the card (``"gpu:0"``), or ``"cpu:0"`` without one."""
    p = _current
    if p is None:
        p = Place("gpu" if torch.cuda.is_available() else "cpu", 0)
    return f"{p.kind}:{p.device_id}"


def is_compiled_with_tpu():
    """Whether the accelerator (the card) is present."""
    return torch.cuda.is_available()


def device_count():
    """The number of cards."""
    return torch.cuda.device_count()


def resolve_device(device=None):
    """``None`` -> the device :func:`set_device` chose, else the current
    CUDA device (raises without one); an explicit ``"cpu"``,
    ``"cuda[:i]"``/``"gpu[:i]"``/``"tpu[:i]"``, ``Place`` or
    ``torch.device`` is taken as given, and a card request without a GPU
    raises."""
    if device is None:
        device = ("cuda" if _current is None
                  else _torch_device(_current.kind, _current.device_id))
    if isinstance(device, Place):
        device = _torch_device(device.kind, device.device_id)
    elif isinstance(device, str) and device.partition(":")[0] in ("tpu",
                                                                   "gpu"):
        p = _parse(device)
        device = _torch_device(p.kind, p.device_id)
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
