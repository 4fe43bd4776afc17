"""Test harnesses shipped with the package (counterpart:
``paddle_tpu/testing``): ``faults``, the deterministic fault injection
that the checkpoint writers' and the pod's kill points fire;
``virtual_pod``, N real localhost rank processes under a supervising
parent; ``pod_fixture``, the data-parallel training rank the virtual pod
runs."""
from . import faults  # noqa: F401
from . import virtual_pod  # noqa: F401
from .virtual_pod import VirtualPod  # noqa: F401

__all__ = ["faults", "virtual_pod", "VirtualPod"]
