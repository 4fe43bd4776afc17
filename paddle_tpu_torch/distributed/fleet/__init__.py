"""Fleet utilities (counterpart: ``paddle_tpu/distributed/fleet``): the
filesystem abstraction the checkpoint core writes through
(``utils.fs.LocalFS``)."""
from . import utils  # noqa: F401

__all__ = ["utils"]
