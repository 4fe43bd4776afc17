"""The port's engine under load: admission control sheds the excess with
``OverloadedError`` and a request whose deadline lapses in the queue
resolves with ``DeadlineExceeded`` without a device step (the reference
engine's contract, ``paddle_tpu/serving/engine.py``)."""
import threading
import time

import numpy as np
import pytest
import torch

from paddle_tpu_torch import nn, serving


class _Gated(nn.Layer):
    """A Linear whose forward waits for ``gate`` (set = run freely)."""

    def __init__(self):
        super().__init__()
        self.fc = nn.Linear(4, 2, device="cpu")
        self.gate = threading.Event()
        self.gate.set()
        self.entered = threading.Event()

    def forward(self, x):
        self.entered.set()
        assert self.gate.wait(timeout=30)
        return self.fc(x)

    def __deepcopy__(self, memo):  # the engine snapshots the live model
        return self


def test_engine_sheds_and_expires():
    torch.set_num_threads(2)
    model = _Gated()
    x = np.ones((1, 4), "float32")
    eng = serving.Engine.from_layer(model, [([None, 4], "float32")],
                                    bucket_ladder=(1,), max_pending=1,
                                    batch_timeout_ms=0.0, device="cpu")
    try:
        model.gate.clear()
        model.entered.clear()
        busy = eng.submit(x)                    # occupies the device step
        assert model.entered.wait(timeout=30)
        late = eng.submit(x, deadline_ms=200.0) # queued, will expire
        with pytest.raises(serving.OverloadedError):
            eng.submit(x)                       # queue full: shed
        time.sleep(0.5)                         # past late's deadline
        model.gate.set()
        assert busy.result(timeout=30)[0].shape == (1, 2)
        with pytest.raises(serving.DeadlineExceeded):
            late.result(timeout=30)
        stats = eng.stats()
    finally:
        model.gate.set()
        eng.close()
    assert stats["shed"] == 1 and stats["deadline_expired"] == 1
    assert stats["requests"] == 1 and stats["batches"] == 1
