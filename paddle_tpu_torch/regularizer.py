"""Regularizers (counterpart: ``paddle_tpu/regularizer.py``)."""


class L1Decay:
    def __init__(self, coeff=0.0):
        self.coeff = coeff


class L2Decay:
    def __init__(self, coeff=0.0):
        self.coeff = coeff
