"""Layer classes (counterpart: ``paddle_tpu/nn/layer``)."""
