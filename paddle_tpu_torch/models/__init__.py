"""Models (counterpart: ``paddle_tpu/models``)."""
