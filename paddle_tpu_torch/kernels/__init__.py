"""Hand-written Hopper kernels (counterpart: ``paddle_tpu/kernels``).

Each kernel has a CUDA source under ``csrc/``, built with ``nvcc`` at
first use (``_build``), a Python wrapper that checks its inputs and counts
its launches, and a plain PyTorch version of the same function that CPU
tensors take. ``graph_while`` is the exception: CUDA-graph IF and WHILE
conditional nodes for control flow under a capture, with no CPU version
(control flow on the CPU is Python).
"""
