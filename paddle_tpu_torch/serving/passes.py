"""Load-time serving passes (counterpart: ``paddle_tpu/serving/passes.py``).

The reference rewrites a recorded program; the port runs the module
eagerly, so its passes act on the module the engine serves:

- ``"bf16"``: the served module is a bfloat16 copy of the engine's
  snapshot of the live model (the live model is left untouched), float32
  feeds are cast to bfloat16 on the way in, integer feeds (token ids)
  pass through, and floating outputs are cast back to the declared dtype
  at the engine boundary.
- ``"donate"``: accepted for parity with the reference, where it donates
  input buffers to XLA. Here it is a no-op: each batch's feeds are fresh
  device tensors that nothing else holds, and they are freed after the
  step anyway.
"""
import torch

__all__ = ["SERVING_PASSES", "validate_passes", "apply_passes", "cast_feed"]

SERVING_PASSES = ("bf16", "donate")


def validate_passes(passes):
    unknown = [n for n in passes if n not in SERVING_PASSES]
    if unknown:
        raise ValueError(
            f"unknown serving pass(es) {unknown}; known: "
            f"{sorted(SERVING_PASSES)}")


def apply_passes(module, passes):
    """Apply the module-rewriting passes to ``module`` (the engine's own
    snapshot, so the rewrite is in place) and return it."""
    if "bf16" in passes:
        module.to(torch.bfloat16)
    return module


def cast_feed(x, passes):
    """The bf16 pass's compute cast: float32 feeds -> bfloat16."""
    if "bf16" in passes and x.dtype == torch.float32:
        return x.to(torch.bfloat16)
    return x
