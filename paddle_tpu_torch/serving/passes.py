"""Load-time serving passes (counterpart: ``paddle_tpu/serving/passes.py``).

On a live layer (``Engine.from_layer``) the passes act on the module the
engine serves:

- ``"bf16"``: the served module is a bfloat16 copy of the engine's
  snapshot of the live model (the live model is left untouched), float32
  feeds are cast to bfloat16 on the way in, integer feeds (token ids)
  pass through, and floating outputs are cast back to the declared dtype
  at the engine boundary.
- ``"donate"``: accepted for parity with the reference, where it donates
  input buffers to XLA. Here it is a no-op: each batch's feeds are copied
  into buffers that the engine owns.

On an exported artifact (``Engine(path)``) the program's dtypes are
frozen, so only structural passes apply: :func:`prune_outputs` (the
engine's ``outputs=``) drops the unfetched outputs from the exported graph
and eliminates the code that only they needed, as XLA's dead-code
elimination does for the reference; ``"bf16"`` raises with the
reference's guidance (:func:`check_artifact_passes`).

On a recorded ``static.Program`` (``Engine.from_program``) the pipeline
rewrites the program at load, as the reference's does
(:func:`build_serving_program`): its evaluation clone, pruned to the
served fetches, then :func:`serving_bf16_cast_pass` for ``"bf16"``.
The reference's structural verification of each stage reads
``analysis``, which is not ported (ROADMAP item 18).
"""
import torch
import torch.utils._pytree as pytree

__all__ = ["SERVING_PASSES", "validate_passes", "apply_passes", "cast_feed",
           "check_artifact_passes", "prune_outputs", "serving_bf16_cast_pass",
           "build_serving_program"]

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


def check_artifact_passes(passes):
    """The passes an exported artifact takes: the mixed-precision rewrite
    runs on the model before export (as in the reference), never on the
    serialized program."""
    if "bf16" in passes:
        raise ValueError(
            "the bf16 pass cannot rewrite a serialized torch.export "
            "artifact (dtypes are baked into the exported program); serve "
            "via Engine.from_layer, or re-export the model with bf16 "
            "weights")


def prune_outputs(module, keep):
    """Keep only the outputs at indices ``keep`` of ``module`` (an
    exported program's ``module()``, whose graph returns a flat tuple) and
    drop every node that no kept output needs. Rewrites ``module`` in
    place; returns its node counts (before, after)."""
    graph = module.graph
    before = len(graph.nodes)
    out = next(n for n in reversed(graph.nodes) if n.op == "output")
    flat = out.args[0]
    out.args = (tuple(flat[i] for i in keep),)
    codegen = graph._codegen
    codegen.pytree_info = codegen.pytree_info._replace(
        out_spec=pytree.tree_structure(tuple(range(len(keep)))))
    graph.eliminate_dead_code()
    module.recompile()
    return before, len(graph.nodes)


def _cast_bf16(v):
    return v.to(torch.bfloat16)


def serving_bf16_cast_pass(prog):
    """A new Program with bfloat16 weights and compute: every float32
    parameter, buffer or constant becomes a bfloat16 copy (the live
    model's tensors stay as they are), and every float32 feed goes
    through a ``cast`` op put first, whose output replaces the feed in
    every op after it. Integer feeds pass through; outputs stay bfloat16
    (the engine casts them back at its boundary)."""
    from ..static.program import _OpRecord, _Slot
    p = prog._shallow([])
    p.params = {s: (t.detach().to(torch.bfloat16)
                    if t.dtype == torch.float32 else t)
                for s, t in prog.params.items()}
    remap, casts, nslots = {}, [], prog._slot_count
    for _name, (slot, _shape, dtype) in prog.feed_vars.items():
        if str(dtype) not in ("float32", "torch.float32"):
            continue
        casts.append(_OpRecord(_cast_bf16, (_Slot(slot),), {}, [nslots],
                               "cast"))
        remap[slot] = nslots
        nslots += 1

    def rewrite(tree):
        if isinstance(tree, _Slot):
            return _Slot(remap.get(tree.idx, tree.idx))
        if type(tree) in (tuple, list):
            return type(tree)(rewrite(v) for v in tree)
        if isinstance(tree, dict):
            return {k: rewrite(v) for k, v in tree.items()}
        return tree
    p.ops = casts + [op.replace(args=rewrite(op.args),
                                kwargs=rewrite(op.kwargs)) for op in prog.ops]
    p._slot_count = nslots
    p._produced = set(prog._produced) | set(remap.values())
    p._optimizer = None
    p._loss_slot = None
    return p


def build_serving_program(prog, fetches, passes=()):
    """The load-time pipeline over a recorded Program: its evaluation
    clone (dropout off, batch norm on its running statistics, no
    statistics written), pruned to ``fetches``, then the program-rewrite
    passes among ``passes`` (``"bf16"``). Returns the new Program; the
    fetch tensors name its outputs still (slots are shared)."""
    from ..static.passes import apply_pass, prune
    validate_passes(passes)
    p = prune(prog.clone(for_test=True), list(fetches))
    if "bf16" in passes:
        p = apply_pass(p, "serving_bf16_cast_pass")
    return p


def _register():
    from ..static.passes import register_pass
    register_pass("serving_bf16_cast_pass")(serving_bf16_cast_pass)


_register()
