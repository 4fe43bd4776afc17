"""Step checkpoints of split and pipelined models on the CPU, over gloo (a
repaired fault: a checkpoint of a tensor-parallel model restored rank 0's
slice on every rank, and a pipelined model saved stage 0 only).

The ranks are processes spawned by ``test_torch_hybrid.spawn`` (a
``file://`` rendezvous under the test's temporary directory), each running
this file's ``rank_task``: a tiny GPT (``use_mp`` at mp 2 and dp 2 x mp 2
with ZeRO-1 over dp, from the reference's weights; ``build_pipeline_layer``
at pp 2, seeded) trained two AdamW steps, saved by ``CheckpointManager`` (every
rank calls ``save``), then fresh objects from another seed on every rank
restored from it.

Bounds, all exact: each rank's restored parameters, buffers and optimizer
state (its slices, its ZeRO rows, its stage) equal what that rank held at
the save, byte for byte; only global rank 0 writes; the dp 2 x mp 2
checkpoint, restored into the reference's single-process dense GPT and
AdamW, gives the reference the port's full-layout weights and moments
byte for byte; a combination the checkpoint does not cover (ZeRO-2 over
tensor-parallel parameters, a pipeline with ZeRO, a pod checkpoint of a
pipeline) raises at ``save`` and writes nothing.
"""
import os

import numpy as np
import pytest
import torch

from test_torch_hybrid import GPT, fleet_init, spawn

LR = 1e-3
BATCH, SEQ = 4, 16


# -- the ranks --------------------------------------------------------------

def _state(model, opt):
    """This rank's parameters, buffers and optimizer state as numpy."""
    from paddle_tpu_torch.checkpoint.state import to_numpy
    out = {"model." + k: to_numpy(v) for k, v in model.state_dict().items()}
    out.update({"opt." + k: to_numpy(v) for k, v in opt.state_dict().items()
                if isinstance(v, torch.Tensor)})
    return out


def _counting_writes():
    """Count this rank's calls of the checkpoint core's writer."""
    from paddle_tpu_torch.checkpoint import core
    calls = []
    write = core.write_checkpoint

    def counted(*args, **kwargs):
        calls.append(1)
        return write(*args, **kwargs)

    core.write_checkpoint = counted
    return calls


def _lm_loss(logits, labels):
    from paddle_tpu_torch.nn import functional as F
    v = logits.shape[-1]
    return F.cross_entropy(logits[:, :-1].reshape(-1, v),
                           labels[:, 1:].reshape(-1).long())


def _gpt(inputs, hcg, seed, weights=True):
    import paddle_tpu_torch
    from paddle_tpu_torch import bridge, optimizer
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.models import gpt
    paddle_tpu_torch.seed(seed)
    model = gpt.GPTForCausalLM(gpt.GPTConfig(**GPT, use_mp=True),
                               device="cpu")
    wrapped = fleet.distributed_model(model)
    if weights:
        bridge.load_reference_state(wrapped, inputs["gpt_weights"])
    opt = fleet.distributed_optimizer(optimizer.AdamW(
        parameters=model.parameters(), learning_rate=LR))
    return model, wrapped, opt


def _train(model, wrapped, opt, inputs, hcg, dp):
    from paddle_tpu_torch.distributed.parallel import fused_allreduce_grads
    ids = inputs["gpt_ids"]
    b = ids.shape[0] // dp
    r = hcg.get_data_parallel_rank()
    local = torch.from_numpy(ids[r * b:(r + 1) * b])
    for _ in range(2):
        model.loss(wrapped(local), local).backward()
        if opt._zero is None and dp > 1:
            fused_allreduce_grads(model.parameters(),
                                  group=hcg.get_data_parallel_group())
        opt.step()
        opt.clear_grad()


def _round_trip(inputs, root, dp, mp):
    from paddle_tpu_torch import bridge, checkpoint
    hcg = fleet_init(dp=dp, mp=mp, sharding=dp > 1)
    model, wrapped, opt = _gpt(inputs, hcg, seed=1)
    _train(model, wrapped, opt, inputs, hcg, dp)
    saved = _state(model, opt)
    full = bridge.full_state_dict(model)
    calls = _counting_writes()
    checkpoint.CheckpointManager(root).add_model(model).add_optimizer(
        opt).save(2)
    fresh, _, fresh_opt = _gpt(inputs, hcg, seed=7, weights=False)
    before = _state(fresh, fresh_opt)
    meta = checkpoint.CheckpointManager(root).add_model(
        fresh).add_optimizer(fresh_opt).restore()
    return {"saved": saved, "restored": _state(fresh, fresh_opt),
            "fresh": before, "writes": len(calls), "step": meta["step"],
            "full": full, "mp_rank": hcg.get_model_parallel_rank(),
            "dp_rank": hcg.get_data_parallel_rank(),
            "opt_names": [opt._names[id(p)] for p in opt._parameters()],
            "zero": None if opt._zero is None else opt._zero.stage}


def _zero2_refused(inputs, root):
    """ZeRO-2 over the (one-rank) dp axis with mp-split parameters."""
    from paddle_tpu_torch import checkpoint
    hcg = fleet_init(mp=2)
    model, _, opt = _gpt(inputs, hcg, seed=1)
    opt._zero_enable(axis="dp", mesh=hcg.mesh, stage=2)
    try:
        checkpoint.CheckpointManager(root).add_model(model).add_optimizer(
            opt).save(1)
    except NotImplementedError as e:
        return {"raised": str(e), "written": checkpoint.latest_step(root)}
    return {"raised": None, "written": checkpoint.latest_step(root)}


def _pipeline(inputs, root):
    import paddle_tpu_torch
    from paddle_tpu_torch import checkpoint, optimizer
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.models import gpt

    def build(seed):
        paddle_tpu_torch.seed(seed)
        layer = gpt.build_pipeline_layer(gpt.GPTConfig(**GPT), num_stages=2,
                                         loss_fn=_lm_loss, device="cpu")
        return layer, fleet.distributed_model(layer), \
            fleet.distributed_optimizer(optimizer.AdamW(
                parameters=layer.parameters(), learning_rate=LR))

    fleet_init(pp=2, pipeline_configs={"accumulate_steps": 2,
                                       "micro_batch_size": 2})
    layer, model, opt = build(1)
    ids = torch.from_numpy(inputs["gpt_ids"])
    for _ in range(2):
        model.train_batch((ids, ids), opt)
    saved = _state(layer, opt)
    calls = _counting_writes()
    checkpoint.CheckpointManager(root).add_model(layer).add_optimizer(
        opt).save(2)
    step_dir = os.path.join(root, checkpoint.core.step_dirname(2))
    files = sorted(os.listdir(step_dir)) if os.path.isdir(step_dir) else None
    fresh, _, fresh_opt = build(7)
    checkpoint.CheckpointManager(root).add_model(fresh).add_optimizer(
        fresh_opt).restore()
    out = {"saved": saved, "restored": _state(fresh, fresh_opt),
           "writes": len(calls), "stage": layer.stage_id, "files": files}
    # not covered: a pipeline with ZeRO, and a pod checkpoint of one
    raised = []
    opt._zero_enable(axis="dp", mesh=fleet.get_hybrid_communicate_group()
                     .mesh, stage=1)
    for mgr in (checkpoint.CheckpointManager(root + "_zero"),
                checkpoint.PodCheckpointManager(root + "_pod")):
        try:
            mgr.add_model(layer).add_optimizer(opt).save(3)
            raised.append(None)
        except NotImplementedError as e:
            raised.append(str(e))
    out["refused"] = raised
    out["refused_written"] = [checkpoint.latest_step(root + s)
                              for s in ("_zero", "_pod")]
    return out


def rank_task(task, inputs, rank, world):
    from paddle_tpu_torch.distributed.fleet.base import topology
    root = inputs["root"]
    if task == "ckpt_mp2":
        out = {"mp2": _round_trip(inputs, root + "/mp2", dp=1, mp=2)}
        topology.set_hybrid_communicate_group(None)
        out["zero2"] = _zero2_refused(inputs, root + "/zero2")
    elif task == "ckpt_pp2":
        out = _pipeline(inputs, root + "/pp2")
    else:
        out = _round_trip(inputs, root + "/dp2mp2", dp=2, mp=2)
    topology.set_hybrid_communicate_group(None)
    return out


# -- the parent -------------------------------------------------------------------

def _inputs(tmp):
    import paddle_tpu as paddle
    from paddle_tpu.models import gpt as ref_gpt
    paddle.seed(0)
    ref = ref_gpt.GPTForCausalLM(ref_gpt.GPTConfig(**GPT))
    rng = np.random.RandomState(3)
    return {"root": str(tmp),
            "gpt_weights": {k: np.asarray(v.numpy())
                            for k, v in ref.state_dict().items()},
            "gpt_ids": rng.randint(0, GPT["vocab_size"],
                                   (BATCH, SEQ)).astype(np.int64)}


def _same(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].shape == \
            want[k].shape, k
        assert got[k].tobytes() == want[k].tobytes(), k


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("ckpt_hybrid")
    inputs = _inputs(tmp)
    out = {"inputs": inputs}
    for task, world in (("ckpt_mp2", 2), ("ckpt_pp2", 2),
                        ("ckpt_dp2mp2", 4)):
        out[task] = spawn(tmp, world, __name__, task, inputs)
    return out


def test_mp2_round_trip_restores_each_rank_its_own_slice(worlds):
    ranks = [r["mp2"] for r in worlds["ckpt_mp2"]]
    for r in ranks:
        _same(r["restored"], r["saved"])
        assert r["step"] == 2
    qkv = "model.gpt.blocks.0.qkv.weight"
    assert ranks[0]["saved"][qkv].tobytes() != ranks[1]["saved"][qkv] \
        .tobytes()  # two slices, each restored to its own rank
    assert ranks[0]["fresh"][qkv].tobytes() != ranks[0]["saved"][qkv] \
        .tobytes()  # the fresh objects did start elsewhere
    assert [r["writes"] for r in ranks] == [1, 0]


def test_mp2_checkpoint_holds_the_full_layout(worlds):
    from paddle_tpu_torch import checkpoint
    from paddle_tpu_torch.checkpoint import state
    _, payloads, meta = checkpoint.read_checkpoint(
        worlds["inputs"]["root"] + "/mp2")
    model = state.loads(payloads["model_model.pkl"])["state"]
    want = worlds["inputs"]["gpt_weights"]
    assert {k: v.shape for k, v in model.items()} == \
        {k: v.shape for k, v in want.items()}
    full = worlds["ckpt_mp2"][0]["mp2"]["full"]
    _same({k: np.asarray(v) for k, v in model.items()}, full)
    opt = state.loads(payloads["optimizer_opt.pkl"])
    assert opt["full_layout"] and "zero" not in opt


def test_zero2_with_split_parameters_is_refused_at_save(worlds):
    for r in worlds["ckpt_mp2"]:
        assert "ZeRO-2" in r["zero2"]["raised"]
        assert r["zero2"]["written"] is None


def test_pp2_round_trip_writes_and_restores_every_stage(worlds):
    ranks = worlds["ckpt_pp2"]
    assert sorted(r["stage"] for r in ranks) == [0, 1]
    for r in ranks:
        _same(r["restored"], r["saved"])
    assert [r["writes"] for r in ranks] == [1, 0]
    files = ranks[0]["files"]
    for kind in ("model_model", "optimizer_opt"):
        assert {f"{kind}.stage0.pkl", f"{kind}.stage1.pkl"} <= set(files)
    names = [set(k for k in r["saved"] if k.startswith("model."))
             for r in ranks]
    assert names[0] and names[1] and not names[0] & names[1]


def test_pipeline_with_zero_or_a_pod_checkpoint_is_refused(worlds):
    for r in worlds["ckpt_pp2"]:
        zero, pod = r["refused"]
        assert zero is not None and "ZeRO" in zero
        assert pod is not None and "pipelined" in pod
        assert r["refused_written"] == [None, None]


def test_dp2_mp2_zero1_round_trip_on_every_rank(worlds):
    ranks = worlds["ckpt_dp2mp2"]
    assert all(r["zero"] == 1 for r in ranks)
    for r in ranks:
        _same(r["restored"], r["saved"])
    assert sum(r["writes"] for r in ranks) == 1 and ranks[0]["writes"] == 1
    # the four (dp, mp) coordinates, and the dp replicas' slices alike
    assert sorted((r["dp_rank"], r["mp_rank"]) for r in ranks) == [
        (0, 0), (0, 1), (1, 0), (1, 1)]
    by_mp = {}
    for r in ranks:
        by_mp.setdefault(r["mp_rank"], []).append(r["saved"])
    qkv = "model.gpt.blocks.0.qkv.weight"
    for group in by_mp.values():
        assert group[0][qkv].tobytes() == group[1][qkv].tobytes()
    assert by_mp[0][0][qkv].tobytes() != by_mp[1][0][qkv].tobytes()


def test_dp2_mp2_checkpoint_crosses_to_the_reference_byte_for_byte(worlds):
    import paddle_tpu as paddle
    from paddle_tpu import checkpoint as ref_checkpoint
    from paddle_tpu.models import gpt as ref_gpt
    from paddle_tpu_torch import checkpoint
    from paddle_tpu_torch.checkpoint import state
    root = worlds["inputs"]["root"] + "/dp2mp2"
    paddle.seed(11)
    ref = ref_gpt.GPTForCausalLM(ref_gpt.GPTConfig(**GPT))
    ref_opt = paddle.optimizer.AdamW(parameters=ref.parameters(),
                                     learning_rate=LR)
    ref_names = [n for n, _ in ref.named_parameters()]
    assert ref_names == worlds["ckpt_dp2mp2"][0]["opt_names"]
    ref_checkpoint.CheckpointManager(root, include_rng=False).add_model(
        ref).add_optimizer(ref_opt).restore()
    full = worlds["ckpt_dp2mp2"][0]["full"]
    _same({k: np.asarray(v.numpy()) for k, v in ref.state_dict().items()},
          full)
    _, payloads, _ = checkpoint.read_checkpoint(root)
    saved = state.loads(payloads["optimizer_opt.pkl"])["accumulators"]
    got = {}
    for i, p in enumerate(ref.parameters()):
        for slot in ("moment1", "moment2"):
            got[f"0.{i}.{slot}"] = np.asarray(
                ref_opt._accumulators[(slot, id(p))]._value)
    _same(got, {k: np.asarray(v) for k, v in saved.items()})
    assert int(np.asarray(ref_opt._step_count._value)) == 2
