"""Tensor parallelism of the port on the CPU, over gloo, against the
reference: the mp layers, GPT with ``use_mp`` and BERT with ``use_mp``
under the fleet's hybrid mesh.

The ranks are processes that run this file as a script (``spawn``: a
``file://`` rendezvous under the test's temporary directory, one thread
each, a time limit per world); every world runs all of its checks in one
spawn and each rank writes its results. ``spawn`` and the rank script also
serve ``test_torch_pipeline.py`` and ``test_torch_sequence_expert.py``,
whose tasks live in those files (``rank_task``). The ranks import no JAX.

The reference side runs in the parent process: the dense
``GPTForCausalLM`` and, for the reference dryrun's first line
(``__graft_entry__.py:87-100``), ``fleet.init`` at dp 2 x mp 2 with
``strategy.sharding`` on the 8-device CPU mesh of ``tests/conftest.py``.

Bounds (float32 on both sides, the same math in another order):

- losses 1e-5 relative; gradients and parameters 1e-4 relative L2, but for
  the key third of each ``qkv.bias`` after AdamW steps: its gradient is
  exactly zero (softmax cancels a bias on k), so both sides step on
  rounding noise there, held to 2.2 x the rate a step each;
- the mp layers against the dense torch ops on the same full weights:
  outputs and gradients 1e-5 relative L2 (sums split over two ranks);
- the naive split of the fused QKV (contiguous thirds of the columns, the
  reference's ``P(None, "mp")`` layout taken literally) must miss the
  reference's loss by more than 1e-3 relative: it hands each rank q, k and
  v columns of different heads.

Data parallelism averages the ranks' means: the MLM batch of the BERT twin
gives each dp rank as many MLM labels (every fifth position), so that the
average of the ranks' means is the reference's global mean.
"""
import os
import pickle
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
LOSS_REL, GRAD_REL, LAYER_REL, WITNESS_REL = 1e-5, 1e-4, 1e-5, 1e-3
SPAWN_TIMEOUT = 240
GPT = dict(vocab_size=256, hidden_size=64, num_layers=2, num_heads=4,
           max_seq_len=16, hidden_dropout=0.0, attention_dropout=0.0)
BERT = dict(vocab_size=256, hidden_size=64, num_layers=2, num_heads=4,
            intermediate_size=128, max_position_embeddings=32,
            hidden_dropout=0.0, attention_dropout=0.0)
BERT_LR, BERT_BATCH, BERT_SEQ = 1e-3, 4, 32
CLIP_LR, CLIP_NORM = 1e-3, 0.5  # the clip binds: the gradients' norm is ~30


def rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def updated_rel(name, mine, theirs, hidden, lr, steps):
    """Relative L2 of an updated parameter, but for the key third of a
    ``qkv.bias``: its gradient is exactly zero, so AdamW steps on rounding
    noise there; that third is held to 2.2 x the rate a step each way."""
    if not name.endswith("qkv.bias"):
        return rel(mine, theirs)
    key = np.s_[hidden:2 * hidden]
    assert np.abs(mine[key] - theirs[key]).max() <= 2 * 2.2 * lr * steps, \
        name
    return rel(np.delete(mine, key), np.delete(theirs, key))


# -- the gloo worlds --------------------------------------------------------

def spawn(workdir, world, module, task, inputs):
    """Run ``module.rank_task(task, inputs, rank, world)`` on ``world``
    gloo ranks; returns the ranks' results, in rank order."""
    workdir = Path(workdir)
    with open(workdir / f"{task}.in.pkl", "wb") as f:
        pickle.dump(inputs, f)
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, __file__, module, task, str(rank), str(world),
         str(workdir)], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for rank in range(world)]
    try:
        logs = [p.communicate(timeout=SPAWN_TIMEOUT)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    assert all(p.returncode == 0 for p in procs), "\n".join(logs)
    out = []
    for rank in range(world):
        with open(workdir / f"{task}.rank{rank}.pkl", "rb") as f:
            out.append(pickle.load(f))
    return out


def _rank_main(module, task, rank, world, workdir):
    torch.set_num_threads(1)
    from paddle_tpu_torch.distributed import parallel_env
    parallel_env.init_parallel_env(
        device="cpu", init_method=f"file://{workdir}/rendezvous_{task}",
        world_size=world, rank=rank)
    with open(Path(workdir) / f"{task}.in.pkl", "rb") as f:
        inputs = pickle.load(f)
    import importlib
    out = importlib.import_module(module).rank_task(task, inputs, rank,
                                                    world)
    with open(Path(workdir) / f"{task}.rank{rank}.pkl", "wb") as f:
        pickle.dump(out, f)
    # tear gloo down before the interpreter does: a group left to exit-time
    # destruction can end the process with "terminate called without an
    # active exception" (seen once for rank 0 of the dp 2 x mp 2 world);
    # the mesh and the fleet's hybrid group hold groups past
    # destroy_process_group, so drop them too (F11)
    parallel_env.destroy_parallel_env()


def fleet_init(dp=1, mp=1, pp=1, sharding_degree=1, **strategy_fields):
    """``fleet.init`` of a hybrid mesh on the gloo world (rank side)."""
    from paddle_tpu_torch.distributed import fleet
    s = fleet.DistributedStrategy()
    s.hybrid_configs = {"dp_degree": dp, "mp_degree": mp, "pp_degree": pp,
                        "sharding_degree": sharding_degree}
    for k, v in strategy_fields.items():
        setattr(s, k, v)
    return fleet.init(is_collective=True, strategy=s, device="cpu")


def grads_as_state(model):
    """The model's gradients under its state names, gathered into the
    reference's full layout (every rank of the mp group calls it)."""
    from paddle_tpu_torch import bridge
    saved = {}
    for p in model.parameters():
        saved[p] = p.data
        p.data = p.grad if p.grad is not None else torch.zeros_like(p)
    try:
        return bridge.full_state_dict(model)
    finally:
        for p, d in saved.items():
            p.data = d


# -- rank tasks ---------------------------------------------------------------

def _mp_layers(group):
    """Each mp layer against the dense ops on the same full weights."""
    from paddle_tpu_torch import bridge
    from paddle_tpu_torch.distributed.fleet import meta_parallel as mpl
    rng = np.random.RandomState(3)
    out = {}

    def run(layer, full, x, dense, local=None):
        """``local(y)``: this rank's part of the dense output, where the
        layer's output is split (every rank draws the same ``c``, so the
        dense cotangent is ``c`` repeated)."""
        for name, p in layer.named_parameters():
            with torch.no_grad():
                p.copy_(torch.from_numpy(bridge.local_slice(full[name], p)))
        xt = torch.from_numpy(x).requires_grad_()
        y = layer(xt)
        c = torch.from_numpy(rng.rand(*y.shape).astype("float32"))
        (y * c).sum().backward()
        xd = torch.from_numpy(x).requires_grad_()
        wd = {k: torch.from_numpy(v).requires_grad_()
              for k, v in full.items()}
        yd = dense(xd, wd)
        n = yd.shape[-1] // y.shape[-1]
        (yd * torch.cat([c] * n, -1)).sum().backward()
        errs = {"y": rel(y.detach(), (local or (lambda v: v))(yd.detach())),
                "dx": rel(xt.grad, xd.grad)}
        for name, p in layer.named_parameters():
            errs["d" + name] = rel(p.grad, bridge.local_slice(
                wd[name].grad.numpy(), p))
        return errs

    x = rng.rand(3, 8).astype("float32")
    for gather in (True, False):
        full = {"weight": rng.rand(8, 12).astype("float32"),
                "bias": rng.rand(12).astype("float32")}
        layer = mpl.ColumnParallelLinear(8, 12, gather_output=gather,
                                         mp_group=group, device="cpu")

        out[f"column gather={gather}"] = run(
            layer, full, x, lambda xd, w: xd @ w["weight"] + w["bias"],
            None if gather else lambda y, p=layer.weight: y.chunk(
                p.split_degree, -1)[p.split_rank])
    for parallel_in in (False, True):
        full = {"weight": rng.rand(8, 6).astype("float32"),
                "bias": rng.rand(6).astype("float32")}
        layer = mpl.RowParallelLinear(8, 6, input_is_parallel=parallel_in,
                                      mp_group=group, device="cpu")
        if parallel_in:
            r, n = layer.weight.split_rank, layer.weight.split_degree
            xs = np.split(x, n, axis=-1)[r]

            def dense(xd, w, r=r, n=n):
                # the full input is every rank's block; this rank's block
                # is xd, the others are fixed
                blocks = list(np.split(x, n, axis=-1))
                parts = [xd if i == r else torch.from_numpy(b)
                         for i, b in enumerate(blocks)]
                return torch.cat(parts, -1) @ w["weight"] + w["bias"]
            out[f"row input_is_parallel={parallel_in}"] = run(layer, full,
                                                              xs, dense)
        else:
            out[f"row input_is_parallel={parallel_in}"] = run(
                layer, full, x,
                lambda xd, w: xd @ w["weight"] + w["bias"])
    ids = rng.randint(0, 16, (3, 5))
    full = {"weight": rng.rand(16, 4).astype("float32")}
    emb = mpl.VocabParallelEmbedding(16, 4, mp_group=group, device="cpu")
    for name, p in emb.named_parameters():
        with torch.no_grad():
            p.copy_(torch.from_numpy(bridge.local_slice(full[name], p)))
    y = emb(torch.from_numpy(ids))
    c = torch.from_numpy(rng.rand(*y.shape).astype("float32"))
    (y * c).sum().backward()
    wd = torch.from_numpy(full["weight"]).requires_grad_()
    yd = torch.nn.functional.embedding(torch.from_numpy(ids), wd)
    (yd * c).sum().backward()
    out["vocab embedding"] = {
        "y": rel(y.detach(), yd.detach()),
        "dweight": rel(emb.weight.grad, bridge.local_slice(
            wd.grad.numpy(), emb.weight))}
    logits = rng.rand(6, 16).astype("float32") * 4
    labels = np.array([0, 5, 9, 15, -100, 8])
    ce = mpl.ParallelCrossEntropy(mp_group=group)
    r, n = emb.weight.split_rank, emb.weight.split_degree
    lt = torch.from_numpy(np.split(logits, n, -1)[r].copy()).requires_grad_()
    loss = ce(lt, torch.from_numpy(labels))
    loss.sum().backward()
    ld = torch.from_numpy(logits).requires_grad_()
    dense = torch.nn.functional.cross_entropy(
        ld, torch.from_numpy(labels), reduction="none", ignore_index=-100)
    dense.sum().backward()
    out["parallel cross entropy"] = {
        "loss": rel(loss.detach()[:, 0], dense.detach()),
        "shape": tuple(loss.shape),
        "dlogits": rel(lt.grad, np.split(ld.grad.numpy(), n, -1)[r])}
    return out


def _gpt_mp(inputs, dp, mp, naive_qkv=False):
    """GPT with use_mp from the reference's weights: loss and gradients
    (averaged over dp, gathered over mp)."""
    import paddle_tpu_torch
    from paddle_tpu_torch import bridge
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.distributed.parallel import fused_allreduce_grads
    from paddle_tpu_torch.models import gpt
    hcg = fleet_init(dp=dp, mp=mp)
    paddle_tpu_torch.seed(1)
    model = gpt.GPTForCausalLM(gpt.GPTConfig(**GPT, use_mp=True),
                               device="cpu")
    wrapped = fleet.distributed_model(model)
    bridge.load_reference_state(wrapped, inputs["gpt_weights"])
    if naive_qkv:  # contiguous thirds of the columns, not whole heads
        r, n = hcg.get_model_parallel_rank(), mp
        with torch.no_grad():
            for i, blk in enumerate(model.gpt.blocks):
                for leaf in ("weight", "bias"):
                    full = inputs["gpt_weights"][f"gpt.blocks.{i}.qkv.{leaf}"]
                    getattr(blk.qkv, leaf).copy_(torch.from_numpy(
                        np.split(full, n, axis=-1)[r].copy()))
    ids = inputs["gpt_ids"]
    b = ids.shape[0] // dp
    r = hcg.get_data_parallel_rank()
    local = torch.from_numpy(ids[r * b:(r + 1) * b])
    loss = model.loss(wrapped(local), local)
    loss.backward()
    fused_allreduce_grads(model.parameters(),
                          group=hcg.get_data_parallel_group())
    from paddle_tpu_torch.distributed import collective
    total = loss.detach().clone()
    collective.all_reduce(total, op=collective.ReduceOp.AVG,
                          group=hcg.get_data_parallel_group())
    return {"loss": float(total), "grads": grads_as_state(model),
            "weights": bridge.full_state_dict(model),
            "flops_per_token": model.flops_per_token()}


def _gpt_clip_step(inputs):
    """One AdamW step of GPT use_mp at mp 2 with a global-norm clip that
    binds: the norm sums the sliced parameters' squares over mp."""
    import paddle_tpu_torch
    from paddle_tpu_torch import bridge, nn, optimizer
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.models import gpt
    fleet_init(mp=2)
    paddle_tpu_torch.seed(1)
    model = gpt.GPTForCausalLM(gpt.GPTConfig(**GPT, use_mp=True),
                               device="cpu")
    wrapped = fleet.distributed_model(model)
    bridge.load_reference_state(wrapped, inputs["gpt_weights"])
    opt = fleet.distributed_optimizer(optimizer.AdamW(
        parameters=model.parameters(), learning_rate=CLIP_LR,
        grad_clip=nn.ClipGradByGlobalNorm(CLIP_NORM)))
    ids = torch.from_numpy(inputs["gpt_ids"])
    model.loss(wrapped(ids), ids).backward()
    opt.step()
    return {"clip": type(opt._grad_clip).__name__,
            "weights": bridge.full_state_dict(model)}


def _sharding_axis(inputs):
    """ZeRO-1 over a sharding axis of 2 against ZeRO-1 over dp 2: the same
    step, bitwise."""
    import paddle_tpu_torch
    from paddle_tpu_torch import bridge, optimizer
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.models import gpt
    out = {}
    for axis, kw in (("sharding", dict(sharding_degree=2)),
                     ("dp", dict(dp=2))):
        hcg = fleet_init(**kw, sharding=True)
        paddle_tpu_torch.seed(1)
        model = gpt.GPTForCausalLM(gpt.GPTConfig(**GPT), device="cpu")
        bridge.load_reference_state(model, inputs["gpt_weights"])
        wrapped = fleet.distributed_model(model)
        opt = fleet.distributed_optimizer(optimizer.AdamW(
            parameters=model.parameters(), learning_rate=CLIP_LR))
        r = (hcg.get_sharding_parallel_rank() if axis == "sharding"
             else hcg.get_data_parallel_rank())
        ids = torch.from_numpy(inputs["gpt_ids"][2 * r:2 * r + 2])
        model.loss(wrapped(ids), ids).backward()
        opt.step()
        out[axis] = {"wrapper": type(wrapped).__name__,
                     "dp_axis": getattr(wrapped, "dp_axis", None),
                     "zero_axis": opt.zero_layout()["axis"],
                     "weights": {k: v.detach().numpy().copy() for k, v in
                                 model.state_dict().items()}}
    return out


def _bert_twin(inputs):
    """The reference dryrun's first line: BERT use_mp at dp 2 x mp 2,
    ``strategy.sharding`` (ZeRO-1 over dp), two eager steps."""
    import paddle_tpu_torch
    from paddle_tpu_torch import bridge, optimizer
    from paddle_tpu_torch.distributed import collective, fleet
    from paddle_tpu_torch.models import bert
    hcg = fleet_init(dp=2, mp=2, sharding=True)
    paddle_tpu_torch.seed(1)
    model = bert.BertForPretraining(bert.BertConfig(**BERT, use_mp=True),
                                    device="cpu")
    wrapped = fleet.distributed_model(model)
    bridge.load_reference_state(wrapped, inputs["bert_weights"])
    opt = fleet.distributed_optimizer(optimizer.AdamW(
        parameters=model.parameters(), learning_rate=BERT_LR))
    r = hcg.get_data_parallel_rank()
    b = BERT_BATCH // 2
    batch = [torch.from_numpy(a[r * b:(r + 1) * b])
             for a in inputs["bert_batch"]]
    losses = []
    for _ in range(2):
        logits, nsp = wrapped(batch[0], batch[1])
        loss = model.loss(logits, nsp, batch[2], batch[3])
        loss.backward()
        opt.step()
        opt.clear_grad()
        total = loss.detach().clone()
        collective.all_reduce(total, op=collective.ReduceOp.AVG,
                              group=hcg.get_data_parallel_group())
        losses.append(float(total))
    layout = opt.zero_layout()
    return {"losses": losses, "weights": bridge.full_state_dict(model),
            "zero": {k: layout[k] for k in ("stage", "axis", "degree")},
            "rows": (layout["bucket_rows"], layout["shard_rows"])}


def rank_task(task, inputs, rank, world):
    from paddle_tpu_torch.distributed.fleet.base import topology
    out = {}
    if world == 2:
        hcg = fleet_init(mp=2)
        out["layers"] = _mp_layers(hcg.get_model_parallel_group())
        out["gpt_mp2"] = _gpt_mp(inputs, dp=1, mp=2)
        out["gpt_mp2_naive_qkv"] = _gpt_mp(inputs, dp=1, mp=2,
                                           naive_qkv=True)["loss"]
        out["gpt_mp2_clip_step"] = _gpt_clip_step(inputs)
        out["sharding_axis"] = _sharding_axis(inputs)
    else:
        out["gpt_dp2_mp2"] = _gpt_mp(inputs, dp=2, mp=2)
        out["bert_dp2_mp2_zero1"] = _bert_twin(inputs)
    topology.set_hybrid_communicate_group(None)
    return out


# -- the reference side -------------------------------------------------------

def _reference_inputs():
    import paddle_tpu as paddle
    from paddle_tpu.distributed import fleet as ref_fleet
    from paddle_tpu.distributed import parallel_env as ref_env
    from paddle_tpu.distributed.fleet.base import topology as ref_topo
    from paddle_tpu.models import bert as ref_bert
    from paddle_tpu.models import gpt as ref_gpt
    from jax.sharding import PartitionSpec as P

    out = {}
    paddle.seed(0)
    g = ref_gpt.GPTForCausalLM(ref_gpt.GPTConfig(**GPT))
    out["gpt_weights"] = {k: np.asarray(v.numpy())
                          for k, v in g.state_dict().items()}
    ids = np.random.RandomState(0).randint(
        0, GPT["vocab_size"], (4, GPT["max_seq_len"])).astype("int32")
    out["gpt_ids"] = ids
    loss = g.loss(g(paddle.to_tensor(ids)), paddle.to_tensor(ids))
    loss.backward()
    ref = {"gpt_loss": float(loss),
           "gpt_grads": {n: np.asarray(p.grad.numpy())
                         for n, p in g.named_parameters()},
           "gpt_flops_per_token": g.flops_per_token()}
    norm = float(np.sqrt(sum(float((v.astype(np.float64) ** 2).sum())
                             for v in ref["gpt_grads"].values())))
    assert norm > 10 * CLIP_NORM, norm  # the clip binds
    opt = paddle.optimizer.AdamW(
        parameters=g.parameters(), learning_rate=CLIP_LR,
        grad_clip=paddle.nn.ClipGradByGlobalNorm(CLIP_NORM))
    opt.step()
    ref["gpt_clip_step"] = {k: np.asarray(v.numpy())
                            for k, v in g.state_dict().items()}

    # the dryrun's first line, at this size
    strategy = ref_fleet.DistributedStrategy()
    strategy.hybrid_configs = {"dp_degree": 2, "mp_degree": 2,
                               "pp_degree": 1, "sharding_degree": 1}
    strategy.sharding = True
    try:
        ref_fleet.init(is_collective=True, strategy=strategy)
        paddle.seed(0)
        bm = ref_bert.BertForPretraining(ref_bert.BertConfig(**BERT,
                                                             use_mp=True))
        out["bert_weights"] = {k: np.asarray(v.numpy())
                               for k, v in bm.state_dict().items()}
        model = ref_fleet.distributed_model(bm)
        with pytest.warns(UserWarning, match="ZeRO flat sharding"):
            opt = ref_fleet.distributed_optimizer(paddle.optimizer.AdamW(
                parameters=model.parameters(), learning_rate=BERT_LR))
        inner = model._layers if hasattr(model, "_layers") else model

        def train_step(a, b, c, d):
            logits, nsp = inner(a, b)
            loss = inner.loss(logits, nsp, c, d)
            loss.backward()
            opt.step()
            opt.clear_grad()
            return loss

        step = paddle.jit.to_static(train_step)
        step._arg_pspecs = [P("dp")] * 4
        ids, tok, _, nsp = ref_bert.synthetic_mlm_batch(
            BERT_BATCH, BERT_SEQ, BERT["vocab_size"])
        mlm = np.full_like(ids, -100)
        mlm[:, ::5] = ids[:, ::5]  # as many MLM labels on each dp rank
        out["bert_batch"] = (ids, tok, mlm, nsp)
        ref["bert_losses"] = [float(np.asarray(step(*[
            paddle.to_tensor(a) for a in out["bert_batch"]]).numpy()))
            for _ in range(2)]
        ref["bert_weights"] = {k: np.asarray(v.numpy())
                               for k, v in bm.state_dict().items()}
    finally:
        ref_env.set_mesh(None)
        ref_topo.set_hybrid_communicate_group(None)
    return out, ref


@pytest.fixture(scope="module")
def reference():
    return _reference_inputs()


@pytest.fixture(scope="module")
def mp2(reference, tmp_path_factory):
    return spawn(tmp_path_factory.mktemp("mp2"), 2, "test_torch_hybrid",
                 "mp2", reference[0])


@pytest.fixture(scope="module")
def dp2mp2(reference, tmp_path_factory):
    return spawn(tmp_path_factory.mktemp("dp2mp2"), 4, "test_torch_hybrid",
                 "dp2mp2", reference[0])


@pytest.mark.parametrize("layer", [
    "column gather=True", "column gather=False",
    "row input_is_parallel=False", "row input_is_parallel=True",
    "vocab embedding", "parallel cross entropy"])
def test_mp_layers_at_mp2_match_the_dense_ops(mp2, layer):
    for rank in mp2:
        errs = dict(rank["layers"][layer])
        if "shape" in errs:
            assert errs.pop("shape") == (6, 1)
        assert max(errs.values()) <= LAYER_REL, errs


@pytest.mark.parametrize("arm", ["gpt_mp2", "gpt_dp2_mp2"])
def test_gpt_use_mp_matches_the_dense_reference(mp2, dp2mp2, reference,
                                                arm):
    _, ref = reference
    ranks = mp2 if arm == "gpt_mp2" else dp2mp2
    for got in (r[arm] for r in ranks):
        assert abs(got["loss"] - ref["gpt_loss"]) <= LOSS_REL * abs(
            ref["gpt_loss"])
        assert sorted(got["grads"]) == sorted(ref["gpt_grads"])
        for n, g in ref["gpt_grads"].items():
            assert rel(got["grads"][n], g) <= GRAD_REL, n
        assert got["flops_per_token"] == ref["gpt_flops_per_token"]


def test_full_state_dict_gives_the_reference_layout_back(mp2, reference):
    inputs, _ = reference
    for got in (r["gpt_mp2"]["weights"] for r in mp2):
        assert sorted(got) == sorted(inputs["gpt_weights"])
        for n, w in inputs["gpt_weights"].items():
            assert np.array_equal(got[n], w), n


def test_a_naive_qkv_split_misses_the_reference(mp2, reference):
    """The witness: contiguous thirds of the fused QKV columns give each
    rank q, k and v of different heads."""
    _, ref = reference
    for rank in mp2:
        assert abs(rank["gpt_mp2_naive_qkv"] - ref["gpt_loss"]) > \
            WITNESS_REL * abs(ref["gpt_loss"])


def test_hybrid_global_norm_clip_at_mp2(mp2, reference):
    """One AdamW step under a binding global-norm clip: each rank's norm
    sums its slices over mp and the replicated parameters once."""
    _, ref = reference
    for rank in mp2:
        got = rank["gpt_mp2_clip_step"]
        assert got["clip"] == "HybridParallelClipGrad"
        for n, w in ref["gpt_clip_step"].items():
            assert updated_rel(n, got["weights"][n], w, GPT["hidden_size"],
                               CLIP_LR, steps=1) <= GRAD_REL, n


def test_zero_over_a_sharding_axis_equals_zero_over_dp(mp2):
    for rank in mp2:
        got = rank["sharding_axis"]
        assert (got["sharding"]["wrapper"], got["sharding"]["dp_axis"],
                got["sharding"]["zero_axis"]) == ("ShardingParallel",
                                                  "sharding", "sharding")
        assert (got["dp"]["wrapper"], got["dp"]["zero_axis"]) == (
            "DataParallel", "dp")
        for n, w in got["dp"]["weights"].items():
            assert np.array_equal(got["sharding"]["weights"][n], w), n


def test_bert_dryrun_twin_dp2_mp2_zero1(dp2mp2, reference):
    """Two steps of BERT use_mp at dp 2 x mp 2 with strategy.sharding:
    the losses and the parameters against the reference's, and ZeRO-1
    over the dp axis only (each rank's stores hold half its mp slice)."""
    _, ref = reference
    for rank in dp2mp2:
        got = rank["bert_dp2_mp2_zero1"]
        for a, b in zip(got["losses"], ref["bert_losses"]):
            assert abs(a - b) <= LOSS_REL * abs(b)
        assert sorted(got["weights"]) == sorted(ref["bert_weights"])
        for n, w in ref["bert_weights"].items():
            assert updated_rel(n, got["weights"][n], w, BERT["hidden_size"],
                               BERT_LR, steps=2) <= GRAD_REL, n
        assert got["zero"] == {"stage": 1, "axis": "dp", "degree": 2}
        rows, shard_rows = got["rows"]
        assert [2 * r for r in shard_rows] == rows


if __name__ == "__main__":
    sys.path.insert(0, str(ROOT / "tests"))
    _rank_main(sys.argv[1], sys.argv[2], int(sys.argv[3]), int(sys.argv[4]),
               sys.argv[5])
