"""Pipeline parallelism of the port on the CPU, over gloo, against the
reference: ``parallel.spmd_pipeline_1f1b`` with the reference dryrun's
stage functions (``__graft_entry__.py:296-347``), the GPipe forward
``spmd_pipeline`` and ``pipelined_transformer_step``'s loss with the same
stages, GPT's ``PipelineLayer`` under ``PipelineParallel.train_batch``, and
``build_gpt_1f1b_step``.

The ranks are spawned by ``test_torch_hybrid.spawn`` (two ranks: pp 2;
four: pp 4 and dp 2 x pp 2); the reference runs in the parent, on the
8-device CPU mesh (``shard_map`` over ``pp`` and ``dp``), and its
``PipelineParallel`` with ``fleet.init(pp_degree=2)``.

Bounds, float32 on both sides: losses 1e-5 relative, gradients and updated
parameters 1e-4 relative L2 (the same math in another order: the port
recomputes each stage in its backward and sums the microbatches' gradients
in schedule order; the key third of a ``qkv.bias`` as in
``test_torch_hybrid.updated_rel``). The schedule of every rank equals the
reference's ``_last_schedule``, and each rank held at most its
``max_in_flight``.

A reference fault, held as it is: at dp > 1 the reference's stage
gradients come out summed over dp, not averaged. Its stage parameters
enter ``shard_map`` replicated over ``dp`` and ``jax.grad`` inside the
pipeline inserts a psum over ``dp`` for them; the ``pmean`` after it then
keeps the sum. The first and last stages' parameters are cast to
dp-varying first and come out as the mean. So at dp = 2 the port's stage
gradients (the mean) are held against the reference's halved.
"""
import numpy as np
import pytest
import torch

from test_torch_hybrid import (GPT, GRAD_REL, LOSS_REL, fleet_init, rel,
                               spawn, updated_rel)

M, MB, T = 4, 2, 8           # the dryrun's microbatches
H, V = 32, 128
PIPE_M, PIPE_LR = 4, 1e-3    # GPT train_batch: 4 microbatches of 1 row


def _dryrun_arrays():
    rng = np.random.RandomState(0)
    return {"w": (rng.randn(4, H, H) * 0.1).astype(np.float32),
            "b": np.zeros((4, H), np.float32),
            "emb": (rng.randn(V, H) * 0.1).astype(np.float32),
            "head": (rng.randn(H, V) * 0.1).astype(np.float32),
            "ids": rng.randint(0, V, (M, MB, T)).astype(np.int64),
            "labels": rng.randint(0, V, (M, MB, T)).astype(np.int64)}


# -- the port's side ------------------------------------------------------------

def _stage_fn(params, x):
    w, b = params
    return torch.tanh(x @ w + b) + x


def _first_fn(e, ids):
    return e[ids]


def _last_fn(hw, x, y):
    logp = torch.log_softmax(x @ hw, dim=-1)
    return -logp.gather(-1, y[..., None]).mean()


def _lm_loss(logits, labels):
    """``GPTForCausalLM.loss``: positions 0..S-2 against labels 1..S-1."""
    from paddle_tpu_torch.nn import functional as F
    v = logits.shape[-1]
    return F.cross_entropy(logits[:, :-1].reshape(-1, v),
                           labels[:, 1:].reshape(-1).long())


def _spmd(inputs, dp, pp):
    """The dryrun's 1F1B at dp x pp: loss and this stage's gradients."""
    from paddle_tpu_torch.distributed import collective
    from paddle_tpu_torch.parallel import spmd_pipeline_1f1b
    hcg = fleet_init(dp=dp, pp=pp)
    a = inputs["dryrun"]
    s = hcg.get_stage_id()
    per = 4 // pp  # the stages' w and b stack [4, ...]: pp blocks of per

    def stage_fn(params, x):
        for w, b in zip(*params):
            x = _stage_fn((w, b), x)
        return x

    sp = (torch.from_numpy(a["w"][s * per:(s + 1) * per]),
          torch.from_numpy(a["b"][s * per:(s + 1) * per]))
    r, b = hcg.get_data_parallel_rank(), MB // dp
    ids = torch.from_numpy(a["ids"][:, r * b:(r + 1) * b])
    labels = torch.from_numpy(a["labels"][:, r * b:(r + 1) * b])
    loss, gP, gE, gH = spmd_pipeline_1f1b(
        stage_fn, _last_fn, sp, torch.from_numpy(a["head"]), ids, labels,
        first_fn=_first_fn, first_params=torch.from_numpy(a["emb"]),
        group=hcg.get_pipe_parallel_group())
    dpg = hcg.get_data_parallel_group()
    for t in (loss, *gP, gE, gH):
        collective.all_reduce(t, op=collective.ReduceOp.AVG, group=dpg)
    return {"stage": s, "loss": float(loss),
            "gw": gP[0].numpy(), "gb": gP[1].numpy(), "gE": gE.numpy(),
            "gH": gH.numpy()}


def _gpipe(inputs, pp):
    """spmd_pipeline (one dryrun layer a stage) and
    pipelined_transformer_step's loss over the pipe group."""
    from paddle_tpu_torch.parallel import (pipelined_transformer_step,
                                           spmd_pipeline)
    hcg = fleet_init(pp=pp)
    a = inputs["dryrun"]
    s, group = hcg.get_stage_id(), hcg.get_pipe_parallel_group()
    sp = (torch.from_numpy(a["w"][s]), torch.from_numpy(a["b"][s]))
    emb = torch.from_numpy(a["emb"])
    micro = emb[torch.from_numpy(a["ids"])]
    out = spmd_pipeline(_stage_fn, sp, micro, group=group)
    loss_fn = pipelined_transformer_step(
        _stage_fn, lambda other, ids: other[0][ids],
        lambda other, h, y: _last_fn(other[1], h, y))
    loss = loss_fn(sp, (emb, torch.from_numpy(a["head"])),
                   torch.from_numpy(a["ids"]), torch.from_numpy(a["labels"]),
                   group=group)
    return {"out": out.numpy(), "loss": float(loss)}


def _train_batch(inputs):
    """GPT's PipelineLayer at pp 2 through train_batch, one step."""
    import paddle_tpu_torch
    from paddle_tpu_torch import bridge, optimizer
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.models import gpt
    fleet_init(pp=2, pipeline_configs={"accumulate_steps": PIPE_M,
                                       "micro_batch_size": 1})
    paddle_tpu_torch.seed(1)
    layer = gpt.build_pipeline_layer(gpt.GPTConfig(**GPT), num_stages=2,
                                     loss_fn=_lm_loss, device="cpu")
    bridge.load_reference_state(layer, inputs["pipe_weights"])
    model = fleet.distributed_model(layer)
    opt = fleet.distributed_optimizer(optimizer.AdamW(
        parameters=layer.parameters(), learning_rate=PIPE_LR))
    ids = torch.from_numpy(inputs["pipe_ids"])
    eval_loss = model.eval_batch((ids, ids))  # the weights before the step
    out = model(ids)  # the pipelined forward: logits on the last stage
    loss = model.train_batch((ids, ids), opt)
    return {"loss": float(loss), "eval_loss": float(eval_loss),
            "forward": None if out is None else tuple(out.shape),
            "stage": layer.stage_id, "schedule": model._last_schedule,
            "max_in_flight": model.max_in_flight(),
            "weights": {k: v.detach().numpy().copy()
                        for k, v in layer.state_dict().items()}}


def _gpt_1f1b(inputs, dp, pp):
    import paddle_tpu_torch
    from paddle_tpu_torch import bridge
    from paddle_tpu_torch.models import gpt
    hcg = fleet_init(dp=dp, pp=pp)
    paddle_tpu_torch.seed(1)
    model = gpt.GPTForCausalLM(gpt.GPTConfig(**GPT), device="cpu")
    bridge.load_reference_state(model, inputs["gpt_weights"])
    run, (_, _, _, leaf_names) = gpt.build_gpt_1f1b_step(
        model, axis_pp="pp", axis_dp="dp" if dp > 1 else None)
    ids = torch.from_numpy(inputs["gpt_micro"])
    loss, (gP, gF, gL) = run(ids, ids)
    return {"stage": hcg.get_stage_id(), "loss": float(loss),
            "leaf_names": leaf_names,
            "gP": [[g.numpy() for g in blk] for blk in gP],
            "gF": [g.numpy() for g in gF], "gL": [g.numpy() for g in gL]}


def rank_task(task, inputs, rank, world):
    from paddle_tpu_torch.distributed.fleet.base import topology
    if world == 2:
        out = {"spmd_pp2": _spmd(inputs, 1, 2),
               "gpipe_pp2": _gpipe(inputs, 2),
               "train_batch_pp2": _train_batch(inputs),
               "gpt_1f1b_dp1_pp2": _gpt_1f1b(inputs, 1, 2)}
    else:
        out = {"spmd_pp4": _spmd(inputs, 1, 4),
               "gpipe_pp4": _gpipe(inputs, 4),
               "spmd_dp2_pp2": _spmd(inputs, 2, 2),
               "gpt_1f1b_dp2_pp2": _gpt_1f1b(inputs, 2, 2)}
    topology.set_hybrid_communicate_group(None)
    return out


# -- the reference side -------------------------------------------------------

def _ref_spmd(a, dp, pp):
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    import paddle_tpu.distributed as dist
    from paddle_tpu.parallel import spmd_pipeline_1f1b
    mesh = dist.make_mesh({"dp": dp, "pp": pp},
                          devices=jax.devices()[:dp * pp])

    def stage_fn(params, x):
        def body(h, wb):
            wi, bi = wb
            return jnp.tanh(h @ wi + bi) + h, None
        return jax.lax.scan(body, x, params)[0]

    def last_fn(hw, x, y):
        logp = jax.nn.log_softmax(x @ hw, axis=-1)
        return -jnp.mean(jnp.take_along_axis(logp, y[..., None], axis=-1))

    def inner(w, b, e, hw, x, y):
        loss, gP, gE, gH = spmd_pipeline_1f1b(
            stage_fn, last_fn, (w, b), hw, x, y,
            first_fn=lambda e_, ids: e_[ids], first_params=e,
            axis_name="pp")
        pm = lambda g: jax.lax.pmean(g, "dp")  # noqa: E731
        return pm(loss), jax.tree_util.tree_map(pm, gP), pm(gE), pm(gH)

    per = 4 // pp
    w = a["w"].reshape(pp, per, H, H)
    b = a["b"].reshape(pp, per, H)
    f = jax.jit(jax.shard_map(
        inner, mesh=mesh,
        in_specs=(P("pp"), P("pp"), P(), P(), P(None, "dp"), P(None, "dp")),
        out_specs=(P(), (P("pp"), P("pp")), P(), P())))
    loss, (gw, gb), gE, gH = f(w, b, a["emb"], a["head"],
                               a["ids"].astype(np.int32),
                               a["labels"].astype(np.int32))
    return {"loss": float(loss), "gw": np.asarray(gw), "gb": np.asarray(gb),
            "gE": np.asarray(gE), "gH": np.asarray(gH)}


def _ref_gpipe(a, pp):
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    import paddle_tpu.distributed as dist
    from paddle_tpu.parallel import (pipelined_transformer_step,
                                     spmd_pipeline)
    mesh = dist.make_mesh({"pp": pp}, devices=jax.devices()[:pp])

    def stage_fn(params, x):
        w, b = params
        return jnp.tanh(x @ w + b) + x

    def head_loss(other, h, y):
        logp = jax.nn.log_softmax(h @ other[1], axis=-1)
        return -jnp.mean(jnp.take_along_axis(logp, y[..., None], axis=-1))

    w, b = a["w"][:pp], a["b"][:pp]
    micro = a["emb"][a["ids"]]
    out = jax.jit(jax.shard_map(
        lambda w_, b_, m: spmd_pipeline(stage_fn, (w_, b_), m, "pp"),
        mesh=mesh, in_specs=(P("pp"), P("pp"), P()), out_specs=P()))(
            w, b, micro)
    loss_fn = pipelined_transformer_step(
        stage_fn, lambda other, ids: other[0][ids], head_loss)
    loss = jax.jit(jax.shard_map(
        lambda w_, b_, e, hd, ids, y: loss_fn((w_, b_), (e, hd), ids, y),
        mesh=mesh, in_specs=(P("pp"), P("pp"), P(), P(), P(), P()),
        out_specs=P()))(w, b, a["emb"], a["head"], a["ids"].astype(np.int32),
                        a["labels"].astype(np.int32))
    return {"out": np.asarray(out), "loss": float(loss)}


def _reference_inputs():
    import jax
    import paddle_tpu as paddle
    import paddle_tpu.distributed as dist
    from paddle_tpu.distributed import fleet as ref_fleet
    from paddle_tpu.distributed import parallel_env as ref_env
    from paddle_tpu.distributed.fleet.base import topology as ref_topo
    from paddle_tpu.models import gpt as ref_gpt

    a = _dryrun_arrays()
    inputs, ref = {"dryrun": a}, {}
    for dp, pp in ((1, 2), (1, 4), (2, 2)):
        ref[f"spmd_dp{dp}_pp{pp}"] = _ref_spmd(a, dp, pp)
    for pp in (2, 4):
        ref[f"gpipe_pp{pp}"] = _ref_gpipe(a, pp)

    cfg = ref_gpt.GPTConfig(**GPT)
    paddle.seed(0)
    model = ref_gpt.GPTForCausalLM(cfg)
    inputs["gpt_weights"] = {k: np.asarray(v.numpy())
                             for k, v in model.state_dict().items()}
    micro = np.random.RandomState(1).randint(
        0, GPT["vocab_size"], (2, 4, GPT["max_seq_len"])).astype(np.int32)
    inputs["gpt_micro"] = micro
    for dp in (1, 2):
        mesh = dist.make_mesh({"dp": dp, "pp": 2},
                              devices=jax.devices()[:2 * dp])
        run, (_, _, _, leaf_names) = ref_gpt.build_gpt_1f1b_step(
            model, mesh, axis_pp="pp", axis_dp="dp" if dp > 1 else None)
        loss, (gP, gF, gL) = run(micro, micro)
        ref[f"gpt_1f1b_dp{dp}_pp2"] = {
            "loss": float(loss), "leaf_names": leaf_names,
            "gP": [np.asarray(g) for g in gP],
            "gF": [np.asarray(g) for g in gF],
            "gL": [np.asarray(g) for g in gL]}

    strategy = ref_fleet.DistributedStrategy()
    strategy.hybrid_configs = {"dp_degree": 1, "mp_degree": 1,
                               "pp_degree": 2, "sharding_degree": 1}
    strategy.pipeline_configs = {"accumulate_steps": PIPE_M,
                                 "micro_batch_size": 1}
    try:
        ref_fleet.init(is_collective=True, strategy=strategy)
        paddle.seed(0)
        layer = ref_gpt.build_pipeline_layer(
            cfg, num_stages=2, loss_fn=lambda lo, la: model.loss(lo, la))
        inputs["pipe_weights"] = {k: np.asarray(v.numpy())
                                  for k, v in layer.state_dict().items()}
        ids = np.random.RandomState(2).randint(
            0, GPT["vocab_size"], (PIPE_M, GPT["max_seq_len"])
        ).astype(np.int32)
        inputs["pipe_ids"] = ids
        pipe = ref_fleet.distributed_model(layer)
        opt = paddle.optimizer.AdamW(parameters=layer.parameters(),
                                     learning_rate=PIPE_LR)
        loss = pipe.train_batch((paddle.to_tensor(ids),
                                 paddle.to_tensor(ids)), opt)
        ref["train_batch_pp2"] = {
            "loss": float(np.asarray(loss.numpy())),
            "schedule": list(pipe._last_schedule),
            "max_in_flight": pipe.max_in_flight(),
            "weights": {k: np.asarray(v.numpy())
                        for k, v in layer.state_dict().items()}}
    finally:
        ref_env.set_mesh(None)
        ref_topo.set_hybrid_communicate_group(None)
    return inputs, ref


@pytest.fixture(scope="module")
def reference():
    return _reference_inputs()


@pytest.fixture(scope="module")
def pp2(reference, tmp_path_factory):
    return spawn(tmp_path_factory.mktemp("pp2"), 2, "test_torch_pipeline",
                 "pp2", reference[0])


@pytest.fixture(scope="module")
def pp4(reference, tmp_path_factory):
    return spawn(tmp_path_factory.mktemp("pp4"), 4, "test_torch_pipeline",
                 "pp4", reference[0])


@pytest.mark.parametrize("arm", ["spmd_pp2", "spmd_pp4", "spmd_dp2_pp2"])
def test_spmd_pipeline_1f1b_matches_the_reference(pp2, pp4, reference, arm):
    _, ref = reference
    ranks = pp2 if arm == "spmd_pp2" else pp4
    want = ref[{"spmd_pp2": "spmd_dp1_pp2", "spmd_pp4": "spmd_dp1_pp4",
                "spmd_dp2_pp2": "spmd_dp2_pp2"}[arm]]
    dp = 2 if arm == "spmd_dp2_pp2" else 1
    for got in (r[arm] for r in ranks):
        s = got["stage"]
        assert abs(got["loss"] - want["loss"]) <= LOSS_REL * want["loss"]
        # the reference sums the stage gradients over dp (see the module
        # docstring); the port's are the mean
        assert rel(dp * got["gw"], want["gw"][s]) <= GRAD_REL
        assert rel(dp * got["gb"], want["gb"][s]) <= GRAD_REL
        assert rel(got["gE"], want["gE"]) <= GRAD_REL
        assert rel(got["gH"], want["gH"]) <= GRAD_REL


@pytest.mark.parametrize("pp", [2, 4])
def test_spmd_pipeline_and_pipelined_step_match_the_reference(pp2, pp4,
                                                              reference, pp):
    want = reference[1][f"gpipe_pp{pp}"]
    for got in (r[f"gpipe_pp{pp}"] for r in (pp2 if pp == 2 else pp4)):
        assert rel(got["out"], want["out"]) <= GRAD_REL
        assert abs(got["loss"] - want["loss"]) <= LOSS_REL * want["loss"]


def test_train_batch_at_pp2_matches_the_reference(pp2, reference):
    _, ref = reference
    want = ref["train_batch_pp2"]
    held = set()
    for got in (r["train_batch_pp2"] for r in pp2):
        assert abs(got["loss"] - want["loss"]) <= LOSS_REL * want["loss"]
        assert abs(got["eval_loss"] - want["loss"]) <= LOSS_REL * \
            want["loss"]
        assert got["forward"] == ((PIPE_M, GPT["max_seq_len"],
                                   GPT["vocab_size"]) if got["stage"] == 1
                                  else None)
        assert got["schedule"] == want["schedule"]
        assert got["max_in_flight"] == want["max_in_flight"] == 2
        for n, w in got["weights"].items():
            assert updated_rel(n, w, want["weights"][n], GPT["hidden_size"],
                               PIPE_LR, steps=1) <= GRAD_REL, n
            held.add(n)
    assert held == set(want["weights"])  # the two stages hold the model


@pytest.mark.parametrize("arm", ["gpt_1f1b_dp1_pp2", "gpt_1f1b_dp2_pp2"])
def test_build_gpt_1f1b_step_matches_the_reference(pp2, pp4, reference,
                                                   arm):
    _, ref = reference
    want = ref[arm]
    ranks = pp2 if arm.endswith("dp1_pp2") else pp4
    dp = 2 if arm == "gpt_1f1b_dp2_pp2" else 1
    for got in (r[arm] for r in ranks):
        s = got["stage"]
        assert got["leaf_names"] == want["leaf_names"]
        assert abs(got["loss"] - want["loss"]) <= LOSS_REL * want["loss"]
        for i, blk in enumerate(got["gP"]):
            for j, g in enumerate(blk):
                assert rel(dp * g, want["gP"][j][s, i]) <= GRAD_REL, (i, j)
        for mine, theirs in zip(got["gF"] + got["gL"],
                                want["gF"] + want["gL"]):
            assert rel(mine, theirs) <= GRAD_REL
