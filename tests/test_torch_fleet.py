"""The fleet's topology, strategy and pipeline segmentation against the
reference, GPT-3 1.3B at full width against the reference, and every
hybrid path at degree 1 on a one-rank gloo world (the code the H100 runs,
``chip_smoke.py`` phase 10).

- Topology: rank <-> coordinate maps, the axis groups' rank lists and the
  ``HybridCommunicateGroup`` accessors equal the reference's
  ``CommunicateTopology`` and the device grid of its mesh, for (dp, pp,
  sharding, mp) = (2,1,1,2), (1,2,1,2) and (2,2,1,1). Pure Python on both
  sides.
- ``PipelineLayer`` segmentation (uniform, by parameter size, by layer
  class) equals the reference's on the same descriptions; each stage holds
  the reference's names of its layers.
- GPT-3 1.3B (hidden 2048, 16 heads: head dim 128) with one layer at
  1 x 128, float32: loss 1e-5 relative, gradients 1e-4 relative L2, after
  the bridge moved the reference's weights (the same math in another
  order).
- Degree 1 (one-rank groups on every axis, no shortcut): the ``use_mp``
  GPT under ``TensorParallel`` against the plain model from the same
  weights, two AdamW steps with the global-norm clip, bitwise (a one-rank
  all-reduce is a copy, and the row-parallel bias is added after the
  reduction as ``F.linear`` adds it after the product); ``PipelineParallel``
  at pp = 1 with 4 microbatches against 4 accumulated plain micro-steps of
  the same layer, bitwise, and its schedule the reference's for S = 1,
  M = 4; ``build_gpt_1f1b_step`` at pp = 1 against the same accumulation:
  the loss 1e-6 relative and gradients 1e-5 relative L2 (the stage is
  recomputed through ``functional_call``, in another order); ring, Ulysses
  and MoE on one-rank groups against their dense forms, 1e-6.
"""
import numpy as np
import pytest
import torch

from test_torch_hybrid import GPT, fleet_init, rel, spawn

DIMS = [(2, 1, 1, 2), (1, 2, 1, 2), (2, 2, 1, 1)]
NAMES = ("data", "pipe", "sharding", "model")
W1_LOSS, W1_GRAD, DEG1 = 1e-5, 1e-4, 1e-6


@pytest.fixture(autouse=True)
def _threads():
    torch.set_num_threads(2)


@pytest.mark.parametrize("dims", DIMS)
def test_topology_and_groups_equal_the_reference(dims):
    from paddle_tpu.distributed import parallel_env as ref_env
    from paddle_tpu.distributed.fleet.base import topology as ref_topo
    from paddle_tpu_torch.distributed.fleet.base import topology
    ref_t = ref_topo.CommunicateTopology(dims=dims)
    port_t = topology.CommunicateTopology(dims=dims)
    world = int(np.prod(dims))
    assert port_t.world_size() == ref_t.world_size() == world
    for r in range(world):
        assert port_t.get_coord(r) == {k: int(v) for k, v in
                                       ref_t.get_coord(r).items()}
        assert port_t.get_rank(**port_t.get_coord(r)) == r == ref_t.get_rank(
            **ref_t.get_coord(r))
    try:
        ref_hcg = ref_topo.HybridCommunicateGroup(topology=ref_t)
        grid = np.vectorize(lambda d: d.id)(ref_hcg.mesh.devices)
    finally:
        ref_env.set_mesh(None)
    assert grid.shape == tuple(dims)
    for i, name in enumerate(NAMES):
        lines = np.moveaxis(grid, i, -1).reshape(-1, dims[i]).tolist()
        assert port_t.get_comm_list(name) == lines, name
    for r in range(world):
        hcg = topology.HybridCommunicateGroup(topology=port_t, rank=r)
        coord = ref_t.get_coord(r)
        assert (hcg.get_data_parallel_world_size(),
                hcg.get_pipe_parallel_world_size(),
                hcg.get_sharding_parallel_world_size(),
                hcg.get_model_parallel_world_size()) == (
            ref_hcg.get_data_parallel_world_size(),
            ref_hcg.get_pipe_parallel_world_size(),
            ref_hcg.get_sharding_parallel_world_size(),
            ref_hcg.get_model_parallel_world_size())
        assert (hcg.get_data_parallel_rank(), hcg.get_stage_id(),
                hcg.get_sharding_parallel_rank(),
                hcg.get_model_parallel_rank()) == tuple(
            int(coord[n]) for n in NAMES)
        for name, group in zip(NAMES, (
                hcg.get_data_parallel_group(), hcg.get_pipe_parallel_group(),
                hcg.get_sharding_parallel_group(),
                hcg.get_model_parallel_group())):
            assert r in group.ranks and group.ranks in \
                port_t.get_comm_list(name)
            assert group.ranks[group.rank] == r
        assert hcg.mesh is None  # topology only: no process group here


def test_strategy_fields_equal_the_reference():
    from paddle_tpu.distributed.fleet import DistributedStrategy as Ref
    from paddle_tpu_torch.distributed.fleet import DistributedStrategy
    assert vars(DistributedStrategy()) == vars(Ref())


def _descs(pkg, device):
    from importlib import import_module
    mp = import_module(f"{pkg}.distributed.fleet.meta_parallel")
    nn = import_module(f"{pkg}.nn")
    kw = {} if device is None else {"device": device}
    sizes = [(4, 16), (16, 16), (16, 64), (64, 8), (8, 8), (8, 8), (8, 2)]
    return [mp.LayerDesc(nn.Linear, a, b, **kw) for a, b in sizes]


@pytest.mark.parametrize("k", [2, 3])
@pytest.mark.parametrize("method", ["uniform", "param_size",
                                    "layer:Linear"])
def test_pipeline_segmentation_equals_the_reference(k, method):
    from paddle_tpu.distributed.fleet.meta_parallel import \
        PipelineLayer as RefLayer
    from paddle_tpu_torch.distributed.fleet.meta_parallel import \
        PipelineLayer
    ref = RefLayer(_descs("paddle_tpu", None), num_stages=k,
                   seg_method=method)
    names = set()
    for s in range(k):
        port = PipelineLayer(_descs("paddle_tpu_torch", None), num_stages=k,
                             seg_method=method, stage_id=s, device="cpu")
        assert port._segments == ref._segments
        names |= set(port.state_dict())
        assert len(port.run_list) == ref._segments[s + 1] - ref._segments[s]
    assert names == set(ref.state_dict())


def test_rng_tracker_draws_per_mp_rank_and_restores():
    """The model-parallel state draws apart from the package's generator
    (seeded seed + 1024 + mp rank) and its states round trip."""
    import paddle_tpu_torch
    from paddle_tpu_torch.core.random import draw_generator
    from paddle_tpu_torch.distributed.fleet.meta_parallel import (
        get_rng_state_tracker, model_parallel_random_seed)
    tracker = get_rng_state_tracker()

    def draw():
        return torch.rand(4, generator=draw_generator("cpu"))
    try:
        model_parallel_random_seed(7)
        plain = draw()
        with tracker.rng_state():
            mp = draw()
        want = torch.rand(4, generator=torch.Generator().manual_seed(
            7 + 1024))
        assert torch.equal(mp, want) and not torch.equal(mp, plain)
        saved = tracker.get_states_tracker()
        with tracker.rng_state():
            first = draw()
        tracker.set_states_tracker(saved)
        with tracker.rng_state():
            assert torch.equal(draw(), first)
        paddle_tpu_torch.seed(7)
        assert torch.equal(draw(), plain)  # the package's stream untouched
        with pytest.raises(ValueError, match="already exists"):
            tracker.add("other", 7 + 1024)
    finally:
        tracker.reset()


def test_gpt3_1p3b_width_matches_the_reference():
    import paddle_tpu as paddle
    from paddle_tpu.models import gpt as ref_gpt
    from paddle_tpu_torch.bridge import load_reference_state
    from paddle_tpu_torch.models import gpt
    cfg = gpt.gpt3_1p3b(num_layers=1, hidden_dropout=0.0,
                        attention_dropout=0.0)
    assert (cfg.hidden_size, cfg.num_heads, cfg.vocab_size,
            cfg.max_seq_len) == (2048, 16, 50304, 1024)
    assert cfg.hidden_size // cfg.num_heads == 128
    paddle.seed(0)
    ref = ref_gpt.GPTForCausalLM(ref_gpt.GPTConfig(
        hidden_size=2048, num_layers=1, num_heads=16, hidden_dropout=0.0,
        attention_dropout=0.0))
    port = gpt.GPTForCausalLM(cfg, device="cpu")
    load_reference_state(port, {k: np.asarray(v.numpy())
                                for k, v in ref.state_dict().items()})
    ids = np.random.RandomState(0).randint(0, cfg.vocab_size,
                                           (1, 128)).astype("int32")
    want = ref.loss(ref(paddle.to_tensor(ids)), paddle.to_tensor(ids))
    want.backward()
    got = port.loss(port(torch.from_numpy(ids)), torch.from_numpy(ids))
    got.backward()
    assert abs(got.item() - float(want)) <= W1_LOSS * abs(float(want))
    for n, p in ref.named_parameters():
        mine = dict(port.named_parameters())[n].grad.numpy()
        assert rel(mine, np.asarray(p.grad.numpy())) <= W1_GRAD, n


# -- degree 1 on a one-rank gloo world ------------------------------------------

def _steps(model, opt, ids, n):
    losses, grads = [], []
    for _ in range(n):
        loss = model.loss(model(ids), ids)
        loss.backward()
        grads.append({k: p.grad.clone() for k, p in model.named_parameters()})
        opt.step()
        opt.clear_grad()
        losses.append(loss.detach())
    return losses, grads


def _degree1_tp(ids):
    import paddle_tpu_torch
    from paddle_tpu_torch import nn, optimizer
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.distributed.fleet.meta_parallel import \
        TensorParallel
    from paddle_tpu_torch.distributed.parallel import DataParallel
    from paddle_tpu_torch.models import gpt
    hcg = fleet_init()
    paddle_tpu_torch.seed(3)
    plain = gpt.GPTForCausalLM(gpt.GPTConfig(**GPT), device="cpu")
    mp = gpt.GPTForCausalLM(gpt.GPTConfig(**GPT, use_mp=True), device="cpu")
    mp.set_state_dict(plain.state_dict())
    wrapped = fleet.distributed_model(plain)
    out = {"wrapper": type(wrapped).__name__}

    def opt(m, hybrid):
        o = optimizer.AdamW(parameters=m.parameters(), learning_rate=1e-2,
                            grad_clip=nn.ClipGradByGlobalNorm(1.0))
        return fleet.distributed_optimizer(o) if hybrid else o
    want = _steps(plain, opt(plain, False), ids, 2)
    tp = TensorParallel(mp, hcg)
    got = _steps(mp, opt(tp, True), ids, 2)
    out["tp_bitwise"] = all(torch.equal(a, b) for a, b in zip(want[0],
                                                              got[0])) and \
        all(torch.equal(w[k], g[k]) for w, g in zip(want[1], got[1])
            for k in w)
    out["dp_is_data_parallel"] = isinstance(wrapped, DataParallel)
    return out


def _degree1_pipeline(ids):
    import paddle_tpu_torch
    from paddle_tpu_torch import optimizer
    from paddle_tpu_torch.distributed.fleet.meta_parallel import \
        PipelineParallel
    from paddle_tpu_torch.models import gpt
    from test_torch_pipeline import _lm_loss
    cfg = gpt.GPTConfig(**GPT)
    hcg = fleet_init(pipeline_configs={"accumulate_steps": 4})
    from paddle_tpu_torch.distributed.fleet.base import fleet_base

    def layer():
        paddle_tpu_torch.seed(4)
        return gpt.build_pipeline_layer(cfg, 1, loss_fn=_lm_loss,
                                        device="cpu")
    pipe_layer, plain = layer(), layer()
    pp = PipelineParallel(pipe_layer, hcg, fleet_base._strategy)
    o1 = optimizer.AdamW(parameters=pipe_layer.parameters(),
                         learning_rate=1e-2)
    loss = pp.train_batch((ids, ids), o1)
    o2 = optimizer.AdamW(parameters=plain.parameters(), learning_rate=1e-2)
    total = torch.zeros(())
    for x in ids.chunk(4):
        micro = _lm_loss(plain(x), x) / 4
        micro.backward()
        total += micro.detach()
    o2.step()
    out = {"schedule": pp._last_schedule, "loss_bitwise": torch.equal(
        loss, total), "params_bitwise": all(
        torch.equal(a, b) for a, b in zip(pipe_layer.parameters(),
                                          plain.parameters()))}

    # build_gpt_1f1b_step at pp = 1 against the same accumulation
    paddle_tpu_torch.seed(5)
    model = gpt.GPTForCausalLM(cfg, device="cpu")
    run, (sp, fp, lp, _) = gpt.build_gpt_1f1b_step(model, axis_pp="pp")
    step_loss, (gP, gF, gL) = run(ids.reshape(4, 1, -1),
                                  ids.reshape(4, 1, -1))
    acc = torch.zeros(())
    for x in ids.chunk(4):
        micro = model.loss(model(x), x) / 4
        micro.backward()
        acc += micro.detach()
    errs = [rel(g, p.grad) for blk, pblk in zip(gP, sp)
            for g, p in zip(blk, pblk)]
    errs += [rel(gF[1], fp[1].grad), rel(gL[0], lp[0].grad),
             rel(gL[1], lp[1].grad), rel(gF[0] + gL[2], fp[0].grad)]
    out["f1b_loss_rel"] = abs(float(step_loss) - float(acc)) / float(acc)
    out["f1b_grad_rel"] = max(errs)
    return out


def _degree1_sp_ep():
    from paddle_tpu_torch.distributed import collective
    from paddle_tpu_torch.parallel import (moe_ffn, ring_attention,
                                           ulysses_attention)
    from paddle_tpu_torch.parallel.ring_attention import _full_attention
    g = collective.new_group([0], axis_name="sp")
    rng = np.random.RandomState(6)
    q, k, v = (torch.from_numpy(rng.randn(2, 16, 4, 8).astype("float32"))
               for _ in range(3))
    errs = {}
    for causal in (False, True):
        want = _full_attention(q, k, v, causal=causal)
        errs[f"ring causal={causal}"] = rel(
            ring_attention(q, k, v, group=g, causal=causal), want)
        errs[f"ulysses causal={causal}"] = rel(
            ulysses_attention(q, k, v, group=g, causal=causal), want)
    x = torch.from_numpy(rng.randn(12, 8).astype("float32"))
    ws = [torch.from_numpy(rng.randn(*s).astype("float32") * 0.2) for s in
          ((8, 4), (4, 8, 16), (4, 16), (4, 16, 8), (4, 8))]
    y1, a1 = moe_ffn(x, *ws, group=g)
    y0, a0 = moe_ffn(x, *ws)
    errs["moe"] = max(rel(y1, y0), abs(float(a1) - float(a0)) / float(a0))
    return errs


def _degree1_errors():
    from paddle_tpu_torch import optimizer
    from paddle_tpu_torch.distributed import fleet
    out = {}
    # on a collective fleet the parameter-server entry points raise by name
    # (no PS runtime), and stop_worker is a no-op, as the reference's
    for name in ("init_server", "run_server", "init_worker", "ps_step"):
        try:
            getattr(fleet, name)()
        except RuntimeError as e:
            out[name] = str(e)
    out["stop_worker"] = fleet.stop_worker()
    s = fleet.DistributedStrategy()
    s.amp = True
    # strategy.amp is ported: it resolves to the reference's stack
    out["amp"] = fleet.distributed_optimizer(optimizer.AdamW(
        parameters=[torch.nn.Parameter(torch.zeros(2))]),
        s)._meta_optimizer_names
    # a_sync selects the PS mode and no meta-optimizer: passed through
    s = fleet.DistributedStrategy()
    s.a_sync = True
    inner = optimizer.AdamW(parameters=[torch.nn.Parameter(torch.zeros(2))])
    out["a_sync_inner"] = fleet.distributed_optimizer(
        inner, s)._inner_opt is inner
    try:
        fleet_init(dp=2)
    except ValueError as e:
        out["world"] = str(e)
    # strategy.recompute wraps the sublayers its checkpoints name
    from paddle_tpu_torch.models import gpt
    fleet_init(recompute=True,
               recompute_configs={"checkpoints": ["blocks.1"]})
    model = gpt.GPTForCausalLM(gpt.GPTConfig(**GPT), device="cpu")
    fleet.distributed_model(model)
    out["recompute"] = [getattr(b, "_recompute_policy", None)
                        for b in model.gpt.blocks]
    return out


def rank_task(task, inputs, rank, world):
    ids = torch.from_numpy(np.random.RandomState(7).randint(
        0, GPT["vocab_size"], (4, GPT["max_seq_len"])))
    return {"tp": _degree1_tp(ids), "pipeline": _degree1_pipeline(ids),
            "sp_ep": _degree1_sp_ep(), "errors": _degree1_errors()}


@pytest.fixture(scope="module")
def degree1(tmp_path_factory):
    return spawn(tmp_path_factory.mktemp("degree1"), 1, "test_torch_fleet",
                 "degree1", {})[0]


def test_degree1_tensor_parallel_is_bitwise_the_plain_model(degree1):
    assert degree1["tp"]["wrapper"] == "DataParallel"
    assert degree1["tp"]["dp_is_data_parallel"]
    assert degree1["tp"]["tp_bitwise"]


def test_degree1_pipeline_is_bitwise_plain_accumulation(degree1):
    got = degree1["pipeline"]
    assert got["schedule"] == [(k, m) for m in range(4) for k in "FB"]
    assert got["loss_bitwise"] and got["params_bitwise"]
    assert got["f1b_loss_rel"] <= DEG1
    assert got["f1b_grad_rel"] <= 10 * DEG1


def test_degree1_sequence_and_expert_parallel_match_the_dense_forms(
        degree1):
    assert max(degree1["sp_ep"].values()) <= DEG1, degree1["sp_ep"]


def test_parameter_server_and_unported_switches_raise(degree1):
    errors = degree1["errors"]
    for name in ("init_server", "run_server", "init_worker", "ps_step"):
        assert "parameter-server role" in errors[name]
    assert errors["stop_worker"] is None
    assert errors["amp"] == ["amp"]
    assert errors["a_sync_inner"] is True
    assert "need a world of 2 ranks" in errors["world"]
    assert errors["recompute"] == [None, "full"]
