"""Sequence and expert parallelism of the port on the CPU, over gloo,
against the reference: ``ring_attention`` and ``ulysses_attention`` at
sp = 2 and 4, causal and not; ``moe_ffn`` at ep = 2 and 4 against the
reference's dense form (no drops) and its ep form (with capacity drops);
``switch_route``; ``MoELayer``.

The ranks are spawned by ``test_torch_hybrid.spawn``; the reference runs in
the parent under ``shard_map`` on the 8-device CPU mesh (the dryrun's
``_dryrun_sequence_parallel`` and ``_dryrun_expert_parallel``,
``__graft_entry__.py:350-420``). Gradients are of ``sum(out * c)`` for a
fixed ``c``: the reference differentiates the global function, each port
rank its part, whose sum is the same loss.

Bounds, float32: outputs and gradients 1e-5 relative L2, aux losses 1e-6
relative (the same math in another order); routing decisions exactly.
"""
import numpy as np
import pytest
import torch

from test_torch_hybrid import rel, spawn

OUT_REL, AUX_REL = 1e-5, 1e-6
B, S_PER, H, D = 2, 8, 4, 16            # attention: [B, S_PER * sp, H, D]
T_PER, DM, F, E_LOCAL = 16, 8, 16, 2    # moe: T_PER tokens and 2 experts a rank
CAPS = {"nodrop": 100.0, "drop": 1.0}


def _attn_inputs(sp):
    rng = np.random.RandomState(sp)
    qkv = [(rng.randn(B, S_PER * sp, H, D) * 0.5).astype(np.float32)
           for _ in range(3)]
    c = rng.randn(B, S_PER * sp, H, D).astype(np.float32)
    return qkv, c


def _moe_inputs(ep):
    rng = np.random.RandomState(10 + ep)
    E = E_LOCAL * ep
    return {"x": (rng.randn(T_PER * ep, DM) * 0.5).astype(np.float32),
            "gw": rng.randn(DM, E).astype(np.float32),
            "w1": (rng.randn(E, DM, F) * 0.2).astype(np.float32),
            "b1": (rng.randn(E, F) * 0.1).astype(np.float32),
            "w2": (rng.randn(E, F, DM) * 0.2).astype(np.float32),
            "b2": (rng.randn(E, DM) * 0.1).astype(np.float32),
            "c": rng.randn(T_PER * ep, DM).astype(np.float32)}


# -- the port's side ------------------------------------------------------------

def _attention(group, sp, rank):
    from paddle_tpu_torch.parallel import ring_attention, ulysses_attention
    (q, k, v), c = _attn_inputs(sp)
    sl = np.s_[:, rank * S_PER:(rank + 1) * S_PER]
    out = {}
    for name, fn in (("ring", ring_attention), ("ulysses", ulysses_attention)):
        for causal in (False, True):
            ts = [torch.from_numpy(a[sl].copy()).requires_grad_()
                  for a in (q, k, v)]
            o = fn(*ts, group=group, causal=causal)
            (o * torch.from_numpy(c[sl].copy())).sum().backward()
            out[(name, causal)] = {"out": o.detach().numpy(),
                                   "grads": [t.grad.numpy() for t in ts]}
    return out


def _moe(group, ep, rank):
    from paddle_tpu_torch.distributed import collective
    from paddle_tpu_torch.parallel import moe_ffn
    a = _moe_inputs(ep)
    toks = np.s_[rank * T_PER:(rank + 1) * T_PER]
    exps = np.s_[rank * E_LOCAL:(rank + 1) * E_LOCAL]
    out = {}
    for cap_name, cap in CAPS.items():
        t = {k: torch.from_numpy(a[k][exps].copy()).requires_grad_()
             for k in ("w1", "b1", "w2", "b2")}
        x = torch.from_numpy(a["x"][toks].copy()).requires_grad_()
        gw = torch.from_numpy(a["gw"]).requires_grad_()
        y, aux = moe_ffn(x, gw, t["w1"], t["b1"], t["w2"], t["b2"],
                         group=group, capacity_factor=cap)
        (y * torch.from_numpy(a["c"][toks].copy())).sum().backward()
        g_gate = gw.grad.clone()
        collective.all_reduce(g_gate, group=group)
        out[cap_name] = {"y": y.detach().numpy(), "aux": float(aux),
                         "dx": x.grad.numpy(), "dgate": g_gate.numpy(),
                         **{"d" + k: v.grad.numpy() for k, v in t.items()}}
    return out


def _moe_layer(group, ep, rank):
    """MoELayer.shard_experts at ep against the same layer unsharded on all
    tokens (no drops)."""
    from paddle_tpu_torch.incubate import MoELayer
    x = np.random.RandomState(5).randn(ep * 6, DM).astype(np.float32)
    dense = MoELayer(DM, F, E_LOCAL * ep, capacity_factor=100.0,
                     name="moe_twin", device="cpu")
    want = dense(torch.from_numpy(x)).detach().numpy()
    layer = MoELayer(DM, F, E_LOCAL * ep, capacity_factor=100.0,
                     name="moe_twin", device="cpu").shard_experts(group)
    got = layer(torch.from_numpy(x[rank * 6:(rank + 1) * 6].copy()))
    return {"y": got.detach().numpy(), "want": want[rank * 6:(rank + 1) * 6],
            "local_w1": tuple(layer.w1.shape)}


def rank_task(task, inputs, rank, world):
    from paddle_tpu_torch.distributed import collective
    group = collective.new_group(list(range(world)), axis_name="sp")
    return {"attention": _attention(group, world, rank),
            "moe": _moe(group, world, rank),
            "moe_layer": _moe_layer(group, world, rank)}


# -- the reference side -------------------------------------------------------

def _reference(n):
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    import paddle_tpu.distributed as dist
    from paddle_tpu.parallel import (moe_ffn, ring_attention,
                                     ulysses_attention)
    mesh = dist.make_mesh({"sp": n}, devices=jax.devices()[:n])
    ref = {"attention": {}, "moe": {}}
    (q, k, v), c = _attn_inputs(n)
    for name, fn in (("ring", ring_attention), ("ulysses", ulysses_attention)):
        for causal in (False, True):
            f = jax.shard_map(
                lambda a, b_, c_, fn=fn, causal=causal: fn(
                    a, b_, c_, "sp", causal=causal),
                mesh=mesh, in_specs=(P(None, "sp"),) * 3,
                out_specs=P(None, "sp"))
            loss = jax.jit(jax.value_and_grad(
                lambda a, b_, c_, f=f: jnp.sum(f(a, b_, c_) * c),
                argnums=(0, 1, 2)))
            _, grads = loss(q, k, v)
            ref["attention"][(name, causal)] = {
                "out": np.asarray(jax.jit(f)(q, k, v)),
                "grads": [np.asarray(g) for g in grads]}
    a = _moe_inputs(n)
    args = [jnp.asarray(a[k]) for k in ("x", "gw", "w1", "b1", "w2", "b2")]
    for cap_name, cap in CAPS.items():
        f = jax.shard_map(
            lambda *z, cap=cap: moe_ffn(*z, axis_name="sp",
                                        capacity_factor=cap),
            mesh=mesh, in_specs=(P("sp"), P(), P("sp"), P("sp"), P("sp"),
                                 P("sp")),
            out_specs=(P("sp"), P()))
        y, aux = jax.jit(f)(*args)
        grads = jax.jit(jax.grad(lambda *z, f=f: jnp.sum(f(*z)[0] * a["c"]),
                                 argnums=tuple(range(6))))(*args)
        ref["moe"][cap_name] = {
            "y": np.asarray(y), "aux": float(aux),
            **{"d" + k: np.asarray(g) for k, g in zip(
                ("x", "gate", "w1", "b1", "w2", "b2"), grads)}}
    y_dense, aux_dense = moe_ffn(*args, capacity_factor=CAPS["nodrop"])
    ref["moe"]["dense"] = {"y": np.asarray(y_dense),
                           "aux": float(aux_dense)}
    return ref


@pytest.fixture(scope="module")
def reference():
    return {n: _reference(n) for n in (2, 4)}


@pytest.fixture(scope="module")
def worlds(reference, tmp_path_factory):
    return {n: spawn(tmp_path_factory.mktemp(f"sp{n}"), n,
                     "test_torch_sequence_expert", f"sp{n}", {})
            for n in (2, 4)}


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("name", ["ring", "ulysses"])
@pytest.mark.parametrize("causal", [False, True])
def test_sequence_parallel_attention_matches_the_reference(
        worlds, reference, n, name, causal):
    want = reference[n]["attention"][(name, causal)]
    for rank, res in enumerate(worlds[n]):
        got = res["attention"][(name, causal)]
        sl = np.s_[:, rank * S_PER:(rank + 1) * S_PER]
        assert rel(got["out"], want["out"][sl]) <= OUT_REL
        for g, w in zip(got["grads"], want["grads"]):
            assert rel(g, w[sl]) <= OUT_REL


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("cap", ["nodrop", "drop"])
def test_moe_ffn_matches_the_reference_ep_form(worlds, reference, n, cap):
    want = reference[n]["moe"][cap]
    dropped = 0
    for rank, res in enumerate(worlds[n]):
        got = res["moe"][cap]
        toks = np.s_[rank * T_PER:(rank + 1) * T_PER]
        exps = np.s_[rank * E_LOCAL:(rank + 1) * E_LOCAL]
        assert rel(got["y"], want["y"][toks]) <= OUT_REL
        assert abs(got["aux"] - want["aux"]) <= AUX_REL * want["aux"]
        assert rel(got["dx"], want["dx"][toks]) <= OUT_REL
        assert rel(got["dgate"], want["dgate"]) <= OUT_REL
        for k in ("w1", "b1", "w2", "b2"):
            assert rel(got["d" + k], want["d" + k][exps]) <= OUT_REL, k
        dropped += int((np.abs(got["y"]).sum(-1) == 0).sum())
    assert (dropped > 0) == (cap == "drop")  # the drops are exercised


@pytest.mark.parametrize("n", [2, 4])
def test_moe_ffn_without_drops_matches_the_dense_form(worlds, reference, n):
    want = reference[n]["moe"]["dense"]
    got = np.concatenate([r["moe"]["nodrop"]["y"] for r in worlds[n]])
    assert rel(got, want["y"]) <= OUT_REL


@pytest.mark.parametrize("n", [2, 4])
def test_moe_layer_shard_experts(worlds, n):
    for res in worlds[n]:
        got = res["moe_layer"]
        assert got["local_w1"] == (E_LOCAL, DM, F)
        assert rel(got["y"], got["want"]) <= OUT_REL


def test_switch_route_and_moe_layer_match_the_reference():
    import jax.numpy as jnp

    import paddle_tpu as paddle
    from paddle_tpu.incubate.moe import MoELayer as RefMoELayer
    from paddle_tpu.parallel import switch_route as ref_route
    from paddle_tpu_torch.incubate import MoELayer
    from paddle_tpu_torch.parallel import switch_route
    a = _moe_inputs(2)
    for cap in (3, 100):
        got = switch_route(torch.from_numpy(a["x"]), torch.from_numpy(a["gw"]),
                           4, cap)
        want = ref_route(jnp.asarray(a["x"]), jnp.asarray(a["gw"]), 4, cap)
        for g, w in zip(got[:2], want[:2]):
            assert np.array_equal(g.numpy(), np.asarray(w))
        for g, w in zip(got[2:], want[2:]):
            assert rel(g.numpy(), np.asarray(w)) <= OUT_REL
    ref = RefMoELayer(DM, F, 4, name="moe_twin")
    port = MoELayer(DM, F, 4, name="moe_twin", device="cpu")
    for n, p in port.named_parameters():
        assert np.array_equal(p.detach().numpy(),
                              np.asarray(getattr(ref, n).numpy())), n
    x = a["x"][:12]
    want = np.asarray(ref(paddle.to_tensor(x)).numpy())
    got = port(torch.from_numpy(x))
    assert rel(got.detach().numpy(), want) <= OUT_REL
    assert abs(float(port.aux_loss.detach()) - float(ref.aux_loss)) <= \
        AUX_REL * float(ref.aux_loss)
