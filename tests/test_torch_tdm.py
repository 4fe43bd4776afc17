"""The port's TDM tree index, layer-wise sampler and ops against the
reference's, on the CPU (``tests/test_tdm.py``'s cases, each through both
packages).

- ``TreeIndex`` for item counts {1, 7, 16, 1000} and branches {2, 3, 4},
  and a tree given by dicts: every method and the three op feeds
  (``travel_array``, ``layer_array``, ``tree_info_array``) exactly.
- The validation errors, with the reference's messages.
- ``LayerWiseSampler.sample``, ``tdm_sampler`` and ``tdm_child`` exactly
  for the same seeds (the reference returns int32 ids without JAX's x64
  mode, the port int64: the values are compared).
- The two-tower retrieval loop of ``tests/test_tdm.py``: the same starting
  weights (moved over by ``bridge``), 20 Adam steps whose losses agree
  within ``LOSS_RTOL`` (the same float32 math in another library), then
  beam retrieval down the tree through ``tdm_child`` with the same hits.
"""
import gc

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.distributed.fleet import LayerWiseSampler as RefSampler
from paddle_tpu.distributed.fleet import TreeIndex as RefTree
import paddle_tpu_torch as pt
from paddle_tpu_torch import bridge
from paddle_tpu_torch.core.tensor import unwrap
from paddle_tpu_torch.distributed.fleet import LayerWiseSampler, TreeIndex
from paddle_tpu_torch.nn import functional as F

LOSS_RTOL = 1e-5
SIZES = [1, 7, 16, 1000]
BRANCHES = [2, 3, 4]


@pytest.fixture(autouse=True)
def _release():
    yield
    # the layers a test built may sit in reference cycles: collect them,
    # so no later test of this process finds them in the state ledger
    gc.collect()


def _np(t):
    return np.asarray(t.numpy() if hasattr(t, "numpy") else t)


def _same_tree(ref, got):
    """Every method of two trees agrees exactly."""
    assert (got.branch, got.height) == (ref.branch, ref.height)
    leafs = ref.get_all_leafs()
    assert got.get_all_leafs() == leafs
    assert got.emb_id_count() == ref.emb_id_count()
    codes = []
    for lvl in range(ref.height + 1):
        want = ref.get_layer_codes(lvl)
        assert got.get_layer_codes(lvl) == want
        codes += want
    for c in codes:
        assert got.layer_of(c) == ref.layer_of(c)
        assert got.get_children_codes(c) == ref.get_children_codes(c)
    probe = codes + [-1, max(codes) + 1, 10 ** 6]
    assert got.get_nodes(probe) == ref.get_nodes(probe)
    for start in (0, 1):
        for it in leafs[:50] + leafs[-50:]:
            assert got.get_travel_codes(it, start) == \
                ref.get_travel_codes(it, start)
    for lvl in range(ref.height):
        assert got.get_ancestor_codes(leafs[:64], lvl) == \
            ref.get_ancestor_codes(leafs[:64], lvl)
    for start in (0, 1):
        if start < ref.height:
            np.testing.assert_array_equal(got.travel_array(start),
                                          ref.travel_array(start))
        for g, r in zip(got.layer_array(start), ref.layer_array(start)):
            np.testing.assert_array_equal(g, r)
            assert g.dtype == np.int64
    np.testing.assert_array_equal(got.tree_info_array(),
                                  ref.tree_info_array())


@pytest.mark.parametrize("branch", BRANCHES)
@pytest.mark.parametrize("n", SIZES)
def test_tree_index_matches_the_reference(n, branch):
    items = np.random.RandomState(n).permutation(np.arange(1, n + 1)) + 3
    _same_tree(RefTree.from_items(items, branch=branch),
               TreeIndex.from_items(items, branch=branch))


def test_a_tree_given_by_dicts():
    ids = {0: 10, 1: 11, 2: 12, 3: 1, 4: 2, 5: 3}
    items = {1: 3, 2: 4, 3: 5}
    _same_tree(RefTree(2, 3, ids, items), TreeIndex(2, 3, ids, items))
    with pytest.raises(KeyError):
        TreeIndex(2, 3, ids, items).get_travel_codes(9)


def test_validation_errors_match_the_reference():
    for args, kw, match in (
            (([0, 1, 2],), {}, "positive"), (([1, 2],), {"branch": 1},
                                            "branch"),
            (([1, 1, 2],), {}, "duplicate"), (([5, 10 ** 9],), {}, "densify"),
            (([],), {}, "zero items")):
        with pytest.raises(ValueError, match=match) as want:
            RefTree.from_items(*args, **kw)
        with pytest.raises(ValueError, match=match) as got:
            TreeIndex.from_items(*args, **kw)
        assert str(got.value) == str(want.value)
    for pkg_tree, pkg_sampler in ((RefTree, RefSampler),
                                  (TreeIndex, LayerWiseSampler)):
        t = pkg_tree.from_items(np.arange(1, 5))
        with pytest.raises(ValueError, match="never terminate"):
            pkg_sampler(t, [1, 1, 1], start_sample_layer=0,
                        seed=0).sample([[1]], [2])
        with pytest.raises(ValueError, match="one entry per sampled"):
            pkg_sampler(t, [1], start_sample_layer=1)


@pytest.mark.parametrize("hierarchy", [False, True])
@pytest.mark.parametrize("seed", [0, 3, 17])
def test_layerwise_sampler_matches_the_reference(seed, hierarchy):
    ref_t = RefTree.from_items(np.arange(1, 41), branch=3)
    t = TreeIndex.from_items(np.arange(1, 41), branch=3)
    counts = [1, 2, 3, 3]
    users = [[5], [9], [40], [1]]
    targets = [3, 38, 17, 1]
    want = RefSampler(ref_t, counts, 1, seed).sample(users, targets,
                                                    hierarchy)
    got = LayerWiseSampler(t, counts, 1, seed).sample(users, targets,
                                                      hierarchy)
    assert got.dtype == np.int64
    np.testing.assert_array_equal(got, want)


def _feeds(tree):
    travel = tree.travel_array(start_level=1)
    layer_flat, offsets = tree.layer_array(start_level=1)
    return travel, layer_flat, offsets, np.diff(offsets).tolist()


@pytest.mark.parametrize("seed", [0, 7, 99])
def test_tdm_sampler_matches_the_reference(seed):
    t = TreeIndex.from_items(np.arange(1, 101), branch=2)
    travel, layer_flat, offsets, counts = _feeds(t)
    negs = [min(c - 1, 3) for c in counts]
    travel = travel.copy()
    travel[5, -1] = 0  # a shorter path: masked lanes
    x = np.random.RandomState(seed).randint(1, 101, (64, 1))
    want = paddle.ops.tdm_sampler(paddle.to_tensor(x), negs, counts, travel,
                                  layer_flat, layer_offsets=offsets,
                                  seed=seed)
    got = pt.ops.tdm_sampler(torch.from_numpy(x), negs, counts, travel,
                             layer_flat, layer_offsets=offsets, seed=seed)
    for g, w in zip(got, want):
        assert g.dtype == torch.int64 and g.device.type == "cpu"
        np.testing.assert_array_equal(_np(g), _np(w).astype(np.int64))
    # without positives, layer_node_num_list alone, int32
    want = paddle.ops.tdm_sampler(paddle.to_tensor(x[:8]), negs, counts,
                                  travel, layer_flat, output_positive=False,
                                  seed=seed, dtype="int32")
    got = pt.ops.tdm_sampler(torch.from_numpy(x[:8]), negs, counts, travel,
                             layer_flat, output_positive=False, seed=seed,
                             dtype="int32")
    for g, w in zip(got, want):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(_np(g), _np(w))


def test_tdm_sampler_checks_match_the_reference():
    t = TreeIndex.from_items(np.arange(1, 9))
    travel, layer_flat, offsets, counts = _feeds(t)
    for negs, nums, offs, x, match in (
            ([1, 1], counts, None, 1, "must match"),
            ([1, 1, 1], [2, 4, 9], offsets, 1, "but layer data"),
            ([2, 1, 1], counts, None, 1, "exceeds layer"),
            ([1, 1, 1], counts, None, 99, "outside travel")):
        xx = np.array([[x]])
        with pytest.raises(ValueError, match=match) as want:
            paddle.ops.tdm_sampler(paddle.to_tensor(xx), negs, nums, travel,
                                   layer_flat, layer_offsets=offs)
        with pytest.raises(ValueError, match=match) as got:
            pt.ops.tdm_sampler(torch.from_numpy(xx), negs, nums, travel,
                               layer_flat, layer_offsets=offs)
        assert str(got.value) == str(want.value)


@pytest.mark.parametrize("branch", [2, 3])
def test_tdm_child_matches_the_reference(branch):
    t = TreeIndex.from_items(np.arange(1, 30), branch=branch)
    info = t.tree_info_array()
    x = np.arange(info.shape[0]).reshape(-1, 1)
    for cn in range(1, branch + 1):
        want = paddle.ops.tdm_child(paddle.to_tensor(x), info, cn)
        got = pt.ops.tdm_child(torch.from_numpy(x), info, cn)
        for g, w in zip(got, want):
            assert tuple(g.shape) == x.shape + (cn,)
            np.testing.assert_array_equal(_np(g), _np(w).astype(np.int64))
    with pytest.raises(ValueError, match="exceeds tree branch"):
        pt.ops.tdm_child(torch.from_numpy(x), info, branch + 1)
    with pytest.raises(ValueError, match="outside tree_info"):
        pt.ops.tdm_child(torch.tensor([info.shape[0]]), info, 1)


def _ref_two_tower(t, steps):
    """``tests/test_tdm.py``'s loop: losses, the weights after, and the
    starting weights."""
    travel, layer_flat, offsets, counts = _feeds(t)
    negs = [min(2, c - 1) for c in counts]
    n_items = len(t.get_all_leafs())
    paddle.seed(0)
    node_emb = paddle.nn.Embedding(t.emb_id_count(), 8)
    user_emb = paddle.nn.Embedding(n_items + 1, 8)
    init = {"node": _np(node_emb.weight).copy(),
            "user": _np(user_emb.weight).copy()}
    opt = paddle.optimizer.Adam(
        parameters=list(node_emb.parameters())
        + list(user_emb.parameters()), learning_rate=0.05)
    users = np.arange(1, n_items + 1, dtype=np.int64)
    losses = []
    for step in range(steps):
        out, labels, mask = paddle.ops.tdm_sampler(
            paddle.to_tensor(users[:, None]), negs, counts, travel,
            layer_flat, layer_offsets=offsets, seed=step)
        u = user_emb(paddle.to_tensor(users))
        nodes = node_emb(out)
        logits = paddle.ops.sum(nodes * u.unsqueeze(1), axis=-1)
        m = mask.astype("float32")
        loss = paddle.ops.sum(
            paddle.nn.functional.binary_cross_entropy_with_logits(
                logits, labels.astype("float32"), reduction="none")
            * m) / paddle.ops.sum(m)
        loss.backward()
        opt.step()
        opt.clear_grad()
        losses.append(float(loss.numpy()))
    return losses, init, (_np(node_emb.weight), _np(user_emb.weight))


def _port_two_tower(t, steps, init):
    travel, layer_flat, offsets, counts = _feeds(t)
    negs = [min(2, c - 1) for c in counts]
    n_items = len(t.get_all_leafs())
    node_emb = pt.nn.Embedding(t.emb_id_count(), 8, device="cpu")
    user_emb = pt.nn.Embedding(n_items + 1, 8, device="cpu")
    bridge.load_reference_state(node_emb, {"weight": init["node"]})
    bridge.load_reference_state(user_emb, {"weight": init["user"]})
    opt = pt.optimizer.Adam(
        parameters=list(node_emb.parameters())
        + list(user_emb.parameters()), learning_rate=0.05)
    users = torch.arange(1, n_items + 1, dtype=torch.int64)
    losses = []
    for step in range(steps):
        out, labels, mask = (unwrap(v) for v in pt.ops.tdm_sampler(
            users[:, None], negs, counts, travel, layer_flat,
            layer_offsets=offsets, seed=step))
        u = unwrap(user_emb(users))
        nodes = unwrap(node_emb(out))
        logits = (nodes * u.unsqueeze(1)).sum(-1)
        m = mask.float()
        loss = (F.binary_cross_entropy_with_logits(
            logits, labels.float(), reduction="none") * m).sum() / m.sum()
        loss.backward()
        opt.step()
        opt.clear_grad()
        losses.append(float(loss.detach()))
    return losses, (node_emb.weight.detach().numpy(),
                    user_emb.weight.detach().numpy())


def _retrieve(tree_child, info, first, ne, uv, beam=4):
    """Beam search down the tree (``tests/test_tdm.py``'s ``retrieve``)."""
    frontier = np.asarray(first, np.int64)
    while True:
        child, leaf = tree_child(frontier, info)
        child, leaf = child.ravel(), leaf.ravel()
        kids = child[child != 0]
        if kids.size == 0:
            return frontier
        scores = ne[kids] @ uv
        keep = kids[np.argsort(-scores, kind="stable")[:beam]]
        if leaf[child != 0].all():
            return keep
        frontier = keep


def test_two_tower_loop_and_retrieval_match_the_reference():
    steps = 20
    ref_t = RefTree.from_items(np.arange(1, 17), branch=2)
    t = TreeIndex.from_items(np.arange(1, 17), branch=2)
    want, init, (ref_ne, ref_ue) = _ref_two_tower(ref_t, steps)
    got, (ne, ue) = _port_two_tower(t, steps, init)
    np.testing.assert_allclose(got, want, rtol=LOSS_RTOL)
    assert got[-1] < got[0]
    info = t.tree_info_array()
    first = t.get_nodes(t.get_children_codes(0))

    def ref_child(f, i):
        return tuple(_np(v) for v in paddle.ops.tdm_child(
            paddle.to_tensor(f), i, 2))

    def port_child(f, i):
        return tuple(_np(v) for v in pt.ops.tdm_child(
            torch.from_numpy(f), i, 2))

    hits = {}
    for name, child, n_e, u_e in (("ref", ref_child, ref_ne, ref_ue),
                                  ("port", port_child, ne, ue)):
        hits[name] = [int(uid in _retrieve(child, info, first, n_e,
                                           u_e[uid]))
                      for uid in range(1, 9)]
    assert hits["port"] == hits["ref"]
