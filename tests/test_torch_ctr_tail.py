"""The port's CTR, text-matching and tree op tail against the reference's,
on the CPU (``tests/test_ctr_tail.py``'s ops, each through both packages on
the same inputs).

- Each op's float32 output, and its gradients with respect to the
  arguments the reference differentiates, within ``RTOL``/``ATOL`` (the
  same float32 math, summed in another library's order).
- The host halves exactly: ``filter_by_instag``'s rows, loss weights and
  ``index_map``; the pyramid's hash rows (``_hash64`` bit for bit, every
  n-gram's table rows); the tree patches of ``tree_conv``.
- ``shuffle_batch`` draws from torch's generator, so its permutation is
  not the reference's: it is checked as a permutation (seeded: the same
  twice), and under an injected permutation against the reference under
  the same one, output and gradient exactly.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.ops import ctr_tail as ref_tail
import paddle_tpu_torch as pt
from paddle_tpu_torch.core.tensor import unwrap
from paddle_tpu_torch.ops import ctr_tail

RTOL, ATOL = 1e-5, 1e-6


def _ref_run(fn, arrays, diff, cot_seed=0):
    """``fn`` on reference tensors of ``arrays``: the output and the
    gradients of ``sum(out * cot)`` with respect to ``arrays[i]`` for ``i``
    in ``diff``."""
    ts = [paddle.to_tensor(a) for a in arrays]
    for i in diff:
        ts[i].stop_gradient = False
    out = fn(*ts)
    o = np.asarray(out.numpy())
    cot = np.random.RandomState(cot_seed).randn(*o.shape).astype(np.float32)
    if diff:
        paddle.ops.sum(out * paddle.to_tensor(cot)).backward()
    return o, [np.asarray(ts[i].grad.numpy()) for i in diff]


def _port_run(fn, arrays, diff, cot_seed=0, device="cpu"):
    ts = [torch.tensor(a, device=device) for a in arrays]
    for i in diff:
        ts[i].requires_grad_(True)
    out = unwrap(fn(*ts))
    o = out.detach().cpu().numpy()
    cot = np.random.RandomState(cot_seed).randn(*o.shape).astype(np.float32)
    if diff:
        (out * torch.from_numpy(cot).to(device)).sum().backward()
    return o, [ts[i].grad.cpu().numpy() for i in diff]


def _compare(ref_fn, port_fn, arrays, diff):
    want, want_g = _ref_run(ref_fn, arrays, diff)
    got, got_g = _port_run(port_fn, arrays, diff)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    for g, w in zip(got_g, want_g):
        np.testing.assert_allclose(g, w, rtol=RTOL, atol=ATOL)
    return got


rng = np.random.RandomState(9)


def test_shuffle_batch_is_a_permutation():
    x = torch.arange(24, dtype=torch.float32).reshape(12, 2)
    pt.seed(3)
    got = unwrap(pt.ops.shuffle_batch(x)).numpy()
    assert sorted(got[:, 0].tolist()) == list(range(0, 24, 2))
    np.testing.assert_array_equal(got[:, 1], got[:, 0] + 1)
    a = unwrap(pt.ops.shuffle_batch(x, seed=5)).numpy()
    b = unwrap(pt.ops.shuffle_batch(x, seed=5)).numpy()
    np.testing.assert_array_equal(a, b)
    assert not np.array_equal(a, x.numpy())


def test_shuffle_batch_under_an_injected_permutation(monkeypatch):
    x = rng.randn(10, 3).astype(np.float32)
    perm = np.random.RandomState(1).permutation(10)
    monkeypatch.setattr(jax.random, "permutation",
                        lambda key, n: jnp.asarray(perm))
    monkeypatch.setattr(ctr_tail, "_permutation",
                        lambda n, device, seed: torch.as_tensor(
                            perm, device=device))
    got = _compare(lambda v: paddle.ops.shuffle_batch(v, seed=2),
                   lambda v: pt.ops.shuffle_batch(v, seed=2), [x], [0])
    np.testing.assert_array_equal(got, x[perm])


@pytest.mark.parametrize("padded", [False, True])
def test_filter_by_instag_matches_the_reference(padded):
    ins = rng.rand(6, 3).astype(np.float32)
    tags = [[1, 2], [3], [2, 7], [4], [9, 9], [5, 4]]
    if padded:
        arr = np.zeros((6, 2), np.int64)
        for i, row in enumerate(tags):
            arr[i, :len(row)] = row
        tags = arr
    for filt in ([2, 4], [99]):
        want = paddle.ops.filter_by_instag(
            paddle.to_tensor(ins),
            paddle.to_tensor(tags) if padded else tags,
            paddle.to_tensor(np.array(filt, np.int64)))
        got = pt.ops.filter_by_instag(
            torch.from_numpy(ins), torch.from_numpy(tags) if padded else tags,
            torch.tensor(filt))
        for g, w in zip(got, want):
            assert unwrap(g).device.type == "cpu"
            np.testing.assert_array_equal(unwrap(g).numpy(),
                                          np.asarray(w.numpy()))


def test_hash64_is_the_reference_bit_for_bit():
    a = np.random.RandomState(2).randint(0, 2 ** 63, 1000, dtype=np.int64) \
        .astype(np.uint64) * np.uint64(3)
    b = np.random.RandomState(3).randint(0, 2 ** 63, 1000, dtype=np.int64) \
        .astype(np.uint64)
    got = ctr_tail._hash64(a, b)
    want = np.array([ref_tail._hash64(x, y) for x, y in zip(a, b)],
                    np.uint64)
    np.testing.assert_array_equal(got, want)
    assert ctr_tail._hash64(np.uint64(7), np.uint64(9)) == \
        ref_tail._hash64(np.uint64(7), np.uint64(9))


def _ref_pyramid_rows(ids, pieces, space_len, pyramid_layer, seed):
    """The reference's own n-gram loop (``search_pyramid_hash``'s host
    half) with its ``_hash64``."""
    out = []
    for b in range(ids.shape[0]):
        toks = [t for t in ids[b] if t != 0]
        rows = []
        for w in range(2, pyramid_layer + 1):
            for s in range(0, max(0, len(toks) - w + 1)):
                sig = np.uint64(seed)
                for t in toks[s:s + w]:
                    sig = ref_tail._hash64(sig, np.uint64(t))
                rows.append([int(ref_tail._hash64(sig, np.uint64(j))
                                 % np.uint64(space_len))
                             for j in range(pieces)])
        out.append(rows)
    return out


@pytest.mark.parametrize("layers,seed", [(2, 0), (3, 5), (4, 11)])
def test_pyramid_hash_rows_and_gradients_match_the_reference(layers, seed):
    ids = np.random.RandomState(seed).randint(1, 50, (5, 9)).astype(np.int32)
    ids[0, 4:] = 0
    ids[1, 1:] = 0          # one token: no n-gram
    ids[2, 3] = 0           # a gap inside: the tokens close up
    W = rng.rand(64, 4).astype(np.float32)
    idx, mask = ctr_tail._pyramid_rows(ids.astype(np.int64), 2, 64, layers,
                                       seed)
    for b, rows in enumerate(_ref_pyramid_rows(ids, 2, 64, layers, seed)):
        n = len(rows)
        assert mask[b, :n].all() and not mask[b, n:].any()
        if n:
            np.testing.assert_array_equal(idx[b, :n], np.asarray(rows))
    _compare(lambda i, w: paddle.ops.search_pyramid_hash(
                 i, w, num_emb=8, space_len=64, pyramid_layer=layers,
                 rand_len=4, seed=seed),
             lambda i, w: pt.ops.search_pyramid_hash(
                 i, w, num_emb=8, space_len=64, pyramid_layer=layers,
                 rand_len=4, seed=seed), [ids, W], [1])


@pytest.mark.parametrize("K", [2, 3])
def test_rank_attention_matches_the_reference(K):
    N, d, out_col = 40, 6, 5
    x = rng.randn(N, d).astype(np.float32)
    p = rng.randn(d * K * K, out_col).astype(np.float32)
    r = np.random.RandomState(K)
    ro = np.zeros((N, 1 + 2 * K), np.int32)
    ro[:, 0] = r.randint(0, K + 1, N)          # 0: invalid instance
    ro[:, 1::2] = r.randint(0, K + 1, (N, K))  # 0: no related instance
    ro[:, 2::2] = r.randint(0, N, (N, K))
    _compare(lambda a, b, c: paddle.ops.rank_attention(a, b, c, max_rank=K),
             lambda a, b, c: pt.ops.rank_attention(a, b, c, max_rank=K),
             [x, ro, p], [0, 2])


def _random_trees(B, N, E, seed):
    r = np.random.RandomState(seed)
    edges = np.zeros((B, E, 2), np.int32)
    for b in range(B):
        n_edges = r.randint(1, N)
        for i in range(n_edges):   # node i + 2 hangs under an earlier node
            edges[b, i] = [r.randint(1, i + 2), i + 2]
    return edges


@pytest.mark.parametrize("depth", [1, 2, 3])
def test_tree_conv_matches_the_reference(depth):
    B, N, C, O, Fn = 3, 7, 4, 5, 2
    nodes = rng.randn(B, N, C).astype(np.float32)
    edges = _random_trees(B, N, N, depth)
    w = rng.randn(C, 3, O, Fn).astype(np.float32)
    for b in range(B):
        for g, r in zip(ctr_tail._tree_patches(edges[b], N, depth),
                        ref_tail._tree_patches(edges[b], N, depth)):
            np.testing.assert_array_equal(g, r)
    _compare(lambda a, e, f: paddle.ops.tree_conv(a, e, f, max_depth=depth),
             lambda a, e, f: pt.ops.tree_conv(a, e, f, max_depth=depth),
             [nodes, edges, w], [0, 2])


@pytest.mark.parametrize("stride", [(1, 1), (2, 1)])
def test_var_conv_2d_matches_the_reference(stride):
    B, Cin, Cout, H, W = 3, 2, 3, 7, 6
    x = rng.randn(B, Cin, H, W).astype(np.float32)
    f = rng.randn(Cout, Cin, 3, 3).astype(np.float32)
    rows = np.array([4, 7, 1], np.int32)
    cols = np.array([6, 2, 5], np.int32)
    _compare(lambda a, r_, c_, w_: paddle.ops.var_conv_2d(
                 a, r_, c_, w_, Cin, Cout, stride=stride),
             lambda a, r_, c_, w_: pt.ops.var_conv_2d(
                 a, r_, c_, w_, Cin, Cout, stride=stride),
             [x, rows, cols, f], [0, 3])


@pytest.mark.parametrize("has_offset", [False, True])
def test_bilateral_slice_matches_the_reference(has_offset):
    N, Cin, Cout, H, W = 2, 3, 2, 5, 6
    gd, gh, gw = 4, 3, 3
    grid = rng.randn(N, Cout * (Cin + int(has_offset)), gd, gh, gw) \
        .astype(np.float32)
    x = rng.randn(N, Cin, H, W).astype(np.float32)
    guide = rng.rand(N, H, W).astype(np.float32)
    _compare(lambda a, g, gr: paddle.ops.bilateral_slice(a, g, gr,
                                                         has_offset),
             lambda a, g, gr: pt.ops.bilateral_slice(a, g, gr, has_offset),
             [x, guide, grid], [0, 1, 2])
    with pytest.raises(ValueError, match="multiple of Cin"):
        pt.ops.bilateral_slice(torch.from_numpy(x), torch.from_numpy(guide),
                               torch.zeros(N, 5, gd, gh, gw), True)
