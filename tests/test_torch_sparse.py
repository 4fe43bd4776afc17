"""Sparse embeddings against the reference, on the CPU:
``embedding(sparse=True)``'s row gradient (``SelectedRows``), its merge
and accumulation rules, and the row-wise optimizer updates.

- The gradient's rows and values equal the reference's ``SelectedRows``
  (padding ids and duplicates included): rows exactly, values within
  ``RTOL`` (float32 sums of the same cotangents in another order).
- K rows come out for K ids whatever the duplicates (the static shape).
- One step each of ``SGD``, ``Momentum``, ``Adam(lazy_mode=True)`` and
  ``AdamW`` (with a dense parameter beside the table, a clip and a
  ``GradScaler``): the table, the dense parameter and every accumulator
  within ``RTOL`` of the reference's; the rows no id touched, and their
  accumulators, bitwise as they were.
- ``DataParallel``'s all-reduce skips a sparse gradient; a dp reduce and
  ZeRO raise for one, as the reference's do.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu_torch as pt
from paddle_tpu_torch.core.selected_rows import SelectedRows

RTOL, ATOL = 1e-5, 1e-6
HEIGHT, DIM, PAD = 12, 4, 3


@pytest.fixture(autouse=True)
def _threads():
    torch.set_num_threads(2)


def _data(seed=0):
    r = np.random.RandomState(seed)
    table = r.randn(HEIGHT, DIM).astype(np.float32)
    ids = np.array([[1, 5, 5, PAD], [7, 1, 5, 9]], np.int64)
    cot = r.randn(2, 4, DIM).astype(np.float32)
    return table, ids, cot


def _ref_grad(table, ids, cot, padding_idx=PAD):
    w = paddle.Parameter(table)
    out = paddle.nn.functional.embedding(paddle.to_tensor(ids), w,
                                         padding_idx=padding_idx, sparse=True)
    (out * paddle.to_tensor(cot)).sum().backward()
    return w._grad


def _port_grad(table, ids, cot, padding_idx=PAD):
    w = pt.Parameter(torch.from_numpy(table))
    out = pt.nn.functional.embedding(pt.to_tensor(ids, place="cpu"), w,
                                     padding_idx=padding_idx, sparse=True)
    (out * pt.to_tensor(cot, place="cpu")).sum().backward()
    return w


def _rows_equal(ref_sr, port_sr):
    np.testing.assert_array_equal(port_sr.rows.numpy(),
                                  np.asarray(ref_sr.rows))
    np.testing.assert_allclose(port_sr.values.detach().numpy(),
                               np.asarray(ref_sr.values), rtol=RTOL,
                               atol=ATOL)
    assert port_sr.height == ref_sr.height


@pytest.mark.parametrize("padding_idx", [None, PAD])
def test_sparse_embedding_gradient_matches_reference(padding_idx):
    table, ids, cot = _data()
    ref = _ref_grad(table, ids, cot, padding_idx)
    w = _port_grad(table, ids, cot, padding_idx)
    assert w.grad is None  # torch's grad stays empty: the rows carry it
    _rows_equal(ref, w._sparse_grad)
    np.testing.assert_allclose(w._sparse_grad.to_dense().numpy(),
                               np.asarray(ref.to_dense()), rtol=RTOL,
                               atol=ATOL)


@pytest.mark.parametrize("ids", [
    np.zeros((3, 5), np.int64), np.arange(15).reshape(3, 5) % 12,
    np.array([[11, 0, 11, 0, 11]])])
def test_k_rows_out_whatever_the_duplicates(ids):
    table = np.ones((HEIGHT, DIM), np.float32)
    cot = np.ones(ids.shape + (DIM,), np.float32)
    sr = _port_grad(table, ids, cot, None)._sparse_grad
    k = ids.size
    assert sr.rows.shape == (k,) and sr.values.shape == (k, DIM)
    uniq = np.unique(ids)
    assert sr.rows.numpy().tolist() == uniq.tolist() + [HEIGHT] * (
        k - len(uniq))
    counts = np.array([(ids == u).sum() for u in uniq], np.float32)
    np.testing.assert_array_equal(sr.values.numpy()[:len(uniq), 0], counts)
    assert not sr.values.numpy()[len(uniq):].any()


def test_merge_add_matches_reference():
    r = np.random.RandomState(2)
    rows_a, rows_b = np.array([4, 1, 4, 9]), np.array([9, 0, 1])
    va = r.randn(4, 3).astype(np.float32)
    vb = r.randn(3, 3).astype(np.float32)
    from paddle_tpu.core.selected_rows import SelectedRows as RefRows
    ref = RefRows(rows_a, paddle.to_tensor(va)._value, 10).merge_add(
        RefRows(rows_b, paddle.to_tensor(vb)._value, 10))
    got = SelectedRows(torch.from_numpy(rows_a), torch.from_numpy(va),
                       10).merge_add(SelectedRows(torch.from_numpy(rows_b),
                                                  torch.from_numpy(vb), 10))
    _rows_equal(ref, got)
    with pytest.raises(ValueError, match="heights"):
        got.merge_add(SelectedRows(torch.tensor([0]), torch.ones(1, 3), 11))


def test_two_lookups_merge_and_a_dense_use_makes_it_dense():
    table, ids, cot = _data(1)
    ids2 = np.array([[0, 5]], np.int64)
    for dense_too in (False, True):
        w = pt.Parameter(torch.from_numpy(table))
        rw = paddle.Parameter(table)
        loss = 0
        for pkg, wt, T in ((pt, w, lambda a: pt.to_tensor(a, place="cpu")),
                           (paddle, rw, paddle.to_tensor)):
            e1 = pkg.nn.functional.embedding(T(ids), wt, sparse=True)
            e2 = pkg.nn.functional.embedding(T(ids2), wt, sparse=True)
            loss = (e1 * T(cot)).sum() + 2.0 * e2.sum()
            if dense_too:
                loss = loss + (wt * wt).sum()
            loss.backward()
        if dense_too:
            from paddle_tpu_torch.core.tensor import grad_of
            g = grad_of(w)
            assert isinstance(g, torch.Tensor)
            np.testing.assert_allclose(g.numpy(), np.asarray(rw._grad),
                                       rtol=RTOL, atol=ATOL)
        else:
            _rows_equal(rw._grad, w._sparse_grad)
            assert w._sparse_grad.rows.shape == (ids.size + ids2.size,)


# -- one optimizer step against the reference's ---------------------------------

def _opt(pkg, name, params, clip=False):
    kw = {"parameters": params}
    if clip:
        kw["grad_clip"] = pkg.nn.ClipGradByGlobalNorm(0.5)
    if name == "SGD":
        return pkg.optimizer.SGD(learning_rate=0.1, **kw)
    if name == "Momentum":
        return pkg.optimizer.Momentum(learning_rate=0.1, momentum=0.9,
                                      weight_decay=0.01, **kw)
    if name == "Adam":
        return pkg.optimizer.Adam(learning_rate=0.05, lazy_mode=True, **kw)
    return pkg.optimizer.AdamW(learning_rate=0.05, weight_decay=0.1, **kw)


def _two_steps(pkg, name, clip=False, scaler=False):
    table, ids, cot = _data(3)
    lin = np.random.RandomState(4).randn(DIM, 2).astype(np.float32)
    if pkg is paddle:
        w, d = paddle.Parameter(table), paddle.Parameter(lin)
        T = paddle.to_tensor
    else:
        w, d = (pt.Parameter(torch.from_numpy(table)),
                pt.Parameter(torch.from_numpy(lin)))

        def T(a):
            return pt.to_tensor(a, place="cpu")
    opt = _opt(pkg, name, [w, d], clip)
    sc = pkg.amp.GradScaler(init_loss_scaling=64.0) if scaler else None
    for step in range(2):
        e = pkg.nn.functional.embedding(T(ids[:, step:step + 3]), w,
                                        padding_idx=PAD, sparse=True)
        loss = (pkg.matmul(e, d) * T(cot[:, :3, :2])).sum()
        if sc is not None:
            sc.scale(loss).backward()
            sc.step(opt)
        else:
            loss.backward()
            opt.step()
        opt.clear_grad()
    accs = {k[0]: v for k, v in opt._accumulators.items() if k[1] == id(w)}
    return w, d, accs


def _np(t):
    return np.asarray(t.detach().numpy() if isinstance(t, torch.Tensor)
                      else getattr(t, "_value", t))


@pytest.mark.parametrize("extra", ["plain", "clip", "scaler"])
@pytest.mark.parametrize("name", ["SGD", "Momentum", "Adam", "AdamW"])
def test_row_wise_step_matches_reference(name, extra):
    kw = {"clip": extra == "clip", "scaler": extra == "scaler"}
    rw, rd, raccs = _two_steps(paddle, name, **kw)
    w, d, accs = _two_steps(pt, name, **kw)
    np.testing.assert_allclose(_np(w), _np(rw), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(_np(d), _np(rd), rtol=RTOL, atol=ATOL)
    assert sorted(accs) == sorted(raccs)
    for slot in accs:
        np.testing.assert_allclose(_np(accs[slot]), _np(raccs[slot]),
                                   rtol=RTOL, atol=ATOL, err_msg=slot)
    table, ids, _ = _data(3)
    touched = np.unique(ids[:, :5])
    untouched = [i for i in range(HEIGHT) if i not in touched]
    np.testing.assert_array_equal(_np(w)[untouched], table[untouched])
    for slot, acc in accs.items():
        assert not _np(acc)[untouched].any(), slot


def test_sparse_step_equals_the_dense_step_for_sgd():
    """Without decay, SGD on the rows is the dense update."""
    table, ids, cot = _data(5)
    out = []
    for sparse in (True, False):
        w = pt.Parameter(torch.from_numpy(table))
        opt = pt.optimizer.SGD(learning_rate=0.3, parameters=[w])
        e = pt.nn.functional.embedding(pt.to_tensor(ids, place="cpu"), w,
                                       sparse=sparse)
        (e * pt.to_tensor(cot, place="cpu")).sum().backward()
        opt.step()
        out.append(w.detach().numpy())
    np.testing.assert_allclose(out[0], out[1], rtol=RTOL, atol=ATOL)


def test_padding_rows_are_dropped_not_clamped():
    """Every id equal: K - 1 padding entries, none may touch row 0 (a
    clamped index would write a stale row there)."""
    table = np.arange(HEIGHT * DIM, dtype=np.float32).reshape(HEIGHT, DIM)
    w = pt.Parameter(torch.from_numpy(table.copy()))
    opt = pt.optimizer.Adam(learning_rate=0.1, parameters=[w])
    e = pt.nn.functional.embedding(torch.full((6,), 7), w, sparse=True)
    e.sum().backward()
    opt.step()
    got = w.detach().numpy()
    np.testing.assert_array_equal(np.delete(got, 7, 0),
                                  np.delete(table, 7, 0))
    assert not np.array_equal(got[7], table[7])


def test_bf16_table_with_float32_master():
    table, ids, cot = _data(6)
    w = pt.Parameter(torch.from_numpy(table).bfloat16())
    opt = pt.optimizer.AdamW(learning_rate=0.05, parameters=[w],
                             multi_precision=True)
    e = pt.nn.functional.embedding(pt.to_tensor(ids, place="cpu"), w,
                                   sparse=True)
    (e.float() * pt.to_tensor(cot, place="cpu")).sum().backward()
    opt.step()
    master = opt._accumulators[("master", id(w))]
    assert torch.equal(w.detach(), master.bfloat16())
    untouched = [i for i in range(HEIGHT) if i not in ids]
    assert torch.equal(w.detach()[untouched],
                       torch.from_numpy(table).bfloat16()[untouched])


def test_embedding_layer_sparse_trains():
    emb = pt.nn.Embedding(HEIGHT, DIM, sparse=True, padding_idx=0,
                          device="cpu")
    opt = pt.optimizer.SGD(learning_rate=1.0, parameters=emb.parameters())
    before = emb.weight.detach().clone()
    emb(pt.to_tensor([[2, 0, 2]], place="cpu")).sum().backward()
    opt.step()
    changed = (emb.weight.detach() != before).any(1).nonzero().ravel()
    assert changed.tolist() == [2]
    emb.clear_gradients()
    assert emb.weight.__dict__.get("_sparse_grad") is None


@pytest.mark.parametrize("create_graph", [False, True])
@pytest.mark.parametrize("padding_idx", [None, PAD])
def test_grad_over_a_sparse_table_matches_reference(create_graph,
                                                    padding_idx):
    """``grad`` over a sparse table returns its row gradient, the
    reference's ``SelectedRows`` (``create_graph``, which the reference
    refuses here, gives the same rows with differentiable values), and
    touches no leaf: the row gradient of an earlier ``backward`` stays as
    it was, and the next step applies it alone."""
    table, ids, _ = _data(3)
    w_r = paddle.Parameter(table)
    out = paddle.nn.functional.embedding(paddle.to_tensor(ids), w_r,
                                         padding_idx=padding_idx,
                                         sparse=True)
    (g_r,) = paddle.grad((out * out).sum(), [w_r])

    _, _, cot = _data(3)
    w = _port_grad(table, ids, cot, padding_idx)  # a row gradient first
    rows_before = w._sparse_grad.rows.clone()
    values_before = w._sparse_grad.values.clone()
    out = pt.nn.functional.embedding(pt.to_tensor(ids, place="cpu"), w,
                                     padding_idx=padding_idx, sparse=True)
    (g,) = pt.grad((out * out).sum(), [w], create_graph=create_graph)
    assert isinstance(g, SelectedRows)
    _rows_equal(g_r._value, g)
    assert g.values.requires_grad == create_graph
    assert w.grad is None
    assert torch.equal(w._sparse_grad.rows, rows_before)
    assert torch.equal(w._sparse_grad.values, values_before)

    expect = _port_grad(table, ids, cot, padding_idx)
    for p in (w, expect):
        pt.optimizer.SGD(learning_rate=0.5, parameters=[p]).step()
    assert torch.equal(w.detach(), expect.detach())


def test_grad_over_a_tensor_table_and_a_dense_path():
    """A ``Tensor`` table (not a parameter) gets its row gradient through
    the functional's ``Tensor`` boundary, from ``grad`` as from
    ``backward``; a table also reached by dense ops gets the dense sum."""
    table, ids, cot = _data(4)
    w = pt.to_tensor(table, place="cpu", stop_gradient=False)
    c = pt.to_tensor(cot, place="cpu")
    loss = (pt.nn.functional.embedding(pt.to_tensor(ids, place="cpu"), w,
                                       sparse=True) * c).sum()
    (g,) = pt.grad(loss, [w])
    assert w.__dict__.get("_sparse_grad") is None
    loss.backward(retain_graph=True)
    assert w.grad is None
    assert torch.equal(w._sparse_grad.rows, g.rows)
    assert torch.equal(w._sparse_grad.values, g.values)

    (mixed,) = pt.grad(loss + (w * w).sum(), [w])
    assert type(mixed) is pt.Tensor
    np.testing.assert_allclose(mixed.numpy(),
                               g.to_dense().numpy() + 2 * table,
                               rtol=RTOL, atol=ATOL)


# -- data parallelism --------------------------------------------------------------

@pytest.fixture
def one_rank_mesh(tmp_path):
    from paddle_tpu_torch.distributed import parallel_env
    saved = parallel_env.current_mesh()
    parallel_env.init_parallel_env(
        device="cpu", init_method=f"file://{tmp_path}/rendezvous",
        world_size=1, rank=0)
    parallel_env.set_mesh(parallel_env.make_mesh({"dp": 1}))
    try:
        yield parallel_env
    finally:
        parallel_env.set_mesh(saved)
        torch.distributed.destroy_process_group()


def test_data_parallel_skips_sparse_and_dp_reduce_and_zero_raise(
        one_rank_mesh):
    from paddle_tpu_torch.distributed.parallel import fused_allreduce_grads
    table, ids, cot = _data(7)
    w = pt.Parameter(torch.from_numpy(table))
    d = pt.Parameter(torch.ones(DIM, 2))
    e = pt.nn.functional.embedding(pt.to_tensor(ids, place="cpu"), w,
                                   sparse=True)
    pt.matmul(e, d).sum().backward()
    sparse_before = w._sparse_grad.values.clone()
    assert fused_allreduce_grads([w]) == 0       # skipped: no dense grad
    assert fused_allreduce_grads([w, d]) == 1    # the dense one only
    assert torch.equal(w._sparse_grad.values, sparse_before)
    opt = pt.optimizer.SGD(learning_rate=0.1, parameters=[w, d])
    with one_rank_mesh.dp_axis_ctx("dp"):
        with pytest.raises(NotImplementedError, match="dp axis"):
            opt.step()
    zopt = pt.optimizer.AdamW(learning_rate=0.1, parameters=[w, d])
    zopt._zero_enable(axis="dp", stage=1)
    with pytest.raises(NotImplementedError, match="ZeRO"):
        zopt.step()
