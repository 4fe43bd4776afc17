"""``text`` and ``dataset`` against the reference: every synthetic dataset
and every classic reader sample for sample, bit for bit; the CRF ops
(``viterbi_decode`` and ``ViterbiDecoder`` in the [N, N] layout with and
without BOS/EOS, ``linear_chain_crf`` and ``crf_decoding`` in fluid's
[N + 2, N] layout) on the same seeded emissions and lengths: decoded
paths exact, with planted ties (the first maximum wins, as ``jnp.argmax``
takes it), identity backpointers past a length and ``crf_decoding``'s
zeros there; a brute force over every path on a small case.

Tolerances: Viterbi scores and CRF losses within 1e-5 relative to their
largest element (float32 sums of the same terms, the log-sum-exp in
another order); the CRF's gradients within 1e-4 relative to their largest
element.
"""
import itertools

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import dataset as rds
from paddle_tpu import text as rtext
from paddle_tpu_torch import dataset as tds
from paddle_tpu_torch import text as ttext

TOL, GRAD_TOL = 1e-5, 1e-4


@pytest.fixture(autouse=True)
def _threads():
    torch.set_num_threads(2)


def _np(t):
    return np.asarray(t.numpy())


def _same(a, b, what):
    if isinstance(a, (tuple, list)):
        assert isinstance(b, (tuple, list)) and len(a) == len(b), what
        for x, y in zip(a, b):
            _same(x, y, what)
        return
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape, what
    np.testing.assert_array_equal(a, b, err_msg=what)


DATASETS = ["Imdb", "Imikolov", "UCIHousing", "Conll05st", "Movielens",
            "WMT14", "WMT16"]


@pytest.mark.parametrize("name", DATASETS)
@pytest.mark.parametrize("mode", ["train", "test"])
def test_datasets_equal_the_reference_bit_for_bit(name, mode):
    ref = getattr(rtext, name)(mode=mode)
    port = getattr(ttext, name)(mode=mode)
    assert len(port) == len(ref)
    for i in sorted({0, 1, len(ref) // 2, len(ref) - 1}):
        _same(port[i], ref[i], f"{name}[{i}]")
    for attr in ("word_idx", "word_dict", "label_dict", "src_word_idx"):
        if hasattr(ref, attr):
            assert getattr(port, attr) == getattr(ref, attr)
    assert port.synthetic == ref.synthetic


READERS = [("mnist", "train"), ("cifar", "train10"), ("cifar", "test100"),
           ("imdb", "test"), ("uci_housing", "train"), ("imikolov", "test"),
           ("movielens", "test"), ("conll05", "train"), ("wmt14", "test"),
           ("wmt16", "train")]


@pytest.mark.parametrize("module,fn", READERS)
def test_classic_readers_yield_the_reference_samples(module, fn):
    ref = getattr(getattr(rds, module), fn)()()
    port = getattr(getattr(tds, module), fn)()()
    for _ in range(3):
        _same(next(port), next(ref), f"{module}.{fn}")


def _close(got, want, tol, what):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, what
    scale = max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * scale,
                               err_msg=what)


def _crf_inputs(seed, B=4, T=7, N=5, layout="viterbi"):
    rng = np.random.RandomState(seed)
    pot = rng.randn(B, T, N).astype(np.float32)
    rows = N if layout == "viterbi" else N + 2
    trans = rng.randn(rows, N).astype(np.float32)
    lens = np.array([T, 4, 1, T - 2][:B], np.int64)
    return pot, trans, lens


@pytest.mark.parametrize("with_tag", [True, False])
@pytest.mark.parametrize("with_lens", [True, False])
def test_viterbi_decode_matches(with_tag, with_lens):
    pot, trans, lens = _crf_inputs(1)
    lens_r = paddle.to_tensor(lens) if with_lens else None
    lens_t = torch.from_numpy(lens) if with_lens else None
    rs, rp = rtext.viterbi_decode(paddle.to_tensor(pot),
                                  paddle.to_tensor(trans), lens_r, with_tag)
    ts, tp = ttext.viterbi_decode(torch.from_numpy(pot),
                                  torch.from_numpy(trans), lens_t, with_tag)
    np.testing.assert_array_equal(_np(tp), _np(rp))
    _close(_np(ts), _np(rs), TOL, "scores")
    dec = ttext.ViterbiDecoder(torch.from_numpy(trans), with_tag)
    np.testing.assert_array_equal(_np(dec(torch.from_numpy(pot), lens_t)[1]),
                                  _np(rp))


def test_viterbi_brute_force():
    pot, trans, lens = _crf_inputs(2, B=2, T=4, N=3)
    score, path = ttext.viterbi_decode(torch.from_numpy(pot),
                                       torch.from_numpy(trans),
                                       torch.from_numpy(lens), False)
    for b in range(2):
        L = int(lens[b])
        best = max(itertools.product(range(3), repeat=L), key=lambda tags: (
            pot[b, 0, tags[0]] + sum(trans[tags[t - 1], tags[t]]
                                     + pot[b, t, tags[t]]
                                     for t in range(1, L))))
        assert list(_np(path)[b, :L]) == list(best)


def test_planted_ties_take_the_first_maximum():
    """All-equal scores: every step ties, so each backpointer is tag 0 and
    the last tag is 0, in both packages and in both layouts."""
    B, T, N = 2, 5, 4
    pot = np.zeros((B, T, N), np.float32)
    trans = np.zeros((N, N), np.float32)
    lens = np.array([5, 3], np.int64)
    _, rp = rtext.viterbi_decode(paddle.to_tensor(pot),
                                 paddle.to_tensor(trans),
                                 paddle.to_tensor(lens), False)
    _, tp = ttext.viterbi_decode(torch.from_numpy(pot),
                                 torch.from_numpy(trans),
                                 torch.from_numpy(lens), False)
    np.testing.assert_array_equal(_np(tp), _np(rp))
    assert not _np(tp).any()
    # a tie between tags 1 and 3 above the rest: tag 1 wins everywhere
    pot[:, :, [1, 3]] = 1.0
    t32 = np.zeros((N + 2, N), np.float32)
    rp = rtext.crf_decoding(paddle.to_tensor(pot), paddle.to_tensor(t32),
                            length=paddle.to_tensor(lens))
    tp = ttext.crf_decoding(torch.from_numpy(pot), torch.from_numpy(t32),
                            length=torch.from_numpy(lens))
    np.testing.assert_array_equal(_np(tp), _np(rp))
    np.testing.assert_array_equal(_np(tp), [[1, 1, 1, 1, 1], [1, 1, 1, 0, 0]])


@pytest.mark.parametrize("with_lens", [True, False])
def test_linear_chain_crf_loss_and_gradients(with_lens):
    pot, trans, lens = _crf_inputs(3, layout="crf")
    lab = np.random.RandomState(4).randint(0, 5, pot.shape[:2])
    w = np.random.RandomState(5).rand(4, 1).astype(np.float32)
    rx = paddle.to_tensor(pot, stop_gradient=False)
    rt = paddle.to_tensor(trans, stop_gradient=False)
    rl = rtext.linear_chain_crf(rx, paddle.to_tensor(lab), rt,
                                paddle.to_tensor(lens) if with_lens else None)
    (rl * paddle.to_tensor(w)).sum().backward()
    tx = torch.from_numpy(pot).requires_grad_(True)
    tt = torch.from_numpy(trans).requires_grad_(True)
    tl = ttext.linear_chain_crf(tx, torch.from_numpy(lab), tt,
                                torch.from_numpy(lens) if with_lens
                                else None)
    (tl * torch.from_numpy(w)).sum().backward()
    assert tuple(tl.shape) == (4, 1)
    _close(tl.detach().numpy(), _np(rl), TOL, "nll")
    _close(tx.grad.numpy(), _np(rx.grad), GRAD_TOL, "d emissions")
    _close(tt.grad.numpy(), _np(rt.grad), GRAD_TOL, "d transition")
    assert float(tl.min()) > 0  # a negative log-likelihood


def test_crf_decoding_paths_and_label_mode():
    pot, trans, lens = _crf_inputs(6, layout="crf")
    lab = np.random.RandomState(7).randint(0, 5, pot.shape[:2])
    for length in (lens, None):
        rl = paddle.to_tensor(length) if length is not None else None
        tl = torch.from_numpy(length) if length is not None else None
        rp = rtext.crf_decoding(paddle.to_tensor(pot),
                                paddle.to_tensor(trans), length=rl)
        tp = ttext.crf_decoding(torch.from_numpy(pot),
                                torch.from_numpy(trans), length=tl)
        np.testing.assert_array_equal(_np(tp), _np(rp))
        rok = rtext.crf_decoding(paddle.to_tensor(pot),
                                 paddle.to_tensor(trans),
                                 label=paddle.to_tensor(lab), length=rl)
        tok = ttext.crf_decoding(torch.from_numpy(pot),
                                 torch.from_numpy(trans),
                                 label=torch.from_numpy(lab), length=tl)
        np.testing.assert_array_equal(_np(tok), _np(rok))
    path = _np(ttext.crf_decoding(torch.from_numpy(pot),
                                  torch.from_numpy(trans),
                                  length=torch.from_numpy(lens)))
    for b, L in enumerate(lens):
        assert not path[b, L:].any()
