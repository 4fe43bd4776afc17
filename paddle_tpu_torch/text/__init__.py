"""Text (counterpart: ``paddle_tpu/text``): the datasets and the
linear-chain CRF ops.

The datasets (reference framework: `python/paddle/text/datasets/` — Imdb,
Imikolov, Movielens, UCIHousing, Conll05st, WMT14, WMT16) build the
reference's deterministic synthetic corpora from ``_rng(mode, salt)`` (a
numpy ``RandomState``), so each sample equals the reference's bit for
bit; ``UCIHousing`` reads a real file where one is given and exists.
Nothing is downloaded.

The CRF ops (``viterbi_decode``, ``ViterbiDecoder``, ``linear_chain_crf``,
``crf_decoding``; reference framework: `operators/viterbi_decode_op`,
`operators/linear_chain_crf_op.h`, `operators/crf_decoding_op.h`) are a
loop over time of torch operations on the emissions' device, in the
reference's two transition layouts: ``[N, N]`` with BOS and EOS as the
last two tags for ``viterbi_decode``, and fluid's ``[N + 2, N]`` (row 0
start, row 1 stop, then the square) for the CRF ops. Past a sequence's
length a step keeps its scores and takes identity backpointers, so the
path carries the last tag through; ``crf_decoding`` writes 0 there. Ties
go to the first maximum, as ``jnp.argmax`` takes it (``torch.argmax``
returns the first maximal index on both devices). Paths are int64 (the
reference's int32 without jax's 64-bit types).
"""
import os
import zlib

import numpy as np
import torch

from ..core.tensor import unwrap, wrap
from ..io.dataset import Dataset

__all__ = ["Imdb", "Imikolov", "UCIHousing", "Conll05st", "Movielens",
           "WMT14", "WMT16", "ViterbiDecoder", "viterbi_decode",
           "linear_chain_crf", "crf_decoding"]


def _rng(mode, salt):
    # crc32, not hash(): str hashing is randomized per interpreter, and the
    # corpus must be identical across runs and across launched trainer procs
    return np.random.RandomState((zlib.crc32(mode.encode()) ^ salt)
                                 & 0x7FFFFFFF)


class Imdb(Dataset):
    """Binary sentiment over token-id sequences.
    reference: python/paddle/text/datasets/imdb.py"""

    def __init__(self, data_path=None, mode="train", cutoff=150):
        self.mode = mode
        self.synthetic = not (data_path and os.path.exists(data_path))
        rng = _rng(mode, 0x11DB)
        n = 2000 if mode == "train" else 500
        self.word_idx = {f"w{i}": i for i in range(5000)}
        self.docs, self.labels = [], []
        for _ in range(n):
            label = rng.randint(0, 2)
            length = rng.randint(20, 200)
            # sentiment-correlated token bands so models can learn
            lo, hi = (0, 2500) if label == 0 else (2500, 5000)
            doc = rng.randint(lo, hi, size=length).astype(np.int64)
            self.docs.append(doc)
            self.labels.append(np.int64(label))

    def __getitem__(self, idx):
        return self.docs[idx], self.labels[idx]

    def __len__(self):
        return len(self.docs)


class Imikolov(Dataset):
    """PTB-style n-gram LM dataset.
    reference: python/paddle/text/datasets/imikolov.py"""

    def __init__(self, data_path=None, data_type="NGRAM", window_size=5,
                 mode="train", min_word_freq=50):
        self.mode = mode
        self.window_size = window_size
        self.synthetic = True
        rng = _rng(mode, 0x131)
        vocab = 2000
        self.word_idx = {f"w{i}": i for i in range(vocab)}
        corpus = rng.randint(0, vocab, size=20000).astype(np.int64)
        self.grams = [corpus[i:i + window_size]
                      for i in range(0, len(corpus) - window_size, window_size)]

    def __getitem__(self, idx):
        g = self.grams[idx]
        return tuple(np.asarray(x, dtype=np.int64) for x in g)

    def __len__(self):
        return len(self.grams)


class UCIHousing(Dataset):
    """13-feature regression. reference: text/datasets/uci_housing.py"""

    N_FEAT = 13

    def __init__(self, data_path=None, mode="train"):
        self.synthetic = not (data_path and os.path.exists(data_path))
        if not self.synthetic:
            raw = np.loadtxt(data_path).astype(np.float32)
            feats, target = raw[:, :-1], raw[:, -1:]
        else:
            rng = _rng(mode, 0x0C1)
            n = 404 if mode == "train" else 102
            feats = rng.randn(n, self.N_FEAT).astype(np.float32)
            w = np.linspace(-2, 2, self.N_FEAT).astype(np.float32)
            target = (feats @ w[:, None]
                      + 0.1 * rng.randn(n, 1)).astype(np.float32)
        mu, sig = feats.mean(0), feats.std(0) + 1e-6
        self.data = ((feats - mu) / sig).astype(np.float32)
        self.target = target

    def __getitem__(self, idx):
        return self.data[idx], self.target[idx]

    def __len__(self):
        return len(self.data)


class Conll05st(Dataset):
    """SRL: token/predicate/label id sequences.
    reference: text/datasets/conll05.py"""

    def __init__(self, data_path=None, mode="train"):
        self.synthetic = True
        rng = _rng(mode, 0xC05)
        n = 500 if mode == "train" else 100
        self.word_dict = {f"w{i}": i for i in range(3000)}
        self.label_dict = {f"L{i}": i for i in range(20)}
        self.predicate_dict = {f"p{i}": i for i in range(100)}
        self.samples = []
        for _ in range(n):
            ln = rng.randint(5, 40)
            words = rng.randint(0, 3000, ln).astype(np.int64)
            pred = np.full(ln, rng.randint(0, 100), np.int64)
            labels = rng.randint(0, 20, ln).astype(np.int64)
            self.samples.append((words, pred, labels))

    def __getitem__(self, idx):
        return self.samples[idx]

    def __len__(self):
        return len(self.samples)


class Movielens(Dataset):
    """(user, gender, age, occupation, movie, category, title) -> rating.
    reference: text/datasets/movielens.py"""

    def __init__(self, data_path=None, mode="train"):
        self.synthetic = True
        rng = _rng(mode, 0x303)
        n = 2000 if mode == "train" else 400
        self.samples = []
        for _ in range(n):
            user = rng.randint(0, 6040)
            movie = rng.randint(0, 3883)
            feats = (np.int64(user), np.int64(rng.randint(0, 2)),
                     np.int64(rng.randint(0, 7)), np.int64(rng.randint(0, 21)),
                     np.int64(movie), rng.randint(0, 18, 3).astype(np.int64),
                     rng.randint(0, 5000, 4).astype(np.int64))
            rating = np.float32((user * 7 + movie * 3) % 5 + 1)
            self.samples.append(feats + (rating,))

    def __getitem__(self, idx):
        return self.samples[idx]

    def __len__(self):
        return len(self.samples)


class _SyntheticTranslation(Dataset):
    SRC_VOCAB = 3000
    TRG_VOCAB = 3000
    BOS, EOS, UNK = 0, 1, 2

    def __init__(self, mode, salt):
        self.synthetic = True
        rng = _rng(mode, salt)
        n = 1000 if mode == "train" else 200
        self.src_word_idx = {f"s{i}": i for i in range(self.SRC_VOCAB)}
        self.trg_word_idx = {f"t{i}": i for i in range(self.TRG_VOCAB)}
        self.samples = []
        for _ in range(n):
            ln = rng.randint(4, 30)
            src = rng.randint(3, self.SRC_VOCAB, ln).astype(np.int64)
            # target = deterministic "translation" (reversed, shifted) so
            # seq2seq models have real signal
            trg_body = ((src[::-1] + 7) % (self.TRG_VOCAB - 3) + 3)
            trg = np.concatenate([[self.BOS], trg_body]).astype(np.int64)
            trg_next = np.concatenate([trg_body, [self.EOS]]).astype(np.int64)
            self.samples.append((src, trg, trg_next))

    def __getitem__(self, idx):
        return self.samples[idx]

    def __len__(self):
        return len(self.samples)


class WMT14(_SyntheticTranslation):
    """reference: text/datasets/wmt14.py"""

    def __init__(self, data_path=None, mode="train", dict_size=3000):
        super().__init__(mode, 0x1414)


class WMT16(_SyntheticTranslation):
    """reference: text/datasets/wmt16.py"""

    def __init__(self, data_path=None, mode="train", src_dict_size=3000,
                 trg_dict_size=3000, lang="en"):
        super().__init__(mode, 0x1616)


def _lengths(lengths, batch, steps, device):
    if lengths is None:
        return torch.full((batch,), steps, dtype=torch.int64, device=device)
    return torch.as_tensor(unwrap(lengths)).to(device=device,
                                               dtype=torch.int64)


def _backtrace(last, backptrs):
    """The best path [B, T] from the last tag and the backpointers of
    steps 1..T-1 (slot k maps the tag at k + 1 to the tag at k)."""
    path = [last]
    tag = last
    for bp in reversed(backptrs):
        tag = torch.gather(bp, 1, tag[:, None])[:, 0]
        path.append(tag)
    return torch.stack(path[::-1], dim=1)


def _viterbi(emis, square, alpha, lens):
    """Max-product over time from ``alpha`` (the scores at step 0):
    returns the scores at the last step and the backpointers."""
    B, T, N = emis.shape
    ident = torch.arange(N, device=emis.device).expand(B, N)
    backptrs = []
    for t in range(1, T):
        scores = alpha[:, :, None] + square[None, :, :]  # [B, prev, next]
        best_prev = torch.argmax(scores, dim=1)
        nxt = torch.amax(scores, dim=1) + emis[:, t]
        active = (t < lens)[:, None]
        alpha = torch.where(active, nxt, alpha)
        backptrs.append(torch.where(active, best_prev, ident))
    return alpha, backptrs


def viterbi_decode(potentials, transition_params, lengths=None,
                   include_bos_eos_tag=True):
    """Viterbi decoding of linear-chain CRF scores (reference:
    ``paddle.text.viterbi_decode``, operators/viterbi_decode_op).

    potentials: [B, T, N] unary scores; transition_params: [N, N] (with
    ``include_bos_eos_tag``, tags N-2 and N-1 are BOS and EOS). Returns
    (scores [B], paths [B, T])."""
    pot = unwrap(potentials)
    trans = unwrap(transition_params).to(pot.device)
    B, T, N = pot.shape
    lens = _lengths(lengths, B, T, pot.device)
    alpha = pot[:, 0, :]
    if include_bos_eos_tag:
        alpha = alpha + trans[N - 2][None, :]
    alpha, backptrs = _viterbi(pot, trans, alpha, lens)
    if include_bos_eos_tag:
        alpha = alpha + trans[:, N - 1][None, :]
    last = torch.argmax(alpha, dim=-1)
    score = torch.amax(alpha, dim=-1)
    return wrap(score), wrap(_backtrace(last, backptrs))


class ViterbiDecoder:
    """A layer-style wrapper over :func:`viterbi_decode` (reference:
    ``paddle.text.ViterbiDecoder``)."""

    def __init__(self, transitions, include_bos_eos_tag=True, name=None):
        self.transitions = transitions
        self.include_bos_eos_tag = include_bos_eos_tag

    def __call__(self, potentials, lengths=None):
        return viterbi_decode(potentials, self.transitions, lengths,
                              self.include_bos_eos_tag)


def linear_chain_crf(input, label, transition, length=None):  # noqa: A002
    """The linear-chain CRF's negative log-likelihood [B, 1] (reference:
    operators/linear_chain_crf_op.h, whose kernel returns ``-ll``), in
    fluid's transition layout [N + 2, N]: row 0 start, row 1 stop, rows 2+
    the square. input: [B, T, N] padded emissions, label: [B, T] tags,
    length: [B]. Differentiable in ``input`` and ``transition``."""
    from ..core.dispatch import call_op
    lab = torch.as_tensor(unwrap(label)).long()
    ln = None if length is None else unwrap(length)

    def _crf(emis, trans):
        B, T, N = emis.shape
        lens = _lengths(ln, B, T, emis.device)
        labels = lab.to(emis.device)
        start, stop, sq = trans[0], trans[1], trans[2:]
        # the partition function
        alpha = emis[:, 0] + start[None, :]
        for t in range(1, T):
            nxt = torch.logsumexp(alpha[:, :, None] + sq[None, :, :],
                                  dim=1) + emis[:, t]
            alpha = torch.where((t < lens)[:, None], nxt, alpha)
        logz = torch.logsumexp(alpha + stop[None, :], dim=1)
        # the gold path's score
        t_idx = torch.arange(T, device=emis.device)
        valid = t_idx[None, :] < lens[:, None]
        emit_sc = torch.gather(emis, 2, labels[..., None])[..., 0]
        emit_sum = torch.sum(torch.where(valid, emit_sc,
                                         torch.zeros_like(emit_sc)), dim=1)
        tr_sc = sq[labels[:, :-1], labels[:, 1:]]
        tr_valid = t_idx[None, 1:] < lens[:, None]
        tr_sum = torch.sum(torch.where(tr_valid, tr_sc,
                                       torch.zeros_like(tr_sc)), dim=1)
        first = labels[:, 0]
        last = torch.gather(labels, 1, (lens - 1)[:, None])[:, 0]
        gold = start[first] + emit_sum + tr_sum + stop[last]
        return (logz - gold)[:, None]

    return call_op(_crf, input, transition, op_name="linear_chain_crf")


def crf_decoding(input, transition, label=None, length=None):  # noqa: A002
    """Viterbi decoding in fluid's [N + 2, N] transition layout
    (reference: operators/crf_decoding_op.h). Returns the best path [B, T],
    0 past each sequence's length; with ``label``, 1 where the decoded tag
    equals the label and 0 elsewhere and past the lengths (the reference's
    error-indicator mode)."""
    emis = unwrap(input).detach()
    trans = unwrap(transition).detach().to(emis.device)
    B, T, _ = emis.shape
    lens = _lengths(length, B, T, emis.device)
    start, stop, sq = trans[0], trans[1], trans[2:]
    alpha, backptrs = _viterbi(emis, sq, emis[:, 0] + start[None, :], lens)
    last = torch.argmax(alpha + stop[None, :], dim=-1)
    inside = torch.arange(T, device=emis.device)[None, :] < lens[:, None]
    path = torch.where(inside, _backtrace(last, backptrs),
                       torch.zeros((), dtype=torch.int64,
                                   device=emis.device))
    if label is None:
        return wrap(path)
    lab = torch.as_tensor(unwrap(label)).to(device=emis.device,
                                            dtype=path.dtype)
    ok = path == lab
    if length is not None:
        ok = ok & inside
    return wrap(ok.to(torch.int64))
