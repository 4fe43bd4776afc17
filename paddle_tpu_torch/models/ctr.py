"""Wide & Deep CTR model + the cached async training loop (counterpart:
``paddle_tpu/models/ctr.py``; the reference framework's ``dist_ctr``
fixtures of ``test_dist_base.py``, PaddleRec's wide_deep).

Sparse slot ids look up embedding tables that live on the parameter
servers, a deep MLP over the concatenated embeddings joins a wide
(linear-in-one-hot) term, and the sparse tables train at device speed
through the device-resident cache.

Two execution modes share the model:

- **eager** — ``model(ids)``: per-batch ``lookup``/``apply_grads`` over
  the bound caches (or plain per-batch PS pulls with ``cached=False``).
- **k-step windows** — ``model((slots, inv), (wide_slots, wide_inv))``
  inside ``to_static(..., scan_steps=k)``: lookups gather from the device
  tables by prefetched static-shaped feeds, sparse gradients accumulate in
  the caches' delta stores, and :func:`train_ctr_windows` drives the async
  pipeline — a ``CachePrefetcher`` plans window N+1 while the device runs
  window N, and eviction/end-pass deltas push through a ``WriteBackQueue``
  behind the next window's compute. On the card every window replays one
  captured CUDA graph of one step.

Synthetic data (:func:`synthetic_ctr_batches`) draws slot ids from a
Zipf-skewed distribution and labels from a fixed hidden per-key scorer,
the reference's generator draw for draw.
"""
import numpy as np
import torch

from .. import nn
from ..nn import functional as F
from ..nn.layer.layers import Layer

__all__ = ["WideAndDeep", "synthetic_ctr_batches", "build_ctr_scan_step",
           "train_ctr_windows"]


class WideAndDeep(Layer):
    """Wide & Deep over ``slots`` sparse id slots of one vocab.

    Deep: concat of per-slot ``dim``-d embeddings → MLP → logit.
    Wide: per-key scalar weights (an embedding table of dim 1) summed
    over the slots. Both tables live on the PS (``table_id`` /
    ``wide_table_id``); with ``cached=True`` they serve from
    device-resident caches (``CachedSparseEmbedding``). The dense layers
    and the caches are on ``device`` (the card unless ``"cpu"``).

    ``forward(ids)`` for the eager path; ``forward(deep_feed,
    wide_feed)`` with ``(slots, inv)`` pairs (``WindowPlan.feeds()``)
    inside a k-step body.
    """

    def __init__(self, vocab, dim=16, slots=8, hidden=(64, 32),
                 cached=True, capacity=None, table_id=1000,
                 wide_table_id=1001, optimizer="sgd", lr=0.01,
                 init_range=0.05, writeback=None, watermark=(0.0, 0.15),
                 device=None):
        super().__init__()
        from ..distributed.ps import CachedSparseEmbedding, SparseEmbedding
        self.vocab, self.dim, self.slots = vocab, dim, slots
        if cached:
            kw = dict(capacity=capacity, optimizer=optimizer, lr=lr,
                      init_range=init_range, writeback=writeback,
                      watermark=watermark, device=device)
            self.emb = CachedSparseEmbedding([vocab, dim],
                                             table_id=table_id, **kw)
            self.wide = CachedSparseEmbedding([vocab, 1],
                                              table_id=wide_table_id, **kw)
        else:
            self.emb = SparseEmbedding([vocab, dim], table_id=table_id,
                                       init_range=init_range, device=device)
            self.wide = SparseEmbedding([vocab, 1],
                                        table_id=wide_table_id,
                                        init_range=init_range, device=device)
        self.deep = nn.LayerList()
        prev = slots * dim
        for h in hidden:
            self.deep.append(nn.Linear(prev, h, device=device))
            prev = h
        self.head = nn.Linear(prev, 1, device=device)

    def caches(self):
        """The bound device caches (deep, wide) — empty when uncached."""
        return [e.cache for e in (self.emb, self.wide)
                if getattr(e, "cache", None) is not None]

    def forward(self, ids, wide_ids=None):
        wide_ids = ids if wide_ids is None else wide_ids
        e = self.emb(ids)        # [B, S, D]
        w = self.wide(wide_ids)  # [B, S, 1]
        h = e.reshape(e.shape[0], self.slots * self.dim)
        for fc in self.deep:
            h = F.relu(fc(h))
        return self.head(h) + w.sum(1)


def synthetic_ctr_batches(n_batches, batch_size=256, slots=8,
                          vocab=50000, seed=7, zipf=1.2):
    """``[(ids int64 [B, S], label float32 [B, 1]), ...]`` — Zipf-skewed
    ids (rank-r key drawn ∝ 1/r^zipf, shuffled over the vocab so hot
    keys scatter across the id space like real feasign hashes) and
    labels from a hidden per-key scorer thresholded at zero."""
    rng = np.random.RandomState(seed)
    p = 1.0 / np.arange(1, vocab + 1, dtype=np.float64) ** zipf
    p /= p.sum()
    perm = np.random.RandomState(11).permutation(vocab)
    scorer = np.random.RandomState(1).randn(vocab).astype(np.float32)
    out = []
    for _ in range(n_batches):
        ranks = rng.choice(vocab, (batch_size, slots), p=p)
        ids = perm[ranks].astype(np.int64)
        score = scorer[ids].mean(axis=1)
        label = (score > 0.0).astype(np.float32).reshape(-1, 1)
        out.append((ids, label))
    return out


def build_ctr_scan_step(model, optimizer, k):
    """The k-step CTR training program: ``[k, ...]``-stacked window feeds
    in, per-step losses out. Dense parameters update in the body through
    ``optimizer``; sparse gradients accumulate in the caches' delta stores
    and drain at the window boundary (``cache.drain_window``)."""
    from ..jit.to_static import to_static

    def one_step(deep_slots, deep_inv, wide_slots, wide_inv, labels):
        logit = model((deep_slots, deep_inv), (wide_slots, wide_inv))
        loss = F.binary_cross_entropy_with_logits(logit, labels)
        loss.backward()
        optimizer.step()
        optimizer.clear_grad()
        return loss

    return to_static(one_step, scan_steps=k)


def train_ctr_windows(model, optimizer, batches, k, prefetch=True,
                      depth=2, bucket=None, step=None, flush=True):
    """Drive cached CTR training as k-step windows with the async
    pipeline. ``batches`` is a list of ``(ids, label)`` (from
    :func:`synthetic_ctr_batches`); consecutive groups of ``k`` form one
    window. With ``prefetch`` a ``CachePrefetcher`` plans window N+1
    (dedupe → PS pull; the install happens on this thread at
    ``feeds()``) while the device executes window N; ``prefetch=False``
    plans synchronously — numerically identical (same plan order), all
    pull time exposed.

    Returns ``{"losses", "windows", "overlap_efficiency", "pull_s",
    "wait_s", "lookups"}``. ``overlap_efficiency`` is 0.0 when
    ``prefetch=False`` (nothing hidden) and excludes the first window
    (its fill cannot overlap anything).
    """
    from ..distributed.ps import CachePrefetcher

    caches = model.caches()
    if not caches:
        raise RuntimeError("train_ctr_windows needs a CACHED WideAndDeep "
                           "(cached=True) bound to a communicator")
    n_win = len(batches) // k
    if n_win < 1:
        raise ValueError(f"need at least k={k} batches, got {len(batches)}")
    ids_w = [np.stack([batches[w * k + i][0] for i in range(k)])
             for w in range(n_win)]
    lab_w = [np.stack([batches[w * k + i][1] for i in range(k)])
             for w in range(n_win)]
    if bucket is None:
        # worst-case per-step unique count, so every window of the run
        # shares one program
        b = 8
        while b < ids_w[0].shape[1] * ids_w[0].shape[2]:
            b <<= 1
        bucket = b
    if step is None:
        step = build_ctr_scan_step(model, optimizer, k)

    pf = CachePrefetcher(caches, depth=depth, bucket=bucket) \
        if prefetch else None
    losses = []
    lookups = 0
    try:
        if pf is not None:
            for w in range(min(depth, n_win)):
                pf.submit(ids_w[w])
        for w in range(n_win):
            if pf is not None:
                plans = pf.take()
                if w == 0:
                    # the first fill has nothing to hide behind — keep
                    # the overlap metric about the steady state
                    pf.reset_stats()
            else:
                plans = {c.table_id: c.plan_window(ids_w[w], bucket=bucket)
                         for c in caches}
            deep_p = plans[model.emb.table_id]
            wide_p = plans[model.wide.table_id]
            (ds, di), (ws, wi) = deep_p.feeds(), wide_p.feeds()
            ys = step(ds, di, ws, wi, caches[0]._to_device(lab_w[w]))
            if pf is not None and w + depth < n_win:
                pf.submit(ids_w[w + depth])
            for c, p in ((model.emb.cache, deep_p),
                         (model.wide.cache, wide_p)):
                c.drain_window(p)
            losses.extend(ys.detach().cpu().numpy().ravel().tolist())
            lookups += int(ids_w[w].size) * len(caches)
    finally:
        if pf is not None:
            pf.close()
    for c in caches:
        c.end_pass(flush=flush)
    return {"losses": losses, "windows": n_win,
            "overlap_efficiency": (pf.overlap_efficiency()
                                   if pf is not None else 0.0),
            "pull_s": pf.pull_s if pf is not None else 0.0,
            "wait_s": pf.wait_s if pf is not None else 0.0,
            "lookups": lookups}
