"""TDM tree index and its layer-wise sampler (counterpart:
``paddle_tpu/distributed/fleet/index_dataset.py``; the reference
framework's `distributed/index_dataset/index_wrapper.{h,cc}` TreeIndex and
`index_sampler.cc` LayerWiseSampler).

A :class:`TreeIndex` puts items on the leaves of a complete
``branch``-ary tree whose codes are heap positions (root 0, the children
of ``c`` at ``c * branch + 1 .. c * branch + branch``); every node carries
an embedding id. The index is held as numpy arrays over codes and item
ids, not as dicts, and the op feeds (``travel_array``, ``layer_array``,
``tree_info_array``) and :meth:`TreeIndex.from_items` are built a whole
layer at a time: at UserBehavior's 4,162,024 items a per-node loop takes
minutes. Every method returns what the reference's returns (lists of
Python ints, int64 arrays). Host code: numpy only.
"""
import numpy as np

__all__ = ["TreeIndex", "LayerWiseSampler"]


def _layer_first(branch, level):
    """The first heap code of ``level``."""
    if branch == 1:
        return level
    return (branch ** level - 1) // (branch - 1)


class TreeIndex:
    """Heap-coded retrieval tree over item ids.

    ``id_of_code`` maps heap codes to embedding ids and ``code_of_item``
    item ids to leaf codes (dicts, as in the reference). ``from_items``
    builds a balanced tree: the leaves fill the last layer from the left,
    item ids map to leaves in the given order, and the internal nodes get
    fresh ids after the largest item id, in code order.
    """

    def __init__(self, branch, height, id_of_code, code_of_item):
        codes = np.fromiter(id_of_code.keys(), np.int64, len(id_of_code))
        ids = np.fromiter(id_of_code.values(), np.int64, len(id_of_code))
        items = np.fromiter(code_of_item.keys(), np.int64, len(code_of_item))
        leaves = np.fromiter(code_of_item.values(), np.int64,
                             len(code_of_item))
        self._set(branch, height, codes, ids, items, leaves)

    def _set(self, branch, height, codes, ids, items, leaves):
        """Hold the tree as arrays: ``_ids[code]`` (0 where absent),
        ``_present[code]``, ``_item[code]`` and ``_leaf[code]`` (a code
        that carries an item), ``_code[item]`` (-1 where absent)."""
        self.branch = int(branch)
        self.height = int(height)          # layers, root layer = 0
        size = int(max(codes.max(initial=-1), leaves.max(initial=-1))) + 1
        self._ids = np.zeros(size, np.int64)
        self._ids[codes] = ids
        self._present = np.zeros(size, bool)
        self._present[codes] = True
        self._item = np.zeros(size, np.int64)
        self._item[leaves] = items
        self._leaf = np.zeros(size, bool)
        self._leaf[leaves] = True
        self._code = np.full(int(items.max(initial=-1)) + 1, -1, np.int64)
        self._code[items] = leaves
        return self

    # -- construction -----------------------------------------------------
    @classmethod
    def from_items(cls, item_ids, branch=2):
        items = np.asarray(item_ids).ravel().astype(np.int64)
        n = items.size
        if n == 0:
            raise ValueError("cannot build a tree over zero items")
        if branch < 2:
            raise ValueError("branch must be >= 2 (a 1-ary tree is a "
                             "path, not a retrieval index)")
        if int(items.min()) <= 0:
            raise ValueError(
                "item ids must be positive: 0 is the absent/padding "
                "sentinel in travel arrays and tdm_child leaf masks")
        if np.unique(items).size != n:
            raise ValueError("duplicate item ids in from_items")
        top = int(items.max())
        if top > max(1024, 8 * n):
            raise ValueError(
                f"max item id {top} is far larger than the "
                f"item count {n}; travel/emb tables are indexed by raw "
                f"id (like the reference's Travel tensor) — densify ids "
                f"to a contiguous range first")
        height = 1
        while branch ** (height - 1) < n:
            height += 1
        first_leaf = _layer_first(branch, height - 1)
        leaves = first_leaf + np.arange(n, dtype=np.int64)
        # the leaves fill their layer from the left, so each upper layer's
        # ancestors are a prefix of it: layer l holds ceil(n / b^(h-1-l))
        internal = [_layer_first(branch, lvl) + np.arange(
                        -(-n // branch ** (height - 1 - lvl)), dtype=np.int64)
                    for lvl in range(height - 1)]
        internal = (np.concatenate(internal) if internal
                    else np.zeros(0, np.int64))
        codes = np.concatenate([leaves, internal])
        ids = np.concatenate([items, top + 1 + np.arange(internal.size,
                                                         dtype=np.int64)])
        tree = cls.__new__(cls)
        return tree._set(branch, height, codes, ids, items, leaves)

    # -- code arithmetic (reference: index_wrapper.cc) --------------------
    def layer_of(self, code):
        lvl, first = 0, 0
        while True:
            last = first + self.branch ** lvl - 1 if self.branch == 1 \
                else (self.branch ** (lvl + 1) - 1) // (self.branch - 1) - 1
            if code <= last:
                return lvl
            lvl += 1
            first = last + 1

    def _leaf_code(self, item_id):
        item_id = int(item_id)
        code = self._code[item_id] if 0 <= item_id < self._code.size else -1
        if code < 0:
            raise KeyError(item_id)
        return int(code)

    def get_travel_codes(self, item_id, start_level=0):
        """Leaf-to-root ancestor codes of `item_id`, deepest first,
        stopping at `start_level` (GetTravelCodes)."""
        code = self._leaf_code(item_id)
        out = []
        lvl = self.height - 1
        while lvl >= start_level:
            out.append(code)
            code = (code - 1) // self.branch
            lvl -= 1
        return out

    def _layer_range(self, level):
        if self.branch == 1:
            return level, level
        return (_layer_first(self.branch, level),
                _layer_first(self.branch, level + 1) - 1)

    def _layer_codes(self, level):
        first, last = self._layer_range(level)
        lo, hi = max(first, 0), min(last + 1, self._present.size)
        if hi <= lo:
            return np.zeros(0, np.int64)
        return np.flatnonzero(self._present[lo:hi]).astype(np.int64) + lo

    def get_layer_codes(self, level):
        """Codes PRESENT in the tree at `level` (GetLayerCodes)."""
        return self._layer_codes(level).tolist()

    def get_ancestor_codes(self, item_ids, level):
        out = []
        for it in item_ids:
            code = self._leaf_code(it)
            lvl = self.height - 1
            while lvl > level:
                code = (code - 1) // self.branch
                lvl -= 1
            out.append(code)
        return out

    def get_children_codes(self, ancestor_code, level=None):
        """Direct children codes present in the tree (GetChildrenCodes;
        `level` kept for reference-signature parity)."""
        first = ancestor_code * self.branch + 1
        return [c for c in range(first, first + self.branch)
                if 0 <= c < self._present.size and self._present[c]]

    def _nodes(self, codes):
        """Embedding ids of an int array of codes; 0 for absent codes."""
        codes = np.asarray(codes, np.int64)
        if codes.size and 0 <= codes.min() and codes.max() < self._ids.size:
            return self._ids[codes]
        ok = (codes >= 0) & (codes < self._ids.size)
        return np.where(ok, self._ids[np.where(ok, codes, 0)], 0)

    def get_nodes(self, codes):
        """Embedding ids for `codes` (GetNodes); 0 for absent codes."""
        return self._nodes(np.asarray(list(codes), np.int64)).tolist()

    def get_all_leafs(self):
        return self._item[np.flatnonzero(self._leaf)].tolist()

    def emb_id_count(self):
        return int(self._ids[self._present].max()) + 1

    # -- op-shaped exports (feeds for tdm_sampler / tdm_child) -----------
    def travel_array(self, start_level=1):
        """(n_items, height - start_level) per-item ancestor EMB IDS,
        deepest-last — the `Travel` input of tdm_sampler_op (rows are
        root-side first, like the reference's layer ordering)."""
        items = np.flatnonzero(self._code >= 0)
        depth = self.height - start_level
        out = np.zeros((int(items.max()) + 1, depth), np.int64)
        cols = np.empty((max(depth, 0), items.size), np.int64)
        code = self._code[items]
        for col in range(depth - 1, -1, -1):   # deepest first
            cols[col] = self._nodes(code)
            code = (code - 1) // self.branch
        out[items] = cols.T
        return out

    def layer_array(self, start_level=1):
        """(flat layer emb ids, per-layer offsets) — the `Layer` input of
        tdm_sampler_op."""
        layers = [self._nodes(self._layer_codes(lvl))
                  for lvl in range(start_level, self.height)]
        offsets = np.cumsum([0] + [a.size for a in layers]).astype(np.int64)
        flat = (np.concatenate(layers) if layers else np.zeros(0, np.int64))
        return flat.astype(np.int64), offsets

    def tree_info_array(self):
        """(n_emb_ids, 3 + branch) rows of [item_id, layer, parent_id,
        child ids...] — the `TreeInfo` input of tdm_child_op."""
        b = self.branch
        n = self.emb_id_count()
        info = np.zeros((n, 3 + b), np.int64)
        codes = np.flatnonzero(self._present).astype(np.int64)
        if b == 1:
            layer = np.asarray([self.layer_of(int(c)) for c in codes],
                               np.int64)
        else:  # the first code of each layer, as far as the largest code
            firsts = [0]
            while firsts[-1] <= codes[-1]:
                firsts.append(firsts[-1] * b + 1)
            layer = np.searchsorted(np.asarray(firsts, np.int64), codes,
                                    side="right") - 1
        parent = np.where(codes > 0, self._nodes((codes - 1) // b), 0)
        kids = codes[:, None] * b + 1 + np.arange(b, dtype=np.int64)
        here = (kids < self._present.size) & self._present[
            np.minimum(kids, self._present.size - 1)]
        kid_ids = np.where(here, self._nodes(kids), 0)
        if b > 1 and not (here[:, :-1] >= here[:, 1:]).all():
            # present children first, in code order, then zeros (a tree
            # from items is packed already)
            kid_ids = np.take_along_axis(
                kid_ids, np.argsort(~here, axis=1, kind="stable"), axis=1)
        emb = self._ids[codes]
        info[emb, 0] = self._item[codes] * self._leaf[codes]
        info[emb, 1] = layer
        info[emb, 2] = parent
        info[emb, 3:] = kid_ids
        return info


class LayerWiseSampler:
    """Per-layer positive + uniform negatives for TDM training
    (reference: index_sampler.cc LayerWiseSampler::sample). Deterministic
    under `seed` — collisions with the positive re-sample, exactly like
    the reference's do/while, in the reference's draw order."""

    def __init__(self, tree, layer_counts, start_sample_layer=1, seed=0):
        self.tree = tree
        self.layer_counts = list(layer_counts)
        self.start = start_sample_layer
        self.seed = seed
        depth = tree.height - start_sample_layer
        if len(self.layer_counts) != depth:
            raise ValueError(
                f"layer_counts must have one entry per sampled layer "
                f"({depth}), got {len(self.layer_counts)}")

    def sample(self, user_inputs, target_ids, with_hierarchy=False):
        """Returns rows of [user features..., node_id, label]; one
        positive + layer_counts[j] negatives per layer per target."""
        rng = np.random.RandomState(self.seed)
        tree = self.tree
        layer_ids = {}
        rows = []
        for i, tid in enumerate(target_ids):
            codes = tree.get_travel_codes(int(tid), self.start)
            path = tree.get_nodes(codes)[::-1]    # root-side first
            for j, pos in enumerate(path):
                lvl = self.start + j
                if with_hierarchy and j > 0:
                    user = tree.get_nodes(tree.get_ancestor_codes(
                        user_inputs[i], lvl))
                else:
                    user = list(user_inputs[i])
                if lvl not in layer_ids:
                    layer_ids[lvl] = tree.get_nodes(tree.get_layer_codes(lvl))
                ids = layer_ids[lvl]
                if self.layer_counts[j] > len(ids) - 1:
                    raise ValueError(
                        f"layer_counts[{j}]={self.layer_counts[j]} "
                        f"exceeds layer {lvl} size {len(ids)} - 1 "
                        f"(the positive is excluded; the resample loop "
                        f"would never terminate)")
                rows.append(user + [pos, 1])
                for _ in range(self.layer_counts[j]):
                    neg = pos
                    while neg == pos:
                        neg = ids[rng.randint(len(ids))]
                    rows.append(user + [neg, 0])
        return np.asarray(rows, np.int64)
