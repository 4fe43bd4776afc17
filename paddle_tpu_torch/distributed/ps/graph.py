"""Graph parameter-server client (counterpart:
``paddle_tpu/distributed/ps/graph.py``; the reference framework's
`distributed/table/common_graph_table.cc` sharded graph storage + neighbor
sampling, `service/graph_brpc_server.cc:404` RPC handlers,
`service/graph_py_service.{h,cc}` GraphPyClient — batch_sample_neighboors,
random_sample_nodes, pull_graph_list, get_node_feat).

The graph tables live in the native PS service (``_native/src/
ps_service.cc``, ops 20-26); this client speaks to them through
:class:`~.client.PsClient` with the reference's request bytes, so either
package's client talks to either package's server. Nodes shard across the
servers by ``id % n_servers``; edges live on their source node's shard, so
neighbor sampling is a single-server operation per node.

Node features are fixed-dim float32 vectors: every feature pull returns a
dense ``(n, feat_dim)`` array. Sampling is deterministic per (seed, node):
the server runs a partial Fisher–Yates with an xorshift64 rng seeded by
splitmix64, which :func:`deterministic_sample_indices` reproduces bit for
bit. A sampling reply is decoded with numpy views: one pass over its
per-node counts, then one gather of every neighbor and weight.
"""
import struct

import numpy as np

from .client import PsClient  # noqa: F401  (re-exported convenience)

__all__ = ["GraphPsClient", "deterministic_sample_indices"]

OP_GRAPH_ADD_NODES = 20
OP_GRAPH_ADD_EDGES = 21
OP_GRAPH_SAMPLE_NEIGHBORS = 22
OP_GRAPH_PULL_LIST = 23
OP_GRAPH_NODE_FEAT = 24
OP_GRAPH_RANDOM_NODES = 25
OP_GRAPH_SIZE = 26

_MASK = np.uint64(0xFFFFFFFFFFFFFFFF)
_ENTRY = 12  # one sampled neighbor on the wire: u64 id + f32 weight


def _mix64(x):
    x = np.uint64(x)
    with np.errstate(over="ignore"):
        x = (x + np.uint64(0x9E3779B97F4A7C15)) & _MASK
        x = ((x ^ (x >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)) \
            & _MASK
        x = ((x ^ (x >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)) \
            & _MASK
        return x ^ (x >> np.uint64(31))


def deterministic_sample_indices(seed, node_id, degree, k):
    """Python mirror of the server's neighbor sampler (ps_service.cc
    kGraphSampleNeighbors): partial Fisher–Yates driven by xorshift64
    seeded with mix64(seed ^ mix64(node_id))."""
    cnt = min(degree, k)
    idx = list(range(degree))
    s = int(_mix64(np.uint64(seed) ^ _mix64(node_id)))
    if s == 0:
        s = 0x9E3779B97F4A7C15
    out = []
    for j in range(cnt):
        s ^= (s << 13) & 0xFFFFFFFFFFFFFFFF
        s ^= s >> 7
        s ^= (s << 17) & 0xFFFFFFFFFFFFFFFF
        pick = j + s % (degree - j)
        idx[j], idx[pick] = idx[pick], idx[j]
        out.append(idx[j])
    return out


def _decode_samples(raw, n, k):
    """A sampling reply of ``n`` nodes (per node ``u32 cnt | cnt x (u64
    neighbor, f32 weight)``) as ``(counts [n], nbrs, weights, filled [n,
    k])``: one pass over the counts finds each node's entries, and one
    gather reads them all."""
    buf = np.frombuffer(raw, np.uint8)
    counts = np.empty(n, np.int64)
    starts = np.empty(n, np.int64)
    off = 0
    unpack = struct.Struct("<I").unpack_from
    for i in range(n):
        (c,) = unpack(raw, off)
        counts[i] = c
        starts[i] = off + 4
        off += 4 + _ENTRY * c
    filled = np.arange(k)[None, :] < counts[:, None]
    at = (starts[:, None] + _ENTRY * np.arange(k)[None, :])[filled]
    body = buf[at[:, None] + np.arange(_ENTRY)[None, :]]
    nb = body[:, :8].copy().view(np.uint64).ravel()
    wt = body[:, 8:].copy().view(np.float32).ravel()
    return counts, nb, wt, filled


def _parts(idx, *arrays):
    """The rows ``idx`` of each array, as the buffers of one request (the
    arrays themselves when ``idx`` takes every row)."""
    whole = idx.size == arrays[0].shape[0]
    return [a if whole else a[idx] for a in arrays]


class GraphPsClient:
    """Client view of one sharded graph table (GraphPyClient analog)."""

    def __init__(self, client, table_id, feat_dim):
        self.client = client
        self.table_id = table_id
        self.feat_dim = feat_dim

    # -- construction -----------------------------------------------------
    def add_nodes(self, ids, feats=None):
        ids = np.ascontiguousarray(ids, np.uint64).ravel()
        feats = (np.zeros((ids.size, self.feat_dim), np.float32)
                 if feats is None
                 else np.ascontiguousarray(feats, np.float32).reshape(
                     ids.size, self.feat_dim))
        for srv, idx in self.client._shard(ids):
            self.client._check_ok(
                self.client._call(srv, OP_GRAPH_ADD_NODES, self.table_id,
                                  idx.size, _parts(idx, ids, feats)),
                self.table_id)

    def add_edges(self, src, dst, weight=None):
        """Directed edges; pass both directions for an undirected graph
        (reference load_edges reverse_edge flag)."""
        src = np.ascontiguousarray(src, np.uint64).ravel()
        dst = np.ascontiguousarray(dst, np.uint64).ravel()
        w = (np.ones(src.size, np.float32) if weight is None
             else np.ascontiguousarray(weight, np.float32).ravel())
        for srv, idx in self.client._shard(src):
            self.client._check_ok(
                self.client._call(srv, OP_GRAPH_ADD_EDGES, self.table_id,
                                  idx.size, _parts(idx, src, dst, w)),
                self.table_id)

    def load_node_file(self, path):
        """Text format: ``id f1 f2 ... f<feat_dim>`` per line (reference:
        load_nodes `node_type \\t id \\t features`; node types collapse
        into separate table_ids here)."""
        ids, feats = [], []
        with open(path) as f:
            for line in f:
                parts = line.split()
                if not parts:
                    continue
                ids.append(int(parts[0]))
                row = [float(x) for x in parts[1:1 + self.feat_dim]]
                row += [0.0] * (self.feat_dim - len(row))
                feats.append(row)
        if ids:
            self.add_nodes(np.array(ids, np.uint64),
                           np.array(feats, np.float32))
        return len(ids)

    def load_edge_file(self, path, reverse_edge=False):
        """Text format: ``src dst [weight]`` per line (reference:
        load_edges + reverse_edge)."""
        src, dst, w = [], [], []
        with open(path) as f:
            for line in f:
                parts = line.split()
                if len(parts) < 2:
                    continue
                src.append(int(parts[0]))
                dst.append(int(parts[1]))
                w.append(float(parts[2]) if len(parts) > 2 else 1.0)
        if src:
            self.add_edges(np.array(src, np.uint64),
                           np.array(dst, np.uint64),
                           np.array(w, np.float32))
            if reverse_edge:
                self.add_edges(np.array(dst, np.uint64),
                               np.array(src, np.uint64),
                               np.array(w, np.float32))
        return len(src)

    # -- queries ----------------------------------------------------------
    def sample_neighbors(self, ids, k, seed=0):
        """Up-to-k neighbors per node. Returns ``(nbrs, weights, counts)``
        with nbrs/weights padded to ``(n, k)`` and a count vector (the
        reference returns ragged vector<vector<pair>>); padded lanes repeat
        the node's own id with weight 0, so a mean-aggregation GNN needs
        no masking."""
        ids = np.ascontiguousarray(ids, np.uint64).ravel()
        n = ids.size
        nbrs = np.tile(ids[:, None], (1, k))
        weights = np.zeros((n, k), np.float32)
        counts = np.zeros(n, np.int32)
        extra = np.uint32(k).tobytes() + np.uint64(seed).tobytes()
        for srv, idx in self.client._shard(ids):
            payload = ids[idx].tobytes() + extra
            raw = self.client._call(srv, OP_GRAPH_SAMPLE_NEIGHBORS,
                                    self.table_id, idx.size, payload,
                                    idempotent=True)
            cnt, nb, wt, filled = _decode_samples(raw, idx.size, k)
            sub_n = nbrs[idx]
            sub_w = weights[idx]
            sub_n[filled] = nb
            sub_w[filled] = wt
            nbrs[idx] = sub_n
            weights[idx] = sub_w
            counts[idx] = cnt
        return nbrs, weights, counts

    def node_feat(self, ids):
        ids = np.ascontiguousarray(ids, np.uint64).ravel()
        if self.client.n_servers == 1:  # the reply is the whole result
            raw = self.client._call(0, OP_GRAPH_NODE_FEAT, self.table_id,
                                    ids.size, ids, idempotent=True)
            return np.frombuffer(raw, np.float32).reshape(ids.size,
                                                          self.feat_dim)
        out = np.zeros((ids.size, self.feat_dim), np.float32)
        for srv, idx in self.client._shard(ids):
            raw = self.client._call(srv, OP_GRAPH_NODE_FEAT, self.table_id,
                                    idx.size, ids[idx].tobytes(),
                                    idempotent=True)
            out[idx] = np.frombuffer(raw, np.float32).reshape(
                idx.size, self.feat_dim)
        return out

    def pull_graph_list(self, server, start, count):
        """Node-id batch from one server's shard, in insertion order
        (reference: pull_graph_list paging)."""
        payload = (np.uint64(start).tobytes() +
                   np.uint64(count).tobytes())
        raw = self.client._call(server, OP_GRAPH_PULL_LIST, self.table_id,
                                0, payload, idempotent=True)
        return np.frombuffer(raw, np.uint64).copy()

    def random_sample_nodes(self, server, k, seed=0):
        payload = (np.uint32(k).tobytes() + np.uint64(seed).tobytes())
        raw = self.client._call(server, OP_GRAPH_RANDOM_NODES,
                                self.table_id, 0, payload, idempotent=True)
        return np.frombuffer(raw, np.uint64).copy()

    def node_count(self):
        total = 0
        for srv in range(self.client.n_servers):
            raw = self.client._call(srv, OP_GRAPH_SIZE, self.table_id, 0,
                                    idempotent=True)
            total += int(np.frombuffer(raw, np.uint64)[0])
        return total

    # -- composite walks (reference: GraphPyClient use-cases) -------------
    def sample_khop(self, ids, k_per_hop, seed=0):
        """K-hop neighborhood expansion for GNN minibatches: returns a
        list of (nbrs, weights, counts) per hop; hop h samples neighbors
        of hop h-1's flattened frontier."""
        out = []
        frontier = np.ascontiguousarray(ids, np.uint64).ravel()
        for h, k in enumerate(k_per_hop):
            nbrs, w, cnt = self.sample_neighbors(frontier, k,
                                                 seed=seed + h)
            out.append((nbrs, w, cnt))
            frontier = nbrs.ravel()
        return out

    def random_walk(self, start_ids, walk_len, seed=0):
        """Deterministic random walks (one neighbor per step). Dead ends
        repeat the final node, like the padded-sampling convention."""
        walks = [np.ascontiguousarray(start_ids, np.uint64).ravel()]
        for step in range(walk_len):
            nbrs, _w, _c = self.sample_neighbors(walks[-1], 1,
                                                 seed=seed + step)
            walks.append(nbrs[:, 0])
        return np.stack(walks, axis=1)  # (n, walk_len + 1)
