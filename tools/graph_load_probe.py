"""Where the graph PS's load time goes: the port's native service at the
Reddit graph's size (232,965 nodes x 602 float32 features, log-normal
degrees around 492: ~114.7 M edges), in the chunks `chip_smoke.py` phase
18 (b) sends.

    PYTHONPATH=. python tools/graph_load_probe.py
    PYTHONPATH=. python tools/graph_load_probe.py --top-pad-bytes 131072

Prints the seconds of: the nodes' requests sent to a table the server does
not hold (the transport and the frame's parse alone), the nodes' first
insert, their overwrite (no allocation), the edges' requests to no table,
the edges' insert, and one feature pull of 104,000 unique ids.
``--top-pad-bytes`` sets glibc's ``M_TOP_PAD`` after the server started
(the service sets 64 MB), to compare heap growth in small steps.
"""
import argparse
import ctypes
import time

import numpy as np

M_TOP_PAD = -2  # glibc's mallopt parameter
FEAT, NODES, DEGREE = 602, 232_965, 492
NODE_CHUNK, EDGE_CHUNK = 20_000, 1 << 23


def timed(label, fn):
    t0 = time.perf_counter()
    fn()
    print(f"{label}: {time.perf_counter() - t0:.3f} s", flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--top-pad-bytes", type=int, default=None)
    args = ap.parse_args()
    from paddle_tpu_torch.distributed import ps
    from paddle_tpu_torch.distributed.ps.graph import (OP_GRAPH_ADD_EDGES,
                                                       OP_GRAPH_ADD_NODES)
    srv = ps.PsServer([ps.TableConfig(7, "graph", FEAT)], port=0)
    cli = ps.PsClient([f"127.0.0.1:{srv.start()}"])
    if args.top_pad_bytes is not None:
        ctypes.CDLL("libc.so.6").mallopt(M_TOP_PAD, args.top_pad_bytes)
    g = ps.GraphPsClient(cli, 7, FEAT)
    rng = np.random.default_rng(0)
    feats = rng.standard_normal((NODES, FEAT), dtype=np.float32)
    ids = np.arange(NODES, dtype=np.uint64)
    deg = np.exp(np.log(DEGREE) - 0.5 + rng.standard_normal(NODES))
    deg = np.clip(np.rint(deg), 1, NODES - 1).astype(np.int64)
    off = np.concatenate([[0], np.cumsum(deg)])
    dst = rng.integers(0, NODES, off[-1], dtype=np.uint64)
    cuts = np.searchsorted(off, np.arange(EDGE_CHUNK, off[-1], EDGE_CHUNK))
    bounds = [0, *sorted(set(int(c) for c in cuts)), NODES]
    spans = [(a, b) for a, b in zip(bounds, bounds[1:]) if a < b]
    nodes = [(ids[a:a + NODE_CHUNK], feats[a:a + NODE_CHUNK])
             for a in range(0, NODES, NODE_CHUNK)]

    def no_table(op, parts):
        cli._call(0, op, 99, parts[0].size, list(parts))  # ok = 0: ignored

    def edges(a, b):
        return np.repeat(ids[a:b], deg[a:b]), dst[off[a]:off[b]]

    try:
        timed("nodes to no table", lambda: [no_table(OP_GRAPH_ADD_NODES, n)
                                            for n in nodes])
        timed("nodes, first insert", lambda: [g.add_nodes(*n)
                                              for n in nodes])
        timed("nodes, overwrite", lambda: [g.add_nodes(*n) for n in nodes])
        timed("edges to no table", lambda: [no_table(OP_GRAPH_ADD_EDGES, (
            *edges(a, b), np.ones(int(off[b] - off[a]), np.float32)))
            for a, b in spans])
        timed(f"edges ({int(off[-1])}), insert",
              lambda: [g.add_edges(*edges(a, b)) for a, b in spans])
        q = rng.choice(NODES, 104_000, replace=False).astype(np.uint64)
        timed("feature pull of 104,000 ids", lambda: g.node_feat(q))
    finally:
        cli.stop_servers()
        cli.close()
        srv.stop()


if __name__ == "__main__":
    main()
