"""The PS server over the native service (counterpart:
``paddle_tpu/distributed/ps/server.py``; the reference framework's
`distributed/service/brpc_ps_server.cc` + `fleet/runtime/the_one_ps.py:486`
init_server/run_server).

One server a process: the native library (``paddle_tpu_torch._native``,
built at first use) holds it. ``start`` raises when the library cannot be
built (no fallback). A started server is stopped at interpreter exit if its
owner did not stop it, so no service thread outlives the interpreter's
teardown.
"""
import atexit
import time

import numpy as np

from ... import _native
from ...observability import tracing as _obs

OPT_SUM = 0
OPT_SGD = 1
OPT_ADAM = 2

_OPT_BY_NAME = {"sum": OPT_SUM, "sgd": OPT_SGD, "adam": OPT_ADAM}


def server_op_stats():
    """Native per-(table, op) service-side latency totals:
    ``[{"table", "op", "calls", "ns"}, ...]`` (empty when the native lib
    is absent or no server ran). Monotonic until ``pt_ps_reset``."""
    import ctypes
    import json

    from .client import _OP_NAMES

    if not _native.loaded():
        return []
    lib = _native.lib()
    size = 1 << 16
    for _ in range(4):  # concurrent handlers can grow the table between
        buf = ctypes.create_string_buffer(size)  # the size probe + read
        n = lib.pt_ps_stats_json(buf, len(buf))
        if n >= 0:
            break
        size = -n + 4096
    if n <= 0:
        return []
    rows = json.loads(buf.value.decode())
    for r in rows:
        r["op"] = _OP_NAMES.get(r["op"], f"op{r['op']}")
    return rows


def server_trace_spans(drain=True):
    """Service-side spans for traced requests (clients propagating a
    trace context over the wire): ``[{"name", "table", "op", "trace",
    "parent", "span", "t0", "t1", "dup"}, ...]`` with ids as ints on the
    same monotonic ns base as client spans. ``drain=True`` empties the
    bounded native ring (spans are reported once)."""
    import ctypes
    import json

    from .client import _OP_NAMES

    if not _native.loaded():
        return []
    lib = _native.lib()
    size = 1 << 18
    for _ in range(4):  # ring can grow between the size probe + read
        buf = ctypes.create_string_buffer(size)
        n = lib.pt_ps_trace_json(buf, len(buf), 1 if drain else 0)
        if n >= 0:
            break
        size = -n + 4096
    if n <= 0:
        return []
    rows = json.loads(buf.value.decode())
    for r in rows:
        r["name"] = f"ps_server/{_OP_NAMES.get(r['op'], 'op%d' % r['op'])}"
    return rows


def drain_trace_to_runlog():
    """Move the native server-span ring into the active run-log (tagged
    ``process="ps_server"`` so the merge tool gives the service its own
    track). Returns the number of spans moved; no-op without a run-log
    or the native lib."""
    from ...observability import runlog
    if runlog.active() is None:
        return 0
    spans = server_trace_spans(drain=True)
    for r in spans:
        runlog.span(r["name"], "ps", r["t0"], r["t1"], r["trace"],
                    r["span"], r["parent"],
                    attrs={"table": r["table"], "dup": bool(r["dup"])},
                    process="ps_server", tid=0)
    return len(spans)


def _stats_collector():
    """Scrape-time collector: per-table per-op latency counters with
    Prometheus labels (ps_server_op_{calls,ns}{table=...,op=...}) plus
    the push request-id dedup counter (retries acked without
    re-applying — the server-side twin of the client's ps_retry_total)."""
    from ...observability.export import format_labels
    out = {}
    for r in server_op_stats():
        key = format_labels("ps_server_op", table=r["table"], op=r["op"])
        # SUM on duplicate keys: past the cardinality cap every
        # overflowed (table,op) shares one __overflow__ suffix — the
        # overflow series must aggregate their traffic, not report
        # whichever combo iterated last
        ck, nk = f"ps_server_op_calls{key}", f"ps_server_op_ns{key}"
        out[ck] = out.get(ck, 0) + r["calls"]
        out[nk] = out.get(nk, 0) + r["ns"]
    if _native.loaded():
        out["ps_server_dup_requests"] = int(
            _native.lib().pt_ps_dup_requests())
    return out


class TableConfig:
    """One PS table (reference: ps.proto TableParameter)."""

    def __init__(self, table_id, kind, dim, optimizer="sgd", lr=0.01,
                 beta1=0.9, beta2=0.999, eps=1e-8, init_range=0.0, seed=0,
                 mem_budget_rows=0, spill_path=None):
        assert kind in ("dense", "sparse", "graph")  # graph: dim=feat_dim
        self.table_id = table_id
        self.kind = kind
        self.dim = dim
        self.optimizer = optimizer
        self.lr = lr
        self.beta1 = beta1
        self.beta2 = beta2
        self.eps = eps
        self.init_range = init_range
        self.seed = seed
        # out-of-core sparse (reference: ssd_sparse_table.cc): cap the
        # in-memory rows; colder rows spill to `spill_path`
        self.mem_budget_rows = mem_budget_rows
        self.spill_path = spill_path


class PsServer:
    """In-process native PS server. One per process."""

    def __init__(self, tables, port=0):
        self.tables = list(tables)
        self.port = port
        self._started = False

    def start(self):
        lib = _native.lib()  # raises NativeBuildError with g++'s output
        lib.pt_ps_reset()
        for t in self.tables:
            opt = _OPT_BY_NAME[t.optimizer]
            if t.kind == "dense":
                lib.pt_ps_add_dense(t.table_id, t.dim, opt, t.lr, t.beta1,
                                    t.beta2, t.eps)
            elif t.kind == "graph":
                lib.pt_ps_add_graph(t.table_id, t.dim)
            else:
                lib.pt_ps_add_sparse(t.table_id, t.dim, opt, t.lr, t.beta1,
                                     t.beta2, t.eps, t.init_range, t.seed)
                if t.mem_budget_rows:
                    if not t.spill_path:
                        raise ValueError(
                            f"sparse table {t.table_id}: mem_budget_rows "
                            f"requires a spill_path")
                    # fail at startup, not at first eviction, when the
                    # spill location is unwritable
                    with open(t.spill_path, "ab"):
                        pass
                    lib.pt_ps_sparse_spill(t.table_id, t.mem_budget_rows,
                                           t.spill_path.encode())
        with _obs.trace_span("ps/server_start", cat="ps",
                             n_tables=len(self.tables)):
            port = lib.pt_ps_start(self.port)
        if port < 0:
            raise RuntimeError(f"ps server failed to bind port {self.port}")
        _obs.count("ps_server_starts", cat="ps")
        # per-table op latencies become scrapeable the moment the server
        # is up; the collector pulls fresh native counters per scrape
        from ...observability import export as _export
        _export.register_collector("ps_server", _stats_collector)
        self.port = port
        self._started = True
        _live.add(self)
        return port

    def stats(self):
        """Per-(table, op) service-side latency totals (see
        :func:`server_op_stats`)."""
        return server_op_stats()

    def run(self):
        """Block until a client sends STOP (reference: run_server), then
        join the service's threads."""
        lib = _native.lib()
        while lib.pt_ps_running():
            time.sleep(0.2)
        self.stop()

    def trace_spans(self, drain=True):
        """Service-side spans recorded for traced requests (see
        :func:`server_trace_spans`)."""
        return server_trace_spans(drain=drain)

    def stop(self):
        if self._started:
            # flush service-side spans into the run-log before the ring
            # dies with the server (evidence must outlive the process's
            # serving phase)
            try:
                drain_trace_to_runlog()
            except Exception:
                pass
            _native.lib().pt_ps_stop()
            self._started = False
            _live.discard(self)


_live = set()


@atexit.register
def _stop_live_servers():
    for srv in list(_live):
        srv.stop()
