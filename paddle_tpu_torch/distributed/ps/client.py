"""PS client: sockets + sharding (counterpart:
``paddle_tpu/distributed/ps/client.py``, whose wire format it keeps byte
for byte, so either package's client talks to either package's server;
the reference framework's `distributed/service/brpc_ps_client.cc` +
`ps_client.h`).

Sparse keys shard across servers by `key % nservers` (reference shards by
key hash, `common_sparse_table.cc` block partition); dense tables live on
`table_id % nservers`. The wire protocol is the length-prefixed binary
format of `_native/src/ps_service.cc`.
"""
import random
import socket
import struct
import threading
import time

import numpy as np

from ...observability import runlog as _runlog
from ...observability import tracing as _obs
from ...testing import faults as _faults
from .retry import RetryPolicy

MAGIC = 0x31535450  # b"PTS1": protocol magic/version (ps_service.cc kMagic)
TRACE_FLAG = 0x80  # op | 0x80: payload prefixed with u64 trace|u64 span

OP_PULL_DENSE = 1
OP_PUSH_DENSE_GRAD = 2
OP_PULL_SPARSE = 3
OP_PUSH_SPARSE_GRAD = 4
OP_PUSH_SPARSE_DELTA = 5
OP_PUSH_DENSE_DELTA = 6
OP_BARRIER = 7
OP_SAVE = 8
OP_LOAD = 9
OP_STOP = 10
OP_SPARSE_SIZE = 11
OP_PULL_DENSE_INIT = 12
# request-id'd push family: payload is `u64 request_id | legacy payload`.
# The server dedups on the id, so a retried push is applied exactly once
# — what makes the push path idempotent and therefore retriable.
OP_PUSH_DENSE_GRAD_ID = 13
OP_PUSH_DENSE_DELTA_ID = 14
OP_PUSH_SPARSE_GRAD_ID = 15
OP_PUSH_SPARSE_DELTA_ID = 16
OP_PULL_SPANS = 17
OP_SPARSE_SPILL_INFO = 27

# the one wire-op -> name map (client spans AND the server's per-table
# latency exporter use it; graph-service ids 20-26 are graph.py's)
_OP_NAMES = {
    OP_PULL_DENSE: "pull_dense", OP_PUSH_DENSE_GRAD: "push_dense_grad",
    OP_PULL_SPARSE: "pull_sparse", OP_PUSH_SPARSE_GRAD: "push_sparse_grad",
    OP_PUSH_SPARSE_DELTA: "push_sparse_delta",
    OP_PUSH_DENSE_DELTA: "push_dense_delta", OP_BARRIER: "barrier",
    OP_SAVE: "save", OP_LOAD: "load", OP_STOP: "stop",
    OP_SPARSE_SIZE: "sparse_size", OP_PULL_DENSE_INIT: "pull_dense_init",
    OP_PUSH_DENSE_GRAD_ID: "push_dense_grad",
    OP_PUSH_DENSE_DELTA_ID: "push_dense_delta",
    OP_PUSH_SPARSE_GRAD_ID: "push_sparse_grad",
    OP_PUSH_SPARSE_DELTA_ID: "push_sparse_delta",
    OP_PULL_SPANS: "pull_spans",
    OP_SPARSE_SPILL_INFO: "sparse_spill_info",
    20: "graph_add_nodes", 21: "graph_add_edges",
    22: "graph_sample_neighbors", 23: "graph_pull_list",
    24: "graph_node_feat", 25: "graph_random_nodes", 26: "graph_size",
}


class PsClient:
    """One client per worker process; thread-safe per-server sockets.

    Failure handling (reference: `brpc_ps_client.cc` retries connects
    under FLAGS_pserver_connect_timeout_ms — and ONLY connects): every
    idempotent call rides ``retry_policy`` — bounded attempts,
    exponential backoff with jitter, and a per-call deadline
    (:class:`~.retry.RetryPolicy`), so a worker survives a server
    restart on any of pull/push/save/load, not just at connect time.
    The push family is idempotent by construction: each push carries a
    u64 request id the server dedups, so a re-sent grad is applied
    exactly once. Only the barrier stays single-shot (re-sending a
    barrier arrival would double-count the worker). Retries are counted
    in ``ps_retry_total``; each attempt passes the ``ps/call``
    kill-point for deterministic fault injection.
    """

    CONNECT_RETRIES = 60
    CONNECT_BACKOFF = 0.25  # seconds between connect attempts (~15s window)

    def __init__(self, endpoints, retry_policy=None, request_id_base=None):
        self.endpoints = list(endpoints)
        self._socks = [None] * len(self.endpoints)
        self._locks = [threading.Lock() for _ in self.endpoints]
        self._sparse_dim = {}
        self._dense_dim = {}
        self.retry_policy = retry_policy or RetryPolicy()
        # request ids: a random 32-bit session tag + a monotonic counter.
        # Unique across client restarts (a restarted worker must not be
        # deduped against its predecessor's ids); request_id_base pins
        # them for deterministic tests.
        if request_id_base is None:
            request_id_base = random.SystemRandom().getrandbits(32) << 31
        self._req_counter = [int(request_id_base)]
        self._req_lock = threading.Lock()

    def _next_request_id(self):
        with self._req_lock:
            self._req_counter[0] += 1
            return self._req_counter[0]

    # -- table metadata (client-side reshape info) ------------------------
    def register_sparse(self, table, dim):
        self._sparse_dim[table] = dim

    def register_dense(self, table, dim):
        self._dense_dim[table] = dim

    @property
    def n_servers(self):
        return len(self.endpoints)

    # -- transport --------------------------------------------------------
    def _sock(self, i):
        if self._socks[i] is None:
            host, port = self.endpoints[i].rsplit(":", 1)
            last = None
            # the whole connect window is bounded by the call deadline: a
            # blackholed host (SYN drop, no RST) must not hold one _sock
            # call for CONNECT_RETRIES x full TCP timeouts
            budget = max(self.retry_policy.deadline_s, 0.1)
            t0 = time.monotonic()
            for _ in range(self.CONNECT_RETRIES):
                try:
                    s = socket.create_connection(
                        (host, int(port)), timeout=min(120.0, budget))
                    break
                except OSError as e:
                    last = e
                    if time.monotonic() - t0 >= budget:
                        raise ConnectionError(
                            f"ps server {self.endpoints[i]} unreachable "
                            f"within the {budget:.1f}s call deadline"
                        ) from last
                    time.sleep(self.CONNECT_BACKOFF)
            else:
                raise ConnectionError(
                    f"ps server {self.endpoints[i]} unreachable after "
                    f"{self.CONNECT_RETRIES} connect attempts") from last
            s.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            self._socks[i] = s
        return self._socks[i]

    def _drop_sock(self, i):
        s, self._socks[i] = self._socks[i], None
        if s is not None:
            try:
                s.close()
            except OSError:
                pass

    def _call(self, server, op, table, n, payload=b"", idempotent=False,
              io_timeout=None):
        if not _obs.enabled("ps"):
            return self._call_impl(server, op, table, n, payload,
                                   idempotent, io_timeout)
        # RPC telemetry: per-op round-trips + payload bytes both ways
        # (the brpc-side latency/qps vars of the reference's PSClient)
        op_name = _OP_NAMES.get(op, str(op))
        t0 = _obs.now_ns()
        with _obs.trace_span(f"ps/{op_name}", cat="ps", table=table,
                             server=server, bytes_out=len(payload)):
            reply = self._call_impl(server, op, table, n, payload,
                                    idempotent, io_timeout)
        _obs.count("ps_client_calls")
        _obs.count(f"ps_client_{op_name}_calls")
        _obs.count("ps_client_bytes_out", len(payload) + 21)  # hdr+frame
        _obs.count("ps_client_bytes_in", len(reply))
        _obs.count("ps_client_rtt_ns", _obs.now_ns() - t0)
        return reply

    def _call_impl(self, server, op, table, n, payload=b"",
                   idempotent=False, io_timeout=None):
        op_name = _OP_NAMES.get(op, str(op))

        def build_msg():
            # trace propagation: with tracing on, each ATTEMPT's span
            # context rides the wire (op | TRACE_FLAG + 16-byte prefix),
            # so the server-side span parents to the exact attempt that
            # reached it — a retried push shows every client attempt and
            # the one (or deduped) server apply under one trace
            ctx = (_obs.trace_context() if _obs.enabled("ps") else None)
            if ctx is not None:
                body = struct.pack("<IBIQ", MAGIC, op | TRACE_FLAG,
                                   table, n) + \
                    struct.pack("<QQ", ctx[0], ctx[1]) + payload
            else:
                body = struct.pack("<IBIQ", MAGIC, op, table, n) + payload
            return struct.pack("<I", len(body)) + body

        # idempotent calls clamp socket I/O to the call deadline (a
        # connected-but-stalled server must not hold the caller past the
        # policy's fail-fast promise); single-shot calls keep the long
        # transport timeout — a barrier legitimately blocks until the
        # slowest worker arrives (first-step compile, data skew) and
        # timing it out at the retry deadline would strand its
        # already-counted arrival. An explicit io_timeout (the
        # barrier(timeout=) deadline) wins over both.
        if io_timeout is None:
            io_timeout = (min(120.0, max(self.retry_policy.deadline_s, 0.1))
                          if idempotent else 120.0)

        def attempt():
            # per-attempt span: the wire context minted inside it makes
            # the server's span a child of THIS attempt, and a failed
            # attempt still leaves its span (with the error name) in the
            # trace — the client half of "client attempt -> server apply"
            with _obs.trace_span(f"ps/attempt/{op_name}", cat="ps",
                                 server=server) as span:
                msg = build_msg()
                # the per-server lock is held per ATTEMPT, not across the
                # whole retry window: backoff sleeps must not serialize
                # other threads' calls behind a failing one (worst case
                # would be N_threads x deadline instead of one each)
                try:
                    with self._locks[server]:
                        _faults.kill_point("ps/call")  # chaos: error/latency
                        s = self._sock(server)
                        try:
                            s.settimeout(io_timeout)
                            s.sendall(msg)
                            hdr = self._recv_exact(s, 4)
                            (rlen,) = struct.unpack("<I", hdr)
                            return self._recv_exact(s, rlen) if rlen else b""
                        except (ConnectionError, OSError):
                            self._drop_sock(server)
                            raise
                except BaseException as e:
                    span.set_attr(error=type(e).__name__)
                    raise

        if not idempotent:
            # single-shot ops: a re-sent barrier arrival would count the
            # worker twice; a re-sent save could interleave two writers
            # on one snapshot file — failure surfaces raw
            try:
                return attempt()
            except (ConnectionError, OSError) as e:
                raise ConnectionError(
                    f"ps server {self.endpoints[server]} lost during "
                    f"non-retriable {op_name!r} (op={op}); the request "
                    "may or may not have taken effect — verify "
                    "server-side state before re-issuing it") from e

        def on_retry(k, delay, exc):
            _obs.count(f"ps_retry_{op_name}", cat="ps")
            _runlog.event("ps_retry", op=op_name,
                          server=self.endpoints[server], attempt=k,
                          delay_s=round(delay, 6),
                          error=type(exc).__name__ if exc else None)
            if _obs.enabled("ps"):
                # the backoff gap becomes a visible span in the trace
                now = _obs.now_ns()
                _obs.profiler.record_span(
                    f"ps/retry_backoff/{op_name}", "ps", now,
                    now + int(delay * 1e9))

        return self.retry_policy.run(
            attempt, on_retry=on_retry,
            what=f"ps {op_name!r} to {self.endpoints[server]}")

    @staticmethod
    def _recv_exact(s, n):
        buf = bytearray()
        while len(buf) < n:
            chunk = s.recv(n - len(buf))
            if not chunk:
                raise ConnectionError("ps server closed connection")
            buf.extend(chunk)
        return bytes(buf)

    # -- dense ------------------------------------------------------------
    def _dense_server(self, table):
        return table % self.n_servers

    def pull_dense(self, table):
        raw = self._call(self._dense_server(table), OP_PULL_DENSE, table, 0,
                         idempotent=True)
        return np.frombuffer(raw, np.float32).copy()

    def pull_dense_init(self, table, init_values):
        """Pull; server adopts `init_values` if the table is untouched
        (worker-0 initialization handoff, reference: communicator init)."""
        payload = np.ascontiguousarray(init_values, np.float32).tobytes()
        raw = self._call(self._dense_server(table), OP_PULL_DENSE_INIT,
                         table, 0, payload, idempotent=True)
        return np.frombuffer(raw, np.float32).copy()

    def push_dense_grad(self, table, grad):
        payload = struct.pack("<Q", self._next_request_id()) + \
            np.ascontiguousarray(grad, np.float32).tobytes()
        self._check_ok(self._call(self._dense_server(table),
                                  OP_PUSH_DENSE_GRAD_ID, table, 0, payload,
                                  idempotent=True),
                       table)

    def push_dense_delta(self, table, delta):
        payload = struct.pack("<Q", self._next_request_id()) + \
            np.ascontiguousarray(delta, np.float32).tobytes()
        self._check_ok(self._call(self._dense_server(table),
                                  OP_PUSH_DENSE_DELTA_ID, table, 0, payload,
                                  idempotent=True),
                       table)

    @staticmethod
    def _check_ok(raw, table):
        if len(raw) != 4 or struct.unpack("<I", raw)[0] != 1:
            raise RuntimeError(
                f"ps server rejected push for table {table} (not "
                f"registered on the server, value size does not match the "
                f"live table, or snapshot load failed?)")

    # -- sparse -----------------------------------------------------------
    def pull_sparse(self, table, keys):
        dim = self._sparse_dim[table]
        keys = np.ascontiguousarray(keys, np.uint64).ravel()
        out = np.empty((keys.size, dim), np.float32)
        for srv, idx in self._shard(keys):
            raw = self._call(srv, OP_PULL_SPARSE, table, idx.size,
                             keys[idx].tobytes(), idempotent=True)
            if len(raw) != idx.size * dim * 4:
                raise RuntimeError(
                    f"sparse table {table} pull returned {len(raw)} bytes, "
                    f"expected {idx.size * dim * 4} — table not registered "
                    f"on server {srv}?")
            out[idx] = np.frombuffer(raw, np.float32).reshape(idx.size, dim)
        return out

    def push_sparse_grad(self, table, keys, grads):
        self._push_sparse(OP_PUSH_SPARSE_GRAD_ID, table, keys, grads)

    def push_sparse_delta(self, table, keys, deltas):
        self._push_sparse(OP_PUSH_SPARSE_DELTA_ID, table, keys, deltas)

    def _push_sparse(self, op, table, keys, vals):
        dim = self._sparse_dim[table]
        keys = np.ascontiguousarray(keys, np.uint64).ravel()
        vals = np.ascontiguousarray(vals, np.float32).reshape(keys.size, dim)
        # merge duplicate ids before pushing (reference: merge_add in
        # communicator.cc MergeVars) — one server-side update per id
        uniq, inv = np.unique(keys, return_inverse=True)
        merged = np.zeros((uniq.size, dim), np.float32)
        np.add.at(merged, inv, vals)
        for srv, idx in self._shard(uniq):
            # one request id per server shard: each shard's push dedups
            # independently (only the lost one is re-applied on retry)
            payload = struct.pack("<Q", self._next_request_id()) + \
                uniq[idx].tobytes() + merged[idx].tobytes()
            self._check_ok(self._call(srv, op, table, idx.size, payload,
                                      idempotent=True),
                           table)

    def _shard(self, keys):
        if self.n_servers == 1:
            yield 0, np.arange(keys.size)
            return
        srv = (keys % np.uint64(self.n_servers)).astype(np.int64)
        for i in range(self.n_servers):
            idx = np.nonzero(srv == i)[0]
            if idx.size:
                yield i, idx

    # -- control ----------------------------------------------------------
    def barrier(self, n_workers, timeout=None):
        """Global worker barrier via server 0 (reference: fetch_barrier).
        ``timeout`` bounds the wait (socket deadline): a worker that
        never arrives surfaces as a ConnectionError here instead of a
        silent 120 s hang — pass one in every multi-process path (the
        ``barrier-without-timeout`` lint rule checks call sites)."""
        self._call(0, OP_BARRIER, 0, n_workers, io_timeout=timeout)

    def save(self, path_prefix):
        # single-shot: a timed-out save retried while the original is
        # still writing would put two writers on one snapshot file. The
        # server writes tmp+rename, so a failed/interrupted save never
        # destroys an existing good snapshot — re-issue explicitly.
        for i in range(self.n_servers):
            raw = self._call(i, OP_SAVE, 0, 0,
                             f"{path_prefix}.{i}".encode())
            if struct.unpack("<I", raw)[0] != 1:
                raise RuntimeError(
                    f"ps server {i} failed to write snapshot "
                    f"{path_prefix}.{i}")

    def load(self, path_prefix):
        for i in range(self.n_servers):
            raw = self._call(i, OP_LOAD, 0, 0,
                             f"{path_prefix}.{i}".encode(), idempotent=True)
            if struct.unpack("<I", raw)[0] != 1:
                raise RuntimeError(
                    f"ps server {i} failed to load snapshot "
                    f"{path_prefix}.{i}")

    def drain_server_spans(self, to_runlog=True, drain=True):
        """Pull service-side trace spans from every server over the wire
        (wire op 17) — the remote-server twin of
        ``server.drain_trace_to_runlog()``: a client of a server in
        ANOTHER process (where the native ring is unreachable) collects
        the service's spans into its own run-log, so a single merge of
        client-side logs reconstructs the full client→server trace.

        Returns the parsed span rows (``name``/``table``/``op``/
        ``trace``/``parent``/``span``/``t0``/``t1``/``dup``/``server``).
        With ``to_runlog`` and an active run-log, rows are also recorded
        tagged ``process="ps_server"`` so ``tools/trace_view.py`` gives
        the service its own track. ``drain=False`` peeks without
        emptying the server's bounded ring.

        Span timestamps are on the SERVER's CLOCK_MONOTONIC base — for a
        same-host server that is also the client profiler's base; spans
        from a server on a different host land unaligned (align via the
        server host's own run-log manifest instead).
        """
        import json as _json

        out = []
        for i in range(self.n_servers):
            # retriable: a re-sent drain after a lost response cannot
            # corrupt state — the lost batch of spans is gone either way
            # (telemetry, not state) and the retry returns what has
            # accumulated since
            raw = self._call(i, OP_PULL_SPANS, 0, 1 if drain else 0,
                             idempotent=True)
            rows = _json.loads(raw.decode()) if raw else []
            for r in rows:
                r["name"] = ("ps_server/"
                             f"{_OP_NAMES.get(r['op'], 'op%d' % r['op'])}")
                r["server"] = self.endpoints[i]
            out.extend(rows)
        if to_runlog and out:
            from ...observability import runlog
            if runlog.active() is not None:
                for r in out:
                    runlog.span(r["name"], "ps", r["t0"], r["t1"],
                                r["trace"], r["span"], r["parent"],
                                attrs={"table": r["table"],
                                       "dup": bool(r["dup"]),
                                       "server": r["server"]},
                                process="ps_server", tid=0)
        return out

    def sparse_spill_info(self, table):
        """Per-server (in_memory_rows, spilled_rows, spill_failures) for
        an out-of-core sparse table (reference: ssd_sparse_table cache
        stats). Non-zero failures mean the disk path is broken and the
        budget is not being enforced."""
        out = []
        for i in range(self.n_servers):
            raw = self._call(i, OP_SPARSE_SPILL_INFO, table, 0,
                             idempotent=True)
            out.append(tuple(int(x)
                             for x in struct.unpack("<QQQ", raw)))
        return out

    def sparse_size(self, table):
        total = 0
        for i in range(self.n_servers):
            raw = self._call(i, OP_SPARSE_SIZE, table, 0, idempotent=True)
            total += struct.unpack("<Q", raw)[0]
        return total

    def stop_servers(self):
        for i in range(self.n_servers):
            try:
                self._call(i, OP_STOP, 0, 0)
            except (ConnectionError, OSError):
                pass

    def close(self):
        for s in self._socks:
            if s is not None:
                s.close()
        self._socks = [None] * len(self.endpoints)
