"""Elastic training manager (counterpart:
``paddle_tpu/distributed/fleet/elastic.py``, the port's own copy;
upstream's ``fleet/elastic.py``: ElasticManager, watch: a node registry,
a fault watch, re-rank and relaunch).

The KV store is pluggable: ``FileKVStore`` (a shared directory) keeps
heartbeat files whose mtime is the lease; ``KVServer``/``TcpKVStore``
serve the same surface over TCP. Membership changes re-rank hosts
deterministically (sorted endpoints) and call the relaunch callback, the
upstream scale-in/scale-out semantics. :meth:`ElasticManager.relaunch`
paces itself through the same
:class:`~paddle_tpu_torch.distributed.restart.RestartPolicy` the pod
supervisor uses (a bounded budget, exponential backoff with jitter).
"""
import json
import os
import socket
import socketserver
import tempfile
import threading
import time

from ..restart import RestartPolicy

__all__ = ["FileKVStore", "TcpKVStore", "KVServer", "start_kv_server",
           "ElasticManager", "ElasticStatus", "RestartPolicy"]


class ElasticStatus:
    COMPLETED = "completed"
    ERROR = "error"
    HOLD = "hold"
    RESTART = "restart"
    EXIT = "exit"


class FileKVStore:
    """etcd-shaped KV on a shared directory (lease = heartbeat mtime)."""

    def __init__(self, root):
        self.root = root
        os.makedirs(root, exist_ok=True)

    def _path(self, key):
        return os.path.join(self.root, key.replace("/", "__"))

    def put(self, key, value):
        tmp = self._path(key) + ".tmp"
        with open(tmp, "w") as f:
            f.write(value)
        os.replace(tmp, self._path(key))

    def refresh(self, key):
        try:
            os.utime(self._path(key))
            return True
        except FileNotFoundError:
            return False

    def get(self, key):
        try:
            with open(self._path(key)) as f:
                return f.read()
        except FileNotFoundError:
            return None

    def delete(self, key):
        try:
            os.remove(self._path(key))
        except FileNotFoundError:
            pass

    def list(self, prefix, ttl=None):
        """Live keys under prefix (mtime within ttl seconds)."""
        pre = prefix.replace("/", "__")
        out = {}
        now = time.time()
        for name in os.listdir(self.root):
            if not name.startswith(pre) or name.endswith(".tmp"):
                continue
            path = os.path.join(self.root, name)
            try:
                if ttl is not None and now - os.path.getmtime(path) > ttl:
                    continue
                with open(path) as f:
                    out[name.replace("__", "/")] = f.read()
            except FileNotFoundError:
                continue
        return out


class KVServer(socketserver.ThreadingTCPServer):
    """Cross-host KV service — the in-framework etcd analog the reference
    points PADDLE_ELASTIC_ETCD_SERVICE_HOST at (`fleet/elastic.py:118`).
    JSON-lines protocol over TCP; leases are refresh timestamps, `list`
    filters by TTL. Run one per job (any host) via start_kv_server()."""

    allow_reuse_address = True
    daemon_threads = True

    def __init__(self, addr=("0.0.0.0", 0)):
        self._kv = {}     # key -> value
        self._t = {}      # key -> last refresh time
        self._mu = threading.Lock()
        super().__init__(addr, _KVHandler)

    def handle_req(self, req):
        op = req.get("op")
        key = req.get("key")
        with self._mu:
            if op == "put":
                self._kv[key] = req.get("value", "")
                self._t[key] = time.time()
                return {"ok": True}
            if op == "refresh":
                if key in self._kv:
                    self._t[key] = time.time()
                    return {"ok": True}
                return {"ok": False}
            if op == "get":
                return {"ok": True, "value": self._kv.get(key)}
            if op == "delete":
                self._kv.pop(key, None)
                self._t.pop(key, None)
                return {"ok": True}
            if op == "list":
                pre = req.get("prefix", "")
                ttl = req.get("ttl")
                now = time.time()
                out = {k: v for k, v in self._kv.items()
                       if k.startswith(pre)
                       and (ttl is None or now - self._t[k] <= ttl)}
                return {"ok": True, "items": out}
        return {"ok": False, "error": f"bad op {op!r}"}


class _KVHandler(socketserver.StreamRequestHandler):
    def handle(self):
        while True:
            line = self.rfile.readline()
            if not line:
                return
            try:
                resp = self.server.handle_req(json.loads(line))
            except Exception as e:  # malformed request: answer, keep serving
                resp = {"ok": False, "error": str(e)}
            self.wfile.write((json.dumps(resp) + "\n").encode())
            self.wfile.flush()


def start_kv_server(port=0, host="0.0.0.0"):
    """Start a KVServer on a daemon thread; returns (server, bound_port)."""
    srv = KVServer((host, port))
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    return srv, srv.server_address[1]


class TcpKVStore:
    """Client for KVServer with the FileKVStore interface — membership
    works across hosts with no shared filesystem."""

    def __init__(self, endpoint):
        if isinstance(endpoint, str):
            host, port = endpoint.rsplit(":", 1)
            endpoint = (host, int(port))
        self.endpoint = endpoint
        self._sock = None
        self._mu = threading.Lock()

    def _call(self, **req):
        # the mutex serializes one connection's request/reply framing (a
        # leaf lock, as pod._Conn's)
        with self._mu:
            try:
                if self._sock is None:
                    self._sock = socket.create_connection(self.endpoint,
                                                          timeout=30)
                    self._f = self._sock.makefile("rwb")
                self._f.write((json.dumps(req) + "\n").encode())
                self._f.flush()
                line = self._f.readline()
                if not line:
                    raise ConnectionError("kv server closed connection")
                return json.loads(line)
            except (OSError, ConnectionError, ValueError):
                # ValueError covers a truncated/garbage JSON reply from a
                # dying server; drop the socket so the next call reconnects
                if self._sock is not None:
                    try:
                        self._sock.close()
                    except OSError:
                        pass
                    self._sock = None
                raise

    def put(self, key, value):
        self._call(op="put", key=key, value=value)

    def refresh(self, key):
        return self._call(op="refresh", key=key)["ok"]

    def get(self, key):
        return self._call(op="get", key=key)["value"]

    def delete(self, key):
        self._call(op="delete", key=key)

    def list(self, prefix, ttl=None):
        return self._call(op="list", prefix=prefix, ttl=ttl)["items"]

    def close(self):
        with self._mu:
            if self._sock is not None:
                self._sock.close()
                self._sock = None


class ElasticManager:
    """Membership + fault watch + re-rank (reference: elastic.py:99).

    env contract (reference :109-136): PADDLE_ELASTIC_NP (target node count),
    PADDLE_ELASTIC_JOB_ID, heartbeat TTL. The store can be a FileKVStore or
    any object with put/refresh/list/delete.
    """

    def __init__(self, endpoint, np=None, job_id=None, store=None,
                 ttl=10, heartbeat_interval=2):
        self.endpoint = endpoint
        self.np = int(np or os.environ.get("PADDLE_ELASTIC_NP", "1"))
        self.job_id = job_id or os.environ.get("PADDLE_ELASTIC_JOB_ID",
                                               "default")
        if store is None:
            # etcd-analog endpoint wins (cross-host); else shared-dir store
            kv_ep = os.environ.get("PADDLE_ELASTIC_KV_ENDPOINT")
            if kv_ep:
                store = TcpKVStore(kv_ep)
            else:
                root = os.environ.get(
                    "PADDLE_ELASTIC_STORE_DIR",
                    os.path.join(tempfile.gettempdir(),
                                 "paddle_tpu_elastic"))
                store = FileKVStore(os.path.join(root, self.job_id))
        self.store = store
        self.ttl = ttl
        self.hb_interval = heartbeat_interval
        self._stop = threading.Event()
        self._hb_thread = None
        # job-scoped keys: one KV endpoint may serve many jobs (the
        # FileKVStore gets the same scoping from its per-job directory)
        self._prefix = f"{self.job_id}/nodes/"
        self._key = self._prefix + self.endpoint

    # -- membership ---------------------------------------------------------
    def register(self):
        self.store.put(self._key, self.endpoint)
        self._hb_thread = threading.Thread(target=self._heartbeat,
                                           daemon=True)
        self._hb_thread.start()

    def _heartbeat(self):
        while not self._stop.wait(self.hb_interval):
            try:
                if not self.store.refresh(self._key):
                    self.store.put(self._key, self.endpoint)
            except (OSError, ConnectionError, ValueError):
                # transient KV failure (TcpKVStore raises, FileKVStore
                # returns False): keep beating — dying here would expire
                # the lease and split-brain the ranks while we still train
                continue

    def live_nodes(self):
        return sorted(self.store.list(self._prefix, ttl=self.ttl).values())

    def rank(self):
        """Deterministic re-rank: position in the sorted live endpoints."""
        nodes = self.live_nodes()
        return nodes.index(self.endpoint) if self.endpoint in nodes else -1

    def ready(self):
        return len(self.live_nodes()) >= self.np

    def wait_ready(self, timeout=60):
        deadline = time.time() + timeout
        while time.time() < deadline:
            if self.ready():
                return True
            time.sleep(0.2)
        return False

    # -- fault watch --------------------------------------------------------
    def watch(self, interval=1.0, on_change=None, max_iter=None,
              baseline=None):
        """Block until membership changes vs `baseline` (default: the
        membership at call time); returns (status, live_nodes).
        reference: elastic.py watch:316."""
        if baseline is None:
            baseline = self.live_nodes()
        i = 0
        while True:
            time.sleep(interval)
            cur = self.live_nodes()
            if cur != baseline:
                status = (ElasticStatus.RESTART if len(cur) >= self.np
                          else ElasticStatus.HOLD)
                if on_change:
                    on_change(status, cur)
                return status, cur
            i += 1
            if max_iter is not None and i >= max_iter:
                return ElasticStatus.COMPLETED, cur

    # -- relaunch (reference: watch -> launcher restart) --------------------
    def relaunch(self, spawn_fn, policy=None, watch_interval=0.5,
                 wait_ready_timeout=60.0):
        """Run the local trainer under the watch→restart loop
        (reference: ``elastic.py watch:316`` feeding the launcher's
        restart): spawn via ``spawn_fn()`` (returns a process-like
        object with ``poll()``/``terminate()``), then RELAUNCH it —
        paced by the shared :class:`RestartPolicy` — whenever the child
        dies abnormally or the live membership changes while the job
        can still reach ``np`` nodes.

        Returns ``(status, proc)``: ``COMPLETED`` (clean child exit
        under stable membership, ``proc`` is the finished handle),
        ``EXIT`` (restart budget exhausted — the KV-relaunch analog of
        the pod supervisor's ``pod_respawn_denied``), or ``HOLD``
        (membership fell below ``np`` and never recovered within
        ``wait_ready_timeout``)."""
        policy = policy if policy is not None else RestartPolicy()
        proc = spawn_fn()
        baseline = self.live_nodes()
        while True:
            time.sleep(watch_interval)
            ret = proc.poll()
            cur = self.live_nodes()
            if ret is None and cur == baseline:
                continue  # healthy child, stable membership
            if ret == 0 and cur == baseline:
                return ElasticStatus.COMPLETED, proc
            # child died abnormally, or membership changed: tear the old
            # child ALL the way down first — the replacement reuses its
            # rendezvous port / KV lease / log files, so spawning while
            # the predecessor still drains would dud the relaunch
            if ret is None:
                proc.terminate()
                deadline = time.time() + 30.0
                while proc.poll() is None and time.time() < deadline:
                    time.sleep(min(watch_interval, 0.1))
            if len(cur) < self.np and not self.wait_ready(
                    timeout=wait_ready_timeout):
                # not enough nodes to relaunch into — a membership dip
                # is not a restart attempt, so the budget is untouched
                return ElasticStatus.HOLD, None
            delay = policy.schedule(self.endpoint)
            if delay is None:
                return ElasticStatus.EXIT, None
            time.sleep(delay)
            proc = spawn_fn()
            baseline = self.live_nodes()

    def exit(self):
        self._stop.set()
        if self._hb_thread:
            self._hb_thread.join(timeout=self.hb_interval + 1)
        self.store.delete(self._key)
