"""Multi-host virtual pod runtime: rendezvous, failure detection, elastic
re-formation (counterpart: ``paddle_tpu/distributed/pod.py``, the port's
own copy; the JSON-lines wire protocol is the reference's byte for byte,
so a port rank rendezvouses with the reference's coordinator and a
reference rank with the port's).

Reference analog: the raw-TCP NCCL ``uniqueId`` exchange of
``gen_comm_id_helper.cc`` plus the launcher watchdog of
``fleet/launch_utils.py watch_local_trainers:565`` — but where the
reference restarts dead trainers from scratch, this runtime makes rank
death a *detected, recoverable* event for the survivors:

- **Rendezvous** (:class:`PodCoordinator` + :meth:`PodRuntime.init`): a
  JSON-lines TCP service (normally hosted by the launcher/supervisor, so
  it outlives any rank — see ``testing/virtual_pod.py``) admits
  ``num_processes`` ranks and hands each the same minted pod ``uid``
  (the uniqueId exchange), the generation number, and the roster.
- **Failure detection**: every rank's heartbeat thread stamps a lease at
  the coordinator; a lease older than ``lease_ttl`` marks the rank
  failed (the *bounded detection window*), and a supervisor that reaps a
  dead child can :meth:`PodCoordinator.mark_failed` it immediately.
  Failures piggyback on heartbeat replies, so every survivor learns of a
  dead peer within one heartbeat interval; blocked barriers/collectives
  fail the instant the mark lands. Surfaced as :class:`RankFailedError`
  naming the dead rank(s).
- **Barrier with timeout** (:meth:`PodRuntime.barrier`): a hung or dead
  rank fails the barrier loudly — :class:`BarrierTimeoutError` lists who
  never arrived — instead of deadlocking the pod.
- **Host collectives** (:meth:`PodRuntime.allreduce`): gather-sum-
  broadcast through the coordinator in float64 with a deterministic
  (rank-sorted) reduction order: the pod's own data-parallel path. Under
  the pod a ``torch.distributed`` group (the reference brings up
  ``jax.distributed``; the keyword stays ``jax_init``) carries the tensor
  traffic when each rank has its own card (NCCL), while the pod carries
  liveness and control; ``jax_init="always"`` brings it up anyway (gloo
  on the host), ``"never"`` never. NCCL refuses two ranks on one card, so
  ranks sharing one card run on the pod's collectives alone.
- **Elastic re-formation** (:meth:`PodRuntime.reform`): after a failure
  the survivors re-form at the smaller world size — dense re-rank, new
  generation, fresh leases — and drive the elastic restore path
  (``checkpoint.multihost``) to continue from the last
  rank-0-committed multi-process checkpoint. The ``torch.distributed``
  group is left as it is, as the reference leaves ``jax.distributed``.
- **Elastic scale-UP** (the heal-and-grow half): the coordinator keeps
  a **lobby** — a join arriving after formation (a supervised
  replacement for a reaped rank, or a net-new rank scaling the job out)
  is parked there *without disturbing the running generation*.
  Survivors learn of parked joiners at window boundaries
  (:meth:`PodRuntime.pending_joiners`) and the next :meth:`reform`
  admits them: the world GROWS — survivors keep their dense re-rank
  (the committer is always an incumbent while any survive), joiners
  append in origin order, generation + 1, fresh leases, stale-gen ops
  still rejected loudly — and every rank (incumbent and replacement
  alike) restores from the latest rank-0-committed pod checkpoint at
  the new dp degree through the elastic re-flattening, so the grown
  world resumes from one consistent step. :class:`PodSupervisor` is the
  production launcher for this loop: it hosts the coordinator, spawns
  the ranks, marks reaped children failed (the fast detection path) and
  **respawns replacements** under a shared
  :class:`~paddle_tpu_torch.distributed.restart.RestartPolicy` (bounded
  budget + exponential backoff with jitter — the same policy object
  ``fleet/elastic.py``'s relaunch path uses).
- **Straggler detection**: the coordinator already timestamps every
  lease; it also keeps per-rank heartbeat-gap histories, exported as
  ``pod_rank_heartbeat_ms{rank=,q=}`` gauges, queryable via
  :meth:`PodCoordinator.stragglers` / :meth:`PodRuntime.stragglers`,
  and edge-triggered ``pod_straggler`` run-log events — a slow-but-
  alive rank becomes visible *before* its lease expires and it becomes
  a failure.

Env contract (:meth:`PodRuntime.from_env`):
``PADDLE_POD_COORDINATOR`` (host:port), ``PADDLE_TRAINERS_NUM``,
``PADDLE_TRAINER_ID``, and the knobs ``PADDLE_POD_LEASE_TTL`` /
``PADDLE_POD_HEARTBEAT_S`` / ``PADDLE_POD_BARRIER_TIMEOUT`` /
``PADDLE_POD_JOIN_TIMEOUT``.
"""
import base64
import collections
import json
import os
import secrets
import socket
import socketserver
import threading
import time

import numpy as np

from .. import _lockwatch as lockwatch
from .parallel_env import _free_port
from .restart import RestartPolicy

__all__ = ["PodRuntime", "PodCoordinator", "PodSupervisor", "RankExit",
           "RestartPolicy", "start_coordinator",
           "PodError", "RankFailedError", "BarrierTimeoutError",
           "StaleGenerationError"]


def _runlog_event(what, **fields):
    """Best-effort run-log event (coordinator AND runtime side)."""
    try:
        from ..observability import runlog
        runlog.event(what, **fields)
    except Exception:
        pass


class PodError(RuntimeError):
    """Base class for pod runtime failures."""


class RankFailedError(PodError):
    """One or more pod ranks died (missed lease / reaped by the
    supervisor). ``ranks`` holds the ORIGIN trainer ids (stable across
    re-formations); ``details`` the per-rank reason strings."""

    def __init__(self, details):
        self.details = list(details)
        self.ranks = sorted({d.get("origin", d.get("rank"))
                             for d in self.details})
        msg = "; ".join(
            f"rank {d.get('origin', d.get('rank'))}: {d.get('reason')}"
            for d in self.details)
        super().__init__(f"pod rank(s) {self.ranks} failed — {msg}")


class BarrierTimeoutError(PodError):
    """A barrier deadline expired before every live rank arrived."""

    def __init__(self, name, waiting, timeout):
        self.name = name
        self.waiting = sorted(waiting)
        super().__init__(
            f"barrier {name!r} timed out after {timeout:.1f}s waiting for "
            f"rank(s) {self.waiting} — a hung rank fails loudly instead "
            "of deadlocking the pod")


class StaleGenerationError(PodError):
    """An op was issued against a generation the pod has re-formed past
    (the caller missed a reform — re-sync before retrying)."""


# -- coordinator (server side) ---------------------------------------------

class PodCoordinator(socketserver.ThreadingTCPServer):
    """The pod's rendezvous + liveness service.

    Normally hosted by the process that SUPERVISES the ranks (the
    launcher, ``testing.virtual_pod.VirtualPod``, or a dedicated
    scheduler sidecar) so that no rank's death takes the coordinator
    with it. All state lives under one condition variable; barrier /
    allreduce / join / reform handlers block their connection thread
    until the op completes, a participant fails, or the deadline passes.
    """

    allow_reuse_address = True
    daemon_threads = True

    def __init__(self, addr=("127.0.0.1", 0), expected=None,
                 lease_ttl=3.0, monitor_interval=None,
                 straggler_threshold=None):
        self.expected = expected
        self.lease_ttl = float(lease_ttl)
        # a rank whose heartbeat gap exceeds this (but not yet the ttl)
        # is a STRAGGLER: visible before it becomes a failure
        self.straggler_threshold = (self.lease_ttl / 2.0
                                    if straggler_threshold is None
                                    else float(straggler_threshold))
        self.uid = secrets.token_hex(16)  # the "uniqueId" every rank gets
        self.gen = 0
        self._members = {}   # rank -> {"origin", "pid", "endpoint"}
        self._leases = {}    # rank -> last heartbeat time
        self._failed = {}    # rank -> {"rank","origin","reason","t"}
        self._failure_log = []
        self._barriers = {}  # (gen, name) -> {"arrived": set, "done": set}
        self._colls = {}     # (gen, name) -> {"parts", "result", "done"}
        self._reforms = {}   # gen -> set(ranks)
        self._reform_result = {}  # old gen -> {"gen", "map"}
        self._lobby = {}     # origin -> joiner info, parked until reform
        self._admitted = {}  # origin -> {"gen","rank","world"} (post-reform)
        self._hb_gaps = {}   # origin -> deque of heartbeat gaps (seconds)
        self._straggling = set()  # origins currently past the threshold
        self._cond = lockwatch.Condition(name="pod.coordinator")
        self._closed = False
        super().__init__(addr, _PodHandler)
        interval = (monitor_interval if monitor_interval is not None
                    else max(0.05, self.lease_ttl / 4.0))
        self._monitor = threading.Thread(
            target=self._monitor_leases, args=(interval,), daemon=True)
        self._monitor.start()

    # -- public (in-process supervisor surface) ----------------------------
    @property
    def endpoint(self):
        host, port = self.server_address[:2]
        return f"{host}:{port}"

    def mark_failed(self, origin, reason):
        """Mark the member with ORIGIN trainer id failed (the supervisor
        fast path: a reaped child is dead *now*, no need to wait out the
        lease). A dead LOBBY joiner is swept out of the lobby instead —
        admitting a corpse at the next reform would hang the grown
        world's first barrier."""
        with self._cond:
            for rank, info in self._members.items():
                if info["origin"] == origin:
                    self._mark_failed_locked(rank, reason)
                    return True
            if origin in self._lobby:
                self._lobby.pop(origin, None)
                self._failure_log.append(
                    {"origin": origin, "reason": reason, "t": time.time(),
                     "member": False, "lobby": True})
                self._cond.notify_all()  # wake its blocked join
                return False
            self._failure_log.append(
                {"origin": origin, "reason": reason, "t": time.time(),
                 "member": False})
        return False

    def state(self):
        with self._cond:
            return {
                "gen": self.gen, "uid": self.uid,
                "members": {r: dict(m) for r, m in self._members.items()},
                "failed": {r: dict(f) for r, f in self._failed.items()},
                "failure_log": list(self._failure_log),
                "lobby": {o: dict(j) for o, j in self._lobby.items()},
                "lease_ttl": self.lease_ttl,
            }

    def heartbeat_stats(self):
        """Per-rank heartbeat-gap stats: ``{origin: {"last_ms", "p50_ms",
        "p95_ms", "max_ms", "n"}}`` over the recent gap history (live
        members only). ``last_ms`` is the CURRENT lease age — the number
        that grows while a rank is wedged."""
        with self._cond:
            now = time.time()
            out = {}
            for rank, info in self._members.items():
                if rank in self._failed:
                    continue
                origin = info["origin"]
                lease = self._leases.get(rank)
                rec = {"n": len(self._hb_gaps.get(origin, ()))}
                if lease is not None:
                    rec["last_ms"] = round((now - lease) * 1e3, 3)
                gaps = sorted(self._hb_gaps.get(origin, ()))
                if gaps:
                    rec["p50_ms"] = round(gaps[len(gaps) // 2] * 1e3, 3)
                    rec["p95_ms"] = round(
                        gaps[min(len(gaps) - 1,
                                 int(round((len(gaps) - 1) * 0.95)))]
                        * 1e3, 3)
                    rec["max_ms"] = round(gaps[-1] * 1e3, 3)
                out[origin] = rec
            return out

    def stragglers(self, threshold=None):
        """Origins of LIVE ranks whose current heartbeat gap exceeds
        ``threshold`` seconds (default: the configured straggler
        threshold) — slow but not yet lease-expired. The early-warning
        query: these ranks are stretching every barrier today and are
        the next lease expiries tomorrow."""
        thr = (self.straggler_threshold if threshold is None
               else float(threshold))
        with self._cond:
            now = time.time()
            out = []
            for rank, info in self._members.items():
                if rank in self._failed:
                    continue
                lease = self._leases.get(rank)
                if lease is not None and now - lease > thr:
                    out.append(info["origin"])
            return sorted(out)

    def close(self):
        self._closed = True
        self.shutdown()
        self.server_close()

    # -- internals ----------------------------------------------------------
    def _mark_failed_locked(self, rank, reason):
        if rank in self._failed:
            return
        rec = {"rank": rank,
               "origin": self._members.get(rank, {}).get("origin", rank),
               "reason": reason, "t": time.time(), "gen": self.gen}
        self._failed[rank] = rec
        self._failure_log.append(dict(rec))
        self._leases.pop(rank, None)
        self._cond.notify_all()

    def _monitor_leases(self, interval):
        while not self._closed:
            time.sleep(interval)
            self._monitor_once(time.time())

    def _monitor_once(self, now):
        """One lease-enforcement + straggler sweep. Lock discipline:
        membership state mutates under the condition, but the straggler
        telemetry (run-log events and gauges — file + registry I/O) is
        emitted AFTER release. Emitting it under the coordinator's one
        condition serialized every join/barrier/heartbeat handler
        behind a disk write per monitor tick — the exact hazard the
        ``blocking-call-under-lock`` rule flags (it did, here)."""
        with self._cond:
            # leases only bind once the pod has FORMED: during
            # rendezvous a joined rank's heartbeat hasn't started
            # (init() returns after join), so join skew longer than
            # the ttl must not falsely kill the early joiners —
            # formation re-stamps every lease (_op_join) and
            # enforcement begins from there
            if self.expected is None \
                    or len(self._members) < self.expected:
                return
            for rank in list(self._members):
                if rank in self._failed:
                    continue
                lease = self._leases.get(rank)
                if lease is not None and now - lease > self.lease_ttl:
                    self._mark_failed_locked(
                        rank, f"lease expired ({now - lease:.2f}s > "
                              f"ttl {self.lease_ttl:.2f}s without a "
                              "heartbeat)")
            snap = self._straggler_snapshot_locked(now)
        self._emit_straggler_telemetry(snap)

    def _straggler_snapshot_locked(self, now):
        """One straggler sweep's STATE half (caller holds the
        condition): update the edge-trigger set, return the plain-data
        snapshot — new stragglers to announce plus per-rank gap series
        — for :meth:`_emit_straggler_telemetry` to publish unlocked."""
        thr = self.straggler_threshold
        gaps_now = {}
        for rank, info in self._members.items():
            if rank in self._failed:
                continue
            lease = self._leases.get(rank)
            if lease is not None:
                gaps_now[info["origin"]] = now - lease
        new_stragglers = []
        for origin, gap in gaps_now.items():
            if gap > thr and gap <= self.lease_ttl \
                    and origin not in self._straggling:
                self._straggling.add(origin)
                new_stragglers.append((origin, gap))
            elif gap <= thr / 2.0 and origin in self._straggling:
                self._straggling.discard(origin)
        series = {}
        for origin, gap in gaps_now.items():
            rec = {"last": gap}
            hist = sorted(self._hb_gaps.get(origin, ()))
            if hist:
                rec["p50"] = hist[len(hist) // 2]
                rec["p95"] = hist[min(len(hist) - 1,
                                      int(round((len(hist) - 1)
                                                * 0.95)))]
            series[origin] = rec
        return {"threshold": thr, "gen": self.gen,
                "new_stragglers": new_stragglers, "series": series}

    def _emit_straggler_telemetry(self, snap):
        """Publish one straggler snapshot: edge-triggered
        ``pod_straggler`` run-log events (re-armed once the rank
        recovers under threshold/2) and per-rank
        ``pod_rank_heartbeat_ms{rank=,q=}`` gauges. Runs with NO
        coordinator lock held; best-effort — a metrics error must never
        take the lease monitor down."""
        try:
            thr = snap["threshold"]
            for origin, gap in snap["new_stragglers"]:
                # 3-decimal precision like heartbeat_stats: the trigger
                # is STRICTLY gap > threshold, and 1-decimal rounding
                # could collapse a 300.04 ms gap onto the 300.0 ms
                # threshold, contradicting the inequality downstream
                _runlog_event("pod_straggler", origin=origin,
                              gap_ms=round(gap * 1e3, 3),
                              threshold_ms=round(thr * 1e3, 3),
                              gen=snap["gen"])
                try:
                    from .. import monitor
                    monitor.stat_add("pod_stragglers_total", 1)
                except Exception:
                    pass
            from ..observability import export
            for origin, rec in snap["series"].items():
                for q, v in rec.items():
                    name = "pod_rank_heartbeat_ms" + export.format_labels(
                        "pod_rank_heartbeat_ms", rank=origin, q=q)
                    export.set_gauge(name, round(v * 1e3, 3))
        except Exception:
            pass

    def _failed_snapshot_locked(self):
        return [dict(f) for f in self._failed.values()]

    # -- request handlers (each runs on its connection's thread) -----------
    def handle_req(self, req):
        op = req.get("op")
        fn = getattr(self, f"_op_{op}", None)
        if fn is None:
            return {"ok": False, "error": "bad_op", "op": op}
        try:
            return fn(req)
        except Exception as e:  # never kill the handler thread
            return {"ok": False, "error": "internal",
                    "detail": f"{type(e).__name__}: {e}"}

    def _op_join(self, req):
        rank = int(req["rank"])
        nprocs = int(req["nprocs"])
        deadline = time.time() + float(req.get("timeout", 60.0))
        with self._cond:
            formed = (self.expected is not None
                      and len(self._members) >= self.expected) \
                or self.gen != 0
            if formed:
                # post-formation join: a replacement (or net-new) rank
                # parks in the LOBBY until the next reform admits it —
                # the running generation is not disturbed, and nprocs
                # is irrelevant (the world may have shrunk since launch)
                # one run-log write per (rare) lobby join; the handler
                # owns the condition for its whole park-and-wait
                return self._lobby_join_locked(int(req.get("origin", rank)),
                                               req, deadline)
            if self.expected is None:
                self.expected = nprocs
            if nprocs != self.expected:
                return {"ok": False, "error": "world_mismatch",
                        "expected": self.expected}
            self._members[rank] = {"origin": int(req.get("origin", rank)),
                                   "pid": req.get("pid"),
                                   "endpoint": req.get("endpoint")}
            self._leases[rank] = time.time()
            if len(self._members) >= self.expected:
                # formation instant: re-stamp EVERY lease so detection
                # windows start now, not at each rank's (skewed) join
                now = time.time()
                for r in self._members:
                    self._leases[r] = now
            self._cond.notify_all()
            while len(self._members) < self.expected:
                if self._failed:
                    return {"ok": False, "error": "rank_failed",
                            "failed": self._failed_snapshot_locked()}
                remaining = deadline - time.time()
                if remaining <= 0:
                    missing = self.expected - len(self._members)
                    return {"ok": False, "error": "join_timeout",
                            "missing": missing}
                self._cond.wait(remaining)
            if self._failed:
                # the roster filled, but a peer was already marked dead
                # (supervisor fast path) — admitting this rank into a
                # half-dead pod would just defer the error to the first
                # barrier
                return {"ok": False, "error": "rank_failed",
                        "failed": self._failed_snapshot_locked()}
            return {"ok": True, "gen": self.gen, "rank": rank,
                    "world": sorted(self._members), "uid": self.uid,
                    "lease_ttl": self.lease_ttl}

    def _lobby_join_locked(self, origin, req, deadline):
        """Park a post-formation joiner until a reform admits it. The
        connection thread blocks here (the joiner's ``init()`` is
        waiting on this reply); admission data lands in ``_admitted``
        when the survivors' next :meth:`reform` grows the world."""
        # a FAILED member no longer owns its origin: it stays in
        # `_members` until the survivors' reform rebuilds the roster,
        # and a fast supervisor respawn can land here before that —
        # the replacement must PARK, not bounce (bouncing would burn a
        # RestartPolicy attempt per incarnation until the budget dies)
        if any(m["origin"] == origin for r, m in self._members.items()
               if r not in self._failed):
            return {"ok": False, "error": "duplicate_origin",
                    "origin": origin,
                    "detail": f"origin {origin} is already a live member "
                              "— a replacement may only join after its "
                              "predecessor was marked failed"}
        self._lobby[origin] = {"origin": origin, "pid": req.get("pid"),
                               "endpoint": req.get("endpoint"),
                               "t": time.time()}
        _runlog_event("pod_lobby_join", origin=origin, gen=self.gen,
                      world=len(self._members))
        self._cond.notify_all()
        while origin not in self._admitted:
            if origin not in self._lobby:
                # swept by mark_failed while parked: the joiner process
                # is dead (or was evicted) — tell whoever is listening
                return {"ok": False, "error": "rank_failed",
                        "failed": [{"origin": origin,
                                    "reason": "removed from lobby before "
                                              "admission"}]}
            remaining = deadline - time.time()
            if remaining <= 0:
                self._lobby.pop(origin, None)
                return {"ok": False, "error": "join_timeout",
                        "lobby": True,
                        "detail": "no reform admitted this joiner within "
                                  "the join timeout — survivors check "
                                  "pending_joiners() at window boundaries"}
            self._cond.wait(min(remaining, 0.25))
        adm = self._admitted.pop(origin)
        return {"ok": True, "gen": adm["gen"], "rank": adm["rank"],
                "world": adm["world"], "uid": self.uid,
                "lease_ttl": self.lease_ttl, "joined": "lobby"}

    def _op_pending_joiners(self, req):
        with self._cond:
            return {"ok": True, "gen": self.gen,
                    "joiners": [dict(self._lobby[o])
                                for o in sorted(self._lobby)]}

    def _op_stragglers(self, req):
        thr = req.get("threshold")
        return {"ok": True,
                "stragglers": self.stragglers(
                    None if thr is None else float(thr))}

    def _op_heartbeat(self, req):
        origin = int(req["origin"])
        with self._cond:
            for rank, info in self._members.items():
                if info["origin"] == origin and rank not in self._failed:
                    now = time.time()
                    prev = self._leases.get(rank)
                    if prev is not None:
                        self._hb_gaps.setdefault(
                            origin, collections.deque(maxlen=128)).append(
                            now - prev)
                    self._leases[rank] = now
                    break
            return {"ok": True, "gen": self.gen,
                    "failed": self._failed_snapshot_locked()}

    def _op_mark_failed(self, req):
        ok = self.mark_failed(int(req["origin"]),
                              req.get("reason", "marked by supervisor"))
        return {"ok": True, "member": ok}

    def _op_leave(self, req):
        rank = int(req["rank"])
        with self._cond:
            self._members.pop(rank, None)
            self._leases.pop(rank, None)
            self._cond.notify_all()
        return {"ok": True}

    def _op_state(self, req):
        return {"ok": True, "state": self.state()}

    def _gen_guard_locked(self, req):
        """None when the request's generation is current, else the error
        reply (stale ops must not deadlock against a re-formed pod)."""
        if int(req.get("gen", -1)) != self.gen:
            return {"ok": False, "error": "stale_gen", "gen": self.gen}
        return None

    def _op_barrier(self, req):
        rank = int(req["rank"])
        name = str(req["name"])
        timeout = float(req.get("timeout", 60.0))
        deadline = time.time() + timeout
        with self._cond:
            stale = self._gen_guard_locked(req)
            if stale:
                return stale
            gen = self.gen
            key = (gen, name)
            b = self._barriers.setdefault(key, {"arrived": set(),
                                                "done": set()})
            b["arrived"].add(rank)
            self._cond.notify_all()
            while True:
                if self.gen != gen:
                    return {"ok": False, "error": "stale_gen",
                            "gen": self.gen}
                if self._failed:
                    return {"ok": False, "error": "rank_failed",
                            "failed": self._failed_snapshot_locked()}
                live = set(self._members)
                if live <= b["arrived"]:
                    b["done"].add(rank)
                    if b["done"] >= live:
                        self._barriers.pop(key, None)
                    return {"ok": True, "gen": gen}
                remaining = deadline - time.time()
                if remaining <= 0:
                    return {"ok": False, "error": "barrier_timeout",
                            "waiting": sorted(
                                self._members[r]["origin"]
                                for r in live - b["arrived"])}
                self._cond.wait(min(remaining, 0.25))

    def _op_allreduce(self, req):
        rank = int(req["rank"])
        name = str(req["name"])
        timeout = float(req.get("timeout", 60.0))
        deadline = time.time() + timeout
        arr = _decode_array(req)
        with self._cond:
            stale = self._gen_guard_locked(req)
            if stale:
                return stale
            gen = self.gen
            key = (gen, name)
            c = self._colls.setdefault(
                key, {"parts": {}, "result": None, "done": set()})
            c["parts"][rank] = arr
            self._cond.notify_all()
            while True:
                if self.gen != gen:
                    return {"ok": False, "error": "stale_gen",
                            "gen": self.gen}
                if self._failed:
                    return {"ok": False, "error": "rank_failed",
                            "failed": self._failed_snapshot_locked()}
                live = set(self._members)
                if c["result"] is None and live <= set(c["parts"]):
                    # deterministic reduction: rank-sorted float64 sum
                    total = None
                    for r in sorted(c["parts"]):
                        if r not in live:
                            continue
                        p = c["parts"][r]
                        total = p.copy() if total is None else total + p
                    c["result"] = total
                    self._cond.notify_all()
                if c["result"] is not None:
                    c["done"].add(rank)
                    result = c["result"]
                    if c["done"] >= live:
                        self._colls.pop(key, None)
                    return {"ok": True, "gen": gen,
                            **_encode_array(result)}
                remaining = deadline - time.time()
                if remaining <= 0:
                    return {"ok": False, "error": "barrier_timeout",
                            "waiting": sorted(
                                self._members[r]["origin"]
                                for r in live - set(c["parts"]))}
                self._cond.wait(min(remaining, 0.25))

    def _op_reform(self, req):
        rank = int(req["rank"])
        timeout = float(req.get("timeout", 60.0))
        deadline = time.time() + timeout
        with self._cond:
            old_gen = int(req.get("gen", self.gen))
            if old_gen != self.gen and old_gen not in self._reform_result:
                return {"ok": False, "error": "stale_gen", "gen": self.gen}
            if old_gen == self.gen:
                if rank in self._failed:
                    return {"ok": False, "error": "rank_failed",
                            "failed": self._failed_snapshot_locked()}
                waiters = self._reforms.setdefault(old_gen, set())
                waiters.add(rank)
                self._cond.notify_all()
                while old_gen not in self._reform_result:
                    survivors = set(self._members) - set(self._failed)
                    if rank in self._failed:
                        return {"ok": False, "error": "rank_failed",
                                "failed": self._failed_snapshot_locked()}
                    if survivors and survivors <= waiters:
                        self._do_reform_locked(old_gen, survivors)
                        break
                    remaining = deadline - time.time()
                    if remaining <= 0:
                        return {"ok": False, "error": "barrier_timeout",
                                "waiting": sorted(
                                    self._members[r]["origin"]
                                    for r in survivors - waiters)}
                    self._cond.wait(min(remaining, 0.25))
            res = self._reform_result[old_gen]
            new_rank = res["map"].get(rank)
            if new_rank is None:
                return {"ok": False, "error": "rank_failed",
                        "failed": self._failed_snapshot_locked()}
            return {"ok": True, "gen": res["gen"], "rank": new_rank,
                    "world": res["world"], "uid": self.uid}

    def _do_reform_locked(self, old_gen, survivors):
        """Re-form around the survivors AND the lobby: dense re-rank of
        the survivors (sorted by old rank — the committer, rank 0, stays
        an incumbent while any survive), lobby joiners appended in
        origin order (the world GROWS when the lobby is non-empty), new
        generation, fresh leases for everyone, failure set cleared (the
        log keeps history). Pending old-gen barriers/collectives wake
        with ``stale_gen``; each admitted joiner's blocked join returns
        with its new rank."""
        mapping = {old: new for new, old in enumerate(sorted(survivors))}
        now = time.time()
        members = {mapping[old]: self._members[old]
                   for old in sorted(survivors)}
        admitted = sorted(self._lobby)
        for origin in admitted:
            rank = len(members)
            info = self._lobby.pop(origin)
            members[rank] = {"origin": origin, "pid": info.get("pid"),
                             "endpoint": info.get("endpoint")}
        self._members = members
        self._leases = {r: now for r in members}
        # the re-formed pod IS fully formed at the new size: track
        # `expected` or the monitor's formation gate would skip lease
        # enforcement forever after the first reform
        self.expected = len(self._members)
        self.gen = old_gen + 1
        world = sorted(members)
        for rank, info in members.items():
            if info["origin"] in admitted:
                self._admitted[info["origin"]] = {
                    "gen": self.gen, "rank": rank, "world": world}
        self._failed = {}
        self._straggling.clear()
        self._barriers.clear()
        self._colls.clear()
        self._reforms.pop(old_gen, None)
        self._reform_result[old_gen] = {
            "gen": self.gen, "map": mapping, "world": world}
        self._cond.notify_all()


class _PodHandler(socketserver.StreamRequestHandler):
    def handle(self):
        while True:
            line = self.rfile.readline()
            if not line:
                return
            try:
                resp = self.server.handle_req(json.loads(line))
            except ValueError as e:
                resp = {"ok": False, "error": "bad_request",
                        "detail": str(e)}
            try:
                self.wfile.write((json.dumps(resp) + "\n").encode())
                self.wfile.flush()
            except OSError:
                return  # client gone mid-reply (killed rank)


def start_coordinator(port=0, host="127.0.0.1", expected=None,
                      lease_ttl=3.0, straggler_threshold=None):
    """Start a :class:`PodCoordinator` on a daemon thread; returns
    ``(coordinator, endpoint)``."""
    coord = PodCoordinator((host, port), expected=expected,
                           lease_ttl=lease_ttl,
                           straggler_threshold=straggler_threshold)
    t = threading.Thread(target=coord.serve_forever, daemon=True)
    t.start()
    return coord, coord.endpoint


# -- wire helpers -----------------------------------------------------------

def _encode_array(arr):
    arr = np.ascontiguousarray(np.asarray(arr, dtype=np.float64))
    return {"dtype": "float64", "shape": list(arr.shape),
            "data": base64.b64encode(arr.tobytes()).decode("ascii")}


def _decode_array(rec):
    raw = base64.b64decode(rec["data"])
    return np.frombuffer(raw, dtype=np.float64).reshape(
        rec["shape"]).copy()


class _Conn:
    """One persistent JSON-lines connection (lock-serialized). The pod
    client holds TWO: the heartbeat thread's and the main thread's —
    a blocking barrier on one must never starve liveness on the other."""

    def __init__(self, endpoint, connect_timeout=10.0):
        host, port = endpoint.rsplit(":", 1)
        self.addr = (host, int(port))
        self.connect_timeout = connect_timeout
        self._sock = None
        self._f = None
        self._mu = lockwatch.Lock(name="pod.conn")

    def call(self, io_timeout, **req):
        # the mutex serializes one connection's request/reply framing;
        # callers hold no other lock across call() (ops and heartbeat use
        # separate connections, so this lock stays a leaf)
        with self._mu:
            try:
                if self._sock is None:
                    self._sock = socket.create_connection(
                        self.addr, timeout=self.connect_timeout)
                    self._f = self._sock.makefile("rwb")
                self._sock.settimeout(io_timeout)
                self._f.write((json.dumps(req) + "\n").encode())
                self._f.flush()
                line = self._f.readline()
                if not line:
                    raise ConnectionError(
                        "pod coordinator closed the connection")
                return json.loads(line)
            except (OSError, ValueError):
                self._drop_locked()
                raise

    def _drop_locked(self):
        if self._sock is not None:
            try:
                self._sock.close()
            except OSError:
                pass
            self._sock = None
            self._f = None

    def close(self):
        with self._mu:
            self._drop_locked()


# -- runtime (client side) --------------------------------------------------

class PodRuntime:
    """One rank's handle on the pod (see module docstring).

    Lifecycle::

        pod = PodRuntime.from_env()      # or explicit args
        pod.init()                       # rendezvous: blocks for the pod
        ...
        pod.barrier("step0", timeout=30)
        g = pod.allreduce(local_grads)   # float64, rank-sorted sum
        ...
        except RankFailedError:
            view = pod.reform(timeout=30)   # survivors re-form smaller
            ...restore from the last pod checkpoint, continue...
        pod.shutdown()
    """

    def __init__(self, coordinator, num_processes, process_id, *,
                 heartbeat_interval=0.5, lease_ttl=None,
                 barrier_timeout=60.0, join_timeout=60.0,
                 jax_init="auto"):
        self.coordinator = coordinator
        self.num_processes = int(num_processes)
        self.origin = int(process_id)
        self.heartbeat_interval = float(heartbeat_interval)
        self.lease_ttl = lease_ttl  # served back by the coordinator
        self.barrier_timeout = float(barrier_timeout)
        self.join_timeout = float(join_timeout)
        self.jax_init = jax_init
        self.uid = None
        self._lock = lockwatch.RLock(name="pod.runtime")
        self._rank = int(process_id)
        self._world = list(range(self.num_processes))
        self._gen = 0
        self._failed = {}      # origin -> failure record
        self._raised = set()   # origins already surfaced via an exception
        self._seq = 0
        self._ops = _Conn(coordinator)
        self._hb_conn = _Conn(coordinator)
        self._hb_stop = threading.Event()
        self._hb_thread = None
        self._initialized = False
        self._group = False  # whether init() brought up torch.distributed

    # -- construction -------------------------------------------------------
    @classmethod
    def from_env(cls, **overrides):
        """Build from the launcher env contract (see module docstring)."""
        coord = os.environ.get("PADDLE_POD_COORDINATOR")
        if not coord:
            raise PodError("PADDLE_POD_COORDINATOR is not set — launch "
                           "through testing.virtual_pod.VirtualPod or "
                           "export the coordinator endpoint")
        kw = dict(
            coordinator=coord,
            num_processes=int(os.environ.get("PADDLE_TRAINERS_NUM", "1")),
            process_id=int(os.environ.get("PADDLE_TRAINER_ID", "0")),
        )
        for env, key, cast in (
                ("PADDLE_POD_HEARTBEAT_S", "heartbeat_interval", float),
                ("PADDLE_POD_BARRIER_TIMEOUT", "barrier_timeout", float),
                # a replacement rank parks in the coordinator's lobby
                # until the survivors' next reform admits it — its join
                # deadline must cover a full training window
                ("PADDLE_POD_JOIN_TIMEOUT", "join_timeout", float),
                # seeds the client's expectation only — the
                # coordinator's configured ttl is authoritative and is
                # served back at join
                ("PADDLE_POD_LEASE_TTL", "lease_ttl", float)):
            raw = os.environ.get(env)
            if raw:
                kw[key] = cast(raw)
        kw.update(overrides)
        return cls(**kw)

    # -- introspection -------------------------------------------------------
    @property
    def rank(self):
        return self._rank

    @property
    def world_size(self):
        return len(self._world)

    @property
    def gen(self):
        return self._gen

    def shard_range(self, n):
        """This rank's contiguous ``[lo, hi)`` slice of ``n`` items under
        the CURRENT world size (re-shards automatically after a
        reform)."""
        w, r = self.world_size, self._rank
        base, rem = divmod(int(n), w)
        lo = r * base + min(r, rem)
        return lo, lo + base + (1 if r < rem else 0)

    def failed_ranks(self):
        """Origin ids of every rank known dead in the current
        generation."""
        with self._lock:
            return sorted(self._failed)

    # -- lifecycle -----------------------------------------------------------
    def init(self):
        """Rendezvous: join the pod (the uniqueId exchange), start the
        heartbeat lease, optionally bring up a ``torch.distributed`` group
        (``jax_init``)."""
        resp = self._call(self.join_timeout + 5.0, op="join",
                          rank=self.origin, origin=self.origin,
                          nprocs=self.num_processes, pid=os.getpid(),
                          timeout=self.join_timeout)
        if not resp.get("ok"):
            self._collective_reply(resp, "join", self.join_timeout)
        self.uid = resp["uid"]
        self.lease_ttl = resp.get("lease_ttl", self.lease_ttl)
        with self._lock:
            self._gen = resp["gen"]
            self._rank = resp["rank"]
            self._world = list(resp["world"])
        self._hb_thread = threading.Thread(target=self._heartbeat_loop,
                                           daemon=True)
        self._hb_thread.start()
        self._maybe_init_group()
        self._initialized = True
        _runlog_event("pod_join", rank=self._rank,
                      world=self.world_size, gen=self._gen,
                      uid=self.uid,
                      via=resp.get("joined", "rendezvous"))
        return self

    def _maybe_init_group(self):
        """Layer a ``torch.distributed`` group under the pod (the
        reference's ``jax.distributed.initialize``). ``jax_init``:
        ``"auto"`` when each rank has its own card (NCCL; NCCL refuses two
        ranks on one card, so ranks sharing one run without), ``"always"``
        (NCCL on cards, else gloo on the host) or ``"never"``."""
        if self.jax_init == "never" or self.num_processes < 2:
            return
        import torch
        own_card = (torch.cuda.is_available()
                    and torch.cuda.device_count() >= self.num_processes)
        if self.jax_init == "auto" and not own_card:
            return
        addr = os.environ.get("MASTER_ADDR")
        port = os.environ.get("MASTER_PORT")
        if not addr or not port:
            # the pod coordinator's endpoint is no fallback: that port
            # serves the JSON-lines protocol, which torch's store cannot
            # speak
            raise PodError(
                "a torch.distributed group under the pod needs MASTER_ADDR "
                "and MASTER_PORT (a port distinct from the pod "
                "coordinator's); launch through distributed.launch / "
                "testing.virtual_pod, which export them, or set "
                "jax_init='never'")
        import torch.distributed as dist
        kwargs = {}
        if own_card:
            dev = torch.device("cuda", self.origin)
            torch.cuda.set_device(dev)
            kwargs["device_id"] = dev
        dist.init_process_group(
            "nccl" if own_card else "gloo",
            init_method=f"tcp://{addr}:{port}",
            world_size=self.num_processes, rank=self.origin, **kwargs)
        self._group = True

    def shutdown(self):
        """Leave the pod cleanly (no failure mark) and stop the
        heartbeat."""
        self._hb_stop.set()
        if self._hb_thread is not None:
            self._hb_thread.join(timeout=self.heartbeat_interval + 1.0)
        if self._initialized:
            try:
                self._call(5.0, op="leave", rank=self._rank,
                           gen=self._gen)
            except PodError:
                # _call wraps transport errors into PodError; a clean
                # shutdown must not die (and read as a rank failure to
                # the watchdog) just because the coordinator is already
                # gone in a teardown race
                pass
        if self._group:
            try:
                import torch.distributed as dist
                dist.destroy_process_group()
            except Exception:
                pass
            self._group = False
        self._ops.close()
        self._hb_conn.close()
        self._initialized = False

    # -- liveness ------------------------------------------------------------
    def _heartbeat_loop(self):
        while not self._hb_stop.wait(self.heartbeat_interval):
            try:
                resp = self._hb_conn.call(
                    max(5.0, self.heartbeat_interval * 4), op="heartbeat",
                    origin=self.origin)
            except (OSError, ConnectionError, ValueError):
                # transient coordinator loss: keep beating — the lease
                # only expires after ttl, and dying here would turn a
                # network blip into a false rank death
                continue
            self._absorb_failures(resp.get("failed") or ())

    def _absorb_failures(self, failed):
        with self._lock:
            for rec in failed:
                self._failed.setdefault(rec.get("origin"), rec)

    def check_failures(self):
        """Raise :class:`RankFailedError` for failures not yet surfaced
        to the caller (each dead rank is raised once; a recovery path
        that caught it won't see it again)."""
        with self._lock:
            fresh = [rec for o, rec in sorted(self._failed.items())
                     if o not in self._raised]
            if not fresh:
                return
            self._raised.update(rec.get("origin") for rec in fresh)
        exc = RankFailedError(fresh)
        self._flight_dump_failure(exc, op="check_failures")
        raise exc

    def _flight_dump_failure(self, exc, **fields):
        """Pod failure forensics: an atomic flight dump
        (``reason="pod_failure"``, absent/origin ranks in the payload)
        BEFORE any reform — the post-mortem exists even when the
        survivor recovers and keeps running. Best-effort: never masks
        the failure being raised."""
        try:
            from ..observability import flight
            if not flight.installed():
                return
            payload = {"gen": self._gen, "rank": self._rank,
                       "origin": self.origin,
                       "world_size": self.world_size, **fields}
            if isinstance(exc, RankFailedError):
                payload["failed_ranks"] = exc.ranks
            if isinstance(exc, BarrierTimeoutError):
                payload["absent_ranks"] = exc.waiting
            flight.dump("pod_failure", exc=exc,
                        extra={"pod_failure": payload})
        except Exception:
            pass

    # -- collectives ---------------------------------------------------------
    def _call(self, io_timeout, **req):
        try:
            return self._ops.call(io_timeout, **req)
        except socket.timeout as e:
            raise BarrierTimeoutError(
                req.get("name", req.get("op")), ["<coordinator>"],
                io_timeout) from e
        except (OSError, ConnectionError, ValueError) as e:
            raise PodError(
                f"pod coordinator {self.coordinator} unreachable during "
                f"{req.get('op')!r}: {type(e).__name__}: {e}") from e

    def _collective_reply(self, resp, name, timeout):
        if resp.get("ok"):
            return resp
        err = resp.get("error")
        if err == "rank_failed":
            self._absorb_failures(resp.get("failed") or ())
            with self._lock:
                for rec in resp.get("failed") or ():
                    self._raised.add(rec.get("origin"))
            exc = RankFailedError(resp.get("failed") or
                                  [{"origin": None, "reason": "unknown"}])
            self._flight_dump_failure(exc, op=name)
            raise exc
        if err == "barrier_timeout":
            exc = BarrierTimeoutError(name, resp.get("waiting", ()),
                                      timeout)
            self._flight_dump_failure(exc, op=name)
            raise exc
        if err == "stale_gen":
            raise StaleGenerationError(
                f"op {name!r} used generation {self._gen}, pod is at "
                f"{resp.get('gen')} — re-sync (reform) before retrying")
        raise PodError(f"pod op {name!r} failed: {resp}")

    def barrier(self, name, timeout=None):
        """Block until every live rank arrives at ``name`` — or fail
        loudly: :class:`RankFailedError` when a member died,
        :class:`BarrierTimeoutError` (naming who is absent) at the
        deadline. There is deliberately no infinite-wait mode."""
        timeout = self.barrier_timeout if timeout is None else float(timeout)
        resp = self._call(timeout + 15.0, op="barrier", rank=self._rank,
                          gen=self._gen, name=str(name), timeout=timeout)
        self._collective_reply(resp, str(name), timeout)

    def allreduce(self, value, name=None, timeout=None):
        """Sum ``value`` (any array-like; float64 on the wire, reduction
        rank-sorted so every world size reduces in one deterministic
        order) across all live ranks. All ranks must issue collectives
        in the same order; ``name`` overrides the auto sequence id."""
        timeout = self.barrier_timeout if timeout is None else float(timeout)
        arr = np.asarray(value, dtype=np.float64)
        with self._lock:
            if name is None:
                name = f"ar{self._seq}"
                self._seq += 1
        resp = self._call(timeout + 15.0, op="allreduce", rank=self._rank,
                          gen=self._gen, name=str(name), timeout=timeout,
                          **_encode_array(arr))
        self._collective_reply(resp, str(name), timeout)
        return _decode_array(resp)

    def allreduce_mean(self, value, name=None, timeout=None):
        return self.allreduce(value, name=name,
                              timeout=timeout) / self.world_size

    # -- elastic re-formation ------------------------------------------------
    def pending_joiners(self):
        """Origins parked in the coordinator's lobby — replacement or
        net-new ranks waiting for the next :meth:`reform` to admit
        them. Poll at window boundaries; when non-empty (agree across
        ranks first — e.g. allreduce the count — so every survivor
        reforms together), checkpoint and :meth:`reform` to grow the
        world back."""
        resp = self._call(10.0, op="pending_joiners", gen=self._gen)
        if not resp.get("ok"):
            return []
        return sorted(int(j["origin"]) for j in resp.get("joiners", ()))

    def stragglers(self, threshold=None):
        """Origins of live ranks whose current heartbeat gap exceeds
        ``threshold`` seconds (default: the coordinator's configured
        straggler threshold, lease_ttl/2) — slow-but-alive ranks,
        visible before they become failures."""
        resp = self._call(10.0, op="stragglers", gen=self._gen,
                          threshold=threshold)
        if not resp.get("ok"):
            return []
        return [int(o) for o in resp.get("stragglers", ())]

    def reform(self, timeout=None):
        """Re-form the pod: survivors re-rank densely and every lobby
        joiner is admitted — the world SHRINKS after a failure, GROWS
        when replacements (or net-new ranks) are waiting, generation + 1
        either way, failure set cleared. Returns ``{"gen", "rank",
        "world_size"}``. Every survivor must call this (it is itself a
        barrier among the living); after it, restore from the latest
        pod checkpoint so the new world resumes from one consistent
        step."""
        timeout = self.barrier_timeout if timeout is None else float(timeout)
        t0 = time.time()
        old_world = self.world_size
        resp = self._call(timeout + 15.0, op="reform", rank=self._rank,
                          gen=self._gen, timeout=timeout)
        self._collective_reply(resp, "reform", timeout)
        with self._lock:
            self._gen = resp["gen"]
            self._rank = resp["rank"]
            self._world = list(resp["world"])
            self._failed = {}
            self._raised = set()
            self._seq = 0
        direction = ("grow" if self.world_size > old_world
                     else "shrink" if self.world_size < old_world
                     else "steady")
        _runlog_event("pod_reform", rank=self._rank,
                      world=self.world_size, gen=self._gen,
                      direction=direction, old_world=old_world,
                      new_world=self.world_size,
                      took_s=round(time.time() - t0, 3))
        return {"gen": self._gen, "rank": self._rank,
                "world_size": self.world_size}


# -- supervisor (the production launcher side) ------------------------------

class RankExit:
    """One rank process's terminal state as the supervisor observed it.
    ``incarnation`` counts spawns of this origin (1 = the original
    process, 2+ = supervised replacements)."""

    def __init__(self, rank, returncode, t_reaped, incarnation=1):
        self.rank = rank
        self.returncode = returncode
        self.t_reaped = t_reaped
        self.incarnation = incarnation

    @property
    def signal(self):
        """Signal name when the rank died by signal, else None."""
        from .launch import signal_name
        return signal_name(self.returncode)

    def __repr__(self):
        return (f"RankExit(rank={self.rank}, returncode={self.returncode}"
                + (f", signal={self.signal}" if self.signal else "")
                + (f", incarnation={self.incarnation}"
                   if self.incarnation != 1 else "") + ")")


class PodSupervisor:
    """Launch AND heal a pod of local rank processes.

    The production-facing wrapper over the coordinator (the reference's
    launcher watchdog, ``launch_utils.py watch_local_trainers:565``, but
    where the reference restarts the WHOLE job this supervisor replaces
    one rank at a time): it hosts the :class:`PodCoordinator` (so no
    rank's death takes rendezvous down), spawns one POSIX process per
    rank through ``launch.spawn_trainer`` (env contract + per-rank
    run-log/flight dirs), and its watchdog

    - **reaps** exited children and marks signal/error deaths failed at
      the coordinator immediately (the fast detection path — the lease
      TTL bounds detection even with no supervisor);
    - **respawns** a replacement process for each reaped rank when a
      :class:`~paddle_tpu_torch.distributed.restart.RestartPolicy` is supplied
      (``restart=``): the policy's exponential backoff paces the
      relaunch and its bounded budget stops a crash-looping rank from
      burning the machine. The replacement joins the coordinator's
      LOBBY; the survivors' next :meth:`PodRuntime.reform` admits it and
      the pod grows back to full world — the kill→shrink→heal→grow
      lifecycle.

    ``testing.virtual_pod.VirtualPod`` subclasses this with
    deterministic process kill-points for the chaos tier.
    ``devices_per_proc`` is kept for the reference's signature (an XLA
    host-device count there); a port rank takes its device from its own
    arguments.
    """

    def __init__(self, nprocs, script, *, workdir, script_args=(),
                 env=None, lease_ttl=3.0, heartbeat_interval=0.5,
                 barrier_timeout=60.0, watchdog_interval=0.2,
                 devices_per_proc=1, restart=None,
                 straggler_threshold=None):
        self.nprocs = int(nprocs)
        self.script = str(script)
        self.script_args = list(script_args)
        self.workdir = str(workdir)
        self.extra_env = dict(env or {})
        self.lease_ttl = float(lease_ttl)
        self.heartbeat_interval = float(heartbeat_interval)
        self.barrier_timeout = float(barrier_timeout)
        self.watchdog_interval = float(watchdog_interval)
        self.devices_per_proc = int(devices_per_proc)
        self.restart = restart  # RestartPolicy; None = never respawn
        self.straggler_threshold = straggler_threshold
        self.log_dir = os.path.join(self.workdir, "logs")
        self.runlog_dir = os.path.join(self.workdir, "runlogs")
        self.flight_dir = os.path.join(self.workdir, "flight")
        self.coordinator = None
        self.exits = {}            # origin -> LATEST RankExit
        self.exit_history = []     # every reap, in order
        self.respawns_denied = []  # origins whose restart budget ran out
        self._procs = []
        self._cluster = None
        self._base_envs = {}
        self._incarnation = {}     # origin -> spawn count (1 = original)
        self._pending_respawn = {}  # origin -> earliest respawn time
        self._closing = False      # terminate() in progress: no respawns

    # -- lifecycle -----------------------------------------------------------
    def start(self):
        from . import launch
        for d in (self.log_dir, self.runlog_dir, self.flight_dir):
            os.makedirs(d, exist_ok=True)
        self.coordinator, endpoint = start_coordinator(
            expected=self.nprocs, lease_ttl=self.lease_ttl,
            straggler_threshold=self.straggler_threshold)
        # the trainer endpoints; the first is the torch.distributed
        # rendezvous (MASTER_ADDR/MASTER_PORT) of a group under the pod
        base = _free_port()
        eps = [f"127.0.0.1:{base + i}" for i in range(self.nprocs)]
        self._cluster = launch.get_cluster(["127.0.0.1"], "127.0.0.1",
                                           eps, self.nprocs)
        self._base_envs = {
            "PADDLE_POD_COORDINATOR": endpoint,
            "PADDLE_POD_HEARTBEAT_S": str(self.heartbeat_interval),
            "PADDLE_POD_BARRIER_TIMEOUT": str(self.barrier_timeout),
            "PADDLE_TPU_RUNLOG_DIR": self.runlog_dir,
            "PADDLE_TPU_FLIGHT_DIR": self.flight_dir,
            "PYTHONPATH": _repo_root() + os.pathsep
                          + os.environ.get("PYTHONPATH", ""),
        }
        self._base_envs.update(self.extra_env)
        for t in self._cluster.pods[0].trainers:
            self._spawn_rank(t.rank, incarnation=1)
        return self

    # -- respawn -------------------------------------------------------------
    def _respawn_env(self, origin, incarnation):
        """Env OVERRIDES for a respawned rank (subclass hook — the
        virtual pod arms per-incarnation kill specs through it)."""
        return {}

    def _spawn_rank(self, origin, incarnation):
        from . import launch
        trainer = next(t for t in self._cluster.pods[0].trainers
                       if t.rank == origin)
        envs = dict(self._base_envs)
        if incarnation > 1:
            envs["PADDLE_TPU_POD_INCARNATION"] = str(incarnation)
            envs.update(self._respawn_env(origin, incarnation))
        tp = launch.spawn_trainer(
            self._cluster, trainer, self.script, self.script_args,
            log_dir=self.log_dir, envs=envs,
            log_mode="w" if incarnation == 1 else "a")
        tp.incarnation = incarnation
        tp.reaped = False
        self._incarnation[origin] = incarnation
        self._procs.append(tp)
        if incarnation > 1:
            try:
                from .. import monitor
                monitor.stat_add("pod_respawns_total", 1)
            except Exception:
                pass
            _runlog_event("pod_respawn", origin=origin,
                          incarnation=incarnation)
        return tp

    def _schedule_respawn(self, origin, reason):
        if self.restart is None or self._closing:
            # a deliberate terminate() reaps children with nonzero exit
            # codes — those are not crashes and must neither burn the
            # restart budget nor log denied respawns
            return
        delay = self.restart.schedule(origin)
        if delay is None:
            # bounded budget: a crash-looping rank stays down and the
            # pod runs degraded instead of thrashing
            self.respawns_denied.append(origin)
            _runlog_event("pod_respawn_denied", origin=origin,
                          reason=reason)
            return
        self._pending_respawn[origin] = time.time() + delay

    def _spawn_due_respawns(self, alive):
        now = time.time()
        for origin, not_before in list(self._pending_respawn.items()):
            if not alive:
                # no survivor is left to reform the replacement into —
                # whole-pod restart is the elastic relaunch path's job
                del self._pending_respawn[origin]
                self.respawns_denied.append(origin)
                continue
            if now < not_before:
                continue  # the policy's backoff delay is still running
            del self._pending_respawn[origin]
            self._spawn_rank(origin, self._incarnation.get(origin, 1) + 1)

    # -- watchdog ------------------------------------------------------------
    def watch_once(self):
        """One watchdog pass: reap exited children, mark signal/error
        deaths failed at the coordinator (the fast detection path),
        schedule replacements through the restart policy, and spawn any
        respawn whose backoff elapsed. Returns the ranks still alive."""
        alive = []
        for tp in self._procs:
            if getattr(tp, "reaped", False):
                continue
            ret = tp.proc.poll()
            if ret is None:
                alive.append(tp.rank)
                continue
            tp.reaped = True
            ex = RankExit(tp.rank, ret, time.time(),
                          incarnation=getattr(tp, "incarnation", 1))
            self.exits[tp.rank] = ex
            self.exit_history.append(ex)
            if tp.log_f:
                tp.log_f.close()
                tp.log_f = None
            if ret != 0:
                reason = (f"killed by {ex.signal}" if ex.signal
                          else f"exited with code {ret}")
                self.coordinator.mark_failed(tp.rank, reason)
                self._schedule_respawn(tp.rank, reason)
        self._spawn_due_respawns(alive)
        return alive

    def wait(self, timeout=180.0):
        """Watchdog loop until every rank exits and no respawn is
        pending (or ``timeout``: the stragglers are terminated with a
        grace period and a TimeoutError raises). Returns
        ``{origin: latest RankExit}`` (``exit_history`` holds every
        incarnation's exit)."""
        deadline = time.time() + float(timeout)
        while True:
            alive = self.watch_once()
            if not alive and not self._pending_respawn:
                return dict(self.exits)
            if time.time() > deadline:
                self.terminate()
                raise TimeoutError(
                    f"pod rank(s) {alive} still alive after "
                    f"{timeout:.0f}s; terminated. Logs under "
                    f"{self.log_dir}: " + self.tail_logs())
            time.sleep(self.watchdog_interval)

    def run(self, timeout=180.0):
        """``start()`` + ``wait()`` + coordinator shutdown."""
        self.start()
        try:
            return self.wait(timeout=timeout)
        finally:
            self.close()

    def kill_rank(self, rank, sig=None):
        """Externally kill a rank's CURRENT process (the preemption
        story — vs the deterministic in-process kill-points)."""
        import signal as _signal
        sig = _signal.SIGKILL if sig is None else sig
        for tp in self._procs:
            if tp.rank == rank and not getattr(tp, "reaped", False) \
                    and tp.proc.poll() is None:
                tp.proc.send_signal(sig)
                return True
        return False

    def terminate(self, grace_s=5.0):
        from . import launch
        self._closing = True
        self._pending_respawn.clear()
        launch.terminate_local_procs(self._procs, grace_s=grace_s)
        self.watch_once()

    def close(self):
        if self.coordinator is not None:
            self.coordinator.close()
            self.coordinator = None

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        try:
            self.terminate()
        finally:
            self.close()
        return False

    # -- evidence ------------------------------------------------------------
    def log(self, rank):
        """A rank's captured stdout+stderr (``workerlog.<rank>``;
        respawned incarnations APPEND to their rank's log)."""
        try:
            with open(os.path.join(self.log_dir,
                                   f"workerlog.{rank}")) as f:
                return f.read()
        except OSError:
            return ""

    def tail_logs(self, n=2000):
        out = []
        for r in range(self.nprocs):
            text = self.log(r)
            if text:
                out.append(f"--- workerlog.{r} ---\n{text[-n:]}")
        return "\n".join(out)

    def runlog_paths(self):
        """Every per-rank run-log JSONL written so far — including a
        killed rank's (its log ends at the kill, which is the point)."""
        try:
            return sorted(
                os.path.join(self.runlog_dir, f)
                for f in os.listdir(self.runlog_dir)
                if f.endswith(".jsonl"))
        except OSError:
            return []


def _repo_root():
    return os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
