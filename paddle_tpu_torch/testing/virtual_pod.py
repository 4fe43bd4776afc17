"""Virtual pod: N REAL localhost processes under a supervising parent
(counterpart: ``paddle_tpu/testing/virtual_pod.py``, the port's own copy).

Pod semantics — rendezvous, heartbeat failure detection, barrier
timeouts, elastic re-formation (down AND back up), rank-0-committed
multi-process checkpoints — are provable on one machine, against
*actual* process boundaries and *actual* SIGKILLs; the ranks may share
one card (``testing.pod_fixture`` takes its device from the pod's
environment).

The parent is a :class:`~paddle_tpu_torch.distributed.pod.PodSupervisor`
(the production launcher: coordinator hosting, watchdog reaping, fast
failure marking, and — given a ``restart=RestartPolicy(...)`` —
supervised replacement spawning so the pod re-forms UPWARD after a
kill). This subclass adds the chaos tier's determinism:

- **Process-level kill-points** ride the ``PADDLE_TPU_PROCESS_KILL``
  env (``testing.faults``): ``VirtualPod(..., kill=(rank, point, nth))``
  SIGKILLs that rank at the nth hit of the named point —
  deterministic, uncatchable, real.
- **Per-incarnation kill specs**: ``respawn_kills={origin: [(point,
  nth), None, ...]}`` arms the k-th RESPAWN of that origin with its own
  kill spec (``None`` = the replacement runs clean). A replacement
  never inherits the original's kill spec — without this, every
  incarnation would re-kill itself identically and the restart budget
  would just burn down.

Typical test shapes::

    pod = VirtualPod(2, FIXTURE, workdir=tmp, kill=(1, "pod/mid_step", 5))
    exits = pod.run(timeout=180)
    assert exits[1].signal == "SIGKILL" and exits[0].returncode == 0

    # kill -> shrink -> heal -> grow:
    pod = VirtualPod(2, FIXTURE, workdir=tmp,
                     kill=(1, "pod/mid_step", 5),
                     restart=RestartPolicy(max_restarts=2, seed=0))
    exits = pod.run(timeout=240)     # replacement rejoins, world heals
    assert exits[1].returncode == 0  # the LAST incarnation finished
"""
import sys

from ..distributed.pod import PodSupervisor, RankExit, RestartPolicy

__all__ = ["VirtualPod", "RankExit", "RestartPolicy"]


class VirtualPod(PodSupervisor):
    """Launch ``nprocs`` real localhost ranks running ``script`` under a
    parent-hosted pod coordinator, with deterministic kill specs. See
    module docstring."""

    def __init__(self, nprocs, script, *, workdir, script_args=(),
                 env=None, kill=None, respawn_kills=None, lease_ttl=2.0,
                 heartbeat_interval=0.25, barrier_timeout=30.0,
                 watchdog_interval=0.2, started_port=0,
                 devices_per_proc=1, restart=None,
                 straggler_threshold=None):
        self.kills = ([] if kill is None
                      else [kill] if isinstance(kill, tuple) else list(kill))
        self.respawn_kills = {int(o): list(specs)
                              for o, specs in (respawn_kills or {}).items()}
        env = dict(env or {})
        # every rank arms the lock-order watchdog (_lockwatch), so the pod
        # runtime's and the metrics' locks are order-checked under real
        # kills and a violation rides the flight dump. Env-level so
        # module-scope locks are watched too; "0" disarms it.
        env.setdefault("PADDLE_TPU_LOCKWATCH", "1")
        if self.kills:
            env["PADDLE_TPU_PROCESS_KILL"] = ",".join(
                f"{point}@{rank}#{nth}" for rank, point, nth in
                (k if len(k) == 3 else (k[0], k[1], 1) for k in self.kills))
        super().__init__(nprocs, script, workdir=workdir,
                         script_args=script_args, env=env,
                         lease_ttl=lease_ttl,
                         heartbeat_interval=heartbeat_interval,
                         barrier_timeout=barrier_timeout,
                         watchdog_interval=watchdog_interval,
                         devices_per_proc=devices_per_proc,
                         restart=restart,
                         straggler_threshold=straggler_threshold)

    def _respawn_env(self, origin, incarnation):
        """Replacement ranks run CLEAN by default (the original's kill
        spec must not re-kill every incarnation); ``respawn_kills``
        arms the k-th respawn with its own deterministic spec."""
        specs = self.respawn_kills.get(int(origin))
        i = incarnation - 2  # incarnation 2 == first respawn == specs[0]
        spec = specs[i] if specs and i < len(specs) else None
        return {"PADDLE_TPU_PROCESS_KILL":
                "" if spec is None else f"{spec[0]}@{origin}#{spec[1]}"}


def _main():  # pragma: no cover - tiny CLI convenience
    import argparse
    ap = argparse.ArgumentParser(
        prog=f"{sys.executable} -m paddle_tpu_torch.testing.virtual_pod",
        description="run a script as an N-process virtual pod")
    ap.add_argument("--nprocs", type=int, default=2)
    ap.add_argument("--workdir", required=True)
    ap.add_argument("--kill", default=None,
                    help="point@rank[#nth] process kill spec")
    ap.add_argument("--restarts", type=int, default=0,
                    help="respawn budget per origin (0 = never respawn)")
    ap.add_argument("--timeout", type=float, default=300.0)
    ap.add_argument("script")
    ap.add_argument("script_args", nargs="...")
    args = ap.parse_args()
    kill = None
    if args.kill:
        point, _, rest = args.kill.partition("@")
        rank_s, _, nth_s = rest.partition("#")
        kill = (int(rank_s), point, int(nth_s) if nth_s else 1)
    restart = (RestartPolicy(max_restarts=args.restarts)
               if args.restarts > 0 else None)
    pod = VirtualPod(args.nprocs, args.script, workdir=args.workdir,
                     script_args=args.script_args, kill=kill,
                     restart=restart)
    exits = pod.run(timeout=args.timeout)
    for r in sorted(exits):
        print(f"rank {r}: {exits[r]!r}")
    return max(abs(e.returncode or 0) for e in exits.values())


if __name__ == "__main__":  # pragma: no cover
    sys.exit(_main())
