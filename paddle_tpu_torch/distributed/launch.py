"""Multi-process launcher, ``python -m paddle_tpu_torch.distributed.launch``
(counterpart: ``paddle_tpu/distributed/launch.py``; upstream's
``fleet/launch_utils.py``: Cluster, Pod, start_local_trainers,
watch_local_trainers).

Each trainer gets the reference's environment contract
(``PADDLE_TRAINER_ID``, ``PADDLE_TRAINER_ENDPOINTS``,
``PADDLE_CURRENT_ENDPOINT``, ``PADDLE_TRAINERS_NUM``). Where the reference
derives jax's coordination-service address from the first endpoint, the
port derives ``MASTER_ADDR``/``MASTER_PORT`` for ``torch.distributed``
(``distributed.init_parallel_env`` rendezvouses at the first endpoint).
``--nproc_per_node`` defaults to 1: one process a card.
"""
import os
import signal
import subprocess
import sys
import time

__all__ = ["Cluster", "Pod", "Trainer", "get_cluster", "spawn_trainer",
           "start_local_trainers", "watch_local_trainers", "main"]


class Trainer:
    def __init__(self, rank, endpoint, gpus=()):
        self.rank = rank
        self.endpoint = endpoint
        self.accelerators = list(gpus)

    def __repr__(self):
        return f"Trainer(rank={self.rank}, endpoint={self.endpoint})"


class Pod:
    """One node's worth of trainers (reference: launch_utils.py Pod:173)."""

    def __init__(self, addr="127.0.0.1"):
        self.addr = addr
        self.trainers = []

    def rank_of(self, trainer):
        return trainer.rank


class Cluster:
    """All pods (reference: launch_utils.py Cluster:59)."""

    def __init__(self, pods=None):
        self.pods = pods or []

    def trainers_endpoints(self):
        return [t.endpoint for p in self.pods for t in p.trainers]

    def trainers_nranks(self):
        return len(self.trainers_endpoints())

    def world_device_ids(self):
        return [t.accelerators for p in self.pods for t in p.trainers]


def get_cluster(node_ips, node_ip, trainer_endpoints, nproc_per_node):
    cluster = Cluster()
    rank = 0
    for ip in node_ips:
        pod = Pod(ip)
        for _ in range(nproc_per_node):
            pod.trainers.append(Trainer(rank, trainer_endpoints[rank]))
            rank += 1
        cluster.pods.append(pod)
    return cluster


class TrainerProc:
    def __init__(self, proc, rank, log_f=None):
        self.proc = proc
        self.rank = rank
        self.log_f = log_f


def spawn_trainer(cluster, trainer, training_script, training_script_args,
                  log_dir=None, envs=None, log_mode="w"):
    """Spawn ONE trainer process with the cluster env contract —
    ``start_local_trainers``' per-trainer body, exposed so a supervisor
    (``distributed.pod.PodSupervisor``) can relaunch a single
    REPLACEMENT rank without re-spawning the pod. ``log_mode="a"``
    appends to the rank's existing ``workerlog.<rank>`` so an origin's
    incarnations share one log."""
    endpoints = cluster.trainers_endpoints()
    env = dict(os.environ)
    env.update(envs or {})
    env.update({
        "PADDLE_TRAINER_ID": str(trainer.rank),
        "PADDLE_CURRENT_ENDPOINT": trainer.endpoint,
        "PADDLE_TRAINERS_NUM": str(cluster.trainers_nranks()),
        "PADDLE_TRAINER_ENDPOINTS": ",".join(endpoints),
        # the torch.distributed rendezvous (the first endpoint)
        "MASTER_ADDR": endpoints[0].rsplit(":", 1)[0],
        "MASTER_PORT": endpoints[0].rsplit(":", 1)[1],
        "TORCH_SHOW_CPP_STACKTRACES": "1",
    })
    cmd = [sys.executable, "-u", training_script] + \
        list(training_script_args)
    log_f = None
    if log_dir:
        os.makedirs(log_dir, exist_ok=True)
        log_f = open(os.path.join(log_dir, f"workerlog.{trainer.rank}"),
                     log_mode)
    proc = subprocess.Popen(cmd, env=env, stdout=log_f or None,
                            stderr=subprocess.STDOUT if log_f else None)
    return TrainerProc(proc, trainer.rank, log_f)


def start_local_trainers(cluster, pod, training_script, training_script_args,
                         log_dir=None, envs=None):
    """Spawn one POSIX process per local trainer with the env contract
    (reference: launch_utils.py start_local_trainers:453)."""
    return [spawn_trainer(cluster, t, training_script,
                          training_script_args, log_dir=log_dir, envs=envs)
            for t in pod.trainers]


def signal_name(exitcode):
    """Signal name for a by-signal child exit (``exitcode < 0``), else
    None (spawn's join and the virtual pod's ``RankExit`` use it)."""
    if exitcode is None or exitcode >= 0:
        return None
    try:
        return signal.Signals(-exitcode).name
    except ValueError:
        return f"signal {-exitcode}"


def _death_desc(ret):
    """Human description of a child exit code — names the signal for a
    signal death so a SIGKILLed (OOM-killed, preempted) trainer reads
    differently from a traceback exit."""
    sig = signal_name(ret)
    if sig is not None:
        return f"died by signal {sig}"
    return f"failed with exit code {ret}"


def watch_local_trainers(procs, nranks=None, grace_s=5.0):
    """Poll children; on any failure terminate the rest and raise
    (reference: launch_utils.py watch_local_trainers:565 — abort-all on
    first failure). Teardown is graceful — SIGTERM, wait up to
    ``grace_s``, then SIGKILL — so each survivor's flight-recorder
    SIGTERM hook gets to dump its span ring before the pod disappears.
    Returns the list of still-alive procs; [] when all exited
    cleanly."""
    alive = []
    for tp in procs:
        ret = tp.proc.poll()
        if ret is None:
            alive.append(tp)
        elif ret != 0:
            terminate_local_procs(procs, grace_s=grace_s)
            raise RuntimeError(
                f"trainer rank {tp.rank} {_death_desc(ret)}; remaining "
                f"trainers were terminated (SIGTERM, {grace_s:.0f}s "
                "grace, then SIGKILL — flight dumps, if armed, are in "
                "PADDLE_TPU_FLIGHT_DIR)")
        else:
            if tp.log_f:
                tp.log_f.close()
    return alive


def terminate_local_procs(procs, grace_s=5.0):
    """SIGTERM every live child, wait up to ``grace_s`` for the flight
    recorder's SIGTERM hook (and any atexit flushing) to run, then
    SIGKILL stragglers."""
    for tp in procs:
        if tp.proc.poll() is None:
            try:
                tp.proc.terminate()
            except OSError:
                pass
    deadline = time.time() + max(0.0, grace_s)
    for tp in procs:
        try:
            tp.proc.wait(timeout=max(0.1, deadline - time.time()))
        except subprocess.TimeoutExpired:
            tp.proc.kill()
        if tp.log_f:
            tp.log_f.close()


def _parse_args(argv):
    import argparse
    p = argparse.ArgumentParser(
        prog="python -m paddle_tpu_torch.distributed.launch")
    p.add_argument("--ips", default="127.0.0.1",
                   help="comma-separated node ips")
    p.add_argument("--node_rank", type=int, default=None,
                   help="this node's index in --ips (default: from "
                        "PADDLE_NODE_RANK env, else 0)")
    p.add_argument("--nproc_per_node", type=int, default=1)
    p.add_argument("--started_port", type=int, default=6170)
    p.add_argument("--log_dir", default=None)
    p.add_argument("training_script")
    p.add_argument("training_script_args", nargs="...")
    return p.parse_args(argv)


def main(argv=None):
    args = _parse_args(argv)
    ips = args.ips.split(",")
    endpoints = []
    for ip in ips:
        for i in range(args.nproc_per_node):
            endpoints.append(f"{ip}:{args.started_port + i}")
    node_rank = args.node_rank
    if node_rank is None:
        node_rank = int(os.environ.get("PADDLE_NODE_RANK", "0"))
    if not 0 <= node_rank < len(ips):
        raise SystemExit(f"--node_rank {node_rank} out of range for "
                         f"{len(ips)} node(s) in --ips")
    cluster = get_cluster(ips, ips[node_rank], endpoints,
                          args.nproc_per_node)
    pod = cluster.pods[node_rank]  # this launcher manages only its own node

    procs = start_local_trainers(cluster, pod, args.training_script,
                                 args.training_script_args,
                                 log_dir=args.log_dir)

    def on_sig(signum, frame):
        terminate_local_procs(procs)
        sys.exit(1)

    signal.signal(signal.SIGTERM, on_sig)
    signal.signal(signal.SIGINT, on_sig)

    while True:
        procs = watch_local_trainers(procs)
        if not procs:
            return 0
        time.sleep(0.5)


if __name__ == "__main__":
    sys.exit(main())
