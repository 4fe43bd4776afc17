"""The pod runtime, its supervisor and the restart policy against the
reference.

- ``RestartPolicy`` gives the reference's schedule for the same seed
  (delays equal to the last bit, the budget and the window alike).
- The wire protocol: port ranks rendezvous, barrier and allreduce through
  the reference's coordinator, reference ranks through the port's, and a
  mixed pod of one rank of each through either; the sums are exact
  (float64, rank-sorted). A barrier one rank never reaches raises
  ``BarrierTimeoutError`` naming it, and a rank marked failed raises
  ``RankFailedError`` naming it, as in the reference.
- Kill and heal: 2-process ``VirtualPod`` runs of
  ``testing.pod_fixture`` on the CPU (the reference's MLP, and GPT
  replicas that restore the whole model and AdamW state), rank 1
  SIGKILLed at ``pod/mid_step`` and respawned under a ``RestartPolicy``:
  the survivor detects it, re-forms at world 1, the replacement rejoins
  and the world heals to 2; every loss is within 1e-6 of the fixture's
  in-process control. (The reference's own subprocess pod tests fail in the
  driver's runs, so the port's run is held to its own control.)
- ``spawn`` reports a rank's death with its signal and its stderr tail;
  ``distributed.launch`` runs as a module with the reference's
  environment names and ``MASTER_ADDR``/``MASTER_PORT``; the elastic
  manager registers, sees its peers and relaunches under a policy.
"""
import os
import re
import signal
import subprocess
import sys
import threading

import numpy as np
import pytest

from paddle_tpu.distributed import pod as ref_pod
from paddle_tpu.distributed import restart as ref_restart
from paddle_tpu_torch.distributed import pod, restart
from paddle_tpu_torch.distributed.spawn import spawn
from paddle_tpu_torch.distributed.fleet import elastic
from paddle_tpu_torch.testing import pod_fixture
from paddle_tpu_torch.testing.virtual_pod import VirtualPod

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LOSS_TOL = 1e-6


@pytest.mark.parametrize("kw", [
    dict(seed=0), dict(seed=7, jitter=0.5, factor=3.0, max_restarts=5),
    dict(seed=3, window_s=10.0, max_restarts=2)])
def test_restart_policy_schedules_as_the_reference(kw):
    want, got = ref_restart.RestartPolicy(**kw), restart.RestartPolicy(**kw)
    for now in (0.0, 1.0, 2.0, 3.0, 4.0, 30.0, 31.0):
        for key in ("a", "b"):
            assert got.schedule(key, now=now) == want.schedule(key, now=now)
    assert got.snapshot() == want.snapshot()
    got.reset("a")
    want.reset("a")
    assert got.attempts("a") == want.attempts("a") == 0
    assert pod.RestartPolicy is restart.RestartPolicy


def _rank(mod, endpoint, n, i, out, steps=3):
    rt = mod.PodRuntime(endpoint, n, i, heartbeat_interval=0.1,
                        barrier_timeout=20.0, jax_init="never")
    rt.init()
    try:
        got = []
        for s in range(steps):
            rt.barrier(f"s{s}")
            got.append(rt.allreduce(np.arange(4.0) * (i + 1) + s,
                                    name=f"ar{s}"))
        out[i] = (rt.rank, rt.world_size, rt.uid, got,
                  rt.allreduce_mean([float(i)]))
    finally:
        rt.shutdown()


PAIRS = [("ref", "port", "port"), ("port", "ref", "ref"),
         ("ref", "ref", "port"), ("port", "port", "ref")]


@pytest.mark.parametrize("coord,r0,r1", PAIRS,
                         ids=[f"{c}-coordinator-{a}+{b}" for c, a, b in PAIRS])
def test_ranks_interoperate_over_the_wire(coord, r0, r1):
    mods = {"ref": ref_pod, "port": pod}
    server, endpoint = mods[coord].start_coordinator(expected=2,
                                                     lease_ttl=5.0)
    out = {}
    try:
        threads = [threading.Thread(target=_rank,
                                    args=(mods[m], endpoint, 2, i, out))
                   for i, m in enumerate((r0, r1))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
    finally:
        server.close()
    assert sorted(out) == [0, 1]
    assert out[0][2] == out[1][2]  # one pod uid
    for i in (0, 1):
        rank, world, _uid, sums, mean = out[i]
        assert (rank, world) == (i, 2)
        for s, got in enumerate(sums):
            np.testing.assert_array_equal(got, np.arange(4.0) * 3 + 2 * s)
        np.testing.assert_array_equal(mean, [0.5])


def _pair(mod, endpoint):
    rts = [mod.PodRuntime(endpoint, 2, i, heartbeat_interval=0.1,
                          jax_init="never") for i in range(2)]
    ts = [threading.Thread(target=r.init) for r in rts]
    for t in ts:
        t.start()
    for t in ts:
        t.join(30)
    return rts


@pytest.mark.parametrize("pkg", ["port", "reference"])
def test_barrier_timeout_and_rank_failure(pkg):
    mod = pod if pkg == "port" else ref_pod
    server, endpoint = mod.start_coordinator(expected=2, lease_ttl=5.0)
    rts = _pair(mod, endpoint)
    try:
        with pytest.raises(mod.BarrierTimeoutError) as e:
            rts[0].barrier("lonely", timeout=0.5)
        assert e.value.waiting == [1] and e.value.name == "lonely"
        server.mark_failed(1, "killed by SIGKILL")
        with pytest.raises(mod.RankFailedError) as e:
            rts[0].barrier("after", timeout=5.0)
        assert e.value.ranks == [1]
        assert "killed by SIGKILL" in str(e.value)
        assert rts[0].failed_ranks() == [1]
        view = rts[0].reform(timeout=5.0)
        assert view == {"gen": 1, "rank": 0, "world_size": 1}
        with pytest.raises(mod.StaleGenerationError):
            rts[1].barrier("stale", timeout=1.0)
    finally:
        for r in rts:
            r.shutdown()
        server.close()


def _losses(text):
    out = {}
    for step, loss in re.findall(r"^LOSS (\d+) (\S+)$", text, re.M):
        out.setdefault(int(step), []).append(float(loss))
    return out


# (model, steps, checkpoint every, the kill's hit of pod/mid_step, heal
# by step): the reference's MLP, and GPT replicas whose restore carries
# the whole model and AdamW state
POD_RUNS = [("mlp", 10, 3, 5, 7), ("gpt_tiny", 5, 2, 4, 4)]


@pytest.mark.parametrize("model,steps,every,kill_at,heal_by", POD_RUNS)
def test_virtual_pod_kill_and_heal_within_control(tmp_path, model, steps,
                                                  every, kill_at, heal_by):
    env = {"POD_FIX_CKPT_ROOT": str(tmp_path / "ckpt"),
           "POD_FIX_MODEL": model, "POD_FIX_DEVICE": "cpu",
           "POD_FIX_STEPS": str(steps),
           "POD_FIX_CKPT_EVERY": str(every), "POD_FIX_TARGET_WORLD": "2",
           "POD_FIX_HEAL_BY_STEP": str(heal_by),
           "POD_FIX_HEAL_TIMEOUT": "60", "OMP_NUM_THREADS": "1"}
    vp = VirtualPod(2, pod_fixture.__file__, workdir=str(tmp_path), env=env,
                    kill=(1, "pod/mid_step", kill_at),
                    restart=restart.RestartPolicy(max_restarts=2,
                                                  base_delay=0.2, seed=0))
    exits = vp.run(timeout=180)
    logs = vp.tail_logs(20000)
    assert exits[0].returncode == 0, logs
    assert exits[1].returncode == 0 and exits[1].incarnation == 2, logs
    first = vp.exit_history[0]
    assert (first.rank, first.signal) == (1, "SIGKILL")
    r0 = vp.log(0)
    assert "FAILURE_DETECTED" in r0 and "err=RankFailedError" in r0
    assert re.search(r"REFORMED rank=0 world=1 gen=1 dir=shrink", r0)
    assert re.search(r"REFORMED rank=0 world=2 gen=2 dir=grow", r0)
    assert "DONE rank=0 world=2" in r0
    assert "DONE rank=1 world=2" in vp.log(1)
    control = pod_fixture.control(steps, device="cpu", model=model)
    losses = _losses(r0 + vp.log(1))
    assert sorted(losses) == list(range(steps))
    for step, got in losses.items():
        for value in got:
            assert abs(value - control[step]) <= LOSS_TOL, (step, value)
    assert vp.runlog_paths()  # each rank's run-log, the killed one's too
    assert os.listdir(os.path.join(str(tmp_path), "flight"))


def _dies(code):
    print("about to die", file=sys.stderr, flush=True)
    if code < 0:
        os.kill(os.getpid(), -code)
    return code


def test_spawn_reports_a_dead_rank_with_its_stderr():
    with pytest.raises(RuntimeError) as e:
        spawn(_dies, args=(-int(signal.SIGKILL),), nprocs=2,
                    backend="cpu", timeout=60)
    text = str(e.value)
    assert "died by SIGKILL" in text and "about to die" in text
    ctx = spawn(_dies, args=(3,), nprocs=2, backend="cpu", timeout=60)
    assert [r[2] for r in ctx.results] == [3, 3]


def test_launch_module_exports_the_environment(tmp_path):
    script = tmp_path / "show.py"
    script.write_text(
        "import os\n"
        "keys = ['PADDLE_TRAINER_ID', 'PADDLE_TRAINERS_NUM', "
        "'PADDLE_TRAINER_ENDPOINTS', 'PADDLE_CURRENT_ENDPOINT', "
        "'MASTER_ADDR', 'MASTER_PORT', 'TORCH_SHOW_CPP_STACKTRACES']\n"
        "print(' '.join(f'{k}={os.environ[k]}' for k in keys))\n")
    env = dict(os.environ, PYTHONPATH=ROOT)
    res = subprocess.run(
        [sys.executable, "-m", "paddle_tpu_torch.distributed.launch",
         "--nproc_per_node", "2", "--started_port", "7311", "--log_dir",
         str(tmp_path / "logs"), str(script)],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=60)
    assert res.returncode == 0, res.stderr
    line = (tmp_path / "logs" / "workerlog.1").read_text().strip()
    assert line == (
        "PADDLE_TRAINER_ID=1 PADDLE_TRAINERS_NUM=2 "
        "PADDLE_TRAINER_ENDPOINTS=127.0.0.1:7311,127.0.0.1:7312 "
        "PADDLE_CURRENT_ENDPOINT=127.0.0.1:7312 MASTER_ADDR=127.0.0.1 "
        "MASTER_PORT=7311 TORCH_SHOW_CPP_STACKTRACES=1")


def test_elastic_manager_registers_and_relaunches(tmp_path):
    store = elastic.FileKVStore(str(tmp_path / "kv"))
    a = elastic.ElasticManager("127.0.0.1:1", np=2, job_id="j", store=store,
                               ttl=5.0, heartbeat_interval=0.1)
    b = elastic.ElasticManager("127.0.0.1:2", np=2, job_id="j", store=store,
                               ttl=5.0, heartbeat_interval=0.1)
    try:
        a.register()
        b.register()
        assert a.wait_ready(timeout=10)
        assert a.live_nodes() == ["127.0.0.1:1", "127.0.0.1:2"]
        assert (a.rank(), b.rank()) == (0, 1)
        codes = iter([1, 1, 0])  # two crashes, then a clean exit
        spawned = []

        class _Proc:
            def __init__(self):
                self.code = next(codes)
                spawned.append(self)

            def poll(self):
                return self.code

            def terminate(self):
                pass
        status, proc = a.relaunch(
            _Proc, policy=restart.RestartPolicy(max_restarts=3,
                                                base_delay=0.01, seed=0),
            watch_interval=0.01)
        assert status == elastic.ElasticStatus.COMPLETED
        assert len(spawned) == 3 and proc is spawned[-1]
        codes = iter([1, 1, 1])
        status, _ = a.relaunch(
            _Proc, policy=restart.RestartPolicy(max_restarts=1,
                                                base_delay=0.01, seed=0),
            watch_interval=0.01)
        assert status == elastic.ElasticStatus.EXIT
    finally:
        a.exit()
        b.exit()
    assert elastic.RestartPolicy is restart.RestartPolicy
