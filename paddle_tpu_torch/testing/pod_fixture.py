"""One data-parallel training rank for ``testing.virtual_pod`` (counterpart:
the reference's ``tests/fixtures/virtual_pod_fixture.py``, rewritten over
the port).

Run as ``python -m paddle_tpu_torch.testing.pod_fixture`` under a
:class:`~paddle_tpu_torch.testing.virtual_pod.VirtualPod`. Deterministic
per-step batches; the model and optimizer state checkpoint through the
rank-0-committed pod checkpoint (``checkpoint.PodCheckpointManager``). On a
peer's death the rank detects it (``RankFailedError``, a barrier timeout
or a failed pod save), re-forms at the smaller world, restores from the
last pod checkpoint and continues.

The heal half (``POD_FIX_TARGET_WORLD``): at every step boundary the ranks
agree, through an allreduce of what each sees in the coordinator's lobby,
on whether a replacement is waiting; when one is, every rank commits the
current state (unless the newest checkpoint already holds it), calls
``pod.reform()`` (the world grows) and restores from that checkpoint, so
the grown world resumes from one step. From ``POD_FIX_HEAL_BY_STEP`` on, a
rank below the target world waits at the boundary for a joiner (at most
``POD_FIX_HEAL_TIMEOUT`` seconds).

``POD_FIX_MODEL`` picks what a rank trains:

- ``mlp`` (the default, the reference's fixture): the batch is sharded
  over the CURRENT pod world and the loss and gradients cross the process
  boundary through the coordinator's float64 allreduce. The forward and
  backward are hand-written numpy float64 on the float32 parameters (so
  the pod's mean of shard sums equals the full-batch mean to ~1e-15, and
  "within 1e-6 of :func:`control`" is a real invariant); the update is the
  port's ``Momentum`` on the parameters' device.
- ``gpt_small`` (GPT-small at full width: 124M parameters, AdamW with
  float32 masters, about 1.7 GB of state) and ``gpt_tiny`` (2 layers,
  width 64, 32 tokens a row): replicas. Every rank runs the whole batch
  (``POD_FIX_BATCH`` rows of the model's sequence) under bf16
  ``auto_cast`` and updates
  its own copy; only the loss crosses the pod (its mean over the ranks,
  equal to each replica's loss when they agree), so a re-formation
  restores the full state from the pod checkpoint, which each rank writes
  a shard of.

The device is ``POD_FIX_DEVICE``, by default the card
(``core.device.resolve_device``: a raise without one); the tests ask for
``cpu``.

Standard output (the protocol the reference's fixture prints)::

  POD_READY rank=R world=W gen=G
  LOSS <step> <loss>
  CKPT <step>
  FAILURE_DETECTED t=<wall> failed=[..] err=<ExcType>
  REFORMED rank=R world=W gen=G dir=<shrink|grow|steady> t=<wall>
  RESUME_FROM <step> t=<wall>
  HEAL_TIMEOUT step=<step>
  DONE rank=R world=W
"""
import os
import sys
import time

import numpy as np
import torch

MODEL = os.environ.get("POD_FIX_MODEL", "mlp")
STEPS = int(os.environ.get("POD_FIX_STEPS", "8"))
CKPT_EVERY = int(os.environ.get("POD_FIX_CKPT_EVERY", "3"))
BATCH = int(os.environ.get("POD_FIX_BATCH", "8"))
TARGET_WORLD = int(os.environ.get("POD_FIX_TARGET_WORLD", "0"))
HEAL_BY_STEP = int(os.environ.get("POD_FIX_HEAL_BY_STEP", "-1"))
HEAL_TIMEOUT = float(os.environ.get("POD_FIX_HEAL_TIMEOUT", "60"))
IN_DIM, HID = 8, 16


def _data(step):
    rng = np.random.RandomState(1000 + step)
    return rng.rand(BATCH, IN_DIM), rng.rand(BATCH, 1)  # float64


def _forward_backward(params, x, y):
    """Float64 MLP (Linear-ReLU-Linear, MSE) on one shard: the
    squared-error SUM and the gradient sums in the parameters' order
    [W1, b1, W2, b2]. The caller allreduces the sums and divides by the
    global batch, so any sharding gives the full-batch mean."""
    W1, b1, W2, b2 = params
    h = x @ W1 + b1
    hr = np.maximum(h, 0.0)
    out = hr @ W2 + b2
    d = out - y
    sq = float(np.sum(d * d))
    dout = 2.0 * d
    gW2 = hr.T @ dout
    gb2 = dout.sum(axis=0)
    dh = (dout @ W2.T) * (h > 0.0)
    return sq, [x.T @ dh, dh.sum(axis=0), gW2, gb2]


def build(device):
    """The MLP (seed 7) and its ``Momentum`` optimizer."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch import nn
    pt.seed(7)
    model = nn.Sequential(nn.Linear(IN_DIM, HID, device=device), nn.ReLU(),
                          nn.Linear(HID, 1, device=device))
    opt = pt.optimizer.Momentum(parameters=model.parameters(),
                                learning_rate=0.05, momentum=0.9)
    return model, opt


def _host(params):
    return [p.detach().cpu().double().numpy() for p in params]


class _MLP:
    """The reference fixture's rank: its shard's float64 sums, divided by
    the global batch after the allreduce."""

    def __init__(self, device):
        self.model, self.opt = build(device)
        self.params = list(self.model.parameters())
        self.grads = None

    def local(self, step, lo, hi):
        x, y = _data(step)
        sq, self.grads = _forward_backward(_host(self.params), x[lo:hi],
                                           y[lo:hi])
        return np.concatenate([g.ravel() for g in self.grads]
                              + [np.array([sq])])

    def update(self, total, world):
        mean = total / float(BATCH)
        off = 0
        for p, g in zip(self.params, self.grads):
            n = g.size
            p.grad = torch.from_numpy(
                mean[off:off + n].reshape(g.shape).astype(np.float32)).to(
                    p.device)
            off += n
        self.opt.step()
        self.opt.clear_grad()
        return float(mean[-1])


def _gpt_config(model=MODEL):
    from paddle_tpu_torch.models.gpt import GPTConfig, gpt_small
    if model == "gpt_small":
        return gpt_small(hidden_dropout=0.0, attention_dropout=0.0)
    if model == "gpt_tiny":
        return GPTConfig(vocab_size=128, hidden_size=64, num_layers=2,
                         num_heads=2, max_seq_len=32, hidden_dropout=0.0,
                         attention_dropout=0.0)
    raise ValueError(f"unknown POD_FIX_MODEL {model!r}: mlp, gpt_small "
                     "or gpt_tiny")


class _GPTReplica:
    """A GPT replica (seed 7, bf16 parameters) with AdamW over float32
    masters and a global-norm clip: the whole batch on every rank, the
    loss the only number that crosses the pod."""

    def __init__(self, device, model):
        import paddle_tpu_torch as pt
        from paddle_tpu_torch import nn, optimizer
        from paddle_tpu_torch.models.gpt import GPTForCausalLM
        self.pt = pt
        self.cfg = _gpt_config(model)
        pt.seed(7)
        self.model = GPTForCausalLM(self.cfg, device=device)
        self.model.to("bfloat16")
        self.opt = optimizer.AdamW(
            learning_rate=1e-4, parameters=self.model.parameters(),
            multi_precision=True, grad_clip=nn.ClipGradByGlobalNorm(1.0),
            apply_decay_param_fun=lambda n: not (n.endswith(".bias")
                                                 or ".ln" in n))
        self.device = device

    def local(self, step, lo, hi):
        from paddle_tpu_torch.models.gpt import synthetic_lm_batch
        ids = torch.from_numpy(synthetic_lm_batch(
            BATCH, self.cfg.max_seq_len, self.cfg.vocab_size,
            seed=1000 + step)).to(
                self.device)
        with self.pt.amp.auto_cast(enable=True, dtype="bfloat16"):
            loss = self.model.loss(self.model(ids), ids)
        loss.backward()
        return np.array([float(loss.item())])

    def update(self, total, world):
        self.opt.step()
        self.opt.clear_grad()
        return float(total[0] / world)


def _trainer(device, model=MODEL):
    """The rank's trainer for ``POD_FIX_MODEL`` ``model``."""
    return _MLP(device) if model == "mlp" else _GPTReplica(device, model)


def control(steps=STEPS, device=None, model=MODEL):
    """The same training in one process without a pod: the loss of each
    step (the pod's losses must be within 1e-6 of these)."""
    from paddle_tpu_torch.core.device import resolve_device
    t = _trainer(resolve_device(device), model)
    losses = []
    for step in range(steps):
        losses.append(t.update(t.local(step, 0, BATCH), 1))
    return losses


def main():
    from paddle_tpu_torch import observability as obs
    from paddle_tpu_torch.checkpoint.multihost import (PodCheckpointError,
                                                       PodCheckpointManager)
    from paddle_tpu_torch.core.device import resolve_device
    from paddle_tpu_torch.distributed.pod import (BarrierTimeoutError,
                                                  PodRuntime,
                                                  RankFailedError)
    from paddle_tpu_torch.testing import faults

    root = os.environ["POD_FIX_CKPT_ROOT"]
    device = resolve_device(os.environ.get("POD_FIX_DEVICE"))
    obs.enable()  # the run-log and the flight recorder arm from the env
    pod = PodRuntime.from_env()
    pod.init()
    print(f"POD_READY rank={pod.rank} world={pod.world_size} "
          f"gen={pod.gen}", flush=True)

    t = _trainer(device)
    mgr = PodCheckpointManager(root, pod=pod, timeout=60.0)
    mgr.add_model(t.model).add_optimizer(t.opt)

    meta = mgr.restore()
    step = (int(meta["step"]) + 1) if meta else 0
    if meta:
        print(f"RESUME_FROM {step} t={time.time():.3f}", flush=True)

    def reform_and_restore():
        nonlocal step, meta
        old_w = pod.world_size
        pod.reform(timeout=30.0)
        d = ("grow" if pod.world_size > old_w
             else "shrink" if pod.world_size < old_w else "steady")
        print(f"REFORMED rank={pod.rank} world={pod.world_size} "
              f"gen={pod.gen} dir={d} t={time.time():.3f}", flush=True)
        meta = mgr.restore()
        step = (int(meta["step"]) + 1) if meta else 0
        print(f"RESUME_FROM {step} t={time.time():.3f}", flush=True)

    while step < STEPS:
        try:
            # the step boundary: learn of parked joiners and grow back.
            # The decision is collective (an allreduce of each rank's
            # glimpse of the lobby), or one rank could reform alone while
            # its peer waits in the step's barrier.
            attempt = 0
            wait_t0 = None
            while True:
                joiners = len(pod.pending_joiners())
                agreed = pod.allreduce(
                    [float(joiners)],
                    name=f"lobby{step}.{attempt}.g{pod.gen}",
                    timeout=30.0)[0]
                attempt += 1
                if agreed > 0:
                    # every rank of the grown world restores this state;
                    # every rank reads the same newest step here (the
                    # allreduce above follows the last save's commit)
                    if step > 0 and mgr.latest_step() != step - 1:
                        mgr.save(step - 1)
                    reform_and_restore()
                    attempt = 0  # the replacement starts at attempt 0
                    wait_t0 = None
                    continue
                if TARGET_WORLD and 0 <= HEAL_BY_STEP <= step \
                        and pod.world_size < TARGET_WORLD:
                    wait_t0 = time.time() if wait_t0 is None else wait_t0
                    if time.time() - wait_t0 > HEAL_TIMEOUT:
                        print(f"HEAL_TIMEOUT step={step}", flush=True)
                        break
                    time.sleep(0.25)
                    continue
                break

            faults.kill_point("pod/before_barrier")
            pod.barrier(f"step{step}.g{pod.gen}", timeout=30.0)
            lo, hi = pod.shard_range(BATCH)
            contribution = t.local(step, lo, hi)
            faults.kill_point("pod/mid_step")
            total = pod.allreduce(contribution,
                                  name=f"grads{step}.g{pod.gen}",
                                  timeout=30.0)
            loss = t.update(total, pod.world_size)
            print(f"LOSS {step} {loss:.12e}", flush=True)
            if (step + 1) % CKPT_EVERY == 0:
                mgr.save(step)
                obs.memory.runlog_snapshot(rank=pod.origin, export=True)
                print(f"CKPT {step}", flush=True)
            step += 1
        except (RankFailedError, BarrierTimeoutError,
                PodCheckpointError) as e:
            print(f"FAILURE_DETECTED t={time.time():.3f} "
                  f"failed={getattr(e, 'ranks', [])} "
                  f"err={type(e).__name__}", flush=True)
            reform_and_restore()

    obs.memory.runlog_snapshot(rank=pod.origin, export=True)
    print(f"DONE rank={pod.rank} world={pod.world_size}", flush=True)
    pod.shutdown()
    obs.stop_run()
    return 0


if __name__ == "__main__":
    sys.exit(main())
