"""CTR-style parameter-server training process (counterpart: the
reference's ``tests/fixtures/ps_ctr_runner.py``, rewritten over the port):
a ``SparseEmbedding`` + MLP trained against one or more servers and N
workers on localhost through the fleet (``fleet.init(is_collective=
False)``, ``init_server``/``run_server``, ``init_worker``, ``ps_step``,
``save_persistables``, ``stop_worker``, ``shutdown_servers``).

Run as ``python -m paddle_tpu_torch.testing.ps_fixture``. The environment
picks the role and mode, as the reference's:

  PS_ROLE=server|worker|local
  PS_MODE=sync|async|geo (geo: PS_K_STEPS, default 1)
  PADDLE_PSERVER_ENDPOINTS, PADDLE_TRAINER_ID, PADDLE_TRAINERS_NUM,
  PADDLE_PSERVER_ID, TRAINING_ROLE
  PS_SAVE: a snapshot prefix worker 0 saves to after training

and, the port's own:

  PS_FIX_DEVICE: where the dense math runs, by default the card (a raise
      without one); the tests ask for ``cpu``
  PS_FIX_STEPS: training steps (default 200, the reference's)
  PS_FIX_INIT: an ``.npz`` of the dense parameters by structured name
      (``fc1.weight``, ...), e.g. the reference's initial weights; without
      it they are drawn from ``paddle_tpu_torch.seed(0)``

A server whose endpoint names port 0 binds a free one. Standard output:
``SERVER_READY <port>`` (server), ``LOSS <step> <value>`` per
step, ``PARAMS <sha256 of the dense parameters' float32 bytes>`` after the
last step (worker) and ``SPARSE_SIZE <n>`` (worker 0 with ``PS_SAVE``).
``local`` emulates geo k=1 on one process exactly: the whole table
initialized by the server's per-key rule, plain SGD.
"""
import hashlib
import os

import numpy as np
import torch

VOCAB, DIM, SLOTS, BATCH, STEPS = 100, 8, 3, 64, 200
LR = 0.2

_ID_WEIGHTS = np.random.RandomState(42).randn(VOCAB).astype(np.float32)


def synth_batch(step, worker_id, n_workers):
    """The reference fixture's deterministic batch: the label is keyed on
    the first slot's id alone, so each embedding row can memorize it."""
    rng = np.random.RandomState(1234 + step * 17 + worker_id)
    ids = rng.randint(0, VOCAB, (BATCH, SLOTS)).astype(np.int64)
    label = _ID_WEIGHTS[ids[:, 0]] > 0.0
    return ids, label.astype(np.float32).reshape(-1, 1)


def _device():
    from paddle_tpu_torch.core.device import resolve_device
    return resolve_device(os.environ.get("PS_FIX_DEVICE") or None)


def _steps():
    return int(os.environ.get("PS_FIX_STEPS", STEPS))


def build_model(device, sparse=True):
    """The fixture's model on ``device``: a ``SparseEmbedding([VOCAB,
    DIM])`` (table 1000), ``fc1`` (SLOTS * DIM -> 16) and ``fc2`` (16 ->
    1); dense weights from ``PS_FIX_INIT`` when given."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch import nn
    from paddle_tpu_torch.distributed import ps

    class CtrModel(nn.Layer):
        def __init__(self):
            super().__init__()
            self.emb = (ps.SparseEmbedding([VOCAB, DIM], init_range=0.1,
                                           device=device)
                        if sparse else None)
            self.fc1 = nn.Linear(SLOTS * DIM, 16, device=device)
            self.fc2 = nn.Linear(16, 1, device=device)

        def forward(self, ids, emb_out=None):
            e = self.emb(ids) if self.emb is not None else emb_out
            h = e.reshape(e.shape[0], SLOTS * DIM)
            h = nn.functional.relu(self.fc1(h))
            return self.fc2(h)

    pt.seed(0)
    model = CtrModel()
    init = os.environ.get("PS_FIX_INIT")
    if init:
        with np.load(init) as z:
            with torch.no_grad():
                for name, p in model.named_parameters():
                    p.copy_(torch.from_numpy(z[name]))
    return model


def loss_fn(logits, label):
    from paddle_tpu_torch.nn import functional as F
    return F.binary_cross_entropy_with_logits(
        logits, torch.from_numpy(label).to(logits.device))


def make_strategy():
    from paddle_tpu_torch.distributed import fleet
    s = fleet.DistributedStrategy()
    mode = os.environ.get("PS_MODE", "sync")
    s.a_sync = mode != "sync"
    s.a_sync_configs = {"learning_rate": LR}
    if mode == "geo":
        s.a_sync_configs["k_steps"] = int(os.environ.get("PS_K_STEPS", "1"))
    return s


def params_digest(model):
    h = hashlib.sha256()
    for _, p in model.named_parameters():
        h.update(p.detach().float().cpu().numpy().tobytes())
    return h.hexdigest()


def run_server():
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.distributed.fleet import PaddleCloudRoleMaker
    fleet.init(PaddleCloudRoleMaker(is_collective=False),
               strategy=make_strategy())
    model = build_model(torch.device("cpu"))  # the table and dense shapes
    srv = fleet.init_server(model)
    print(f"SERVER_READY {srv.port}", flush=True)
    fleet.run_server()


def run_worker():
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.distributed.fleet import PaddleCloudRoleMaker
    fleet.init(PaddleCloudRoleMaker(is_collective=False),
               strategy=make_strategy())
    device = _device()
    model = build_model(device)
    fleet.init_worker(model)
    mode = os.environ.get("PS_MODE", "sync")
    wid = int(os.environ.get("PADDLE_TRAINER_ID", "0"))
    nw = int(os.environ.get("PADDLE_TRAINERS_NUM", "1"))
    opt = (pt.optimizer.SGD(parameters=model.parameters(), learning_rate=LR)
           if mode == "geo" else None)
    for step in range(_steps()):
        ids, label = synth_batch(step, wid, nw)
        logits = model(torch.from_numpy(ids).to(device))
        loss = loss_fn(logits, label)
        loss.backward()
        fleet.ps_step(opt)
        print(f"LOSS {step} {float(loss.detach()):.9g}", flush=True)
    fleet.barrier_worker()  # all workers done training
    if mode != "geo":
        fleet.ps_runtime().communicator.pull_dense()
    print(f"PARAMS {params_digest(model)}", flush=True)
    if wid == 0 and os.environ.get("PS_SAVE"):
        fleet.save_persistables(dirname=os.environ["PS_SAVE"])
        size = fleet.ps_runtime().client.sparse_size(model.emb.table_id)
        print(f"SPARSE_SIZE {size}", flush=True)
    fleet.barrier_worker()  # save complete before anyone tears down
    fleet.stop_worker()
    if wid == 0:
        fleet.shutdown_servers()
    fleet.ps_runtime().client.close()


def run_local():
    """Geo k=1 on one process: the full table initialized with the
    server's per-key rule, plain SGD on it and on the dense layers."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.distributed.ps.embedding import deterministic_init
    device = _device()
    model = build_model(device, sparse=False)
    table = torch.from_numpy(deterministic_init(
        1000, np.arange(VOCAB, dtype=np.uint64), DIM, 0.1)).to(device)
    table.requires_grad_(True)
    opt = pt.optimizer.SGD(parameters=model.parameters(), learning_rate=LR)
    for step in range(_steps()):
        ids, label = synth_batch(step, 0, 1)
        idx = torch.from_numpy(ids.ravel()).to(device)
        emb = table.index_select(0, idx).reshape(BATCH, SLOTS, DIM)
        loss = loss_fn(model(None, emb_out=emb), label)
        loss.backward()
        opt.step()
        opt.clear_grad()
        with torch.no_grad():
            table -= LR * table.grad
        table.grad = None
        print(f"LOSS {step} {float(loss.detach()):.9g}", flush=True)


def main():
    torch.set_num_threads(1)
    role = os.environ.get("PS_ROLE", "local")
    if role == "server":
        run_server()
    elif role == "worker":
        run_worker()
    else:
        run_local()


if __name__ == "__main__":
    main()
