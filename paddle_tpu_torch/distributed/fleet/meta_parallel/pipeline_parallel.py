"""PipelineParallel (counterpart:
``paddle_tpu/distributed/fleet/meta_parallel/pipeline_parallel.py``).

Each pp rank holds its stage (``PipelineLayer``); activations go down the
pipe group and their gradients come back by point-to-point messages. Every
rank runs the reference's schedule: ``min(S, M)`` warm-up forwards, then one
backward and one forward at a time, then the remaining backwards (``1F1B``;
``FThenB`` runs every forward first). The reference's single process runs
that order over the whole model; here each rank runs it over its stage,
which needs no pairing of sends and receives: sends are posted without
waiting (``isend``) and every receive is of a message that an earlier step
of the schedule sends, so no two stages wait on each other. A forward
message is a small header (rank of the tensor, dtype, shape) and the
activation; a gradient has its activation's shape.

``train_batch`` returns the batch's mean loss on every rank (the last
stage's, broadcast over the pipe group), steps the optimizer and clears the
gradients; ``_last_schedule`` is this rank's ``("F" | "B", microbatch)``
order and ``max_in_flight`` the most microbatches it held at once.
"""
from collections import deque

import torch
import torch.distributed as dist

from ... import collective
from ...parallel import _LayerWrapper, broadcast_parameters

_DTYPES = [torch.float32, torch.bfloat16, torch.float16, torch.float64]
_HEADER = 8


def send_activation(y, dst, group, pending_sends):
    """Post a header (rank, dtype, shape) and ``y`` to ``group``'s rank
    ``dst`` without waiting; (work, tensor) pairs go to
    ``pending_sends``, to be waited."""
    dst = collective.peer(group, dst)
    y = y.detach().contiguous()
    header = torch.zeros(_HEADER, dtype=torch.int64, device=y.device)
    header[0], header[1] = y.dim(), _DTYPES.index(y.dtype)
    header[2:2 + y.dim()] = torch.tensor(y.shape)
    for t in (header, y):
        pending_sends.append((collective.isend(t, dst, group), t))


def recv_activation(src, group, device):
    """Receive what :func:`send_activation` sent from ``group``'s rank
    ``src``."""
    src = collective.peer(group, src)
    header = torch.empty(_HEADER, dtype=torch.int64, device=device)
    collective.recv(header, src, group)
    h = header.tolist()
    x = torch.empty(h[2:2 + h[0]], dtype=_DTYPES[h[1]], device=device)
    return collective.recv(x, src, group)


class PipelineParallel(_LayerWrapper):
    def __init__(self, layers, hcg, strategy=None):
        super().__init__(layers)
        cfg = strategy.pipeline_configs if strategy else {}
        self.accumulate_steps = int(cfg.get("accumulate_steps", 1))
        self.micro_batch_size = cfg.get("micro_batch_size", None)
        self.schedule_mode = cfg.get("schedule_mode", "1F1B")
        if self.schedule_mode not in ("1F1B", "FThenB"):
            raise ValueError(f"unknown schedule_mode {self.schedule_mode!r}")
        self.num_stages = layers.num_stages
        self.stage_id = layers.stage_id
        self._hcg = hcg
        self._group = (hcg.get_pipe_parallel_group() if hcg is not None
                       else None)
        if self.num_stages > 1 and (self._group is None
                                    or self._group.nranks
                                    != self.num_stages):
            raise ValueError(f"{self.num_stages} stages need a pipe group "
                             f"of as many ranks (fleet.init with pp_degree="
                             f"{self.num_stages})")
        first = next(iter(layers.parameters()), None)
        self._device = first.device if first is not None else \
            torch.device("cpu")
        self._last_schedule = []
        self._shared_groups = self._make_shared_groups()
        if collective._world() and hcg is not None:
            for key, group in self._shared_groups.items():
                broadcast_parameters(
                    list(layers._shared_map[key].parameters()), group)
            broadcast_parameters(list(layers.parameters()),
                                 hcg.get_data_parallel_group())

    def _make_shared_groups(self):
        """key -> the group of the stages (of this rank's pipe line) that
        hold the shared layer, where more than one does; every rank makes
        every group, in one order."""
        out = {}
        if self._hcg is None or not collective._world():
            return out
        lines = self._hcg.topology().get_comm_list("pipe")
        me = dist.get_rank()
        for key in sorted(self._layers.shared_keys):
            stages = sorted(self._layers.shared_keys[key])
            if len(stages) < 2:
                continue
            for line in lines:
                ranks = [line[s] for s in stages]
                g = dist.new_group(ranks)
                if me in ranks:
                    out[key] = collective.Group(g, ranks, axis_name="pp")
        return out

    # -- messages ------------------------------------------------------------
    def _send_activation(self, y, pending_sends):
        send_activation(y, self.stage_id + 1, self._group, pending_sends)

    def _recv_activation(self):
        return recv_activation(self.stage_id - 1, self._group, self._device)

    # -- schedules -----------------------------------------------------------
    def _split_micro(self, data):
        x, y = data
        n = self.accumulate_steps
        if x.shape[0] % n:
            raise ValueError(f"batch {x.shape[0]} does not split into "
                             f"{n} microbatches")
        return list(zip(x.chunk(n), y.chunk(n) if y is not None
                        else [None] * n))

    def _forward_micro(self, micro, last, pending_sends):
        x, _ = micro
        if self.stage_id > 0:
            x = self._recv_activation()
            if torch.is_grad_enabled():
                x.requires_grad_(True)
        out = self._layers(x)
        if not last:
            self._send_activation(out, pending_sends)
        return x, out

    def train_batch(self, data, optimizer, lr_scheduler=None, scaler=None):
        if self._layers._loss_fn is None:
            raise ValueError("PipelineLayer needs a loss_fn to train")
        micros = self._split_micro(data)
        M, S = len(micros), self.num_stages
        first, last = self.stage_id == 0, self.stage_id == S - 1
        self._last_schedule = []
        pending = deque()
        sends = []
        total = torch.zeros((), dtype=torch.float32, device=self._device)

        def fwd(m):
            x, out = self._forward_micro(micros[m], last, sends)
            if last:
                out = self._layers._loss_fn(out, micros[m][1]) / M
                total.add_(out.detach().float())
            pending.append((m, x, out))
            self._last_schedule.append(("F", m))

        def bwd():
            m, x, out = pending.popleft()
            if last:
                (scaler.scale(out) if scaler is not None else out).backward()
            else:
                g = torch.empty_like(out)
                collective.recv(g, self._group.ranks[self.stage_id + 1],
                                self._group)
                torch.autograd.backward(out, g)
            if not first:
                gx = x.grad.contiguous()
                sends.append((collective.isend(
                    gx, self._group.ranks[self.stage_id - 1], self._group),
                    gx))
            self._last_schedule.append(("B", m))

        warmup = min(S, M) if self.schedule_mode == "1F1B" else M
        for m in range(warmup):
            fwd(m)
        for m in range(warmup, M):
            bwd()
            fwd(m)
        while pending:
            bwd()
        for work, _ in sends:
            work.wait()
        self._reduce_shared_grads()
        loss = self._broadcast_loss(total)
        if scaler is not None:
            scaler.step(optimizer)
        else:
            optimizer.step()
        optimizer.clear_grad()
        if lr_scheduler is not None:
            lr_scheduler.step()
        return loss

    @torch.no_grad()
    def eval_batch(self, data, compute_loss=True):
        micros = self._split_micro(data)
        last = self.stage_id == self.num_stages - 1
        total = torch.zeros((), dtype=torch.float32, device=self._device)
        outs, sends = [], []
        for micro in micros:
            _, out = self._forward_micro(micro, last, sends)
            if last and compute_loss:
                total.add_(self._layers._loss_fn(out, micro[1]).float()
                           / len(micros))
            outs.append(out)
        for work, _ in sends:
            work.wait()
        if compute_loss:
            return self._broadcast_loss(total)
        return torch.cat(outs) if last else None

    def forward(self, x):
        """The pipelined forward of one batch: the output on the last
        stage, None on the others."""
        sends = []
        last = self.stage_id == self.num_stages - 1
        _, out = self._forward_micro((x, None), last, sends)
        for work, _ in sends:
            work.wait()
        return out if last else None

    def _reduce_shared_grads(self):
        for key, group in self._shared_groups.items():
            for p in self._layers._shared_map[key].parameters():
                if p.grad is None:
                    p.grad = torch.zeros_like(p)
                collective.all_reduce(p.grad, group=group)

    def _broadcast_loss(self, total):
        if self.num_stages > 1:
            collective.broadcast(total, src=self._group.ranks[-1],
                                 group=self._group)
        return total

    def max_in_flight(self):
        """The most microbatches held at once in the last ``train_batch``."""
        live = peak = 0
        for kind, _ in self._last_schedule:
            live += 1 if kind == "F" else -1
            peak = max(peak, live)
        return peak
