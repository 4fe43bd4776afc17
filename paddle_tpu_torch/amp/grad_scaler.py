"""GradScaler: dynamic loss scaling (counterpart:
``paddle_tpu/amp/grad_scaler.py``, the reference's
``check_finite_and_unscale`` and ``update_loss_scaling``).

bfloat16 needs no loss scaling (``GradScaler(enable=False)`` keeps the
API and does nothing); float16 training does. The scale, the good and bad
step counts and the found-inf flag are tensors on the device, updated in
place, and a step that found an inf or a NaN is skipped on the device:
the optimizer's state (parameters, moments, masters, ZeRO stores and
``@step``) is snapshotted before the update and selected back where the
flag is set. So a scaled step reads nothing on the host and runs inside a
captured k-step program. The state tensors move to the loss's device at
the first :meth:`scale` (a checkpoint restored before that is carried).

Under a dp axis the flag is the OR over the group's ranks. In an
accumulation window's micro steps ``step`` only defers to the optimizer,
and the window's last step unscales the window's gradients once; ZeRO
stage 2/3 windows (whose earlier micro steps are already folded into
``gacc``, scaled) are not supported. A sparse gradient (``SelectedRows``)
is unscaled and checked through its row values.
"""
import torch

from ..core.selected_rows import SelectedRows
from ..core.tensor import fold_sparse
from ..distributed import collective, parallel_env

__all__ = ["GradScaler", "AmpScaler"]


class GradScaler:
    def __init__(self, enable=True, init_loss_scaling=2.0 ** 15,
                 incr_ratio=2.0, decr_ratio=0.5, incr_every_n_steps=1000,
                 decr_every_n_nan_or_inf=2, use_dynamic_loss_scaling=True):
        self._enable = enable
        self._use_dynamic = use_dynamic_loss_scaling
        self._incr_ratio = incr_ratio
        self._decr_ratio = decr_ratio
        self._incr_every = incr_every_n_steps
        self._decr_every = decr_every_n_nan_or_inf
        self._scale = torch.tensor(
            float(init_loss_scaling) if enable else 1.0, dtype=torch.float32)
        self._good_steps = torch.zeros((), dtype=torch.int32)
        self._bad_steps = torch.zeros((), dtype=torch.int32)
        self._found_inf = torch.zeros((), dtype=torch.bool)
        self._unscaled = False  # unscale_ ran since the last step

    def _place(self, device):
        """Move the state to ``device`` (before any capture reads it)."""
        if self._scale.device != device:
            for name in ("_scale", "_good_steps", "_bad_steps", "_found_inf"):
                setattr(self, name, getattr(self, name).to(device))

    def is_enable(self):
        return self._enable

    def is_use_dynamic_loss_scaling(self):
        return self._use_dynamic

    def get_init_loss_scaling(self):
        return float(self._scale)

    def set_init_loss_scaling(self, v):
        self._scale.fill_(float(v))

    def scale(self, var):
        if not self._enable:
            return var
        self._place(var.device)
        return var * self._scale

    def unscale_(self, optimizer, _check_finite=True):
        """Divide every gradient by the scale, in place, and set the
        found-inf flag where one is not finite."""
        if not self._enable:
            return
        acc = parallel_env.current_accum()
        if acc is not None and acc[0] == "accum":
            raise RuntimeError(
                "scaler.unscale_ inside a gradient-accumulation window "
                "(to_static(accumulate_steps=a)) mixes unscaled and scaled "
                "micro gradients; rely on scaler.step at the window "
                "boundary (it unscales the accumulated window once), or "
                "clip via optimizer grad_clip which runs after that unscale")
        with torch.no_grad():
            inv = self._scale.reciprocal()
            found = torch.zeros_like(self._found_inf)
            for p in optimizer._parameters():
                g = fold_sparse(p)
                if g is None:
                    continue
                if isinstance(g, SelectedRows):
                    g = g.values
                elif g.is_sparse:
                    raise NotImplementedError(
                        "torch sparse (COO) gradients are not taken: the "
                        "port's sparse gradients are SelectedRows")
                g.mul_(inv.to(g.dtype))
                if _check_finite:
                    found |= ~torch.isfinite(g).all()
            self._found_inf.copy_(found)
        self._unscaled = True

    def _dp_found(self):
        """The flag over the dp group's ranks: an inf on one rank's
        gradients skips the update on every rank."""
        axis = parallel_env.current_dp_axis()
        if axis is None:
            return self._found_inf
        mesh = parallel_env.current_mesh()
        flag = self._found_inf.float()
        collective.all_reduce(flag, group=parallel_env.axis_group(mesh, axis))
        return flag > 0

    def step(self, optimizer):
        if not self._enable:
            optimizer.step()
            return
        acc = parallel_env.current_accum()
        if acc is not None and acc[0] == "accum":
            optimizer.step()  # a micro step: the window's last step updates
            return
        zero = optimizer._zero
        if zero is not None and acc is not None and zero.stage >= 2:
            raise NotImplementedError(
                "GradScaler with ZeRO stage>=2 accumulation windows is not "
                "ported: the window's earlier micro steps are folded into "
                "the sharded accumulator still scaled; use stage<=1")
        if not self._unscaled:
            self.unscale_(optimizer)
        with torch.no_grad():
            found = self._dp_found()
            held = [(t, t.clone()) for t in _state_tensors(optimizer)]
            optimizer.step()
            # check_finite_and_unscale: a step that found an inf keeps the
            # whole state as it was, @step included
            for t, old in held:
                t.copy_(torch.where(found, old, t))
            if zero is not None and zero.stage == 3 \
                    and parallel_env.current_dp_axis() is None:
                zero.refresh_parameters()  # gathered before the selection
            self._update(found)
        self._unscaled = False

    def _update(self, found):
        """The loss-scaling state machine, branch-free."""
        if not self._use_dynamic:
            return
        zero_i = torch.zeros_like(self._bad_steps)
        bad = torch.where(found, self._bad_steps + 1, zero_i)
        good = torch.where(found, zero_i, self._good_steps + 1)
        dec = bad >= self._decr_every
        inc = good >= self._incr_every
        scale = self._scale
        new_scale = torch.where(
            dec, (scale * self._decr_ratio).clamp_min(1.0),
            torch.where(inc, scale * self._incr_ratio, scale))
        self._bad_steps.copy_(torch.where(dec, zero_i, bad))
        self._good_steps.copy_(torch.where(inc, zero_i, good))
        self._scale.copy_(new_scale)

    def update(self):
        pass  # folded into step()

    def minimize(self, optimizer, scaled_loss):
        scaled_loss.backward()
        self.step(optimizer)
        optimizer.clear_grad()

    def state_dict(self):
        return {"scale": self._scale.detach().clone(),
                "incr_ratio": self._incr_ratio,
                "decr_ratio": self._decr_ratio,
                "good_steps": self._good_steps.detach().clone(),
                "bad_steps": self._bad_steps.detach().clone()}

    def load_state_dict(self, state):
        """Load :meth:`state_dict`'s tensors (or numpy arrays) in place."""
        with torch.no_grad():
            for key, t in (("scale", self._scale),
                           ("good_steps", self._good_steps),
                           ("bad_steps", self._bad_steps)):
                t.copy_(torch.as_tensor(state[key]))
            self._found_inf.zero_()
        self._unscaled = False


def _state_tensors(opt):
    """Every tensor an optimizer step writes: the trainable parameters (or
    stage 3's kept buffers), the accumulators (or the fused stores that
    hold them), the ZeRO stores and ``@step``."""
    fused = opt._fused
    out = [opt._step_count, *(fused.stores.values() if fused is not None
                              else opt._accumulators.values())]
    zero = opt._zero
    if zero is None:
        out += [p for p in opt._parameters() if p.requires_grad]
        return out
    for b in zero.buckets:
        out += [t for slot, t in b.stores.items() if slot != "gacc"]
        if zero.stage < 3 or b.kept:
            out.append(b.buffer)  # the parameters, views of it
    return out


AmpScaler = GradScaler
