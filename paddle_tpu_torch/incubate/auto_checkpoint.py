"""Auto-checkpoint (counterpart: ``paddle_tpu/incubate/auto_checkpoint.py``;
``TrainEpochRange``, ``train_epoch_range``).

Epoch loops with a save at each epoch's end and a resume at the start,
keyed by the job id, on the checkpoint core (``paddle_tpu_torch.checkpoint``):
each epoch's save is one atomically published ``step_<epoch>/`` directory,
a restore accepts only a checkpoint that validates, and the save interval
(``checkpoint_inter``) counts only saves that landed.
"""
import os
import time

from .. import checkpoint as _ckpt
from ..distributed.fleet.utils.fs import LocalFS

__all__ = ["TrainEpochRange", "train_epoch_range", "get_checkpoint_dir"]


def get_checkpoint_dir():
    return os.environ.get("PADDLE_AUTO_CHECKPOINT_DIR",
                          "./auto_checkpoint")


class TrainEpochRange:
    """Iterate epochs with a save at each epoch's end and a resume at the
    start: models, optimizers, scalers and the random generators in one
    atomic checkpoint an epoch, the last ``keep_last_n`` kept."""

    def __init__(self, max_epoch_num, name, checkpoint_inter=None,
                 save_checkpoint=True, fs=None, keep_last_n=2):
        self.max_epoch_num = max_epoch_num
        self.name = name
        self.save_checkpoint = save_checkpoint
        self.checkpoint_inter = checkpoint_inter  # seconds between saves
        self._last_save = 0.0
        self._fs = fs or LocalFS()
        job_id = os.environ.get("PADDLE_JOB_ID", "job_default")
        self._dir = os.path.join(get_checkpoint_dir(), job_id, name)
        self._mgr = _ckpt.CheckpointManager(self._dir, fs=self._fs,
                                            keep_last_n=keep_last_n)
        self.restored_from = None
        self._start_epoch = 0
        self._load_meta()

    # -- registration -------------------------------------------------------
    def add_model(self, model, name="model"):
        self._mgr.add_model(model, name)
        return self

    def add_optimizer(self, optimizer, name="opt"):
        self._mgr.add_optimizer(optimizer, name)
        return self

    def add_scaler(self, scaler, name="scaler"):
        self._mgr.add_scaler(scaler, name)
        return self

    # -- persistence --------------------------------------------------------
    def _load_meta(self):
        """A manifest-only peek (no payload read or hashed: a checkpoint of
        gigabytes is not read twice at start-up). The restore in get()
        gives the authoritative epoch; this primes the loop bounds."""
        found = _ckpt.core.peek_meta(self._dir, fs=self._fs)
        if found is None:
            return
        _step, meta = found
        self._start_epoch = int(meta.get("next_epoch", 0))
        self.restored_from = meta.get("saved_at_epoch")

    def _restore_states(self):
        """One full validated restore; re-anchor the resume epoch on the
        checkpoint that actually restored (the peeked newest one may
        have failed payload validation and been skipped)."""
        meta = self._mgr.restore(strict=False)
        if meta is None:
            self._start_epoch = 0
            self.restored_from = None
        else:
            self._start_epoch = int(meta.get("next_epoch",
                                             self._start_epoch))
            self.restored_from = meta.get("saved_at_epoch",
                                          self.restored_from)

    def _save(self, epoch):
        if not self.save_checkpoint:
            return
        if (self.checkpoint_inter is not None
                and time.time() - self._last_save < self.checkpoint_inter
                and epoch + 1 < self.max_epoch_num):
            return
        self._mgr.save(epoch, extra_meta={"next_epoch": epoch + 1,
                                          "saved_at_epoch": epoch})
        # stamped only AFTER the atomic publish: a failed/interrupted
        # save must not eat the next interval's retry
        self._last_save = time.time()

    # -- iteration ----------------------------------------------------------
    def get(self):
        """Yield remaining epoch indices; save state after each completes."""
        if self._start_epoch > 0:
            self._restore_states()
        for epoch in range(self._start_epoch, self.max_epoch_num):
            yield epoch
            self._save(epoch)

    def __iter__(self):
        return self.get()


def train_epoch_range(max_epoch_num, name="auto_checkpoint", **kw):
    """The functional form of :class:`TrainEpochRange`."""
    return TrainEpochRange(max_epoch_num, name, **kw)
