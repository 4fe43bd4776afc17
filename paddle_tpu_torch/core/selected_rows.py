"""SelectedRows, the sparse row gradient (counterpart:
``paddle_tpu/core/selected_rows.py``; the reference's
``framework/selected_rows.h``: rows, values, height).

The shapes are static, as on the reference's TPU, so that a sparse step
can be captured into a CUDA graph: ``rows`` (int64 ``[K]``) and
``values`` (``[K, ...]``) keep K, the number of ids looked up, whatever
the duplicates. :meth:`merge_add` sums the values of equal rows with a
sort and a segment sum (``index_add_``): its rows come out sorted and
unique, padded to K with ``height``, whose values are zero. Nothing here
reads a data-dependent size on the host (no ``unique``, ``nonzero``,
``coalesce`` or boolean-mask indexing). On the card ``index_add_`` adds
with atomics; under ``torch.use_deterministic_algorithms`` its sums are
reproducible bit for bit.
"""
import torch

__all__ = ["SelectedRows"]


class SelectedRows:
    """rows: int64 [K]; values: [K, ...] per-row data; height: table rows."""

    def __init__(self, rows, values, height):
        self.rows = torch.as_tensor(rows, dtype=torch.int64,
                                    device=values.device)
        self.values = values
        self.height = int(height)

    @property
    def dtype(self):
        return self.values.dtype

    @property
    def shape(self):
        return (self.height,) + tuple(self.values.shape[1:])

    def astype(self, dtype):
        return SelectedRows(self.rows, self.values.to(dtype), self.height)

    def merge_add(self, other=None):
        """Sum the values of equal rows (the reference's MergeAdd); with
        ``other``, of both. K (rows in) = K (rows out), padded with
        ``height``."""
        rows, vals = self.rows, self.values
        if other is not None:
            if other.height != self.height:
                raise ValueError(f"merge_add: heights {self.height} and "
                                 f"{other.height} differ")
            rows = torch.cat([rows, other.rows])
            vals = torch.cat([vals, other.values.to(vals.dtype)])
        k = rows.shape[0]
        ordered, order = torch.sort(rows, stable=True)
        starts = torch.ones_like(ordered, dtype=torch.bool)
        starts[1:] = ordered[1:] != ordered[:-1]
        seg = torch.cumsum(starts, 0) - 1  # segment of each sorted entry
        # each segment's entries write the same row (index_copy_ has a
        # deterministic kernel; its duplicates carry equal values)
        uniq = torch.full_like(rows, self.height).index_copy_(0, seg, ordered)
        summed = torch.zeros_like(vals).index_add_(
            0, seg, vals.index_select(0, order))
        return SelectedRows(uniq, summed, self.height)

    def to_dense(self):
        """The dense ``[height, ...]`` gradient (padding rows dropped)."""
        out = torch.zeros((self.height + 1,) + tuple(self.values.shape[1:]),
                          dtype=self.values.dtype, device=self.values.device)
        out.index_add_(0, self.rows.clamp(0, self.height), self.values)
        return out[:self.height]

    def __repr__(self):
        return (f"SelectedRows(height={self.height}, "
                f"nnz_rows={self.rows.shape[0]}, "
                f"row_shape={tuple(self.values.shape[1:])})")
