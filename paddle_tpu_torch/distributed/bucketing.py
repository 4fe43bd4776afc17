"""Gradient bucket assignment (counterpart:
``paddle_tpu/distributed/bucketing.py``; the reference's ``reducer.cc``
group-size logic behind DataParallel's ``comm_buffer_size``).

One collective per bucket instead of one per parameter. The ZeRO step's
flat per-bucket stores are laid out with exactly these assignments, which
are the reference's for the same parameters.
"""
import math

__all__ = ["bucket_params", "bucket_nbytes", "DEFAULT_COMM_BUFFER_MB"]

DEFAULT_COMM_BUFFER_MB = 25.0  # the reference DataParallel's default


def _param_nbytes(p):
    """Reduction payload of one parameter's gradient: gradients are reduced
    in float32 whatever the parameter's dtype, 4 bytes an element."""
    return math.prod(p.shape) * 4 if p.dim() else 4


def bucket_params(params, comm_buffer_mb=DEFAULT_COMM_BUFFER_MB,
                  last_comm_buffer_mb=None):
    """Greedy in-order assignment of ``params`` into buckets of at most
    ``comm_buffer_mb`` MB of float32 gradient (the last bucket re-split at
    ``last_comm_buffer_mb`` when given). Order is kept: every rank must lay
    its buckets out alike. A parameter larger than the cap gets a bucket of
    its own. Returns a list of non-empty lists of parameters."""
    params = list(params)
    if not params:
        return []
    cap = max(float(comm_buffer_mb), 0.0) * 1024 * 1024
    buckets = [[]]
    fill = 0.0
    for p in params:
        nb = _param_nbytes(p)
        if buckets[-1] and fill + nb > cap:
            buckets.append([])
            fill = 0.0
        buckets[-1].append(p)
        fill += nb
    if last_comm_buffer_mb is not None and len(buckets) > 1:
        last_cap = max(float(last_comm_buffer_mb), 0.0) * 1024 * 1024
        tail = buckets.pop()
        cur, fill = [], 0.0
        for p in tail:
            nb = _param_nbytes(p)
            if cur and fill + nb > last_cap:
                buckets.append(cur)
                cur, fill = [], 0.0
            cur.append(p)
            fill += nb
        if cur:
            buckets.append(cur)
    return buckets


def bucket_nbytes(bucket):
    """Total float32 gradient payload of one bucket."""
    return sum(_param_nbytes(p) for p in bucket)
