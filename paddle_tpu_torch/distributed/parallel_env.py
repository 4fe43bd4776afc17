"""The process and mesh environment (counterpart:
``paddle_tpu/distributed/parallel_env.py``).

One process drives one device and is one rank of a ``torch.distributed``
process group. A mesh (:class:`Mesh`) lays the group's ranks out on named
axes: one data-parallel axis over the whole group (the ZeRO mesh), or the
hybrid axes in the reference's data x pipe x sharding x model order
(``make_mesh({"dp": a, "pp": b, "sharding": c, "mp": d})``), the last axis
the fastest, with one ``new_group`` for every slice of every axis;
:func:`axis_group` is this rank's group on an axis. ``init_parallel_env``
creates the default group: NCCL on the card, gloo only when the caller asks
for the CPU; it never picks a backend by itself.

The step program binds its dp axis (``jit.to_static(..., dp_axis="dp")``)
and the phase of an accumulation window through :class:`dp_axis_ctx` and
:class:`accum_ctx`, which the optimizer consults: inside a bound dp axis the
gradients are reduced over the mesh's group, in an accumulation window's
micro steps the update waits for the window's last step.
"""
import os

import numpy as np
import torch
import torch.distributed as dist

from ..core.device import resolve_device

_mesh = None
# the dp axis of the step program running now, and the accumulation phase
# of its inner step: ("accum" | "fire", window steps). Plain cells: a step
# program runs on one thread.
_dp_axis = [None]
_accum = [None]
_program = [None]


class Mesh:
    """Named axes over the ranks of a ``torch.distributed`` process group.

    ``shape`` maps each axis to its size (in order), ``groups`` each axis to
    this rank's process group on it, ``coords`` each axis to this rank's
    index there, and ``ranks`` is the grid of global ranks (a numpy array of
    ``shape``). ``group`` is the group the whole mesh spans (None: the
    default group)."""

    def __init__(self, axes, groups=None, coords=None, ranks=None,
                 group=None):
        self.axis_names = tuple(axes)
        self.shape = {a: int(n) for a, n in axes.items()}
        self.group = group
        self.groups = dict(groups) if groups else {
            a: group for a in self.axis_names}
        self.coords = dict(coords) if coords else {
            a: (dist.get_rank(group) if dist.is_initialized() else 0)
            for a in self.axis_names}
        self.ranks = ranks

    @property
    def size(self):
        n = 1
        for v in self.shape.values():
            n *= v
        return n

    def __repr__(self):
        return f"Mesh({self.shape})"


def current_mesh():
    return _mesh


def set_mesh(mesh):
    global _mesh
    _mesh = mesh
    return mesh


def current_dp_axis():
    """The dp axis of the step program running now, or None."""
    return _dp_axis[0]


def current_program():
    """The step program (``jit.StaticFunction``) running now, or None."""
    return _program[0]


def current_accum():
    """("accum" | "fire", window steps) of the inner step running now, or
    None outside an accumulation window."""
    return _accum[0]


class _Cell:
    """Bind one value of a module cell for the duration of a block."""

    cell = None

    def __init__(self, value):
        self.value = value
        self._saved = None

    def __enter__(self):
        self._saved = self.cell[0]
        self.cell[0] = self.value
        return self

    def __exit__(self, *exc):
        self.cell[0] = self._saved
        return False


class accum_ctx(_Cell):
    """Bind the accumulation phase of one inner step: "accum" for the
    window's first steps (the update waits, gradients live on), "fire" for
    its last (one update over the window's gradients, scaled 1/steps)."""

    cell = _accum

    def __init__(self, phase, steps):
        if phase not in ("accum", "fire"):
            raise ValueError(f"accumulation phase must be 'accum' or "
                             f"'fire', got {phase!r}")
        super().__init__((phase, int(steps)))


class dp_axis_ctx(_Cell):
    """Bind the step program's dp axis for one inner step."""

    cell = _dp_axis


class program_ctx(_Cell):
    """Bind the step program running one inner step."""

    cell = _program


def axis_bound(axis):
    """True inside a step program whose dp axis is ``axis``: the
    optimizer's collectives then run over the mesh's group."""
    return axis is not None and _dp_axis[0] == axis


def axis_degree(mesh, axis):
    """Size of a mesh axis (1 when the mesh or the axis is absent)."""
    if mesh is None:
        return 1
    return mesh.shape.get(axis, 1)


def axis_group(mesh, axis):
    """This rank's process group on a mesh axis (the default group where a
    one-axis mesh names none)."""
    if mesh is None or axis not in mesh.shape:
        raise ValueError(f"mesh {mesh} has no axis {axis!r}")
    g = mesh.groups.get(axis)
    return g if g is not None else dist.group.WORLD


def axis_rank(mesh, axis):
    """This rank's index on a mesh axis (0 without a mesh or the axis)."""
    if mesh is None or axis not in mesh.shape:
        return 0
    return mesh.coords[axis]


def make_mesh(axes, devices=None, group=None):
    """``{"dp": n}`` -> a one-axis :class:`Mesh` over ``group`` (default:
    the default process group); ``{"dp": a, "pp": b, "sharding": c, "mp":
    d}`` (any names, in order) -> the hybrid mesh over the default group,
    whose ranks lie in C order (the last axis fastest, the reference's
    ``CommunicateTopology``) with one ``new_group`` per slice of each axis,
    made by every rank in the same order. ``-1`` takes what the group's
    size leaves. Raises unless the sizes multiply to the group's size."""
    if devices is not None:
        raise NotImplementedError("a mesh here is a process group: one "
                                  "device per rank, no device list")
    axes = dict(axes)
    if not axes:
        raise ValueError("a mesh needs at least one axis")
    if not dist.is_available() or not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialized process group "
                           "(init_parallel_env)")
    n = dist.get_world_size(group)
    sizes = [int(v) for v in axes.values()]
    if sizes.count(-1) > 1:
        raise ValueError(f"mesh {axes}: at most one axis may be -1")
    if -1 in sizes:
        known = int(np.prod([v for v in sizes if v != -1]))
        sizes[sizes.index(-1)] = n // max(known, 1)
    axes = dict(zip(axes, sizes))
    if int(np.prod(sizes)) != n:
        raise ValueError(f"mesh {axes} needs a process group of "
                         f"{int(np.prod(sizes))} ranks; this one has {n}")
    if len(axes) == 1:
        return Mesh(axes, group=group)
    if group is not None:
        raise NotImplementedError("a hybrid mesh spans the default group")
    grid = np.arange(n).reshape(sizes)
    me = dist.get_rank()
    coords = dict(zip(axes, (int(c) for c in np.unravel_index(me, sizes))))
    groups = {}
    for i, name in enumerate(axes):
        lines = np.moveaxis(grid, i, -1).reshape(-1, sizes[i])
        for line in lines:  # every rank makes every group, in one order
            g = dist.new_group([int(r) for r in line])
            if me in line:
                groups[name] = g
    return Mesh(axes, groups=groups, coords=coords, ranks=grid)


def init_parallel_env(device=None, init_method=None, world_size=None,
                      rank=None):
    """Create the default process group (once): NCCL for ``cuda`` (the
    default device), gloo for ``device="cpu"``. ``world_size``, ``rank``
    and ``init_method`` default to the reference launcher's environment
    (``PADDLE_TRAINER_ENDPOINTS``, ``PADDLE_TRAINER_ID``: the first
    endpoint is the rendezvous); a world of one needs none of them.
    Returns the :class:`ParallelEnv`."""
    if dist.is_initialized():
        return ParallelEnv()
    device = resolve_device(device)
    endpoints = os.environ.get("PADDLE_TRAINER_ENDPOINTS", "").split(",")
    endpoints = [e for e in endpoints if e]
    if world_size is None:
        world_size = max(len(endpoints), 1)
    if rank is None:
        rank = int(os.environ.get("PADDLE_TRAINER_ID", 0))
    if init_method is None:
        if endpoints:
            init_method = f"tcp://{endpoints[0]}"
        elif int(world_size) == 1:
            init_method = f"tcp://localhost:{_free_port()}"
        else:
            raise ValueError("init_parallel_env needs an init_method (or "
                             "the launcher's PADDLE_TRAINER_ENDPOINTS) for "
                             f"a world of {world_size}")
    kwargs = {}
    if device.type == "cuda":
        torch.cuda.set_device(device)
        kwargs["device_id"] = device
    dist.init_process_group("nccl" if device.type == "cuda" else "gloo",
                            init_method=init_method,
                            world_size=int(world_size), rank=int(rank),
                            **kwargs)
    return ParallelEnv()


def _free_port():
    import socket
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


class ParallelEnv:
    """The reference's ``ParallelEnv``: this process's rank and the world's
    size."""

    @property
    def rank(self):
        return get_rank()

    @property
    def world_size(self):
        return get_world_size()

    @property
    def device_id(self):
        return torch.cuda.current_device() if torch.cuda.is_available() else 0

    local_rank = rank
    nranks = world_size


def get_rank():
    return dist.get_rank() if dist.is_initialized() else 0


def get_world_size():
    return dist.get_world_size() if dist.is_initialized() else 1
