"""The native parameter-server service, bound through ctypes (counterpart:
``paddle_tpu/_native/__init__.py``, the ``pt_ps_*`` half).

``src/ps_service.cc`` is a copy of the JAX package's service: the same
tables, server-side rules and wire format. Its one outside symbol,
``pt_prof_now_ns``, comes from ``src/pt_clock.cc`` (``CLOCK_MONOTONIC``
nanoseconds, the base of ``profiler._now_ns()``). :func:`lib` builds both
with ``g++ -O3 -shared -fPIC -std=c++17 -pthread`` at first use into
``build/libpaddle_tpu_torch_ps-<hash>.so`` (the hash covers the sources
and the command, so an edited source rebuilds and a stale library is never
loaded) and loads it with ``RTLD_LOCAL``: this library and the JAX
package's, in one process, each resolve their own ``pt_ps_*`` and
``pt_prof_now_ns`` and each hold their own server. Importing the package
builds nothing.

There is no fallback: a failed build raises :class:`NativeBuildError`
with the compiler's output, and everything that needs the service raises
with it.
"""
import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRCS = [os.path.join(_HERE, "src", "ps_service.cc"),
         os.path.join(_HERE, "src", "pt_clock.cc")]
BUILD_DIR = os.path.join(_HERE, "build")
_CMD = ["g++", "-O3", "-shared", "-fPIC", "-std=c++17", "-pthread",
        "-fvisibility=hidden", "-Wl,-Bsymbolic"]

_lib = None
_lock = threading.Lock()
build_seconds = None  # wall time of this process's build, None if cached


class NativeBuildError(RuntimeError):
    """The PS service did not build or load; the message holds the
    compiler's output."""


def _digest():
    h = hashlib.sha256(" ".join(_CMD).encode())
    for src in _SRCS:
        with open(src, "rb") as f:
            h.update(f.read())
    return h.hexdigest()[:16]


def library_path():
    """Where the library of the current sources is (or will be) built."""
    return os.path.join(BUILD_DIR, f"libpaddle_tpu_torch_ps-{_digest()}.so")


def _build(path):
    import time
    global build_seconds
    os.makedirs(BUILD_DIR, exist_ok=True)
    # a private temporary name, then an atomic rename: concurrent first
    # uses (spawned ranks, test workers) never load a half-written file
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    t0 = time.perf_counter()
    try:
        try:
            r = subprocess.run([*_CMD, "-o", tmp, *_SRCS, "-lrt"],
                               capture_output=True, text=True)
        except OSError as e:
            raise NativeBuildError(
                f"cannot run g++ to build the PS service: {e}") from e
        if r.returncode != 0:
            raise NativeBuildError(
                f"g++ failed (exit {r.returncode}) building the PS service "
                f"from {_SRCS}:\n{r.stdout}{r.stderr}")
        os.chmod(tmp, 0o755)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    build_seconds = time.perf_counter() - t0


_SIGS = None


def _bind(lib):
    c = ctypes
    I, CP = c.c_int, c.c_char_p
    sigs = {
        "pt_prof_now_ns": (c.c_longlong, []),
        "pt_ps_reset": (None, []),
        "pt_ps_add_dense": (None, [c.c_uint32, I, I, c.c_float, c.c_float,
                                   c.c_float, c.c_float]),
        "pt_ps_add_sparse": (None, [c.c_uint32, I, I, c.c_float, c.c_float,
                                    c.c_float, c.c_float, c.c_float,
                                    c.c_uint64]),
        "pt_ps_add_graph": (None, [c.c_uint32, I]),
        "pt_ps_sparse_spill": (None, [c.c_uint32, c.c_uint64, CP]),
        "pt_ps_start": (I, [I]),
        "pt_ps_stop": (None, []),
        "pt_ps_port": (I, []),
        "pt_ps_running": (I, []),
        "pt_ps_dup_requests": (c.c_longlong, []),
        "pt_ps_stats_json": (I, [CP, I]),
        "pt_ps_trace_json": (I, [CP, I, I]),
    }
    for name, (res, args) in sigs.items():
        fn = getattr(lib, name)
        fn.restype = res
        fn.argtypes = args
    return lib


def lib():
    """The bound service library, built on first use; raises
    :class:`NativeBuildError` when it cannot be built or loaded."""
    global _lib
    with _lock:
        if _lib is None:
            path = library_path()
            if not os.path.exists(path):
                _build(path)
            try:
                handle = ctypes.CDLL(path, mode=os.RTLD_LOCAL)
            except OSError as e:
                raise NativeBuildError(
                    f"cannot load the PS service {path}: {e}") from e
            _lib = _bind(handle)
        return _lib


def loaded():
    """True once :func:`lib` has loaded the library in this process."""
    return _lib is not None
