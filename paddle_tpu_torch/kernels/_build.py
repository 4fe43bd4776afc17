"""Build CUDA sources into shared libraries with a plain C interface.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into
``build/lib<name>-<hash>.so`` (the hash covers the source, the shared
headers ``csrc/*.cuh`` and the flags, so an edited source or header
rebuilds) and loaded with ``ctypes``. Several sources
build in parallel, one ``nvcc`` each. ``ptxas``'s register and
shared-memory report for each build is kept beside the library
(``.log``). Building happens on first use, never at import.
"""
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

_lock = threading.Lock()
_libs = {}


def nvcc():
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, else ``nvcc`` on PATH,
    else the toolkit's default install location."""
    home = os.environ.get("CUDA_HOME")
    for cand in ((Path(home) / "bin" / "nvcc") if home else None,
                 shutil.which("nvcc"), Path("/usr/local/cuda/bin/nvcc")):
        if cand and Path(cand).is_file():
            return str(cand)
    raise RuntimeError("nvcc not found; set CUDA_HOME to the CUDA toolkit")


def library_path(name):
    h = hashlib.sha1((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    digest = h.hexdigest()[:12]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build(names):
    """Compile every source of ``names`` that is not built yet, all at
    once; raises with the compiler's output if any build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.monotonic_ns()
    compiler = None
    jobs = []
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        compiler = compiler or nvcc()
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [compiler, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        jobs.append((name, out, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    if not jobs:
        return
    failed = []
    for name, out, tmp, proc in jobs:
        log, _ = proc.communicate()
        out.with_suffix(".log").write_text(log)
        if proc.returncode != 0:
            failed.append(f"{name}: nvcc exited {proc.returncode}\n{log}")
            tmp.unlink(missing_ok=True)
        else:
            # atomic: a concurrent loader never sees half a file
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    # a backend compile: jit_backend_compile_ns / jit_backend_compiles
    from ..observability import tracing
    tracing.record_compile("backend", t0, time.monotonic_ns(),
                           sources=len(jobs))


def load(name):
    """The loaded ``ctypes.CDLL`` of ``csrc/<name>.cu``, built if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build([name])
            lib = _libs[name] = ctypes.CDLL(str(library_path(name)))
        return lib


def build_log(name):
    """``ptxas``'s report from the build of ``name`` (empty if unknown)."""
    log = library_path(name).with_suffix(".log")
    return log.read_text() if log.exists() else ""
