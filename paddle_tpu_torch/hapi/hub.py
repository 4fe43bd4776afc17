"""torch.hub-style loading of models (counterpart: ``paddle_tpu/hapi/hub.py``).

Only ``source="local"`` is supported: a directory that holds a
``hubconf.py``, whose public callables are the entry points. Nothing is
downloaded, so the ``github`` and ``gitee`` sources raise, as in the
reference. A hubconf's ``dependencies`` must be importable.
"""
import importlib.util
import os
import sys

MODULE_HUBCONF = "hubconf.py"


def _import_hubconf(repo_dir):
    path = os.path.join(repo_dir, MODULE_HUBCONF)
    if not os.path.exists(path):
        raise FileNotFoundError(f"no {MODULE_HUBCONF} found in {repo_dir!r}")
    spec = importlib.util.spec_from_file_location("hubconf", path)
    m = importlib.util.module_from_spec(spec)
    sys.path.insert(0, repo_dir)
    try:
        spec.loader.exec_module(m)
    finally:
        sys.path.remove(repo_dir)
    deps = getattr(m, "dependencies", [])
    missing = [d for d in deps if importlib.util.find_spec(d) is None]
    if missing:
        raise RuntimeError(f"hubconf dependencies missing: {missing}")
    return m


def _resolve(repo_dir, source):
    if source != "local":
        raise RuntimeError(
            "only source='local' is supported: the github and gitee "
            "sources download an archive, and nothing is downloaded")
    return repo_dir


def _entry(repo_dir, model, source):
    m = _import_hubconf(_resolve(repo_dir, source))
    fn = getattr(m, model, None)
    if fn is None or not callable(fn):
        raise RuntimeError(f"no callable entry point {model!r} in hubconf")
    return fn


def list(repo_dir, source="local", force_reload=False):  # noqa: A001
    """The entry points' names that the repo's ``hubconf.py`` exports."""
    m = _import_hubconf(_resolve(repo_dir, source))
    return [k for k, v in vars(m).items()
            if callable(v) and not k.startswith("_")]


def help(repo_dir, model, source="local", force_reload=False):  # noqa: A001
    """The entry point's docstring."""
    return _entry(repo_dir, model, source).__doc__


def load(repo_dir, model, source="local", force_reload=False, **kwargs):
    """The entry point called with ``kwargs``."""
    return _entry(repo_dir, model, source)(**kwargs)
