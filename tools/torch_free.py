#!/usr/bin/env python3
"""Run a Python module, script or code string with torch blocked, and
time its start.

    python3 tools/torch_free.py [--with-torch] -m MODULE [ARGS...]
    python3 tools/torch_free.py [--with-torch] -c CODE [ARGS...]
    python3 tools/torch_free.py [--with-torch] SCRIPT [ARGS...]

``sys.modules["torch"]`` is set to None before anything else is
imported, so any ``import torch`` in the process raises
``ModuleNotFoundError``: a process that runs to its end this way never
needed torch.  ``--with-torch`` leaves torch importable and only times
the start, for a comparison.

The process prints one line on standard error, at its first request (its
first socket connect, or its first gRPC channel: grpc connects from C),
or at exit if it made none:

    torch_free: {"pid": ..., "torch_loaded": false, "start_s": ...,
                 "first": "connect" | "grpc_channel" | null}

``start_s`` counts from ``TORCH_FREE_SPAWN_T`` in the environment (the
parent's ``time.time()`` just before it started the process), else from
this script's own start.  The target runs in this process (``runpy``),
so its pid, arguments and exit code are the process's own.
"""

import sys

_BLOCK = "--with-torch" not in sys.argv[1:2]
if _BLOCK:
    sys.modules["torch"] = None

import atexit  # noqa: E402
import importlib.abc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import runpy  # noqa: E402
import threading  # noqa: E402
import time  # noqa: E402

_T0 = float(os.environ.get("TORCH_FREE_SPAWN_T") or time.time())
_SEEN = []
_LOCK = threading.Lock()
PREFIX = "torch_free: "


def _report(first):
    with _LOCK:
        if _SEEN:
            return
        _SEEN.append(first)
    start = None if first is None else time.time() - _T0
    print(PREFIX + json.dumps({
        "pid": os.getpid(),
        "torch_loaded": sys.modules.get("torch") is not None,
        "start_s": start, "first": first}), file=sys.stderr, flush=True)


def _audit(event, args):
    if event == "socket.connect" and not _SEEN:
        _report("connect")


def _noting(make_channel):
    def wrapper(*args, **kwargs):
        _report("grpc_channel")
        return make_channel(*args, **kwargs)
    return wrapper


class _ChannelSpy(importlib.abc.MetaPathFinder):
    """Wraps ``insecure_channel`` and ``secure_channel`` of ``grpc`` and
    ``grpc.aio`` as each module loads, so that neither is imported here
    unless the target imports it."""

    NAMES = ("grpc", "grpc.aio")

    def find_spec(self, name, path=None, target=None):
        if name not in self.NAMES:
            return None
        for finder in sys.meta_path:
            if finder is self or not hasattr(finder, "find_spec"):
                continue
            spec = finder.find_spec(name, path, target)
            if spec is not None:
                break
        else:
            return None
        run = spec.loader.exec_module

        def exec_module(module):
            run(module)
            for fn in ("insecure_channel", "secure_channel"):
                if hasattr(module, fn):
                    setattr(module, fn, _noting(getattr(module, fn)))

        spec.loader.exec_module = exec_module
        return spec


def main(argv):
    if argv[:1] == ["--with-torch"]:
        argv = argv[1:]
    if not argv:
        sys.exit(__doc__)
    sys.addaudithook(_audit)
    sys.meta_path.insert(0, _ChannelSpy())
    atexit.register(_report, None)
    if argv[0] == "-m":
        sys.argv = [argv[1], *argv[2:]]
        sys.path[0] = os.getcwd()
        runpy.run_module(argv[1], run_name="__main__", alter_sys=True)
    elif argv[0] == "-c":
        sys.argv = ["-c", *argv[2:]]
        sys.path[0] = ""
        exec(compile(argv[1], "<string>", "exec"), {"__name__": "__main__"})
    else:
        sys.argv = list(argv)
        sys.path[0] = os.path.dirname(os.path.abspath(argv[0]))
        runpy.run_path(argv[0], run_name="__main__")


if __name__ == "__main__":
    main(sys.argv[1:])
