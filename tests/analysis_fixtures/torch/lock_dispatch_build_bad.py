"""LOCK-DISPATCH (torch key: a compile or an extension build) bad
samples: nvcc and torch.compile under a lock hold every waiter for
seconds to minutes."""

import threading

import torch
from torch.utils import cpp_extension

from client_tpu_torch.ops._build import kernels  # noqa: F401 (fixture only)


class Builder:
    def __init__(self):
        self._lock = threading.Lock()
        self._ext = None
        self._fn = None

    def extension(self, sources):
        with self._lock:
            # BAD: an nvcc build under the lock
            self._ext = cpp_extension.load("ext", sources)
            return self._ext

    def inline(self, src):
        with self._lock:
            # BAD: load_inline builds too
            return torch.utils.cpp_extension.load_inline("ext", src)

    def compiled(self, fn):
        with self._lock:
            # BAD: torch.compile under the lock
            self._fn = torch.compile(fn)
            return self._fn

    def _ensure_locked(self):
        # BAD: the port's kernel build in a *_locked method
        return kernels()
