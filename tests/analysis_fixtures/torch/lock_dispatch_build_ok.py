"""LOCK-DISPATCH (torch key: a compile or an extension build) clean
samples: the build runs before the lock is taken; only the result is
published under it."""

import threading

from torch.utils import cpp_extension

from client_tpu_torch.ops._build import kernels  # noqa: F401 (fixture only)


class Builder:
    def __init__(self):
        self._lock = threading.Lock()
        self._ext = None

    def extension(self, sources):
        ext = cpp_extension.load("ext", sources)
        with self._lock:
            self._ext = ext
        return ext

    def start(self):
        ext = kernels()
        with self._lock:
            self._ext = ext
