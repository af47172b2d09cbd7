"""BLOCK-UNDER-LOCK (torch key) clean sample: the build (and its host
sync) runs with no lock held; the lock only publishes the result."""

import threading

import torch


class Batcher:
    def __init__(self):
        self._lock = threading.Lock()
        self._programs = {}

    def program(self, key):
        with self._lock:
            prog = self._programs.get(key)
        if prog is None:
            prog = self._build(key)
            with self._lock:
                prog = self._programs.setdefault(key, prog)
        return prog

    def _build(self, key):
        prog = object()
        self._drain()
        return prog

    def _drain(self):
        torch.cuda.synchronize()
