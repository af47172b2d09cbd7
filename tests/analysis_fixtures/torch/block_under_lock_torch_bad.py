"""BLOCK-UNDER-LOCK (torch key) bad sample: the interprocedural shape —
a host sync two calls below a ``with self._lock:`` body, which only the
call-graph pass sees (the batcher's program lock over a capture)."""

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
                # BAD: reaches torch.cuda.synchronize with _lock held
                prog = self._build(key)
            return prog

    def _build(self, key):
        prog = object()
        self._drain()
        self._programs[key] = prog
        return prog

    def _drain(self):
        torch.cuda.synchronize()
