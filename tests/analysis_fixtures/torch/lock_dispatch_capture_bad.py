"""LOCK-DISPATCH (torch key: a CUDA-graph capture) bad samples: the
engine's first-submit shape — every tick graph captured while the
scheduler's condition is held, so each submit, cancel and stats read
waits through the whole capture."""

import threading

import torch


class Engine:
    def __init__(self, step):
        self._cv = threading.Condition()
        self._step = step
        self._graph = None

    def _capture_locked(self, static):
        graph = torch.cuda.CUDAGraph()
        # BAD: a *_locked method captures (the caller holds _cv)
        with torch.cuda.graph(graph):
            self._step(static)
        return graph

    def start(self, static):
        with self._cv:
            graph = torch.cuda.CUDAGraph()
            # BAD: capture_begin under the scheduler lock
            graph.capture_begin()
            self._step(static)
            graph.capture_end()
            self._graph = graph

    def graphed(self, module, sample):
        with self._cv:
            # BAD: make_graphed_callables captures too
            return torch.cuda.make_graphed_callables(module, (sample,))
