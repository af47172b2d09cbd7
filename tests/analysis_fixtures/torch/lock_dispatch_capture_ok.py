"""LOCK-DISPATCH (torch key: a CUDA-graph capture) clean samples: the
graph is captured with no lock held and installed under the lock; a
replay under the lock is asynchronous and is not a capture."""

import threading

import torch


class Engine:
    def __init__(self, step):
        self._cv = threading.Condition()
        self._step = step
        self._graph = None

    def start(self, static):
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            self._step(static)
        with self._cv:
            self._graph = graph

    def tick(self):
        with self._cv:
            graph = self._graph
            graph.replay()
