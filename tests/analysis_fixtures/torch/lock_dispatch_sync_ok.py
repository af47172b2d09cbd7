"""LOCK-DISPATCH (torch key: a host sync) clean samples: the sync runs
with no lock held; an event is recorded (not waited on) under it."""

import threading

import torch


class Reader:
    def __init__(self):
        self._cv = threading.Condition()
        self._out = None
        self._event = None

    def publish(self, out):
        event = torch.cuda.Event()
        event.record()
        with self._cv:
            self._out = out
            self._event = event

    def read(self):
        with self._cv:
            out, event = self._out, self._event
        event.synchronize()
        return out
