"""LOCK-DISPATCH (torch key: a host sync) bad samples: a sync under the
lock holds it until every queued kernel has run."""

import threading

import torch


class Reader:
    def __init__(self):
        self._cv = threading.Condition()
        self._out = None
        self._stream = torch.cuda.Stream()

    def read(self):
        with self._cv:
            # BAD: the device drains with _cv held
            torch.cuda.synchronize()
            return self._out

    def read_event(self, event):
        with self._cv:
            # BAD: Event.synchronize waits the same way
            event.synchronize()
            return self._out

    def drain_locked(self):
        # BAD: Stream.synchronize in a *_locked method
        self._stream.synchronize()
