"""Shared device-completion observer for async-dispatch bookkeeping.

Counterpart of client_tpu/serve/_completion.py.  A single daemon thread
per observer waits on watched device results and runs a per-item callback
at completion: the mechanism the dynamic batcher's pipeline backpressure
closes through.  Where JAX blocks on the result arrays
(``jax.block_until_ready``), the port records a ``torch.cuda.Event`` on
the current stream when the result is watched (right after its dispatch)
and waits on that event; one wait per event covers everything the stream
ran before it.  Host-only results (CPU tensors, numpy) settle at once on
the caller thread.
"""

import threading

import torch


def _completion_event(result):
    """A CUDA event after the work that produced *result* (a nested
    dict/list/tuple of tensors), recorded on the current stream of the
    first CUDA tensor's device; None when nothing in it is on CUDA."""
    stack = [result]
    while stack:
        item = stack.pop()
        if isinstance(item, dict):
            stack.extend(item.values())
        elif isinstance(item, (list, tuple)):
            stack.extend(item)
        elif isinstance(item, torch.Tensor) and item.is_cuda:
            event = torch.cuda.Event()
            event.record(torch.cuda.current_stream(item.device))
            return event
    return None


class CompletionObserver:
    def __init__(self, name="completion-observer"):
        self._name = name
        self._cv = threading.Condition()
        self._backlog = []  # (event, callback)
        self._closed = False
        self._thread = None

    def watch(self, result, callback):
        """Run *callback* once the device work behind *result* completed.

        Host results (nothing to wait on) run the callback inline.
        Watches arriving after close() (a batcher thread that outlived its
        bounded shutdown join) wait inline on the caller thread and still
        run the callback, so no semaphore or counter ever leaks.
        """
        event = _completion_event(result)
        if event is None:
            callback()
            return
        with self._cv:
            if not self._closed:
                if self._thread is None:
                    self._thread = threading.Thread(
                        target=self._loop, name=self._name, daemon=True
                    )
                    self._thread.start()
                self._backlog.append((event, callback))
                self._cv.notify()
                return
        self._settle([event])
        callback()

    @staticmethod
    def _settle(events):
        for event in events:
            try:
                event.synchronize()
            except Exception:  # noqa: BLE001 - failed results still complete
                pass

    def _loop(self):
        # one guard per pass: a raising completion callback must not kill
        # the observer thread, or every later watch would leak its
        # semaphore silently
        while True:
            try:
                if not self._drain_once():
                    return
            except Exception:
                pass

    def _drain_once(self):
        """Settle and deliver one backlog batch; False once closed and
        drained.  Each callback is guarded individually so one bad
        callback cannot skip its batch siblings."""
        with self._cv:
            while not self._backlog and not self._closed:
                self._cv.wait()
            if not self._backlog:
                return False
            batch, self._backlog = self._backlog, []
        self._settle([event for event, _ in batch])
        for _, callback in batch:
            try:
                callback()
            except Exception:  # noqa: BLE001 - siblings must still run
                pass
        return True

    def close(self, timeout=30):
        with self._cv:
            self._closed = True
            self._cv.notify_all()
            thread = self._thread
        if thread is not None:
            thread.join(timeout=timeout)
