"""Hand-written Hopper kernels and their plain PyTorch versions.

``LAUNCHES`` counts, per kernel, the launches its wrapper made; a run
resets the counts and reads them back to show which kernels a path went
through.  Launching a kernel is the only thing that increments a count
(the server launches from several threads, hence the lock).  A wrapper
whose binding picks one of several kernels by dtype and shape also counts
the route the binding reports in ``ROUTES`` (one call, one count, however
many kernels the call launches).

A CUDA graph launches its kernels without calling the wrappers, so a
replay would count nothing.  While a thread captures a graph it holds
``recording()``: the wrappers it calls add to the recording instead of
the counts, and every replay adds that recording once through
``count_replay``.  A capture that runs a backward names its stream:
autograd launches the backward's kernels from a thread of its own, on the
forward's stream, and those launches join the recording by that stream.  A graph's launches are counted where it launches them,
at each replay; the warm-up run before a capture records too and is not
counted (it serves no tick).
"""

import contextlib
import threading

LAUNCHES = {"int8_matmul": 0, "flash_fwd": 0, "flash_bwd_dq": 0,
            "flash_bwd_dkv": 0, "paged_attention": 0}
# {wrapper: {route: launches}}: the kernel each call went through
ROUTES = {"int8_matmul": {"gemv": 0, "tiled": 0, "mma": 0},
          "paged_attention": {"split": 0, "mma": 0}}
_lock = threading.Lock()
_local = threading.local()  # .record: this thread's recording, if any
_streams = {}  # {CUDA stream handle: recording} of the captures that name one
# CUDA graphs are captured one at a time in a process (the engine's
# programs and the dynamic batcher's bucket programs alike): captures
# start on whichever thread needs them first
CAPTURE_LOCK = threading.Lock()


def count_launch(name, route=None):
    record = getattr(_local, "record", None)
    if record is None and _streams:
        import torch

        record = _streams.get(torch.cuda.current_stream().cuda_stream)
    with _lock:
        if record is not None:
            record[name, route] = record.get((name, route), 0) + 1
            return
        LAUNCHES[name] += 1
        if route is not None:
            ROUTES[name][route] += 1


@contextlib.contextmanager
def recording(stream=None):
    """Divert this thread's launch counts into a dict ``{(name, route):
    launches}``, yielded, until the block ends (a CUDA graph's capture);
    with ``stream``, every launch any thread makes on that stream too."""
    if getattr(_local, "record", None) is not None:
        raise RuntimeError("launch recordings do not nest")
    _local.record = record = {}
    key = None if stream is None else stream.cuda_stream
    if key is not None:
        with _lock:
            _streams[key] = record
    try:
        yield record
    finally:
        _local.record = None
        if key is not None:
            with _lock:
                _streams.pop(key, None)


def count_replay(record):
    """Count one replay of a graph whose capture recorded ``record``."""
    with _lock:
        for (name, route), n in record.items():
            LAUNCHES[name] += n
            if route is not None:
                ROUTES[name][route] += n


def reset_launches():
    with _lock:
        for name in LAUNCHES:
            LAUNCHES[name] = 0
        for routes in ROUTES.values():
            for route in routes:
                routes[route] = 0
