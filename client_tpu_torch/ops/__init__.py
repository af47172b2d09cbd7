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

Every CUDA graph of the port is captured by :func:`capture_graph`: a
warm-up on a side stream, then ``CUDAGraph.capture_begin`` /
``capture_end`` on that stream, with none of ``torch.cuda.graph``'s
device-wide synchronize and cache flushes, which held up every other
thread that allocated while a capture was set up.
"""

import contextlib
import gc
import threading
import time

LAUNCHES = {"int8_matmul": 0, "flash_fwd": 0, "flash_bwd_dq": 0,
            "flash_bwd_dkv": 0, "paged_attention": 0}
# {wrapper: {route: launches}}: the kernel each call went through
ROUTES = {"int8_matmul": {"gemv": 0, "tiled": 0, "mma": 0},
          "paged_attention": {"split": 0, "mma": 0}}
_lock = threading.Lock()
_local = threading.local()  # .record: this thread's recording, if any
_streams = {}  # {CUDA stream handle: recording} of the captures that name one
# CUDA graphs are captured one at a time in a process (the engine's
# programs, the batcher's buckets, the serial, train and vision programs
# alike), so the graphs that share a memory pool are captured in the
# order they replay.  Other threads' CUDA work goes on during a capture
# (thread-local capture mode); only a thread that captures waits here.
# Reentrant: the engine and the batcher hold it around a batch of
# captures, each of which takes it again.
CAPTURE_LOCK = threading.RLock()


class Graph:
    """One captured CUDA graph: ``replay()`` launches it and counts the
    launches its capture recorded."""

    def __init__(self, graph, launches, seconds):
        self.graph = graph        # the torch.cuda.CUDAGraph
        self.launches = launches  # {(kernel, route): launches} a replay
        self.seconds = seconds    # warm-up + capture wall time

    def replay(self):
        self.graph.replay()
        count_replay(self.launches)


def capture_graph(body, warm_up, pool, stream):
    """Record ``body()`` as a CUDA graph in ``pool`` (a graph pool handle,
    or None for a pool of its own) on ``stream``, a side stream of the
    current device, and return its :class:`Graph`.

    ``stream`` waits for the calling thread's current stream, then runs
    ``warm_up()`` unless it is None (the kernels' lazy set-up: cuDNN's
    and cuBLAS's plans, handles and workspaces for ``stream``, the
    allocator's blocks; its launches count nowhere), then records
    ``body()`` between ``capture_begin`` and ``capture_end`` in
    thread-local mode; the current stream then waits for ``stream``.
    Nothing synchronizes the device, collects garbage or empties the
    device or pinned-host cache, so no other thread's work or allocation
    waits on a capture.  Automatic garbage collection is paused from
    ``capture_begin`` to ``capture_end``: a collection there could free a
    dead graph held in a reference cycle, and destroying a graph on the
    thread that captures invalidates the capture (``torch.cuda.graph``
    collects before each capture instead, a pause of its own).  One
    capture at a time in the process (``CAPTURE_LOCK``).  The capture
    itself runs nothing; a failed capture raises."""
    import torch

    main = torch.cuda.current_stream(stream.device)
    t0 = time.monotonic()
    with CAPTURE_LOCK:
        stream.wait_stream(main)
        if warm_up is not None:
            with torch.cuda.stream(stream), recording():
                warm_up()
        graph = torch.cuda.CUDAGraph()
        with recording(stream) as launches, torch.cuda.stream(stream), \
                _collection_paused():
            graph.capture_begin(pool, capture_error_mode="thread_local")
            try:
                body()
            finally:
                graph.capture_end()
        main.wait_stream(stream)
    return Graph(graph, launches, time.monotonic() - t0)


@contextlib.contextmanager
def _collection_paused():
    """No automatic garbage collection in the block (an explicit
    ``gc.collect()`` still runs); the collector's state is restored
    after."""
    enabled = gc.isenabled()
    gc.disable()
    try:
        yield
    finally:
        if enabled:
            gc.enable()


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
