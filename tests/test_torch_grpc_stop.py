"""A gRPC stream the client stops, on the CPU: chip_smoke.py phase 21's
stopped stream, with the client cancelling from the callback that reads
its last token (``InferenceServerClient.cancel_stream``) and the server
cancelling the engine handle as the RPC ends (``StreamCancel`` fired
from ``context.add_callback``).

The port's ``Server(device="cpu", grpc_port=0)`` serves
``lm_streaming_batched`` (float32, ``DEFAULT_LM_CONFIG``'s width and
depth, random weights from a seed) and chip_smoke's own ``stop_runs``
stops its stream after GRPC_STOP_AFTER tokens, GRPC_STOP_RUNS times in a
row, each split by ``StopSplit`` at the client's cancel, the server's
notice and the engine handle's cancel.  Each stop is held to phase 21's
bound: its handle cancelled, its KV blocks back to where they were, at
most GRPC_STOP_AFTER + GRPC_STOP_SLACK tokens made.  The reference's
gRPC tests have no such bound (its server leaves the close to grpcio):
tests/test_torch_grpc.py holds the JAX server to its own.
"""

import os
import sys
import threading
import time

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402
from client_tpu_torch import grpc as grpcclient  # noqa: E402
from client_tpu_torch.serve import Server  # noqa: E402
from client_tpu_torch.serve.model_runtime import (  # noqa: E402
    StreamCancel,
    on_stream_cancel,
)
from client_tpu_torch.serve.models import language  # noqa: E402


@pytest.fixture(scope="module")
def served():
    runner = language._LmRunner(device="cpu")
    model = language.lm_streaming_batched_model(runner=runner)
    split = chip_smoke.StopSplit()
    eng = model.closer.__self__
    with chip_smoke.stop_hooks(split), Server(
            models=[model], grpc_port=0, device="cpu",
            with_default_models=False) as server:
        # the engine starts (its KV pool with it) at its first submit
        q, _ = eng.submit(np.arange(3, 9, dtype=np.int32), 2)
        assert chip_smoke.collect(q, eng.CLOSE, timeout=60)
        yield server, eng, split


def test_stopped_stream_cancels_its_handle_within_the_bound(served):
    server, eng, split = served
    prompt = language.encode_text(chip_smoke.PROMPT)
    cancelled = []
    engine_cancel = eng.cancel
    failed = _failures(server)

    def spy(handle):
        cancelled.append((handle, threading.current_thread().name))
        return engine_cancel(handle)

    eng.cancel = spy
    try:
        stops = chip_smoke.stop_runs(
            grpcclient, server.grpc_address, server, eng, prompt, split,
            chip_smoke.GRPC_STOP_RUNS // 4)
    finally:
        del eng.cancel
    bound = chip_smoke.GRPC_STOP_AFTER + chip_smoke.GRPC_STOP_SLACK
    assert len(stops) == chip_smoke.GRPC_STOP_RUNS // 4
    for stop in stops:
        assert stop["tokens_read"] == chip_smoke.GRPC_STOP_AFTER, stop
        assert stop["blocks_back"], stop
        assert stop["tokens_made"] <= bound, stop
        # the cancel, the notice and the handle's cancel were all marked
        assert stop["cancel_to_notice_s"] >= 0, stop
        assert stop["tokens_after_close"] == 0, stop
    # every stream's handle was cancelled; the first cancel of a handle
    # comes from grpc's own thread as the RPC ends (StreamCancel), not
    # from the handler thread once its next send fails
    first = {}
    for handle, thread in cancelled:
        if handle is not None:
            first.setdefault(id(handle), thread)
    assert len(first) == len(stops)
    assert any(not name.startswith("client_tpu_torch-grpc")
               for name in first.values()), first
    assert eng.kv.used_blocks == 0
    summary = chip_smoke.stop_summary(stops)
    assert summary["within_bound"] == len(stops)
    # a stream its client stopped counts as failed, as before the cancel
    # moved to the RPC's end (the reference counts an abandoned stream
    # so); the handler thread records it as its generator ends, which may
    # come after the blocks are back
    deadline = time.monotonic() + 30
    while (_failures(server) < failed + len(stops)
           and time.monotonic() < deadline):
        time.sleep(0.01)
    assert _failures(server) == failed + len(stops)


def _failures(server):
    stats = server.engine.statistics("lm_streaming_batched")[0]
    return stats["inference_stats"]["fail"]["count"]


def test_stream_cancel_scope():
    """StreamCancel: a cancel registered while the scope is bound runs
    once when the RPC ends, an unregistered one never, one registered
    after the end at once; with no scope bound nothing is registered."""
    ran = []
    assert on_stream_cancel(lambda: ran.append("unbound"))() is None
    scope = StreamCancel()
    with scope.bound():
        keep = on_stream_cancel(lambda: ran.append("kept"))
        drop = on_stream_cancel(lambda: ran.append("dropped"))
    assert on_stream_cancel(lambda: ran.append("outside"))() is None
    drop()
    scope.fire()
    scope.fire()
    assert ran == ["kept"]
    keep()  # after the end: nothing left to unregister
    with scope.bound():
        on_stream_cancel(lambda: ran.append("late"))
    assert ran == ["kept", "late"]


def test_stream_cancel_fires_each_cancel_once_under_contention():
    """Threads register and unregister cancels while another fires the
    scope: every cancel still registered at the end runs exactly once,
    one unregistered first never runs, one registered after the end runs
    at once."""
    scope = StreamCancel()
    runs = {}
    lock = threading.Lock()
    removed = set()

    def count(i):
        with lock:
            runs[i] = runs.get(i, 0) + 1

    def worker(base):
        for j in range(200):
            i = base + j
            remove = scope.add(lambda i=i: count(i))
            if j % 3 == 0:
                remove()
                with lock:
                    removed.add(i)

    was = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=worker, args=(k * 1000,))
                   for k in range(16)]
        for th in threads:
            th.start()
        scope.fire()
        for th in threads:
            th.join(timeout=60)
        assert not any(th.is_alive() for th in threads)
    finally:
        sys.setswitchinterval(was)
    assert all(n == 1 for n in runs.values()), runs
    kept = {k * 1000 + j for k in range(16) for j in range(200)} - removed
    # a cancel removed after the fire had already run it is counted once
    assert kept <= set(runs)



def test_cancel_stream_from_the_callback_ends_the_stream(served):
    """cancel_stream() from the stream's own callback: nothing more
    reaches the callback, stop_stream() afterwards returns at once, and
    the engine gives the stream's blocks back."""
    server, eng, _ = served
    got, more, done = [], [], threading.Event()
    before = set(threading.enumerate())
    client = grpcclient.InferenceServerClient(server.grpc_address)

    def on_response(result, error):
        if done.is_set():
            more.append((result, error))
            return
        assert error is None
        got.append(int(result.as_numpy("TOKEN")[0]))
        if len(got) == 1:
            client.cancel_stream()
            done.set()

    with client:
        client.start_stream(on_response, stream_timeout=60)
        client.async_stream_infer(
            "lm_streaming_batched",
            chip_smoke.grpc_lm_inputs(
                grpcclient, np.arange(3, 9, dtype=np.int32), 200))
        assert done.wait(timeout=60)
        client.stop_stream(cancel_requests=True)
        client.cancel_stream()  # no stream: nothing to cancel
    assert len(got) == 1 and more == []
    deadline = time.monotonic() + 30
    while eng.kv.used_blocks and time.monotonic() < deadline:
        time.sleep(0.01)
    assert eng.kv.used_blocks == 0
    # the stream's threads (its handler and grpc's request thread) end:
    # stop_stream after the response side has ended still closes the
    # request iterator
    while (set(threading.enumerate()) - before
           and time.monotonic() < deadline):
        time.sleep(0.01)
    assert set(threading.enumerate()) - before == set()


def test_stalled_handler_holds_the_engine_to_the_window(served):
    """The server's handler thread stalls as it renders the stream's
    GRPC_STOP_AFTER-th response (the host does not schedule it): the
    engine stops at the served window (``BatchedLmRunner.stream_window``
    tokens unread in the stream's queue), its lane sits the ticks out,
    and once the handler runs again and the client cancels, the stream
    has made at most GRPC_STOP_AFTER + GRPC_STOP_SLACK tokens.  Unwindowed,
    the engine decodes on through the stall.  No reference counterpart."""
    from client_tpu_torch.serve import grpc_server
    from client_tpu_torch.serve.models.continuous import BatchedLmRunner

    server, eng, _ = served
    prompt = language.encode_text(chip_smoke.PROMPT)[:8]
    render = grpc_server._dict_to_response
    gate, stalled, rendered = threading.Event(), threading.Event(), []

    def stalling(*args):
        out = render(*args)
        rendered.append(1)
        if len(rendered) == chip_smoke.GRPC_STOP_AFTER:
            stalled.set()
            assert gate.wait(timeout=60)
        return out

    metric = server.engine.metrics
    base = metric.get("ctpu_lm_tokens_total")
    read = []
    client = threading.Thread(target=lambda: read.extend(
        chip_smoke.grpc_stream(
            grpcclient, server.grpc_address, "lm_streaming_batched", prompt,
            chip_smoke.GRPC_STOP_MAX, stop_after=chip_smoke.GRPC_STOP_AFTER)))
    grpc_server._dict_to_response = stalling
    try:
        client.start()
        assert stalled.wait(timeout=60)
        deadline = time.monotonic() + 60
        while not (any(lane.held for lane in eng._lanes)
                   and not eng._inflight):
            assert time.monotonic() < deadline, "the lane never sat out"
            time.sleep(0.005)
        made = metric.get("ctpu_lm_tokens_total") - base
        # the handler took GRPC_STOP_AFTER; the window waits unread
        assert made == chip_smoke.GRPC_STOP_AFTER + BatchedLmRunner.stream_window
    finally:
        gate.set()
        client.join(timeout=60)
        grpc_server._dict_to_response = render
    assert len(read) == chip_smoke.GRPC_STOP_AFTER
    deadline = time.monotonic() + 30
    while eng.kv.used_blocks and time.monotonic() < deadline:
        time.sleep(0.01)
    assert eng.kv.used_blocks == 0
    made = metric.get("ctpu_lm_tokens_total") - base
    assert made <= chip_smoke.GRPC_STOP_AFTER + chip_smoke.GRPC_STOP_SLACK
