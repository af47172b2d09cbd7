"""The port's dynamic batcher (client_tpu_torch.serve.dynamic_batcher)
held against client_tpu.serve.dynamic_batcher: the cases of
tests/test_dynamic_batcher.py on the port's engine, on the CPU.

Device groups are groups of tensors (the port's device arrays; CPU
tensors here).  A ``fused_batching`` model runs each group through its
bucket's program, whose static outputs every run overwrites, on the CPU
as on the card; the back-to-back cases show each request keeps its own
rows.  Values are exact (the echo model doubles its input).
"""

import sys
import threading
import time

import numpy as np
import pytest
import torch

from client_tpu.serve import dynamic_batcher as jbatcher
from client_tpu_torch.serve.dynamic_batcher import (
    ModelBatcher,
    _bucket,
    _buckets_up_to,
    batchable_request,
)
from client_tpu_torch.serve.model_runtime import (
    InferenceEngine,
    Model,
    TensorSpec,
)
from client_tpu_torch.utils import InferenceServerException, to_wire_bytes


def _echo_model(record, name="echo2x", **kwargs):
    """Model that doubles its input and records every executed batch size
    (numpy in the wire path, tensors in device and fused groups)."""

    def fn(inputs, params, ctx):
        record.append(int(inputs["IN"].shape[0]))
        return {"OUT": inputs["IN"] * 2.0}

    defaults = dict(
        max_batch_size=8,
        dynamic_batching=True,
        max_queue_delay_us=20000,
    )
    defaults.update(kwargs)
    return Model(
        name,
        inputs=[TensorSpec("IN", "FP32", [-1, 4])],
        outputs=[TensorSpec("OUT", "FP32", [-1, 4])],
        fn=fn,
        **defaults,
    )


def _fused_model(record, **kwargs):
    return _echo_model(record, batch_device_inputs=True, fused_batching=True,
                       platform="torch", backend="torch", device="cpu",
                       **kwargs)


def _request(arr, shm_output=None):
    raw = to_wire_bytes(arr, "FP32")
    req = {
        "id": "",
        "parameters": {},
        "inputs": [
            {
                "name": "IN",
                "datatype": "FP32",
                "shape": list(arr.shape),
                "parameters": {"binary_data_size": len(raw)},
            }
        ],
        "outputs": [{"name": "OUT", "parameters": {"binary_data": True}}],
    }
    if shm_output:
        req["outputs"][0]["parameters"] = {
            "shared_memory_region": shm_output,
            "shared_memory_byte_size": arr.nbytes,
        }
    return req, raw


class _Stats:
    def __init__(self, record):
        self.record = record

    def record_batched(self, **kw):
        self.record.append(("batched", kw["rows"]))


def _concurrently(n, fn):
    barrier = threading.Barrier(n)
    errors = []

    def run(i):
        barrier.wait()
        try:
            fn(i)
        except Exception as e:  # pragma: no cover - surfaced below
            errors.append(e)

    threads = [threading.Thread(target=run, args=(i,)) for i in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errors, errors


def _hold_first_forward(model):
    """Make the model's first forward wait until released.  The batcher
    dispatches an idle pipeline's first request at once, and on the CPU a
    group completes at once, so without a hold whether requests fuse
    depends on timing; with it, the requests that arrive during the hold
    queue up and fuse into the next group."""
    entered, release = threading.Event(), threading.Event()
    inner = model.fn

    def fn(inputs, params, ctx):
        if not entered.is_set():  # only the batcher thread calls fn
            entered.set()
            assert release.wait(30)
        return inner(inputs, params, ctx)

    model.fn = fn
    return entered, release


def _fused_run(n, fn, queue_depth, entered, release):
    """fn(i) for i in range(n), each on a thread: the first alone until
    its forward holds, the other n - 1 while it holds (all queued), then
    the release.  The n - 1 fuse into one group."""
    errors = []

    def run(i):
        try:
            fn(i)
        except Exception as e:  # pragma: no cover - surfaced below
            errors.append(e)

    threads = [threading.Thread(target=run, args=(i,)) for i in range(n)]
    threads[0].start()
    assert entered.wait(30)
    for t in threads[1:]:
        t.start()
    for _ in range(3000):
        if queue_depth() == n - 1:
            break
        threading.Event().wait(0.01)
    assert queue_depth() == n - 1
    release.set()
    for t in threads:
        t.join(timeout=30)
    assert not any(t.is_alive() for t in threads)
    assert not errors, errors


def test_bucket_shapes():
    """``_bucket`` / ``_buckets_up_to`` equal the reference's."""
    assert [_bucket(n, 64) for n in (1, 2, 3, 5, 7, 9, 13, 20, 40, 50)] == [
        1, 2, 3, 6, 8, 12, 16, 24, 48, 64,
    ]
    assert _bucket(100, 64) == 64
    buckets = _buckets_up_to(64)
    assert buckets == [1, 2, 3, 4, 6, 8, 12, 16, 24, 32, 48, 64]
    for cap in (1, 2, 7, 8, 32, 64, 100):
        assert _buckets_up_to(cap) == jbatcher._buckets_up_to(cap)
        for n in range(1, cap + 1):
            assert _bucket(n, cap) == jbatcher._bucket(n, cap)
            assert _bucket(n, cap) in _buckets_up_to(cap)


@pytest.mark.parametrize("fused", [False, True])
def test_concurrent_requests_fuse_and_split_correctly(fused):
    record = []
    model = _fused_model(record) if fused else _echo_model(record)
    entered, release = _hold_first_forward(model)
    engine = InferenceEngine(models=[model])
    n_threads = 8
    arrays = [
        np.full((1, 4), float(i), dtype=np.float32) for i in range(n_threads)
    ]
    results = [None] * n_threads

    def run(i):
        req, raw = _request(arrays[i])
        response, blobs = engine.execute("echo2x", "", req, raw)
        results[i] = np.frombuffer(blobs[0], dtype=np.float32).reshape(1, 4)

    _fused_run(n_threads, run,
               lambda: engine._batchers["echo2x"].queue_depth(),
               entered, release)
    for i in range(n_threads):
        np.testing.assert_array_equal(results[i], arrays[i] * 2.0)
    # the first request alone, the 7 queued behind it fused: 1 + 8 rows
    # (7 padded to the bucket of 8)
    assert record == [1, 8]
    for b in record:
        assert b in _buckets_up_to(8)
    stats = engine.statistics("echo2x")[0]
    assert stats["inference_stats"]["success"]["count"] == n_threads
    # executions apart from inferences: 8 rows over fewer forward passes
    assert stats["inference_count"] == n_threads
    assert stats["execution_count"] == len(record)
    engine.close()


def test_batched_model_response_parameters_replicate():
    """A batched model's reserved "__parameters__" result key is
    batch-wide: the split replicates it to every request."""
    record = []

    def fn(inputs, params, ctx):
        record.append(int(inputs["IN"].shape[0]))
        return {
            "OUT": inputs["IN"] * 2.0,
            "__parameters__": {"engine_pass": 1, "batched": True},
        }

    model = Model(
        "echo2x",
        inputs=[TensorSpec("IN", "FP32", [-1, 4])],
        outputs=[TensorSpec("OUT", "FP32", [-1, 4])],
        fn=fn,
        max_batch_size=8,
        dynamic_batching=True,
        max_queue_delay_us=20000,
    )
    engine = InferenceEngine(models=[model])
    n = 4
    arrays = [np.full((1, 4), float(i), dtype=np.float32) for i in range(n)]
    outs = [None] * n

    def run(i):
        req, raw = _request(arrays[i])
        outs[i] = engine.execute("echo2x", "", req, raw)

    _concurrently(n, run)
    for i, (response, blobs) in enumerate(outs):
        got = np.frombuffer(blobs[0], dtype=np.float32).reshape(1, 4)
        np.testing.assert_array_equal(got, arrays[i] * 2.0)
        assert [o["name"] for o in response["outputs"]] == ["OUT"]
    engine.close()


def test_bucket_program_drops_response_parameters():
    """A fused model's program replays no python, so a "__parameters__"
    dict is dropped (the reference's fused splitter does the same)."""
    def fn(inputs, params, ctx):
        return {"OUT": inputs["IN"] * 2.0, "__parameters__": {"n": 1}}

    model = _fused_model([])
    model.fn = fn
    batcher = ModelBatcher(model, _Stats([]), max_queue_delay_s=0.0)
    try:
        out = batcher.submit({"IN": torch.full((1, 4), 2.0)})
        assert set(out) == {"OUT"}
        torch.testing.assert_close(out["OUT"], torch.full((1, 4), 4.0))
    finally:
        batcher.close()


def test_multi_row_requests_batch():
    for model in (_echo_model([]), _fused_model([])):
        engine = InferenceEngine(models=[model])
        arr = np.arange(12, dtype=np.float32).reshape(3, 4)
        req, raw = _request(arr)
        response, blobs = engine.execute("echo2x", "", req, raw)
        out = np.frombuffer(blobs[0], dtype=np.float32).reshape(3, 4)
        np.testing.assert_array_equal(out, arr * 2.0)
        assert response["outputs"][0]["shape"] == [3, 4]
        engine.close()


def test_oversize_request_takes_direct_path():
    record = []
    engine = InferenceEngine(models=[_echo_model(record)])
    arr = np.zeros((9, 4), dtype=np.float32)  # > max_batch_size=8
    req, raw = _request(arr)
    response, blobs = engine.execute("echo2x", "", req, raw)
    assert np.frombuffer(blobs[0], dtype=np.float32).size == 36
    assert record == [9]  # executed unbatched, unpadded
    engine.close()


def test_shm_output_bypasses_batcher():
    model = _echo_model([])
    arr = np.zeros((1, 4), dtype=np.float32)
    req, _ = _request(arr, shm_output="region0")
    assert not batchable_request(model, {"IN": arr}, {}, None, req)


def test_sequence_and_other_inputs_bypass_batcher():
    model = _echo_model([])
    arr = np.zeros((1, 4), dtype=np.float32)
    req, _ = _request(arr)
    assert not batchable_request(
        model, {"IN": arr}, {"sequence_id": 7}, None, req
    )

    class NotATensor:
        ndim = 2
        shape = (1, 4)

    assert not batchable_request(model, {"IN": NotATensor()}, {}, None, req)
    # a tensor input skips batching unless the model opts in
    assert not batchable_request(model, {"IN": torch.zeros(1, 4)}, {}, None,
                                 req)
    # plain numpy wire request IS batchable
    assert batchable_request(model, {"IN": arr}, {}, None, req)


def test_request_parameters_bypass_batcher():
    model = _echo_model([])
    arr = np.zeros((1, 4), dtype=np.float32)
    req, _ = _request(arr)
    # a custom parameter must reach model.fn, so it takes the direct path
    assert not batchable_request(model, {"IN": arr}, {"top_k": 5}, None, req)
    assert batchable_request(
        model, {"IN": arr}, {"binary_data_output": True}, None, req
    )


def test_device_request_batchable_and_mixed_rejected():
    model = _echo_model([], batch_device_inputs=True)
    req_shm_out = {"outputs": [{"name": "OUT", "parameters": {
        "shared_memory_region": "r", "shared_memory_byte_size": 16}}]}
    dev = torch.zeros((1, 4))
    host = np.zeros((1, 4), dtype=np.float32)
    assert batchable_request(model, {"IN": dev}, {}, None, req_shm_out)
    assert not batchable_request(
        _echo_model([]), {"IN": dev}, {}, None, req_shm_out
    )
    assert not batchable_request(model, {"IN": host}, {}, None, req_shm_out)
    model2 = Model(
        "echo2",
        inputs=[TensorSpec("A", "FP32", [-1, 4]),
                TensorSpec("B", "FP32", [-1, 4])],
        outputs=[TensorSpec("OUT", "FP32", [-1, 4])],
        fn=lambda i, p, c: {"OUT": i["A"]},
        max_batch_size=8,
        dynamic_batching=True,
    )
    assert not batchable_request(
        model2, {"A": dev, "B": host}, {}, None, {"outputs": []}
    )


def test_device_requests_fuse_on_device():
    """Device-tensor requests of an unfused model batch on the device path:
    one forward on a zero-padded bucket buffer, each output a row view."""
    record = []
    model = _echo_model(record, batch_device_inputs=True)
    entered, release = _hold_first_forward(model)
    batcher = ModelBatcher(model, _Stats(record), max_queue_delay_s=0.05)
    results = [None] * 4
    try:
        def run(i):
            results[i] = batcher.submit(
                {"IN": torch.full((1, 4), float(i + 1))})

        _fused_run(4, run, batcher.queue_depth, entered, release)
        for i, res in enumerate(results):
            assert isinstance(res["OUT"], torch.Tensor)
            torch.testing.assert_close(
                res["OUT"], torch.full((1, 4), 2.0 * (i + 1)))
        rows = [r[1] for r in record if isinstance(r, tuple)]
        assert rows == [1, 3]  # the 3 queued requests fused
    finally:
        batcher.close()


def _shm_request(in_region, out_region, offset=0):
    """One [1, 4] FP32 request with input and output in regions."""
    return {
        "id": "",
        "parameters": {},
        "inputs": [{"name": "IN", "datatype": "FP32", "shape": [1, 4],
                    "parameters": {"shared_memory_region": in_region,
                                   "shared_memory_offset": offset,
                                   "shared_memory_byte_size": 16}}],
        "outputs": [{"name": "OUT", "parameters": {
            "shared_memory_region": out_region,
            "shared_memory_offset": offset,
            "shared_memory_byte_size": 16}}],
    }


@pytest.mark.parametrize("fused", [False, True])
def test_device_requests_fuse_on_device_with_shm_outputs(fused):
    """CUDA-shm requests (inputs views of their regions, outputs written
    to regions) batch on the device path: fewer executions than requests,
    each output in its own region (the JAX test of the same name, with
    the port's CPU regions in place of TPU ones)."""
    from client_tpu_torch.utils import cuda_shared_memory as cudashm

    record = []
    model = (_fused_model(record) if fused
             else _echo_model(record, batch_device_inputs=True))
    entered, release = _hold_first_forward(model)
    engine = InferenceEngine(models=[model])
    n = 4
    h_in = cudashm.create_shared_memory_region("dev_in", 16 * n,
                                               device="cpu")
    h_out = cudashm.create_shared_memory_region("dev_out", 16 * n,
                                                device="cpu")
    try:
        cudashm.set_shared_memory_region(h_in, [
            np.full((1, 4), float(i + 1), dtype=np.float32)
            for i in range(n)])
        for name, h in (("dev_in", h_in), ("dev_out", h_out)):
            engine.shm.register_cuda(name, cudashm.get_raw_handle(h), 0,
                                     16 * n)
        _fused_run(
            n, lambda i: engine.execute(
                "echo2x", "", _shm_request("dev_in", "dev_out", 16 * i), b""),
            engine._batcher_for(model).queue_depth, entered, release)
        # fewer executions than requests proves device-side fusion
        assert len(record) < n
        stats = engine.statistics("echo2x")[0]
        assert stats["inference_count"] == n
        assert stats["execution_count"] == 2
        got = cudashm.get_contents_as_numpy(h_out, np.float32, [n, 4])
        np.testing.assert_array_equal(
            got, 2.0 * np.arange(1, n + 1, dtype=np.float32)[:, None]
            * np.ones((1, 4), np.float32))
    finally:
        engine.close()
        cudashm.destroy_shared_memory_region(h_in)
        cudashm.destroy_shared_memory_region(h_out)


def test_fused_device_groups_write_into_sinks():
    """A fused device group copies each request's rows into its sink (its
    CUDA-shm output, in place) at dispatch; a request without one, or
    with one too small for its rows, gets a view of the group's own copy.
    Values exact, the static output untouched by either."""
    record = []
    model = _fused_model(record)
    entered, release = _hold_first_forward(model)
    batcher = ModelBatcher(model, _Stats(record), max_queue_delay_s=0.05)
    region = torch.zeros(64)
    sinks = {1: {"OUT": region[:4]}, 2: {"OUT": region[8:10]},
             3: {"OUT": region[16:]}}
    results = [None] * 4
    try:
        def run(i):
            results[i] = batcher.submit(
                {"IN": torch.full((1, 4), float(i + 1))}, sinks=sinks.get(i))

        _fused_run(4, run, batcher.queue_depth, entered, release)
        for i, res in enumerate(results):
            torch.testing.assert_close(
                res["OUT"], torch.full((1, 4), 2.0 * (i + 1)))
        # requests 1 and 3 answered in their sinks; 2's is too small
        assert results[1]["OUT"].data_ptr() == region.data_ptr()
        assert results[3]["OUT"].data_ptr() == region[16:].data_ptr()
        assert results[2]["OUT"].data_ptr() != region[8:].data_ptr()
        np.testing.assert_array_equal(region[:4].numpy(), [4.0] * 4)
        np.testing.assert_array_equal(region[16:20].numpy(), [8.0] * 4)
        assert not region[4:16].any() and not region[20:].any()
        static = {p.outputs["OUT"].data_ptr()
                  for p in batcher._programs.values()}
        assert not static & {r["OUT"].data_ptr() for r in results}
    finally:
        batcher.close()


@pytest.mark.parametrize("kind", ["system", "cuda"])
def test_wire_request_with_shm_output_runs_direct(kind):
    """A wire request whose output goes to a region keeps the direct path
    (one unpadded execution of its own) and its answer lands in the
    region."""
    import os

    from client_tpu_torch.utils import cuda_shared_memory as cudashm
    from client_tpu_torch.utils import shared_memory as sysshm

    record = []
    engine = InferenceEngine(models=[_echo_model(record)])
    arr = np.arange(12, dtype=np.float32).reshape(3, 4)
    if kind == "system":
        key = f"/ctpu_torch_batcher_{os.getpid()}"
        h = sysshm.create_shared_memory_region("out", key, arr.nbytes)
        engine.shm.register_system("out", key, 0, arr.nbytes)
    else:
        h = cudashm.create_shared_memory_region("out", arr.nbytes,
                                                device="cpu")
        engine.shm.register_cuda("out", cudashm.get_raw_handle(h), 0,
                                 arr.nbytes)
    try:
        req, raw = _request(arr, shm_output="out")
        response, blobs = engine.execute("echo2x", "", req, raw)
        assert blobs == [] and record == [3]
        assert response["outputs"][0]["parameters"] == {
            "shared_memory_region": "out",
            "shared_memory_byte_size": arr.nbytes}
        mod = sysshm if kind == "system" else cudashm
        np.testing.assert_array_equal(
            mod.get_contents_as_numpy(h, np.float32, [3, 4]), 2.0 * arr)
    finally:
        engine.close()
        if kind == "system":
            sysshm.destroy_shared_memory_region(h)
        else:
            cudashm.destroy_shared_memory_region(h)


def test_fused_device_groups_correct_splits():
    """fused_batching: a device group runs through its bucket's program;
    per-request outputs come back as tensors of their own, values exact,
    padding rows zero and never returned."""
    record = []
    seen = []
    model = _fused_model(record)
    inner = model.fn

    def fn(inputs, params, ctx):
        seen.append(inputs["IN"].clone())
        return inner(inputs, params, ctx)

    model.fn = fn
    entered, release = _hold_first_forward(model)
    batcher = ModelBatcher(model, _Stats(record), max_queue_delay_s=0.05)
    try:
        results = [None] * 6

        def run(i):
            results[i] = batcher.submit(
                {"IN": torch.full((1, 4), float(i + 1))})

        _fused_run(6, run, batcher.queue_depth, entered, release)
        for i, res in enumerate(results):
            torch.testing.assert_close(
                res["OUT"], torch.full((1, 4), 2.0 * (i + 1)))
        rows = [r[1] for r in record if isinstance(r, tuple)]
        assert rows == [1, 5]  # the 5 queued requests fused, bucket 6
        for batch, n in zip(seen, rows):
            assert batch.shape[0] == _bucket(n, 8)
            assert not batch[n:].any()  # padding rows are zeros
        # a different row count reuses the same program set
        out = batcher.submit({"IN": torch.ones((2, 4))})
        torch.testing.assert_close(out["OUT"], 2.0 * torch.ones((2, 4)))
    finally:
        batcher.close()


@pytest.mark.parametrize("device_group", [True, False])
def test_back_to_back_groups_through_one_bucket_get_their_own_rows(
        device_group):
    """Two groups dispatched back to back through one bucket's program:
    the second run overwrites the program's static output, and the first
    group's results are unchanged (each request's rows were copied out
    before the next run)."""
    record = []
    batcher = ModelBatcher(_fused_model(record), _Stats(record),
                           max_queue_delay_s=0.0)
    try:
        def make(v):
            x = np.full((3, 4), v, dtype=np.float32)
            return torch.from_numpy(x) if device_group else x

        first = batcher.submit({"IN": make(1.0)})
        second = batcher.submit({"IN": make(5.0)})
        assert len(batcher._programs) == 1  # both ran bucket 3's program
        np.testing.assert_array_equal(np.asarray(first["OUT"]),
                                      np.full((3, 4), 2.0, np.float32))
        np.testing.assert_array_equal(np.asarray(second["OUT"]),
                                      np.full((3, 4), 10.0, np.float32))
        prog, = batcher._programs.values()
        assert prog.bucket == 3
        assert prog.outputs["OUT"].data_ptr() != (
            torch.as_tensor(first["OUT"]).data_ptr())
    finally:
        batcher.close()


def test_batcher_error_propagates_per_request():
    def fn(inputs, params, ctx):
        raise ValueError("boom")

    model = Model(
        "boom",
        inputs=[TensorSpec("IN", "FP32", [-1, 4])],
        outputs=[TensorSpec("OUT", "FP32", [-1, 4])],
        fn=fn,
        max_batch_size=8,
        dynamic_batching=True,
        max_queue_delay_us=20000,
    )
    engine = InferenceEngine(models=[model])
    errors = []

    def run(i):
        req, raw = _request(np.zeros((1, 4), dtype=np.float32))
        with pytest.raises(InferenceServerException, match="boom") as ei:
            engine.execute("boom", "", req, raw)
        errors.append(ei.value)

    _concurrently(3, run)
    assert len(errors) == 3
    stats = engine.statistics("boom")[0]["inference_stats"]
    assert stats["fail"]["count"] == 3
    engine.close()


def test_unload_closes_batcher_and_reload_works():
    record = []
    engine = InferenceEngine(models=[_echo_model(record)])
    arr = np.ones((1, 4), dtype=np.float32)
    req, raw = _request(arr)
    engine.execute("echo2x", "", req, raw)
    batcher = engine._batchers["echo2x"]
    engine.unload_model("echo2x")
    assert batcher._closed and "echo2x" not in engine._batchers
    with pytest.raises(InferenceServerException, match="unknown model"):
        engine.execute("echo2x", "", req, raw)
    engine.load_model("echo2x")
    response, blobs = engine.execute("echo2x", "", req, raw)
    np.testing.assert_array_equal(
        np.frombuffer(blobs[0], dtype=np.float32).reshape(1, 4), arr * 2.0
    )
    engine.close()


def test_replacing_model_replaces_batcher():
    record_v1, record_v2 = [], []
    engine = InferenceEngine(models=[_echo_model(record_v1)])
    arr = np.ones((1, 4), dtype=np.float32)
    req, raw = _request(arr)
    engine.execute("echo2x", "", req, raw)
    assert record_v1  # v1 batcher served it
    old = engine._batchers["echo2x"]

    engine.add_model(_echo_model(record_v2))
    assert old._closed
    engine.execute("echo2x", "", req, raw)
    assert record_v2  # new batcher bound to the new model fn
    assert len(record_v1) == 1
    engine.close()


def test_warmup_compiles_all_buckets():
    record = []
    engine = InferenceEngine(models=[_echo_model(record, warmup=True)])
    assert sorted(set(record)) == _buckets_up_to(8)
    engine.close()


def test_fused_warmup_builds_one_program_per_bucket():
    """A fused model's warmup builds (on the card: captures) one program
    for every bucket up to max_batch_size; a request then builds none."""
    record = []
    engine = InferenceEngine(models=[_fused_model(record, warmup=True)])
    batcher = engine._batchers["echo2x"]
    assert sorted(p.bucket for p in batcher._programs.values()) == (
        _buckets_up_to(8))
    req, raw = _request(np.ones((5, 4), dtype=np.float32))
    engine.execute("echo2x", "", req, raw)
    assert len(batcher._programs) == len(_buckets_up_to(8))
    engine.close()


def test_programs_built_together_share_the_pools_lock():
    """The programs a build captures into one graph pool (a fused
    warmup's buckets) share one lock, since a replay may overwrite
    another's static outputs; a later build (another input signature)
    has a pool and a lock of its own.  On the CPU each run is an eager
    run of its program."""
    record = []
    engine = InferenceEngine(models=[_fused_model(record, warmup=True)])
    batcher = engine._batchers["echo2x"]
    warm = list(batcher._programs.values())
    assert len({id(p.lock) for p in warm}) == 1
    out = batcher.submit({"IN": torch.ones((5, 4), dtype=torch.float64)})
    torch.testing.assert_close(out["OUT"], torch.full((5, 4), 2.0,
                                                      dtype=torch.float64))
    later = [p for p in batcher._programs.values() if p not in warm]
    assert len(later) == 1 and later[0].lock is not warm[0].lock
    assert later[0].eager_runs == 1 and later[0].replays == 0
    engine.close()


def test_dynamic_batching_in_model_config():
    model = _echo_model([], flops_per_item=12)
    cfg = model.config()
    assert cfg["dynamic_batching"]["max_queue_delay_microseconds"] == 20000
    assert cfg["max_batch_size"] == 8
    assert cfg["parameters"]["flops_per_item"]["string_value"] == "12"


def test_queue_full_sheds_with_503():
    """Admission: beyond max_queue_depth queued requests, submit sheds
    with a retryable 503."""
    entered, gate = threading.Event(), threading.Event()

    def fn(inputs, params, ctx):
        entered.set()
        gate.wait(5)
        return {"OUT": inputs["IN"]}

    model = _echo_model([])
    model.fn = fn
    batcher = ModelBatcher(model, _Stats([]), max_queue_delay_s=0.0,
                           max_queue_depth=1)
    arr = np.zeros((1, 4), dtype=np.float32)
    threads = [threading.Thread(target=batcher.submit, args=({"IN": arr},))]
    try:
        threads[0].start()
        assert entered.wait(5)  # the first group is in the forward
        threads.append(
            threading.Thread(target=batcher.submit, args=({"IN": arr},)))
        threads[1].start()
        for _ in range(500):
            if batcher.queue_depth() == 1:
                break
            threading.Event().wait(0.01)
        with pytest.raises(InferenceServerException) as ei:
            batcher.submit({"IN": arr})
        assert ei.value.status() == "503"
    finally:
        gate.set()
        for t in threads:
            t.join()
        batcher.close()


def test_completion_observer_settles_host_results_at_once():
    """client_tpu_torch.serve._completion: a result with no CUDA tensor
    (CPU tensors, numpy) runs its callback inline, as the reference's
    observer does for host results; after close() a watch still runs
    its callback."""
    from client_tpu_torch.serve._completion import CompletionObserver

    observer = CompletionObserver()
    done = []
    observer.watch({"a": (torch.ones(2), np.ones(2))}, lambda: done.append(1))
    assert done == [1] and observer._thread is None
    observer.close()
    observer.watch({"b": torch.zeros(1)}, lambda: done.append(2))
    assert done == [1, 2]


@pytest.mark.parametrize("fused", [False, True])
def test_stress_every_request_gets_its_own_rows(fused):
    """32 threads (more than cores) x 4 requests of 1-3 rows, with a
    shortened switch interval: every request gets exactly its own rows
    back, and the statistics count every row once."""
    import sys

    record = []
    model = _fused_model(record) if fused else _echo_model(record)
    engine = InferenceEngine(models=[model])
    n_threads, per_thread = 32, 4
    failures = []
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        def run(t):
            for i in range(per_thread):
                rows = 1 + (t + i) % 3
                arr = np.full((rows, 4), float(t * 10 + i), np.float32)
                arr[:, 0] = np.arange(rows)
                req, raw = _request(arr)
                _, blobs = engine.execute("echo2x", "", req, raw)
                got = np.frombuffer(blobs[0], np.float32).reshape(rows, 4)
                if not np.array_equal(got, arr * 2.0):
                    failures.append((t, i))

        threads = [threading.Thread(target=run, args=(t,))
                   for t in range(n_threads)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=60)
        assert not any(th.is_alive() for th in threads)
    finally:
        sys.setswitchinterval(old)
        engine.close()
    assert not failures
    stats = engine.statistics("echo2x")[0]
    total_rows = sum(1 + (t + i) % 3 for t in range(n_threads)
                     for i in range(per_thread))
    assert stats["inference_count"] == total_rows
    assert stats["inference_stats"]["success"]["count"] == (
        n_threads * per_thread)


def test_concurrent_first_uses_build_one_program_per_key():
    """A bucket's program is built outside the batcher's program lock
    (``_programs_for`` claims its key): callers that need the same key at
    once get one build and the same program, and a reader of the
    batcher's programs does not wait through the build.  No reference
    counterpart (the JAX batcher builds its executables lazily in jit)."""
    batcher = ModelBatcher(_fused_model([]), _Stats([]),
                           max_queue_delay_s=0.0)
    builds, started = [], threading.Event()
    build = batcher._build_programs

    def slow_build(specs):
        builds.append([key for key, _, _ in specs])
        started.set()
        time.sleep(0.3)  # widen the window other callers arrive in
        return build(specs)

    batcher._build_programs = slow_build
    shapes = {"IN": ((4,), torch.float32)}
    got = [None] * 16
    was = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(
            target=lambda i=i: got.__setitem__(i, batcher._program(8, shapes)))
            for i in range(len(got))]
        for th in threads:
            th.start()
        assert started.wait(timeout=30)
        t0 = time.monotonic()
        assert batcher.programs() == {}
        assert time.monotonic() - t0 < 0.2
        for th in threads:
            th.join(timeout=60)
        assert not any(th.is_alive() for th in threads)
    finally:
        sys.setswitchinterval(was)
        batcher.close()
    assert len(builds) == 1
    assert all(prog is got[0] for prog in got)
    assert batcher.programs() == {8: got[0]}
