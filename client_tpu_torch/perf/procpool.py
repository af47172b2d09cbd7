"""Multi-process load generation: worker processes driving one server.

The port's copy of client_tpu/perf/procpool.py.  The reference's
perf_analyzer is a native multi-threaded binary (reference
src/c++/perf_analyzer/perf_analyzer.cc:56-424, concurrency_worker.cc); a
single-process Python harness shares its GIL between load workers — and,
for an in-process server, with the server itself — so at high concurrency
the measurement instrument becomes the bottleneck.  This module is the
GIL-sidestep: K worker processes, each a full interpreter running its own
``ConcurrencyManager`` slice against the server's gRPC socket, coordinated
over pipes and merged into one drain-corrected measurement
(``profiler.profile_completion`` semantics).

CUDA-shm loads use **region-by-name referencing**: the coordinator (which
owns the device) creates and registers the CUDA regions; workers build
requests that reference those regions by name and never create a CUDA
context — exactly how a fleet of remote clients would drive a GPU serving
host.  Workers are spawned, never forked: a forked child would inherit the
coordinator's CUDA state.  Linux CLOCK_MONOTONIC is system-wide, so
worker-reported window timestamps merge directly.
"""

import multiprocessing
import time

import numpy as np

from client_tpu_torch.perf.infer_data import InferData
from client_tpu_torch.utils import InferenceServerException


class ShapeOnlyLoader:
    """Minimal DataLoader stand-in for preregistered-region workers: knows
    only the (stream, step) topology; carries no tensor data."""

    def __init__(self, num_streams=1, steps_per_stream=(1,)):
        self.num_streams = num_streams
        self._steps = list(steps_per_stream)

    def num_steps(self, stream_id):
        return self._steps[stream_id]

    def get_expected_outputs(self, stream_id, step_id):
        return {}


class PreRegisteredShmInferDataManager:
    """InferData built from region *names* registered by someone else.

    ``input_specs``: {(stream, step): [(name, shape, datatype, region_name,
    nbytes), ...]}; ``output_specs``: [(name, region_name, nbytes)] (empty
    region_name = plain requested output)."""

    completion_sync = False

    def __init__(self, backend, input_specs, output_specs):
        self._backend = backend
        self._input_specs = input_specs
        self._output_specs = output_specs
        self._cache = {}

    def init(self):
        InferInput = self._backend.infer_input_cls
        Requested = self._backend.requested_output_cls
        for (s, t), tensors in self._input_specs.items():
            inputs = []
            for name, shape, datatype, region, nbytes in tensors:
                inp = InferInput(name, list(shape), datatype)
                inp.set_shared_memory(region, nbytes)
                inputs.append(inp)
            outputs = []
            for name, region, nbytes in self._output_specs:
                out = Requested(name)
                if region:
                    out.set_shared_memory(region, nbytes)
                outputs.append(out)
            self._cache[(s, t)] = InferData(inputs, outputs)

    def get_infer_data(self, stream_id, step_id):
        return self._cache[(stream_id, step_id)]

    def cleanup(self):
        pass


def export_region_specs(data_manager, inputs_meta, loader):
    """(input_specs, output_specs) for PreRegisteredShmInferDataManager from
    a live shm data manager (its regions stay registered with the server)."""
    metas = {m["name"]: m for m in inputs_meta}
    input_specs = {}
    for s in range(loader.num_streams):
        for t in range(loader.num_steps(s)):
            tensors = []
            for name, meta in metas.items():
                entry = data_manager._regions.get((s, t, name))
                if entry is None:
                    continue
                region, nbytes = entry
                td = loader.get_input_data(s, t).get(name)
                shape = list(td.array.shape) if td is not None else meta["shape"]
                tensors.append((name, shape, meta["datatype"], region, nbytes))
            input_specs[(s, t)] = tensors
    output_specs = [
        (name,) + data_manager._out_regions.get(name, ("", 0))
        for name in [m["name"] for m in getattr(data_manager, "_outputs_meta", [])]
    ]
    return input_specs, output_specs


def _worker_main(conn, url, model_name, concurrency, warmup_s, window_s, spec):
    """One load process: build the object graph, wait for 'go', run the
    window, report records.  Never touches a device."""
    try:
        from client_tpu_torch.perf import (
            BackendKind,
            ClientBackendFactory,
            ConcurrencyManager,
            DataLoader,
        )
        from client_tpu_torch.perf.infer_data import InferDataManager

        def factory():
            return ClientBackendFactory.create(BackendKind.TRITON_GRPC, url=url)

        if spec["mode"] == "shm_ref":
            loader = ShapeOnlyLoader(
                spec["num_streams"], spec["steps_per_stream"]
            )
            manager_backend = factory()
            data_manager = PreRegisteredShmInferDataManager(
                manager_backend, spec["input_specs"], spec["output_specs"]
            )
        else:  # wire: generate tensor data locally from server metadata
            manager_backend = factory()
            meta = manager_backend.model_metadata(model_name, "")
            inputs_meta = [dict(m) for m in meta["inputs"]]
            for m in inputs_meta:
                dims = [int(d) for d in m["shape"]]
                if dims and dims[0] == -1:
                    dims[0] = 1
                m["shape"] = dims
            outputs_meta = [dict(m) for m in meta["outputs"]]
            loader = DataLoader(inputs_meta, batch_size=1)
            loader.generate_data()
            data_manager = InferDataManager(
                manager_backend, loader, inputs_meta, outputs_meta
            )
        data_manager.init()
        manager = ConcurrencyManager(
            backend_factory=factory,
            data_loader=loader,
            data_manager=data_manager,
            model_name=model_name,
            max_threads=concurrency,
        )
        conn.send({"ready": True})
        if conn.recv() != "go":
            raise InferenceServerException("coordinator sent no 'go'")
        manager.change_concurrency_level(concurrency)
        time.sleep(warmup_s)
        manager.swap_timestamps()
        manager.get_and_reset_num_sent()
        t0 = time.monotonic_ns()
        time.sleep(window_s)
        manager.stop_workers()
        t1 = time.monotonic_ns()
        records = manager.swap_timestamps()
        sent = manager.get_and_reset_num_sent()
        ok = [r for r in records if r.ok]
        conn.send(
            {
                "ok": len(ok),
                "errors": len(records) - len(ok),
                "sent": sent,
                "t0": t0,
                "t1": t1,
                "latencies_ns": [r.end_ns - r.start_ns for r in ok],
                "requests": manager.request_totals(),
            }
        )
        manager.cleanup()
        try:
            manager_backend.close()
        except Exception:
            pass
    except Exception as e:  # noqa: BLE001 - reported to the coordinator
        try:
            conn.send({"error": f"{type(e).__name__}: {e}"})
        except Exception:
            pass
    finally:
        conn.close()


class ProcPoolResult:
    """The merged measurement.  ``requests`` is (completed, failed) over
    every request the workers sent, warm-up included: what the server's
    statistics count (the CLI's JSON ``requests``)."""

    def __init__(self):
        self.throughput = 0.0
        self.completed_requests = 0
        self.error_count = 0
        self.send_rate = 0.0
        self.percentiles_us = {}
        self.latency_avg_us = 0.0
        self.window_s = 0.0
        self.processes = 0
        self.concurrency = 0
        self.requests = (0, 0)


def _recv(conn, what):
    """One message from a worker; a worker that died reads as EOF."""
    try:
        msg = conn.recv()
    except EOFError:
        raise InferenceServerException(
            f"load worker process exited before it {what}"
        ) from None
    if "error" in msg:
        raise InferenceServerException(f"load worker failed: {msg['error']}")
    return msg


def run_completion_multiproc(url, model_name, *, processes, concurrency,
                             window_s=8.0, warmup_s=2.0, spec=None,
                             sync_outputs=None, start_timeout_s=180.0,
                             on_go=None):
    """Drain-corrected completion measurement across worker processes.

    *concurrency* is the TOTAL outstanding-request count, split evenly.
    *sync_outputs* (coordinator-side) forces the outputs' arrival before
    the clock closes — same semantics as InferenceProfiler.profile_completion."""
    spec = spec or {"mode": "wire"}
    processes = max(int(processes), 1)
    per = max(concurrency // processes, 1)
    ctx = multiprocessing.get_context("spawn")
    workers = []
    try:
        for _ in range(processes):
            parent_conn, child_conn = ctx.Pipe()
            p = ctx.Process(
                target=_worker_main,
                args=(child_conn, url, model_name, per, warmup_s, window_s,
                      spec),
                daemon=True,
            )
            p.start()
            child_conn.close()
            workers.append((p, parent_conn))
        deadline = time.monotonic() + start_timeout_s
        for p, conn in workers:
            if not conn.poll(max(deadline - time.monotonic(), 0.1)):
                raise InferenceServerException(
                    "load worker process failed to initialize in time"
                )
            _recv(conn, "initialized")
        for _, conn in workers:
            conn.send("go")
        if on_go is not None:
            on_go()  # e.g. snapshot server busy counters at window start
        results = []
        wait_s = warmup_s + window_s + 60
        for p, conn in workers:
            if not conn.poll(wait_s):
                raise InferenceServerException(
                    "load worker process did not report results"
                )
            results.append(_recv(conn, "reported results"))
        if sync_outputs is not None:
            sync_outputs()  # drain: only completed device work counts
        t_close = time.monotonic_ns()
        out = ProcPoolResult()
        out.processes = processes
        out.concurrency = per * processes
        t0 = min(r["t0"] for r in results)
        elapsed = (t_close - t0) / 1e9
        out.window_s = elapsed
        out.completed_requests = sum(r["ok"] for r in results)
        out.error_count = sum(r["errors"] for r in results)
        out.requests = (sum(r["requests"][0] for r in results),
                        sum(r["requests"][1] for r in results))
        out.throughput = out.completed_requests / elapsed if elapsed else 0.0
        out.send_rate = sum(r["sent"] for r in results) / elapsed if elapsed else 0.0
        lat = np.concatenate(
            [np.asarray(r["latencies_ns"], np.int64) for r in results]
        ) if any(r["latencies_ns"] for r in results) else np.array([], np.int64)
        if lat.size:
            out.latency_avg_us = float(lat.mean()) / 1e3
            for p_ in (50, 90, 95, 99):
                out.percentiles_us[p_] = float(np.percentile(lat, p_)) / 1e3
        return out
    finally:
        for p, conn in workers:
            try:
                conn.close()
            except Exception:
                pass
            p.join(timeout=10)
            if p.is_alive():
                p.terminate()
                p.join(timeout=10)
