"""Load generation: worker threads driving a ClientBackend.

Parity with the reference's load-manager family (reference
src/c++/perf_analyzer/load_manager.h:43-126, concurrency_manager.h:53-119,
request_rate_manager, custom_load_manager, the worker classes and
infer_context.h:43-156), re-shaped for Python: each outstanding request slot
is a worker thread (the sync-client analog of an InferContext), timestamps
accumulate per-thread and are swapped out by the profiler between
measurement windows.

The port's copy of client_tpu/perf/load_manager.py, with
``AsyncConcurrencyManager`` (``--async``: asyncio slots on one loop thread
over the port's grpc.aio client).  One addition: every request of a run,
inside a measurement window or not, is counted by outcome
(:meth:`LoadManager.request_totals`), so a run's client count can be held
against the server's statistics.
"""

import threading
import time

import numpy as np

from client_tpu_torch.utils import InferenceServerException


class RequestRecord:
    __slots__ = ("start_ns", "end_ns", "ok", "sequence_id", "delayed",
                 "endpoint", "tenant")

    def __init__(self, start_ns, end_ns, ok, sequence_id=0, delayed=False,
                 endpoint="", tenant=""):
        self.start_ns = start_ns
        self.end_ns = end_ns
        self.ok = ok
        self.sequence_id = sequence_id
        self.delayed = delayed
        # replica this request was sent to (multi-replica runs report a
        # per-endpoint throughput/latency split)
        self.endpoint = endpoint
        # tenant identity this request was sent AS (--tenants mixes report
        # a per-tenant latency split — the noisy-neighbor isolation proof)
        self.tenant = tenant


class ThreadStat:
    """Per-worker request records + health (infer_context.h ThreadStat).

    ``fatal`` is set only for errors that kill the worker loop (backend
    construction/transport collapse); per-request failures are recorded in
    ``records`` and surface as error counts, not aborts.
    """

    def __init__(self):
        self.lock = threading.Lock()
        self.records = []
        self.fatal = None
        self.completed = 0  # every request this worker sent, by outcome
        self.failed = 0


class InferContext:
    """One request slot: prepared data rotation + send (infer_context.h:43)."""

    def __init__(self, ctx_id, backend, data_manager, loader, model_name,
                 model_version, sequence_manager=None, thread_stat=None,
                 tenant=""):
        self.ctx_id = ctx_id
        self.backend = backend
        self.data_manager = data_manager
        self.loader = loader
        self.model_name = model_name
        self.model_version = model_version
        self.sequences = sequence_manager
        self.stat = thread_stat or ThreadStat()
        self.tenant = tenant  # sent as the x-tenant-id header when set
        self._rot = 0  # (stream, step) rotation for stateless workloads

    def send(self, delayed=False):
        seq_id, seq_start, seq_end = 0, False, False
        if self.sequences is not None:
            status = self.sequences.get(self.ctx_id)
            if status is None or status.remaining_queries <= 0:
                steps_per_stream = [
                    self.loader.num_steps(s)
                    for s in range(self.loader.num_streams)
                ]
                status = self.sequences.begin_sequence(
                    self.ctx_id, steps_per_stream
                )
            stream_id = status.data_stream_id
            step_id = status.step_id % self.loader.num_steps(stream_id)
            seq_id = status.seq_id
            seq_start, seq_end = self.sequences.advance(status)
        else:
            stream_id = self._rot % self.loader.num_streams
            step_id = self._rot // self.loader.num_streams % self.loader.num_steps(
                stream_id
            )
            self._rot += 1
        data = self.data_manager.get_infer_data(stream_id, step_id)
        headers = {"x-tenant-id": self.tenant} if self.tenant else None
        start = time.monotonic_ns()
        ok = True
        try:
            result = self.backend.infer(
                self.model_name,
                data.inputs,
                outputs=data.outputs,
                sequence_id=seq_id,
                sequence_start=seq_start,
                sequence_end=seq_end,
                model_version=self.model_version,
                headers=headers,
            )
            if getattr(self.data_manager, "completion_sync", False):
                self.data_manager.sync_outputs()
            ok = self._validate(result, stream_id, step_id)
        except InferenceServerException:
            ok = False  # counted per-window; does not abort the run
        end = time.monotonic_ns()
        with self.stat.lock:
            if ok:
                self.stat.completed += 1
            else:
                self.stat.failed += 1
            self.stat.records.append(
                RequestRecord(
                    start, end, ok, seq_id, delayed,
                    endpoint=self.backend.endpoint,
                    tenant=self.tenant,
                )
            )

    def _validate(self, result, stream_id, step_id):
        return _validate_result(self.loader, result, stream_id, step_id)


def _validate_result(loader, result, stream_id, step_id):
    """Compare response tensors against the data loader's expected-output
    (validation_data) entries, when provided — shared by the sync and async
    request slots."""
    expected = loader.get_expected_outputs(stream_id, step_id)
    if not expected or result is None or not hasattr(result, "as_numpy"):
        return True
    try:
        for name, td in expected.items():
            got = result.as_numpy(name)
            if got is None:
                # output not in the response payload (e.g. delivered via
                # a shared-memory region) — nothing to compare against
                continue
            want = td.array
            if got.size != want.size:
                return False
            if got.dtype == np.object_ or want.dtype == np.object_:
                if list(got.flatten()) != list(want.flatten()):
                    return False
            elif not np.allclose(
                got.reshape(-1).astype(np.float64),
                want.reshape(-1).astype(np.float64),
                rtol=1e-5, atol=1e-6,
            ):
                return False
    except Exception:
        return False  # malformed comparison counts as a failed request
    return True


class LoadManager:
    """Base: owns backend(s), data pipeline, worker threads, stat swap."""

    def __init__(self, backend_factory, data_loader, data_manager, model_name,
                 model_version="", sequence_manager=None, max_threads=16,
                 tenants=None):
        self._backend_factory = backend_factory  # () -> ClientBackend
        self.loader = data_loader
        self.data_manager = data_manager
        self.model_name = model_name
        self.model_version = model_version
        self.sequences = sequence_manager
        self.max_threads = max_threads
        # Tenant mix: worker slot i sends as tenants[i % len(tenants)]
        # (--tenants "gold:3,bronze:1" expands to a weighted slot list)
        self.tenants = list(tenants or [])
        self._threads = []  # (thread, ThreadStat, stop_event)
        self._backends = []
        self._residual = []  # records harvested from stopped workers
        self._totals = [0, 0]  # (completed, failed) of stopped workers
        self._sent = 0
        self._sent_lock = threading.Lock()

    # -- stats ---------------------------------------------------------------

    def swap_timestamps(self):
        """Collect and clear all worker records (load_manager.h SwapTimestamps)."""
        out = self._residual
        self._residual = []
        for _, stat, _ in self._threads:
            with stat.lock:
                out.extend(stat.records)
                stat.records = []
        return out

    def request_totals(self):
        """(completed, failed): every request of the run so far."""
        done, failed = self._totals
        for _, stat, _ in self._threads:
            with stat.lock:
                done += stat.completed
                failed += stat.failed
        return done, failed

    def count_sent(self, n=1):
        with self._sent_lock:
            self._sent += n

    def get_and_reset_num_sent(self):
        with self._sent_lock:
            n = self._sent
            self._sent = 0
            return n

    def check_health(self):
        """Raise only on fatal worker conditions: a crashed thread or a
        worker-level error (load_manager.h CheckHealth); per-request failures
        are reported through the measurement error counts instead."""
        for th, stat, stop in self._threads:
            with stat.lock:
                if stat.fatal is not None:
                    raise stat.fatal
            if not th.is_alive() and not stop.is_set():
                raise InferenceServerException(
                    "a load worker thread died unexpectedly"
                )

    # -- worker plumbing -----------------------------------------------------

    def _spawn(self, target, ctx_id):
        stop = threading.Event()
        stat = ThreadStat()
        backend = self._backend_factory()
        self._backends.append(backend)
        tenant = (
            self.tenants[ctx_id % len(self.tenants)] if self.tenants else ""
        )
        ctx = InferContext(
            ctx_id, backend, self.data_manager, self.loader, self.model_name,
            self.model_version, self.sequences, stat, tenant=tenant,
        )

        def run(ctx=ctx, stop=stop, stat=stat):
            try:
                target(ctx, stop)
            except Exception as e:  # worker-level collapse is fatal
                with stat.lock:
                    stat.fatal = e

        th = threading.Thread(target=run, daemon=True)
        self._threads.append((th, stat, stop))
        th.start()

    def stop_workers(self):
        for _, _, stop in self._threads:
            stop.set()
        for th, _, _ in self._threads:
            th.join(timeout=30)
        # Records from the final in-flight requests outlive the worker list:
        # profile_completion stops workers (quiescing sends before the drain)
        # and only then swaps timestamps.
        for _, stat, _ in self._threads:
            with stat.lock:
                self._residual.extend(stat.records)
                stat.records = []
                self._totals[0] += stat.completed
                self._totals[1] += stat.failed
        self._threads = []
        for b in self._backends:
            try:
                b.close()
            except Exception:
                pass
        self._backends = []

    def cleanup(self):
        self.stop_workers()
        self.data_manager.cleanup()


class ConcurrencyManager(LoadManager):
    """Maintain N outstanding requests (concurrency_manager.h:53-119).

    Python shape: one worker thread per outstanding slot (the transports are
    synchronous), so the achievable concurrency equals the thread count.
    Levels beyond ``max_threads`` are refused rather than silently capped —
    raise ``--max-threads`` for bigger sweeps.
    """

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.concurrency = 0

    def change_concurrency_level(self, concurrency):
        if concurrency > self.max_threads:
            raise InferenceServerException(
                f"concurrency {concurrency} exceeds max_threads "
                f"{self.max_threads}; raise --max-threads"
            )
        self.stop_workers()
        # A new level starts with a clean slate: tail records the old level's
        # workers produced after its last swap belong to no window (they
        # would otherwise be counted as this level's errors).
        self._residual = []
        self.concurrency = concurrency
        for slot in range(concurrency):
            self._spawn(self._worker_loop, slot)

    def _worker_loop(self, ctx, stop):
        while not stop.is_set():
            ctx.send()
            self.count_sent()


class AsyncConcurrencyManager(LoadManager):
    """N outstanding requests as asyncio tasks on ONE event-loop thread over
    the grpc.aio client — the reference's ``-a/--async`` mode (async
    InferContext slots on the completion-queue thread,
    infer_context.cc:103-150).  Versus thread-per-slot, high concurrency
    costs coroutines instead of OS threads and the GIL is held by a single
    loop, so the measurement instrument stays honest at deep concurrency.

    Stateless workloads only (the reference's async mode pairs sequences
    with streaming, which rides ``async_stream_infer`` instead).  The
    client is the port's grpc.aio one (client_tpu_torch/grpc/aio); as the
    thread engine's workers do, every slot counts its requests by outcome
    (:meth:`request_totals`).
    """

    def __init__(self, url, data_loader, data_manager, model_name,
                 model_version="", max_threads=512):
        super().__init__(
            backend_factory=lambda: None,
            data_loader=data_loader,
            data_manager=data_manager,
            model_name=model_name,
            model_version=model_version,
            max_threads=max_threads,
        )
        self._url = url
        self.concurrency = 0
        self._loop = None
        self._loop_thread = None
        self._client = None
        self._slots = []  # (asyncio.Task, ThreadStat, threading.Event)

    # -- loop plumbing ------------------------------------------------------

    def _ensure_loop(self):
        import asyncio

        if self._loop is not None:
            return
        # the loop object is created HERE (caller thread) so self._loop
        # is only ever written caller-side (_ensure_loop/cleanup); the
        # pump thread works through its closure, never through self
        loop = asyncio.new_event_loop()
        started = threading.Event()

        def run():
            asyncio.set_event_loop(loop)
            started.set()
            try:
                loop.run_forever()
            finally:
                loop.close()

        self._loop = loop
        self._loop_thread = threading.Thread(
            target=run, name="perf-aio-loop", daemon=True
        )
        self._loop_thread.start()
        started.wait()

    def _call_in_loop(self, coro, timeout=60):
        import asyncio

        return asyncio.run_coroutine_threadsafe(coro, self._loop).result(
            timeout
        )

    async def _get_client(self):
        if self._client is None:
            from client_tpu_torch.grpc import aio as aiogrpc

            self._client = aiogrpc.InferenceServerClient(self._url)
        return self._client

    # -- slots --------------------------------------------------------------

    async def _slot(self, ctx_id, stat, stop):
        client = await self._get_client()
        rot = ctx_id  # interleave (stream, step) rotation across slots
        while not stop.is_set():
            stream_id = rot % self.loader.num_streams
            step_id = (
                rot // self.loader.num_streams
                % self.loader.num_steps(stream_id)
            )
            rot += 1
            data = self.data_manager.get_infer_data(stream_id, step_id)
            start = time.monotonic_ns()
            ok = True
            try:
                result = await client.infer(
                    self.model_name,
                    data.inputs,
                    outputs=data.outputs,
                    model_version=self.model_version,
                )
                if getattr(self.data_manager, "completion_sync", False):
                    self.data_manager.sync_outputs()
                ok = _validate_result(
                    self.loader, result, stream_id, step_id
                )
            except InferenceServerException:
                ok = False
            except Exception as e:  # noqa: BLE001 - transport collapse
                with stat.lock:
                    stat.fatal = e
                return
            end = time.monotonic_ns()
            with stat.lock:
                if ok:
                    stat.completed += 1
                else:
                    stat.failed += 1
                stat.records.append(
                    RequestRecord(start, end, ok, endpoint=self._url)
                )
            self.count_sent()

    def change_concurrency_level(self, concurrency):
        import asyncio

        if concurrency > self.max_threads:
            raise InferenceServerException(
                f"concurrency {concurrency} exceeds max_threads "
                f"{self.max_threads}; raise --max-threads"
            )
        self.stop_workers()
        self._residual = []  # see ConcurrencyManager.change_concurrency_level
        self._ensure_loop()
        self.concurrency = concurrency

        async def start_slots():
            slots = []
            for ctx_id in range(concurrency):
                stat = ThreadStat()
                stop = threading.Event()
                task = asyncio.get_running_loop().create_task(
                    self._slot(ctx_id, stat, stop)
                )
                slots.append((task, stat, stop))
            return slots

        self._slots = self._call_in_loop(start_slots())

    def stop_workers(self):
        import asyncio

        if not self._slots:
            return
        for _, _, stop in self._slots:
            stop.set()

        async def join_slots(timeout):
            tasks = [task for task, _, _ in self._slots]
            done, pending = await asyncio.wait(tasks, timeout=timeout)
            for task in pending:  # wedged in a hung infer: cancel and move on
                task.cancel()
            if pending:
                await asyncio.gather(*pending, return_exceptions=True)

        try:
            self._call_in_loop(join_slots(30), timeout=60)
        except Exception:
            pass  # teardown continues; records already harvested below
        for _, stat, _ in self._slots:
            with stat.lock:
                self._residual.extend(stat.records)
                stat.records = []
                self._totals[0] += stat.completed
                self._totals[1] += stat.failed
        self._slots = []

    def request_totals(self):
        """(completed, failed): every request of the run so far."""
        done, failed = self._totals
        for _, stat, _ in self._slots:
            with stat.lock:
                done += stat.completed
                failed += stat.failed
        return done, failed

    def swap_timestamps(self):
        out = self._residual
        self._residual = []
        for _, stat, _ in self._slots:
            with stat.lock:
                out.extend(stat.records)
                stat.records = []
        return out

    def check_health(self):
        for task, stat, stop in self._slots:
            with stat.lock:
                if stat.fatal is not None:
                    raise stat.fatal
            if task.done() and not stop.is_set():
                exc = None
                if not task.cancelled():
                    exc = task.exception()  # the slot's real failure
                if exc is not None:
                    raise exc
                raise InferenceServerException(
                    "an async load slot exited unexpectedly"
                )

    def cleanup(self):
        self.stop_workers()
        if self._loop is not None:
            if self._client is not None:
                try:
                    self._call_in_loop(self._client.close(), timeout=10)
                except Exception:
                    pass
                self._client = None
            self._loop.call_soon_threadsafe(self._loop.stop)
            self._loop_thread.join(timeout=10)
            self._loop = None
            self._loop_thread = None
        self.data_manager.cleanup()


class RequestRateManager(LoadManager):
    """Send on a schedule: poisson or constant inter-arrival gaps
    (request_rate_manager.h)."""

    def __init__(self, *args, distribution="constant", rng_seed=0, **kwargs):
        super().__init__(*args, **kwargs)
        self.distribution = distribution
        self._rng = np.random.default_rng(rng_seed)
        self._schedule_lock = threading.Lock()
        self._next_slot = 0
        self._gaps_ns = []
        self._t0 = None
        self._rate = None

    def _make_schedule(self, rate, horizon=100000):
        mean = 1e9 / rate
        if self.distribution == "poisson":
            return self._rng.exponential(mean, horizon).astype(np.int64)
        return np.full(horizon, int(mean), np.int64)

    def change_request_rate(self, rate, num_threads=None):
        self.stop_workers()
        self._residual = []  # see change_concurrency_level
        self._rate = rate
        self._gaps_ns = np.cumsum(self._make_schedule(rate))
        self._t0 = time.monotonic_ns()
        self._next_slot = 0
        n = num_threads or min(self.max_threads, max(2, int(rate // 4) or 1))
        for slot in range(n):
            self._spawn(self._worker_loop, slot)

    def _extend_schedule(self):
        """Append another horizon chunk so long levels never run dry."""
        more = np.cumsum(self._make_schedule(self._rate)) + int(
            self._gaps_ns[-1]
        )
        self._gaps_ns = np.concatenate([self._gaps_ns, more])

    def _claim_slot(self):
        with self._schedule_lock:
            slot = self._next_slot
            self._next_slot += 1
            if slot >= len(self._gaps_ns):
                if getattr(self, "_rate", None) is None:
                    return None, False  # finite custom schedule exhausted
                self._extend_schedule()
        target_ns = self._t0 + int(self._gaps_ns[slot])
        now = time.monotonic_ns()
        delayed = False
        if now < target_ns:
            time.sleep((target_ns - now) / 1e9)
        elif now - target_ns > 2_000_000:  # >2ms behind schedule
            delayed = True
        return slot, delayed

    def _worker_loop(self, ctx, stop):
        while not stop.is_set():
            slot, delayed = self._claim_slot()
            if slot is None:
                stop.set()  # finite schedule done: a clean stop, not a crash
                return
            ctx.send(delayed=delayed)
            self.count_sent()


class CustomLoadManager(RequestRateManager):
    """Replay user-provided inter-request intervals (custom_load_manager.h)."""

    def __init__(self, *args, intervals_file=None, intervals_ns=None, **kwargs):
        super().__init__(*args, **kwargs)
        if intervals_ns is None:
            if intervals_file is None:
                raise InferenceServerException(
                    "custom load needs --request-intervals file"
                )
            with open(intervals_file) as f:
                intervals_ns = [int(line.strip()) for line in f if line.strip()]
        if not intervals_ns:
            raise InferenceServerException("empty request-intervals data")
        self._intervals = np.asarray(intervals_ns, np.int64)

    def start(self, num_threads=2, repeats=1000):
        self.stop_workers()
        self._residual = []  # see change_concurrency_level
        self._rate = None  # finite replay: no auto-extension
        gaps = np.tile(self._intervals, repeats)
        self._gaps_ns = np.cumsum(gaps)
        self._t0 = time.monotonic_ns()
        self._next_slot = 0
        for slot in range(num_threads):
            self._spawn(self._worker_loop, slot)
