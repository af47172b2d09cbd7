"""Cross-request dynamic micro-batching for stateless batchable models.

Counterpart of client_tpu/serve/dynamic_batcher.py.  The host logic (the
bucket sizes, the weighted-fair queue, gather / top-up / dispatch, host
completion, failure per request, admission, close) is the reference's;
the device half is rewritten for PyTorch:

- a device array is a ``torch.Tensor`` on the device its model runs on
  (CUDA on the card; the CPU when the caller asked for it), the port's
  ``jax.Array``;
- a ``fused_batching`` model (a torch-pure ``fn``) runs every group
  through one :class:`_BucketProgram` per padded bucket, the counterpart
  of the reference's ``jax.jit`` forward: on a CUDA device a CUDA graph
  captured at warmup (every bucket up to ``max_batch_size``) or at the
  bucket's first use, replayed for each group.  A dispatch copies the
  group into the program's static input (host groups with one pinned
  copy, device groups tensor by tensor), zero-pads the rest, replays, and
  copies each request's rows out of the static output before anything
  else runs on the stream: the next replay of that bucket overwrites it.
  On the CPU the same programs run eagerly.  A failed capture raises;
  nothing falls back to eager on the card.  A fused model's request
  that is not batched runs through the same program on its own thread
  (:meth:`ModelBatcher.run_direct`, the reference's direct path calling
  its batcher's executable); each program's lock gives its static
  buffers one owner at a time;
- other models keep the reference's eager paths: host groups concatenate
  and pad on the host, device groups assemble a zero-padded bucket buffer
  (``_device_batch``) and narrow the output (``_device_split``).

Streams: the batcher thread, the request threads and an ensemble's steps
are different threads, and an ensemble hands a CUDA tensor from one step
to the next.  Every hop runs on its device's default stream
(:func:`device_stream`), so each is ordered after the work that made its
input, with no event to forget.

Observability: a request's trace (serve/tracing.py) gets QUEUE_END and
COMPUTE_START at dispatch and COMPUTE_END when its rows are handed over,
host clock, as the reference's batcher stamps them; the engine's
``BusyTracker`` span runs from dispatch to the group's completion.

Eligibility: stateless, non-decoupled models with ``max_batch_size > 1``
and host-resident (wire) inputs, or device tensors for models that opt in
with ``batch_device_inputs``.

The module imports without torch: a host model (``device`` None) batches
numpy arrays on the host and never touches it, and the device half reads
torch only once a model with a device reaches it.
"""

import contextlib
import threading
import time
from collections import deque

import numpy as np

from client_tpu_torch import is_tensor, ops, require_torch
from client_tpu_torch.serve._completion import CompletionObserver
from client_tpu_torch.utils import InferenceServerException, triton_to_np_dtype


def _bucket(n, cap):
    """Smallest bucket >= n from {2^k, 3*2^k}, capped at cap.

    The 1.5x intermediate sizes keep worst-case padding waste to 33% instead
    of 100% while the bucket count (and so the graph count) stays O(log n).
    """
    b = 1
    while b < n:
        if b * 3 // 2 >= n and b >= 2:
            b = b * 3 // 2
            break
        b *= 2
    return min(b, cap)


def _buckets_up_to(cap):
    """All bucket sizes warmup must cover, ending exactly at cap."""
    out = []
    b = 1
    while b < cap:
        out.append(b)
        if b >= 2 and b * 3 // 2 < cap:
            out.append(b * 3 // 2)
        b *= 2
    out.append(cap)
    return sorted(set(out))


def _torch():
    return require_torch("a model on a device")


def _is_device_array(arr):
    """A tensor, on the device its model runs on: what a jax.Array is to
    the reference (numpy arrays are host arrays)."""
    return is_tensor(arr)


def device_stream(device):
    """Run on *device*'s default stream (a no-op off CUDA, and for a host
    model's None): the one stream every hop of a device tensor is ordered
    on."""
    if device is None:
        return contextlib.nullcontext()
    torch = _torch()
    if torch.device(device).type == "cuda":
        return torch.cuda.stream(torch.cuda.default_stream(device))
    return contextlib.nullcontext()


def _dtype_key(arr):
    return arr.dtype.str if isinstance(arr, np.ndarray) else str(arr.dtype)


def _torch_dtype(np_dtype):
    return _torch().from_numpy(np.zeros(0, dtype=np_dtype)).dtype


def _device_batch(parts, padded, out=None):
    """The parts laid end to end in a [padded, ...] buffer (*out*, a
    bucket program's static input, or a new one), the rows after them
    zero: padding rows never reach a response."""
    first = parts[0]
    if out is None:
        out = first.new_empty((padded,) + tuple(first.shape[1:]))
    offset = 0
    for p in parts:
        if p.device != out.device or p.dtype != out.dtype:
            raise InferenceServerException(
                f"device input {p.dtype} on {p.device} does not match the "
                f"batch buffer ({out.dtype} on {out.device})", status="400")
        rows = int(p.shape[0])
        out[offset:offset + rows].copy_(p)
        offset += rows
    if offset < padded:
        out[offset:].zero_()
    return out


def _group_sinks(group):
    """``{output: [flat tensor or None per part]}``: the sinks each
    request of a group gave when it was queued."""
    names = set().union(*(p.sinks for p in group))
    return {name: [p.sinks.get(name) for p in group] for name in names}


def _device_rows(out, sizes, targets, rows):
    """Each part's rows of a fused device group's static outputs,
    ``[{name: tensor}]``: copied into the part's sink (``targets``, from
    :func:`_group_sinks`) where it has one that holds them, else a view
    of one copy of the group's rows."""
    per_part = [{} for _ in sizes]
    for name, arr in out.items():
        live = arr[:rows].split(sizes)
        flat = targets.get(name) or [None] * len(sizes)
        # each part's sink as a view of its rows' shape (a tensor, where
        # the copy lands), None where it has none or it is too small
        dsts = [s[:part.numel()].view(part.shape)
                if s is not None and s.numel() >= part.numel() else None
                for s, part in zip(flat, live)]
        copies = (arr[:rows].clone().split(sizes)
                  if any(d is None for d in dsts) else None)
        for i, (part, dst) in enumerate(zip(live, dsts)):
            if dst is None:
                per_part[i][name] = copies[i]
            else:
                dst.copy_(part)
                per_part[i][name] = dst
    return per_part


def _device_split(arr, offset, rows):
    """One request's row slice of an eager batch output (a view: the
    output is the request's own)."""
    return arr.narrow(0, offset, rows)


class _HostRows:
    """A host group's output rows on their way to the host: pinned tensors
    that non_blocking copies fill, and the CUDA event after the copies
    (None on the CPU)."""

    __slots__ = ("tensors", "event")

    def __init__(self, tensors, event):
        self.tensors = tensors
        self.event = event

    def fetch(self):
        """The rows as numpy arrays, once the copies have landed."""
        if self.event is not None:
            self.event.synchronize()
        return {name: t.numpy() for name, t in self.tensors.items()}


def _to_host(result):
    """A model result as host numpy arrays (the reference's
    ``jax.device_get``); non-tensor entries (``__parameters__``) pass."""
    if isinstance(result, _HostRows):
        return result.fetch()
    if isinstance(result, dict):
        return {k: _to_host(v) for k, v in result.items()}
    if is_tensor(result):
        return result.detach().cpu().numpy()
    return result


class _BucketProgram:
    """One padded bucket's forward at one input signature: the port's
    counterpart of one executable of the reference's jitted forward.

    ``inputs`` are static buffers ``[bucket, ...]`` on the model's device
    that a dispatch fills; ``outputs`` the forward's result tensors, which
    every ``run`` overwrites in place.  On a CUDA device ``capture``
    records the forward as a CUDA graph and ``run`` replays it (counting
    the hand-written kernel launches the capture recorded,
    ``ops.count_replay``); on the CPU ``run`` calls the forward eagerly
    and copies its result into the same static outputs, so both devices
    share one contract.

    Programs captured into one memory pool share one ``lock``: a graph
    may write its intermediates where another's static output lies, so
    the pool's programs take turns from filling the inputs until their
    outputs' copies are issued, and the stream runs each turn whole."""

    def __init__(self, fn, shapes, bucket, device, lock=None):
        torch = _torch()
        self.fn = fn
        self.bucket = bucket
        self.device = device
        self.inputs = {
            name: torch.zeros((bucket,) + tuple(dims), dtype=dtype,
                              device=device)
            for name, (dims, dtype) in shapes.items()
        }
        self.outputs = None
        self.graph = None
        self.launches = {}  # {(kernel, route): launches} of one replay
        # runs that replayed the graph, and runs of the eager forward (on
        # the CPU, or of a program not captured)
        self.replays = self.eager_runs = 0
        # the static buffers' (and the pool's) one owner at a time: the
        # batcher thread and a direct request's thread each hold it from
        # filling the inputs until the outputs' copies are issued (the
        # stream orders the rest)
        self.lock = lock or threading.Lock()

    def _forward(self):
        out = self.fn(self.inputs, {}, None)
        # a replayed graph runs no python: fused models cannot set
        # per-response parameters, as in the reference's fused path
        out.pop("__parameters__", None)
        return out

    def run(self):
        if self.graph is None:
            self.eager_runs += 1
            out = self._forward()
            if self.outputs is None:
                self.outputs = out
            else:
                for name, arr in out.items():
                    self.outputs[name].copy_(arr)
            return
        self.replays += 1
        self.graph.replay()
        ops.count_replay(self.launches)

    def capture(self, pool, stream):
        """Record the forward as a CUDA graph in *pool* on *stream*
        (``ops.capture_graph``) and return the seconds it took.  A
        warm-up run on the same (zeroed) inputs comes first, so cuDNN and
        cuBLAS pick their algorithms and workspaces outside the capture;
        its launches count nowhere."""
        box = {}

        def body():
            box["outputs"] = self._forward()

        captured = ops.capture_graph(body, self._forward, pool, stream)
        self.outputs = box["outputs"]
        self.graph, self.launches = captured.graph, captured.launches
        return captured.seconds


class _Pending:
    __slots__ = ("inputs", "rows", "signature", "event", "result", "error",
                 "t_enq", "trace", "tenant", "weight", "vfinish", "sinks")

    def __init__(self, inputs, rows, signature, trace=None, tenant="",
                 weight=1.0, sinks=None):
        self.inputs = inputs
        self.rows = rows
        self.signature = signature
        self.sinks = sinks or {}
        self.event = threading.Event()
        self.result = None
        self.error = None
        self.t_enq = time.monotonic_ns()
        self.trace = trace  # optional RequestTrace (queue/compute events)
        self.tenant = tenant  # fair-queue lane (see _FairQueue)
        self.weight = max(float(weight), 1e-3)
        self.vfinish = 0.0  # virtual finish time, stamped at push


class _FairQueue:
    """Weighted-fair queue over per-tenant FIFO lanes.

    Each request is stamped a *virtual finish time* on push
    (``max(vclock, lane_last_finish) + rows / weight``, the start-time
    fair queueing recurrence) and :meth:`pop` always takes the earliest
    stamp across lane heads: a tenant's burst deepens only its own lane,
    and service converges to the weight ratio regardless of arrival
    order.  Within one lane order stays FIFO.

    Not internally locked: the batcher's ``_cond`` guards every call.
    """

    __slots__ = ("_lanes", "_last_vfinish", "_vclock", "_len")

    def __init__(self):
        self._lanes = {}  # tenant -> deque of _Pending
        self._last_vfinish = {}  # tenant -> last stamped vfinish
        self._vclock = 0.0
        self._len = 0

    def __len__(self):
        return self._len

    def push(self, pending):
        lane = self._lanes.get(pending.tenant)
        if lane is None:
            lane = deque()
            self._lanes[pending.tenant] = lane
        start = max(
            self._vclock, self._last_vfinish.get(pending.tenant, 0.0)
        )
        pending.vfinish = start + max(pending.rows, 1) / pending.weight
        self._last_vfinish[pending.tenant] = pending.vfinish
        lane.append(pending)
        self._len += 1

    def pop(self):
        """Remove and return the entry with the earliest virtual finish
        time (caller guarantees non-empty)."""
        best_tenant, best = None, None
        for tenant, lane in self._lanes.items():
            head = lane[0]
            if best is None or head.vfinish < best.vfinish:
                best_tenant, best = tenant, head
        self._remove(best_tenant, 0)
        self._vclock = max(self._vclock, best.vfinish)
        return best

    def take_first(self, pred):
        """Remove and return the fair-order-first entry matching *pred*
        (the batch fold-in scan), or None.  Per lane only the earliest
        match is a candidate: lane order stays FIFO."""
        best_tenant, best_i, best = None, None, None
        for tenant, lane in self._lanes.items():
            for i, pending in enumerate(lane):
                if pred(pending):
                    if best is None or pending.vfinish < best.vfinish:
                        best_tenant, best_i, best = tenant, i, pending
                    break
        if best is None:
            return None
        self._remove(best_tenant, best_i)
        return best

    def _remove(self, tenant, index):
        lane = self._lanes[tenant]
        del lane[index]
        self._len -= 1
        if not lane:
            del self._lanes[tenant]
        if not self._lanes:
            # busy period over: forget per-tenant stamps so the map cannot
            # grow without bound across tenant churn
            self._last_vfinish.clear()
            self._vclock = 0.0

    def depths(self):
        """{tenant: queued count}."""
        return {tenant: len(lane) for tenant, lane in self._lanes.items()}

    def drain(self):
        """Remove and return every queued entry (shutdown/failure paths)."""
        out = [p for lane in self._lanes.values() for p in lane]
        self._lanes.clear()
        self._last_vfinish.clear()
        self._vclock = 0.0
        self._len = 0
        return out


# dispatched groups in flight: wire groups hold host copies of their
# tensors, device groups only device references (a runaway bound)
_PIPELINE_DEPTH = 4
_DEVICE_PIPELINE_DEPTH = 64


class ModelBatcher:
    """One background batcher per model: gathers concurrent requests into a
    single padded forward pass and splits the outputs back per request."""

    def __init__(self, model, stats, max_queue_delay_s=0.003, busy=None,
                 max_queue_depth=None, registry=None, prof=None):
        self.model = model
        self.stats = stats
        self._busy = busy  # engine BusyTracker (duty-cycle metric), optional
        self._registry = registry  # engine metrics Registry (shed counters)
        self.prof = prof  # engine PhaseProfiler: one "batch" tick per group
        self.max_batch = max(int(model.max_batch_size), 1)
        self.max_queue_delay_s = max_queue_delay_s
        # Admission control: requests beyond this queue depth are shed with
        # a retryable 503 instead of growing the queue (and the tail
        # latency) without bound.  None = unbounded.
        self.max_queue_depth = max_queue_depth
        self.max_fused_arity = int(model.max_fused_arity)
        # fused models: {(bucket, input signature): _BucketProgram}
        self._programs = {}
        # guards _programs, _building and _graph_stats; never held across a
        # build or a capture (keys being built are claimed in _building)
        self._programs_cv = threading.Condition()
        self._building = set()
        self._graph_stats = {"graphs": 0, "capture_s": 0.0,
                             "direct_runs": 0}
        # Dispatch and completion are decoupled: the batcher thread only
        # gathers and issues batches; completion waits run off the
        # dispatch path.  HOST (wire) groups end in a real batch-wide D2H,
        # so a small completion pool + semaphore bounds memory; DEVICE
        # groups hold device references only and are acked at dispatch,
        # with a deep semaphore purely as a runaway bound and one watcher
        # thread that waits on each group's CUDA event.
        self._sem = threading.Semaphore(_PIPELINE_DEPTH)
        self._sem_device = threading.Semaphore(_DEVICE_PIPELINE_DEPTH)
        self._observer = CompletionObserver(
            name=f"batcher-{model.name}-watch"
        )
        # Host completions (batch D2H + row split) run on daemon worker
        # threads consuming _host_q, bounded-waited in close().
        self._host_cv = threading.Condition()
        self._host_q = deque()
        self._host_threads = []
        self._host_outstanding = 0
        # Workers exit on _host_closed, set only AFTER the batcher thread is
        # joined: the batcher keeps dispatching its remaining queue after
        # _closed, and a worker exiting early would strand those batches.
        self._host_closed = False
        self._inflight = 0  # dispatched, completion pending (under _cond)
        self._cond = threading.Condition()
        self._queue = _FairQueue()
        # Requests popped off the queue but not yet completed/failed, so
        # the _loop BaseException handler can fail them too.
        self._active = set()
        self._closed = False
        self._thread = threading.Thread(
            target=self._loop, name=f"batcher-{model.name}", daemon=True
        )
        self._thread.start()

    def _device(self):
        return _torch().device(self.model.device or "cpu")

    # -- bucket programs (fused models) -------------------------------------

    @staticmethod
    def _program_key(bucket, shapes):
        return (bucket, tuple(sorted(
            (name, str(dtype), tuple(dims))
            for name, (dims, dtype) in shapes.items())))

    def _program(self, bucket, shapes):
        """The program of *bucket* at *shapes* ``{name: (dims, torch
        dtype)}``, built (and on CUDA captured) at its first use."""
        key = self._program_key(bucket, shapes)
        prog, = self._programs_for([(key, bucket, shapes)])
        return prog

    def _programs_for(self, specs):
        """The programs of ``[(key, bucket, shapes)]``, building those not
        built yet.  The build runs outside ``_programs_cv``: the keys are
        claimed first, so a caller that needs one of them waits for that
        build alone, and nothing else waits through a capture.  A failed
        build raises here and leaves its keys to the next caller."""
        with self._programs_cv:
            while any(key in self._building for key, _, _ in specs):
                self._programs_cv.wait()
            missing = [spec for spec in specs
                       if spec[0] not in self._programs]
            self._building.update(key for key, _, _ in missing)
        if missing:
            try:
                self._build_programs(missing)
            finally:
                with self._programs_cv:
                    self._building.difference_update(
                        key for key, _, _ in missing)
                    self._programs_cv.notify_all()
        with self._programs_cv:
            return [self._programs[key] for key, _, _ in specs]

    def _build_programs(self, specs):
        """Build one program per ``(key, bucket, shapes)`` and, on a CUDA
        device, capture them all under the process's capture lock; then
        install them under ``_programs_cv``."""
        device = self._device()
        lock = threading.Lock()  # the pool's, below
        progs = [_BucketProgram(self.model.fn, shapes, bucket, device, lock)
                 for _, bucket, shapes in specs]
        captured = None
        if device.type == "cuda":
            torch = _torch()
            pool = torch.cuda.graph_pool_handle()
            stream = torch.cuda.Stream(device)
            with ops.CAPTURE_LOCK, device_stream(device):
                torch.cuda.synchronize(device)
                before = torch.cuda.memory_reserved(device)
                t0 = time.monotonic()
                for prog in progs:
                    prog.capture(pool, stream)
                torch.cuda.synchronize(device)
                captured = (time.monotonic() - t0, before,
                            torch.cuda.memory_reserved(device))
        with self._programs_cv:
            if captured is not None:
                seconds, before, after = captured
                stats = self._graph_stats
                stats["capture_s"] += seconds
                stats.setdefault("memory_reserved_before", before)
                stats["memory_reserved_after"] = after
                stats["graphs"] += len(progs)
            for (key, _, _), prog in zip(specs, progs):
                self._programs[key] = prog
        return progs

    def programs(self):
        """{bucket: program} of the programs built so far (the last built
        per bucket where several input signatures were seen)."""
        with self._programs_cv:
            return {prog.bucket: prog for prog in self._programs.values()}

    def graph_stats(self):
        """Graphs captured, capture seconds, direct-path requests run
        through a program (``direct_runs``), ``memory_reserved`` before the
        first capture and after the last (CUDA only)."""
        with self._programs_cv:
            return dict(self._graph_stats)

    def _run_program(self, group, names, rows):
        """Copy the group into its bucket's static inputs, run the
        program, and copy each request's rows out before returning: a
        device request's into its sink where it gave one (its CUDA
        shared-memory output, written in place) and otherwise into one copy
        of the group's rows (a view of it each), host groups one pinned
        copy of the rows (an event after it).  Everything runs on the
        device's default stream, in this order, before any later replay is
        issued."""
        padded = _bucket(rows, cap=self.max_batch)
        parts = {name: [p.inputs[name] for p in group] for name in names}
        shapes = {
            name: (tuple(ps[0].shape[1:]),
                   ps[0].dtype if _is_device_array(ps[0])
                   else _torch_dtype(ps[0].dtype))
            for name, ps in parts.items()
        }
        prog = self._program(padded, shapes)
        torch = _torch()
        device = prog.device
        cuda = device.type == "cuda"
        fused = group[0].signature[0]
        # resolved before the lock: only the copies need it
        targets = _group_sinks(group) if fused else None
        with prog.lock, device_stream(device):
            for name, ps in parts.items():
                buf = prog.inputs[name]
                if _is_device_array(ps[0]):
                    _device_batch(ps, padded, out=buf)
                    continue
                host = torch.empty(buf.shape, dtype=buf.dtype,
                                   pin_memory=cuda)
                raw = host.numpy()
                np.concatenate(ps, axis=0, out=raw[:rows])
                raw[rows:] = 0
                buf.copy_(host, non_blocking=cuda)
            prog.run()
            out = prog.outputs
            if fused:
                return ("fused", _device_rows(
                    out, [p.rows for p in group], targets, rows))
            tensors = {}
            for name, arr in out.items():
                host = torch.empty((rows,) + tuple(arr.shape[1:]),
                                   dtype=arr.dtype, pin_memory=cuda)
                host.copy_(arr[:rows], non_blocking=cuda)
                tensors[name] = host
            event = None
            if cuda:
                event = torch.cuda.Event()
                event.record()
            return _HostRows(tensors, event)

    def run_direct(self, inputs):
        """Run one request that is not batched (the direct path: a host
        request with shared-memory outputs, or one with parameters) through
        its bucket's program on the calling thread, as the reference's
        direct path calls the jitted executable its batcher calls.  The
        request is not queued and joins no group.  Returns its outputs:
        host numpy arrays for host inputs (copied out before the program
        is free), for device inputs a device copy of its rows.  A failed
        run or capture raises; nothing falls back to the eager forward."""
        rows = _leading_rows(inputs)
        device = _is_device_array(next(iter(inputs.values())))
        part = _Pending(inputs, rows, (device,))
        result = self._run_program([part], list(inputs), rows)
        with self._programs_cv:
            self._graph_stats["direct_runs"] += 1
        if device:
            return result[1][0]
        return result.fetch()

    def warmup(self, input_specs):
        """Prepare every padded bucket (the reference's ``model_warmup``)
        so no client request pays a capture or an algorithm search.  A
        fused model builds (on CUDA captures) one program per bucket,
        which serves host and device groups alike; other models run their
        forward once per bucket.  Skipped for models with dynamic
        non-batch dims."""
        shapes = {}
        for spec in input_specs:
            dims = list(spec.dims)
            if any(d < 0 for d in dims[1:]):
                return
            np_dtype = triton_to_np_dtype(spec.datatype)
            if np_dtype is None or np_dtype == np.object_:
                return
            shapes[spec.name] = (dims[1:], np_dtype)
        buckets = _buckets_up_to(self.max_batch)
        if self.model.fused_batching:
            tshapes = {name: (tuple(dims), _torch_dtype(dt))
                       for name, (dims, dt) in shapes.items()}
            self._programs_for([(self._program_key(b, tshapes), b, tshapes)
                                for b in buckets])
            return
        # one eager forward per bucket: cuDNN and cuBLAS pick their
        # algorithms for each shape.  A device group's forward runs at the
        # same shapes (its parts assembled into a bucket buffer), so
        # unlike the reference's executables it needs no pass of its own.
        with device_stream(self.model.device):
            for b in buckets:
                zeros = {
                    name: np.zeros([b] + dims, dtype=np_dtype)
                    for name, (dims, np_dtype) in shapes.items()
                }
                _to_host(self.model.fn(zeros, {}, None))

    # -- request side -----------------------------------------------------

    def queue_depth(self):
        """Requests currently waiting in the queue."""
        with self._cond:
            return len(self._queue)

    def queue_depths_by_tenant(self):
        """{tenant: queued count}."""
        with self._cond:
            return self._queue.depths()

    def submit(self, inputs, trace=None, tenant="", weight=1.0, sinks=None):
        """Block until the batched execution finishes; return this request's
        slice of the outputs: host numpy arrays for wire groups, device
        tensors (its own) for device groups.  ``trace`` (a RequestTrace)
        gets QUEUE_END and COMPUTE_START at dispatch and COMPUTE_END when
        the results are handed over.  ``tenant``/``weight`` select and
        weight the fair-queue lane this request waits in.

        ``sinks`` ``{output: flat tensor}``: where a device request's rows
        of that output go (its CUDA shared-memory region, viewed as the
        output's dtype).  A fused program copies them there at dispatch,
        on the batcher's thread; the result then holds that view, and
        returns once the copy is done on the device.  Other paths ignore
        sinks."""
        rows = _leading_rows(inputs)
        # device-resident requests batch on the device and must never mix
        # with host groups: the signature's device flag keeps them apart
        device = all(_is_device_array(a) for a in inputs.values())
        signature = (device,) + tuple(
            (name, _dtype_key(arr), tuple(arr.shape[1:]))
            for name, arr in sorted(inputs.items())
        )
        pending = _Pending(inputs, rows, signature, trace, tenant=tenant,
                           weight=weight, sinks=sinks)
        with self._cond:
            if self._closed:
                raise InferenceServerException(
                    f"model '{self.model.name}' is shutting down", status="500"
                )
            if (
                self.max_queue_depth is not None
                and len(self._queue) >= self.max_queue_depth
            ):
                # retryable overload: the client backs off and re-submits
                if self._registry is not None:
                    self._registry.inc(
                        "ctpu_requests_shed_total",
                        {"reason": "queue_full"},
                        help_="Requests shed with a retryable 503",
                    )
                raise InferenceServerException(
                    f"model '{self.model.name}' queue is full "
                    f"({len(self._queue)} >= {self.max_queue_depth} queued); "
                    "retry after backoff",
                    status="503",
                )
            self._queue.push(pending)
            self._cond.notify()
        pending.event.wait()
        if pending.error is not None:
            raise pending.error
        return pending.result

    def close(self, shutdown_timeout_s=30.0):
        # one deadline budget shared across every shutdown phase (batcher
        # join, host-completion drain, observer close)
        deadline = time.monotonic() + shutdown_timeout_s
        with self._cond:
            self._closed = True
            self._cond.notify_all()
        self._thread.join(timeout=max(deadline - time.monotonic(), 0.0))
        # Host completion tasks for batches already dispatched finish
        # before leftovers are failed; bounded, so a task wedged on a
        # stalled device cannot hang close().
        with self._host_cv:
            self._host_closed = True
            self._host_cv.notify_all()
            while self._host_outstanding or self._host_q:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    break
                self._host_cv.wait(timeout=remaining)
            host_threads = list(self._host_threads)
        # the completion workers return once closed and drained; a worker
        # that ran torch ops and is still alive at interpreter exit
        # aborts the process, so close() waits for them (bounded)
        for thread in host_threads:
            thread.join(timeout=max(deadline - time.monotonic(), 0.0))
        self._observer.close(timeout=max(deadline - time.monotonic(), 0.0))
        # Fail anything still queued (drained under the lock: items the
        # batcher thread already popped are its to complete).
        with self._cond:
            leftovers = self._queue.drain()
        for p in leftovers:
            p.error = InferenceServerException("server shutdown", status="500")
            p.event.set()

    # -- batcher thread ----------------------------------------------------

    def _loop(self):
        try:
            self._run()
        except BaseException:  # noqa: BLE001 - a dead batcher must not strand waiters
            with self._cond:
                self._closed = True
                leftovers = self._queue.drain() + [
                    p for p in self._active if not p.event.is_set()
                ]
                self._active.clear()
            err = InferenceServerException(
                f"model '{self.model.name}' batcher thread died", status="500"
            )
            for p in leftovers:
                p.error = err
                p.event.set()
            raise

    def _run(self):
        # Pipelined dispatch: the batcher thread gathers and issues batches;
        # completion waits run elsewhere (pool for host groups, the
        # watcher for device groups).
        while True:
            group = self._gather()
            if group is None:
                return
            device = group[0].signature[0]
            sem = self._sem_device if device else self._sem
            # Backpressure: block while the pipeline is full.  The queue
            # keeps filling meanwhile, and _topup folds those arrivals into
            # this batch: depth and batch size grow together under load.
            sem.acquire()
            self._topup(group)
            dispatched = self._dispatch(group)
            if dispatched is None:
                sem.release()
                continue
            with self._cond:
                self._inflight += 1
            if device:
                handed = self._handoff_device(*dispatched)
                if handed is None:  # handoff failed; group already notified
                    self._busy_end()
                    self._finish_one(sem)
                else:
                    watch, in_sinks = handed
                    with device_stream(self.model.device):
                        self._observer.watch(
                            watch,
                            lambda s=sem, w=in_sinks: self._finish_sinks(s, w)
                        )
            else:
                self._submit_host(dispatched)

    def _finish_sinks(self, sem, waiting):
        """A device group's work is done: release the requests whose rows
        went to their sinks, then the group's pipeline slot."""
        self._busy_end()
        for p in waiting:
            p.event.set()
        self._finish_one(sem)

    def _busy_end(self):
        if self._busy is not None:
            self._busy.end()

    def _finish_one(self, sem):
        with self._cond:
            self._inflight -= 1
            # wake a _gather waiting out its peer-delay: with nothing in
            # flight the delay no longer buys anything
            self._cond.notify_all()
        sem.release()

    # -- host-group completion workers --------------------------------------

    def _submit_host(self, dispatched):
        with self._host_cv:
            self._host_q.append(dispatched)
            self._host_threads = [
                t for t in self._host_threads if t.is_alive()
            ]
            if len(self._host_threads) < _PIPELINE_DEPTH:
                t = threading.Thread(
                    target=self._host_loop,
                    name=f"batcher-{self.model.name}-done",
                    daemon=True,
                )
                self._host_threads.append(t)
                t.start()
            self._host_cv.notify()

    def _host_loop(self):
        # one guard per pass: an escaped exception would kill this
        # completion worker silently and strand every group behind it
        while True:
            try:
                if not self._host_once():
                    return
            except Exception:
                pass

    def _host_once(self):
        """Complete one dispatched host group; False once closed and
        drained."""
        with self._host_cv:
            while not self._host_q and not self._host_closed:
                self._host_cv.wait()
            if not self._host_q:
                self._host_cv.notify_all()  # wake the close() waiter
                return False
            dispatched = self._host_q.popleft()
            self._host_outstanding += 1
        try:
            self._complete_host(*dispatched)
        finally:
            with self._host_cv:
                self._host_outstanding -= 1
                self._host_cv.notify_all()
            self._finish_one(self._sem)
        return True

    def _drain_compatible_locked(self, group, first, rows, max_arity):
        """Fold queued signature-compatible requests into *group* (no wait),
        taken in fair-queue order.  Caller holds self._cond.  Returns the
        updated row count."""
        while rows < self.max_batch and len(group) < max_arity:
            taken = self._queue.take_first(
                lambda p, rows=rows: (
                    p.signature == first.signature
                    and rows + p.rows <= self.max_batch
                )
            )
            if taken is None:
                break
            self._active.add(taken)
            group.append(taken)
            rows += taken.rows
        return rows

    def _max_arity(self, first):
        # fused device groups cap the part count (one copy a part into
        # the bucket at dispatch)
        return (
            self.max_fused_arity
            if first.signature[0] and self.model.fused_batching
            else self.max_batch
        )

    def _gather(self):
        """Take the oldest request and fold in signature-compatible peers.

        Batch-while-busy: the timed max_queue_delay wait for peers only
        happens while at least one batch is dispatched-but-incomplete; an
        idle pipeline dispatches immediately, so low-concurrency requests
        pay no artificial queue delay."""
        with self._cond:
            while not self._queue:
                if self._closed:
                    return None
                self._cond.wait()
            first = self._queue.pop()
            self._active.add(first)
            group = [first]
            max_arity = self._max_arity(first)
            rows = self._drain_compatible_locked(
                group, first, first.rows, max_arity
            )
            deadline = time.monotonic() + self.max_queue_delay_s
            while (
                rows < self.max_batch
                and len(group) < max_arity
                and self._inflight > 0
                and not self._closed
            ):
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    break
                self._cond.wait(timeout=remaining)
                rows = self._drain_compatible_locked(
                    group, first, rows, max_arity
                )
            return group

    def _topup(self, group):
        """Last-moment fold-in of arrivals that queued while the pipeline
        semaphore blocked (or between gather and dispatch)."""
        with self._cond:
            first = group[0]
            rows = sum(p.rows for p in group)
            self._drain_compatible_locked(
                group, first, rows, self._max_arity(first)
            )

    def _prof_commit(self, rows, t0, t_in, infer_ns, output_ns):
        """Fold one completed group into the engine's continuous profiler
        (serve/prof.py) as a "batch" tick, reusing the timestamps
        record_batched already took.  Queue wait is omitted: it overlaps
        other groups' device time."""
        prof = self.prof
        if prof is None:
            return
        prof.commit(
            "batch",
            (t_in - t0 + infer_ns + output_ns) / 1e9,
            phases={
                "host": (t_in - t0) / 1e9,
                "compute": infer_ns / 1e9,
                "render": output_ns / 1e9,
            },
            model=self.model.name,
            items=rows,
            flops_per_item=self.model.flops_per_item,
        )

    def _dispatch(self, group):
        """Pad the group to its bucket and issue the (asynchronous)
        forward.  Returns state for the completion, or None if the
        dispatch failed (the group is already notified).

        The engine duty-cycle span opens here and closes when the group's
        results are complete (the completion observer for device groups,
        the host copy for wire groups) or it fails."""
        t0 = time.monotonic_ns()
        w_dispatch = time.time_ns()
        for p in group:
            if p.trace is not None:
                p.trace.event("QUEUE_END", w_dispatch)
                p.trace.event("COMPUTE_START", w_dispatch)
        if self._busy is not None:
            self._busy.begin()
        try:
            device = group[0].signature[0]
            names = [e[0] for e in group[0].signature[1:]]
            rows = sum(p.rows for p in group)
            if self.model.fused_batching:
                t_in = time.monotonic_ns()
                result = self._run_program(group, names, rows)
                return group, result, rows, t0, t_in
            # rows <= max_batch by construction, so padded >= rows always.
            padded = _bucket(rows, cap=self.max_batch)
            batched = {}
            for name in names:
                parts = [p.inputs[name] for p in group]
                if device:
                    # a lone full-bucket part skips assembly (zero-copy)
                    if len(parts) == 1 and parts[0].shape[0] == padded:
                        batched[name] = parts[0]
                    else:
                        with device_stream(parts[0].device):
                            batched[name] = _device_batch(parts, padded)
                else:
                    if padded > rows:
                        pad = np.zeros(
                            (padded - rows,) + tuple(parts[0].shape[1:]),
                            dtype=parts[0].dtype,
                        )
                        parts = parts + [pad]
                    batched[name] = (
                        np.concatenate(parts, axis=0)
                        if len(parts) > 1
                        else parts[0]
                    )
            t_in = time.monotonic_ns()
            with device_stream(self.model.device):
                result = self.model.fn(batched, {}, None)
            return group, result, rows, t0, t_in
        except Exception as e:  # noqa: BLE001 - failure propagates per-request
            self._busy_end()
            self._fail(group, e)
            return None

    def _handoff_device(self, group, result, rows, t0, t_in):
        """Hand a device group's results to its waiters at dispatch time
        (the device work may still be running: every consumer is ordered
        after it on the default stream), except a request whose rows went
        to its sinks: another process reads those, so it is released once
        the work is done.  Returns what the watcher should observe for
        completion and the requests it releases then, or None on failure
        (the group is already notified)."""
        in_sinks = []
        try:
            w_done = time.time_ns()
            if isinstance(result, tuple) and result[0] == "fused":
                # each request's rows, copied at dispatch: into its sinks
                # or a view of the group's own copy
                per_part = result[1]
                for p, rows_of in zip(group, per_part):
                    p.result = rows_of
                    # trace events land BEFORE the waiter wakes: the
                    # request thread completes the trace once it runs
                    if p.trace is not None:
                        p.trace.event("COMPUTE_END", w_done)
                    if p.sinks:
                        in_sinks.append(p)
                    else:
                        p.event.set()
                watch = per_part
            else:
                # batch-wide response parameters replicate, never slice
                # (reserved "__parameters__" result key)
                extra_params = (
                    result.pop("__parameters__", None)
                    if isinstance(result, dict)
                    else None
                )
                offset = 0
                for p in group:
                    # whole-buffer pass-through when one request fills the
                    # bucket; a row view otherwise
                    p.result = {
                        name: arr
                        if offset == 0 and p.rows == arr.shape[0]
                        else _device_split(arr, offset, p.rows)
                        for name, arr in result.items()
                    }
                    if extra_params is not None:
                        p.result["__parameters__"] = extra_params
                    offset += p.rows
                    if p.trace is not None:
                        p.trace.event("COMPUTE_END", w_done)
                    p.event.set()
                watch = result
            with self._cond:
                self._active.difference_update(group)
            t1 = time.monotonic_ns()
            self.stats.record_batched(
                rows=rows,
                infer_ns=t1 - t_in,
                input_ns=t_in - t0,
                output_ns=0,
                queue_ns=sum(t_in - p.t_enq for p in group),
                queue_ns_each=[t_in - p.t_enq for p in group],
            )
            self._prof_commit(rows, t0, t_in, t1 - t_in, 0)
            return watch, in_sinks
        except Exception as e:  # noqa: BLE001 - failure propagates per-request
            self._fail(group, e)
            return None

    def _complete_host(self, group, result, rows, t0, t_in):
        """Wire-group completion (runs on the completion pool): the
        batch's rows reach the host, then split back to requests.  The
        busy span closes when they have: real completion."""
        busy_open = self._busy is not None
        try:
            with device_stream(self.model.device):
                host = _to_host(result)
            if busy_open:
                self._busy.end()  # wire results landed host-side
                busy_open = False
            t_inf = time.monotonic_ns()
            # response-level parameters (reserved "__parameters__" result
            # key) are batch-wide, not row-sliceable: replicate them onto
            # every request's split instead of slicing a dict
            extra_params = host.pop("__parameters__", None)
            w_done = time.time_ns()
            offset = 0
            for p in group:
                p.result = {
                    name: arr[offset : offset + p.rows]
                    for name, arr in host.items()
                }
                if extra_params is not None:
                    p.result["__parameters__"] = extra_params
                offset += p.rows
                if p.trace is not None:
                    p.trace.event("COMPUTE_END", w_done)
                p.event.set()
            with self._cond:
                self._active.difference_update(group)
            t1 = time.monotonic_ns()
            self.stats.record_batched(
                rows=rows,
                infer_ns=t_inf - t_in,
                input_ns=t_in - t0,
                output_ns=t1 - t_inf,
                queue_ns=sum(t_in - p.t_enq for p in group),
                queue_ns_each=[t_in - p.t_enq for p in group],
            )
            self._prof_commit(rows, t0, t_in, t_inf - t_in, t1 - t_inf)
        except Exception as e:  # noqa: BLE001 - failure propagates per-request
            if busy_open:
                self._busy.end()  # the copy raised before the span closed
            self._fail(group, e)

    def _fail(self, group, e):
        err = (
            e
            if isinstance(e, InferenceServerException)
            else InferenceServerException(
                f"{self.model.name}: batched execution failed: {e}",
                status="500",
                debug_details=e,
            )
        )
        for p in group:
            p.error = err
            p.event.set()
        with self._cond:
            self._active.difference_update(group)


def _leading_rows(inputs):
    for arr in inputs.values():
        if arr.ndim == 0:
            raise InferenceServerException(
                "batchable model input must have a leading batch dimension",
                status="400",
            )
        return int(arr.shape[0])
    raise InferenceServerException("request has no inputs", status="400")


def _fits_a_bucket(model, inputs):
    """Whether the inputs are all host arrays (no BYTES) or all device
    tensors, with one leading row count no larger than the largest
    bucket."""
    if len({_is_device_array(a) for a in inputs.values()}) != 1:
        return False  # none, or host and device mixed
    rows = set()
    for arr in inputs.values():
        if isinstance(arr, np.ndarray):
            if arr.dtype == np.object_:
                return False  # BYTES inputs: direct path
        elif not _is_device_array(arr):
            return False
        if arr.ndim == 0:
            return False
        rows.add(int(arr.shape[0]))
    return len(rows) == 1 and rows.pop() <= model.max_batch_size


def direct_program_request(model, inputs, context):
    """Whether a request that is not batched runs through its bucket's
    program (:meth:`ModelBatcher.run_direct`) instead of ``model.fn``:
    a ``fused_batching`` model's stateless request that a bucket holds.
    A fused ``fn`` is torch-pure and sets no per-response parameters, so
    the program gives its outputs whatever the request's parameters."""
    return (model.fused_batching and model.dynamic_batching
            and not model.decoupled and context is None
            and model.max_batch_size > 1 and _fits_a_bucket(model, inputs))


def batchable_request(model, inputs, params, context, request):
    """Whether this request may take the dynamic-batching path."""
    if not model.dynamic_batching or model.decoupled:
        return False
    if context is not None or params.get("sequence_id"):
        return False
    # Request parameters beyond rendering hints reach model.fn on the direct
    # path; the batcher calls fn once for many requests and cannot honor
    # per-request parameters, so any such request keeps the direct path.
    if any(k not in ("binary_data_output",) for k in params):
        return False
    if model.max_batch_size <= 1:
        return False
    device = bool(inputs) and all(
        _is_device_array(a) for a in inputs.values()
    )
    if device and not model.batch_device_inputs:
        # device-resident inputs dispatch directly by default: fusing adds
        # assemble/split device work per request, pure overhead on a path
        # that pays no H2D either way.  Models opt in per model.
        return False
    if not device:
        for out in request.get("outputs") or []:
            # shm outputs of host groups stay on the direct path
            if "shared_memory_region" in (out.get("parameters") or {}):
                return False
    # mixed host/device inputs in one request keep the direct path (a device
    # concat would silently copy the host parts or vice versa)
    return _fits_a_bucket(model, inputs)
