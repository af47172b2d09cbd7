"""Ensemble DAG scheduler: server-side model pipelines with device-resident
intermediates.

Counterpart of client_tpu/serve/pipeline.py:

- **Parse + validate at load time** (:func:`build_dag`): the ensemble's
  steps become an explicit dependency DAG over ensemble tensors.  Cycles,
  unknown composing models, unmapped composing inputs, dangling tensors,
  producer/consumer dtype (and comparable-rank shape) mismatches, and
  decoupled composing models are rejected with a 400 when the ensemble is
  *added or loaded*, not at the first unlucky infer.

- **Concurrent ready steps** (:class:`PipelineRunner`): independent
  branches run in parallel; pure chains keep the zero-thread sequential
  path.

- **The normal scheduling path per step**: a step is dispatched exactly
  like a direct request to the composing model: through the model's
  dynamic batcher when the request is batchable (so ensemble steps from
  concurrent requests fuse into real device batches), directly otherwise,
  recording real per-composing-model statistics.

- **Device-resident intermediates**: when the consumer step is
  torch-backed and the tensor a producer step made is a device tensor, it
  is handed over as is, with no host round trip
  (``ctpu_ensemble_device_handoffs_total``).  Host materialization happens
  only for python-platform consumers (``ctpu_ensemble_host_hops_total``)
  and at the DAG boundary when the response is rendered.  Every step runs
  on its device's default stream (``dynamic_batcher.device_stream``), so
  a handed-over CUDA tensor is ordered after the work that made it.

- **Failure semantics**: a failing step cancels every not-yet-started
  step, the error names the failing step, and the composing model's
  failure plus the ensemble-level failure are each recorded exactly once.
  A composing model unloaded mid-flight surfaces as the engine's clean
  400, never a hang.  Nested ensembles recurse through this scheduler.
"""

import queue
import threading
import time

from client_tpu_torch.serve.dynamic_batcher import (
    _is_device_array,
    _to_host,
    batchable_request,
    device_stream,
)
from client_tpu_torch.utils import InferenceServerException

__all__ = [
    "ENSEMBLE_RESERVED_PARAMS",
    "EnsembleDag",
    "PipelineRunner",
    "build_dag",
]

# Request parameters that configure the *ensemble* request itself and must
# not leak into composing-model executions: sequence identity binds to the
# ensemble, rendering hints
# apply only to the ensemble's own response, and decoupled-completion
# markers have no meaning mid-DAG.  Everything else (model-defined params
# like temperature/seed) threads through to every step.
ENSEMBLE_RESERVED_PARAMS = frozenset(
    {
        "sequence_id",
        "sequence_start",
        "sequence_end",
        "binary_data_output",
        "triton_enable_empty_final_response",
        "priority",
        "timeout",
    }
)


def step_params(params):
    """Request parameters forwarded to composing models (reserved keys
    stripped) — the fix for ensemble steps silently running with ``{}``."""
    return {
        k: v for k, v in (params or {}).items()
        if k not in ENSEMBLE_RESERVED_PARAMS
    }


def is_torch_model(model):
    """Whether a composing model consumes device tensors natively (its fn
    is torch-backed), so an upstream device tensor hands off with zero
    host I/O."""
    return (model.platform.startswith("torch")
            or model.backend.startswith("torch"))


class _Step:
    """One parsed ensemble step and its resolved dependencies."""

    __slots__ = ("index", "model_name", "input_map", "output_map", "deps",
                 "consumers")

    def __init__(self, index, model_name, input_map, output_map):
        self.index = index
        self.model_name = model_name
        self.input_map = dict(input_map)    # composing input <- ensemble tensor
        self.output_map = dict(output_map)  # composing output -> ensemble tensor
        self.deps = set()        # step indices whose outputs this step reads
        self.consumers = set()   # step indices reading this step's outputs

    @property
    def label(self):
        return f"step_{self.index}:{self.model_name}"


class EnsembleDag:
    """Validated dependency DAG for one ensemble model."""

    __slots__ = ("model_name", "steps", "is_chain", "order", "produced")

    def __init__(self, model_name, steps, is_chain, order, produced):
        self.model_name = model_name
        self.steps = steps
        self.is_chain = is_chain
        self.order = order        # step indices in topological order
        self.produced = produced  # ensemble tensors produced by steps


def _reject(ensemble_name, message):
    raise InferenceServerException(
        f"ensemble '{ensemble_name}': {message}", status="400"
    )


def _spec_maps(model):
    inputs = {t.name: t for t in model.inputs}
    outputs = {t.name: t for t in model.outputs}
    return inputs, outputs


def _shapes_conflict(src_dims, dst_dims):
    """True when two equal-rank specs pin conflicting fixed dims.  Specs of
    different rank are not comparable here — models like the builtin
    ``identity`` declare ``[-1]`` meaning "any shape"."""
    if len(src_dims) != len(dst_dims):
        return False
    return any(
        s >= 0 and d >= 0 and s != d for s, d in zip(src_dims, dst_dims)
    )


def build_dag(model, lookup):
    """Parse + validate *model*'s ensemble_scheduling into an EnsembleDag.

    *lookup* maps a model name to its Model (or None).  Raises a 400
    InferenceServerException on any structural problem so the ensemble is
    rejected at add/load time, never at infer time.
    """
    name = model.name
    if not model.ensemble_steps:
        _reject(name, "ensemble_scheduling has no steps")
    ens_inputs, ens_outputs = _spec_maps(model)

    steps = []
    producer = {}        # ensemble tensor -> producing step index
    produced_spec = {}   # ensemble tensor -> composing output TensorSpec
    for i, raw in enumerate(model.ensemble_steps):
        sub_name = raw.get("model_name")
        if not sub_name:
            _reject(name, f"step {i} has no model_name")
        step = _Step(i, sub_name, raw.get("input_map") or {},
                     raw.get("output_map") or {})
        if sub_name == name:
            _reject(name, f"step {i} refers to the ensemble itself")
        sub = lookup(sub_name)
        if sub is None:
            _reject(
                name,
                f"step {i} names unknown composing model '{sub_name}'",
            )
        if sub.decoupled:
            _reject(
                name,
                f"step {i}: composing model '{sub_name}' is decoupled; "
                "a mid-DAG response stream cannot be honored",
            )
        sub_inputs, sub_outputs = _spec_maps(sub)
        for ci in step.input_map:
            if ci not in sub_inputs:
                _reject(
                    name,
                    f"step {i} input_map names '{ci}', which is not an "
                    f"input of composing model '{sub_name}'",
                )
        missing = [
            t.name for t in sub.inputs
            if t.name not in step.input_map and not t.optional
        ]
        if missing:
            _reject(
                name,
                f"step {i} leaves composing model '{sub_name}' inputs "
                f"{missing} unmapped",
            )
        for co, et in step.output_map.items():
            if co not in sub_outputs:
                _reject(
                    name,
                    f"step {i} output_map names '{co}', which is not an "
                    f"output of composing model '{sub_name}'",
                )
            if et in producer:
                _reject(
                    name,
                    f"tensor '{et}' is produced by both step "
                    f"{producer[et]} and step {i}",
                )
            if et in ens_inputs:
                _reject(
                    name,
                    f"step {i} produces tensor '{et}', which shadows an "
                    "ensemble input",
                )
            producer[et] = i
            produced_spec[et] = sub_outputs[co]
        steps.append(step)

    # Resolve each step input to its source (ensemble input or producing
    # step) and check dtype/shape agreement producer -> consumer.
    for step in steps:
        sub = lookup(step.model_name)
        sub_inputs, _ = _spec_maps(sub)
        for ci, et in step.input_map.items():
            dst = sub_inputs[ci]
            if et in ens_inputs:
                src = ens_inputs[et]
            elif et in producer:
                if producer[et] == step.index:
                    _reject(
                        name,
                        f"step {step.index} reads its own output tensor "
                        f"'{et}' (self-cycle)",
                    )
                step.deps.add(producer[et])
                src = produced_spec[et]
            else:
                _reject(
                    name,
                    f"step {step.index} reads tensor '{et}', which is "
                    "neither an ensemble input nor produced by any step "
                    "(dangling tensor)",
                )
            if src.datatype != dst.datatype:
                _reject(
                    name,
                    f"step {step.index} input '{ci}' expects "
                    f"{dst.datatype} but tensor '{et}' carries "
                    f"{src.datatype}",
                )
            if _shapes_conflict(src.dims, dst.dims):
                _reject(
                    name,
                    f"step {step.index} input '{ci}' dims {dst.dims} "
                    f"conflict with tensor '{et}' dims {src.dims}",
                )
    for step in steps:
        for d in step.deps:
            steps[d].consumers.add(step.index)

    # Every ensemble output must be produced (or be a pass-through input),
    # with matching dtype.
    for out_name, spec in ens_outputs.items():
        if out_name in ens_inputs:
            src = ens_inputs[out_name]
        elif out_name in producer:
            src = produced_spec[out_name]
        else:
            _reject(
                name,
                f"output tensor '{out_name}' is not produced by any step",
            )
        if src.datatype != spec.datatype:
            _reject(
                name,
                f"output tensor '{out_name}' is declared {spec.datatype} "
                f"but its producer carries {src.datatype}",
            )
        if _shapes_conflict(src.dims, spec.dims):
            _reject(
                name,
                f"output tensor '{out_name}' dims {spec.dims} conflict "
                f"with its producer's dims {src.dims}",
            )

    # Kahn topological check: leftover steps form a cycle.  The same walk
    # detects whether the DAG is a pure chain (at most one step ready at
    # any point) — chains skip the threaded scheduler entirely.
    indegree = {s.index: len(s.deps) for s in steps}
    ready = sorted(i for i, d in indegree.items() if d == 0)
    scheduled = []
    is_chain = True
    while ready:
        if len(ready) > 1:
            is_chain = False
        i = ready.pop(0)
        scheduled.append(i)
        for c in sorted(steps[i].consumers):
            indegree[c] -= 1
            if indegree[c] == 0:
                ready.append(c)
    if len(scheduled) != len(steps):
        stuck = sorted(set(indegree) - set(scheduled))
        _reject(
            name,
            "ensemble_scheduling steps "
            f"{[steps[i].label for i in stuck]} form a dependency cycle",
        )
    return EnsembleDag(name, steps, is_chain, scheduled, frozenset(producer))


class _StepOutcome:
    __slots__ = ("index", "outputs", "error", "work_ns")

    def __init__(self, index, outputs=None, error=None, work_ns=0):
        self.index = index
        self.outputs = outputs
        self.error = error
        self.work_ns = work_ns


class PipelineRunner:
    """Executes validated ensemble DAGs against an InferenceEngine.

    One runner per engine; all state is per-call, so concurrent requests
    share it freely.  Steps ride each composing model's normal scheduling
    path (dynamic batcher or direct dispatch): this class only sequences
    them and moves tensors between steps.
    """

    def __init__(self, engine):
        self._engine = engine

    # -- public entry --------------------------------------------------------

    def run(self, model, inputs, params):
        """Execute *model*'s DAG over *inputs*; returns
        ``(outputs, work_ns)`` where *outputs* maps the ensemble's declared
        output tensors and *work_ns* is the summed per-step duration: the
        exact quantity recorded as the ensemble's ``compute_infer``, so
        per-composing-model statistics reconcile against ensemble totals.
        """
        dag = model._dag  # validated at add/load
        self._engine.metrics.inc(
            "ctpu_ensemble_requests_total", {"model": model.name},
            help_="Requests executed by the ensemble DAG scheduler",
        )
        forwarded = step_params(params)
        pool = dict(inputs)
        if dag.is_chain:
            work_ns = self._run_chain(model, dag, pool, forwarded)
        else:
            work_ns = self._run_parallel(model, dag, pool, forwarded)
        missing = [t.name for t in model.outputs if t.name not in pool]
        if missing:
            raise InferenceServerException(
                f"ensemble '{model.name}' produced no tensor(s) {missing}",
                status="500",
            )
        return {t.name: pool[t.name] for t in model.outputs}, work_ns

    # -- schedulers ----------------------------------------------------------

    def _run_chain(self, model, dag, pool, forwarded):
        """Sequential path for pure chains: no threads, no queue."""
        work_ns = 0
        for position, index in enumerate(dag.order):
            outcome = self._run_step(model, dag, dag.steps[index], pool,
                                     forwarded)
            work_ns += outcome.work_ns
            if outcome.error is not None:
                self._note_cancelled(model, len(dag.steps) - position - 1)
                raise outcome.error
            pool.update(outcome.outputs)
        return work_ns

    def _run_parallel(self, model, dag, pool, forwarded):
        """Event-driven scheduler: every ready step dispatches immediately
        on its own worker thread; completions release their consumers.  On
        a step failure nothing new dispatches (the cancellation contract);
        already-running steps are drained so no worker outlives the call.
        """
        done = queue.Queue()
        pool_lock = threading.Lock()
        indegree = {s.index: len(s.deps) for s in dag.steps}
        ready = [dag.steps[i] for i, d in sorted(indegree.items()) if d == 0]
        inflight = 0
        executed = 0
        failures = 0
        failure = None
        work_ns = 0

        def worker(step):
            with pool_lock:
                snapshot = dict(pool)
            try:
                outcome = self._run_step(model, dag, step, snapshot,
                                         forwarded)
            except BaseException as e:  # noqa: BLE001 - thread boundary:
                # the worker must always post exactly one outcome or the
                # coordinator hangs on done.get()
                outcome = _StepOutcome(
                    step.index, error=self._step_error(model, step, e)
                )
            done.put(outcome)

        while ready or inflight:
            if len(ready) == 1 and not inflight:
                # a lone ready step with nothing to overlap runs directly
                # on the calling thread: chain-shaped stretches of a wide
                # DAG spawn no threads
                done.put(self._run_step(model, dag, ready.pop(), pool,
                                        forwarded))
                inflight += 1
            else:
                # thread-per-ready-step, deliberately not a shared bounded
                # pool: steps block on the batcher (and nested ensembles
                # dispatch steps of their own), so a finite pool could
                # deadlock parent steps waiting on children with no slot
                for step in ready:
                    t = threading.Thread(
                        target=worker, args=(step,), daemon=True,
                        name=f"ensemble-{model.name}-{step.label}",
                    )
                    try:
                        t.start()
                    except RuntimeError:
                        # thread limit hit: degrade to inline execution
                        worker(step)
                    inflight += 1
                ready = []
            # bounded: every dispatched worker always posts exactly one
            # outcome, success or failure
            outcome = done.get()
            inflight -= 1
            work_ns += outcome.work_ns
            if outcome.error is not None:
                failures += 1
                if failure is None:
                    failure = outcome.error
                continue  # drain remaining in-flight steps, dispatch nothing
            executed += 1
            with pool_lock:
                pool.update(outcome.outputs)
            if failure is None:
                for c in sorted(dag.steps[outcome.index].consumers):
                    indegree[c] -= 1
                    if indegree[c] == 0:
                        ready.append(dag.steps[c])
        if failure is not None:
            # dispatched steps all posted (executed + failures); the rest
            # were never dispatched
            self._note_cancelled(
                model, len(dag.steps) - executed - failures
            )
            raise failure
        return work_ns

    def _note_cancelled(self, model, count):
        if count > 0:
            self._engine.metrics.inc(
                "ctpu_ensemble_cancelled_steps_total",
                {"model": model.name}, value=count,
                help_="DAG steps never dispatched because an earlier step "
                      "failed",
            )

    # -- one step ------------------------------------------------------------

    def _run_step(self, ens, dag, step, pool, forwarded):
        """Execute one step; failures come back in the outcome so the
        schedulers control cancellation uniformly.  Only ``Exception`` is
        converted: KeyboardInterrupt/SystemExit propagate (the parallel
        scheduler's worker adds its own thread-boundary net)."""
        engine = self._engine
        metrics = engine.metrics
        t0 = time.monotonic_ns()
        try:
            # repository lookup per dispatch: a composing model unloaded
            # mid-flight fails THIS step with the engine's clean 400
            sub = engine.get_model(step.model_name, "")
            sub_inputs, hops, handoffs = self._map_inputs(
                step, sub, pool, dag.produced
            )
            t_in1 = time.monotonic_ns()
            if hops:
                metrics.inc(
                    "ctpu_ensemble_host_hops_total", {"model": ens.name},
                    value=hops,
                    help_="Device intermediates materialized to host for a "
                          "non-torch consumer step",
                )
            if handoffs:
                metrics.inc(
                    "ctpu_ensemble_device_handoffs_total",
                    {"model": ens.name}, value=handoffs,
                    help_="Device intermediates handed to a torch-backed "
                          "consumer step with zero host I/O",
                )
            out, total_ns = self._dispatch(step, sub, sub_inputs, forwarded,
                                           t0, t_in1)
            outputs = {}
            for co, et in step.output_map.items():
                if co not in out:
                    raise InferenceServerException(
                        f"composing model '{sub.name}' produced no output "
                        f"'{co}'", status="500",
                    )
                outputs[et] = out[co]
            metrics.inc(
                "ctpu_ensemble_steps_total",
                {"model": ens.name, "composing_model": step.model_name},
                help_="Ensemble DAG steps executed",
            )
            return _StepOutcome(step.index, outputs=outputs,
                                work_ns=total_ns)
        except Exception as e:
            metrics.inc(
                "ctpu_ensemble_step_failures_total",
                {"model": ens.name, "composing_model": step.model_name},
                help_="Ensemble DAG steps that failed",
            )
            return _StepOutcome(
                step.index, error=self._step_error(ens, step, e),
                work_ns=time.monotonic_ns() - t0,
            )

    def _dispatch(self, step, sub, sub_inputs, forwarded, t0, t_in1):
        """Route one step through the composing model's normal scheduling
        path and record its statistics under the composing model's name.
        Returns ``(result_arrays, total_ns)``; *total_ns* is exactly what
        lands in the composing model's success duration, so summed step
        durations reconcile with the ensemble's compute_infer total."""
        engine = self._engine
        sub_stats = engine._stats[sub.name]
        if sub.ensemble_steps:  # nested ensemble: recurse, record its stats
            try:
                out, work_ns = self.run(sub, sub_inputs, forwarded)
            except BaseException:
                sub_stats.record(False, time.monotonic_ns() - t0)
                raise
            total_ns = time.monotonic_ns() - t0
            sub_stats.record(
                True, total_ns, work_ns, t_in1 - t0, 0,
                batch=_rows_of(sub, sub_inputs),
            )
            return out, total_ns
        try:
            if batchable_request(sub, sub_inputs, forwarded, None, {}):
                # the batcher records execution-level statistics (queue /
                # compute split) under the composing model's name
                out = engine._batcher_for(sub).submit(sub_inputs)
                total_ns = time.monotonic_ns() - t0
                sub_stats.record_request_success(total_ns)
                return out, total_ns
            with device_stream(sub.device):
                out = sub.fn(sub_inputs, forwarded, None)
            t_inf1 = time.monotonic_ns()
            t_end = time.monotonic_ns()
            total_ns = t_end - t0
            # input = tensor mapping/residency conversion, infer = the
            # model call, output = the output-map fanout
            sub_stats.record(
                True, total_ns, t_inf1 - t_in1, t_in1 - t0, t_end - t_inf1,
                batch=_rows_of(sub, sub_inputs),
            )
            return out, total_ns
        except BaseException:
            sub_stats.record(False, time.monotonic_ns() - t0)
            raise

    def _map_inputs(self, step, sub, pool, produced):
        """Composing-model inputs from the tensor pool, honoring residency:
        torch-backed consumers take device tensors as they are (zero host
        I/O); python consumers get host arrays.  Only *intermediates*
        (tensors produced by an upstream step) count toward the
        handoff/hop metrics."""
        torch_backed = is_torch_model(sub)
        sub_inputs = {}
        hops = 0
        handoffs = 0
        for ci, et in step.input_map.items():
            try:
                arr = pool[et]
            except KeyError:
                raise InferenceServerException(
                    f"tensor '{et}' not available for step "
                    f"'{step.model_name}'", status="500",
                ) from None
            if _is_device_array(arr):
                if torch_backed:
                    handoffs += et in produced
                else:
                    with device_stream(arr.device):
                        arr = _to_host(arr)  # host materialization
                    hops += et in produced
            sub_inputs[ci] = arr
        return sub_inputs, hops, handoffs

    @staticmethod
    def _step_error(ens, step, exc):
        if isinstance(exc, InferenceServerException):
            message = exc.message() or str(exc)
            if message.startswith(f"ensemble '{ens.name}' step"):
                return exc  # already named by a nested level
            return InferenceServerException(
                f"ensemble '{ens.name}' step {step.index} "
                f"('{step.model_name}') failed: {message}",
                status=exc.status() or "500",
                debug_details=exc.debug_details(),
            )
        return InferenceServerException(
            f"ensemble '{ens.name}' step {step.index} "
            f"('{step.model_name}') failed: {exc}",
            status="500", debug_details=exc,
        )


def _rows_of(model, inputs):
    if model.max_batch_size <= 0:
        return 1
    for arr in inputs.values():
        shape = getattr(arr, "shape", None)
        if shape:
            return int(shape[0])
    return 1
