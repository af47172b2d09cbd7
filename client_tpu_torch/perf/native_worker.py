"""Runs the native C++ load-generation worker (build/torch_cpp/perf_worker).

The port's copy of client_tpu/perf/native_worker.py.  The binary is the
harness's C++ engine, the reference perf_analyzer's native load path
(perf_analyzer.cc:56-424): N async InferContexts multiplexed on one HTTP/2
connection, completed by its reactor thread.  No GIL anywhere near the
measurement; the Python side only assembles arguments and parses the
one-line JSON report.

The binary is the JAX package's own worker, built from this checkout's
``src/cpp`` at its first use into ``build/torch_cpp`` (the Makefile's
``perf_worker`` target with the build directories redirected), under a
file lock so concurrent first uses build it once.  A failed build raises
with make's output: there is no fallback to the Python engine.

CUDA-shm loads reference regions by name, as procpool's do: the
coordinator (Python, which owns the device) creates and registers the
regions; the native worker sends requests that name them.
"""

import fcntl
import json
import os
import subprocess

from client_tpu_torch.utils import InferenceServerException

_ROOT = os.path.dirname(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
)
_BUILD = "build/torch_cpp"
_DEFAULT_BINARY = os.path.join(_ROOT, _BUILD, "perf_worker")
_MAKE = ["make", f"CPP_BUILD={_BUILD}", "PB_CPP=build/torch_proto_cpp",
         f"{_BUILD}/perf_worker"]


def native_worker_available(binary=None):
    return os.path.exists(binary or _DEFAULT_BINARY)


def build_native_worker(timeout_s=600):
    """Build (or bring up to date) the default binary; returns its path.
    Raises InferenceServerException with make's output when the build
    fails (on a machine without protoc or libprotobuf, for one)."""
    os.makedirs(os.path.join(_ROOT, _BUILD), exist_ok=True)
    with open(os.path.join(_ROOT, _BUILD, ".lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            proc = subprocess.run(
                _MAKE + [f"-j{min(os.cpu_count() or 1, 4)}"], cwd=_ROOT,
                capture_output=True, text=True, timeout=timeout_s,
            )
        except (OSError, subprocess.TimeoutExpired) as e:
            raise InferenceServerException(
                f"building the native perf worker failed: {e}"
            ) from e
    if proc.returncode != 0:
        raise InferenceServerException(
            f"building the native perf worker failed ({proc.returncode}): "
            f"{(proc.stderr.strip() or proc.stdout.strip())[-2000:]}"
        )
    return _DEFAULT_BINARY


def native_windows_stable(windows, threshold, window_count=3):
    """DetermineStability over trailing native windows (reference
    inference_profiler.h:365-399): throughput and p99 latency of the last
    ``window_count`` windows each within ±threshold of their mean."""
    if len(windows) < window_count:
        return False
    tail = windows[-window_count:]
    for key in ("throughput", "p99_us"):
        vals = [w[key] for w in tail]
        avg = sum(vals) / len(vals)
        if avg <= 0 or any(abs(v - avg) > threshold * avg for v in vals):
            return False
    return True


def run_native_worker(url, model_name, *, concurrency, duration_s,
                      warmup_s=1.0, wire_inputs=(), shm_inputs=(),
                      shm_outputs=(), binary=None, timeout_s=None,
                      request_rate=0.0, distribution="constant",
                      window_interval_s=0.0, completion_sync=False,
                      sequences=0, seq_steps=8, decoupled=False):
    """One native measurement (fixed concurrency, request-rate schedule, or
    bidi sequence streaming).

    wire_inputs: [(name, datatype, shape)] — random bytes generated in the
    worker.  shm_inputs: [(name, datatype, shape, region, nbytes)].
    shm_outputs: [(name, region, nbytes)].

    request_rate > 0 switches the worker to an open-loop schedule
    (constant or poisson inter-arrivals) with `concurrency` capping the
    outstanding requests; the report then carries a ``delayed`` count.
    completion_sync requests wire outputs instead of shm outputs, so every
    recorded latency covers the outputs' arrival (completion, not ack).
    sequences > 0 drives that many stateful sequences of seq_steps over the
    bidi stream instead of unary AsyncInfer.  decoupled drives
    N-responses-per-request streaming (the LLM token-stream shape): latency
    samples are time-to-first-response, completion rides the
    triton_final_response marker, and the report carries the total content
    ``responses`` count.  wire_inputs entries may carry a constant fill as
    a 4th element (name, datatype, shape, value) — required for decoupled
    models whose input encodes the response count.

    Without *binary*, the default binary is built (or brought up to date)
    first.  Returns the worker's final report dict (ok/errors/delayed/
    elapsed_s/throughput/p50_us/.../avg_us/mode): ``ok`` and ``errors``
    count the requests that completed inside the measured window, not the
    warm-up or the drain after it.  With window_interval_s > 0 the report
    also carries the per-window records under ``windows`` — the feed for
    the profiler's stability loop over native load.
    """
    binary = binary or build_native_worker()
    if not os.path.exists(binary):
        raise InferenceServerException(
            f"native perf worker not built: {binary}"
        )
    cmd = [binary, "-u", url, "-m", model_name, "-c", str(concurrency),
           "-d", str(duration_s), "-w", str(warmup_s)]
    if request_rate > 0:
        cmd += ["-r", str(request_rate), "--distribution", distribution]
    if window_interval_s > 0:
        cmd += ["--window-interval", str(window_interval_s)]
    if completion_sync:
        cmd += ["--completion-sync"]
    if sequences > 0:
        cmd += ["--sequences", str(sequences), "--seq-steps", str(seq_steps)]
    if decoupled:
        cmd += ["--decoupled"]
    for entry in wire_inputs:
        name, datatype, shape = entry[0], entry[1], entry[2]
        dims = ",".join(str(int(d)) for d in shape)
        fill = f"={int(entry[3])}" if len(entry) > 3 else ""
        cmd += ["--wire-input", f"{name}:{datatype}:{dims}{fill}"]
    for name, datatype, shape, region, nbytes in shm_inputs:
        dims = ",".join(str(int(d)) for d in shape)
        cmd += ["--shm-input", f"{name}:{datatype}:{dims}:{region}:{nbytes}"]
    for name, region, nbytes in shm_outputs:
        cmd += ["--shm-output", f"{name}:{region}:{nbytes}"]
    proc = subprocess.run(
        cmd, capture_output=True, text=True,
        timeout=timeout_s or (warmup_s + duration_s + 90),
    )
    if proc.returncode != 0:
        raise InferenceServerException(
            f"native perf worker failed ({proc.returncode}): "
            f"{proc.stderr.strip() or proc.stdout.strip()}"
        )
    try:
        lines = [ln for ln in proc.stdout.strip().splitlines() if ln.strip()]
        report = json.loads(lines[-1])
        windows = []
        for ln in lines[:-1]:
            try:
                doc = json.loads(ln)
            except json.JSONDecodeError:
                continue
            if "window" in doc:
                windows.append(doc)
        if windows:
            report["windows"] = windows
        return report
    except (json.JSONDecodeError, IndexError) as e:
        raise InferenceServerException(
            f"malformed native worker report: {proc.stdout!r}"
        ) from e
