"""Runs the native C++ load-generation worker (build/torch_cpp/perf_worker).

The port's copy of client_tpu/perf/native_worker.py.  The binary is the
harness's C++ engine, the reference perf_analyzer's native load path
(perf_analyzer.cc:56-424): N async InferContexts multiplexed on one HTTP/2
connection, completed by its reactor thread.  No GIL anywhere near the
measurement; the Python side only assembles arguments and parses the
one-line JSON report.

The worker is ``src/cpp/perf/perf_worker.cc``, compiled unedited by g++
alone at its first use into ``build/torch_cpp``: no protoc, no
libprotobuf.  ``csrc/`` comes first on the include path, so the worker's
``#include "grpc_client.h"`` takes this package's protobuf-free client
(``csrc/grpc_client.{h,cc}`` over the hand-written KServe codec
``csrc/kserve_wire.{h,cc}``), built over the repo's own HTTP/2 transport
(``src/cpp/grpc/h2.cc``, ``hpack.cc``, ``src/cpp/client/transport.cc``).
Each source compiles in a g++ process of its own, all started together,
then one link; under a file lock, so concurrent first uses build once.  A
stamp beside the binary (the hash of every source and header compiled,
the flags, ``g++ --version`` and the machine) decides a rebuild: a binary
built elsewhere or from other sources is never trusted.  A failed build
raises with the compiler's output: there is no fallback to the Python
engine.

CUDA-shm loads reference regions by name, as procpool's do: the
coordinator (Python, which owns the device) creates and registers the
regions; the native worker sends requests that name them.
"""

import fcntl
import hashlib
import json
import os
import subprocess
import time

from client_tpu_torch.utils import InferenceServerException

_HERE = os.path.dirname(os.path.abspath(__file__))
_ROOT = os.path.dirname(os.path.dirname(_HERE))
_CSRC = os.path.join(_HERE, "csrc")
_SRC = os.path.join(_ROOT, "src", "cpp")
BUILD_DIR = os.path.join(_ROOT, "build", "torch_cpp")
_DEFAULT_BINARY = os.path.join(BUILD_DIR, "perf_worker")

CXX = "g++"
CXXFLAGS = ["-O2", "-std=c++17"]
LIBS = ["-lpthread", "-lrt"]
# csrc/ ahead of src/cpp/client: grpc_client.h resolves to the port's
INCLUDES = [_CSRC, os.path.join(_SRC, "client"), os.path.join(_SRC, "grpc")]
HEADERS = [
    os.path.join(_CSRC, "kserve_messages.h"),
    os.path.join(_CSRC, "kserve_wire.h"),
    os.path.join(_CSRC, "grpc_client.h"),
    os.path.join(_SRC, "client", "common.h"),
    os.path.join(_SRC, "client", "transport.h"),
    os.path.join(_SRC, "grpc", "h2.h"),
    os.path.join(_SRC, "grpc", "hpack.h"),
]
WORKER_SOURCES = [
    os.path.join(_SRC, "perf", "perf_worker.cc"),
    os.path.join(_CSRC, "grpc_client.cc"),
    os.path.join(_CSRC, "kserve_wire.cc"),
    os.path.join(_SRC, "grpc", "h2.cc"),
    os.path.join(_SRC, "grpc", "hpack.cc"),
    os.path.join(_SRC, "client", "transport.cc"),
]
# the codec alone behind a line-oriented front end (tests)
WIRE_TOOL_SOURCES = [
    os.path.join(_CSRC, "kserve_wire_tool.cc"),
    os.path.join(_CSRC, "kserve_wire.cc"),
]

# the last build that compiled in this process: its wall seconds and the
# commands it ran
last_build = None


def native_worker_available(binary=None):
    return os.path.exists(binary or _DEFAULT_BINARY)


def _compiler_version():
    try:
        proc = subprocess.run([CXX, "--version"], capture_output=True,
                              text=True, timeout=60)
    except (OSError, subprocess.TimeoutExpired) as e:
        raise InferenceServerException(f"{CXX} --version failed: {e}") from e
    return proc.stdout


def build_stamp(sources, headers=None, includes=(), libs=()):
    """The hash that decides a rebuild: every source and header compiled
    (by path under the repo and content; *headers* defaults to the
    worker's), the flags (a build's own *includes* and *libs* among
    them), the compiler's ``--version`` and the machine (``uname -m``)."""
    h = hashlib.sha256()
    for path in sorted(set(sources) | set(HEADERS if headers is None
                                          else headers)):
        h.update(os.path.relpath(path, _ROOT).encode() + b"\0")
        try:
            with open(path, "rb") as f:
                h.update(f.read())
        except OSError as e:
            raise InferenceServerException(
                f"a native source is missing: {e}") from e
    h.update("\0".join([*CXXFLAGS, *LIBS, _compiler_version(),
                        os.uname().machine]).encode())
    if includes or libs:  # a build without its own flags keeps its stamp
        h.update("\0".join(["", *includes, "", *libs]).encode())
    return h.hexdigest()


def _libraries(sources):
    """LIBS, and zlib where a source includes it."""
    needs_z = False
    for path in sources:
        with open(path, "rb") as f:
            needs_z = needs_z or b"<zlib.h>" in f.read()
    return LIBS + (["-lz"] if needs_z else [])


def _compile_and_link(targets, build_dir, timeout_s, includes=(), libs=()):
    """One g++ process a source, all started together (a source several
    of *targets* share compiles once), then each target's link into a
    temporary name that replaces its binary.  *includes* (directories)
    follow INCLUDES, *libs* (link arguments) follow LIBS.  Returns the
    commands."""
    names = sorted(targets)
    objdir = os.path.join(build_dir, (names[0] if len(names) == 1
                                      else "shared") + ".objs")
    os.makedirs(objdir, exist_ok=True)
    includes = [f"-I{d}" for d in (*INCLUDES, *includes)]
    sources = list(dict.fromkeys(s for n in names for s in targets[n]))
    objects, commands, procs = {}, [], []
    deadline = time.monotonic() + timeout_s
    try:
        for i, src in enumerate(sources):
            obj = os.path.join(objdir, f"{i}_{os.path.basename(src)}.o")
            cmd = [CXX, *CXXFLAGS, *includes, "-c", src, "-o", obj]
            objects[src] = obj
            commands.append(cmd)
            procs.append(subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                          stderr=subprocess.STDOUT,
                                          text=True))
        failed = []
        for cmd, proc in zip(commands, procs):
            out, _ = proc.communicate(
                timeout=max(deadline - time.monotonic(), 1))
            if proc.returncode != 0:
                failed.append(f"{os.path.basename(cmd[-3])} "
                              f"({proc.returncode}): {out.strip()}")
        if failed:
            raise InferenceServerException("\n".join(failed))
        for name in names:
            tmp = os.path.join(build_dir, f".{name}.{os.getpid()}")
            cmd = [CXX, "-o", tmp, *(objects[s] for s in targets[name]),
                   *_libraries(targets[name]), *libs]
            commands.append(cmd)
            proc = subprocess.run(
                cmd, capture_output=True, text=True,
                timeout=max(deadline - time.monotonic(), 1))
            if proc.returncode != 0:
                raise InferenceServerException(
                    f"link of {name} ({proc.returncode}): "
                    f"{proc.stderr.strip() or proc.stdout.strip()}")
            os.replace(tmp, os.path.join(build_dir, name))
    except (OSError, subprocess.TimeoutExpired) as e:
        raise InferenceServerException(str(e)) from e
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    return commands


def build_natives(targets, build_dir=None, headers=None, timeout_s=600,
                  includes=(), libs=()):
    """Build each ``{name: sources}`` of *targets* into *build_dir*
    (default ``build/torch_cpp``) unless the stamp beside its binary
    matches (*headers*, *includes* and *libs*: as ``build_stamp``; the
    build's own include directories and link arguments, after the
    worker's); returns ``{name: path}``.  Raises InferenceServerException
    with the compiler's output when the build fails (the stamps and any
    older binaries stay)."""
    build_dir = build_dir or BUILD_DIR
    paths = {name: os.path.join(build_dir, name) for name in targets}
    global last_build
    try:
        os.makedirs(build_dir, exist_ok=True)
        with open(os.path.join(build_dir, ".lock"), "w") as lock:
            fcntl.flock(lock, fcntl.LOCK_EX)
            stale = {}
            for name, sources in targets.items():
                stamp = build_stamp(sources, headers, includes, libs)
                try:
                    with open(paths[name] + ".stamp") as f:
                        current = f.read().strip() == stamp
                except OSError:
                    current = False
                if not (current and os.path.exists(paths[name])):
                    stale[name] = stamp
            if not stale:
                return paths
            t0 = time.monotonic()
            commands = _compile_and_link(
                {name: targets[name] for name in stale}, build_dir,
                timeout_s, includes, libs)
            for name, stamp in stale.items():
                with open(paths[name] + ".stamp", "w") as f:
                    f.write(stamp + "\n")
            last_build = {"seconds": time.monotonic() - t0,
                          "commands": commands}
    except (InferenceServerException, OSError) as e:
        what = ", ".join(n.replace("_", " ") for n in sorted(targets))
        raise InferenceServerException(
            f"building the native {what} failed: {str(e)[-2000:]}") from e
    return paths


def build_native(name, sources, build_dir=None, timeout_s=600):
    """Build *name* from *sources* into *build_dir* (default
    ``build/torch_cpp``) unless the stamp beside it matches; returns its
    path.  Raises InferenceServerException with the compiler's output
    when the build fails (the stamp and any older binary stay)."""
    return build_natives({name: sources}, build_dir,
                         timeout_s=timeout_s)[name]


def build_native_worker(timeout_s=600):
    """Build (or bring up to date) the default binary; returns its path.
    Raises InferenceServerException with the compiler's output when the
    build fails (on a machine without g++, for one)."""
    return build_native("perf_worker", WORKER_SOURCES, timeout_s=timeout_s)


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
