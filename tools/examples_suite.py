"""The examples corpus as a suite: which example takes which address and
options, and a runner that drives many of them at once against one
server.

``examples_torch/`` holds the port's counterpart of each program in the
reference's ``examples/``, under the same file name except where
:data:`RENAMED` says.  Each example is a client of a KServe-v2 server
(``-u host:port``) and prints a ``PASS:`` line when every check held.
:data:`GROUPS` says which examples must not run beside others against
one server; the rest run side by side.

The repo's C++ HTTP examples and ``cc_client_test`` (``src/cpp``) are
clients of the same servers: :func:`build_cpp_http_examples` builds them
with g++ alone, at first use, through the native worker's build.

The module imports neither torch nor grpc, and it reads the checkout's
layout (``examples/``, ``examples_torch/``, ``src/cpp``): the tests on
the CPU and ``chip_smoke.py`` on the card use the same tables and runner.
"""

import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT_DIR = os.path.join(ROOT, "examples_torch")
REFERENCE_DIR = os.path.join(ROOT, "examples")

# reference name -> the port's, where they differ: the reference stages
# tensors in TPU HBM, the port in CUDA device memory, under the names of
# Triton's own CUDA shared-memory examples
RENAMED = {
    "simple_grpc_tpushm_client.py": "simple_grpc_cudashm_client.py",
    "simple_http_tpushm_client.py": "simple_http_cudashm_client.py",
}

# the examples a gRPC address is given to (port names)
GRPC = (
    "simple_grpc_infer_client.py",
    "simple_grpc_async_infer_client.py",
    "simple_grpc_aio_infer_client.py",
    "simple_grpc_string_infer_client.py",
    "simple_grpc_model_control.py",
    "simple_grpc_sequence_stream_infer_client.py",
    "simple_grpc_sequence_sync_infer_client.py",
    "simple_grpc_aio_sequence_stream_infer_client.py",
    "simple_grpc_shm_client.py",
    "simple_grpc_shm_string_client.py",
    "simple_grpc_cudashm_client.py",
    "simple_grpc_health_metadata.py",
    "simple_grpc_keepalive_client.py",
    "simple_grpc_custom_args_client.py",
    "simple_grpc_custom_repeat.py",
    "simple_grpc_replicated_client.py",
    "simple_grpc_discovery_client.py",
    "ensemble_client.py",
    "ensemble_image_client.py",
    "reuse_infer_objects_client.py",
    "grpc_client.py",
    "grpc_image_client.py",
    "grpc_explicit_int_content_client.py",
    "grpc_explicit_int8_content_client.py",
    "grpc_explicit_byte_content_client.py",
    "memory_growth_test.py",
    "image_client.py",
    "llm_streaming_client.py",
)
# the examples an HTTP address is given to
HTTP = (
    "simple_http_infer_client.py",
    "simple_http_async_infer_client.py",
    "simple_http_aio_infer_client.py",
    "simple_http_string_infer_client.py",
    "simple_http_health_metadata.py",
    "simple_http_model_control.py",
    "simple_http_sequence_sync_infer_client.py",
    "simple_http_replicated_client.py",
    "simple_http_shm_client.py",
    "simple_http_shm_string_client.py",
    "simple_http_cudashm_client.py",
)
# ignore -u: they start their own replicas, on --device
REPLICAS = (
    "simple_grpc_replicated_client.py",
    "simple_http_replicated_client.py",
    "simple_grpc_discovery_client.py",
)
# stage tensors in CUDA regions: against a server in another process
# they need CUDA, and without it they exit with a message naming CUDA
CUDA_REGIONS = ("simple_grpc_cudashm_client.py",
                "simple_http_cudashm_client.py")
# the system-region examples: they register POSIX regions, and they
# unregister every system region of the server at start and end.  The
# reference's create their regions under fixed keys (/input_simple, ...):
# the suite runs those through OWN_KEYS, which makes each key the
# process's own, so that two runs at once (another test's, another
# checkout's) never unlink each other's region
SYSTEM_SHM = (
    "simple_grpc_shm_client.py",
    "simple_grpc_shm_string_client.py",
    "simple_http_shm_client.py",
    "simple_http_shm_string_client.py",
)
OWN_KEYS = os.path.join(ROOT, "tools", "own_shm_keys.py")
# how an example is scheduled beside others against one server, by its
# name (the Python examples' file names, the C++ binaries'); an example
# not named runs side by side ("parallel")
GROUPS = {
    # unload a model every other example infers on: run alone
    "simple_grpc_model_control.py": "alone",
    "simple_http_model_control.py": "alone",
    "simple_http_model_control": "alone",
    "simple_grpc_model_control": "alone",
    "cc_client_test": "alone",
    # register system regions where an example may unregister them all:
    # one after another
    **dict.fromkeys(SYSTEM_SHM, "serial"),
    "simple_http_shm_client": "serial",
    "simple_grpc_shm_client": "serial",
}

EXAMPLES = GRPC + HTTP

# the C++ HTTP examples (src/cpp/examples), as the Makefile's cpp target
# lists them, and the typed client suite; each takes ``-u host:port``
# (cc_client_test the address alone)
CPP_HTTP_EXAMPLES = (
    "simple_http_infer_client",
    "simple_http_health_metadata",
    "simple_http_async_infer_client",
    "simple_http_string_infer_client",
    "simple_http_shm_client",
    "simple_http_sequence_sync_infer_client",
    "simple_http_ensemble_client",
    "simple_http_infer_multi_client",
    "reuse_infer_objects_http_client",
    "simple_http_model_control",
)
CPP_BUILD_DIR = os.path.join(ROOT, "build", "torch_cpp")
_CPP = os.path.join(ROOT, "src", "cpp")
_CPP_CLIENT = [os.path.join(_CPP, "client", f"{n}.cc") for n in (
    "json", "http_client", "http_reactor", "shm_utils", "transport")]


def cpp_http_targets():
    """``{binary: sources}`` of the C++ HTTP examples and cc_client_test:
    each its own .cc and the HTTP client's sources."""
    targets = {n: [os.path.join(_CPP, "examples", f"{n}.cc"), *_CPP_CLIENT]
               for n in CPP_HTTP_EXAMPLES}
    targets["cc_client_test"] = [
        os.path.join(_CPP, "tests", "cc_client_test.cc"), *_CPP_CLIENT]
    return targets


def build_cpp_http_examples(build_dir=None, timeout_s=600):
    """Build (or bring up to date) the C++ HTTP examples and
    cc_client_test with g++ alone; a client source compiles once for all
    of them.  Returns ``{binary: path}``; raises
    InferenceServerException with the compiler's output when the build
    fails (no zlib headers, for one: the HTTP client links ``-lz``)."""
    from client_tpu_torch.perf.native_worker import build_natives

    headers = [os.path.join(_CPP, "client", n)
               for n in sorted(os.listdir(os.path.join(_CPP, "client")))
               if n.endswith(".h")]
    return build_natives(cpp_http_targets(), build_dir or CPP_BUILD_DIR,
                         headers=headers, timeout_s=timeout_s)


def cpp_run(binary, url, key=None):
    """The run of a C++ example (or cc_client_test) against *url*: an
    :class:`Run` whose script is the binary (run it with
    ``python=""``)."""
    name = os.path.basename(binary)
    argv = (url,) if name == "cc_client_test" else ("-u", url)
    return Run(key or name, binary, argv, group_of(name))


def port_name(name):
    """The port's file name for a reference example's *name*."""
    return RENAMED.get(name, name)


def reference_names():
    """The reference examples' file names, sorted."""
    return sorted(n for n in os.listdir(REFERENCE_DIR) if n.endswith(".py"))


@dataclass(frozen=True)
class Run:
    """One example process: *key* names it to the caller, *script* is
    its path, *argv* its arguments, *group* how it is scheduled
    (``parallel``, ``serial`` or ``alone``)."""

    key: str
    script: str
    argv: tuple
    group: str = "parallel"


@dataclass
class Outcome:
    key: str
    argv: tuple
    rc: int
    seconds: float
    stdout: str
    stderr: str

    @property
    def pass_line(self):
        """The example's ``PASS:`` line, or None."""
        for line in self.stdout.splitlines():
            if line.startswith("PASS"):
                return line
        return None

    @property
    def passed(self):
        return self.rc == 0 and self.pass_line is not None

    def describe(self, tail=3000):
        """The run, its exit code and the ends of its output, for an
        assertion message."""
        return (f"{self.key} {list(self.argv)}: rc {self.rc}\n"
                f"{self.stdout[-tail:]}\n{self.stderr[-tail:]}")


def group_of(name):
    """How example *name* (a reference or port file name, or a C++
    binary's) is scheduled: ``parallel``, ``serial`` or ``alone``."""
    return GROUPS.get(port_name(name), "parallel")


def url_run(directory, name, grpc_url, http_url, device=None, key=None,
            extra=()):
    """The run of example *name* (a file of *directory*) against the
    server at *grpc_url* / *http_url*; the replica examples get
    ``--device`` (they start their own servers) where *device* is given,
    and the reference's system-region examples run through
    :data:`OWN_KEYS`."""
    url = grpc_url if port_name(name) in GRPC else http_url
    argv = ("-u", url) + tuple(extra)
    if device is not None and port_name(name) in REPLICAS:
        argv += ("--device", device)
    script = os.path.join(directory, name)
    if directory == REFERENCE_DIR and name in SYSTEM_SHM:
        script, argv = OWN_KEYS, (script, *argv)
    return Run(key or name, script, argv, group_of(name))


def run_one(run, timeout=120.0, env=None, python=None):
    """Run one example to its end (or *timeout* seconds: rc -9 then)
    with *python* (this interpreter by default; ``""`` runs the script
    itself, a binary)."""
    start = time.perf_counter()
    interpreter = [] if python == "" else [python or sys.executable]
    try:
        proc = subprocess.run(
            [*interpreter, run.script, *run.argv],
            capture_output=True, text=True, timeout=timeout,
            env=env, cwd=ROOT,
        )
        rc, out, err = proc.returncode, proc.stdout, proc.stderr
    except subprocess.TimeoutExpired as e:
        rc = -9
        out = _text(e.stdout)
        err = _text(e.stderr) + f"\n(killed after {timeout} s)"
    return Outcome(run.key, run.argv, rc, time.perf_counter() - start, out,
                   err)


def _text(data):
    if data is None:
        return ""
    return data.decode(errors="replace") if isinstance(data, bytes) else data


def run_all(runs, jobs=8, timeout=120.0, env=None, python=None):
    """Run every one of *runs*: the ``parallel`` ones *jobs* at a time,
    the ``serial`` ones one after another in one of those slots, then
    the ``alone`` ones one by one.  Returns ``{key: Outcome}``."""
    runs = list(runs)
    keys = [r.key for r in runs]
    if len(set(keys)) != len(keys):
        raise ValueError(f"two runs share a key: {sorted(keys)}")
    serial = [r for r in runs if r.group == "serial"]
    alone = [r for r in runs if r.group == "alone"]
    parallel = [r for r in runs if r.group == "parallel"]

    def chain():
        return [run_one(r, timeout, env, python) for r in serial]

    results = {}
    with ThreadPoolExecutor(max_workers=max(1, jobs)) as pool:
        chained = pool.submit(chain) if serial else None
        futures = [pool.submit(run_one, r, timeout, env, python)
                   for r in parallel]
        for fut in futures:
            out = fut.result()
            results[out.key] = out
        for out in (chained.result() if chained else ()):
            results[out.key] = out
    for r in alone:
        results[r.key] = run_one(r, timeout, env, python)
    return results
