"""The repo's C++ gRPC examples over the port's protobuf-free gRPC client,
on the CPU.

The 14 examples of the Makefile's ``GRPC_EXAMPLES`` are built unedited
with g++ alone (``tools/examples_suite.py``'s ``build_cpp_grpc_examples``:
``client_tpu_torch/perf/csrc`` ahead of ``src/cpp/client`` on the include
path, the hand-written codec in place of protoc's messages) into
``build/torch_cpp/``; no protoc and no libprotobuf.  Each prints its PASS
line against a port ``Server(device="cpu", grpc_port=0)``, and against
the JAX package's ``Server`` on the CPU prints what the Makefile-built
reference binary (protoc's messages and libprotobuf, made by
test_torch_cpp_grpc_examples.py's ``make_reference_binaries``) prints
against that same server, after :data:`MASKS`.  That comparison needs
protoc for the reference binaries: only it skips where protoc is absent.

The calls the port's header declares and does not make return an Error
that names them (a program built over the header calls each).
"""

import os
import re
import shutil
import subprocess
import sys

import pytest

sys.path.insert(0, os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "tools"))
import examples_suite as ex  # noqa: E402

BINARIES = list(ex.CPP_GRPC_EXAMPLES)
JOBS = 4

# (name, pattern, replacement), applied to both outputs of every example
MASKS = (
    # the deadline's error (simple_grpc_timeout_client): whether the
    # client's own deadline or the server's reset of the stream ends the
    # request first varies from run to run, for either build
    ("deadline error", re.compile(r"failed as expected \(.*\)$", re.M),
     "failed as expected (<deadline error>)"),
)


def masked(text):
    for _, pattern, repl in MASKS:
        text = pattern.sub(repl, text)
    return text


@pytest.fixture(scope="module")
def built():
    assert shutil.which("g++"), "the C++ examples build with g++"
    return ex.build_cpp_grpc_examples()


@pytest.fixture(scope="module")
def port_outcomes(built):
    from client_tpu_torch.serve import Server

    with Server(device="cpu", grpc_port=0) as s:
        runs = [ex.cpp_run(path, s.grpc_address) for path in built.values()]
        yield ex.run_all(runs, jobs=JOBS, timeout=100, python="")


@pytest.fixture(scope="module")
def jax_outcomes(built):
    if shutil.which("protoc") is None:
        pytest.skip("the reference binaries need protoc's KServe messages")
    import test_torch_cpp_grpc_examples as reference
    from client_tpu.serve import Server as JaxServer

    made = reference.make_reference_binaries(BINARIES)
    with JaxServer(grpc_port=0) as s:
        runs = [ex.cpp_run(built[n], s.grpc_address, key=f"port {n}")
                for n in BINARIES]
        runs += [ex.cpp_run(made[n], s.grpc_address, key=f"ref {n}")
                 for n in BINARIES]
        env = {**os.environ, "JAX_PLATFORMS": "cpu"}
        yield ex.run_all(runs, jobs=JOBS, timeout=100, env=env, python="")


def test_the_grpc_targets_are_the_makefile_ones():
    """The Makefile's GRPC_EXAMPLES, each from its own unedited source
    and the port's client: its codec, the repo's HTTP/2 transport and
    the system shared-memory helpers."""
    text = open(os.path.join(ex.ROOT, "Makefile")).read()
    listed = text.split("GRPC_EXAMPLES :=", 1)[1].split("\n\n", 1)[0]
    assert sorted(listed.replace("\\", " ").split()) == sorted(BINARIES)
    for name, sources in ex.cpp_grpc_targets().items():
        assert sources[0] == os.path.join(ex.ROOT, "src", "cpp", "examples",
                                          f"{name}.cc")
        assert all(os.path.isfile(s) for s in sources), name
        assert [os.path.basename(s) for s in sources[1:]] == [
            "grpc_client.cc", "kserve_wire.cc", "h2.cc", "hpack.cc",
            "transport.cc", "shm_utils.cc"]
        assert os.path.join(ex.ROOT, "src", "cpp", "client",
                            "grpc_client.cc") not in sources


def test_a_fresh_build_is_g_plus_plus_alone(tmp_path):
    """From scratch: one g++ a distinct source (the client's six compile
    once for all 14), then one link a binary; no command names protoc or
    protobuf, and no binary links libprotobuf."""
    from client_tpu_torch.perf import native_worker as native

    paths = ex.build_cpp_grpc_examples(build_dir=str(tmp_path))
    commands = native.last_build["commands"]
    assert len(commands) == (14 + 6) + 14
    assert all(cmd[0] == native.CXX for cmd in commands)
    assert not any("protoc" in arg or "protobuf" in arg
                   for cmd in commands for arg in cmd)
    assert sorted(paths) == sorted(BINARIES)
    for path in paths.values():
        assert os.access(path, os.X_OK)
        ldd = subprocess.run(["ldd", path], capture_output=True, text=True)
        assert ldd.returncode == 0, ldd.stderr
        assert "protobuf" not in ldd.stdout, ldd.stdout


def test_the_binaries_are_stamped_and_up_to_date(built):
    from client_tpu_torch.perf import native_worker as native

    for name, path in built.items():
        assert os.path.dirname(path) == ex.CPP_BUILD_DIR
        with open(path + ".stamp") as f:
            assert f.read().strip()
    before = native.last_build
    assert ex.build_cpp_grpc_examples() == built
    assert native.last_build is before  # up to date: nothing compiled


@pytest.mark.parametrize("name", BINARIES)
def test_example_passes_against_the_port_server(port_outcomes, name):
    out = port_outcomes[name]
    assert out.passed, out.describe()


@pytest.mark.parametrize("name", BINARIES)
def test_example_prints_what_the_reference_build_prints(jax_outcomes, name):
    port, ref = jax_outcomes[f"port {name}"], jax_outcomes[f"ref {name}"]
    assert port.passed, port.describe()
    assert ref.passed, ref.describe()
    assert masked(port.stdout).splitlines() == masked(ref.stdout).splitlines()
    assert port.stdout.count("\n") >= 1


def test_the_masks_take_only_what_they_name():
    line = "5ms deadline on 50ms model: failed as expected ({})"
    assert masked(line.format("timeout waiting for response")) == masked(
        line.format("h2 stream reset by peer (code 0)"))
    assert masked("0 + 1 = 1\nPASS : grpc_infer") == (
        "0 + 1 = 1\nPASS : grpc_infer")
    assert [name for name, _, _ in MASKS] == ["deadline error"]


UNMADE = r"""
#include <cstdio>
#include "grpc_client.h"

int main() {
  std::unique_ptr<ctpu::InferenceServerGrpcClient> client;
  ctpu::InferenceServerGrpcClient::Create(&client, "localhost:1");
  std::vector<ctpu::InferResult*> results;
  ctpu::InferenceServerGrpcClient::InferStat stat;
  const ctpu::Error errors[] = {
      client->InferMulti(&results, {}, {}),
      client->AsyncInferMulti([](std::vector<ctpu::InferResultPtr>) {}, {},
                              {}),
      client->ClientInferStat(&stat),
      client->RegisterTpuSharedMemory("r", "h", 0, 64),
      client->UnregisterTpuSharedMemory("r"),
  };
  for (const auto& e : errors)
    std::printf("%d %s\n", e.IsOk() ? 1 : 0, e.Message().c_str());
  return 0;
}
"""


def test_calls_the_client_does_not_make_return_errors_naming_them(tmp_path):
    """No silent success: each call the header declares and this client
    does not make returns an Error that names the call, and sends
    nothing (the client points at no server)."""
    from client_tpu_torch.perf import native_worker as native

    src = tmp_path / "unmade.cc"
    src.write_text(UNMADE)
    targets = {"unmade": [str(src), *ex.cpp_grpc_targets()[BINARIES[0]][1:]]}
    binary = native.build_natives(targets, str(tmp_path))["unmade"]
    out = subprocess.run([binary], capture_output=True, text=True,
                         timeout=30)
    assert out.returncode == 0, out.stderr
    lines = out.stdout.splitlines()
    calls = ["InferMulti", "AsyncInferMulti", "ClientInferStat",
             "RegisterTpuSharedMemory", "UnregisterTpuSharedMemory"]
    assert len(lines) == len(calls)
    for call, line in zip(calls, lines):
        assert line.startswith(f"0 {call} is not in the port's "
                               "protobuf-free gRPC client"), line
