"""The repo's C++ gRPC clients against the port's server on the CPU,
where ``protoc`` is present: the Makefile builds the C++ gRPC examples of
its ``grpc_cpp`` target and ``cc_grpc_client_test`` (protoc's KServe
messages and libprotobuf) into build directories of their own
(``build/torch_ref_cpp_examples``: test_torch_native_worker.py makes the
reference worker in ``build/torch_ref_cpp`` at the same time under
``--dist loadfile``), and each prints its PASS line against one port
``Server(device="cpu", grpc_port=0)``.  ``simple_grpc_tpushm_client``
is left out: it stages tensors in TPU HBM, which the port refuses."""

import os
import shutil
import subprocess
import sys

import pytest

sys.path.insert(0, os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "tools"))
import examples_suite as ex  # noqa: E402

BUILD = "build/torch_ref_cpp_examples"
PROTO = "build/torch_ref_proto_cpp_examples"
EXAMPLES = [
    "simple_grpc_infer_client",
    "simple_grpc_sequence_stream_infer_client",
    "simple_grpc_sequence_sync_infer_client",
    "simple_grpc_async_infer_client",
    "simple_grpc_health_metadata",
    "simple_grpc_model_control",
    "simple_grpc_shm_client",
    "simple_grpc_string_infer_client",
    "simple_grpc_ensemble_client",
    "simple_grpc_decoupled_repeat_client",
    "simple_grpc_custom_args_client",
    "simple_grpc_timeout_client",
    "image_client",
    "reuse_infer_objects_grpc_client",
]
BINARIES = EXAMPLES + ["cc_grpc_client_test"]

pytestmark = pytest.mark.skipif(
    shutil.which("protoc") is None,
    reason="the C++ gRPC clients need protoc's KServe messages "
           "(the port's protobuf-free client has 6 of their 35 calls)")


@pytest.fixture(scope="module")
def built():
    proc = subprocess.run(
        ["make", f"CPP_BUILD={BUILD}", f"PB_CPP={PROTO}",
         *(f"{BUILD}/{name}" for name in BINARIES),
         f"-j{min(os.cpu_count() or 1, 4)}"],
        cwd=ex.ROOT, capture_output=True, text=True, timeout=900)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return {name: os.path.join(ex.ROOT, BUILD, name) for name in BINARIES}


@pytest.fixture(scope="module")
def outcomes(built):
    from client_tpu_torch.serve import Server

    with Server(device="cpu", grpc_port=0) as s:
        runs = [ex.Run(name, path,
                       (s.grpc_address,) if name == "cc_grpc_client_test"
                       else ("-u", s.grpc_address),
                       ex.group_of(name))
                for name, path in built.items()]
        yield ex.run_all(runs, jobs=4, timeout=150, python="")


def test_the_grpc_examples_are_the_makefile_ones():
    text = open(os.path.join(ex.ROOT, "Makefile")).read()
    listed = text.split("GRPC_EXAMPLES :=", 1)[1].split("\n\n", 1)[0]
    assert sorted(listed.replace("\\", " ").split()) == sorted(EXAMPLES)


@pytest.mark.parametrize("name", BINARIES)
def test_cpp_grpc_client_passes_against_the_port_server(outcomes, name):
    out = outcomes[name]
    assert out.passed, out.describe()
