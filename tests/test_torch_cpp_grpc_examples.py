"""The repo's C++ gRPC clients against the port's server on the CPU,
where ``protoc`` is present: the Makefile builds the C++ gRPC examples of
its ``grpc_cpp`` target and ``cc_grpc_client_test`` (protoc's KServe
messages and libprotobuf) into build directories of their own
(``build/torch_ref_cpp_examples``: test_torch_native_worker.py makes the
reference worker in ``build/torch_ref_cpp`` at the same time under
``--dist loadfile``), and each prints its PASS line against one port
``Server(device="cpu", grpc_port=0)``.  ``simple_grpc_tpushm_client``
is left out: it stages tensors in TPU HBM, which the port refuses.
test_torch_cpp_grpc_protofree.py makes the same binaries (through
:func:`make_reference_binaries`, under a lock of the checkout) to hold the
port's builds of the examples against them."""

import fcntl
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
EXAMPLES = list(ex.CPP_GRPC_EXAMPLES)  # the Makefile's GRPC_EXAMPLES
BINARIES = EXAMPLES + ["cc_grpc_client_test"]

NO_PROTOC = ("the Makefile's C++ gRPC clients need protoc's KServe messages "
             "(the port's protobuf-free client makes 19 of the 31 "
             "Error-returning methods of src/cpp/client/grpc_client.h: the "
             "14 examples build over it, cc_grpc_client_test does not)")
pytestmark = pytest.mark.skipif(shutil.which("protoc") is None,
                                reason=NO_PROTOC)


def make_reference_binaries(names=BINARIES):
    """Make *names* with the Makefile (protoc and libprotobuf) into
    ``build/torch_ref_cpp_examples``, under a lock of the checkout: two
    test files make the same binaries.  Returns ``{name: path}``."""
    os.makedirs(os.path.join(ex.ROOT, "build"), exist_ok=True)
    with open(os.path.join(ex.ROOT, "build",
                           ".torch_ref_cpp_examples.lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        proc = subprocess.run(
            ["make", f"CPP_BUILD={BUILD}", f"PB_CPP={PROTO}",
             *(f"{BUILD}/{name}" for name in names),
             f"-j{min(os.cpu_count() or 1, 4)}"],
            cwd=ex.ROOT, capture_output=True, text=True, timeout=900)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return {name: os.path.join(ex.ROOT, BUILD, name) for name in names}


@pytest.fixture(scope="module")
def built():
    return make_reference_binaries()


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
