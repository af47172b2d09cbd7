"""The repo's C++ HTTP clients against the port's server on the CPU.

tests/test_cpp_client.py runs them against the JAX server where ``make
cpp`` has built them (it skips otherwise).  Here ``cc_client_test`` and
the ten C++ HTTP examples of the Makefile's ``cpp`` target are built at
first use with g++ alone (``tools/examples_suite.py``'s
``build_cpp_http_examples``, through the native worker's build: one g++ a
source, a client source compiled once for all of them, a stamp deciding
a rebuild) into ``build/torch_cpp/``, and each prints its PASS line
against one port ``Server(device="cpu", http_port=0)``."""

import os
import shutil
import sys

import pytest

sys.path.insert(0, os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "tools"))
import examples_suite as ex  # noqa: E402

BINARIES = sorted(ex.cpp_http_targets())


@pytest.fixture(scope="module")
def built():
    assert shutil.which("g++"), "the C++ clients build with g++"
    return ex.build_cpp_http_examples()


@pytest.fixture(scope="module")
def outcomes(built):
    from client_tpu_torch.serve import Server

    with Server(device="cpu", http_port=0) as s:
        runs = [ex.cpp_run(path, s.http_address)
                for path in built.values()]
        yield ex.run_all(runs, jobs=4, timeout=100, python="")


def test_the_cpp_targets_are_the_makefile_ones():
    """The Makefile's HTTP_EXAMPLES and cc_client_test, each from its
    own source and the HTTP client's five."""
    text = open(os.path.join(ex.ROOT, "Makefile")).read()
    listed = text.split("HTTP_EXAMPLES :=", 1)[1].split("\n\n", 1)[0]
    names = [w for w in listed.replace("\\", " ").split()]
    assert sorted(names) == sorted(ex.CPP_HTTP_EXAMPLES)
    targets = ex.cpp_http_targets()
    assert sorted(targets) == sorted([*names, "cc_client_test"])
    for name, sources in targets.items():
        assert all(os.path.isfile(s) for s in sources), name
        assert len(sources) == 6


def test_the_binaries_are_stamped_and_up_to_date(built):
    from client_tpu_torch.perf import native_worker as native

    for name, path in built.items():
        assert os.path.dirname(path) == ex.CPP_BUILD_DIR
        assert os.access(path, os.X_OK), name
        with open(path + ".stamp") as f:
            assert f.read().strip()
    before = native.last_build
    assert ex.build_cpp_http_examples() == built
    assert native.last_build is before  # up to date: nothing compiled


def test_a_fresh_build_is_g_plus_plus_alone_with_shared_objects(tmp_path):
    """From scratch: one g++ a distinct source (the HTTP client's five
    compile once for all eleven binaries), then one link a binary; no
    command names protoc or protobuf."""
    from client_tpu_torch.perf import native_worker as native

    paths = ex.build_cpp_http_examples(build_dir=str(tmp_path))
    commands = native.last_build["commands"]
    targets = ex.cpp_http_targets()
    sources = {s for srcs in targets.values() for s in srcs}
    assert len(commands) == len(sources) + len(targets) == 16 + 11
    assert all(cmd[0] == native.CXX for cmd in commands)
    assert not any("protoc" in arg or "protobuf" in arg
                   for cmd in commands for arg in cmd)
    assert sorted(paths) == sorted(targets)
    assert all(os.access(p, os.X_OK) for p in paths.values())


@pytest.mark.parametrize("name", BINARIES)
def test_cpp_client_passes_against_the_port_server(outcomes, name):
    out = outcomes[name]
    assert out.passed, out.describe()
    if name == "cc_client_test":
        assert "PASS: cc_client_test" in out.stdout
