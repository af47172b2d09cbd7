"""The edges of libccudashm, the C ABI of CUDA regions
(client_tpu_torch/utils/cuda_shared_memory/ccudashm.{h,cc}), and of the
C++ CUDA shared-memory example's build, on the CPU, where there is no
CUDA toolkit.

- ``ccudashm.h`` compiles alone, as C++ and as C, with no CUDA header;
  the example (``examples_torch/cpp/simple_grpc_cudashm_client.cc``) and
  the ABI's line tool compile with g++ alone over it and the port's gRPC
  client's header: only ``ccudashm.cc`` includes ``cuda_runtime.h``.
- Where ``cuda_runtime.h`` is absent, as here, the CUDA build is refused
  with an InferenceServerException that names the CUDA headers; nothing
  is built and nothing is skipped.
- The toolkit is found from the directory given, from ``nvcc`` on PATH,
  or from ``CUDA_HOME``, in that order (a fake toolkit of empty files).

On the card, ``chip_smoke.py`` phase 29 builds and runs both.
"""

import os
import re
import shutil
import stat
import subprocess
import sys

import pytest

sys.path.insert(0, os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "tools"))
import examples_suite as ex  # noqa: E402

from client_tpu_torch.utils import InferenceServerException  # noqa: E402

HEADER = os.path.join(ex.CUDA_SHM_DIR, "ccudashm.h")
CSRC = os.path.join(ex.ROOT, "client_tpu_torch", "perf", "csrc")
CLIENT_INCLUDES = [f"-I{d}" for d in (
    CSRC, os.path.join(ex.ROOT, "src", "cpp", "client"),
    os.path.join(ex.ROOT, "src", "cpp", "grpc"), ex.CUDA_SHM_DIR)]


def no_cuda_here():
    return (shutil.which("nvcc") is None
            and not os.environ.get("CUDA_HOME"))


@pytest.mark.parametrize("language", ["c++", "c"])
def test_the_header_compiles_alone_without_cuda(tmp_path, language):
    compiler = "g++" if language == "c++" else "gcc"
    src = tmp_path / ("use.cc" if language == "c++" else "use.c")
    src.write_text(
        '#include "ccudashm.h"\n'
        "int f(void* r) { char h[CUDA_SHM_HANDLE_BYTES];\n"
        "  return CudaShmGetRawHandle(r, h, sizeof(h)) == "
        "CUDA_SHM_HANDLE_BYTES ? CUDA_SHM_OK : CUDA_SHM_ERR_CUDA; }\n")
    proc = subprocess.run(
        [compiler, "-fsyntax-only", "-Wall", "-Werror", f"-I{ex.CUDA_SHM_DIR}",
         str(src)], capture_output=True, text=True)
    assert proc.returncode == 0, proc.stderr


@pytest.mark.parametrize("source", [
    ex.CPP_CUDA_EXAMPLE, os.path.join(ex.CUDA_SHM_DIR, "ccudashm_tool.cc")])
def test_the_example_and_the_tool_compile_without_cuda_headers(source):
    proc = subprocess.run(
        ["g++", "-std=c++17", "-fsyntax-only", "-Wall", "-Werror",
         *CLIENT_INCLUDES, source], capture_output=True, text=True)
    assert proc.returncode == 0, proc.stderr


def test_only_the_abi_source_includes_cuda():
    sources = {s for srcs in ex.cpp_cuda_targets().values() for s in srcs}
    with_cuda = {os.path.basename(s) for s in [*sources, HEADER]
                 if re.search(r"^#include <cuda", open(s).read(), re.M)}
    assert with_cuda == {"ccudashm.cc"}


def test_the_cuda_build_is_refused_naming_cuda_headers(tmp_path):
    if not no_cuda_here():
        pytest.skip("a CUDA toolkit is here: the build is not refused")
    before = sorted(os.listdir(tmp_path))
    with pytest.raises(InferenceServerException, match="cuda_runtime.h"):
        ex.build_cpp_cuda_examples(build_dir=str(tmp_path))
    with pytest.raises(InferenceServerException,
                       match="no nvcc on PATH and no CUDA_HOME"):
        ex.cuda_toolkit()
    assert sorted(os.listdir(tmp_path)) == before  # nothing built


def test_a_toolkit_without_headers_is_refused_naming_where(tmp_path):
    with pytest.raises(InferenceServerException) as info:
        ex.cuda_toolkit(str(tmp_path))
    assert "cuda_runtime.h" in str(info.value)
    assert str(tmp_path) in str(info.value)


def fake_toolkit(root, lib="lib64"):
    os.makedirs(os.path.join(root, "include"))
    os.makedirs(os.path.join(root, lib))
    os.makedirs(os.path.join(root, "bin"))
    for path in ("include/cuda_runtime.h", f"{lib}/libcudart.so"):
        open(os.path.join(root, path), "w").close()
    nvcc = os.path.join(root, "bin", "nvcc")
    with open(nvcc, "w") as f:
        f.write("#!/bin/sh\nexit 0\n")
    os.chmod(nvcc, os.stat(nvcc).st_mode | stat.S_IEXEC)
    return str(root)


def test_the_toolkit_is_found_given_then_nvcc_then_cuda_home(tmp_path,
                                                             monkeypatch):
    given = fake_toolkit(tmp_path / "given")
    on_path = fake_toolkit(tmp_path / "on_path", lib="lib")
    home = fake_toolkit(
        tmp_path / "home", lib=os.path.join("targets", "x86_64-linux", "lib"))
    monkeypatch.setenv("PATH", os.path.join(on_path, "bin") + os.pathsep
                       + os.environ["PATH"])
    monkeypatch.setenv("CUDA_HOME", home)
    assert ex.cuda_toolkit(given) == (os.path.join(given, "include"),
                                      os.path.join(given, "lib64"))
    assert ex.cuda_toolkit() == (os.path.join(on_path, "include"),
                                 os.path.join(on_path, "lib"))
    monkeypatch.setenv("PATH", os.pathsep.join(
        p for p in os.environ["PATH"].split(os.pathsep) if on_path not in p))
    assert ex.cuda_toolkit() == (
        os.path.join(home, "include"),
        os.path.join(home, "targets", "x86_64-linux", "lib"))


def test_the_cuda_targets_are_the_example_and_the_tool():
    targets = ex.cpp_cuda_targets()
    assert sorted(targets) == ["ccudashm_tool", "simple_grpc_cudashm_client"]
    example = targets["simple_grpc_cudashm_client"]
    assert example[:2] == [ex.CPP_CUDA_EXAMPLE,
                           os.path.join(ex.CUDA_SHM_DIR, "ccudashm.cc")]
    assert example[2:] == ex.cpp_grpc_targets()["image_client"][1:]
    assert [os.path.basename(s) for s in targets["ccudashm_tool"]] == [
        "ccudashm_tool.cc", "ccudashm.cc"]
    assert all(os.path.isfile(s) for srcs in targets.values() for s in srcs)
