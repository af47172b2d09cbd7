#!/usr/bin/env python
"""Package the client_tpu wheel.

Parity with the reference's Python packaging (reference
src/python/library/setup.py: extras [http]/[grpc]/[all]) — here the
transports ride the standard library + grpcio/urllib3 and the native pieces
are the shm libraries built by `make native` (libcshm_tpu.so, the
libcshm.so analog) which build_wheel.py stages into the package before
bdist_wheel (reference build_wheel.py:165-179 pattern).
"""

import os

from setuptools import find_packages, setup

_HERE = os.path.dirname(os.path.abspath(__file__))


def _version():
    scope = {}
    with open(os.path.join(_HERE, "client_tpu", "_version.py")) as f:
        exec(f.read(), scope)
    return scope.get("__version__", "0.0.0")


setup(
    name="client-tpu",
    version=_version(),
    description=(
        "TPU-native KServe-v2 inference client framework: gRPC/HTTP clients "
        "(sync + asyncio), system and TPU-HBM shared-memory transports, "
        "in-process server, and a perf_analyzer-class load harness"
    ),
    license="BSD-3-Clause",
    packages=find_packages(include=[
        "client_tpu", "client_tpu.*", "client_tpu_torch", "client_tpu_torch.*",
    ]),
    package_data={
        "client_tpu.utils.shared_memory": ["libcshm_tpu.so"],
        "client_tpu.analysis": ["baseline.json"],
        # the port's CUDA sources, compiled on the GPU machine at first use
        "client_tpu_torch.ops": ["csrc/*.cu", "csrc/*.cuh", "csrc/*.cpp"],
        "client_tpu_torch.perf": ["csrc/*.h", "csrc/*.cc"],
        "client_tpu_torch.utils.cuda_shared_memory": ["cudashm.cpp"],
        "client_tpu_torch.analysis": ["baseline.json"],
    },
    python_requires=">=3.9",
    install_requires=["numpy>=1.22", "urllib3>=1.26", "protobuf>=3.19"],
    extras_require={
        "grpc": ["grpcio>=1.41"],
        "tpu": ["jax>=0.4.30"],
        "cuda": ["torch>=2.3"],
        "all": ["grpcio>=1.41", "jax>=0.4.30"],
    },
    entry_points={
        "console_scripts": [
            "client-tpu-perf=client_tpu.perf.__main__:main",
            "client-tpu-serve=client_tpu.serve.__main__:main",
            "client-tpu-torch-serve=client_tpu_torch.serve.__main__:main",
            "client-tpu-torch-perf=client_tpu_torch.perf.__main__:main",
            "client-tpu-lint=client_tpu.analysis.__main__:main",
            "client-tpu-torch-lint=client_tpu_torch.analysis.__main__:main",
        ],
    },
)
