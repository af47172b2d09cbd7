"""The port's examples with ``--hermetic`` on the CPU: each starts its own
port server in process on ``--device cpu`` and prints its PASS line (the
CUDA shared-memory examples and ``image_client.py --shared-memory cuda``
with host regions the in-process broker resolves).  Without ``--device
cpu`` an example that starts a server exits with the port's refusal.
Split from test_torch_examples.py so that ``--dist loadfile`` spreads the
two."""

import os
import sys

import pytest

sys.path.insert(0, os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "tools"))
import examples_suite as ex  # noqa: E402

JOBS = 4

HERMETIC = sorted(
    n for n in os.listdir(ex.PORT_DIR)
    if n.endswith(".py")
    and "--hermetic" in open(os.path.join(ex.PORT_DIR, n)).read()
)
# without --device cpu, the examples that start a server refuse
REFUSE = ["simple_grpc_async_infer_client.py", "llm_streaming_client.py",
          "simple_http_replicated_client.py"]
CPU = ("--hermetic", "--device", "cpu")


@pytest.fixture(scope="module")
def outcomes():
    def run(key, name, argv):
        return ex.Run(key, os.path.join(ex.PORT_DIR, name), argv)

    runs = [run(n, n, CPU) for n in HERMETIC]
    # image_client's image batch (602,112 bytes) in a host region
    runs.append(run("image_client.py --shared-memory cuda", "image_client.py",
                    CPU + ("--shared-memory", "cuda")))
    runs += [run(f"refuse {n}", n,
                 () if n in ex.REPLICAS else ("--hermetic",)) for n in REFUSE]
    return ex.run_all(runs, jobs=JOBS, timeout=100)


def test_the_hermetic_examples_are_the_reference_ones():
    """The 27 examples with ``--hermetic`` (the reference's, the renamed
    pair included); each of them and the three replica examples takes
    ``--device``."""
    ref = sorted(
        ex.port_name(n) for n in ex.reference_names()
        if "--hermetic" in open(os.path.join(ex.REFERENCE_DIR, n)).read())
    assert HERMETIC == ref and len(HERMETIC) == 27
    for name in HERMETIC + list(ex.REPLICAS):
        text = open(os.path.join(ex.PORT_DIR, name)).read()
        assert '"--device", choices=["cuda", "cpu"], default="cuda"' in text, (
            name)


@pytest.mark.parametrize("name", HERMETIC)
def test_port_example_passes_hermetic_on_the_cpu(outcomes, name):
    out = outcomes[name]
    assert out.passed, out.describe()


def test_image_client_cuda_region_hermetic_on_the_cpu(outcomes):
    out = outcomes["image_client.py --shared-memory cuda"]
    assert out.passed, out.describe()


@pytest.mark.parametrize("name", REFUSE)
def test_examples_that_start_a_server_refuse_without_cuda(outcomes, name):
    """``--device`` is ``cuda`` unless ``cpu`` is given: without CUDA the
    example exits with the port's refusal and never carries on."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("this host has CUDA: the example runs on it")
    out = outcomes[f"refuse {name}"]
    assert out.rc != 0, out.describe()
    assert out.pass_line is None, out.describe()
    assert "runs on a CUDA device by default and none is available" in (
        out.stderr), out.describe()
    assert "Traceback" not in out.stderr, out.describe()
