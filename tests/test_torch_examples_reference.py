"""The reference's examples (examples/, clients of the JAX package)
against the port's server on the CPU: every one that honours ``-u`` runs
against one port ``Server(device="cpu", grpc_port=0, http_port=0)``
serving the builtin set, the CNN classifier and the language set.  Each
prints its PASS line, but the two that stage tensors in TPU HBM, which
receive the port's refusal (the port serves CUDA shared memory).  The
three replica examples start JAX servers of their own whatever ``-u``
says, so they test nothing of the port and are left out."""

import os
import sys

import pytest

sys.path.insert(0, os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "tools"))
import examples_suite as ex  # noqa: E402

JOBS = 4

URL_RUNS = [n for n in ex.reference_names()
            if ex.port_name(n) not in ex.REPLICAS]
REFUSED = {
    "simple_grpc_tpushm_client.py":
        "TPU shared memory is not supported by this server "
        "(use CudaSharedMemoryRegister)",
    "simple_http_tpushm_client.py":
        "TPU shared memory is not supported by this server "
        "(use cudasharedmemory)",
}


@pytest.fixture(scope="module")
def outcomes():
    from client_tpu_torch.serve import Server
    from client_tpu_torch.serve.models import language_models
    from client_tpu_torch.serve.models.vision import cnn_classifier_model

    models = [cnn_classifier_model(device="cpu")]
    models += language_models(device="cpu")
    env = {**os.environ, "JAX_PLATFORMS": "cpu"}
    with Server(models=models, device="cpu", grpc_port=0, http_port=0) as s:
        runs = [ex.url_run(ex.REFERENCE_DIR, n, s.grpc_address,
                           s.http_address) for n in URL_RUNS]
        yield ex.run_all(runs, jobs=JOBS, timeout=100, env=env)


def test_the_reference_examples_that_honour_url():
    """All 39 but the three replica examples: the 34 that
    tests/test_examples.py points at a server, image_client.py and
    llm_streaming_client.py."""
    assert len(URL_RUNS) == 36
    assert set(REFUSED) <= set(URL_RUNS)


@pytest.mark.parametrize("name", [n for n in URL_RUNS if n not in REFUSED])
def test_reference_example_passes_against_the_port_server(outcomes, name):
    out = outcomes[name]
    assert out.passed, out.describe()


@pytest.mark.parametrize("name", sorted(REFUSED))
def test_tpu_shared_memory_examples_get_the_port_refusal(outcomes, name):
    out = outcomes[name]
    assert out.rc != 0, out.describe()
    assert out.pass_line is None, out.describe()
    assert REFUSED[name] in out.stdout + out.stderr, out.describe()
