"""The port's examples corpus (examples_torch/) on the CPU.

tests/test_examples.py holds every reference example to its PASS line
against the JAX server; here each port example is held to its PASS line
against one port ``Server(device="cpu", grpc_port=0, http_port=0)``
serving the builtin set, the CNN classifier and the language set
(image_client's and llm_streaming_client's models).  The replica
examples start their own port servers (``--device cpu``), and out of
process without CUDA the examples that stage tensors in CUDA regions exit
nonzero with a message naming CUDA (test_torch_examples_hermetic.py runs
every example with ``--hermetic``).  The runs go through
``tools/examples_suite.py``, the runner chip_smoke.py's phase 29 uses
on the card.
"""

import os
import sys

import pytest

sys.path.insert(0, os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "tools"))
import examples_suite as ex  # noqa: E402

# examples a process runs at once here (the CPU is shared with the suite)
JOBS = 4

URL_RUNS = [n for n in ex.EXAMPLES if n not in ex.CUDA_REGIONS]
# out of process, a CUDA region needs CUDA: (key, example, extra argv)
NO_CUDA = [
    ("simple_grpc_cudashm_client.py", "simple_grpc_cudashm_client.py", ()),
    ("simple_http_cudashm_client.py", "simple_http_cudashm_client.py", ()),
    ("image_client.py --shared-memory cuda", "image_client.py",
     ("--shared-memory", "cuda")),
]


@pytest.fixture(scope="module")
def outcomes():
    from client_tpu_torch.serve import Server
    from client_tpu_torch.serve.models import language_models
    from client_tpu_torch.serve.models.vision import cnn_classifier_model

    models = [cnn_classifier_model(device="cpu")]
    models += language_models(device="cpu")
    with Server(models=models, device="cpu", grpc_port=0, http_port=0) as s:
        runs = [ex.url_run(ex.PORT_DIR, n, s.grpc_address, s.http_address,
                           device="cpu", key=f"url {n}") for n in URL_RUNS]
        runs += [ex.url_run(ex.PORT_DIR, n, s.grpc_address, s.http_address,
                            key=f"nocuda {key}", extra=extra)
                 for key, n, extra in NO_CUDA]
        yield ex.run_all(runs, jobs=JOBS, timeout=100)


@pytest.mark.parametrize("name", URL_RUNS)
def test_port_example_passes_against_the_port_server(outcomes, name):
    out = outcomes[f"url {name}"]
    assert out.passed, out.describe()


@pytest.mark.parametrize("key", [k for k, _, _ in NO_CUDA])
def test_cuda_region_examples_refuse_out_of_process_without_cuda(
        outcomes, key):
    import torch

    if torch.cuda.is_available():
        pytest.skip("this host has CUDA: the examples open their regions")
    out = outcomes[f"nocuda {key}"]
    assert out.rc != 0, out.describe()
    assert out.pass_line is None, out.describe()
    assert "CUDA" in out.stderr, out.describe()
    assert "Traceback" not in out.stderr, out.describe()


# -- the map: every reference example has its counterpart ------------------


def test_example_corpus_size():
    """One port example for each reference example, and nothing else."""
    ref = ex.reference_names()
    port = sorted(n for n in os.listdir(ex.PORT_DIR) if n.endswith(".py"))
    assert len(ref) == 39
    assert port == sorted(ex.port_name(n) for n in ref)


def test_every_reference_example_maps_to_its_counterpart():
    """Same file name, but for the two TPU shared-memory examples: the
    reference stages tensors in TPU HBM, the port in CUDA device memory,
    under the names of Triton's own CUDA shared-memory examples."""
    assert ex.RENAMED == {
        "simple_grpc_tpushm_client.py": "simple_grpc_cudashm_client.py",
        "simple_http_tpushm_client.py": "simple_http_cudashm_client.py",
    }
    for name in ex.reference_names():
        port = os.path.join(ex.PORT_DIR, ex.port_name(name))
        assert os.path.isfile(port), name
    assert sorted(ex.EXAMPLES) == sorted(
        n for n in os.listdir(ex.PORT_DIR) if n.endswith(".py"))
    assert not set(ex.GRPC) & set(ex.HTTP)


def test_port_examples_keep_the_reference_options_and_pass_lines():
    """A reader can diff the two: each port example keeps the reference
    example's options and PASS line (the renamed pair names CUDA where
    the reference names TPU), and adds ``--device`` only where it starts
    a server."""
    import re

    opt = re.compile(r'add_argument\(\s*"([^"]+)"(?:,\s*"([^"]+)")?')
    passes = re.compile(r'"(PASS:[^"{]*)')
    for name in ex.reference_names():
        ref = open(os.path.join(ex.REFERENCE_DIR, name)).read()
        port = open(os.path.join(ex.PORT_DIR, ex.port_name(name))).read()
        ref_opts = set(opt.findall(ref))
        port_opts = set(opt.findall(port))
        added = port_opts - ref_opts
        assert added <= {("--device", "")}, (name, added)
        if name in ex.RENAMED:
            assert ("--shared-memory", "") not in port_opts
            assert passes.findall(port) == [
                p.replace("tpu", "cuda") for p in passes.findall(ref)], name
            continue
        assert ref_opts <= port_opts, (name, ref_opts - port_opts)
        assert passes.findall(port) == passes.findall(ref), name
