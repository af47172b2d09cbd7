"""The port's examples print what the reference's print: each port
example against the port's ``Server(device="cpu")`` and its reference
example against the JAX ``Server``, both serving the builtin set, give the
same standard output after the masks below, and nothing else, are applied
to both.

Examples whose output rests on separately initialised weights (the CNN
classifier's scores, the tiny vision pipeline's, the language model's
text) are compared by structure in test_torch_examples_structure.py:
:data:`WEIGHTS` masks the numbers and text the weights decide, and every
other line must be equal.  The CUDA shared-memory pair is not compared:
the port's examples run against another process's server only with CUDA
(test_torch_examples_hermetic.py runs them in process), and their PASS
lines name CUDA where the reference's name TPU."""

import os
import re
import sys

import pytest

sys.path.insert(0, os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "tools"))
import examples_suite as ex  # noqa: E402

JOBS = 4

# (pattern, replacement), applied to both outputs of every example
MASKS = (
    # addresses: host:port of a server or replica
    (re.compile(r"\b(?:127\.0\.0\.1|localhost|\[::1?\]):\d+"), "<address>"),
    # timings: seconds or milliseconds a run took
    (re.compile(r"\b\d+(?:\.\d+)?\s?(?:ms|s)\b"), "<time>"),
    # RSS figures (memory_growth_test.py)
    (re.compile(r"\b\d+(?:\.\d+)?MB\b"), "<MB>"),
    # the server's own name in its metadata: each package names itself
    (re.compile(r"\bclient_tpu(?:_torch)?\.serve\b"), "<server>"),
)
# example -> (pattern, replacement): what its model's weights decide
WEIGHTS = {
    "image_client.py": (
        re.compile(r"^  \d+\.\d{4} \(\d+\) = class_\d+$", re.M),
        "  <score> (<class>) = <label>"),
    "ensemble_image_client.py": (
        re.compile(r"'\d\.\d{6}:\d+:class_\d+'"), "'<score>:<class>:<label>'"),
    "llm_streaming_client.py": (
        re.compile(r"^stream: .*$", re.M), "stream: <text>"),
}
COMPARED = [n for n in ex.reference_names()
            if n not in ex.RENAMED and n not in WEIGHTS]


def masked(name, text):
    for pattern, repl in MASKS:
        text = pattern.sub(repl, text)
    if name in WEIGHTS:
        pattern, repl = WEIGHTS[name]
        text = pattern.sub(repl, text)
    return text


def run_pairs(names, port, ref):
    """Each of *names* as a port example against *port* and as a
    reference example against *ref* (``{"port NAME"|"ref NAME": Outcome}``)."""
    runs = []
    for name in names:
        runs.append(ex.url_run(ex.PORT_DIR, name, port.grpc_address,
                               port.http_address, device="cpu",
                               key=f"port {name}"))
        runs.append(ex.url_run(ex.REFERENCE_DIR, name, ref.grpc_address,
                               ref.http_address, key=f"ref {name}"))
    env = {**os.environ, "JAX_PLATFORMS": "cpu"}
    return ex.run_all(runs, jobs=JOBS, timeout=100, env=env)


def assert_same_output(outcomes, name):
    port, ref = outcomes[f"port {name}"], outcomes[f"ref {name}"]
    assert port.passed, port.describe()
    assert ref.passed, ref.describe()
    got, want = masked(name, port.stdout), masked(name, ref.stdout)
    assert got.splitlines() == want.splitlines()
    assert got.count("\n") == want.count("\n") >= 1


@pytest.fixture(scope="module")
def outcomes():
    from client_tpu.serve import Server as JaxServer
    from client_tpu_torch.serve import Server

    with Server(device="cpu", grpc_port=0, http_port=0) as port, JaxServer(
            grpc_port=0, http_port=0) as ref:
        yield run_pairs(COMPARED, port, ref)


def test_the_masks_take_only_what_they_name():
    assert masked("x", "a 127.0.0.1:8001 b") == "a <address> b"
    assert masked("x", "took 12.5 ms, 3 s") == "took <time>, <time>"
    assert masked("x", "RSS 56.2MB -> 56.2MB") == "RSS <MB> -> <MB>"
    assert masked("x", "server: client_tpu_torch.serve 0.1.0") == (
        masked("x", "server: client_tpu.serve 0.1.0"))
    assert masked("x", "0 + 1 = 1\nround 2: ok") == "0 + 1 = 1\nround 2: ok"
    assert masked("x", "image top-3: ['0.861084:12:class_12']") == (
        "image top-3: ['0.861084:12:class_12']")
    assert set(WEIGHTS) <= set(ex.reference_names())
    assert len(COMPARED) + len(WEIGHTS) + len(ex.RENAMED) == 39


@pytest.mark.parametrize("name", COMPARED)
def test_port_example_prints_what_the_reference_prints(outcomes, name):
    assert_same_output(outcomes, name)
