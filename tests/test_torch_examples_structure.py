"""The examples whose output rests on separately initialised weights,
compared by structure: ``image_client.py`` (the CNN classifier's
scores), ``ensemble_image_client.py`` (the tiny vision pipeline's) and
``llm_streaming_client.py`` (the language model's text).  Each port
example against the port's ``Server(device="cpu")`` and its reference
example against the JAX ``Server``, both serving the builtin set, the
CNN classifier and the language set, print the same lines once
test_torch_examples_stdout.py's masks and what :data:`WEIGHTS` names for
the example are masked."""

import pytest

import test_torch_examples_stdout as st


@pytest.fixture(scope="module")
def outcomes():
    from client_tpu.serve import Server as JaxServer
    from client_tpu.serve.models import language_models as jax_language
    from client_tpu.serve.models.vision import (
        cnn_classifier_model as jax_cnn,
    )
    from client_tpu_torch.serve import Server
    from client_tpu_torch.serve.models import language_models
    from client_tpu_torch.serve.models.vision import cnn_classifier_model

    port_models = [cnn_classifier_model(device="cpu")]
    port_models += language_models(device="cpu")
    jax_models = [jax_cnn()] + jax_language()
    with Server(models=port_models, device="cpu", grpc_port=0,
                http_port=0) as port, JaxServer(
                    models=jax_models, grpc_port=0, http_port=0) as ref:
        yield st.run_pairs(sorted(st.WEIGHTS), port, ref)


def test_the_weight_masks_take_only_the_weights_part():
    image = ("image 0:\n  6.3749 (986) = class_986\n"
             "  5.7308 (695) = class_695\nPASS: image_client\n")
    assert st.masked("image_client.py", image) == (
        "image 0:\n" + "  <score> (<class>) = <label>\n" * 2
        + "PASS: image_client\n")
    llm = "prompt: 'Once'\nstream: abc\nPASS: streamed 16 pieces\n"
    assert st.masked("llm_streaming_client.py", llm) == (
        "prompt: 'Once'\nstream: <text>\nPASS: streamed 16 pieces\n")
    top = "image top-3: ['0.861084:12:class_12', '0.047084:3:class_3']"
    assert st.masked("ensemble_image_client.py", top) == (
        "image top-3: ['<score>:<class>:<label>', '<score>:<class>:<label>']")


@pytest.mark.parametrize("name", sorted(st.WEIGHTS))
def test_port_example_prints_the_reference_lines_but_the_weights(
        outcomes, name):
    st.assert_same_output(outcomes, name)
