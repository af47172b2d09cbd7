"""Model sets for the port's in-process server.

``model_sets("builtin,jax,resnet,language,pipeline")`` is the set-name
resolver of the serve CLI (counterpart of
client_tpu/serve/models/__init__.py), under the reference's set names, so
the same ``--models`` string serves the same models on both servers:
``builtin`` is serve/builtins.py's numpy models and the tiny vision
pipeline, ``jax`` is the small-CNN vision set, ``resnet``
the resnet50 of BASELINE config 3, ``language`` the tokenizer ->
streaming-LM stack, and ``pipeline`` the full-size vision ensemble DAG
(preprocess -> resnet50 backbone -> classification postprocess).  Every
set runs on *device* (``cuda`` unless the caller says otherwise).
Without torch installed only ``builtin`` resolves (its numpy models);
every other set raises a message naming torch.
"""

from client_tpu_torch import require_torch
from client_tpu_torch.utils import InferenceServerException


def jax_models(device=None):
    from client_tpu_torch.serve.models.vision import cnn_classifier_model

    return [cnn_classifier_model(device=device)]


def resnet_models(device=None):
    from client_tpu_torch.serve.models.vision import resnet50_model

    return [resnet50_model(device=device)]


def language_models(device=None, speculative=None):
    from client_tpu_torch.serve.models.language import language_models as _lm

    return _lm(device=device, speculative=speculative)


def pipeline_models(device=None, warmup=False):
    """Full-size vision pipeline (224px resnet50 backbone): the ensemble
    DAG workload at serving scale."""
    from client_tpu_torch.serve.models.vision import (
        _RESNET50_STAGES,
        vision_pipeline_models,
    )

    return vision_pipeline_models(
        image_size=224, stages=_RESNET50_STAGES, num_classes=1000,
        max_batch_size=64, warmup=warmup, device=device,
    )


def model_sets(names, device=None, speculative=None):
    """Resolve a comma-separated set list
    (builtin,jax,resnet,language,pipeline); the models run on *device*
    (``cuda`` unless the caller says otherwise).  ``speculative`` (a
    SpecConfig-shaped dict) applies to the ``language`` set's batched
    engines only — perf's ``--speculative K --drafter ngram`` threads
    through here."""
    from client_tpu_torch.serve.builtins import default_models

    loaders = {
        "builtin": default_models,
        "jax": jax_models,
        "resnet": resnet_models,
        "language": lambda device: language_models(
            device=device, speculative=speculative),
        "pipeline": pipeline_models,
    }
    models = []
    for name in names.split(","):
        name = name.strip()
        if not name:
            continue
        if name not in loaders:
            raise InferenceServerException(
                f"unknown model set '{name}' (available: "
                f"{', '.join(sorted(loaders))})"
            )
        if name != "builtin":
            require_torch(f"the model set '{name}'")
        models.extend(loaders[name](device=device))
    return models
