"""PyTorch/CUDA port of client_tpu's serving stack for NVIDIA Hopper.

The package keeps client_tpu's module layout, so each module here has a
counterpart of the same name there.  It imports torch, numpy and the
standard library only.  Entry points run on ``cuda`` unless the caller
passes ``device="cpu"``: on the CPU every kernel wrapper takes its plain
PyTorch version, on a CUDA tensor it launches the hand-written kernel.

The layer the reference keeps free of JAX (the clients, perf_analyzer,
the replica set, the analyser and witnesses, the chaos harness, the
postmortem tools and the server with its numpy builtins) imports and
runs here without torch: those modules import it where a path needs a
tensor or the card, and a torch-bound feature raises a message naming
torch when it is not installed.  ``ops``, ``serve.models``,
``serve.lm``, ``train``, ``parallel``, ``convert`` and ``graft`` need
torch to import.
"""

import sys

from client_tpu_torch._version import __version__

__all__ = ["__version__", "is_tensor", "loaded_torch", "require_torch",
           "resolve_device"]


def resolve_device(device=None):
    """The torch.device an entry point runs on: ``cuda`` unless *device*
    names another.  Raises when CUDA is asked for (or implied) and absent;
    there is no quiet fall back to the CPU."""
    torch = require_torch("resolve_device")
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "client_tpu_torch runs on a CUDA device by default and none is "
            "available; pass device='cpu' to run the plain PyTorch path"
        )
    return dev


def require_torch(feature):
    """The torch module, for *feature* (named in the error when torch is
    not installed).  The framework-free layer calls this where a path
    needs torch, so a torch-less install refuses that path and nothing
    else; once torch is loaded this is one dictionary lookup."""
    torch = sys.modules.get("torch")
    if torch is not None:
        return torch
    try:
        import torch
    except ModuleNotFoundError as e:
        if e.name != "torch":
            raise
        raise ModuleNotFoundError(
            f"{feature} needs torch, which is not installed "
            "(pip install client-tpu[cuda])", name="torch") from e
    return torch


def loaded_torch():
    """The torch module if this process has already imported it, else
    None.  A value can be a tensor only once torch is loaded, so a
    per-request tensor test reads this and never imports."""
    return sys.modules.get("torch")


def is_tensor(value):
    """Whether *value* is a torch tensor, without importing torch."""
    torch = sys.modules.get("torch")
    return torch is not None and isinstance(value, torch.Tensor)
