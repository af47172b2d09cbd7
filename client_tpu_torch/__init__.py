"""PyTorch/CUDA port of client_tpu's serving stack for NVIDIA Hopper.

The package keeps client_tpu's module layout, so each module here has a
counterpart of the same name there.  It imports torch, numpy and the
standard library only.  Entry points run on ``cuda`` unless the caller
passes ``device="cpu"``: on the CPU every kernel wrapper takes its plain
PyTorch version, on a CUDA tensor it launches the hand-written kernel.
"""

import torch

from client_tpu_torch._version import __version__

__all__ = ["__version__", "resolve_device"]


def resolve_device(device=None):
    """The torch.device an entry point runs on: ``cuda`` unless *device*
    names another.  Raises when CUDA is asked for (or implied) and absent;
    there is no quiet fall back to the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "client_tpu_torch runs on a CUDA device by default and none is "
            "available; pass device='cpu' to run the plain PyTorch path"
        )
    return dev
