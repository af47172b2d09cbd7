"""Carry weights across: a JAX params pytree, given as numpy arrays, becomes
the port's tensors.

The tree keeps its structure (dicts, lists, the ``{"q", "s"}`` dicts of
``quantize_params`` and the pipeline-stacked tree of
``stack_pipeline_params``, leaves ``[S, L/S, ...]``) and every leaf its
dtype: bfloat16 leaves (numpy arrays of the ``bfloat16`` extension dtype)
are carried bit for bit.
"""

import numpy as np
import torch

from client_tpu_torch import resolve_device


def _tensor(arr, device):
    arr = np.asarray(arr)
    if arr.dtype.name == "bfloat16":
        t = torch.from_numpy(np.ascontiguousarray(arr).view(np.int16).copy())
        t = t.view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(arr, copy=True, order="C"))
    return t.to(device)


def params_from_numpy(tree, device=None):
    """Map a params pytree of numpy arrays to tensors on *device*."""
    device = resolve_device(device)
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [params_from_numpy(v, device) for v in tree]
    return _tensor(tree, device)
