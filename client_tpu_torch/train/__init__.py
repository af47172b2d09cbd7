"""Training checkpoint / resume on ``torch.save`` and ``torch.load``.

Counterpart of client_tpu/train/__init__.py (which wraps orbax), with the
same surface and the two properties training needs:

- **device-, dtype- and layout-aware restore**: pass the live state as
  ``template`` and each leaf comes back on its template leaf's device and
  dtype; a DTensor template leaf (params laid out on a mesh by
  ``parallel.device_put``) comes back as a DTensor of its mesh and
  placements, each rank slicing its own shard, with no gather;
- **atomic, retention-managed steps**: each step is written to a temporary
  file, synced and renamed into place with ``os.replace``, so a killed run
  never leaves a torn checkpoint; ``max_to_keep`` bounds the disk.

A tree is nested dicts, lists and tuples of tensors; other leaves (the
Python values of an optimizer's ``state_dict()``) are kept as they are.
"""

import os
import re
import tempfile

import torch
from torch.distributed.tensor import DTensor, distribute_tensor

_NAME = re.compile(r"^step_(\d+)\.pt$")


def _restore_like(tree, template):
    if isinstance(template, dict):
        if not isinstance(tree, dict) or tree.keys() != template.keys():
            raise ValueError("checkpoint does not match the template's keys")
        return {k: _restore_like(tree[k], template[k]) for k in template}
    if isinstance(template, (list, tuple)):
        if not isinstance(tree, (list, tuple)) or len(tree) != len(template):
            raise ValueError("checkpoint does not match the template's length")
        out = [_restore_like(a, b) for a, b in zip(tree, template)]
        return type(template)(out)
    if isinstance(template, torch.Tensor):
        if not isinstance(tree, torch.Tensor) or tree.shape != template.shape:
            raise ValueError(
                f"checkpoint leaf {getattr(tree, 'shape', tree)} does not "
                f"match the template's {tuple(template.shape)}"
            )
        # a leaf, whatever the saved tensor's requires_grad
        leaf = tree.detach().to(device=template.device, dtype=template.dtype)
        if isinstance(template, DTensor):
            # every rank read the whole leaf: each keeps its own shard,
            # with no collective and no gather
            return distribute_tensor(leaf, template.device_mesh,
                                     template.placements, src_data_rank=None)
        return leaf
    return tree


class CheckpointManager:
    """Save/restore (params, opt_state, step) training state.

    Usage, with the port's train step (the optimizer state is saved as its
    ``state_dict()``)::

        mgr = CheckpointManager(dir, max_to_keep=3)
        mgr.save(step, params=params, opt_state=opt_state.state_dict())
        ...
        restored = mgr.restore(template={
            "params": params, "opt_state": opt.init(params).state_dict()})
        params = restored["params"]
        opt_state = opt.init(params)
        opt_state.load_state_dict(restored["opt_state"])
        start = mgr.latest_step() + 1
    """

    def __init__(self, directory, max_to_keep=3):
        self._dir = os.path.abspath(str(directory))
        self._max_to_keep = max_to_keep
        os.makedirs(self._dir, exist_ok=True)

    def _path(self, step):
        return os.path.join(self._dir, f"step_{step}.pt")

    def save(self, step, /, **state):
        """Write one atomic checkpoint for ``step`` (kwargs form the tree)."""
        fd, tmp = tempfile.mkstemp(prefix=".tmp-", dir=self._dir)
        try:
            with os.fdopen(fd, "wb") as f:
                torch.save(dict(state), f)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, self._path(step))
        except BaseException:
            os.unlink(tmp)
            raise
        if self._max_to_keep is not None:  # None keeps every step
            for old in self.all_steps()[:-self._max_to_keep]:
                os.unlink(self._path(old))

    def all_steps(self):
        """Retained steps, oldest first."""
        steps = (_NAME.match(name) for name in os.listdir(self._dir))
        return sorted(int(m.group(1)) for m in steps if m)

    def latest_step(self):
        """Newest retained step, or None if the directory holds none."""
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, template, step=None):
        """Restore ``step`` (default: latest) shaped like ``template``.

        Every tensor comes back on the template leaf's device and dtype (a
        DTensor on its mesh and placements); a checkpoint whose structure
        or shapes differ from the template's raises ValueError.
        """
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {self._dir}")
        tree = torch.load(self._path(step), map_location="cpu",
                          weights_only=True)
        return _restore_like(tree, template)

    def close(self):
        """Nothing stays open between calls; kept for the JAX surface."""

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
