"""NPY-TRUTH (torch key) clean samples: explicit reductions and
identity scans, no tensor in a truth position."""

import torch


def any_finished(tokens, eos):
    done = torch.where(tokens == eos, 1, 0)
    return int(done.sum().item()) > 0


def has_rows(n):
    rows = torch.zeros((n, 4))
    return rows.shape[0] > 0


def pending_has(handle, prompt):
    row = torch.tensor(prompt)
    pending = [row]
    return any(entry is handle for entry in pending)
