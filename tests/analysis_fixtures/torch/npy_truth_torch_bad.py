"""NPY-TRUTH (torch key) bad samples: a torch tensor in a truth
position raises past one element and, on CUDA, copies to the host and
waits for the device."""

import torch


def any_finished(tokens, eos):
    done = torch.where(tokens == eos, 1, 0)
    # BAD: truthiness of a tensor
    if done:
        return True
    return False


def has_rows(n):
    rows = torch.zeros((n, 4))
    # BAD: bool() over a tensor
    return bool(rows)


def pending_has(handle, prompt):
    row = torch.tensor(prompt)
    pending = [row]
    # BAD: membership over tensor-bearing values compares elementwise
    return handle in pending
