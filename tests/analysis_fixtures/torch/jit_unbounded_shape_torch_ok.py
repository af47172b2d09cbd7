"""JIT-UNBOUNDED-SHAPE (torch key) clean samples: the ragged prompt is
padded to a bucket before the compiled callable sees it."""

import numpy as np

import torch


def prefill(params, tokens):
    return tokens


def pad_prompt(tokens, width):
    out = np.zeros((1, width), np.int32)
    out[0, : tokens.shape[-1]] = tokens.reshape(-1)
    return out


class Scheduler:
    def __init__(self, params):
        self.params = params
        self._prefill = torch.compile(prefill)

    def admit(self, prompt_tokens):
        prompt = np.asarray(prompt_tokens, np.int32).reshape(1, -1)
        prompt = pad_prompt(prompt, 64)
        return self._prefill(self.params, torch.from_numpy(prompt))
