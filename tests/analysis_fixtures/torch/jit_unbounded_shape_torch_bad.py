"""JIT-UNBOUNDED-SHAPE (torch key) bad samples: ``torch.compile`` and
``make_graphed_callables`` specialise per input shape just as
``jax.jit`` does, so a request-shaped tensor recompiles (or misses the
captured graph) per distinct prompt length."""

import numpy as np

import torch


def prefill(params, tokens):
    return tokens


class Scheduler:
    def __init__(self, params, module, sample):
        self.params = params
        self._prefill = torch.compile(prefill)
        self._graphed = torch.cuda.make_graphed_callables(module, (sample,))

    def admit(self, prompt_tokens):
        prompt = np.asarray(prompt_tokens, np.int32).reshape(1, -1)
        # BAD: one compile per distinct prompt length
        return self._prefill(self.params, torch.from_numpy(prompt))

    def run(self, prompt_tokens):
        prompt = np.asarray(prompt_tokens, np.int32).reshape(1, -1)
        # BAD: a graphed callable fed a ragged shape
        return self._graphed(torch.from_numpy(prompt))
