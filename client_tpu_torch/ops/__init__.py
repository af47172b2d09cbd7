"""Hand-written Hopper kernels and their plain PyTorch versions.

``LAUNCHES`` counts, per kernel, the launches its wrapper made; a run
resets the counts and reads them back to show which kernels a path went
through.  Launching a kernel is the only thing that increments a count
(the server launches from several threads, hence the lock).
"""

import threading

LAUNCHES = {"int8_matmul": 0, "flash_fwd": 0, "flash_bwd_dq": 0,
            "flash_bwd_dkv": 0}
_lock = threading.Lock()


def count_launch(name):
    with _lock:
        LAUNCHES[name] += 1


def reset_launches():
    with _lock:
        for name in LAUNCHES:
            LAUNCHES[name] = 0
