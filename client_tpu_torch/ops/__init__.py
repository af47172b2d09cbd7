"""Hand-written Hopper kernels and their plain PyTorch versions.

``LAUNCHES`` counts, per kernel, the launches its wrapper made; a run
resets the counts and reads them back to show which kernels a path went
through.  Launching a kernel is the only thing that increments a count
(the server launches from several threads, hence the lock).  A wrapper
whose binding picks one of several kernels by dtype and shape also counts
the route the binding reports in ``ROUTES`` (one call, one count, however
many kernels the call launches).
"""

import threading

LAUNCHES = {"int8_matmul": 0, "flash_fwd": 0, "flash_bwd_dq": 0,
            "flash_bwd_dkv": 0, "paged_attention": 0}
# {wrapper: {route: launches}}: the kernel each call went through
ROUTES = {"int8_matmul": {"gemv": 0, "tiled": 0, "mma": 0},
          "paged_attention": {"split": 0, "mma": 0}}
_lock = threading.Lock()


def count_launch(name, route=None):
    with _lock:
        LAUNCHES[name] += 1
        if route is not None:
            ROUTES[name][route] += 1


def reset_launches():
    with _lock:
        for name in LAUNCHES:
            LAUNCHES[name] = 0
        for routes in ROUTES.values():
            for route in routes:
                routes[route] = 0
