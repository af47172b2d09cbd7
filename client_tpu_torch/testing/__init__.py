"""Test harnesses for exercising the port's client/server stack under
failure: the port's copy of client_tpu/testing.

``client_tpu_torch.testing.faults`` holds the in-process chaos TCP proxy
and the server-side fault hooks; ``client_tpu_torch.testing.chaos`` the
seeded fault schedules, the chaos matrix and its invariant checkers.
"""
