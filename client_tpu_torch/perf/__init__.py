"""The port's counterpart of client_tpu/perf: only the frame transport
(:mod:`client_tpu_torch.perf.rendezvous`) the fleet tier speaks.  The
perf harness itself stays with the JAX package, whose clients run
unchanged against the port's server."""
