"""Standalone server entry point: ``python -m client_tpu_torch.serve``."""

import argparse
import signal
import threading


def main():
    parser = argparse.ArgumentParser(
        description="client_tpu_torch in-process KServe-v2 server"
    )
    parser.add_argument("--host", default="127.0.0.1")
    parser.add_argument("--http-port", type=int, default=8000)
    parser.add_argument(
        "--grpc-port", type=int, default=None,
        help="also serve KServe-v2 gRPC on this port (0 picks a free port; "
             "needs grpcio and protobuf)",
    )
    parser.add_argument("-v", "--verbose", action="store_true")
    parser.add_argument(
        "--models", default="language",
        help="comma-separated model sets: builtin (the numpy models and "
             "the tiny vision pipeline), jax (the CNN classifier), resnet "
             "(resnet50), language, pipeline (the resnet50 vision "
             "ensemble) (default: language); without torch installed "
             "only builtin, its numpy models",
    )
    parser.add_argument(
        "--device", choices=("cuda", "cpu"), default="cuda",
        help="device the models run on (default: cuda; cpu runs the plain "
             "PyTorch versions of the kernels)",
    )
    parser.add_argument(
        "--response-cache-entries", type=int, default=0,
        help="enable the content-addressed response cache with this many "
             "LRU entries (0 = off)",
    )
    parser.add_argument(
        "--response-cache-ttl", type=float, default=None,
        help="response-cache entry TTL in seconds (default: no expiry)",
    )
    parser.add_argument(
        "--coalescing", action="store_true",
        help="collapse identical concurrent requests into one dispatch",
    )
    parser.add_argument(
        "--tenant-inflight", type=int, default=None,
        help="per-tenant concurrent-request cap (429 + Retry-After beyond)",
    )
    parser.add_argument(
        "--tenant-rate", type=float, default=None,
        help="per-tenant request-rate quota in req/s (429 + Retry-After "
             "beyond)",
    )
    parser.add_argument(
        "--max-inflight", type=int, default=None,
        help="global concurrent-request cap (retryable 503 beyond)",
    )
    parser.add_argument(
        "--slo-p99-ms", type=float, default=None,
        help="arm the SLO watchdog: windowed p99 objective in ms for "
             "every model (breach increments ctpu_slo_breaches_total "
             "and dumps the flight recorder)",
    )
    parser.add_argument(
        "--slo-error-rate", type=float, default=None,
        help="SLO error-rate objective as a fraction (server faults only)",
    )
    parser.add_argument(
        "--flight-dir", default=None,
        help="directory for flight-recorder dumps (default: "
             "$TPU_FLIGHT_DIR, else the system temp dir)",
    )
    parser.add_argument(
        "--fleet-bind", default=None,
        help="join the cross-replica fleet tier: host:port for the peer "
             "server (host:0 picks a free port; printed at startup)",
    )
    parser.add_argument(
        "--fleet-peers", default="",
        help="comma-separated host:port peer fleet addresses",
    )
    parser.add_argument(
        "--replicate-k", type=int, default=1,
        help="peers each durable sequence snapshot / hot item is pushed "
             "to (0 = replication off)",
    )
    parser.add_argument(
        "--seq-quorum", choices=("any", "majority"), default="any",
        help="durable-sequence ack discipline: 'any' acks on best-effort "
             "push (a partition degrades to local-only durability), "
             "'majority' acks only after ceil((K+1)/2) peers stored the "
             "snapshot (quorum unreachable = retryable 503)",
    )
    args = parser.parse_args()

    from client_tpu_torch.serve import Server
    from client_tpu_torch.serve.frontdoor import ResponseCache, TenantQoS
    from client_tpu_torch.serve.models import model_sets
    from client_tpu_torch.serve.slo import SloWatchdog

    try:
        models = model_sets(args.models, device=args.device)
    except ModuleNotFoundError as e:
        if e.name != "torch":
            raise
        parser.error(f"{e}; --models builtin serves without it")

    cache = None
    if args.response_cache_entries > 0:
        cache = ResponseCache(
            max_entries=args.response_cache_entries,
            ttl_s=args.response_cache_ttl,
        )
    qos = None
    if args.tenant_inflight is not None or args.tenant_rate is not None:
        qos = TenantQoS(
            default_max_inflight=args.tenant_inflight,
            default_rate_per_s=args.tenant_rate,
        )
    slo = None
    if args.slo_p99_ms is not None or args.slo_error_rate is not None:
        objective = {}
        if args.slo_p99_ms is not None:
            objective["p99_ms"] = args.slo_p99_ms
        if args.slo_error_rate is not None:
            objective["error_rate"] = args.slo_error_rate
        slo = SloWatchdog(objectives={"*": objective})
    fleet = None
    if args.fleet_bind:
        from client_tpu_torch.serve.fleet import FleetTier

        peers = [p.strip() for p in args.fleet_peers.split(",") if p.strip()]
        fleet = FleetTier(
            bind=args.fleet_bind,
            peers=peers,
            replicate_k=args.replicate_k,
            quorum=args.seq_quorum,
        ).start()

    server = Server(
        models=models,
        with_default_models=False,
        http_port=args.http_port,
        grpc_port=args.grpc_port,
        host=args.host,
        verbose=args.verbose,
        max_inflight=args.max_inflight,
        response_cache=cache,
        coalescing=args.coalescing,
        qos=qos,
        fleet=fleet,
        slo=slo,
    ).start()
    if args.flight_dir:
        server.engine.flight.dump_dir = args.flight_dir
    print(f"client_tpu_torch.serve: HTTP on {server.http_address}", flush=True)
    if server.grpc_address:
        print(f"client_tpu_torch.serve: gRPC on {server.grpc_address}",
              flush=True)
    if fleet is not None:
        print(
            f"client_tpu_torch.serve: fleet peer port on {fleet.address} "
            f"(quorum={fleet.quorum}, replicate_k={fleet.replicate_k})",
            flush=True,
        )

    stop = threading.Event()
    signal.signal(signal.SIGINT, lambda *a: stop.set())
    signal.signal(signal.SIGTERM, lambda *a: stop.set())
    stop.wait()
    server.stop()
    if fleet is not None:
        fleet.close()


if __name__ == "__main__":
    main()
