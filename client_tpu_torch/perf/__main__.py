"""perf CLI — the perf_analyzer command-line surface of the port.

Counterpart of client_tpu/perf/__main__.py.  Option names follow the
reference CLI (reference src/c++/perf_analyzer/command_line_parser.h:44-160)
where the concept carries over; the port's additions: ``--shared-memory
cuda`` stages inputs and outputs in CUDA device memory, ``--hermetic``
benchmarks the in-process server without sockets (the TRITON_C_API
analog), and ``--device`` says where the hermetic models, the CUDA
regions and the device probe run (``cuda`` unless ``cpu``).

``-i http`` drives the port's own HTTP client (client_tpu_torch/http),
``--async`` the load as asyncio slots over its grpc.aio client,
``--world-size N`` coordinated ranks through the rendezvous barrier
(perf/rendezvous.py), and ``--service-kind torchserve|tfserve|
tfserve_rest`` the non-KServe backends (with ``--hermetic``, against the
in-process fakes of perf/fake_endpoints.py, which need no device).
A comma-separated ``--url`` replica list fans the load out across the
replicas through the port's ``balance.EndpointPool`` (round-robin, a
per-endpoint split in the summary), and ``--churn-soak SECONDS`` rotates
the pool's membership through its discovery loop while the load runs.
``--native-loadgen`` sweeps with the C++ engine (perf/native_worker.py,
its binary built at first use from ``src/cpp``), and the ``--ssl-*``
options secure the gRPC and HTTP backends; an SSL option the run cannot
honour (``--async``, ``--native-loadgen``, ``--hermetic``, a non-Triton
kind, the other protocol's options) is refused with a message where the
reference drops it.  Without torch installed the CLI drives any server
over the wire and from system regions; an option that needs torch
(``--shared-memory cuda``, ``--device``, the local GPU gauges, the probe,
a hermetic model set other than ``builtin``) is refused with a message.

    python -m client_tpu_torch.perf -m resnet50 -u localhost:8001 \\
        --shared-memory cuda --output-shared-memory-size 4000 --async
    python -m client_tpu_torch.perf -m simple --hermetic --device cpu
"""

import argparse
import sys

from client_tpu_torch import require_torch, resolve_device
from client_tpu_torch.perf import (
    AsyncConcurrencyManager,
    BackendKind,
    ClientBackendFactory,
    ConcurrencyManager,
    CustomLoadManager,
    DataLoader,
    InferenceProfiler,
    RequestRateManager,
    SequenceManager,
    create_infer_data_manager,
    print_summary,
    write_csv,
    write_json,
)
from client_tpu_torch.perf.metrics_manager import (
    DeviceUtilizationProbe,
    MetricsManager,
    local_device_snapshot,
)
from client_tpu_torch.perf.model_parser import ModelParser
from client_tpu_torch.perf.native_worker import (
    build_native_worker,
    native_windows_stable,
    run_native_worker,
)
from client_tpu_torch.perf.rendezvous import Rendezvous
from client_tpu_torch.utils import InferenceServerException


def _parse_tenants(spec):
    """'gold:3,bronze:1' -> ['gold','gold','gold','bronze']: the slot
    assignment list worker i indexes with i % len (a bare name counts as
    weight 1).  Interleaving is by expansion order, which is fine — slots
    are homogeneous."""
    if not spec:
        return []
    slots = []
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        name, _, weight = part.partition(":")
        try:
            count = int(weight) if weight else 1
        except ValueError:
            raise SystemExit(
                f"error: bad --tenants entry {part!r} (want name[:weight])"
            ) from None
        if count < 1:
            raise SystemExit(
                f"error: --tenants weight must be >= 1 in {part!r}"
            )
        slots.extend([name] * count)
    return slots


def _parse_range(text, cast):
    """start[:end[:step]] (reference concurrency-range format)."""
    parts = text.split(":")
    start = cast(parts[0])
    end = cast(parts[1]) if len(parts) > 1 else start
    step = cast(parts[2]) if len(parts) > 2 else cast(1)
    return start, end, step


def build_parser():
    p = argparse.ArgumentParser(
        prog="python -m client_tpu_torch.perf",
        description="perf_analyzer for the PyTorch/CUDA port: load "
                    "generation + measurement",
    )
    p.add_argument("-m", "--model-name", required=True)
    p.add_argument("-x", "--model-version", default="")
    p.add_argument("-u", "--url", default="localhost:8001",
                   help="server address; a comma-separated list fans the "
                        "load out across replicas (per-endpoint split in "
                        "the summary)")
    p.add_argument("-i", "--protocol", choices=["grpc", "http"], default="grpc")
    p.add_argument("-a", "--async", dest="async_mode", action="store_true",
                   help="async concurrency slots on one event loop over "
                        "grpc.aio (reference -a; stateless gRPC only)")
    p.add_argument("--native-loadgen", action="store_true",
                   help="generate load with the native C++ engine "
                        "(build/torch_cpp/perf_worker, built at first use "
                        "by g++ alone from src/cpp/perf and the port's "
                        "protobuf-free client: async InferContexts on one "
                        "connection, no GIL in the instrument); "
                        "concurrency, request-rate or sequence mode over "
                        "socket gRPC, wire, system or CUDA-shm inputs")
    p.add_argument("--service-kind",
                   choices=["triton", "torchserve", "tfserve",
                            "tfserve_rest"],
                   default="triton",
                   help="target service protocol family (reference "
                        "--service-kind; non-KServe kinds declare the input "
                        "tensor via --shape)")
    p.add_argument("--hermetic", action="store_true",
                   help="benchmark the in-process server (no sockets); with "
                        "--service-kind torchserve/tfserve spins the "
                        "matching in-process fake endpoint")
    p.add_argument("--hermetic-models", default="builtin",
                   help="model sets for --hermetic: "
                        "builtin,jax,resnet,language,pipeline")
    p.add_argument("--device", default=None,
                   help="where the --hermetic models, the CUDA shared-"
                        "memory regions and the device probe run: "
                        "cuda (the default) or cpu")
    p.add_argument("-b", "--batch-size", type=int, default=1)
    p.add_argument("--concurrency-range", default=None,
                   help="start[:end[:step]]")
    p.add_argument("--request-rate-range", default=None,
                   help="start[:end[:step]] in req/sec")
    p.add_argument("--request-intervals", default=None,
                   help="file of inter-request intervals (ns per line)")
    p.add_argument("--request-distribution", choices=["constant", "poisson"],
                   default="constant")
    p.add_argument("--measurement-interval", type=int, default=2000,
                   help="window length in msec (-p)")
    p.add_argument("--measurement-mode",
                   choices=["time_windows", "count_windows"],
                   default="time_windows",
                   help="close windows on elapsed time or on completed "
                        "request count (reference --measurement-mode)")
    p.add_argument("--measurement-request-count", type=int, default=50,
                   help="requests per window for count_windows mode")
    p.add_argument("--max-trials", type=int, default=10)
    p.add_argument("-s", "--stability-percentage", type=float, default=10.0)
    p.add_argument("--percentile", type=int, default=None,
                   help="use this latency percentile for stability checks")
    p.add_argument("-l", "--latency-threshold", type=float, default=0,
                   help="stop the sweep past this avg latency (msec)")
    p.add_argument("--binary-search", action="store_true")
    p.add_argument("--max-threads", type=int, default=16)
    p.add_argument("--shared-memory", choices=["none", "system", "cuda"],
                   default="none")
    p.add_argument("--output-shared-memory-size", type=int, default=0)
    p.add_argument("--cuda-device-id", type=int, default=0)
    p.add_argument("--cuda-shm-sync", action="store_true",
                   help="record completion latency (every output region "
                        "read back to the host per request) instead of "
                        "ack latency for CUDA shm outputs")
    p.add_argument("--input-data", default=None,
                   help="'random', 'zero', a JSON file, or a directory")
    p.add_argument("--shape", action="append", default=[],
                   help="NAME:d1,d2,... override for dynamic dims")
    p.add_argument("--string-length", type=int, default=16)
    p.add_argument("--prefix-share", type=float, default=None,
                   help="LM workload knob: generate prompts whose leading "
                        "FRAC of tokens comes from a small shared prefix "
                        "pool (see --prefix-pool), so the KV prefix "
                        "cache's prefill savings are measurable; with "
                        "--hermetic the summary/CSV/JSON gain per-sweep "
                        "prefix_hit_pct + prefill_tokens_saved_pct from "
                        "the engine's counters")
    p.add_argument("--prefix-pool", type=int, default=4,
                   help="number of distinct shared prefixes --prefix-share "
                        "draws from (smaller pool = hotter prefixes)")
    p.add_argument("--prefix-prompts", type=int, default=16,
                   help="distinct prompts generated for --prefix-share "
                        "(workers rotate over them)")
    p.add_argument("--speculative", type=int, default=None, metavar="K",
                   help="LM engine knob (requires --hermetic): enable "
                        "speculative decoding with up to K draft tokens "
                        "per verify tick on the batched LM engines; the "
                        "summary/CSV/JSON gain per-sweep "
                        "spec_acceptance_pct + spec tokens/s from the "
                        "engine's counters")
    p.add_argument("--drafter", choices=["ngram", "bigram"],
                   default="ngram",
                   help="drafter for --speculative: 'ngram' "
                        "(prompt-lookup) or 'bigram' (static greedy-"
                        "bigram table seeded from the prompt)")
    p.add_argument("--tenants", default=None,
                   help="tenant mix for the worker slots: "
                        "'gold:3,bronze:1' assigns slots to tenants "
                        "proportionally to the weights (a bare name means "
                        "weight 1); requests carry x-tenant-id and the "
                        "summary adds a per-tenant latency split")
    p.add_argument("--hermetic-cache-entries", type=int, default=0,
                   help="with --hermetic: enable the in-process engine's "
                        "response cache (N LRU entries) + coalescing, so "
                        "cache-hit rates show in the summary")
    p.add_argument("--sequence", action="store_true",
                   help="stateful sequence workload")
    p.add_argument("--sequence-length", type=int, default=20)
    p.add_argument("--sequence-length-variation", type=float, default=0.0)
    p.add_argument("--start-sequence-id", type=int, default=1)
    p.add_argument("--sequence-id-range", type=int, default=2**32 - 1)
    p.add_argument("--churn-soak", type=float, default=None,
                   metavar="SECONDS",
                   help="with a --url replica list: soak the replica pool "
                        "under membership churn — every SECONDS a rotating "
                        "replica is retired from the pool through the "
                        "discovery layer and re-added one tick later "
                        "(retire/evict/re-add paths exercised under load; "
                        "the last healthy endpoint is never dropped)")
    p.add_argument("-f", "--filename", default=None, help="CSV output path")
    p.add_argument("--json-export", default=None,
                   help="per-sweep-point JSON report path (the full "
                        "record CSV columns cannot hold: all percentiles, "
                        "per-tenant splits, server stats deltas)")
    p.add_argument("--collect-metrics", action="store_true",
                   help="scrape the server /metrics during measurement")
    p.add_argument("--metrics-url", default=None,
                   help="metrics endpoint (default: http://<url>/metrics)")
    p.add_argument("--metrics-interval", type=float, default=1000.0,
                   help="scrape interval in msec")
    p.add_argument("--collect-local-gpu-metrics", action="store_true",
                   help="also read this host's GPU memory gauges (used/"
                        "total/peak, torch.cuda) each scrape — device "
                        "telemetry when the server under test exposes no "
                        "GPU metrics (requires colocation with the card "
                        "and CUDA)")
    p.add_argument("--probe-device-utilization", action="store_true",
                   help="time a one-element add on a stream of its own "
                        "on the local card each scrape (trusts nothing the "
                        "server reports; requires colocation with the card) "
                        "— its delay and the busy share of its samples, "
                        "ctpu_probe_utilization_pct in the report/CSV.  "
                        "Not a utilization figure: in the server's process "
                        "it reads the running kernels' occupancy, from "
                        "another process the GPU's context time slice")
    # SSL/TLS (reference command_line_parser.h SSL option block; names match)
    p.add_argument("--ssl-grpc-use-ssl", action="store_true",
                   help="use an SSL-encrypted gRPC channel")
    p.add_argument("--ssl-grpc-root-certifications-file", default=None)
    p.add_argument("--ssl-grpc-private-key-file", default=None)
    p.add_argument("--ssl-grpc-certificate-chain-file", default=None)
    p.add_argument("--ssl-https-verify-peer", type=int, choices=[0, 1],
                   default=1, help="0 disables server-cert verification")
    p.add_argument("--ssl-https-ca-certificates-file", default=None,
                   help="also switches the HTTP client to https://")
    p.add_argument("--ssl-https-client-certificate-file", default=None)
    p.add_argument("--ssl-https-private-key-file", default=None)
    # trace control plane: pushed to the server before profiling (reference
    # command_line_parser.h trace options → TraceSetting RPC)
    p.add_argument("--trace-level", action="append", default=None,
                   choices=["OFF", "TIMESTAMPS", "TENSORS"],
                   help="may repeat; OFF clears")
    p.add_argument("--trace-rate", type=int, default=None,
                   help="trace 1 of every N requests")
    p.add_argument("--trace-count", type=int, default=None,
                   help="stop tracing after N traces (-1 = unlimited)")
    p.add_argument("--log-frequency", type=int, default=None,
                   help="flush the trace log every N traces")
    p.add_argument("--world-size", type=int, default=1,
                   help="number of coordinated perf ranks (MPI-mode analog)")
    p.add_argument("--rank", type=int, default=0)
    p.add_argument("--rendezvous-addr", default="127.0.0.1:29400",
                   help="rank-0 coordinator host:port")
    p.add_argument("-v", "--verbose", action="store_true")
    return p


def _ssl_options(args):
    """The backends' ``ssl_options`` (gRPC options under ``-i grpc``, HTTPS
    options under ``-i http``, as the reference builds them), or None.
    Exits with a message where the reference would drop a given option
    silently: a run with no SSL-capable client, the other protocol's
    options, files without ``--ssl-grpc-use-ssl``, a key without its
    certificate."""
    grpc_given = [name for name, on in (
        ("--ssl-grpc-use-ssl", args.ssl_grpc_use_ssl),
        ("--ssl-grpc-root-certifications-file",
         args.ssl_grpc_root_certifications_file),
        ("--ssl-grpc-private-key-file", args.ssl_grpc_private_key_file),
        ("--ssl-grpc-certificate-chain-file",
         args.ssl_grpc_certificate_chain_file)) if on]
    https_given = [name for name, on in (
        ("--ssl-https-verify-peer 0", not args.ssl_https_verify_peer),
        ("--ssl-https-ca-certificates-file",
         args.ssl_https_ca_certificates_file),
        ("--ssl-https-client-certificate-file",
         args.ssl_https_client_certificate_file),
        ("--ssl-https-private-key-file",
         args.ssl_https_private_key_file)) if on]
    if not grpc_given and not https_given:
        return None
    if (args.async_mode or args.native_loadgen or args.hermetic
            or args.service_kind != "triton"):
        sys.exit("error: the --ssl-* options secure the python load "
                 "engine's socket gRPC/HTTP clients (not --async, "
                 "--native-loadgen, --hermetic, or non-Triton "
                 "--service-kind)")
    grpc = args.protocol == "grpc"
    other = https_given if grpc else grpc_given
    if other:
        sys.exit(f"error: {', '.join(other)}: not an option of -i "
                 f"{args.protocol} (the --ssl-{'https' if grpc else 'grpc'}"
                 f"-* options are -i {'http' if grpc else 'grpc'}'s)")
    if grpc:
        if not args.ssl_grpc_use_ssl:
            sys.exit(f"error: {', '.join(grpc_given)} without "
                     "--ssl-grpc-use-ssl: the channel would be plaintext")
        return {
            "use_ssl": True,
            "root_certificates": args.ssl_grpc_root_certifications_file,
            "private_key": args.ssl_grpc_private_key_file,
            "certificate_chain": args.ssl_grpc_certificate_chain_file,
        }
    if (args.ssl_https_private_key_file
            and not args.ssl_https_client_certificate_file):
        sys.exit("error: --ssl-https-private-key-file without "
                 "--ssl-https-client-certificate-file")
    return {
        "use_ssl": True,
        "verify_peer": bool(args.ssl_https_verify_peer),
        "ca_certificates_file": args.ssl_https_ca_certificates_file,
        "client_certificate_file": args.ssl_https_client_certificate_file,
        "private_key_file": args.ssl_https_private_key_file,
    }


def _refuse_native(args, kind, loader):
    """Exits where --native-loadgen cannot run as asked (the reference's
    refusals, in its order; device regions are ``cuda`` here)."""
    if (args.hermetic or kind != BackendKind.TRITON_GRPC
            or args.async_mode or args.request_intervals):
        sys.exit("error: --native-loadgen drives a socket gRPC "
                 "server (concurrency, --request-rate-range, or "
                 "--sequence mode); interval-file replay and "
                 "--async use the python engine")
    # modes the native sweep does not implement fail LOUDLY rather
    # than silently measuring something else
    unsupported = [
        ("-f/--filename", args.filename),
        ("--json-export", args.json_export),
        ("--latency-threshold", args.latency_threshold),
        ("--binary-search", args.binary_search),
        ("--collect-metrics", args.collect_metrics),
        ("--world-size > 1", args.world_size > 1),
        ("--measurement-mode count_windows",
         args.measurement_mode == "count_windows"),
    ]
    offending = [name for name, on in unsupported if on]
    if offending:
        sys.exit("error: --native-loadgen does not support: "
                 + ", ".join(offending))
    if args.request_rate_range and args.sequence:
        sys.exit("error: --native-loadgen sequence mode is "
                 "closed-loop; pick --request-rate-range OR "
                 "--sequence")
    if args.shared_memory == "none" and args.input_data not in (
            None, "random"):
        sys.exit("error: --native-loadgen wire mode generates "
                 "random tensor bytes; custom --input-data is "
                 "honored via --shared-memory system/cuda (regions "
                 "are staged with the real data)")
    if (loader.num_streams != 1 or loader.num_steps(0) != 1):
        sys.exit("error: --native-loadgen repeats one fixed request "
                 "(stream 0, step 0); dataset rotation needs the "
                 "python load engine")


def _run_native_loadgen(args, binary, loader, data_manager):
    """Load sweep driven by the native C++ engine (perf_worker): region
    setup and metadata live here (this process owns the device); the
    measurement loop is pure C++.  Sweeps concurrency, request rate
    (--request-rate-range, constant/poisson), or stateful sequences
    (--sequence) — each level runs one worker long enough for the
    stability loop over its per-window records."""
    from client_tpu_torch.perf.infer_data import _ShmInferDataManagerBase
    from client_tpu_torch.utils import np_to_triton_dtype

    try:
        wire_inputs, shm_inputs, shm_outputs = [], [], []
        step0 = loader.get_input_data(0, 0)
        if isinstance(data_manager, _ShmInferDataManagerBase):
            for name, td in step0.items():
                region, nbytes = data_manager._regions[(0, 0, name)]
                shm_inputs.append((
                    name, np_to_triton_dtype(td.array.dtype),
                    list(td.array.shape), region, nbytes,
                ))
            for name, (region, nbytes) in data_manager._out_regions.items():
                shm_outputs.append((name, region, nbytes))
        else:
            for name, td in step0.items():
                wire_inputs.append((
                    name, np_to_triton_dtype(td.array.dtype),
                    list(td.array.shape),
                ))

        window_s = max(args.measurement_interval / 1e3, 0.5)
        # enough windows for the 3-window stability check without letting
        # default settings balloon a level past ~6 windows
        n_windows = max(3, min(args.max_trials, 6))
        threshold = args.stability_percentage / 100.0

        if args.request_rate_range:
            start, end, step = _parse_range(args.request_rate_range, float)
            # index-based levels: float accumulation (r += step) can skip
            # the final level to rounding (0.1+0.1+0.1 > 0.3)
            n_levels = int(round((end - start) / step)) + 1 if step else 1
            levels = []
            for i in range(max(n_levels, 1)):
                r = start + i * step
                if r > end * (1 + 1e-9):
                    break
                levels.append(("Request rate", r, {
                    "request_rate": r,
                    "distribution": args.request_distribution,
                    "concurrency": args.max_threads,
                }))
        else:
            start, end, step = _parse_range(args.concurrency_range or "1", int)
            label = "Sequences" if args.sequence else "Concurrency"
            levels = []
            c = start
            while c <= end:
                kw = ({"sequences": c, "seq_steps": args.sequence_length,
                       "concurrency": 1}
                      if args.sequence else {"concurrency": c})
                levels.append((label, c, kw))
                c += step

        best = None
        errors = 0
        for label, level, kw in levels:
            report = run_native_worker(
                args.url, args.model_name, binary=binary,
                duration_s=window_s * n_windows, warmup_s=1.0,
                window_interval_s=window_s,
                completion_sync=args.cuda_shm_sync,
                wire_inputs=wire_inputs, shm_inputs=shm_inputs,
                shm_outputs=shm_outputs, **kw,
            )
            errors += report["errors"]
            windows = report.get("windows", [])
            stable = native_windows_stable(windows, threshold)
            if stable:
                tail = windows[-3:]
                report["stable_throughput"] = round(
                    sum(w["throughput"] for w in tail) / 3, 2
                )
            delayed = (f", delayed {report['delayed']}"
                       if report.get("delayed") else "")
            print(
                f"{label}: {level:g}, throughput: "
                f"{report['throughput']:.1f} infer/sec (native), "
                f"p50 {report['p50_us']:.0f} usec, "
                f"p99 {report['p99_us']:.0f} usec, "
                f"errors {report['errors']}{delayed}, "
                f"{'stable' if stable else 'UNSTABLE'} over "
                f"{len(windows)} windows"
            )
            if best is None or report["throughput"] > best[1]["throughput"]:
                best = (level, report)
        if best is not None:
            name = ("rate" if args.request_rate_range
                    else "sequences" if args.sequence else "concurrency")
            print(
                f"Best: {name}={best[0]:g} -> "
                f"{best[1]['throughput']:.1f} infer/sec, "
                f"avg latency {best[1]['avg_us']:.0f} usec"
            )
        return 0 if best is not None and errors == 0 else 1
    finally:
        data_manager.cleanup()


def _refuse_without_torch(args):
    """Exits, naming torch, where an option given needs it and it is not
    installed: CUDA regions, a device, the local GPU gauges and the
    probe."""
    options = [flag for flag, on in (
        ("--shared-memory cuda", args.shared_memory == "cuda"),
        ("--device", args.device is not None),
        ("--collect-local-gpu-metrics", args.collect_local_gpu_metrics),
        ("--probe-device-utilization", args.probe_device_utilization),
    ) if on]
    if options:
        try:
            require_torch(", ".join(options))
        except ModuleNotFoundError as e:
            sys.exit(f"error: {e}")


def _device(args):
    """The device the run's hermetic models, CUDA regions and probe use;
    exits with a message where CUDA is implied and absent.  None without
    torch: only a hermetic run gets here then (its numpy builtins need
    no device, and ``model_sets`` refuses the other sets)."""
    try:
        return resolve_device(args.device)
    except ModuleNotFoundError as e:
        if e.name != "torch":
            raise
        return None
    except RuntimeError as e:
        sys.exit(f"error: {e} (here: --device cpu)")


def main(argv=None):
    args = build_parser().parse_args(argv)

    urls = [u.strip() for u in args.url.split(",") if u.strip()]
    ssl_options = _ssl_options(args)

    shape_overrides = {}
    for item in args.shape:
        name, _, dims = item.partition(":")
        shape_overrides[name] = [int(d) for d in dims.split(",")]

    if args.speculative is not None:
        if args.speculative < 1:
            sys.exit("error: --speculative K must be >= 1")
        if not args.hermetic:
            sys.exit("error: --speculative configures the in-process LM "
                     "engine; add --hermetic")

    _refuse_without_torch(args)
    # a hermetic non-KServe run starts only a host fake: no device
    service = args.service_kind != "triton"
    device = None
    if ((args.hermetic and not service) or args.shared_memory == "cuda"
            or args.collect_local_gpu_metrics
            or args.probe_device_utilization):
        device = _device(args)

    # the local device parts of --collect-metrics refuse to run without
    # CUDA (the probe: unless --device cpu) before anything starts
    probe = None
    if ((args.collect_local_gpu_metrics or args.probe_device_utilization)
            and not args.collect_metrics):
        print("warning: --collect-local-gpu-metrics/"
              "--probe-device-utilization have no effect without "
              "--collect-metrics", file=sys.stderr)
    if args.collect_metrics and args.hermetic:
        print("warning: --collect-metrics needs a socket server; "
              "ignored with --hermetic", file=sys.stderr)
    elif args.collect_metrics:
        try:
            if args.collect_local_gpu_metrics:
                local_device_snapshot()
            if args.probe_device_utilization:
                probe = DeviceUtilizationProbe(device=device)
        except RuntimeError as e:
            sys.exit(f"error: {e}")

    engine = None
    fake = None
    backend_kwargs = {}
    if service:
        kind = {
            "torchserve": BackendKind.TORCHSERVE,
            "tfserve": BackendKind.TFSERVE,  # gRPC PredictionService
            "tfserve_rest": BackendKind.TFSERVE_REST,
        }[args.service_kind]
        # --shape stays tensor-name-keyed: these services declare one input
        # ("data" / "instances" / "input" — the names their backends
        # synthesize)
        tensor = {
            "torchserve": "data",
            "tfserve": "input",
            "tfserve_rest": "instances",
        }[args.service_kind]
        if tensor in shape_overrides:
            backend_kwargs["input_shape"] = shape_overrides[tensor]
        for key in shape_overrides:
            if key != tensor:
                print(
                    f"warning: --shape '{key}' does not match this service "
                    f"kind's input tensor '{tensor}'; ignored",
                    file=sys.stderr,
                )
        if args.hermetic:
            from client_tpu_torch.perf.fake_endpoints import (
                fake_tfserving,
                fake_tfserving_grpc,
                fake_torchserve,
            )

            fake = {
                "torchserve": fake_torchserve,
                "tfserve": fake_tfserving_grpc,
                "tfserve_rest": fake_tfserving,
            }[args.service_kind]([args.model_name]).start()
            args.url = fake.url
    elif args.hermetic:
        from client_tpu_torch.serve import InferenceEngine
        from client_tpu_torch.serve.models import model_sets

        cache = None
        if args.hermetic_cache_entries > 0:
            from client_tpu_torch.serve.frontdoor import ResponseCache

            cache = ResponseCache(max_entries=args.hermetic_cache_entries)
        speculative = None
        if args.speculative is not None:
            speculative = {"k": args.speculative, "drafter": args.drafter}
        try:
            models = model_sets(args.hermetic_models, device=device,
                                speculative=speculative)
        except ModuleNotFoundError as e:
            if e.name != "torch":
                raise
            sys.exit(f"error: {e}")
        engine = InferenceEngine(  # no sockets
            models,
            response_cache=cache,
            coalescing=args.hermetic_cache_entries > 0,
        )
        kind = BackendKind.INPROCESS
    else:
        kind = (
            BackendKind.TRITON_GRPC
            if args.protocol == "grpc"
            else BackendKind.TRITON_HTTP
        )

    # Multi-replica fan-out: workers are assigned round-robin across the
    # --url list via an EndpointPool, and the summary reports a
    # per-endpoint throughput/latency split.
    replica_pool = None
    if len(urls) > 1:
        if (args.hermetic or args.native_loadgen or args.async_mode
                or kind not in (BackendKind.TRITON_GRPC,
                                BackendKind.TRITON_HTTP)):
            sys.exit("error: a --url replica list drives the python load "
                     "engine over socket HTTP/gRPC (not --hermetic, "
                     "--native-loadgen, --async, or non-Triton "
                     "--service-kind)")
        if args.shared_memory != "none":
            sys.exit("error: --shared-memory regions are registered on one "
                     "server; they cannot fan out across a --url replica "
                     "list")
        if len(set(urls)) != len(urls):
            sys.exit("error: duplicate endpoint in the --url replica list")
        from client_tpu_torch.balance import EndpointPool

        replica_pool = EndpointPool(urls, policy="round-robin")
        args.url = urls[0]  # control plane: metadata/statistics/trace

    # Churn-soak: drive discovery updates into the live pool while the
    # load runs — membership rotates through the resolver machinery, so
    # probation/retire/evict are exercised exactly as production would.
    churn_loop = None
    if args.churn_soak is not None:
        if replica_pool is None:
            sys.exit("error: --churn-soak needs a --url replica list "
                     "(membership churn over a single endpoint would "
                     "violate the last-healthy safety valve every tick)")
        from client_tpu_torch.balance.discovery import (
            CallableResolver,
            DiscoveryLoop,
        )

        churn_tick = {"n": 0}

        def churn_membership():
            # tick k retires replica k % (n+1); the full-fleet round
            # (k == n) re-admits everyone, so each replica cycles through
            # retire -> evict -> re-add -> probation -> active
            i = churn_tick["n"] % (len(urls) + 1)
            churn_tick["n"] += 1
            if i == len(urls):
                return list(urls)
            return [u for j, u in enumerate(urls) if j != i]

        churn_loop = DiscoveryLoop(
            replica_pool, CallableResolver(churn_membership),
            interval_s=args.churn_soak,
        ).start()
        if args.verbose:
            print(f"churn soak: rotating {len(urls)} replicas every "
                  f"{args.churn_soak:g}s", file=sys.stderr)

    def backend_factory():
        url = (
            replica_pool.pick().url if replica_pool is not None else args.url
        )
        return ClientBackendFactory.create(
            kind, url=url, engine=engine, verbose=False,
            ssl_options=ssl_options, **backend_kwargs
        )

    control = backend_factory()
    try:
        trace_settings = {}
        if args.trace_level is not None:
            trace_settings["trace_level"] = args.trace_level
        if args.trace_rate is not None:
            trace_settings["trace_rate"] = str(args.trace_rate)
        if args.trace_count is not None:
            trace_settings["trace_count"] = str(args.trace_count)
        if args.log_frequency is not None:
            trace_settings["log_frequency"] = str(args.log_frequency)
        if trace_settings:
            control.update_trace_settings(
                model_name=args.model_name, settings=trace_settings
            )
            if args.verbose:
                print(f"trace settings applied: {trace_settings}",
                      file=sys.stderr)
        parser_obj = ModelParser.create(
            control, args.model_name, args.model_version,
            batch_size=args.batch_size,
        )
        inputs_meta = parser_obj.inputs
        outputs_meta = parser_obj.outputs
        if parser_obj.requires_sequence_flags() and not args.sequence:
            print(
                f"note: model '{args.model_name}' uses the "
                f"{parser_obj.scheduler_type} scheduler; consider --sequence",
                file=sys.stderr,
            )

        loader = DataLoader(
            inputs_meta, batch_size=args.batch_size,
            shape_overrides=shape_overrides,
        )
        if args.prefix_share is not None:
            if args.input_data not in (None, "random"):
                sys.exit("error: --prefix-share generates its own prompt "
                         "workload; drop --input-data")
            if args.native_loadgen:
                sys.exit("error: --prefix-share rotates a prompt set; the "
                         "native engine repeats one fixed request")
            loader.generate_prefix_share(
                args.prefix_share, num_prompts=args.prefix_prompts,
                shared_pool=args.prefix_pool,
            )
        elif args.input_data in (None, "random"):
            loader.generate_data(string_length=args.string_length)
        elif args.input_data == "zero":
            loader.generate_data(zero_data=True,
                                 string_length=args.string_length)
        elif args.input_data.endswith(".json"):
            loader.read_data_from_json(args.input_data)
        else:
            loader.read_data_from_dir(args.input_data)

        # every refusal comes before the data manager registers a region
        tenant_slots = _parse_tenants(args.tenants)
        if tenant_slots and (args.async_mode or args.native_loadgen):
            sys.exit("error: --tenants drives the thread-per-slot python "
                     "load engine (not --async / --native-loadgen)")
        if args.async_mode and (args.request_intervals
                                or args.request_rate_range):
            sys.exit("error: --async applies to concurrency mode only "
                     "(request-rate/interval schedules use worker threads)")
        native_binary = None
        if args.native_loadgen:
            _refuse_native(args, kind, loader)
            native_binary = build_native_worker()  # raises if it fails

        data_manager = create_infer_data_manager(
            control, loader, inputs_meta, outputs_meta,
            shared_memory=args.shared_memory,
            output_shm_byte_size=args.output_shared_memory_size,
            device_id=args.cuda_device_id,
            cuda_completion_sync=args.cuda_shm_sync,
            device=device,
        )
        data_manager.init()
        if args.native_loadgen:
            return _run_native_loadgen(args, native_binary, loader,
                                       data_manager)

        sequences = None
        if args.sequence:
            sequences = SequenceManager(
                start_sequence_id=args.start_sequence_id,
                sequence_id_range=args.sequence_id_range,
                sequence_length=args.sequence_length,
                sequence_length_variation=args.sequence_length_variation,
                sequence_length_specified=True,
                num_streams=loader.num_streams,
            )

        common = dict(
            backend_factory=backend_factory,
            data_loader=loader,
            data_manager=data_manager,
            model_name=args.model_name,
            model_version=args.model_version,
            sequence_manager=sequences,
            max_threads=args.max_threads,
            tenants=tenant_slots,
        )
        latency_limit_us = args.latency_threshold * 1e3 or None

        if args.request_intervals:
            manager = CustomLoadManager(
                intervals_file=args.request_intervals, **common
            )
        elif args.request_rate_range:
            manager = RequestRateManager(
                distribution=args.request_distribution, **common
            )
        elif args.async_mode:
            if (args.hermetic or kind != BackendKind.TRITON_GRPC
                    or args.sequence):
                sys.exit("error: --async requires a socket gRPC server and "
                         "a stateless workload (sequences ride streaming)")
            manager = AsyncConcurrencyManager(
                url=args.url,
                data_loader=loader,
                data_manager=data_manager,
                model_name=args.model_name,
                model_version=args.model_version,
                max_threads=args.max_threads,
            )
        else:
            manager = ConcurrencyManager(**common)

        metrics = None
        if args.collect_metrics and not args.hermetic:
            url = args.metrics_url or f"http://{args.url}/metrics"
            metrics = MetricsManager(
                url, interval_s=args.metrics_interval / 1e3,
                include_local_devices=args.collect_local_gpu_metrics,
                utilization_probe=probe,
            ).start()

        # the metrics (and the probe's first kernel) start BEFORE the
        # rendezvous barrier so multi-rank measurement windows stay aligned
        # after the barrier releases
        rendezvous = None
        if args.world_size > 1:
            rendezvous = Rendezvous(
                args.rank, args.world_size, args.rendezvous_addr
            )
            rendezvous.barrier()  # start measuring together (MPIBarrierWorld)

        profiler = InferenceProfiler(
            manager,
            backend=control,
            measurement_window_s=args.measurement_interval / 1e3,
            max_trials=args.max_trials,
            stability_threshold=args.stability_percentage / 100.0,
            percentile=args.percentile,
            verbose=args.verbose,
            metrics_manager=metrics,
            rendezvous=rendezvous,
            measurement_mode=args.measurement_mode,
            measurement_request_count=args.measurement_request_count,
        )
        if engine is not None:
            # hermetic runs read the LM engine's prefix and speculative
            # counters straight from the in-process registry as deltas a
            # level; socket runs have no per-level counter deltas to offer
            registry = engine.metrics

            def count(name):
                return int(registry.get(name) or 0)

            if args.prefix_share is not None:
                profiler.prefix_probe = lambda: {
                    "hits": count("ctpu_lm_prefix_hits_total"),
                    "misses": count("ctpu_lm_prefix_misses_total"),
                    "prefill_tokens": count("ctpu_lm_prefill_tokens_total"),
                    "saved_tokens": count(
                        "ctpu_lm_prefill_tokens_saved_total"
                    ),
                }
            if args.speculative is not None:
                # delivered = accepted + one correction per verify
                profiler.spec_probe = lambda: {
                    "proposed": count("ctpu_lm_spec_proposed_tokens_total"),
                    "accepted": count("ctpu_lm_spec_accepted_tokens_total"),
                    "lm_tokens": count("ctpu_lm_tokens_total"),
                }

        json_extra = {}
        try:
            if args.request_intervals:
                manager.start()
                results = [profiler.profile_level("custom_intervals", 0)]
            elif args.request_rate_range:
                start, end, step = _parse_range(args.request_rate_range, float)
                if args.binary_search and latency_limit_us:
                    # SLO-seeking capacity search: max sustainable QPS
                    # under the latency limit (open-loop arrivals)
                    results, best = profiler.profile_request_rate_binary(
                        start, end, latency_limit_us,
                        resolution=step if len(
                            args.request_rate_range.split(":")) > 2 else None,
                    )
                    # the search's verdict rides the JSON export
                    json_extra["slo_search"] = {
                        "latency_limit_us": latency_limit_us,
                        "percentile": args.percentile,
                        "best_request_rate": (
                            None if best is None else best.level_value
                        ),
                        "best_throughput_infer_per_sec": (
                            None if best is None else best.throughput
                        ),
                    }
                    if best is not None:
                        print(
                            f"Max sustainable rate under SLO: "
                            f"{best.level_value} req/s "
                            f"({best.throughput:.1f} infer/sec)"
                        )
                    else:
                        print("SLO violated at every probed rate")
                else:
                    results = profiler.profile_request_rate_range(
                        start, end, step, latency_limit_us
                    )
            else:
                start, end, step = _parse_range(
                    args.concurrency_range or "1", int
                )
                if args.binary_search and latency_limit_us:
                    results, _ = profiler.profile_concurrency_binary(
                        start, end, latency_limit_us
                    )
                else:
                    results = profiler.profile_concurrency_range(
                        start, end, step, latency_limit_us
                    )
        finally:
            manager.cleanup()
            if metrics is not None:
                metrics.stop()

        print_summary(results, percentile=args.percentile)
        if rendezvous is not None:
            # rank-aggregated totals (the multi-model MPI mode's raison d'etre)
            per_rank = rendezvous.all_gather(
                [
                    {"level": s.level_value, "throughput": s.throughput,
                     "model": args.model_name}
                    for s in results
                ]
            )
            if args.rank == 0:
                print("\nAggregate across ranks:")
                for rank, levels in enumerate(per_rank):
                    for entry in levels:
                        print(
                            f"  rank {rank} [{entry['model']}] level "
                            f"{entry['level']}: {entry['throughput']:.1f} "
                            "infer/sec"
                        )
                total = sum(e["throughput"] for lv in per_rank for e in lv)
                print(f"  total: {total:.1f} infer/sec")
            rendezvous.close()
        # every request of the run, windows or not: what the server's
        # statistics count
        completed, failed = manager.request_totals()
        json_extra["requests"] = {"completed": completed, "failed": failed}
        print(f"Requests: {completed} completed, {failed} failed")
        if replica_pool is not None:
            per = json_extra["requests"]["per_endpoint"] = {}
            for url, (done, bad) in sorted(
                    manager.request_totals(by_endpoint=True).items()):
                per[url] = {"completed": done, "failed": bad}
                print(f"Requests at {url}: {done} completed, {bad} failed")
        if args.filename:
            write_csv(args.filename, results, verbose=args.verbose)
            print(f"wrote {args.filename}")
        if args.json_export:
            write_json(args.json_export, results, extra=json_extra)
            print(f"wrote {args.json_export}")
        return 0 if results and all(r.error_count == 0 for r in results) else 1
    except InferenceServerException as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    finally:
        if churn_loop is not None:
            churn_loop.close()
        if replica_pool is not None:
            replica_pool.close()
        try:
            control.close()
        except Exception:
            pass
        if engine is not None:
            engine.close()
        if fake is not None:
            fake.stop()


if __name__ == "__main__":
    sys.exit(main())
