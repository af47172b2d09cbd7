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
    parser.add_argument("-v", "--verbose", action="store_true")
    parser.add_argument(
        "--models", default="language",
        help="comma-separated model sets: jax (the CNN classifier), "
             "resnet (resnet50), language, pipeline (the resnet50 vision "
             "ensemble) (default: language)",
    )
    parser.add_argument(
        "--device", choices=("cuda", "cpu"), default="cuda",
        help="device the models run on (default: cuda; cpu runs the plain "
             "PyTorch versions of the kernels)",
    )
    args = parser.parse_args()

    from client_tpu_torch.serve import Server
    from client_tpu_torch.serve.models import model_sets

    server = Server(
        models=model_sets(args.models, device=args.device),
        http_port=args.http_port,
        host=args.host,
        verbose=args.verbose,
    ).start()
    print(f"client_tpu_torch.serve: HTTP on {server.http_address}", flush=True)

    stop = threading.Event()
    signal.signal(signal.SIGINT, lambda *a: stop.set())
    signal.signal(signal.SIGTERM, lambda *a: stop.set())
    stop.wait()
    server.stop()


if __name__ == "__main__":
    main()
