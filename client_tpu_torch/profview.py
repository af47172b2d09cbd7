"""profview: render continuous-profiler reports as top-down
attribution tables (sibling of traceview, which renders per-trace
timelines — this renders *where the engine's time goes*).

The port's copy of client_tpu/profview.py, over the port's
:func:`client_tpu_torch.serve.prof.attribute_phases`: the same tables
and JSON from the same files.  ``--live`` builds the port's
``InferenceEngine`` with the port's cnn model, on CUDA unless it is
given ``--device cpu``; without CUDA and without that flag it refuses.

Input is either a prof report JSON file (the ``GET /v2/debug/prof``
payload — ``{"kind": "prof_report", "engines": [rollups...]}`` — or a
single engine rollup) or a flight-recorder JSON-lines dump whose
``prof_tick`` records profview re-rolls into the same shape::

    curl :8000/v2/debug/prof > prof.json
    python -m client_tpu_torch.profview prof.json
    python -m client_tpu_torch.profview --format json flight-*.jsonl
    python -m client_tpu_torch.profview --live    # self-contained demo

Per engine it prints tick counts by kind, the ranked per-phase table
(seconds + percentage of covered time), the dispatch/compute/host/idle
attribution split, and per-model device share / MFU — the table the
38%-idle-link question is answered from.

``--live`` spins an in-process engine (the cnn model), runs a short
unary workload through it, and renders its own report; no server or
file needed.  The LM engine's attribution comes from a server's
``/v2/debug/prof`` report.

Exit codes: 0 rendered, 1 no prof data in the inputs, 2 unreadable or
unparsable input.  Everything here is stdlib + the serve package.
"""

import argparse
import json
import sys

from client_tpu_torch import require_torch, resolve_device
from client_tpu_torch.serve.prof import attribute_phases

__all__ = ["load_reports", "rollup_from_ticks", "render_engine", "main"]


def _engines_of(obj):
    """Engine rollup dicts inside one parsed JSON object (a prof_report,
    a bare rollup, or a bench record carrying a ``prof`` block)."""
    if not isinstance(obj, dict):
        return []
    if isinstance(obj.get("engines"), list):
        return [e for e in obj["engines"] if isinstance(e, dict)]
    if "phases" in obj and "kinds" in obj:
        return [obj]
    return []


def rollup_from_ticks(ticks):
    """Re-roll flight-dump ``prof_tick`` records into per-engine rollup
    dicts (the ring's aggregation replayed offline; MFU needs the live
    profiler's FLOP totals, so it is absent here)."""
    by_engine = {}
    for record in ticks:
        engine = str(record.get("engine", ""))
        by_engine.setdefault(engine, []).append(record)
    rollups = []
    for engine, records in sorted(by_engine.items()):
        phases = {}
        kinds = {}
        models = {}
        wall = 0.0
        ticks_n = 0
        for record in records:
            ticks_n += record.get("ticks", 1)
            wall += float(record.get("dur_s", 0.0))
            kind = str(record.get("tick_kind") or record.get("kind"))
            kinds[kind] = kinds.get(kind, 0) + record.get("ticks", 1)
            for name, seconds in (record.get("phases") or {}).items():
                phases[name] = phases.get(name, 0.0) + float(seconds)
            model = record.get("model")
            if model is not None:
                entry = models.setdefault(str(model), [0.0, 0])
                entry[1] += int(record.get("items", 0))
        covered = sum(phases.values())
        rollups.append({
            "engine": engine,
            "ticks": ticks_n,
            "wall_s": round(wall, 6),
            "covered_s": round(covered, 6),
            "kinds": kinds,
            "phases": {
                name: {
                    "s": round(seconds, 6),
                    "pct": round(100.0 * seconds / covered, 2)
                    if covered else 0.0,
                }
                for name, seconds in sorted(
                    phases.items(), key=lambda kv: -kv[1]
                )
            },
            "models": {
                m: {"device_s": 0.0, "items": v[1],
                    "compute_share_pct": 0.0}
                for m, v in sorted(models.items())
            },
            "attribution": attribute_phases(phases, wall_s=wall),
        })
    return rollups


def load_reports(paths):
    """Engine rollups from *paths*: prof report JSON files and/or
    flight JSON-lines dumps.  Unreadable files and garbage JSON raise —
    a postmortem artifact that does not parse should be loud."""
    engines = []
    ticks = []
    for path in paths:
        with open(path, "r", encoding="utf-8") as f:
            text = f.read()
        try:
            obj = json.loads(text)
        except ValueError:
            obj = None
        if obj is not None:
            engines.extend(_engines_of(obj))
            if isinstance(obj, dict) and "prof" in obj:
                engines.extend(_engines_of(obj["prof"]))
            continue
        # JSON-lines (a flight dump): collect its prof_tick records
        for line in text.splitlines():
            line = line.strip()
            if not line:
                continue
            record = json.loads(line)
            if isinstance(record, dict):
                if record.get("kind") == "prof_tick":
                    ticks.append(record)
                else:
                    engines.extend(_engines_of(record))
    engines.extend(rollup_from_ticks(ticks))
    return engines


def render_engine(rollup, out):
    """Human attribution table for one engine's rollup."""
    kinds = rollup.get("kinds") or {}
    kinds_txt = " ".join(
        f"{k}={v}" for k, v in sorted(kinds.items(), key=lambda kv: -kv[1])
    )
    out.write(
        f"engine {rollup.get('engine') or '-'}  "
        f"ticks={rollup.get('ticks', 0)} "
        f"wall={rollup.get('wall_s', 0.0):.3f}s "
        f"covered={rollup.get('covered_s', 0.0):.3f}s"
        + (f"  [{kinds_txt}]" if kinds_txt else "")
        + "\n"
    )
    attribution = rollup.get("attribution")
    if attribution:
        out.write(
            "  attribution: "
            + " | ".join(
                f"{key[:-4]} {attribution[key]:.1f}%"
                for key in ("compute_pct", "dispatch_pct", "host_pct",
                            "idle_pct")
                if key in attribution
            )
            + "\n"
        )
    for name, row in (rollup.get("phases") or {}).items():
        out.write(
            f"    {name:<18} {row['s']:>10.4f}s  {row['pct']:>6.2f}%\n"
        )
    for model, row in (rollup.get("models") or {}).items():
        bits = [
            f"    model {model:<12} items={row.get('items', 0)}",
            f"device={row.get('device_s', 0.0):.4f}s",
            f"share={row.get('compute_share_pct', 0.0):.1f}%",
        ]
        if row.get("mfu_pct") is not None:
            bits.append(f"mfu={row['mfu_pct']:.3f}%")
        out.write(" ".join(bits) + "\n")


def live_report(requests=64, image_size=64, device=None):
    """Spin an in-process engine, run a short cnn unary workload, and
    return its prof report — the ``--live`` path (no server, no files;
    small images keep it a few seconds on the CPU).  *device* is where
    the model runs: CUDA unless it names another (``resolve_device``
    refuses CUDA where there is none)."""
    import numpy as np

    from client_tpu_torch.serve.model_runtime import InferenceEngine
    from client_tpu_torch.serve.models.vision import cnn_classifier_model
    from client_tpu_torch.utils import to_wire_bytes

    engine = InferenceEngine(models=[cnn_classifier_model(
        image_size=image_size, device=resolve_device(device),
    )])
    try:
        arr = np.zeros((1, 3, image_size, image_size), np.float32)
        raw = to_wire_bytes(arr, "FP32")
        request = {
            "id": "",
            "inputs": [{
                "name": "INPUT0",
                "datatype": "FP32",
                "shape": list(arr.shape),
                "parameters": {"binary_data_size": len(raw)},
            }],
            "outputs": [
                {"name": "OUTPUT0", "parameters": {"binary_data": True}}
            ],
        }
        for _ in range(int(requests)):
            engine.execute("cnn_classifier", "", dict(request), raw)
        return engine.prof.report(window_s=0)
    finally:
        engine.close()


def main(argv=None):
    parser = argparse.ArgumentParser(
        prog="python -m client_tpu_torch.profview",
        description="Render continuous-profiler reports "
                    "(/v2/debug/prof JSON or flight dumps) as top-down "
                    "time-attribution tables.",
    )
    parser.add_argument(
        "files", nargs="*",
        help="prof report JSON and/or flight JSON-lines files",
    )
    parser.add_argument(
        "--format", choices=("text", "json"), default="text",
        help="text tables (default) or one JSON rollup per engine",
    )
    parser.add_argument(
        "--engine", default=None,
        help="only engines whose name starts with this",
    )
    parser.add_argument(
        "--live", action="store_true",
        help="ignore files: run a short in-process cnn workload and "
             "render its own report",
    )
    parser.add_argument(
        "--device", default=None,
        help="with --live: the device the cnn runs on (default cuda; "
             "`cpu` for the plain PyTorch path)",
    )
    args = parser.parse_args(argv)
    if args.live:
        try:
            require_torch("profview --live")
            device = resolve_device(args.device)
        except (ModuleNotFoundError, RuntimeError) as e:
            # no torch, or no CUDA and --device cpu not given
            print(f"profview: {e}", file=sys.stderr)
            return 2
        engines = live_report(device=device).get("engines", [])
    else:
        if not args.files:
            parser.error("give prof/flight files or --live")
        if args.device is not None:
            parser.error("--device applies to --live only")
        try:
            engines = load_reports(args.files)
        except (OSError, ValueError) as e:
            print(f"profview: {e}", file=sys.stderr)
            return 2
    if args.engine is not None:
        engines = [
            e for e in engines
            if str(e.get("engine", "")).startswith(args.engine)
        ]
    engines = [e for e in engines if e.get("ticks")]
    if not engines:
        print("no prof data found", file=sys.stderr)
        return 1
    if args.format == "json":
        for rollup in engines:
            sys.stdout.write(
                json.dumps(rollup, separators=(",", ":")) + "\n"
            )
        return 0
    for rollup in engines:
        render_engine(rollup, sys.stdout)
        sys.stdout.write("\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
