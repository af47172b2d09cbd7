"""CLI: ``python -m client_tpu_torch.analysis [paths...]``.

Exit codes: 0 clean (after baseline filtering), 1 findings, 2 analyzer
usage/internal error.  The default path is ``client_tpu_torch``; the
rules are the reference analyser's (``client_tpu.analysis``) with torch
keys added: CUDA-graph captures, extension builds and host syncs count as
dispatch under a lock, names bound from ``torch.compile`` or
``make_graphed_callables`` as compiled callables, torch tensor producers
in truth positions, host syncs in ``async def`` bodies.
"""

import argparse
import os
import subprocess
import sys

from client_tpu_torch.analysis import (
    PROGRAM_REGISTRY,
    REGISTRY,
    all_rules,
    scan_paths,
)
from client_tpu_torch.analysis import baseline as baseline_mod
from client_tpu_torch.analysis import cache as cache_mod
from client_tpu_torch.analysis import report


def _changed_files():
    """Files changed vs the merge base with origin/main (falling back to
    a local main, then to the index alone), plus untracked files —
    normalized paths, or None when git itself is unusable (the caller
    errors loudly: a silently-empty changed set would green-light
    anything)."""
    def git(*args):
        try:
            proc = subprocess.run(
                ["git", *args], capture_output=True, text=True,
                timeout=30,
            )
        except (subprocess.TimeoutExpired, OSError):
            # a hung git (stale index lock, dead network fs) must reach
            # the caller's loud exit-2 path, not die in a traceback
            return None
        if proc.returncode != 0:
            return None
        return proc.stdout

    toplevel = git("rev-parse", "--show-toplevel")
    if not toplevel:
        return None
    toplevel = toplevel.strip()
    base = None
    for ref in ("origin/main", "main"):
        out = git("merge-base", "HEAD", ref)
        if out:
            base = out.strip()
            break
    diff = git("diff", "--name-only", base) if base else git(
        "diff", "--name-only", "HEAD"
    )
    if diff is None:
        return None
    untracked = git("ls-files", "--others", "--exclude-standard")
    names = diff.splitlines() + (
        untracked.splitlines() if untracked else []
    )
    # git names are repo-root-relative; finding paths are CLI-relative
    # (or absolute) — compare on one realpath basis so an absolute scan
    # root or a subdirectory cwd cannot silently empty the changed set
    return {
        os.path.realpath(os.path.join(toplevel, n))
        for n in names if n.strip()
    }


def main(argv=None):
    parser = argparse.ArgumentParser(
        prog="python -m client_tpu_torch.analysis",
        description=(
            "tpu-lint: concurrency & array-semantics rules grown from "
            "this repo's shipped bugs (per-file AST rules + whole-program "
            "call-graph/lock-order analysis)"
        ),
    )
    parser.add_argument(
        "paths", nargs="*", default=["client_tpu_torch"],
        help="files or directories to scan (default: client_tpu_torch)",
    )
    parser.add_argument(
        "--format", choices=("text", "json", "sarif"), default="text",
        help=(
            "report format (json is the machine-readable CI surface; "
            "sarif is SARIF 2.1.0 for CI annotators and editors)"
        ),
    )
    parser.add_argument(
        "--json", action="store_true",
        help="alias for --format json",
    )
    parser.add_argument(
        "--changed-only", action="store_true",
        help=(
            "report per-file findings only for files changed vs "
            "`git merge-base HEAD origin/main` (plus untracked files); "
            "the whole-program passes still run over the full tree — "
            "warm from cache — so cross-file findings never go dark. "
            "The fast pre-commit path."
        ),
    )
    parser.add_argument(
        "--baseline", default=baseline_mod.DEFAULT_BASELINE,
        help="baseline file of grandfathered findings",
    )
    parser.add_argument(
        "--no-baseline", action="store_true",
        help="report every finding, ignoring the baseline",
    )
    parser.add_argument(
        "--write-baseline", action="store_true",
        help="regenerate the baseline from the current findings and exit 0",
    )
    parser.add_argument(
        "--rules", default="",
        help="comma-separated rule ids to run (default: all)",
    )
    parser.add_argument(
        "--list-rules", action="store_true",
        help="print the rule catalog and exit",
    )
    parser.add_argument(
        "--explain", metavar="RULE", default="",
        help="print one rule's full rationale and exit",
    )
    parser.add_argument(
        "--no-cache", action="store_true",
        help="ignore and do not write the incremental analysis cache",
    )
    parser.add_argument(
        "--cache-file", default=cache_mod.DEFAULT_CACHE,
        help="incremental cache location (default: under the checkout's "
        "build/, never in the package)",
    )
    args = parser.parse_args(argv)

    if args.list_rules:
        print(report.render_rules(all_rules()))
        return 0

    if args.explain:
        text = report.render_explain(all_rules(), args.explain)
        if text is None:
            print(
                f"tpu-lint: unknown rule {args.explain!r} "
                "(see --list-rules)",
                file=sys.stderr,
            )
            return 2
        print(text)
        return 0

    rules = None  # None = full default rule set (cache-eligible)
    program_rules = None
    if args.rules:
        wanted = {r.strip().upper() for r in args.rules.split(",")}
        known = all_rules()
        unknown = wanted - set(known)
        if unknown:
            print(
                f"tpu-lint: unknown rule(s): {', '.join(sorted(unknown))}",
                file=sys.stderr,
            )
            return 2
        rules = {k: v for k, v in REGISTRY.items() if k in wanted}
        program_rules = {
            k: v for k, v in PROGRAM_REGISTRY.items() if k in wanted
        }

    missing = [p for p in args.paths if not os.path.exists(p)]
    if missing:
        # a typo'd path must not turn the gate into a silent green no-op
        print(
            f"tpu-lint: no such path(s): {', '.join(missing)}",
            file=sys.stderr,
        )
        return 2

    analysis_cache = (
        None if args.no_cache else cache_mod.AnalysisCache(args.cache_file)
    )
    findings = scan_paths(
        args.paths, rules=rules, cache=analysis_cache,
        program_rules=program_rules,
    )

    if args.changed_only:
        changed = _changed_files()
        if changed is None:
            print(
                "tpu-lint: --changed-only needs a working git checkout "
                "(git diff failed)",
                file=sys.stderr,
            )
            return 2
        # per-file findings (the waiver audit included) narrow to the
        # changed set; whole-program findings keep their full-tree
        # scope — a cross-file hazard introduced by a changed file can
        # anchor in an unchanged one
        findings = [
            f for f in findings
            if f.rule not in REGISTRY
            or os.path.realpath(f.path) in changed
        ]

    if args.write_baseline:
        if (
            args.rules
            or args.changed_only
            or args.paths != parser.get_default("paths")
        ):
            # a filtered scan would overwrite the whole file and silently
            # drop every other rule's/path's grandfathered entries
            print(
                "tpu-lint: --write-baseline requires a full default scan "
                "(no --rules, no --changed-only, default paths)",
                file=sys.stderr,
            )
            return 2
        baseline_mod.save(args.baseline, findings)
        print(
            f"tpu-lint: wrote {len(findings)} finding(s) to "
            f"{args.baseline}"
        )
        return 0

    baseline = (
        {} if args.no_baseline else baseline_mod.load(args.baseline)
    )
    new, old = baseline_mod.filter_findings(findings, baseline)

    if args.json or args.format == "json":
        print(report.render_json(new, old, all_rules()))
    elif args.format == "sarif":
        print(report.render_sarif(new, old, all_rules()))
    else:
        print(report.render_text(new, old, all_rules()))
    return 1 if new else 0


if __name__ == "__main__":
    sys.exit(main())
