"""Baseline ratchet for tpu-lint.

Grandfathered findings live in a committed JSON file keyed by
``(path, rule, stripped-source-line)`` — stable across pure line-number
drift.  The gate starts green on the day the analyzer lands and only
ratchets DOWN: a finding matching a baseline entry is filtered; a new
finding (or one more occurrence of a baselined line than the baseline
carries) fails the run.  ``--write-baseline`` regenerates the file from
the current tree after a deliberate cleanup.

Every entry of the port's ``baseline.json`` carries a ``reason``: why
the finding is the code's purpose rather than a hazard.  A regenerated
file keeps the reasons of the entries it keeps; a new entry starts with
an empty one, which its author fills in.
"""

import collections
import json
import os

DEFAULT_BASELINE = os.path.join(os.path.dirname(__file__), "baseline.json")


def load(path):
    """Return the baseline as a Counter of finding keys; {} if absent."""
    if not path or not os.path.exists(path):
        return collections.Counter()
    with open(path, "r", encoding="utf-8") as fh:
        data = json.load(fh)
    counter = collections.Counter()
    for entry in data.get("findings", []):
        key = (entry["path"], entry["rule"], entry["snippet"])
        counter[key] += int(entry.get("count", 1))
    return counter


def reasons(path):
    """``{(path, rule, snippet): reason}`` of the baseline at *path*."""
    if not path or not os.path.exists(path):
        return {}
    with open(path, "r", encoding="utf-8") as fh:
        data = json.load(fh)
    return {
        (e["path"], e["rule"], e["snippet"]): e.get("reason", "")
        for e in data.get("findings", [])
    }


def save(path, findings):
    """Write the given findings as the new baseline (sorted, counted),
    each with the reason the file already gave its key."""
    counter = collections.Counter(f.key() for f in findings)
    kept = reasons(path)
    entries = [
        {"path": p, "rule": r, "snippet": s, "count": n,
         "reason": kept.get((p, r, s), "")}
        for (p, r, s), n in sorted(counter.items())
    ]
    with open(path, "w", encoding="utf-8") as fh:
        json.dump(
            {
                "comment": (
                    "tpu-lint grandfathered findings; regenerate with "
                    "python -m client_tpu_torch.analysis --write-baseline"
                ),
                "findings": entries,
            },
            fh, indent=2, sort_keys=True,
        )
        fh.write("\n")


def filter_findings(findings, baseline_counter):
    """Split findings into (new, grandfathered) against the baseline.

    Occurrences beyond the baselined count for a key are NEW — the
    ratchet lets old debt stand but never grow.
    """
    remaining = collections.Counter(baseline_counter)
    new, old = [], []
    for f in findings:
        if remaining[f.key()] > 0:
            remaining[f.key()] -= 1
            old.append(f)
        else:
            new.append(f)
    return new, old
