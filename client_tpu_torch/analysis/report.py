"""tpu-lint reporters: human text and machine JSON."""

import json


def render_text(new, grandfathered, rules):
    """Return the human report as a string (one finding per line)."""
    lines = []
    for f in new:
        lines.append(f.render())
    if new:
        lines.append("")
    counts = {}
    for f in new:
        counts[f.rule] = counts.get(f.rule, 0) + 1
    summary = ", ".join(f"{r}:{n}" for r, n in sorted(counts.items()))
    lines.append(
        f"tpu-lint: {len(new)} finding(s)"
        + (f" [{summary}]" if summary else "")
        + (
            f", {len(grandfathered)} grandfathered (baseline)"
            if grandfathered
            else ""
        )
    )
    return "\n".join(lines)


def render_json(new, grandfathered, rules):
    return json.dumps(
        {
            "findings": [f.to_dict() for f in new],
            "grandfathered": [f.to_dict() for f in grandfathered],
            "rules": {
                rule.id: rule.rationale for rule in rules.values()
            },
            "count": len(new),
        },
        indent=2,
    )


def render_sarif(new, grandfathered, rules):
    """SARIF 2.1.0 — the interchange format CI annotators, editors, and
    code-scanning UIs consume directly.  Grandfathered (baselined)
    findings are emitted with ``"baselineState": "unchanged"`` so a
    consumer can show or hide the ratchet debt; new findings are
    ``level: error`` (they fail the gate)."""
    def result(f, baselined):
        out = {
            "ruleId": f.rule,
            "level": "note" if baselined else "error",
            "message": {"text": f.message},
            "locations": [{
                "physicalLocation": {
                    "artifactLocation": {
                        "uri": f.path.replace("\\", "/"),
                    },
                    "region": {
                        "startLine": max(int(f.line), 1),
                        "startColumn": max(int(f.col) + 1, 1),
                    },
                },
            }],
        }
        if baselined:
            out["baselineState"] = "unchanged"
        return out

    driver = {
        "name": "tpu-lint",
        "informationUri": (
            "https://github.com/tpu-client/tpu-client"
            "#static-analysis"
        ),
        "rules": [
            {
                "id": rule.id,
                "shortDescription": {"text": rule.rationale},
                "fullDescription": {
                    "text": (type(rule).__doc__ or "").strip(),
                },
            }
            for _rid, rule in sorted(rules.items())
        ],
    }
    return json.dumps(
        {
            "$schema": (
                "https://raw.githubusercontent.com/oasis-tcs/"
                "sarif-spec/master/Schemata/sarif-schema-2.1.0.json"
            ),
            "version": "2.1.0",
            "runs": [{
                "tool": {"driver": driver},
                "results": (
                    [result(f, False) for f in new]
                    + [result(f, True) for f in grandfathered]
                ),
            }],
        },
        indent=2,
    )


def render_rules(rules):
    lines = ["tpu-lint rule catalog:"]
    for rule_id in sorted(rules):
        lines.append(f"  {rule_id:20s} {rules[rule_id].rationale}")
    lines.append(
        "suppress in place with `# tpulint: disable=RULE -- why` (same "
        "line or a comment line above); reason-less suppressions are "
        "BARE-SUPPRESS findings"
    )
    return "\n".join(lines)


def render_explain(rules, rule_id):
    """Full rationale for one rule (class docstring + one-liner), or
    None when the id is unknown."""
    rule = rules.get(rule_id.strip().upper())
    if rule is None:
        return None
    doc = (type(rule).__doc__ or "").strip("\n")
    lines = [f"{rule.id}: {rule.rationale}", ""]
    if doc:
        lines.append(doc)
    return "\n".join(lines)
