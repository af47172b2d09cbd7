"""tpu-lint core: findings, the rule registries, suppressions, file driver.

Pure stdlib (``ast`` + regex comments) so the analyzer runs in any
environment the repo does — no jax, no numpy, no third-party lint
framework.  Two rule families share one driver:

- **per-file rules** (``rules.py``): one function/file at a time;
- **program rules** (``concurrency.py``): run over the whole-program call
  graph + lock summaries built by ``callgraph.py`` — interprocedural
  hazards (lock-order inversion, blocking/callbacks reached under a lock
  through any call depth) that no single-file pass can see.

Each rule encodes an invariant this codebase has actually shipped a bug
against; see the rule catalogs and README "Static analysis" for the
rationale per rule.

Suppressions require a reason: ``# tpulint: disable=RULE -- why``.  A
bare ``# tpulint: disable`` (or one without the ``-- why`` tail) is
itself a finding (BARE-SUPPRESS) — a waiver nobody can audit is debt,
not a decision.
"""

import ast
import dataclasses
import io
import os
import re
import tokenize

# A suppression directive must BE the comment, not merely appear inside
# one (anchored match): prose quoting the syntax — like this very
# paragraph would if it spelled the directive unquoted at a comment
# start — is neither a waiver nor a STALE-SUPPRESS finding.  Forms:
# the directive with ``=RULE-A,RULE-B`` plus a ``-- reason`` tail, or
# reason + no rule list (all rules).  On a code line it suppresses that
# line; on a comment-only line it suppresses the line below (so a
# rationale can sit above the statement it excuses).  The ``-- reason``
# tail is mandatory: reason-less suppressions become BARE-SUPPRESS
# findings, and reasoned ones whose rule no longer fires on the line
# become STALE-SUPPRESS findings.
_SUPPRESS_RE = re.compile(r"^#+\s*tpulint:\s*disable(?P<tail>.*)")
_ALL = "*"


@dataclasses.dataclass(frozen=True)
class Finding:
    rule: str
    path: str
    line: int
    col: int
    message: str
    snippet: str  # stripped source line: the baseline's drift-stable key

    def key(self):
        """Baseline identity: stable across pure line-number drift."""
        return (self.path, self.rule, self.snippet)

    def to_dict(self):
        return dataclasses.asdict(self)

    def render(self):
        return (
            f"{self.path}:{self.line}:{self.col}: "
            f"{self.rule} {self.message}"
        )


class Rule:
    """Per-file rule base: subclasses set ``id``/``rationale`` and
    implement ``check(tree, lines, path) -> iterable[Finding]``."""

    id = ""
    rationale = ""

    def finding(self, path, lines, node, message):
        line = getattr(node, "lineno", 1)
        col = getattr(node, "col_offset", 0)
        snippet = ""
        if 1 <= line <= len(lines):
            snippet = lines[line - 1].strip()
        return Finding(self.id, path, line, col, message, snippet)

    def check(self, tree, lines, path):  # pragma: no cover - interface
        raise NotImplementedError


class ProgramRule:
    """Whole-program rule base: subclasses implement
    ``check_program(program) -> iterable[Finding]`` over a
    :class:`client_tpu_torch.analysis.callgraph.Program`.  Snippets are filled
    in and suppressions applied by the driver."""

    id = ""
    rationale = ""

    def check_program(self, program):  # pragma: no cover - interface
        raise NotImplementedError


REGISTRY = {}
PROGRAM_REGISTRY = {}


def register(cls):
    """Class decorator adding a per-file rule to the global registry."""
    REGISTRY[cls.id] = cls()
    return cls


def register_program(cls):
    """Class decorator adding a whole-program rule to the registry."""
    PROGRAM_REGISTRY[cls.id] = cls()
    return cls


def all_rules():
    """{id: rule} over both families (catalog/--explain/--rules)."""
    merged = dict(REGISTRY)
    merged.update(PROGRAM_REGISTRY)
    return merged


def _comment_tokens(lines):
    """(line, column, text) for every real COMMENT token — tokenizing
    (rather than regexing lines) keeps docstrings and string literals
    that merely *mention* the suppression syntax from acting as (or being
    flagged as) suppressions."""
    source = "\n".join(lines) + "\n"
    out = []
    try:
        for tok in tokenize.generate_tokens(io.StringIO(source).readline):
            if tok.type == tokenize.COMMENT:
                out.append((tok.start[0], tok.start[1], tok.string))
    except (tokenize.TokenError, IndentationError, SyntaxError):
        # unparsable tail: fall back to line-level matching so a file the
        # AST pass already rejects still reports its suppressions sanely
        for i, text in enumerate(lines, start=1):
            idx = text.find("#")
            if idx >= 0:
                out.append((i, idx, text[idx:]))
    return out


def parse_suppressions(lines):
    """Parse suppression comments.

    Returns ``(by_line, bare, comments)``: *by_line* maps line number ->
    set of suppressed rule ids ('*' = all), *bare* lists ``(line, ids)``
    for suppressions missing the mandatory ``-- reason`` tail, and
    *comments* records every suppression comment individually
    (``{"line", "covers", "ids", "bare"}``) so the STALE-SUPPRESS pass
    can audit each waiver against what actually fired on its lines.
    """
    out = {}
    bare = []
    comments = []
    for i, col, comment in _comment_tokens(lines):
        m = _SUPPRESS_RE.search(comment)
        if not m:
            continue
        tail = m.group("tail") or ""
        spec, sep, reason = tail.partition("--")
        spec = spec.strip()
        if spec.startswith("="):
            ids = {
                r.strip().upper()
                for r in spec[1:].split(",")
                if r.strip()
            }
        else:
            ids = {_ALL}
        is_bare = not sep or not reason.strip()
        if is_bare:
            bare.append((i, ids))
        target = i
        if not lines[i - 1][:col].strip():
            target = i + 1  # comment-only line covers the next line
        out.setdefault(target, set()).update(ids)
        out.setdefault(i, set()).update(ids)
        comments.append({
            "line": i, "covers": sorted({i, target}),
            "ids": sorted(ids), "bare": is_bare,
        })
    return out, bare, comments


def _suppressed(finding, by_line):
    if finding.rule in ("BARE-SUPPRESS", "STALE-SUPPRESS"):
        # a waiver cannot waive the rules about waivers
        return False
    ids = by_line.get(finding.line, ())
    return _ALL in ids or finding.rule.upper() in ids


def scan_source(source, path, rules=None, tree=None, parsed_suppressions=None,
                suppressed_out=None):
    """Run every (or the given) per-file rule over one file's source.

    *tree* / *parsed_suppressions* accept precomputed results so a driver
    that also needs them (``_analyze_file`` builds the callgraph summary
    from the same tree) parses and tokenizes each file exactly once.
    *suppressed_out*, when given a list, receives the findings a
    suppression comment filtered — the STALE-SUPPRESS pass audits
    waivers against them.
    """
    active = list((rules if rules is not None else REGISTRY).values())
    lines = source.splitlines()
    if tree is None:
        try:
            tree = ast.parse(source, filename=path)
        except SyntaxError as e:
            return [
                Finding(
                    "PARSE-ERROR", path, e.lineno or 1, e.offset or 0,
                    f"could not parse: {e.msg}", "",
                )
            ]
    if parsed_suppressions is None:
        parsed_suppressions = parse_suppressions(lines)
    suppressed, bare, _comments = parsed_suppressions
    findings = []
    reported = set()  # one finding per (rule, line): passes can overlap
    for rule in active:
        if hasattr(rule, "check_parsed"):
            found = rule.check_parsed(bare, lines, path)
        else:
            found = rule.check(tree, lines, path)
        for f in found:
            if _suppressed(f, suppressed):
                if suppressed_out is not None:
                    suppressed_out.append(f)
                continue
            if (f.rule, f.line) in reported:
                continue
            reported.add((f.rule, f.line))
            findings.append(f)
    findings.sort(key=lambda f: (f.path, f.line, f.col, f.rule))
    return findings


def iter_python_files(paths, exclude_parts=("analysis_fixtures",)):
    """Yield .py files under the given files/directories, skipping any
    whose path contains an excluded component (lint fixtures hold
    intentional violations)."""
    seen = set()
    for root in paths:
        if os.path.isfile(root):
            # an explicitly named file is always scanned — the exclusion
            # only guards directory walks (fixtures hold intentional
            # violations but must be scannable on demand)
            norm = os.path.normpath(root)
            if norm not in seen:
                seen.add(norm)
                yield norm
            continue
        # exclusion applies BELOW the named root only (the dirnames
        # pruning): explicitly passing an excluded directory (e.g. the
        # fixtures) scans it — same no-silent-green principle as the
        # missing-path CLI error
        for dirpath, dirnames, filenames in os.walk(root):
            dirnames[:] = sorted(
                d for d in dirnames
                if d not in exclude_parts and d != "__pycache__"
            )
            for f in sorted(filenames):
                if not f.endswith(".py"):
                    continue
                norm = os.path.normpath(os.path.join(dirpath, f))
                if norm in seen:
                    continue
                seen.add(norm)
                yield norm


def _analyze_file(source, path, rules):
    """(findings, summary, suppression-map, comments, suppressed-hits)
    for one file.

    *summary* is None on parse errors (the PARSE-ERROR finding carries
    the news; program rules skip the file).  The file is parsed and
    tokenized exactly once, shared between the per-file rules and the
    callgraph summary.  *comments* are the parsed suppression comments;
    *suppressed-hits* lists ``(rule, line)`` for every per-file finding
    a suppression filtered (STALE-SUPPRESS input).
    """
    from client_tpu_torch.analysis import callgraph

    lines = source.splitlines()
    by_line, bare, comments = parse_suppressions(lines)
    try:
        tree = ast.parse(source, filename=path)
    except SyntaxError:
        return scan_source(source, path, rules), None, by_line, [], []
    suppressed_hits = []
    findings = scan_source(
        source, path, rules, tree=tree,
        parsed_suppressions=(by_line, bare, comments),
        suppressed_out=suppressed_hits,
    )
    summary = callgraph.summarize_module(tree, path)
    return (
        findings, summary, by_line, comments,
        [(f.rule, f.line) for f in suppressed_hits],
    )


def scan_paths(paths, rules=None, exclude_parts=("analysis_fixtures",),
               cache=None, program_rules=None):
    """Scan files and the program they form.

    ``rules``/``program_rules``: None = all registered; pass a dict to
    filter (an empty dict disables that family).  ``cache`` is an
    optional :class:`client_tpu_torch.analysis.cache.AnalysisCache` reused
    across runs — only consulted for full-default-rule scans (a filtered
    scan must not poison or be poisoned by cached full results).  On a
    full scan the whole-program pass (program rules + the
    STALE-SUPPRESS audit) is additionally cached under a *fileset
    digest* over every scanned file's stat key: when nothing changed,
    the graph walks are skipped entirely and a warm ``make lint`` stays
    ~a second.
    """
    from client_tpu_torch.analysis import callgraph

    use_cache = cache is not None and rules is None
    findings = []
    summaries = []
    suppress_by_path = {}
    comments_by_path = {}    # path -> (comments, per-file suppressed hits)
    fileset = []             # (path, stat-key) pairs -> program digest
    digest_ok = use_cache
    snippet_lines = {}  # program-finding snippets come from the source
    for path in iter_python_files(paths, exclude_parts):
        entry = cache.get(path) if use_cache else None
        if entry is not None:
            file_findings = [Finding(**f) for f in entry["findings"]]
            summary = (
                callgraph.ModuleSummary.from_dict(entry["summary"])
                if entry["summary"] is not None
                else None
            )
            by_line = {
                int(k): set(v) for k, v in entry["suppress"].items()
            }
            comments = entry.get("comments", [])
            hits = [tuple(h) for h in entry.get("suppressed", [])]
            stat_key = cache.stat_for(path)
        else:
            # stat BEFORE reading: a save landing mid-analysis must leave
            # the entry stale (re-scan next run), never fresh-looking
            stat_key = cache.stat_key(path) if use_cache else None
            try:
                with open(path, "r", encoding="utf-8") as fh:
                    source = fh.read()
            except OSError as e:
                findings.append(
                    Finding("READ-ERROR", path, 1, 0, f"unreadable: {e}", "")
                )
                digest_ok = False
                continue
            file_findings, summary, by_line, comments, hits = (
                _analyze_file(source, path, rules)
            )
            # keep THIS run's lines for program-finding snippets: a save
            # landing mid-run must not produce a snippet (the baseline's
            # drift-stable key) from content nobody analyzed
            snippet_lines[path] = source.splitlines()
            if use_cache:
                cache.put(path, {
                    "findings": [f.to_dict() for f in file_findings],
                    "summary": (
                        summary.to_dict() if summary is not None else None
                    ),
                    "suppress": {
                        str(k): sorted(v) for k, v in by_line.items()
                    },
                    "comments": comments,
                    "suppressed": [list(h) for h in hits],
                }, stat_key)
        if stat_key is None:
            digest_ok = False
        else:
            fileset.append((path, stat_key))
        findings.extend(file_findings)
        if summary is not None:
            summaries.append(summary)
            suppress_by_path[path] = by_line
            comments_by_path[path] = (comments, hits)

    active_program = (
        PROGRAM_REGISTRY if program_rules is None else program_rules
    )
    full_scan = rules is None and program_rules is None
    digest = (
        cache.fileset_digest(fileset)
        if digest_ok and full_scan else None
    )
    cached_program = (
        cache.get_program(digest) if digest is not None else None
    )
    def snippet_at(path, line):
        """Drift-stable baseline snippet for a program/stale finding —
        lazily reading cache-hit files whose source this run never saw."""
        if path not in snippet_lines:
            try:
                with open(path, "r", encoding="utf-8") as fh:
                    snippet_lines[path] = fh.read().splitlines()
            except OSError:
                snippet_lines[path] = []
        lines = snippet_lines[path]
        return lines[line - 1].strip() if 1 <= line <= len(lines) else ""

    if cached_program is not None:
        findings.extend(Finding(**f) for f in cached_program)
    elif (active_program or full_scan) and summaries:
        program_findings = []
        if active_program:
            program = callgraph.build_program(summaries)
            reported = set()
            for rule in active_program.values():
                for f in rule.check_program(program):
                    by_line = suppress_by_path.get(f.path, {})
                    if _suppressed(f, by_line):
                        comments_by_path.get(f.path, ([], []))[1].append(
                            (f.rule, f.line)
                        )
                        continue
                    # message is part of the key: two DISTINCT cycles can
                    # anchor on the same witness line (a call made under
                    # two held locks); only true duplicates may collapse
                    key = (f.rule, f.path, f.line, f.message)
                    if key in reported:
                        continue
                    reported.add(key)
                    program_findings.append(dataclasses.replace(
                        f, snippet=snippet_at(f.path, f.line),
                    ))
        if full_scan:
            # the STALE-SUPPRESS audit needs BOTH rule families' verdicts
            # (a waiver may exist for a program finding), so it runs — and
            # is cached — with the program pass
            stale_rule = REGISTRY.get("STALE-SUPPRESS")
            if stale_rule is not None:
                for path, (comments, hits) in sorted(
                    comments_by_path.items()
                ):
                    for f in stale_rule.check_comments(
                        path, comments, hits
                    ):
                        # the comment line IS the snippet: the baseline
                        # key must tell two stale waivers in one file
                        # apart
                        program_findings.append(dataclasses.replace(
                            f, snippet=snippet_at(f.path, f.line),
                        ))
        if digest is not None:
            cache.put_program(
                digest, [f.to_dict() for f in program_findings]
            )
        findings.extend(program_findings)

    if use_cache:
        cache.save()
    findings.sort(key=lambda f: (f.path, f.line, f.col, f.rule))
    return findings


@register
class BareSuppressRule(Rule):
    """BARE-SUPPRESS — suppression comments without a ``-- reason``.

    Every waiver is a decision someone later has to re-audit; a bare
    ``# tpulint: disable=RULE`` records the decision without the
    reasoning, so the next reader cannot tell a load-bearing exemption
    from a drive-by silence.  The reason rides in the comment itself:
    ``# tpulint: disable=RULE -- why this is safe``.  BARE-SUPPRESS
    findings cannot themselves be suppressed.
    """

    id = "BARE-SUPPRESS"
    rationale = (
        "a suppression without a reason cannot be audited — write "
        "`# tpulint: disable=RULE -- why`"
    )

    def check(self, tree, lines, path):
        _by_line, bare, _comments = parse_suppressions(lines)
        return self.check_parsed(bare, lines, path)

    def check_parsed(self, bare, lines, path):
        """The driver hands over its already-parsed suppressions so the
        file is tokenized once, not once per consumer."""
        findings = []
        for line, ids in bare:
            what = (
                "all rules" if _ALL in ids else ", ".join(sorted(ids))
            )
            snippet = lines[line - 1].strip() if line <= len(lines) else ""
            findings.append(Finding(
                self.id, path, line, 0,
                f"suppression of {what} carries no reason — append "
                "`-- <why this is safe>`", snippet,
            ))
        return findings


@register
class StaleSuppressRule(Rule):
    """STALE-SUPPRESS — a reasoned waiver whose rule no longer fires.

    A ``# tpulint: disable=RULE -- why`` comment on a line where RULE no
    longer produces a finding is debt pointing at code that moved on:
    either the hazard was fixed (delete the waiver) or the code drifted
    out from under it (the waiver now silences NOTHING today and the
    wrong thing tomorrow).  Auditing it automatically keeps the waiver
    set honest as rules and code evolve.

    The audit needs every rule family's verdicts for the file — a waiver
    may exist for a whole-program finding — so the driver computes it
    alongside the program pass on full scans (``scan_paths`` with the
    default rule sets); per-file ``scan_source`` calls and ``--rules``-
    filtered runs never report it (a filtered scan cannot tell unused
    from unchecked).  Blanket waivers (``disable`` with no rule list)
    are stale when NO finding at all was suppressed on their lines.
    Reason-less waivers are BARE-SUPPRESS findings already and are not
    double-reported here.  Like BARE-SUPPRESS, a STALE-SUPPRESS finding
    cannot itself be waived — the fix is deleting the dead comment.
    """

    id = "STALE-SUPPRESS"
    rationale = (
        "a suppression whose rule no longer fires on its line silences "
        "nothing today and the wrong thing tomorrow — delete it"
    )

    def check(self, tree, lines, path):
        return []  # driver-computed on full scans (needs program verdicts)

    def check_comments(self, path, comments, suppressed_hits):
        """*suppressed_hits*: (rule, line) for every finding — per-file
        AND program — that a suppression in this file filtered."""
        hits_by_line = {}
        for rule, line in suppressed_hits:
            hits_by_line.setdefault(line, set()).add(rule.upper())
        findings = []
        for comment in comments:
            if comment["bare"]:
                continue  # already a BARE-SUPPRESS finding
            covered = set()
            for line in comment["covers"]:
                covered |= hits_by_line.get(line, set())
            ids = set(comment["ids"])
            if _ALL in ids:
                stale = sorted(ids) if not covered else []
            else:
                stale = sorted(ids - covered)
            for rule_id in stale:
                what = (
                    "any rule" if rule_id == _ALL else rule_id
                )
                findings.append(Finding(
                    self.id, path, comment["line"], 0,
                    f"suppression of {what} no longer matches a "
                    "finding on its line — the waived hazard is gone "
                    "(or moved); delete the stale comment", "",
                ))
        return findings
