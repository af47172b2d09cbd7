"""Incremental-analysis cache for tpu-lint.

Parsing + summarizing every file dominates a `make lint` run; almost no
file changes between runs.  The cache persists, per file, the post-
suppression per-file findings, the serialized
:class:`~client_tpu_torch.analysis.callgraph.ModuleSummary` (program rules
re-run every time — they are cheap graph walks over the summaries), and
the suppression map, keyed on ``(path, mtime, size)`` and guarded by a
**rules hash** over the analyzer's own sources: editing any rule
invalidates everything (a stale cache must never green-light a finding a
new rule would catch).

The cache file lives under the checkout's ``build/`` (gitignored),
never in the package tree.  Corruption,
version skew, or a rules-hash mismatch silently degrade to a full scan —
the cache is an accelerator, never a correctness dependency.
``--no-cache`` on the CLI is the escape hatch.
"""

import hashlib
import json
import os

_VERSION = 3  # v3: summaries carry resource events (resources/res_facts)
DEFAULT_CACHE = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))),
    "build", "analysis_cache.json",
)


def rules_hash():
    """Content hash over every analyzer source file (rule edits, driver
    edits, and callgraph changes all invalidate the cache)."""
    here = os.path.dirname(__file__)
    h = hashlib.sha256()
    for name in sorted(os.listdir(here)):
        if not name.endswith(".py"):
            continue
        h.update(name.encode("utf-8"))
        with open(os.path.join(here, name), "rb") as fh:
            h.update(fh.read())
        h.update(b"\x00")
    return h.hexdigest()


class AnalysisCache:
    """mtime-keyed per-file result cache (see module docstring).

    Beyond per-file entries, one **program entry** caches the whole-
    program pass (program rules + the STALE-SUPPRESS audit) keyed on a
    digest over every scanned file's ``(path, stat-key)``: edit one file
    and only that file re-analyzes but the program pass reruns; touch
    nothing and both come straight from cache.
    """

    def __init__(self, path=DEFAULT_CACHE):
        self.path = path
        self._rules_hash = rules_hash()
        self._entries = {}
        self._program = None  # {"digest": ..., "findings": [...]}
        self._dirty = False
        self.hits = 0
        self.misses = 0
        self.program_hits = 0
        self.program_misses = 0
        self._load()

    def _load(self):
        try:
            with open(self.path, "r", encoding="utf-8") as fh:
                data = json.load(fh)
        except (OSError, ValueError):
            return
        if (
            data.get("version") != _VERSION
            or data.get("rules_hash") != self._rules_hash
        ):
            return  # analyzer changed: every cached result is suspect
        entries = data.get("files")
        if isinstance(entries, dict):
            self._entries = entries
        program = data.get("program")
        if isinstance(program, dict) and "digest" in program:
            self._program = program

    def stat_key(self, path):
        """Freshness key for *path* (None when unstattable).  Callers
        storing results MUST capture this BEFORE reading the file: a save
        landing between the read and the store must make the entry look
        stale (re-scan), never fresh (silently serving findings for
        content nobody analyzed)."""
        try:
            st = os.stat(path)
        except OSError:
            return None
        return [int(st.st_mtime_ns), int(st.st_size)]

    def get(self, path):
        """Cached analysis for *path* if its stat key still matches."""
        entry = self._entries.get(path)
        key = self.stat_key(path)
        if entry is None or key is None or entry.get("stat") != key:
            self.misses += 1
            return None
        self.hits += 1
        return entry["data"]

    def stat_for(self, path):
        """The stat key stored with *path*'s entry (None when absent) —
        the fileset digest reuses it so a cache hit never re-stats."""
        entry = self._entries.get(path)
        return entry.get("stat") if entry else None

    def put(self, path, data, key):
        """Store *data* under the stat *key* captured before the read."""
        if key is None:
            return
        self._entries[path] = {"stat": key, "data": data}
        self._dirty = True

    def fileset_digest(self, fileset):
        """Digest over the full scanned fileset's (path, stat-key)
        pairs — the whole-program pass's freshness key.  Order-free:
        the same files in any scan order digest identically."""
        h = hashlib.sha256()
        for path, key in sorted(fileset):
            h.update(path.encode("utf-8"))
            h.update(repr(key).encode("utf-8"))
            h.update(b"\x00")
        return h.hexdigest()

    def get_program(self, digest):
        """Cached whole-program findings (as dicts) when the fileset
        digest still matches, else None."""
        entry = self._program
        if entry is None or entry.get("digest") != digest:
            self.program_misses += 1
            return None
        self.program_hits += 1
        return entry["findings"]

    def put_program(self, digest, findings):
        self._program = {"digest": digest, "findings": findings}
        self._dirty = True

    def save(self):
        if not self._dirty:
            return
        payload = {
            "version": _VERSION,
            "rules_hash": self._rules_hash,
            "files": self._entries,
            "program": self._program,
        }
        tmp = self.path + ".tmp"
        try:
            os.makedirs(os.path.dirname(os.path.abspath(self.path)),
                        exist_ok=True)
            with open(tmp, "w", encoding="utf-8") as fh:
                json.dump(payload, fh)
            os.replace(tmp, self.path)
        except OSError:
            # a read-only checkout still lints; it just lints cold
            try:
                os.unlink(tmp)
            except OSError:
                pass
        self._dirty = False
