"""The port's static analyser (client_tpu_torch.analysis) against the
reference's (client_tpu.analysis): the same findings, rule, line and
column, on every fixture of tests/analysis_fixtures and on client_tpu/;
the torch keys fire on their own fixtures (tests/analysis_fixtures/
torch/) where the reference is silent; the CLI's exit codes and its
JSON and SARIF reports; the cache kept out of the package; the package
import that loads no rule module; the port's own tree clean."""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

import client_tpu.analysis as ref
from client_tpu.analysis import report as ref_report
import client_tpu_torch.analysis as port
from client_tpu_torch.analysis import baseline as port_baseline
from client_tpu_torch.analysis import cache as port_cache
from client_tpu_torch.analysis import report as port_report

ROOT = Path(__file__).parent.parent
FIXTURES = Path(__file__).parent / "analysis_fixtures"
TORCH_FIXTURES = FIXTURES / "torch"
PACKAGE = ROOT / "client_tpu_torch"

REFERENCE_CASES = sorted(p.name for p in FIXTURES.glob("*.py")) + [
    "client_tpu"]
TORCH_CASES = sorted(p.name for p in TORCH_FIXTURES.glob("*.py"))
# the rule each torch fixture is about, by its name's prefix
TORCH_RULES = {
    "lock_dispatch_": "LOCK-DISPATCH",
    "jit_unbounded_shape_": "JIT-UNBOUNDED-SHAPE",
    "npy_truth_": "NPY-TRUTH",
    "async_block_": "ASYNC-BLOCK",
    "block_under_lock_": "BLOCK-UNDER-LOCK",
}


def _keys(findings):
    return sorted((f.path, f.rule, f.line, f.col) for f in findings)


def _cli(module, *args):
    return subprocess.run(
        [sys.executable, "-m", module, *args],
        cwd=str(ROOT), capture_output=True, text=True, timeout=300,
    )


def test_the_fixture_sets_are_whole():
    """52 reference fixtures, and a _bad and an _ok fixture for each
    torch key."""
    assert len(REFERENCE_CASES) == 52 + 1
    stems = {name[:-len("_bad.py")] for name in TORCH_CASES
             if name.endswith("_bad.py")}
    assert stems == {name[:-len("_ok.py")] for name in TORCH_CASES
                     if name.endswith("_ok.py")}
    assert len(stems) == 7
    assert all(any(stem.startswith(p) for p in TORCH_RULES)
               for stem in stems)


def test_rule_catalogue_equals_the_reference():
    """The same rule ids and one-line rationales; the torch keys live in
    the reference's rules."""
    assert set(port.REGISTRY) == set(ref.REGISTRY)
    assert set(port.PROGRAM_REGISTRY) == set(ref.PROGRAM_REGISTRY)
    assert {k: r.rationale for k, r in port.all_rules().items()} == {
        k: r.rationale for k, r in ref.all_rules().items()}


@pytest.mark.parametrize("case", REFERENCE_CASES)
def test_port_reports_what_the_reference_reports(case):
    """Reference: client_tpu.analysis.scan_paths.  On each reference
    fixture (scanned alone) and on client_tpu/, the port's findings are
    the reference's, rule, path, line and column (exact)."""
    path = "client_tpu" if case == "client_tpu" else str(FIXTURES / case)
    got = _keys(port.scan_paths([path]))
    want = _keys(ref.scan_paths([path]))
    assert got == want


@pytest.mark.parametrize("case", TORCH_CASES)
def test_torch_key_fixture(case):
    """A _bad fixture fires its rule in the port and nothing in the
    reference; an _ok fixture fires nothing in either."""
    path = str(TORCH_FIXTURES / case)
    rule = next(r for p, r in TORCH_RULES.items() if case.startswith(p))
    got = port.scan_paths([path])
    assert ref.scan_paths([path]) == []
    if case.endswith("_bad.py"):
        assert got, f"{case}: the port's {rule} did not fire"
        assert {f.rule for f in got} == {rule}, [f.render() for f in got]
        marked = [i + 1 for i, line in enumerate(
            Path(path).read_text().splitlines()) if "# BAD" in line]
        # each BAD comment sits on the line above its finding
        assert sorted({f.line - 1 for f in got}) == marked
    else:
        assert got == [], [f.render() for f in got]


def test_cli_exit_codes():
    """0 clean, 1 findings, 2 an analyser error: as the reference."""
    ok = "tests/analysis_fixtures/torch/lock_dispatch_sync_ok.py"
    bad = "tests/analysis_fixtures/torch/lock_dispatch_sync_bad.py"
    mod = "client_tpu_torch.analysis"
    proc = _cli(mod, ok, "--no-cache", "--no-baseline")
    assert proc.returncode == 0, proc.stdout + proc.stderr
    proc = _cli(mod, bad, "--no-cache", "--no-baseline")
    assert proc.returncode == 1, proc.stdout + proc.stderr
    assert "LOCK-DISPATCH" in proc.stdout and "host sync" in proc.stdout
    proc = _cli(mod, "no_such_dir_anywhere", "--no-cache")
    assert proc.returncode == 2 and "no such path" in proc.stderr
    proc = _cli(mod, "--rules", "NOT-A-RULE", "--no-cache")
    assert proc.returncode == 2
    # the reference reads the same bad fixture clean
    proc = _cli("client_tpu.analysis", bad, "--no-cache", "--no-baseline")
    assert proc.returncode == 0, proc.stdout + proc.stderr


@pytest.mark.parametrize("fmt", ["json", "sarif"])
def test_reports_equal_the_reference(fmt):
    """On tests/analysis_fixtures/cv_wait_bad.py the JSON report is the
    reference's byte for byte; the SARIF report too, once the port's
    module names read as the reference's, but the full descriptions of
    the rules that carry torch keys (their docstrings say so)."""
    path = str(FIXTURES / "cv_wait_bad.py")
    got_f, want_f = port.scan_paths([path]), ref.scan_paths([path])
    if fmt == "json":
        got = port_report.render_json(got_f, [], port.all_rules())
        want = ref_report.render_json(want_f, [], ref.all_rules())
        assert got == want
        assert json.loads(got)["count"] == 1
        return
    got = json.loads(port_report.render_sarif(
        got_f, [], port.all_rules()).replace("client_tpu_torch.",
                                              "client_tpu."))
    want = json.loads(ref_report.render_sarif(want_f, [], ref.all_rules()))
    keyed = {"LOCK-DISPATCH", "NPY-TRUTH", "ASYNC-BLOCK",
             "JIT-UNBOUNDED-SHAPE"}
    for doc in (got, want):
        for rule in doc["runs"][0]["tool"]["driver"]["rules"]:
            if rule["id"] in keyed:
                text = rule["fullDescription"]["text"]
                assert ("torch" in text) == (doc is got), rule["id"]
                rule["fullDescription"]["text"] = ""
    assert got == want
    assert got["version"] == "2.1.0"
    assert got["runs"][0]["results"][0]["ruleId"] == "CV-WAIT-LOOP"


def test_cache_writes_nowhere_in_the_package_tree(tmp_path):
    """The default cache file is under the checkout's build/, and a
    cached scan writes only its cache file."""
    default = Path(port_cache.DEFAULT_CACHE).resolve()
    assert PACKAGE.resolve() not in default.parents
    assert default.parent == (ROOT / "build").resolve()
    analysis = PACKAGE / "analysis"
    before = sorted(str(p) for p in analysis.rglob("*")
                    if "__pycache__" not in p.parts)
    cache = port_cache.AnalysisCache(str(tmp_path / "c.json"))
    path = str(TORCH_FIXTURES / "npy_truth_torch_bad.py")
    first = port.scan_paths([path], cache=cache)
    cache.save()
    again = port_cache.AnalysisCache(str(tmp_path / "c.json"))
    assert _keys(port.scan_paths([path], cache=again)) == _keys(first)
    assert again.hits == 1
    assert sorted(os.listdir(tmp_path)) == ["c.json"]
    after = sorted(str(p) for p in analysis.rglob("*")
                   if "__pycache__" not in p.parts)
    assert after == before


def test_cache_save_makes_its_directory(tmp_path):
    """A fresh checkout has no build/: the first save makes it."""
    target = tmp_path / "build" / "analysis_cache.json"
    cache = port_cache.AnalysisCache(str(target))
    port.scan_paths([str(TORCH_FIXTURES / "npy_truth_torch_ok.py")],
                    cache=cache)
    cache.save()
    assert target.is_file()


def test_import_loads_no_rule_module():
    """Importing the package (or a witness) loads the witnesses only; a
    core name loads the catalogue on first use."""
    code = (
        "import sys\n"
        "import client_tpu_torch.analysis as a\n"
        "from client_tpu_torch.analysis import witness_shared\n"
        "loaded = sorted(m for m in sys.modules\n"
        "                if m.startswith('client_tpu_torch.analysis.'))\n"
        "print(loaded)\n"
        "a.scan_paths\n"
        "print('client_tpu_torch.analysis.rules' in sys.modules)\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=str(ROOT),
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    first, second = proc.stdout.splitlines()
    assert first == "['client_tpu_torch.analysis.witness']"
    assert second == "True"


def test_baseline_entries_each_carry_a_reason():
    """The port's baseline.json: every grandfathered finding says why
    holding the lock is its purpose, and none is a waiver comment."""
    path = port_baseline.DEFAULT_BASELINE
    with open(path, encoding="utf-8") as fh:
        entries = json.load(fh)["findings"]
    assert entries
    for entry in entries:
        assert len(entry["reason"]) > 40, entry
        assert entry["rule"] in port.REGISTRY
    assert sum(port_baseline.load(path).values()) == sum(
        e["count"] for e in entries)


def test_write_baseline_keeps_the_reasons(tmp_path):
    path = str(TORCH_FIXTURES / "lock_dispatch_sync_bad.py")
    found = port.scan_paths([path])
    target = tmp_path / "baseline.json"
    port_baseline.save(str(target), found)
    data = json.loads(target.read_text())
    for entry in data["findings"]:
        entry["reason"] = "a reason " + entry["snippet"]
    target.write_text(json.dumps(data))
    port_baseline.save(str(target), found)
    again = json.loads(target.read_text())["findings"]
    assert [e["reason"] for e in again] == [
        "a reason " + e["snippet"] for e in again]


def test_the_port_lints_its_own_tree_clean():
    """`python -m client_tpu_torch.analysis client_tpu_torch`: 0
    findings (the default path), with the port's baseline."""
    proc = _cli("client_tpu_torch.analysis", "--no-cache", "--json")
    assert proc.returncode == 0, proc.stdout + proc.stderr
    payload = json.loads(proc.stdout)
    assert payload["count"] == 0
    assert {g["rule"] for g in payload["grandfathered"]} <= {
        "LOCK-DISPATCH"}


def test_the_reference_lints_the_port_tree_clean():
    """`python -m client_tpu.analysis client_tpu_torch`: 0 findings, so
    no waiver in the port is stale to either analyser."""
    proc = _cli("client_tpu.analysis", "client_tpu_torch", "--no-cache")
    assert proc.returncode == 0, proc.stdout + proc.stderr
