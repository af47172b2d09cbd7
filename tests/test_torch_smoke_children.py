"""chip_smoke.py's process hygiene, on the CPU: every process the script
starts goes through ``popen`` (a session of its own, registered), and
``stop_children`` -- which the script runs however it ends, a failed
check included -- leaves no process of theirs running, grandchildren
included.  No reference counterpart (the JAX package's smoke run starts
no process of its own)."""

import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402

# a child that starts a grandchild, prints its pid, and sleeps
_PARENT = (
    "import subprocess, sys, time\n"
    "g = subprocess.Popen([sys.executable, '-c', "
    "'import time; time.sleep(120)'])\n"
    "print(g.pid, flush=True)\n"
    "time.sleep(120)\n"
)


def _running(pid):
    """True while *pid* exists and is not a zombie."""
    try:
        with open(f"/proc/{pid}/stat") as f:
            state = f.read().rsplit(")", 1)[1].split()[0]
    except FileNotFoundError:
        return False
    return state != "Z"


def test_stop_children_ends_children_and_grandchildren():
    procs = [chip_smoke.popen([sys.executable, "-c", _PARENT],
                              stdout=subprocess.PIPE, text=True)
             for _ in range(2)]
    grandchildren = [int(p.stdout.readline()) for p in procs]
    for p in procs:
        p.stdout.close()
    assert all(_running(pid) for pid in grandchildren)
    assert len(chip_smoke.CHILDREN) >= 2
    chip_smoke.stop_children()
    assert chip_smoke.CHILDREN == []
    assert all(p.returncode is not None for p in procs)
    deadline = time.monotonic() + 30
    while (any(_running(pid) for pid in grandchildren)
           and time.monotonic() < deadline):
        time.sleep(0.05)
    assert not any(_running(pid) for pid in grandchildren)


def test_failed_check_leaves_no_child(tmp_path):
    """A run that fails a check after it started a child: the script's
    own exit path (``fail`` -> SystemExit -> ``stop_children``) ends the
    child and its grandchild before the process exits non-zero."""
    script = tmp_path / "run.py"
    script.write_text(
        "import subprocess, sys\n"
        f"sys.path.insert(0, {ROOT!r})\n"
        "import chip_smoke\n"
        "def main():\n"
        f"    p = chip_smoke.popen([sys.executable, '-c', {_PARENT!r}],\n"
        "                         stdout=subprocess.PIPE, text=True)\n"
        "    print(p.pid, p.stdout.readline().strip(), flush=True)\n"
        "    chip_smoke.check(False, 'a check failed')\n"
        "try:\n"
        "    main()\n"
        "finally:\n"
        "    chip_smoke.stop_children()\n")
    out = subprocess.run([sys.executable, str(script)], capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 1
    assert "chip_smoke: FAILED: a check failed" in out.stderr
    pids = [int(x) for x in out.stdout.split()]
    assert len(pids) == 2
    deadline = time.monotonic() + 30
    while any(_running(pid) for pid in pids) and time.monotonic() < deadline:
        time.sleep(0.05)
    assert not any(_running(pid) for pid in pids)
