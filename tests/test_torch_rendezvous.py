"""The port's rendezvous (client_tpu_torch.perf.rendezvous.Rendezvous) and
its multi-rank perf CLI held against the JAX package's
(client_tpu.perf.rendezvous), on the CPU.

- tests/test_metrics_rendezvous.py::TestRendezvous's cases with the
  port's class in place of the JAX one (the module's name is swapped for
  the test): barrier, all-gather and consensus over three ranks, one
  rank, a bad rank, and duplicate, out-of-range and garbage hellos.
- A mixed world: a port rank 0 with a JAX rank 1, and a JAX rank 0 with
  a port rank 1, give every rank the same ``all_gather`` and
  ``all_ranks_stable`` as a world of one package; the frames are the same
  bytes.
- tests/test_metrics_rendezvous.py::TestMultiRankCli with the port's CLI
  (``-m simple --hermetic --device cpu``): both ranks exit 0 and rank 0
  alone prints the aggregate.

Every comparison is exact.
"""

import io
import pathlib
import subprocess
import sys
import threading

import pytest

import test_metrics_rendezvous as jmr
from client_tpu.perf import rendezvous as jrendezvous
from client_tpu.utils import InferenceServerException as JaxError
from client_tpu_torch.perf import rendezvous
from client_tpu_torch.perf.rendezvous import Rendezvous
from client_tpu_torch.utils import InferenceServerException as PortError

ROOT = pathlib.Path(__file__).resolve().parent.parent


class TestRendezvousPort(jmr.TestRendezvous):
    """tests/test_metrics_rendezvous.py::TestRendezvous."""

    @pytest.fixture(autouse=True)
    def _port_rendezvous(self, monkeypatch):
        monkeypatch.setattr(jmr, "Rendezvous", Rendezvous)
        monkeypatch.setattr(jmr, "InferenceServerException",
                            (JaxError, PortError))


def _world(classes):
    """Run one rank of each class in *classes* (rank order) on one
    address: barrier, all_gather of a rank's payload, all_ranks_stable
    with rank 1 unstable.  Returns each rank's (gathered, stable)."""
    addr = f"127.0.0.1:{jmr._free_port()}"
    results = [None] * len(classes)

    def run(rank, cls):
        rv = cls(rank, len(classes), addr, connect_timeout_s=30.0)
        try:
            rv.barrier()
            gathered = rv.all_gather({"rank": rank, "level": [1, 8],
                                      "throughput": 10.5 * (rank + 1)})
            results[rank] = (gathered, rv.all_ranks_stable(rank != 1))
        finally:
            rv.close()

    threads = [threading.Thread(target=run, args=(r, cls))
               for r, cls in enumerate(classes)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    return results


@pytest.mark.parametrize("ranks", [
    ("torch", "jax"), ("jax", "torch"), ("torch", "jax", "torch")])
def test_mixed_world_equals_one_package(ranks):
    """Port and JAX ranks in one world read each other's hellos, payloads
    and answers: every rank gets what a world of JAX ranks alone gets."""
    cls = {"torch": Rendezvous, "jax": jrendezvous.Rendezvous}
    mixed = _world([cls[r] for r in ranks])
    alone = _world([jrendezvous.Rendezvous] * len(ranks))
    assert mixed == alone
    assert all(stable is False for _, stable in mixed)
    assert mixed[0][0] == [{"rank": r, "level": [1, 8],
                            "throughput": 10.5 * (r + 1)}
                           for r in range(len(ranks))]


def test_frames_are_the_same_bytes():
    """send_frame writes what the JAX package's writes, and each package's
    recv_frame reads the other's frame."""
    class Sock(io.BytesIO):
        def sendall(self, data):
            self.write(data)

        def recv(self, n):
            return self.read(n)

    obj = {"payload": [None, True, 1.5, "réang", {"k": [1, 2]}]}
    ours, theirs = Sock(), Sock()
    rendezvous.send_frame(ours, obj)
    jrendezvous.send_frame(theirs, obj)
    assert ours.getvalue() == theirs.getvalue()
    ours.seek(0)
    theirs.seek(0)
    assert jrendezvous.recv_frame(ours) == rendezvous.recv_frame(theirs) == obj


def test_two_rank_hermetic_cli_run():
    """tests/test_metrics_rendezvous.py::TestMultiRankCli::
    test_two_rank_hermetic_run with ``python -m client_tpu_torch.perf
    ... --device cpu``."""
    port = jmr._free_port()
    args = [
        sys.executable, "-m", "client_tpu_torch.perf",
        "-m", "simple", "--hermetic", "--device", "cpu",
        "--concurrency-range", "1",
        "--measurement-interval", "100",
        "--max-trials", "3", "-s", "90",
        "--world-size", "2",
        "--rendezvous-addr", f"127.0.0.1:{port}",
    ]
    procs = [
        subprocess.Popen(
            args + ["--rank", str(rank)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            cwd=str(ROOT),
        )
        for rank in range(2)
    ]
    outs = [p.communicate(timeout=180)[0] for p in procs]
    for rank, (proc, out) in enumerate(zip(procs, outs)):
        assert proc.returncode == 0, f"rank {rank}:\n{out}"
    assert "Aggregate across ranks:" in outs[0]
    assert "total:" in outs[0]
    assert "Aggregate" not in outs[1]  # only rank 0 prints the rollup
    assert "rank 1 [simple] level 1:" in outs[0]
