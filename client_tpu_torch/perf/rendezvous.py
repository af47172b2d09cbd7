"""Multi-rank coordination for data-parallel benchmarking.

Counterpart of client_tpu/perf/rendezvous.py.  The reference
perf_analyzer coordinates its ranks with dlopen'd MPI (reference
mpi_utils.h:32-84: Init/Barrier/Bcast/Finalize) and requires *all* ranks
to reach stability before any stops measuring (AllMPIRanksAreStable,
inference_profiler.h:537); here, as in the JAX package, a tiny TCP
rendezvous takes MPI's place, so N perf processes on one or many hosts
can drive one or many models concurrently:

  rank 0:  python -m client_tpu_torch.perf ... --world-size 2 --rank 0
  rank 1:  python -m client_tpu_torch.perf ... --world-size 2 --rank 1 \
               --rendezvous-addr <rank0-host>:<port>

:class:`Rendezvous` gives ``barrier()``, ``all_gather(obj)`` and
``all_ranks_stable(flag)``; rank 0 serves, other ranks connect with
retry.  Its frames (``send_frame``, ``_recv_exact``, ``recv_frame``,
copied letter for letter: length-prefixed JSON) are also the transport
the fleet tier (serve/fleet.py) speaks, so port and JAX ranks, and port
and JAX replicas, read each other's frames.
"""

import json
import socket
import struct
import time

from client_tpu_torch.resilience import backoff_delays
from client_tpu_torch.utils import InferenceServerException

__all__ = ["Rendezvous", "send_frame", "recv_frame"]


def send_frame(sock, obj):
    """Write one length-prefixed JSON frame — the transport primitive the
    rendezvous AND the fleet cache tier (serve/fleet.py) share."""
    payload = json.dumps(obj).encode("utf-8")
    sock.sendall(struct.pack("<I", len(payload)) + payload)


def _recv_exact(sock, n):
    buf = b""
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            raise InferenceServerException("rendezvous peer disconnected")
        buf += chunk
    return buf


def recv_frame(sock):
    """Read one length-prefixed JSON frame (see :func:`send_frame`)."""
    (length,) = struct.unpack("<I", _recv_exact(sock, 4))
    return json.loads(_recv_exact(sock, length).decode("utf-8"))


class Rendezvous:
    """Barrier + all-gather across ``world_size`` processes."""

    def __init__(self, rank, world_size, addr="127.0.0.1:29400",
                 connect_timeout_s=60.0):
        if not (0 <= rank < world_size):
            raise InferenceServerException(
                f"rank {rank} out of range for world size {world_size}"
            )
        self.rank = rank
        self.world_size = world_size
        host, _, port = addr.rpartition(":")
        self._host = host or "127.0.0.1"
        self._port = int(port)
        self._peers = {}  # rank -> socket (rank 0 only)
        self._server = None
        self._sock = None  # connection to rank 0 (ranks > 0)
        if world_size > 1:
            if rank == 0:
                self._serve(connect_timeout_s)
            else:
                self._connect(connect_timeout_s)

    def _serve(self, timeout_s):
        srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        srv.bind((self._host, self._port))
        srv.listen(self.world_size)
        srv.settimeout(timeout_s)
        self._server = srv
        deadline = time.monotonic() + timeout_s
        while len(self._peers) < self.world_size - 1:
            if time.monotonic() > deadline:
                raise InferenceServerException(
                    f"rendezvous timeout: {len(self._peers) + 1}/"
                    f"{self.world_size} ranks joined"
                )
            try:
                conn, _ = srv.accept()
            except socket.timeout:
                continue
            # Validate the hello: a duplicate or out-of-range rank would
            # silently evict a legitimate peer (all_gather then hangs or
            # mis-orders); reject the connection instead.  Any handshake
            # failure (garbage bytes, early disconnect, RST on the reject
            # send) only drops THAT connection — a port scanner or crashing
            # peer must not abort the whole rendezvous.
            try:
                hello = recv_frame(conn)
                peer = hello.get("rank")
                if (
                    not isinstance(peer, int)
                    or isinstance(peer, bool)
                    or not (1 <= peer < self.world_size)
                ):
                    send_frame(
                        conn,
                        {"error": f"invalid rank {peer!r} for world size "
                                  f"{self.world_size}"},
                    )
                    conn.close()
                    continue
                if peer in self._peers:
                    send_frame(conn, {"error": f"rank {peer} already joined"})
                    conn.close()
                    continue
                send_frame(conn, {"ok": True})
            except (InferenceServerException, OSError, ValueError):
                try:
                    conn.close()
                except OSError:
                    pass
                continue
            self._peers[peer] = conn

    def _connect(self, timeout_s):
        deadline = time.monotonic() + timeout_s
        last_err = None
        # Jittered exponential backoff between attempts: rank 0 binding
        # late is normal, but hammering ECONNREFUSED in a tight loop burns
        # a core per waiting rank, and N ranks retrying in lockstep arrive
        # as a thundering herd the moment the port opens.
        delays = backoff_delays(initial_s=0.05, multiplier=2.0, max_s=1.0)
        while time.monotonic() < deadline:
            try:
                sock = socket.create_connection(
                    (self._host, self._port), timeout=5.0
                )
                sock.settimeout(timeout_s)
                send_frame(sock, {"rank": self.rank})
                ack = recv_frame(sock)
                if "error" in ack:
                    sock.close()
                    raise InferenceServerException(
                        f"rendezvous rejected rank {self.rank}: {ack['error']}"
                    )
                self._sock = sock
                return
            except OSError as e:
                last_err = e
                time.sleep(
                    min(next(delays), max(deadline - time.monotonic(), 0.0))
                )
        raise InferenceServerException(
            f"unable to reach rendezvous at {self._host}:{self._port}: "
            f"{last_err}"
        )

    def all_gather(self, obj):
        """Every rank contributes ``obj``; all receive the rank-ordered list."""
        if self.world_size == 1:
            return [obj]
        if self.rank == 0:
            gathered = {0: obj}
            for rank, sock in self._peers.items():
                gathered[rank] = recv_frame(sock)["payload"]
            result = [gathered[r] for r in range(self.world_size)]
            for sock in self._peers.values():
                send_frame(sock, {"payload": result})
            return result
        send_frame(self._sock, {"payload": obj})
        return recv_frame(self._sock)["payload"]

    def barrier(self):
        self.all_gather(None)

    def all_ranks_stable(self, local_stable):
        """AllMPIRanksAreStable analog: true only when every rank is."""
        return all(self.all_gather(bool(local_stable)))

    def close(self):
        for sock in self._peers.values():
            sock.close()
        self._peers = {}
        if self._sock is not None:
            self._sock.close()
            self._sock = None
        if self._server is not None:
            self._server.close()
            self._server = None
