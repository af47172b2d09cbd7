"""Length-prefixed JSON frames over a socket.

Counterpart of the frame half of client_tpu/perf/rendezvous.py
(``send_frame``, ``_recv_exact``, ``recv_frame``, copied letter for
letter): the transport primitive the fleet tier (serve/fleet.py) speaks,
so a port replica and a JAX replica read each other's frames.  The
rendezvous barrier itself is not ported.
"""

import json
import struct

from client_tpu_torch.utils import InferenceServerException

__all__ = ["send_frame", "recv_frame"]


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
