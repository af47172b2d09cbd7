"""The port's chaos proxy (client_tpu_torch/testing/faults.py).

``kill_active()`` (and ``sigkill()``, which refuses new connections and
kills the live ones) must end every connection the proxy had accepted,
including one whose bridge was still connecting upstream when the kill
came: the reference's FaultProxy appends such a connection to its live
set after the kill and bridges it for good, so a client's pooled
keep-alive connection to a "killed" replica kept answering (ROADMAP
Watch: tests/test_torch_balance.py's kill-one-drain-one case, "the
killed replica read READY").  ``set_delay`` holds a bridge before it
connects upstream, which opens that window on purpose here."""

import socket
import threading
import time

import pytest

from client_tpu_torch.testing.faults import FaultProxy


@pytest.fixture
def echo_address():
    srv = socket.socket()
    srv.bind(("127.0.0.1", 0))
    srv.listen(8)
    conns = []

    def serve():
        while True:
            try:
                conn, _ = srv.accept()
            except OSError:
                return
            conns.append(conn)
            threading.Thread(target=_echo, args=(conn,), daemon=True).start()

    thread = threading.Thread(target=serve, daemon=True)
    thread.start()
    yield "127.0.0.1:%d" % srv.getsockname()[1]
    srv.shutdown(socket.SHUT_RDWR)  # wakes the accept
    srv.close()
    for conn in conns:
        conn.close()
    thread.join(timeout=5)


def _echo(conn):
    try:
        while True:
            data = conn.recv(1024)
            if not data:
                return
            conn.sendall(data)
    except OSError:
        return


def _connect(proxy):
    host, port = proxy.address.rsplit(":", 1)
    conn = socket.create_connection((host, int(port)), timeout=5)
    conn.settimeout(2.0)
    return conn


def _answers(conn):
    """Whether a ping through *conn* comes back."""
    try:
        conn.sendall(b"ping")
        return conn.recv(16) == b"ping"
    except OSError:
        return False


def test_sigkill_ends_a_connection_still_being_bridged(echo_address):
    proxy = FaultProxy(echo_address)
    try:
        proxy.set_delay(0.4)
        conn = _connect(proxy)
        deadline = time.monotonic() + 5
        while proxy.connections < 1 and time.monotonic() < deadline:
            time.sleep(0.01)
        assert proxy.connections == 1  # accepted; its bridge is waiting
        proxy.sigkill()
        time.sleep(0.6)  # the bridge connects upstream after the kill
        assert not _answers(conn)
        conn.close()
    finally:
        proxy.close()


def test_kill_active_spares_connections_accepted_after_it(echo_address):
    proxy = FaultProxy(echo_address)
    try:
        before = _connect(proxy)
        assert _answers(before)
        proxy.kill_active()
        assert not _answers(before)
        after = _connect(proxy)
        assert _answers(after)
        after.close()
        before.close()
    finally:
        proxy.close()
