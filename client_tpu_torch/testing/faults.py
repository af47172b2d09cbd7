"""Fault injection: an in-process chaos TCP proxy + server-side hooks.

The port's copy of client_tpu/testing/faults.py; the hooks raise the
port's :class:`~client_tpu_torch.utils.InferenceServerException`.

:class:`FaultProxy` sits between a real client and a real server socket
and injects transport failures on command — connect delay, reset the
next N connections (error-N-times-then-succeed), refuse everything,
truncate a response mid-body, or kill live connections mid-stream.  The
faults happen on real sockets, so every layer under test (http.client
connection, aiohttp session, grpc channel, h2 stream) sees the failure exactly as it
would in production.

Server-side hooks (:class:`FailNTimes`, :class:`GatedFn`) wrap a model
``fn`` to fail with a chosen status N times before succeeding, or to
block until released (the drain-while-busy and overload shapes).

This module is stdlib-only and import-safe anywhere the clients are.
"""

import socket
import struct
import threading
import time

from client_tpu_torch.utils import InferenceServerException

__all__ = ["FaultProxy", "FailNTimes", "GatedFn"]


class FaultProxy:
    """Chaos TCP proxy forwarding ``host:port`` -> *upstream_address*.

    All fault knobs are thread-safe and take effect on the next
    connection (or, for :meth:`kill_active`, immediately).  With no
    faults armed it is a transparent byte pump.
    """

    def __init__(self, upstream_address, host="127.0.0.1", port=0):
        up_host, _, up_port = str(upstream_address).rpartition(":")
        self._upstream = (up_host or "127.0.0.1", int(up_port))
        self._lock = threading.Lock()
        self._closed = False
        self._refuse = False
        self._reset_next = 0
        self._delay_s = 0.0
        self._cut_plans = []  # [remaining_response_bytes] budgets, one per conn
        self._active = []  # live (client_sock, upstream_sock) pairs
        # kill_active() calls so far: a connection accepted before a kill
        # but not yet in _active (its bridge still connecting upstream)
        # is killed too when it gets there
        self._kills = 0
        self.connections = 0  # accepted count (test observability)
        self._srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._srv.bind((host, port))
        self._srv.listen(64)
        self._thread = threading.Thread(
            target=self._serve, name="fault-proxy", daemon=True
        )
        self._thread.start()

    @property
    def address(self):
        host, port = self._srv.getsockname()[:2]
        return f"{host}:{port}"

    # -- fault plan ---------------------------------------------------------

    def reset_next_connections(self, n):
        """RST the next *n* connections at accept (error-then-succeed)."""
        with self._lock:
            self._reset_next = int(n)

    def refuse_connections(self, refuse=True):
        """Reset every connection until cleared (persistent outage)."""
        with self._lock:
            self._refuse = bool(refuse)

    def set_delay(self, seconds):
        """Hold each new connection *seconds* before bridging upstream."""
        with self._lock:
            self._delay_s = float(seconds)

    def cut_responses_after(self, nbytes, times=1):
        """Truncate: for the next *times* connections forward only
        *nbytes* of response bytes, then kill the connection mid-body."""
        with self._lock:
            self._cut_plans.extend([int(nbytes)] for _ in range(times))

    def kill_active(self):
        """Mid-stream disconnect: hard-close every live bridged pair."""
        with self._lock:
            self._kills += 1
            pairs, self._active = self._active, []
        for pair in pairs:
            for sock in pair:
                _hard_close(sock)

    def sigkill(self):
        """The SIGKILL shape as seen from the network: every live
        connection dies with an RST and every new one is refused — what
        a process kill (plus the kernel reaping its sockets) looks like
        to clients.  The upstream server process itself is untouched;
        pair with stopping it (without drain) for full fidelity."""
        self.refuse_connections(True)
        self.kill_active()

    def close(self):
        with self._lock:
            self._closed = True
        try:
            # close() alone does not wake the accept() blocked on it
            self._srv.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        try:
            self._srv.close()
        except OSError:
            pass
        self.kill_active()
        self._thread.join(timeout=5)

    # -- data path ----------------------------------------------------------

    def _serve(self):
        # one guard over the whole accept pass (the BG-THREAD-CRASH
        # shape): a chaos proxy whose accept thread dies silently turns
        # every scenario into a refused-connection test
        while True:
            try:
                conn, _ = self._srv.accept()
            except OSError:  # listener closed
                return
            try:
                with self._lock:
                    if self._closed:
                        _hard_close(conn)
                        return
                    self.connections += 1
                    reset = self._refuse
                    if self._reset_next > 0:
                        self._reset_next -= 1
                        reset = True
                    delay = self._delay_s
                    kills = self._kills
                    # a reset connection must not consume a truncation
                    # plan: the plan applies to the next connection that
                    # bridges
                    budget = (
                        self._cut_plans.pop(0)
                        if self._cut_plans and not reset
                        else None
                    )
                if reset:
                    _hard_close(conn)
                    continue
                threading.Thread(
                    target=self._bridge,
                    args=(conn, delay, budget, kills),
                    name="fault-proxy-conn",
                    daemon=True,
                ).start()
            except Exception:
                _hard_close(conn)

    def _bridge(self, conn, delay, budget, kills):
        if delay:
            time.sleep(delay)
        try:
            upstream = socket.create_connection(self._upstream, timeout=10)
        except OSError:
            _hard_close(conn)
            return
        pair = (conn, upstream)
        with self._lock:
            if self._closed or self._kills != kills:
                for sock in pair:
                    _hard_close(sock)
                return
            self._active.append(pair)
        request_pump = threading.Thread(
            target=self._pump, args=(conn, upstream, None, pair),
            name="fault-proxy-up", daemon=True,
        )
        request_pump.start()
        # response direction carries the truncation budget
        self._pump(upstream, conn, budget, pair)

    def _pump(self, src, dst, budget, pair):
        try:
            while True:
                data = src.recv(65536)
                if not data:
                    break
                if budget is not None:
                    data = data[: max(budget[0], 0)]
                    budget[0] -= len(data)
                if data:
                    dst.sendall(data)
                if budget is not None and budget[0] <= 0:
                    break  # truncation point reached: kill the pair
        except OSError:
            pass
        with self._lock:
            live = pair in self._active
            if live:
                self._active.remove(pair)
        if live:
            for sock in pair:
                _hard_close(sock)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def _hard_close(sock):
    """Terminate a connection abruptly (SO_LINGER 0 => RST on close).

    ``shutdown()`` first: ``close()`` alone does not tear down the TCP
    connection while another thread is blocked in ``recv()`` on the same
    socket (the in-flight syscall pins the file) — the peer would see
    nothing until that thread woke.  shutdown terminates the connection
    immediately and wakes any blocked pump thread."""
    try:
        sock.setsockopt(
            socket.SOL_SOCKET, socket.SO_LINGER, struct.pack("ii", 1, 0)
        )
    except OSError:
        pass
    try:
        sock.shutdown(socket.SHUT_RDWR)
    except OSError:
        pass
    try:
        sock.close()
    except OSError:
        pass


class FailNTimes:
    """Server-side fault hook: fail the first *n* calls with *status*,
    then delegate to the wrapped model fn (application-level
    error-then-succeed, e.g. a model still loading its weights)."""

    def __init__(self, fn, n, status="503", msg="injected transient failure"):
        self._fn = fn
        self._status = status
        self._msg = msg
        self._lock = threading.Lock()
        self.calls = 0
        self.failures_remaining = int(n)

    def __call__(self, inputs, params, context):
        with self._lock:
            self.calls += 1
            if self.failures_remaining > 0:
                self.failures_remaining -= 1
                raise InferenceServerException(self._msg, status=self._status)
        return self._fn(inputs, params, context)


class GatedFn:
    """Server-side hook holding every call until :meth:`release` — the
    in-flight-work shape for drain and overload tests.  ``entered`` is set
    once at least one call is inside the model."""

    def __init__(self, fn, timeout_s=30.0):
        self._fn = fn
        self._timeout_s = timeout_s
        self.entered = threading.Event()
        self._gate = threading.Event()

    def release(self):
        self._gate.set()

    def __call__(self, inputs, params, context):
        self.entered.set()
        # bounded so a broken test cannot wedge the server thread forever
        self._gate.wait(timeout=self._timeout_s)
        return self._fn(inputs, params, context)
