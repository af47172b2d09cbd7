#!/usr/bin/env python3
"""A TLS relay in front of a plaintext TCP port, in a process of its own.

    python3 tools/tls_relay.py BACKEND CERT KEY [ALPN] [CLIENT_CA]

prints the relay's address (``127.0.0.1:port``) on a line of its own and
relays until its standard input closes.  ``ALPN`` is a comma-separated
list (``h2`` for gRPC); ``CLIENT_CA`` makes it require a client
certificate that CA signs.  It imports the standard library alone, so it
runs with torch blocked (tools/torch_free.py); ``chip_smoke.TlsRelay`` is
this module's class.
"""

import asyncio
import ssl
import sys
import threading


class TlsRelay:
    """TLS in front of a plaintext TCP port: stdlib ``ssl`` on an asyncio
    loop in a thread of its own, bytes copied both ways.  Neither server
    terminates TLS itself; a deployment puts such a proxy in front of it,
    and the perf CLI's --ssl-* options are held against this one.
    ``alpn`` (``("h2",)`` for gRPC, which drops a TLS connection without
    it) and ``client_ca`` (require a client certificate it signs) are the
    server context's."""

    def __init__(self, backend, cert, key, alpn=(), client_ca=None):
        self._ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
        self._ctx.load_cert_chain(cert, key)
        if alpn:
            self._ctx.set_alpn_protocols(list(alpn))
        if client_ca:
            self._ctx.verify_mode = ssl.CERT_REQUIRED
            self._ctx.load_verify_locations(client_ca)
        host, _, port = backend.rpartition(":")
        self._backend = (host, int(port))
        self._loop = asyncio.new_event_loop()
        # a refused handshake (no client certificate) is the expected
        # outcome of a leg, not an error to print
        self._loop.set_exception_handler(lambda loop, context: None)
        self._ready = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._server = None
        self.address = None

    def start(self):
        self._thread.start()
        if not self._ready.wait(30) or self.address is None:
            raise RuntimeError("the TLS relay did not start")
        return self

    def stop(self):
        if self._server is not None:
            self._loop.call_soon_threadsafe(self._server.close)
        self._thread.join(timeout=30)

    def _run(self):
        asyncio.set_event_loop(self._loop)

        async def serve():
            self._server = await asyncio.start_server(
                self._handle, "127.0.0.1", 0, ssl=self._ctx)
            self.address = "127.0.0.1:%d" % (
                self._server.sockets[0].getsockname()[1])
            self._ready.set()
            try:
                await self._server.serve_forever()
            except asyncio.CancelledError:
                pass

        try:
            self._loop.run_until_complete(serve())
        finally:
            self._ready.set()
            for task in asyncio.all_tasks(self._loop):
                task.cancel()
            self._loop.run_until_complete(asyncio.sleep(0))
            self._loop.close()

    async def _handle(self, reader, writer):
        try:
            up_reader, up_writer = await asyncio.open_connection(
                *self._backend)
        except OSError:
            writer.close()
            return

        async def pump(src, dst):
            try:
                while True:
                    data = await src.read(1 << 16)
                    if not data:
                        break
                    dst.write(data)
                    await dst.drain()
            except (OSError, asyncio.IncompleteReadError):
                pass
            finally:
                dst.close()

        await asyncio.gather(pump(reader, up_writer), pump(up_reader, writer))


def main(argv):
    backend, cert, key = argv[:3]
    alpn = argv[3] if len(argv) > 3 else ""
    client_ca = argv[4] if len(argv) > 4 else ""
    relay = TlsRelay(backend, cert, key,
                     alpn=tuple(a for a in alpn.split(",") if a),
                     client_ca=client_ca or None).start()
    print(relay.address, flush=True)
    sys.stdin.read()  # until the parent closes its end
    relay.stop()


if __name__ == "__main__":
    main(sys.argv[1:])
