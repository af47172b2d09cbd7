"""The port's perf_analyzer SSL options (``--ssl-grpc-*``, ``--ssl-https-*``)
held against the JAX package's, on the CPU.

- tests/test_perf.py:514-571's cases on the port's backends: an SSL
  gRPC channel, an https origin, and with ``verify_peer`` 0 a
  non-verifying context, with a CA file or without one (where JAX's
  urllib3 pool gets ``cert_reqs=CERT_NONE``, the port's ``http.client``
  pool gets the same non-verifying context).
- The CLI through TLS relays (chip_smoke.TlsRelay: stdlib ssl, ALPN h2
  for gRPC, certificates openssl makes for localhost and 127.0.0.1) in
  front of the port's server and, with the same argv, of the JAX
  server: the gRPC root certificate, the HTTP CA, verify-peer 0 with no
  CA, a relay that requires a client certificate with it, and without it
  (both CLIs fail, nothing served).  The port's JSON ``requests`` equals
  its server's successes; the JAX run exits 0 with its windows' counts
  within its server's.
- The port's own refusals, where the reference would drop an SSL option
  silently.
"""

import json
import ssl

import grpc
import pytest

import chip_smoke
from client_tpu.perf import client_backend as jbackend
from client_tpu.perf.__main__ import main as jmain
from client_tpu.serve import Server as JaxServer
from client_tpu_torch.perf import client_backend as backend
from client_tpu_torch.perf.__main__ import main
from client_tpu_torch.serve import Server

_WINDOW = ["--concurrency-range", "2", "--measurement-interval", "300",
           "--max-trials", "3", "-s", "90"]


@pytest.fixture(scope="module")
def certs(tmp_path_factory):
    return chip_smoke.make_tls_certs(str(tmp_path_factory.mktemp("tls")))


@pytest.fixture(scope="module")
def servers():
    with Server(http_port=0, grpc_port=0, device="cpu") as port, \
            JaxServer(http_port=0, grpc_port=0) as jax:
        yield {"port": port, "jax": jax}


@pytest.fixture(scope="module")
def relays(servers, certs):
    """For each server: a gRPC relay (ALPN h2), an HTTP relay, and an HTTP
    relay that requires the client certificate."""
    cert, key = certs["server"]
    started = {}
    for name, server in servers.items():
        started[name] = {
            "grpc": chip_smoke.TlsRelay(server.grpc_address, cert, key,
                                        alpn=("h2",)).start(),
            "http": chip_smoke.TlsRelay(server.http_address, cert,
                                        key).start(),
            "mtls": chip_smoke.TlsRelay(server.http_address, cert, key,
                                        client_ca=certs["client"][0]
                                        ).start(),
        }
    yield {name: {k: r.address for k, r in rs.items()}
           for name, rs in started.items()}
    for rs in started.values():
        for r in rs.values():
            r.stop()


def _counts(server):
    stats = server.engine.statistics("simple")[0]["inference_stats"]
    return stats["success"]["count"], stats["fail"]["count"]


# -- tests/test_perf.py:514-571 on the port ----------------------------------

def test_ssl_options_reach_clients(monkeypatch):
    """ssl_options build SSL-configured clients (no connect needed)."""
    calls = []
    real = grpc.secure_channel
    monkeypatch.setattr(
        grpc, "secure_channel",
        lambda url, creds, options=None: calls.append(url)
        or real(url, creds, options=options))
    be = backend.ClientBackendFactory.create(
        backend.BackendKind.TRITON_GRPC, url="localhost:1",
        ssl_options={"use_ssl": True})
    assert calls == ["localhost:1"]
    be.close()

    be = backend.ClientBackendFactory.create(
        backend.BackendKind.TRITON_HTTP, url="localhost:1",
        ssl_options={"use_ssl": True, "verify_peer": False})
    assert be._client._origin.startswith("https://")
    ctx = be._client._pool._ssl_context
    assert ctx.check_hostname is False and ctx.verify_mode == ssl.CERT_NONE
    be.close()
    jbe = jbackend.ClientBackendFactory.create(
        jbackend.BackendKind.TRITON_HTTP, url="localhost:1",
        ssl_options={"use_ssl": True, "verify_peer": False})
    assert jbe._client._pool.connection_pool_kw["cert_reqs"] == "CERT_NONE"
    jbe.close()


def test_ssl_http_ca_with_verify_peer_off(certs):
    """A CA file with verify_peer 0 builds a non-verifying context, as
    JAX's backend does."""
    ctxs = []
    for mod in (backend, jbackend):
        be = mod.ClientBackendFactory.create(
            mod.BackendKind.TRITON_HTTP, url="localhost:1",
            ssl_options={"use_ssl": True, "verify_peer": False,
                         "ca_certificates_file": certs["server"][0]})
        ctxs.append(be._client._pool._ssl_context if mod is backend else
                    be._client._pool.connection_pool_kw["ssl_context"])
        be.close()
    for ctx in ctxs:
        assert ctx.check_hostname is False
        assert ctx.verify_mode == ssl.CERT_NONE


def test_ssl_http_client_certificate_is_loaded(certs):
    """A client certificate and key go into the context both backends
    build (it verifies the server against the CA)."""
    for mod in (backend, jbackend):
        be = mod.ClientBackendFactory.create(
            mod.BackendKind.TRITON_HTTP, url="localhost:1",
            ssl_options={"use_ssl": True, "verify_peer": True,
                         "ca_certificates_file": certs["server"][0],
                         "client_certificate_file": certs["client"][0],
                         "private_key_file": certs["client"][1]})
        ctx = (be._client._pool._ssl_context if mod is backend else
               be._client._pool.connection_pool_kw["ssl_context"])
        assert ctx.verify_mode == ssl.CERT_REQUIRED and ctx.check_hostname
        be.close()


# -- the CLI through TLS relays ----------------------------------------------

def _argv(case, certs):
    cert = certs["server"][0]
    client_cert, client_key = certs["client"]
    return {
        "grpc-root": ("grpc", ["-i", "grpc", "--ssl-grpc-use-ssl",
                               "--ssl-grpc-root-certifications-file",
                               cert]),
        "http-ca": ("http", ["-i", "http",
                             "--ssl-https-ca-certificates-file", cert]),
        "http-no-verify": ("http", ["-i", "http",
                                    "--ssl-https-verify-peer", "0"]),
        "mtls": ("mtls", ["-i", "http",
                          "--ssl-https-ca-certificates-file", cert,
                          "--ssl-https-client-certificate-file",
                          client_cert,
                          "--ssl-https-private-key-file", client_key]),
    }[case]


@pytest.mark.parametrize("case", ["grpc-root", "http-ca", "http-no-verify",
                                  "mtls"])
def test_cli_through_tls_counts_equal_each_server(case, certs, servers,
                                                  relays, tmp_path):
    relay, flags = _argv(case, certs)
    for name, run in (("port", main), ("jax", jmain)):
        out = tmp_path / f"{name}.json"
        server = servers[name]
        before = _counts(server)
        rc = run(["-m", "simple", "-u", relays[name][relay], *flags,
                  *_WINDOW, "--json-export", str(out)])
        after = _counts(server)
        assert rc == 0, name
        assert after[0] > before[0] and after[1] == before[1], name
        doc = json.loads(out.read_text())
        in_windows = sum(r["completed_requests"] for r in doc["results"])
        assert 0 < in_windows <= after[0] - before[0], name
        if name == "port":
            assert doc["requests"] == {"completed": after[0] - before[0],
                                       "failed": 0}


def test_cli_without_the_client_certificate_fails(certs, servers, relays,
                                                  capsys):
    """A relay that requires a client certificate refuses both CLIs'
    handshakes: a non-zero exit, nothing served."""
    flags = ["-i", "http", "--ssl-https-ca-certificates-file",
             certs["server"][0], *_WINDOW]
    for name, run in (("port", main), ("jax", jmain)):
        server = servers[name]
        before = _counts(server)
        try:
            rc = run(["-m", "simple", "-u", relays[name]["mtls"], *flags])
        except Exception as e:  # the JAX CLI lets a transport error out
            rc = repr(e)
        assert rc != 0, name
        assert _counts(server) == before, name
    assert "error:" in capsys.readouterr().err


# -- the port's refusals -----------------------------------------------------

@pytest.mark.parametrize("flags,message", [
    (["--ssl-grpc-use-ssl", "--async"], "not --async, --native-loadgen"),
    (["--ssl-grpc-use-ssl", "--native-loadgen"], "socket gRPC/HTTP clients"),
    (["-i", "http", "--ssl-https-verify-peer", "0", "--hermetic",
      "--device", "cpu"], "--hermetic"),
    (["-i", "http", "--ssl-https-ca-certificates-file", "ca.pem",
      "--service-kind", "tfserve_rest"], "non-Triton --service-kind"),
    (["--ssl-https-ca-certificates-file", "ca.pem"],
     "--ssl-https-ca-certificates-file: not an option of -i grpc"),
    (["-i", "grpc", "--ssl-grpc-use-ssl", "--ssl-https-verify-peer", "0"],
     "--ssl-https-verify-peer 0: not an option of -i grpc"),
    (["-i", "http", "--ssl-grpc-use-ssl"],
     "--ssl-grpc-use-ssl: not an option of -i http"),
    (["--ssl-grpc-root-certifications-file", "ca.pem"],
     "without --ssl-grpc-use-ssl"),
    (["-i", "http", "--ssl-https-private-key-file", "k.pem"],
     "--ssl-https-private-key-file without "
     "--ssl-https-client-certificate-file"),
], ids=["async", "native", "hermetic", "service-kind", "https-on-grpc",
        "verify-peer-on-grpc", "grpc-on-http", "files-without-use-ssl",
        "key-without-cert"])
def test_cli_refuses_ssl_it_cannot_honour(flags, message):
    """Where the reference drops an SSL option silently, the port exits
    with a message before anything starts."""
    with pytest.raises(SystemExit) as e:
        main(["-m", "simple", "-u", "localhost:1", *flags])
    assert str(e.value).startswith("error: ")
    assert message in str(e.value)
