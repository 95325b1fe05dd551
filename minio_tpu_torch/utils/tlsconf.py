"""TLS configuration for the listener and every internode client
(the reference's pkg/certs hot-reload + xhttp TLS listener, trimmed to
env-driven static certs).

Env contract:
  MINIO_TPU_TLS=on            enable TLS (listener + internode clients)
  MINIO_TPU_CERT_FILE/MINIO_TPU_KEY_FILE   the server keypair
  MINIO_TPU_CA_FILE           CA bundle clients verify against;
                              without one, clients accept any cert
                              (self-signed single-cluster deployments -
                              internode auth still rides JWT)
"""

from __future__ import annotations

import http.client
import os
import ssl


def enabled() -> bool:
    return os.environ.get("MINIO_TPU_TLS", "off") == "on"


def server_context() -> "ssl.SSLContext":
    cert = os.environ.get("MINIO_TPU_CERT_FILE", "")
    key = os.environ.get("MINIO_TPU_KEY_FILE", "")
    if not cert or not key:
        raise RuntimeError(
            "MINIO_TPU_TLS=on needs MINIO_TPU_CERT_FILE and "
            "MINIO_TPU_KEY_FILE"
        )
    ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
    ctx.load_cert_chain(cert, key)
    return ctx


def _client_context() -> "ssl.SSLContext":
    ca = os.environ.get("MINIO_TPU_CA_FILE", "")
    if ca:
        return ssl.create_default_context(cafile=ca)
    ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_CLIENT)
    ctx.check_hostname = False
    ctx.verify_mode = ssl.CERT_NONE
    return ctx


def client_connection(
    host: str, port: int, timeout: float
) -> "http.client.HTTPConnection":
    """The one constructor every internode client uses, so the whole
    mesh switches to TLS with the env flag."""
    if enabled():
        return http.client.HTTPSConnection(
            host, port, timeout=timeout, context=_client_context()
        )
    return http.client.HTTPConnection(host, port, timeout=timeout)
