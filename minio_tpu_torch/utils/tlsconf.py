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
import time


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


# A pooled keep-alive connection idle this long is replaced before it is
# reused, at most: the window shrinks to half the servers' idle timeout.
# A server closes an idle connection after MINIO_TPU_IDLE_TIMEOUT_S (both
# request planes; 60 s by default), and a request written into a
# connection the server is closing fails with no sign of whether it ran
# - which a lock grant cannot retry - or, from the JAX package's plane,
# reads the 408 it wrote there as its answer.
KEEPALIVE_REUSE_S = 15.0


def keepalive_reuse_s() -> float:
    """The reuse window: min(KEEPALIVE_REUSE_S, MINIO_TPU_IDLE_TIMEOUT_S
    / 2).  The nodes of a cluster share their env, so the timeout read
    here, as the async plane reads it, is the servers' own."""
    try:
        idle = float(os.environ.get("MINIO_TPU_IDLE_TIMEOUT_S") or 60.0)
    except ValueError:
        idle = 60.0
    return min(KEEPALIVE_REUSE_S, idle / 2)


def pooled_connection(
    local, host: str, port: int, timeout: float
) -> "http.client.HTTPConnection":
    """The calling thread's keep-alive connection, kept in
    ``local.conn``; a new one once the last has idled longer than
    ``keepalive_reuse_s()``."""
    now = time.monotonic()
    c = getattr(local, "conn", None)
    if c is not None and now - local.used > keepalive_reuse_s():
        c.close()
        c = None
    if c is None:
        c = client_connection(host, port, timeout)
        local.conn = c
    local.used = now
    return c
