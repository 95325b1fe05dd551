"""Broker notification targets: Redis, NATS, Kafka
(pkg/event/target/{redis,nats,kafka}.go).

Redis and NATS speak their actual wire protocols over stdlib sockets
(RESP arrays / the NATS text protocol) - no client libraries in-image.
Kafka's binary protocol is not reimplemented here: KafkaTarget takes a
``producer`` with ``produce(topic, key, value)`` (a kafka client or an
in-process fake), matching how the reference delegates to sarama.
"""

from __future__ import annotations

import json
import socket
import threading

from .targets import TargetError


class RedisTarget:
    """RPUSH each event record onto a Redis list (the reference's
    access-format redis target, pkg/event/target/redis.go)."""

    def __init__(
        self,
        target_id: str,
        addr: str,
        key: str = "minioevents",
        password: str = "",
        timeout: float = 5.0,
    ):
        self.id = target_id
        self.arn = f"arn:minio:sqs::{target_id}:redis"
        host, _, port = addr.rpartition(":")
        if not host:
            raise TargetError(f"bad redis address {addr!r}")
        self.host, self.port = host, int(port)
        self.key = key
        self.password = password
        self._timeout = timeout
        self._mu = threading.Lock()
        self._sock: "socket.socket | None" = None

    # -- RESP encoding ---------------------------------------------------

    @staticmethod
    def _resp(*args: bytes) -> bytes:
        out = [b"*%d\r\n" % len(args)]
        for a in args:
            out.append(b"$%d\r\n%s\r\n" % (len(a), a))
        return b"".join(out)

    def _read_reply(self, f) -> bytes:
        line = f.readline()
        if not line:
            raise TargetError("redis connection closed")
        if line[:1] == b"-":
            raise TargetError(f"redis error: {line[1:].strip().decode()}")
        if line[:1] == b"$":  # bulk string
            n = int(line[1:])
            if n >= 0:
                f.read(n + 2)
        return line.strip()

    def _connect(self) -> socket.socket:
        s = socket.create_connection(
            (self.host, self.port), timeout=self._timeout
        )
        if self.password:
            f = s.makefile("rb")
            s.sendall(self._resp(b"AUTH", self.password.encode()))
            self._read_reply(f)
        return s

    def send(self, record: dict) -> None:
        body = json.dumps(record).encode()
        with self._mu:
            try:
                if self._sock is None:
                    self._sock = self._connect()
                s = self._sock
                s.sendall(
                    self._resp(b"RPUSH", self.key.encode(), body)
                )
                self._read_reply(s.makefile("rb"))
            except (OSError, TargetError):
                self._drop()
                raise TargetError(
                    f"redis {self.host}:{self.port} unreachable"
                ) from None

    def _drop(self) -> None:
        if self._sock is not None:
            try:
                self._sock.close()
            except OSError:
                pass
            self._sock = None

    def close(self) -> None:
        with self._mu:
            self._drop()


class NATSTarget:
    """PUB each record to a NATS subject (pkg/event/target/nats.go),
    speaking the plain NATS text protocol."""

    def __init__(
        self,
        target_id: str,
        addr: str,
        subject: str = "minioevents",
        timeout: float = 5.0,
    ):
        self.id = target_id
        self.arn = f"arn:minio:sqs::{target_id}:nats"
        host, _, port = addr.rpartition(":")
        if not host:
            raise TargetError(f"bad nats address {addr!r}")
        self.host, self.port = host, int(port)
        self.subject = subject
        self._timeout = timeout
        self._mu = threading.Lock()
        self._sock: "socket.socket | None" = None
        self._file = None

    def _connect(self) -> None:
        s = socket.create_connection(
            (self.host, self.port), timeout=self._timeout
        )
        f = s.makefile("rb")
        info = f.readline()  # INFO {...}
        if not info.startswith(b"INFO"):
            s.close()
            raise TargetError("not a NATS server")
        s.sendall(b'CONNECT {"verbose":false}\r\n')
        self._sock, self._file = s, f

    def send(self, record: dict) -> None:
        body = json.dumps(record).encode()
        with self._mu:
            try:
                if self._sock is None:
                    self._connect()
                self._sock.sendall(
                    b"PUB %s %d\r\n%s\r\n"
                    % (self.subject.encode(), len(body), body)
                )
                # PING/PONG round trip confirms the server consumed it
                self._sock.sendall(b"PING\r\n")
                while True:
                    line = self._file.readline()
                    if not line:
                        raise TargetError("nats connection closed")
                    if line.startswith(b"PONG"):
                        break
                    if line.startswith(b"-ERR"):
                        raise TargetError(line.decode().strip())
            except (OSError, TargetError):
                self._drop()
                raise TargetError(
                    f"nats {self.host}:{self.port} unreachable"
                ) from None

    def _drop(self) -> None:
        if self._sock is not None:
            try:
                self._sock.close()
            except OSError:
                pass
            self._sock = None
            self._file = None

    def close(self) -> None:
        with self._mu:
            self._drop()


class KafkaTarget:
    """Produce each record to a Kafka topic.  The binary protocol is
    delegated to ``producer`` (kafka-python / confluent client / test
    fake) with ``produce(topic, key, value)`` - mirroring the
    reference's sarama delegation (pkg/event/target/kafka.go)."""

    def __init__(self, target_id: str, topic: str, producer=None):
        self.id = target_id
        self.arn = f"arn:minio:sqs::{target_id}:kafka"
        self.topic = topic
        self.producer = producer

    def send(self, record: dict) -> None:
        if self.producer is None:
            raise TargetError("kafka producer not configured")
        key = record.get("Key", "")
        self.producer.produce(
            self.topic, key.encode(), json.dumps(record).encode()
        )

    def close(self) -> None:
        closer = getattr(self.producer, "close", None)
        if closer is not None:
            closer()
