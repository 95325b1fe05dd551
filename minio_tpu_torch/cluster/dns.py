"""Federation bucket DNS: a shared record store mapping every bucket
to the cluster that owns it (cmd/config/etcd/dns/etcd_dns.go).

The reference writes SkyDNS-style SRV records into etcd so CoreDNS
serves ``bucket.domain`` lookups; federated clusters share the etcd.
This image has no etcd, so the store is an interface with two
backends carrying the same record shape:

- :class:`FileDNSStore` - JSON records in a shared directory (NFS or
  any common mount plays the etcd role); atomic writes, no daemon.
- :class:`MemoryDNSStore` - in-process, for tests and single-cluster
  embedding.

Record shape mirrors the reference's SrvRecord (host/port/key/ttl).
"""

from __future__ import annotations

import dataclasses
import json
import os
import threading
import time
import uuid


class DNSError(Exception):
    pass


class NoEntriesFound(DNSError):
    """dns.ErrNoEntriesFound."""


class RecordExists(DNSError):
    """Exclusive create lost the race to another cluster."""


@dataclasses.dataclass
class SrvRecord:
    host: str
    port: int
    key: str = ""  # bucket name
    ttl: int = 30
    creation_ns: int = 0
    scheme: str = "http"  # the OWNER's scheme, for redirects

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "SrvRecord":
        return cls(
            host=d.get("host", ""),
            port=int(d.get("port", 0)),
            key=d.get("key", ""),
            ttl=int(d.get("ttl", 30)),
            creation_ns=int(d.get("creation_ns", 0)),
            scheme=d.get("scheme", "http"),
        )


class DNSStore:
    """etcd_dns.go Config surface."""

    def put(self, bucket: str, records: "list[SrvRecord]") -> None:
        raise NotImplementedError

    def create(self, bucket: str, records: "list[SrvRecord]") -> None:
        """Exclusive put: RecordExists when the bucket already has a
        record (the etcd-transaction role - two clusters racing a
        CreateBucket must not both win)."""
        raise NotImplementedError

    def get(self, bucket: str) -> "list[SrvRecord]":
        """Records for one bucket; NoEntriesFound when absent."""
        raise NotImplementedError

    def delete(self, bucket: str) -> None:
        raise NotImplementedError

    def list(self) -> "dict[str, list[SrvRecord]]":
        raise NotImplementedError


class MemoryDNSStore(DNSStore):
    def __init__(self):
        self._mu = threading.Lock()
        self._recs: "dict[str, list[SrvRecord]]" = {}

    def put(self, bucket, records):
        with self._mu:
            self._recs[bucket] = list(records)

    def create(self, bucket, records):
        with self._mu:
            if bucket in self._recs:
                raise RecordExists(bucket)
            self._recs[bucket] = list(records)

    def get(self, bucket):
        with self._mu:
            recs = self._recs.get(bucket)
        if not recs:
            raise NoEntriesFound(bucket)
        return list(recs)

    def delete(self, bucket):
        with self._mu:
            self._recs.pop(bucket, None)

    def list(self):
        with self._mu:
            return {b: list(r) for b, r in self._recs.items()}


class FileDNSStore(DNSStore):
    """One JSON file per bucket under a shared directory."""

    def __init__(self, root: str):
        self.root = root
        os.makedirs(root, exist_ok=True)

    def _path(self, bucket: str) -> str:
        if "/" in bucket or bucket.startswith("."):
            raise DNSError(f"bad bucket name {bucket!r}")
        return os.path.join(self.root, f"{bucket}.json")

    def _tmp(self, bucket: str) -> str:
        # unique per call: two servers of one process, or two requests
        # of one server, may stage the same bucket's record at once
        return self._path(bucket) + f".tmp.{os.getpid()}.{uuid.uuid4().hex}"

    def put(self, bucket, records):
        doc = json.dumps([r.to_dict() for r in records]).encode()
        tmp = self._tmp(bucket)
        with open(tmp, "wb") as f:
            f.write(doc)
        os.replace(tmp, self._path(bucket))

    def create(self, bucket, records):
        doc = json.dumps([r.to_dict() for r in records]).encode()
        tmp = self._tmp(bucket)
        with open(tmp, "wb") as f:
            f.write(doc)
        try:
            # hard link is the atomic compare-and-create on shared
            # filesystems: it FAILS if the name exists
            os.link(tmp, self._path(bucket))
        except FileExistsError:
            raise RecordExists(bucket) from None
        finally:
            os.remove(tmp)

    def get(self, bucket):
        try:
            with open(self._path(bucket), "rb") as f:
                doc = json.load(f)
        except FileNotFoundError:
            raise NoEntriesFound(bucket) from None
        except ValueError:
            raise DNSError(f"corrupt record for {bucket!r}") from None
        if not doc:
            raise NoEntriesFound(bucket)
        return [SrvRecord.from_dict(d) for d in doc]

    def delete(self, bucket):
        try:
            os.remove(self._path(bucket))
        except FileNotFoundError:
            pass

    def list(self):
        out = {}
        for fn in os.listdir(self.root):
            if not fn.endswith(".json"):
                continue
            bucket = fn[: -len(".json")]
            try:
                out[bucket] = self.get(bucket)
            except DNSError:
                continue
        return out


class BucketDNS:
    """The federation seam the server drives (globalDNSConfig role):
    owns this cluster's record set and answers ownership questions."""

    def __init__(self, store: DNSStore, host: str, port: int,
                 scheme: str = "http"):
        self.store = store
        self.host = host
        self.port = port
        self.scheme = scheme

    def _own_records(self, bucket: str) -> "list[SrvRecord]":
        return [
            SrvRecord(
                host=self.host,
                port=self.port,
                key=bucket,
                creation_ns=time.time_ns(),
                scheme=self.scheme,
            )
        ]

    def register(self, bucket: str) -> None:
        """Exclusive: raises RecordExists when another cluster won
        the name."""
        self.store.create(bucket, self._own_records(bucket))

    def unregister(self, bucket: str) -> None:
        self.store.delete(bucket)

    def lookup(self, bucket: str) -> "list[SrvRecord]":
        return self.store.get(bucket)

    def owned_by_us(self, records: "list[SrvRecord]") -> bool:
        return any(
            r.host == self.host and r.port == self.port
            for r in records
        )

    def federated_buckets(self) -> "dict[str, list[SrvRecord]]":
        return self.store.list()
