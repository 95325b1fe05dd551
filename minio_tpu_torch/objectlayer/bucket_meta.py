"""Per-bucket metadata subsystem (cmd/bucket-metadata-sys.go).

One JSON document per bucket at ``.sys/buckets/<bucket>/metadata.json``
(the .minio.sys/buckets/<bucket>/.metadata.bin analogue) holding every
bucket-scoped config: policy, versioning state, tagging, quota,
lifecycle, notification, object-lock.  Erasure-coded through the object
layer so all nodes converge on it; cached in memory per process with
read-through on miss.
"""

from __future__ import annotations

import dataclasses
import io
import json
import threading
import time

from ..iam.policy import Policy, PolicyError
from .api import META_BUCKET, BucketNotFound, ObjectNotFound

META_PREFIX = "buckets"
# without a peer control plane, remote config edits surface after the
# cache TTL (the stand-in for peer-RPC invalidation)
CACHE_TTL_S = 5.0


@dataclasses.dataclass
class BucketMetadata:
    """All bucket configs (cmd/bucket-metadata.go BucketMetadata)."""

    name: str = ""
    created_ns: int = 0
    policy_json: str = ""  # bucket (resource) policy document
    versioning: str = ""  # "" | "Enabled" | "Suspended"
    tagging_xml: str = ""
    quota_json: str = ""
    lifecycle_xml: str = ""
    notification_xml: str = ""
    object_lock_xml: str = ""
    sse_config_xml: str = ""
    replication_xml: str = ""
    # admin-registered remote replication targets (bucket-targets.go):
    # JSON list of {endpoint, access_key, secret_key, target_bucket}
    replication_targets_json: str = ""

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "BucketMetadata":
        fields = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in fields})

    @property
    def versioning_enabled(self) -> bool:
        return self.versioning == "Enabled"

    @property
    def versioning_suspended(self) -> bool:
        return self.versioning == "Suspended"

    def policy(self) -> "Policy | None":
        if not self.policy_json:
            return None
        cached = getattr(self, "_parsed_policy", None)
        if cached is not None:
            return cached
        try:
            parsed = Policy.from_json(self.policy_json)
        except PolicyError:
            return None
        # memoized per document: authorization runs per request (and
        # per key in multi-delete) - don't re-parse each time
        object.__setattr__(self, "_parsed_policy", parsed)
        return parsed


class BucketMetadataSys:
    """Read-through cache over the persisted per-bucket documents."""

    def __init__(self, object_layer, cache_ttl_s: "float | None" = None):
        import os

        self._ol = object_layer
        self._ttl = (
            cache_ttl_s
            if cache_ttl_s is not None
            else float(
                os.environ.get("MINIO_TPU_BUCKET_META_TTL_S") or CACHE_TTL_S
            )
        )
        self._mu = threading.RLock()
        self._cache: "dict[str, tuple[BucketMetadata, float]]" = {}
        # peer control plane: set in distributed mode so edits broadcast
        # an invalidation instead of waiting out peers' TTLs
        self.notifier = None

    def _path(self, bucket: str) -> str:
        return f"{META_PREFIX}/{bucket}/metadata.json"

    # -- reads ------------------------------------------------------------

    def get(self, bucket: str) -> BucketMetadata:
        """Metadata for the bucket; a default (empty) document when none
        was ever written.  BucketNotFound propagates from the layer.
        Entries expire after the TTL so edits made through another node
        take effect here without a peer broadcast."""
        now = time.monotonic()
        with self._mu:
            hit = self._cache.get(bucket)
            if hit is not None and now - hit[1] < self._ttl:
                return hit[0]
        bm = self._load(bucket)
        with self._mu:
            self._cache[bucket] = (bm, now)
        return bm

    def cached(self, bucket: str) -> "BucketMetadata | None":
        """The document while its cache entry is fresh, else None; never
        reads the store (for callers on an event loop)."""
        with self._mu:
            hit = self._cache.get(bucket)
            if hit is not None and time.monotonic() - hit[1] < self._ttl:
                return hit[0]
        return None

    def _load(self, bucket: str) -> BucketMetadata:
        buf = io.BytesIO()
        try:
            self._ol.get_object(META_BUCKET, self._path(bucket), buf)
            return BucketMetadata.from_dict(json.loads(buf.getvalue()))
        except ObjectNotFound:
            return BucketMetadata(name=bucket)
        except BucketNotFound:
            return BucketMetadata(name=bucket)
        except ValueError:
            return BucketMetadata(name=bucket)

    # -- writes -----------------------------------------------------------

    def update(self, bucket: str, **fields) -> BucketMetadata:
        """Persist new values for the given config fields."""
        # the bucket must exist (mirrors BucketMetadataSys.Update)
        self._ol.get_bucket_info(bucket)
        with self._mu:
            hit = self._cache.get(bucket)
            bm = hit[0] if hit else self._load(bucket)
            bm = dataclasses.replace(bm, name=bucket, **fields)
            if not bm.created_ns:
                bm.created_ns = time.time_ns()
            raw = json.dumps(bm.to_dict()).encode()
            self._ol.put_object(
                META_BUCKET, self._path(bucket), io.BytesIO(raw), len(raw)
            )
            self._cache[bucket] = (bm, time.monotonic())
        if self.notifier is not None:
            self.notifier.bucket_meta_changed(bucket)
        return bm

    def delete(self, bucket: str) -> None:
        """Drop the document when its bucket is deleted."""
        with self._mu:
            self._cache.pop(bucket, None)
        try:
            self._ol.delete_object(META_BUCKET, self._path(bucket))
        except (ObjectNotFound, BucketNotFound):
            pass
        if self.notifier is not None:
            self.notifier.bucket_meta_deleted(bucket)

    def invalidate(self, bucket: "str | None" = None) -> None:
        """Forget cached entries (peer-invalidation stand-in)."""
        with self._mu:
            if bucket is None:
                self._cache.clear()
            else:
                self._cache.pop(bucket, None)
