"""Bucket quota (cmd/bucket-quota.go): hard quotas enforced on PUT,
FIFO quotas enforced by the crawler's eviction pass.

Config document (madmin BucketQuota JSON): ``{"quota": <bytes>,
"quotatype": "hard" | "fifo"}``, stored in the bucket metadata.
"""

from __future__ import annotations

import dataclasses
import json


class QuotaError(Exception):
    pass


@dataclasses.dataclass
class QuotaConfig:
    quota: int = 0  # bytes; 0 = unlimited
    quota_type: str = "hard"  # hard | fifo

    @classmethod
    def from_json(cls, raw: "str | bytes") -> "QuotaConfig":
        try:
            doc = json.loads(raw)
        except ValueError:
            raise QuotaError("malformed quota JSON") from None
        if not isinstance(doc, dict):
            raise QuotaError("quota document must be an object")
        try:
            quota = int(doc.get("quota", 0))
        except (TypeError, ValueError):
            raise QuotaError("quota must be an integer") from None
        if quota < 0:
            raise QuotaError("quota must be >= 0")
        qt = str(doc.get("quotatype", "hard")).lower()
        if qt not in ("hard", "fifo"):
            raise QuotaError(f"unknown quotatype {qt!r}")
        return cls(quota, qt)

    def to_json(self) -> str:
        return json.dumps(
            {"quota": self.quota, "quotatype": self.quota_type}
        )


def config_for(bucket_meta_sys, bucket: str) -> "QuotaConfig | None":
    try:
        raw = bucket_meta_sys.get(bucket).quota_json
    except Exception:  # noqa: BLE001
        return None
    return parse_config(raw)


def parse_config(raw: str) -> "QuotaConfig | None":
    """The quota a bucket document's ``quota_json`` sets, or None."""
    if not raw:
        return None
    try:
        cfg = QuotaConfig.from_json(raw)
    except QuotaError:
        return None
    return cfg if cfg.quota > 0 else None


def bucket_size(server, bucket: str) -> int:
    """Current logical bytes in the bucket: crawler snapshot when one
    exists (enforceBucketQuota consults the dataUsageCache), else a
    direct list walk."""
    crawler = getattr(server, "crawler", None)
    if crawler is not None:
        bu = crawler.usage().buckets.get(bucket)
        if bu is not None:
            return bu.size
    total = 0
    marker = ""
    while True:
        res = server.object_layer.list_objects(
            bucket, "", marker, "", 1000
        )
        total += sum(o.size for o in res.objects if not o.is_dir)
        if not res.is_truncated:
            return total
        marker = res.next_marker


def enforce_put(server, bucket: str, add_size: int) -> None:
    """Raise when a hard quota would be exceeded by add_size bytes
    (enforceBucketQuota on PutObject)."""
    cfg = config_for(server.bucket_meta, bucket)
    if cfg is None or cfg.quota_type != "hard":
        return
    if add_size < 0:
        add_size = 0
    if bucket_size(server, bucket) + add_size > cfg.quota:
        from ..server.s3errors import S3Error

        raise S3Error("XMinioAdminBucketQuotaExceeded")
