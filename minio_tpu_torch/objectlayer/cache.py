"""Disk cache layer (cmd/disk-cache.go CacheObjectLayer +
disk-cache-backend.go diskCache).

An SSD edge cache shadowing any ObjectLayer: GETs read through the
cache (consistent-hash drive pick, etag-validated against the backend),
writes go straight to the backend and invalidate, and an LRU GC keeps
each cache drive between its low/high watermarks.  Only full-object
GETs populate the cache; range reads are served from a cached whole
object when present and pass through otherwise (the reference's
range-caching refinement is skipped - ranges never cause eviction
pressure here).
"""

from __future__ import annotations

import hashlib
import json
import os
import shutil
import threading

from .api import ObjectInfo, ObjectNotFound

# GC watermarks (disk-cache.go cacheGCHighWater/LowWater defaults)
HIGH_WATERMARK = 0.80
LOW_WATERMARK = 0.70
# objects above this fraction of the quota are never cached
MAX_OBJECT_FRACTION = 0.25


class _CacheDrive:
    """One cache directory with a byte quota and LRU eviction."""

    def __init__(self, root: str, quota_bytes: int):
        self.root = root
        self.quota = quota_bytes
        self._mu = threading.Lock()
        os.makedirs(root, exist_ok=True)
        self._used = self._scan_used()

    def _scan_used(self) -> int:
        total = 0
        for dirpath, _dirs, files in os.walk(self.root):
            for fn in files:
                try:
                    total += os.path.getsize(os.path.join(dirpath, fn))
                except OSError:
                    pass
        return total

    def _entry_dir(self, bucket: str, key: str) -> str:
        h = hashlib.sha256(f"{bucket}/{key}".encode()).hexdigest()
        return os.path.join(self.root, h[:2], h)

    # -- lookup -----------------------------------------------------------

    def get(self, bucket: str, key: str) -> "tuple[str, dict] | None":
        """(data_path, meta) when cached; touches the data file's
        mtime for LRU.  meta.json is never rewritten on the read path:
        an in-place rewrite would race concurrent readers into
        spurious misses (and re-population)."""
        d = self._entry_dir(bucket, key)
        data, meta_p = os.path.join(d, "data"), os.path.join(d, "meta.json")
        try:
            with open(meta_p, encoding="utf-8") as f:
                meta = json.load(f)
        except (OSError, ValueError):
            return None
        if not os.path.isfile(data):
            return None
        try:
            os.utime(data)  # LRU recency = data-file mtime
        except OSError:
            pass
        return data, meta

    # -- population -------------------------------------------------------

    def put(
        self, bucket: str, key: str, data_path_tmp: str, meta: dict
    ) -> None:
        """Adopt a staged data file into the cache (rename, no copy)."""
        size = os.path.getsize(data_path_tmp)
        if self.quota and size > self.quota * MAX_OBJECT_FRACTION:
            os.remove(data_path_tmp)
            return
        with self._mu:
            if self.quota and self._used + size > self.quota * HIGH_WATERMARK:
                self._gc_locked(
                    int(self.quota * LOW_WATERMARK) - size
                )
        d = self._entry_dir(bucket, key)
        os.makedirs(d, exist_ok=True)
        data_p = os.path.join(d, "data")
        # re-population overwrites a stale entry in place: its old
        # bytes leave the accounting as the new ones enter
        try:
            old_size = os.path.getsize(data_p)
        except OSError:
            old_size = 0
        os.replace(data_path_tmp, data_p)
        meta = {**meta, "size": size}
        tmp = os.path.join(d, "meta.json.tmp")
        with open(tmp, "w", encoding="utf-8") as f:
            json.dump(meta, f)
        os.replace(tmp, os.path.join(d, "meta.json"))
        with self._mu:
            self._used += size - old_size

    def invalidate(self, bucket: str, key: str) -> None:
        d = self._entry_dir(bucket, key)
        try:
            size = os.path.getsize(os.path.join(d, "data"))
        except OSError:
            size = 0
        shutil.rmtree(d, ignore_errors=True)
        with self._mu:
            self._used = max(0, self._used - size)

    # -- GC (disk-cache.go gc at watermarks) ------------------------------

    def _entries(self) -> "list[tuple[float, int, str]]":
        out = []
        for sub in os.listdir(self.root):
            subp = os.path.join(self.root, sub)
            if not os.path.isdir(subp):
                continue
            for h in os.listdir(subp):
                d = os.path.join(subp, h)
                try:
                    with open(
                        os.path.join(d, "meta.json"), encoding="utf-8"
                    ) as f:
                        json.load(f)  # unreadable meta -> reap entry
                    st = os.stat(os.path.join(d, "data"))
                except (OSError, ValueError):
                    shutil.rmtree(d, ignore_errors=True)
                    continue
                out.append((st.st_mtime, st.st_size, d))
        return out

    def _gc_locked(self, target_used: int) -> None:
        """Evict least-recently-used entries until used <= target."""
        if self._used <= max(target_used, 0):
            return
        for _atime, size, d in sorted(self._entries()):
            shutil.rmtree(d, ignore_errors=True)
            self._used = max(0, self._used - size)
            if self._used <= max(target_used, 0):
                break

    @property
    def used(self) -> int:
        with self._mu:
            return self._used


class CacheObjectLayer:
    """ObjectLayer decorator adding the read cache.  Every unknown
    attribute passes straight through to the backend layer."""

    def __init__(
        self,
        backend,
        drives: "list[str]",
        quota_bytes: int = 0,
    ):
        self._ol = backend
        self.drives = [_CacheDrive(d, quota_bytes) for d in drives]
        self.hits = 0
        self.misses = 0

    def _drive(self, bucket: str, key: str) -> "_CacheDrive":
        """Consistent drive pick (disk-cache.go:534 hashIndex)."""
        h = int.from_bytes(
            hashlib.sha256(f"{bucket}/{key}".encode()).digest()[:8],
            "big",
        )
        return self.drives[h % len(self.drives)]

    # -- reads ------------------------------------------------------------

    def get_object(
        self, bucket, object_name, writer, offset=0, length=-1,
        version_id="", sse=None,
    ):
        if version_id or sse is not None:
            return self._ol.get_object(
                bucket, object_name, writer, offset, length,
                version_id, sse,
            )
        drive = self._drive(bucket, object_name)
        # backend metadata is the source of truth; a cached entry with
        # a stale etag is invalid (DecryptObjectInfo-less path of
        # cacheObjects.GetObjectNInfo)
        info = self._ol.get_object_info(bucket, object_name)
        # the same range validation the backend performs: cached and
        # uncached objects must answer identically (InvalidRange, not
        # a silently short body)
        logical = info.size
        if offset < 0 or (
            length >= 0 and offset + length > logical
        ) or offset > logical:
            from .api import InvalidRange

            raise InvalidRange(f"{offset}+{length} of {logical}")
        hit = drive.get(bucket, object_name)
        if hit is not None and hit[1].get("etag") == info.etag:
            self.hits += 1
            path, meta = hit
            total = meta.get("size", info.size)
            want = length if length >= 0 else total - offset
            with open(path, "rb") as f:
                f.seek(offset)
                remaining = want
                while remaining > 0:
                    chunk = f.read(min(1 << 20, remaining))
                    if not chunk:
                        break
                    writer.write(chunk)
                    remaining -= len(chunk)
            return info
        self.misses += 1
        if offset == 0 and (length < 0 or length >= info.size):
            # full read: tee into the cache while serving
            import tempfile

            tmp = tempfile.NamedTemporaryFile(
                dir=drive.root, delete=False
            )
            try:
                tee = _Tee(writer, tmp)
                out = self._ol.get_object(
                    bucket, object_name, tee, 0, -1
                )
                tmp.close()
                drive.put(
                    bucket, object_name, tmp.name,
                    {"etag": info.etag},
                )
                return out
            except BaseException:
                tmp.close()
                try:
                    os.remove(tmp.name)
                except OSError:
                    pass
                raise
        return self._ol.get_object(
            bucket, object_name, writer, offset, length
        )

    # -- writes invalidate ------------------------------------------------

    def put_object(self, bucket, object_name, *a, **kw):
        self._drive(bucket, object_name).invalidate(bucket, object_name)
        return self._ol.put_object(bucket, object_name, *a, **kw)

    def delete_object(self, bucket, object_name, *a, **kw):
        self._drive(bucket, object_name).invalidate(bucket, object_name)
        return self._ol.delete_object(bucket, object_name, *a, **kw)

    def copy_object(
        self, src_bucket, src_object, dst_bucket, dst_object, *a, **kw
    ):
        self._drive(dst_bucket, dst_object).invalidate(
            dst_bucket, dst_object
        )
        return self._ol.copy_object(
            src_bucket, src_object, dst_bucket, dst_object, *a, **kw
        )

    def complete_multipart_upload(self, bucket, object_name, *a, **kw):
        self._drive(bucket, object_name).invalidate(bucket, object_name)
        return self._ol.complete_multipart_upload(
            bucket, object_name, *a, **kw
        )

    def update_object_meta(self, bucket, object_name, *a, **kw):
        # metadata rides the backend; cached data stays valid (same
        # etag) so no invalidation needed - but tags/retention changes
        # do not flow into cached meta, which only holds the etag
        return self._ol.update_object_meta(bucket, object_name, *a, **kw)

    def cache_stats(self) -> dict:
        return {
            "hits": self.hits,
            "misses": self.misses,
            "drives": [
                {"root": d.root, "used": d.used, "quota": d.quota}
                for d in self.drives
            ],
        }

    def __getattr__(self, name):
        return getattr(self._ol, name)


class _Tee:
    def __init__(self, a, b):
        self._a, self._b = a, b

    def write(self, data):
        self._a.write(data)
        self._b.write(data)


def cache_from_env(backend):
    """Wrap per MINIO_TPU_CACHE_DRIVES / MINIO_TPU_CACHE_QUOTA_MB."""
    drives = [
        d.strip()
        for d in os.environ.get("MINIO_TPU_CACHE_DRIVES", "").split(",")
        if d.strip()
    ]
    if not drives:
        return backend
    try:
        quota_mb = int(os.environ.get("MINIO_TPU_CACHE_QUOTA_MB") or 0)
    except ValueError:
        quota_mb = 0
    return CacheObjectLayer(backend, drives, quota_mb << 20)
