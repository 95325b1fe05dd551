"""Per-disk storage API instrumentation (cmd/xl-storage-disk-id-check.go).

``MeteredDisk`` wraps any StorageAPI and records, per API endpoint:
call counts, error counts, and cumulative latency, plus a streaming
p50/p99 per API (``P2Quantile`` - the Jain & Chlamtac P² estimator, five
markers, no sample buffer).  The reference keeps the same ledger in its
disk-ID-check decorator (storageMetrics / getMetrics); here metering is
its own layer.

Every observation is forwarded to the disk's ``storage/health.py``
circuit breaker, which is what turns errors into trip decisions:
``health.should_skip`` then masks a tripped disk in the object layer's
``_online_disks``.

``wrap()`` is idempotent and walks existing ``unwrapped`` chains, so
construction sites and the object layer can both call it safely.  The
disk-identity decorator (``DiskIDCheck``) needs ``format.json`` and
comes with the slice that ports the format bootstrap; until then the
only chains are a bare disk or a MeteredDisk over one.
"""

from __future__ import annotations

import threading
import time

from . import errors as serrors

# Errors that are answers, not faults: a disk that promptly says "no
# such object" is healthy.  Only genuine faults (I/O errors, corrupt
# files, unexpected exceptions) feed the circuit breaker's
# consecutive-error ladder.
_BENIGN_ERRORS = (
    serrors.FileNotFound,
    serrors.VersionNotFound,
    serrors.VolumeNotFound,
    serrors.VolumeExists,
    serrors.VolumeNotEmpty,
    serrors.IsNotRegular,
    FileNotFoundError,
)

# the drive-touching surface of the port's StorageAPI (the JAX
# package's DiskIDCheck._CHECKED, restricted to it: the same ledger keys)
_METERED = frozenset(
    {
        "make_vol", "list_vols", "stat_vol", "delete_vol",
        "list_dir", "read_all", "write_all", "delete_file",
        "rename_file", "stat_file", "create_file", "walk", "walk_sorted",
        "read_file_stream", "read_version", "read_xl", "write_metadata",
        "update_metadata", "delete_version", "rename_data", "verify_file",
    }
)


class P2Quantile:
    """Streaming quantile estimator (Jain & Chlamtac's P² algorithm).

    Five markers track the running q-quantile in O(1) memory — no
    sample buffer, so a disk that serves millions of reads costs the
    same 5 floats as one that served fifty.  Not thread-safe; callers
    hold their own lock (MeteredDisk._stats_mu / DiskHealth._mu).
    """

    __slots__ = ("q", "count", "_h", "_pos", "_want", "_inc")

    def __init__(self, q: float):
        self.q = float(q)
        self.count = 0
        self._h: "list[float]" = []  # first 5 raw samples, then heights
        self._pos = [0.0, 1.0, 2.0, 3.0, 4.0]
        self._want = [0.0, 2 * q, 4 * q, 2 + 2 * q, 4.0]
        self._inc = [0.0, q / 2, q, (1 + q) / 2, 1.0]

    def observe(self, x: float) -> None:
        self.count += 1
        h = self._h
        if self.count <= 5:
            h.append(float(x))
            if self.count == 5:
                h.sort()
            return
        # locate cell k such that h[k] <= x < h[k+1], clamping extremes
        if x < h[0]:
            h[0] = float(x)
            k = 0
        elif x >= h[4]:
            h[4] = float(x)
            k = 3
        else:
            k = 0
            while k < 3 and not (h[k] <= x < h[k + 1]):
                k += 1
        pos, want = self._pos, self._want
        for i in range(k + 1, 5):
            pos[i] += 1.0
        for i in range(5):
            want[i] += self._inc[i]
        # nudge interior markers toward their desired positions
        for i in (1, 2, 3):
            d = want[i] - pos[i]
            if (d >= 1.0 and pos[i + 1] - pos[i] > 1.0) or (
                d <= -1.0 and pos[i - 1] - pos[i] < -1.0
            ):
                s = 1.0 if d > 0 else -1.0
                cand = self._parabolic(i, s)
                if not (h[i - 1] < cand < h[i + 1]):
                    cand = self._linear(i, s)
                h[i] = cand
                pos[i] += s

    def _parabolic(self, i: int, s: float) -> float:
        h, n = self._h, self._pos
        return h[i] + s / (n[i + 1] - n[i - 1]) * (
            (n[i] - n[i - 1] + s)
            * (h[i + 1] - h[i])
            / (n[i + 1] - n[i])
            + (n[i + 1] - n[i] - s)
            * (h[i] - h[i - 1])
            / (n[i] - n[i - 1])
        )

    def _linear(self, i: int, s: float) -> float:
        h, n = self._h, self._pos
        j = i + int(s)
        return h[i] + s * (h[j] - h[i]) / (n[j] - n[i])

    def value(self) -> "float | None":
        """Current estimate; None before the first observation.

        Below 5 samples the markers aren't live yet — fall back to the
        nearest-rank quantile of the few raw samples so early readers
        (hedge-deadline warmup) get a sane number, not None.
        """
        if self.count == 0:
            return None
        if self.count >= 5:
            return self._h[2]
        xs = sorted(self._h)
        idx = min(len(xs) - 1, int(self.q * len(xs)))
        return xs[idx]


class MeteredDisk:
    """StorageAPI decorator keeping a per-API call/error/latency ledger."""

    def __init__(self, disk):
        self.unwrapped = disk
        self._stats_mu = threading.Lock()
        # api -> [calls, errors, seconds]
        self._stats: "dict[str, list]" = {}
        # api -> (P2Quantile(p50), P2Quantile(p99)); successful calls only
        self._quantiles: "dict[str, tuple]" = {}
        self._health_cache: "tuple | None" = None

    @property
    def health(self):
        """This disk's circuit breaker (storage/health.py DiskHealth).

        Resolved through the live registry and re-fetched when tests
        swap it out with ``health.reset_registry()`` - a cached breaker
        from a dead registry would silently divorce the ledger from the
        GET path's skip/hedge decisions.  Lazy import: health.py imports
        P2Quantile from this module.
        """
        from . import health as _health

        reg = _health.registry()
        cached = self._health_cache
        if cached is not None and cached[0] is reg:
            return cached[1]
        dh = reg.get_disk(self.metered_endpoint())
        self._health_cache = (reg, dh)
        return dh

    def metered_endpoint(self) -> str:
        """Stable disk label for the ledger and the breaker."""
        try:
            return str(self.unwrapped.endpoint())
        except Exception:  # noqa: BLE001
            return str(getattr(self.unwrapped, "root", "?"))

    def api_stats(self) -> "dict[str, dict]":
        """Ledger snapshot: api -> {calls, errors, seconds, p50, p99}."""
        with self._stats_mu:
            out = {}
            for api, (calls, errors, secs) in self._stats.items():
                row = {
                    "calls": calls,
                    "errors": errors,
                    "seconds": round(secs, 6),
                }
                qs = self._quantiles.get(api)
                if qs is not None:
                    p50, p99 = qs[0].value(), qs[1].value()
                    if p50 is not None:
                        row["p50_seconds"] = round(p50, 6)
                    if p99 is not None:
                        row["p99_seconds"] = round(p99, 6)
                out[api] = row
            return out

    def _record(
        self, api: str, seconds: float, exc: "BaseException | None"
    ) -> None:
        with self._stats_mu:
            row = self._stats.setdefault(api, [0, 0, 0.0])
            row[0] += 1
            if exc is not None:
                row[1] += 1
            row[2] += seconds
            if exc is None:
                qs = self._quantiles.get(api)
                if qs is None:
                    qs = (P2Quantile(0.50), P2Quantile(0.99))
                    self._quantiles[api] = qs
                qs[0].observe(seconds)
                qs[1].observe(seconds)
        # breaker notification happens OUTSIDE _stats_mu: DiskHealth has
        # its own lock and must never nest inside the ledger's.  Benign
        # "no such thing" answers count as successes - the disk did its
        # job; only genuine faults climb the consecutive-error ladder.
        self.health.record_api(
            api,
            seconds,
            ok=exc is None or isinstance(exc, _BENIGN_ERRORS),
        )

    def __getattr__(self, name: str):
        attr = getattr(self.unwrapped, name)
        if name in _METERED and callable(attr):
            def wrapped(*a, **k):
                t0 = time.monotonic()
                try:
                    result = attr(*a, **k)
                except BaseException as e:
                    self._record(name, time.monotonic() - t0, e)
                    raise
                self._record(name, time.monotonic() - t0, None)
                return result

            wrapped.__name__ = name
            # cache the bound wrapper: __getattr__ only fires on miss,
            # so the hot path pays the timing closure, not the lookup
            self.__dict__[name] = wrapped
            return wrapped
        return attr


def is_metered(disk) -> bool:
    """True if a MeteredDisk sits anywhere in the wrapper chain.

    Walks ``unwrapped`` links via ``__dict__`` lookups only - going
    through ``getattr`` would trip the wrappers' own ``__getattr__``
    forwarding on the innermost (raw) disk.
    """
    d = disk
    while d is not None:
        if isinstance(d, MeteredDisk):
            return True
        d = d.__dict__.get("unwrapped") if hasattr(d, "__dict__") else None
    return False


def wrap(disk):
    """Meter a disk unless it (or an inner layer) already is; None-safe."""
    if disk is None or is_metered(disk):
        return disk
    return MeteredDisk(disk)
