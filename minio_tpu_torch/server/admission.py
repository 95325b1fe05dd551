"""Server-plane admission control + telemetry.

The async request plane sheds load *before* a request reaches the
handler pool and the codec queues (the reference's maxClients +
per-tenant throttles, cmd/handler-api.go): an overloaded stage answers
503 SlowDown instead of queueing unboundedly.  Three shed reasons:

``queue``
    The bounded handler backlog is full (or the global admission slot
    timed out in the threaded plane).
``tenant``
    The claimed access key already holds its per-tenant inflight cap
    (``MINIO_TPU_TENANT_MAX_INFLIGHT``; 0 = unlimited).  The key is
    parsed from the Authorization header *unverified* — it gates
    fairness, never privilege: SigV4 verification still happens on the
    handler path exactly as before.  Keys unknown to the IAM subsystem
    share one bucket so garbage cannot mint unbounded counters.
``quota``
    A PUT whose declared Content-Length would overflow the bucket's
    hard quota per the crawler's usage snapshot; without a crawler, or
    before its first sweep of the bucket, nothing is shed here and the
    handler's own quota check answers.

``PlaneStats`` is the shared observability surface for both server
modes: inflight gauge, per-stage queue depths, shed counters.  It is
sampled by the Prometheus exposition (server/metrics.py) and by admin
healthinfo.

Multi-loop plane (the async plane, server/aio.py): with
``MINIO_TPU_SERVER_LOOPS=N`` the async plane runs N shared-nothing
event loops, so admission state splits in two:

``SharedBudget`` / ``TokenCounter``
    The *global* shed decisions (per-tenant inflight caps, the select
    class cap) must hold across loops, but a cross-loop mutex on every
    admit would serialise the exact path the loops exist to parallelise.
    ``TokenCounter`` is lock-free: it builds an atomic bounded counter
    out of CPython's ``list.append``/``list.pop`` (single C-level
    bytecode ops, atomic under the GIL — the same property
    ``queue.SimpleQueue`` leans on).  ``try_acquire`` optimistically
    appends a reservation token, re-reads the length, and undoes the
    append when over the cap.  The invariant is one-sided by design:
    admitted holders can never exceed the cap (any thread that passed
    the check observed its own token plus every admitted-and-unreleased
    holder's token), while a racing burst may *over-shed* a request
    that would have fit — 503 SlowDown is retryable by contract, so
    shedding conservatively is the safe direction.

``LoopStats``
    Per-loop telemetry cell.  Shed counters are single-writer (only the
    owning loop thread sheds loop-side), the inflight gauge uses the
    same atomic-list trick because a loop's worker threads enter/leave
    it.  No locks anywhere on the per-request path; the ``PlaneStats``
    mutex only guards the threaded-oracle aggregate path and scrape-time
    registration.
"""

from __future__ import annotations

import os
import re
import threading

from ..utils.log import kv, logger

_log = logger("admission")

SHED_REASONS = ("queue", "quota", "tenant", "select")

# Authorization: AWS4-HMAC-SHA256 Credential=AK/date/region/..., ...
_CRED_RE = re.compile(r"Credential=([^/,\s]+)/")


def _env_int(name: str, default: int) -> int:
    try:
        return int(os.environ.get(name) or default)
    except ValueError:
        return default


class TokenCounter:
    """Lock-free bounded counter (atomic under the GIL, no mutex).

    ``_res`` holds reservation tokens: ``try_acquire`` appends one,
    re-reads ``len`` and pops its token back off when the cap is
    exceeded (the popped element may be another thread's token — the
    tokens are indistinguishable, only the multiset count matters, and
    every actor's pops are matched one-to-one to its own appends).
    ``_adm`` holds one token per *admitted* holder, so ``value()`` and
    the ``hwm`` high-water mark count real admissions, untainted by
    transient reservations from racing losers.

    Cap proof: suppose ``limit + 1`` holders were admitted
    concurrently.  The last one to pass the check did so while its own
    reservation token and those of the other ``limit``
    admitted-and-unreleased holders were all in ``_res`` (appends
    happen before checks, pops only on failure/release), so it read
    ``len(_res) >= limit + 1`` and cannot have passed.  The converse
    direction is deliberately weak: extra transient tokens can fail a
    request that would have fit.  Over-shedding is safe (503 SlowDown
    is retryable); over-admitting is not.
    """

    __slots__ = ("_res", "_adm", "hwm")

    def __init__(self):
        self._res: "list[None]" = []
        self._adm: "list[None]" = []
        # benign-race max (may under-record a transient peak, never
        # invents one): hwm <= cap is the bench's exactness witness
        self.hwm = 0

    def try_acquire(self, limit: int) -> bool:
        """Take a slot against ``limit`` (0 or negative = unlimited)."""
        res = self._res
        res.append(None)
        if 0 < limit < len(res):
            try:
                res.pop()
            except IndexError:  # pragma: no cover - matched pops only
                pass
            return False
        self._adm.append(None)
        n = len(self._adm)
        if n > self.hwm:
            self.hwm = n
        return True

    def release(self) -> None:
        try:
            self._adm.pop()
            self._res.pop()
        except IndexError:  # pragma: no cover - unmatched release
            pass

    def value(self) -> int:
        return len(self._adm)


class SharedBudget:
    """Global admission budget shared by every server loop.

    One ``TokenCounter`` per tenant plus one for the select/scan class;
    the tenant map grows only by ``dict.setdefault`` (atomic), and
    ``tenant_of`` collapses unknown access keys into "anon" so the map
    is bounded by the real IAM keyset.  Contains no locks — the
    lockorder auditor asserts as much.
    """

    __slots__ = ("_tenants", "select")

    def __init__(self):
        self._tenants: "dict[str, TokenCounter]" = {}
        self.select = TokenCounter()

    def tenant(self, name: str) -> TokenCounter:
        c = self._tenants.get(name)
        if c is None:
            c = self._tenants.setdefault(name, TokenCounter())
        return c

    def tenant_values(self) -> "dict[str, int]":
        out = {}
        for name, c in list(self._tenants.items()):
            n = c.value()
            if n > 0:
                out[name] = n
        return out

    def tenant_hwm(self) -> "dict[str, int]":
        return {
            name: c.hwm for name, c in list(self._tenants.items())
        }


class LoopStats:
    """One event loop's plane counters — no locks by construction.

    The shed dict is single-writer (only the owning loop thread sheds
    loop-side); the inflight gauge uses the atomic-list trick because
    the loop's *worker* threads call enter/leave from route().
    """

    __slots__ = ("index", "_inflight", "shed", "_depth_fns", "state")

    def __init__(self, index: int):
        self.index = index
        self._inflight: "list[None]" = []
        self.shed = {r: 0 for r in SHED_REASONS}
        self._depth_fns: "dict[str, object]" = {}
        self.state = "booting"

    def enter(self) -> None:
        self._inflight.append(None)

    def leave(self) -> None:
        try:
            self._inflight.pop()
        except IndexError:  # pragma: no cover - unmatched leave
            pass

    def inflight(self) -> int:
        return len(self._inflight)

    def shed_inc(self, reason: str) -> None:
        self.shed[reason] = self.shed.get(reason, 0) + 1

    def register_stage(self, stage: str, depth_fn) -> None:
        self._depth_fns[stage] = depth_fn

    def snapshot(self) -> dict:
        depths = {}
        for stage, fn in dict(self._depth_fns).items():
            try:
                depths[stage] = int(fn())
            except Exception:  # noqa: BLE001 - a gauge must never 500 a scrape
                depths[stage] = 0
        return {
            "loop": self.index,
            "state": self.state,
            "inflight": self.inflight(),
            "shed": dict(self.shed),
            "stage_depth": depths,
        }


class PlaneStats:
    """Thread-safe server-plane counters shared by both server modes.

    The lock guards only the threaded-oracle aggregate counters and
    scrape-time registration; multi-loop traffic lands in per-loop
    ``LoopStats`` cells that are lock-free (see module docstring).
    """

    def __init__(self):
        self._mu = threading.Lock()
        self.inflight = 0
        self.shed = {r: 0 for r in SHED_REASONS}
        # stage -> zero-arg depth sampler; stages register lazily so
        # the threaded plane simply exposes fewer gauges
        self._depth_fns: "dict[str, object]" = {}
        self._loops: "list[LoopStats]" = []

    def add_loop(self) -> LoopStats:
        """Mint the next per-loop stats cell (startup only)."""
        with self._mu:
            cell = LoopStats(len(self._loops))
            self._loops.append(cell)
            return cell

    def loop_cells(self) -> "list[LoopStats]":
        return list(self._loops)

    def enter(self, loop: "int | None" = None) -> None:
        if loop is not None and 0 <= loop < len(self._loops):
            self._loops[loop].enter()
            return
        with self._mu:
            self.inflight += 1

    def leave(self, loop: "int | None" = None) -> None:
        if loop is not None and 0 <= loop < len(self._loops):
            self._loops[loop].leave()
            return
        with self._mu:
            self.inflight = max(0, self.inflight - 1)

    def shed_inc(self, reason: str, loop: "int | None" = None) -> None:
        if loop is not None and 0 <= loop < len(self._loops):
            self._loops[loop].shed_inc(reason)
            return
        with self._mu:
            self.shed[reason] = self.shed.get(reason, 0) + 1

    def register_stage(self, stage: str, depth_fn) -> None:
        with self._mu:
            self._depth_fns[stage] = depth_fn

    def snapshot(self) -> dict:
        """Point-in-time view for metrics/healthinfo rendering.

        ``inflight``/``shed``/``stage_depth`` stay the plane-wide
        aggregates (per-loop cells summed in) so single-loop and
        threaded scrapes are shaped exactly as before; ``loops`` adds
        the per-loop breakdown for the zero-filled ``loop``-labelled
        families.
        """
        with self._mu:
            shed = dict(self.shed)
            inflight = self.inflight
            fns = dict(self._depth_fns)
            cells = list(self._loops)
        depths = {}
        for stage, fn in fns.items():
            try:
                depths[stage] = int(fn())
            except Exception:  # noqa: BLE001 - a gauge must never 500 a scrape
                depths[stage] = 0
        loops = [cell.snapshot() for cell in cells]
        for snap in loops:
            inflight += snap["inflight"]
            for reason, n in snap["shed"].items():
                shed[reason] = shed.get(reason, 0) + n
        return {
            "inflight": inflight,
            "shed": shed,
            "stage_depth": depths,
            "loops": loops,
        }


class AdmissionController:
    """Tenant- and quota-keyed early shed, shared by both planes.

    Stateless apart from the lock-free ``SharedBudget``: every server
    loop (and every threaded-oracle handler thread) admits against the
    same global counters without taking a lock, so the caps stay exact
    across loops while the common admit case costs one uncontended
    per-loop check plus two atomic list ops here.
    """

    def __init__(self, server, stats: PlaneStats):
        self._s3 = server
        self.stats = stats
        self.budget = SharedBudget()

    # -- knobs ------------------------------------------------------------

    def _tenant_max(self) -> int:
        return _env_int("MINIO_TPU_TENANT_MAX_INFLIGHT", 0)

    def _select_max(self) -> int:
        return _env_int("MINIO_TPU_SELECT_MAX_INFLIGHT", 0)

    # -- tenant stage -----------------------------------------------------

    def tenant_of(self, headers) -> str:
        """Fairness key: the *claimed* access key, collapsed to "anon"
        when absent or unknown to IAM (unverified by design — see the
        module docstring)."""
        auth_hdr = headers.get("Authorization") or ""
        m = _CRED_RE.search(auth_hdr)
        if not m:
            return "anon"
        ak = m.group(1)
        try:
            self._s3.iam.lookup_secret(ak)
        except Exception:  # noqa: BLE001 - unknown key, shared bucket
            return "anon"
        return ak

    def try_enter_tenant(self, tenant: str) -> bool:
        """Take a tenant slot; False -> shed 503 reason=tenant."""
        return self.budget.tenant(tenant).try_acquire(self._tenant_max())

    def leave_tenant(self, tenant: str) -> None:
        self.budget.tenant(tenant).release()

    def tenant_inflight(self) -> "dict[str, int]":
        return self.budget.tenant_values()

    # -- select stage -----------------------------------------------------
    #
    # Scans are a second admitted traffic class: one SELECT can pin a
    # device submesh and stream megabytes of filtered rows, so an
    # unbounded scan flood would starve the GET/PUT plane long before
    # the global inflight cap notices.  The cap is its own knob
    # (MINIO_TPU_SELECT_MAX_INFLIGHT; 0 = unlimited) and its sheds get
    # their own reason so the operator can tell scan pressure from
    # queue pressure.

    def try_enter_select(self) -> bool:
        """Take a scan slot; False -> shed 503 reason=select."""
        return self.budget.select.try_acquire(self._select_max())

    def leave_select(self) -> None:
        self.budget.select.release()

    def select_inflight(self) -> int:
        return self.budget.select.value()

    # -- quota stage ------------------------------------------------------

    def quota_rejects_put(self, command: str, path: str, headers) -> bool:
        """True when a PUT's declared size cannot fit the bucket's hard
        quota per the crawler snapshot (enforceBucketQuota's
        dataUsageCache consult) - shed before any body byte is read.

        Deliberately snapshot-only: without a crawler the handler's
        synchronous quota check still runs and keeps its exact error
        code, so this stage can only ever shed earlier, never differ.
        It reads no store either: the async plane calls it on its event
        loop, where a bucket-document read (in a cluster a quorum read
        under a dsync lock) would stall every connection of the loop, the
        internode planes' included.  A bucket whose document is not in
        the metadata cache is not shed here.
        """
        if command != "PUT":
            return False
        bucket = path.lstrip("/").split("/", 1)[0]
        if not bucket:
            return False
        try:
            size = int(headers.get("Content-Length") or 0)
        except ValueError:
            return False
        if size <= 0:
            return False
        crawler = getattr(self._s3, "crawler", None)
        if crawler is None:
            return False
        from ..objectlayer import quota as quotamod

        try:
            bu = crawler.usage().buckets.get(bucket)
            if bu is None:
                return False
            bm = self._s3.bucket_meta.cached(bucket)
            cfg = quotamod.parse_config(bm.quota_json) if bm else None
            if cfg is None or cfg.quota_type != "hard":
                return False
            return bu.size + size > cfg.quota
        except Exception as exc:  # noqa: BLE001 - never shed on a broken gauge
            _log.debug(
                "quota precheck failed open", extra=kv(err=str(exc))
            )
            return False
