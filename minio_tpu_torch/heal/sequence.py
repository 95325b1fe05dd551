"""Resumable heal sequences with client tokens
(cmd/admin-heal-ops.go).

A heal *sequence* is a background namespace walk healing every object
under ``bucket/prefix``.  Launching one returns a ``client_token``;
the client then polls with that token and receives the result items
accumulated since its last poll (PopHealStatusJSON semantics,
admin-heal-ops.go:266) - the sequence survives between polls, a
disconnected client resumes by token, and a crashed client's
sequence is garbage-collected ``KEEP_ENDED_S`` after it ends.

Differences from the reference, deliberate: sequence state is
in-memory per node (the reference's is too); the walk drives the
object layer's ``list_objects``/``heal_object`` instead of a raw disk
walk, so REST-remote disks and zones come along for free.  Each
``heal_object`` of a damaged object runs the codec's heal kernels on
the object layer's device (the verify-and-reconstruct read, then the
re-encode of the rebuilt shards).
"""

from __future__ import annotations

import threading
import time
import uuid

# ended sequences stay queryable this long (keepHealSeqStateDuration)
KEEP_ENDED_S = 600.0
# per-sequence cap of unpopped result items: a client that stops
# polling must not grow memory without bound
MAX_UNPOPPED = 10000


class HealSequenceError(Exception):
    def __init__(self, code: str, msg: str):
        super().__init__(msg)
        self.code = code


class HealSequence:
    def __init__(self, object_layer, bucket: str, prefix: str = "",
                 dry_run: bool = False, remove_corrupted: bool = False,
                 client_address: str = ""):
        self._ol = object_layer
        self.bucket = bucket
        self.prefix = prefix
        self.dry_run = dry_run
        self.remove_corrupted = remove_corrupted
        self.client_token = uuid.uuid4().hex
        self.client_address = client_address
        self.start_time = time.time()
        self.end_time = 0.0
        self.status = "running"  # running|finished|stopped|failed
        self.failure = ""
        self.current_path = ""  # resume/progress marker
        self.scanned = 0
        self.healed = 0
        self.failed = 0
        self._items: list = []
        self._mu = threading.Lock()
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._run, daemon=True,
            name=f"heal-seq-{bucket}/{prefix}",
        )

    @property
    def path(self) -> str:
        return f"{self.bucket}/{self.prefix}".rstrip("/")

    def start(self) -> "HealSequence":
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()

    def has_ended(self) -> bool:
        return self.status != "running"

    # -- the walk ---------------------------------------------------------

    def _record(self, item: dict) -> None:
        with self._mu:
            if len(self._items) < MAX_UNPOPPED:
                self._items.append(item)

    def _run(self) -> None:
        try:
            self._heal_bucket()
            marker = ""
            while not self._stop.is_set():
                res = self._ol.list_objects(
                    self.bucket, self.prefix, marker, "", 1000
                )
                for oi in res.objects:
                    if self._stop.is_set():
                        break
                    self._heal_one(oi.name)
                if self._stop.is_set() or not res.is_truncated:
                    break
                marker = res.next_marker
            self.status = (
                "stopped" if self._stop.is_set() else "finished"
            )
        except Exception as e:  # noqa: BLE001
            self.status = "failed"
            self.failure = f"{type(e).__name__}: {e}"
        finally:
            self.end_time = time.time()

    def _heal_bucket(self) -> None:
        try:
            res = self._ol.heal_bucket(
                self.bucket, dry_run=self.dry_run
            )
            self._record(
                {
                    "type": "bucket",
                    "bucket": self.bucket,
                    "detail": res,
                }
            )
        except Exception as e:  # noqa: BLE001
            self._record(
                {
                    "type": "bucket",
                    "bucket": self.bucket,
                    "error": str(e),
                }
            )

    def _heal_one(self, name: str) -> None:
        self.current_path = f"{self.bucket}/{name}"
        self.scanned += 1
        try:
            res = self._ol.heal_object(
                self.bucket, name, dry_run=self.dry_run
            )
        except Exception as e:  # noqa: BLE001
            self.failed += 1
            self._record(
                {
                    "type": "object",
                    "bucket": self.bucket,
                    "object": name,
                    "error": str(e),
                }
            )
            return
        if res.get("healed") or (
            self.dry_run and res.get("outdated")
        ):
            self.healed += 1
            self._record(
                {"type": "object", **res}
            )

    # -- status polling ---------------------------------------------------

    def pop_status(self) -> dict:
        """Status document + result items accumulated since the last
        poll (the reference pops items per status call)."""
        with self._mu:
            items, self._items = self._items, []
        return {
            "client_token": self.client_token,
            "start_time": self.start_time,
            "status": self.status,
            **({"failure": self.failure} if self.failure else {}),
            "current_path": self.current_path,
            "scanned": self.scanned,
            "healed": self.healed,
            "failed": self.failed,
            "items": items,
        }


class AllHealState:
    """Registry of running/recent heal sequences
    (allHealState, admin-heal-ops.go:103)."""

    def __init__(self):
        self._mu = threading.Lock()
        self._seqs: "dict[str, HealSequence]" = {}

    def _gc_locked(self) -> None:
        now = time.time()
        for p in [
            p
            for p, s in self._seqs.items()
            if s.has_ended() and now - s.end_time > KEEP_ENDED_S
        ]:
            del self._seqs[p]

    def launch(self, seq: HealSequence,
               force_start: bool = False) -> dict:
        # force-start first drains the old walker OUTSIDE the registry
        # lock (a join under _mu would stall every status poll for up
        # to the join timeout), then registers the replacement; if the
        # old walker is wedged past the timeout, proceed anyway - it
        # has been stopped and exits at its next object boundary
        old = None
        with self._mu:
            existing = self._seqs.get(seq.path)
            if existing is not None and not existing.has_ended():
                if not force_start:
                    raise HealSequenceError(
                        "HealAlreadyRunning",
                        "Heal is already running on the given path "
                        "(use force-start to stop and start afresh); "
                        f"token is {existing.client_token}",
                    )
                existing.stop()
                old = existing
        if old is not None:
            old._thread.join(timeout=30)
        with self._mu:
            self._gc_locked()
            current = self._seqs.get(seq.path)
            if (
                current is not None
                and current is not old
                and not current.has_ended()
            ):
                # a concurrent launch won the race while we drained
                raise HealSequenceError(
                    "HealAlreadyRunning",
                    "Heal is already running on the given path; "
                    f"token is {current.client_token}",
                )
            # overlap guard: a parent and child path healing
            # concurrently would double-heal and race renames
            for p, s in self._seqs.items():
                if s.has_ended() or p == seq.path:
                    continue
                # '/'-boundary aware: 'bkt' overlaps 'bkt/a' but NOT
                # the sibling bucket 'bkt2'
                if p.startswith(seq.path + "/") or seq.path.startswith(
                    p + "/"
                ):
                    raise HealSequenceError(
                        "HealOverlappingPaths",
                        f"heal sequence overlaps with running path {p}",
                    )
            self._seqs[seq.path] = seq
        seq.start()
        return {
            "client_token": seq.client_token,
            "client_address": seq.client_address,
            "start_time": seq.start_time,
        }

    def pop_status(self, path: str, client_token: str) -> dict:
        with self._mu:
            seq = self._seqs.get(path.rstrip("/"))
        if seq is None:
            raise HealSequenceError(
                "HealNoSuchProcess",
                f"no heal sequence on {path!r}",
            )
        if client_token != seq.client_token:
            raise HealSequenceError(
                "HealInvalidClientToken",
                "client token mismatch",
            )
        return seq.pop_status()

    def stop(self, path: str) -> dict:
        with self._mu:
            seq = self._seqs.get(path.rstrip("/"))
        if seq is None:
            raise HealSequenceError(
                "HealNoSuchProcess",
                f"no heal sequence on {path!r}",
            )
        seq.stop()
        return {"status": "stopping", "client_token": seq.client_token}
