"""EventNotifier: rules + targets + async dispatch
(cmd/notification.go NotificationSys front half +
pkg/event/targetlist.go send loop).

The S3 request path only constructs the event and enqueues it; a
dispatch thread matches rules and drives targets, so a slow webhook
never stalls a PUT (the reference's per-target async queues,
pkg/event/targetlist.go:155).  Delivery is at-most-once with bounded
buffering - the queue drops the oldest events past ``maxlen`` exactly
like the reference's store-less targets drop on a full channel.
"""

from __future__ import annotations

import collections
import itertools
import threading
import time

from .event import Event
from .rules import NotificationConfig, RulesMap

from ..utils.log import kv, logger

_log = logger("event")

_QUEUE_MAX = 10_000


class EventNotifier:
    def __init__(self, targets: "list | None" = None):
        self.rules = RulesMap()
        self._targets: "dict[str, object]" = {}
        for t in targets or []:
            self.register_target(t)
        self._queue: "collections.deque" = collections.deque(
            maxlen=_QUEUE_MAX
        )
        # live listeners (ListenBucketNotification): every event
        # fans out here regardless of configured bucket rules.  The
        # subscription is SCOPED per bucket so one watcher does not
        # de-optimize the fast path for every other bucket
        from ..utils.pubsub import PubSub

        self.listeners = PubSub(maxlen=1000)
        self._listener_mu = threading.Lock()
        self._listener_counts: "dict[str, int]" = {}
        self._wake = threading.Event()
        self._stop = threading.Event()
        self._seq = itertools.count(1)
        self._thread: "threading.Thread | None" = None

    # -- configuration ----------------------------------------------------

    def register_target(self, target) -> None:
        self._targets[target.arn] = target

    @property
    def known_arns(self) -> "set[str]":
        return set(self._targets)

    def set_bucket_config(
        self, bucket: str, config: NotificationConfig
    ) -> None:
        config.validate(self.known_arns)
        self.rules.set(bucket, config)

    def load_bucket_config(self, bucket: str, raw_xml: str) -> None:
        """Rebuild rules from a persisted document (boot / peer
        invalidation path); unknown ARNs are tolerated here - the
        target may exist on the node that stored the config."""
        cfg = NotificationConfig.from_xml(raw_xml.encode())
        self.rules.set(bucket, cfg)

    def remove_bucket(self, bucket: str) -> None:
        self.rules.remove(bucket)

    # -- dispatch ---------------------------------------------------------

    def start(self) -> "EventNotifier":
        if self._thread is None:
            self._thread = threading.Thread(
                target=self._run, daemon=True, name="event-notifier"
            )
            self._thread.start()
        return self

    def shutdown(self) -> None:
        self._stop.set()
        self._wake.set()
        if self._thread is not None:
            self._thread.join(timeout=5)

    def subscribe_listener(self, bucket: str):
        """Live subscription for one bucket's events."""
        sub = self.listeners.subscribe()
        with self._listener_mu:
            self._listener_counts[bucket] = (
                self._listener_counts.get(bucket, 0) + 1
            )
        return sub

    def unsubscribe_listener(self, bucket: str, sub) -> None:
        self.listeners.unsubscribe(sub)
        with self._listener_mu:
            n = self._listener_counts.get(bucket, 0) - 1
            if n > 0:
                self._listener_counts[bucket] = n
            else:
                self._listener_counts.pop(bucket, None)

    def has_listeners(self, bucket: str) -> bool:
        with self._listener_mu:
            return bucket in self._listener_counts

    def send(self, event: Event) -> None:
        """Fast path: O(1) enqueue; rule matching happens off-thread."""
        if not self.rules.has_rules(event.bucket) and not (
            self.has_listeners(event.bucket)
        ):
            return
        if not event.sequencer:
            event.sequencer = f"{next(self._seq):016X}"
        if not event.time_ns:
            event.time_ns = time.time_ns()
        self._queue.append(event)
        self._wake.set()

    def flush(self, timeout_s: float = 5.0) -> bool:
        """Block until the queue drains (tests / graceful shutdown)."""
        deadline = time.monotonic() + timeout_s
        while self._queue and time.monotonic() < deadline:
            time.sleep(0.01)
        return not self._queue

    def _run(self) -> None:
        while not self._stop.is_set():
            if not self._queue:
                self._wake.wait(timeout=0.5)
                self._wake.clear()
                continue
            try:
                ev = self._queue.popleft()
            except IndexError:
                continue
            self._dispatch(ev)

    def _dispatch(self, ev: Event) -> None:
        if self.has_listeners(ev.bucket):
            self.listeners.publish(ev)
        arns = self.rules.match(ev.bucket, ev.name, ev.object_key)
        if not arns:
            return
        record = {"EventName": ev.name, "Key": f"{ev.bucket}/{ev.object_key}",
                  "Records": [ev.to_record()]}
        for arn in arns:
            target = self._targets.get(arn)
            if target is None:
                continue
            try:
                target.send(record)
            except Exception as exc:
                _log.debug("event target send failed; at-most-once drop", extra=kv(err=str(exc)))
