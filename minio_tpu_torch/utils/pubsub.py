"""In-process pub/sub with bounded subscriber queues (pkg/pubsub).

Publishers never block: a slow subscriber drops its oldest entries
(the reference's non-blocking Publish with buffered channels).
"""

from __future__ import annotations

import collections
import threading


class PubSub:
    def __init__(self, maxlen: int = 10_000):
        self._mu = threading.Lock()
        self._subs: "list[_Sub]" = []
        self._maxlen = maxlen

    def publish(self, item) -> None:
        with self._mu:
            subs = list(self._subs)
        for s in subs:
            s._push(item)

    def subscribe(self) -> "_Sub":
        s = _Sub(self, self._maxlen)
        with self._mu:
            self._subs.append(s)
        return s

    def unsubscribe(self, sub: "_Sub") -> None:
        with self._mu:
            try:
                self._subs.remove(sub)
            except ValueError:
                pass

    @property
    def num_subscribers(self) -> int:
        with self._mu:
            return len(self._subs)


class _Sub:
    def __init__(self, ps: PubSub, maxlen: int):
        self._ps = ps
        self._mu = threading.Lock()
        self._cv = threading.Condition(self._mu)
        self._q: collections.deque = collections.deque(maxlen=maxlen)

    def _push(self, item) -> None:
        with self._cv:
            self._q.append(item)
            self._cv.notify()

    def get(self, timeout: "float | None" = None):
        """Next item or None on timeout."""
        with self._cv:
            if not self._q and not self._cv.wait(timeout):
                return None
            if not self._q:
                return None
            return self._q.popleft()

    def drain(self) -> list:
        with self._cv:
            out = list(self._q)
            self._q.clear()
            return out

    def close(self) -> None:
        self._ps.unsubscribe(self)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
