"""Request stage spans: where one request's wall time goes.

The request plane opens a record for each request it routes (``begin``),
the layers below add the seconds of their stages to the calling thread's
record (``add``, ``span``), and the plane closes it (``end``) into a ring
of the last ``RING`` records, which the admin ``request-stages`` route
returns and clears.  A stage run on another thread (a read-ahead, a lock
call) is charged by the request thread that waits for it; the decode's
stages sum the seconds of the shard reads it ran at once, so the stages
can add up to more than the request's wall time.

Stages:

- ``queue``: the async plane's hand-off, from the parsed head to a
  worker starting the handler;
- ``lock`` / ``unlock``: the namespace lock's acquire and release (dsync
  quorum calls in a cluster);
- ``meta``: ``xl.meta`` quorum reads;
- ``open``: opening the shard streams (storage REST calls for remote
  drives);
- ``shard_reads``, ``verify``, ``assemble``: the erasure decode's
  ``disk``, ``codec`` (K2 and its synchronisation) and ``assemble``
  stages;
- ``write``: response bytes handed to the loop, headers included.

A record holds the request's method, path (internode calls by their
plane and method), request id, wall start, handler seconds (``total``)
and the stages; what the stages leave of ``total`` is the handler's
own work.  Recording costs a thread-local lookup and a dict update a
stage.  ``thread_cpu`` gives each thread's CPU seconds, so a reader
that takes it around a window sees which threads held the CPU then.
"""

from __future__ import annotations

import collections
import contextlib
import threading
import time

RING = 4096

_tls = threading.local()
_mu = threading.Lock()
_ring: "collections.deque[dict]" = collections.deque(maxlen=RING)


def begin(enqueued: "float | None" = None) -> dict:
    """Open this thread's record; ``enqueued`` is the monotonic time the
    plane queued the request (its wait counts as ``queue``)."""
    now = time.monotonic()
    rec = {"t": time.time(), "t0": now, "stages": {}}
    if enqueued is not None:
        rec["stages"]["queue"] = now - enqueued
    _tls.rec = rec
    return rec


def note(**fields) -> None:
    rec = getattr(_tls, "rec", None)
    if rec is not None:
        rec.update(fields)


def add(stage: str, seconds: float) -> None:
    rec = getattr(_tls, "rec", None)
    if rec is not None:
        st = rec["stages"]
        st[stage] = st.get(stage, 0.0) + seconds


@contextlib.contextmanager
def span(stage: str):
    t0 = time.monotonic()
    try:
        yield
    finally:
        add(stage, time.monotonic() - t0)


def end(rec: dict) -> None:
    """Close ``rec`` into the ring."""
    if getattr(_tls, "rec", None) is rec:
        _tls.rec = None
    rec["total"] = time.monotonic() - rec.pop("t0")
    with _mu:
        _ring.append(rec)


def drain() -> "list[dict]":
    """The records closed since the last drain, oldest first."""
    with _mu:
        out = list(_ring)
        _ring.clear()
    return out


def thread_cpu() -> "list[dict]":
    """CPU seconds of each of this process's threads so far, from
    /proc (Linux): a Python thread by its name, any other (the CUDA
    runtime's, OpenMP's) by its command name."""
    import os

    names = {t.native_id: t.name for t in threading.enumerate()}
    tick = os.sysconf("SC_CLK_TCK")
    out = []
    try:
        tids = os.listdir("/proc/self/task")
    except OSError:
        return out
    for tid in tids:
        try:
            with open(f"/proc/self/task/{tid}/stat") as f:
                raw = f.read()
        except OSError:
            continue
        comm = raw[raw.index("(") + 1:raw.rindex(")")]
        fields = raw[raw.rindex(")") + 2:].split()
        cpu = (int(fields[11]) + int(fields[12])) / tick
        out.append({"tid": int(tid),
                    "name": names.get(int(tid), f"native:{comm}"),
                    "cpu_s": cpu})
    return out
