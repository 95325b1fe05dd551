"""Bounded in-process byte pipe (io.Pipe analogue).

Connects a push-style producer (get_object writing into a sink) to a
pull-style consumer (put_object reading from a source) across two
threads with bounded memory - the streaming-copy primitive
(CopyObject pipes GetObject into PutObject in the reference without
materializing the object).
"""

from __future__ import annotations

import queue
import threading

_EOF = object()
CHUNK = 1 << 20


class PipeClosed(OSError):
    pass


class StreamPipe:
    """One writer thread, one reader thread, bounded chunk queue."""

    def __init__(self, depth: int = 4):
        self._q: "queue.Queue" = queue.Queue(maxsize=depth)
        self._buf = b""
        self._eof = False
        self._err: "BaseException | None" = None
        self._closed_read = threading.Event()

    # -- writer side ------------------------------------------------------

    def write(self, data: bytes) -> int:
        if self._closed_read.is_set():
            raise PipeClosed("read side closed")
        view = memoryview(data)
        for off in range(0, len(view), CHUNK):
            chunk = bytes(view[off : off + CHUNK])
            while True:
                if self._closed_read.is_set():
                    raise PipeClosed("read side closed")
                try:
                    self._q.put(chunk, timeout=0.25)
                    break
                except queue.Full:
                    continue
        return len(data)

    def close_write(self, error: "BaseException | None" = None) -> None:
        """Signal EOF (or a producer error, re-raised to the reader)."""
        self._err = error
        while True:
            if self._closed_read.is_set():
                return
            try:
                self._q.put(_EOF, timeout=0.25)
                return
            except queue.Full:
                continue

    # -- reader side ------------------------------------------------------

    def read(self, n: int = -1) -> bytes:
        out = bytearray()
        while n < 0 or len(out) < n:
            if self._buf:
                take = len(self._buf) if n < 0 else n - len(out)
                out += self._buf[:take]
                self._buf = self._buf[take:]
                continue
            if self._eof:
                break
            item = self._q.get()
            if item is _EOF:
                self._eof = True
                if self._err is not None:
                    raise OSError(
                        f"pipe producer failed: {self._err}"
                    ) from self._err
                break
            self._buf = item
        return bytes(out)

    def close_read(self) -> None:
        """Abandon the stream; unblocks a producer stuck on a full pipe."""
        self._closed_read.set()
        # drain so a producer blocked in put() exits promptly
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass


def streaming_copy(producer, consumer):
    """Run ``producer(sink)`` in a thread while ``consumer(source)``
    runs inline; returns the consumer's result.  Producer errors
    surface to the consumer as a short/failed read; consumer errors
    unblock and cancel the producer."""
    pipe = StreamPipe()

    def run():
        try:
            producer(pipe)
        except BaseException as e:  # noqa: BLE001
            pipe.close_write(e)
        else:
            pipe.close_write()

    t = threading.Thread(target=run, name="stream-copy", daemon=True)
    t.start()
    try:
        return consumer(pipe)
    finally:
        pipe.close_read()
        t.join(timeout=30)
