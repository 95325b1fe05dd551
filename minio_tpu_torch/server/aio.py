"""Asyncio request plane (the default; MINIO_TPU_SERVER=async).

The reference serves thousands of connections on goroutines behind its
custom L7 listener (cmd/http/server.go); a thread-per-request stdlib
server on a GIL cannot do that — at 32 clients every blocked thread
competes for the interpreter and p99 collapses.  This plane runs N
shared-nothing event loops (``MINIO_TPU_SERVER_LOOPS``, default
``min(cores, 4)``), each loop thread owning its sockets, connections,
parser, bridges, and a slice of the bounded worker pool running the
existing synchronous handlers, so concurrency costs a queue slot
instead of a thread:

    accept -> [parse: loop_i] -> [admission: loop_i + shared budget]
    -> [handler: loop_i's pool slice] -> [codec/disk:
    parallel/iopool.py] -> response via loop_i

No cross-loop locks on the hot path: a connection lives and dies on
one loop, and the only cross-loop state a request touches is the
lock-free ``SharedBudget`` (server/admission.py) that keeps tenant and
select caps globally exact.  ``MINIO_TPU_SERVER_LOOPS=1`` is today's
single-loop plane verbatim — the bisection oracle within the async
mode, just as ``MINIO_TPU_SERVER=threaded`` bisects the whole plane.

Listener sharding uses ``SO_REUSEPORT`` where the platform offers it
(each loop gets its own bound socket; the kernel spreads accepts), and
falls back to one listener on loop 0 handing accepted sockets off
round-robin (``MINIO_TPU_SERVER_REUSEPORT=off`` forces the fallback —
useful to exercise it on Linux).

Stage boundaries are explicit queues with backpressure; when the
handler backlog is full the request is shed with 503 SlowDown *before*
any body byte is read (server/admission.py).  The handlers themselves
are unchanged — ``_Handler.route()`` runs on a worker thread over two
thin bridges:

``_LoopReader``
    Blocking file-like over the connection's ``asyncio.StreamReader``.
    Each ``read(n)`` is one ``run_coroutine_threadsafe`` round-trip, so
    a PUT body streams chunk-by-chunk from the loop straight into
    ``HashReader`` -> ``encode_begin`` with bounded memory — the loop
    never holds a full body and the worker never touches the socket.

``_LoopWriter``
    Blocking writes through ``transport.write`` + ``drain()``.  A
    ``memoryview`` passes to the transport unjoined (zero-copy GET: the
    decoded block slices the iopool assembles go to the socket without
    intermediate ``b"".join``); blocking the worker until the loop has
    consumed the buffer makes caller-side buffer reuse safe and gives
    natural per-connection flow control.

Long-lived streaming endpoints (admin trace/console, bucket event
listen) would starve a bounded pool, so they run on dedicated threads.
The threaded plane stays available as the bisection oracle
(``MINIO_TPU_SERVER=threaded``, house style of MINIO_TPU_PARITY_PLANE).

Blocking calls inside ``async def`` bodies here are a correctness bug
(one stalled coroutine stalls every connection *on its loop*); the
bridges above are sync-side by construction.  The fault-injection
wedge (`wedge_loop`, admin ``loops/wedge``) deliberately stalls one
loop with a busy-spin to prove the blast radius stops at the loop
boundary.

On this package's card path the handler workers are the codec
batcher's clients (codec/batcher.py names a client by its thread): a
request runs on one of its loop's pooled workers, and a keep-alive
connection's next request may run on another.  The plane is this
package's default (``MINIO_TPU_SERVER`` unset or ``async``).
"""

from __future__ import annotations

import asyncio
import io
import os
import queue
import socket
import threading
import urllib.parse
import uuid
from http import client as _hclient

from . import s3errors
from . import response as xmlr
from ..utils.log import kv, logger

_log = logger("aio")

# header-block cap, matching the stdlib server's per-line ceiling
_MAX_HEAD = 1 << 16

# listen(2) backlog for sharded/fallback sockets (asyncio's default)
_LISTEN_BACKLOG = 100


def _env_float(name: str, default: float) -> float:
    try:
        return float(os.environ.get(name) or default)
    except ValueError:
        return default


def _env_int(name: str, default: int) -> int:
    try:
        return int(os.environ.get(name) or default)
    except ValueError:
        return default


def _default_workers() -> int:
    """A few blocking-I/O slots per core, capped.  More workers than
    this just interleaves CPU-bound codec work (GIL thrash) and
    inflates p99 without adding throughput."""
    return min(16, max(4, 4 * (os.cpu_count() or 1)))


def _default_loops() -> int:
    """One accept loop per core up to 4: past that the shared budget
    and the disk plane dominate before accept/parse does."""
    return min(os.cpu_count() or 1, 4)


def _loop_count() -> int:
    return max(1, _env_int("MINIO_TPU_SERVER_LOOPS", _default_loops()))


def _reuseport_requested() -> bool:
    val = (os.environ.get("MINIO_TPU_SERVER_REUSEPORT") or "auto").lower()
    return val not in ("off", "0", "false", "no")


def _split(total: int, parts: int) -> "list[int]":
    """Spread ``total`` across ``parts`` slices, each at least 1."""
    base, rem = divmod(max(total, parts), parts)
    return [base + (1 if i < rem else 0) for i in range(parts)]


class _LoopReader:
    """Synchronous file-like over the owning loop's StreamReader, used
    by the handler thread.  Every call blocks the *worker*, never the
    loop.  ``owner`` is the connection's ``_ServerLoop``."""

    def __init__(self, owner: "_ServerLoop", reader: asyncio.StreamReader):
        self._owner = owner
        self._reader = reader

    def _call(self, coro):
        try:
            fut = asyncio.run_coroutine_threadsafe(coro, self._owner.loop)
            return fut.result()
        except asyncio.TimeoutError:
            raise socket.timeout("body read timed out") from None
        except (RuntimeError, ConnectionError, asyncio.CancelledError) as e:
            raise OSError(f"connection lost: {e}") from None

    def read(self, n: int = -1) -> bytes:
        timeout = self._owner.body_timeout

        async def _rd():
            return await asyncio.wait_for(self._reader.read(n), timeout)

        return self._call(_rd())

    def readline(self, limit: int = -1) -> bytes:
        """Bounded line read (internode chunked framing uses 1024)."""
        timeout = self._owner.body_timeout
        reader = self._reader

        async def _rl():
            out = bytearray()
            while limit < 0 or len(out) < limit:
                b = await asyncio.wait_for(reader.read(1), timeout)
                if not b:
                    break
                out += b
                if b == b"\n":
                    break
            return bytes(out)

        return self._call(_rl())


class _LoopWriter:
    """Synchronous writes through the owning loop's transport.

    ``write`` hands the buffer (bytes or memoryview — unjoined) to
    ``transport.write`` on the loop and blocks the worker through
    ``drain()``, so a slow client backpressures its own worker instead
    of growing an unbounded transport buffer."""

    def __init__(self, owner: "_ServerLoop", writer: asyncio.StreamWriter):
        self._owner = owner
        self._writer = writer

    def write(self, data) -> int:
        n = len(data)
        if n == 0:
            return 0
        writer = self._writer

        async def _wr():
            writer.write(data)
            await writer.drain()

        try:
            asyncio.run_coroutine_threadsafe(
                _wr(), self._owner.loop
            ).result()
        except (RuntimeError, ConnectionError, asyncio.CancelledError) as e:
            raise OSError(f"connection lost: {e}") from None
        return n

    def flush(self) -> None:  # writes are already synchronous
        pass


class _WorkerPool:
    """Bounded handler stage: a full backlog means shed, not queue."""

    def __init__(self, workers: int, backlog: int, name: str = "aio"):
        self._q: "queue.Queue" = queue.Queue(maxsize=max(1, backlog))
        self.workers = max(1, workers)
        self._threads = [
            threading.Thread(
                target=self._run, name=f"{name}-worker-{i}", daemon=True
            )
            for i in range(self.workers)
        ]
        for t in self._threads:
            t.start()
        self._streams: "set[threading.Thread]" = set()
        self._streams_mu = threading.Lock()
        self._stream_seq = 0
        self._name = name

    def depth(self) -> int:
        return self._q.qsize()

    def try_submit(self, fn) -> bool:
        try:
            self._q.put_nowait(fn)
            return True
        except queue.Full:
            return False

    def spawn_stream(self, fn) -> None:
        """Long-lived streaming request: dedicated thread so it cannot
        starve the bounded pool (trace/console/listen endpoints)."""
        with self._streams_mu:
            self._stream_seq += 1
            name = f"{self._name}-stream-{self._stream_seq}"
        t = threading.Thread(
            target=self._run_stream, args=(fn,), name=name, daemon=True
        )
        with self._streams_mu:
            self._streams.add(t)
        t.start()

    def _run_stream(self, fn) -> None:
        try:
            fn()
        except Exception as exc:  # noqa: BLE001
            _log.debug("stream handler failed", extra=kv(err=str(exc)))
        finally:
            with self._streams_mu:
                self._streams.discard(threading.current_thread())

    def _run(self) -> None:
        while True:
            fn = self._q.get()
            if fn is None:
                return
            try:
                fn()
            except Exception as exc:  # noqa: BLE001
                _log.debug("handler job failed", extra=kv(err=str(exc)))

    def shutdown(self, timeout: float = 10.0) -> None:
        for _ in self._threads:
            try:
                self._q.put(None, timeout=timeout)
            except queue.Full:
                break
        for t in self._threads:
            t.join(timeout)
        with self._streams_mu:
            streams = list(self._streams)
        for t in streams:
            t.join(timeout)


class _ServerLoop:
    """One shared-nothing event loop: its own thread, listener socket,
    connection set, worker-pool slice, and lock-free stats cell.  A
    connection accepted here never touches another loop."""

    def __init__(self, plane: "AsyncPlane", index: int,
                 workers: int, backlog: int):
        self.plane = plane
        self.s3 = plane.s3
        self.adm = plane.adm
        self.index = index
        self.loop = asyncio.new_event_loop()
        self.header_timeout = plane.header_timeout
        self.body_timeout = plane.body_timeout
        self.idle_timeout = plane.idle_timeout
        self.pool = _WorkerPool(workers, backlog, name=f"aio{index}")
        self.lstats = plane.stats.add_loop()
        self._conns: "set[asyncio.StreamWriter]" = set()
        self._tasks: "set[asyncio.Task]" = set()
        self._srv = None
        self._thread: "threading.Thread | None" = None
        self.lstats.register_stage("parse", lambda: len(self._conns))
        self.lstats.register_stage("handler", self.pool.depth)

    # -- lifecycle --------------------------------------------------------

    @property
    def state(self) -> str:
        return self.lstats.state

    @state.setter
    def state(self, value: str) -> None:
        self.lstats.state = value

    def start_thread(self) -> None:
        self._thread = threading.Thread(
            target=self._run_loop, name=f"aio-loop-{self.index}",
            daemon=True,
        )
        self._thread.start()

    def _run_loop(self) -> None:
        asyncio.set_event_loop(self.loop)
        try:
            self.loop.run_forever()
        finally:
            try:
                self.loop.close()
            except Exception as exc:  # noqa: BLE001
                _log.debug("loop close failed", extra=kv(err=str(exc)))

    def serve(self, host, port, sock, ssl_ctx) -> None:
        """Bring the listener up ON this loop (a bound SO_REUSEPORT
        socket when sharded, host/port for the single-loop plane, or
        no listener at all in handoff mode)."""

        async def _boot():
            if sock is not None:
                return await asyncio.start_server(
                    self._serve_conn, sock=sock, ssl=ssl_ctx,
                    limit=_MAX_HEAD,
                )
            return await asyncio.start_server(
                self._serve_conn, host, port, ssl=ssl_ctx,
                limit=_MAX_HEAD,
            )

        self._srv = asyncio.run_coroutine_threadsafe(
            _boot(), self.loop
        ).result(timeout=30)
        self.state = "serving"

    def mark_serving(self) -> None:
        """Handoff mode: no listener of our own, the acceptor feeds us."""
        self.state = "serving"

    def bound_port(self) -> int:
        return self._srv.sockets[0].getsockname()[1]

    async def _adopt(self, conn: socket.socket, ssl_ctx) -> None:
        """Round-robin handoff target: wrap an already-accepted socket
        in this loop's streams and serve it like a native accept."""
        conn.setblocking(False)
        reader = asyncio.StreamReader(limit=_MAX_HEAD)
        proto = asyncio.StreamReaderProtocol(reader, self._serve_conn)
        try:
            # factory, not instance: one _adopt call wraps one socket
            await self.loop.connect_accepted_socket(
                lambda: proto, conn, ssl=ssl_ctx
            )
        except (OSError, asyncio.CancelledError):
            conn.close()

    def close_listener(self) -> None:
        self.state = "draining"
        if self._srv is not None:
            self.loop.call_soon_threadsafe(self._srv.close)

    def cut_conns(self) -> None:
        """Cut remaining connections while the loop still runs: pending
        bridge reads/writes fail fast and unblock their workers."""

        def _cut():
            for w in list(self._conns):
                try:
                    w.close()
                except Exception as exc:  # noqa: BLE001
                    _log.debug(
                        "transport close failed", extra=kv(err=str(exc))
                    )

        self.loop.call_soon_threadsafe(_cut)

    def drain_tasks(self, drain_s: float) -> None:
        async def _gather():
            tasks = [t for t in self._tasks if not t.done()]
            if tasks:
                await asyncio.wait(tasks, timeout=drain_s + 5.0)

        try:
            asyncio.run_coroutine_threadsafe(
                _gather(), self.loop
            ).result(timeout=drain_s + 10.0)
        except Exception as exc:  # noqa: BLE001
            _log.debug(
                "connection drain incomplete",
                extra=kv(loop=self.index, err=str(exc)),
            )

    def stop_loop(self) -> None:
        self.loop.call_soon_threadsafe(self.loop.stop)
        if self._thread is not None:
            self._thread.join(timeout=10)
        self.state = "stopped"

    def wedge(self, seconds: float) -> None:
        """Fault injection: stall THIS loop's thread with a busy-spin
        so a chaos run can prove the blast radius is one shard.  A
        spin, not a sleep: the point is an unresponsive loop.  The
        spin starts after a short grace so the admin response that
        scheduled it can flush even when its own connection is owned
        by the loop being wedged."""
        import time as _time

        def _spin():
            end = _time.monotonic() + seconds
            while _time.monotonic() < end:
                pass

        self.loop.call_soon_threadsafe(
            lambda: self.loop.call_later(0.2, _spin)
        )

    # -- connection handling ----------------------------------------------

    async def _serve_conn(
        self,
        reader: asyncio.StreamReader,
        writer: asyncio.StreamWriter,
    ) -> None:
        task = asyncio.current_task()
        if task is not None:
            self._tasks.add(task)
        self._conns.add(writer)
        try:
            first = True
            while not self.s3.draining:
                head = await self._read_head(reader, writer, first)
                if head is None:
                    return
                first = False
                if not await self._handle_one(reader, writer, head):
                    return
        except (ConnectionError, asyncio.CancelledError, OSError):
            pass
        finally:
            self._conns.discard(writer)
            if task is not None:
                self._tasks.discard(task)
            try:
                writer.close()
            except Exception as exc:  # noqa: BLE001
                _log.debug(
                    "connection close failed", extra=kv(err=str(exc))
                )

    async def _read_head(self, reader, writer, first: bool):
        """One request head (bytes through the blank line), or None on
        EOF/timeout/oversize.  The header timeout caps the WHOLE head - a
        slow-loris trickling header bytes gets 408, not a held slot.
        Between keep-alive requests the connection may idle for
        ``idle_timeout`` and is then closed without a word: a 408 written
        into an idle connection is read by the client as the answer to
        the next request it sends there."""
        lead = b""
        if not first:
            try:
                lead = await asyncio.wait_for(
                    reader.read(1), self.idle_timeout
                )
            except (asyncio.TimeoutError, ConnectionError, OSError):
                return None
            if not lead:
                return None  # client closed
        try:
            return lead + await asyncio.wait_for(
                reader.readuntil(b"\r\n\r\n"), self.header_timeout
            )
        except asyncio.TimeoutError:
            await self._reject(writer, 408, "RequestTimeout",
                               "request header read timed out")
            return None
        except asyncio.LimitOverrunError:
            await self._reject(writer, 431, "InvalidRequest",
                               "request header block too large")
            return None
        except (asyncio.IncompleteReadError, ConnectionError, OSError):
            return None  # client went away

    async def _handle_one(self, reader, writer, head: bytes) -> bool:
        """Parse + admit + dispatch one request; False ends the
        connection (keep-alive otherwise)."""
        try:
            requestline, command, raw_path, version, headers = (
                _parse_head(head)
            )
        except ValueError as e:
            await self._reject(writer, 400, "InvalidRequest", str(e))
            return False
        parsed = urllib.parse.urlsplit(raw_path)
        upath = urllib.parse.unquote(parsed.path)
        query = urllib.parse.parse_qs(parsed.query, keep_blank_values=True)

        # -- admission stage (loop-side, before any body byte): the
        # per-loop fast path is this block — no locks; the only shared
        # state is the budget's atomic counters -------------------------
        shed_reason = None
        tenant = None
        if self._admitted_path(upath):
            if self.adm.quota_rejects_put(command, upath, headers):
                shed_reason = "quota"
            else:
                tenant = self.adm.tenant_of(headers)
                if not self.adm.try_enter_tenant(tenant):
                    shed_reason, tenant = "tenant", None
        if shed_reason is None and not self._enqueue_ok(
            command, upath, query
        ):
            shed_reason = "queue"
        if shed_reason is not None:
            if tenant is not None:
                self.adm.leave_tenant(tenant)
            self.lstats.shed_inc(shed_reason)
            self.s3.metrics.observe("Shed", 503, 0.0)
            await self._reject(
                writer, 503, "SlowDown",
                "Resource requested is unreadable, please reduce your "
                f"request rate ({shed_reason})",
            )
            return False

        # -- handler stage -------------------------------------------------
        h = self.plane.handler_cls.__new__(self.plane.handler_cls)
        h.command = command
        h.path = raw_path
        h.request_version = version
        h.requestline = requestline
        h.headers = headers
        h.client_address = writer.get_extra_info("peername") or ("", 0)
        h.close_connection = _wants_close(version, headers)
        h.rfile = _LoopReader(self, reader)
        h.wfile = _LoopWriter(self, writer)
        h._plane_admitted = True
        h._loop_index = self.index
        if (
            version >= "HTTP/1.1"
            and (headers.get("Expect") or "").lower() == "100-continue"
        ):
            h._expect_100_req = True

        done = self.loop.create_future()

        def _finish():
            if not done.done():
                done.set_result(None)

        def _work():
            try:
                h.route()
            except Exception as exc:  # noqa: BLE001 - connection-fatal only
                h.close_connection = True
                _log.debug("handler failed", extra=kv(err=str(exc)))
            finally:
                if tenant is not None:
                    self.adm.leave_tenant(tenant)
                self.loop.call_soon_threadsafe(_finish)

        if self._is_streaming(command, upath, query):
            self.pool.spawn_stream(_work)
        else:
            # reserved above by _enqueue_ok probing; enqueue for real
            if not self.pool.try_submit(_work):
                if tenant is not None:
                    self.adm.leave_tenant(tenant)
                self.lstats.shed_inc("queue")
                self.s3.metrics.observe("Shed", 503, 0.0)
                await self._reject(
                    writer, 503, "SlowDown",
                    "Resource requested is unreadable, please reduce "
                    "your request rate (queue)",
                )
                return False
        await done
        return not h.close_connection and not writer.is_closing()

    # -- helpers -----------------------------------------------------------

    def _admitted_path(self, upath: str) -> bool:
        """Paths subject to tenant/quota admission: the S3 plane only —
        internode, health, and metrics endpoints bypass it exactly like
        the global admission slot in route()."""
        for prefix in self.s3.internode:
            if upath.startswith(prefix + "/"):
                return False
        return not upath.startswith(
            ("/minio/health/", "/minio-tpu/prometheus/")
        )

    def _enqueue_ok(self, command: str, upath: str, query) -> bool:
        """Backlog headroom check before taking the tenant slot; the
        real enqueue happens after the shim is built."""
        if self._is_streaming(command, upath, query):
            return True
        return not self.pool._q.full()

    def _is_streaming(self, command: str, upath: str, query) -> bool:
        from . import admin as adminmod

        if upath.startswith(adminmod.PREFIX + "/"):
            tail = upath[len(adminmod.PREFIX) + 1 :]
            if tail in ("trace", "console"):
                return True
        return command == "GET" and "events" in query

    async def _reject(
        self, writer, status: int, code: str, message: str
    ) -> None:
        """Loop-side terminal response (shed / malformed head): S3 XML
        error document, Connection: close."""
        err = s3errors.get(code)
        body = xmlr.error_xml(
            err.code, message, "/", uuid.uuid4().hex[:16]
        )
        reason = {408: "Request Timeout", 431: "Headers Too Large",
                  503: "Slow Down"}.get(status, "Error")
        head = (
            f"HTTP/1.1 {status} {reason}\r\n"
            "Server: MinIO-TPU\r\n"
            "Content-Type: application/xml\r\n"
            f"Content-Length: {len(body)}\r\n"
            "Connection: close\r\n\r\n"
        ).encode("latin-1")
        try:
            writer.write(head + body)
            await writer.drain()
        except (ConnectionError, OSError):
            pass


def _parse_head(head: bytes):
    lines = head.split(b"\r\n", 1)
    try:
        requestline = lines[0].decode("latin-1")
    except UnicodeDecodeError:
        raise ValueError("bad request line") from None
    words = requestline.split()
    if len(words) != 3:
        raise ValueError("malformed request line")
    command, raw_path, version = words
    if not version.startswith("HTTP/"):
        raise ValueError("bad HTTP version")
    try:
        headers = _hclient.parse_headers(io.BytesIO(lines[1]))
    except Exception:  # noqa: BLE001
        raise ValueError("malformed headers") from None
    return requestline, command, raw_path, version, headers


def _wants_close(version: str, headers) -> bool:
    conn = (headers.get("Connection") or "").lower()
    if version <= "HTTP/1.0":
        return "keep-alive" not in conn
    return "close" in conn


class AsyncPlane:
    """N shared-nothing event loops + per-loop worker slices serving
    the S3 surface; this object is only the boot/teardown coordinator
    and observability roll-up — no request ever runs through it."""

    def __init__(self, server):
        self.s3 = server
        self.stats = server.plane_stats
        self.adm = server.admission
        self.header_timeout = _env_float("MINIO_TPU_HEADER_TIMEOUT_S", 30.0)
        self.body_timeout = _env_float("MINIO_TPU_BODY_TIMEOUT_S", 60.0)
        self.idle_timeout = _env_float("MINIO_TPU_IDLE_TIMEOUT_S", 60.0)
        n = _loop_count()
        workers = _env_int("MINIO_TPU_SERVER_WORKERS", _default_workers())
        backlog = _env_int("MINIO_TPU_SERVER_BACKLOG", 64)
        self.loops = [
            _ServerLoop(self, i, w, b)
            for i, (w, b) in enumerate(
                zip(_split(workers, n), _split(backlog, n))
            )
        ]
        self.handler_cls = None
        self.reuseport = False
        self._accept_sock: "socket.socket | None" = None
        self._accept_task = None
        self._ssl_ctx = None
        self._rr = 0
        self._stopped = False
        self.port = 0
        # aggregate stage gauges keep the single-loop scrape shape;
        # the per-loop breakdown rides the LoopStats cells
        self.stats.register_stage(
            "parse", lambda: sum(len(sl._conns) for sl in self.loops)
        )
        self.stats.register_stage(
            "handler", lambda: sum(sl.pool.depth() for sl in self.loops)
        )

    # -- compatibility aliases (single-loop callers/tests) ----------------

    @property
    def loop(self):
        return self.loops[0].loop

    @property
    def pool(self):
        return self.loops[0].pool

    # -- lifecycle --------------------------------------------------------

    def start(self, handler_cls, host: str, port: int, ssl_ctx=None):
        self.handler_cls = handler_cls
        self._handler_cls = handler_cls  # legacy alias
        self._ssl_ctx = ssl_ctx
        for sl in self.loops:
            sl.start_thread()
        if len(self.loops) == 1:
            # today's plane verbatim: one asyncio.start_server listener
            self.loops[0].serve(host, port, None, ssl_ctx)
            self.port = self.loops[0].bound_port()
            return self
        if _reuseport_requested() and hasattr(socket, "SO_REUSEPORT"):
            try:
                self._start_reuseport(host, port, ssl_ctx)
                return self
            except OSError as exc:
                _log.info(
                    "SO_REUSEPORT shard bind failed; using handoff",
                    extra=kv(err=str(exc)),
                )
        self._start_handoff(host, port, ssl_ctx)
        return self

    def _bind_socket(self, host, port, reuseport: bool) -> socket.socket:
        infos = socket.getaddrinfo(
            host or None, port, type=socket.SOCK_STREAM,
            flags=socket.AI_PASSIVE,
        )
        family, stype, proto, _, addr = infos[0]
        s = socket.socket(family, stype, proto)
        try:
            s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
            if reuseport:
                s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEPORT, 1)
            s.bind(addr[:2] if family == socket.AF_INET else addr)
            s.listen(_LISTEN_BACKLOG)
        except OSError:
            s.close()
            raise
        return s

    def _start_reuseport(self, host, port, ssl_ctx) -> None:
        """One bound SO_REUSEPORT socket per loop; the kernel spreads
        accepts across them (the reference's goroutine-per-listener
        served by Go's netpoller gets this for free)."""
        socks: "list[socket.socket]" = []
        bound = port
        try:
            for _ in self.loops:
                s = self._bind_socket(host, bound, reuseport=True)
                if bound == 0:
                    bound = s.getsockname()[1]
                socks.append(s)
        except OSError:
            for s in socks:
                s.close()
            raise
        for sl, s in zip(self.loops, socks):
            sl.serve(None, None, s, ssl_ctx)
        self.reuseport = True
        self.port = bound or self.loops[0].bound_port()

    def _start_handoff(self, host, port, ssl_ctx) -> None:
        """Fallback sharding: one listener, accepted sockets handed to
        loops round-robin.  Accept throughput stays single-loop but
        parse/serve still shard."""
        lsock = self._bind_socket(host, port, reuseport=False)
        self._accept_sock = lsock
        self.port = lsock.getsockname()[1]
        for sl in self.loops:
            sl.mark_serving()
        acceptor = self.loops[0]

        async def _accept_forever():
            lsock.setblocking(False)
            while True:
                try:
                    conn, _addr = await acceptor.loop.sock_accept(lsock)
                except (asyncio.CancelledError, OSError):
                    return
                target = self.loops[self._rr % len(self.loops)]
                self._rr += 1
                asyncio.run_coroutine_threadsafe(
                    target._adopt(conn, ssl_ctx), target.loop
                )

        def _spawn():
            task = acceptor.loop.create_task(_accept_forever())
            self._accept_task = task
            acceptor._tasks.add(task)

        acceptor.loop.call_soon_threadsafe(_spawn)

    def stop(self, drain_s: float = 10.0) -> None:
        import time as _time

        if self._stopped or self.loops[0].loop.is_closed():
            return
        self._stopped = True
        # 1. stop accepting on every loop
        for sl in self.loops:
            sl.close_listener()
        if self._accept_sock is not None:
            # cancel the handoff acceptor ON its loop (a cross-thread
            # socket close would leave sock_accept parked in the
            # selector), then close the listening socket there too
            acceptor, lsock = self.loops[0], self._accept_sock

            def _stop_accept():
                if self._accept_task is not None:
                    self._accept_task.cancel()
                try:
                    lsock.close()
                except OSError:
                    pass

            acceptor.loop.call_soon_threadsafe(_stop_accept)
        # 2. drain in-flight requests (admitted -> released in route())
        deadline = _time.monotonic() + drain_s
        while (
            self.stats.snapshot()["inflight"] > 0
            and _time.monotonic() < deadline
        ):
            _time.sleep(0.05)
        # 3. cut survivors and collect per-connection tasks, loop by loop
        for sl in self.loops:
            sl.cut_conns()
        for sl in self.loops:
            sl.drain_tasks(drain_s)
        # 4. retire worker slices, then the loops themselves
        for sl in self.loops:
            sl.pool.shutdown()
        for sl in self.loops:
            sl.stop_loop()

    # -- observability / fault injection ----------------------------------

    def loops_ready(self) -> bool:
        return all(sl.state == "serving" for sl in self.loops)

    def describe(self) -> dict:
        """healthinfo/readiness block: one row per loop."""
        return {
            "count": len(self.loops),
            "reuseport": self.reuseport,
            "per_loop": [
                {
                    "loop": sl.index,
                    "state": sl.state,
                    "connections": len(sl._conns),
                    "inflight": sl.lstats.inflight(),
                    "workers": sl.pool.workers,
                    "handler_depth": sl.pool.depth(),
                    "shed": dict(sl.lstats.shed),
                }
                for sl in self.loops
            ],
        }

    def wedge_loop(self, index: int, seconds: float) -> bool:
        """Stall one loop (fault injection; see _ServerLoop.wedge)."""
        if not 0 <= index < len(self.loops):
            return False
        self.loops[index].wedge(seconds)
        return True
