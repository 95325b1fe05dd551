"""Scenario interpreter: steps -> harness actions -> invariant checks.

A scenario is data, not code: a tuple of small step verbs executed in
order against a live ClusterHarness, followed by the shared invariant
sweep.  The verbs deliberately mirror what an operator can do to a real
pool (degrade a drive, kill a process, restart it, keep client load
running) - nothing reaches into a node's memory; every interaction
crosses the wire.

Quorum invariants checked after every scenario:

- **readable-at-quorum**: every tracked object GETs bit-identical bytes
  from EVERY live node, and the bytes match one of the payloads a
  client successfully wrote (or plausibly wrote: a failed overwrite may
  have landed before the error) - or every node agrees it is cleanly
  absent.  Split answers between nodes are a violation.
- **no-torn-meta**: every xl.meta on every drive of every node still
  decodes (XLMeta.from_bytes); a torn or half-written journal fails.
- **breaker-cycle** (opt-in per scenario via await_breaker steps): the
  observer node's circuit breaker for the faulted node's drives must
  reach TRIPPED while the fault holds and return to HEALTHY after it
  lifts (half-open probe recovery).
"""

from __future__ import annotations

import dataclasses
import json
import random
import threading
import time

from ..cluster.harness import ClusterHarness
from ..utils.log import kv, logger

_log = logger("testgrid")

BUCKET = "grid"


@dataclasses.dataclass(frozen=True)
class Fault:
    """One remote FaultDisk rule, addressed to a node."""

    node: int
    api: str
    disk: str = "*"
    delay_s: float = 0.0
    hang_s: float = 0.0
    error: bool = False
    corrupt: bool = False
    prob: float = 1.0
    calls: "tuple | None" = None


@dataclasses.dataclass(frozen=True)
class Scenario:
    """One grid cell: cluster shape + seeded data + step script."""

    name: str
    title: str
    nodes: int = 3
    drives_per_node: int = 2
    seed_objects: int = 4
    object_size: int = 48_000
    steps: tuple = ()
    # extra environment for every node process, as a tuple of
    # (name, value) pairs (frozen dataclasses need hashable fields);
    # the caller's env still wins on conflicts
    env: tuple = ()
    # invariant toggles (the sweep itself is shared)
    check_meta: bool = True
    check_reads: bool = True


def payload(n: int, seed: int) -> bytes:
    return random.Random(seed).randbytes(n)


class _Ctx:
    """Mutable scenario state: which payloads a key may legally hold."""

    def __init__(self, harness: ClusterHarness):
        self.h = harness
        # key -> list of acceptable payloads (last confirmed write
        # first; failed overwrites appended - a 5xx PUT may still have
        # reached quorum before the client saw the error)
        self.objects: "dict[str, list[bytes]]" = {}
        self.threads: "list[threading.Thread]" = []
        self.errors: "list[str]" = []
        self.breaker_log: "list[str]" = []
        # cross-step measurements (latency percentiles, counter marks)
        self.marks: "dict[str, float]" = {}
        # (key, expr) -> row-engine oracle Records bytes, computed once
        self.select_oracles: "dict[tuple, bytes]" = {}

    def confirm(self, key: str, body: bytes) -> None:
        self.objects[key] = [body]

    def attempt(self, key: str, body: bytes) -> None:
        self.objects.setdefault(key, []).append(body)


def _request(ctx: _Ctx, node: int, method: str, path: str, **kw):
    """One signed request to ``node`` on a connection of its own."""
    c = ctx.h.client(node)
    try:
        return c.request(method, path, **kw)
    finally:
        c.close()


def _put(ctx: _Ctx, node: int, key: str, body: bytes) -> int:
    status, _, _ = _request(ctx, node, "PUT", f"/{BUCKET}/{key}", body=body)
    if status == 200:
        ctx.confirm(key, body)
    else:
        ctx.attempt(key, body)
    return status


def _get(ctx: _Ctx, node: int, key: str):
    return _request(ctx, node, "GET", f"/{BUCKET}/{key}")


# -- step verbs ------------------------------------------------------------


def _step_fault(ctx: _Ctx, f: Fault) -> None:
    ctx.h.inject_fault(
        f.node,
        f.api,
        disk=f.disk,
        delay_s=f.delay_s,
        hang_s=f.hang_s,
        error=f.error,
        corrupt=f.corrupt,
        prob=f.prob,
        calls=None if f.calls is None else list(f.calls),
    )


def _step_clear(ctx: _Ctx, node: int) -> None:
    ctx.h.clear_faults(node)


def _step_put(ctx: _Ctx, node: int, key: str, size: int, seed: int) -> None:
    status = _put(ctx, node, key, payload(size, seed))
    if status not in (200, 503):
        raise AssertionError(f"PUT {key} via n{node + 1}: HTTP {status}")


def _step_churn(
    ctx: _Ctx, node: int, keys: int, rounds: int, size: int, seed: int
) -> None:
    """Background writer: overwrite a keyset round-robin until joined.
    Failures are tolerated (that is the point of churn under faults)
    but recorded as attempts so the final sweep accepts either body."""

    def run() -> None:
        s = seed
        for r in range(rounds):
            for k in range(keys):
                s += 1
                try:
                    _put(ctx, node, f"churn{k}", payload(size, s))
                except OSError:
                    # node restarting mid-request: retry next round
                    time.sleep(0.2)

    t = threading.Thread(target=run, name="grid-churn", daemon=True)
    t.start()
    ctx.threads.append(t)


def _step_join(ctx: _Ctx, timeout_s: float = 120.0) -> None:
    for t in ctx.threads:
        t.join(timeout=timeout_s)
        if t.is_alive():
            raise AssertionError(f"workload thread {t.name} hung")
    ctx.threads.clear()


def _flood(
    ctx: _Ctx, key: str, count: int, threads: int
) -> "list[float]":
    """Hot-key read storm from every node; every reply must be 200 and
    bit-identical to an acceptable payload.  Returns the per-request
    wall latencies of the successful reads."""
    ok_bodies = ctx.objects[key]
    fails: list[str] = []
    latencies: list[float] = []

    import http.client as _hc

    def run(worker: int) -> None:
        for j in range(count):
            node = (worker + j) % len(ctx.h.nodes)
            if not ctx.h.nodes[node].alive():
                continue
            # a dropped connection under fault load is a transport
            # hiccup, not a correctness violation: one retry on a
            # fresh connection; only a persistent failure counts
            for attempt in (0, 1):
                t0 = time.monotonic()
                try:
                    status, _, body = _get(ctx, node, key)
                except (OSError, _hc.HTTPException):
                    if attempt:
                        fails.append(f"n{node + 1}#{j}: transport")
                    continue
                if status != 200 or body not in ok_bodies:
                    fails.append(f"n{node + 1}#{j}: HTTP {status}")
                else:
                    latencies.append(time.monotonic() - t0)
                break

    ts = [
        threading.Thread(target=run, args=(w,), daemon=True)
        for w in range(threads)
    ]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=120)
    if fails:
        raise AssertionError(
            f"get flood on {key}: {len(fails)} bad reads "
            f"(first: {fails[0]})"
        )
    return latencies


def _step_get_flood(
    ctx: _Ctx, key: str, count: int, threads: int = 4
) -> None:
    _flood(ctx, key, count, threads)


def _p99(samples: "list[float]") -> float:
    if not samples:
        raise AssertionError("no latency samples collected")
    s = sorted(samples)
    return s[min(len(s) - 1, int(0.99 * len(s)))]


def _step_timed_get_flood(
    ctx: _Ctx, key: str, count: int, threads: int, mark: str
) -> None:
    """get_flood + record the p99 latency under ``mark``."""
    ctx.marks[mark] = _p99(_flood(ctx, key, count, threads))


def _step_assert_p99_within(
    ctx: _Ctx,
    mark: str,
    baseline: str,
    factor: float,
    slack_s: float = 0.0,
) -> None:
    """The marked p99 must stay within factor x baseline (plus an
    absolute slack floor so millisecond-scale noise cannot flake).

    On a single-core host the background load and the timed flood
    time-slice one CPU, so latency inflation measures the scheduler,
    not the isolation property under test — the factor falls back to
    a coarse starvation-only bound there (a stalled flood behind a
    scan/heal storm still overshoots it by an order of magnitude)."""
    import os

    hot, base = ctx.marks[mark], ctx.marks[baseline]
    if (os.cpu_count() or 1) < 2:
        factor = max(factor, 8.0)
    limit = max(base * factor, base + slack_s)
    if hot > limit:
        raise AssertionError(
            f"p99 regressed: {mark}={hot * 1e3:.1f}ms vs "
            f"{baseline}={base * 1e3:.1f}ms (limit {limit * 1e3:.1f}ms)"
        )


# the data-plane shard-read API: one call per shard stream a GET opens.
# A full-cache-hit GET opens zero (the codec's reader bank is lazy), so
# the hot-key cache cell can assert the counter does not move at all.
DATA_READ_API = "read_file_stream"


def _data_reads_total(ctx: _Ctx) -> float:
    from ..cluster.harness import parse_prometheus

    total = 0.0
    for n in ctx.h.nodes:
        if not n.alive():
            continue
        try:
            rows = parse_prometheus(ctx.h.scrape(n.index))
        except OSError:
            continue
        for name, labels, value in rows:
            if (
                name == "miniotpu_disk_api_calls_total"
                and labels.get("api") == DATA_READ_API
            ):
                total += value
    return total


def _step_mark_data_reads(ctx: _Ctx, mark: str = "data_reads") -> None:
    ctx.marks[mark] = _data_reads_total(ctx)


def _step_assert_data_reads_flat(
    ctx: _Ctx, mark: str = "data_reads"
) -> None:
    before = ctx.marks[mark]
    now = _data_reads_total(ctx)
    if now != before:
        raise AssertionError(
            f"cache-hit flood touched the data plane: "
            f"{DATA_READ_API} calls moved {before:.0f} -> {now:.0f}"
        )


# -- S3-Select verbs -------------------------------------------------------
#
# The select cells treat every node's SELECT response as a claim about
# the object's bytes: the Records payload must be BIT-IDENTICAL to the
# row engine run locally in the grid's own process over the payload the
# client wrote.  Whatever engine a node picks (device screen, host
# vector, row) and however degraded its disks are, the answer may not
# drift.


def csv_payload(rows: int, seed: int) -> bytes:
    """Deterministic CSV table (same shape for the grid and the cluster)."""
    lines = ["id,name,qty,price"]
    for i in range(rows):
        j = i + seed
        lines.append(f"{i},item{j % 13},{j % 11},{(j % 7) * 0.75}")
    return ("\n".join(lines) + "\n").encode()


def _select_xml(expr: str) -> bytes:
    return (
        "<SelectObjectContentRequest>"
        f"<Expression>{expr.replace('<', '&lt;')}</Expression>"
        "<ExpressionType>SQL</ExpressionType>"
        "<InputSerialization><CSV><FileHeaderInfo>USE"
        "</FileHeaderInfo></CSV></InputSerialization>"
        "<OutputSerialization><CSV/></OutputSerialization>"
        "</SelectObjectContentRequest>"
    ).encode()


def _select_records(stream: bytes) -> bytes:
    from ..s3select.message import decode_all

    return b"".join(
        m["payload"]
        for m in decode_all(stream)
        if m["headers"].get(":event-type") == "Records"
    )


def _select_oracle(ctx: _Ctx, key: str, expr: str) -> bytes:
    """Row-engine answer computed in the grid's own process (no cluster
    involvement), cached per (key, expr)."""
    cached = ctx.select_oracles.get((key, expr))
    if cached is not None:
        return cached
    import io
    import os

    from ..s3select.engine import S3Select, SelectRequest

    data = ctx.objects[key][0]
    saved = os.environ.get("MINIO_TPU_SELECT")
    os.environ["MINIO_TPU_SELECT"] = "row"
    try:
        out = bytearray()
        sel = S3Select(
            SelectRequest.from_xml(_select_xml(expr)), device="cpu"
        )
        sel.evaluate(io.BytesIO(data), len(data), out.extend)
    finally:
        if saved is None:
            os.environ.pop("MINIO_TPU_SELECT", None)
        else:
            os.environ["MINIO_TPU_SELECT"] = saved
    oracle = _select_records(bytes(out))
    ctx.select_oracles[(key, expr)] = oracle
    return oracle


def _select_once(ctx: _Ctx, node: int, key: str, expr: str):
    return _request(
        ctx,
        node,
        "POST",
        f"/{BUCKET}/{key}",
        query={"select": "", "select-type": "2"},
        body=_select_xml(expr),
    )


def _select_flood(
    ctx: _Ctx, key: str, expr: str, count: int, threads: int
) -> "list[float]":
    """SELECT storm from every node; every reply must be 200 with a
    Records payload bit-identical to the local row-engine oracle."""
    oracle = _select_oracle(ctx, key, expr)
    fails: list[str] = []
    latencies: list[float] = []

    import http.client as _hc

    def run(worker: int) -> None:
        for j in range(count):
            node = (worker + j) % len(ctx.h.nodes)
            if not ctx.h.nodes[node].alive():
                continue
            for attempt in (0, 1):
                t0 = time.monotonic()
                try:
                    status, _, body = _select_once(ctx, node, key, expr)
                except (OSError, _hc.HTTPException):
                    if attempt:
                        fails.append(f"n{node + 1}#{j}: transport")
                    continue
                if status != 200:
                    fails.append(f"n{node + 1}#{j}: HTTP {status}")
                elif _select_records(body) != oracle:
                    fails.append(f"n{node + 1}#{j}: records diverged")
                else:
                    latencies.append(time.monotonic() - t0)
                break

    ts = [
        threading.Thread(target=run, args=(w,), daemon=True)
        for w in range(threads)
    ]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=120)
    if fails:
        raise AssertionError(
            f"select flood on {key}: {len(fails)} bad answers "
            f"(first: {fails[0]})"
        )
    return latencies


def _step_put_csv(
    ctx: _Ctx, node: int, key: str, rows: int, seed: int
) -> None:
    status = _put(ctx, node, key, csv_payload(rows, seed))
    if status != 200:
        raise AssertionError(f"PUT {key} via n{node + 1}: HTTP {status}")


def _step_select_flood(
    ctx: _Ctx, key: str, expr: str, count: int, threads: int = 4
) -> None:
    _select_flood(ctx, key, expr, count, threads)


def _step_timed_select_flood(
    ctx: _Ctx, key: str, expr: str, count: int, threads: int, mark: str
) -> None:
    """select_flood + record the p99 latency under ``mark``."""
    ctx.marks[mark] = _p99(_select_flood(ctx, key, expr, count, threads))


def _step_select_churn(
    ctx: _Ctx, key: str, expr: str, rounds: int, threads: int = 2
) -> None:
    """Background scan load: keep SELECTing until joined.  Transport
    hiccups are tolerated; a wrong ANSWER is recorded and fails the
    scenario at the end (bit-identity holds even for background load)."""
    oracle = _select_oracle(ctx, key, expr)

    def run(worker: int) -> None:
        for r in range(rounds):
            node = (worker + r) % len(ctx.h.nodes)
            if not ctx.h.nodes[node].alive():
                continue
            try:
                status, _, body = _select_once(ctx, node, key, expr)
            except OSError:
                time.sleep(0.1)
                continue
            if status == 200 and _select_records(body) != oracle:
                ctx.errors.append(
                    f"select churn n{node + 1}#{r}: records diverged"
                )

    for w in range(threads):
        t = threading.Thread(
            target=run, args=(w,), name="grid-select", daemon=True
        )
        t.start()
        ctx.threads.append(t)


def _step_make_bucket(ctx: _Ctx, node: int, name: str) -> None:
    status, _, _ = _request(ctx, node, "PUT", f"/{name}")
    if status != 200:
        raise AssertionError(f"make_bucket {name}: HTTP {status}")


_REPL_XML = (
    b"<ReplicationConfiguration>"
    b"<Rule><Status>Enabled</Status><Priority>1</Priority>"
    b"<Prefix></Prefix>"
    b"<Destination><Bucket>%s</Bucket></Destination></Rule>"
    b"</ReplicationConfiguration>"
)


def _step_enable_replication(ctx: _Ctx, node: int, dst: str) -> None:
    """Versioning + a catch-all replication rule on the grid bucket,
    targeting a local destination bucket."""
    status, _, body = _request(
        ctx, node, "PUT", f"/{BUCKET}", query={"versioning": ""},
        body=b"<VersioningConfiguration><Status>Enabled</Status>"
        b"</VersioningConfiguration>",
    )
    if status != 200:
        raise AssertionError(f"enable versioning: HTTP {status}")
    status, _, body = _request(
        ctx, node, "PUT", f"/{BUCKET}", query={"replication": ""},
        body=_REPL_XML % dst.encode(),
    )
    if status != 200:
        raise AssertionError(
            f"replication config: HTTP {status}: {body[:200]!r}"
        )


def _step_await_replication(
    ctx: _Ctx,
    node: int,
    dst: str,
    keys: tuple,
    timeout_s: float = 90.0,
) -> None:
    """Poll the destination bucket until every key reads back one of
    its acceptable payloads — the async queue plus the crawler's
    PENDING/FAILED catch-up must converge with no manual kick."""
    deadline = time.monotonic() + timeout_s
    lagging: "dict[str, object]" = {}
    while time.monotonic() < deadline:
        lagging = {}
        for key in keys:
            ok_bodies = ctx.objects.get(key, [])
            try:
                status, _, body = _request(ctx, node, "GET", f"/{dst}/{key}")
            except OSError:
                lagging[key] = "transport"
                continue
            if status != 200:
                lagging[key] = f"HTTP {status}"
            elif body not in ok_bodies:
                lagging[key] = f"stale body ({len(body)} bytes)"
        if not lagging:
            return
        time.sleep(0.5)
    raise AssertionError(
        f"replication to {dst} never converged: {lagging}"
    )


def _step_kill(ctx: _Ctx, node: int) -> None:
    ctx.h.kill(node)


def _step_terminate(ctx: _Ctx, node: int) -> None:
    rc = ctx.h.terminate(node)
    if rc != 0:
        raise AssertionError(
            f"n{node + 1} SIGTERM exit rc={rc}:\n"
            + ctx.h.nodes[node].log_tail()
        )


def _step_restart(ctx: _Ctx, node: int, graceful: bool = False) -> None:
    ctx.h.restart(node, graceful=graceful)


def _step_wipe_drive(ctx: _Ctx, node: int, drive: int) -> None:
    """Empty one drive dir while its node is down (drive swap)."""
    import shutil

    root = ctx.h.nodes[node].drive_dirs[drive]
    for entry in list(root.iterdir()):
        shutil.rmtree(entry, ignore_errors=True)


def _step_sleep(ctx: _Ctx, seconds: float) -> None:
    time.sleep(seconds)


def _step_await_breaker(
    ctx: _Ctx,
    observer: int,
    target: int,
    state: int,
    timeout_s: float = 60.0,
) -> None:
    """Poll the observer's miniotpu_disk_state for the target node's
    drives until one reaches ``state`` (2=TRIPPED) or, for state 0,
    until ALL are healthy again.  Reads are issued each poll so the
    breaker sees traffic (half-open needs a probe request)."""
    port_tag = f":{ctx.h.nodes[target].port}"
    probe_keys = list(ctx.objects) or [""]
    deadline = time.monotonic() + timeout_s
    last: dict = {}
    i = 0
    while time.monotonic() < deadline:
        if probe_keys[0]:
            try:
                _get(ctx, observer, probe_keys[i % len(probe_keys)])
            except OSError:
                pass
            i += 1
        states = {
            ep: st
            for ep, st in ctx.h.disk_states(observer).items()
            if port_tag in ep
        }
        last = states
        if states:
            if state == 0 and all(st == 0 for st in states.values()):
                ctx.breaker_log.append(f"n{target + 1}:recovered")
                return
            if state > 0 and any(
                st >= state for st in states.values()
            ):
                ctx.breaker_log.append(f"n{target + 1}:state{state}")
                return
        time.sleep(0.25)
    raise AssertionError(
        f"breaker on n{observer + 1} never reached state {state} for "
        f"n{target + 1} drives; last={last}"
    )


def _step_await_heal(
    ctx: _Ctx,
    node: int,
    drive: int,
    want_objects: "tuple",
    timeout_s: float = 90.0,
) -> None:
    """Wait until every named object has a shard back on the wiped
    drive - convergence with NO manual heal call (fresh-disk monitor
    plus heal routine)."""
    root = ctx.h.nodes[node].drive_dirs[drive]
    want = set(want_objects)
    deadline = time.monotonic() + timeout_s
    healed: set = set()
    while time.monotonic() < deadline:
        healed = {
            p.parent.parent.name
            for p in root.glob(f"{BUCKET}/*/*/part.1")
        }
        if want <= healed:
            return
        time.sleep(0.5)
    raise AssertionError(
        f"heal never converged on n{node + 1} drive{drive + 1}: "
        f"healed={sorted(healed)} want={sorted(want)}"
    )


def _step_await_locks_drained(
    ctx: _Ctx, node: int, timeout_s: float = 30.0
) -> None:
    """top-locks on a node must drain to empty: a graceful peer
    restart may not leave orphaned dsync entries behind."""
    deadline = time.monotonic() + timeout_s
    doc: dict = {}
    while time.monotonic() < deadline:
        status, doc = ctx.h.admin(node, "GET", "top-locks")
        locks = doc.get("locks", doc if isinstance(doc, list) else [])
        if status == 200 and not locks:
            return
        time.sleep(0.5)
    raise AssertionError(
        f"n{node + 1} still holds lock entries: {doc}"
    )


def _step_expect_put(
    ctx: _Ctx, node: int, key: str, size: int, seed: int, status: int
) -> None:
    got = _put(ctx, node, key, payload(size, seed))
    if got != status:
        raise AssertionError(
            f"PUT {key} via n{node + 1}: wanted HTTP {status}, "
            f"got {got}"
        )


def _step_wedge_loop(
    ctx: _Ctx, node: int, loop_ix: int, seconds: float
) -> None:
    """Busy-spin one server loop's thread on node ``node`` via the
    admin control plane (gated on MINIO_TPU_FAULT_INJECTION, like disk
    faults).  Returns as soon as the wedge is scheduled."""
    body = json.dumps({"loop": loop_ix, "seconds": seconds}).encode()
    status, out = ctx.h.admin(node, "POST", "loops/wedge", body=body)
    if status != 200:
        raise AssertionError(
            f"loops/wedge loop{loop_ix} on n{node + 1}: "
            f"HTTP {status} {out}"
        )


def _step_assert_loops_serving(
    ctx: _Ctx, node: int, count: int
) -> None:
    """Node ``node`` reports exactly ``count`` event loops, all in
    state=serving."""
    status, out = ctx.h.admin(node, "GET", "loops/status")
    if status != 200:
        raise AssertionError(
            f"loops/status on n{node + 1}: HTTP {status} {out}"
        )
    states = [row.get("state") for row in out.get("per_loop", [])]
    if out.get("count") != count or states != ["serving"] * count:
        raise AssertionError(
            f"n{node + 1} loops not all serving: "
            f"count={out.get('count')} states={states}"
        )


def _step_probe_health_during_wedge(
    ctx: _Ctx, node: int, within_s: float, probes: int = 3
) -> None:
    """While a wedge holds on one of node's loops, concurrent fresh
    connections must still reach the control plane fast: at least one
    of ``probes`` parallel loops/status calls answers within
    ``within_s`` (in handoff mode consecutive accepts round-robin over
    loops, so some probe always lands on a healthy loop)."""
    time.sleep(0.5)  # let the wedge's scheduling grace elapse first
    results: "list[tuple[int, float]]" = []
    mu = threading.Lock()

    def probe() -> None:
        t0 = time.monotonic()
        try:
            status, _ = ctx.h.admin(node, "GET", "loops/status")
        except OSError:
            status = -1
        with mu:
            results.append((status, time.monotonic() - t0))

    threads = [
        threading.Thread(target=probe) for _ in range(probes)
    ]
    for t in threads:
        t.start()
        # sequential connects so handoff round-robin spreads the
        # probes across loops deterministically
        time.sleep(0.05)
    for t in threads:
        t.join(within_s + 30.0)
    fast = [
        el for st, el in results if st == 200 and el < within_s
    ]
    if not fast:
        raise AssertionError(
            f"no health probe on n{node + 1} answered within "
            f"{within_s}s during the wedge: {results}"
        )


_VERBS = {
    "fault": _step_fault,
    "clear": _step_clear,
    "put": _step_put,
    "expect_put": _step_expect_put,
    "churn": _step_churn,
    "join": _step_join,
    "get_flood": _step_get_flood,
    "timed_get_flood": _step_timed_get_flood,
    "assert_p99_within": _step_assert_p99_within,
    "mark_data_reads": _step_mark_data_reads,
    "assert_data_reads_flat": _step_assert_data_reads_flat,
    "put_csv": _step_put_csv,
    "select_flood": _step_select_flood,
    "timed_select_flood": _step_timed_select_flood,
    "select_churn": _step_select_churn,
    "make_bucket": _step_make_bucket,
    "enable_replication": _step_enable_replication,
    "await_replication": _step_await_replication,
    "kill": _step_kill,
    "terminate": _step_terminate,
    "restart": _step_restart,
    "wipe_drive": _step_wipe_drive,
    "sleep": _step_sleep,
    "await_breaker": _step_await_breaker,
    "await_heal": _step_await_heal,
    "await_locks_drained": _step_await_locks_drained,
    "wedge_loop": _step_wedge_loop,
    "assert_loops_serving": _step_assert_loops_serving,
    "probe_health_during_wedge": _step_probe_health_during_wedge,
}


# -- invariant sweep -------------------------------------------------------


def check_quorum_reads(ctx: _Ctx) -> int:
    """Every tracked key: all live nodes agree on one acceptable
    payload, or all agree it is absent.  Returns keys verified."""
    live = [n.index for n in ctx.h.nodes if n.alive()]
    if not live:
        raise AssertionError("no live nodes to verify reads against")
    for key, bodies in sorted(ctx.objects.items()):
        answers: "dict[int, tuple]" = {}
        for node in live:
            status, _, body = _get(ctx, node, key)
            answers[node] = (status, body)
        statuses = {s for s, _ in answers.values()}
        if statuses == {404}:
            continue  # cleanly absent everywhere
        if statuses != {200}:
            raise AssertionError(
                f"{key}: split availability across nodes: "
                f"{ {f'n{n + 1}': s for n, (s, _) in answers.items()} }"
            )
        distinct = {body for _, body in answers.values()}
        if len(distinct) != 1:
            raise AssertionError(
                f"{key}: nodes disagree on content "
                f"({len(distinct)} distinct payloads)"
            )
        got = next(iter(distinct))
        if got not in bodies:
            raise AssertionError(
                f"{key}: stored payload matches NO client write "
                f"({len(got)} bytes, {len(bodies)} candidates)"
            )
    return len(ctx.objects)


def check_no_torn_meta(ctx: _Ctx) -> int:
    """Every xl.meta on every drive must decode; torn journals fail.
    Returns files checked."""
    from ..storage.meta import XLMeta

    checked = 0
    for n in ctx.h.nodes:
        for root in n.drive_dirs:
            for p in root.rglob("xl.meta"):
                raw = p.read_bytes()
                try:
                    XLMeta.from_bytes(raw)
                except Exception as e:
                    raise AssertionError(
                        f"torn xl.meta on n{n.index + 1} at "
                        f"{p.relative_to(root)}: {e}"
                    ) from None
                checked += 1
    return checked


def run_scenario(
    sc: Scenario, base_dir, env: "dict | None" = None
) -> dict:
    """Execute one grid cell; returns a small report for assertions
    and logging.  Raises AssertionError on any invariant violation."""
    merged_env = dict(sc.env)
    merged_env.update(env or {})
    h = ClusterHarness(
        base_dir,
        nodes=sc.nodes,
        drives_per_node=sc.drives_per_node,
        env=merged_env,
    )
    with h:
        ctx = _Ctx(h)
        status, _, _ = _request(ctx, 0, "PUT", f"/{BUCKET}")
        if status != 200:
            raise AssertionError(f"make_bucket: HTTP {status}")
        for i in range(sc.seed_objects):
            body = payload(sc.object_size, 7_000 + i)
            st = _put(ctx, i % sc.nodes, f"seed{i}", body)
            if st != 200:
                raise AssertionError(f"seed{i}: HTTP {st}")
        for step in sc.steps:
            verb, args = step[0], step[1:]
            _log.debug(
                "step", extra=kv(scenario=sc.name, verb=verb)
            )
            _VERBS[verb](ctx, *args)
        # safety net: no scenario may leak schedules into the sweep
        for n in h.nodes:
            if n.alive():
                try:
                    h.clear_faults(n.index)
                except RuntimeError as exc:
                    _log.debug(
                        "final fault clear failed",
                        extra=kv(node=n.index, err=str(exc)),
                    )
        report = {
            "scenario": sc.name,
            "objects": 0,
            "meta_files": 0,
            "breaker_events": list(ctx.breaker_log),
        }
        if ctx.errors:
            raise AssertionError(
                f"{sc.name}: workload errors: {ctx.errors[:3]}"
            )
        if sc.check_reads:
            report["objects"] = check_quorum_reads(ctx)
        if sc.check_meta:
            report["meta_files"] = check_no_torn_meta(ctx)
    return report
