"""The chaos grid: one Scenario per failure archetype.

Every cell runs on a 3-node x 2-drive loopback cluster (6-disk erasure
set, data=3 / parity=3, write quorum 4) so ONE fully-degraded node
still leaves both read and write quorum intact - scenarios can assert
availability under faults, not just clean failure.

Fault delivery is always remote: the grid's process schedules
FaultDisk rules inside another OS process via the authenticated admin
fault endpoint, exactly how the harness would degrade a node it cannot
reach into.
"""

from __future__ import annotations

from .engine import Fault, Scenario

SEEDS = ("seed0", "seed1", "seed2", "seed3")


# A remote node's drives serve errors on every storage op: reads must
# degrade (5 live disks >= data quorum), writes must still commit
# (4 healthy drives = write quorum), the OBSERVER's breaker for the
# faulted node must trip, and lifting the fault must recover it through
# the half-open probe.
DEAD_REMOTE_DISKS = Scenario(
    name="dead_remote_disks",
    title="dead remote disks: degraded IO + breaker trip/recover",
    steps=(
        ("fault", Fault(node=1, api="*", error=True)),
        ("await_breaker", 0, 1, 2),
        ("put", 0, "during-fault", 30_000, 101),
        ("get_flood", "seed0", 5, 2),
        ("clear", 1),
        ("await_breaker", 0, 1, 0),
        ("put", 0, "after-clear", 30_000, 102),
    ),
)

# One node answers shard reads slowly; a hot-key read storm across all
# nodes must stay bit-identical (hedged reads may race the slow disk,
# but correctness never depends on who wins).
SLOW_REMOTE_DISKS = Scenario(
    name="slow_remote_disks",
    title="slow remote disks: hot reads stay correct under hedging",
    steps=(
        ("fault", Fault(node=1, api="read_at", delay_s=0.2)),
        ("get_flood", "seed1", 8, 4),
        ("clear", 1),
    ),
)

# Shard writes and the metadata-commit rename hang on one node while a
# client PUTs: the write either commits at quorum or fails cleanly -
# the sweep proves no torn xl.meta and no split availability.
PARTITION_MID_PUT = Scenario(
    name="partition_mid_put",
    title="network partition mid-PUT: commit-or-clean, never torn",
    steps=(
        ("fault", Fault(node=1, api="write", hang_s=2.0)),
        ("fault", Fault(node=1, api="rename_file", hang_s=2.0)),
        ("put", 0, "torn-candidate", 60_000, 201),
        ("put", 2, "torn-candidate", 60_000, 202),
        ("clear", 1),
        ("sleep", 0.5),
    ),
)

# Rolling graceful restarts under live write load: every node cycles
# while a writer churns; SIGTERM must drain + unwind dsync grants, so
# after the roll no node holds orphaned lock entries and churned keys
# read back consistent.
ROLLING_RESTART = Scenario(
    name="rolling_restart",
    title="rolling restarts under load: drains, lock unwind, no orphans",
    steps=(
        ("churn", 0, 3, 30, 20_000, 300),
        ("sleep", 0.5),
        ("restart", 1, True),
        ("restart", 2, True),
        ("join",),
        ("await_locks_drained", 0),
        ("await_locks_drained", 1),
        ("await_locks_drained", 2),
    ),
)

# Heal storm racing live writes: a node dies, loses a drive's contents
# (swap), and rejoins while a writer keeps churning - the fresh-disk
# monitor + heal routine must reconstruct every seed shard with no
# manual heal call, without corrupting the racing writes.
HEAL_STORM = Scenario(
    name="heal_storm",
    title="heal storm vs live writes: wiped drive reconverges",
    steps=(
        ("kill", 2),
        ("wipe_drive", 2, 0),
        ("churn", 0, 2, 10, 20_000, 400),
        ("restart", 2, False),
        ("join",),
        ("await_heal", 2, 0, SEEDS),
    ),
)

# Hot-key GET flood across every node with one mildly slow drive set:
# high fan-in reads on a single object stay bit-identical everywhere.
HOT_KEY_FLOOD = Scenario(
    name="hot_key_flood",
    title="hot-key GET flood: fan-in reads bit-identical on all nodes",
    steps=(
        ("fault", Fault(node=2, api="read_at", delay_s=0.05, prob=0.5)),
        ("get_flood", "seed2", 12, 6),
        ("clear", 2),
        ("get_flood", "seed2", 5, 2),
    ),
)

# Hot-key GET flood with the tiered read cache on and one node's
# drives erroring every shard read: after the warm-up floods, every
# GET is a full cache hit, so (a) the data-plane shard-read counter
# must not move AT ALL during the degraded flood — zero disk calls on
# hit — and (b) GET p99 stays flat against the healthy hot baseline
# (1.5x plus an absolute noise floor).  Bit-identity holds throughout:
# the flood compares every body, and the final sweep re-reads every
# object on every node.
HOT_KEY_CACHE_FLOOD = Scenario(
    name="hot_key_cache_flood",
    title="hot-key flood vs tripped disk: cache hits keep p99 flat",
    env=(("MINIO_TPU_READ_CACHE", "host"),),
    steps=(
        ("get_flood", "seed3", 6, 3),  # warm every node's cache
        ("timed_get_flood", "seed3", 20, 4, "healthy_p99"),
        ("mark_data_reads", "flood"),
        ("fault", Fault(node=1, api="read_file_stream", error=True)),
        ("fault", Fault(node=1, api="read_at", error=True)),
        ("timed_get_flood", "seed3", 20, 4, "degraded_p99"),
        ("assert_data_reads_flat", "flood"),
        ("assert_p99_within", "degraded_p99", "healthy_p99", 1.5, 0.15),
        ("clear", 1),
    ),
)

# Replication lag under churn: a catch-all rule replicates the grid
# bucket into a local destination while a writer churns a keyset and
# one node's shard writes stutter.  After the churn joins and the
# fault lifts, the destination must converge to an acceptable payload
# for every churned key — the async queue plus the crawler's
# PENDING/FAILED catch-up, no manual kick.
REPLICATION_LAG_CHURN = Scenario(
    name="replication_lag_churn",
    title="replication lag under churn: destination converges",
    steps=(
        ("make_bucket", 0, "replica"),
        ("enable_replication", 0, "replica"),
        ("fault", Fault(node=2, api="write", delay_s=0.05, prob=0.3)),
        ("churn", 0, 3, 8, 20_000, 500),
        ("join",),
        ("clear", 2),
        ("await_replication", 0, "replica", ("churn0", "churn1", "churn2")),
    ),
)

# Heavy SELECT mix: an analytics scan flood shares the cluster with
# the hot-key GET path.  Every SELECT response — whatever engine the
# node picks (device screen, host vector, row) — must be BIT-IDENTICAL
# to the row engine run locally by the grid over the payload the
# client wrote, including while one node's shard reads error (degraded
# erasure reads feed the scan plane); and GET p99 under concurrent
# scan load stays within 1.5x of the healthy baseline (single-core
# hosts fall back to the engine's coarse starvation-only bound: the
# scan threads time-slice the only CPU with the timed flood).
_SELECT_EXPR = "SELECT s.id, s.name FROM S3Object s WHERE s.qty > 6"

SELECT_HEAVY_MIX = Scenario(
    name="select_heavy_mix",
    title="select flood vs GET mix: bit-identical answers under faults",
    steps=(
        ("put_csv", 0, "table.csv", 4000, 17),
        ("select_flood", "table.csv", _SELECT_EXPR, 3, 2),  # warm engines
        ("timed_get_flood", "seed0", 20, 4, "healthy_p99"),
        ("select_churn", "table.csv", _SELECT_EXPR, 10, 2),
        ("timed_get_flood", "seed0", 20, 4, "mixed_p99"),
        ("join",),
        ("assert_p99_within", "mixed_p99", "healthy_p99", 1.5, 0.15),
        ("fault", Fault(node=1, api="read_file_stream", error=True)),
        ("select_flood", "table.csv", _SELECT_EXPR, 6, 3),
        ("clear", 1),
        ("select_flood", "table.csv", _SELECT_EXPR, 3, 2),
    ),
)

# One event loop of a multi-loop node is artificially wedged (admin
# loops/wedge busy-spins the loop thread, gated on fault injection
# like disk faults): the blast radius must be that loop's shard ONLY.
# The control plane keeps answering on fresh connections while the
# wedge holds (handoff mode round-robins consecutive accepts over
# loops, so probes deterministically reach a healthy loop), the rest
# of the grid serves reads and writes throughout, and once the spin
# releases every loop reports serving again.  The standard sweep then
# proves no request was lost or torn behind the stall.
WEDGED_LOOP = Scenario(
    name="wedged_loop",
    title="wedged event loop: one stalled loop degrades only its shard",
    env=(
        ("MINIO_TPU_SERVER", "async"),
        ("MINIO_TPU_SERVER_LOOPS", "2"),
        ("MINIO_TPU_SERVER_REUSEPORT", "off"),
    ),
    steps=(
        ("assert_loops_serving", 0, 2),
        ("assert_loops_serving", 1, 2),
        ("assert_loops_serving", 2, 2),
        # wedge the non-acceptor loop on n2: accepts keep flowing
        ("wedge_loop", 1, 1, 4.0),
        ("probe_health_during_wedge", 1, 2.5),
        ("get_flood", "seed0", 6, 3),
        ("put", 0, "during-wedge", 30_000, 201),
        ("sleep", 1.0),
        ("assert_loops_serving", 1, 2),
        ("get_flood", "seed1", 3, 2),
    ),
)

GRID = (
    DEAD_REMOTE_DISKS,
    SLOW_REMOTE_DISKS,
    PARTITION_MID_PUT,
    ROLLING_RESTART,
    HEAL_STORM,
    HOT_KEY_FLOOD,
    HOT_KEY_CACHE_FLOOD,
    REPLICATION_LAG_CHURN,
    SELECT_HEAVY_MIX,
    WEDGED_LOOP,
)


def scenario_by_name(name: str) -> Scenario:
    for sc in GRID:
        if sc.name == name:
            return sc
    raise KeyError(name)
