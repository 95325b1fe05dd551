"""The port's MINIO_TPU_* environment-knob registry (MTPU606's ground truth).

Every environment variable ``minio_tpu_torch`` reads must have a row
here - name, default, one-line description - and a row in README.md's
table of the port's knobs.  The port's lifecycle pass
(``minio_tpu_torch.analysis.lifecycle``) enforces all three directions
as MTPU606: an env read with no registry entry, a registry entry missing
from the README table, and a registry entry nothing reads are each
findings.  ``PREFIX_KNOBS`` covers dynamically-composed families
(``MINIO_TPU_NOTIFY_<KIND>_<KEY>_<ID>``) whose full names cannot be
enumerated statically.

The rows are the JAX package's registry's, name for name and default for
default, with two differences: ``JAX_ONLY`` holds the one knob of a
construct the port has no counterpart of (so nothing here reads it),
with its reason, and the three OpenID knobs, which both packages read
through module constants (``iam/openid.py``), have rows here.

This module is intentionally data-only (no env reads of its own): the
runtime seams keep reading ``os.environ`` per call so ConfigSys edits
apply without restart; this table is the catalog that keeps those
scattered reads honest.
"""

from __future__ import annotations

import collections

Knob = collections.namedtuple("Knob", ("default", "description"))

KNOBS: "dict[str, Knob]" = {
    # -- server front plane ------------------------------------------------
    "MINIO_TPU_SERVER": Knob("async", "server mode: async | threaded"),
    "MINIO_TPU_SERVER_LOOPS": Knob(
        "cpu-derived", "async accept-loop count (shared-nothing planes)"
    ),
    "MINIO_TPU_SERVER_REUSEPORT": Knob(
        "auto", "SO_REUSEPORT per-loop listeners: auto | on | off"
    ),
    "MINIO_TPU_SERVER_WORKERS": Knob(
        "cpu-derived", "worker threads per loop for blocking work"
    ),
    "MINIO_TPU_SERVER_BACKLOG": Knob("64", "listen(2) backlog per loop"),
    "MINIO_TPU_HEADER_TIMEOUT_S": Knob(
        "30.0", "slow-loris guard: max seconds to receive headers"
    ),
    "MINIO_TPU_BODY_TIMEOUT_S": Knob(
        "60.0", "max seconds between body chunks"
    ),
    "MINIO_TPU_IDLE_TIMEOUT_S": Knob(
        "60.0", "keep-alive idle connection timeout"
    ),
    "MINIO_TPU_REQUESTS_MAX": Knob(
        "0", "global inflight request cap (0 = auto)"
    ),
    "MINIO_TPU_REQUESTS_DEADLINE_S": Knob(
        "10.0", "queue wait deadline before 503 SlowDown"
    ),
    "MINIO_TPU_TENANT_MAX_INFLIGHT": Knob(
        "0", "per-tenant admission cap (0 = unlimited)"
    ),
    "MINIO_TPU_SELECT_MAX_INFLIGHT": Knob(
        "0", "admission cap for the select/scan class (0 = unlimited)"
    ),
    "MINIO_TPU_PROMETHEUS_AUTH_TYPE": Knob(
        "jwt", "metrics endpoint auth: jwt | public"
    ),
    "MINIO_TPU_TLS": Knob("off", "serve TLS: on | off"),
    "MINIO_TPU_CERT_FILE": Knob("", "TLS server certificate path"),
    "MINIO_TPU_KEY_FILE": Knob("", "TLS private key path"),
    "MINIO_TPU_CA_FILE": Knob("", "TLS client-verification CA path"),
    # -- codec / device plane ----------------------------------------------
    "MINIO_TPU_CODEC_KERNEL": Knob(
        "fused1", "codec kernels: fused1 | legacy (the three-pass codec)"
    ),
    "MINIO_TPU_CODEC_FORMULATION": Knob(
        "swar", "GF(2^8) product formulation: swar | mxu"
    ),
    "MINIO_TPU_CODEC_OVERLAP": Knob(
        "auto", "codec overlap: pipeline | async | off; unset, pipeline on "
        "the card and off on the CPU"
    ),
    "MINIO_TPU_CODEC_SUBCHUNK_KB": Knob(
        "256", "sub-chunk size of the async overlap chain (KiB)"
    ),
    "MINIO_TPU_PARITY_PLANE": Knob(
        "on", "device-resident parity plane: on | off"
    ),
    "MINIO_TPU_PARITY_CACHE_MB": Knob(
        "128", "parity-plane cache budget (MiB)"
    ),
    "MINIO_TPU_PARITY_ACK": Knob(
        "settle", "PUT parity durability ack: settle | early"
    ),
    "MINIO_TPU_DEVICE_BUDGET_MB": Knob(
        "192", "device memory ledger capacity (MiB)"
    ),
    "MINIO_TPU_COMPRESS": Knob("off", "transparent object compression: on | off"),
    "MINIO_TPU_DEVICE_COMPRESS": Knob(
        "auto", "device-side compression codec pass: on | off | auto"
    ),
    "MINIO_TPU_DCOMP_MAX_FILL": Knob(
        "0.75", "device-compression max output fill ratio"
    ),
    "MINIO_TPU_NO_INSTRUMENT": Knob(
        "0", "disable codec telemetry instrumentation"
    ),
    "MINIO_TPU_PLACEMENT": Knob(
        "auto", "device placement policy for sharded ops: span | route | auto"
    ),
    "MINIO_TPU_SUBMESH_DEVICES": Knob(
        "1", "device count for the codec submesh"
    ),
    "MINIO_TPU_SELECT": Knob(
        "auto", "S3 Select engine: device | host | row | auto"
    ),
    # -- caches ------------------------------------------------------------
    "MINIO_TPU_READ_CACHE": Knob(
        "off", "tiered GET read cache: off | host | device | auto"
    ),
    "MINIO_TPU_READ_CACHE_MB": Knob("64", "read cache host tier (MiB)"),
    "MINIO_TPU_READ_CACHE_DEVICE_MB": Knob(
        "64", "read cache device tier (MiB)"
    ),
    "MINIO_TPU_CACHE_DRIVES": Knob(
        "", "disk cache drive paths (comma-separated)"
    ),
    "MINIO_TPU_CACHE_QUOTA_MB": Knob(
        "0", "disk cache quota (MiB, 0 = unlimited)"
    ),
    "MINIO_TPU_BUCKET_META_TTL_S": Knob(
        "code default", "bucket metadata cache TTL (seconds)"
    ),
    # -- storage / io plane ------------------------------------------------
    "MINIO_TPU_IOPOOL_QUEUES": Knob("16", "io-pool queue count"),
    "MINIO_TPU_IOPOOL_DEPTH": Knob("8", "io-pool per-queue depth"),
    "MINIO_TPU_BREAKER": Knob("1", "per-disk circuit breaker: 1 | 0"),
    "MINIO_TPU_BREAKER_TRIP_ERRORS": Knob(
        "5", "consecutive errors that trip a breaker"
    ),
    "MINIO_TPU_BREAKER_SUSPECT_ERRORS": Knob(
        "2", "errors that mark a disk suspect"
    ),
    "MINIO_TPU_BREAKER_BACKOFF_MS": Knob(
        "1000.0", "tripped-breaker probe backoff (ms)"
    ),
    "MINIO_TPU_BREAKER_OUTLIER": Knob(
        "4.0", "latency outlier factor vs the disk median"
    ),
    "MINIO_TPU_BREAKER_SLOW_STRIKES": Knob(
        "code default", "slow-call strikes before suspect"
    ),
    "MINIO_TPU_BREAKER_SLOW_DECAY_MS": Knob(
        "2000.0", "slow-strike decay window (ms)"
    ),
    "MINIO_TPU_HEDGE": Knob("1", "hedged reads: 1 | 0"),
    "MINIO_TPU_HEDGE_FACTOR": Knob(
        "3.0", "hedge trigger factor vs median latency"
    ),
    "MINIO_TPU_HEDGE_MIN_MS": Knob("2.0", "minimum hedge delay (ms)"),
    "MINIO_TPU_HEDGE_MAX_MS": Knob("2000.0", "maximum hedge delay (ms)"),
    "MINIO_TPU_FAULT_INJECTION": Knob(
        "", "enable the fault-injection admin plane: 1 | on | true"
    ),
    "MINIO_TPU_FAULT_SEED": Knob("0", "fault-injection RNG seed"),
    "MINIO_TPU_SANITIZE": Knob(
        "0", "build/load the sanitizer native library variant"
    ),
    "MINIO_TPU_NATIVE_THREADS": Knob(
        "0", "native codec thread count (0 = auto)"
    ),
    # -- background services -----------------------------------------------
    "MINIO_TPU_CRAWL_INTERVAL_S": Knob(
        "60.0", "crawler cycle interval (seconds)"
    ),
    "MINIO_TPU_HEAL_THROTTLE_S": Knob(
        "0.0", "background heal per-object throttle (seconds)"
    ),
    "MINIO_TPU_FRESH_DISK_INTERVAL_S": Knob(
        "10.0", "fresh-disk detection poll interval (seconds)"
    ),
    "MINIO_TPU_IAM_REFRESH_S": Knob(
        "120.0", "IAM store refresh interval (seconds)"
    ),
    # -- dsync / federation ------------------------------------------------
    "MINIO_TPU_LOCK_REFRESH_S": Knob(
        "10.0", "dsync holder-side lock refresh cadence (seconds)"
    ),
    "MINIO_TPU_LOCK_EXPIRY_S": Knob(
        "30.0", "dsync server-side lock expiry (seconds)"
    ),
    "MINIO_TPU_WRITE_LOCK_ACQUIRE_S": Knob(
        "30.0", "namespace write-lock acquire timeout (seconds)"
    ),
    "MINIO_TPU_FEDERATION_DIR": Knob(
        "", "federation bucket-DNS directory path"
    ),
    "MINIO_TPU_FEDERATION_HOST": Knob(
        "", "this node's advertised federation host"
    ),
    # -- gateway / kms / logging -------------------------------------------
    "MINIO_TPU_GATEWAY_ACCESS_KEY": Knob(
        "", "upstream credentials for gateway mode"
    ),
    "MINIO_TPU_GATEWAY_SECRET_KEY": Knob(
        "", "upstream credentials for gateway mode"
    ),
    "MINIO_TPU_GATEWAY_INSECURE": Knob(
        "0", "skip upstream TLS verification in gateway mode"
    ),
    "MINIO_TPU_KMS_MASTER_KEY": Knob(
        "", "local KMS master key (key-id:hex)"
    ),
    "MINIO_TPU_KMS_KES_ENDPOINT": Knob("", "KES server endpoint URL"),
    "MINIO_TPU_KMS_KES_KEY_ID": Knob(
        "minio-tpu", "KES default key id"
    ),
    "MINIO_TPU_KMS_KES_TOKEN": Knob("", "KES API token"),
    "MINIO_TPU_KMS_KES_INSECURE": Knob(
        "0", "skip KES TLS verification"
    ),
    # -- identity --------------------------------------------------------
    "MINIO_TPU_IDENTITY_OPENID_CONFIG_URL": Knob(
        "", "OpenID discovery document URL (web identity)"
    ),
    "MINIO_TPU_IDENTITY_OPENID_CLIENT_ID": Knob(
        "", "OpenID client id the tokens' audience must name"
    ),
    "MINIO_TPU_IDENTITY_OPENID_CLAIM_NAME": Knob(
        "policy", "token claim that names the policies"
    ),
    "MINIO_TPU_LOG": Knob("json", "log format: json | console"),
    "MINIO_TPU_LOG_LEVEL": Knob("info", "log level"),
    "MINIO_TPU_AUDIT_LOG_FILE": Knob(
        "", "audit-log JSON-lines sink path"
    ),
}

# Families whose member names are composed at runtime
# (MINIO_TPU_NOTIFY_<KIND>_<KEY>_<ID>: event notification targets).
PREFIX_KNOBS: "dict[str, Knob]" = {
    "MINIO_TPU_NOTIFY_": Knob(
        "", "event notification target family (webhook/logfile/redis)"
    ),
}

# Knobs of the JAX package's registry that name constructs the port has
# no counterpart of: nothing in the port reads them.  The reason is the
# Knob's description.
JAX_ONLY: "dict[str, Knob]" = {
    "MINIO_TPU_CODEC_INTERPRET": Knob(
        "0", "Pallas interpret mode: the port's kernels are CUDA C++ and "
        "their CPU path is the plain PyTorch version"
    ),
}
