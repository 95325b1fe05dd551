"""ConfigSys: persisted, runtime-editable server configuration
(cmd/config/config.go Config map + RegisterDefaultKVS at :164,
admin set-config-kv at cmd/admin-router.go:89).

Layering (highest wins):
  1. persisted KV edits (admin set-config-kv, stored in
     ``.sys/config/config.json`` through the object layer)
  2. process environment (``MINIO_TPU_<SUBSYS>_<KEY>``)
  3. registered defaults

``apply()`` pushes the effective values into the runtime seams that
read environment variables per call (heal intervals, API limits), so an
admin edit takes effect without restart.

The ``codec`` keys differ from the JAX package's.  ``backend`` takes
``cuda`` (the default) or ``cpu``; ``tpu`` and ``auto`` are refused
with a ConfigError.  Every erasure set takes its device and its codec
backend (batcher included) when the object layer is built at boot, so
an edit of a ``codec`` key is persisted and takes effect at the next
boot: it never moves a running server onto the CPU, and ``apply()``
leaves the running backends alone.  ``compression`` and ``crawler``
keys are stored and applied to their env seams: the object layer reads
MINIO_TPU_COMPRESS per PUT, so ``compression enable=on`` takes effect on
the next PUT, and the data crawler re-reads MINIO_TPU_CRAWL_INTERVAL_S
each cycle, so ``crawler interval_s`` takes effect from the next wait.
"""

from __future__ import annotations

import io
import json
import os
import threading

from ..utils.log import kv, logger

_log = logger("config")

DEFAULT_TARGET = "_"
CONFIG_PATH = "config/config.json"


class ConfigError(Exception):
    pass


# -- registry (RegisterDefaultKVS, config.go:164) ------------------------

_DEFAULTS: "dict[str, dict[str, str]]" = {}
_HELP: "dict[str, dict[str, str]]" = {}


def register_default_kvs(
    subsys: str, kvs: "dict[str, str]", help_text: "dict[str, str] | None" = None
) -> None:
    _DEFAULTS[subsys] = dict(kvs)
    _HELP[subsys] = dict(help_text or {})


def registered_defaults() -> "dict[str, dict[str, str]]":
    return {s: dict(k) for s, k in _DEFAULTS.items()}


# the subsystems this framework exposes (config-current.go initHelp set,
# trimmed to what has a runtime seam here)
register_default_kvs(
    "compression",
    {"enable": "off"},
    {"enable": "on|off: transparent object compression"},
)
register_default_kvs(
    "heal",
    {"throttle_s": "0", "fresh_disk_interval_s": "10"},
    {
        "throttle_s": "sleep between background heal tasks",
        "fresh_disk_interval_s": "fresh-disk monitor poll interval",
    },
)
register_default_kvs(
    "crawler",
    {"interval_s": "60"},
    {"interval_s": "data crawler cycle interval"},
)
register_default_kvs(
    "api",
    {"requests_max": "0", "requests_deadline_s": "10"},
    {
        "requests_max": "max concurrent S3 requests (0 = auto)",
        "requests_deadline_s": "seconds a queued request may wait",
    },
)
register_default_kvs(
    "codec",
    {"backend": "cuda", "batch": "on", "batch_deadline_ms": "4"},
    {
        "backend": "cuda|cpu erasure codec device (next boot)",
        "batch": "on|off cross-request codec batching",
        "batch_deadline_ms": "batch flush deadline",
    },
)
register_default_kvs(
    "logger",
    {"level": "info"},
    {"level": "debug|info|warning|error"},
)

# key -> (parser, min_value): values must parse and clear the floor -
# a bad value written to the env seam would otherwise kill or busy-loop
# the background thread reading it
_NUMERIC_KEYS: "dict[tuple[str, str], tuple] " = {
    ("heal", "throttle_s"): (float, 0.0),
    ("heal", "fresh_disk_interval_s"): (float, 1.0),
    ("crawler", "interval_s"): (float, 1.0),
    ("api", "requests_max"): (int, 0),
    ("api", "requests_deadline_s"): (float, 0.1),
    ("codec", "batch_deadline_ms"): (float, 0.0),
}

# keys whose value is one of a fixed set: the codec device is the card
# or, when asked for, the CPU - never a TPU, and there is no auto mode
_CHOICE_KEYS: "dict[tuple[str, str], tuple[str, ...]]" = {
    ("codec", "backend"): ("cuda", "cpu"),
}

# config key -> the env var its runtime seam reads
_ENV_SEAMS: "dict[tuple[str, str], str]" = {
    ("compression", "enable"): "MINIO_TPU_COMPRESS",
    ("heal", "throttle_s"): "MINIO_TPU_HEAL_THROTTLE_S",
    ("heal", "fresh_disk_interval_s"): "MINIO_TPU_FRESH_DISK_INTERVAL_S",
    ("crawler", "interval_s"): "MINIO_TPU_CRAWL_INTERVAL_S",
    ("api", "requests_max"): "MINIO_TPU_REQUESTS_MAX",
    ("api", "requests_deadline_s"): "MINIO_TPU_REQUESTS_DEADLINE_S",
    ("codec", "backend"): "MINIO_ERASURE_BACKEND",
    ("codec", "batch"): "MINIO_CODEC_BATCH",
    ("codec", "batch_deadline_ms"): "MINIO_CODEC_BATCH_DEADLINE_MS",
    ("logger", "level"): "MINIO_TPU_LOG_LEVEL",
}


class ConfigSys:
    """Persisted config document + in-memory effective view."""

    def __init__(self, object_layer=None):
        self._ol = object_layer
        self._mu = threading.RLock()
        # persisted edits only (defaults/env are layered at read time)
        self._kv: "dict[str, dict[str, dict[str, str]]]" = {}
        # operator env values saved before apply() overwrote them, so
        # deleting an edit restores the pre-edit layering
        self._orig_env: "dict[str, str | None]" = {}
        self.notifier = None  # peer control plane
        if object_layer is not None:
            self.reload()

    # -- persistence ------------------------------------------------------

    def reload(self) -> None:
        """Re-read the persisted document (peer-reload entry point)."""
        if self._ol is None:
            return
        from ..objectlayer.api import (
            META_BUCKET,
            BucketNotFound,
            ObjectNotFound,
        )

        buf = io.BytesIO()
        try:
            self._ol.get_object(META_BUCKET, CONFIG_PATH, buf)
            doc = json.loads(buf.getvalue())
        except (ObjectNotFound, BucketNotFound):
            doc = {}
        except ValueError:
            doc = {}
        if not isinstance(doc, dict):
            doc = {}
        with self._mu:
            self._kv = doc

    def _persist(self) -> None:
        if self._ol is None:
            return
        from ..objectlayer.api import META_BUCKET

        with self._mu:
            raw = json.dumps(self._kv).encode()
        self._ol.put_object(
            META_BUCKET, CONFIG_PATH, io.BytesIO(raw), len(raw)
        )

    # -- reads ------------------------------------------------------------

    def get(
        self, subsys: str, key: str, target: str = DEFAULT_TARGET
    ) -> str:
        """Effective value: persisted edit > env > registered default."""
        with self._mu:
            v = (
                self._kv.get(subsys, {})
                .get(target, {})
                .get(key)
            )
        if v is not None:
            return v
        env = _ENV_SEAMS.get((subsys, key))
        if env and os.environ.get(env) is not None:
            return os.environ[env]
        d = _DEFAULTS.get(subsys, {}).get(key)
        if d is None:
            raise ConfigError(f"unknown config key {subsys}.{key}")
        return d

    def dump(self) -> dict:
        """Full effective config (admin get-config)."""
        out: dict = {}
        for subsys, defaults in _DEFAULTS.items():
            kvs = {}
            for key in defaults:
                kvs[key] = self.get(subsys, key)
            out[subsys] = {DEFAULT_TARGET: kvs}
        # carry custom targets verbatim
        with self._mu:
            for subsys, targets in self._kv.items():
                for target, kvs in targets.items():
                    if target == DEFAULT_TARGET:
                        continue
                    out.setdefault(subsys, {})[target] = dict(kvs)
        return out

    def help(self, subsys: str) -> dict:
        if subsys not in _DEFAULTS:
            raise ConfigError(f"unknown subsystem {subsys!r}")
        return dict(_HELP.get(subsys, {}))

    # -- writes (admin set-config-kv / del-config-kv) ---------------------

    def set_kvs(
        self,
        subsys: str,
        kvs: "dict[str, str]",
        target: str = DEFAULT_TARGET,
    ) -> None:
        if subsys not in _DEFAULTS:
            raise ConfigError(f"unknown subsystem {subsys!r}")
        import math

        for k, v in kvs.items():
            if k not in _DEFAULTS[subsys]:
                raise ConfigError(f"unknown key {subsys}.{k}")
            choices = _CHOICE_KEYS.get((subsys, k))
            if choices is not None and str(v) not in choices:
                raise ConfigError(
                    f"{subsys}.{k} must be one of {'|'.join(choices)}, "
                    f"got {v!r}"
                )
            spec = _NUMERIC_KEYS.get((subsys, k))
            if spec is not None:
                parser, floor = spec
                try:
                    num = parser(v)
                except (TypeError, ValueError):
                    raise ConfigError(
                        f"{subsys}.{k} must be {parser.__name__}, "
                        f"got {v!r}"
                    ) from None
                if not math.isfinite(num) or num < floor:
                    raise ConfigError(
                        f"{subsys}.{k} must be a finite number "
                        f">= {floor}"
                    )
        with self._mu:
            self._kv.setdefault(subsys, {}).setdefault(target, {}).update(
                {k: str(v) for k, v in kvs.items()}
            )
        self._persist()
        self.apply()
        if self.notifier is not None:
            self.notifier.config_changed()

    def del_kvs(self, subsys: str, target: str = DEFAULT_TARGET) -> None:
        """Reset a subsystem back to defaults (del-config-kv)."""
        if subsys not in _DEFAULTS:
            raise ConfigError(f"unknown subsystem {subsys!r}")
        with self._mu:
            self._kv.get(subsys, {}).pop(target, None)
            if not self._kv.get(subsys):
                self._kv.pop(subsys, None)
        self._persist()
        self.apply()
        if self.notifier is not None:
            self.notifier.config_changed()

    # -- runtime application ---------------------------------------------

    def apply(self) -> None:
        """Push effective values into the env seams the runtime reads
        per call.  Persisted edits win; without one, the seam keeps
        whatever the operator exported at process start."""
        with self._mu:
            edited = {
                (s, k)
                for s, targets in self._kv.items()
                for k in targets.get(DEFAULT_TARGET, {})
            }
        logger_touched = False
        for (subsys, key), env in _ENV_SEAMS.items():
            if (subsys, key) in edited:
                if env not in self._orig_env:
                    self._orig_env[env] = os.environ.get(env)
                os.environ[env] = self.get(subsys, key)
                logger_touched = logger_touched or subsys == "logger"
            elif env in self._orig_env:
                # edit was deleted: restore the operator's value
                orig = self._orig_env.pop(env)
                if orig is None:
                    os.environ.pop(env, None)
                else:
                    os.environ[env] = orig
                logger_touched = logger_touched or subsys == "logger"
        # codec keys: the sets built at boot hold their backend, so the
        # env seam is written for the next boot and nothing is reset
        if logger_touched:
            # log level is applied at setup time, not read per call
            from ..utils import log

            try:
                log.setup(self.get("logger", "level"))
            except Exception as exc:
                _log.warning("logger level re-apply failed", extra=kv(err=str(exc)))
