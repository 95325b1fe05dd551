"""Runtime KV configuration subsystem (cmd/config/config.go:188-278).

``Config = {subsys: {target: {key: value}}}`` with a registered-defaults
layer, persisted as one JSON document under the meta volume and
runtime-editable through the admin API with cluster-wide peer reload.
"""

from .sys import (
    DEFAULT_TARGET,
    ConfigError,
    ConfigSys,
    register_default_kvs,
    registered_defaults,
)

__all__ = [
    "ConfigSys",
    "ConfigError",
    "DEFAULT_TARGET",
    "register_default_kvs",
    "registered_defaults",
]
