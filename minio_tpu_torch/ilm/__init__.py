"""Object lifecycle management (pkg/bucket/lifecycle)."""

from .lifecycle import (  # noqa: F401
    Action,
    Lifecycle,
    LifecycleError,
    ObjectOpts,
    Rule,
)
