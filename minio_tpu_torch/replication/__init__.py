"""Bucket replication (cmd/bucket-replication.go + pkg/bucket/replication).

``config`` holds the ReplicationConfiguration document model;
``engine`` (see replicate.py) applies it: async replicate-on-write with
crawler catch-up for missed operations.
"""

from .config import ReplicationConfig, ReplicationError, ReplicationRule

__all__ = ["ReplicationConfig", "ReplicationError", "ReplicationRule"]
