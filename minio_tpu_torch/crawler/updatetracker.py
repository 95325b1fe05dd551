"""Seam of the data-update tracker (cmd/data-update-tracker.go:63).

In the JAX package every object mutation marks its path into a bloom
journal the data crawler reads to skip clean buckets.  The tracker and
the crawler come with slice 9d; until then the object layer calls this
same-named seam, which records nothing, and the server starts neither.
"""

from __future__ import annotations


def object_path_updated(path: str) -> None:
    """Mark ``path`` dirty for the crawler: a no-op until slice 9d."""
    del path
