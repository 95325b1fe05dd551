"""Ellipses endpoint expansion + set layout math.

The CLI arg syntax of the reference (pkg/ellipses + endpoint-ellipses.go):
``http://host{1...4}/disk{1...8}`` expands to the cross-product of ranges,
and the total drive count is divided into erasure sets of 4-16 drives
using the greatest valid symmetric divisor (getSetIndexes,
endpoint-ellipses.go:132; docs/distributed/DESIGN.md:38-48).
"""

from __future__ import annotations

import itertools
import re

_ELLIPSIS = re.compile(r"\{(\d+)\.\.\.(\d+)\}")

# valid erasure set sizes (docs/distributed/DESIGN.md:40; the reference
# uses 4-16, we additionally allow 2 for tiny test layouts)
SET_SIZES = tuple(range(2, 17))


def has_ellipses(arg: str) -> bool:
    return bool(_ELLIPSIS.search(arg))


def expand(arg: str) -> list[str]:
    """Expand every {a...b} range in the pattern (cross-product order:
    rightmost varies fastest, matching the reference's arg expansion)."""
    spans = list(_ELLIPSIS.finditer(arg))
    if not spans:
        return [arg]
    ranges = []
    for m in spans:
        lo, hi = int(m.group(1)), int(m.group(2))
        if hi < lo:
            raise ValueError(f"bad range {m.group(0)}")
        width = len(m.group(1)) if m.group(1).startswith("0") else 0
        ranges.append(
            [str(v).zfill(width) for v in range(lo, hi + 1)]
        )
    out = []
    for combo in itertools.product(*ranges):
        s = arg
        # replace right-to-left so spans stay valid
        for m, v in zip(reversed(spans), reversed(combo)):
            s = s[: m.start()] + v + s[m.end() :]
        out.append(s)
    return out


def expand_all(args: list[str]) -> list[str]:
    out = []
    for a in args:
        out.extend(expand(a))
    return out


def get_set_size(count: int) -> int:
    """Drives per set: the largest valid size dividing count evenly."""
    for size in sorted(SET_SIZES, reverse=True):
        if count % size == 0:
            return size
    raise ValueError(
        f"cannot partition {count} drives into sets of {SET_SIZES}"
    )


def layout(count: int) -> tuple[int, int]:
    """(set_count, drives_per_set) for a drive count."""
    size = get_set_size(count)
    return count // size, size
