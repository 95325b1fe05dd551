"""Shared, mtime-keyed AST cache for the file-walking passes.

The analyzer grew from one AST pass to three (hot-path lint, the
callgraph builder, and the deviceflow rules) — re-reading and
re-parsing the whole tree per pass triples the dominant cost of a lint
run for zero benefit.  ``python -m minio_tpu_torch.analysis`` parses each
file ONCE through this cache and hands the parsed modules to every
pass; cache entries are keyed on ``(mtime_ns, size)`` so an edit
between passes (or between CLI runs inside one long-lived process,
e.g. the tier-1 test session) re-parses exactly the edited files.

Entries hold the raw text, the split lines (for noqa filtering), and
the parsed ``ast.Module`` — or ``None`` with the ``SyntaxError`` kept,
so every pass sees the same MTPU100-shaped truth for a broken file.
"""

from __future__ import annotations

import ast
import dataclasses
import os


@dataclasses.dataclass
class ParsedModule:
    """One cached source file: text + lines + AST (or the parse error)."""

    rel_path: str
    text: str
    lines: "list[str]"
    tree: "ast.Module | None"
    error: "SyntaxError | None" = None


class AstCache:
    def __init__(self):
        # rel_path -> ((mtime_ns, size), ParsedModule)
        self._entries: "dict[str, tuple[tuple[int, int], ParsedModule]]" = {}

    def _stamp(self, abs_path: str) -> "tuple[int, int]":
        st = os.stat(abs_path)
        return (st.st_mtime_ns, st.st_size)

    def get(self, rel_path: str) -> ParsedModule:
        """The parsed module for a repo-relative path, (re)parsed iff
        the file changed since the last call."""
        from . import REPO_ROOT

        abs_path = os.path.join(REPO_ROOT, rel_path)
        stamp = self._stamp(abs_path)
        hit = self._entries.get(rel_path)
        if hit is not None and hit[0] == stamp:
            return hit[1]
        with open(abs_path, encoding="utf-8") as fh:
            text = fh.read()
        parsed = parse_source(rel_path, text)
        self._entries[rel_path] = (stamp, parsed)
        return parsed

    def load(self, rel_paths: "list[str]") -> "dict[str, ParsedModule]":
        """Parsed modules for a file set, ordered like the input."""
        return {rel: self.get(rel) for rel in rel_paths}

    def invalidate(self) -> None:
        self._entries.clear()


def parse_source(rel_path: str, text: str) -> ParsedModule:
    """Parse source that is already in memory (fixtures, seeded
    canaries, mutated copies) into the same shape the cache serves."""
    lines = text.splitlines()
    try:
        tree = ast.parse(text, filename=rel_path)
    except SyntaxError as e:
        return ParsedModule(rel_path, text, lines, None, e)
    return ParsedModule(rel_path, text, lines, tree)


# process-wide cache: the CLI, run_lint and the deviceflow pass all
# share it, which is the whole point
CACHE = AstCache()
