"""On-demand profiling (admin profiling start/download,
cmd/admin-handlers.go StartProfilingHandler + DownloadProfilingData;
the reference collects pprof profiles per node and zips them).

cProfile for "cpu", tracemalloc snapshots for "mem"; results are
per-node bytes (pstats dump / tracemalloc top lines) the admin API
zips together.
"""

from __future__ import annotations

import cProfile
import io
import pstats
import threading


class Profiler:
    def __init__(self):
        self._mu = threading.Lock()
        self._cpu: "cProfile.Profile | None" = None
        self._mem = False

    def start(self, kind: str = "cpu") -> None:
        with self._mu:
            if kind == "cpu":
                if self._cpu is not None:
                    raise RuntimeError("cpu profiling already running")
                self._cpu = cProfile.Profile()
                self._cpu.enable()
            elif kind == "mem":
                import tracemalloc

                if not tracemalloc.is_tracing():
                    tracemalloc.start()
                self._mem = True
            else:
                raise ValueError(f"unknown profiler {kind!r}")

    def stop(self, kind: str = "cpu") -> bytes:
        """Stop + return the profile artifact bytes."""
        with self._mu:
            if kind == "cpu":
                if self._cpu is None:
                    raise RuntimeError("cpu profiling not running")
                self._cpu.disable()
                buf = io.StringIO()
                stats = pstats.Stats(self._cpu, stream=buf)
                stats.sort_stats("cumulative").print_stats(100)
                self._cpu = None
                return buf.getvalue().encode()
            if kind == "mem":
                import tracemalloc

                if not self._mem:
                    raise RuntimeError("mem profiling not running")
                snap = tracemalloc.take_snapshot()
                self._mem = False
                tracemalloc.stop()
                lines = [
                    str(s) for s in snap.statistics("lineno")[:200]
                ]
                return "\n".join(lines).encode()
            raise ValueError(f"unknown profiler {kind!r}")

    @property
    def running(self) -> "list[str]":
        with self._mu:
            out = []
            if self._cpu is not None:
                out.append("cpu")
            if self._mem:
                out.append("mem")
            return out
