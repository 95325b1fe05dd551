"""S3 Select: SQL over streamed CSV/JSON/Parquet objects
(pkg/s3select in the reference; handler at cmd/object-handlers.go:91
SelectObjectContentHandler).

A recursive-descent SQL parser and row-at-a-time evaluator (``sql``),
streaming record readers (``csvio``, ``jsonio``, ``parquetio``), AWS
EventStream response framing (``message``), the columnar host scans
(``vector``), the device pre-filter (``device``, on the kernels of
``ops/select_step.py``), and the orchestrator (``engine``) that wires
request XML -> reader -> evaluator -> framed response.
"""

from .engine import S3Select, SelectError

__all__ = ["S3Select", "SelectError"]
