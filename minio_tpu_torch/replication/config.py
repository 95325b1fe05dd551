"""ReplicationConfiguration document model
(pkg/bucket/replication/replication.go).

Rules select objects by prefix; each rule names a destination bucket
ARN.  The mid-2020 reference replicates to one remote target per
bucket, asynchronously, and repairs missed replications on crawler
passes (data-crawler.go:756 healReplication).
"""

from __future__ import annotations

import dataclasses
import xml.etree.ElementTree as ET

from ..utils.xmlutil import child as _child, child_text as _child_text, strip_ns as _strip_ns

_S3_NS = "http://s3.amazonaws.com/doc/2006-03-01/"

# minio-style target ARN: arn:minio:replication:<region>:<id>:<bucket>
ARN_PREFIX = "arn:minio:replication:"


class ReplicationError(Exception):
    pass


@dataclasses.dataclass
class ReplicationRule:
    rule_id: str = ""
    status: str = "Enabled"  # Enabled | Disabled
    prefix: str = ""
    priority: int = 0
    destination_arn: str = ""  # arn:...:bucket or plain bucket name

    @property
    def enabled(self) -> bool:
        return self.status == "Enabled"

    @property
    def target_bucket(self) -> str:
        """Destination bucket from the ARN (or the raw name)."""
        arn = self.destination_arn
        for prefix in (ARN_PREFIX, "arn:aws:s3:::"):
            if arn.startswith(prefix):
                return arn[len(prefix):].rpartition(":")[2]
        return arn

    def matches(self, key: str) -> bool:
        return self.enabled and key.startswith(self.prefix)


@dataclasses.dataclass
class ReplicationConfig:
    role: str = ""
    rules: "list[ReplicationRule]" = dataclasses.field(
        default_factory=list
    )

    @classmethod
    def from_xml(cls, body: bytes) -> "ReplicationConfig":
        try:
            root = ET.fromstring(body)
        except ET.ParseError:
            raise ReplicationError("malformed XML") from None
        if _strip_ns(root.tag) != "ReplicationConfiguration":
            raise ReplicationError("not a ReplicationConfiguration")
        cfg = cls()
        for el in root:
            name = _strip_ns(el.tag)
            if name == "Role":
                cfg.role = (el.text or "").strip()
            elif name == "Rule":
                # direct children only: Rule/Status must not be read
                # from e.g. DeleteMarkerReplication/Status
                status = _child_text(el, "Status") or "Enabled"
                if status not in ("Enabled", "Disabled"):
                    raise ReplicationError(f"invalid Status {status!r}")
                dest_el = _child(el, "Destination")
                dest = (
                    _child_text(dest_el, "Bucket")
                    if dest_el is not None
                    else ""
                )
                if not dest:
                    raise ReplicationError("Rule missing Destination Bucket")
                try:
                    priority = int(_child_text(el, "Priority") or "0")
                except ValueError:
                    raise ReplicationError("bad Priority") from None
                # prefix may be rule-level (legacy) or inside
                # Filter / Filter/And (current schema)
                prefix = _child_text(el, "Prefix")
                if not prefix:
                    f = _child(el, "Filter")
                    if f is not None:
                        prefix = _child_text(f, "Prefix")
                        if not prefix:
                            a = _child(f, "And")
                            if a is not None:
                                prefix = _child_text(a, "Prefix")
                cfg.rules.append(
                    ReplicationRule(
                        rule_id=_child_text(el, "ID"),
                        status=status,
                        prefix=prefix,
                        priority=priority,
                        destination_arn=dest,
                    )
                )
        if not cfg.rules:
            raise ReplicationError("at least one Rule is required")
        return cfg

    def to_xml(self) -> bytes:
        import xml.sax.saxutils as sx

        parts = [
            '<?xml version="1.0" encoding="UTF-8"?>\n',
            f'<ReplicationConfiguration xmlns="{_S3_NS}">',
        ]
        if self.role:
            parts.append(f"<Role>{sx.escape(self.role)}</Role>")
        for r in sorted(self.rules, key=lambda x: -x.priority):
            parts.append(
                "<Rule>"
                + (f"<ID>{sx.escape(r.rule_id)}</ID>" if r.rule_id else "")
                + f"<Status>{r.status}</Status>"
                + f"<Priority>{r.priority}</Priority>"
                + f"<Prefix>{sx.escape(r.prefix)}</Prefix>"
                + "<Destination><Bucket>"
                + sx.escape(r.destination_arn)
                + "</Bucket></Destination></Rule>"
            )
        parts.append("</ReplicationConfiguration>")
        return "".join(parts).encode()

    def rule_for(self, key: str) -> "ReplicationRule | None":
        """Highest-priority enabled rule matching the key
        (replication.Config.FilterActionableRules)."""
        best = None
        for r in self.rules:
            if r.matches(key) and (
                best is None or r.priority > best.priority
            ):
                best = r
        return best
