"""NotificationConfiguration parsing + rule matching
(pkg/event/config.go ParseConfig, pkg/event/rules.go RulesMap).

The wire format is the S3 XML document::

    <NotificationConfiguration>
      <QueueConfiguration>
        <Id>1</Id>
        <Queue>arn:minio:sqs::primary:webhook</Queue>
        <Event>s3:ObjectCreated:*</Event>
        <Filter><S3Key>
          <FilterRule><Name>prefix</Name><Value>logs/</Value></FilterRule>
          <FilterRule><Name>suffix</Name><Value>.txt</Value></FilterRule>
        </S3Key></Filter>
      </QueueConfiguration>
    </NotificationConfiguration>

Validation mirrors the reference: unknown event names and ARNs not
registered in the target list are rejected at PUT time
(config.Validate, pkg/event/config.go:280-303).
"""

from __future__ import annotations

import dataclasses
import fnmatch
import xml.etree.ElementTree as ET

from .event import EventName

S3_NS = "http://s3.amazonaws.com/doc/2006-03-01/"


class NotificationError(Exception):
    """Malformed or invalid notification configuration."""


def _local(tag: str) -> str:
    return tag.split("}")[-1]


def _find_all(el: ET.Element, name: str) -> "list[ET.Element]":
    return [c for c in el.iter() if _local(c.tag) == name]


def _child_text(el: ET.Element, name: str) -> str:
    for c in el:
        if _local(c.tag) == name:
            return c.text or ""
    return ""


@dataclasses.dataclass
class Queue:
    """One QueueConfiguration entry."""

    id: str
    arn: str
    events: "list[str]"
    prefix: str = ""
    suffix: str = ""

    def __post_init__(self):
        # expanded once here so matches() on the dispatch hot path is a
        # set lookup, not a rebuild per event
        self._covered = frozenset(
            n for e in self.events for n in EventName.expand(e)
        )

    def matches(self, event_name: str, key: str) -> bool:
        if event_name not in self._covered:
            return False
        if self.prefix and not key.startswith(self.prefix):
            return False
        if self.suffix and not key.endswith(self.suffix):
            return False
        return True


@dataclasses.dataclass
class NotificationConfig:
    queues: "list[Queue]" = dataclasses.field(default_factory=list)

    @classmethod
    def from_xml(cls, raw: bytes) -> "NotificationConfig":
        if not raw.strip():
            return cls()
        try:
            root = ET.fromstring(raw)
        except ET.ParseError as e:
            raise NotificationError(f"malformed XML: {e}") from None
        if _local(root.tag) != "NotificationConfiguration":
            raise NotificationError(
                f"unexpected root element {_local(root.tag)}"
            )
        queues = []
        for qc in _find_all(root, "QueueConfiguration"):
            arn = _child_text(qc, "Queue")
            events = [
                (e.text or "").strip()
                for e in qc
                if _local(e.tag) == "Event"
            ]
            if not arn or not events:
                raise NotificationError(
                    "QueueConfiguration needs a Queue ARN and >=1 Event"
                )
            for name in events:
                if not EventName.valid(name):
                    raise NotificationError(f"unknown event {name!r}")
            prefix = suffix = ""
            for fr in _find_all(qc, "FilterRule"):
                fr_name = _child_text(fr, "Name").lower()
                fr_val = _child_text(fr, "Value")
                if fr_name == "prefix":
                    prefix = fr_val
                elif fr_name == "suffix":
                    suffix = fr_val
                else:
                    raise NotificationError(
                        f"unsupported filter rule {fr_name!r}"
                    )
            queues.append(
                Queue(
                    id=_child_text(qc, "Id"),
                    arn=arn,
                    events=events,
                    prefix=prefix,
                    suffix=suffix,
                )
            )
        # the reference also accepts Topic/CloudFunction configurations;
        # minio routes everything through queue targets, as do we
        if _find_all(root, "TopicConfiguration") or _find_all(
            root, "CloudFunctionConfiguration"
        ):
            raise NotificationError(
                "only QueueConfiguration targets are supported"
            )
        return cls(queues)

    def validate(self, known_arns: "set[str]") -> None:
        """Reject ARNs with no registered target (config.Validate)."""
        for q in self.queues:
            if not any(
                fnmatch.fnmatchcase(q.arn, pat) or q.arn == pat
                for pat in known_arns
            ):
                raise NotificationError(
                    f"unregistered notification target {q.arn!r}"
                )

    def to_xml(self) -> bytes:
        root = ET.Element(
            "NotificationConfiguration", xmlns=S3_NS
        )
        for q in self.queues:
            qc = ET.SubElement(root, "QueueConfiguration")
            if q.id:
                ET.SubElement(qc, "Id").text = q.id
            ET.SubElement(qc, "Queue").text = q.arn
            for e in q.events:
                ET.SubElement(qc, "Event").text = e
            if q.prefix or q.suffix:
                f = ET.SubElement(qc, "Filter")
                s3k = ET.SubElement(f, "S3Key")
                for name, val in (
                    ("prefix", q.prefix),
                    ("suffix", q.suffix),
                ):
                    if val:
                        fr = ET.SubElement(s3k, "FilterRule")
                        ET.SubElement(fr, "Name").text = name
                        ET.SubElement(fr, "Value").text = val
        return (
            b'<?xml version="1.0" encoding="UTF-8"?>\n'
            + ET.tostring(root)
        )


class RulesMap:
    """bucket -> parsed config, with per-event target resolution
    (pkg/event/rules.go, cached per bucket like bucketRulesMap)."""

    def __init__(self):
        self._configs: "dict[str, NotificationConfig]" = {}

    def set(self, bucket: str, config: NotificationConfig) -> None:
        if config.queues:
            self._configs[bucket] = config
        else:
            self._configs.pop(bucket, None)

    def remove(self, bucket: str) -> None:
        self._configs.pop(bucket, None)

    def match(
        self, bucket: str, event_name: str, key: str
    ) -> "list[str]":
        """ARNs whose rules match this event."""
        cfg = self._configs.get(bucket)
        if cfg is None:
            return []
        return [
            q.arn
            for q in cfg.queues
            if q.matches(event_name, key)
        ]

    def has_rules(self, bucket: str) -> bool:
        return bucket in self._configs
