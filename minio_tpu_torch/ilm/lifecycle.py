"""Bucket lifecycle configuration + evaluation
(pkg/bucket/lifecycle/lifecycle.go ComputeAction,
pkg/bucket/lifecycle/rule.go validation).

Wire format is the S3 LifecycleConfiguration XML::

    <LifecycleConfiguration>
      <Rule>
        <ID>expire-logs</ID>
        <Status>Enabled</Status>
        <Filter><Prefix>logs/</Prefix></Filter>
        <Expiration><Days>30</Days></Expiration>
        <NoncurrentVersionExpiration>
          <NoncurrentDays>7</NoncurrentDays>
        </NoncurrentVersionExpiration>
        <AbortIncompleteMultipartUpload>
          <DaysAfterInitiation>3</DaysAfterInitiation>
        </AbortIncompleteMultipartUpload>
      </Rule>
    </LifecycleConfiguration>

Evaluation is pure: ``compute_action(opts)`` maps an object's state to
the action the crawler should take, exactly the ComputeAction seam the
reference's data crawler drives (cmd/data-crawler.go:877-907).
"""

from __future__ import annotations

import dataclasses
import datetime
import xml.etree.ElementTree as ET


class LifecycleError(Exception):
    """Malformed or invalid lifecycle configuration."""


class Action:
    NONE = "none"
    DELETE = "delete"  # expire the (unversioned/current) object
    DELETE_VERSION = "delete-version"  # expire a noncurrent version
    ABORT_MULTIPART = "abort-multipart"


def _local(tag: str) -> str:
    return tag.split("}")[-1]


def _child(el: "ET.Element | None", name: str) -> "ET.Element | None":
    if el is None:
        return None
    for c in el:
        if _local(c.tag) == name:
            return c
    return None


def _text(el: "ET.Element | None", name: str) -> str:
    c = _child(el, name)
    return (c.text or "").strip() if c is not None else ""


def _parse_days(el: "ET.Element | None", name: str) -> "int | None":
    raw = _text(el, name)
    if not raw:
        return None
    try:
        days = int(raw)
    except ValueError:
        raise LifecycleError(f"{name} must be an integer") from None
    if days <= 0:
        raise LifecycleError(f"{name} must be positive")
    return days


def _parse_date(el: "ET.Element | None") -> "float | None":
    raw = _text(el, "Date")
    if not raw:
        return None
    try:
        dt = datetime.datetime.fromisoformat(raw.replace("Z", "+00:00"))
    except ValueError:
        raise LifecycleError(f"bad Expiration Date {raw!r}") from None
    if dt.tzinfo is None:
        dt = dt.replace(tzinfo=datetime.timezone.utc)
    return dt.timestamp()


def _parse_tag(el: ET.Element) -> "tuple[str, str]":
    key = _text(el, "Key")
    if not key:
        raise LifecycleError("Filter Tag must carry a Key")
    return key, _text(el, "Value")


def _parse_filter(
    filt: "ET.Element | None",
) -> "tuple[str, list[tuple[str, str]]]":
    """(prefix, tags) from a <Filter> holding exactly one of
    Prefix | Tag | And (filter.go Validate)."""
    if filt is None:
        return "", []
    prefix_el = _child(filt, "Prefix")
    tag_el = _child(filt, "Tag")
    and_el = _child(filt, "And")
    populated = sum(
        1
        for el, check in (
            (prefix_el, prefix_el is not None and (prefix_el.text or "").strip()),
            (tag_el, tag_el is not None),
            (and_el, and_el is not None),
        )
        if check
    )
    if populated > 1:
        raise LifecycleError(
            "Filter must have exactly one of Prefix, Tag, or And"
        )
    if and_el is not None:
        tags = [
            _parse_tag(c) for c in and_el if _local(c.tag) == "Tag"
        ]
        keys = [k for k, _ in tags]
        if len(keys) != len(set(keys)):
            raise LifecycleError("duplicate Tag key in And")
        return _text(and_el, "Prefix"), tags
    if tag_el is not None:
        return "", [_parse_tag(tag_el)]
    return _text(filt, "Prefix"), []


@dataclasses.dataclass
class Rule:
    id: str = ""
    status: str = "Enabled"
    prefix: str = ""
    # tag scoping (pkg/bucket/lifecycle/filter.go TestTags): every
    # (key, value) here must appear among the object's tags
    tags: "list[tuple[str, str]]" = dataclasses.field(
        default_factory=list
    )
    expire_days: "int | None" = None
    expire_date_ts: "float | None" = None
    expire_delete_marker: bool = False
    noncurrent_days: "int | None" = None
    abort_multipart_days: "int | None" = None

    @property
    def enabled(self) -> bool:
        return self.status == "Enabled"

    def match_prefix(self, key: str) -> bool:
        return key.startswith(self.prefix)

    def match_tags(self, user_tags: str) -> bool:
        """user_tags is the URL-encoded x-amz-tagging form the object
        layer stores (the reference passes ObjectOpts.UserTags the
        same way, lifecycle.go:169)."""
        if not self.tags:
            return True
        import urllib.parse

        have = dict(
            urllib.parse.parse_qsl(user_tags, keep_blank_values=True)
        )
        return all(have.get(k) == v for k, v in self.tags)


@dataclasses.dataclass
class ObjectOpts:
    """Everything ComputeAction looks at (lifecycle.go ObjectOpts)."""

    name: str
    mod_time_ns: int = 0
    is_latest: bool = True
    delete_marker: bool = False
    num_versions: int = 1
    # URL-encoded object tags (ObjectOpts.UserTags)
    user_tags: str = ""
    # for noncurrent versions: when the version BECAME noncurrent
    # (successor mod time); falls back to the version's own mod time
    successor_mod_time_ns: int = 0


@dataclasses.dataclass
class Lifecycle:
    rules: "list[Rule]" = dataclasses.field(default_factory=list)

    # -- parsing ----------------------------------------------------------

    @classmethod
    def from_xml(cls, raw: bytes) -> "Lifecycle":
        try:
            root = ET.fromstring(raw)
        except ET.ParseError as e:
            raise LifecycleError(f"malformed XML: {e}") from None
        if _local(root.tag) not in (
            "LifecycleConfiguration",
            "BucketLifecycleConfiguration",
        ):
            raise LifecycleError(
                f"unexpected root element {_local(root.tag)}"
            )
        rules = []
        for rel in root:
            if _local(rel.tag) != "Rule":
                continue
            status = _text(rel, "Status")
            if status not in ("Enabled", "Disabled"):
                raise LifecycleError("Rule Status must be Enabled|Disabled")
            # Transition actions are unsupported - reject loudly like
            # the reference (errTransitionUnsupported, pkg/bucket/
            # lifecycle/transition.go), never silently drop an action
            # the user asked for
            for unsup in ("Transition", "NoncurrentVersionTransition"):
                if _child(rel, unsup) is not None:
                    raise LifecycleError(
                        f"Specifying <{unsup}> is not supported"
                    )
            # <Filter> holds exactly one of Prefix | Tag | And
            # (filter.go:66 Validate); legacy top-level <Prefix> also
            # accepted
            filt = _child(rel, "Filter")
            prefix, tags = _parse_filter(filt)
            if not prefix:
                prefix = _text(rel, "Prefix")
            exp = _child(rel, "Expiration")
            nve = _child(rel, "NoncurrentVersionExpiration")
            aimu = _child(rel, "AbortIncompleteMultipartUpload")
            rule = Rule(
                id=_text(rel, "ID"),
                status=status,
                prefix=prefix,
                tags=tags,
                expire_days=_parse_days(exp, "Days"),
                expire_date_ts=_parse_date(exp),
                expire_delete_marker=(
                    _text(exp, "ExpiredObjectDeleteMarker") == "true"
                ),
                noncurrent_days=_parse_days(nve, "NoncurrentDays"),
                abort_multipart_days=_parse_days(
                    aimu, "DaysAfterInitiation"
                ),
            )
            if rule.expire_days and rule.expire_date_ts:
                raise LifecycleError(
                    "Expiration takes Days OR Date, not both"
                )
            if not (
                rule.expire_days
                or rule.expire_date_ts
                or rule.expire_delete_marker
                or rule.noncurrent_days
                or rule.abort_multipart_days
            ):
                raise LifecycleError(
                    f"rule {rule.id!r} specifies no action"
                )
            rules.append(rule)
        if not rules:
            raise LifecycleError("no rules")
        if len(rules) > 1000:
            raise LifecycleError("too many rules (max 1000)")
        ids = [r.id for r in rules if r.id]
        if len(ids) != len(set(ids)):
            raise LifecycleError("duplicate rule ID")
        return cls(rules)

    def to_xml(self) -> bytes:
        root = ET.Element("LifecycleConfiguration")
        for r in self.rules:
            rel = ET.SubElement(root, "Rule")
            if r.id:
                ET.SubElement(rel, "ID").text = r.id
            ET.SubElement(rel, "Status").text = r.status
            f = ET.SubElement(rel, "Filter")
            if r.tags and (r.prefix or len(r.tags) > 1):
                a = ET.SubElement(f, "And")
                if r.prefix:
                    ET.SubElement(a, "Prefix").text = r.prefix
                for k, v in r.tags:
                    t = ET.SubElement(a, "Tag")
                    ET.SubElement(t, "Key").text = k
                    ET.SubElement(t, "Value").text = v
            elif r.tags:
                t = ET.SubElement(f, "Tag")
                ET.SubElement(t, "Key").text = r.tags[0][0]
                ET.SubElement(t, "Value").text = r.tags[0][1]
            elif r.prefix:
                ET.SubElement(f, "Prefix").text = r.prefix
            if r.expire_days or r.expire_date_ts or r.expire_delete_marker:
                e = ET.SubElement(rel, "Expiration")
                if r.expire_days:
                    ET.SubElement(e, "Days").text = str(r.expire_days)
                if r.expire_date_ts:
                    ET.SubElement(e, "Date").text = (
                        datetime.datetime.fromtimestamp(
                            r.expire_date_ts, tz=datetime.timezone.utc
                        ).strftime("%Y-%m-%dT%H:%M:%SZ")
                    )
                if r.expire_delete_marker:
                    ET.SubElement(
                        e, "ExpiredObjectDeleteMarker"
                    ).text = "true"
            if r.noncurrent_days:
                n = ET.SubElement(rel, "NoncurrentVersionExpiration")
                ET.SubElement(n, "NoncurrentDays").text = str(
                    r.noncurrent_days
                )
            if r.abort_multipart_days:
                a = ET.SubElement(rel, "AbortIncompleteMultipartUpload")
                ET.SubElement(a, "DaysAfterInitiation").text = str(
                    r.abort_multipart_days
                )
        return (
            b'<?xml version="1.0" encoding="UTF-8"?>\n'
            + ET.tostring(root)
        )

    # -- evaluation -------------------------------------------------------

    def compute_action(
        self, opts: ObjectOpts, now_ns: "int | None" = None
    ) -> str:
        """The crawler seam (lifecycle.go:237 ComputeAction)."""
        import time as _t

        now = now_ns if now_ns is not None else _t.time_ns()
        day_ns = 86400 * 10**9
        for r in self.rules:
            if not r.enabled or not r.match_prefix(opts.name):
                continue
            if not opts.is_latest:
                # tag gate applies here too.  DELIBERATE DIVERGENCE:
                # the reference's FilterActionableRules exempts
                # NoncurrentVersionExpiration from the tag test
                # (lifecycle.go:165-167), which lets a tag-scoped rule
                # destroy noncurrent versions of objects the user
                # scoped OUT - AWS applies the filter, and so do we
                if r.noncurrent_days and r.match_tags(opts.user_tags):
                    since = (
                        opts.successor_mod_time_ns or opts.mod_time_ns
                    )
                    if now - since >= r.noncurrent_days * day_ns:
                        return Action.DELETE_VERSION
                continue
            if opts.delete_marker:
                # a marker whose older versions are all gone is litter
                if r.expire_delete_marker and opts.num_versions == 1:
                    return Action.DELETE_VERSION
                continue
            # tag scoping applies to the expiration family only; the
            # delete-marker and noncurrent actions above act per-key
            # regardless of tags (FilterActionableRules,
            # lifecycle.go:141-173)
            if not r.match_tags(opts.user_tags):
                continue
            if r.expire_date_ts and now >= r.expire_date_ts * 10**9:
                return Action.DELETE
            if (
                r.expire_days
                and opts.mod_time_ns
                and now - opts.mod_time_ns >= r.expire_days * day_ns
            ):
                return Action.DELETE
        return Action.NONE

    def abort_multipart_before_ns(
        self, key: str, now_ns: "int | None" = None
    ) -> "int | None":
        """Cutoff before which an incomplete upload for ``key`` should
        be aborted, or None when no rule applies."""
        import time as _t

        now = now_ns if now_ns is not None else _t.time_ns()
        day_ns = 86400 * 10**9
        cutoffs = [
            now - r.abort_multipart_days * day_ns
            for r in self.rules
            if r.enabled and r.abort_multipart_days and r.match_prefix(key)
        ]
        return max(cutoffs) if cutoffs else None
