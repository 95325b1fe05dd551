"""Object lock / retention / legal hold (WORM).

The S3 object-lock data model and enforcement rules from the reference's
``pkg/bucket/object/lock/lock.go`` and ``cmd/bucket-object-lock.go``:

- A bucket may carry an ``ObjectLockConfiguration`` (only on buckets
  created with object-lock enabled, which forces versioning).  Its
  optional default retention rule stamps every new object version.
- An object version carries retention (mode GOVERNANCE/COMPLIANCE +
  retain-until date) and/or a legal hold flag in its user metadata.
- Deletion of a version is blocked while the legal hold is ON or the
  retain-until date is in the future; GOVERNANCE can be bypassed by a
  caller holding ``s3:BypassGovernanceRetention`` who set the
  ``x-amz-bypass-governance-retention: true`` header
  (``enforceRetentionBypassForDelete``, cmd/bucket-object-lock.go:83).
"""

from __future__ import annotations

import dataclasses
import datetime
import xml.etree.ElementTree as ET

# metadata keys on the object version (objectlock.AmzObjectLock* keys)
META_MODE = "x-amz-object-lock-mode"
META_RETAIN_UNTIL = "x-amz-object-lock-retain-until-date"
META_LEGAL_HOLD = "x-amz-object-lock-legal-hold"

GOVERNANCE = "GOVERNANCE"
COMPLIANCE = "COMPLIANCE"

from ..utils.xmlutil import findtext as _findtext, strip_ns as _strip_ns

_S3_NS = "http://s3.amazonaws.com/doc/2006-03-01/"


class ObjectLockError(Exception):
    """Malformed object-lock configuration or headers."""


def utcnow() -> datetime.datetime:
    return datetime.datetime.now(datetime.timezone.utc)


def parse_iso8601(value: str) -> datetime.datetime:
    """RetainUntilDate parser - accepts the AWS ISO8601 forms."""
    v = value.strip()
    if v.endswith("Z"):
        v = v[:-1] + "+00:00"
    try:
        dt = datetime.datetime.fromisoformat(v)
    except ValueError:
        raise ObjectLockError(f"invalid date {value!r}") from None
    if dt.tzinfo is None:
        dt = dt.replace(tzinfo=datetime.timezone.utc)
    return dt


def format_iso8601(dt: datetime.datetime) -> str:
    return dt.astimezone(datetime.timezone.utc).strftime(
        "%Y-%m-%dT%H:%M:%SZ"
    )


@dataclasses.dataclass
class DefaultRetention:
    mode: str = ""  # GOVERNANCE | COMPLIANCE
    days: int = 0
    years: int = 0


@dataclasses.dataclass
class ObjectLockConfig:
    """Parsed ObjectLockConfiguration document."""

    enabled: bool = True
    default: "DefaultRetention | None" = None

    @classmethod
    def from_xml(cls, body: bytes) -> "ObjectLockConfig":
        try:
            root = ET.fromstring(body)
        except ET.ParseError:
            raise ObjectLockError("malformed XML") from None
        if _strip_ns(root.tag) != "ObjectLockConfiguration":
            raise ObjectLockError("not an ObjectLockConfiguration")
        enabled_s = _findtext(root, "ObjectLockEnabled")
        if enabled_s and enabled_s != "Enabled":
            raise ObjectLockError("ObjectLockEnabled must be 'Enabled'")
        default = None
        mode = _findtext(root, "Mode")
        if mode:
            if mode not in (GOVERNANCE, COMPLIANCE):
                raise ObjectLockError(f"invalid Mode {mode!r}")
            days_s = _findtext(root, "Days")
            years_s = _findtext(root, "Years")
            if bool(days_s) == bool(years_s):
                raise ObjectLockError(
                    "exactly one of Days or Years is required"
                )
            try:
                days = int(days_s) if days_s else 0
                years = int(years_s) if years_s else 0
            except ValueError:
                raise ObjectLockError("Days/Years must be integers") from None
            if days < 0 or years < 0 or (days_s and days == 0) or (
                years_s and years == 0
            ):
                raise ObjectLockError("Days/Years must be positive")
            default = DefaultRetention(mode, days, years)
        return cls(enabled=True, default=default)

    def to_xml(self) -> bytes:
        rule = ""
        if self.default is not None:
            dur = (
                f"<Days>{self.default.days}</Days>"
                if self.default.days
                else f"<Years>{self.default.years}</Years>"
            )
            rule = (
                "<Rule><DefaultRetention>"
                f"<Mode>{self.default.mode}</Mode>{dur}"
                "</DefaultRetention></Rule>"
            )
        return (
            '<?xml version="1.0" encoding="UTF-8"?>\n'
            f'<ObjectLockConfiguration xmlns="{_S3_NS}">'
            "<ObjectLockEnabled>Enabled</ObjectLockEnabled>"
            f"{rule}</ObjectLockConfiguration>"
        ).encode()

    def default_retention_meta(self) -> dict:
        """Metadata stamped on new versions by the default rule
        (checkPutObjectLockAllowed, cmd/object-handlers.go)."""
        if self.default is None:
            return {}
        until = utcnow() + datetime.timedelta(
            days=self.default.days + 365 * self.default.years
        )
        return {
            META_MODE: self.default.mode,
            META_RETAIN_UNTIL: format_iso8601(until),
        }


@dataclasses.dataclass
class Retention:
    mode: str = ""
    retain_until: "datetime.datetime | None" = None

    @property
    def valid(self) -> bool:
        return self.mode in (GOVERNANCE, COMPLIANCE)

    @classmethod
    def from_xml(cls, body: bytes) -> "Retention":
        try:
            root = ET.fromstring(body)
        except ET.ParseError:
            raise ObjectLockError("malformed XML") from None
        if _strip_ns(root.tag) != "Retention":
            raise ObjectLockError("not a Retention document")
        mode = _findtext(root, "Mode")
        until_s = _findtext(root, "RetainUntilDate")
        if mode not in (GOVERNANCE, COMPLIANCE):
            raise ObjectLockError(f"invalid Mode {mode!r}")
        if not until_s:
            raise ObjectLockError("RetainUntilDate is required")
        until = parse_iso8601(until_s)
        if until <= utcnow():
            raise ObjectLockError("RetainUntilDate must be in the future")
        return cls(mode, until)

    @classmethod
    def from_meta(cls, user_defined: dict) -> "Retention":
        mode = user_defined.get(META_MODE, "")
        until_s = user_defined.get(META_RETAIN_UNTIL, "")
        if not mode or not until_s:
            return cls()
        try:
            return cls(mode, parse_iso8601(until_s))
        except ObjectLockError:
            return cls()

    def to_xml(self) -> bytes:
        return (
            '<?xml version="1.0" encoding="UTF-8"?>\n'
            f'<Retention xmlns="{_S3_NS}">'
            f"<Mode>{self.mode}</Mode>"
            f"<RetainUntilDate>{format_iso8601(self.retain_until)}"
            "</RetainUntilDate></Retention>"
        ).encode()


def parse_legal_hold_xml(body: bytes) -> str:
    try:
        root = ET.fromstring(body)
    except ET.ParseError:
        raise ObjectLockError("malformed XML") from None
    if _strip_ns(root.tag) != "LegalHold":
        raise ObjectLockError("not a LegalHold document")
    status = _findtext(root, "Status")
    if status not in ("ON", "OFF"):
        raise ObjectLockError("Status must be ON or OFF")
    return status


def legal_hold_xml(status: str) -> bytes:
    return (
        '<?xml version="1.0" encoding="UTF-8"?>\n'
        f'<LegalHold xmlns="{_S3_NS}">'
        f"<Status>{status}</Status></LegalHold>"
    ).encode()


def retention_meta_from_headers(headers: dict) -> dict:
    """Explicit per-object lock headers on PUT
    (x-amz-object-lock-*, objectlock.ParseObjectLockHeaders)."""
    lower = {k.lower(): v for k, v in headers.items()}
    mode = lower.get(META_MODE, "")
    until_s = lower.get(META_RETAIN_UNTIL, "")
    hold = lower.get(META_LEGAL_HOLD, "")
    meta: dict = {}
    if bool(mode) != bool(until_s):
        raise ObjectLockError(
            "x-amz-object-lock-mode and "
            "x-amz-object-lock-retain-until-date must both be present"
        )
    if mode:
        if mode.upper() not in (GOVERNANCE, COMPLIANCE):
            raise ObjectLockError(f"unknown WORM mode {mode!r}")
        until = parse_iso8601(until_s)
        if until <= utcnow():
            raise ObjectLockError("retain date must be in the future")
        meta[META_MODE] = mode.upper()
        meta[META_RETAIN_UNTIL] = format_iso8601(until)
    if hold:
        if hold.upper() not in ("ON", "OFF"):
            raise ObjectLockError("legal hold must be ON or OFF")
        meta[META_LEGAL_HOLD] = hold.upper()
    return meta


def is_governance_bypass(headers: dict) -> bool:
    for k, v in headers.items():
        if k.lower() == "x-amz-bypass-governance-retention":
            return v.strip().lower() == "true"
    return False


def retention_blocks_delete(
    user_defined: dict, bypass_governance: bool = False
) -> "str | None":
    """Why (if at all) this version cannot be deleted right now.

    Returns None when deletion may proceed, "legal-hold" or "retention"
    otherwise.  ``bypass_governance`` reflects a caller who both set the
    bypass header AND holds the bypass permission - GOVERNANCE yields to
    it, COMPLIANCE never does (enforceRetentionBypassForDelete).
    """
    if user_defined.get(META_LEGAL_HOLD, "") == "ON":
        return "legal-hold"
    ret = Retention.from_meta(user_defined)
    if not ret.valid or ret.retain_until is None:
        return None
    if ret.retain_until <= utcnow():
        return None
    if ret.mode == GOVERNANCE and bypass_governance:
        return None
    return "retention"
