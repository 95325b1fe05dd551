"""IAM/bucket policy engine (pkg/iam/policy + pkg/bucket/policy).

Policy documents are the standard AWS JSON shape: Version + Statement
list, each statement carrying Effect / Action / Resource / Condition
(and Principal for bucket policies).  Evaluation follows the reference
(pkg/iam/policy/policy.go IsAllowed): an explicit Deny wins over any
Allow; no match is an implicit deny.

Identity policies (attached to users/groups) have no Principal; bucket
policies are resource policies whose statements name principals ("*"
for anonymous).
"""

from __future__ import annotations

import dataclasses
import fnmatch
import ipaddress
import json

ARN_PREFIX = "arn:aws:s3:::"

# ---------------------------------------------------------------------------
# actions (pkg/iam/policy/action.go)
# ---------------------------------------------------------------------------

# bucket-scoped actions evaluate against arn:aws:s3:::bucket; the rest
# against arn:aws:s3:::bucket/object
BUCKET_ACTIONS = frozenset(
    {
        "s3:CreateBucket",
        "s3:DeleteBucket",
        "s3:GetBucketLocation",
        "s3:ListBucket",
        "s3:ListBucketVersions",
        "s3:ListBucketMultipartUploads",
        "s3:GetBucketPolicy",
        "s3:PutBucketPolicy",
        "s3:DeleteBucketPolicy",
        "s3:GetBucketVersioning",
        "s3:PutBucketVersioning",
        "s3:GetBucketTagging",
        "s3:PutBucketTagging",
        "s3:GetBucketNotification",
        "s3:PutBucketNotification",
        "s3:GetLifecycleConfiguration",
        "s3:PutLifecycleConfiguration",
        "s3:GetBucketObjectLockConfiguration",
        "s3:PutBucketObjectLockConfiguration",
        "s3:GetEncryptionConfiguration",
        "s3:PutEncryptionConfiguration",
        "s3:ListAllMyBuckets",
        "s3:ForceDeleteBucket",
    }
)

OBJECT_ACTIONS = frozenset(
    {
        "s3:GetObject",
        "s3:GetObjectVersion",
        "s3:PutObject",
        "s3:DeleteObject",
        "s3:DeleteObjectVersion",
        "s3:ListMultipartUploadParts",
        "s3:AbortMultipartUpload",
        "s3:GetObjectTagging",
        "s3:PutObjectTagging",
        "s3:DeleteObjectTagging",
        "s3:GetObjectRetention",
        "s3:PutObjectRetention",
        "s3:GetObjectLegalHold",
        "s3:PutObjectLegalHold",
        "s3:SelectObjectContent",
    }
)

ALL_ACTIONS = BUCKET_ACTIONS | OBJECT_ACTIONS


def wildcard_match(pattern: str, s: str) -> bool:
    """pkg/wildcard MatchSimple: '*' any sequence, '?' one char."""
    if pattern == "*":
        return True
    return fnmatch.fnmatchcase(s, pattern)


@dataclasses.dataclass
class Args:
    """Evaluation inputs (pkg/iam/policy/args.go Args)."""

    account: str = ""  # access key ("" = anonymous)
    action: str = ""
    bucket: str = ""
    object: str = ""
    is_owner: bool = False
    conditions: "dict[str, list[str]]" = dataclasses.field(
        default_factory=dict
    )

    @property
    def resource(self) -> str:
        if self.action in BUCKET_ACTIONS:
            return ARN_PREFIX + self.bucket
        return ARN_PREFIX + f"{self.bucket}/{self.object}"


class PolicyError(Exception):
    pass


# ---------------------------------------------------------------------------
# condition functions (pkg/policy/condition)
# ---------------------------------------------------------------------------


def _cond_values(args: Args, key: str) -> list[str]:
    # keys may be written aws:SourceIp / s3:prefix etc; context keys are
    # stored lower-cased without a prefix qualifier
    k = key.split(":", 1)[-1].lower()
    return args.conditions.get(k, [])


def _parse_cond_date(raw: str) -> "float | None":
    """ISO-8601 or epoch-seconds -> unix timestamp."""
    import datetime

    raw = raw.strip()
    if raw.isdigit():
        return float(raw)
    try:
        dt = datetime.datetime.fromisoformat(
            raw.replace("Z", "+00:00")
        )
    except ValueError:
        return None
    if dt.tzinfo is None:
        dt = dt.replace(tzinfo=datetime.timezone.utc)
    return dt.timestamp()


def _num_cmp(base: str, g: str, values: "list[str]") -> bool:
    try:
        gv = float(g)
        vs = [float(v) for v in values]
    except ValueError:
        return False
    return any(
        {
            "NumericEquals": gv == v,
            "NumericNotEquals": gv != v,
            "NumericLessThan": gv < v,
            "NumericLessThanEquals": gv <= v,
            "NumericGreaterThan": gv > v,
            "NumericGreaterThanEquals": gv >= v,
        }[base]
        for v in vs
    )


def _date_cmp(base: str, g: str, values: "list[str]") -> bool:
    gv = _parse_cond_date(g)
    if gv is None:
        return False
    out = False
    for v in values:
        vv = _parse_cond_date(v)
        if vv is None:
            continue
        out = out or {
            "DateEquals": gv == vv,
            "DateNotEquals": gv != vv,
            "DateLessThan": gv < vv,
            "DateLessThanEquals": gv <= vv,
            "DateGreaterThan": gv > vv,
            "DateGreaterThanEquals": gv >= vv,
        }[base]
    return out


def _one_value_matches(base: str, g: str, values: "list[str]") -> bool:
    """Does ONE context value satisfy the operator against the policy
    value set?  (pkg/iam/policy condition function library.)"""
    if base in ("StringEquals", "StringLike"):
        like = base == "StringLike"
        return any(
            (wildcard_match(v, g) if like else v == g) for v in values
        )
    if base in ("StringEqualsIgnoreCase",):
        return any(v.lower() == g.lower() for v in values)
    if base.startswith("Numeric"):
        return _num_cmp(base, g, values)
    if base.startswith("Date"):
        return _date_cmp(base, g, values)
    if base == "Bool":
        return g.lower() in [v.lower() for v in values]
    if base == "IpAddress":
        try:
            addr = ipaddress.ip_address(g)
        except ValueError:
            return False
        for v in values:
            try:
                if addr in ipaddress.ip_network(v, strict=False):
                    return True
            except ValueError:
                continue
        return False
    raise KeyError(base)  # unreachable: _KNOWN_OPS gates callers


_NEGATED = {
    "StringNotEquals": "StringEquals",
    "StringNotLike": "StringLike",
    "StringNotEqualsIgnoreCase": "StringEqualsIgnoreCase",
    "NotIpAddress": "IpAddress",
    "NumericNotEquals": "NumericEquals",
    "DateNotEquals": "DateEquals",
}

# every operator _one_value_matches understands; checked up front so
# a typo'd operator NEVER matches, even under a vacuous ForAllValues
_KNOWN_OPS = frozenset(
    [
        "StringEquals",
        "StringLike",
        "StringEqualsIgnoreCase",
        "Bool",
        "IpAddress",
    ]
    + [
        f"Numeric{suffix}"
        for suffix in (
            "Equals", "LessThan", "LessThanEquals",
            "GreaterThan", "GreaterThanEquals",
        )
    ]
    + [
        f"Date{suffix}"
        for suffix in (
            "Equals", "LessThan", "LessThanEquals",
            "GreaterThan", "GreaterThanEquals",
        )
    ]
)


def _eval_condition(op: str, key: str, values: list[str], args: Args) -> bool:
    got = _cond_values(args, key)
    qualifier = ""
    base = op
    for q in ("ForAllValues:", "ForAnyValue:"):
        if op.startswith(q):
            qualifier, base = q[:-1], op[len(q):]
            break
    if base == "Null":
        want_absent = values and values[0].lower() == "true"
        return (not got) if want_absent else bool(got)
    neg = base in _NEGATED
    pos_base = _NEGATED.get(base, base)
    if pos_base not in _KNOWN_OPS:
        # unknown operator: no match (conservative deny for Allow
        # statements, no effect for Deny)
        return False

    def pred(g: str) -> bool:
        """Does ONE context value satisfy the (possibly negated)
        operator?  The qualifier quantifies over this predicate."""
        hit = _one_value_matches(pos_base, g, values)
        return (not hit) if neg else hit

    if qualifier == "ForAllValues":
        # vacuously true on an absent key (AWS set-operator semantics)
        return all(pred(g) for g in got)
    if qualifier == "ForAnyValue":
        return any(pred(g) for g in got)
    if neg:
        # default negated ops: true on an absent key, else EVERY
        # context value must satisfy the negation
        return all(pred(g) for g in got)
    return bool(got) and any(pred(g) for g in got)


# ---------------------------------------------------------------------------
# statements + policies
# ---------------------------------------------------------------------------


def _as_list(v) -> list:
    if v is None:
        return []
    if isinstance(v, str):
        return [v]
    return list(v)


@dataclasses.dataclass
class Statement:
    effect: str = "Allow"  # "Allow" | "Deny"
    actions: list = dataclasses.field(default_factory=list)
    resources: list = dataclasses.field(default_factory=list)
    conditions: dict = dataclasses.field(default_factory=dict)
    principals: "list | None" = None  # None = identity policy
    sid: str = ""

    @classmethod
    def from_dict(cls, d: dict) -> "Statement":
        effect = d.get("Effect", "")
        if effect not in ("Allow", "Deny"):
            raise PolicyError(f"invalid Effect {effect!r}")
        actions = _as_list(d.get("Action"))
        if not actions:
            raise PolicyError("statement missing Action")
        resources = _as_list(d.get("Resource"))
        principals = None
        if "Principal" in d:
            p = d["Principal"]
            if p == "*":
                principals = ["*"]
            elif isinstance(p, dict):
                principals = _as_list(p.get("AWS"))
            else:
                principals = _as_list(p)
        conditions = d.get("Condition", {}) or {}
        if not isinstance(conditions, dict):
            raise PolicyError("Condition must be an object")
        return cls(
            effect=effect,
            actions=actions,
            resources=resources,
            conditions=conditions,
            principals=principals,
            sid=d.get("Sid", ""),
        )

    def to_dict(self) -> dict:
        d: dict = {"Effect": self.effect, "Action": list(self.actions)}
        if self.sid:
            d["Sid"] = self.sid
        if self.principals is not None:
            d["Principal"] = {"AWS": list(self.principals)}
        if self.resources:
            d["Resource"] = list(self.resources)
        if self.conditions:
            d["Condition"] = self.conditions
        return d

    # -- evaluation -------------------------------------------------------

    def _match_action(self, action: str) -> bool:
        return any(wildcard_match(a, action) for a in self.actions)

    def _match_principal(self, account: str) -> bool:
        if self.principals is None:
            return True  # identity policy: principal implied
        who = account or "*"  # anonymous matches only "*"
        for p in self.principals:
            if p == "*" or p == who:
                return True
            # arn:aws:iam::<acct>:user/<name> form
            if p.rpartition("/")[2] == who:
                return True
        return False

    def _match_resource(self, resource: str) -> bool:
        if not self.resources:
            return True
        target = resource[len(ARN_PREFIX):] if resource.startswith(
            ARN_PREFIX
        ) else resource
        for r in self.resources:
            pat = r[len(ARN_PREFIX):] if r.startswith(ARN_PREFIX) else r
            if wildcard_match(pat, target):
                return True
        return False

    def _match_conditions(self, args: Args) -> bool:
        for op, kv in self.conditions.items():
            for key, values in kv.items():
                if not _eval_condition(op, key, _as_list(values), args):
                    return False
        return True

    def matches(self, args: Args) -> bool:
        return (
            self._match_action(args.action)
            and self._match_principal(args.account)
            and self._match_resource(args.resource)
            and self._match_conditions(args)
        )


@dataclasses.dataclass
class Policy:
    version: str = "2012-10-17"
    statements: list = dataclasses.field(default_factory=list)
    id: str = ""

    @classmethod
    def from_dict(cls, d: dict) -> "Policy":
        stmts = d.get("Statement")
        if stmts is None:
            raise PolicyError("policy missing Statement")
        return cls(
            version=d.get("Version", "2012-10-17"),
            statements=[Statement.from_dict(s) for s in _as_list(stmts)],
            id=d.get("Id", ""),
        )

    @classmethod
    def from_json(cls, raw: "str | bytes") -> "Policy":
        try:
            d = json.loads(raw)
        except (ValueError, TypeError):
            raise PolicyError("malformed policy JSON") from None
        if not isinstance(d, dict):
            raise PolicyError("policy must be a JSON object")
        return cls.from_dict(d)

    def to_dict(self) -> dict:
        d: dict = {
            "Version": self.version,
            "Statement": [s.to_dict() for s in self.statements],
        }
        if self.id:
            d["Id"] = self.id
        return d

    def to_json(self) -> str:
        return json.dumps(self.to_dict())

    def is_allowed(self, args: Args) -> bool:
        """Deny overrides allow; default deny (policy.go IsAllowed)."""
        allowed = False
        for s in self.statements:
            if not s.matches(args):
                continue
            if s.effect == "Deny":
                return False
            allowed = True
        return allowed

    def validate_bucket(self, bucket: str) -> None:
        """Bucket policies must reference only their own bucket
        (PutBucketPolicyHandler validation)."""
        for s in self.statements:
            if s.principals is None:
                raise PolicyError("bucket policy requires Principal")
            for r in s.resources:
                pat = (
                    r[len(ARN_PREFIX):]
                    if r.startswith(ARN_PREFIX)
                    else r
                )
                b = pat.split("/", 1)[0]
                if not wildcard_match(b, bucket):
                    raise PolicyError(
                        f"resource {r!r} outside bucket {bucket!r}"
                    )


# ---------------------------------------------------------------------------
# canned policies (cmd/iam.go defaults)
# ---------------------------------------------------------------------------


def _canned(statements: list) -> Policy:
    return Policy(statements=[Statement.from_dict(s) for s in statements])


CANNED_POLICIES: "dict[str, Policy]" = {
    "readonly": _canned(
        [
            {
                "Effect": "Allow",
                "Action": ["s3:GetBucketLocation", "s3:GetObject"],
                "Resource": [ARN_PREFIX + "*"],
            }
        ]
    ),
    "readwrite": _canned(
        [
            {
                "Effect": "Allow",
                "Action": ["s3:*"],
                "Resource": [ARN_PREFIX + "*"],
            }
        ]
    ),
    "writeonly": _canned(
        [
            {
                "Effect": "Allow",
                "Action": ["s3:PutObject"],
                "Resource": [ARN_PREFIX + "*"],
            }
        ]
    ),
    "diagnostics": _canned(
        [
            {
                "Effect": "Allow",
                "Action": ["s3:ListAllMyBuckets"],
                "Resource": [ARN_PREFIX + "*"],
            }
        ]
    ),
}
