"""Request -> S3 action classification + authorization dispatch
(cmd/auth-handler.go:272 checkRequestAuthType + the per-handler action
constants in cmd/object-handlers.go / bucket-handlers.go).

``action_for_request`` maps (method, bucket, key, query) onto the IAM
action the reference's handler would check; ``authorize`` runs the
identity-policy or bucket-policy decision.
"""

from __future__ import annotations

from ..iam.policy import Args
from .s3errors import S3Error

_BUCKET_GET_SUBRESOURCES = {
    # FIRST: must mirror the router's dispatch precedence - a request
    # carrying several sub-resources is authorized for the one that
    # will actually serve it, and the router checks ?events first
    "events": "s3:ListenBucketNotification",
    "location": "s3:GetBucketLocation",
    "policy": "s3:GetBucketPolicy",
    "versioning": "s3:GetBucketVersioning",
    "tagging": "s3:GetBucketTagging",
    "lifecycle": "s3:GetLifecycleConfiguration",
    "notification": "s3:GetBucketNotification",
    "uploads": "s3:ListBucketMultipartUploads",
    "versions": "s3:ListBucketVersions",
    "object-lock": "s3:GetBucketObjectLockConfiguration",
    "encryption": "s3:GetEncryptionConfiguration",
    "replication": "s3:GetReplicationConfiguration",
    # ACL stubs are gated on the policy action (acl-handlers.go:142)
    "acl": "s3:GetBucketPolicy",
}

_BUCKET_PUT_SUBRESOURCES = {
    "policy": "s3:PutBucketPolicy",
    "versioning": "s3:PutBucketVersioning",
    "tagging": "s3:PutBucketTagging",
    "lifecycle": "s3:PutLifecycleConfiguration",
    "notification": "s3:PutBucketNotification",
    "object-lock": "s3:PutBucketObjectLockConfiguration",
    "encryption": "s3:PutEncryptionConfiguration",
    "replication": "s3:PutReplicationConfiguration",
    "acl": "s3:PutBucketPolicy",
}

_BUCKET_DELETE_SUBRESOURCES = {
    "policy": "s3:DeleteBucketPolicy",
    "tagging": "s3:PutBucketTagging",
    "lifecycle": "s3:PutLifecycleConfiguration",
    "encryption": "s3:PutEncryptionConfiguration",
    "replication": "s3:PutReplicationConfiguration",
}

_OBJECT_GET_SUBRESOURCES = {
    "tagging": "s3:GetObjectTagging",
    "retention": "s3:GetObjectRetention",
    "legal-hold": "s3:GetObjectLegalHold",
}

_OBJECT_PUT_SUBRESOURCES = {
    "tagging": "s3:PutObjectTagging",
    "retention": "s3:PutObjectRetention",
    "legal-hold": "s3:PutObjectLegalHold",
}


def action_for_request(
    method: str,
    bucket: str,
    key: str,
    query: "dict[str, list[str]]",
    headers: "dict[str, str] | None" = None,
) -> str:
    headers = headers or {}
    if not bucket:
        return "s3:ListAllMyBuckets"
    if key:
        if method == "GET":
            for sub, action in _OBJECT_GET_SUBRESOURCES.items():
                if sub in query:
                    return action
            if "uploadId" in query:
                return "s3:ListMultipartUploadParts"
            if "versionId" in query:
                return "s3:GetObjectVersion"
            return "s3:GetObject"
        if method == "HEAD":
            if "versionId" in query:
                return "s3:GetObjectVersion"
            return "s3:GetObject"
        if method == "PUT":
            for sub, action in _OBJECT_PUT_SUBRESOURCES.items():
                if sub in query:
                    return action
            return "s3:PutObject"
        if method == "POST":
            if "select" in query:
                return "s3:SelectObjectContent"
            return "s3:PutObject"  # initiate/complete multipart
        if method == "DELETE":
            if "uploadId" in query:
                return "s3:AbortMultipartUpload"
            if "tagging" in query:
                return "s3:DeleteObjectTagging"
            if "versionId" in query:
                return "s3:DeleteObjectVersion"
            return "s3:DeleteObject"
        raise S3Error("MethodNotAllowed")
    # bucket-level
    if method == "GET":
        for sub, action in _BUCKET_GET_SUBRESOURCES.items():
            if sub in query:
                return action
        return "s3:ListBucket"
    if method == "HEAD":
        return "s3:ListBucket"
    if method == "PUT":
        for sub, action in _BUCKET_PUT_SUBRESOURCES.items():
            if sub in query:
                return action
        return "s3:CreateBucket"
    if method == "DELETE":
        for sub, action in _BUCKET_DELETE_SUBRESOURCES.items():
            if sub in query:
                return action
        return "s3:DeleteBucket"
    if method == "POST":
        # ?delete (multi-delete) authorizes per key inside the handler;
        # POST policy form uploads authorize as PutObject after the form
        # signature verifies
        return "s3:PutObject" if "delete" not in query else "s3:DeleteObject"
    raise S3Error("MethodNotAllowed")


def condition_values(
    query: "dict[str, list[str]]",
    headers: "dict[str, str]",
    client_ip: str = "",
) -> "dict[str, list[str]]":
    """Context keys for policy Condition evaluation
    (cmd/auth-handler.go getConditionValues)."""
    cond: "dict[str, list[str]]" = {}
    for qk, ck in (
        ("prefix", "prefix"),
        ("delimiter", "delimiter"),
        ("max-keys", "max-keys"),
        ("versionid", "versionid"),
    ):
        for k, v in query.items():
            if k.lower() == qk and v:
                cond[ck] = [v[0]]
    lower = {k.lower(): v for k, v in headers.items()}
    if "referer" in lower:
        cond["referer"] = [lower["referer"]]
    if client_ip:
        cond["sourceip"] = [client_ip]
    for k, v in lower.items():
        if k.startswith("x-amz-"):
            cond[k] = [v]
    return cond


def is_reserved_bucket(bucket: str) -> bool:
    """The meta volume (any dot-prefixed name) and the router prefix
    are never reachable as S3 buckets (isMinioMetaBucketName /
    reserved-bucket guard; "minio-tpu" shadows the admin/metrics
    mounts)."""
    return bucket.startswith(".") or bucket == "minio-tpu"


def authorize(
    iam,
    bucket_policy,
    account: str,
    action: str,
    bucket: str,
    key: str,
    conditions: "dict[str, list[str]]",
) -> bool:
    """The reference's two-source decision: identity policy for
    authenticated accounts, resource (bucket) policy for anonymous."""
    args = Args(
        account=account,
        action=action,
        bucket=bucket,
        object=key,
        conditions=conditions,
    )
    if account:
        # authenticated accounts are decided by identity policy alone,
        # matching the mid-2020 reference (auth-handler.go:272: IAMSys
        # for credentials, PolicySys only for anonymous)
        return iam.is_allowed(args)
    if bucket_policy is None:
        return False
    return bucket_policy.is_allowed(args)
