"""Web UI backend: the browser's JSON-RPC control plane plus
upload/download endpoints (cmd/web-handlers.go:81, web-router.go).

Wire shape matches the reference's jsonrpc usage::

    POST /minio-tpu/webrpc
    {"id": 1, "jsonrpc": "2.0", "method": "web.ListBuckets",
     "params": {}}

``web.Login`` exchanges credentials for a JWT (signed with the
server's root secret, like the reference's authenticateWeb); every
other method requires it as a Bearer token.  File transfer rides
dedicated endpoints so bodies stream instead of riding JSON:

    PUT  /minio-tpu/web/upload/<bucket>/<object>     (Bearer token)
    GET  /minio-tpu/web/download/<bucket>/<object>?token=<url token>
    POST /minio-tpu/web/zip?token=<url token>        (JSON object list)

Uploads go through the S3 PUT's invariant chain (``_checked_put``), so
they erasure-code on the codec's device like any PUT; downloads and
zips read through the object layer's decode.  The console page
(console_ui.py) is served at ``/minio-tpu/console``.
"""

from __future__ import annotations

import hmac
import json
import time
import urllib.parse
import zipfile

from ..codec import sse as ssemod
from ..event.event import EventName
from ..iam.policy import Args, Policy, PolicyError
from ..iam.sys import generate_credentials
from ..utils import jwt
from ..utils.hashreader import HashReader
from . import s3errors
from .auth import AuthContext, presign_url
from .console_ui import CONSOLE_HTML
from .s3errors import S3Error

RPC_PATH = "/minio-tpu/webrpc"
WEB_PREFIX = "/minio-tpu/web"
CONSOLE_PATH = "/minio-tpu/console"
TOKEN_EXPIRY_S = 24 * 3600
URL_TOKEN_EXPIRY_S = 3600
UI_VERSION = "minio-tpu-web/1"


class WebError(Exception):
    pass


def is_web_path(path: str) -> bool:
    """Whether the router hands ``path`` to ``handle``."""
    return (
        path in (RPC_PATH, CONSOLE_PATH)
        or path.startswith(WEB_PREFIX + "/")
    )


def _auth_token(h) -> str:
    """Validated access key from the request's Bearer token."""
    authz = h.headers.get("Authorization", "")
    if not authz.startswith("Bearer "):
        raise WebError("authentication required")
    try:
        claims = jwt.verify(
            authz[len("Bearer "):], h.s3.iam.root_secret_key
        )
    except jwt.JWTError as e:
        raise WebError(f"invalid token: {e}") from None
    return claims.get("sub", "")


def _allow(h, access_key: str, action: str, bucket: str,
           key: str = "") -> None:
    """One IAM/policy decision for a web call - the same authorize()
    the S3 plane runs (a read-only user must be read-only here too)."""
    h._query = {}
    if not h._check_action(action, bucket, key, access_key):
        raise WebError("access denied")


# -- RPC methods ------------------------------------------------------------


def _login(h, params) -> dict:
    username = params.get("username", "")
    password = params.get("password", "")
    secret = h.s3.iam.lookup_secret(username)
    if secret is None or not hmac.compare_digest(secret, password):
        raise WebError("invalid credentials")
    if h.s3.iam.is_temp_credential(username):
        # a 24h web JWT must not outlive a short-lived STS credential
        raise WebError(
            "temporary credentials cannot log into the web console"
        )
    token = jwt.sign(
        {"sub": username}, h.s3.iam.root_secret_key, expiry_s=TOKEN_EXPIRY_S
    )
    return {"token": token, "uiVersion": UI_VERSION}


def _server_info(h, params, access_key) -> dict:
    return {
        "MinioVersion": UI_VERSION,
        "MinioMemory": "",
        "MinioPlatform": "",
        "MinioRuntime": "python",
        "MinioGlobalInfo": {
            "isDistErasure": h.s3.peer_notifier is not None,
            "serverTime_ns": time.time_ns(),
        },
        "MinioUserInfo": {"isIAMUser": False},
    }


def _storage_info(h, params, access_key) -> dict:
    return h.s3.object_layer.storage_info()


def _list_buckets(h, params, access_key) -> dict:
    out = []
    for b in h.s3.object_layer.list_buckets():
        if b.name.startswith("."):
            continue
        # per-bucket visibility, like the reference's web ListBuckets
        # (readable buckets only)
        try:
            _allow(h, access_key, "s3:ListBucket", b.name)
        except WebError:
            continue
        out.append(
            {"name": b.name, "creationDate_ns": b.created_ns}
        )
    return {"buckets": out}


def _make_bucket(h, params, access_key) -> dict:
    bucket = params.get("bucketName", "")
    _allow(h, access_key, "s3:CreateBucket", bucket)
    # the shared path keeps web creates federation-unique
    h._bucket_create(bucket)
    return {}


def _delete_bucket(h, params, access_key) -> dict:
    bucket = params.get("bucketName", "")
    _allow(h, access_key, "s3:DeleteBucket", bucket)
    # the shared path unregisters DNS + drops config/event rules
    h._bucket_delete(bucket)
    return {}


def _list_objects(h, params, access_key) -> dict:
    _allow(h, access_key, "s3:ListBucket", params.get("bucketName", ""))
    res = h.s3.object_layer.list_objects(
        params.get("bucketName", ""),
        params.get("prefix", ""),
        params.get("marker", ""),
        "/",
        int(params.get("maxKeys", 1000)),
    )
    return {
        "objects": [
            {
                "name": o.name,
                "size": o.size,
                "lastModified_ns": o.mod_time_ns,
                "contentType": o.content_type,
                "etag": o.etag,
            }
            for o in res.objects
        ]
        + [{"name": p, "size": 0, "isDir": True} for p in res.prefixes],
        "isTruncated": res.is_truncated,
        "nextMarker": res.next_marker,
    }


def _remove_objects(h, params, access_key) -> dict:
    bucket = params.get("bucketName", "")
    removed, errors = [], []
    versioned, suspended = h._versioning(bucket)
    _set_event_principal(h, access_key)
    for name in params.get("objects", []):
        try:
            _allow(h, access_key, "s3:DeleteObject", bucket, name)
            dinfo = h.s3.object_layer.delete_object(
                bucket, name,
                versioned=versioned, version_suspended=suspended,
            )
            removed.append(name)
            # versioned buckets write a delete marker, a distinct
            # event with the marker's version id (http _delete_object)
            h._notify(
                EventName.OBJECT_REMOVED_DELETE_MARKER
                if dinfo.delete_marker
                else EventName.OBJECT_REMOVED_DELETE,
                bucket, name, version_id=dinfo.version_id,
            )
        except Exception as e:  # noqa: BLE001
            errors.append({"object": name, "error": str(e)})
    return {"removed": removed, "errors": errors}


def _presigned_get(h, params, access_key) -> dict:
    bucket = params.get("bucketName", "")
    obj = params.get("objectName", "")
    expiry = min(int(params.get("expiry", 3600)), 7 * 24 * 3600)
    _allow(h, access_key, "s3:GetObject", bucket, obj)
    secret = h.s3.iam.lookup_secret(access_key)
    if secret is None:
        raise WebError("credentials no longer valid")
    url = presign_url(
        "GET",
        f"{h.s3.endpoint}/{bucket}/{urllib.parse.quote(obj)}",
        access_key,
        secret,
        expires=expiry,
        region=h.s3.region,
    )
    return {"url": url}


def _create_url_token(h, params, access_key) -> dict:
    return {
        "token": jwt.sign(
            {"sub": access_key, "web-url-token": True},
            h.s3.iam.root_secret_key,
            expiry_s=URL_TOKEN_EXPIRY_S,
        )
    }


def _get_bucket_policy(h, params, access_key) -> dict:
    bucket = params.get("bucketName", "")
    _allow(h, access_key, "s3:GetBucketPolicy", bucket)
    h.s3.object_layer.get_bucket_info(bucket)
    return {
        "policy": h.s3.bucket_meta.get(bucket).policy_json or ""
    }


def _set_bucket_policy(h, params, access_key) -> dict:
    bucket = params.get("bucketName", "")
    _allow(h, access_key, "s3:PutBucketPolicy", bucket)
    h.s3.object_layer.get_bucket_info(bucket)
    raw = params.get("policy", "")
    if raw:
        try:
            Policy.from_json(raw)
        except (PolicyError, ValueError) as e:
            raise WebError(f"bad policy: {e}") from None
    h.s3.bucket_meta.update(bucket, policy_json=raw)
    return {}


def _generate_auth(h, params, access_key) -> dict:
    """Fresh random credential pair for the console's 'generate'
    button (web-handlers.go:823 GenerateAuth); owner only, nothing is
    persisted until SetAuth/add-user applies it."""
    if not h.s3.iam.is_owner(access_key):
        raise WebError("only the owner can generate credentials")
    ak, sk = generate_credentials()
    return {"accessKey": ak, "secretKey": sk}


def _set_auth(h, params, access_key) -> dict:
    """Change the calling IAM user's OWN secret key after proving the
    current one (web-handlers.go:850 SetAuth); the owner's root
    credential cannot be changed through the browser."""
    if h.s3.iam.is_owner(access_key):
        raise WebError(
            "owner credentials cannot be changed via the console"
        )
    current = params.get("currentSecretKey", "")
    new = params.get("newSecretKey", "")
    secret = h.s3.iam.lookup_secret(access_key)
    if secret is None or not hmac.compare_digest(secret, current):
        raise WebError("current secret key does not match")
    if len(new) < 8:
        raise WebError("new secret key must be at least 8 characters")
    h.s3.iam.set_user_secret(access_key, new)
    return {}


_LEVELS = {
    (True, True): "readwrite",
    (True, False): "readonly",
    (False, True): "writeonly",
    (False, False): "none",
}


def _list_all_bucket_policies(h, params, access_key) -> dict:
    """Per-prefix canned access summary of the bucket policy
    (web-handlers.go:1721 ListAllBucketPolicies): for each resource
    prefix the policy names, report readonly/writeonly/readwrite as
    the anonymous GET/PUT decisions the engine would actually make."""
    bucket = params.get("bucketName", "")
    _allow(h, access_key, "s3:GetBucketPolicy", bucket)
    h.s3.object_layer.get_bucket_info(bucket)
    raw = h.s3.bucket_meta.get(bucket).policy_json or ""
    if not raw:
        return {"policies": []}
    try:
        pol = Policy.from_json(raw)
    except Exception as e:  # noqa: BLE001
        raise WebError(f"bad stored policy: {e}") from None
    prefixes: "set[str]" = set()
    for st in getattr(pol, "statements", []):
        for res in getattr(st, "resources", []):
            tail = res.split(":::", 1)[-1]
            if tail.startswith(bucket):
                rest = tail[len(bucket):].lstrip("/")
                prefixes.add(rest.rstrip("*"))
    out = []
    for prefix in sorted(prefixes):
        probe = prefix + "obj"
        can = tuple(
            pol.is_allowed(Args(account="", action=action,
                                bucket=bucket, object=probe))
            for action in ("s3:GetObject", "s3:PutObject")
        )
        out.append(
            {"bucket": bucket, "prefix": prefix, "policy": _LEVELS[can]}
        )
    return {"policies": out}


_METHODS = {
    "web.ServerInfo": _server_info,
    "web.StorageInfo": _storage_info,
    "web.ListBuckets": _list_buckets,
    "web.MakeBucket": _make_bucket,
    "web.DeleteBucket": _delete_bucket,
    "web.ListObjects": _list_objects,
    "web.RemoveObject": _remove_objects,
    "web.GetBucketPolicy": _get_bucket_policy,
    "web.SetBucketPolicy": _set_bucket_policy,
    "web.ListAllBucketPolicies": _list_all_bucket_policies,
    "web.PresignedGet": _presigned_get,
    "web.CreateURLToken": _create_url_token,
    "web.GenerateAuth": _generate_auth,
    "web.SetAuth": _set_auth,
}


def _rpc(h) -> None:
    try:
        doc = json.loads(h._read_body() or b"{}")
    except ValueError:
        return _rpc_reply(h, None, error="parse error")
    rid = doc.get("id")
    method = doc.get("method", "")
    params = doc.get("params") or {}
    try:
        if method == "web.Login":
            return _rpc_reply(h, rid, result=_login(h, params))
        access_key = _auth_token(h)
        if h.s3.object_layer is None:
            raise WebError("server initializing")
        fn = _METHODS.get(method)
        if fn is not None:
            return _rpc_reply(h, rid, result=fn(h, params, access_key))
        return _rpc_reply(h, rid, error=f"unknown method {method!r}")
    except WebError as e:
        return _rpc_reply(h, rid, error=str(e))
    except Exception as e:  # noqa: BLE001
        err = s3errors.from_exception(e)
        return _rpc_reply(h, rid, error=f"{err.code}: {err.message}")


def _rpc_reply(h, rid, result=None, error: "str | None" = None) -> None:
    """One JSON-RPC answer; jsonrpc transports errors in-band (200)."""
    doc = {"jsonrpc": "2.0", "id": rid}
    if error is None:
        doc["result"] = result
    else:
        doc["error"] = {"message": error}
    h._respond(200, json.dumps(doc).encode(),
               content_type="application/json")


def _set_event_principal(h, access_key: str) -> None:
    """Bearer-token web requests never run sigv4 verification, so
    h._auth stays None and events would carry an empty principal;
    stamp the authenticated web identity before notifying."""
    h._auth = AuthContext(access_key=access_key, kind="web-jwt")


# -- upload / download ------------------------------------------------------


def _upload(h, bucket: str, obj: str) -> None:
    access_key = _auth_token(h)  # bearer-authenticated like WebUpload
    try:
        _allow(h, access_key, "s3:PutObject", bucket, obj)
    except WebError:
        raise S3Error("AccessDenied") from None
    reader, size = h._open_body()
    if size < 0:
        raise S3Error("MissingContentLength")
    # the S3 PUT invariant chain (size cap, quota, lock defaults,
    # bucket-default SSE, replication, event) rides the shared
    # helper so web uploads can never drift from it
    _set_event_principal(h, access_key)
    versioned, _ = h._versioning(bucket)
    info = h._checked_put(
        bucket,
        obj,
        HashReader(reader, size),
        size,
        {
            "content-type": h.headers.get("Content-Type")
            or "application/octet-stream"
        },
        versioned=versioned,
    )
    h._respond(200, b"", {"ETag": f'"{info.etag}"'})


def _verify_url_token(h, query) -> dict:
    """Shared URL-token check for download/zip endpoints: a login
    token is NOT a download token (web-handlers.go URL token)."""
    token = query.get("token", [""])[0]
    try:
        claims = jwt.verify(token, h.s3.iam.root_secret_key)
    except jwt.JWTError as e:
        raise S3Error("AccessDenied", f"bad token: {e}") from None
    if not claims.get("web-url-token"):
        raise S3Error("AccessDenied", "not a download token")
    return claims


def _start_stream(h, content_type: str, disposition: str,
                  length: "int | None") -> None:
    """Status and headers of a download; ``length`` None streams the
    body chunked."""
    h.send_response(200)
    h.send_header("Server", "MinIO-TPU")
    h.send_header("Content-Type", content_type)
    h.send_header("Content-Disposition", disposition)
    if length is None:
        h.send_header("Transfer-Encoding", "chunked")
    else:
        h.send_header("Content-Length", str(length))
    h.end_headers()


def _download(h, bucket: str, obj: str, query) -> None:
    claims = _verify_url_token(h, query)
    try:
        _allow(h, claims.get("sub", ""), "s3:GetObject", bucket, obj)
    except WebError:
        raise S3Error("AccessDenied") from None
    info = h.s3.object_layer.get_object_info(bucket, obj)
    if (info.user_defined or {}).get(ssemod.META_SSE) == "C":
        # a web download cannot supply the customer key; failing
        # before end_headers() beats a truncated 200
        raise S3Error(
            "InvalidRequest",
            "The object was stored using a form of Server Side "
            "Encryption. The correct parameters must be provided "
            "to retrieve the object.",
        )
    # control chars and quotes stripped: a crafted object name must
    # not split the response into injected headers
    fname = "".join(
        c
        for c in obj.rsplit("/", 1)[-1]
        if c.isprintable() and c not in '"\\'
    ) or "download"
    _start_stream(h, "application/octet-stream",
                  f'attachment; filename="{fname}"', info.size)
    if info.size:
        h.s3.object_layer.get_object(bucket, obj, h.wfile)
        h._resp_bytes += info.size


class _Chunked:
    """Chunked-transfer writer (length unknown up front)."""

    def __init__(self, h):
        self._h = h

    def write(self, b: bytes) -> int:
        if b:
            # one write a chunk: on the async plane each write is a
            # hand-off to the connection's event loop
            self._h.wfile.write(b"%x\r\n%s\r\n" % (len(b), b))
            self._h._resp_bytes += len(b)
        return len(b)

    def flush(self):
        self._h.wfile.flush()


def _zip_names(ol, bucket: str, prefix: str, objects) -> "list[str]":
    """The archive's object names: each entry ending in '/' (or the
    bare prefix) expands to every object under it."""
    names: "list[str]" = []
    for obj in objects:
        full = prefix + obj
        if full.endswith("/") or full == "":
            marker = ""
            while True:
                res = ol.list_objects(bucket, full, marker, "", 1000)
                names.extend(o.name for o in res.objects)
                if not res.is_truncated:
                    break
                marker = res.next_marker
        else:
            names.append(full)
    return names


def _download_zip(h, query) -> None:
    """DownloadZip (web-handlers.go:1290): POST a JSON document
    ``{"bucketName": b, "prefix": p, "objects": [...]}`` with a URL
    token; objects ending in '/' expand recursively.  The archive is
    streamed - zipfile writes straight into the chunked response, so
    memory stays bounded per object block."""
    claims = _verify_url_token(h, query)
    try:
        args = json.loads(h._read_body() or b"{}")
    except ValueError:
        raise S3Error("InvalidRequest", "bad JSON body") from None
    bucket = args.get("bucketName", "")
    prefix = args.get("prefix", "")
    objects = args.get("objects") or []
    if not bucket or not objects:
        raise S3Error("InvalidRequest", "bucketName and objects required")
    account = claims.get("sub", "")
    ol = h.s3.object_layer
    # expand prefixes + permission-check every entry BEFORE headers
    names = _zip_names(ol, bucket, prefix, objects)
    for name in names:
        try:
            _allow(h, account, "s3:GetObject", bucket, name)
        except WebError:
            raise S3Error("AccessDenied") from None
        info = ol.get_object_info(bucket, name)
        if (info.user_defined or {}).get(ssemod.META_SSE) == "C":
            raise S3Error(
                "InvalidRequest",
                "zip download cannot read SSE-C objects",
            )
    _start_stream(h, "application/zip",
                  'attachment; filename="download.zip"', None)
    with zipfile.ZipFile(_Chunked(h), "w", zipfile.ZIP_DEFLATED) as zf:
        for name in names:
            # archive paths are relative to the requested prefix
            arcname = name[len(prefix):] if name.startswith(
                prefix
            ) else name
            zi = zipfile.ZipInfo(arcname or name)
            # ZipFile's compression arg does NOT apply to handed-in
            # ZipInfo objects (they default to STORED)
            zi.compress_type = zipfile.ZIP_DEFLATED
            with zf.open(zi, "w", force_zip64=True) as entry:
                ol.get_object(bucket, name, entry)
    h.wfile.write(b"0\r\n\r\n")
    h.wfile.flush()


def handle(h, path: str, query) -> None:
    """Entry from the router for the paths ``is_web_path`` accepts."""
    if path == CONSOLE_PATH:
        # the embedded browser frontend (static, unauthenticated -
        # every action it performs authenticates via web.Login)
        if h.command != "GET":
            raise S3Error("MethodNotAllowed")
        return h._respond(
            200, CONSOLE_HTML, content_type="text/html; charset=utf-8"
        )
    if path == RPC_PATH:
        if h.command != "POST":
            raise S3Error("MethodNotAllowed")
        return _rpc(h)
    tail = path[len(WEB_PREFIX) + 1 :]
    parts = tail.split("/", 2)
    if len(parts) == 3 and parts[0] == "upload" and h.command == "PUT":
        return _upload(h, parts[1], urllib.parse.unquote(parts[2]))
    if len(parts) == 3 and parts[0] == "download" and h.command == "GET":
        return _download(
            h, parts[1], urllib.parse.unquote(parts[2]), query
        )
    if parts[0] == "zip" and h.command == "POST":
        return _download_zip(h, query)
    raise S3Error("MethodNotAllowed")
