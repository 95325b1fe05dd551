"""IAMSys: users, service accounts, named policies + authorization
(cmd/iam.go:203 IAMSys, cmd/iam-object-store.go).

Identity documents persist as erasure-coded objects under the reserved
meta volume (``.sys/config/iam/...``, the .minio.sys analogue), so every
node sees the same IAM state through the object layer and a node restart
loads it back (iam.go:419 Init).  The in-memory maps are the serving
path; refresh() re-reads the store (the peer-invalidation stand-in until
a control plane exists).

Authorization: the root credential bypasses policy (owner); every other
account is evaluated against its attached named policy, with bucket
(resource) policies consulted for anonymous and cross-account access by
the caller (auth dispatch in server/http.py).
"""

from __future__ import annotations

import io
import json
import secrets as pysecrets
import threading
import time

from ..objectlayer.api import META_BUCKET, ObjectNotFound
from .policy import CANNED_POLICIES, Args, Policy, PolicyError

from ..utils.log import kv, logger

_log = logger("iam")

IAM_PREFIX = "config/iam"

# STS AssumeRole duration bounds (sts-handlers.go parseDurationSeconds)
STS_MIN_DURATION_S = 900
STS_MAX_DURATION_S = 7 * 24 * 3600
STS_DEFAULT_DURATION_S = 3600


class IAMError(Exception):
    pass


class UserNotFound(IAMError):
    pass


class PolicyNotFound(IAMError):
    pass


class GroupNotFound(IAMError):
    pass


class InvalidToken(IAMError):
    """Temp-credential session token missing/mismatched/expired."""


def generate_credentials() -> "tuple[str, str]":
    """Access/secret key pair (pkg/auth GetNewCredentials shape)."""
    alphabet = "ABCDEFGHIJKLMNOPQRSTUVWXYZ0123456789"
    ak = "".join(pysecrets.choice(alphabet) for _ in range(20))
    sk = pysecrets.token_urlsafe(30)[:40]
    return ak, sk


class IAMSys:
    """In-memory IAM maps + object-layer persistence."""

    def __init__(
        self,
        root_access_key: str,
        root_secret_key: str,
        object_layer=None,
    ):
        self.root_access_key = root_access_key
        self.root_secret_key = root_secret_key
        self._ol = object_layer
        self._mu = threading.RLock()
        # access_key -> {"secret": str, "policy": str, "status": str,
        #               "parent": str (service accounts),
        #               "sts": bool, "expiration": unix ts,
        #               "session_token": str, "session_policy": json}
        self._users: "dict[str, dict]" = {}
        self._policies: "dict[str, Policy]" = dict(CANNED_POLICIES)
        # group name -> {"members": [ak...], "policy": str, "status": str}
        self._groups: "dict[str, dict]" = {}
        # peer control plane: set in distributed mode so IAM edits
        # broadcast a reload to every node
        self.notifier = None
        if object_layer is not None:
            self.refresh()

    # -- persistence ------------------------------------------------------

    def _store_path(self, kind: str, name: str) -> str:
        return f"{IAM_PREFIX}/{kind}/{name}.json"

    def _save_doc(self, kind: str, name: str, doc: dict) -> None:
        if self._ol is None:
            return
        raw = json.dumps(doc).encode()
        self._ol.put_object(
            META_BUCKET,
            self._store_path(kind, name),
            io.BytesIO(raw),
            len(raw),
        )
        self._notify_peers(kind, name, deleted=False)

    def _delete_doc(self, kind: str, name: str) -> None:
        if self._ol is None:
            return
        try:
            self._ol.delete_object(
                META_BUCKET, self._store_path(kind, name)
            )
        except ObjectNotFound:
            pass
        self._notify_peers(kind, name, deleted=True)

    def _notify_peers(
        self, kind: str, name: str, deleted: bool
    ) -> None:
        if self.notifier is None:
            return
        # granular invalidation when the notifier supports it (one
        # entity reload on each peer); coarse full-reload otherwise
        entity = getattr(self.notifier, "iam_entity", None)
        if entity is not None:
            entity(kind, name, deleted=deleted)
        else:
            self.notifier.iam_changed()

    def _load_docs(self, kind: str) -> "dict[str, dict]":
        out: dict = {}
        if self._ol is None:
            return out
        prefix = f"{IAM_PREFIX}/{kind}/"
        marker = ""
        while True:
            res = self._ol.list_objects(
                META_BUCKET, prefix, marker, "", 1000
            )
            for obj in res.objects:
                name = obj.name[len(prefix):]
                if not name.endswith(".json"):
                    continue
                buf = io.BytesIO()
                try:
                    self._ol.get_object(META_BUCKET, obj.name, buf)
                    out[name[:-5]] = json.loads(buf.getvalue())
                except Exception:  # noqa: BLE001 - skip corrupt doc
                    continue
            if not res.is_truncated:
                return out
            marker = res.next_marker

    # sentinel distinguishing "the doc does not exist" (evict the
    # cached entity) from a transient read failure (KEEP the cached
    # entity - evicting a valid credential on a quorum blip would
    # lock a live user out until the periodic refresher runs)
    _ABSENT = object()

    def _load_one_doc(self, kind: str, name: str):
        """The doc dict, ``_ABSENT`` when it does not exist (or is
        corrupt), or None on a transient read failure."""
        buf = io.BytesIO()
        try:
            self._ol.get_object(
                META_BUCKET, self._store_path(kind, name), buf
            )
        except ObjectNotFound:
            return self._ABSENT
        except Exception:  # noqa: BLE001 - quorum blip etc.
            return None
        try:
            return json.loads(buf.getvalue())
        except ValueError:
            return self._ABSENT

    # -- granular peer invalidation (LoadUser/LoadPolicy/LoadGroup
    #    peer RPCs reload ONE entity instead of the whole store) ----------

    def load_user(self, access_key: str) -> bool:
        """Reload one user / service account / STS credential from its
        persisted doc; drops it only when the doc is truly gone."""
        if self._ol is None or not access_key:
            return False
        doc = self._load_one_doc("users", access_key)
        if doc is self._ABSENT:
            sts = self._load_one_doc("sts", access_key)
            if sts is None:
                return False  # transient failure: keep the cache
            if isinstance(sts, dict) and sts.get(
                "expiration", 0
            ) > time.time():
                doc = sts
        if doc is None:
            return False  # transient failure: keep the cache
        with self._mu:
            if doc is self._ABSENT:
                self._users.pop(access_key, None)
                return False
            self._users[access_key] = doc
        return True

    def drop_user(self, access_key: str) -> None:
        with self._mu:
            self._users.pop(access_key, None)

    def load_policy(self, name: str) -> bool:
        if self._ol is None or not name:
            return False
        doc = self._load_one_doc("policies", name)
        if doc is None:
            return False  # transient failure: keep the cache
        with self._mu:
            if doc is self._ABSENT:
                self._policies.pop(name, None)
                if name in CANNED_POLICIES:
                    self._policies[name] = CANNED_POLICIES[name]
                return False
            try:
                self._policies[name] = Policy.from_dict(doc)
            except PolicyError:
                return False
        return True

    def drop_policy(self, name: str) -> None:
        with self._mu:
            self._policies.pop(name, None)
            if name in CANNED_POLICIES:
                self._policies[name] = CANNED_POLICIES[name]

    def load_group(self, name: str) -> bool:
        if self._ol is None or not name:
            return False
        doc = self._load_one_doc("groups", name)
        if doc is None:
            return False  # transient failure: keep the cache
        with self._mu:
            if doc is self._ABSENT:
                self._groups.pop(name, None)
                return False
            self._groups[name] = doc
        return True

    def start_refresher(self, interval_s: float = 120.0):
        """Periodic reload fallback (iam.go watch loop): peer
        notifications give immediate convergence; this catches any a
        down node missed.  Daemon thread; returns it."""
        stop = threading.Event()

        def loop():
            while not stop.wait(interval_s):
                try:
                    self.refresh()
                except Exception as exc:
                    _log.warning("iam refresh failed", extra=kv(err=str(exc)))

        t = threading.Thread(target=loop, daemon=True, name="iam-refresh")
        t.stop = stop  # type: ignore[attr-defined]
        t.start()
        return t

    def refresh(self) -> None:
        """Reload users + groups + policies from the store (iam.go Load)."""
        if self._ol is None:
            # store-less IAM: in-memory maps ARE the source of truth;
            # "reloading" would wipe them
            return
        users = self._load_docs("users")
        policies = self._load_docs("policies")
        groups = self._load_docs("groups")
        now = time.time()
        # temp credentials persist under their own kind with a TTL
        # (iam-object-store stores STS creds so every node honors them)
        for ak, u in self._load_docs("sts").items():
            if u.get("expiration", 0) > now:
                users.setdefault(ak, u)
        with self._mu:
            # keep unexpired in-memory temp creds unconditionally: a
            # concurrent assume_role may have inserted one after this
            # refresh snapshotted the sts/ docs (and store-less IAM has
            # no docs at all) - dropping it would orphan a live token
            for ak, u in self._users.items():
                if u.get("sts") and u.get("expiration", 0) > now:
                    users.setdefault(ak, u)
            self._users = users
            self._groups = groups
            self._policies = dict(CANNED_POLICIES)
            for name, doc in policies.items():
                try:
                    self._policies[name] = Policy.from_dict(doc)
                except PolicyError:
                    continue

    # -- credential lookup (SigV4Verifier seam) ---------------------------

    def lookup_secret(self, access_key: str) -> "str | None":
        if access_key == self.root_access_key:
            return self.root_secret_key
        with self._mu:
            u = self._users.get(access_key)
            if u is None or u.get("status") == "disabled":
                return None
            if u.get("sts") and u.get("expiration", 0) <= time.time():
                return None  # expired temp credential
            return u["secret"]

    def validate_session_token(
        self, access_key: str, token: "str | None"
    ) -> None:
        """Temp credentials must present their session token on every
        request (x-amz-security-token); long-lived credentials must
        not carry a foreign token (checkClaimsFromToken)."""
        with self._mu:
            u = self._users.get(access_key)
        if u is None or not u.get("sts"):
            if token:
                raise InvalidToken(
                    "security token used with a non-temporary credential"
                )
            return
        if u.get("expiration", 0) <= time.time():
            raise InvalidToken("temporary credential expired")
        if not token or token != u.get("session_token"):
            raise InvalidToken("security token mismatch")

    def is_owner(self, access_key: str) -> bool:
        return access_key == self.root_access_key

    def is_temp_credential(self, access_key: str) -> bool:
        """Whether the key is an STS temporary credential (those are
        refused console login: their session rides the S3 plane with
        its own token, web-handlers.go authenticateWeb)."""
        with self._mu:
            u = self._users.get(access_key)
        return bool(u and u.get("sts"))

    # -- user management (iam.go SetUser/DeleteUser/...) ------------------

    def add_user(
        self, access_key: str, secret_key: str, policy: str = ""
    ) -> None:
        if access_key == self.root_access_key:
            raise IAMError("cannot shadow the root credential")
        if policy:
            self.get_policy(policy)  # must exist
        doc = {"secret": secret_key, "policy": policy, "status": "enabled"}
        with self._mu:
            self._users[access_key] = doc
        self._save_doc("users", access_key, doc)

    def add_service_account(
        self, parent: str, access_key: str = "", secret_key: str = ""
    ) -> "tuple[str, str]":
        """Service account inheriting the parent user's policy
        (iam.go NewServiceAccount)."""
        if parent != self.root_access_key and parent not in self._users:
            raise UserNotFound(parent)
        if not access_key:
            access_key, secret_key = generate_credentials()
        doc = {
            "secret": secret_key,
            "policy": "",
            "status": "enabled",
            "parent": parent,
        }
        with self._mu:
            self._users[access_key] = doc
        self._save_doc("users", access_key, doc)
        return access_key, secret_key

    def remove_user(self, access_key: str) -> None:
        with self._mu:
            if access_key not in self._users:
                raise UserNotFound(access_key)
            del self._users[access_key]
            # drop the user's service accounts too
            orphans = [
                ak
                for ak, u in self._users.items()
                if u.get("parent") == access_key
            ]
            for ak in orphans:
                del self._users[ak]
        self._delete_doc("users", access_key)
        for ak in orphans:
            self._delete_doc("users", ak)

    def set_user_status(self, access_key: str, enabled: bool) -> None:
        with self._mu:
            u = self._users.get(access_key)
            if u is None:
                raise UserNotFound(access_key)
            u["status"] = "enabled" if enabled else "disabled"
            doc = dict(u)
        self._save_doc("users", access_key, doc)

    def set_user_secret(self, access_key: str, secret_key: str) -> None:
        """Rotate a user's secret key in place (the console SetAuth
        path, web-handlers.go:850); policy/status are untouched."""
        with self._mu:
            u = self._users.get(access_key)
            if u is None:
                raise UserNotFound(access_key)
            u["secret"] = secret_key
            doc = dict(u)
        self._save_doc("users", access_key, doc)

    def set_user_policy(self, access_key: str, policy: str) -> None:
        if policy:
            self.get_policy(policy)
        with self._mu:
            u = self._users.get(access_key)
            if u is None:
                raise UserNotFound(access_key)
            u["policy"] = policy
            doc = dict(u)
        self._save_doc("users", access_key, doc)

    def list_users(self) -> "dict[str, dict]":
        with self._mu:
            return {
                ak: {"policy": u.get("policy", ""), "status": u.get("status")}
                for ak, u in self._users.items()
                if not u.get("parent") and not u.get("sts")
            }

    # -- STS temp credentials (cmd/sts-handlers.go AssumeRole) ------------

    def assume_role(
        self,
        caller: str,
        duration_s: "int | None" = None,
        session_policy: "str | None" = None,
    ) -> dict:
        """Issue temp credentials bound to the caller's permissions.

        The effective policy of the temp credential is the caller's
        policy intersected with the optional session policy (both must
        allow).  Returns the credential document incl. the session
        token and expiration (unix seconds).
        """
        if duration_s is None:
            duration_s = STS_DEFAULT_DURATION_S
        if not (STS_MIN_DURATION_S <= duration_s <= STS_MAX_DURATION_S):
            raise IAMError(
                f"DurationSeconds {duration_s} out of range "
                f"[{STS_MIN_DURATION_S}, {STS_MAX_DURATION_S}]"
            )
        if session_policy:
            try:
                Policy.from_json(session_policy)
            except PolicyError as e:
                raise IAMError(f"bad session policy: {e}") from None
        with self._mu:
            if caller != self.root_access_key:
                u = self._users.get(caller)
                if u is None or u.get("status") == "disabled":
                    raise UserNotFound(caller)
                if u.get("sts"):
                    raise IAMError(
                        "temporary credentials cannot assume roles"
                    )
                if u.get("parent"):
                    # the reference refuses AssumeRole for service
                    # accounts (sts-handlers.go IsServiceAccount check)
                    raise IAMError(
                        "service accounts cannot assume roles"
                    )
        ak, sk = generate_credentials()
        token = pysecrets.token_urlsafe(48)
        doc = {
            "secret": sk,
            "policy": "",
            "status": "enabled",
            "parent": caller,
            "sts": True,
            "expiration": time.time() + duration_s,
            "session_token": token,
            "session_policy": session_policy or "",
        }
        with self._mu:
            self._users[ak] = doc
        self._save_doc("sts", ak, doc)
        return {"access_key": ak, **doc}

    def assume_role_with_token(
        self,
        policy: str,
        duration_s: "int | None" = None,
        subject: str = "",
    ) -> dict:
        """Temp credential for a federated identity: carries its OWN
        policy attachment instead of a parent user (the OpenID STS
        path, sts-handlers.go:293-443).  Every named policy must
        exist; multiple arrive comma-joined and any allow wins."""
        if duration_s is None:
            duration_s = STS_DEFAULT_DURATION_S
        if not (STS_MIN_DURATION_S <= duration_s <= STS_MAX_DURATION_S):
            raise IAMError(
                f"DurationSeconds {duration_s} out of range "
                f"[{STS_MIN_DURATION_S}, {STS_MAX_DURATION_S}]"
            )
        if not policy:
            raise IAMError("federated credential needs a policy claim")
        for name in policy.split(","):
            self.get_policy(name)  # must exist (PolicyNotFound)
        ak, sk = generate_credentials()
        token = pysecrets.token_urlsafe(48)
        doc = {
            "secret": sk,
            "policy": policy,
            "status": "enabled",
            "parent": "",
            "sts": True,
            "expiration": time.time() + duration_s,
            "session_token": token,
            "session_policy": "",
            "oidc_sub": subject,
        }
        with self._mu:
            self._users[ak] = doc
        self._save_doc("sts", ak, doc)
        return {"access_key": ak, **doc}

    def purge_expired_sts(self) -> int:
        """Drop expired temp credentials (lazy GC; returns count)."""
        now = time.time()
        with self._mu:
            dead = [
                ak
                for ak, u in self._users.items()
                if u.get("sts") and u.get("expiration", 0) <= now
            ]
            for ak in dead:
                del self._users[ak]
        for ak in dead:
            self._delete_doc("sts", ak)
        return len(dead)

    # -- groups (iam.go AddUsersToGroup / SetGroupStatus / ...) -----------

    def add_group_members(
        self, group: str, members: "list[str]"
    ) -> None:
        """Create the group if needed and add members (AddUsersToGroup)."""
        with self._mu:
            for ak in members:
                if ak not in self._users:
                    raise UserNotFound(ak)
            g = self._groups.setdefault(
                group, {"members": [], "policy": "", "status": "enabled"}
            )
            for ak in members:
                if ak not in g["members"]:
                    g["members"].append(ak)
            doc = dict(g)
        self._save_doc("groups", group, doc)

    def remove_group_members(
        self, group: str, members: "list[str]"
    ) -> None:
        """Remove members; an emptied member list with no members arg
        deletes the group (RemoveUsersFromGroup semantics)."""
        with self._mu:
            g = self._groups.get(group)
            if g is None:
                raise GroupNotFound(group)
            if not members:
                if g["members"]:
                    raise IAMError("group not empty")
                del self._groups[group]
                doc = None
            else:
                g["members"] = [
                    ak for ak in g["members"] if ak not in members
                ]
                doc = dict(g)
        if doc is None:
            self._delete_doc("groups", group)
        else:
            self._save_doc("groups", group, doc)

    def set_group_policy(self, group: str, policy: str) -> None:
        if policy:
            self.get_policy(policy)
        with self._mu:
            g = self._groups.get(group)
            if g is None:
                raise GroupNotFound(group)
            g["policy"] = policy
            doc = dict(g)
        self._save_doc("groups", group, doc)

    def set_group_status(self, group: str, enabled: bool) -> None:
        with self._mu:
            g = self._groups.get(group)
            if g is None:
                raise GroupNotFound(group)
            g["status"] = "enabled" if enabled else "disabled"
            doc = dict(g)
        self._save_doc("groups", group, doc)

    def group_info(self, group: str) -> dict:
        with self._mu:
            g = self._groups.get(group)
            if g is None:
                raise GroupNotFound(group)
            return dict(g)

    def list_groups(self) -> "list[str]":
        with self._mu:
            return sorted(self._groups)

    # -- policy management ------------------------------------------------

    def set_policy(self, name: str, policy: Policy) -> None:
        with self._mu:
            self._policies[name] = policy
        self._save_doc("policies", name, policy.to_dict())

    def get_policy(self, name: str) -> Policy:
        with self._mu:
            p = self._policies.get(name)
        if p is None:
            raise PolicyNotFound(name)
        return p

    def remove_policy(self, name: str) -> None:
        with self._mu:
            if name not in self._policies:
                raise PolicyNotFound(name)
            del self._policies[name]
        if name not in CANNED_POLICIES:
            self._delete_doc("policies", name)

    def list_policies(self) -> list[str]:
        with self._mu:
            return sorted(self._policies)

    # -- authorization (iam.go IsAllowed) ---------------------------------

    def _base_allowed(self, account: str, args: Args) -> bool:
        """Combined identity decision: the account's attached policy OR
        any enabled group's policy (iam.go policyDBGet aggregates user +
        group policies; any allow wins)."""
        with self._mu:
            u = self._users.get(account)
            if u is None or u.get("status") == "disabled":
                return False
            pnames = []
            if u.get("policy"):
                # federated creds may carry several comma-joined names
                pnames.extend(
                    p for p in u["policy"].split(",") if p
                )
            for g in self._groups.values():
                if (
                    account in g.get("members", ())
                    and g.get("status") != "disabled"
                    and g.get("policy")
                ):
                    pnames.append(g["policy"])
            policies = [
                self._policies[p] for p in pnames if p in self._policies
            ]
        return any(p.is_allowed(args) for p in policies)

    def is_allowed(self, args: Args) -> bool:
        """Identity-policy decision for an authenticated account."""
        if self.is_owner(args.account):
            return True
        with self._mu:
            u = self._users.get(args.account)
        if u is None or u.get("status") == "disabled":
            return False
        if u.get("sts"):
            if u.get("expiration", 0) <= time.time():
                return False
            # temp creds: parent's permissions INTERSECTED with the
            # session policy (both must allow; sts-handlers.go claims)
            sp = u.get("session_policy", "")
            if sp:
                try:
                    if not Policy.from_json(sp).is_allowed(args):
                        return False
                except PolicyError:
                    return False
            parent = u.get("parent", "")
            if parent:
                if self.is_owner(parent):
                    return True
                return self._base_allowed(parent, args)
            # parentless federated credential (OpenID STS): its own
            # attached policy IS the whole identity
            return self._base_allowed(args.account, args)
        # service accounts inherit the parent's effective policy
        parent = u.get("parent")
        if parent:
            if self.is_owner(parent):
                return True
            return self._base_allowed(parent, args)
        return self._base_allowed(args.account, args)
