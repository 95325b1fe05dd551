"""Declarative acquire/release/transfer registry for the lifecycle pass.

The reference MinIO keeps resource discipline honest with ``defer`` and
the race detector; this registry is the Python tree's substitute: every
manually-paired resource class is named here — who acquires it, who
releases it, which seams take ownership — and ``lifecycle.py`` proves
the pairing over the call graph (MTPU601-605).  A paired API that
is NOT registered is itself a finding (MTPU605), so the registry cannot
rot behind the code.

Matching model (all matching is syntactic, scoped by ``scope`` path
prefixes; the call graph supplies interprocedural release credit and
the MTPU605 resolution check):

* ``acquire_calls`` / ``release_calls`` / ``transfer_calls`` name call
  sites.  A plain name matches the called function/attribute name; a
  dotted ``"recv.name"`` form additionally requires the receiver's
  trailing attribute (``"s3.release"`` matches ``self.s3.release()``
  but not ``lock.release()``).
* ``conditional=True`` marks try-style acquires: the resource is held
  only when the call returns truthy (``if not try_enter(t): return``
  refines the obligation away on the shed branch).
* ``handle=True`` marks acquires whose return value IS the resource
  (staging reservation, io-future, parity ref).  Release is the
  handle flowing into a ``release_calls`` function or one of
  ``release_methods`` invoked on it; returning/storing/passing the
  handle transfers ownership out of the local frame.
* ``acquire_attr_ops`` / ``release_attr_ops`` register primitive
  mutations — ``("_res", "append")`` matches ``self._res.append(...)``
  (and simple local aliases of ``self._res``) — for the counters whose
  bodies implement a seam (TokenCounter).
* ``acquire_kwarg`` restricts an acquire to calls carrying that
  keyword (``FaultDisk.inject`` only parks a hang when ``hang_s`` is
  passed).
* ``defs`` pins each registered function to its defining module so the
  MTPU605 drift check (and the introspection-closure test) can demand
  that every entry resolves to a call-graph node.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ResourceClass:
    """One manually-paired resource: how it is acquired, released,
    and handed off, and where the pairing is enforced."""

    name: str
    scope: "tuple[str, ...]"
    acquire_calls: "tuple[str, ...]" = ()
    release_calls: "tuple[str, ...]" = ()
    transfer_calls: "tuple[str, ...]" = ()
    release_methods: "tuple[str, ...]" = ()
    acquire_attr_ops: "tuple[tuple[str, str], ...]" = ()
    release_attr_ops: "tuple[tuple[str, str], ...]" = ()
    acquire_kwarg: "str | None" = None
    conditional: bool = False
    handle: bool = False
    defs: "tuple[tuple[str, str], ...]" = ()

    def in_scope(self, rel_path: str) -> bool:
        return rel_path.startswith(self.scope)


@dataclasses.dataclass(frozen=True)
class Registry:
    """The resource table the lifecycle pass interprets."""

    resources: "tuple[ResourceClass, ...]"

    def scoped(self, rel_path: str) -> "tuple[ResourceClass, ...]":
        return tuple(r for r in self.resources if r.in_scope(rel_path))

    @staticmethod
    def default() -> "Registry":
        return Registry(resources=_DEFAULT_RESOURCES)


_DEFAULT_RESOURCES: "tuple[ResourceClass, ...]" = (
    # Device-budget staging ledger (codec/backend.py): _stage_reserve
    # returns the byte count that _stage_release must give back; the
    # reservation may instead ride into an _AsyncHandle payload, whose
    # *_end drain releases it on the device side.
    ResourceClass(
        name="staging-ledger",
        scope=("minio_tpu_torch/codec/backend.py",),
        acquire_calls=("_stage_reserve",),
        release_calls=("_stage_release",),
        transfer_calls=("_AsyncHandle",),
        handle=True,
        defs=(
            ("minio_tpu_torch/codec/backend.py", "_stage_reserve"),
            ("minio_tpu_torch/codec/backend.py", "_stage_release"),
        ),
    ),
    # Admission tokens (server/): the AdmissionController seams and
    # the TokenCounter reserve/undo primitives they are built from.
    # try_* acquires hold only on a truthy return; a seam returning
    # True hands its internal reservation to the caller.
    ResourceClass(
        name="admission-token",
        scope=("minio_tpu_torch/server/",),
        acquire_calls=(
            "try_enter_tenant",
            "try_enter_select",
            "try_acquire",
        ),
        release_calls=("leave_tenant", "leave_select"),
        acquire_attr_ops=(("_res", "append"), ("_adm", "append")),
        release_attr_ops=(("_res", "pop"), ("_adm", "pop")),
        conditional=True,
        defs=(
            ("minio_tpu_torch/server/admission.py", "AdmissionController.try_enter_tenant"),
            ("minio_tpu_torch/server/admission.py", "AdmissionController.leave_tenant"),
            ("minio_tpu_torch/server/admission.py", "AdmissionController.try_enter_select"),
            ("minio_tpu_torch/server/admission.py", "AdmissionController.leave_select"),
            ("minio_tpu_torch/server/admission.py", "TokenCounter.try_acquire"),
            ("minio_tpu_torch/server/admission.py", "TokenCounter.release"),
        ),
    ),
    # Per-plane inflight gauges (PlaneStats/LoopStats enter/leave):
    # unconditional counters that must stay exactly paired or the
    # shed decisions read a phantom load forever.
    ResourceClass(
        name="plane-inflight",
        scope=("minio_tpu_torch/server/",),
        acquire_calls=("enter",),
        release_calls=("leave",),
        defs=(
            ("minio_tpu_torch/server/admission.py", "PlaneStats.enter"),
            ("minio_tpu_torch/server/admission.py", "PlaneStats.leave"),
            ("minio_tpu_torch/server/admission.py", "LoopStats.enter"),
            ("minio_tpu_torch/server/admission.py", "LoopStats.leave"),
        ),
    ),
    # Threaded-server request slot (S3Server.admit/release): the
    # receiver-qualified form keeps "release" from colliding with the
    # other release verbs that live under server/.
    ResourceClass(
        name="server-slot",
        scope=("minio_tpu_torch/server/http.py",),
        acquire_calls=("s3.admit",),
        release_calls=("s3.release",),
        conditional=True,
        defs=(
            ("minio_tpu_torch/server/http.py", "S3Server.admit"),
            ("minio_tpu_torch/server/http.py", "S3Server.release"),
        ),
    ),
    # Parity-plane cache refs (codec/backend.py): constructing a ref
    # admits it to the ParityPlaneCache; it must be drained, released,
    # or handed to an owner before the frame exits.
    ResourceClass(
        name="parity-ref",
        scope=("minio_tpu_torch/codec/backend.py",),
        acquire_calls=(
            "_EagerParityRef",
            "_DeviceParityRef",
            "_SubchunkParityRef",
        ),
        release_methods=("release", "drain"),
        handle=True,
        defs=(
            ("minio_tpu_torch/codec/backend.py", "_EagerParityRef.release"),
            ("minio_tpu_torch/codec/backend.py", "_DeviceParityRef.release"),
            ("minio_tpu_torch/codec/backend.py", "_DeviceParityRef.drain"),
            ("minio_tpu_torch/codec/backend.py", "_SubchunkParityRef.drain"),
        ),
    ),
    # IO-pool futures: a granted slot's future must be waited,
    # abandoned (hedged losers), or adopted by a band/flusher; a
    # dropped future strands its queue slot accounting.  Scoped to the
    # pool and its caller: parallel/fanout.py's Fanout.submit returns no
    # future (its jobs report their own outcome).
    ResourceClass(
        name="io-future",
        scope=(
            "minio_tpu_torch/parallel/iopool.py",
            "minio_tpu_torch/codec/erasure.py",
        ),
        acquire_calls=("submit", "submit_hedged"),
        transfer_calls=("adopt", "add_done_callback"),
        release_methods=("wait", "result_or_raise", "abandon", "settle"),
        handle=True,
        defs=(
            ("minio_tpu_torch/parallel/iopool.py", "IOPool.submit"),
            ("minio_tpu_torch/parallel/iopool.py", "IOPool.submit_hedged"),
            ("minio_tpu_torch/parallel/iopool.py", "IOFuture.wait"),
            ("minio_tpu_torch/parallel/iopool.py", "IOFuture.result_or_raise"),
            ("minio_tpu_torch/parallel/iopool.py", "IOFuture.abandon"),
            ("minio_tpu_torch/parallel/iopool.py", "ParityBand.adopt"),
        ),
    ),
    # Namespace / dsync locks: timeout'd bool acquires with explicit
    # release verbs (the context managers in namespace.py are built on
    # these and are themselves checked here).
    ResourceClass(
        name="rw-lock",
        scope=("minio_tpu_torch/dsync/",),
        acquire_calls=(
            "acquire_read",
            "acquire_write",
            "get_lock",
            "get_rlock",
        ),
        release_calls=(
            "release_read",
            "release_write",
            "unlock",
            "runlock",
        ),
        conditional=True,
        defs=(
            ("minio_tpu_torch/dsync/namespace.py", "_RWLock.acquire_read"),
            ("minio_tpu_torch/dsync/namespace.py", "_RWLock.release_read"),
            ("minio_tpu_torch/dsync/namespace.py", "_RWLock.acquire_write"),
            ("minio_tpu_torch/dsync/namespace.py", "_RWLock.release_write"),
            ("minio_tpu_torch/dsync/drwmutex.py", "DRWMutex.get_lock"),
            ("minio_tpu_torch/dsync/drwmutex.py", "DRWMutex.unlock"),
            ("minio_tpu_torch/dsync/drwmutex.py", "DRWMutex.get_rlock"),
            ("minio_tpu_torch/dsync/drwmutex.py", "DRWMutex.runlock"),
        ),
    ),
    # FaultDisk parked hangs: inject(hang_s=...) parks worker threads
    # until clear(); a schedule that cannot be cleared wedges every
    # disk op behind it.
    ResourceClass(
        name="fault-hang",
        scope=(
            "minio_tpu_torch/storage/faults.py",
            "minio_tpu_torch/server/admin.py",
        ),
        acquire_calls=("inject",),
        release_calls=("clear",),
        acquire_kwarg="hang_s",
        defs=(
            ("minio_tpu_torch/storage/faults.py", "FaultDisk.inject"),
            ("minio_tpu_torch/storage/faults.py", "FaultDisk.clear"),
        ),
    ),
)


# Names that look like acquires: a def with one of these shapes inside
# a registered scope must itself be registered or MTPU605 fires (the
# other drift direction — code outrunning the registry).
ACQUIRE_SHAPED_PREFIXES = ("try_enter_", "try_acquire", "acquire_")
ACQUIRE_SHAPED_NAMES = ("reserve", "_stage_reserve", "admit")


def registered_call_names(registry: Registry) -> "set[str]":
    """Every bare function name the registry knows (drift whitelist)."""
    out: "set[str]" = set()
    for res in registry.resources:
        for group in (
            res.acquire_calls,
            res.release_calls,
            res.transfer_calls,
        ):
            for name in group:
                out.add(name.rsplit(".", 1)[-1])
        for _, qname in res.defs:
            out.add(qname.rsplit(".", 1)[-1])
    return out
