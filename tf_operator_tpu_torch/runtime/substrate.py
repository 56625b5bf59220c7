"""Substrate: the cluster-API seam the controller runs against.

The reference controller talks to a Kubernetes apiserver through
client-go clientsets and exercises its logic in tests through *fake*
clientsets (reference controller_test.go:44-64). We make that seam a
first-class interface: `Substrate` is the minimal cluster surface the
job controller needs (TFJob store + pod/service CRUD + watch events),
with two implementations:

- `InMemorySubstrate` (here): a thread-safe fake apiserver plus a tiny
  kubelet simulator, the unit/E2E test substrate. Plays the combined
  role of the reference's fake clientsets and its remote-controllable
  fake training server (test/test-server/test_app.py:15-82).
- `KubeSubstrate` (kube.py): real apiserver over stdlib HTTP.

Watch semantics mirror informers: subscribers get (verb, object)
callbacks after the store mutates; the controller layers expectations
on top exactly like the reference (jobcontroller/pod.go:20-160).

The port's copy of tf_operator_tpu/runtime/substrate.py; it imports nothing of that package.
"""

from __future__ import annotations

import contextvars
import dataclasses
import datetime
import itertools
from typing import Any, Callable, Dict, List, Optional, Protocol, Set, Tuple

from ..api import k8s
from ..api.k8s import DEFAULT_LEASE_DURATION, Lease  # noqa: F401 — re-export
from ..api.serde import deep_copy
from ..api.types import ServeService, TFJob

from ..utils import locks

ADDED = "ADDED"
MODIFIED = "MODIFIED"
DELETED = "DELETED"

WatchCallback = Callable[[str, Any], None]


def now_iso() -> str:
    return datetime.datetime.now(datetime.timezone.utc).strftime("%Y-%m-%dT%H:%M:%SZ")


def match_labels(selector: Dict[str, str], labels: Dict[str, str]) -> bool:
    return all(labels.get(key) == value for key, value in selector.items())


class NotFound(KeyError):
    pass


class BadRequest(ValueError):
    """Client-side request error (the apiserver's 400 class — e.g. a
    log read naming a container the pod does not have)."""


class AlreadyExists(ValueError):
    pass


class Conflict(RuntimeError):
    """Optimistic-concurrency failure (stale resourceVersion)."""


class FencedWrite(Conflict):
    """A write carried a fencing token (leader epoch) older than the
    newest lease epoch the substrate has seen: the writer is a deposed
    leader that does not know it yet. Subclasses Conflict because the
    correct reaction is the same — re-read the world, don't replay —
    and is_transient_error already classifies Conflict as semantic
    (never blindly retried)."""

    def __init__(self, op: str, token: int, fence: int) -> None:
        super().__init__(
            f"{op}: fencing token {token} is stale (current epoch {fence})"
        )
        self.op = op
        self.token = token
        self.fence = fence


# Ambient fencing token for the CURRENT thread of control: bound by
# FencedSubstrate (runtime/leader.py) around each mutating call; None
# means the writer is unfenced (single-replica mode, tests, clients)
# and passes every check. A contextvar, not a thread-local: informer
# callbacks run synchronously inside the mutator's call, and a nested
# FencedSubstrate re-binds its OWN epoch for writes it sends from a
# handler — each writer is judged by its own token.
_write_token: contextvars.ContextVar[Optional[int]] = contextvars.ContextVar(
    "substrate_write_token", default=None
)


@dataclasses.dataclass
class FenceRejection:
    """Audit row for one rejected stale-epoch write."""

    op: str
    token: int
    fence: int


class Substrate(Protocol):
    """What the controller requires of a cluster. All objects passed in
    and returned are owned by the caller (value semantics)."""

    # TFJob store (the CRD)
    def list_jobs(self, namespace: Optional[str] = None) -> List[TFJob]: ...
    def get_job(self, namespace: str, name: str) -> TFJob: ...
    def update_job_status(self, job: TFJob) -> TFJob: ...
    def delete_job(self, namespace: str, name: str) -> None: ...

    # Pods
    def create_pod(self, pod: k8s.Pod) -> k8s.Pod: ...
    def get_pod(self, namespace: str, name: str) -> k8s.Pod: ...
    def list_pods(
        self, namespace: Optional[str], selector: Optional[Dict[str, str]] = None
    ) -> List[k8s.Pod]: ...
    def delete_pod(self, namespace: str, name: str) -> None: ...
    def patch_pod_labels(
        self, namespace: str, name: str, labels: Dict[str, str]
    ) -> k8s.Pod: ...
    def patch_pod_owner_references(
        self, namespace: str, name: str, refs: List[k8s.OwnerReference],
        expected_uid: str = "",
    ) -> k8s.Pod: ...

    # Services
    def create_service(self, service: k8s.Service) -> k8s.Service: ...
    def list_services(
        self, namespace: str, selector: Optional[Dict[str, str]] = None
    ) -> List[k8s.Service]: ...
    def delete_service(self, namespace: str, name: str) -> None: ...
    def patch_service_owner_references(
        self, namespace: str, name: str, refs: List[k8s.OwnerReference],
        expected_uid: str = "",
    ) -> k8s.Service: ...

    # Events + watches
    def record_event(self, event: k8s.Event) -> None: ...
    def events_for(
        self, kind: str, name: str, namespace: Optional[str] = None
    ) -> List[k8s.Event]: ...
    def subscribe(self, kind: str, callback: WatchCallback) -> None: ...
    def unsubscribe(self, kind: str, callback: WatchCallback) -> None: ...


class InMemorySubstrate:
    """Fake apiserver + kubelet simulator for tests and local runs.

    Kubelet simulation is explicit: tests drive pod phases with
    ``mark_pod_running`` / ``terminate_pod`` the way the reference's E2E
    suite drives its fake training server's ``/exit?exitCode=n``
    endpoint (test/test-server/test_app.py:47-53).
    """

    def __init__(self) -> None:
        self._lock = locks.make_rlock("InMemorySubstrate._lock")
        self._uid = itertools.count(1)
        self._rv = itertools.count(1)
        self._jobs: Dict[Tuple[str, str], TFJob] = {}
        self._serve_services: Dict[Tuple[str, str], ServeService] = {}
        self._pods: Dict[Tuple[str, str], k8s.Pod] = {}
        self._services: Dict[Tuple[str, str], k8s.Service] = {}
        self._pod_groups: Dict[Tuple[str, str], Any] = {}
        self._leases: Dict[Tuple[str, str], Any] = {}
        self._pod_logs: Dict[Tuple[str, str], str] = {}
        self.events: List[k8s.Event] = []
        self._subscribers: Dict[str, List[WatchCallback]] = {}
        # namespace+label inverted index over pods/services: the
        # apiserver answers selector LISTs from etcd + an index; a full
        # O(all pods) scan per sync made "list" the dominant superlinear
        # phase at scale (CONTROLLER_PROFILE.json). Maintained — i.e.
        # invalidated — on every write that touches labels or
        # membership, so a selector LIST costs O(matching).
        # (ns, label_key, label_value) -> set of object keys
        self._pod_index: Dict[Tuple[str, str, str], Set[Tuple[str, str]]] = {}
        self._service_index: Dict[
            Tuple[str, str, str], Set[Tuple[str, str]]
        ] = {}
        # fencing: the newest lease epoch ever written here; writes
        # carrying an older ambient token raise FencedWrite. Audit
        # trails let the HA soak assert "zero stale writes accepted"
        # from the substrate's own books (tests/test_ha.py).
        self._fence_epoch = 0
        self.fence_rejections: List[FenceRejection] = []
        # (op, token, fence_epoch_at_accept) for every ACCEPTED write
        # that carried a token — must never contain token < fence
        self.fenced_writes_accepted: List[Tuple[str, int, int]] = []

    # -- plumbing ----------------------------------------------------------

    def _fence(self, op: str) -> None:
        """Reject stale-epoch writes (call first, inside self._lock, in
        every mutating verb): the check-and-write must be atomic with
        lease-epoch advancement or a write racing a takeover could slip
        through after the new leader's epoch landed."""
        token = _write_token.get()
        if token is None:
            return  # unfenced writer (single-replica mode, clients, tests)
        if token < self._fence_epoch:
            self.fence_rejections.append(
                FenceRejection(op=op, token=token, fence=self._fence_epoch)
            )
            raise FencedWrite(op, token, self._fence_epoch)
        self.fenced_writes_accepted.append((op, token, self._fence_epoch))

    @property
    def fence_epoch(self) -> int:
        with self._lock:
            return self._fence_epoch

    @staticmethod
    def _index_add(
        index: Dict[Tuple[str, str, str], Set[Tuple[str, str]]],
        key: Tuple[str, str],
        labels: Dict[str, str],
    ) -> None:
        ns = key[0]
        for lk, lv in labels.items():
            index.setdefault((ns, lk, lv), set()).add(key)

    @staticmethod
    def _index_remove(
        index: Dict[Tuple[str, str, str], Set[Tuple[str, str]]],
        key: Tuple[str, str],
        labels: Dict[str, str],
    ) -> None:
        ns = key[0]
        for lk, lv in labels.items():
            bucket = index.get((ns, lk, lv))
            if bucket is not None:
                bucket.discard(key)
                if not bucket:
                    del index[(ns, lk, lv)]

    def _index_candidates(
        self,
        index: Dict[Tuple[str, str, str], Set[Tuple[str, str]]],
        namespace: str,
        selector: Dict[str, str],
    ) -> Set[Tuple[str, str]]:
        """Smallest posting set among the selector's terms (standard
        inverted-index intersection order); the caller still verifies
        the FULL selector against each candidate's labels."""
        smallest: Optional[Set[Tuple[str, str]]] = None
        for lk, lv in selector.items():
            bucket = index.get((namespace, lk, lv))
            if not bucket:
                return set()
            if smallest is None or len(bucket) < len(smallest):
                smallest = bucket
        return smallest if smallest is not None else set()

    def _stamp(self, meta: k8s.ObjectMeta) -> None:
        if not meta.uid:
            meta.uid = f"uid-{next(self._uid)}"
        meta.resource_version = str(next(self._rv))
        if meta.creation_timestamp is None:
            meta.creation_timestamp = now_iso()

    def _notify(self, kind: str, verb: str, obj: Any) -> None:
        for callback in self._subscribers.get(kind, []):
            if dataclasses.is_dataclass(obj):
                callback(verb, deep_copy(obj))
            elif hasattr(obj, "copy"):
                callback(verb, obj.copy())
            else:
                callback(verb, obj)

    def subscribe(self, kind: str, callback: WatchCallback) -> None:
        with self._lock:
            self._subscribers.setdefault(kind, []).append(callback)

    def unsubscribe(self, kind: str, callback: WatchCallback) -> None:
        """Remove a watch callback (finite watchers like sdk.watch must
        detach or every past watcher keeps receiving events forever)."""
        with self._lock:
            callbacks = self._subscribers.get(kind, [])
            if callback in callbacks:
                callbacks.remove(callback)

    # -- TFJobs ------------------------------------------------------------

    def create_job(self, job: TFJob) -> TFJob:
        with self._lock:
            self._fence("create-job")
            key = (job.namespace, job.name)
            if key in self._jobs:
                raise AlreadyExists(f"tfjob {key} exists")
            job = job.copy()
            self._stamp(job.metadata)
            self._jobs[key] = job
            self._notify("tfjob", ADDED, job)
            return job.copy()

    def list_jobs(self, namespace: Optional[str] = None) -> List[TFJob]:
        with self._lock:
            return [
                job.copy()
                for (ns, _), job in self._jobs.items()
                if namespace is None or ns == namespace
            ]

    def get_job(self, namespace: str, name: str) -> TFJob:
        with self._lock:
            job = self._jobs.get((namespace, name))
            if job is None:
                raise NotFound(f"tfjob {namespace}/{name}")
            return job.copy()

    def update_job(self, job: TFJob) -> TFJob:
        with self._lock:
            self._fence("update-job")
            key = (job.namespace, job.name)
            if key not in self._jobs:
                raise NotFound(f"tfjob {key}")
            stored = self._jobs[key]
            if (
                job.metadata.resource_version
                and job.metadata.resource_version != stored.metadata.resource_version
            ):
                raise Conflict(f"tfjob {key}: stale resourceVersion")
            job = job.copy()
            job.metadata.resource_version = str(next(self._rv))
            self._jobs[key] = job
            self._notify("tfjob", MODIFIED, job)
            return job.copy()

    def update_job_status(self, job: TFJob) -> TFJob:
        """Status-subresource write: only .status (+ resourceVersion) moves.

        The reference writes status through UpdateStatus / a raw CRD REST
        client (status.go:176-184, k8sutil/client.go).
        """
        with self._lock:
            self._fence("update-job-status")
            key = (job.namespace, job.name)
            stored = self._jobs.get(key)
            if stored is None:
                raise NotFound(f"tfjob {key}")
            stored.status = deep_copy(job.status)
            stored.metadata.resource_version = str(next(self._rv))
            self._notify("tfjob", MODIFIED, stored)
            return stored.copy()

    def delete_job(self, namespace: str, name: str) -> None:
        with self._lock:
            self._fence("delete-job")
            job = self._jobs.pop((namespace, name), None)
            if job is None:
                raise NotFound(f"tfjob {namespace}/{name}")
            self._notify("tfjob", DELETED, job)
            self._cascade_delete(job.metadata.uid)

    # -- ServeServices -----------------------------------------------------
    # Watch kind "serveservice". Same semantics as the TFJob store:
    # optimistic concurrency on update, a status subresource, and
    # cascade GC of owned children on delete.

    def create_serve_service(self, svc: ServeService) -> ServeService:
        with self._lock:
            self._fence("create-serveservice")
            key = (svc.namespace, svc.name)
            if key in self._serve_services:
                raise AlreadyExists(f"serveservice {key} exists")
            svc = svc.copy()
            self._stamp(svc.metadata)
            self._serve_services[key] = svc
            self._notify("serveservice", ADDED, svc)
            return svc.copy()

    def list_serve_services(
        self, namespace: Optional[str] = None
    ) -> List[ServeService]:
        with self._lock:
            return [
                svc.copy()
                for (ns, _), svc in self._serve_services.items()
                if namespace is None or ns == namespace
            ]

    def get_serve_service(self, namespace: str, name: str) -> ServeService:
        with self._lock:
            svc = self._serve_services.get((namespace, name))
            if svc is None:
                raise NotFound(f"serveservice {namespace}/{name}")
            return svc.copy()

    def update_serve_service(self, svc: ServeService) -> ServeService:
        with self._lock:
            self._fence("update-serveservice")
            key = (svc.namespace, svc.name)
            if key not in self._serve_services:
                raise NotFound(f"serveservice {key}")
            stored = self._serve_services[key]
            if (
                svc.metadata.resource_version
                and svc.metadata.resource_version
                != stored.metadata.resource_version
            ):
                raise Conflict(f"serveservice {key}: stale resourceVersion")
            svc = svc.copy()
            svc.metadata.resource_version = str(next(self._rv))
            self._serve_services[key] = svc
            self._notify("serveservice", MODIFIED, svc)
            return svc.copy()

    def update_serve_service_status(self, svc: ServeService) -> ServeService:
        with self._lock:
            self._fence("update-serveservice-status")
            key = (svc.namespace, svc.name)
            stored = self._serve_services.get(key)
            if stored is None:
                raise NotFound(f"serveservice {key}")
            stored.status = deep_copy(svc.status)
            stored.metadata.resource_version = str(next(self._rv))
            self._notify("serveservice", MODIFIED, stored)
            return stored.copy()

    def delete_serve_service(self, namespace: str, name: str) -> None:
        with self._lock:
            self._fence("delete-serveservice")
            svc = self._serve_services.pop((namespace, name), None)
            if svc is None:
                raise NotFound(f"serveservice {namespace}/{name}")
            self._notify("serveservice", DELETED, svc)
            self._cascade_delete(svc.metadata.uid)

    def _cascade_delete(self, owner_uid: str) -> None:
        """Garbage-collect children owned (via ownerReferences) by a gone
        object — the role the k8s GC controller plays for the reference."""
        for store, index, kind in (
            (self._pods, self._pod_index, "pod"),
            (self._services, self._service_index, "service"),
        ):
            doomed = [
                key
                for key, obj in store.items()
                if any(ref.uid == owner_uid for ref in obj.metadata.owner_references)
            ]
            for key in doomed:
                obj = store.pop(key)
                self._index_remove(index, key, obj.metadata.labels)
                if kind == "pod":
                    self._pod_logs.pop(key, None)
                self._notify(kind, DELETED, obj)

    # -- Pods --------------------------------------------------------------

    def create_pod(self, pod: k8s.Pod) -> k8s.Pod:
        with self._lock:
            self._fence("create-pod")
            key = (pod.metadata.namespace, pod.metadata.name)
            if key in self._pods:
                raise AlreadyExists(f"pod {key} exists")
            pod = deep_copy(pod)
            self._stamp(pod.metadata)
            pod.status.phase = k8s.POD_PENDING
            self._pods[key] = pod
            self._index_add(self._pod_index, key, pod.metadata.labels)
            self._notify("pod", ADDED, pod)
            return deep_copy(pod)

    def get_pod(self, namespace: str, name: str) -> k8s.Pod:
        with self._lock:
            pod = self._pods.get((namespace, name))
            if pod is None:
                raise NotFound(f"pod {namespace}/{name}")
            return deep_copy(pod)

    def list_pods(
        self, namespace: Optional[str], selector: Optional[Dict[str, str]] = None
    ) -> List[k8s.Pod]:
        """namespace=None lists across all namespaces (the apiserver's
        cluster-scoped GET /api/v1/pods). Namespaced selector LISTs —
        the controller's per-sync shape — answer from the label index
        in O(matching) instead of scanning every pod."""
        with self._lock:
            if namespace is not None and selector:
                candidates = self._index_candidates(
                    self._pod_index, namespace, selector
                )
                return [
                    deep_copy(self._pods[key])
                    for key in sorted(candidates)
                    if match_labels(selector, self._pods[key].metadata.labels)
                ]
            return [
                deep_copy(pod)
                for (ns, _), pod in self._pods.items()
                if (namespace is None or ns == namespace)
                and (selector is None or match_labels(selector, pod.metadata.labels))
            ]

    def delete_pod(self, namespace: str, name: str) -> None:
        with self._lock:
            self._fence("delete-pod")
            pod = self._pods.pop((namespace, name), None)
            if pod is None:
                raise NotFound(f"pod {namespace}/{name}")
            self._index_remove(
                self._pod_index, (namespace, name), pod.metadata.labels
            )
            # a pod recreated at the same name must start with fresh logs
            self._pod_logs.pop((namespace, name), None)
            self._notify("pod", DELETED, pod)

    def patch_pod_labels(
        self, namespace: str, name: str, labels: Dict[str, str]
    ) -> k8s.Pod:
        with self._lock:
            self._fence("patch-pod-labels")
            pod = self._pods.get((namespace, name))
            if pod is None:
                raise NotFound(f"pod {namespace}/{name}")
            self._index_remove(
                self._pod_index, (namespace, name), pod.metadata.labels
            )
            pod.metadata.labels.update(labels)
            self._index_add(
                self._pod_index, (namespace, name), pod.metadata.labels
            )
            pod.metadata.resource_version = str(next(self._rv))
            self._notify("pod", MODIFIED, pod)
            return deep_copy(pod)

    def patch_pod_owner_references(
        self, namespace: str, name: str, refs: List[k8s.OwnerReference],
        expected_uid: str = "",
    ) -> k8s.Pod:
        """Replace a pod's ownerReferences — the adoption/release patch
        the reference's ControllerRefManager sends
        (service_ref_manager.go:32-60). With expected_uid set, the patch
        is rejected if the name now belongs to a different object (uid
        is immutable; the apiserver behaves the same)."""
        with self._lock:
            self._fence("patch-pod-owner-refs")
            pod = self._pods.get((namespace, name))
            if pod is None:
                raise NotFound(f"pod {namespace}/{name}")
            if expected_uid and pod.metadata.uid != expected_uid:
                raise Conflict(
                    f"pod {namespace}/{name}: uid changed "
                    f"({pod.metadata.uid} != {expected_uid})"
                )
            pod.metadata.owner_references = [deep_copy(r) for r in refs]
            pod.metadata.resource_version = str(next(self._rv))
            self._notify("pod", MODIFIED, pod)
            return deep_copy(pod)

    # -- Services ----------------------------------------------------------

    def create_service(self, service: k8s.Service) -> k8s.Service:
        with self._lock:
            self._fence("create-service")
            key = (service.metadata.namespace, service.metadata.name)
            if key in self._services:
                raise AlreadyExists(f"service {key} exists")
            service = deep_copy(service)
            self._stamp(service.metadata)
            self._services[key] = service
            self._index_add(self._service_index, key, service.metadata.labels)
            self._notify("service", ADDED, service)
            return deep_copy(service)

    def list_services(
        self, namespace: str, selector: Optional[Dict[str, str]] = None
    ) -> List[k8s.Service]:
        with self._lock:
            if selector:
                candidates = self._index_candidates(
                    self._service_index, namespace, selector
                )
                return [
                    deep_copy(self._services[key])
                    for key in sorted(candidates)
                    if match_labels(
                        selector, self._services[key].metadata.labels
                    )
                ]
            return [
                deep_copy(svc)
                for (ns, _), svc in self._services.items()
                if ns == namespace
                and (selector is None or match_labels(selector, svc.metadata.labels))
            ]

    def delete_service(self, namespace: str, name: str) -> None:
        with self._lock:
            self._fence("delete-service")
            svc = self._services.pop((namespace, name), None)
            if svc is None:
                raise NotFound(f"service {namespace}/{name}")
            self._index_remove(
                self._service_index, (namespace, name), svc.metadata.labels
            )
            self._notify("service", DELETED, svc)

    def patch_service_owner_references(
        self, namespace: str, name: str, refs: List[k8s.OwnerReference],
        expected_uid: str = "",
    ) -> k8s.Service:
        with self._lock:
            self._fence("patch-service-owner-refs")
            svc = self._services.get((namespace, name))
            if svc is None:
                raise NotFound(f"service {namespace}/{name}")
            if expected_uid and svc.metadata.uid != expected_uid:
                raise Conflict(
                    f"service {namespace}/{name}: uid changed "
                    f"({svc.metadata.uid} != {expected_uid})"
                )
            svc.metadata.owner_references = [deep_copy(r) for r in refs]
            svc.metadata.resource_version = str(next(self._rv))
            self._notify("service", MODIFIED, svc)
            return deep_copy(svc)

    # -- PodGroups (gang scheduling) ---------------------------------------

    def create_pod_group(self, group) -> None:
        with self._lock:
            self._fence("create-podgroup")
            key = (group.namespace, group.name)
            if key in self._pod_groups:
                raise AlreadyExists(f"podgroup {key} exists")
            self._pod_groups[key] = group.copy()
            self._notify("podgroup", ADDED, group)

    def get_pod_group(self, namespace: str, name: str):
        with self._lock:
            group = self._pod_groups.get((namespace, name))
            return group.copy() if group is not None else None

    def update_pod_group(self, group) -> None:
        with self._lock:
            self._fence("update-podgroup")
            self._pod_groups[(group.namespace, group.name)] = group.copy()
            self._notify("podgroup", MODIFIED, group)

    def delete_pod_group(self, namespace: str, name: str) -> None:
        with self._lock:
            self._fence("delete-podgroup")
            group = self._pod_groups.pop((namespace, name), None)
            if group is not None:
                self._notify("podgroup", DELETED, group)

    # -- Leases (leader election) ------------------------------------------

    def get_lease(self, namespace: str, name: str):
        with self._lock:
            lease = self._leases.get((namespace, name))
            return lease.copy() if lease is not None else None

    def create_lease(self, lease) -> None:
        with self._lock:
            key = (lease.namespace, lease.name)
            if key in self._leases:
                raise AlreadyExists(f"lease {key} exists")
            lease = lease.copy()
            lease.resource_version = str(next(self._rv))
            self._leases[key] = lease
            self._advance_fence(lease)

    def update_lease(self, lease) -> None:
        """Compare-and-swap on resourceVersion — two operators renewing
        concurrently must not both succeed (the reference gets this from
        the apiserver's optimistic concurrency)."""
        with self._lock:
            key = (lease.namespace, lease.name)
            stored = self._leases.get(key)
            if stored is None:
                raise NotFound(f"lease {key}")
            if (
                lease.resource_version
                and lease.resource_version != stored.resource_version
            ):
                raise Conflict(f"lease {key}: stale resourceVersion")
            lease = lease.copy()
            lease.resource_version = str(next(self._rv))
            self._leases[key] = lease
            self._advance_fence(lease)

    def _advance_fence(self, lease) -> None:
        """The fence follows the newest lease epoch written (under
        self._lock with the write, so a takeover and a stale write
        serialize). Monotonic: a replayed old lease body can't lower it."""
        epoch = int(getattr(lease, "epoch", 0) or 0)
        if epoch > self._fence_epoch:
            self._fence_epoch = epoch

    # -- Events ------------------------------------------------------------

    def record_event(self, event: k8s.Event) -> None:
        with self._lock:
            if event.timestamp is None:
                event.timestamp = now_iso()
            self.events.append(event)

    def events_for(
        self, kind: str, name: str, namespace: Optional[str] = None
    ) -> List[k8s.Event]:
        with self._lock:
            return [
                e
                for e in self.events
                if e.involved_object_kind == kind
                and e.involved_object_name == name
                and (
                    namespace is None
                    or e.involved_object_namespace == namespace
                )
            ]

    # -- Pod logs ----------------------------------------------------------

    def append_pod_log(self, namespace: str, name: str, text: str) -> None:
        with self._lock:
            self._pod_logs[(namespace, name)] = (
                self._pod_logs.get((namespace, name), "") + text
            )

    def read_pod_log(
        self,
        namespace: str,
        name: str,
        container: Optional[str] = None,
        tail_lines: Optional[int] = None,
        follow: bool = False,
    ):
        """Signature mirrors KubeClient.read_pod_log (the apiserver
        requires ?container= for multi-container pods and supports
        ?tailLines= and ?follow=); the in-memory twin validates the
        container name and honors the tail so SDK code exercises the
        same contract. follow=True returns an ITERATOR of log chunks
        that ends when the pod reaches a terminal phase or is deleted
        (kubectl logs -f semantics)."""
        with self._lock:
            pod = self._pods.get((namespace, name))
            if pod is None:
                raise NotFound(f"pod {namespace}/{name}")
            if container is not None and container not in [
                c.name for c in pod.spec.containers
            ]:
                raise BadRequest(
                    f"container {container} is not valid for pod {name}"
                )
            text = self._pod_logs.get((namespace, name), "")
        full_len = len(text)  # offsets are in FULL-buffer coordinates:
        # the tail below restricts the HISTORY shown, not what counts
        # as already-delivered for the follow stream
        if tail_lines is not None:
            n = int(tail_lines)
            if n < 0:  # matches the apiserver's Invalid class
                raise BadRequest(
                    f"tailLines must be a non-negative integer, got {n}"
                )
            lines = text.splitlines(keepends=True)
            text = "".join(lines[-n:]) if n else ""
        if not follow:
            return text
        return self._follow_pod_log(namespace, name, full_len, text)

    def _follow_pod_log(self, namespace: str, name: str,
                        offset: int, first: str):
        """Generator behind read_pod_log(follow=True): poll the log
        buffer, yield appended chunks, stop once the pod is terminal
        (after draining whatever it wrote) or deleted."""
        import time as _time

        if first:
            yield first
        while True:
            with self._lock:
                pod = self._pods.get((namespace, name))
                text = self._pod_logs.get((namespace, name), "")
            if len(text) > offset:
                yield text[offset:]
                offset = len(text)
                continue  # drain fully before any terminal check
            if pod is None or pod.status.phase in (
                k8s.POD_SUCCEEDED, k8s.POD_FAILED,
            ):
                return
            _time.sleep(0.05)

    # -- Kubelet simulator -------------------------------------------------

    def mark_pod_running(self, namespace: str, name: str) -> None:
        self._set_phase(namespace, name, k8s.POD_RUNNING)

    def terminate_pod(self, namespace: str, name: str, exit_code: int = 0) -> None:
        """Terminate the main container with a chosen exit code — the
        in-process analog of the fake server's /exit?exitCode=n."""
        phase = k8s.POD_SUCCEEDED if exit_code == 0 else k8s.POD_FAILED
        with self._lock:
            pod = self._pods.get((namespace, name))
            if pod is None:
                raise NotFound(f"pod {namespace}/{name}")
            pod.status.phase = phase
            container_name = (
                pod.spec.containers[0].name if pod.spec.containers else "tensorflow"
            )
            pod.status.container_statuses = [
                k8s.ContainerStatus(
                    name=container_name,
                    state=k8s.ContainerState(
                        terminated=k8s.ContainerStateTerminated(exit_code=exit_code)
                    ),
                )
            ]
            pod.metadata.resource_version = str(next(self._rv))
            self._notify("pod", MODIFIED, pod)

    def _set_phase(self, namespace: str, name: str, phase: str) -> None:
        with self._lock:
            pod = self._pods.get((namespace, name))
            if pod is None:
                raise NotFound(f"pod {namespace}/{name}")
            pod.status.phase = phase
            pod.metadata.resource_version = str(next(self._rv))
            self._notify("pod", MODIFIED, pod)

    def run_all_pending(self, namespace: Optional[str] = None) -> int:
        """Advance every Pending pod to Running (a permissive scheduler +
        kubelet tick). Returns how many pods moved."""
        with self._lock:
            moved = []
            for (ns, name), pod in self._pods.items():
                if namespace is not None and ns != namespace:
                    continue
                if pod.status.phase == k8s.POD_PENDING:
                    moved.append((ns, name))
        for ns, name in moved:
            self.mark_pod_running(ns, name)
        return len(moved)
