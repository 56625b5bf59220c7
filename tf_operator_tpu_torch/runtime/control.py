"""Pod/Service control: typed create/delete of children with ownership.

Mirrors reference pkg/control (RealPodControl pod_control.go:55-105,
RealServiceControl/FakeServiceControl service_control.go): every child
is stamped with the job's labels and a controller ownerReference, and
every action emits an Event. Fake variants record instead of acting —
the backbone of the table-driven controller tests (reference
controller_test.go:44-64).

The port's copy of tf_operator_tpu/runtime/control.py; it imports nothing of that package.
"""

from __future__ import annotations

from typing import List, Optional, Protocol

from ..api import k8s
from ..api.serde import deep_copy
from ..api.types import API_VERSION, KIND, TFJob
from .substrate import Substrate


def owner_reference(job) -> k8s.OwnerReference:
    """Reference GenOwnerReference, jobcontroller.go:196-208.

    Works for any owning resource carrying kind/api_version (TFJob,
    ServeService); the TFJob constants remain the fallback for owner
    objects predating the kind field."""
    return k8s.OwnerReference(
        api_version=getattr(job, "api_version", API_VERSION),
        kind=getattr(job, "kind", KIND),
        name=job.name,
        uid=job.metadata.uid,
        controller=True,
        block_owner_deletion=True,
    )


def is_controlled_by(meta: k8s.ObjectMeta, job: TFJob) -> bool:
    return any(
        ref.controller and ref.uid == job.metadata.uid
        for ref in meta.owner_references
    )


class Recorder(Protocol):
    def event(self, obj_kind: str, obj_name: str, namespace: str,
              event_type: str, reason: str, message: str) -> None: ...


class PodControl(Protocol):
    def create_pod(self, namespace: str, pod: k8s.Pod, job: TFJob) -> None: ...
    def delete_pod(self, namespace: str, name: str, job: TFJob) -> None: ...
    def patch_pod_labels(self, namespace: str, name: str, labels: dict) -> None: ...
    def patch_pod_owner_references(
        self, namespace: str, name: str, refs: List[k8s.OwnerReference],
        expected_uid: str = "",
    ) -> None: ...


class ServiceControl(Protocol):
    def create_service(self, namespace: str, service: k8s.Service, job: TFJob) -> None: ...
    def delete_service(self, namespace: str, name: str, job: TFJob) -> None: ...
    def patch_service_owner_references(
        self, namespace: str, name: str, refs: List[k8s.OwnerReference],
        expected_uid: str = "",
    ) -> None: ...


class RealPodControl:
    def __init__(self, substrate: Substrate, recorder: Recorder) -> None:
        self._substrate = substrate
        self._recorder = recorder

    def create_pod(self, namespace: str, pod: k8s.Pod, job: TFJob) -> None:
        pod = deep_copy(pod)
        pod.metadata.namespace = namespace
        if not is_controlled_by(pod.metadata, job):
            pod.metadata.owner_references.append(owner_reference(job))
        self._substrate.create_pod(pod)
        self._recorder.event(
            getattr(job, "kind", KIND), job.name, namespace,
            "Normal", "SuccessfulCreatePod",
            f"Created pod: {pod.metadata.name}",
        )

    def delete_pod(self, namespace: str, name: str, job: TFJob) -> None:
        self._substrate.delete_pod(namespace, name)
        self._recorder.event(
            getattr(job, "kind", KIND), job.name, namespace,
            "Normal", "SuccessfulDeletePod",
            f"Deleted pod: {name}",
        )

    def patch_pod_labels(self, namespace: str, name: str, labels: dict) -> None:
        self._substrate.patch_pod_labels(namespace, name, labels)

    def patch_pod_owner_references(
        self, namespace: str, name: str, refs: List[k8s.OwnerReference],
        expected_uid: str = "",
    ) -> None:
        self._substrate.patch_pod_owner_references(
            namespace, name, refs, expected_uid
        )


class RealServiceControl:
    def __init__(self, substrate: Substrate, recorder: Recorder) -> None:
        self._substrate = substrate
        self._recorder = recorder

    def create_service(self, namespace: str, service: k8s.Service, job: TFJob) -> None:
        service = deep_copy(service)
        service.metadata.namespace = namespace
        if not is_controlled_by(service.metadata, job):
            service.metadata.owner_references.append(owner_reference(job))
        self._substrate.create_service(service)
        self._recorder.event(
            getattr(job, "kind", KIND), job.name, namespace,
            "Normal", "SuccessfulCreateService",
            f"Created service: {service.metadata.name}",
        )

    def delete_service(self, namespace: str, name: str, job: TFJob) -> None:
        self._substrate.delete_service(namespace, name)
        self._recorder.event(
            getattr(job, "kind", KIND), job.name, namespace,
            "Normal", "SuccessfulDeleteService",
            f"Deleted service: {name}",
        )

    def patch_service_owner_references(
        self, namespace: str, name: str, refs: List[k8s.OwnerReference],
        expected_uid: str = "",
    ) -> None:
        self._substrate.patch_service_owner_references(
            namespace, name, refs, expected_uid
        )


class FakePodControl:
    """Records intents; used by table-driven reconciler tests the way the
    reference uses controller.FakePodControl (controller_test.go:52-57)."""

    def __init__(self) -> None:
        self.created: List[k8s.Pod] = []
        self.deleted: List[str] = []
        self.patched: List[tuple] = []
        self.owner_patched: List[tuple] = []  # (name, refs)
        self.create_error: Optional[Exception] = None

    def create_pod(self, namespace: str, pod: k8s.Pod, job: TFJob) -> None:
        if self.create_error is not None:
            raise self.create_error
        pod = deep_copy(pod)
        pod.metadata.namespace = namespace
        self.created.append(pod)

    def delete_pod(self, namespace: str, name: str, job: TFJob) -> None:
        self.deleted.append(name)

    def patch_pod_labels(self, namespace: str, name: str, labels: dict) -> None:
        self.patched.append((name, labels))

    def patch_pod_owner_references(
        self, namespace: str, name: str, refs: List[k8s.OwnerReference],
        expected_uid: str = "",
    ) -> None:
        self.owner_patched.append((name, [deep_copy(r) for r in refs]))


class FakeServiceControl:
    def __init__(self) -> None:
        self.created: List[k8s.Service] = []
        self.deleted: List[str] = []
        self.owner_patched: List[tuple] = []

    def create_service(self, namespace: str, service: k8s.Service, job: TFJob) -> None:
        service = deep_copy(service)
        service.metadata.namespace = namespace
        self.created.append(service)

    def delete_service(self, namespace: str, name: str, job: TFJob) -> None:
        self.deleted.append(name)

    def patch_service_owner_references(
        self, namespace: str, name: str, refs: List[k8s.OwnerReference],
        expected_uid: str = "",
    ) -> None:
        self.owner_patched.append((name, [deep_copy(r) for r in refs]))
