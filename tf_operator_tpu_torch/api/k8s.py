"""Kubernetes-lite object model: the subset of core/v1 the operator touches.

The reference vendors all of k8s.io/api; we model only what the TFJob
data path actually reads or writes — pod templates, pods, headless
services, events, owner references — and round-trip everything else
through ``extra`` (see serde.py). Field coverage is driven by the
reference's usage sites, cited per class.

The port's copy of tf_operator_tpu/api/k8s.py; it imports nothing of that package.
"""

from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Any, Dict, List, Optional

# Pod phases (k8s core/v1 PodPhase) — consumed by the status machine,
# reference pkg/controller.v1/tensorflow/status.go:204-214.
POD_PENDING = "Pending"
POD_RUNNING = "Running"
POD_SUCCEEDED = "Succeeded"
POD_FAILED = "Failed"
POD_UNKNOWN = "Unknown"


@dataclass
class OwnerReference:
    """Ownership link used for adoption/orphaning and cascading GC.

    Reference: GenOwnerReference, pkg/common/jobcontroller/jobcontroller.go:196-208.
    """

    api_version: str = ""
    kind: str = ""
    name: str = ""
    uid: str = ""
    controller: Optional[bool] = None
    block_owner_deletion: Optional[bool] = None


@dataclass
class ObjectMeta:
    name: str = ""
    namespace: str = ""
    uid: str = ""
    resource_version: str = ""
    labels: Dict[str, str] = field(default_factory=dict)
    annotations: Dict[str, str] = field(default_factory=dict)
    owner_references: List[OwnerReference] = field(default_factory=list)
    creation_timestamp: Optional[str] = None
    deletion_timestamp: Optional[str] = None
    extra: Dict[str, Any] = field(default_factory=dict)


@dataclass
class EnvVar:
    name: str = ""
    value: str = ""
    extra: Dict[str, Any] = field(default_factory=dict)


@dataclass
class ContainerPort:
    name: str = ""
    container_port: int = 0
    host_port: Optional[int] = None
    extra: Dict[str, Any] = field(default_factory=dict)


@dataclass
class ResourceRequirements:
    limits: Dict[str, Any] = field(default_factory=dict)
    requests: Dict[str, Any] = field(default_factory=dict)


@dataclass
class Container:
    name: str = ""
    image: str = ""
    command: List[str] = field(default_factory=list)
    args: List[str] = field(default_factory=list)
    env: List[EnvVar] = field(default_factory=list)
    ports: List[ContainerPort] = field(default_factory=list)
    resources: Optional[ResourceRequirements] = None
    extra: Dict[str, Any] = field(default_factory=dict)

    def env_value(self, name: str) -> Optional[str]:
        for item in self.env:
            if item.name == name:
                return item.value
        return None

    def set_env(self, name: str, value: str) -> None:
        for item in self.env:
            if item.name == name:
                item.value = value
                return
        self.env.append(EnvVar(name=name, value=value))


@dataclass
class PodSpec:
    containers: List[Container] = field(default_factory=list)
    # Pod-level restart policy (distinct from the replica RestartPolicy;
    # mapped in reference pod.go:309-315).
    restart_policy: Optional[str] = None
    host_network: Optional[bool] = None
    scheduler_name: Optional[str] = None
    node_selector: Dict[str, str] = field(default_factory=dict)
    extra: Dict[str, Any] = field(default_factory=dict)

    def container(self, name: str) -> Optional[Container]:
        for c in self.containers:
            if c.name == name:
                return c
        return None


@dataclass
class PodTemplateSpec:
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    spec: PodSpec = field(default_factory=PodSpec)


@dataclass
class ContainerStateTerminated:
    exit_code: int = 0
    reason: str = ""
    message: str = ""
    extra: Dict[str, Any] = field(default_factory=dict)


@dataclass
class ContainerState:
    terminated: Optional[ContainerStateTerminated] = None
    extra: Dict[str, Any] = field(default_factory=dict)


@dataclass
class ContainerStatus:
    name: str = ""
    state: Optional[ContainerState] = None
    restart_count: int = 0
    extra: Dict[str, Any] = field(default_factory=dict)


@dataclass
class PodStatus:
    phase: str = POD_PENDING
    container_statuses: List[ContainerStatus] = field(default_factory=list)
    extra: Dict[str, Any] = field(default_factory=dict)


@dataclass
class Pod:
    api_version: str = "v1"
    kind: str = "Pod"
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    spec: PodSpec = field(default_factory=PodSpec)
    status: PodStatus = field(default_factory=PodStatus)

    def is_active(self) -> bool:
        """Reference k8sutil.FilterActivePods, pkg/util/k8sutil/k8sutil.go:75-94."""
        return (
            self.status.phase not in (POD_SUCCEEDED, POD_FAILED)
            and self.metadata.deletion_timestamp is None
        )


@dataclass
class ServicePort:
    name: str = ""
    port: int = 0
    extra: Dict[str, Any] = field(default_factory=dict)


@dataclass
class ServiceSpec:
    # "None" => headless: the stable-DNS addressing scheme TF_CONFIG and
    # the TPU hostnames point at (reference service.go:113-127).
    cluster_ip: Optional[str] = field(default=None, metadata={"json": "clusterIP"})
    selector: Dict[str, str] = field(default_factory=dict)
    ports: List[ServicePort] = field(default_factory=list)
    extra: Dict[str, Any] = field(default_factory=dict)


@dataclass
class Service:
    api_version: str = "v1"
    kind: str = "Service"
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    spec: ServiceSpec = field(default_factory=ServiceSpec)


@dataclass
class Event:
    """Lifecycle breadcrumbs; the reference records one per action via the
    EventRecorder (jobcontroller.go:160-163) and the E2E suite asserts on
    them (py/kubeflow/tf_operator/k8s_util.py:158)."""

    type: str = "Normal"
    reason: str = ""
    message: str = ""
    involved_object_kind: str = ""
    involved_object_name: str = ""
    involved_object_namespace: str = ""
    timestamp: Optional[str] = None
    extra: Dict[str, Any] = field(default_factory=dict)


# single source for the default lease duration (reference server.go:53);
# leader election and kube.py must not restate the number
DEFAULT_LEASE_DURATION = 15.0


@dataclass
class Lease:
    """Coordination lease record (k8s coordination.k8s.io/v1 Lease
    shape, reduced to the fields leader election uses). Stored by
    substrates; consumed by server.leader.LeaseLock and
    runtime.leader.LeaderElector.

    ``epoch`` is the fencing token (carried as leaseTransitions on the
    wire): it increments every time leadership changes hands, and
    substrates reject writes stamped with an older epoch — a
    paused-then-resumed old leader cannot double-create children or
    clobber status (docs/ha.md).

    acquire_time/renew_time are CHANGE MARKERS, not cross-process
    timestamps: followers judge expiry by how long the record sits
    unchanged on their OWN monotonic clock (clock-skew safety), so the
    values themselves are opaque.
    """

    namespace: str = "default"
    name: str = "tfjob-tpu-operator"
    holder: str = ""
    acquire_time: float = 0.0
    renew_time: float = 0.0
    lease_duration_seconds: float = DEFAULT_LEASE_DURATION
    resource_version: str = ""
    epoch: int = 0

    # NOTE: deliberately no expired(now) helper — judging expiry by
    # comparing a local clock against the holder's written renewTime is
    # skew-unsafe; the lock tracks locally-observed change instead
    # (see runtime/leader.py and test_clock_skew_does_not_steal_healthy_lease).

    def copy(self) -> "Lease":
        return replace(self)


def pod_main_exit_code(pod: Pod, container_name: str) -> Optional[int]:
    """Exit code of the job container, if it has terminated.

    Reference reads status.containerStatuses for the "tensorflow"
    container to drive ExitCode restart policy (pod.go:119-139).
    """
    for status in pod.status.container_statuses:
        if status.name != container_name:
            continue
        if status.state and status.state.terminated:
            return status.state.terminated.exit_code
    return None


__all__ = [
    "POD_PENDING",
    "POD_RUNNING",
    "POD_SUCCEEDED",
    "POD_FAILED",
    "POD_UNKNOWN",
    "OwnerReference",
    "ObjectMeta",
    "EnvVar",
    "ContainerPort",
    "ResourceRequirements",
    "Container",
    "PodSpec",
    "PodTemplateSpec",
    "ContainerStateTerminated",
    "ContainerState",
    "ContainerStatus",
    "PodStatus",
    "Pod",
    "ServicePort",
    "ServiceSpec",
    "Service",
    "Event",
    "DEFAULT_LEASE_DURATION",
    "Lease",
    "pod_main_exit_code",
]
