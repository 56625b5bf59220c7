"""Defaulting for TFJob, mirroring reference pkg/apis/tensorflow/v1/defaults.go.

Applied at admission (reference job.go:91 calls scheme defaulting before
any reconcile): replica-type key normalization, replicas -> 1,
restartPolicy -> Never, cleanPodPolicy -> Running, and the default
tfjob-port 2222 appended to the workload container if absent
(defaults.go:36-113).

TPU additions: a TPU replica set defaults its pod spec's node selectors
from tpuAccelerator/tpuTopology and requests one google.com/tpu chip per
pod if no explicit TPU resource is set.

The port's copy of tf_operator_tpu/api/defaults.py; it imports nothing of that package.
"""

from __future__ import annotations

from typing import Dict

from . import types as t
from .k8s import Container, ContainerPort, ResourceRequirements
from .validation import chips_per_pod

# Canonical spellings for case-insensitive replica-type keys
# (reference defaults.go:63-77 setTypeNamesToCamelCase).
_CANONICAL = {rt.value.lower(): rt.value for rt in t.ReplicaType}


def normalize_replica_type(key: str) -> str:
    return _CANONICAL.get(key.lower(), key)


def _set_default_port(container: Container) -> None:
    """Append tfjob-port 2222 if the workload container declares no port
    with that name (reference defaults.go:36-51 setDefaultPort)."""
    for port in container.ports:
        if port.name == t.DEFAULT_PORT_NAME:
            return
    container.ports.append(
        ContainerPort(name=t.DEFAULT_PORT_NAME, container_port=t.DEFAULT_PORT)
    )


def _set_tpu_defaults(spec: t.ReplicaSpec) -> None:
    pod_spec = spec.template.spec
    if spec.tpu_accelerator:
        pod_spec.node_selector.setdefault(
            t.GKE_TPU_ACCELERATOR_SELECTOR, spec.tpu_accelerator
        )
    if spec.tpu_topology:
        pod_spec.node_selector.setdefault(t.GKE_TPU_TOPOLOGY_SELECTOR, spec.tpu_topology)
    container = pod_spec.container(t.DEFAULT_CONTAINER_NAME)
    if container is None:
        return
    if container.resources is None:
        container.resources = ResourceRequirements()
    res = container.resources
    if t.TPU_RESOURCE_KEY not in res.limits and t.TPU_RESOURCE_KEY not in res.requests:
        # A TPU pod claims every chip it can see: a full host for
        # multi-host slices, only the slice's own chips for sub-host
        # shapes (1x1, 2x2) so the pod stays schedulable there.
        chips = chips_per_pod(spec.tpu_accelerator or "v5e", spec.tpu_topology)
        res.limits[t.TPU_RESOURCE_KEY] = chips
        res.requests[t.TPU_RESOURCE_KEY] = chips


def set_defaults(job: t.TFJob) -> t.TFJob:
    """Default a TFJob in place (and return it).

    Mirrors SetDefaults_TFJob (reference defaults.go:92-113).
    """
    spec = job.spec
    if spec.run_policy.clean_pod_policy is None:
        spec.run_policy.clean_pod_policy = t.CleanPodPolicy.RUNNING
    if spec.success_policy is None:
        spec.success_policy = t.SuccessPolicy.DEFAULT

    normalized: Dict[str, t.ReplicaSpec] = {}
    for key, rspec in spec.tf_replica_specs.items():
        normalized[normalize_replica_type(key)] = rspec
    spec.tf_replica_specs = normalized

    for key, rspec in spec.tf_replica_specs.items():
        if rspec is None:
            continue  # validation reports nil specs; don't crash here
        if rspec.replicas is None:
            rspec.replicas = 1
        if rspec.restart_policy is None:
            rspec.restart_policy = t.RestartPolicy.NEVER
        container = rspec.template.spec.container(t.DEFAULT_CONTAINER_NAME)
        if container is not None:
            _set_default_port(container)
        if key == t.ReplicaType.TPU.value:
            _set_tpu_defaults(rspec)
    return job


def set_serve_defaults(svc: t.ServeService) -> t.ServeService:
    """Default a ServeService in place (and return it): replicas -> 1,
    maxUnavailable -> 1, slots -> 8, port -> 8600, and a default serve
    container (image + command + port) when the template declares none
    — the in-process fleet only needs the pod as a reconcile unit, but
    the template must still describe a runnable replica."""
    spec = svc.spec
    if spec.replicas is None:
        spec.replicas = 1
    if spec.max_unavailable is None:
        spec.max_unavailable = 1
    if spec.slots is None:
        spec.slots = 8
    if spec.port is None:
        spec.port = t.DEFAULT_SERVE_PORT
    # role-typed replica groups (disaggregated prefill/decode):
    # normalize role-key case to the SERVE_ROLES spellings, then
    # default each group's scale to 1 and its slots to the fleet-wide
    # spec.slots (prefill_chunk stays None = engine default unless the
    # spec pins it per role)
    if spec.replica_groups:
        canonical = {role.lower(): role for role in t.SERVE_ROLES}
        spec.replica_groups = {
            canonical.get(key.lower(), key): group
            for key, group in spec.replica_groups.items()
        }
        for group in spec.replica_groups.values():
            if group is None:
                continue  # validation reports nil groups; don't crash
            if group.replicas is None:
                group.replicas = 1
            # autoscaler band defaults to pinned at the current scale;
            # widening [minReplicas, maxReplicas] opts the group in
            if group.min_replicas is None:
                group.min_replicas = min(
                    group.replicas, group.max_replicas or group.replicas
                )
            if group.max_replicas is None:
                group.max_replicas = max(group.replicas, group.min_replicas)
            if group.slots is None:
                group.slots = spec.slots
    pod_spec = spec.template.spec
    if not pod_spec.containers:
        pod_spec.containers.append(
            Container(
                name=t.SERVE_CONTAINER_NAME,
                image="tf-operator-tpu/serve:latest",
                command=[
                    "python", "-m", "tf_operator_tpu_torch.serve",
                    "--preset", spec.preset,
                    "--batching", "continuous",
                    "--slots", str(spec.slots),
                ] + (
                    ["--mesh-shape", spec.mesh_shape]
                    if spec.mesh_shape else []
                ),
            )
        )
    container = pod_spec.container(t.SERVE_CONTAINER_NAME)
    if container is not None and not any(
        p.name == t.DEFAULT_SERVE_PORT_NAME for p in container.ports
    ):
        container.ports.append(
            ContainerPort(
                name=t.DEFAULT_SERVE_PORT_NAME, container_port=spec.port
            )
        )
    return svc
