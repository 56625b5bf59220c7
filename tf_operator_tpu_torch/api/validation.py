"""TFJob validation, mirroring reference pkg/apis/tensorflow/validation/validation.go:27-73.

Checks: replica specs present and non-nil, each template has containers,
each has a container named "tensorflow" with an image, at most one
Chief/Master, at most one Evaluator. TPU additions: topology strings
parse, chip counts are consistent with worker fan-out, and TPU replica
sets don't mix with GPU resource requests.

The port's copy of tf_operator_tpu/api/validation.py; it imports nothing of that package.
"""

from __future__ import annotations

import re
from typing import List, Optional

from . import types as t


class ValidationError(ValueError):
    pass


_TOPOLOGY_RE = re.compile(r"^\d+x\d+(x\d+)?$")
# accelerator "v5e-8" etc.: generation + chip count
_ACCEL_RE = re.compile(r"^v\d+[a-z]*-\d+$", re.IGNORECASE)

# Chips per TPU host VM in this framework's canonical slice shapes: every
# supported generation (v2-v6e boards) carries 4 chips per host, one pod
# per host. The accelerator suffix in OUR naming always counts chips
# ("v5e-8" = 8 chips), never TensorCores.
_CHIPS_PER_HOST = {"v2": 4, "v3": 4, "v4": 4, "v5e": 4, "v5p": 4, "v6e": 4}


def chips_per_host(accelerator: str) -> int:
    gen = accelerator.split("-")[0].lower()
    return _CHIPS_PER_HOST.get(gen, 4)


def accelerator_chip_count(accelerator: str) -> int:
    """Total chips encoded in the accelerator name suffix ("v5e-8" -> 8)."""
    return int(accelerator.rsplit("-", 1)[1])


def chips_per_pod(accelerator: str, topology: Optional[str]) -> int:
    """Per-pod chip request: a sub-host slice (e.g. 1x1, 2x2 on v5e)
    claims only its own chips; multi-host slices claim a full host."""
    per_host = chips_per_host(accelerator)
    if topology and _TOPOLOGY_RE.match(topology):
        return min(per_host, topology_chip_count(topology))
    return per_host


def topology_chip_count(topology: str) -> int:
    dims = [int(d) for d in topology.lower().split("x")]
    count = 1
    for d in dims:
        count *= d
    return count


def expected_hosts(accelerator: str, topology: str) -> int:
    """Number of host VMs (= pods = replicas) for a slice shape."""
    per_host = chips_per_host(accelerator)
    chips = topology_chip_count(topology)
    if chips > per_host and chips % per_host != 0:
        raise ValidationError(
            f"topology {topology!r} has {chips} chips, not a multiple of the "
            f"{per_host} chips per {accelerator} host"
        )
    return max(1, chips // per_host)


def _validate_tpu_replica(key: str, spec: t.ReplicaSpec, errs: List[str]) -> None:
    if spec.tpu_topology and not _TOPOLOGY_RE.match(spec.tpu_topology):
        errs.append(
            f"TFJobSpec.tfReplicaSpecs.{key}.tpuTopology {spec.tpu_topology!r} "
            "must look like '2x4' or '4x4x4'"
        )
    if spec.tpu_accelerator and not _ACCEL_RE.match(spec.tpu_accelerator):
        errs.append(
            f"TFJobSpec.tfReplicaSpecs.{key}.tpuAccelerator {spec.tpu_accelerator!r} "
            "must look like 'v5e-8'"
        )
    if (
        spec.tpu_accelerator
        and spec.tpu_topology
        and _ACCEL_RE.match(spec.tpu_accelerator)
        and _TOPOLOGY_RE.match(spec.tpu_topology)
    ):
        chips = topology_chip_count(spec.tpu_topology)
        declared = accelerator_chip_count(spec.tpu_accelerator)
        if declared != chips:
            errs.append(
                f"TFJobSpec.tfReplicaSpecs.{key}: accelerator "
                f"{spec.tpu_accelerator!r} declares {declared} chips but topology "
                f"{spec.tpu_topology!r} has {chips}"
            )
        else:
            try:
                want = expected_hosts(spec.tpu_accelerator, spec.tpu_topology)
            except ValidationError as err:
                errs.append(f"TFJobSpec.tfReplicaSpecs.{key}: {err}")
            else:
                if spec.replicas is not None and spec.replicas != want:
                    errs.append(
                        f"TFJobSpec.tfReplicaSpecs.{key}.replicas={spec.replicas} "
                        f"but {spec.tpu_accelerator}/{spec.tpu_topology} is a "
                        f"{want}-host slice; a multi-host slice must run exactly "
                        "one pod per host"
                    )
    container = spec.template.spec.container(t.DEFAULT_CONTAINER_NAME)
    if container is not None and container.resources is not None:
        for res in (container.resources.limits, container.resources.requests):
            for res_key in res:
                if "nvidia.com/gpu" in res_key:
                    errs.append(
                        f"TFJobSpec.tfReplicaSpecs.{key} requests GPU resources; "
                        "TPU replica sets must not mix accelerator types"
                    )


def validate(job: t.TFJob) -> None:
    """Raise ValidationError listing every problem found."""
    errs: List[str] = []
    specs = job.spec.tf_replica_specs
    if not specs:
        errs.append("TFJobSpec is not valid: tfReplicaSpecs must be specified")

    chief_like = 0
    evaluators = 0
    for key, spec in specs.items():
        if spec is None:
            errs.append(f"TFJobSpec.tfReplicaSpecs.{key} is not valid: spec is nil")
            continue
        try:
            rtype = t.ReplicaType(key)
        except ValueError:
            errs.append(
                f"TFJobSpec.tfReplicaSpecs key {key!r} is not a valid replica type "
                f"(expected one of {[rt.value for rt in t.ReplicaType]})"
            )
            continue
        containers = spec.template.spec.containers
        if not containers:
            errs.append(
                f"TFJobSpec.tfReplicaSpecs.{key} is not valid: containers must be specified"
            )
            continue
        for container in containers:
            if not container.image:
                errs.append(
                    f"TFJobSpec.tfReplicaSpecs.{key} is not valid: image is "
                    f"undefined in container {container.name!r}"
                )
        if spec.template.spec.container(t.DEFAULT_CONTAINER_NAME) is None:
            errs.append(
                f"TFJobSpec.tfReplicaSpecs.{key} is not valid: there must be a "
                f"container named {t.DEFAULT_CONTAINER_NAME!r}"
            )
        if rtype in t.CHIEF_LIKE:
            chief_like += 1
        if rtype == t.ReplicaType.EVALUATOR:
            # Evaluator cardinality counts replicas, not replica sets
            # (reference validation.go:45-46).
            evaluators += spec.replicas if spec.replicas is not None else 1
        if rtype == t.ReplicaType.TPU:
            _validate_tpu_replica(key, spec, errs)
        elif spec.tpu_accelerator or spec.tpu_topology:
            errs.append(
                f"TFJobSpec.tfReplicaSpecs.{key}: tpuAccelerator/tpuTopology "
                "are only valid on the TPU replica type"
            )

    if chief_like > 1:
        errs.append("TFJobSpec is not valid: more than 1 Chief/Master replica set")
    if evaluators > 1:
        errs.append("TFJobSpec is not valid: more than 1 Evaluator replica")

    if errs:
        raise ValidationError("; ".join(errs))


def is_valid(job: t.TFJob) -> bool:
    try:
        validate(job)
        return True
    except ValidationError:
        return False


def validate_serve_service(svc: t.ServeService) -> None:
    """Raise ValidationError listing every problem found. Expects a
    defaulted spec (set_serve_defaults) — None fields are reported."""
    errs: List[str] = []
    spec = svc.spec
    if not svc.metadata.name:
        errs.append("ServeService metadata.name must be specified")
    if spec.replicas is None or spec.replicas < 1:
        errs.append(
            f"ServeServiceSpec.replicas must be >= 1, got {spec.replicas}"
        )
    if spec.max_unavailable is None or spec.max_unavailable < 1:
        errs.append(
            "ServeServiceSpec.maxUnavailable must be >= 1, got "
            f"{spec.max_unavailable}"
        )
    elif spec.replicas is not None and spec.max_unavailable > spec.replicas:
        errs.append(
            f"ServeServiceSpec.maxUnavailable={spec.max_unavailable} "
            f"exceeds replicas={spec.replicas}"
        )
    if spec.slots is None or spec.slots < 1:
        errs.append(
            f"ServeServiceSpec.slots must be >= 1, got {spec.slots}"
        )
    if spec.mesh_shape:
        parts = spec.mesh_shape.lower().split("x")
        if len(parts) != 2 or not all(
            p.isdigit() and int(p) >= 1 for p in parts
        ):
            errs.append(
                "ServeServiceSpec.meshShape must be 'BATCHxMODEL' "
                f"with axes >= 1, got {spec.mesh_shape!r}"
            )
    if spec.port is None or not (0 < spec.port < 65536):
        errs.append(
            f"ServeServiceSpec.port must be in 1..65535, got {spec.port}"
        )
    if not spec.preset:
        errs.append("ServeServiceSpec.preset must be specified")
    for role, group in spec.replica_groups.items():
        if role not in t.SERVE_ROLES:
            errs.append(
                f"ServeServiceSpec.replicaGroups key {role!r} is not a "
                f"serve role ({'/'.join(t.SERVE_ROLES)})"
            )
        if group is None:
            errs.append(
                f"ServeServiceSpec.replicaGroups[{role!r}] must be "
                "specified"
            )
            continue
        if group.replicas is None or group.replicas < 1:
            errs.append(
                f"ServeServiceSpec.replicaGroups[{role!r}].replicas "
                f"must be >= 1, got {group.replicas}"
            )
        if group.slots is not None and group.slots < 1:
            errs.append(
                f"ServeServiceSpec.replicaGroups[{role!r}].slots "
                f"must be >= 1, got {group.slots}"
            )
        if group.prefill_chunk is not None and group.prefill_chunk < 0:
            errs.append(
                f"ServeServiceSpec.replicaGroups[{role!r}].prefillChunk "
                f"must be >= 0, got {group.prefill_chunk}"
            )
        if group.speculate is not None:
            if group.speculate not in ("off", "ngram", "draft"):
                errs.append(
                    f"ServeServiceSpec.replicaGroups[{role!r}]."
                    f"speculate must be off/ngram/draft, got "
                    f"{group.speculate!r}"
                )
            elif (
                group.speculate != "off"
                and role == t.SERVE_ROLE_PREFILL
            ):
                errs.append(
                    f"ServeServiceSpec.replicaGroups[{role!r}]."
                    f"speculate={group.speculate!r} is decode-pool-"
                    "only: prefill replicas never decode, so their "
                    "draft/verify programs would be dead compiles"
                )
        if group.spec_depth is not None and group.spec_depth < 1:
            errs.append(
                f"ServeServiceSpec.replicaGroups[{role!r}].specDepth "
                f"must be >= 1, got {group.spec_depth}"
            )
        if group.min_replicas is not None and group.min_replicas < 1:
            errs.append(
                f"ServeServiceSpec.replicaGroups[{role!r}].minReplicas "
                f"must be >= 1, got {group.min_replicas}"
            )
        if (
            group.min_replicas is not None
            and group.max_replicas is not None
            and group.max_replicas < group.min_replicas
        ):
            errs.append(
                f"ServeServiceSpec.replicaGroups[{role!r}].maxReplicas="
                f"{group.max_replicas} is below minReplicas="
                f"{group.min_replicas}"
            )
        elif (
            group.replicas is not None
            and group.min_replicas is not None
            and group.max_replicas is not None
            and not (
                group.min_replicas <= group.replicas <= group.max_replicas
            )
        ):
            errs.append(
                f"ServeServiceSpec.replicaGroups[{role!r}].replicas="
                f"{group.replicas} is outside [minReplicas="
                f"{group.min_replicas}, maxReplicas={group.max_replicas}]"
            )
    if spec.autoscale is not None:
        policy = spec.autoscale
        if policy.enabled and not spec.replica_groups:
            errs.append(
                "ServeServiceSpec.autoscale.enabled requires "
                "replicaGroups — the autoscaler scales role pools"
            )
        if policy.cooldown_seconds <= 0:
            errs.append(
                "ServeServiceSpec.autoscale.cooldownSeconds must be "
                f"> 0, got {policy.cooldown_seconds}"
            )
        if policy.scale_out_step < 1 or policy.scale_in_step < 1:
            errs.append(
                "ServeServiceSpec.autoscale scale steps must be >= 1, "
                f"got scaleOutStep={policy.scale_out_step} "
                f"scaleInStep={policy.scale_in_step}"
            )
        if policy.max_queue_per_replica <= 0:
            errs.append(
                "ServeServiceSpec.autoscale.maxQueuePerReplica must be "
                f"> 0, got {policy.max_queue_per_replica}"
            )
    container = spec.template.spec.container(t.SERVE_CONTAINER_NAME)
    if container is None:
        errs.append(
            "ServeServiceSpec.template is not valid: there must be a "
            f"container named {t.SERVE_CONTAINER_NAME!r}"
        )
    elif not container.image:
        errs.append(
            "ServeServiceSpec.template is not valid: image is undefined "
            f"in container {t.SERVE_CONTAINER_NAME!r}"
        )
    if errs:
        raise ValidationError("; ".join(errs))


def is_valid_serve_service(svc: t.ServeService) -> bool:
    try:
        validate_serve_service(svc)
        return True
    except ValidationError:
        return False
