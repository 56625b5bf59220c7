"""TFJob API types (tpu.kubeflow.org/v1, wire-compatible with kubeflow.org/v1).

Re-designed from the reference's API layer:
  - pkg/apis/tensorflow/v1/types.go:27-127 (TFJob/TFJobSpec/TFReplicaType)
  - vendor/github.com/kubeflow/common/pkg/apis/common/v1/types.go:24-201
    (ReplicaSpec, JobStatus, JobCondition, RestartPolicy, CleanPodPolicy,
    RunPolicy, SchedulingPolicy)
  - pkg/apis/tensorflow/v1/common.go:17-23 (SuccessPolicy)
  - pkg/apis/tensorflow/v1/constants.go (ports, container name)

New in this framework: the ``TPU`` replica type, per-job TPU topology
(``tpuTopology``/``tpuAccelerator`` on the replica spec), and the
``google.com/tpu`` resource key, per the north-star in BASELINE.json.

The port's copy of tf_operator_tpu/api/types.py; it imports nothing of that package.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

from .k8s import ObjectMeta, PodTemplateSpec
from .serde import from_jsonable, to_jsonable

# --- Group / version / kind -------------------------------------------------

GROUP_NAME = "kubeflow.org"
VERSION = "v1"
KIND = "TFJob"
PLURAL = "tfjobs"
SINGULAR = "tfjob"
API_VERSION = f"{GROUP_NAME}/{VERSION}"

# --- Constants (reference pkg/apis/tensorflow/v1/constants.go) --------------

DEFAULT_PORT_NAME = "tfjob-port"
DEFAULT_CONTAINER_NAME = "tensorflow"
DEFAULT_PORT = 2222

# TPU resource/env vocabulary (new; north-star BASELINE.json).
TPU_RESOURCE_KEY = "google.com/tpu"
GKE_TPU_ACCELERATOR_SELECTOR = "cloud.google.com/gke-tpu-accelerator"
GKE_TPU_TOPOLOGY_SELECTOR = "cloud.google.com/gke-tpu-topology"

# Env injected into workload containers.
ENV_TF_CONFIG = "TF_CONFIG"
ENV_TPU_WORKER_ID = "TPU_WORKER_ID"
ENV_TPU_WORKER_HOSTNAMES = "TPU_WORKER_HOSTNAMES"
ENV_TPU_TOPOLOGY = "TPU_TOPOLOGY"
ENV_TPU_ACCELERATOR = "TPU_ACCELERATOR_TYPE"
ENV_COORDINATOR_ADDRESS = "JAX_COORDINATOR_ADDRESS"
# honored by parallel.distributed.read_process_env: remaps ONLY the
# coordinator endpoint (identity env stays authoritative) — hermetic
# E2Es and local repros rendezvous over 127.0.0.1 where the injected
# headless-service DNS name cannot resolve
ENV_COORDINATOR_OVERRIDE = "TFJOB_COORDINATOR_OVERRIDE"
ENV_NUM_PROCESSES = "JAX_NUM_PROCESSES"
ENV_PROCESS_ID = "JAX_PROCESS_ID"
ENV_CUSTOM_CLUSTER_DOMAIN = "CUSTOM_CLUSTER_DOMAIN"

# Label keys stamped on child pods/services.
# Reference: jobcontroller.go:139-143, controller.go:55-56, GenLabels
# jobcontroller.go:211-222.
LABEL_GROUP_NAME = "group-name"
LABEL_JOB_NAME = "job-name"
LABEL_TF_JOB_NAME = "tf-job-name"  # deprecated twin kept for compat
LABEL_REPLICA_TYPE = "tf-replica-type"
LABEL_REPLICA_INDEX = "tf-replica-index"
LABEL_JOB_ROLE = "job-role"

# Gang-scheduling annotation consumed by kube-batch/volcano
# (reference pod.go:224-229).
ANNOTATION_GANG_GROUP = "scheduling.k8s.io/group-name"


class ReplicaType(str, enum.Enum):
    """Replica roles. Reference types.go:88-110, plus the new TPU role."""

    PS = "PS"
    WORKER = "Worker"
    CHIEF = "Chief"
    MASTER = "Master"
    EVALUATOR = "Evaluator"
    TPU = "TPU"


# Roles that count as "the designated success indicator" when present
# (reference status.go:87-142: chief OR master; else worker 0).
CHIEF_LIKE = (ReplicaType.CHIEF, ReplicaType.MASTER)


class RestartPolicy(str, enum.Enum):
    """Reference common/v1/types.go:152-163."""

    ALWAYS = "Always"
    ON_FAILURE = "OnFailure"
    NEVER = "Never"
    EXIT_CODE = "ExitCode"


class CleanPodPolicy(str, enum.Enum):
    """Reference common/v1/types.go:131-137."""

    ALL = "All"
    RUNNING = "Running"
    NONE = "None"


class SuccessPolicy(str, enum.Enum):
    """Reference pkg/apis/tensorflow/v1/common.go:17-23."""

    DEFAULT = ""
    ALL_WORKERS = "AllWorkers"


class ConditionType(str, enum.Enum):
    """Reference common/v1/types.go:100-126."""

    CREATED = "Created"
    RUNNING = "Running"
    RESTARTING = "Restarting"
    SUCCEEDED = "Succeeded"
    FAILED = "Failed"
    # operator-side: set while the degraded-mode latch holds (the
    # apiserver is failing and pod churn is paused); not a reference
    # condition — the reference has no degraded mode to report
    DEGRADED = "Degraded"


@dataclass
class ReplicaSpec:
    """Reference common/v1/types.go:60-80, plus TPU topology fields."""

    replicas: Optional[int] = None
    template: PodTemplateSpec = field(default_factory=PodTemplateSpec)
    restart_policy: Optional[RestartPolicy] = None
    # New: TPU slice shape for this replica set, e.g. "v5e-8" + "2x4".
    # Drives worker fan-out validation and node-selector injection.
    tpu_accelerator: Optional[str] = None
    tpu_topology: Optional[str] = None
    extra: Dict[str, Any] = field(default_factory=dict)


@dataclass
class SchedulingPolicy:
    """Reference common/v1/types.go:193-201."""

    min_available: Optional[int] = None
    queue: Optional[str] = None
    extra: Dict[str, Any] = field(default_factory=dict)


@dataclass
class RunPolicy:
    """Policies shared by all job operators. Reference common/v1/types.go:166-190."""

    clean_pod_policy: Optional[CleanPodPolicy] = None
    ttl_seconds_after_finished: Optional[int] = field(
        default=None, metadata={"json": "ttlSecondsAfterFinished"}
    )
    active_deadline_seconds: Optional[int] = None
    backoff_limit: Optional[int] = None
    scheduling_policy: Optional[SchedulingPolicy] = None
    extra: Dict[str, Any] = field(default_factory=dict)


@dataclass
class TFJobSpec:
    """Reference pkg/apis/tensorflow/v1/types.go:47-86.

    The reference inlines RunPolicy fields directly on the spec; we keep
    the same flat wire format via serde metadata-free inlining below.
    """

    tf_replica_specs: Dict[str, ReplicaSpec] = field(
        default_factory=dict, metadata={"json": "tfReplicaSpecs", "keep_empty": True}
    )
    run_policy: RunPolicy = field(default_factory=RunPolicy, metadata={"json": "runPolicy"})
    success_policy: Optional[SuccessPolicy] = None
    enable_dynamic_worker: Optional[bool] = None
    extra: Dict[str, Any] = field(default_factory=dict)


@dataclass
class ReplicaStatus:
    """Reference common/v1/types.go:38-50, plus a persistent restart
    counter (new): ExitCode restarts must count toward BackoffLimit
    across syncs and controller restarts, so they live in status rather
    than controller memory."""

    active: int = 0
    succeeded: int = 0
    failed: int = 0
    restarts: int = 0


@dataclass
class JobCondition:
    """Reference common/v1/types.go:83-98."""

    type: ConditionType = ConditionType.CREATED
    status: str = "True"
    reason: str = ""
    message: str = ""
    last_update_time: Optional[str] = None
    last_transition_time: Optional[str] = None


@dataclass
class JobStatus:
    """Reference common/v1/types.go:24-36."""

    conditions: List[JobCondition] = field(default_factory=list)
    replica_statuses: Dict[str, ReplicaStatus] = field(default_factory=dict)
    start_time: Optional[str] = None
    completion_time: Optional[str] = None
    last_reconcile_time: Optional[str] = None
    extra: Dict[str, Any] = field(default_factory=dict)


@dataclass
class TFJob:
    api_version: str = API_VERSION
    kind: str = KIND
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    spec: TFJobSpec = field(default_factory=TFJobSpec)
    status: JobStatus = field(default_factory=JobStatus)
    extra: Dict[str, Any] = field(default_factory=dict)

    # -- convenience -------------------------------------------------------

    @property
    def name(self) -> str:
        return self.metadata.name

    @property
    def namespace(self) -> str:
        return self.metadata.namespace

    def key(self) -> str:
        """Workqueue key, "namespace/name" (reference util.go:24-32)."""
        return f"{self.metadata.namespace}/{self.metadata.name}" if self.metadata.namespace else self.metadata.name

    def replica_spec(self, rtype: ReplicaType) -> Optional[ReplicaSpec]:
        return self.spec.tf_replica_specs.get(rtype.value)

    def replica_types(self) -> List[ReplicaType]:
        """Replica roles present on this job, skipping unknown keys.

        Unknown/non-canonical keys are a validation concern
        (validation.py reports them); accessors must not crash on them.
        """
        out: List[ReplicaType] = []
        for key in self.spec.tf_replica_specs:
            try:
                out.append(ReplicaType(key))
            except ValueError:
                continue
        return out

    def num_replicas(self, rtype: ReplicaType) -> int:
        spec = self.replica_spec(rtype)
        if spec is None:
            return 0
        return spec.replicas if spec.replicas is not None else 1

    def total_replicas(self) -> int:
        return sum(self.num_replicas(rt) for rt in self.replica_types())

    def has_condition(self, ctype: ConditionType) -> bool:
        return any(c.type == ctype and c.status == "True" for c in self.status.conditions)

    def is_finished(self) -> bool:
        """Terminal check. Reference pkg/util/status.go semantics: a job is
        finished once Succeeded or Failed is True."""
        return self.has_condition(ConditionType.SUCCEEDED) or self.has_condition(
            ConditionType.FAILED
        )

    # -- serde -------------------------------------------------------------

    def to_dict(self) -> Dict[str, Any]:
        out = to_jsonable(self)
        # The reference's wire format inlines RunPolicy fields on the spec
        # (types.go:47-75: cleanPodPolicy, ttlSecondsAfterFinished,
        # activeDeadlineSeconds, backoffLimit live directly under .spec).
        spec = out.get("spec", {})
        run_policy = spec.pop("runPolicy", None)
        if run_policy:
            for key, value in run_policy.items():
                spec.setdefault(key, value)
        return out

    @classmethod
    def from_dict(cls, data: Dict[str, Any]) -> "TFJob":
        data = dict(data)
        spec = dict(data.get("spec") or {})
        if "runPolicy" not in spec:
            run_policy: Dict[str, Any] = {}
            for key in (
                "cleanPodPolicy",
                "ttlSecondsAfterFinished",
                "activeDeadlineSeconds",
                "backoffLimit",
                "schedulingPolicy",
            ):
                if key in spec:
                    run_policy[key] = spec.pop(key)
            if run_policy:
                spec["runPolicy"] = run_policy
        data["spec"] = spec
        return from_jsonable(data, cls)

    def copy(self) -> "TFJob":
        return from_jsonable(to_jsonable(self), TFJob)


def replica_name(job_name: str, rtype: str, index: int) -> str:
    """Child pod/service name: "{job}-{type}-{index}" (lowercased rtype).

    Reference jobcontroller/util.go:47-57 (GenGeneralName).
    """
    return f"{job_name}-{rtype.lower()}-{index}".replace("/", "-")


def gen_labels(job_name: str) -> Dict[str, str]:
    """Base selector labels. Reference jobcontroller.go:211-222."""
    safe = job_name.replace("/", "-")
    return {
        LABEL_GROUP_NAME: GROUP_NAME,
        LABEL_JOB_NAME: safe,
        LABEL_TF_JOB_NAME: safe,
    }


# --- ServeService (serving fleet CRD) ---------------------------------------
#
# The serving twin of TFJob: a reconciled fleet of continuous-batching
# engine replicas behind the least-loaded router (serve/router.py).
# Where TFJob describes a gang of training workers that run to
# completion, ServeService describes a long-lived replica set with
# drain-based rolling weight updates (spec.weightsVersion bump) bounded
# by maxUnavailable. No reference counterpart — the reference operator
# stops at training — but the wire shape follows the same conventions
# (camelCase, conditions list, status subresource).

SERVE_KIND = "ServeService"
SERVE_PLURAL = "serveservices"
SERVE_SINGULAR = "serveservice"

SERVE_CONTAINER_NAME = "serve"
DEFAULT_SERVE_PORT_NAME = "serve-port"
DEFAULT_SERVE_PORT = 8600

LABEL_SERVE_NAME = "serve-service-name"
LABEL_SERVE_REPLICA_INDEX = "serve-replica-index"
# stamped with spec.weightsVersion at pod creation and patched after a
# successful in-place drain+swap: the reconciler's rolling-update
# progress lives on the pods themselves, surviving controller restarts
LABEL_SERVE_WEIGHTS = "serve-weights-version"
# disaggregated serving: which role pool the replica belongs to
# ("prefill" / "decode"); absent on monolithic fleets
LABEL_SERVE_ROLE = "serve-replica-role"

# the role vocabulary for spec.replicaGroups — the serving twin of the
# tfReplicaSpecs role map (Chief/Worker/PS), scoped to the two phases
# disaggregated serving splits (DistServe/Splitwise): prefill-heavy
# replicas ingest prompts and ship the resulting KV block set; decode-
# heavy replicas admit the migrated blocks and stream tokens
SERVE_ROLE_PREFILL = "prefill"
SERVE_ROLE_DECODE = "decode"
SERVE_ROLES = (SERVE_ROLE_PREFILL, SERVE_ROLE_DECODE)


@dataclass
class ServeReplicaGroup:
    """Per-role replica group (spec.replicaGroups values) — mirrors
    the shape of ReplicaSpec for the serving fleet: a scale plus the
    role-differentiating engine knobs."""

    replicas: Optional[int] = None
    # autoscaler bounds: the closed loop (serve/autoscaler.py) moves
    # `replicas` only within [minReplicas, maxReplicas]. Both default
    # to `replicas`, so a group without explicit bounds is pinned —
    # autoscaling is opt-in by widening the band
    min_replicas: Optional[int] = field(
        default=None, metadata={"json": "minReplicas"}
    )
    max_replicas: Optional[int] = field(
        default=None, metadata={"json": "maxReplicas"}
    )
    # engine slot-grid width for this role's replicas; None inherits
    # spec.slots (prefill pools usually run narrow, decode pools wide)
    slots: Optional[int] = None
    # chunked-prefill width for this role's replicas; None inherits
    # the engine default. Decode replicas can pin it small — migrated
    # prompts arrive as cached blocks and skip prefill entirely
    prefill_chunk: Optional[int] = field(
        default=None, metadata={"json": "prefillChunk"}
    )
    # speculative decoding for this role's replicas ("off" / "ngram" /
    # "draft"); decode-pool-only — validation refuses it on a prefill
    # group, whose replicas never decode
    speculate: Optional[str] = None
    # max drafted tokens per speculative round (the verify window is
    # specDepth + 1); None inherits the engine default
    spec_depth: Optional[int] = field(
        default=None, metadata={"json": "specDepth"}
    )
    extra: Dict[str, Any] = field(default_factory=dict)


@dataclass
class ServeAutoscalePolicy:
    """spec.autoscale — policy for the closed-loop autoscaler.

    The loop scales OUT a role group when the fast TTFT-SLO burn
    window fires (or queue depth per replica exceeds
    maxQueuePerReplica), and scales IN only after the slow window has
    been resolved for a full cooldown with the queue quiet. Every
    decision starts a cooldown, so the fleet changes direction at
    most once per cooldownSeconds."""

    enabled: bool = False
    # seconds both directions must wait after any decision (and the
    # slow window's resolve must age past) before the next decision
    cooldown_seconds: float = field(
        default=300.0, metadata={"json": "cooldownSeconds"}
    )
    # replicas added per scale-out / removed per scale-in decision
    scale_out_step: int = field(
        default=1, metadata={"json": "scaleOutStep"}
    )
    scale_in_step: int = field(
        default=1, metadata={"json": "scaleInStep"}
    )
    # queue-depth pressure: mean queued requests per replica above
    # which the group scales out even before the burn window fires,
    # and below a quarter of which scale-in is allowed
    max_queue_per_replica: float = field(
        default=4.0, metadata={"json": "maxQueuePerReplica"}
    )
    extra: Dict[str, Any] = field(default_factory=dict)


@dataclass
class ServeServiceSpec:
    replicas: Optional[int] = None
    # rolling-update budget: how many replicas may be draining /
    # booting at once (1..replicas)
    max_unavailable: Optional[int] = None
    # model selection for the replica servers (presets in models/)
    preset: str = "tiny"
    # engine slot-grid width per replica
    slots: Optional[int] = None
    # ('batch','model') decode mesh per replica as "BATCHxMODEL"
    # ("1x2"); "" = single-device. A sharded replica is ONE replica
    # that steps faster, not N replicas — the router folds the mesh
    # size into its compute terms, never into replica count
    mesh_shape: str = field(
        default="", metadata={"json": "meshShape"}
    )
    port: Optional[int] = None
    # opaque version tag for the loaded weights; bumping it triggers a
    # drain-based rolling update across the fleet
    weights_version: str = field(
        default="", metadata={"json": "weightsVersion"}
    )
    # role-typed replica groups (disaggregated prefill/decode) — the
    # serving analog of tfReplicaSpecs. Empty = monolithic: the fleet
    # is spec.replicas role-less engines, today's behavior. Non-empty
    # = keys from SERVE_ROLES, each scaled/rolled/reported per role;
    # spec.replicas is then ignored in favor of the groups' sum
    replica_groups: Dict[str, ServeReplicaGroup] = field(
        default_factory=dict, metadata={"json": "replicaGroups"}
    )
    # closed-loop autoscaling policy; None = no autoscaler (the
    # observatory still observes, nothing actuates). Requires
    # replicaGroups — the loop scales role pools, not monoliths
    autoscale: Optional[ServeAutoscalePolicy] = None
    template: PodTemplateSpec = field(default_factory=PodTemplateSpec)
    extra: Dict[str, Any] = field(default_factory=dict)


@dataclass
class ServeRoleStatus:
    """Per-role slice of ServeServiceStatus (status.roleStatuses)."""

    replicas: int = 0
    ready_replicas: int = 0
    updated_replicas: int = 0
    extra: Dict[str, Any] = field(default_factory=dict)


@dataclass
class ServeServiceStatus:
    replicas: int = 0
    ready_replicas: int = 0
    # replicas whose pod carries the spec's current weightsVersion
    updated_replicas: int = 0
    # replica pods replaced after terminal exits (chaos 137s)
    restarts: int = 0
    # per-role readiness when spec.replicaGroups is set (empty for
    # monolithic fleets): role -> counts, so "the decode pool is
    # short" is visible without reading pod labels
    role_statuses: Dict[str, ServeRoleStatus] = field(
        default_factory=dict, metadata={"json": "roleStatuses"}
    )
    conditions: List[JobCondition] = field(default_factory=list)
    extra: Dict[str, Any] = field(default_factory=dict)


@dataclass
class ServeService:
    api_version: str = API_VERSION
    kind: str = SERVE_KIND
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    spec: ServeServiceSpec = field(default_factory=ServeServiceSpec)
    status: ServeServiceStatus = field(default_factory=ServeServiceStatus)
    extra: Dict[str, Any] = field(default_factory=dict)

    @property
    def name(self) -> str:
        return self.metadata.name

    @property
    def namespace(self) -> str:
        return self.metadata.namespace

    def key(self) -> str:
        if self.metadata.namespace:
            return f"{self.metadata.namespace}/{self.metadata.name}"
        return self.metadata.name

    def has_condition(self, ctype: ConditionType) -> bool:
        return any(
            c.type == ctype and c.status == "True"
            for c in self.status.conditions
        )

    def to_dict(self) -> Dict[str, Any]:
        return to_jsonable(self)

    @classmethod
    def from_dict(cls, data: Dict[str, Any]) -> "ServeService":
        return from_jsonable(data, cls)

    def copy(self) -> "ServeService":
        return from_jsonable(to_jsonable(self), ServeService)


def serve_replica_name(service_name: str, index: int) -> str:
    """Replica pod name: "{service}-engine-{index}"."""
    return f"{service_name}-engine-{index}".replace("/", "-")


def serve_role_replica_name(service_name: str, role: str, index: int) -> str:
    """Role-group replica pod name: "{service}-{role}-{index}"."""
    return f"{service_name}-{role}-{index}".replace("/", "-")


def serve_labels(service_name: str) -> Dict[str, str]:
    """Base selector labels for a ServeService's replica pods."""
    return {
        LABEL_GROUP_NAME: GROUP_NAME,
        LABEL_SERVE_NAME: service_name.replace("/", "-"),
    }


def is_retryable_exit_code(exit_code: int) -> bool:
    """Exit-code classification for RestartPolicy ExitCode.

    Semantics from reference pkg/util/train/train_util.go:18-53:
    codes signalling transient infrastructure trouble (SIGINT 130,
    SIGKILL 137, SIGTERM 143) and the user-defined retry code (SIGUSR1
    138) retry; documented permanent shell errors (1, 2, 126, 127, 128,
    SIGSEGV 139) and anything unclassified do not.
    """
    return exit_code in (130, 137, 138, 143)
