"""TFJob status machine.

Semantics from reference pkg/controller.v1/tensorflow/status.go:
- replica counters from pod phases (:204-214)
- chief-based vs worker0-based success, SuccessPolicyAllWorkers (:87-142)
- Restarting vs Failed on failures depending on whether a retryable
  restart happened this round (:144-172)
- condition CRUD with Running<->Restarting mutual exclusion and
  Running=False stamping on terminal conditions (:236-306)
- terminal states are sticky: no condition changes after
  Succeeded/Failed (:241-244)

The port's copy of tf_operator_tpu/controller/status.py; it imports nothing of that package.
"""

from __future__ import annotations

from typing import Callable, Optional

from ..api import k8s
from ..api.types import (
    CHIEF_LIKE,
    ConditionType,
    JobCondition,
    ReplicaStatus,
    ReplicaType,
    SuccessPolicy,
    TFJob,
)

# Condition reasons (reference status.go:33-43)
REASON_CREATED = "TFJobCreated"
REASON_RUNNING = "TFJobRunning"
REASON_SUCCEEDED = "TFJobSucceeded"
REASON_FAILED = "TFJobFailed"
REASON_RESTARTING = "TFJobRestarting"


def has_condition(job: TFJob, ctype: ConditionType) -> bool:
    return job.has_condition(ctype)


def is_succeeded(job: TFJob) -> bool:
    return job.has_condition(ConditionType.SUCCEEDED)


def is_failed(job: TFJob) -> bool:
    return job.has_condition(ConditionType.FAILED)


def _filter_out(conditions, ctype: ConditionType):
    """Drop the condition being replaced, enforce Running<->Restarting
    exclusion, and mark Running False once terminal
    (reference filterOutCondition, status.go:284-306)."""
    out = []
    for cond in conditions:
        if ctype == ConditionType.RESTARTING and cond.type == ConditionType.RUNNING:
            continue
        if ctype == ConditionType.RUNNING and cond.type == ConditionType.RESTARTING:
            continue
        if cond.type == ctype:
            continue
        if (
            ctype in (ConditionType.FAILED, ConditionType.SUCCEEDED)
            and cond.type == ConditionType.RUNNING
        ):
            cond.status = "False"
        out.append(cond)
    return out


def set_condition(
    job: TFJob, ctype: ConditionType, reason: str, message: str, now: str
) -> None:
    """Append/refresh a condition (reference setCondition, status.go:236-281)."""
    if is_failed(job) or is_succeeded(job):
        return  # terminal states are sticky
    condition = JobCondition(
        type=ctype,
        status="True",
        reason=reason,
        message=message,
        last_update_time=now,
        last_transition_time=now,
    )
    for current in job.status.conditions:
        if current.type != ctype:
            continue
        if (
            current.status == condition.status
            and current.reason == condition.reason
            and current.message == condition.message
        ):
            return  # unchanged
        if current.status == condition.status:
            condition.last_transition_time = current.last_transition_time
        break
    job.status.conditions = _filter_out(job.status.conditions, ctype) + [condition]


def clear_condition(
    job: TFJob, ctype: ConditionType, reason: str, message: str, now: str
) -> bool:
    """Flip an existing True condition to False (k8s convention for "no
    longer the case" — deleting it would erase the history that the
    episode happened). No-op unless a True condition of that type
    exists; returns whether anything changed."""
    if not any(
        c.type == ctype and c.status == "True" for c in job.status.conditions
    ):
        return False
    job.status.conditions = _filter_out(job.status.conditions, ctype) + [
        JobCondition(
            type=ctype,
            status="False",
            reason=reason,
            message=message,
            last_update_time=now,
            last_transition_time=now,
        )
    ]
    return True


def initialize_replica_statuses(job: TFJob, rtype: ReplicaType) -> None:
    """Reset phase counters for one replica type before re-counting
    (reference initializeTFReplicaStatuses, status.go:194-202). The
    restart counter is cumulative and carries over."""
    old = job.status.replica_statuses.get(rtype.value)
    job.status.replica_statuses[rtype.value] = ReplicaStatus(
        restarts=old.restarts if old is not None else 0
    )


def update_replica_status(job: TFJob, rtype: ReplicaType, pod: k8s.Pod) -> None:
    """Fold one observed pod into the counters
    (reference updateTFJobReplicaStatuses, status.go:204-214)."""
    status = job.status.replica_statuses.setdefault(rtype.value, ReplicaStatus())
    if pod.status.phase == k8s.POD_RUNNING:
        status.active += 1
    elif pod.status.phase == k8s.POD_SUCCEEDED:
        status.succeeded += 1
    elif pod.status.phase == k8s.POD_FAILED:
        status.failed += 1


def contains_chief_or_master(job: TFJob) -> bool:
    return any(rt in job.replica_types() for rt in CHIEF_LIKE)


class StatusUpdater:
    """Per-replica-type status transition (reference updateStatusSingle,
    status.go:61-173), with clock and side-effect hooks injected so the
    state machine stays deterministic under test."""

    def __init__(
        self,
        now: Callable[[], str],
        record_event: Callable[[TFJob, str, str, str], None],
        on_start: Optional[Callable[[TFJob], None]] = None,
        metrics=None,
    ) -> None:
        self._now = now
        self._event = record_event
        self._on_start = on_start
        self._metrics = metrics

    def update_status_single(
        self,
        job: TFJob,
        rtype: ReplicaType,
        replicas: int,
        restart: bool,
        worker0_completed: bool,
    ) -> None:
        counters = job.status.replica_statuses.setdefault(
            rtype.value, ReplicaStatus()
        )
        expected = replicas - counters.succeeded
        running = counters.active
        failed = counters.failed
        now = self._now()

        if job.status.start_time is None:
            job.status.start_time = now
            if self._on_start is not None:
                # schedule the ActiveDeadlineSeconds re-sync
                # (reference status.go:80-85)
                self._on_start(job)

        if contains_chief_or_master(job):
            if rtype in CHIEF_LIKE:
                if running > 0:
                    set_condition(
                        job, ConditionType.RUNNING, REASON_RUNNING,
                        f"TFJob {job.name} is running.", now,
                    )
                if expected == 0:
                    self._mark_succeeded(job, now)
        elif rtype == ReplicaType.WORKER:
            # Succeed if (1) all workers succeeded, or (2) worker 0
            # completed under the default success policy
            # (reference status.go:115-131).
            all_done = expected == 0
            worker0_done = (
                worker0_completed
                and job.spec.success_policy != SuccessPolicy.ALL_WORKERS
            )
            if all_done or worker0_done:
                self._mark_succeeded(job, now)
            elif running > 0:
                set_condition(
                    job, ConditionType.RUNNING, REASON_RUNNING,
                    f"TFJob {job.name} is running.", now,
                )
        elif rtype == ReplicaType.TPU:
            # A TPU replica set is one logical accelerator: success is
            # all-hosts-succeeded, never a single host (multi-host slice
            # semantics, SURVEY.md §7 hard part #1).
            if expected == 0:
                self._mark_succeeded(job, now)
            elif running > 0:
                set_condition(
                    job, ConditionType.RUNNING, REASON_RUNNING,
                    f"TFJob {job.name} is running.", now,
                )

        if failed > 0:
            if restart:
                set_condition(
                    job, ConditionType.RESTARTING, REASON_RESTARTING,
                    f"TFJob {job.name} is restarting because {failed} "
                    f"{rtype.value} replica(s) failed.", now,
                )
                self._event(
                    job, "Warning", REASON_RESTARTING,
                    f"TFJob {job.name} is restarting because {failed} "
                    f"{rtype.value} replica(s) failed.",
                )
                if self._metrics is not None:
                    self._metrics.restarted()
                    self._metrics.failed()
            else:
                if job.status.completion_time is None:
                    job.status.completion_time = now
                set_condition(
                    job, ConditionType.FAILED, REASON_FAILED,
                    f"TFJob {job.name} has failed because {failed} "
                    f"{rtype.value} replica(s) failed.", now,
                )
                self._event(
                    job, "Normal", REASON_FAILED,
                    f"TFJob {job.name} has failed because {failed} "
                    f"{rtype.value} replica(s) failed.",
                )
                if self._metrics is not None:
                    self._metrics.failed()

    def _mark_succeeded(self, job: TFJob, now: str) -> None:
        if is_succeeded(job):
            return
        if job.status.completion_time is None:
            job.status.completion_time = now
        set_condition(
            job, ConditionType.SUCCEEDED, REASON_SUCCEEDED,
            f"TFJob {job.name} successfully completed.", now,
        )
        self._event(
            job, "Normal", REASON_SUCCEEDED,
            f"TFJob {job.name} successfully completed.",
        )
        if self._metrics is not None:
            self._metrics.succeeded()
