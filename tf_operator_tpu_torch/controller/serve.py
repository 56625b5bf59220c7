"""ServeServiceController: reconciled fleets of decode engine replicas.

The serving sibling of TFJobController (controller.py). A ServeService
asks for N replica pods, each running the continuous-batching decode
server; this controller keeps exactly N alive (chaos kills included —
a 137 is just a terminal pod that gets replaced) and runs drain-based
rolling weight updates bounded by spec.maxUnavailable when
spec.weightsVersion changes.

Same machinery as the training controller, deliberately: informer
subscriptions feed ControllerExpectations and a rate-limited
workqueue; admission defaults+validates under the resource's
correlation ID; sync is level-triggered with a status-diff persist.
The rolling update is the one genuinely new move: progress is stored
on the pods themselves as a weights-version label, so a restarted
controller resumes mid-rollout from the substrate's truth rather than
its own memory.

The in-place update path (weight_update hook) is how the in-process
fleet harness swaps params through the engine lifecycle lock
(serve/fleet.py): drain the replica, swap, readmit, patch the label.
Without a hook, the controller falls back to delete+recreate — the
pod-template answer a real cluster would use.

The port's copy of tf_operator_tpu/controller/serve.py; it imports nothing of that package.
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Callable, List, Optional

from ..api import k8s, set_serve_defaults, validate_serve_service
from ..api.serde import deep_copy, to_jsonable
from ..api.types import (
    LABEL_SERVE_NAME,
    LABEL_SERVE_REPLICA_INDEX,
    LABEL_SERVE_ROLE,
    LABEL_SERVE_WEIGHTS,
    SERVE_CONTAINER_NAME,
    SERVE_KIND,
    SERVE_ROLES,
    ConditionType,
    ServeRoleStatus,
    ServeService,
    serve_labels,
    serve_replica_name,
    serve_role_replica_name,
)
from ..api.validation import ValidationError
from ..runtime import (
    ADDED,
    Conflict,
    DELETED,
    MODIFIED,
    ControllerExpectations,
    EventRecorder,
    NotFound,
    RateLimitingQueue,
    RealPodControl,
)
from ..runtime.control import owner_reference
from ..telemetry.flight import correlate, flight_record
from ..telemetry.tracecontext import format_traceparent, trace_scope
from .clock import Clock
from .status import clear_condition, set_condition

logger = logging.getLogger("tf_operator_tpu_torch.controller.serve")

REASON_SERVE_CREATED = "ServeServiceCreated"
REASON_SERVE_RUNNING = "ServeServiceRunning"
REASON_SERVE_FAILED_VALIDATION = "ServeServiceFailedValidation"
REASON_SERVE_RESTARTING = "ServeServiceRestarting"

def expectation_pods_key(job_key: str, rt: str) -> str:
    """Per job+type expectation keys (reference GenExpectationPodsKey,
    jobcontroller/util.go:33-44): the one function of the reference's
    controller/reconciler.py that this controller needs."""
    return f"{job_key}/{rt}/pods"


# the per-service expectation bucket ("serve" plays the replica-type
# role the training reconciler keys by)
SERVE_REPLICA_TYPE = "serve"


def _controller_owner(meta: k8s.ObjectMeta) -> Optional[k8s.OwnerReference]:
    for ref in meta.owner_references:
        if ref.controller:
            return ref
    return None


def _desired_replicas(svc: ServeService):
    """The pods this spec asks for, as (name, index, role, group).

    Empty replicaGroups keeps the classic flat fan-out (role "" and a
    None group); role-typed groups fan out per role in SERVE_ROLES
    order so prefill/decode pools get stable, disjoint name ranges."""
    groups = svc.spec.replica_groups
    if not groups:
        want = int(svc.spec.replicas or 0)
        return [
            (serve_replica_name(svc.name, i), i, "", None)
            for i in range(want)
        ]
    desired = []
    ordered = [r for r in SERVE_ROLES if r in groups]
    ordered += [r for r in sorted(groups) if r not in SERVE_ROLES]
    for role in ordered:
        group = groups[role]
        if group is None:
            continue  # validation reports nil groups
        for i in range(int(group.replicas or 0)):
            desired.append(
                (serve_role_replica_name(svc.name, role, i), i, role, group)
            )
    return desired


class ServeReconciler:
    """Drives one ServeService's pods to spec. Table-testable with
    FakePodControl, like the training Reconciler."""

    def __init__(
        self,
        pod_control,
        recorder,
        expectations,
        clock: Clock,
        weight_update: Optional[
            Callable[[ServeService, List[k8s.Pod]], List[str]]
        ] = None,
    ) -> None:
        self.pod_control = pod_control
        self.recorder = recorder
        self.expectations = expectations
        self.clock = clock
        # weight_update(svc, stale_running_pods) drains each pod's
        # engine in place (serve/fleet.py) and returns the names it
        # updated; the reconciler patches those pods' weights label.
        # None -> delete+recreate (pod-template semantics).
        self.weight_update = weight_update

    # -- claiming ----------------------------------------------------------

    def claim_pods(
        self, svc: ServeService, pods: List[k8s.Pod]
    ) -> List[k8s.Pod]:
        """Keep our children; adopt label-matched orphans. (The full
        training claim manager also handles release-on-mismatch and
        cross-controller disputes; serve pods are label-selected per
        service so ownership disputes reduce to the orphan case.)"""
        claimed: List[k8s.Pod] = []
        for pod in pods:
            owner = _controller_owner(pod.metadata)
            if owner is not None:
                if owner.uid == svc.metadata.uid:
                    claimed.append(pod)
                continue  # someone else's child: never co-claim
            if pod.metadata.deletion_timestamp is not None:
                continue  # never adopt a terminating orphan
            refs = [deep_copy(r) for r in pod.metadata.owner_references]
            refs.append(owner_reference(svc))
            try:
                self.pod_control.patch_pod_owner_references(
                    pod.metadata.namespace, pod.metadata.name, refs,
                    pod.metadata.uid,
                )
            except Exception as err:  # noqa: BLE001 — adoption is
                # best-effort; the orphan stays unclaimed this sync
                logger.warning(
                    "serveservice %s: failed to adopt %s: %s",
                    svc.name, pod.metadata.name, err,
                )
                continue
            pod.metadata.owner_references = refs
            claimed.append(pod)
        return claimed

    # -- reconcile ---------------------------------------------------------

    def reconcile(self, svc: ServeService, pods: List[k8s.Pod]) -> None:
        pods = self.claim_pods(svc, pods)
        desired = _desired_replicas(svc)
        want = len(desired)
        key = svc.key()
        namespace = svc.namespace

        # 1. Reap terminal pods (chaos 137s, OOMs, clean exits): delete
        # the record so step 3 recreates the index. Restart accounting
        # is cumulative in status (it survives because status persists).
        live: List[k8s.Pod] = []
        for pod in pods:
            if pod.status.phase in (k8s.POD_FAILED, k8s.POD_SUCCEEDED):
                exit_code = k8s.pod_main_exit_code(pod, SERVE_CONTAINER_NAME)
                svc.status.restarts += 1
                self._event(
                    svc, "Normal", REASON_SERVE_RESTARTING,
                    f"Replacing terminal pod {pod.metadata.name} "
                    f"(exit code {exit_code})",
                )
                flight_record(
                    "reconcile", op="serve-reap", key=key,
                    pod=pod.metadata.name, exit_code=exit_code,
                )
                self._delete_pod(svc, pod)
            else:
                live.append(pod)

        by_name = {p.metadata.name: p for p in live}
        desired_names = {name for name, _, _, _ in desired}

        # 2. Scale down: anything live outside the desired name set
        # (covers index-range shrink AND a role group being removed)
        for pod in live:
            if pod.metadata.name not in desired_names:
                self._delete_pod(svc, pod)
        live = [p for p in live if p.metadata.name in desired_names]

        # 3. Create missing indexed replicas (a reaped pod's index is
        # missing here on the SAME sync, so replacement is immediate)
        for name, index, role, group in desired:
            if name not in by_name:
                self._create_pod(svc, index, role=role, group=group)

        # 4. Rolling weight update over RUNNING pods that carry a stale
        # weights label, bounded by maxUnavailable minus the capacity
        # already lost to dead/booting replicas.
        self._rolling_update(svc, live, want)

        # 5. Status + conditions from observed truth
        running = [p for p in live if p.status.phase == k8s.POD_RUNNING]
        svc.status.replicas = len(live)
        svc.status.ready_replicas = len(running)
        svc.status.updated_replicas = len([
            p for p in running
            if p.metadata.labels.get(LABEL_SERVE_WEIGHTS)
            == svc.spec.weights_version
        ])
        svc.status.role_statuses = self._role_statuses(svc, live, running)
        now = self.clock.now_iso()
        if running and len(running) == want:
            set_condition(
                svc, ConditionType.RUNNING, REASON_SERVE_RUNNING,
                f"All {want} serve replicas are running.", now,
            )
        elif svc.has_condition(ConditionType.RUNNING) and len(running) < want:
            clear_condition(
                svc, ConditionType.RUNNING, REASON_SERVE_RESTARTING,
                f"{len(running)}/{want} serve replicas running.", now,
            )

    def _role_statuses(
        self,
        svc: ServeService,
        live: List[k8s.Pod],
        running: List[k8s.Pod],
    ):
        """Per-role observed counts for role-typed replica groups
        (empty when the spec is monolithic)."""
        if not svc.spec.replica_groups:
            return {}
        version = svc.spec.weights_version
        statuses = {}
        for role, group in svc.spec.replica_groups.items():
            if group is None:
                continue
            role_live = [
                p for p in live
                if p.metadata.labels.get(LABEL_SERVE_ROLE) == role
            ]
            role_running = [
                p for p in role_live if p.status.phase == k8s.POD_RUNNING
            ]
            statuses[role] = ServeRoleStatus(
                replicas=len(role_live),
                ready_replicas=len(role_running),
                updated_replicas=len([
                    p for p in role_running
                    if p.metadata.labels.get(LABEL_SERVE_WEIGHTS) == version
                ]),
            )
        return statuses

    def _rolling_update(
        self, svc: ServeService, live: List[k8s.Pod], want: int
    ) -> None:
        version = svc.spec.weights_version
        max_unavailable = int(svc.spec.max_unavailable or 1)
        running = [p for p in live if p.status.phase == k8s.POD_RUNNING]
        stale = sorted(
            (
                p for p in running
                if p.metadata.labels.get(LABEL_SERVE_WEIGHTS) != version
            ),
            key=lambda p: p.metadata.name,
        )
        if not stale:
            return
        # capacity already unavailable (dead, booting, pending) counts
        # against the budget: a chaos kill mid-rollout must pause the
        # rollout rather than stack a drain on top of a dead replica
        unavailable = max(0, want - len(running))
        budget = max(0, max_unavailable - unavailable)
        batch = stale[:budget]
        if not batch:
            flight_record(
                "reconcile", op="serve-rollout", key=svc.key(),
                decision="paused", stale=len(stale),
                unavailable=unavailable,
            )
            return
        flight_record(
            "reconcile", op="serve-rollout", key=svc.key(),
            decision="updating", batch=[p.metadata.name for p in batch],
            version=version, stale=len(stale),
        )
        if self.weight_update is None:
            # pod-template semantics: replace the pod, recreation picks
            # up the new version label (and, on a real cluster, the new
            # weights reference in the template)
            for pod in batch:
                self._delete_pod(svc, pod)
            return
        updated = self.weight_update(svc, batch)
        for name in updated:
            self.pod_control.patch_pod_labels(
                svc.namespace, name, {LABEL_SERVE_WEIGHTS: version}
            )
            self._event(
                svc, "Normal", "UpdatedWeights",
                f"Replica {name} now serving weights {version!r}",
            )

    # -- pod CRUD with expectation accounting ------------------------------

    def _create_pod(
        self, svc: ServeService, index: int, role: str = "", group=None
    ) -> None:
        labels = serve_labels(svc.name)
        labels[LABEL_SERVE_REPLICA_INDEX] = str(index)
        labels[LABEL_SERVE_WEIGHTS] = svc.spec.weights_version
        if role:
            labels[LABEL_SERVE_ROLE] = role
        template = deep_copy(svc.spec.template)
        if role:
            template.metadata.name = serve_role_replica_name(
                svc.name, role, index
            )
            container = template.spec.container(SERVE_CONTAINER_NAME)
            if container is not None and container.command:
                # per-role engine tuning rides the command line; argparse
                # last-wins lets the role flags override template-wide
                # defaults like --slots
                container.command = list(container.command)
                container.command += ["--role", role]
                if group is not None and group.slots is not None:
                    container.command += ["--slots", str(group.slots)]
                if group is not None and group.prefill_chunk is not None:
                    container.command += [
                        "--prefill-chunk", str(group.prefill_chunk)
                    ]
                if group is not None and group.speculate is not None:
                    # validation already refused speculate on prefill
                    # groups — decode-pool-only under disaggregation
                    container.command += [
                        "--speculate", group.speculate
                    ]
                if group is not None and group.spec_depth is not None:
                    container.command += [
                        "--spec-depth", str(group.spec_depth)
                    ]
        else:
            template.metadata.name = serve_replica_name(svc.name, index)
        template.metadata.labels.update(labels)
        pod = k8s.Pod(metadata=template.metadata, spec=template.spec)
        pod.metadata.namespace = svc.namespace

        key = expectation_pods_key(svc.key(), SERVE_REPLICA_TYPE)
        self.expectations.raise_expectations(key, 1, 0)
        try:
            self.pod_control.create_pod(svc.namespace, pod, svc)
        except Exception:
            self.expectations.creation_observed(key)
            raise

    def _delete_pod(self, svc: ServeService, pod: k8s.Pod) -> None:
        key = expectation_pods_key(svc.key(), SERVE_REPLICA_TYPE)
        self.expectations.raise_expectations(key, 0, 1)
        try:
            self.pod_control.delete_pod(
                svc.namespace, pod.metadata.name, svc
            )
        except NotFound:
            self.expectations.deletion_observed(key)
        except Exception:
            self.expectations.deletion_observed(key)
            raise

    def _event(
        self, svc: ServeService, etype: str, reason: str, message: str
    ) -> None:
        self.recorder.event(
            SERVE_KIND, svc.name, svc.namespace, etype, reason, message
        )


class ServeServiceController:
    """Watch wiring + workqueue + admission + sync for ServeServices.

    A compact mirror of TFJobController: same informer handlers, same
    expectations gate, same status-diff persist with one Conflict
    retry. Run it next to the training controller on the same
    substrate — the watch kinds don't overlap and pod events route by
    their labels."""

    def __init__(
        self,
        substrate,
        clock: Optional[Clock] = None,
        namespace: Optional[str] = None,
        metrics=None,
        weight_update: Optional[
            Callable[[ServeService, List[k8s.Pod]], List[str]]
        ] = None,
        leadership=None,
    ) -> None:
        self.substrate = substrate
        # HA gate, same contract as TFJobController: None means
        # single-replica (always leading); otherwise followers drop
        # events and park workers until promoted (docs/ha.md)
        self._leadership = leadership
        self.clock = clock or Clock()
        self.namespace = namespace
        self.metrics = metrics
        self.recorder = EventRecorder(substrate)
        # the pure-Python structures: the reference's native_queue
        # factories return these when native/ is absent or disabled
        self.expectations = ControllerExpectations()
        wq_metrics = None
        if metrics is not None:
            wq_factory = getattr(metrics, "workqueue", None)
            if wq_factory is not None:
                wq_metrics = wq_factory("serveservice")
        self.queue = RateLimitingQueue(metrics=wq_metrics)
        self.reconciler = ServeReconciler(
            pod_control=RealPodControl(substrate, self.recorder),
            recorder=self.recorder,
            expectations=self.expectations,
            clock=self.clock,
            weight_update=weight_update,
        )
        self._stop = threading.Event()
        self._workers: List[threading.Thread] = []
        substrate.subscribe("serveservice", self._on_serve_service)
        substrate.subscribe("pod", self._on_pod)

    def _telemetry(self, method: str, *args) -> None:
        """Best-effort duck-typed metrics call (TFJobController's twin)."""
        fn = getattr(self.metrics, method, None) if self.metrics is not None else None
        if fn is not None:
            fn(*args)

    # -- event handlers ----------------------------------------------------

    def _is_leading(self) -> bool:
        if self._leadership is None:
            return True
        flag = getattr(self._leadership, "is_leader", True)
        return bool(flag() if callable(flag) else flag)

    def _in_scope(self, namespace: str) -> bool:
        return self.namespace is None or namespace == self.namespace

    def _guard_handler(self, handler, verb, obj, key: Optional[str]) -> None:
        """HandleCrash analog (see TFJobController._guard_handler): an
        informer-callback exception must never poison the substrate's
        watch dispatcher; isolate and requeue."""
        if not self._is_leading():
            return  # follower: the takeover rebuild relists this gap
        try:
            handler(verb, obj)
        except Exception:
            logger.exception(
                "%s handler crashed on %s (isolated)",
                getattr(handler, "__name__", "event"), verb,
            )
            if self.metrics is not None:
                self.metrics.reconcile_panic()
            if key:
                self.enqueue(key)

    def _on_serve_service(self, verb: str, svc: ServeService) -> None:
        self._guard_handler(self._handle_serve_service, verb, svc, svc.key())

    def _on_pod(self, verb: str, pod: k8s.Pod) -> None:
        svc_name = pod.metadata.labels.get(LABEL_SERVE_NAME)
        key = f"{pod.metadata.namespace}/{svc_name}" if svc_name else None
        if key is None:
            return  # not a serve pod (training pods route to TFJobController)
        self._guard_handler(self._handle_pod, verb, pod, key)

    def _handle_serve_service(self, verb: str, svc: ServeService) -> None:
        if not self._in_scope(svc.namespace):
            return
        if verb == ADDED:
            self._admit(svc)
        elif verb == MODIFIED:
            self.enqueue(svc.key())
        elif verb == DELETED:
            self.expectations.delete_expectations(svc.key())

    def _handle_pod(self, verb: str, pod: k8s.Pod) -> None:
        if not self._in_scope(pod.metadata.namespace):
            return
        owner = _controller_owner(pod.metadata)
        if owner is not None and owner.kind != SERVE_KIND:
            return
        svc_name = pod.metadata.labels.get(LABEL_SERVE_NAME)
        key = f"{pod.metadata.namespace}/{svc_name}"
        ekey = expectation_pods_key(key, SERVE_REPLICA_TYPE)
        if verb == ADDED:
            self.expectations.creation_observed(ekey)
        elif verb == DELETED:
            self.expectations.deletion_observed(ekey)
        self.enqueue(key)

    # -- admission ---------------------------------------------------------

    def _admit(self, svc: ServeService) -> None:
        with correlate(svc.metadata.uid or svc.key()):
            self._admit_correlated(svc)

    def _admit_correlated(self, svc: ServeService) -> None:
        svc = svc.copy()
        set_serve_defaults(svc)
        try:
            validate_serve_service(svc)
        except ValidationError as err:
            logger.warning(
                "serveservice %s failed validation: %s", svc.key(), err
            )
            flight_record(
                "reconcile", op="serve-admit", key=svc.key(),
                decision="failed-validation", error=str(err),
            )
            self.recorder.event(
                SERVE_KIND, svc.name, svc.namespace, "Warning",
                REASON_SERVE_FAILED_VALIDATION, str(err),
            )
            set_condition(
                svc, ConditionType.FAILED, REASON_SERVE_FAILED_VALIDATION,
                str(err), self.clock.now_iso(),
            )
            self._update_status(svc)
            return
        flight_record(
            "reconcile", op="serve-admit", key=svc.key(),
            decision="admitted", replicas=svc.spec.replicas,
        )
        set_condition(
            svc, ConditionType.CREATED, REASON_SERVE_CREATED,
            f"ServeService {svc.name} is created.", self.clock.now_iso(),
        )
        self._update_status(svc)
        self.enqueue(svc.key())

    # -- sync --------------------------------------------------------------

    def enqueue(self, key: str) -> None:
        flight_record("workqueue", op="add", key=key)
        self.queue.add(key)

    def sync(self, key: str) -> None:
        """Phase-attributed like TFJobController.sync: each pass splits
        into get/admission/expectations/list/reconcile/status-write,
        observed into reconcile_phase_seconds{phase=} and emitted as one
        kind="phase" flight record."""
        phases: dict = {}
        mark = time.perf_counter()
        try:
            namespace, name = key.split("/", 1)
        except ValueError:
            logger.error("invalid key %r", key)
            return
        try:
            svc = self.substrate.get_serve_service(namespace, name)
        except NotFound:
            self.expectations.delete_expectations(key)
            flight_record("reconcile", op="serve-sync", key=key, decision="gone")
            phases["get"] = time.perf_counter() - mark
            self._record_phases(key, phases)
            return
        phases["get"] = time.perf_counter() - mark
        # each reconcile episode is its own trace, stamped in the same
        # traceparent header shape the serve planes propagate — so a
        # flightz trace filter (or the fleet collector) isolates one
        # episode's records exactly like one request's
        with correlate(svc.metadata.uid or key), trace_scope() as tctx:
            flight_record(
                "reconcile", op="serve-sync", key=key,
                decision="episode",
                traceparent=format_traceparent(tctx),
            )
            try:
                self._sync_service(key, svc, phases)
            finally:
                self._record_phases(key, phases)

    def _record_phases(self, key: str, phases: dict) -> None:
        if not phases:
            return
        for phase, seconds in phases.items():
            self._telemetry("observe_phase", phase, seconds)
        flight_record(
            "phase", key=key,
            **{phase: round(seconds, 6) for phase, seconds in phases.items()},
        )

    def _sync_service(
        self, key: str, svc: ServeService, phases: Optional[dict] = None
    ) -> None:
        if phases is None:
            phases = {}
        mark = time.perf_counter()

        def lap(phase: str) -> None:
            nonlocal mark
            now = time.perf_counter()
            phases[phase] = phases.get(phase, 0.0) + (now - mark)
            mark = now

        set_serve_defaults(svc)
        if svc.metadata.deletion_timestamp is not None:
            flight_record(
                "reconcile", op="serve-sync", key=key,
                decision="pending-deletion",
            )
            lap("admission")
            return
        if not svc.status.conditions:
            self._admit(svc)
            lap("admission")
            return
        if svc.has_condition(ConditionType.FAILED):
            # failed validation is terminal for the spec that failed;
            # an update (MODIFIED) lands here again and re-admits below
            # only once conditions are wiped by the user
            flight_record(
                "reconcile", op="serve-sync", key=key, decision="failed",
            )
            lap("admission")
            return
        lap("admission")
        ekey = expectation_pods_key(key, SERVE_REPLICA_TYPE)
        if not self.expectations.satisfied(ekey):
            flight_record(
                "reconcile", op="serve-sync", key=key,
                decision="expectations-pending",
            )
            lap("expectations")
            return
        lap("expectations")
        old_status = to_jsonable(svc.status)
        pods = self.substrate.list_pods(
            svc.namespace, serve_labels(svc.name)
        )
        lap("list")
        self.reconciler.reconcile(svc, pods)
        lap("reconcile")
        status_changed = to_jsonable(svc.status) != old_status
        flight_record(
            "reconcile", op="serve-sync", key=key, decision="reconciled",
            pods=len(pods), status_changed=status_changed,
        )
        if status_changed:
            self._update_status(svc)
        lap("status-write")

    def _update_status(self, svc: ServeService) -> None:
        try:
            self.substrate.update_serve_service_status(svc)
        except NotFound:
            pass  # deleted mid-sync
        except Conflict:
            try:
                fresh = self.substrate.get_serve_service(
                    svc.namespace, svc.name
                )
            except NotFound:
                return
            if fresh.metadata.uid != svc.metadata.uid:
                return  # name reused by a NEW service
            fresh.status = svc.status
            self.substrate.update_serve_service_status(fresh)

    # -- run loops ---------------------------------------------------------

    def resync(self) -> None:
        if not self._is_leading():
            return
        for svc in self.substrate.list_serve_services(self.namespace):
            if not svc.status.conditions:
                self._admit(svc)
            else:
                self.enqueue(svc.key())

    def process_next(self, timeout: Optional[float] = None) -> bool:
        if not self._is_leading():
            # park, don't drain (TFJobController.process_next's twin)
            self._stop.wait(min(timeout if timeout is not None else 0.2, 0.2))
            return False
        key = self.queue.get(timeout=timeout)
        if key is None:
            return False
        started = time.monotonic()
        try:
            self.sync(key)
        except Exception:
            logger.exception("error syncing %r; requeueing", key)
            self._telemetry("observe_reconcile", time.monotonic() - started, "error")
            if self.metrics is not None:
                self.metrics.reconcile_panic()
            self.queue.add_rate_limited(key)
        else:
            self._telemetry("observe_reconcile", time.monotonic() - started, "success")
            self.queue.forget(key)
        finally:
            self.queue.done(key)
        return True

    def run_until_quiet(self, max_steps: int = 100) -> int:
        steps = 0
        while steps < max_steps and self.process_next(timeout=0.05):
            steps += 1
        return steps

    def run(self, threadiness: int = 1, resync_period: float = 30.0) -> None:
        self.resync()
        for i in range(threadiness):
            worker = threading.Thread(
                target=self._worker_loop,
                name=f"serveservice-worker-{i}", daemon=True,
            )
            worker.start()
            self._workers.append(worker)
        if resync_period > 0:
            resyncer = threading.Thread(
                target=self._resync_loop, args=(resync_period,),
                name="serveservice-resync", daemon=True,
            )
            resyncer.start()
            self._workers.append(resyncer)

    def _resync_loop(self, period: float) -> None:
        while not self._stop.wait(period):
            try:
                self.resync()
            except Exception:
                logger.exception("serve resync failed")

    def _worker_loop(self) -> None:
        while not self._stop.is_set():
            self.process_next(timeout=0.2)

    def stop(self) -> None:
        self._stop.set()
        self.queue.shut_down()
        for worker in self._workers:
            worker.join(timeout=2)
        for kind, handler in (
            ("serveservice", self._on_serve_service),
            ("pod", self._on_pod),
        ):
            try:
                self.substrate.unsubscribe(kind, handler)
            except Exception:  # pragma: no cover — already detached
                pass

    # -- leadership takeover -----------------------------------------------

    def rebuild_from_relist(self) -> None:
        """Takeover rebuild, TFJobController.rebuild_from_relist's twin:
        clear expectations over the relist-derived key universe
        (services plus labeled serve pods, so orphans count) and
        re-prime the queue via resync()."""
        namespace = self.namespace
        services = self.substrate.list_serve_services(namespace)
        pods = self.substrate.list_pods(namespace)
        keys = {
            expectation_pods_key(svc.key(), SERVE_REPLICA_TYPE)
            for svc in services
        }
        for pod in pods:
            owner_name = pod.metadata.labels.get(LABEL_SERVE_NAME)
            if owner_name:
                owner_key = f"{pod.metadata.namespace}/{owner_name}"
                keys.add(expectation_pods_key(owner_key, SERVE_REPLICA_TYPE))
        self.expectations.rebuild_from_observed(keys)
        epoch = getattr(self._leadership, "epoch", 0) if self._leadership else 0
        flight_record(
            "leader", event="rebuild", controller="serveservice",
            epoch=epoch, services=len(services), keys=len(keys),
        )
        self.resync()
