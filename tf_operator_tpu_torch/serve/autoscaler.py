"""Closed-loop SLO autoscaler: the observatory's alert stream actuates.

PR 15 taught the fleet to *judge* itself — multi-window burn-rate
alerts over fleet-summed histograms. This module closes the loop: a
`ServeAutoscaler` watches the fleet AlertManager's TTFT-SLO instances
plus the queue-depth gauge and moves `spec.replicaGroups[*].replicas`
on the substrate, within each group's [minReplicas, maxReplicas] band.
The ServeReconciler then applies the change as an ordinary reconcile —
pod creation on scale-out, drain-based removal on scale-in — so the
actuator never touches a pod directly.

Direction policy, deliberately asymmetric (the SRE shape):

- scale OUT when the *fast* burn window fires (a spike is burning
  budget now) or queued requests per replica exceed the policy's
  maxQueuePerReplica — capacity problems are urgent;
- scale IN only when the *slow* window has been resolved for a full
  cooldown AND the fast window is quiet AND the queue is near-empty —
  giving back capacity is never urgent, and the slow window's
  hysteresis (resolve at fire_burn x 0.8) plus the no-data-holds-state
  rule mean chaos restarts and rolling updates cannot fake "healthy".

Every decision starts a cooldown, so a group changes direction at most
once per cooldownSeconds — the no-thrash invariant run_autoscale_smoke
asserts. Each decision is a `kind="scale"` flight record carrying the
triggering alert instance and that alert's sampled trace ids, so "why
did we scale at 14:02" is answerable from the flight ring alone.

The port's copy of tf_operator_tpu/serve/autoscaler.py; it imports nothing of that package.
"""

from __future__ import annotations

import logging
from typing import Dict, List, Optional, Tuple

from ..telemetry.flight import FlightRecorder, default_flight
from ..utils import locks

__all__ = ["ServeAutoscaler"]

logger = logging.getLogger("tf_operator_tpu_torch.serve.autoscaler")

# the fleet-summed gauge fleet_slo() ingests each scrape; queued
# requests across every replica
_QUEUE_SERIES = "fleet_queue_depth"
# scale-in additionally requires the queue to sit below this fraction
# of the scale-out pressure threshold — between the two lies a dead
# band where the autoscaler holds still
_SCALE_IN_QUEUE_FRACTION = 0.25


class ServeAutoscaler:
    """Drives one ServeService's replicaGroups from fleet alert state.

    Reads policy fresh from the substrate every tick (the spec is the
    source of truth; operators edit it live), decides per role group,
    and writes the new scale back with optimistic concurrency — a
    Conflict (the reconciler updated the object mid-tick) just skips
    the tick; the next one re-reads.
    """

    def __init__(
        self,
        substrate,
        namespace: str,
        name: str,
        alerts,
        history,
        registry=None,
        flight: Optional[FlightRecorder] = None,
        clock=None,
        rule_name: str = "fleet-ttft-slo",
    ) -> None:
        self.substrate = substrate
        self.namespace = namespace
        self.name = name
        self.alerts = alerts
        self.history = history
        self.flight = flight if flight is not None else default_flight()
        self.clock = clock if clock is not None else history.clock
        self.rule_name = rule_name
        self.fast_key, self.slow_key = self._burn_keys(alerts, rule_name)
        self._lock = locks.make_lock("ServeAutoscaler._lock")
        # slow-window resolve age: None while firing, else the tick
        # timestamp it was first observed non-firing
        self._slow_ok_since: Optional[float] = None
        # role -> the last decision dict (at/direction/from/to/reason)
        self._last_decision: Dict[str, Dict] = {}
        self.ticks = 0
        self.conflicts = 0
        self._g_desired = None
        self._c_decisions = None
        if registry is not None:
            self._g_desired = registry.gauge(
                "autoscale_replicas_desired",
                "Replicas the autoscaler last wrote for the role group",
                labelnames=("role",),
            )
            self._c_decisions = registry.counter(
                "autoscale_decisions_total",
                "Scaling decisions applied, by role and direction",
                labelnames=("role", "direction"),
            )

    @staticmethod
    def _burn_keys(alerts, rule_name: str) -> Tuple[str, str]:
        """The (fast, slow) instance keys of the named burn-rate rule
        — fast is the shortest window, slow the longest, matching the
        `name[Ws]` instance-key scheme."""
        for rule in alerts.rules:
            if rule.name == rule_name and hasattr(rule, "windows"):
                windows = sorted(w for w, _ in rule.windows)
                if not windows:
                    break
                return (
                    f"{rule_name}[{windows[0]:g}s]",
                    f"{rule_name}[{windows[-1]:g}s]",
                )
        raise ValueError(
            f"alert manager has no burn-rate rule {rule_name!r} "
            "with windows"
        )

    # -- introspection -------------------------------------------------------

    def describe(self) -> Dict:
        """Operator view for /debug/slozz: last decision + cooldown
        per role, the burn instances watched, and per-tenant reject
        rates (req/s over the last minute) so "why is/isn't the fleet
        scaling" needs no log spelunking."""
        now = self.clock.monotonic()
        try:
            svc = self.substrate.get_serve_service(
                self.namespace, self.name
            )
        except Exception:
            svc = None
        policy = svc.spec.autoscale if svc is not None else None
        cooldown = (
            policy.cooldown_seconds if policy is not None else None
        )
        with self._lock:
            roles: Dict[str, Dict] = {}
            group_items = (
                svc.spec.replica_groups.items() if svc is not None else ()
            )
            for role, group in group_items:
                last = self._last_decision.get(role)
                remaining = None
                if last is not None and cooldown:
                    remaining = max(0.0, cooldown - (now - last["at"]))
                roles[role] = {
                    "replicas": group.replicas,
                    "min_replicas": group.min_replicas,
                    "max_replicas": group.max_replicas,
                    "last_decision": (
                        {
                            k: v for k, v in last.items() if k != "at"
                        } | {"age_s": round(now - last["at"], 3)}
                        if last is not None else None
                    ),
                    "cooldown_remaining_s": (
                        round(remaining, 3)
                        if remaining is not None else None
                    ),
                }
            slow_ok_since = self._slow_ok_since
        return {
            "enabled": bool(policy is not None and policy.enabled),
            "fast_instance": self.fast_key,
            "slow_instance": self.slow_key,
            "slow_resolved_for_s": (
                round(now - slow_ok_since, 3)
                if slow_ok_since is not None else None
            ),
            "ticks": self.ticks,
            "conflicts": self.conflicts,
            "roles": roles,
            "tenant_reject_rates": self.tenant_reject_rates(),
        }

    def tenant_reject_rates(self, window_s: float = 60.0) -> Dict[str, float]:
        """Per-tenant fleet reject rate (429/s) over the window, read
        off the tenant_rejected_total series fleet_slo() ingests."""
        out: Dict[str, float] = {}
        for series in self.history.series_names():
            if not series.startswith('fleet_tenant_rejected_total{'):
                continue
            rate = self.history.rate(series, window_s)
            if rate is None:
                continue
            tenant = series.split('tenant="', 1)[-1].rstrip('"}')
            out[tenant] = round(rate, 6)
        return out

    # -- trace correlation ---------------------------------------------------

    def _alert_traces(self, instance: str, state: str) -> str:
        """The `traces` field of the most recent kind="alert" record
        for this instance+state — the requests that burned (or
        recovered) the budget the decision acted on."""
        if self.flight is None:
            return ""
        for record in reversed(self.flight.snapshot(kind="alert")):
            fields = record.fields
            if (
                fields.get("instance") == instance
                and fields.get("state") == state
            ):
                return str(fields.get("traces", ""))
        return ""

    # -- the loop ------------------------------------------------------------

    def tick(self) -> List[Dict]:
        """One control step: read alert state, decide per role group,
        write the new scale. Returns the decisions applied (possibly
        empty). Never raises on substrate conflicts — the reconciler
        and the autoscaler share the object; losing a race just defers
        to the next tick."""
        now = self.clock.monotonic()
        with self._lock:
            self.ticks += 1
            try:
                svc = self.substrate.get_serve_service(
                    self.namespace, self.name
                )
            except Exception:
                return []
            policy = svc.spec.autoscale
            if policy is None or not policy.enabled:
                return []

            firing = set(self.alerts.firing())
            fast_firing = self.fast_key in firing
            slow_firing = self.slow_key in firing
            if slow_firing:
                self._slow_ok_since = None
            elif self._slow_ok_since is None:
                self._slow_ok_since = now

            queue_depth = self.history.latest(_QUEUE_SERIES)
            if queue_depth is None or isinstance(queue_depth, tuple):
                queue_depth = 0.0
            total_replicas = sum(
                group.replicas or 0
                for group in svc.spec.replica_groups.values()
            )
            queue_per_replica = float(queue_depth) / max(1, total_replicas)

            decisions: List[Dict] = []
            cooldown = policy.cooldown_seconds
            for role, group in svc.spec.replica_groups.items():
                cur = group.replicas or 1
                lo = group.min_replicas or cur
                hi = group.max_replicas or cur
                last = self._last_decision.get(role)
                if last is not None and now - last["at"] < cooldown:
                    continue  # in cooldown: at most one direction
                    # change per window, by construction
                queue_hot = queue_per_replica > policy.max_queue_per_replica
                if (fast_firing or queue_hot) and cur < hi:
                    reason = (
                        f"burn:{self.fast_key}" if fast_firing
                        else f"queue:{queue_per_replica:.2f}/replica"
                    )
                    decisions.append({
                        "at": now,
                        "role": role,
                        "direction": "out",
                        "from": cur,
                        "to": min(hi, cur + policy.scale_out_step),
                        "reason": reason,
                        "traces": (
                            self._alert_traces(self.fast_key, "firing")
                            if fast_firing else ""
                        ),
                    })
                elif (
                    cur > lo
                    and not fast_firing
                    and not slow_firing
                    and self._slow_ok_since is not None
                    and now - self._slow_ok_since >= cooldown
                    and queue_per_replica
                    <= policy.max_queue_per_replica
                    * _SCALE_IN_QUEUE_FRACTION
                ):
                    decisions.append({
                        "at": now,
                        "role": role,
                        "direction": "in",
                        "from": cur,
                        "to": max(lo, cur - policy.scale_in_step),
                        "reason": (
                            f"slow-resolved:"
                            f"{now - self._slow_ok_since:.1f}s"
                        ),
                        "traces": self._alert_traces(
                            self.slow_key, "resolved"
                        ) or self._alert_traces(self.fast_key, "resolved"),
                    })

            if not decisions:
                return []
            for decision in decisions:
                svc.spec.replica_groups[decision["role"]].replicas = (
                    decision["to"]
                )
            try:
                self.substrate.update_serve_service(svc)
            except Exception:
                # optimistic-concurrency loss (or a fence rejection
                # mid-failover): drop the decisions, re-read next tick
                self.conflicts += 1
                return []
            for decision in decisions:
                self._last_decision[decision["role"]] = decision
                self._emit(decision)
            return [
                {k: v for k, v in d.items() if k != "at"}
                for d in decisions
            ]

    def _emit(self, decision: Dict) -> None:
        role = decision["role"]
        logger.info(
            "autoscale %s: %s %d -> %d (%s)",
            self.name, role, decision["from"], decision["to"],
            decision["reason"],
        )
        if self._g_desired is not None:
            self._g_desired.labels(role=role).set(decision["to"])
        if self._c_decisions is not None:
            self._c_decisions.labels(
                role=role, direction=decision["direction"]
            ).inc()
        if self.flight is not None:
            self.flight.record(
                "scale",
                service=self.name,
                role=role,
                direction=decision["direction"],
                from_replicas=decision["from"],
                to_replicas=decision["to"],
                reason=decision["reason"],
                instance=(
                    self.fast_key if decision["direction"] == "out"
                    else self.slow_key
                ),
                traces=decision["traces"],
            )
