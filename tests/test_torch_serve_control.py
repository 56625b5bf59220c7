"""The port's ServeService control plane (tf_operator_tpu_torch/api,
runtime/{substrate,control,events,expectations,workqueue}.py,
controller/serve.py), the autoscaler (serve/autoscaler.py), the trace
collector (telemetry/collector.py) and the fleet observatory
(serve/observatory.py), held against the JAX package's copies of the same
modules on the same inputs. Host code only: nothing here runs a model.

Criteria: equal. The API's wire dicts after set_serve_defaults are equal
apart from the serve pod command's module (`tf_operator_tpu_torch.serve`
in the port, the one intended difference), and validation raises the same
ValidationError texts. The controllers run one scripted sequence, each
on its own package's InMemorySubstrate under its own FakeClock: pod names,
labels, commands, owner references, phases, ServeService status and
conditions and the recorded events must be equal after every step (the
wall-clock stamps, resource versions and trace ids, which no step fixes,
are left out). The autoscalers see one scripted alert/history sequence and
must take the same decisions; hop_breakdown, fleet_kv_directory and
fleet_slo see the same records and router state.
"""

import dataclasses
import importlib
import re

import pytest

try:
    import tf_operator_tpu.api as ref_api  # noqa: F401 — skips on a card machine without JAX
except ImportError:
    pytest.skip("the reference package is not importable here", allow_module_level=True)

PACKAGES = ("tf_operator_tpu", "tf_operator_tpu_torch")


def mods(pkg):
    """The modules of one package that the control plane spans."""
    def m(name):
        return importlib.import_module(f"{pkg}.{name}")

    return dataclasses.make_dataclass("Mods", ["api", "types", "k8s", "validation", "runtime",
                                                "controller", "serve_ctl", "clock"])(
        m("api"), m("api.types"), m("api.k8s"), m("api.validation"), m("runtime"),
        m("controller"), m("controller.serve"), m("controller.clock"))


# -- the API ----------------------------------------------------------------

MANIFESTS = [
    {"apiVersion": "tpu.kubeflow.org/v1", "kind": "ServeService",
     "metadata": {"name": "fleet", "namespace": "test", "uid": "svc-uid-1"},
     "spec": {"replicas": 3, "maxUnavailable": 1, "weightsVersion": "w-2024"}},
    {"apiVersion": "tpu.kubeflow.org/v1", "kind": "ServeService",
     "metadata": {"name": "d"}, "spec": {}},
    {"apiVersion": "tpu.kubeflow.org/v1", "kind": "ServeService",
     "metadata": {"name": "m"}, "spec": {"meshShape": "1x2", "slots": 4, "preset": "small"}},
    {"apiVersion": "tpu.kubeflow.org/v1", "kind": "ServeService",
     "metadata": {"name": "split", "namespace": "ns"},
     "spec": {"weightsVersion": "v1", "replicaGroups": {
         "prefill": {"replicas": 1, "slots": 2},
         "decode": {"replicas": 2, "minReplicas": 1, "maxReplicas": 4, "speculate": "ngram"},
     }, "autoscale": {"enabled": True, "cooldownSeconds": 30}}},
]

# (a manifest's spec overrides, the ValidationError the reference raises)
BAD_SPECS = [
    {"replicas": 0},
    {"replicas": 2, "maxUnavailable": 5},
    {"meshShape": "2x"},
    {"meshShape": "0x2"},
    {"replicaGroups": {"prefill": {"replicas": 0}}},
    {"replicaGroups": {"verify": {"replicas": 1}}},
    {"replicaGroups": {"decode": {"replicas": 2, "minReplicas": 3}}},
    {"replicaGroups": {"prefill": {"replicas": 1, "speculate": "ngram"}}},
    {"slots": 0},
    {"port": 0},
]

MODULE_NAMES = re.compile(r"\btf_operator_tpu(_torch)?\.serve\b")


def _wire(pkg, manifest):
    m = mods(pkg)
    svc = m.types.ServeService.from_dict(manifest)
    m.api.set_serve_defaults(svc)
    return svc.to_dict()


def _neutral(obj):
    """obj with the serve pod command's module name made neutral."""
    if isinstance(obj, dict):
        return {k: _neutral(v) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_neutral(v) for v in obj]
    if isinstance(obj, str):
        return MODULE_NAMES.sub("<pkg>.serve", obj)
    return obj


@pytest.mark.parametrize("manifest", MANIFESTS, ids=lambda m: m["metadata"]["name"])
def test_serve_service_defaults_and_wire_match_the_reference(manifest):
    ref, port = (_wire(pkg, manifest) for pkg in PACKAGES)
    assert _neutral(port) == _neutral(ref)
    assert port != ref  # the command's module is the one difference
    command = port["spec"]["template"]["spec"]["containers"][0]["command"]
    assert command[:3] == ["python", "-m", "tf_operator_tpu_torch.serve"]
    for pkg, wire in zip(PACKAGES, (ref, port)):
        m = mods(pkg)
        back = m.types.ServeService.from_dict(wire)
        assert back.to_dict() == wire
        m.api.validate_serve_service(back)


@pytest.mark.parametrize("spec", BAD_SPECS, ids=lambda s: ",".join(sorted(s)))
def test_validation_refuses_bad_specs_as_the_reference(spec):
    texts = []
    for pkg in PACKAGES:
        m = mods(pkg)
        svc = m.types.ServeService.from_dict({
            "apiVersion": "tpu.kubeflow.org/v1", "kind": "ServeService",
            "metadata": {"name": "bad", "namespace": "t"}, "spec": dict(spec),
        })
        m.api.set_serve_defaults(svc)
        with pytest.raises(m.validation.ValidationError) as err:
            m.api.validate_serve_service(svc)
        texts.append(str(err.value))
    assert texts[0] == texts[1]


def test_env_names_kept_for_the_worker_bootstrap():
    from tf_operator_tpu.api import types as ref_types
    from tf_operator_tpu_torch.api import types as port_types

    for name in ("ENV_TPU_WORKER_ID", "ENV_TPU_WORKER_HOSTNAMES", "ENV_TPU_TOPOLOGY",
                 "ENV_TPU_ACCELERATOR", "ENV_COORDINATOR_ADDRESS", "ENV_COORDINATOR_OVERRIDE",
                 "ENV_NUM_PROCESSES", "ENV_PROCESS_ID"):
        assert getattr(port_types, name) == getattr(ref_types, name)


# -- the controller on one scripted sequence --------------------------------

DROP = re.compile(r"(Timestamp|Time|resourceVersion|timestamp)$")
TRACE = re.compile(r"\b[0-9a-f]{32}\b|\b[0-9a-f]{16}\b")


def _strip(obj):
    """A wire dict without the stamps no step fixes (wall times, resource
    versions, trace ids), and with the command's module made neutral."""
    if isinstance(obj, dict):
        return {k: _strip(v) for k, v in obj.items() if not DROP.search(k)}
    if isinstance(obj, list):
        return [_strip(v) for v in obj]
    if isinstance(obj, str):
        return TRACE.sub("<id>", MODULE_NAMES.sub("<pkg>.serve", obj))
    return obj


class Scenario:
    """One package's controller, substrate and hook on a FakeClock."""

    def __init__(self, pkg, hook=True):
        self.m = mods(pkg)
        self.clock = self.m.clock.FakeClock()
        self.substrate = self.m.runtime.InMemorySubstrate()
        self.calls = []
        self.controller = self.m.controller.ServeServiceController(
            self.substrate, clock=self.clock, namespace="ctl",
            weight_update=self._hook if hook else None,
        )

    def _hook(self, svc, pods):
        names = [p.metadata.name for p in pods]
        self.calls.append((svc.spec.weights_version, names))
        return names

    def svc(self, name, **spec):
        svc = self.m.types.ServeService.from_dict({
            "apiVersion": "tpu.kubeflow.org/v1", "kind": "ServeService",
            "metadata": {"name": name, "namespace": "ctl"}, "spec": spec,
        })
        return svc

    def run(self):
        self.clock.advance(1.0)
        self.controller.run_until_quiet()

    def running(self, *names):
        for pod in self.substrate.list_pods("ctl"):
            if not names or pod.metadata.name in names:
                if pod.status.phase == self.m.k8s.POD_PENDING:
                    self.substrate.mark_pod_running("ctl", pod.metadata.name)

    def snapshot(self):
        pods = sorted(self.substrate.list_pods("ctl"), key=lambda p: p.metadata.name)
        services = sorted(self.substrate.list_serve_services("ctl"), key=lambda s: s.name)
        events = [
            (e.involved_object_name, e.type, e.reason, e.message)
            for s in services
            for e in self.substrate.events_for("ServeService", s.name, "ctl")
        ]
        return _strip({
            "pods": [self.m.api.serde.to_jsonable(p) for p in pods],
            "services": [s.to_dict() for s in services],
            "events": events,
            "hook_calls": list(self.calls),
        })


def _steps(sc):
    """The scripted sequence; yields (step name, snapshot)."""
    m = sc.m
    sc.substrate.create_serve_service(sc.svc("fleet", replicas=3, weightsVersion="v1"))
    sc.run()
    yield "create", sc.snapshot()
    sc.running()
    sc.run()
    yield "running", sc.snapshot()
    sc.substrate.terminate_pod("ctl", "fleet-engine-1", exit_code=137)
    sc.run()
    yield "kill 137", sc.snapshot()
    sc.running()
    sc.run()
    # a pod of the namespace that no ServeService owns
    foreign = m.k8s.Pod(metadata=m.k8s.ObjectMeta(
        name="someone-else", namespace="ctl", labels={"app": "other"}))
    sc.substrate.create_pod(foreign)
    sc.run()
    yield "foreign pod", sc.snapshot()
    fresh = sc.substrate.get_serve_service("ctl", "fleet")
    fresh.spec.replicas = 2
    sc.substrate.update_serve_service(fresh)
    sc.run()
    yield "scale down", sc.snapshot()
    fresh = sc.substrate.get_serve_service("ctl", "fleet")
    fresh.spec.weights_version = "v2"
    sc.substrate.update_serve_service(fresh)
    for i in range(4):
        sc.run()
        yield f"rolling update {i}", sc.snapshot()
    # a dead replica mid-rollout pauses it (capacity already down)
    fresh = sc.substrate.get_serve_service("ctl", "fleet")
    fresh.spec.weights_version = "v3"
    sc.substrate.update_serve_service(fresh)
    sc.substrate.terminate_pod("ctl", "fleet-engine-0", exit_code=137)
    sc.run()
    yield "paused rollout", sc.snapshot()
    sc.running()
    for i in range(3):
        sc.run()
        yield f"resumed rollout {i}", sc.snapshot()
    sc.substrate.create_serve_service(sc.svc("bad", replicas=0))
    sc.run()
    yield "invalid spec", sc.snapshot()
    sc.substrate.create_serve_service(sc.svc("split", weightsVersion="v1", replicaGroups={
        "prefill": {"replicas": 1, "slots": 2},
        "decode": {"replicas": 2, "speculate": "ngram", "specDepth": 3},
    }))
    sc.run()
    sc.running()
    sc.run()
    yield "role groups", sc.snapshot()
    fresh = sc.substrate.get_serve_service("ctl", "split")
    fresh.spec.replica_groups.pop("prefill")
    sc.substrate.update_serve_service(fresh)
    sc.run()
    yield "role group removed", sc.snapshot()


@pytest.mark.parametrize("hook", [True, False], ids=["weight_update hook", "no hook"])
def test_serve_controller_matches_the_reference_on_a_scripted_sequence(hook):
    ref, port = Scenario(PACKAGES[0], hook), Scenario(PACKAGES[1], hook)
    try:
        steps = 0
        for (name, want), (_, got) in zip(_steps(ref), _steps(port)):
            assert got == want, name
            steps += 1
        assert steps == 16
        final = port.snapshot()
        names = [p["metadata"]["name"] for p in final["pods"]]
        assert "someone-else" in names  # foreign pods left alone
        assert any(e[2] == "ServeServiceFailedValidation" for e in final["events"])
        if hook:
            assert [c[0] for c in port.calls].count("v2") >= 2
    finally:
        ref.controller.stop()
        port.controller.stop()


def test_controller_uses_the_python_work_queue_and_expectations():
    from tf_operator_tpu_torch.runtime import (ControllerExpectations, InMemorySubstrate,
                                               RateLimitingQueue)
    from tf_operator_tpu_torch.controller import ServeServiceController

    controller = ServeServiceController(InMemorySubstrate(), namespace="q")
    try:
        assert type(controller.queue) is RateLimitingQueue
        assert type(controller.expectations) is ControllerExpectations
    finally:
        controller.stop()


# -- the autoscaler ---------------------------------------------------------


def _autoscale_run(pkg):
    """Drive one package's ServeAutoscaler through a scripted alert and
    queue sequence on a FakeClock; -> its decisions, tick by tick, and
    the service's replicas after each."""
    m = mods(pkg)
    alerts_mod = importlib.import_module(f"{pkg}.telemetry.alerts")
    history_mod = importlib.import_module(f"{pkg}.telemetry.history")
    flight_mod = importlib.import_module(f"{pkg}.telemetry.flight")
    autoscaler_mod = importlib.import_module(f"{pkg}.serve.autoscaler")
    clock = m.clock.FakeClock()
    substrate = m.runtime.InMemorySubstrate()
    svc = m.types.ServeService.from_dict({
        "apiVersion": "tpu.kubeflow.org/v1", "kind": "ServeService",
        "metadata": {"name": "auto", "namespace": "a"},
        "spec": {"weightsVersion": "v1", "replicaGroups": {
            "decode": {"replicas": 1, "minReplicas": 1, "maxReplicas": 3},
            "prefill": {"replicas": 2, "minReplicas": 1, "maxReplicas": 2},
        }, "autoscale": {"enabled": True, "cooldownSeconds": 5, "maxQueuePerReplica": 4}},
    })
    m.api.set_serve_defaults(svc)
    substrate.create_serve_service(svc)
    history = history_mod.MetricHistory(capacity=256, clock=clock)
    queue = {"depth": 0.0}
    history.track_flat(lambda: {("fleet_queue_depth", "gauge"): queue["depth"]})
    manager = alerts_mod.AlertManager(history, alerts_mod.fleet_rules(
        windows=((2.0, 2.0), (6.0, 1.5))), clock=clock)
    flight = flight_mod.FlightRecorder(capacity=512)
    scaler = autoscaler_mod.ServeAutoscaler(
        substrate, "a", "auto", manager, history, flight=flight, clock=clock,
    )
    # alert states forced by the script: (seconds, fast, slow, queue)
    script = ([(0.5, False, False, 0)] * 4 + [(0.5, True, True, 0)] * 4
              + [(1.0, True, True, 0)] * 6 + [(1.0, False, True, 0)] * 3
              + [(1.0, False, False, 0)] * 14 + [(1.0, False, False, 30)] * 3
              + [(1.0, False, False, 0)] * 12)
    fast, slow = scaler.fast_key, scaler.slow_key
    out = []
    for seconds, fast_on, slow_on, depth in script:
        clock.advance(seconds)
        queue["depth"] = float(depth)
        history.tick()
        firing = [k for k, on in ((fast, fast_on), (slow, slow_on)) if on]
        manager.firing = lambda firing=firing: list(firing)
        decisions = scaler.tick()
        groups = substrate.get_serve_service("a", "auto").spec.replica_groups
        out.append((
            [{k: d[k] for k in ("role", "direction", "from", "to", "reason")}
             for d in decisions],
            {role: g.replicas for role, g in sorted(groups.items())},
        ))
    records = [
        {k: r.fields[k] for k in ("role", "direction", "from_replicas", "to_replicas",
                                  "reason", "instance")}
        for r in flight.snapshot(kind="scale")
    ]
    return out, records, scaler.ticks, scaler.conflicts


def test_autoscaler_decides_as_the_reference():
    ref, port = (_autoscale_run(pkg) for pkg in PACKAGES)
    assert port == ref
    decisions = [d for step, _ in port[0] for d in step]
    assert {d["direction"] for d in decisions} == {"out", "in"}
    assert any(d["reason"].startswith("queue:") for d in decisions)


# -- the collector and the observatory --------------------------------------


def _rec(seq, t, corr, op, trace="t" * 32, **fields):
    fields = {"op": op, "trace": trace, **fields}
    return {"seq": seq, "t": t, "wall": 1000.0 + t, "kind": "serve", "corr": corr,
            "fields": fields}


def _disagg_records(trace="t" * 32, base=100.0):
    t = [base + 0.01 * i for i in range(9)]
    return [
        _rec(1, t[0], "r-1", "route", trace=trace),
        _rec(2, t[1], "r-1", "pick", trace=trace),
        _rec(3, t[2], "req-1", "request", trace=trace, path="/prefill"),
        _rec(4, t[2] + 0.002, "req-1", "prefill-chunk", trace=trace),
        _rec(5, t[3], "req-1", "evict", trace=trace),
        _rec(6, t[4], "req-1", "kv-export", trace=trace),
        _rec(7, t[5], "req-2", "request", trace=trace, path="/kv/import"),
        _rec(8, t[6], "req-2", "kv-import", trace=trace),
        _rec(9, t[6] + 0.001, "req-3", "request", trace=trace, path="/generate_stream"),
        _rec(10, t[7], "req-3", "admit", trace=trace),
        _rec(11, t[8], "req-3", "first-token", trace=trace),
    ]


def _monolithic_records():
    records = _disagg_records()
    keep = {"route", "pick", "admit", "first-token"}
    out = [r for r in records if r["fields"]["op"] in keep]
    out.insert(2, _rec(12, 100.015, "req-9", "request", path="/generate_stream"))
    return out


RECORD_SETS = {
    "disaggregated": _disagg_records(),
    "monolithic": _monolithic_records(),
    "missing boundary": [r for r in _disagg_records() if r["fields"]["op"] != "kv-export"],
    "failover": _disagg_records() + [_rec(20, 100.035, "r-1", "pick")],
    "skewed": [dict(r, t=r["t"] + (0.003 if r["fields"]["op"] == "admit" else 0.0))
               for r in _disagg_records()],
}


@pytest.mark.parametrize("name", sorted(RECORD_SETS))
def test_hop_breakdown_matches_the_reference(name):
    from tf_operator_tpu.telemetry import collector as ref_collector
    from tf_operator_tpu_torch.telemetry import collector as port_collector

    records = RECORD_SETS[name]
    assert port_collector.hop_breakdown(records) == ref_collector.hop_breakdown(records)
    assert port_collector.HOP_NAMES == ref_collector.HOP_NAMES
    assert port_collector.KNOWN_OPS == ref_collector.KNOWN_OPS


class _DigestRouter:
    """A router stand-in carrying per-replica digests, as the reference's
    tests/test_kv_observatory.py drives fleet_kv_directory."""

    def __init__(self, per_replica):
        self._per = per_replica

    def digests(self):
        return self._per


def test_fleet_kv_directory_matches_the_reference():
    from tf_operator_tpu.serve import observatory as ref_obs
    from tf_operator_tpu_torch.serve import observatory as port_obs

    per = {
        "r0": {"role": "", "block_size": 8, "digest": ["a", "b", "c"]},
        "r1": {"role": "", "block_size": 8, "digest": ["b", "c", "d"]},
        "r2": {"role": "decode", "block_size": 8, "digest": ["c"]},
        "r3": {"role": "", "block_size": 8, "digest": []},
    }
    got = port_obs.fleet_kv_directory(_DigestRouter(per))
    assert got == ref_obs.fleet_kv_directory(_DigestRouter(per))
    assert got["duplication_factor"] == pytest.approx(7 / 4)
    assert port_obs.fleet_kv_directory(_DigestRouter({})) == \
        ref_obs.fleet_kv_directory(_DigestRouter({}))


def test_fleet_slo_matches_the_reference():
    from tf_operator_tpu.serve import observatory as ref_obs
    from tf_operator_tpu.serve.router import LeastLoadedRouter as RefRouter
    from tf_operator_tpu_torch.serve import observatory as port_obs
    from tf_operator_tpu_torch.serve.router import LeastLoadedRouter

    pages = []
    for obs, router in ((ref_obs, RefRouter()), (port_obs, LeastLoadedRouter())):
        router._ttft_window.extend([0.010, 0.020, 0.030, 0.040, 0.300])
        router._itl_window.extend([0.001, 0.002, 0.003])
        slo = obs.fleet_slo(router)
        pages.append((slo, router.registry.render()))
    assert pages[1][0] == pages[0][0]
    assert "fleet_ttft_seconds" in pages[1][1]
    assert pages[1][0]["router"]["ttft"]["p95"] == pytest.approx(
        pages[0][0]["router"]["ttft"]["p95"])


def test_fleet_rules_match_the_reference():
    from tf_operator_tpu.telemetry import alerts as ref_alerts
    from tf_operator_tpu_torch.telemetry import alerts as port_alerts

    def shape(rules):
        return [(type(r).__name__, r.name, getattr(r, "series", None),
                 getattr(r, "description", None)) for r in rules]

    assert shape(port_alerts.fleet_rules()) == shape(ref_alerts.fleet_rules())
    assert shape(port_alerts.fleet_rules(ttft_slo_s=0.5, windows=((5.0, 2.0),))) == \
        shape(ref_alerts.fleet_rules(ttft_slo_s=0.5, windows=((5.0, 2.0),)))
