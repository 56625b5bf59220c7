"""The port's training telemetry (tf_operator_tpu_torch/train/observe.py:
TrainTelemetry, WorkerClient, TrainFleetView, fold_train_observability,
the observe smoke, and --monitoring-bind-addr on every train CLI) held
against the JAX package's train/observe.py on the CPU.

- The process-wide registry carries the reference's "tf_operator_tpu"
  prefix: one MNIST Trainer.fit in each package, on fresh default
  registries, renders the same set of sample names.
- The fleet view runs tests/test_train_observe.py's scripted fake
  workers in both packages: the reports, the alert transitions and the
  /debug/alertz pages are equal.
- train/gpt.py --monitoring-bind-addr serves every route while it
  trains; its /metrics validates and names what the reference CLI's
  names.
- run_train_observe_smoke(device="cpu") runs once (~20 s: two MNIST
  workers through a baseline, a latency fault and its recovery).
"""

import json
import socket
import types
import urllib.error
import urllib.request

import pytest

try:
    import jax

    from tf_operator_tpu import telemetry as ref_telemetry
    from tf_operator_tpu.api.serde import from_jsonable, to_jsonable
    from tf_operator_tpu.api.types import TFJob
    from tf_operator_tpu.controller.clock import FakeClock as RefFakeClock
    from tf_operator_tpu.train import observe as ref_observe
except ImportError:  # a card machine without JAX
    jax = None

from tf_operator_tpu_torch import telemetry as port_telemetry
from tf_operator_tpu_torch.controller.clock import FakeClock
from tf_operator_tpu_torch.telemetry import MetricRegistry, validate_text
from tf_operator_tpu_torch.train import observe

ROUTES = ("/metrics", "/healthz", "/debug/slozz", "/debug/flightz", "/debug/historyz",
          "/debug/alertz", "/debug/profilez")
CLIS = ("gpt", "bert", "resnet", "mnist", "moe", "vit", "eval_loop")


def _need_jax():
    if jax is None:
        pytest.skip("JAX is not installed")


@pytest.fixture
def fresh_default_registries(monkeypatch):
    """Both packages' process-wide registries, new for this test."""
    monkeypatch.setattr(port_telemetry, "_default", None)
    if jax is not None:
        monkeypatch.setattr(ref_telemetry, "_default", None)


def _sample_names(text):
    return {line.split(" ")[0] for line in text.splitlines() if line and not line.startswith("#")}


def _get(url):
    with urllib.request.urlopen(url, timeout=10) as resp:
        return resp.status, resp.headers.get("Content-Type"), resp.read()


# -- the registry prefix -----------------------------------------------------------

def test_default_registry_renders_the_reference_names(fresh_default_registries):
    """One MNIST Trainer.fit of three steps on each package's default
    registry: the same sample names, every one under the reference's
    tf_operator_tpu_ prefix (the port's registry had none)."""
    _need_jax()
    import optax
    import torch

    from tf_operator_tpu.models import mnist as jax_mnist
    from tf_operator_tpu.parallel.sharding import REPLICATED_RULES
    from tf_operator_tpu.train import trainer as jax_trainer
    from tf_operator_tpu_torch.models import mnist as torch_mnist
    from tf_operator_tpu_torch.train.trainer import Trainer, classification_task

    jtrainer = jax_trainer.Trainer(
        jax_mnist.MnistCNN(), jax_trainer.classification_task(jax_mnist.MnistCNN()),
        optax.adam(1e-3), rules=REPLICATED_RULES,
    )
    key = jax.random.PRNGKey(0)

    def jax_batches():
        k = jax.random.PRNGKey(1)
        while True:
            k, sub = jax.random.split(k)
            yield jax_mnist.synthetic_batch(sub, 8)

    jtrainer.fit(jtrainer.init(key, jax_mnist.synthetic_batch(key, 8)), jax_batches(),
                 steps=3, log_every=1)
    trainer = Trainer(torch_mnist.MnistCNN(generator=torch.Generator().manual_seed(0)),
                      classification_task(), learning_rate=1e-3, weight_decay=0.0,
                      device="cpu")

    def torch_batches():
        generator = torch.Generator().manual_seed(1)
        while True:
            yield torch_mnist.synthetic_batch(generator, 8)

    trainer.fit(trainer.init(), torch_batches(), steps=3, log_every=1)
    text = port_telemetry.default_registry().render()
    names = _sample_names(text)
    assert names == _sample_names(ref_telemetry.default_registry().render())
    assert "tf_operator_tpu_train_steps_total 3" in text.splitlines()
    assert all(name.startswith("tf_operator_tpu_train_") for name in names)


# -- the worker telemetry server ---------------------------------------------------

def _fake_trainer(registry):
    """The surface TrainTelemetry reads off a Trainer."""
    trainer = types.SimpleNamespace(
        metrics_registry=registry, health=observe.HealthPhase(),
        phase_timer=observe.StepPhaseTimer(registry, clock=FakeClock()),
        goodput=observe.GoodputLedger(registry),
    )
    trainer.health.set("training")
    trainer.goodput.useful(1.0, steps=1)
    return trainer


def test_train_telemetry_serves_every_route_and_the_worker_client():
    registry = MetricRegistry("tf_operator_tpu")
    telemetry = observe.TrainTelemetry(trainer=_fake_trainer(registry), worker="worker-7",
                                       history_interval_s=0.05)
    port = telemetry.start("127.0.0.1:0")
    base = f"http://127.0.0.1:{port}"
    try:
        for path in ROUTES:
            status, ctype, body = _get(base + path)
            assert status == 200 and ctype, path
        validate_text(_get(base + "/metrics")[2].decode())
        with pytest.raises(urllib.error.HTTPError) as err:
            _get(base + "/nope")
        assert err.value.code == 404
        health = json.loads(_get(base + "/healthz")[2])
        assert (health["phase"], health["worker"], health["steps"]) == ("training", "worker-7", 0)
        slozz = json.loads(_get(base + "/debug/slozz")[2])["train"]
        assert slozz["goodput_fraction"] == 1.0
        assert set(slozz["phases"]["phase_seconds"]) == set(observe.PHASES)
        client = observe.WorkerClient(base)
        assert client.metrics()["tf_operator_tpu_train_goodput_useful_seconds_total"] == 1.0
        assert client.healthz()["phase"] == "training" and "goodput" in client.slozz()["train"]
        assert json.loads(_get(base + "/debug/historyz")[2])["ticks"] >= 0
    finally:
        telemetry.stop()
    assert telemetry.history._ticker is None  # stop() ends the tick thread too


# -- the fleet view ------------------------------------------------------------------

class _FakeWorker:
    """Scriptable WorkerClient: the fleet view calls metrics() and healthz()."""

    def __init__(self):
        self.steps = 0.0
        self.dead = False

    def metrics(self):
        if self.dead:
            raise ConnectionError("scrape refused")
        return {"tf_operator_tpu_train_steps_total": self.steps}

    def healthz(self):
        return {"phase": "training"}


def _fleet_script(pkg):
    """tests/test_train_observe.py's scripts (a straggler fires then
    resolves, a stall, a dead scrape holding the alerts) on one fleet:
    -> every pass's report, the firing sets and the /debug/alertz page."""
    telemetry, clock_cls, mod = pkg
    clock = clock_cls()
    workers = {"worker-0": _FakeWorker(), "worker-1": _FakeWorker()}
    history = telemetry.MetricHistory(capacity=256, clock=clock)
    manager = telemetry.AlertManager(
        history, telemetry.train_rules(sorted(workers), straggler_ratio=0.7, stall_k=8.0),
        registry=telemetry.MetricRegistry("tf_operator_tpu"), clock=clock,
        flight=telemetry.FlightRecorder(),
    )
    view = mod.TrainFleetView(workers, history=history, alerts=manager,
                              registry=telemetry.MetricRegistry("tf_operator_tpu"),
                              clock=clock, rate_window_s=4.0)
    reports, firing = [], []
    for seconds, rates in ((6, {"worker-0": 4, "worker-1": 4}),
                           (6, {"worker-0": 4, "worker-1": 1}),
                           (8, {"worker-0": 4, "worker-1": 4}),
                           (6, {"worker-0": 4, "worker-1": 0}),
                           (2, {"worker-0": 4, "worker-1": 1}),
                           ("dead", {"worker-0": 4}),
                           (3, {"worker-0": 4})):
        if seconds == "dead":
            workers["worker-1"].dead = True
            continue
        for _ in range(seconds):
            for name, rate in rates.items():
                workers[name].steps += rate
            clock.advance(1.0)
            reports.append(view.observe())
        firing.append(manager.firing())
    slowdown = view.history.latest(f'{mod.SLOWDOWN_SERIES}{{worker="worker-1"}}')
    alertz = json.loads(telemetry.render_alertz(manager, ""))
    return {"reports": reports, "firing": firing, "slowdown": slowdown, "alertz": alertz,
            "last": view.last_report}


def test_fleet_view_matches_the_reference():
    _need_jax()
    ref = _fleet_script((ref_telemetry, RefFakeClock, ref_observe))
    port = _fleet_script((port_telemetry, FakeClock, observe))
    assert port == ref
    firing = port["firing"]
    assert firing[0] == [] and "train-straggler[worker-1]" in firing[1]
    assert firing[2] == []  # resolved once the skew left the window
    assert "train-stall[worker-1]" in firing[3]
    last = port["reports"][-1]
    assert last["partial"] is True and "worker-1" in last["scrape_errors"]
    assert firing[-1] == firing[-2]  # a dead scrape never fakes a recovery
    assert port["last"] is not None and port["reports"][0]["workers"]["worker-0"]["phase"]


def test_fold_round_trips_through_the_reference_serde():
    _need_jax()
    report = {"last_step": 42, "median_steps_per_sec": 3.5, "stragglers": ["worker-1"],
              "stalled": [], "alerts": {"firing": ["train-straggler[worker-1]"]},
              "partial": True}
    job, ref_job = TFJob(), TFJob()
    job.metadata.name = ref_job.metadata.name = "train-observe"
    observe.fold_train_observability(job, report)
    ref_observe.fold_train_observability(ref_job, report)
    assert job.status.extra == ref_job.status.extra
    back = from_jsonable(to_jsonable(job), TFJob)
    assert back.status.extra["trainObservability"] == {
        "lastStep": 42, "medianStepsPerSec": 3.5, "stragglers": ["worker-1"],
        "stalledWorkers": [], "alertsFiring": ["train-straggler[worker-1]"], "partial": True,
    }


# -- the CLIs --------------------------------------------------------------------------

@pytest.mark.parametrize("cli", CLIS)
def test_every_train_cli_takes_monitoring_bind_addr(cli):
    import importlib

    module = importlib.import_module(f"tf_operator_tpu_torch.train.{cli}")
    argv = ["--monitoring-bind-addr", "127.0.0.1:0"]
    if cli == "eval_loop":
        argv += ["--checkpoint-dir", "ck"]
    assert module.parse_args(argv).monitoring_bind_addr == "127.0.0.1:0"
    assert module.parse_args(argv[2:]).monitoring_bind_addr is None


def _free_port():
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def test_gpt_cli_serves_telemetry_while_it_trains(fresh_default_registries):
    """train/gpt.py on GPT_TINY with --monitoring-bind-addr: every route
    answers from inside a step, /metrics validates and counts the steps,
    /healthz reaches training, and the run's sample names are the
    reference CLI's."""
    from tf_operator_tpu_torch.train import gpt as gpt_cli

    port = _free_port()
    base = f"http://127.0.0.1:{port}"
    argv = ["--preset", "tiny", "--steps", "3", "--batch-size", "8", "--seq-len", "64",
            "--log-every", "1", "--monitoring-bind-addr", f"127.0.0.1:{port}"]
    seen = {}

    def scrape(state):
        if state.step < 2:
            return
        seen[state.step] = {path: _get(base + path) for path in ROUTES}

    assert gpt_cli.main(argv + ["--device", "cpu"], on_step=scrape) == 0
    assert sorted(seen) == [2, 3]
    for step, pages in seen.items():
        assert all(status == 200 for status, _, _ in pages.values())
        assert json.loads(pages["/healthz"][2])["phase"] == "training"
        text = pages["/metrics"][2].decode()
        validate_text(text)
        assert f"tf_operator_tpu_train_steps_total {step}" in text.splitlines()
    with pytest.raises(OSError):  # the server ended with the run
        _get(base + "/healthz")
    names = _sample_names(port_telemetry.default_registry().render())
    assert _sample_names(seen[3]["/metrics"][2].decode()) == names
    if jax is not None:
        from tf_operator_tpu.train import gpt as jax_gpt_cli

        assert jax_gpt_cli.main(argv[:-1] + ["127.0.0.1:0"]) == 0
        assert names == _sample_names(ref_telemetry.default_registry().render())


# -- the smoke -----------------------------------------------------------------------

def test_train_observe_smoke_on_the_cpu():
    summary = observe.run_train_observe_smoke(device="cpu", steps=250)
    assert summary["ok"] and summary["problems"] == []
    assert summary["fired"] == ["train-straggler[worker-1]"] and summary["resolved"]
    assert all(c >= 0.95 for c in summary["phase_coverage"].values())
    for ledger in summary["goodput"].values():
        assert ledger["accounted_steps"] == 250
    assert summary["status_extra"]["trainObservability"]["lastStep"] == 250
    assert summary["latency_faults"] >= 1 and summary["profiler_samples"] > 0
