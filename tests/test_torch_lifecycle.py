"""The TFJob worker's lifecycle in the port (tf_operator_tpu_torch/train/):
gradient accumulation held against the JAX Trainer's, and the behaviour of
checkpoint and resume, SIGTERM -> 143, the input pipeline, fit, run_steps,
the step profiler and the Evaluator, after the reference's
tests/test_workload.py.

- Accumulation: BERT_TINY's mlm_task at f32 over 2 microbatches whose mlm
  weight mass differs (3 masked positions against 40). The loss within
  1e-5 and the accumulated gradient within 1e-4 of the reference's
  Trainer(accum_steps=2) (whose gradient an optax transformation keeps in
  its state), the tolerances tests/test_torch_bert.py gives one step; and
  the port's accumulated gradient within 1e-5 of its own full-batch
  gradient (the same sums in two groups: f32 rounding only).
- Accumulation with BatchNorm: a small f32 ResNet, one SGD step at accum 2:
  loss, parameters and running statistics within 1e-5 of the reference's
  (each microbatch's forward updates the statistics once, as the
  reference's scan threads batch_stats).

The cuda-marked tests need a card; on a machine with a card and no JAX run
them with `python -m pytest --noconftest tests/test_torch_lifecycle.py -m cuda`.
"""

import dataclasses
import json
import os
import signal
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch

try:
    import jax
    import jax.numpy as jnp
    import optax

    from tf_operator_tpu.models import bert as jax_bert
    from tf_operator_tpu.models import resnet as jax_resnet
    from tf_operator_tpu.parallel.mesh import single_device_mesh
    from tf_operator_tpu.parallel.sharding import CONV_RULES
    from tf_operator_tpu.train import trainer as jax_trainer
except ImportError:  # a card machine without JAX runs only the cuda tests
    jax = None

from tf_operator_tpu_torch.controller.clock import FakeClock
from tf_operator_tpu_torch.models import bert as torch_bert
from tf_operator_tpu_torch.models import gpt as torch_gpt
from tf_operator_tpu_torch.models import resnet as torch_resnet
from tf_operator_tpu_torch.models.convert import (
    bert_state_dict_from_flax,
    resnet_state_dict_from_flax,
)
from tf_operator_tpu_torch.ops import kernels
from tf_operator_tpu_torch.telemetry import MetricRegistry
from tf_operator_tpu_torch.telemetry.flight import (
    FlightRecorder,
    default_flight,
    set_default_flight,
)
from tf_operator_tpu_torch.telemetry.profiler import StepProfiler
from tf_operator_tpu_torch.train import bert as bert_cli
from tf_operator_tpu_torch.train import eval_loop
from tf_operator_tpu_torch.train import gpt as gpt_cli
from tf_operator_tpu_torch.train import resnet as resnet_cli
from tf_operator_tpu_torch.train import trainer as torch_trainer
from tf_operator_tpu_torch.train.input_pipeline import (
    InputPipeline,
    shard_source,
    step_generator,
    synthetic_source,
    write_shards,
)
from tf_operator_tpu_torch.train.observe import GoodputLedger, StepPhaseTimer
from tf_operator_tpu_torch.train.preemption import (
    PREEMPTED_EXIT_CODE,
    PreemptionGuard,
    maybe_preempt_exit,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LOSS_ATOL = 1e-5
GRAD_ATOL = 1e-4
SELF_ATOL = 1e-5
needs_jax = pytest.mark.skipif(jax is None, reason="needs the JAX reference")


# -- gradient accumulation against the reference ------------------------------

def _uneven_mlm_batch(cfg, b=4, s=32, seed=3):
    """Rows 0-1 (microbatch 0) carry 3 masked positions, rows 2-3 40; row
    1 is padded from position 20."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
    mask = np.ones((b, s), np.int32)
    mask[1, 20:] = 0
    weights = np.zeros((b, s), np.float32)
    weights[0, [1, 5]] = 1.0
    weights[1, 7] = 1.0
    weights[2:, :] = (rng.random((2, s)) < 0.7) & (mask[2:] > 0)
    weights[2, :20] = 1.0
    return {"input_ids": ids, "labels": ids, "mlm_weights": weights, "attention_mask": mask}


def _keep_grads():
    """An optax transformation that leaves the parameters alone and keeps
    the gradient it was given in its state."""

    def init(params):
        return jax.tree_util.tree_map(jnp.zeros_like, params)

    def update(grads, state, params=None):
        return jax.tree_util.tree_map(jnp.zeros_like, grads), grads

    return optax.GradientTransformation(init, update)


def _np_tree(tree):
    return jax.tree_util.tree_map(lambda x: np.array(x), tree)


def _torch_batch(batch):
    out = {k: torch.tensor(v) for k, v in batch.items()}
    out["input_ids"] = out["input_ids"].long()
    out["labels"] = out["labels"].long()
    return out


@pytest.fixture(scope="module")
def jax_accum():
    cfg = dataclasses.replace(jax_bert.BERT_TINY, dtype=jnp.float32)
    model = jax_bert.BertForMLM(cfg)
    trainer = jax_trainer.Trainer(
        model, jax_trainer.mlm_task(model), _keep_grads(), mesh=single_device_mesh(),
        accum_steps=2,
    )
    batch = _uneven_mlm_batch(cfg)
    jbatch = trainer.place_batch({k: jnp.asarray(v) for k, v in batch.items()})
    state = trainer.init(jax.random.PRNGKey(0), jbatch)
    params = _np_tree(state.params)
    state, metrics = trainer.step(state, jbatch)
    return {"batch": batch, "params": params, "loss": float(metrics["loss"]),
            "grads": bert_state_dict_from_flax(_np_tree(state.opt_state))}


def _port_grads(params, batch, accum_steps):
    cfg = dataclasses.replace(torch_bert.BERT_TINY, dtype=torch.float32)
    model = torch_bert.BertForMLM(cfg)
    model.load_state_dict(bert_state_dict_from_flax(params))
    trainer = torch_trainer.Trainer(
        model, torch_trainer.mlm_task(), learning_rate=0.0, weight_decay=0.0,
        device="cpu", accum_steps=accum_steps,
    )
    state, metrics = trainer.step(trainer.init(), trainer.place_batch(_torch_batch(batch)))
    return float(metrics["loss"]), {n: p.grad.clone() for n, p in model.named_parameters()}


@needs_jax
def test_accumulated_mlm_step_matches_reference(jax_accum):
    weights = jax_accum["batch"]["mlm_weights"]
    assert weights[:2].sum() == 3 and weights[2:].sum() >= 40  # uneven microbatches
    loss, grads = _port_grads(jax_accum["params"], jax_accum["batch"], 2)
    np.testing.assert_allclose(loss, jax_accum["loss"], atol=LOSS_ATOL)
    assert set(grads) == set(jax_accum["grads"])
    for name, want in jax_accum["grads"].items():
        np.testing.assert_allclose(grads[name].numpy(), want.numpy(), atol=GRAD_ATOL, err_msg=name)


@needs_jax
def test_accumulated_gradient_matches_full_batch(jax_accum):
    loss2, grads2 = _port_grads(jax_accum["params"], jax_accum["batch"], 2)
    loss1, grads1 = _port_grads(jax_accum["params"], jax_accum["batch"], 1)
    np.testing.assert_allclose(loss2, loss1, atol=SELF_ATOL)
    for name, want in grads1.items():
        np.testing.assert_allclose(grads2[name].numpy(), want.numpy(), atol=SELF_ATOL, err_msg=name)
    # the mean of the two microbatches' mean gradients is another gradient
    halves = [
        _port_grads(jax_accum["params"], {k: v[rows] for k, v in jax_accum["batch"].items()}, 1)[1]
        for rows in (slice(0, 2), slice(2, 4))
    ]
    naive = {n: (halves[0][n] + halves[1][n]) / 2 for n in grads1}
    assert max((naive[n] - grads1[n]).abs().max().item() for n in grads1) > 100 * SELF_ATOL


def test_accumulation_rejects_an_indivisible_batch():
    cfg = dataclasses.replace(torch_bert.BERT_TINY, dtype=torch.float32)
    model = torch_bert.BertForMLM(cfg)
    trainer = torch_trainer.Trainer(model, torch_trainer.mlm_task(), device="cpu",
                                    accum_steps=2)
    batch = torch_bert.synthetic_batch(torch.Generator().manual_seed(0), 3, 16, cfg)
    with pytest.raises(ValueError, match="not divisible"):
        trainer.step(trainer.init(), trainer.place_batch(batch))
    with pytest.raises(ValueError, match="accum_steps"):
        torch_trainer.Trainer(model, torch_trainer.mlm_task(), device="cpu", accum_steps=0)


RESNET_SMALL = dict(stage_sizes=(1,), num_classes=10, width=8)


@needs_jax
def test_accumulated_batchnorm_statistics_match_reference():
    model = jax_resnet.ResNet(**RESNET_SMALL, dtype=jnp.float32)
    trainer = jax_trainer.Trainer(
        model, jax_trainer.classification_task(model), optax.sgd(0.1, momentum=0.9),
        mesh=single_device_mesh(), rules=CONV_RULES, accum_steps=2,
    )
    rng = np.random.default_rng(5)
    batch = {"image": rng.standard_normal((4, 32, 32, 3)).astype(np.float32),
             "label": rng.integers(0, 10, (4,)).astype(np.int32)}
    # microbatches with different statistics, so two EMA updates differ from one
    batch["image"][2:] = 3.0 * batch["image"][2:] + 1.0
    jbatch = trainer.place_batch({k: jnp.asarray(v) for k, v in batch.items()})
    state = trainer.init(jax.random.PRNGKey(0), jbatch)
    before = (_np_tree(state.params), _np_tree(state.batch_stats))
    state, metrics = trainer.step(state, jbatch)
    want = resnet_state_dict_from_flax(_np_tree(state.params), _np_tree(state.batch_stats))

    port = torch_resnet.ResNet(**RESNET_SMALL, dtype=torch.float32)
    port.load_state_dict(resnet_state_dict_from_flax(*before))
    ptrainer = torch_trainer.Trainer(
        port, torch_trainer.classification_task(), learning_rate=0.1, device="cpu",
        optimizer="sgd", accum_steps=2,
    )
    pstate, pmetrics = ptrainer.step(ptrainer.init(), ptrainer.place_batch({
        "image": torch.tensor(batch["image"]), "label": torch.tensor(batch["label"]).long(),
    }))
    np.testing.assert_allclose(float(pmetrics["loss"]), float(metrics["loss"]), atol=LOSS_ATOL)
    got = pstate.model.state_dict()
    stats = [n for n in want if n.endswith((".mean", ".var"))]
    assert stats
    for name, value in want.items():
        np.testing.assert_allclose(got[name].numpy(), value.numpy(), atol=1e-5, err_msg=name)
    one_update = resnet_state_dict_from_flax(*before)["stem_bn.mean"] * 0.9
    assert not torch.allclose(got["stem_bn.mean"], one_update, atol=1e-3)


# -- checkpointing ------------------------------------------------------------

def _tiny_gpt_trainer(tmp_path=None, seed=0, accum_steps=1, lr=1e-3):
    model = torch_gpt.GPT(torch_gpt.GPT_TINY, generator=torch.Generator().manual_seed(seed))
    return torch_trainer.Trainer(
        model, torch_trainer.causal_lm_task(), learning_rate=lr, weight_decay=0.01,
        device="cpu", accum_steps=accum_steps,
        checkpoint_dir=None if tmp_path is None else str(tmp_path),
        metrics_registry=MetricRegistry(), clock=FakeClock(),
    )


def _gpt_batch(seed=1, b=2, s=32):
    return torch_gpt.synthetic_batch(torch.Generator().manual_seed(seed), b, s, torch_gpt.GPT_TINY)


def _state_tensors(state):
    out = {f"model.{k}": v.clone() for k, v in state.model.state_dict().items()}
    for index, entry in state.optimizer.state_dict()["state"].items():
        out.update({f"opt.{index}.{k}": v.clone() for k, v in entry.items()})
    return out


def _assert_same(a, b):
    assert set(a) == set(b)
    for name in a:
        assert torch.equal(a[name], b[name]), name


def test_checkpoint_round_trip_is_bit_exact(tmp_path):
    trainer = _tiny_gpt_trainer(tmp_path)
    state = trainer.init()
    batch = trainer.place_batch(_gpt_batch())
    for _ in range(2):
        state, _ = trainer.step(state, batch)
    trainer.save(state)
    saved = _state_tensors(state)
    other = _tiny_gpt_trainer(tmp_path, seed=9)
    restored = other.restore(other.init())
    assert restored is not None and restored.step == 2
    _assert_same(_state_tensors(restored), saved)
    # and the next step from each is the same step
    state, m1 = trainer.step(state, batch)
    restored, m2 = other.step(restored, batch)
    assert float(m1["loss"]) == float(m2["loss"])
    _assert_same(_state_tensors(restored), _state_tensors(state))


def test_async_save_snapshots_before_returning(tmp_path):
    trainer = _tiny_gpt_trainer(tmp_path)
    state = trainer.init()
    batch = trainer.place_batch(_gpt_batch())
    state, _ = trainer.step(state, batch)
    pre = _state_tensors(state)
    trainer.save(state, block=False)
    state, _ = trainer.step(state, batch)  # updates in place while the writer runs
    restored = _tiny_gpt_trainer(tmp_path, seed=5).restore(_tiny_gpt_trainer(seed=5).init())
    assert restored.step == 1
    _assert_same(_state_tensors(restored), pre)


def test_aborted_fit_still_flushes_its_async_save(tmp_path):
    trainer = _tiny_gpt_trainer(tmp_path)
    state = trainer.init()
    batch = _gpt_batch()

    def batches():
        for _ in range(2):
            yield batch
        raise RuntimeError("input died")

    with pytest.raises(RuntimeError, match="input died"):
        trainer.fit(state, batches(), steps=10, checkpoint_every=2)
    assert trainer._ckpt._thread is None  # settled by fit's finally
    assert trainer._ckpt.latest_step() == 2


def test_keep_three_and_half_written_directories_are_ignored(tmp_path):
    trainer = _tiny_gpt_trainer(tmp_path)
    state = trainer.init()
    batch = trainer.place_batch(_gpt_batch())
    for _ in range(5):
        state, _ = trainer.step(state, batch)
        trainer.save(state)
    ckpt = trainer._ckpt
    assert ckpt.steps() == [3, 4, 5]
    # a writer that died mid-write leaves a temporary name; a step
    # directory without its file is no checkpoint either
    os.makedirs(tmp_path / ".tmp-9-1-1")
    (tmp_path / ".tmp-9-1-1" / "state.pt").write_bytes(b"\x80half")
    os.makedirs(tmp_path / "8")
    assert ckpt.latest_step() == 5
    assert trainer.reload_checkpoints() == 5
    restored = _tiny_gpt_trainer(tmp_path, seed=3).restore(_tiny_gpt_trainer(seed=3).init())
    assert restored.step == 5


def test_each_save_is_a_traced_flight_record(tmp_path):
    previous = default_flight()
    recorder = set_default_flight(FlightRecorder())
    try:
        trainer = _tiny_gpt_trainer(tmp_path)
        state = trainer.init()
        trainer.save(state)
        trainer.save(state, block=False)
        trainer._ckpt.wait()
    finally:
        set_default_flight(previous)
    records = recorder.snapshot(kind="checkpoint")
    assert [(r.fields["step"], r.fields["block"]) for r in records] == [(0, True), (0, False)]
    traces = [r.fields["trace"] for r in records]
    assert all(len(t) == 32 for t in traces) and traces[0] != traces[1]


def test_restore_without_a_checkpoint_and_save_without_a_directory(tmp_path):
    trainer = _tiny_gpt_trainer(tmp_path)
    assert trainer.restore(trainer.init()) is None
    bare = _tiny_gpt_trainer()
    with pytest.raises(ValueError, match="checkpoint_dir"):
        bare.save(bare.init())


# -- preemption ---------------------------------------------------------------

def test_guard_latches_sigterm_and_restores_the_handler():
    before = signal.getsignal(signal.SIGTERM)
    with PreemptionGuard() as guard:
        assert not guard.triggered.is_set()
        os.kill(os.getpid(), signal.SIGTERM)
        deadline = time.monotonic() + 5
        while not guard.triggered.is_set() and time.monotonic() < deadline:
            time.sleep(0.01)
        assert guard.triggered.is_set()
    assert signal.getsignal(signal.SIGTERM) is before


def test_guard_degrades_off_the_main_thread():
    before = signal.getsignal(signal.SIGTERM)
    result = {}

    def run():
        with PreemptionGuard() as guard:
            result["installed"] = guard._installed

    worker = threading.Thread(target=run)
    worker.start()
    worker.join(timeout=5)
    assert not worker.is_alive()
    assert result == {"installed": False}
    assert signal.getsignal(signal.SIGTERM) is before


def test_maybe_preempt_exit_contract(tmp_path):
    class FakeState:
        step = 7

    class FakeTrainer:
        def __init__(self):
            self.saved = []

        def save(self, state):
            self.saved.append(state.step)

    guard = PreemptionGuard()  # not entered: no handler installed
    trainer, state = FakeTrainer(), FakeState()
    assert maybe_preempt_exit(guard, trainer, state, str(tmp_path)) is None
    guard.triggered.set()
    assert maybe_preempt_exit(guard, trainer, state, str(tmp_path)) == PREEMPTED_EXIT_CODE == 143
    assert trainer.saved == [7]
    # without a checkpoint directory: still 143, nothing saved
    assert maybe_preempt_exit(guard, trainer, state, None) == 143
    assert trainer.saved == [7]


def test_sigterm_during_fit_checkpoints_and_reports_preempted(tmp_path):
    trainer = _tiny_gpt_trainer(tmp_path)
    state = trainer.init()
    batch = _gpt_batch()
    seen = []

    def batches():
        while True:
            if len(seen) == 3:
                os.kill(os.getpid(), signal.SIGTERM)  # during step 4
            seen.append(1)
            yield batch

    calls = []
    state, metrics = trainer.fit(state, batches(), steps=1000, log_every=100,
                                 metrics_callback=lambda step, m: calls.append((step, m)))
    assert metrics["preempted"] == 1.0
    assert state.step == 4 and trainer._ckpt.latest_step() == 4
    assert calls[-1][0] == 4 and calls[-1][1]["preempted"] == 1.0
    assert trainer.health.phase == "preempted"
    restored = _tiny_gpt_trainer(tmp_path, seed=2).restore(_tiny_gpt_trainer(seed=2).init())
    assert restored.step == 4


def test_step_budget_counts_restored_steps(tmp_path):
    trainer = _tiny_gpt_trainer(tmp_path)
    state = trainer.init()
    batch = _gpt_batch()
    state, _ = trainer.fit(state, iter([batch] * 3), steps=3)
    trainer.save(state)
    resumed = _tiny_gpt_trainer(tmp_path, seed=4)
    rstate = resumed.restore(resumed.init())
    drawn = []

    def batches():
        while True:
            drawn.append(1)
            yield batch

    rstate, _ = resumed.fit(rstate, batches(), steps=5)
    assert rstate.step == 5 and len(drawn) == 2
    assert resumed.goodput.wasted["rewarmup"][1] == 1  # the resumed first step
    rstate, _ = resumed.fit(rstate, batches(), steps=5)
    assert rstate.step == 5 and len(drawn) == 2  # budget spent: nothing more


def test_phase_timer_and_goodput_reconcile_with_the_step_counter(tmp_path):
    trainer = _tiny_gpt_trainer(tmp_path)
    registry = trainer.metrics_registry
    state = trainer.init()
    state, _ = trainer.fit(state, iter([_gpt_batch()] * 4), steps=4, checkpoint_every=2,
                           log_every=2)
    assert trainer.phase_timer.steps == 4
    assert registry.get("train_steps_total").value == 4
    assert registry.get("train_step_seconds").count == 4
    assert trainer.goodput.reconciles(state.step)
    assert trainer.goodput.wasted["warmup"][1] == 1 and trainer.goodput.useful_steps == 3
    split = trainer.phase_timer.summary()["phase_seconds"]
    assert set(split) >= {"data_wait", "host_to_device", "step_dispatch", "device_sync",
                          "checkpoint", "eval_publish"}
    ledger = GoodputLedger(registry)
    ledger.useful(1.0, steps=2)
    ledger.waste("warmup", 1.0, steps=1)
    assert ledger.reconciles(3) and ledger.fraction() == 0.5
    with pytest.raises(ValueError):
        ledger.waste("coffee", 1.0)
    clock = FakeClock()
    timer = StepPhaseTimer(registry, clock=clock, flight_every=1)
    timer.start()
    clock.advance(0.25)
    timer.lap("data_wait")
    clock.advance(0.75)
    timer.lap("step_dispatch")
    split = timer.finish(1)
    assert split == {"data_wait": 0.25, "step_dispatch": 0.75, "wall": 1.0}
    assert timer.coverage() == 1.0


# -- input pipeline -----------------------------------------------------------

class _PlaceOnCpu:
    device = torch.device("cpu")

    def place_batch(self, batch):
        return batch


def test_input_pipeline_keeps_order_depth_and_count():
    produced = []

    def source(i):
        produced.append(i)
        return {"x": torch.full((2,), float(i))}

    with InputPipeline(source, _PlaceOnCpu(), depth=2, steps=5) as pipe:
        time.sleep(0.2)
        assert len(produced) <= 2 + 1  # the queue holds depth, one more in hand
        got = [int(batch["x"][0]) for batch in pipe]
    assert got == [0, 1, 2, 3, 4]
    with pytest.raises(StopIteration):
        next(pipe)
    assert pipe.host_seconds >= 0.0
    with pytest.raises(ValueError):
        InputPipeline(source, _PlaceOnCpu(), depth=0)


def test_input_pipeline_passes_the_producer_error_on():
    def source(i):
        if i == 2:
            raise KeyError("bad shard")
        return {"x": torch.zeros(1)}

    pipe = InputPipeline(source, _PlaceOnCpu(), depth=2)
    assert next(pipe) is not None and next(pipe) is not None
    with pytest.raises(KeyError, match="bad shard"):
        next(pipe)
    with pytest.raises(StopIteration):
        next(pipe)
    pipe.close()
    assert not pipe._thread.is_alive()


def test_input_pipeline_close_stops_a_blocked_producer():
    pipe = InputPipeline(lambda i: {"x": torch.zeros(1)}, _PlaceOnCpu(), depth=1)
    time.sleep(0.1)
    pipe.close()
    assert not pipe._thread.is_alive()


def test_input_pipeline_places_through_the_trainer():
    trainer = _tiny_gpt_trainer()
    source = synthetic_source(lambda gen: {"input_ids": torch.randint(0, 9, (2, 4), generator=gen)}, 7)
    with InputPipeline(source, trainer, depth=2, steps=3) as pipe:
        batches = list(pipe)
    assert len(batches) == 3 and all(b["input_ids"].device.type == "cpu" for b in batches)
    assert torch.equal(batches[1]["input_ids"], source(1)["input_ids"])  # a function of (seed, step)
    assert not torch.equal(batches[0]["input_ids"], batches[1]["input_ids"])
    a = torch.randint(0, 1 << 30, (4,), generator=step_generator(7, 1))
    b = torch.randint(0, 1 << 30, (4,), generator=step_generator(8, 1))
    assert not torch.equal(a, b)


def test_shard_source_round_trip(tmp_path):
    arrays = {"image": np.arange(10 * 3, dtype=np.float32).reshape(10, 3),
              "label": np.arange(10, dtype=np.int32)}
    assert write_shards(str(tmp_path), arrays, shard_size=4) == 3
    batches = list(shard_source(str(tmp_path), batch_size=3, shuffle_seed=None, epochs=1))
    assert [b["label"].tolist() for b in batches] == [[0, 1, 2], [3, 4, 5], [6, 7, 8]]
    two = [list(shard_source(str(tmp_path), 2, shuffle_seed=None, epochs=1, process_id=p,
                             num_processes=2)) for p in range(2)]
    assert len(two[0]) == len(two[1])  # every process issues the same number of steps
    trainer = _tiny_gpt_trainer()
    with InputPipeline(shard_source(str(tmp_path), 5, shuffle_seed=0, epochs=1), trainer) as pipe:
        placed = list(pipe)
    assert [tuple(b["image"].shape) for b in placed] == [(5, 3), (5, 3)]


# -- run_steps, profiler, schedule -------------------------------------------

def test_run_steps_on_cpu_is_bit_equal_to_step_calls():
    def make():
        model = torch_resnet.ResNet(**RESNET_SMALL, dtype=torch.float32,
                                    generator=torch.Generator().manual_seed(0))
        return torch_trainer.Trainer(
            model, torch_trainer.classification_task(), optimizer="sgd", device="cpu",
            learning_rate=torch_trainer.warmup_cosine_lr(0.1, 6, 2),
        )

    batch = torch_resnet.synthetic_batch(torch.Generator().manual_seed(1), 4, 32, 10)
    fused = make()
    fstate, fmetrics = fused.run_steps(fused.init(), fused.place_batch(batch), 4)
    loop = make()
    lstate = loop.init()
    for _ in range(4):
        lstate, lmetrics = loop.step(lstate, loop.place_batch(batch))
    assert fstate.step == lstate.step == 4
    assert float(fmetrics["loss"]) == float(lmetrics["loss"])
    _assert_same(_state_tensors(fstate), _state_tensors(lstate))
    with pytest.raises(ValueError):
        fused.run_steps(fstate, batch, 0)


def _sgd_trainer_on_a_device_rate():
    """A CPU trainer whose optimizer has the form Trainer.init builds on
    CUDA for SGD: fused, the learning rate a tensor that steps refill in
    place."""
    model = torch_resnet.ResNet(**RESNET_SMALL, dtype=torch.float32,
                                generator=torch.Generator().manual_seed(0))
    trainer = torch_trainer.Trainer(
        model, torch_trainer.classification_task(), optimizer="sgd", device="cpu",
        learning_rate=torch_trainer.warmup_cosine_lr(0.1, 8, 2),
    )
    state = trainer.init()
    state.optimizer = torch.optim.SGD(
        model.parameters(), lr=torch.tensor(0.0), momentum=torch_trainer.SGD_MOMENTUM,
        fused=True,
    )
    return trainer, state


def test_graph_body_is_the_eager_step_on_a_device_rate():
    """run_steps' captured body, run eagerly on the CPU after one warm-up
    step, with its rate computed from the device counter into the
    optimizer's rate tensor: the same bits as eager steps, whose rate is
    filled from the host schedule, and the rate tensor is never replaced
    (a graph reads it by address)."""
    batch = torch_resnet.synthetic_batch(torch.Generator().manual_seed(1), 4, 32, 10)
    eager, estate = _sgd_trainer_on_a_device_rate()
    rate = estate.optimizer.param_groups[0]["lr"]
    for _ in range(4):
        estate, emetrics = eager.step(estate, batch)
    assert estate.optimizer.param_groups[0]["lr"] is rate
    assert float(rate) == np.float32(eager._lr(3))
    body, bstate = _sgd_trainer_on_a_device_rate()
    bstate, _ = body.step(bstate, batch)
    captured = torch_trainer._CapturedStep(body, batch)
    captured.grads = [(p, p.grad) for p in bstate.model.parameters()]
    captured.prepare(bstate, batch)
    for _ in range(3):
        captured._body(body, bstate)
    bstate.step += 3
    assert float(captured.count) == 4
    assert float(captured.outputs["loss"]) == float(emetrics["loss"])
    _assert_same(_state_tensors(bstate), _state_tensors(estate))


def test_restore_keeps_the_trainers_optimizer_form(tmp_path):
    """A checkpoint from the CUDA form of the optimizer (fused, rate
    tensor) restores into a plain CPU trainer with the trainer's own float
    rate and form, and back again; momentum buffers and steps go through,
    and the rate tensor keeps its identity."""
    batch = torch_resnet.synthetic_batch(torch.Generator().manual_seed(1), 4, 32, 10)
    device_form, dstate = _sgd_trainer_on_a_device_rate()
    dstate, _ = device_form.step(dstate, batch)
    ckpt = torch_trainer.Checkpointer(str(tmp_path / "a"))
    ckpt.save(dstate.step, dstate)
    model = torch_resnet.ResNet(**RESNET_SMALL, dtype=torch.float32,
                                generator=torch.Generator().manual_seed(5))
    plain = torch_trainer.Trainer(model, torch_trainer.classification_task(),
                                  optimizer="sgd", device="cpu", learning_rate=0.1)
    pstate = ckpt.restore_latest(plain.init())
    group = pstate.optimizer.param_groups[0]
    assert pstate.step == 1 and isinstance(group["lr"], float) and not group["fused"]
    _assert_same(_state_tensors(pstate), _state_tensors(dstate))
    pstate, _ = plain.step(pstate, batch)
    back = torch_trainer.Checkpointer(str(tmp_path / "b"))
    back.save(pstate.step, pstate)
    again, astate = _sgd_trainer_on_a_device_rate()
    rate = astate.optimizer.param_groups[0]["lr"]
    astate = back.restore_latest(astate)
    group = astate.optimizer.param_groups[0]
    assert astate.step == 2 and group["lr"] is rate and group["fused"]
    _assert_same(_state_tensors(astate), _state_tensors(pstate))


@pytest.mark.parametrize("warmup", [0, 3])
def test_warmup_cosine_on_device_matches_the_host_schedule(warmup):
    schedule = torch_trainer.warmup_cosine_lr(1e-3, 10, warmup)
    if not warmup:
        assert schedule == 1e-3
        return
    for count in range(14):
        device = schedule.on_device(torch.tensor(float(count), dtype=torch.float64))
        assert abs(float(device) - schedule(count)) <= 1e-18


def test_step_profiler_writes_a_trace_only_in_its_window(tmp_path):
    profiler = StepProfiler(str(tmp_path), total_steps=6, window=(2, 4))
    for i in range(6):
        profiler.before_step(i)
        torch.ones(8).sum()
        if i < 3:
            assert os.listdir(tmp_path) == []
        profiler.after_step(i, drain=lambda: None)
        assert profiler.active == (i in (2,))
    profiler.close()
    assert os.listdir(tmp_path) == ["steps_2_4.pt.trace.json"]
    with open(tmp_path / "steps_2_4.pt.trace.json") as fh:
        assert "traceEvents" in json.load(fh)
    # an exception inside the window still writes the trace
    other = StepProfiler(str(tmp_path / "b"), total_steps=3, window=(0, 3))
    with pytest.raises(RuntimeError):
        try:
            other.before_step(0)
            raise RuntimeError("step failed")
        finally:
            other.close()
    assert os.listdir(tmp_path / "b") == ["steps_0_3.pt.trace.json"]
    assert StepProfiler(None, 5).start_step == -1


# -- the CLIs and the Evaluator -----------------------------------------------

GPT_ARGS = ["--preset", "tiny", "--steps", "6", "--batch-size", "4", "--seq-len", "128",
            "--accum-steps", "2", "--device", "cpu", "--log-every", "1"]


def test_gpt_cli_sigterm_exits_143_then_resumes_to_the_budget(tmp_path):
    """The acceptance run: a real SIGTERM after step 3 ends the process
    with 143 and a checkpoint at step 3; the same command again resumes at
    3 and exits 0 at step 6."""
    ckpt = str(tmp_path / "ckpt")
    args = GPT_ARGS + ["--checkpoint-dir", ckpt]
    env = dict(os.environ, PYTHONPATH=REPO)
    code = (
        "import os, signal, sys\n"
        "from tf_operator_tpu_torch.train import gpt\n"
        f"sys.exit(gpt.main({args!r}, on_step=lambda s: s.step == 3 and "
        "os.kill(os.getpid(), signal.SIGTERM)))\n"
    )
    first = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                           capture_output=True, text=True, timeout=300)
    assert first.returncode == 143, first.stderr[-2000:]
    assert sorted(os.listdir(ckpt)) == ["3"]
    second = subprocess.run([sys.executable, "-m", "tf_operator_tpu_torch.train.gpt", *args],
                            cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert second.returncode == 0, second.stderr[-2000:]
    assert "resumed from step 3" in second.stderr
    assert "step 6 loss=" in second.stderr and "step 7" not in second.stderr
    assert sorted(os.listdir(ckpt), key=int) == ["3", "6"]


def test_gpt_cli_preemption_in_process(tmp_path):
    ckpt = str(tmp_path / "ckpt")
    args = gpt_cli.parse_args(GPT_ARGS + ["--checkpoint-dir", ckpt])
    summary, state = gpt_cli.train(
        args, on_step=lambda s: s.step == 3 and os.kill(os.getpid(), signal.SIGTERM))
    assert summary["exit_code"] == 143 and summary["preempted"] == 1.0 and state.step == 3
    assert summary["forward_passes"] == summary["backward_passes"] == 3 * 2  # no eval
    summary, state = gpt_cli.train(args)
    assert (summary["start_step"], summary["step"], summary["exit_code"]) == (3, 6, 0)
    assert summary["steps"] == 2 and "eval_loss" in summary


@pytest.mark.parametrize("cli,argv", [
    (bert_cli, ["--preset", "tiny", "--steps", "3", "--batch-size", "4", "--seq-len", "32",
                "--flash", "--packed"]),
    (resnet_cli, ["--small", "--steps", "3", "--per-chip-batch", "4", "--image-size", "32",
                  "--conv3-impl", "pallas"]),
])
def test_cli_lifecycle_flags_on_cpu(tmp_path, cli, argv):
    before = dict(kernels.LAUNCHES)
    args = cli.parse_args(argv + [
        "--device", "cpu", "--accum-steps", "2", "--checkpoint-dir", str(tmp_path / "ck"),
        "--profile-dir", str(tmp_path / "prof"),
    ])
    summary = cli.run(args)
    assert summary["exit_code"] == 0 and summary["step"] == 3
    assert summary["backward_passes"] == 2 * 3  # microbatches
    assert os.listdir(tmp_path / "ck") == ["3"]
    assert os.listdir(tmp_path / "prof") == ["steps_0_2.pt.trace.json"]
    assert kernels.LAUNCHES == before  # CPU tensors never reach a kernel
    again = cli.run(args)  # resumes at 3: the warm-up step only
    assert again["step"] == 4 and again["steps"] == 0


def test_cli_flags_parse():
    args = gpt_cli.parse_args(["--checkpoint-dir", "d", "--accum-steps", "4"])
    assert (args.checkpoint_dir, args.accum_steps) == ("d", 4)
    for cli in (gpt_cli, bert_cli, resnet_cli):  # the telemetry server is ported
        args = cli.parse_args(["--monitoring-bind-addr", "0.0.0.0:9090"])
        assert args.monitoring_bind_addr == "0.0.0.0:9090"
    assert bert_cli.parse_args(["--profile-dir", "p"]).profile_dir == "p"
    assert resnet_cli.parse_args(["--profile-dir", "p"]).profile_dir == "p"


def test_evaluator_evaluates_the_newest_checkpoint_and_exits(tmp_path):
    ckpt = tmp_path / "ckpt"
    trainer = _tiny_gpt_trainer(ckpt)
    state = trainer.init()
    batch = trainer.place_batch(_gpt_batch(b=2, s=64))
    for _ in range(3):
        state, _ = trainer.step(state, batch)
        trainer.save(state)
    out = tmp_path / "eval.jsonl"
    rc = eval_loop.main([
        "--task", "gpt", "--preset", "tiny", "--seq-len", "64", "--batch-size", "2",
        "--checkpoint-dir", str(ckpt), "--out", str(out), "--until-step", "3",
        "--poll-seconds", "0.01", "--device", "cpu",
    ])
    assert rc == 0
    lines = [json.loads(line) for line in out.read_text().splitlines()]
    assert [line["step"] for line in lines] == [3]  # the newest, then done
    assert np.isfinite(lines[0]["loss"]) and lines[0]["perplexity"] > 1
    # nothing newer to evaluate: gives up after --max-polls
    rc = eval_loop.main([
        "--task", "gpt", "--preset", "tiny", "--seq-len", "64", "--batch-size", "2",
        "--checkpoint-dir", str(tmp_path / "empty"), "--max-polls", "2",
        "--poll-seconds", "0.01", "--device", "cpu",
    ])
    assert rc == 1


# -- on the card --------------------------------------------------------------

@pytest.mark.cuda
def test_cuda_run_steps_is_a_graph_that_matches_eager_steps():
    """BERT_TINY at head_dim 64 through K1-K3: run_steps(n=4) with a
    warm-up-cosine schedule captures one step and replays it; the kernels
    launch once per layer per replay, and the state lands on the bits of 4
    eager steps (the graph's update runs the eager optimizer's kernels on
    the same scalars)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from tf_operator_tpu_torch.ops.flash_attention import flash_attention

    cfg = dataclasses.replace(torch_bert.BERT_TINY, num_heads=2)  # head_dim 64
    batch = torch_bert.synthetic_batch(torch.Generator().manual_seed(0), 4, 128, cfg)

    def make():
        model = torch_bert.BertForMLM(cfg, attention_fn=flash_attention,
                                      generator=torch.Generator().manual_seed(1))
        return torch_trainer.Trainer(
            model, torch_trainer.mlm_task(), weight_decay=0.01, packed=True,
            device="cuda", learning_rate=torch_trainer.warmup_cosine_lr(1e-3, 8, 2),
        )

    eager = make()
    estate = eager.init()
    placed = eager.place_batch(batch)
    for _ in range(4):
        estate, emetrics = eager.step(estate, placed)
    graph = make()
    gstate, gmetrics = graph.run_steps(graph.init(), placed, 4)
    captured = graph.last_graph
    assert gstate.step == 4 and captured.replays == 3
    assert {k: v for k, v in captured.launches.items() if v} == {
        "flash_fwd": cfg.num_layers, "flash_bwd_dkv": cfg.num_layers,
        "flash_bwd_dq": cfg.num_layers}
    assert float(gmetrics["loss"]) == float(emetrics["loss"])
    _assert_same(_state_tensors(gstate), _state_tensors(estate))
    gstate, _ = graph.run_steps(gstate, placed, 2)
    assert gstate.step == 6 and captured.replays == 5 and graph.last_graph is captured


@pytest.mark.cuda
def test_cuda_input_pipeline_copies_on_a_side_stream():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    trainer = torch_trainer.Trainer(torch.nn.Linear(2, 2), None, device="cuda")
    source = synthetic_source(lambda gen: {"x": torch.randn((256, 1024), generator=gen)}, 3)
    with InputPipeline(source, trainer, depth=2, steps=4) as pipe:
        assert pipe._stream is not None and pipe._stream != torch.cuda.current_stream()
        got = [batch["x"] for batch in pipe]
    assert all(t.is_cuda for t in got)
    for i, t in enumerate(got):
        assert torch.equal(t.cpu(), source(i)["x"])
