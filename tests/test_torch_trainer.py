"""The port's trainer core (tf_operator_tpu_torch/train/) held against the
JAX package's, plus the port's isolation from JAX.

- One AdamW step of BERT_TINY in f32 from the same weights and numpy
  batch: loss 1e-5 and updated parameters 1e-5 absolute (1% of the
  first AdamW step, which moves a weight by lr * g / (|g| + eps), about
  lr = 1e-3). Where |g| is within a few hundred eps of zero that ratio
  is set by f32 rounding noise, not by the math: the attention key
  bias, whose exact gradient is zero (it shifts every score of a row by
  q.b, which the softmax ignores), and the odd weight of another
  tensor. Those weights (|g| <= 1e-6; at least 99% of the weights with
  a nonzero gradient lie above it) are held to moving at most
  lr * (1 + 1e-3) + lr * wd * |w|.
  At the bench's weight decay of 0.01 the decay term lr * wd * |w| is at
  most 1e-5 (a LayerNorm scale of 1), within that tolerance, so the step
  is also taken at wd 0.5, where the decay moves weights by up to 5e-4
  and a dropped or mis-scaled decay cannot pass.
- The port imports with jax, flax, optax, orbax and tf_operator_tpu
  blocked, and no module of it or chip_smoke.py imports them.
"""

import ast
import dataclasses
import functools
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tf_operator_tpu.models import bert as jax_bert
from tf_operator_tpu.parallel.mesh import single_device_mesh
from tf_operator_tpu.train import trainer as jax_trainer
from tf_operator_tpu_torch._device import resolve_device
from tf_operator_tpu_torch.models import bert as torch_bert
from tf_operator_tpu_torch.models.convert import bert_state_dict_from_flax
from tf_operator_tpu_torch.ops import kernels
from tf_operator_tpu_torch.train import bert as torch_bert_cli
from tf_operator_tpu_torch.train import trainer as torch_trainer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "tf_operator_tpu_torch")
LR = 1e-3
ATOL = 1e-5
GRAD_NOISE = 1e-6
BLOCKED = ("jax", "flax", "optax", "orbax", "tf_operator_tpu")


def _numpy_batch(cfg, b=2, s=64, seed=0):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
    mask = np.ones((b, s), np.int32)
    mask[1, s - 20:] = 0
    weights = ((rng.random((b, s)) < 0.3) & (mask > 0)).astype(np.float32)
    return {"input_ids": ids, "labels": ids, "mlm_weights": weights,
            "attention_mask": mask}


def _torch_batch(batch):
    out = {k: torch.tensor(v) for k, v in batch.items()}
    out["input_ids"] = out["input_ids"].long()
    out["labels"] = out["labels"].long()
    return out


def _np_tree(tree):
    return jax.tree_util.tree_map(lambda x: np.array(x), tree)


@functools.lru_cache(maxsize=None)
def _jax_step(weight_decay):
    """Weights before and after one JAX Trainer.step, and its loss."""
    cfg = dataclasses.replace(jax_bert.BERT_TINY, dtype=jnp.float32)
    model = jax_bert.BertForMLM(cfg)
    trainer = jax_trainer.Trainer(
        model, jax_trainer.mlm_task(model),
        optax.adamw(LR, weight_decay=weight_decay), mesh=single_device_mesh(),
    )
    batch = _numpy_batch(cfg)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    state = trainer.init(jax.random.PRNGKey(0), jbatch)
    before = _np_tree(state.params)
    ev = trainer.evaluate(state, trainer.place_batch(jbatch))
    eval_loss = float(ev["loss"])
    state, metrics = trainer.step(state, trainer.place_batch(jbatch))
    return {
        "batch": batch, "before": before, "after": _np_tree(state.params),
        "loss": float(metrics["loss"]), "eval_loss": eval_loss,
    }


@pytest.fixture(scope="module")
def jax_run():
    return _jax_step(0.01)


def _port_trainer(before, packed=False, attention_fn=None, weight_decay=0.01):
    cfg = dataclasses.replace(torch_bert.BERT_TINY, dtype=torch.float32)
    model = torch_bert.BertForMLM(cfg, attention_fn=attention_fn)
    model.load_state_dict(bert_state_dict_from_flax(before))
    trainer = torch_trainer.Trainer(
        model, torch_trainer.mlm_task(model), learning_rate=LR,
        weight_decay=weight_decay, packed=packed, device="cpu",
    )
    return trainer, trainer.init()


@pytest.mark.parametrize("weight_decay", [0.01, 0.5])
def test_one_step_matches_jax(weight_decay):
    jax_run = _jax_step(weight_decay)
    trainer, state = _port_trainer(jax_run["before"], weight_decay=weight_decay)
    batch = trainer.place_batch(_torch_batch(jax_run["batch"]))
    state, metrics = trainer.step(state, batch)
    assert state.step == 1
    np.testing.assert_allclose(float(metrics["loss"]), jax_run["loss"], atol=ATOL)
    want = bert_state_dict_from_flax(jax_run["after"])
    before = bert_state_dict_from_flax(jax_run["before"])
    got = dict(state.model.named_parameters())
    assert set(got) == set(want)
    strict = nonzero = 0
    for name, w in want.items():
        p = got[name].detach()
        g = got[name].grad
        noise = g.abs() <= GRAD_NOISE
        strict += int((~noise).sum())
        nonzero += int((g != 0).sum())
        np.testing.assert_allclose(
            p[~noise].numpy(), w[~noise].numpy(), atol=ATOL, err_msg=name
        )
        moved = (p[noise] - before[name][noise]).abs()
        limit = LR * (1 + 1e-3) + LR * weight_decay * before[name][noise].abs()
        assert bool((moved <= limit).all()), name
    assert strict >= 0.99 * nonzero


def test_evaluate_matches_jax(jax_run):
    trainer, state = _port_trainer(jax_run["before"])
    metrics = trainer.evaluate(state, trainer.place_batch(_torch_batch(jax_run["batch"])))
    np.testing.assert_allclose(float(metrics["loss"]), jax_run["eval_loss"], atol=ATOL)
    assert state.step == 0
    assert all(p.grad is None for p in state.model.parameters())


def test_packed_drops_the_mask(jax_run):
    """packed: place_batch drops attention_mask, as the JAX trainer's
    _prepare_batch does, so the flash route runs with no mask."""
    batch = _torch_batch(jax_run["batch"])
    jt = jax_trainer.Trainer.__new__(jax_trainer.Trainer)
    jt.packed, jt.shard_sequence = True, False
    assert set(jt._prepare_batch(jax_run["batch"])) == {"input_ids", "labels", "mlm_weights"}
    seen = []

    def recording_attention(q, k, v, mask=None):
        seen.append(mask)
        from tf_operator_tpu_torch.ops.flash_attention import flash_attention

        return flash_attention(q, k, v, mask)

    trainer, state = _port_trainer(jax_run["before"], packed=True,
                                   attention_fn=recording_attention)
    placed = trainer.place_batch(batch)
    assert set(placed) == {"input_ids", "labels", "mlm_weights"}
    trainer.step(state, placed)
    assert seen and all(m is None for m in seen)
    unpacked, ustate = _port_trainer(jax_run["before"], attention_fn=recording_attention)
    seen.clear()
    unpacked.step(ustate, unpacked.place_batch(batch))
    assert seen and all(m is not None and m.shape == (2, 1, 1, 64) for m in seen)


@pytest.mark.parametrize("warmup", [0, 3])
def test_warmup_cosine_lr_matches_optax(warmup):
    port = torch_trainer.warmup_cosine_lr(1e-3, 10, warmup)
    ref = jax_trainer.warmup_cosine_lr(1e-3, 10, warmup)
    for count in range(14):
        want = float(ref(count)) if callable(ref) else ref
        got = port(count) if callable(port) else port
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-12)


@pytest.mark.parametrize("extra", [[], ["--flash", "--packed", "--warmup-steps", "1"]])
def test_cli_main_runs_on_cpu(extra):
    before = dict(kernels.LAUNCHES)
    rc = torch_bert_cli.main([
        "--preset", "tiny", "--steps", "2", "--batch-size", "2",
        "--seq-len", "32", "--device", "cpu", *extra,
    ])
    assert rc == 0
    assert kernels.LAUNCHES == before  # CPU tensors never reach a kernel


def test_cli_run_summary():
    summary = torch_bert_cli.run(torch_bert_cli.parse_args([
        "--preset", "tiny", "--steps", "1", "--batch-size", "2",
        "--seq-len", "16", "--device", "cpu", "--flash",
    ]))
    assert np.isfinite(summary["loss"]) and np.isfinite(summary["eval_loss"])
    assert summary["forward_passes"] == 3 and summary["backward_passes"] == 2


def test_device_defaults_to_cuda_and_raises_without_it():
    assert resolve_device("cpu") == torch.device("cpu")
    if torch.cuda.is_available():
        assert resolve_device(None).type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            resolve_device(None)


def _port_modules():
    names = []
    for root, _, files in os.walk(PORT):
        for f in sorted(files):
            if f.endswith(".py"):
                rel = os.path.relpath(os.path.join(root, f), REPO)[:-3]
                name = rel.replace(os.sep, ".")
                names.append(name[: -len(".__init__")] if name.endswith(".__init__") else name)
    return sorted(names)


def test_port_imports_with_jax_blocked():
    modules = _port_modules()
    assert "tf_operator_tpu_torch.ops.flash_attention" in modules
    code = (
        "import sys\n"
        f"for name in {BLOCKED!r}:\n"
        "    sys.modules[name] = None\n"
        "import importlib\n"
        f"for mod in {modules!r}:\n"
        "    importlib.import_module(mod)\n"
        "print('ok', len(sys.modules))\n"
    )
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
        timeout=120,
    )
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.startswith("ok")


def test_no_module_of_the_port_imports_jax():
    paths = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, files in os.walk(PORT):
        paths += [os.path.join(root, f) for f in files if f.endswith(".py")]
    offenders = []
    for path in paths:
        with open(path) as fh:
            tree = ast.parse(fh.read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                tops = [alias.name.split(".")[0] for alias in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
                tops = [node.module.split(".")[0]]
            else:
                continue
            offenders += [f"{path}:{node.lineno} {t}" for t in tops if t in BLOCKED]
    assert len(paths) > 10
    assert offenders == []
