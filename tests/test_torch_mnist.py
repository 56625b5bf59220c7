"""The port's dist-MNIST (tf_operator_tpu_torch/models/mnist.py,
train/mnist.py, train/summaries.py) held against the JAX package's on the
CPU, in f32, on the same weights (the flax params carried across with
models/convert.py) and the same numpy images.

Tolerances: logits 1e-5 absolute and gradients 1e-4, as
tests/test_torch_bert.py justifies them (two frameworks summing the same
products in other orders; here through two 5x5 convolutions and a
3136-wide Dense). The reference flattens NHWC activations before Dense_0;
a port that flattened NCHW would feed Dense_0 its features in another
order, and the logits would move by far more than the tolerance, which
one test shows on the same weights.
"""

import json
import os
import signal

import numpy as np
import pytest
import torch
import torch.nn.functional as F

try:
    import jax
    import jax.numpy as jnp
    import optax

    from tf_operator_tpu.models import mnist as jax_mnist
except ImportError:  # a card machine without JAX
    jax = None

from tf_operator_tpu_torch.models import mnist as torch_mnist
from tf_operator_tpu_torch.models.convert import mnist_state_dict_from_flax
from tf_operator_tpu_torch.train import eval_loop
from tf_operator_tpu_torch.train import mnist as mnist_cli
from tf_operator_tpu_torch.train.summaries import maybe_writer

LOGIT_ATOL = 1e-5
GRAD_ATOL = 1e-4
needs_jax = pytest.mark.skipif(jax is None, reason="needs the JAX reference")


def _numpy_batch(n=6, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((n, 28, 28, 1)).astype(np.float32),
            rng.integers(0, 10, (n,)).astype(np.int32))


@pytest.fixture(scope="module")
def flax_run():
    images, labels = _numpy_batch()
    model = jax_mnist.MnistCNN()
    params = model.init(jax.random.PRNGKey(0), jnp.asarray(images))["params"]

    def loss_fn(p):
        logits = model.apply({"params": p}, jnp.asarray(images))
        onehot = jax.nn.one_hot(jnp.asarray(labels), 10)
        return optax.softmax_cross_entropy(logits, onehot).mean(), logits

    (loss, logits), grads = jax.value_and_grad(loss_fn, has_aux=True)(params)
    tree = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    return {"images": images, "labels": labels, "params": tree(params),
            "logits": np.asarray(logits), "loss": float(loss), "grads": tree(grads)}


def _port_model(params):
    model = torch_mnist.MnistCNN()
    model.load_state_dict(mnist_state_dict_from_flax(params))
    return model


@needs_jax
def test_logits_match_flax(flax_run):
    model = _port_model(flax_run["params"])
    logits = model(torch.tensor(flax_run["images"])).detach().numpy()
    assert logits.dtype == np.float32 and logits.shape == (6, 10)
    np.testing.assert_allclose(logits, flax_run["logits"], atol=LOGIT_ATOL)


@needs_jax
def test_gradients_match_flax(flax_run):
    model = _port_model(flax_run["params"])
    logits = model(torch.tensor(flax_run["images"]))
    loss = F.cross_entropy(logits, torch.tensor(flax_run["labels"]).long())
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), flax_run["loss"], atol=LOGIT_ATOL)
    want = mnist_state_dict_from_flax(flax_run["grads"])
    got = dict(model.named_parameters())
    assert set(got) == set(want)
    for name, grad in want.items():
        np.testing.assert_allclose(got[name].grad.numpy(), grad.numpy(), atol=GRAD_ATOL,
                                   err_msg=name)


@needs_jax
def test_an_nchw_flatten_would_break_parity(flax_run):
    """The same converted weights with the activations flattened NCHW
    before Dense_0: far outside the logits' tolerance."""
    model = _port_model(flax_run["params"])
    x = torch.tensor(flax_run["images"]).permute(0, 3, 1, 2)
    x = F.max_pool2d(torch.relu(model.Conv_0(x)), 2)
    x = F.max_pool2d(torch.relu(model.Conv_1(x)), 2)
    x = torch.relu(model.Dense_0(x.reshape(x.shape[0], -1)))
    wrong = model.Dense_1(x).detach().numpy()
    assert np.abs(wrong - flax_run["logits"]).max() > 1000 * LOGIT_ATOL


@needs_jax
def test_converter_maps_every_param(flax_run):
    state = mnist_state_dict_from_flax(flax_run["params"])
    assert set(state) == set(torch_mnist.MnistCNN().state_dict())
    assert tuple(state["Conv_1.weight"].shape) == (64, 32, 5, 5)
    assert tuple(state["Dense_0.weight"].shape) == (1024, 3136)
    with pytest.raises(KeyError):
        mnist_state_dict_from_flax({"Conv_9": {"kernel": np.zeros((1, 1, 1, 1))}})


def test_synthetic_batch_is_rolled_prototypes_plus_noise():
    a = torch_mnist.synthetic_batch(torch.Generator().manual_seed(3), 64)
    b = torch_mnist.synthetic_batch(torch.Generator().manual_seed(3), 64)
    assert torch.equal(a["image"], b["image"]) and torch.equal(a["label"], b["label"])
    assert a["image"].shape == (64, 28, 28, 1) and a["image"].dtype == torch.float32
    assert int(a["label"].min()) >= 0 and int(a["label"].max()) <= 9
    prototypes = torch_mnist._digit_prototypes()
    assert prototypes.shape == (10, 28, 28, 1)
    # each image is its class prototype at some shift in [-3, 3], plus noise
    for image, label in zip(a["image"][:8], a["label"][:8]):
        errors = [
            (image - torch.roll(prototypes[label], (dy, dx), dims=(0, 1))).std().item()
            for dy in range(-3, 4) for dx in range(-3, 4)
        ]
        assert abs(min(errors) - 0.3) < 0.05


def test_mnist_cli_trains_writes_summaries_and_artifact(tmp_path):
    acc = tmp_path / "acc.json"
    rc = mnist_cli.main([
        "--steps", "30", "--batch-size", "32", "--log-every", "1", "--device", "cpu",
        "--summary-dir", str(tmp_path / "s"), "--acc-json", str(acc),
        "--checkpoint-dir", str(tmp_path / "ck"),
    ])
    assert rc == 0
    lines = [json.loads(line) for line in (tmp_path / "s" / "metrics.jsonl").read_text().splitlines()]
    assert [line["step"] for line in lines] == list(range(1, 31))
    assert np.mean([line["loss"] for line in lines[-5:]]) < 0.5 * lines[0]["loss"]
    artifact = json.loads(acc.read_text())
    assert artifact["eval_samples"] == 4096 and artifact["steps"] == 30
    assert artifact["platform"] == "cpu" and 0.0 <= artifact["eval_accuracy"] <= 1.0
    assert sorted(os.listdir(tmp_path / "ck"), key=int) == ["30"]


def test_mnist_cli_gates_on_target_accuracy(tmp_path):
    assert mnist_cli.main(["--steps", "1", "--batch-size", "8", "--device", "cpu",
                           "--target-accuracy", "1.01"]) == 1


def test_mnist_cli_exits_143_on_sigterm_and_resumes(tmp_path, monkeypatch):
    ckpt = str(tmp_path / "ck")
    draws = []
    real = torch_mnist.synthetic_batch

    def counting(generator, batch_size, noise=0.3):
        draws.append(batch_size)
        if len(draws) == 3:
            os.kill(os.getpid(), signal.SIGTERM)  # latched during step 3
        return real(generator, batch_size, noise)

    monkeypatch.setattr(torch_mnist, "synthetic_batch", counting)
    argv = ["--steps", "8", "--batch-size", "8", "--device", "cpu", "--checkpoint-dir", ckpt]
    assert mnist_cli.main(argv) == 143
    assert os.listdir(ckpt) == ["3"]
    monkeypatch.setattr(torch_mnist, "synthetic_batch", real)
    assert mnist_cli.main(argv) == 0
    assert sorted(os.listdir(ckpt), key=int) == ["3", "8"]


def test_evaluator_reads_the_mnist_checkpoints(tmp_path):
    ckpt = str(tmp_path / "ckpt")
    assert mnist_cli.main(["--steps", "6", "--batch-size", "16", "--device", "cpu",
                           "--checkpoint-dir", ckpt, "--log-every", "3"]) == 0
    out = tmp_path / "eval.jsonl"
    rc = eval_loop.main([
        "--task", "mnist", "--checkpoint-dir", ckpt, "--batch-size", "64", "--out", str(out),
        "--until-step", "1", "--poll-seconds", "0.01", "--max-polls", "5", "--device", "cpu",
    ])
    assert rc == 0
    rows = [json.loads(line) for line in out.read_text().splitlines()]
    assert rows[-1]["step"] == 6 and 0.0 <= rows[-1]["accuracy"] <= 1.0
    assert "perplexity" in rows[-1]


def test_disabled_summary_writer_writes_nothing(tmp_path):
    target = tmp_path / "nothing"
    with maybe_writer(str(target), process_id=1) as writer:
        writer.scalars(1, {"loss": 1.0})
    assert not target.exists()
    with maybe_writer(str(tmp_path / "logs")) as writer:
        writer.scalars(10, {"loss": 0.5})
    line = json.loads((tmp_path / "logs" / "metrics.jsonl").read_text())
    assert line["step"] == 10 and line["loss"] == 0.5
