"""The port's MoE family (tf_operator_tpu_torch/models/moe.py, moe_task,
train/moe.py) held against the JAX package's on the CPU, in f32, on the
same weights (the flax params carried across with models/convert.py) and
the same numpy tokens.

Tolerances: logits and loss 1e-5 absolute and gradients 1e-4, as
tests/test_torch_bert.py justifies them; the router losses (scalars of
order 1e-2 built from means of softmax outputs) 1e-6. Routing decisions
are discrete: dispatch masks must be equal, combine weights (gate
probabilities) within 1e-6. Greedy chains are held equal only after each
decision's top-2 margin is checked far above f32 noise.

One AdamW step with bf16 expert kernels is held against optax on the
same gradients: both keep the experts' moments in bf16 and round the
updated parameter to bf16, where a value half an ulp from a rounding
boundary may land on either side (optax forms the update in f32, torch
in bf16), so each expert parameter must land within one bf16 ulp (of
the larger of the two values) of optax's, plus two bf16 ulps of an
lr-sized update (2 x lr x 2^-7) where the update's own rounding shows
near zero, and most of them on it exactly; the f32 parameters within
1e-6.
"""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

try:
    import jax
    import jax.numpy as jnp
    import optax

    from tf_operator_tpu.models import moe as jax_moe
    from tf_operator_tpu.train import trainer as jax_trainer
except ImportError:  # a card machine without JAX
    jax = None

from tf_operator_tpu_torch.models import moe as torch_moe
from tf_operator_tpu_torch.models.convert import moe_state_dict_from_flax
from tf_operator_tpu_torch.train import moe as torch_moe_cli
from tf_operator_tpu_torch.train import trainer as torch_trainer
from torch_threads import one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT_ATOL = 1e-5
AUX_ATOL = 1e-6
GRAD_ATOL = 1e-4
GATE_ATOL = 1e-6
MIN_MARGIN = 1e-4
LR = 1e-3
WD = 0.01
BF16_EPS = 2.0**-7  # a bf16 ulp at 1
# MOE_TINY, and a variant with the z-loss on
VARIANTS = {"tiny": {}, "zloss": dict(router_z_weight=0.01)}


@pytest.fixture(scope="module")
def needs_jax():
    if jax is None:
        pytest.skip("JAX is not installed")


def _configs(**changes):
    jcfg = dataclasses.replace(jax_moe.MOE_TINY, **changes)
    tcfg = dataclasses.replace(torch_moe.MOE_TINY, **changes)
    return jcfg, tcfg


def _batch(cfg, b=2, s=32, seed=0):
    """Tokens, and a mask that pads row 1 from position 20."""
    ids = np.random.default_rng(seed).integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
    mask = np.ones((b, s), np.int32)
    mask[1, 20:] = 0
    return {"input_ids": ids, "labels": ids, "attention_mask": mask}


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _params(jcfg, seed=0):
    ids = jnp.zeros((1, 8), jnp.int32)
    init = jax.jit(jax_moe.MoELM(jcfg).init)
    return _np_tree(init(jax.random.PRNGKey(seed), ids)["params"])


def _port(tcfg, params):
    model = torch_moe.MoELM(tcfg)
    model.load_state_dict(moe_state_dict_from_flax(params))
    return model


def _torch_batch(batch):
    return {k: torch.tensor(v).long() if k != "attention_mask" else torch.tensor(v)
            for k, v in batch.items()}


@pytest.mark.usefixtures("needs_jax")
@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_moe_task_matches_jax(variant):
    """moe_task on a padded batch: logits, loss (lm + router losses),
    router_aux, router_z, loss_weight and every gradient; the eval loss
    is the LM loss alone."""
    jcfg, tcfg = _configs(**VARIANTS[variant])
    batch = _batch(jcfg)
    jmodel = jax_moe.MoELM(jcfg)
    params = _params(jcfg)
    jtask = jax_trainer.moe_task(jmodel)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}

    def jloss(p):
        return jtask.loss_fn({"params": p}, jbatch, True)

    (jl, jaux), jgrads = jax.jit(jax.value_and_grad(jloss, has_aux=True))(params)
    jlogits, _ = jax.jit(lambda p: jmodel.apply(
        {"params": p}, jbatch["input_ids"], jbatch["attention_mask"], mutable=["losses"]))(params)
    jeval, _ = jax.jit(lambda p: jtask.loss_fn({"params": p}, jbatch, False))(params)

    model = _port(tcfg, params)
    tbatch = _torch_batch(batch)
    task = torch_trainer.moe_task()
    loss, aux = task.loss_fn(model, tbatch, train=True)
    loss.backward()
    logits, losses = model(tbatch["input_ids"], tbatch["attention_mask"])
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(jlogits), atol=OUT_ATOL)
    np.testing.assert_allclose(loss.item(), float(jl), atol=OUT_ATOL)
    for name in ("router_aux", "router_z"):
        np.testing.assert_allclose(aux[name].item(), float(jaux[name]), atol=AUX_ATOL,
                                   err_msg=name)
    assert aux["loss_weight"].item() == float(jaux["loss_weight"]) == 31 + 19
    assert len(losses["router_aux"]) == tcfg.num_layers  # moe_every 1
    assert ("router_z" in losses) == (tcfg.router_z_weight > 0)
    want = moe_state_dict_from_flax(_np_tree(jgrads))
    got = dict(model.named_parameters())
    assert set(want) == set(got)
    for name, grad in want.items():
        np.testing.assert_allclose(got[name].grad.numpy(), grad.numpy(), atol=GRAD_ATOL,
                                   err_msg=name)
    with torch.no_grad():
        eval_loss, _ = task.loss_fn(model, tbatch, train=False)
    np.testing.assert_allclose(eval_loss.item(), float(jeval), atol=OUT_ATOL)
    lm = torch_moe.lm_loss(logits, tbatch["labels"], tbatch["attention_mask"])
    assert abs(eval_loss.item() - lm.item()) < 1e-6 and loss.item() > lm.item()


@pytest.mark.usefixtures("needs_jax")
@pytest.mark.parametrize("capacity_factor", [1.25, 0.5])
def test_router_masks_match_jax(capacity_factor):
    """The router alone on [4 groups, 32 tokens]: dispatch equal, combine
    within GATE_ATOL, the sown aux equal. At capacity factor 0.5 tokens
    drop, and they are the reference's: whole rounds claim in order, so
    some token's second choice drops while a later token's first choice
    is kept."""
    jcfg, tcfg = _configs(capacity_factor=capacity_factor)
    x = np.random.default_rng(1).standard_normal((4, 32, jcfg.hidden_size)).astype(np.float32)
    router = jax_moe.TopKRouter(jcfg)
    variables = router.init(jax.random.PRNGKey(2), jnp.asarray(x))
    (jd, jc), sown = router.apply(variables, jnp.asarray(x), mutable=["losses"])
    port = torch_moe.TopKRouter(tcfg)
    kernel = np.asarray(variables["params"]["router"]["kernel"])
    port.router.weight.data = torch.tensor(kernel.T.copy())
    with torch.no_grad():
        dispatch, combine, losses = port(torch.tensor(x))
    np.testing.assert_array_equal(dispatch.numpy(), np.asarray(jd))
    np.testing.assert_allclose(combine.numpy(), np.asarray(jc), atol=GATE_ATOL)
    np.testing.assert_allclose(losses["router_aux"].item(),
                               float(sown["losses"]["router_aux"][0]), atol=AUX_ATOL)
    kept = dispatch.sum(dim=(2, 3))  # [g, t]: slots each token holds
    k = tcfg.experts_per_token
    if capacity_factor >= 1.25:
        assert int(kept.sum()) >= 0.9 * 4 * 32 * k
        return
    capacity = torch_moe.expert_capacity(tcfg, 32)
    assert capacity == 8 and int(kept.sum()) < 4 * 32 * k
    # a token that lost its second slot while a later token kept its first
    per_slot = dispatch.sum(dim=3)  # [g, t, e]
    logits = torch.tensor(x) @ port.router.weight.T
    order = logits.argsort(dim=-1, descending=True)
    first = per_slot.gather(2, order[..., :1])[..., 0]
    second = per_slot.gather(2, order[..., 1:2])[..., 0]
    found = False
    for g in range(4):
        for t in range(32):
            if second[g, t] == 0 and first[g, t + 1:].sum() > 0:
                found = True
    assert found


@pytest.mark.usefixtures("needs_jax")
def test_adamw_step_with_bf16_experts_matches_optax():
    """MOE_TINY with bf16 experts (the MOE_BASE layout): the port's
    Trainer.init optimizer keeps the experts' moments in bf16, and one
    step on the reference's gradients lands where optax.adamw's does."""
    jcfg, tcfg = _configs(dtype=jnp.bfloat16)
    tcfg = dataclasses.replace(tcfg, dtype=torch.bfloat16)
    params = _params(jcfg)
    assert params["layer_0"]["moe_mlp"]["expert_in"].dtype.name == "bfloat16"
    batch = _batch(jcfg)
    jmodel = jax_moe.MoELM(jcfg)
    jtask = jax_trainer.moe_task(jmodel)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    grads = jax.jit(jax.grad(lambda p: jtask.loss_fn({"params": p}, jbatch, True)[0]))(params)
    opt = optax.adamw(LR, weight_decay=WD)
    updates, _ = opt.update(grads, opt.init(params), params)
    after = _np_tree(optax.apply_updates(params, updates))

    model = _port(tcfg, params)
    assert model.layer_0.moe_mlp.expert_in.dtype == torch.bfloat16
    assert model.layer_0.moe_mlp.router_gate.router.weight.dtype == torch.float32
    trainer = torch_trainer.Trainer(model, torch_trainer.moe_task(), learning_rate=LR,
                                    weight_decay=WD, device="cpu")
    state = trainer.init()
    want_grads = moe_state_dict_from_flax(_np_tree(grads))
    for name, param in model.named_parameters():
        param.grad = want_grads[name].to(param.dtype)
    state.optimizer.step()
    want = moe_state_dict_from_flax(after)
    experts = 0
    for name, param in model.named_parameters():
        moments = state.optimizer.state[param]
        assert moments["exp_avg"].dtype == moments["exp_avg_sq"].dtype == param.dtype, name
        got, ref = param.detach().float(), want[name].float()
        if param.dtype == torch.bfloat16:
            experts += 1
            top = torch.maximum(got.abs(), ref.abs()).clamp_min(1e-30)
            ulp = BF16_EPS * torch.exp2(torch.floor(torch.log2(top)))
            assert bool(((got - ref).abs() <= ulp + 2 * LR * BF16_EPS).all()), name
            assert float((got == ref).float().mean()) > 0.9, name
        else:
            np.testing.assert_allclose(got.numpy(), ref.numpy(), atol=1e-6, err_msg=name)
    assert experts == 2 * tcfg.num_layers


@pytest.mark.usefixtures("needs_jax")
def test_decode_and_prefill_match_the_training_forward():
    """At capacity factor 2.0 training drops nothing, so MoEDecodeStep
    fed the sequence position by position gives the forward's logits,
    and MoEPrefill the forward's last position (and fills the same
    cache the steps fill)."""
    _, tcfg = _configs(capacity_factor=2.0)
    model = _port(tcfg, _params(_configs(capacity_factor=2.0)[0]))
    ids = torch.tensor(_batch(tcfg, s=24)["input_ids"]).long()
    # an expert takes at most one claim per token: a capacity of the
    # sequence's length drops nothing
    assert torch_moe.expert_capacity(tcfg, 24) >= 24
    with torch.no_grad():
        logits, _ = model(ids)
    cache = torch_moe.KVCache.zeros(tcfg, 2, 24)
    step = torch_moe.MoEDecodeStep(model)
    stepped = torch.stack([step(ids[:, i], i, cache) for i in range(24)], dim=1)
    np.testing.assert_allclose(stepped.numpy(), logits.numpy(), atol=OUT_ATOL)
    pcache = torch_moe.KVCache.zeros(tcfg, 2, 24)
    last = torch_moe.MoEPrefill(model)(ids, pcache)
    np.testing.assert_allclose(last.numpy(), logits[:, -1].numpy(), atol=OUT_ATOL)
    for a, b in zip(cache.keys + cache.values, pcache.keys + pcache.values):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=OUT_ATOL)


@pytest.mark.usefixtures("needs_jax")
@pytest.mark.parametrize("new", [1, 12])
def test_greedy_chains_match_jax(new):
    """Greedy moe_generate from a 6-token prompt: the reference's chain,
    each decision's top-2 margin first checked above MIN_MARGIN."""
    jcfg, tcfg = _configs()
    params = _params(jcfg)
    prompt = _batch(jcfg, s=6, seed=4)["input_ids"]
    want = np.asarray(jax_moe.moe_generate(jcfg, params, jnp.asarray(prompt), new))
    model = _port(tcfg, params)
    got = torch_moe.moe_generate(model, torch.tensor(prompt), new)
    assert got.shape == (2, 6 + new)
    with torch.no_grad():
        logits, _ = model(torch.tensor(want).long())
    top2 = logits[:, 5:-1].topk(2, dim=-1).values
    assert float((top2[..., 0] - top2[..., 1]).min()) > MIN_MARGIN
    np.testing.assert_array_equal(got.numpy(), want)


def test_sampled_chains_are_deterministic_and_errors_match():
    model = torch_moe.MoELM(torch_moe.MOE_TINY, generator=torch.Generator().manual_seed(0))
    prompt = torch.randint(0, 512, (2, 4), generator=torch.Generator().manual_seed(1))

    def sample(seed):
        gen = torch.Generator().manual_seed(seed)
        return torch_moe.moe_generate(model, prompt, 8, temperature=1.0, generator=gen)

    assert torch.equal(sample(3), sample(3))
    assert not torch.equal(sample(3), sample(4))
    assert torch.equal(sample(3)[:, :4], prompt)
    with pytest.raises(ValueError, match="max_new_tokens must be >= 1, got 0"):
        torch_moe.moe_generate(model, prompt, 0)
    with pytest.raises(ValueError, match="prompt\\+new = 129 exceeds max_position_embeddings 128"):
        torch_moe.moe_generate(model, prompt, 125)
    with pytest.raises(ValueError, match="temperature must be >= 0, got -1"):
        torch_moe.moe_generate(model, prompt, 2, temperature=-1.0)


@pytest.mark.usefixtures("needs_jax")
def test_converter_round_trip():
    """Every flax leaf lands on a port parameter once, strict, with its
    values (transposed where the layout says) and its dtype: bf16 expert
    kernels stay bf16; the port's state_dict has no key the tree lacks."""
    jcfg, tcfg = _configs(dtype=jnp.bfloat16, moe_every=2)
    tcfg = dataclasses.replace(tcfg, dtype=torch.bfloat16)
    params = _params(jcfg)
    state = moe_state_dict_from_flax(params)
    model = torch_moe.MoELM(tcfg)
    model.load_state_dict(state, strict=True)
    assert set(state) == set(model.state_dict())
    assert isinstance(model.layer_0, torch_moe.TransformerBlock)
    assert isinstance(model.layer_1, torch_moe.MoEBlock)
    layer = params["layer_1"]["moe_mlp"]
    np.testing.assert_array_equal(
        model.layer_1.moe_mlp.expert_in.detach().float().numpy(),
        np.asarray(layer["expert_in"]).astype(np.float32))
    np.testing.assert_array_equal(
        model.layer_1.moe_mlp.router_gate.router.weight.detach().numpy(),
        np.asarray(layer["router_gate"]["router"]["kernel"]).T)
    np.testing.assert_array_equal(model.lm_head.weight.detach().numpy(),
                                  np.asarray(params["head"]["lm_head"]["kernel"]).T)
    assert model.lm_head.bias is None
    with pytest.raises(KeyError, match="no mapping"):
        moe_state_dict_from_flax({"layer_0": {"surprise": np.zeros(1)}})


def test_cli_runs_three_steps_on_cpu(tmp_path):
    args = torch_moe_cli.parse_args([
        "--preset", "tiny", "--steps", "3", "--batch-size", "4", "--seq-len", "32",
        "--log-every", "1", "--device", "cpu", "--checkpoint-dir", str(tmp_path),
    ])
    summary = torch_moe_cli.run(args)
    assert summary["exit_code"] == 0 and summary["step"] == 3
    for key in ("loss", "router_aux", "eval_loss", "eval_router_aux", "eval_perplexity",
                "tokens_per_sec"):
        assert np.isfinite(summary[key]) and summary[key] > 0, key
    assert summary["router_z"] == 0.0  # MOE_TINY leaves the z-loss out
    assert sorted(os.listdir(tmp_path)) == ["3"]


@pytest.mark.parametrize("argv, item", [
    (["--ep", "2"], "item 7"), (["--tp", "2"], "item 7"),
])
def test_cli_refuses_what_is_not_ported(argv, item, capsys):
    """--ep and --tp were refused naming ROADMAP item 7 until it was
    ported (tests/test_torch_expert_parallel.py trains at both): each now
    parses to its mesh, and so does --fsdp together with it (item 4's 2-D
    line: FSDP2 over each ep and tp rank's shards,
    tests/test_torch_two_d.py)."""
    from tf_operator_tpu_torch.parallel.mesh import MeshConfig

    axis = argv[0][2:]
    assert torch_moe_cli.parse_args(argv).mesh == MeshConfig(**{axis: 2})
    assert item not in capsys.readouterr().err
    two_d = torch_moe_cli.parse_args(argv + ["--fsdp", "2"]).mesh
    assert two_d == MeshConfig(dp=-1, fsdp=2, **{axis: 2})
    assert "ROADMAP" not in capsys.readouterr().err


def test_cli_serves_telemetry_with_monitoring_bind_addr(tmp_path, monkeypatch):
    """--monitoring-bind-addr (ported with the telemetry plane) starts the
    worker's TrainTelemetry around the run and stops it after."""
    from tf_operator_tpu_torch.train import observe

    started = []
    real = observe.TrainTelemetry.start
    monkeypatch.setattr(observe.TrainTelemetry, "start",
                        lambda self, addr: started.append(self) or real(self, "127.0.0.1:0"))
    args = torch_moe_cli.parse_args([
        "--preset", "tiny", "--steps", "2", "--batch-size", "2", "--seq-len", "16",
        "--device", "cpu", "--monitoring-bind-addr", "0.0.0.0:9090",
    ])
    assert torch_moe_cli.run(args)["exit_code"] == 0
    (telemetry,) = started
    assert telemetry.worker == "worker-0" and telemetry._httpd is None
    assert telemetry.healthz()["phase"] == "training"


def test_cli_wants_cuda_and_seq_len_raises_the_position_table():
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            torch_moe_cli.run(torch_moe_cli.parse_args(["--steps", "1"]))
    args = torch_moe_cli.parse_args(["--preset", "tiny", "--seq-len", "300"])
    assert torch_moe_cli.config(args).max_position_embeddings == 300


def test_moe_modules_import_with_jax_blocked():
    code = (
        "import sys\n"
        "for name in ('jax', 'flax', 'optax', 'orbax', 'tf_operator_tpu'):\n"
        "    sys.modules[name] = None\n"
        "import tf_operator_tpu_torch.models.moe, tf_operator_tpu_torch.train.moe\n"
        "import tf_operator_tpu_torch.models.vit, tf_operator_tpu_torch.train.vit\n"
        "print('ok')\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0 and proc.stdout.strip() == "ok", proc.stderr


@pytest.mark.usefixtures("needs_jax")
def test_adamw_steps_track_the_reference():
    """Six AdamW steps of MOE_TINY on fresh batches from the same
    weights: each step's loss and router_aux follow the reference's
    (optax.adamw, the same batches) while the router moves."""
    jcfg, tcfg = _configs()
    params = _params(jcfg)
    jmodel = jax_moe.MoELM(jcfg)
    jtask = jax_trainer.moe_task(jmodel)
    opt = optax.adamw(LR, weight_decay=WD)

    @jax.jit
    def jstep(p, state, batch):
        (loss, aux), grads = jax.value_and_grad(
            lambda q: jtask.loss_fn({"params": q}, batch, True), has_aux=True)(p)
        updates, state = opt.update(grads, state, p)
        return optax.apply_updates(p, updates), state, loss, aux["router_aux"]

    model = _port(tcfg, params)
    trainer = torch_trainer.Trainer(model, torch_trainer.moe_task(), learning_rate=LR,
                                    weight_decay=WD, device="cpu")
    state = trainer.init()
    jstate = opt.init(params)
    jparams = jax.tree_util.tree_map(jnp.asarray, params)
    auxes = []
    for i in range(6):
        batch = _batch(jcfg, s=32, seed=10 + i)
        jparams, jstate, jloss, jaux = jstep(
            jparams, jstate, {k: jnp.asarray(v) for k, v in batch.items()})
        state, metrics = trainer.step(state, trainer.place_batch(_torch_batch(batch)))
        np.testing.assert_allclose(metrics["loss"].item(), float(jloss), rtol=1e-5, err_msg=i)
        np.testing.assert_allclose(metrics["router_aux"].item(), float(jaux), rtol=1e-4,
                                   err_msg=i)
        auxes.append(float(jaux))
    assert auxes[-1] != auxes[0]
