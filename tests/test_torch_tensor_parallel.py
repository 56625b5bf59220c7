"""The port's tensor parallelism (parallel/sharding.py's Megatron plan,
the vocab-parallel loss, generate(mesh=)) in a world of 2 gloo
processes on the CPU, held against the JAX reference at tp = 2 on the
virtual CPU mesh, f32.

- GPT (GPT_TINY's widths with 4 heads), BERT_TINY (a padded row: the mask
  path under tp) and VIT_TINY, each from converted reference weights on
  the same numpy batch: one step's loss (1e-5) and each rank's gradient
  shard against the matching slice of the reference's gradient (1e-4),
  then each rank's parameter shard after 2 AdamW steps (1e-4 where the
  reference's gradient is above noise; a near-zero gradient's weight
  held to how far an AdamW step can move it).
- generate(mesh=) at tp = 2: the greedy chain equals the reference's
  generate(mesh=) at tp = 2.
- A checkpoint saved at tp = 2 (gathered over tp) restores bit-equal in
  one process.
- The plan's own seams on the CPU: shard_state_dict and its inverse,
  the vocab-parallel cross-entropy against the plain one; convert.py's
  slice of the reference's tree for each rank equals what the laid-out
  model holds.

The world is this file run as a script (`_world_main`), spawned once per
module; tests/test_torch_sequence_parallel.py spawns its worlds with the
same helpers.
"""

import dataclasses
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from tf_operator_tpu_torch.models import bert as torch_bert
from tf_operator_tpu_torch.models import gpt as torch_gpt
from tf_operator_tpu_torch.models import vit as torch_vit
from tf_operator_tpu_torch.models.convert import (
    bert_state_dict_from_flax,
    gpt_state_dict_from_flax,
    vit_state_dict_from_flax,
)
from tf_operator_tpu_torch.parallel import distributed
from tf_operator_tpu_torch.parallel import mesh as torch_mesh
from tf_operator_tpu_torch.parallel import sharding
from tf_operator_tpu_torch.train import trainer as torch_trainer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TP = 2
LOSS_ATOL = 1e-5
GRAD_ATOL = 1e-4
PARAM_ATOL = 1e-4
GRAD_NOISE = 1e-6
ADAM_LR = 1e-3
ADAM_WD = 0.01
STEPS = 2
PROMPT = (2, 8)
NEW_TOKENS = 16
# the worlds' processes share the machine: two threads each
CHILD_ENV = {"OMP_NUM_THREADS": "2"}
LAUNCH_TIMEOUT_S = 240
CONVERT = {"gpt": gpt_state_dict_from_flax, "bert": bert_state_dict_from_flax,
           "vit": vit_state_dict_from_flax}


# -- data and models, shared by the parent and the worlds' processes ----------

def gpt_cfg():
    """GPT_TINY's widths with 4 heads of 32 (2 heads cannot take tp 2 x sp 2)."""
    return dataclasses.replace(torch_gpt.GPT_TINY, num_heads=4, dtype=torch.float32)


def bert_cfg():
    return dataclasses.replace(torch_bert.BERT_TINY, dtype=torch.float32)


def vit_cfg():
    return dataclasses.replace(torch_vit.VIT_TINY, dtype=torch.float32)


def gpt_batch(b=4, s=32, seed=7):
    vocab = torch_gpt.GPT_TINY.vocab_size
    return {"input_ids": np.random.default_rng(seed).integers(0, vocab, (b, s)).astype(np.int32)}


def mlm_batch(b=4, s=32, seed=3, padded=True):
    """Uneven mlm weights along the rows and the sequence (the sequence
    shards carry different weight masses); row 1 padded from position 20
    where `padded`, else an all-ones mask (a packed batch)."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, torch_bert.BERT_TINY.vocab_size, (b, s)).astype(np.int32)
    mask = np.ones((b, s), np.int32)
    if padded:
        mask[1, 20:] = 0
    weights = ((rng.random((b, s)) < 0.3) & (mask > 0)).astype(np.float32)
    weights[0, :4] = 1.0
    return {"input_ids": ids, "labels": ids, "mlm_weights": weights, "attention_mask": mask}


def image_batch(seed=5):
    rng = np.random.default_rng(seed)
    size = torch_vit.VIT_TINY.image_size
    return {"image": rng.standard_normal((4, size, size, 3)).astype(np.float32),
            "label": rng.integers(0, torch_vit.VIT_TINY.num_classes, (4,)).astype(np.int32)}


def torch_batch(batch):
    out = {k: torch.tensor(v) for k, v in batch.items()}
    for key in ("input_ids", "labels", "label"):
        if key in out:
            out[key] = out[key].long()
    return out


def port_trainer(kind, weights, mesh=None, attention_fn=None, shard_sequence=False,
                 checkpoint_dir=None, accum_steps=1):
    if kind == "gpt":
        model = torch_gpt.GPT(gpt_cfg(), attention_fn=attention_fn)
        task = torch_trainer.causal_lm_task()
    elif kind == "bert":
        model = torch_bert.BertForMLM(bert_cfg(), attention_fn=attention_fn)
        task = torch_trainer.mlm_task()
    else:
        model, task = torch_vit.ViT(vit_cfg()), torch_trainer.classification_task()
    model.load_state_dict(weights)
    return torch_trainer.Trainer(
        model, task, learning_rate=ADAM_LR, weight_decay=ADAM_WD, device="cpu", mesh=mesh,
        shard_sequence=shard_sequence, checkpoint_dir=checkpoint_dir, accum_steps=accum_steps)


def port_steps(kind, weights, batch, mesh, attention_fn=None, shard_sequence=False,
               checkpoint_dir=None):
    """STEPS AdamW steps on the global batch in this world: step 1's loss
    and this rank's gradients, its parameters after the last step, and
    (with a checkpoint_dir) the checkpoint written there and the gathered
    payload (rank 0's)."""
    trainer = port_trainer(kind, weights, mesh, attention_fn, shard_sequence, checkpoint_dir)
    state = trainer.init()
    placed = trainer.place_batch(torch_batch(batch))
    state, metrics = trainer.step(state, placed)
    out = {"loss": float(metrics["loss"]),
           "grads": {n: p.grad.detach().clone() for n, p in state.model.named_parameters()}}
    for _ in range(STEPS - 1):
        state, metrics = trainer.step(state, placed)
    out["params"] = {n: p.detach().clone() for n, p in state.model.named_parameters()}
    out["last_loss"] = float(metrics["loss"])
    if checkpoint_dir is not None:
        trainer.save(state)
        payload = torch_trainer.state_payload(state)
        out["payload"] = None if payload is None else payload_tensors(payload)
    return out


def payload_tensors(payload):
    """A state_payload flattened to {name: tensor}, copied."""
    out = {f"model.{k}": v.detach().clone() for k, v in payload["model"].items()}
    for index, entry in payload["optimizer"]["state"].items():
        for key, value in entry.items():
            if isinstance(value, torch.Tensor):
                out[f"opt.{index}.{key}"] = value.detach().clone()
    out["step"] = torch.tensor(payload["step"])
    return out


# -- one process of the world ---------------------------------------------------

def _world_main(work: str) -> None:
    distributed.initialize("cpu")
    try:
        inputs = torch.load(os.path.join(work, "inputs.pt"), weights_only=False)
        mesh = torch_mesh.build_mesh(torch_mesh.MeshConfig(tp=TP), "cpu")
        out = {"rank": distributed.rank(), "coordinate": dict(mesh.coordinate),
               "summary": torch_mesh.mesh_summary(mesh)}
        for kind in ("gpt", "bert", "vit"):
            ckpt = os.path.join(work, "ckpt") if kind == "gpt" else None
            out[kind] = port_steps(kind, inputs["weights"][kind], inputs[f"{kind}_batch"], mesh,
                                   checkpoint_dir=ckpt)
            # the converter's slice for this rank is what the laid-out model holds
            trainer = port_trainer(kind, inputs["weights"][kind], mesh)
            state = trainer.init()
            want = CONVERT[kind](inputs["flax"][kind], mesh=mesh)
            got = state.model.state_dict()
            out[kind]["converted_equal"] = set(got) == set(want) and all(
                torch.equal(got[n], want[n]) for n in want)
        model = torch_gpt.GPT(gpt_cfg())
        model.load_state_dict(inputs["weights"]["gpt"])
        prompt = torch.tensor(inputs["prompt"]).long()
        out["generated"] = torch_gpt.generate(model, prompt, NEW_TOKENS, mesh=mesh).tolist()
        out["generate_heads"] = model.layer_0.attention.query.kernel.shape[1]  # untouched
        torch.save(out, os.path.join(work, f"rank{out['rank']}.pt"))
        distributed.barrier()
    finally:
        distributed.shutdown()


# -- launching worlds (shared with tests/test_torch_sequence_parallel.py) -------

def rank_env(rank: int, world: int, port: int) -> dict:
    env = dict(os.environ, **CHILD_ENV)
    env["PYTHONPATH"] = os.pathsep.join(filter(None, [REPO, env.get("PYTHONPATH")]))
    env.update({
        "TPU_WORKER_ID": str(rank),
        "TPU_WORKER_HOSTNAMES": ",".join(f"worker-{i}" for i in range(world)),
        "JAX_NUM_PROCESSES": str(world),
        "JAX_PROCESS_ID": str(rank),
        "TFJOB_COORDINATOR_OVERRIDE": f"127.0.0.1:{port}",
    })
    return env


def run_world(script: str, work: str, world: int, timeout: float = LAUNCH_TIMEOUT_S) -> list:
    """`world` processes of `script` (its `_world_main(work)`), once more on
    a fresh port if a rank fails (a port taken between the pick and the
    bind); each rank's rank<r>.pt. A rank that fails both attempts fails
    the test with every rank's log."""
    from tests.test_e2e import retry_flaky
    from tf_operator_tpu.runtime.process_kubelet import free_port

    def launch(attempt):
        logs = os.path.join(work, f"logs{attempt}")
        os.makedirs(logs)
        port = free_port()
        procs = []
        for rank in range(world):
            log = open(os.path.join(logs, f"rank{rank}.log"), "w")
            procs.append((subprocess.Popen(
                [sys.executable, script, work], cwd=REPO, env=rank_env(rank, world, port),
                stdout=log, stderr=subprocess.STDOUT), log))
        deadline = time.monotonic() + timeout
        codes = []
        for proc, log in procs:
            try:
                codes.append(proc.wait(timeout=max(deadline - time.monotonic(), 1)))
            except subprocess.TimeoutExpired:
                proc.kill()
                codes.append(proc.wait())
            finally:
                log.close()
        texts = [open(os.path.join(logs, f"rank{r}.log")).read()[-3000:] for r in range(world)]
        assert codes == [0] * world, (codes, texts)

    retry_flaky(launch)
    return [torch.load(os.path.join(work, f"rank{r}.pt"), weights_only=False)
            for r in range(world)]


# -- the reference ----------------------------------------------------------------

def keeping_grads():
    """An optax transformation that passes the gradient on and keeps it in
    its state."""
    import jax
    import jax.numpy as jnp
    import optax

    def init(params):
        return jax.tree_util.tree_map(jnp.zeros_like, params)

    def update(grads, state, params=None):
        return grads, grads

    return optax.GradientTransformation(init, update)


def jax_models(attention_fn=None):
    """The reference's GPT, BERT and ViT at the test widths, f32."""
    import jax.numpy as jnp

    from tf_operator_tpu.models import bert as jax_bert
    from tf_operator_tpu.models import gpt as jax_gpt
    from tf_operator_tpu.models import vit as jax_vit

    gpt = jax_gpt.GPT(dataclasses.replace(jax_gpt.GPT_TINY, num_heads=4, dtype=jnp.float32),
                      attention_fn=attention_fn)
    bert = jax_bert.BertForMLM(dataclasses.replace(jax_bert.BERT_TINY, dtype=jnp.float32),
                               attention_fn=attention_fn)
    vit = jax_vit.ViT(dataclasses.replace(jax_vit.VIT_TINY, dtype=jnp.float32))
    return {"gpt": gpt, "bert": bert, "vit": vit}


def reference_steps(kind, model, batch, mesh, shard_sequence=False, accum_steps=1):
    """The reference Trainer's STEPS AdamW steps on the global batch over
    `mesh`: params before, step 1's gradient and loss, params after, as
    numpy trees."""
    import jax
    import jax.numpy as jnp
    import optax

    from tf_operator_tpu.train import trainer as jax_trainer

    task = {"gpt": jax_trainer.causal_lm_task, "bert": jax_trainer.mlm_task,
            "vit": jax_trainer.classification_task}[kind](model)
    trainer = jax_trainer.Trainer(
        model, task, optax.chain(keeping_grads(), optax.adamw(ADAM_LR, weight_decay=ADAM_WD)),
        mesh=mesh, shard_sequence=shard_sequence, accum_steps=accum_steps)
    jbatch = trainer.place_batch({k: jnp.asarray(v) for k, v in batch.items()})
    state = trainer.init(jax.random.PRNGKey(0), jbatch)
    to_np = lambda tree: jax.tree_util.tree_map(np.asarray, tree)  # noqa: E731
    before = to_np(state.params)
    state, metrics = trainer.step(state, jbatch)
    grads, loss = to_np(state.opt_state[0]), float(metrics["loss"])
    for _ in range(STEPS - 1):
        state, metrics = trainer.step(state, jbatch)
    return {"before": CONVERT[kind](before), "flax_before": before,
            "grads": CONVERT[kind](grads), "loss": loss,
            "after": CONVERT[kind](to_np(state.params)), "last_loss": float(metrics["loss"])}


def jax_mesh(**axes):
    import jax

    from tf_operator_tpu.parallel.mesh import MeshConfig, build_mesh

    n = int(np.prod(list(axes.values())))
    return build_mesh(MeshConfig(dp=1, **axes), devices=jax.devices()[:n])


def tp_slice(name, tensor, tp_rank, tp_size=TP):
    """The port plan's slice of a full tensor for tp rank `tp_rank`."""
    rule = sharding.tp_rule(name, sharding.TRANSFORMER_RULES.tp)
    return tensor if rule is None else tensor.chunk(tp_size, rule[0])[tp_rank]


def close(got, want, atol, what):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=atol, err_msg=what)


def check_against_reference(got, ref, tp_rank, tp_size=TP):
    """One rank's port_steps against the reference's reference_steps."""
    close(got["loss"], ref["loss"], LOSS_ATOL, "loss")
    close(got["last_loss"], ref["last_loss"], LOSS_ATOL, "last loss")
    assert set(got["grads"]) == set(ref["grads"])
    strict = nonzero = 0
    for name, full in ref["grads"].items():
        want_grad = tp_slice(name, full, tp_rank, tp_size)
        close(got["grads"][name], want_grad, GRAD_ATOL, f"grad {name}")
        want = tp_slice(name, ref["after"][name], tp_rank, tp_size)
        start = tp_slice(name, ref["before"][name], tp_rank, tp_size)
        noise = want_grad.abs() <= GRAD_NOISE
        strict += int((~noise).sum())
        nonzero += int((want_grad != 0).sum())
        p = got["params"][name]
        close(p[~noise], want[~noise], PARAM_ATOL, f"param {name}")
        # a noise-level gradient's weight: at most STEPS AdamW moves of lr
        # (plus weight decay) from its start, whichever sign Adam took
        moved = (p[noise] - start[noise]).abs()
        bound = STEPS * (ADAM_LR * (1 + 1e-3) + ADAM_LR * ADAM_WD * start[noise].abs())
        assert bool((moved <= bound).all()), name
    assert strict >= 0.95 * nonzero


@pytest.fixture(scope="module")
def reference():
    import jax.numpy as jnp

    from tf_operator_tpu.models import gpt as jax_gpt

    batches = {"gpt": gpt_batch(), "bert": mlm_batch(), "vit": image_batch()}
    mesh = jax_mesh(tp=TP)
    models = jax_models()
    run = {kind: reference_steps(kind, models[kind], batches[kind], mesh) for kind in batches}
    prompt = gpt_batch(*PROMPT, seed=11)["input_ids"]
    params = _flax_tree(run["gpt"]["before"])
    run["generated"] = np.asarray(jax_gpt.generate(
        models["gpt"].config, params, jnp.asarray(prompt), NEW_TOKENS, mesh=mesh)).tolist()
    run["batches"] = batches
    run["prompt"] = prompt
    return run


def _flax_tree(port_state):
    """A port GPT state dict back into the reference's param tree (Dense
    kernels transposed): the weights the reference decodes with."""
    tree = {}
    for name, tensor in port_state.items():
        parts = name.split(".")
        value = tensor.numpy()
        if parts[-1] == "weight" and parts[-2] in ("token_embed", "position_embed"):
            parts[-1] = "embedding"
        elif parts[-1] == "weight" and parts[-2] in ("ln_attn", "ln_mlp", "ln_final"):
            parts[-1] = "scale"
        elif parts[-1] == "weight":
            parts[-1], value = "kernel", value.T
        node = tree
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = value
    return tree


@pytest.fixture(scope="module")
def world(reference, tmp_path_factory):
    work = str(tmp_path_factory.mktemp("tp2"))
    torch.save({"weights": {k: reference[k]["before"] for k in ("gpt", "bert", "vit")},
                "flax": {k: reference[k]["flax_before"] for k in ("gpt", "bert", "vit")},
                **{f"{k}_batch": v for k, v in reference["batches"].items()},
                "prompt": reference["prompt"]}, os.path.join(work, "inputs.pt"))
    ranks = run_world(os.path.abspath(__file__), work, TP)
    return {"ranks": ranks, "ckpt": os.path.join(work, "ckpt")}


# -- the world of two at tp = 2 against the reference -------------------------------

def test_world_lays_out_a_tp_mesh(world):
    for rank, out in enumerate(world["ranks"]):
        assert out["rank"] == rank
        assert out["coordinate"] == {"dp": 0, "pp": 0, "fsdp": 0, "ep": 0, "sp": 0, "tp": rank}
        assert out["summary"] == "dp=1xpp=1xfsdp=1xep=1xsp=1xtp=2"


@pytest.mark.parametrize("kind", ["gpt", "bert", "vit"])
def test_tp2_steps_match_the_reference_tp_mesh(world, reference, kind):
    """Loss, each rank's gradient shard and its parameters after 2 AdamW
    steps against the reference's at tp = 2 (BERT with a padded row)."""
    for rank, out in enumerate(world["ranks"]):
        got = out[kind]
        assert got["converted_equal"]  # convert.py's slice for the rank is the laid-out model
        # every planned parameter is this rank's half of the full one
        for name, full in reference[kind]["grads"].items():
            assert got["grads"][name].shape == tp_slice(name, full, rank).shape, name
        check_against_reference(got, reference[kind], rank)


def test_tp_splits_what_the_rules_split(reference):
    """Which of each model's parameters the plan splits, and along which
    dimension: heads for q/k/v, the hidden of the MLP, rows of the
    embeddings and of the LM/MLM head; ViT's patch, position and class
    head, and every norm, replicated."""
    plan = sharding.TRANSFORMER_RULES.tp
    split = {kind: sorted({n.split(".", 1)[-1] if n.startswith("layer_") else n
                           for n in reference[kind]["grads"] if sharding.tp_rule(n, plan)})
             for kind in ("gpt", "bert", "vit")}
    block = ["attention.attn_out.kernel", "attention.key.bias", "attention.key.kernel",
             "attention.query.bias", "attention.query.kernel", "attention.value.bias",
             "attention.value.kernel", "mlp_in.bias", "mlp_in.weight", "mlp_out.weight"]
    assert split["gpt"] == sorted(block + ["lm_head.bias", "lm_head.weight",
                                           "position_embed.weight", "token_embed.weight"])
    assert split["vit"] == block
    assert "mlm_head.weight" in split["bert"] and "encoder.token_embed.weight" in split["bert"]
    assert sharding.tp_rule("layer_0.attention.query.kernel", plan) == (1, "column")
    assert sharding.tp_rule("layer_0.mlp_out.weight", plan) == (1, "row")
    assert sharding.tp_rule("layer_0.ln_attn.weight", plan) is None


def test_generate_on_a_tp2_mesh_matches_the_reference_chain(world, reference):
    for out in world["ranks"]:
        assert out["generated"] == reference["generated"]
        assert out["generate_heads"] == 4  # the caller's model keeps its full weights
    want = np.asarray(reference["generated"])
    assert want.shape == (PROMPT[0], PROMPT[1] + NEW_TOKENS)


def test_tp2_checkpoint_restores_bit_equal_in_one_process(world, reference):
    gathered = world["ranks"][0]["gpt"]["payload"]
    assert world["ranks"][1]["gpt"]["payload"] is None  # rank 0 holds the gathered state
    trainer = port_trainer("gpt", reference["gpt"]["before"], checkpoint_dir=world["ckpt"])
    state = trainer.restore(trainer.init())
    assert state is not None and state.step == STEPS
    got = payload_tensors(torch_trainer.state_payload(state))
    assert set(got) == set(gathered)
    for name, want in gathered.items():
        assert torch.equal(got[name], want), name
    # the gathered halves are the ranks' own
    for rank, out in enumerate(world["ranks"]):
        for name, local in out["gpt"]["params"].items():
            assert torch.equal(tp_slice(name, gathered[f"model.{name}"], rank), local), name


# -- the plan's seams, in one process ------------------------------------------------

def _fake_mesh(tp_rank, tp=TP):
    return torch_mesh.TrainMesh(shape={"dp": 1, "fsdp": 1, "sp": 1, "tp": tp},
                                coordinate={"dp": 0, "fsdp": 0, "sp": 0, "tp": tp_rank})


def test_shard_state_dict_slices_by_the_plan_and_reassembles(reference):
    full = reference["gpt"]["before"]
    halves = [sharding.shard_state_dict(full, _fake_mesh(r), sharding.TRANSFORMER_RULES)
              for r in range(TP)]
    for name, tensor in full.items():
        rule = sharding.tp_rule(name, sharding.TRANSFORMER_RULES.tp)
        if rule is None:
            assert all(torch.equal(h[name], tensor) for h in halves), name
        else:
            assert torch.equal(torch.cat([h[name] for h in halves], rule[0]), tensor), name
    assert sharding.shard_state_dict(full, None, sharding.TRANSFORMER_RULES).keys() == full.keys()
    assert sharding.gather_state_dict(full, None) == full


def test_vocab_parallel_cross_entropy_matches_the_plain_loss(monkeypatch):
    """Two vocab halves in one process, each half's all-reduces answered
    with what the group returns (the max and the sums over both halves),
    after checking what the half contributes (its picked logit only where
    it owns the label): the loss and the halves' gradients equal the plain
    fused loss's."""
    from tf_operator_tpu_torch.ops import losses

    rng = np.random.default_rng(0)
    logits = torch.tensor(rng.standard_normal((6, 10)).astype(np.float32) * 3)
    labels = torch.tensor([0, 4, 5, 9, 2, 7])
    g = torch.tensor(rng.standard_normal(6).astype(np.float32))
    plain = logits.clone().requires_grad_()
    want = losses.cross_entropy_with_integer_labels(plain, labels)
    (want * g).sum().backward()
    m = logits.amax(-1)
    sumexp = torch.exp(logits - m[:, None]).sum(-1)
    picked = logits.gather(-1, labels[:, None])[:, 0]
    halves = [logits[:, :5].clone().requires_grad_(), logits[:, 5:].clone().requires_grad_()]
    for rank, half in enumerate(halves):
        owned = (labels // 5) == rank
        answers = iter([(None, m), (None, sumexp), (torch.where(owned, picked, 0.0), picked)])

        def reduce(tensor, group, op="sum", answers=answers):
            contribution, total = next(answers)
            if contribution is not None:
                assert torch.equal(tensor, contribution)
            return total

        monkeypatch.setattr(distributed, "all_reduce", reduce)
        got = losses.vocab_parallel_cross_entropy(half, labels, 5 * rank, None)
        close(got.detach(), want.detach(), 1e-6, "loss")
        (got * g).sum().backward()
    close(torch.cat([h.grad for h in halves], dim=1), plain.grad, 1e-6, "grad")


if __name__ == "__main__":
    _world_main(sys.argv[1])
