"""The port's workers in a world of several processes
(tf_operator_tpu_torch/parallel/, the Trainer's mesh seam, sync
TpuBatchNorm), held against the JAX reference on the CPU over gloo, f32.

- `read_process_env` and `MeshConfig.resolve` against the reference's own
  functions on a table of envs and sizes, errors included.
- One world of 2 processes (this file run as a script: `_world_main`),
  spawned once per module, on the same global batches and weights as the
  reference:
  - BERT_TINY MLM under DDP with uneven masks (3 masked positions on rank
    0, >= 40 on rank 1), one SGD-momentum step at accum_steps 1 and 2:
    loss 1e-5, gradients and parameters 1e-4 against the reference
    Trainer on the global batch (accum_steps 1 and 2) and against the
    port in one process. SGD's first step moves a weight by lr * g, so a
    gradient error shows in the parameters unscaled by an Adam
    normalisation.
  - A small ResNet (TpuBatchNorm) under DDP with sync BN, the two ranks'
    images drawn from different distributions, at accum_steps 1 and 2:
    running statistics and loss 1e-5, gradients 1e-4 against the
    reference's global-batch step.
  - GPT_TINY at --fsdp 2 (FSDP2, AdamW wd 0.01) against the reference
    with MeshConfig(fsdp=2) on two of the 8 virtual CPU devices: loss
    1e-5, gradients 1e-4, parameters 1e-4 where the reference's gradient
    is above 1e-6, and near-zero gradients held to a bound on how far an
    AdamW step moves a weight (tests/test_torch_trainer.py explains).
  - MOE_TINY (padding on one row) under DDP at accum_steps 1 and 2 and
    under FSDP2 (MOE_RULES, --fsdp 2) at accum_steps 1, one SGD-momentum
    step each: loss 1e-5, router_aux 1e-6, gradients and parameters 1e-4
    against the reference Trainer on the global batch. The routers'
    per-expert means are all-reduced over the batch group; a control step
    with that sync unset must miss the reference's router_aux and router
    gradients.
  - Every rank draws the same initial weights from the seeded generators.
  - Checkpoints saved at world 2 (DDP and FSDP2) restore bit-equal in one
    process, and checkpoints saved in one process restore bit-equal at
    world 2.
- A SIGTERM to one rank of train/gpt.py at world 2: both ranks exit 143
  at the same step, with one checkpoint at that step.
- --tp, --sp and --sp-strategy parse to their MeshConfig; together with
  --fsdp > 1 (2-D) they are refused, naming ROADMAP. Their worlds run in
  tests/test_torch_tensor_parallel.py and test_torch_sequence_parallel.py.

The worlds rendezvous over 127.0.0.1 on a free port; a port taken between
the pick and the bind fails the launch, which is retried once with a
fresh port (a genuine fault fails both attempts).
"""

import dataclasses
import hashlib
import os
import signal
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from tf_operator_tpu_torch.models import bert as torch_bert
from tf_operator_tpu_torch.models import gpt as torch_gpt
from tf_operator_tpu_torch.models import moe as torch_moe
from tf_operator_tpu_torch.models import resnet as torch_resnet
from tf_operator_tpu_torch.models.convert import (
    bert_state_dict_from_flax,
    gpt_state_dict_from_flax,
    moe_state_dict_from_flax,
    resnet_state_dict_from_flax,
)
from tf_operator_tpu_torch.parallel import distributed
from tf_operator_tpu_torch.parallel import mesh as torch_mesh
from tf_operator_tpu_torch.parallel.sharding import CONV_RULES, MOE_RULES
from tf_operator_tpu_torch.train import trainer as torch_trainer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = 2
LOSS_ATOL = 1e-5
GRAD_ATOL = 1e-4
PARAM_ATOL = 1e-4
STATS_ATOL = 1e-5
GRAD_NOISE = 1e-6
AUX_ATOL = 1e-6
# the smallest miss of the reference's router_aux (relative) and router
# gradients (absolute) that the unsynced control must show: each 10x the
# bound the synced step is held to
CONTROL_AUX_RTOL = 1e-3
CONTROL_GRAD_MISS = 10 * GRAD_ATOL
SGD_LR = 0.1
ADAM_LR = 1e-3
ADAM_WD = 0.01
RESNET_SMALL = dict(stage_sizes=(1,), num_classes=10, width=8)
# the worlds' processes share the machine: two threads each
CHILD_ENV = {"OMP_NUM_THREADS": "2"}
LAUNCH_TIMEOUT_S = 240


# -- data and models, shared by the parent and the world's processes ----------

def _bert_cfg():
    return dataclasses.replace(torch_bert.BERT_TINY, dtype=torch.float32)


def _gpt_cfg():
    return dataclasses.replace(torch_gpt.GPT_TINY, dtype=torch.float32)


def _uneven_mlm_batch(vocab, b=4, s=32, seed=3):
    """Rows 0-1 (rank 0 at world 2) carry 3 masked positions, rows 2-3
    (rank 1) at least 40; row 1 is padded from position 20."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, vocab, (b, s)).astype(np.int32)
    mask = np.ones((b, s), np.int32)
    mask[1, 20:] = 0
    weights = np.zeros((b, s), np.float32)
    weights[0, [1, 5]] = 1.0
    weights[1, 7] = 1.0
    weights[2:, :] = (rng.random((2, s)) < 0.7) & (mask[2:] > 0)
    weights[2, :20] = 1.0
    return {"input_ids": ids, "labels": ids, "mlm_weights": weights, "attention_mask": mask}


def _image_batch(seed=5):
    """Rows 2-3 (rank 1) from another distribution than rows 0-1, so that
    per-rank BatchNorm statistics differ from the global batch's."""
    rng = np.random.default_rng(seed)
    batch = {"image": rng.standard_normal((4, 32, 32, 3)).astype(np.float32),
             "label": rng.integers(0, 10, (4,)).astype(np.int32)}
    batch["image"][2:] = 3.0 * batch["image"][2:] + 1.0
    return batch


def _moe_batch(vocab, b=4, s=32, seed=9):
    """Tokens for a causal LM with labels and a mask that pads row 1 (rank 0
    at world 2) from position 20."""
    ids = np.random.default_rng(seed).integers(0, vocab, (b, s)).astype(np.int32)
    mask = np.ones((b, s), np.int32)
    mask[1, 20:] = 0
    return {"input_ids": ids, "labels": ids, "attention_mask": mask}


def _tokens(vocab, b=4, s=32, seed=7):
    return {"input_ids": np.random.default_rng(seed).integers(0, vocab, (b, s)).astype(np.int32)}


def _torch_batch(batch):
    out = {k: torch.tensor(v) for k, v in batch.items()}
    for key in ("input_ids", "labels", "label"):
        if key in out:
            out[key] = out[key].long()
    return out


def _bert_trainer(weights, mesh=None, accum_steps=1, checkpoint_dir=None):
    model = torch_bert.BertForMLM(_bert_cfg())
    model.load_state_dict(weights)
    return torch_trainer.Trainer(
        model, torch_trainer.mlm_task(), learning_rate=SGD_LR, optimizer="sgd", device="cpu",
        accum_steps=accum_steps, checkpoint_dir=checkpoint_dir, mesh=mesh,
    )


def _resnet_trainer(weights, mesh=None, accum_steps=1):
    model = torch_resnet.ResNet(**RESNET_SMALL, dtype=torch.float32)
    model.load_state_dict(weights)
    return torch_trainer.Trainer(
        model, torch_trainer.classification_task(), learning_rate=SGD_LR, optimizer="sgd",
        device="cpu", mesh=mesh, rules=CONV_RULES, accum_steps=accum_steps,
    )


def _gpt_trainer(weights, mesh=None, checkpoint_dir=None):
    model = torch_gpt.GPT(_gpt_cfg())
    model.load_state_dict(weights)
    return torch_trainer.Trainer(
        model, torch_trainer.causal_lm_task(), learning_rate=ADAM_LR, weight_decay=ADAM_WD,
        device="cpu", checkpoint_dir=checkpoint_dir, mesh=mesh,
    )


def _moe_trainer(weights, mesh=None, accum_steps=1):
    model = torch_moe.MoELM(torch_moe.MOE_TINY)
    model.load_state_dict(weights)
    return torch_trainer.Trainer(
        model, torch_trainer.moe_task(), learning_rate=SGD_LR, optimizer="sgd", device="cpu",
        accum_steps=accum_steps, mesh=mesh, rules=MOE_RULES,
    )


def _moe_step(weights, batch, mesh, accum_steps=1, synced=True):
    """One MoE step in this world: loss, router_aux, full gradients and
    parameters; synced=False unsets the routers' sync group first."""
    trainer = _moe_trainer(weights, mesh, accum_steps)
    state = trainer.init()
    routers = [m for m in state.model.modules() if isinstance(m, torch_moe.TopKRouter)]
    groups = [r.sync_group is not None for r in routers]
    if not synced:
        for router in routers:
            router.sync_group = None
    state, metrics = trainer.step(state, trainer.place_batch(_torch_batch(batch)))
    params = {}
    for name, param in state.model.named_parameters():
        full = param.full_tensor() if hasattr(param, "full_tensor") else param
        params[name] = full.detach().clone()
    return {"loss": float(metrics["loss"]), "aux": float(metrics["router_aux"]),
            "grads": _full_grads(state.model), "params": params, "synced": groups,
            "sharded": type(state.model.layer_0.attention.query.kernel).__name__}


def _full_grads(model):
    """Every parameter's gradient as a full tensor (gathered from FSDP2's
    shards: a collective)."""
    out = {}
    for name, param in model.named_parameters():
        grad = param.grad
        out[name] = (grad.full_tensor() if hasattr(grad, "full_tensor") else grad).detach().clone()
    return out


def _payload_tensors(payload):
    """A state_payload flattened to {name: tensor}, copied."""
    out = {f"model.{k}": v.detach().clone() for k, v in payload["model"].items()}
    for index, entry in payload["optimizer"]["state"].items():
        for key, value in entry.items():
            if isinstance(value, torch.Tensor):
                out[f"opt.{index}.{key}"] = value.detach().clone()
    out["step"] = torch.tensor(payload["step"])
    return out


def _seeded_digests():
    """sha256 of each model's parameters as drawn from seed 0."""
    models = {
        "bert": torch_bert.BertForMLM(_bert_cfg(), generator=torch.Generator().manual_seed(0)),
        "gpt": torch_gpt.GPT(_gpt_cfg(), generator=torch.Generator().manual_seed(0)),
        "resnet": torch_resnet.ResNet(**RESNET_SMALL, dtype=torch.float32,
                                      generator=torch.Generator().manual_seed(0)),
    }
    return {
        name: hashlib.sha256(
            torch.cat([p.detach().flatten() for p in model.parameters()]).numpy().tobytes()
        ).hexdigest()
        for name, model in models.items()
    }


# -- one process of the world ---------------------------------------------------

def _bn_features(seed=11):
    """[4, 3, 5, 5]: rows 2-3 (rank 1) from another distribution."""
    x = np.random.default_rng(seed).standard_normal((4, 3, 5, 5)).astype(np.float32)
    x[2:] = 3.0 * x[2:] + 1.0
    return x


def _bn_sides(rank: int) -> dict:
    """One training forward of a TpuBatchNorm on this rank's rows in a
    world of 2: first as built (no sync group), then after sync_batch_norm
    gave it the dp mesh's batch group; the batch mean each time."""
    from tf_operator_tpu_torch.models.norm import TpuBatchNorm
    from tf_operator_tpu_torch.parallel.sharding import sync_batch_norm

    rows = torch.tensor(_bn_features()[2 * rank:2 * rank + 2])
    out = {}
    for side in ("unset", "synced"):
        bn = TpuBatchNorm(3, momentum=0.0, dtype=torch.float32)
        if side == "synced":
            sync_batch_norm(bn, torch_mesh.build_mesh(torch_mesh.MeshConfig(), "cpu"))
        out[f"{side}_group"] = bn.sync_group is not None
        bn.train()(rows)
        out[side] = bn.mean.clone()
    return out


def _world_main(work: str) -> None:
    """Run every world-2 check's side in this process and write
    rank<r>.pt under `work`."""
    distributed.initialize("cpu")
    try:
        rank = distributed.rank()
        inputs = torch.load(os.path.join(work, "inputs.pt"), weights_only=False)
        ckpt = os.path.join(work, "ckpt")
        dp = torch_mesh.build_mesh(torch_mesh.MeshConfig(), "cpu")
        fsdp = torch_mesh.build_mesh(torch_mesh.MeshConfig(fsdp=WORLD), "cpu")
        out = {"rank": rank, "world": distributed.world_size(), "digests": _seeded_digests(),
               "dp": torch_mesh.mesh_summary(dp), "fsdp": torch_mesh.mesh_summary(fsdp)}

        for accum in (1, 2):
            trainer = _bert_trainer(
                inputs["bert"], dp, accum,
                os.path.join(ckpt, "bert_w2") if accum == 1 else None)
            state, metrics = trainer.step(trainer.init(),
                                          trainer.place_batch(_torch_batch(inputs["bert_batch"])))
            out[f"bert{accum}"] = {
                "loss": float(metrics["loss"]), "grads": _full_grads(state.model),
                "params": {k: v.clone() for k, v in state.model.state_dict().items()},
                "rows": int(trainer.place_batch(_torch_batch(inputs["bert_batch"]))["mlm_weights"].sum()),
            }
            if accum == 1:
                trainer.save(state)
                out["bert_w2"] = _payload_tensors(torch_trainer.state_payload(state))
        restorer = _bert_trainer(inputs["bert"], dp, checkpoint_dir=os.path.join(ckpt, "bert_w1"))
        out["bert_from_w1"] = _payload_tensors(torch_trainer.state_payload(
            restorer.restore(restorer.init())))

        for accum in (1, 2):
            trainer = _resnet_trainer(inputs["resnet"], dp, accum)
            state, metrics = trainer.step(
                trainer.init(), trainer.place_batch(_torch_batch(inputs["resnet_batch"])))
            out[f"resnet{accum}"] = {
                "loss": float(metrics["loss"]), "grads": _full_grads(state.model),
                "state": {k: v.clone() for k, v in state.model.state_dict().items()}}

        out["bn"] = _bn_sides(rank)

        for accum in (1, 2):
            out[f"moe_ddp{accum}"] = _moe_step(inputs["moe"], inputs["moe_batch"], dp, accum)
        out["moe_fsdp1"] = _moe_step(inputs["moe"], inputs["moe_batch"], fsdp)
        out["moe_unsynced"] = _moe_step(inputs["moe"], inputs["moe_batch"], dp, synced=False)

        trainer = _gpt_trainer(inputs["gpt"], fsdp, os.path.join(ckpt, "gpt_w2"))
        state = trainer.init()
        out["gpt_sharded"] = type(state.model.layer_0.mlp_in.weight).__name__
        state, metrics = trainer.step(state, trainer.place_batch(_torch_batch(inputs["gpt_batch"])))
        grads = _full_grads(state.model)
        payload = torch_trainer.state_payload(state)
        trainer.save(state)
        out["gpt"] = {"loss": float(metrics["loss"]), "grads": grads}
        if payload is not None:
            out["gpt_w2"] = _payload_tensors(payload)
        restorer = _gpt_trainer(inputs["gpt"], fsdp, os.path.join(ckpt, "gpt_w1"))
        payload = torch_trainer.state_payload(restorer.restore(restorer.init()))
        if payload is not None:
            out["gpt_from_w1"] = _payload_tensors(payload)
        torch.save(out, os.path.join(work, f"rank{rank}.pt"))
        distributed.barrier()
    finally:
        distributed.shutdown()


# -- launching worlds -------------------------------------------------------------

def _rank_env(rank: int, port: int) -> dict:
    env = dict(os.environ, **CHILD_ENV)
    env["PYTHONPATH"] = os.pathsep.join(filter(None, [REPO, env.get("PYTHONPATH")]))
    env.update({
        "TPU_WORKER_ID": str(rank),
        "TPU_WORKER_HOSTNAMES": ",".join(f"worker-{i}" for i in range(WORLD)),
        "JAX_NUM_PROCESSES": str(WORLD),
        "JAX_PROCESS_ID": str(rank),
        "TFJOB_COORDINATOR_OVERRIDE": f"127.0.0.1:{port}",
    })
    return env


def _start_world(argv, logs_dir):
    """WORLD ranks of `argv`, rendezvousing on a fresh port."""
    from tf_operator_tpu.runtime.process_kubelet import free_port

    port = free_port()
    procs = []
    for rank in range(WORLD):
        log = open(os.path.join(logs_dir, f"rank{rank}.log"), "w")
        procs.append((subprocess.Popen(
            [sys.executable] + argv, cwd=REPO, env=_rank_env(rank, port),
            stdout=log, stderr=subprocess.STDOUT,
        ), log))
    return procs


def _finish_world(procs, timeout):
    """Wait for every process (killing the rest at the deadline); their
    exit codes."""
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
    return codes


def _logs(logs_dir):
    return [open(os.path.join(logs_dir, f"rank{r}.log")).read() for r in range(WORLD)]


# -- the reference ----------------------------------------------------------------

def _keeping_grads():
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


def _reference_step(model, task, optimizer, batch, mesh, rules=None, accum_steps=1):
    """Params before and after one reference Trainer.step on the global
    batch, its gradient and its loss (and batch_stats, where the model
    has them), as numpy trees."""
    import jax
    import jax.numpy as jnp
    import optax

    from tf_operator_tpu.train import trainer as jax_trainer

    kwargs = {} if rules is None else {"rules": rules}
    trainer = jax_trainer.Trainer(
        model, task, optax.chain(_keeping_grads(), optimizer), mesh=mesh,
        accum_steps=accum_steps, **kwargs)
    jbatch = trainer.place_batch({k: jnp.asarray(v) for k, v in batch.items()})
    state = trainer.init(jax.random.PRNGKey(0), jbatch)
    to_np = lambda tree: jax.tree_util.tree_map(np.asarray, tree)  # noqa: E731
    before = (to_np(state.params), to_np(state.batch_stats))
    state, metrics = trainer.step(state, jbatch)
    return {"before": before, "after": (to_np(state.params), to_np(state.batch_stats)),
            "grads": to_np(state.opt_state[0]), "loss": float(metrics["loss"]),
            "aux": float(metrics.get("router_aux", float("nan")))}


@pytest.fixture(scope="module")
def reference():
    import dataclasses as dc

    import jax
    import jax.numpy as jnp
    import optax

    from tf_operator_tpu.models import bert as jax_bert
    from tf_operator_tpu.models import gpt as jax_gpt
    from tf_operator_tpu.models import moe as jax_moe
    from tf_operator_tpu.models import resnet as jax_resnet
    from tf_operator_tpu.parallel.mesh import MeshConfig, build_mesh, single_device_mesh
    from tf_operator_tpu.parallel.sharding import CONV_RULES as JAX_CONV_RULES
    from tf_operator_tpu.train import trainer as jax_trainer

    bert = jax_bert.BertForMLM(dc.replace(jax_bert.BERT_TINY, dtype=jnp.float32))
    bert_batch = _uneven_mlm_batch(jax_bert.BERT_TINY.vocab_size)
    resnet = jax_resnet.ResNet(**RESNET_SMALL, dtype=jnp.float32)
    gpt = jax_gpt.GPT(dc.replace(jax_gpt.GPT_TINY, dtype=jnp.float32))
    gpt_batch = _tokens(jax_gpt.GPT_TINY.vocab_size)
    moe = jax_moe.MoELM(jax_moe.MOE_TINY)
    moe_batch = _moe_batch(jax_moe.MOE_TINY.vocab_size)
    sgd = optax.sgd(SGD_LR, momentum=0.9)
    run = {
        "bert_batch": bert_batch, "resnet_batch": _image_batch(), "gpt_batch": gpt_batch,
        "moe_batch": moe_batch,
        "moe1": _reference_step(moe, jax_trainer.moe_task(moe), sgd, moe_batch,
                                single_device_mesh()),
        "moe2": _reference_step(moe, jax_trainer.moe_task(moe), sgd, moe_batch,
                                single_device_mesh(), accum_steps=2),
        "bert1": _reference_step(bert, jax_trainer.mlm_task(bert), sgd, bert_batch,
                                 single_device_mesh()),
        "bert2": _reference_step(bert, jax_trainer.mlm_task(bert), sgd, bert_batch,
                                 single_device_mesh(), accum_steps=2),
        "resnet1": _reference_step(resnet, jax_trainer.classification_task(resnet), sgd,
                                   _image_batch(), single_device_mesh(), rules=JAX_CONV_RULES),
        "resnet2": _reference_step(resnet, jax_trainer.classification_task(resnet), sgd,
                                   _image_batch(), single_device_mesh(), rules=JAX_CONV_RULES,
                                   accum_steps=2),
        "gpt": _reference_step(
            gpt, jax_trainer.causal_lm_task(gpt), optax.adamw(ADAM_LR, weight_decay=ADAM_WD),
            gpt_batch, build_mesh(MeshConfig(dp=1, fsdp=WORLD), devices=jax.devices()[:WORLD])),
    }
    run["weights"] = {
        "bert": bert_state_dict_from_flax(run["bert1"]["before"][0]),
        "resnet": resnet_state_dict_from_flax(*run["resnet1"]["before"]),
        "gpt": gpt_state_dict_from_flax(run["gpt"]["before"][0]),
        "moe": moe_state_dict_from_flax(run["moe1"]["before"][0]),
    }
    return run


@pytest.fixture(scope="module")
def world(reference, tmp_path_factory):
    """The world-2 run's per-rank results, after one-process checkpoints
    were written for it to restore; plus the one-process states."""
    work = str(tmp_path_factory.mktemp("world2"))
    ckpt = os.path.join(work, "ckpt")
    w = reference["weights"]
    one = {}
    trainer = _bert_trainer(w["bert"], checkpoint_dir=os.path.join(ckpt, "bert_w1"))
    state, metrics = trainer.step(trainer.init(),
                                  trainer.place_batch(_torch_batch(reference["bert_batch"])))
    one["bert"] = {"loss": float(metrics["loss"]), "grads": _full_grads(state.model)}
    trainer.save(state)
    one["bert_w1"] = _payload_tensors(torch_trainer.state_payload(state))
    trainer = _gpt_trainer(w["gpt"], checkpoint_dir=os.path.join(ckpt, "gpt_w1"))
    state, _ = trainer.step(trainer.init(),
                            trainer.place_batch(_torch_batch(reference["gpt_batch"])))
    trainer.save(state)
    one["gpt_w1"] = _payload_tensors(torch_trainer.state_payload(state))
    torch.save({"bert": w["bert"], "resnet": w["resnet"], "gpt": w["gpt"], "moe": w["moe"],
                "bert_batch": reference["bert_batch"], "resnet_batch": reference["resnet_batch"],
                "gpt_batch": reference["gpt_batch"], "moe_batch": reference["moe_batch"]},
               os.path.join(work, "inputs.pt"))

    def launch(attempt):
        logs = os.path.join(work, f"logs{attempt}")
        os.makedirs(logs)
        codes = _finish_world(_start_world([os.path.abspath(__file__), work], logs),
                              LAUNCH_TIMEOUT_S)
        assert codes == [0] * WORLD, (codes, _logs(logs))

    from tests.test_e2e import retry_flaky

    retry_flaky(launch)
    ranks = [torch.load(os.path.join(work, f"rank{r}.pt"), weights_only=False)
             for r in range(WORLD)]
    return {"ranks": ranks, "one": one, "ckpt": ckpt}


def _close(got, want, atol, what):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=atol, err_msg=what)


def _assert_same(got, want):
    assert set(got) == set(want)
    for name in want:
        assert torch.equal(got[name], want[name]), name


# -- the env and the mesh against the reference -------------------------------------

ENVS = [
    {},
    {"TPU_WORKER_ID": "1", "TPU_WORKER_HOSTNAMES": "a,b,c"},
    {"JAX_PROCESS_ID": "2", "TPU_WORKER_ID": "1", "TPU_WORKER_HOSTNAMES": "a,b,c"},
    {"JAX_NUM_PROCESSES": "4", "TPU_WORKER_HOSTNAMES": "a,b"},
    {"TPU_WORKER_HOSTNAMES": "h0,h1", "JAX_COORDINATOR_ADDRESS": "h0.svc:8476"},
    {"TPU_WORKER_HOSTNAMES": "h0,h1", "JAX_COORDINATOR_ADDRESS": "h0.svc:8476",
     "TFJOB_COORDINATOR_OVERRIDE": "127.0.0.1:1234", "TPU_WORKER_ID": "1"},
    {"TPU_WORKER_HOSTNAMES": ",x,,y,", "TPU_TOPOLOGY": "2x2", "TPU_ACCELERATOR_TYPE": "v5e-8"},
    {"JAX_PROCESS_ID": "one"},
    {"JAX_NUM_PROCESSES": ""},
]


@pytest.mark.parametrize("env", ENVS, ids=range(len(ENVS)))
def test_read_process_env_matches_the_reference(env):
    from tf_operator_tpu.parallel import distributed as jax_distributed

    try:
        want = dataclasses.asdict(jax_distributed.read_process_env(env))
    except ValueError as err:
        with pytest.raises(ValueError) as got:
            distributed.read_process_env(env)
        assert str(got.value) == str(err)
        return
    assert dataclasses.asdict(distributed.read_process_env(env)) == want


MESHES = [
    ({}, 1), ({}, 8), ({"fsdp": 2}, 8), ({"dp": 2, "fsdp": 2}, 4), ({"dp": 3}, 4),
    ({"fsdp": 3}, 8), ({"tp": 2, "fsdp": 2}, 8), ({"pp": 2, "ep": 2}, 8),
    ({"dp": 2, "fsdp": 4}, 4), ({"sp": 4, "tp": 2}, 8),
]


@pytest.mark.parametrize("config,n", MESHES, ids=range(len(MESHES)))
def test_mesh_config_resolve_matches_the_reference(config, n):
    from tf_operator_tpu.parallel.mesh import MeshConfig as JaxMeshConfig

    try:
        want = JaxMeshConfig(**config).resolve(n)
    except ValueError as err:
        with pytest.raises(ValueError) as got:
            torch_mesh.MeshConfig(**config).resolve(n)
        assert str(got.value) == str(err)
        return
    assert torch_mesh.MeshConfig(**config).resolve(n) == want


def test_one_process_has_no_mesh_and_refuses_what_is_not_ported():
    assert torch_mesh.build_mesh(torch_mesh.MeshConfig(), "cpu") is None
    assert torch_mesh.local_rows(None, 8) == slice(0, 8)
    with pytest.raises(ValueError, match="1 devices"):
        torch_mesh.build_mesh(torch_mesh.MeshConfig(fsdp=2), "cpu")
    # pp, ep, sp and tp are ported: in one process they do not fit, as fsdp=2 does not
    for axis in ("pp", "ep", "sp", "tp"):
        with pytest.raises(ValueError, match="1 devices"):
            torch_mesh.build_mesh(torch_mesh.MeshConfig(**{axis: 2}), "cpu")
    # so is fsdp together with them (the 2-D mesh, tests/test_torch_two_d.py)
    for axis in ("ep", "sp", "tp"):
        with pytest.raises(ValueError, match=r"1 devices not divisible by .*=4"):
            torch_mesh.build_mesh(torch_mesh.MeshConfig(fsdp=2, **{axis: 2}), "cpu")
    assert distributed.initialize("cpu", environ={}).num_processes == 1
    assert not distributed.is_initialized()


@pytest.mark.parametrize("cli", ["bert", "gpt"])
@pytest.mark.parametrize("flags", [["--tp", "2"], ["--sp", "2"], ["--sp-strategy", "ulysses"]])
def test_cli_refuses_unported_parallelism_naming_roadmap(cli, flags, capsys):
    from tf_operator_tpu_torch.train import bert as bert_cli
    from tf_operator_tpu_torch.train import gpt as gpt_cli

    module = {"bert": bert_cli, "gpt": gpt_cli}[cli]
    base = ["--preset", "tiny", "--device", "cpu"]
    args = module.parse_args(base + flags)
    # the flags are ported: each parses to its MeshConfig
    want = {"--tp": torch_mesh.MeshConfig(tp=2), "--sp": torch_mesh.MeshConfig(sp=2),
            "--sp-strategy": torch_mesh.MeshConfig()}[flags[0]]
    assert args.mesh == want
    assert args.sp_strategy == ("ulysses" if flags[0] == "--sp-strategy" else "ring")
    if flags[0] != "--sp-strategy":
        # with --fsdp > 1 they parse to the 2-D mesh (FSDP2 over each tp
        # rank's shards, or replicated over sp; tests/test_torch_two_d.py)
        two_d = module.parse_args(base + flags + ["--fsdp", "2"]).mesh
        assert two_d == dataclasses.replace(want, fsdp=2)
        assert "ROADMAP" not in capsys.readouterr().err
    assert module.parse_args(["--preset", "tiny", "--fsdp", "2"]).mesh == torch_mesh.MeshConfig(
        fsdp=2)


# -- the world of two against the reference -------------------------------------------

def test_world_ranks_and_meshes(world):
    for rank, out in enumerate(world["ranks"]):
        assert (out["rank"], out["world"]) == (rank, WORLD)
        assert out["dp"] == "dp=2xpp=1xfsdp=1xep=1xsp=1xtp=1"
        assert out["fsdp"] == "dp=1xpp=1xfsdp=2xep=1xsp=1xtp=1"


def test_every_rank_draws_the_same_initial_weights(world):
    first = world["ranks"][0]["digests"]
    assert set(first) == {"bert", "gpt", "resnet"}
    for out in world["ranks"][1:]:
        assert out["digests"] == first
    assert _seeded_digests() == first  # and a single process draws them too


@pytest.mark.parametrize("accum", [1, 2])
def test_ddp_mlm_step_with_uneven_masks_matches_the_reference(world, reference, accum):
    ref = reference[f"bert{accum}"]
    want_grads = bert_state_dict_from_flax(ref["grads"])
    want_params = bert_state_dict_from_flax(ref["after"][0])
    masked = [out[f"bert{accum}"]["rows"] for out in world["ranks"]]
    if accum == 1:
        assert masked[0] == 3 and masked[1] >= 40  # uneven across the ranks
    for out in world["ranks"]:
        got = out[f"bert{accum}"]
        _close(got["loss"], ref["loss"], LOSS_ATOL, "loss")
        assert set(got["grads"]) == set(want_grads)
        for name, want in want_grads.items():
            _close(got["grads"][name], want, GRAD_ATOL, f"grad {name}")
            _close(got["params"][name], want_params[name], PARAM_ATOL, f"param {name}")


def test_ddp_mlm_step_matches_the_port_in_one_process(world):
    one = world["one"]["bert"]
    for out in world["ranks"]:
        _close(out["bert1"]["loss"], one["loss"], LOSS_ATOL, "loss")
        for name, want in one["grads"].items():
            _close(out["bert1"]["grads"][name], want, GRAD_ATOL, name)
    # a mean of the two ranks' mean gradients would be another gradient
    ranks = world["ranks"]
    assert ranks[0]["bert1"]["rows"] != ranks[1]["bert1"]["rows"]


@pytest.mark.parametrize("accum", [1, 2])
def test_sync_batchnorm_step_matches_the_global_batch(world, reference, accum):
    """At accum_steps 2 each rank holds one row of each of the reference's
    microbatches (rows 0-1, then 2-3), and the running statistics are
    updated once per microbatch, from that microbatch's global sums."""
    ref = reference[f"resnet{accum}"]
    want_grads = resnet_state_dict_from_flax(ref["grads"], ref["before"][1])
    want_state = resnet_state_dict_from_flax(*ref["after"])
    stats = [n for n in want_state if n.endswith((".mean", ".var"))]
    assert stats
    for out in world["ranks"]:
        got = out[f"resnet{accum}"]
        _close(got["loss"], ref["loss"], LOSS_ATOL, "loss")
        for name in stats:
            _close(got["state"][name], want_state[name], STATS_ATOL, name)
        for name, grad in got["grads"].items():
            _close(grad, want_grads[name], GRAD_ATOL, f"grad {name}")
            _close(got["state"][name], want_state[name], PARAM_ATOL, f"param {name}")
    # rank-local statistics would be far from these: the halves differ
    halves = np.asarray(reference["resnet_batch"]["image"]).reshape(2, -1)
    assert abs(halves[0].mean() - halves[1].mean()) > 0.5


def test_batch_norm_syncs_only_over_the_group_parallelize_gives_it(world):
    """A TpuBatchNorm in a world of 2 keeps its own rank's statistics
    until sync_batch_norm (which parallelize calls) gives it the mesh's
    batch group; then both ranks hold the global batch's."""
    x = _bn_features()
    for rank, out in enumerate(world["ranks"]):
        got = out["bn"]
        assert not got["unset_group"] and got["synced_group"]
        _close(got["unset"], x[2 * rank:2 * rank + 2].mean(axis=(0, 2, 3)), STATS_ATOL, "local")
        _close(got["synced"], x.mean(axis=(0, 2, 3)), STATS_ATOL, "global")


def test_fsdp2_gpt_step_matches_the_reference_fsdp_mesh(world, reference):
    ref = reference["gpt"]
    want_grads = gpt_state_dict_from_flax(ref["grads"])
    want = gpt_state_dict_from_flax(ref["after"][0])
    start = gpt_state_dict_from_flax(ref["before"][0])
    got_params = {k[len("model."):]: v for k, v in world["ranks"][0]["gpt_w2"].items()
                  if k.startswith("model.")}
    strict = nonzero = 0
    for out in world["ranks"]:
        assert out["gpt_sharded"] == "DTensor"
        _close(out["gpt"]["loss"], ref["loss"], LOSS_ATOL, "loss")
        for name, grad in out["gpt"]["grads"].items():
            _close(grad, want_grads[name], GRAD_ATOL, f"grad {name}")
    for name, g in want_grads.items():
        noise = g.abs() <= GRAD_NOISE
        strict += int((~noise).sum())
        nonzero += int((g != 0).sum())
        p = got_params[name]
        _close(p[~noise], want[name][~noise], PARAM_ATOL, f"param {name}")
        moved = (p[noise] - start[name][noise]).abs()
        assert bool((moved <= ADAM_LR * (1 + 1e-3) + ADAM_LR * ADAM_WD
                     * start[name][noise].abs()).all()), name
    assert strict >= 0.99 * nonzero


@pytest.mark.parametrize("run, accum", [("moe_ddp1", 1), ("moe_ddp2", 2), ("moe_fsdp1", 1)])
def test_moe_step_matches_the_reference_global_batch(world, reference, run, accum):
    """MOE_TINY with a padded row, under DDP (accum 1 and 2) and FSDP2:
    the loss, router_aux, every gradient and parameter of the reference's
    step on the global batch (at accum 2 each microbatch's router means
    are its global rows', as the reference's per-microbatch aux)."""
    ref = reference[f"moe{accum}"]
    want_grads = moe_state_dict_from_flax(ref["grads"])
    want_params = moe_state_dict_from_flax(ref["after"][0])
    for out in world["ranks"]:
        got = out[run]
        assert got["synced"] == [True] * torch_moe.MOE_TINY.num_layers
        assert got["sharded"] == ("DTensor" if run == "moe_fsdp1" else "Parameter")
        _close(got["loss"], ref["loss"], LOSS_ATOL, "loss")
        _close(got["aux"], ref["aux"], AUX_ATOL, "router_aux")
        assert set(got["grads"]) == set(want_grads)
        for name, want in want_grads.items():
            _close(got["grads"][name], want, GRAD_ATOL, f"grad {name}")
            _close(got["params"][name], want_params[name], PARAM_ATOL, f"param {name}")


def test_moe_router_without_the_sync_misses_the_reference(world, reference):
    """The control: the same DDP step with each router's sync group unset
    averages per-rank products of means, another loss; its router_aux and
    its router gradients miss the reference by far more than the synced
    step's bounds."""
    ref = reference["moe1"]
    want_grads = moe_state_dict_from_flax(ref["grads"])
    for out in world["ranks"]:
        got = out["moe_unsynced"]
        assert abs(got["aux"] - ref["aux"]) > CONTROL_AUX_RTOL * abs(ref["aux"])
        miss = max(float((got["grads"][n] - want_grads[n]).abs().max())
                   for n in want_grads if "router_gate" in n)
        assert miss > CONTROL_GRAD_MISS, miss


# -- checkpoints across world sizes -------------------------------------------------

@pytest.mark.parametrize("model", ["bert", "gpt"])
def test_world2_checkpoint_restores_bit_equal_in_one_process(world, reference, model):
    w = reference["weights"][model]
    make = {"bert": _bert_trainer, "gpt": _gpt_trainer}[model]
    trainer = make(w, checkpoint_dir=os.path.join(world["ckpt"], f"{model}_w2"))
    state = trainer.restore(trainer.init())
    assert state is not None and state.step == 1
    _assert_same(_payload_tensors(torch_trainer.state_payload(state)),
                 world["ranks"][0][f"{model}_w2"])


@pytest.mark.parametrize("model", ["bert", "gpt"])
def test_one_process_checkpoint_restores_bit_equal_at_world2(world, model):
    want = world["one"][f"{model}_w1"]
    _assert_same(world["ranks"][0][f"{model}_from_w1"], want)
    if model == "bert":  # DDP: every rank holds the whole state
        _assert_same(world["ranks"][1]["bert_from_w1"], want)


# -- preemption at world 2 ----------------------------------------------------------

def test_sigterm_to_one_rank_stops_both_on_one_step(tmp_path):
    """train/gpt.py at world 2 with a long budget; SIGTERM to rank 1 only
    once it has logged step 3: both ranks exit 143 after the same step,
    and rank 0 wrote the one checkpoint, at that step."""

    def run(attempt):
        logs = str(tmp_path / f"logs{attempt}")
        ckpt = str(tmp_path / f"ckpt{attempt}")
        os.makedirs(logs)
        procs = _start_world([
            "-m", "tf_operator_tpu_torch.train.gpt", "--preset", "tiny", "--steps", "100000",
            "--batch-size", "4", "--seq-len", "32", "--log-every", "1", "--device", "cpu",
            "--checkpoint-dir", ckpt,
        ], logs)
        deadline = time.monotonic() + 120
        while "step 3 loss=" not in _logs(logs)[1]:
            if time.monotonic() > deadline or any(p.poll() is not None for p, _ in procs):
                _finish_world(procs, 1)
                raise AssertionError(_logs(logs))
            time.sleep(0.2)
        procs[1][0].send_signal(signal.SIGTERM)
        codes = _finish_world(procs, 120)
        texts = _logs(logs)
        assert codes == [143, 143], (codes, texts)
        steps = sorted(int(name) for name in os.listdir(ckpt) if name.isdigit())
        assert len(steps) == 1, steps
        for text in texts:
            assert f"preempted at step {steps[0]} " in text, text
        assert "another rank latched SIGTERM" in texts[0]

    from tests.test_e2e import retry_flaky

    retry_flaky(run)


if __name__ == "__main__":
    _world_main(sys.argv[1])
