"""The port's expert parallelism and MoE tensor parallelism (models/moe.py
MoEMlp's expert-parallel mode, parallel/sharding.py MOE_RULES' ep layout
and tp plan, the trainer's gathers) in one world of 4 gloo processes on
the CPU, held against the JAX reference under MOE_RULES on the virtual
CPU mesh at the same factorization, f32.

- MoELM (dense and MoE layers, router_aux_weight and router_z_weight
  non-zero, a padded row) from converted reference weights at dp 2 x ep
  2, ep 2 x tp 2 and dp 2 x tp 2: the forward's logits (2e-5, as the
  reference's test_gspmd_ep_matches_replicated), one step's loss (1e-5),
  each rank's gradient shard (1e-4) and its parameters after 2 AdamW
  steps (1e-4, tests/test_torch_tensor_parallel.py's rule for noise-level
  gradients).
- The checkpoint saved at ep 2 x tp 2 (gathered over tp and ep) restores
  bit-equal in one process; the converter's slice for each rank is what
  the laid-out model holds.
- Two planted controls at ep 2 x tp 2, each of which must miss the
  gradient bound on the routers: the gates not copied to the expert
  group (each rank's router then misses the other ranks' combine paths)
  and the same with the router's gradient summed over the group (the
  aux and z losses, which every rank computes whole, counted ep x tp
  times).
- The MoE CLI's --ep 2 --tp 2 parses to its mesh, and so does --fsdp
  with --ep (fsdp x ep trains in tests/test_torch_two_d.py).

The world is this file run as a script (`_world_main`), spawned once per
module with tests/test_torch_tensor_parallel.py's helpers.
"""

import dataclasses
import os
import sys

import numpy as np
import pytest
import torch

from tests import test_torch_tensor_parallel as tpt
from tf_operator_tpu_torch.models import moe as torch_moe
from tf_operator_tpu_torch.models.convert import moe_state_dict_from_flax
from tf_operator_tpu_torch.parallel import distributed
from tf_operator_tpu_torch.parallel import mesh as torch_mesh
from tf_operator_tpu_torch.parallel import sharding
from tf_operator_tpu_torch.train import trainer as torch_trainer

from torch_threads import one_torch_thread  # noqa: F401

WORLD = 4
LOGIT_ATOL = 2e-5
MESHES = {"dp2_ep2": {"dp": 2, "ep": 2}, "ep2_tp2": {"ep": 2, "tp": 2},
          "dp2_tp2": {"dp": 2, "tp": 2}}
CONTROLS = ("gates_not_copied", "router_grad_summed")


def cfg():
    """Four layers (dense and MoE alternating), 4 experts top-2, both router
    losses weighted enough that counting them wrongly shows."""
    return torch_moe.MoEConfig(
        vocab_size=256, hidden_size=32, num_layers=4, num_heads=4, intermediate_size=64,
        max_position_embeddings=64, num_experts=4, experts_per_token=2, moe_every=2,
        router_aux_weight=0.1, router_z_weight=0.01, dtype=torch.float32)


def moe_batch(b=8, s=16, seed=21):
    ids = np.random.default_rng(seed).integers(0, 256, (b, s)).astype(np.int32)
    mask = np.ones((b, s), np.int32)
    mask[1, 10:] = 0
    return {"input_ids": ids, "labels": ids, "attention_mask": mask}


def port_trainer(weights, mesh=None, checkpoint_dir=None):
    model = torch_moe.MoELM(cfg())
    model.load_state_dict(weights)
    return torch_trainer.Trainer(
        model, torch_trainer.moe_task(), learning_rate=tpt.ADAM_LR, weight_decay=tpt.ADAM_WD,
        device="cpu", mesh=mesh, rules=sharding.MOE_RULES, checkpoint_dir=checkpoint_dir)


def _grads(model):
    return {n: p.grad.detach().clone() for n, p in model.named_parameters()}


def port_run(weights, flax, batch, mesh, checkpoint_dir=None):
    """The laid-out model's converter check and forward logits (whole
    vocab, this rank's rows), then STEPS AdamW steps: step 1's loss and
    gradients, the parameters after, and (checkpoint_dir) the gathered
    payload."""
    trainer = port_trainer(weights, mesh, checkpoint_dir)
    state = trainer.init()
    want = moe_state_dict_from_flax(flax, mesh=mesh)
    got = state.model.state_dict()
    out = {"converted_equal": set(got) == set(want) and all(
        torch.equal(got[n], want[n]) for n in want)}
    placed = trainer.place_batch(tpt.torch_batch(batch))
    with torch.no_grad():
        logits, _ = trainer.module(placed["input_ids"], placed["attention_mask"])
    shard = sharding.vocab_shard(trainer.module)
    out["logits"] = logits if shard is None else distributed.all_gather(logits, shard.group, -1)
    state, metrics = trainer.step(state, placed)
    out.update(loss=float(metrics["loss"]), grads=_grads(state.model))
    for _ in range(tpt.STEPS - 1):
        state, metrics = trainer.step(state, placed)
    out["params"] = {n: p.detach().clone() for n, p in state.model.named_parameters()}
    out["last_loss"] = float(metrics["loss"])
    out["local_experts"] = state.model.layer_1.moe_mlp.expert_in.shape[0]
    if checkpoint_dir is not None:
        trainer.save(state)
        payload = torch_trainer.state_payload(state)
        out["payload"] = None if payload is None else tpt.payload_tensors(payload)
    return out


def planted_grads(weights, batch, mesh, control):
    """Step 1's gradients with a planted fault in the routers' paths."""
    trainer = port_trainer(weights, mesh)
    state = trainer.init()
    routers = [m for m in state.model.modules() if isinstance(m, torch_moe.TopKRouter)]
    for router in routers:
        router.combine_group = None
    state, _ = trainer.step(state, trainer.place_batch(tpt.torch_batch(batch)))
    grads = _grads(state.model)
    if control == "router_grad_summed":
        for name in grads:
            if "router_gate" in name:
                grads[name] = distributed.all_reduce(grads[name], mesh.expert_group)
    return grads


# -- one process of the world ---------------------------------------------------

def _world_main(work: str) -> None:
    distributed.initialize("cpu")
    torch.set_num_threads(1)
    try:
        inputs = torch.load(os.path.join(work, "inputs.pt"), weights_only=False)
        out = {"rank": distributed.rank()}
        for name, axes in MESHES.items():
            mesh = torch_mesh.build_mesh(torch_mesh.MeshConfig(**axes), "cpu")
            ckpt = os.path.join(work, "ckpt") if name == "ep2_tp2" else None
            out[name] = port_run(inputs["weights"], inputs["flax"], inputs["batch"], mesh, ckpt)
            out[name]["coordinate"] = dict(mesh.coordinate)
            out[name]["summary"] = torch_mesh.mesh_summary(mesh)
            if name == "ep2_tp2":
                out["controls"] = {c: planted_grads(inputs["weights"], inputs["batch"], mesh, c)
                                   for c in CONTROLS}
        torch.save(out, os.path.join(work, f"rank{out['rank']}.pt"))
        distributed.barrier()
    finally:
        distributed.shutdown()


# -- the reference ----------------------------------------------------------------

def jax_cfg():
    import jax.numpy as jnp

    from tf_operator_tpu.models import moe as jax_moe

    fields = {f.name: getattr(cfg(), f.name) for f in dataclasses.fields(cfg())}
    return jax_moe.MoEConfig(**{**fields, "dtype": jnp.float32})


def reference_steps(model, batch, mesh):
    """The reference Trainer's STEPS AdamW steps under MOE_RULES on
    `mesh`: its logits, params before and after, step 1's gradient and
    loss, converted to the port's names."""
    import jax
    import jax.numpy as jnp
    import optax

    from tf_operator_tpu.parallel.sharding import MOE_RULES
    from tf_operator_tpu.train import trainer as jax_trainer

    trainer = jax_trainer.Trainer(
        model, jax_trainer.moe_task(model),
        optax.chain(tpt.keeping_grads(), optax.adamw(tpt.ADAM_LR, weight_decay=tpt.ADAM_WD)),
        mesh=mesh, rules=MOE_RULES)
    jbatch = trainer.place_batch({k: jnp.asarray(v) for k, v in batch.items()})
    state = trainer.init(jax.random.PRNGKey(0), jbatch)
    to_np = lambda tree: jax.tree_util.tree_map(np.asarray, tree)  # noqa: E731
    before = to_np(state.params)
    logits = np.asarray(model.apply({"params": state.params}, jbatch["input_ids"],
                                    jbatch["attention_mask"]))
    state, metrics = trainer.step(state, jbatch)
    grads, loss = to_np(state.opt_state[0]), float(metrics["loss"])
    for _ in range(tpt.STEPS - 1):
        state, metrics = trainer.step(state, jbatch)
    return {"before": moe_state_dict_from_flax(before), "flax_before": before,
            "grads": moe_state_dict_from_flax(grads), "loss": loss, "logits": logits,
            "after": moe_state_dict_from_flax(to_np(state.params)),
            "last_loss": float(metrics["loss"])}


def jax_mesh(axes):
    import jax

    from tf_operator_tpu.parallel.mesh import MeshConfig, build_mesh

    return build_mesh(MeshConfig(**{"dp": 1, **axes}), devices=jax.devices()[:WORLD])


@pytest.fixture(scope="module")
def reference():
    from tf_operator_tpu.models import moe as jax_moe

    model = jax_moe.MoELM(jax_cfg())
    batch = moe_batch()
    run = {name: reference_steps(model, batch, jax_mesh(axes)) for name, axes in MESHES.items()}
    run["batch"] = batch
    return run


@pytest.fixture(scope="module")
def world(reference, tmp_path_factory):
    work = str(tmp_path_factory.mktemp("ep"))
    first = reference["dp2_ep2"]
    torch.save({"weights": first["before"], "flax": first["flax_before"],
                "batch": reference["batch"]}, os.path.join(work, "inputs.pt"))
    ranks = tpt.run_world(os.path.abspath(__file__), work, WORLD)
    return {"ranks": ranks, "ckpt": os.path.join(work, "ckpt")}


def _plans(mesh_axes, coordinate):
    """TensorParallel stand-ins of a rank's tp plan and ep layout."""
    plans = []
    if mesh_axes.get("tp", 1) > 1:
        plans.append(sharding.TensorParallel(None, coordinate["tp"], mesh_axes["tp"],
                                             sharding.MOE_RULES.tp))
    if mesh_axes.get("ep", 1) > 1:
        plans.append(sharding.TensorParallel(None, coordinate["ep"], mesh_axes["ep"],
                                             sharding.MOE_RULES.ep))
    return plans


def _local(name, tensor, plans):
    return sharding.local_slice(name, tensor, plans)


# -- the world against the reference ----------------------------------------------------

def test_world_lays_out_the_ep_and_tp_meshes(world):
    for rank, out in enumerate(world["ranks"]):
        assert out["ep2_tp2"]["coordinate"] == {"dp": 0, "pp": 0, "fsdp": 0, "ep": rank // 2,
                                                "sp": 0, "tp": rank % 2}
        assert out["ep2_tp2"]["summary"] == "dp=1xpp=1xfsdp=1xep=2xsp=1xtp=2"
        assert out["dp2_ep2"]["coordinate"]["dp"] == rank // 2
        assert out["dp2_tp2"]["summary"] == "dp=2xpp=1xfsdp=1xep=1xsp=1xtp=2"
        assert out["ep2_tp2"]["local_experts"] == 2 and out["dp2_tp2"]["local_experts"] == 4


@pytest.mark.parametrize("name", list(MESHES))
def test_moe_rules_step_matches_the_reference_mesh(world, reference, name):
    """Logits, loss, each rank's gradient shard and its parameters after 2
    AdamW steps against the reference's MOE_RULES step on the same mesh."""
    ref = reference[name]
    axes = MESHES[name]
    rows = 8 // axes.get("dp", 1)
    for out in world["ranks"]:
        got = out[name]
        assert got["converted_equal"]
        dp = got["coordinate"]["dp"]
        tpt.close(got["logits"], ref["logits"][dp * rows:(dp + 1) * rows], LOGIT_ATOL, "logits")
        plans = _plans(axes, got["coordinate"])
        sliced = {k: {n: _local(n, v, plans) for n, v in ref[k].items()}
                  for k in ("grads", "before", "after")}
        for name_, want in sliced["grads"].items():
            assert got["grads"][name_].shape == want.shape, name_
        tpt.check_against_reference(got, {**ref, **sliced}, 0, 1)


@pytest.mark.parametrize("control", CONTROLS)
def test_planted_router_faults_miss_the_gradient_bound(world, reference, control):
    """Without the gates copied to the expert group, each rank's router
    gradient lacks the other ranks' combine paths; summing it over the
    group then counts the router's own losses ep x tp times. Both miss
    the bound the real step meets, on the routers of every rank."""
    ref = reference["ep2_tp2"]
    for out in world["ranks"]:
        got = out["controls"][control]
        misses = [float((got[n] - ref["grads"][n]).abs().max())
                  for n in got if "router_gate" in n]
        assert len(misses) == 2 and min(misses) > 10 * tpt.GRAD_ATOL, misses
        real = [float((out["ep2_tp2"]["grads"][n] - ref["grads"][n]).abs().max())
                for n in got if "router_gate" in n]
        assert max(real) <= tpt.GRAD_ATOL


def test_ep2_tp2_checkpoint_restores_bit_equal_in_one_process(world, reference):
    gathered = world["ranks"][0]["ep2_tp2"]["payload"]
    assert all(out["ep2_tp2"]["payload"] is None for out in world["ranks"][1:])
    trainer = port_trainer(reference["ep2_tp2"]["before"], checkpoint_dir=world["ckpt"])
    state = trainer.restore(trainer.init())
    assert state is not None and state.step == tpt.STEPS
    got = tpt.payload_tensors(torch_trainer.state_payload(state))
    assert set(got) == set(gathered)
    for name, want in gathered.items():
        assert torch.equal(got[name], want), name
    # the gathered tensors hold each rank's own shards
    for out in world["ranks"]:
        plans = _plans(MESHES["ep2_tp2"], out["ep2_tp2"]["coordinate"])
        for name, local in out["ep2_tp2"]["params"].items():
            assert torch.equal(_local(name, gathered[f"model.{name}"], plans), local), name


def test_moe_rules_split_what_the_reference_splits():
    """The experts' dimension on ep, their intermediate on tp (expert_in's
    last, expert_out's middle), TRANSFORMER_RULES' plan for the rest,
    the router replicated."""
    rules = sharding.MOE_RULES
    assert sharding.tp_rule("layer_1.moe_mlp.expert_in", rules.ep) == (0, "expert")
    assert sharding.tp_rule("layer_1.moe_mlp.expert_out", rules.ep) == (0, "expert")
    assert sharding.tp_rule("layer_1.moe_mlp.expert_in", rules.tp) == (2, "expert")
    assert sharding.tp_rule("layer_1.moe_mlp.expert_out", rules.tp) == (1, "expert")
    assert sharding.tp_rule("layer_1.moe_mlp.router_gate.router.weight", rules.tp) is None
    assert sharding.tp_rule("layer_1.moe_mlp.router_gate.router.weight", rules.ep) is None
    assert sharding.tp_rule("layer_0.mlp_in.weight", rules.tp) == (0, "column")
    assert sharding.tp_rule("lm_head.weight", rules.tp) == (0, "head")
    assert sharding.TRANSFORMER_RULES.ep == ()


def test_cli_takes_ep_and_tp_and_refuses_fsdp_with_ep(capsys):
    """--ep and --tp parse to their mesh; --fsdp with --ep, refused until
    item 4's 2-D line was ported, now parses to fsdp x ep, which in one
    process does not fit, as any mesh of 4 does not."""
    from tf_operator_tpu_torch.train import moe as moe_cli

    args = moe_cli.parse_args(["--preset", "base", "--ep", "2", "--tp", "2"])
    assert args.mesh == torch_mesh.MeshConfig(ep=2, tp=2)
    assert moe_cli.parse_args(["--ep", "2", "--fsdp", "2"]).mesh == torch_mesh.MeshConfig(
        fsdp=2, ep=2)
    assert "ROADMAP" not in capsys.readouterr().err
    with pytest.raises(ValueError, match="1 devices"):
        torch_mesh.build_mesh(torch_mesh.MeshConfig(fsdp=2, ep=2), "cpu")


if __name__ == "__main__":
    _world_main(sys.argv[1])
