"""The port's 2-D training mesh (parallel/mesh.py's FSDP2 DeviceMesh,
parallel/sharding.py's FSDP2 over the tp plan's and the ep layout's local
tensors, the trainer's gathers) in one world of 4 gloo processes on the
CPU, held against the JAX reference at the same MeshConfig on 4 of the 8
virtual CPU devices, f32, from converted reference weights on the same
numpy batch:

- GPT (GPT_TINY's widths, 4 heads) at fsdp 2 x tp 2;
- BERT_TINY with a padded row at fsdp 2 x tp 2;
- ViT (VIT_TINY's widths) at fsdp 2 x tp 2;
- GPT at fsdp 2 x sp 2 with ring attention (FSDP2 replicating over sp),
  also with 2 accumulated microbatches (the sp replicate's all-reduce
  deferred with FSDP2's reduce-scatter to the last);
- the MoE LM of tests/test_torch_expert_parallel.py (router_z_weight >
  0, a padded row) at fsdp 2 x ep 2, and in a second world, of 8, at
  fsdp 2 x ep 2 x tp 2.

Each rank's step-1 loss (1e-5), its FSDP2 shard of each gradient (1e-4)
and of each parameter after 2 AdamW steps (1e-4,
tests/test_torch_tensor_parallel.py's rule for noise-level gradients),
against the matching chunk of the reference's: its tp or ep slice, then
FSDP2's dim-0 chunk for the rank's fsdp coordinate. Then:

- the GPT checkpoint saved at fsdp 2 x tp 2 (gathered over fsdp, then
  tp) restores bit-equal in one process, and at dp 2 x fsdp 2 in the
  same world, where every rank holds its chunk of the gathered tensors;
- generate(mesh=) at fsdp 2 x tp 2 gives the reference's greedy chain at
  that mesh, with the int8 KV cache too (the reference's
  tests/test_gpt.py sharded int8 case), and the trained FSDP2 model's
  chain is the one process's on the restored checkpoint;
- the MoE LM with bf16 experts beside f32 weights (MoE-base's dtypes) at
  fsdp 2 x ep 2: FSDP2 takes a unit of one dtype, so the experts and the
  router are units of their own; one step runs and agrees with the one
  process's within bf16's bound.

Each world is this file run as a script (`_world_main`), spawned once per
module with tests/test_torch_tensor_parallel.py's helpers.
"""

import dataclasses
import os
import sys

import numpy as np
import pytest
import torch

from tests import test_torch_expert_parallel as ept
from tests import test_torch_tensor_parallel as tpt
from tf_operator_tpu_torch.models import gpt as torch_gpt
from tf_operator_tpu_torch.models import moe as torch_moe
from tf_operator_tpu_torch.parallel import distributed
from tf_operator_tpu_torch.parallel import mesh as torch_mesh
from tf_operator_tpu_torch.parallel import ring_attention as torch_ring
from tf_operator_tpu_torch.parallel import sharding
from tf_operator_tpu_torch.train import trainer as torch_trainer

from torch_threads import one_torch_thread  # noqa: F401

WORLD = 4
WIDE_WORLD = 8
FSDP = 2
# name -> (model kind, the mesh's axes): the world of 4's meshes
MESHES = {
    "gpt_fsdp2_tp2": ("gpt", {"fsdp": 2, "tp": 2}),
    "bert_fsdp2_tp2": ("bert", {"fsdp": 2, "tp": 2}),
    "vit_fsdp2_tp2": ("vit", {"fsdp": 2, "tp": 2}),
    "gpt_fsdp2_sp2": ("gpt", {"fsdp": 2, "sp": 2}),
    "gpt_fsdp2_sp2_accum2": ("gpt", {"fsdp": 2, "sp": 2}),
    "moe_fsdp2_ep2": ("moe", {"fsdp": 2, "ep": 2}),
}
# the world of 8's
WIDE_MESHES = {"moe_fsdp2_ep2_tp2": ("moe", {"fsdp": 2, "ep": 2, "tp": 2})}
ALL_MESHES = {**MESHES, **WIDE_MESHES}
ACCUM = {"gpt_fsdp2_sp2_accum2": 2}
CHECKPOINTED = "gpt_fsdp2_tp2"


def _local(tensor):
    return sharding.local_tensor(tensor).detach().clone()


def port_run(kind, axes, weights, batch, mesh, checkpoint_dir=None, accum_steps=1):
    """tests/test_torch_tensor_parallel.py's port_steps on this mesh, each
    tensor this rank's FSDP2 shard (no gather): step 1's loss and
    gradients, the parameters after STEPS AdamW steps, and with a
    checkpoint_dir the checkpoint written there and the gathered payload
    (rank 0's)."""
    sequence = axes.get("sp", 1) > 1
    if kind == "moe":
        trainer = ept.port_trainer(weights, mesh, checkpoint_dir)
    else:
        ring = torch_ring.make_ring_attention(mesh, causal=True) if sequence else None
        trainer = tpt.port_trainer(kind, weights, mesh, attention_fn=ring,
                                   shard_sequence=sequence, checkpoint_dir=checkpoint_dir,
                                   accum_steps=accum_steps)
    state = trainer.init()
    placed = trainer.place_batch(tpt.torch_batch(batch))
    state, metrics = trainer.step(state, placed)
    out = {"loss": float(metrics["loss"]),
           "grads": {n: _local(p.grad) for n, p in state.model.named_parameters()},
           "sharded": sharding.is_fully_sharded(state.model)}
    for _ in range(tpt.STEPS - 1):
        state, metrics = trainer.step(state, placed)
    out["params"] = {n: _local(p) for n, p in state.model.named_parameters()}
    out["last_loss"] = float(metrics["loss"])
    if checkpoint_dir is not None:
        trainer.save(state)
        payload = torch_trainer.state_payload(state)
        out["payload"] = None if payload is None else tpt.payload_tensors(payload)
    return out, state


def restore_at(weights, mesh, checkpoint_dir):
    """The GPT checkpoint restored into a trainer on `mesh`: this rank's
    parameter and moment shards, and the payload gathered again."""
    trainer = tpt.port_trainer("gpt", weights, mesh, checkpoint_dir=checkpoint_dir)
    state = trainer.restore(trainer.init())
    out = {"step": state.step,
           "params": {n: _local(p) for n, p in state.model.named_parameters()},
           "moments": {n: _local(state.optimizer.state[p]["exp_avg"])
                       for n, p in state.model.named_parameters()}}
    payload = torch_trainer.state_payload(state)
    out["payload"] = None if payload is None else tpt.payload_tensors(payload)
    return out


def wrong_shape_refusal(weights, mesh, checkpoint_dir):
    """The GPT checkpoint with one matrix cut to its first row (a shape
    that copy_ would broadcast) loaded at `mesh`: (the tensor's name, the
    ValueError's text, or None where it loads)."""
    trainer = tpt.port_trainer("gpt", weights, mesh)
    state = trainer.init()
    ckpt = torch_trainer.Checkpointer(checkpoint_dir)
    payload = torch.load(ckpt.path(ckpt.latest_step()), weights_only=True)
    name = next(n for n, p in state.model.named_parameters() if p.dim() == 2)
    payload["model"][name] = payload["model"][name][:1]
    try:
        torch_trainer._apply_payload(state, payload)
    except ValueError as err:
        return name, str(err)
    return name, None


def bf16_moe_step(weights, batch, mesh=None):
    """One AdamW step of the MoE LM with bf16 experts (MoEConfig's dtype:
    the experts' kernels, f32 elsewhere) from the f32 weights: its loss,
    the experts' dtype and whether the model is sharded."""
    cfg = ept.cfg()
    model = torch_moe.MoELM(dataclasses.replace(cfg, dtype=torch.bfloat16))
    model.load_state_dict(weights)
    trainer = torch_trainer.Trainer(
        model, torch_trainer.moe_task(), learning_rate=tpt.ADAM_LR, weight_decay=tpt.ADAM_WD,
        device="cpu", mesh=mesh, rules=sharding.MOE_RULES)
    state = trainer.init()
    state, metrics = trainer.step(state, trainer.place_batch(tpt.torch_batch(batch)))
    return {"loss": float(metrics["loss"]), "sharded": sharding.is_fully_sharded(state.model),
            "expert_dtype": str(state.model.layer_1.moe_mlp.expert_in.dtype)}


# -- one process of the world ---------------------------------------------------

def _world_main(work: str) -> None:
    distributed.initialize("cpu")
    torch.set_num_threads(1)
    try:
        inputs = torch.load(os.path.join(work, "inputs.pt"), weights_only=False)
        out = {"rank": distributed.rank()}
        ckpt = os.path.join(work, "ckpt")
        meshes = MESHES if distributed.world_size() == WORLD else WIDE_MESHES
        for name, (kind, axes) in meshes.items():
            mesh = torch_mesh.build_mesh(torch_mesh.MeshConfig(**axes), "cpu")
            out[name], state = port_run(kind, axes, inputs["weights"][name],
                                        inputs["batches"][name], mesh,
                                        ckpt if name == CHECKPOINTED else None,
                                        ACCUM.get(name, 1))
            out[name]["coordinate"] = dict(mesh.coordinate)
            out[name]["summary"] = torch_mesh.mesh_summary(mesh)
            if name == CHECKPOINTED:
                prompt = torch.tensor(inputs["prompt"]).long()
                out["trained_chain"] = torch_gpt.generate(
                    state.model, prompt, tpt.NEW_TOKENS, mesh=mesh).tolist()
                model = torch_gpt.GPT(tpt.gpt_cfg())
                model.load_state_dict(inputs["weights"][name])
                out["generated"] = torch_gpt.generate(
                    model, prompt, tpt.NEW_TOKENS, mesh=mesh).tolist()
                out["generated_int8"] = torch_gpt.generate(
                    model, prompt, tpt.NEW_TOKENS, mesh=mesh, kv_quant_int8=True).tolist()
                out["wrong_shape"] = wrong_shape_refusal(inputs["weights"][name], mesh, ckpt)
            del state
        if meshes is WIDE_MESHES:
            torch.save(out, os.path.join(work, f"rank{out['rank']}.pt"))
            distributed.barrier()
            return
        mesh = torch_mesh.build_mesh(torch_mesh.MeshConfig(fsdp=FSDP, ep=2), "cpu")
        out["moe_bf16"] = bf16_moe_step(inputs["weights"]["moe_fsdp2_ep2"],
                                        inputs["batches"]["moe_fsdp2_ep2"], mesh)
        fsdp_alone = torch_mesh.build_mesh(torch_mesh.MeshConfig(fsdp=FSDP), "cpu")
        out["fsdp_alone"] = restore_at(inputs["weights"][CHECKPOINTED], fsdp_alone, ckpt)
        out["fsdp_alone"]["coordinate"] = dict(fsdp_alone.coordinate)
        torch.save(out, os.path.join(work, f"rank{out['rank']}.pt"))
        distributed.barrier()
    finally:
        distributed.shutdown()


# -- the reference ----------------------------------------------------------------

def batches():
    return {"gpt_fsdp2_tp2": tpt.gpt_batch(), "bert_fsdp2_tp2": tpt.mlm_batch(),
            "vit_fsdp2_tp2": tpt.image_batch(),
            "gpt_fsdp2_sp2": tpt.gpt_batch(), "gpt_fsdp2_sp2_accum2": tpt.gpt_batch(),
            "moe_fsdp2_ep2": ept.moe_batch(), "moe_fsdp2_ep2_tp2": ept.moe_batch()}


def _reference_run(name, batch):
    from tf_operator_tpu.models import moe as jax_moe
    from tf_operator_tpu.parallel.ring_attention import make_ring_attention

    kind, axes = ALL_MESHES[name]
    mesh = tpt.jax_mesh(**axes)
    if kind == "moe":
        return ept.reference_steps(jax_moe.MoELM(ept.jax_cfg()), batch, mesh)
    sequence = axes.get("sp", 1) > 1
    ring = make_ring_attention(mesh, causal=True) if sequence else None
    model = tpt.jax_models(attention_fn=ring)[kind]
    return tpt.reference_steps(kind, model, batch, mesh, shard_sequence=sequence,
                               accum_steps=ACCUM.get(name, 1))


@pytest.fixture(scope="module")
def reference():
    import jax.numpy as jnp

    from tf_operator_tpu.models import gpt as jax_gpt

    run = {"batches": batches()}
    for name in ALL_MESHES:
        run[name] = _reference_run(name, run["batches"][name])
    prompt = tpt.gpt_batch(*tpt.PROMPT, seed=11)["input_ids"]
    params = tpt._flax_tree(run[CHECKPOINTED]["before"])
    mesh = tpt.jax_mesh(**MESHES[CHECKPOINTED][1])
    for key, int8 in (("generated", False), ("generated_int8", True)):
        run[key] = np.asarray(jax_gpt.generate(
            tpt.jax_models()["gpt"].config, params, jnp.asarray(prompt), tpt.NEW_TOKENS,
            mesh=mesh, kv_quant_int8=int8)).tolist()
    run["prompt"] = prompt
    return run


@pytest.fixture(scope="module")
def world(reference, tmp_path_factory):
    work = str(tmp_path_factory.mktemp("two_d"))
    torch.save({"weights": {name: reference[name]["before"] for name in MESHES},
                "batches": reference["batches"], "prompt": reference["prompt"]},
               os.path.join(work, "inputs.pt"))
    ranks = tpt.run_world(os.path.abspath(__file__), work, WORLD)
    return {"ranks": ranks, "ckpt": os.path.join(work, "ckpt")}


@pytest.fixture(scope="module")
def wide_world(reference, tmp_path_factory):
    work = str(tmp_path_factory.mktemp("two_d_wide"))
    torch.save({"weights": {name: reference[name]["before"] for name in WIDE_MESHES},
                "batches": reference["batches"]}, os.path.join(work, "inputs.pt"))
    return {"ranks": tpt.run_world(os.path.abspath(__file__), work, WIDE_WORLD)}


def _plans(kind, axes, coordinate):
    """TensorParallel stand-ins of a rank's tp plan and ep layout."""
    rules = sharding.MOE_RULES if kind == "moe" else sharding.TRANSFORMER_RULES
    plans = []
    for axis, plan in (("tp", rules.tp), ("ep", rules.ep)):
        if axes.get(axis, 1) > 1:
            plans.append(sharding.TensorParallel(None, coordinate[axis], axes[axis], plan))
    return plans


def fsdp_chunk(tensor, index, size=FSDP):
    """FSDP2's dim-0 chunk `index` of `size` (torch.chunk's cut, the last
    ones short or empty)."""
    step = -(-tensor.shape[0] // size)
    return tensor[index * step:(index + 1) * step]


def rank_slice(name, full, kind, axes, coordinate):
    """A full tensor's shard on a rank: its tp or ep slice, then its fsdp chunk."""
    local = sharding.local_slice(name, full, _plans(kind, axes, coordinate))
    return fsdp_chunk(local, coordinate["fsdp"])


# -- the world against the reference -------------------------------------------------

def test_world_lays_out_the_two_d_meshes(world):
    for rank, out in enumerate(world["ranks"]):
        assert out["rank"] == rank
        assert out["gpt_fsdp2_tp2"]["coordinate"] == {
            "dp": 0, "pp": 0, "fsdp": rank // 2, "ep": 0, "sp": 0, "tp": rank % 2}
        assert out["gpt_fsdp2_tp2"]["summary"] == "dp=1xpp=1xfsdp=2xep=1xsp=1xtp=2"
        assert out["gpt_fsdp2_sp2"]["coordinate"]["sp"] == rank % 2
        assert out["moe_fsdp2_ep2"]["summary"] == "dp=1xpp=1xfsdp=2xep=2xsp=1xtp=1"
        assert all(out[name]["sharded"] for name in MESHES)


def test_wide_world_lays_out_fsdp_ep_tp(wide_world):
    for rank, out in enumerate(wide_world["ranks"]):
        got = out["moe_fsdp2_ep2_tp2"]
        assert got["summary"] == "dp=1xpp=1xfsdp=2xep=2xsp=1xtp=2" and got["sharded"]
        assert got["coordinate"] == {"dp": 0, "pp": 0, "fsdp": rank // 4, "ep": rank // 2 % 2,
                                     "sp": 0, "tp": rank % 2}


@pytest.mark.parametrize("name", list(ALL_MESHES))
def test_two_d_steps_match_the_reference_mesh(request, reference, name):
    """Loss, each rank's FSDP2 shard of every gradient and of every
    parameter after 2 AdamW steps against the reference's at the same
    MeshConfig."""
    kind, axes = ALL_MESHES[name]
    ref = reference[name]
    ranks = request.getfixturevalue("world" if name in MESHES else "wide_world")["ranks"]
    for out in ranks:
        got = out[name]
        coordinate = got["coordinate"]
        sliced = {key: {n: rank_slice(n, v, kind, axes, coordinate)
                        for n, v in ref[key].items()}
                  for key in ("grads", "before", "after")}
        for param, want in sliced["grads"].items():
            assert got["grads"][param].shape == want.shape, param
        tpt.check_against_reference(got, {**ref, **sliced}, 0, 1)


def test_two_d_checkpoint_restores_bit_equal_in_one_process(world, reference):
    gathered = world["ranks"][0][CHECKPOINTED]["payload"]
    assert all(out[CHECKPOINTED]["payload"] is None for out in world["ranks"][1:])
    trainer = tpt.port_trainer("gpt", reference[CHECKPOINTED]["before"],
                               checkpoint_dir=world["ckpt"])
    state = trainer.restore(trainer.init())
    assert state is not None and state.step == tpt.STEPS
    got = tpt.payload_tensors(torch_trainer.state_payload(state))
    assert set(got) == set(gathered)
    for name, want in gathered.items():
        assert torch.equal(got[name], want), name
    # the gathered tensors hold each rank's own shards
    kind, axes = MESHES[CHECKPOINTED]
    for out in world["ranks"]:
        for name, local in out[CHECKPOINTED]["params"].items():
            want = rank_slice(name, gathered[f"model.{name}"], kind, axes,
                              out[CHECKPOINTED]["coordinate"])
            assert torch.equal(want, local), name
    # the trained FSDP2 model's greedy chain on the mesh is the restored one's
    chain = torch_gpt.generate(state.model, torch.tensor(reference["prompt"]).long(),
                               tpt.NEW_TOKENS).tolist()
    assert all(out["trained_chain"] == chain for out in world["ranks"])


def test_two_d_restore_refuses_a_tensor_of_another_shape(world):
    """A saved tensor cut to [1, n] would broadcast into the live [m, n]
    shard through copy_: the restore raises on every rank, naming it."""
    for out in world["ranks"]:
        name, text = out["wrong_shape"]
        assert text is not None and name in text and "shape" in text, (name, text)


def test_two_d_checkpoint_restores_at_fsdp2_alone(world):
    """The fsdp 2 x tp 2 checkpoint restored at dp 2 x fsdp 2: each rank
    holds its fsdp chunk of every gathered parameter and moment, and the
    state gathered again is the checkpoint, bit for bit."""
    gathered = world["ranks"][0][CHECKPOINTED]["payload"]
    names = list(world["ranks"][0]["fsdp_alone"]["params"])
    for out in world["ranks"]:
        alone = out["fsdp_alone"]
        assert alone["step"] == tpt.STEPS
        index = alone["coordinate"]["fsdp"]
        assert alone["coordinate"]["dp"] == out["rank"] // 2
        for i, name in enumerate(names):
            assert torch.equal(alone["params"][name],
                               fsdp_chunk(gathered[f"model.{name}"], index)), name
            assert torch.equal(alone["moments"][name],
                               fsdp_chunk(gathered[f"opt.{i}.exp_avg"], index)), name
    again = world["ranks"][0]["fsdp_alone"]["payload"]
    assert set(again) == set(gathered)
    for name, want in gathered.items():
        assert torch.equal(again[name], want), name


@pytest.mark.parametrize("key", ["generated", "generated_int8"])
def test_generate_on_a_two_d_mesh_matches_the_reference_chain(world, reference, key):
    """generate(mesh=) at fsdp 2 x tp 2, with the f32 and the int8 KV
    cache, against the reference's generate at the same MeshConfig."""
    want = np.asarray(reference[key])
    assert want.shape == (tpt.PROMPT[0], tpt.PROMPT[1] + tpt.NEW_TOKENS)
    for out in world["ranks"]:
        assert out[key] == reference[key]


def test_bf16_experts_shard_as_units_of_their_own(world, reference):
    """MoE-base's dtypes (bf16 experts, f32 elsewhere) at fsdp 2 x ep 2: the
    step runs on every rank, its loss the same on each and within bf16's
    bound of the one process's step on the same weights and batch."""
    one = bf16_moe_step(reference["moe_fsdp2_ep2"]["before"], reference["batches"]["moe_fsdp2_ep2"])
    losses = [out["moe_bf16"]["loss"] for out in world["ranks"]]
    assert all(out["moe_bf16"]["sharded"] for out in world["ranks"])
    assert {out["moe_bf16"]["expert_dtype"] for out in world["ranks"]} == {"torch.bfloat16"}
    assert len(set(losses)) == 1, losses
    # the loss is f32; the experts' bf16 products differ in rounding only
    assert abs(losses[0] - one["loss"]) <= 2.0 ** -7 * abs(one["loss"]), (losses, one)
    assert {"MoEMlp", "TopKRouter"} <= set(sharding.MOE_RULES.blocks)


def test_fsdp2_chunk_spans_cover_short_and_empty_chunks():
    """FSDP2's chunks of 5 rows over 4 ranks are 2, 2, 1 and 0 rows: the
    span of each, and fsdp_chunk's cut, as the world's shards use them."""
    assert [sharding.fsdp_chunk_span(5, i, 4) for i in range(4)] == [(0, 2), (2, 4), (4, 5),
                                                                 (5, 5)]
    full = torch.arange(10.0).reshape(5, 2)
    parts = [fsdp_chunk(full, i, 4) for i in range(4)]
    assert [p.shape[0] for p in parts] == [2, 2, 1, 0]
    assert torch.equal(torch.cat(parts), full)


if __name__ == "__main__":
    _world_main(sys.argv[1])
