"""The port's pipeline parallelism (parallel/pipeline.py's GPipe schedule,
models/moe_pipeline.py's PipelinedMoELM) in one world of 4 gloo processes
on the CPU, held against the JAX reference on the virtual CPU mesh at the
same factorization, f32, at tests/test_moe_pipeline.py's widths and
tolerances; and the port's dryrun_multichip.

- pipeline_apply on residual tanh layers at dp 2 x pp 2: forward (1e-6)
  and gradient (1e-5) against the reference's pipeline_apply; the
  single-stage mesh (dp 4, pp 1); the bad microbatch count.
- PipelinedMoELM from converted reference weights at pp 2 x ep 2 and dp
  2 x pp 2: logits (1e-5), aux, and the gradient of lm loss + aux (1e-4)
  on each rank's stage and experts against the reference's; after one
  Adam step the replicated embeddings and head are equal on every rank;
  five Adam steps lower the loss.
- Mean of means: at dp 2 x pp 2 the aux equals the reference's (each
  microbatch's router means its own, averaged over microbatches and data
  shards); the control, the same weights' aux over the global batch's
  means (MoELM on all rows at once), differs from it by far more.
- The converter's slice of the reference's stacked tree for each rank.
- dryrun_multichip(2) and dryrun_multichip(4) print every one of the
  reference's ok lines (world 4: BERT at fsdp 2 x tp 2).

The world is this file run as a script (`_world_main`), spawned once per
module with tests/test_torch_tensor_parallel.py's helpers.
"""

import os
import sys

import numpy as np
import pytest
import torch

from tests import test_torch_tensor_parallel as tpt
from tf_operator_tpu_torch.models import moe as torch_moe
from tf_operator_tpu_torch.models.convert import moe_pipeline_state_dict_from_flax
from tf_operator_tpu_torch.models.moe_pipeline import (
    PipelinedMoELM,
    local_state_dict,
    stage_layers,
)
from tf_operator_tpu_torch.parallel import distributed
from tf_operator_tpu_torch.parallel import mesh as torch_mesh
from tf_operator_tpu_torch.parallel import pipeline as torch_pipeline

from torch_threads import one_torch_thread  # noqa: F401

WORLD = 4
PIPE_ATOL = 1e-6
PIPE_GRAD_ATOL = 1e-5
MOE_ATOL = 1e-5
MOE_GRAD_ATOL = 1e-4
AUX_ATOL = 1e-6
TRAIN_STEPS = 5
TRAIN_LR = 1e-2
MOE_MESHES = {"pp2_ep2": {"pp": 2, "ep": 2}, "dp2_pp2": {"dp": 2, "pp": 2}}
LAYERS, WIDTH = 8, 16


def cfg():
    """tests/test_moe_pipeline.py's CFG."""
    return torch_moe.MoEConfig(
        vocab_size=256, hidden_size=32, num_layers=4, num_heads=4, intermediate_size=64,
        max_position_embeddings=64, num_experts=4, experts_per_token=2, moe_every=1,
        dtype=torch.float32)


def layers_np():
    rng = np.random.RandomState(0)
    return [{"w": (rng.randn(WIDTH, WIDTH) * 0.1).astype(np.float32),
             "b": (rng.randn(WIDTH) * 0.1).astype(np.float32)} for _ in range(LAYERS)]


def x_np(batch=8):
    return np.random.RandomState(1).randn(batch, 4, WIDTH).astype(np.float32)


def ids_np():
    return np.random.default_rng(0).integers(0, 256, (8, 16)).astype(np.int64)


def layer_fn(p, h):
    return h + torch.tanh(h @ p["w"] + p["b"])


def _mesh(**axes):
    return torch_mesh.build_mesh(torch_mesh.MeshConfig(**axes), "cpu")


def simple_pipeline(mesh, batch):
    """pipeline_apply at `mesh` on this rank's rows of x: its output rows and
    the gradient of mean(out ** 2) over the global batch on its stage's
    layers (averaged over the data shards)."""
    layers = [{k: torch.tensor(v, requires_grad=True) for k, v in p.items()}
              for p in layers_np()]
    mine = torch_pipeline.stack_layers(layers, mesh.size("pp"))[mesh.index("pp")]
    x = torch.tensor(x_np(batch))[torch_mesh.local_rows(mesh, batch)]
    out = torch_pipeline.pipeline_apply(layer_fn, mine, x, mesh=mesh, n_microbatches=4)
    (out ** 2).mean().backward()
    n = torch_mesh.data_shards(mesh)
    grads = [{k: (distributed.all_reduce(v.grad, mesh.batch_group) if n > 1 else v.grad) / n
              for k, v in p.items()} for p in mine]
    return {"out": out.detach(), "grads": grads}


def moe_pipeline(mesh, full, ids):
    """PipelinedMoELM at `mesh` on converted weights: logits, aux, step 1's
    loss and gradients, the parameters after one Adam step, then the
    global loss at each of TRAIN_STEPS Adam steps."""
    model = PipelinedMoELM(cfg(), mesh, n_microbatches=2)
    model.load_state_dict(local_state_dict(full, mesh))
    optimizer = torch.optim.Adam(model.parameters(), lr=TRAIN_LR)
    local = torch.tensor(ids)[torch_mesh.local_rows(mesh, ids.shape[0])]
    out, losses = {}, []
    for step in range(TRAIN_STEPS):
        optimizer.zero_grad()
        logits, aux = model(local)
        loss = torch_moe.lm_loss(logits, local) + aux
        loss.backward()
        model.sync_gradients()
        if step == 0:
            out.update(logits=logits.detach(), aux=float(aux.detach()),
                       grads={k: p.grad.clone() for k, p in model.named_parameters()})
        optimizer.step()
        if step == 0:
            out["params"] = {k: p.detach().clone() for k, p in model.named_parameters()}
        # every rank of a data shard holds its loss: the world's mean is the global one
        losses.append(distributed.all_reduce_scalars({"l": float(loss.detach())})["l"] / WORLD)
    out["losses"] = losses
    return out


# -- one process of the world ---------------------------------------------------

def _world_main(work: str) -> None:
    distributed.initialize("cpu")
    torch.set_num_threads(1)
    try:
        inputs = torch.load(os.path.join(work, "inputs.pt"), weights_only=False)
        out = {"rank": distributed.rank()}
        mesh = _mesh(dp=2, pp=2)
        out["simple"] = simple_pipeline(mesh, 8)
        out["simple_coordinate"] = dict(mesh.coordinate)
        single = _mesh(pp=1)
        out["single"] = simple_pipeline(single, 16)["out"]
        for name, axes in MOE_MESHES.items():
            mesh = _mesh(**axes)
            out[name] = moe_pipeline(mesh, inputs["full"], inputs["ids"])
            out[name]["coordinate"] = dict(mesh.coordinate)
            out[name]["layers"] = list(stage_layers(cfg().num_layers, mesh))
        torch.save(out, os.path.join(work, f"rank{out['rank']}.pt"))
        distributed.barrier()
    finally:
        distributed.shutdown()


# -- the reference ----------------------------------------------------------------

def jax_mesh(axes):
    import jax

    from tf_operator_tpu.parallel.mesh import MeshConfig, build_mesh

    return build_mesh(MeshConfig(**{"dp": 1, **axes}), devices=jax.devices()[:WORLD])


def reference_simple():
    import jax
    import jax.numpy as jnp

    from tf_operator_tpu.parallel import pipeline as jax_pipeline

    layers = [{k: jnp.asarray(v) for k, v in p.items()} for p in layers_np()]
    x = jnp.asarray(x_np())
    mesh = jax_mesh({"dp": 2, "pp": 2})

    def fn(p, h):
        return h + jnp.tanh(h @ p["w"] + p["b"])

    def loss(stacked):
        out = jax_pipeline.pipeline_apply(fn, stacked, x, mesh=mesh, n_microbatches=4)
        return (out ** 2).mean(), out

    stacked = jax_pipeline.stack_layers(layers, 2)
    (_, out), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(stacked)
    single = jnp.asarray(x_np(16))
    for p in layers:
        single = fn(p, single)
    return {"out": np.asarray(out), "grads": jax.tree_util.tree_map(np.asarray, grads),
            "single": np.asarray(single)}


def reference_moe(axes, ids):
    """The reference's PipelinedMoELM at `axes`: its params, logits, aux and
    the gradient of lm_loss + aux, as numpy trees."""
    import jax
    import jax.numpy as jnp

    from tf_operator_tpu.models import moe as jax_moe
    from tf_operator_tpu.models.moe_pipeline import PipelinedMoELM as JaxPipelinedMoELM

    jcfg = jax_moe.MoEConfig(
        vocab_size=256, hidden_size=32, num_layers=4, num_heads=4, intermediate_size=64,
        max_position_embeddings=64, num_experts=4, experts_per_token=2, moe_every=1,
        dtype=jnp.float32)
    model = JaxPipelinedMoELM(jcfg, jax_mesh(axes), n_microbatches=2)
    jids = jnp.asarray(ids, jnp.int32)
    params = model.place(model.init(jax.random.PRNGKey(0), jids))

    def loss(p):
        logits, aux = model.apply_with_aux(p, jids)
        return jax_moe.lm_loss(logits, jids) + aux, (logits, aux)

    (_, (logits, aux)), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(params)
    to_np = lambda tree: jax.tree_util.tree_map(np.asarray, tree)  # noqa: E731
    return {"flax": to_np(params), "logits": np.asarray(logits), "aux": float(aux),
            "grads": moe_pipeline_state_dict_from_flax(to_np(grads))}


@pytest.fixture(scope="module")
def reference():
    ids = ids_np()
    run = {"simple": reference_simple(), "ids": ids}
    for name, axes in MOE_MESHES.items():
        run[name] = reference_moe(axes, ids)
    run["full"] = moe_pipeline_state_dict_from_flax(run["pp2_ep2"]["flax"])
    return run


@pytest.fixture(scope="module")
def world(reference, tmp_path_factory):
    work = str(tmp_path_factory.mktemp("pp"))
    torch.save({"full": reference["full"], "ids": reference["ids"]},
               os.path.join(work, "inputs.pt"))
    return tpt.run_world(os.path.abspath(__file__), work, WORLD)


def _fake_mesh(**axes):
    shape = {a: axes.get(a, 1) for a in torch_mesh.MESH_AXES}
    coordinate = {a: axes.get(f"{a}_index", 0) for a in torch_mesh.MESH_AXES}
    return torch_mesh.TrainMesh(shape=shape, coordinate=coordinate)


def _rank_slice(name, tensor, coordinate, ep):
    if ep > 1 and "expert_" in name:
        return tensor.chunk(ep, 0)[coordinate["ep"]]
    return tensor


# -- pipeline_apply ----------------------------------------------------------------------

def test_pipeline_apply_matches_the_reference_forward_and_gradient(world, reference):
    ref = reference["simple"]
    for out in world:
        c = out["simple_coordinate"]
        rows = slice(4 * c["dp"], 4 * c["dp"] + 4)
        tpt.close(out["simple"]["out"], ref["out"][rows], PIPE_ATOL, "out")
        for layer, grads in enumerate(out["simple"]["grads"]):
            for key, grad in grads.items():
                want = ref["grads"][key][c["pp"], layer]
                tpt.close(grad, want, PIPE_GRAD_ATOL, f"grad stage {c['pp']} {layer} {key}")


def test_single_stage_mesh_matches_sequential(world, reference):
    for rank, out in enumerate(world):
        tpt.close(out["single"], reference["simple"]["single"][4 * rank:4 * rank + 4],
                  PIPE_ATOL, "single stage")


def test_stack_layers_and_the_bad_microbatch_count():
    stacked = torch_pipeline.stack_layers(list(range(8)), 4)
    assert stacked == [[0, 1], [2, 3], [4, 5], [6, 7]]
    with pytest.raises(ValueError, match="divisible"):
        torch_pipeline.stack_layers(list(range(8)), 3)
    layers = [{k: torch.tensor(v) for k, v in p.items()} for p in layers_np()]
    with pytest.raises(ValueError, match="microbatches"):
        torch_pipeline.pipeline_apply(layer_fn, layers, torch.ones(6, 4, WIDTH), mesh=None,
                                      n_microbatches=4)
    # one process, one stage: the schedule is the layers in order
    x = torch.tensor(x_np())
    want = x
    for p in layers:
        want = layer_fn(p, want)
    got = torch_pipeline.pipeline_apply(layer_fn, layers, x, mesh=None, n_microbatches=2)
    tpt.close(got, want, PIPE_ATOL, "one process")


# -- PipelinedMoELM -----------------------------------------------------------------------

@pytest.mark.parametrize("name", list(MOE_MESHES))
def test_pipelined_moe_matches_the_reference(world, reference, name):
    """Logits, aux and each rank's gradient (its stage's layers, its ep
    experts, the replicated embeddings and head) against the reference's
    at the same mesh."""
    ref = reference[name]
    ep = MOE_MESHES[name].get("ep", 1)
    for out in world:
        got, c = out[name], out[name]["coordinate"]
        rows = 8 // MOE_MESHES[name].get("dp", 1)
        tpt.close(got["logits"], ref["logits"][c["dp"] * rows:(c["dp"] + 1) * rows], MOE_ATOL,
                  "logits")
        tpt.close(got["aux"], ref["aux"], AUX_ATOL, "aux")
        assert got["aux"] > 0
        mine = {f"layer_{i}" for i in got["layers"]}
        assert {n.split(".")[0] for n in got["grads"] if n.startswith("layer_")} == mine
        for n, grad in got["grads"].items():
            tpt.close(grad, _rank_slice(n, ref["grads"][n], c, ep), MOE_GRAD_ATOL, f"grad {n}")


@pytest.mark.parametrize("name", list(MOE_MESHES))
def test_pipelined_moe_replicas_agree_after_a_step_and_training_lowers_the_loss(world, name):
    first = world[0][name]
    for out in world[1:]:
        for n, p in out[name]["params"].items():
            if not n.startswith("layer_"):
                assert torch.equal(p, first["params"][n]), n
        assert out[name]["losses"] == first["losses"]
    losses = first["losses"]
    assert losses[-1] < losses[0], losses


def test_pipeline_aux_is_the_mean_of_microbatch_means(world, reference):
    """At dp 2 x pp 2 the aux is the reference's mean over microbatches and
    data shards of each one's own router losses; the same weights' aux
    over the global batch's means (one MoELM forward of all 8 rows, the
    routers synced) is another number, far outside the bound."""
    ref_aux = reference["dp2_pp2"]["aux"]
    model = torch_moe.MoELM(cfg())
    model.load_state_dict(reference["full"])
    with torch.no_grad():
        _, losses = model(torch.tensor(reference["ids"]))
    global_aux = float(torch_moe.total_aux_loss(losses))
    assert abs(global_aux - ref_aux) > 100 * AUX_ATOL, (global_aux, ref_aux)
    for out in world:
        tpt.close(out["dp2_pp2"]["aux"], ref_aux, AUX_ATOL, "aux")


def test_pipeline_converter_slices_the_stacked_tree(reference):
    flax = reference["pp2_ep2"]["flax"]
    full = reference["full"]
    assert {n.split(".")[0] for n in full if n.startswith("layer_")} == {
        f"layer_{i}" for i in range(4)}
    # block (s, l) of the stacked tree is layer s * L/S + l
    np.testing.assert_array_equal(full["layer_3.attention.query.kernel"].numpy(),
                                  flax["blocks"]["attention"]["query"]["kernel"][1, 1])
    for pp_index in range(2):
        for ep_index in range(2):
            mesh = _fake_mesh(pp=2, ep=2, pp_index=pp_index, ep_index=ep_index)
            got = moe_pipeline_state_dict_from_flax(flax, mesh=mesh)
            layers = {f"layer_{2 * pp_index + i}" for i in range(2)}
            assert {n.split(".")[0] for n in got if n.startswith("layer_")} == layers
            for n, tensor in got.items():
                want = full[n].chunk(2, 0)[ep_index] if "expert_" in n else full[n]
                assert torch.equal(tensor, want), n


def test_pipelined_moe_keeps_the_reference_errors():
    with pytest.raises(ValueError, match="homogeneous"):
        PipelinedMoELM(torch_moe.MOE_BASE, None)
    bad_layers = torch_moe.MoEConfig(num_layers=3, moe_every=1, hidden_size=32, num_heads=4)
    with pytest.raises(ValueError, match="not divisible by 2 pipeline stages"):
        PipelinedMoELM(bad_layers, _fake_mesh(pp=2))
    bad_experts = torch_moe.MoEConfig(num_experts=3, moe_every=1, hidden_size=32, num_heads=4)
    with pytest.raises(ValueError, match="not divisible by ep=2"):
        PipelinedMoELM(bad_experts, _fake_mesh(ep=2))


# -- the dry run -------------------------------------------------------------------------

def test_dryrun_multichip_2_prints_every_ok_line(capsys):
    from tf_operator_tpu_torch.testing import dryrun

    dryrun.dryrun_multichip(2, "cpu")
    lines = capsys.readouterr().out.splitlines()
    for phase in ("dp", "bert", "gpt", "moe-pipeline"):
        assert any(line.startswith(f"dryrun {phase} ok:") for line in lines), (phase, lines)
    assert lines[-1] == "dryrun_multichip ok"
    assert "'ep': 2" in next(line for line in lines if line.startswith("dryrun moe-pipeline"))


def test_dryrun_runs_on_the_card_unless_asked_otherwise(monkeypatch):
    from tf_operator_tpu_torch.testing import dryrun

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        dryrun.dryrun_multichip(2)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        dryrun.main(["--rank-of", "2"])


def test_dryrun_world4_bert_mesh_is_refused_naming_item_4(capsys):
    """World 4's BERT mesh is fsdp 2 x tp 2, refused until item 4's 2-D
    line was ported: dryrun_multichip(4) now prints every phase's ok line,
    BERT's at that mesh."""
    from tf_operator_tpu_torch.testing import dryrun

    config = dryrun._mesh_config(4)
    assert (config.fsdp, config.tp) == (2, 2)
    assert dryrun._moe_mesh_config(4) == torch_mesh.MeshConfig(dp=-1, pp=2, ep=2)
    dryrun.dryrun_multichip(4, "cpu")
    lines = capsys.readouterr().out.splitlines()
    for phase in ("dp", "bert", "gpt", "moe-pipeline"):
        assert any(line.startswith(f"dryrun {phase} ok:") for line in lines), (phase, lines)
    assert lines[-1] == "dryrun_multichip ok"
    bert = next(line for line in lines if line.startswith("dryrun bert ok:"))
    assert "'fsdp': 2" in bert and "'tp': 2" in bert


if __name__ == "__main__":
    _world_main(sys.argv[1])
