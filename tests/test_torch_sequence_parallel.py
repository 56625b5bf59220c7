"""The port's sequence parallelism (parallel/ring_attention.py,
parallel/ulysses.py, the trainer's sequence shards) in gloo worlds on the
CPU, held against the JAX reference on the virtual CPU mesh, f32.

- A world of 2 at sp = 2, ring then Ulysses (the port's Ulysses with the
  flash route inside, whose CPU route is the kernels' plain version):
  GPT (causal) and BERT (packed, uneven mlm weights along the sequence)
  from converted reference weights, one step's loss, each rank's
  gradients and its parameters after 2 AdamW steps against the
  reference's step at the same mesh (with its ring attention; its
  Ulysses computes the same function, and the refusal tests below run
  it), with the bounds of tests/test_torch_tensor_parallel.py. Ring
  attention alone against the reference's plain attention on the full
  sequence, causal and not: 2e-6 on each rank's output shard, 1e-4 on
  its dq, dk and dv shards.
- A world of 4: tp 2 x sp 2, GPT with ring attention and BERT with
  Ulysses (one local head), against the reference's tp 2 x sp 2 mesh;
  then ring attention over sp = 4, and a planted ring that rotates the
  wrong way (to rank i - 1): its causal output and gradients must miss.
- The mask refusal and Ulysses' head-count refusal, with the reference's
  texts.
"""

import os
import sys

import numpy as np
import pytest
import torch

from tests import test_torch_tensor_parallel as tpt
from tf_operator_tpu_torch.parallel import distributed
from tf_operator_tpu_torch.parallel import mesh as torch_mesh
from tf_operator_tpu_torch.parallel import ring_attention as torch_ring
from tf_operator_tpu_torch.parallel import ulysses as torch_ulysses

OUT_ATOL = 2e-6
ATTN_GRAD_ATOL = 1e-4
# the planted wrong-way ring must miss by at least this much
CONTROL_MISS = 10 * ATTN_GRAD_ATOL
QKV = (2, 32, 4, 16)
STRATEGIES = ("ring", "ulysses")


def qkv_inputs(seed=13):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(QKV).astype(np.float32) for _ in range(4)]  # q, k, v, cotangent


def port_attention(mesh, strategy, causal):
    if strategy == "ring":
        return torch_ring.make_ring_attention(mesh, causal=causal)
    return torch_ulysses.make_ulysses_attention(mesh, causal=causal, flash=True)


def ring_case(mesh, inputs, causal):
    """This rank's sequence shard through ring attention: its output and
    the gradients of sum(out * cotangent) on its q, k and v shards."""
    span = torch_mesh.local_positions(mesh, QKV[1])
    q, k, v, cot = (torch.tensor(x[:, span]) for x in inputs)
    q, k, v = (t.requires_grad_() for t in (q, k, v))
    out = torch_ring.make_ring_attention(mesh, causal=causal)(q, k, v)
    (out * cot).sum().backward()
    return {"out": out.detach(), "dq": q.grad, "dk": k.grad, "dv": v.grad, "span": span}


def _reversed_exchange(tensors, group):
    """The planted fault: the ring rotated to rank i - 1 instead of i + 1."""
    import torch.distributed as dist

    n, me = dist.get_world_size(group), dist.get_rank(group)
    to = dist.get_global_rank(group, (me - 1) % n)
    frm = dist.get_global_rank(group, (me + 1) % n)
    recvs = [torch.empty_like(t) for t in tensors]
    ops = [dist.P2POp(dist.isend, t.contiguous(), to, group) for t in tensors]
    ops += [dist.P2POp(dist.irecv, r, frm, group) for r in recvs]
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    return recvs


def _steps(inputs, mesh, strategy):
    return {kind: tpt.port_steps(
        kind, inputs["weights"][kind], inputs[f"{kind}_batch"], mesh,
        attention_fn=port_attention(mesh, strategy, causal=kind == "gpt"),
        shard_sequence=True) for kind in ("gpt", "bert")}


def _world_main(work: str) -> None:
    distributed.initialize("cpu")
    try:
        inputs = torch.load(os.path.join(work, "inputs.pt"), weights_only=False)
        world = distributed.world_size()
        out = {"rank": distributed.rank()}
        if world == 2:
            mesh = torch_mesh.build_mesh(torch_mesh.MeshConfig(sp=2), "cpu")
            out["coordinate"] = dict(mesh.coordinate)
            for strategy in STRATEGIES:
                out[strategy] = _steps(inputs, mesh, strategy)
            out["ring_units"] = {causal: ring_case(mesh, inputs["qkv"], causal)
                                 for causal in (False, True)}
        else:
            mesh = torch_mesh.build_mesh(torch_mesh.MeshConfig(sp=2, tp=2), "cpu")
            out["coordinate"] = dict(mesh.coordinate)
            out["summary"] = torch_mesh.mesh_summary(mesh)
            out["tp_sp"] = {
                "gpt": tpt.port_steps("gpt", inputs["weights"]["gpt"], inputs["gpt_batch"], mesh,
                                      attention_fn=port_attention(mesh, "ring", True),
                                      shard_sequence=True),
                "bert": tpt.port_steps("bert", inputs["weights"]["bert"], inputs["bert_batch"],
                                       mesh, attention_fn=port_attention(mesh, "ulysses", False),
                                       shard_sequence=True),
            }
            ring4 = torch_mesh.build_mesh(torch_mesh.MeshConfig(sp=4), "cpu")
            out["ring_units"] = {causal: ring_case(ring4, inputs["qkv"], causal)
                                 for causal in (False, True)}
            exchange = distributed.ring_exchange
            distributed.ring_exchange = _reversed_exchange
            try:
                out["planted"] = ring_case(ring4, inputs["qkv"], True)
            finally:
                distributed.ring_exchange = exchange
        torch.save(out, os.path.join(work, f"rank{out['rank']}.pt"))
        distributed.barrier()
    finally:
        distributed.shutdown()


# -- the reference ----------------------------------------------------------------

def jax_attention(mesh, strategy, causal):
    from tf_operator_tpu.parallel.ring_attention import make_ring_attention
    from tf_operator_tpu.parallel.ulysses import make_ulysses_attention

    if strategy == "ring":
        return make_ring_attention(mesh, causal=causal)
    return make_ulysses_attention(mesh, causal=causal, flash=False)


def reference_pair(mesh, attention):
    """GPT (causal) and BERT reference steps over `mesh` with the
    sequence sharded; attention: kind -> the reference's attention_fn."""
    batches = {"gpt": tpt.gpt_batch(), "bert": tpt.mlm_batch(padded=False)}
    out = {}
    for kind in ("gpt", "bert"):
        model = tpt.jax_models(attention_fn=attention[kind])[kind]
        out[kind] = tpt.reference_steps(kind, model, batches[kind], mesh, shard_sequence=True)
    return out


def plain_attention_reference(inputs, causal):
    """The reference's dot_product_attention over the full sequence, and
    the gradients of sum(out * cotangent)."""
    import jax
    import jax.numpy as jnp

    from tf_operator_tpu.ops.attention import dot_product_attention

    q, k, v, cot = (jnp.asarray(x) for x in inputs)
    s = q.shape[1]
    mask = jnp.tril(jnp.ones((s, s), bool))[None, None] if causal else None
    out, vjp = jax.vjp(lambda q, k, v: dot_product_attention(q, k, v, mask), q, k, v)
    dq, dk, dv = vjp(cot)
    return {name: np.asarray(x) for name, x in
            {"out": out, "dq": dq, "dk": dk, "dv": dv}.items()}


@pytest.fixture(scope="module")
def reference():
    sp2 = tpt.jax_mesh(sp=2)
    tp_sp = tpt.jax_mesh(sp=2, tp=2)
    run = {"sp2": reference_pair(sp2, {
        "gpt": jax_attention(sp2, "ring", True), "bert": jax_attention(sp2, "ring", False)})}
    run["tp_sp"] = reference_pair(tp_sp, {
        "gpt": jax_attention(tp_sp, "ring", True), "bert": jax_attention(tp_sp, "ulysses", False)})
    qkv = qkv_inputs()
    run["qkv"] = qkv
    run["plain"] = {causal: plain_attention_reference(qkv, causal) for causal in (False, True)}
    return run


@pytest.fixture(scope="module")
def worlds(reference, tmp_path_factory):
    out = {}
    for size in (2, 4):
        work = str(tmp_path_factory.mktemp(f"sp{size}"))
        torch.save({"weights": {k: reference["sp2"][k]["before"] for k in ("gpt", "bert")},
                    "gpt_batch": tpt.gpt_batch(), "bert_batch": tpt.mlm_batch(padded=False),
                    "qkv": reference["qkv"]}, os.path.join(work, "inputs.pt"))
        out[size] = tpt.run_world(os.path.abspath(__file__), work, size)
    return out


# -- the worlds against the reference ---------------------------------------------------

@pytest.mark.parametrize("strategy", STRATEGIES)
@pytest.mark.parametrize("kind", ["gpt", "bert"])
def test_sp2_steps_match_the_reference(worlds, reference, strategy, kind):
    """Each sp rank trains on its half of every row (GPT's labels across
    the shard boundary from the full row, its positions from its offset;
    BERT's weight mass summed over the shards): the reference's loss,
    gradients and parameters after 2 AdamW steps at sp = 2."""
    for rank, out in enumerate(worlds[2]):
        assert out["coordinate"] == {"dp": 0, "pp": 0, "fsdp": 0, "ep": 0, "sp": rank, "tp": 0}
        tpt.check_against_reference(out[strategy][kind], reference["sp2"][kind], tp_rank=0,
                                    tp_size=1)


@pytest.mark.parametrize("kind", ["gpt", "bert"])
def test_tp2_sp2_steps_match_the_reference(worlds, reference, kind):
    """tp 2 x sp 2 in a world of 4: GPT with ring attention (2 local heads),
    BERT with Ulysses (one head each after the all-to-all); each rank's
    gradient and parameter shards against the reference's slices."""
    for rank, out in enumerate(worlds[4]):
        assert out["coordinate"] == {"dp": 0, "pp": 0, "fsdp": 0, "ep": 0, "sp": rank // 2,
                                     "tp": rank % 2}
        assert out["summary"] == "dp=1xpp=1xfsdp=1xep=1xsp=2xtp=2"
        tpt.check_against_reference(out["tp_sp"][kind], reference["tp_sp"][kind],
                                    tp_rank=rank % 2)


@pytest.mark.parametrize("size", [2, 4])
@pytest.mark.parametrize("causal", [False, True])
def test_ring_attention_matches_plain_attention(worlds, reference, size, causal):
    want = reference["plain"][causal]
    for out in worlds[size]:
        got = out["ring_units"][causal]
        span = got["span"]
        tpt.close(got["out"], want["out"][:, span], OUT_ATOL, "out")
        for name in ("dq", "dk", "dv"):
            tpt.close(got[name], want[name][:, span], ATTN_GRAD_ATOL, name)


def test_a_ring_rotating_the_wrong_way_misses(worlds, reference):
    """The control: the same causal ring over sp = 4 with its blocks sent
    to rank i - 1 folds them under the wrong source offsets."""
    want = reference["plain"][True]
    miss = {name: 0.0 for name in ("out", "dq", "dk", "dv")}
    for out in worlds[4]:
        got = out["planted"]
        for name in miss:
            err = float(np.abs(got[name].numpy() - want[name][:, got["span"]]).max())
            miss[name] = max(miss[name], err)
    assert all(err > CONTROL_MISS for err in miss.values()), miss


# -- the refusals, against the reference's texts ------------------------------------------

def _sp2_mesh():
    """A TrainMesh at sp = 2 without a process group: enough for the
    refusals, which come before any collective."""
    return torch_mesh.TrainMesh(shape={"dp": 1, "fsdp": 1, "sp": 2, "tp": 1},
                                coordinate={"dp": 0, "fsdp": 0, "sp": 0, "tp": 0})


@pytest.mark.parametrize("strategy", STRATEGIES)
def test_sequence_parallel_attention_refuses_a_mask_as_the_reference(strategy):
    import jax.numpy as jnp

    x = np.zeros((2, 32, 4, 16), np.float32)
    mask = np.ones((2, 1, 1, 32), bool)
    with pytest.raises(NotImplementedError) as want:
        jax_attention(tpt.jax_mesh(sp=2), strategy, False)(
            *(jnp.asarray(x),) * 3, mask=jnp.asarray(mask))
    with pytest.raises(NotImplementedError) as got:
        port_attention(_sp2_mesh(), strategy, False)(
            *(torch.tensor(x),) * 3, mask=torch.tensor(mask))
    assert str(got.value) == str(want.value)


def test_ulysses_refuses_local_heads_sp_does_not_divide_as_the_reference():
    import jax.numpy as jnp

    x = np.zeros((2, 32, 3, 16), np.float32)
    with pytest.raises(ValueError) as want:
        jax_attention(tpt.jax_mesh(sp=2), "ulysses", False)(*(jnp.asarray(x),) * 3)
    with pytest.raises(ValueError) as got:
        port_attention(_sp2_mesh(), "ulysses", False)(*(torch.tensor(x),) * 3)
    assert str(got.value) == str(want.value)


if __name__ == "__main__":
    _world_main(sys.argv[1])
