"""MoE-base's router under AdamW, the reference against the port: six
steps of MOE_BASE (f32, 2 x 128, AdamW 3e-4 wd 0.01, fresh seeded batches)
through the reference's moe_task with optax.adamw and through the port's
Trainer on the converted weights, then one forward on a held-out batch
before and after. Prints, for each side, every step's loss, router_aux and
balance (router_aux / (router_aux_weight x MoE layers); 1.0 is uniform)
and the held-out batch's balance and routed fraction (the (token, slot)
claims inside capacity over all claims) by MoE layer. Not a test (MoE-base
on the CPU takes a few minutes and ~8 GB); run it by hand:

    python tests/torch_moe_router_check.py
"""

import dataclasses
import gc
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import optax  # noqa: E402
import torch  # noqa: E402

from tf_operator_tpu.models import moe as jax_moe  # noqa: E402
from tf_operator_tpu.train import trainer as jax_trainer  # noqa: E402
from tf_operator_tpu_torch.models import moe as torch_moe  # noqa: E402
from tf_operator_tpu_torch.models.convert import moe_state_dict_from_flax  # noqa: E402
from tf_operator_tpu_torch.train import trainer as torch_trainer  # noqa: E402

LR, WD, B, S, STEPS = 3e-4, 0.01, 2, 128, 6
JCFG = dataclasses.replace(jax_moe.MOE_BASE, dtype=jnp.float32)
TCFG = dataclasses.replace(torch_moe.MOE_BASE, dtype=torch.float32)


def batch(seed):
    ids = np.random.default_rng(seed).integers(0, JCFG.vocab_size, (B, S)).astype(np.int32)
    return {"input_ids": ids, "labels": ids, "attention_mask": np.ones((B, S), np.int32)}


def readings(fractions, aux):
    """Balance and routed fraction from the MoE layers' routed fractions
    (layer order) and the summed router_aux."""
    return {"balance": aux / (JCFG.router_aux_weight * len(fractions)),
            "routed": sum(fractions) / len(fractions), "routed_by_layer": fractions}


def routed_fraction(dispatch):
    d = np.asarray(dispatch)
    return float(d.sum()) / (d.shape[0] * d.shape[1] * JCFG.experts_per_token)


def reference(batches, held):
    params = jax.jit(jax_moe.MoELM(JCFG).init)(jax.random.PRNGKey(0),
                                               jnp.zeros((1, 8), jnp.int32))["params"]
    initial = jax.tree_util.tree_map(np.asarray, params)
    model = jax_moe.MoELM(JCFG)
    task = jax_trainer.moe_task(model)
    opt = optax.adamw(LR, weight_decay=WD)

    @jax.jit
    def step(p, state, b):
        (loss, aux), grads = jax.value_and_grad(
            lambda q: task.loss_fn({"params": q}, b, True), has_aux=True)(p)
        updates, state = opt.update(grads, state, p)
        return optax.apply_updates(p, updates), state, loss, aux["router_aux"]

    @jax.jit
    def forward(p, b):
        _, mods = model.apply(
            {"params": p}, b["input_ids"], b["attention_mask"],
            mutable=["losses", "intermediates"],
            capture_intermediates=lambda m, name: (isinstance(m, jax_moe.TopKRouter)
                                                   and name == "__call__"))
        return mods

    def held_readings(p):
        mods = forward(p, {k: jnp.asarray(v) for k, v in held.items()})
        layers = mods["intermediates"]
        # layer_<i> in numeric order; each router's output is (dispatch, combine)
        names = sorted(layers, key=lambda n: int(n.split("_")[1]))
        fractions = [routed_fraction(layers[n]["moe_mlp"]["router_gate"]["__call__"][0][0])
                     for n in names]
        return readings(fractions, float(jax_moe.sum_sown(mods["losses"], "router_aux")))

    out = {"held_before": held_readings(params), "steps": []}
    state = opt.init(params)
    for b in batches:
        params, state, loss, aux = step(params, state, {k: jnp.asarray(v) for k, v in b.items()})
        out["steps"].append({"loss": float(loss), "router_aux": float(aux)})
    out["held_after"] = held_readings(params)
    return out, initial


def port(batches, held, initial):
    model = torch_moe.MoELM(TCFG)
    model.load_state_dict(moe_state_dict_from_flax(initial))
    trainer = torch_trainer.Trainer(model, torch_trainer.moe_task(), learning_rate=LR,
                                    weight_decay=WD, device="cpu")

    def place(b):
        return {k: torch.tensor(v).long() if k != "attention_mask" else torch.tensor(v)
                for k, v in b.items()}

    def held_readings():
        fractions = []
        hooks = [m.register_forward_hook(lambda mod, a, o: fractions.append(
            routed_fraction(o[0].detach().numpy()))) for m in model.modules()
            if isinstance(m, torch_moe.TopKRouter)]
        try:
            with torch.no_grad():
                b = place(held)
                _, losses = model(b["input_ids"], b["attention_mask"])
        finally:
            for hook in hooks:
                hook.remove()
        return readings(fractions, float(torch_moe.sum_sown(losses, "router_aux")))

    out = {"held_before": held_readings(), "steps": []}
    state = trainer.init()
    for b in batches:
        state, metrics = trainer.step(state, trainer.place_batch(place(b)))
        out["steps"].append({"loss": metrics["loss"].item(),
                             "router_aux": metrics["router_aux"].item()})
    out["held_after"] = held_readings()
    return out


def main() -> int:
    torch.set_num_threads(4)
    batches = [batch(100 + i) for i in range(STEPS)]
    held = batch(999)
    ref, initial = reference(batches, held)
    gc.collect()
    ours = port(batches, held, initial)
    n_moe = len(ref["held_before"]["routed_by_layer"])
    for side in (ref, ours):
        for s in side["steps"]:
            s["balance"] = s["router_aux"] / (JCFG.router_aux_weight * n_moe)
    print(json.dumps({"reference": ref, "port": ours}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
