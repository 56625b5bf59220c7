"""How much of the client's TTFT the trace smoke's 8 hops cover, run after
run: `run_trace_smoke` of the port (GPT_TINY f32 on the reference's
PRNGKey(0) weights, the CPU, as tests/test_torch_fleet.py runs it) or of the
reference, `--runs` times, one line a run: the migrated trace's hop sum,
the client's TTFT and their ratio (the smoke's bound is 0.95), then the
count below the bound. Not a test; run it by hand, alone or beside a load
(the tier-1 suite's `-n 6` is the load under which the bound has failed):

    python tests/torch_trace_coverage.py --side port --runs 30
    python tests/torch_trace_coverage.py --side ref --runs 30
    python tests/torch_trace_coverage.py --side port --root <another tree>
"""

import argparse
import dataclasses
import json
import os
import sys


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--side", choices=["port", "ref"], default="port")
    parser.add_argument("--runs", type=int, default=10)
    parser.add_argument("--root", default=os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), help="the tree whose packages run")
    args = parser.parse_args()
    sys.path.insert(0, args.root)
    import jax

    jax.config.update("jax_platforms", "cpu")
    if args.side == "port":
        import jax.numpy as jnp
        import numpy as np
        import torch

        from tf_operator_tpu.models import gpt as jax_gpt
        from tf_operator_tpu_torch.models import gpt as torch_gpt
        from tf_operator_tpu_torch.models.convert import gpt_state_dict_from_flax
        from tf_operator_tpu_torch.serve import fleet

        torch.set_num_threads(1)
        jcfg = dataclasses.replace(jax_gpt.GPT_TINY, dtype=jnp.float32)
        params = jax_gpt.GPT(jcfg).init(jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))
        state = gpt_state_dict_from_flax(jax.tree_util.tree_map(np.array, params["params"]))
        cfg = dataclasses.replace(torch_gpt.GPT_TINY, dtype=torch.float32)

        def run():
            return fleet.run_trace_smoke(seed=0, cfg=cfg, params=state, device="cpu")
    else:
        from tf_operator_tpu.serve import fleet

        def run():
            return fleet.run_trace_smoke(seed=0)

    below = 0
    for k in range(args.runs):
        try:
            summary = run()
        except AssertionError as err:
            summary = json.loads(str(err).split(": ", 1)[1])
        for tid in summary["migrated_traces"]:
            hops = sum(h["duration_s"] for h in summary["breakdowns"][tid]["hops"])
            client = summary["client_ttft"][tid]
            below += hops < 0.95 * client
            print(json.dumps({"run": k, "hops_s": round(hops, 6), "client_ttft_s": client,
                              "share": round(hops / client, 4)}), flush=True)
    print(json.dumps({"side": args.side, "runs": args.runs, "below_0.95": below}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
