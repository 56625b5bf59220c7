"""One-off check (not collected by pytest): the phase groups of
chip_smoke.py whose fixed costs (process boots) were cut, driven alone
from the checkout at ROOT on the card, each group's seconds printed as
chip_smoke.py prints them (group_seconds), then one BUDGET line. Run it
for two checkouts in one call to compare them:

    python tests/torch_chip_groups.py <checkout root>
"""

import json
import os
import sys

GROUPS = ("distributed", "decode_modes", "moe_vit", "telemetry")


def main(root: str) -> int:
    sys.path.insert(0, os.path.abspath(root))
    os.chdir(root)
    import chip_smoke as c
    from tf_operator_tpu_torch.ops import kernels

    kernels.library()
    smi = c.nvidia_smi()
    runs = {"distributed": c.run_distributed_phases, "decode_modes": c.run_decode_modes_phases,
            "moe_vit": c.run_moe_vit_phases, "telemetry": c.run_telemetry_phases}
    seconds: dict = {}
    for name in GROUPS:
        c.timed_group(seconds, name, runs[name], kernels, smi)
        c.free_device_memory()
    print("BUDGET " + json.dumps({"tree": root, "card": smi, "groups": seconds}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1]))
