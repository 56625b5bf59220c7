"""World smoke test: every rank takes part in a collective. Twin of
tf_operator_tpu/train/smoke.py (itself the analog of the reference's
examples/tf_sample/tf_smoke.py).

    python -m tf_operator_tpu_torch.train.smoke --device cpu [--matrix-size 256]

Joins the world from the operator-injected env; each rank computes a
unit from a bf16 matmul on its device (trace(ones @ ones) / size^2) and
contributes (rank + 1) times it to an all-reduce, which must equal
n (n + 1) / 2: a rank that is absent or misaddressed changes the
answer. Exit 0 when it does, 1 otherwise. --backend as
testing/rendezvous_worker.py's.
"""

from __future__ import annotations

import argparse
import logging
import sys
from typing import List, Optional

import torch
import torch.distributed as dist

logger = logging.getLogger("tf_operator_tpu_torch.train.smoke")


def run_smoke(device: torch.device, matrix_size: int = 256) -> bool:
    from ..parallel import distributed

    n = distributed.world_size()
    ones = torch.ones((matrix_size, matrix_size), dtype=torch.bfloat16, device=device)
    unit = torch.diagonal(ones @ ones).sum(dtype=torch.float32) / float(matrix_size ** 2)
    total = unit * (distributed.rank() + 1)
    if n > 1:
        dist.all_reduce(total)
    total = float(total)
    expected = n * (n + 1) / 2
    ok = abs(total - expected) < 1e-3
    logger.info("collective sum=%s expected=%s over %d rank(s) on %s -> %s",
                total, expected, n, device, "OK" if ok else "MISMATCH")
    return ok


def main(argv: Optional[List[str]] = None) -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--matrix-size", type=int, default=256)
    parser.add_argument("--device", default=None, help="default: cuda")
    parser.add_argument("--backend", default=None, help="default: by device")
    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.INFO, stream=sys.stderr)

    from .._device import resolve_device
    from ..parallel import distributed

    device = resolve_device(args.device)
    with distributed.world(device, args.backend):
        ok = run_smoke(device, args.matrix_size)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
