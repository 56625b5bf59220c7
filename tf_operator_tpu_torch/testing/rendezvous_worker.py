"""Rendezvous worker: a pod checks its place in the world from inside.
Twin of tf_operator_tpu/testing/rendezvous_worker.py.

    python -m tf_operator_tpu_torch.testing.rendezvous_worker --device cpu

The process joins the world from the operator-injected identity
(TPU_WORKER_ID, TPU_WORKER_HOSTNAMES, JAX_PROCESS_ID, JAX_NUM_PROCESSES;
parallel/distributed.py), then checks:

- torch.distributed's rank == the injected process id;
- its world size == the injected number of processes;
- an all-gather of every rank's claimed id, on `--device`, returns
  exactly [0 .. n-1]: each worker sees the whole world.

It prints one `RENDEZVOUS {json}` line and exits 0, or 1 on any
mismatch. Under the TPU replica type a TFJob succeeds only when every
pod exits 0, so "the job Succeeded" means every worker's view of the
world was right. A hermetic run maps the injected coordinator (a
headless-service DNS name) to 127.0.0.1:<port> with
TFJOB_COORDINATOR_OVERRIDE; the identity env is not overridden.
--backend names the process group's backend (default: by device, see
parallel/distributed.py); two ranks on one card need gloo.
"""

from __future__ import annotations

import argparse
import json
import logging
import sys
from typing import List, Optional

import torch
import torch.distributed as dist


def check_world(device: torch.device, proc) -> dict:
    """The report of this process's view of the world."""
    from ..parallel import distributed

    report = {
        "claimed_process_id": proc.process_id,
        "claimed_num_processes": proc.num_processes,
        "hostnames": list(proc.hostnames),
        "process_index": distributed.rank(),
        "process_count": distributed.world_size(),
        "device": str(device),
        "backend": str(dist.get_backend()) if distributed.is_initialized() else None,
    }
    failures = []
    if report["process_index"] != proc.process_id:
        failures.append(f"rank {report['process_index']} != injected id {proc.process_id}")
    if report["process_count"] != proc.num_processes:
        failures.append(
            f"world size {report['process_count']} != injected world {proc.num_processes}")
    if proc.is_multi_host:
        mine = torch.tensor([proc.process_id], dtype=torch.int64, device=device)
        gathered = [torch.empty_like(mine) for _ in range(distributed.world_size())]
        dist.all_gather(gathered, mine)
        world = sorted(int(t.item()) for t in gathered)
        report["gathered_world"] = world
        if world != list(range(proc.num_processes)):
            failures.append(f"gathered world {world} != {list(range(proc.num_processes))}")
    report["ok"] = not failures
    if failures:
        report["failures"] = failures
    return report


def main(argv: Optional[List[str]] = None) -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--device", default=None, help="default: cuda")
    parser.add_argument("--backend", default=None, help="default: by device")
    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.INFO, stream=sys.stderr)

    from .._device import resolve_device
    from ..parallel import distributed

    device = resolve_device(args.device)
    with distributed.world(device, args.backend) as proc:
        report = check_world(device, proc)
    print("RENDEZVOUS " + json.dumps(report), flush=True)
    return 0 if report["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
