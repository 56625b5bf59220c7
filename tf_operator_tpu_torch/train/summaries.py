"""Training summaries: scalar metrics persisted to a volume. The port's
copy of tf_operator_tpu/train/summaries.py, the analog of the reference
operator's mnist_with_summaries example.

Scalars always land in an append-only ``metrics.jsonl`` (easy to tail,
survives preemption); TensorBoard event files are written too when
``torch.utils.tensorboard`` (which needs the tensorboard package) is
importable, and a warning is logged when it is not. Only process 0
writes (``maybe_writer``), as chief-only summary writing in distributed
TF.
"""

from __future__ import annotations

import json
import logging
import time
from pathlib import Path
from typing import Dict, Optional

logger = logging.getLogger("tf_operator_tpu_torch.train.summaries")


class SummaryWriter:
    def __init__(self, log_dir: str, enabled: bool = True) -> None:
        self.enabled = enabled
        self.log_dir = Path(log_dir)
        self._tb = None
        if not enabled:
            return
        self.log_dir.mkdir(parents=True, exist_ok=True)
        self._jsonl = (self.log_dir / "metrics.jsonl").open("a")
        try:  # optional TensorBoard backend
            from torch.utils.tensorboard import SummaryWriter as TBWriter

            self._tb = TBWriter(log_dir=str(self.log_dir))
        except Exception as err:
            logger.warning(
                "TensorBoard events disabled (torch.utils.tensorboard "
                "unavailable: %s); writing metrics.jsonl only", err,
            )
            self._tb = None

    def scalars(self, step: int, values: Dict[str, float]) -> None:
        if not self.enabled:
            return
        # a wall TIMESTAMP for the record, not an interval — readers
        # (TensorBoard, metrics.jsonl tailers) align runs by calendar
        # time, so Clock.monotonic() would be wrong here
        record = {"step": step, "time": time.time()}  # noqa: wall-clock-interval
        record.update({k: float(v) for k, v in values.items()})
        self._jsonl.write(json.dumps(record) + "\n")
        self._jsonl.flush()
        if self._tb is not None:
            for key, value in values.items():
                self._tb.add_scalar(key, float(value), global_step=step)

    def close(self) -> None:
        if not self.enabled:
            return
        self._jsonl.close()
        if self._tb is not None:
            self._tb.close()

    def __enter__(self) -> "SummaryWriter":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def maybe_writer(log_dir: Optional[str], process_id: int = 0) -> SummaryWriter:
    """Writer that is active only on process 0 with a directory set."""
    return SummaryWriter(log_dir or ".", enabled=bool(log_dir) and process_id == 0)
