"""The seam shared by the sequence-parallel attentions. Counterpart of
tf_operator_tpu/parallel/compat.py's `packed_only_attention` (its
shard_map shims have no counterpart: the port's bodies run on each
rank's local tensors already)."""

from __future__ import annotations

from typing import Callable


def packed_only_attention(sharded: Callable, strategy: str) -> Callable:
    """Wrap a sharded (q, k, v) attention body into the
    MultiHeadAttention-compatible (query, key, value, mask) seam shared
    by BOTH sequence-parallel strategies: sequence-parallel pretraining
    assumes packed/unpadded batches, so a mask is rejected in one place
    (the reference's text)."""

    def attention_fn(query, key, value, mask=None):
        if mask is not None:
            raise NotImplementedError(
                f"{strategy} attention requires unpadded (packed) "
                "batches; drop the attention mask for sequence-parallel "
                "training"
            )
        return sharded(query, key, value)

    return attention_fn
