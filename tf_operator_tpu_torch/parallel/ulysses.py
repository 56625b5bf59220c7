"""Ulysses sequence parallelism: all-to-all head/sequence re-sharding.
Counterpart of tf_operator_tpu/parallel/ulysses.py.

    [b, s/n, H, d]  --a2a-->  [b, s, H/n, d]   (heads scatter, sequence gathers)
    full-sequence attention on the local H/n heads
    [b, s, H/n, d]  --a2a-->  [b, s/n, H, d]   (back)

over the mesh's sp group (parallel/distributed.py all_to_all_grad, whose
backward is the reverse all-to-all). With flash=True the inner attention
is ops/flash_attention.py's, the Hopper kernels K1-K3 on a CUDA tensor:
after the all-to-all q/k/v are contiguous [b, s, H/n, d] in the model's
compute dtype, the shape the kernels take. Composes with Megatron tp:
the heads a rank holds are its tp share, so the local requirement is
(H / tp) % sp == 0.
"""

from __future__ import annotations

from typing import Callable

import torch

from . import distributed
from .compat import packed_only_attention


def _inner_attention(causal: bool, flash: bool) -> Callable:
    if flash:
        from ..ops.flash_attention import flash_attention

        def inner(q, k, v):
            return flash_attention(q, k, v, causal=causal)

        return inner
    from ..ops.attention import dot_product_attention

    def inner(q, k, v):
        mask = None
        if causal:
            pos = torch.arange(q.shape[1], device=q.device)
            mask = (pos[:, None] >= pos[None, :])[None, None]
        return dot_product_attention(q, k, v, mask)

    return inner


def make_ulysses_attention(mesh, causal: bool = False, flash: bool = False):
    """An attention_fn (query, key, value, mask) -> out for
    MultiHeadAttention with the sequence sharded over the mesh's sp axis,
    the same seam as make_ring_attention. The full-sequence attention on
    [b, s, h_loc / n, d] is plain attention (causal-masked under causal),
    or the flash route with flash=True. A padding mask raises (packed
    batches only), and so does a local head count the sp axis does not
    divide (the reference's text)."""
    group = mesh.sp_group
    n = mesh.shape["sp"]
    inner = _inner_attention(causal, flash)

    def sharded(q, k, v):
        heads_local = q.shape[2]
        if heads_local % n:
            raise ValueError(
                f"Ulysses needs local heads divisible by the sp "
                f"axis: {heads_local} % {n} != 0 (tp-sharded heads count "
                "as local — reduce sp or tp, or use ring attention)"
            )
        if n > 1:
            q, k, v = (distributed.all_to_all_grad(x, group, 2, 1) for x in (q, k, v))
        out = inner(q, k, v)
        if n > 1:
            out = distributed.all_to_all_grad(out, group, 1, 2)
        return out

    return packed_only_attention(sharded, "Ulysses")
