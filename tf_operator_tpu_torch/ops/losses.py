"""Fused cross-entropy over large vocabularies. Counterpart of
tf_operator_tpu/ops/losses.py.

The forward is `logsumexp(logits) - logits[label]` with f32 only at the
reduced [tokens] shape. The backward saves the logits at their own
precision plus the f32 row lse and rebuilds the softmax, d_logits =
(p - onehot) * g, so no second full-vocab f32 tensor is kept between
forward and backward.

`vocab_parallel_cross_entropy` is the same loss over logits whose vocab
is split across the ranks of a tensor-parallel group (the reference's
vocab-on-tp head, parallel/sharding.py TRANSFORMER_RULES, for which
GSPMD inserts the collectives): the row max and the exp-sum are
all-reduced, the picked logit is taken on the rank that owns the label
and all-reduced, and the backward is local. No rank holds the full
[tokens, vocab] logits.
"""

from __future__ import annotations

from typing import Optional

import torch


def _lse(logits: torch.Tensor) -> torch.Tensor:
    x = logits.float()
    m = x.amax(dim=-1, keepdim=True)
    return torch.log(torch.exp(x - m).sum(dim=-1)) + m[..., 0]


def _picked(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    return logits.gather(-1, labels[..., None].long())[..., 0].float()


class _CrossEntropy(torch.autograd.Function):
    @staticmethod
    def forward(ctx, logits, labels):
        lse = _lse(logits)
        ctx.save_for_backward(logits, labels, lse)
        return lse - _picked(logits, labels)

    @staticmethod
    def backward(ctx, g):
        logits, labels, lse = ctx.saved_tensors
        p = torch.exp(logits.float() - lse[..., None])
        # p - onehot in place: one subtraction at each label, no
        # materialized one-hot
        index = labels[..., None].long()
        p.scatter_add_(-1, index, torch.full(index.shape, -1.0, device=p.device))
        return (p * g.float()[..., None]).to(logits.dtype), None


class _VocabParallelCrossEntropy(torch.autograd.Function):
    """logits: this rank's vocab columns [start, start + V_local) of the
    [..., V] logits; labels: global ids. Returns the full loss, the same
    on every rank of the group."""

    @staticmethod
    def forward(ctx, logits, labels, start, group):
        from ..parallel.distributed import all_reduce

        x = logits.float()
        m = all_reduce(x.amax(dim=-1), group, op="max")
        sumexp = all_reduce(torch.exp(x - m[..., None]).sum(dim=-1), group)
        lse = torch.log(sumexp) + m
        local = labels.long() - start
        owned = (local >= 0) & (local < logits.shape[-1])
        index = torch.where(owned, local, torch.zeros_like(local))
        picked = logits.gather(-1, index[..., None])[..., 0].float()
        picked = all_reduce(torch.where(owned, picked, torch.zeros_like(picked)), group)
        ctx.save_for_backward(logits, index, owned, lse)
        return lse - picked

    @staticmethod
    def backward(ctx, g):
        logits, index, owned, lse = ctx.saved_tensors
        p = torch.exp(logits.float() - lse[..., None])
        # minus one at the label's column, on the rank that owns it
        p.scatter_add_(-1, index[..., None], -owned[..., None].float())
        return (p * g.float()[..., None]).to(logits.dtype), None, None, None


def vocab_parallel_cross_entropy(
    logits: torch.Tensor, labels: torch.Tensor, start: int, group,
) -> torch.Tensor:
    """Per-position cross-entropy (f32, shape = labels.shape) of logits
    split on their vocab over `group`: this rank holds columns [start,
    start + logits.shape[-1])."""
    return _VocabParallelCrossEntropy.apply(logits, labels, start, group)


def cross_entropy_with_integer_labels(
    logits: torch.Tensor, labels: torch.Tensor
) -> torch.Tensor:
    """Per-position cross-entropy, f32, shape = labels.shape.
    logits: [..., vocab] (any float dtype); labels: [...] int."""
    return _CrossEntropy.apply(logits, labels)


def weighted_mean_xent(
    logits: torch.Tensor,
    labels: torch.Tensor,
    weights: Optional[torch.Tensor] = None,
    vocab=None,
) -> torch.Tensor:
    """Weighted-mean scalar cross-entropy; weights None means uniform.
    vocab: where the logits are split on their vocab, the split's
    (start, group) (parallel/sharding.py VocabShard)."""
    if vocab is None:
        xent = cross_entropy_with_integer_labels(logits, labels)
    else:
        xent = vocab_parallel_cross_entropy(logits, labels, vocab.start, vocab.group)
    if weights is None:
        return xent.mean()
    w = weights.float()
    return (xent * w).sum() / torch.clamp(w.sum(), min=1.0)
