"""Fused cross-entropy over large vocabularies. Counterpart of
tf_operator_tpu/ops/losses.py.

The forward is `logsumexp(logits) - logits[label]` with f32 only at the
reduced [tokens] shape. The backward saves the logits at their own
precision plus the f32 row lse and rebuilds the softmax, d_logits =
(p - onehot) * g, so no second full-vocab f32 tensor is kept between
forward and backward.
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
) -> torch.Tensor:
    """Weighted-mean scalar cross-entropy; weights None means uniform."""
    xent = cross_entropy_with_integer_labels(logits, labels)
    if weights is None:
        return xent.mean()
    w = weights.float()
    return (xent * w).sum() / torch.clamp(w.sum(), min=1.0)
