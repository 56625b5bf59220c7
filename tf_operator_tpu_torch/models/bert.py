"""BERT encoder for MLM pretraining. Counterpart of
tf_operator_tpu/models/bert.py.

The dtype policy is the reference's: f32 parameters, compute in
`cfg.dtype` (bf16), LayerNorm in f32 (eps 1e-6, flax's default), a
residual stream in the compute dtype, and logits emitted in the compute
dtype. Module and parameter names follow the reference's param paths
(encoder/layer_{i}/attention/query/kernel, ...), so converted weights
(models/convert.py) load by name. Parameters are drawn from the flax
initializers' distributions with a `torch.Generator`; they are not
bit-equal to flax's.

Under the tensor-parallel plan (parallel/sharding.py) each
TransformerBlock copies its halves' inputs to the tp group and its
row-parallel layers all-reduce before their biases; the MLM head is
vocab-parallel. Under sp the encoder's positions start at the rank's
offset (`seq_index`).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..ops.attention import DenseGeneral, MultiHeadAttention, lecun_normal_
from ..ops.quant import QuantDenseGeneral

LAYER_NORM_EPS = 1e-6  # flax nn.LayerNorm's default; torch's is 1e-5


@dataclasses.dataclass(frozen=True)
class BertConfig:
    vocab_size: int = 30522
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: int = 3072
    max_position_embeddings: int = 512
    dtype: torch.dtype = torch.bfloat16
    # per-block rematerialization (torch.utils.checkpoint): recompute
    # each block's forward in the backward instead of keeping its
    # activations
    remat: bool = False

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads


BERT_BASE = BertConfig()
# same parameter count as base, 6 heads x 128 dims
BERT_BASE_WIDE = BertConfig(num_heads=6)
BERT_TINY = BertConfig(
    vocab_size=1024, hidden_size=128, num_layers=2, num_heads=4,
    intermediate_size=512, max_position_embeddings=128,
)


class LayerNorm(nn.LayerNorm):
    """flax nn.LayerNorm(dtype=f32): f32 statistics and output whatever
    the input dtype."""

    def __init__(self, features: int) -> None:
        super().__init__(features, eps=LAYER_NORM_EPS)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return super().forward(x.float())


def dense(layer: nn.Module, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """flax nn.Dense(dtype=dtype): input, kernel and bias cast to dtype,
    the bias added after the product (after the all-reduce of a
    row-parallel layer's partial products). An int8 twin (ops/quant.py, a
    model through quantize_model) runs its own product in `dtype`."""
    if isinstance(layer, QuantDenseGeneral):
        return layer(x, dtype)
    y = F.linear(x.to(dtype), layer.weight.to(dtype))
    group = getattr(layer, "reduce_group", None)
    if group is not None:
        # row-parallel (parallel/sharding.py): the partial products meet
        # before the bias, which is added once
        from ..parallel.distributed import reduce_from_group

        y = reduce_from_group(y, group)
    return y + layer.bias.to(dtype)


def transformer_mlp(
    cfg: BertConfig, x: torch.Tensor, mlp_in: nn.Linear, mlp_out: nn.Linear
) -> torch.Tensor:
    """The LN'd-input MLP half of a transformer block; gelu is flax's
    default tanh approximation."""
    y = dense(mlp_in, x, cfg.dtype)
    y = F.gelu(y, approximate="tanh")
    return dense(mlp_out, y, cfg.dtype)


def init_like_flax_(model: nn.Module, generator: Optional[torch.Generator] = None) -> None:
    """flax's initializers over every submodule of `model`: lecun-normal
    Dense kernels with zero biases, Embed tables normal with variance
    1/features, LayerNorm scale 1 and bias 0."""
    with torch.no_grad():
        for module in model.modules():
            if isinstance(module, nn.Linear):
                lecun_normal_(module.weight, module.in_features, generator)
                if module.bias is not None:
                    module.bias.zero_()
            elif isinstance(module, DenseGeneral):
                module.reset_parameters(generator)
            elif isinstance(module, nn.Embedding):
                module.weight.normal_(
                    0.0, 1.0 / math.sqrt(module.embedding_dim), generator=generator,
                )
            elif isinstance(module, nn.LayerNorm):
                module.reset_parameters()


class TransformerBlock(nn.Module):
    """Pre-LN block: attention and MLP, each added to the residual
    stream. GPT, ViT and the MoE LM (models/gpt.py, vit.py, moe.py) build
    it from their own configs, which have every field read here
    (hidden_size, num_heads, head_dim, intermediate_size, dtype)."""

    def __init__(self, cfg: BertConfig, attention_fn: Optional[Callable] = None) -> None:
        super().__init__()
        self.cfg = cfg
        self.ln_attn = LayerNorm(cfg.hidden_size)
        self.attention = MultiHeadAttention(
            cfg.hidden_size, cfg.num_heads, cfg.head_dim, cfg.dtype,
            attention_fn=attention_fn,
        )
        self.ln_mlp = LayerNorm(cfg.hidden_size)
        self.mlp_in = nn.Linear(cfg.hidden_size, cfg.intermediate_size)
        self.mlp_out = nn.Linear(cfg.intermediate_size, cfg.hidden_size)
        # set by parallel/sharding.py apply_tensor_parallel: the tp group
        # the halves' inputs are copied to
        self.tp_group = None

    def _to_tp(self, y: torch.Tensor) -> torch.Tensor:
        """A half's input, copied to the tp group (identity forward,
        all-reduce backward) under the tensor-parallel plan."""
        if self.tp_group is None:
            return y
        from ..parallel.distributed import copy_to_group

        return copy_to_group(y, self.tp_group)

    def attention_half(
        self, x: torch.Tensor, mask: Optional[torch.Tensor] = None,
        attention_fn: Optional[Callable] = None,
    ) -> torch.Tensor:
        """x plus the attention of its layer norm: the block up to its
        MLP, which the MoE blocks (models/moe.py) share."""
        y = self._to_tp(self.ln_attn(x))
        return x + self.attention(y.to(self.cfg.dtype), mask, attention_fn)

    def forward(
        self, x: torch.Tensor, mask: Optional[torch.Tensor] = None,
        attention_fn: Optional[Callable] = None,
    ) -> torch.Tensor:
        """attention_fn: as MultiHeadAttention.forward's, for this call."""
        x = self.attention_half(x, mask, attention_fn)
        return x + transformer_mlp(self.cfg, self._to_tp(self.ln_mlp(x)), self.mlp_in,
                                   self.mlp_out)


class BertEncoder(nn.Module):
    def __init__(self, cfg: BertConfig, attention_fn: Optional[Callable] = None) -> None:
        super().__init__()
        self.cfg = cfg
        self.token_embed = nn.Embedding(cfg.vocab_size, cfg.hidden_size)
        self.position_embed = nn.Embedding(
            cfg.max_position_embeddings, cfg.hidden_size
        )
        for i in range(cfg.num_layers):
            self.add_module(f"layer_{i}", TransformerBlock(cfg, attention_fn))
        self.ln_final = LayerNorm(cfg.hidden_size)

    def forward(
        self, input_ids: torch.Tensor, mask: Optional[torch.Tensor] = None,
        offset: int = 0,
    ) -> torch.Tensor:
        """offset: the first position's index (a sequence shard's under sp)."""
        cfg = self.cfg
        positions = offset + torch.arange(input_ids.shape[-1], device=input_ids.device)
        # gather in f32 then cast: the same values as flax's cast-then-take
        x = (
            self.token_embed(input_ids).to(cfg.dtype)
            + self.position_embed(positions)[None].to(cfg.dtype)
        )
        attn_mask = None
        if mask is not None:
            # [batch, 1, 1, keys]: the flash kernels take this shape in-kernel
            attn_mask = mask[:, None, None, :].bool()
        for i in range(cfg.num_layers):
            block = getattr(self, f"layer_{i}")
            if cfg.remat and torch.is_grad_enabled():
                x = checkpoint(block, x, attn_mask, use_reentrant=False)
            else:
                x = block(x, attn_mask)
        return self.ln_final(x)


class BertForMLM(nn.Module):
    """Encoder + untied MLM head -> [batch, seq, vocab] logits in the
    compute dtype. Parameters are f32 on `device`, drawn from
    `generator` (on the CPU, so one seed gives the same weights on every
    device)."""

    def __init__(
        self,
        cfg: BertConfig,
        attention_fn: Optional[Callable] = None,
        device: Optional[torch.device] = None,
        generator: Optional[torch.Generator] = None,
    ) -> None:
        super().__init__()
        self.cfg = cfg
        self.encoder = BertEncoder(cfg, attention_fn)
        self.mlm_head = nn.Linear(cfg.hidden_size, cfg.vocab_size)
        # set by parallel/sharding.py: the sequence shard under sp, and
        # the head's vocab split under tp
        self.seq_index = 0
        self.vocab_shard = None
        self.reset_parameters(generator)
        if device is not None:
            self.to(device)

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        init_like_flax_(self, generator)

    def forward(
        self, input_ids: torch.Tensor, mask: Optional[torch.Tensor] = None
    ) -> torch.Tensor:
        """Under tp the logits are this rank's vocab columns (vocab_shard)."""
        hidden = self.encoder(input_ids, mask, self.seq_index * input_ids.shape[-1])
        if self.vocab_shard is not None:
            from ..parallel.distributed import copy_to_group

            hidden = copy_to_group(hidden, self.vocab_shard.group)
        return dense(self.mlm_head, hidden, self.cfg.dtype)


def mlm_loss(
    logits: torch.Tensor, labels: torch.Tensor, weights: torch.Tensor, vocab=None,
) -> torch.Tensor:
    """Masked cross-entropy; `weights` marks the masked positions. vocab:
    the logits' vocab split under tp (parallel/sharding.py VocabShard)."""
    from ..ops.losses import weighted_mean_xent

    return weighted_mean_xent(logits, labels, weights, vocab)


def synthetic_batch(
    generator: torch.Generator, batch_size: int, seq_len: int, cfg: BertConfig
) -> Dict[str, torch.Tensor]:
    """A random MLM batch on the CPU: ~15% of positions carry loss
    weight, no padding. Trainer.place_batch moves it to the device."""
    input_ids = torch.randint(
        0, cfg.vocab_size, (batch_size, seq_len), generator=generator
    )
    mlm_mask = torch.rand((batch_size, seq_len), generator=generator) < 0.15
    return {
        "input_ids": input_ids,
        "labels": input_ids,
        "mlm_weights": mlm_mask.float(),
        "attention_mask": torch.ones((batch_size, seq_len), dtype=torch.int32),
    }
