"""Vision Transformer. Counterpart of tf_operator_tpu/models/vit.py.

The encoder is BERT's TransformerBlock (models/bert.py) built from
`ViTConfig.block_config()`, so its parameter names and dtype policy are
BERT's: f32 parameters cast at use, f32 LayerNorm, compute in cfg.dtype.

- Input: the reference's NHWC images, f32 or uint8. uint8 is normalized
  on the device in cfg.dtype, each step rounded there:
  (x - 127.5) * (1 / 127.5).
- Patchify: a patch x patch, stride-patch convolution (F.conv2d on an
  NCHW view of the NHWC batch, OIHW kernel) in cfg.dtype, the bias added
  after it as flax's Conv adds it. Its [b, hidden, h', w'] output is
  flattened row-major over (h', w'), the reference's patch order, so
  position_embed lands on the same patches.
- `cls` pooling prepends a zero-initialised f32 cls_token; `gap` (the
  default) averages the tokens. position_embed [1, tokens, hidden] is
  f32, cast at use. ln_final in f32, then an f32 head.
- remat recomputes each block in the backward (torch.utils.checkpoint).

Attention is plain `dot_product_attention`, as the reference's
`attention_fn=None`. Parameters are drawn from flax's initializers'
distributions with a `torch.Generator`, not bit-equal to flax's.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..ops.attention import lecun_normal_
from .bert import BertConfig, LayerNorm, TransformerBlock, init_like_flax_


@dataclasses.dataclass(frozen=True)
class ViTConfig:
    image_size: int = 224
    patch_size: int = 16
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: int = 3072
    num_classes: int = 1000
    dtype: torch.dtype = torch.bfloat16
    pool: str = "gap"  # "gap" or "cls"
    remat: bool = False

    def __post_init__(self) -> None:
        if self.pool not in ("gap", "cls"):
            raise ValueError(f"pool must be 'gap' or 'cls', got {self.pool!r}")

    @property
    def num_patches(self) -> int:
        if self.image_size % self.patch_size:
            raise ValueError(
                f"image_size {self.image_size} not divisible by "
                f"patch_size {self.patch_size}"
            )
        return (self.image_size // self.patch_size) ** 2

    def block_config(self) -> BertConfig:
        """The view of this config that the encoder blocks read."""
        return BertConfig(
            hidden_size=self.hidden_size, num_layers=self.num_layers,
            num_heads=self.num_heads, intermediate_size=self.intermediate_size,
            dtype=self.dtype, remat=self.remat,
        )


VIT_B16 = ViTConfig()
VIT_TINY = ViTConfig(
    image_size=32, patch_size=8, hidden_size=64, num_layers=2,
    num_heads=4, intermediate_size=128, num_classes=10,
)


class ViT(nn.Module):
    """images [b, H, W, 3] (f32 or uint8) -> f32 logits [b, classes].
    Parameters are drawn from `generator` (on the CPU) and moved to
    `device`."""

    def __init__(
        self, cfg: ViTConfig, device: Optional[torch.device] = None,
        generator: Optional[torch.Generator] = None,
    ) -> None:
        super().__init__()
        self.cfg = cfg
        block_cfg = cfg.block_config()
        tokens = cfg.num_patches + (cfg.pool == "cls")
        self.patch_embed = nn.Conv2d(
            3, cfg.hidden_size, cfg.patch_size, stride=cfg.patch_size
        )
        if cfg.pool == "cls":
            self.cls_token = nn.Parameter(torch.zeros(1, 1, cfg.hidden_size))
        self.position_embed = nn.Parameter(torch.zeros(1, tokens, cfg.hidden_size))
        for i in range(cfg.num_layers):
            self.add_module(f"layer_{i}", TransformerBlock(block_cfg))
        self.ln_final = LayerNorm(cfg.hidden_size)
        self.head = nn.Linear(cfg.hidden_size, cfg.num_classes)
        init_like_flax_(self, generator)
        with torch.no_grad():
            fan_in = 3 * cfg.patch_size ** 2
            lecun_normal_(self.patch_embed.weight, fan_in, generator)
            self.patch_embed.bias.zero_()
            self.position_embed.normal_(0.0, 0.02, generator=generator)
        if device is not None:
            self.to(device)

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        dtype = cfg.dtype
        if images.dtype == torch.uint8:
            images = (images.to(dtype) - 127.5) * (1.0 / 127.5)
        x = F.conv2d(
            images.to(dtype).permute(0, 3, 1, 2),
            self.patch_embed.weight.to(dtype), stride=cfg.patch_size,
        )
        x = x + self.patch_embed.bias.to(dtype)[None, :, None, None]
        batch = x.shape[0]
        x = x.flatten(2).transpose(1, 2)  # [b, h' * w', hidden], row-major
        if cfg.pool == "cls":
            cls = self.cls_token.to(dtype).expand(batch, 1, cfg.hidden_size)
            x = torch.cat([cls, x], dim=1)
        x = x + self.position_embed.to(dtype)
        for i in range(cfg.num_layers):
            block = getattr(self, f"layer_{i}")
            if cfg.remat and torch.is_grad_enabled():
                x = checkpoint(block, x, None, use_reentrant=False)
            else:
                x = block(x)
        x = self.ln_final(x)
        pooled = x[:, 0] if cfg.pool == "cls" else x.mean(dim=1)
        return F.linear(pooled.float(), self.head.weight, self.head.bias)


CLASS_MEANS_SEED = 42


def synthetic_batch(
    generator: torch.Generator, batch_size: int, cfg: ViTConfig = VIT_TINY
) -> Dict[str, torch.Tensor]:
    """Learnable synthetic classification data on the CPU, the
    reference's recipe: each class has its own mean (drawn from a
    generator seeded CLASS_MEANS_SEED), images are that mean plus 0.5 x
    unit noise, f32 NHWC. The draws are torch's."""
    labels = torch.randint(0, cfg.num_classes, (batch_size,), generator=generator)
    means = torch.randn(
        (cfg.num_classes, 1, 1, 1), generator=torch.Generator().manual_seed(CLASS_MEANS_SEED)
    )
    noise = torch.randn((batch_size, cfg.image_size, cfg.image_size, 3), generator=generator)
    return {"image": means[labels] + 0.5 * noise, "label": labels}
