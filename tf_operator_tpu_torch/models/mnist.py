"""MNIST CNN, the hello-world TFJob workload. Counterpart of
tf_operator_tpu/models/mnist.py (dist_mnist.py's architecture):
conv5x5(32) -> pool -> conv5x5(64) -> pool -> fc(1024) -> fc(10).

Images come in as the reference takes them, [N, 28, 28, 1] (NHWC), and
the convolutions run NCHW. The reference flattens its NHWC activations
before Dense_0 (:34), so the features reach Dense_0 in (h, w, c) order:
the port permutes back to NHWC before flattening, which keeps Dense_0's
rows in the reference's order (models/convert.py carries them across by
a transpose alone).

The class prototypes are the port's own (a torch.Generator and a bicubic
resize, where the reference draws with jax.random and resizes with
jax.image), so the two packages' synthetic batches differ; parity tests
feed both models the same numpy images.
"""

from __future__ import annotations

import functools
from typing import Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.attention import lecun_normal_

PROTOTYPE_SEED = 42


class MnistCNN(nn.Module):
    """Weights as flax initializes them (lecun_normal kernels, zero
    biases), drawn from `generator`."""

    def __init__(
        self, dtype: torch.dtype = torch.float32, generator: Optional[torch.Generator] = None,
    ) -> None:
        super().__init__()
        self.dtype = dtype
        self.Conv_0 = nn.Conv2d(1, 32, 5, padding=2)
        self.Conv_1 = nn.Conv2d(32, 64, 5, padding=2)
        self.Dense_0 = nn.Linear(7 * 7 * 64, 1024)
        self.Dense_1 = nn.Linear(1024, 10)
        for layer in (self.Conv_0, self.Conv_1, self.Dense_0, self.Dense_1):
            fan_in = layer.weight[0].numel()
            lecun_normal_(layer.weight, fan_in, generator)
            nn.init.zeros_(layer.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x [N, 28, 28, 1] -> f32 logits [N, 10]."""
        x = x.to(self.dtype).permute(0, 3, 1, 2)
        x = F.max_pool2d(torch.relu(self.Conv_0(x)), 2)
        x = F.max_pool2d(torch.relu(self.Conv_1(x)), 2)
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)  # NHWC order, as flax
        x = torch.relu(self.Dense_0(x))
        return self.Dense_1(x).float()


@functools.lru_cache(maxsize=1)
def _digit_prototypes() -> torch.Tensor:
    """Ten fixed low-frequency 28x28 'digit' prototypes [10, 28, 28, 1],
    the same in every process: 7x7 noise upsampled bicubically, so each
    class has a smooth, translatable shape a CNN can generalize over."""
    coarse = torch.randn((10, 1, 7, 7), generator=torch.Generator().manual_seed(PROTOTYPE_SEED))
    fine = F.interpolate(coarse, size=(28, 28), mode="bicubic", align_corners=False)
    return fine.permute(0, 2, 3, 1).contiguous()


def synthetic_batch(
    generator: torch.Generator, batch_size: int, noise: float = 0.3,
) -> Dict[str, torch.Tensor]:
    """Learnable synthetic MNIST stand-in: each sample is its class
    prototype rolled by up to +-3 pixels on each axis plus Gaussian noise.
    Fresh batches are new samples of one distribution, so held-out
    accuracy measures generalization."""
    labels = torch.randint(0, 10, (batch_size,), generator=generator)
    shifts = torch.randint(-3, 4, (batch_size, 2), generator=generator)
    grid = torch.arange(28)
    rows = (grid[None, :] - shifts[:, :1]) % 28  # roll: out[i] = in[i - shift]
    cols = (grid[None, :] - shifts[:, 1:]) % 28
    images = _digit_prototypes()[labels[:, None, None], rows[:, :, None], cols[:, None, :]]
    images = images + noise * torch.randn(images.shape, generator=generator)
    return {"image": images, "label": labels}
