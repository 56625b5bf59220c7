"""int8 weights for the decode path. Counterpart of
tf_operator_tpu/ops/quant.py.

Decode reads every weight matrix once per committed token, so storing
the kernels as int8 with one f32 scale per feature slice cuts the weight
bytes a step reads. The scale multiplies the product's output, never a
dequantized copy of the kernel:

    y = x @ (Kq * s)  =  (x @ Kq) * s      # s constant over the
                                           # contracted axes

The product is a plain one: the int8 kernel converted to the compute
dtype, the activations untouched (this is not torch._int_mm, which
would quantize the activations too).

- `quantize_kernel`, `quantize_params`, `is_quantized`: the reference's
  transform, on tensors; `quantize_params` walks a nested dict in the
  reference's layouts (flax paths, kernels in_shape + out_shape).
- `QuantDenseGeneral` (and `QuantDense`, `quant_head_projection`): the
  int8 twins of the port's DenseGeneral and nn.Linear, holding an int8
  `kernel` [in..., out...], an f32 `kernel_scale` [out...] and the f32
  `bias` as buffers.
- `quantize_model`: the decode path's int8 twin of a model: every
  nn.Linear and DenseGeneral replaced by its twin, the embeddings and
  LayerNorms the same modules (no copy). The f32 kernels are not
  referenced by the twin, so once the caller drops the f32 model only
  int8 kernels and their scales stay on the device.
"""

from __future__ import annotations

import copy
import math
from typing import Dict, Mapping, Optional, Sequence, Tuple, Union

import torch
from torch import nn

from .attention import DenseGeneral


def f32_scalar(value: float, device) -> torch.Tensor:
    """A 0-d f32 tensor on `device`, made by a fill (a CUDA graph can
    capture it). Dividing by it is a true division on every device; a
    Python-number divisor is applied on CUDA as a product with its
    reciprocal, which rounds 1 ulp away from the reference's quotient."""
    return torch.full((), value, dtype=torch.float32, device=device)


def quantize_kernel(kernel: torch.Tensor, n_contract: int = 1) -> Tuple[torch.Tensor, torch.Tensor]:
    """(int8 kernel, f32 scale over every non-contracted axis): the
    absmax of each feature slice over the first `n_contract` axes, over
    127, in the reference's op order (round(k / (max(absmax, 1e-8) /
    127)), half to even)."""
    k32 = kernel.detach().float()
    reduce_axes = tuple(range(n_contract))
    s = torch.amax(k32.abs(), dim=reduce_axes).clamp_min(1e-8) / f32_scalar(127.0, k32.device)
    q = torch.round(k32 / s[(None,) * n_contract]).clamp(-127, 127).to(torch.int8)
    return q, s


def quantize_params(params: Mapping) -> dict:
    """The reference's params transform on a nested dict of tensors in
    the reference's layouts: every dict holding a "kernel" of ndim >= 2
    that is not yet int8 gets the int8 kernel plus a "kernel_scale"
    sibling; everything else passes through. Idempotent. An "attn_out"
    kernel of ndim 3 ([heads, head_dim, out]) contracts its two leading
    axes, every other kernel its first; a kernel of ndim >= 4 (a conv's)
    is refused rather than mis-scaled."""

    def walk(node, path=()):
        if not isinstance(node, Mapping):
            return node
        out = {}
        for key, value in node.items():
            if (key == "kernel" and isinstance(value, torch.Tensor) and value.dim() >= 2
                    and value.dtype != torch.int8):
                if value.dim() >= 4:
                    joined = "/".join((*path, key))
                    raise ValueError(
                        f"quantize_params: kernel at '{joined}' has ndim {value.dim()} "
                        "(a conv-family shape); only the decode matmul family "
                        "(ndim <= 3) has a known contraction here — refusing to emit "
                        "a mis-scaled int8 export"
                    )
                n_contract = 2 if path and path[-1] == "attn_out" and value.dim() == 3 else 1
                out["kernel"], out["kernel_scale"] = quantize_kernel(value, n_contract)
            else:
                out[key] = walk(value, path + (key,))
        return out

    return walk(params)


def is_quantized(obj) -> bool:
    """Whether a model (its state) or a nested dict of tensors holds an
    int8 tensor."""
    if isinstance(obj, nn.Module):
        obj = obj.state_dict()
    if isinstance(obj, Mapping):
        return any(is_quantized(value) for value in obj.values())
    return isinstance(obj, torch.Tensor) and obj.dtype == torch.int8


class QuantDenseGeneral(nn.Module):
    """The int8 twin of DenseGeneral (and of nn.Linear, with in_shape
    (in,)): buffers `kernel` int8 [*in_shape, *out_shape], `kernel_scale`
    f32 [*out_shape] and `bias` f32 [*out_shape]. The product runs in
    `dtype` on the kernel converted to it, is cast to f32, multiplied by
    the scale, cast back to `dtype`, and then the bias is added in
    `dtype`: the rounding points of the reference's QuantDenseGeneral."""

    def __init__(self, in_shape: Sequence[int], out_shape: Sequence[int],
                 dtype: torch.dtype) -> None:
        super().__init__()
        self.in_shape = tuple(in_shape)
        self.out_shape = tuple(out_shape)
        self.dtype = dtype
        self.register_buffer("kernel", torch.zeros(*self.in_shape, *self.out_shape,
                                                   dtype=torch.int8))
        self.register_buffer("kernel_scale", torch.ones(*self.out_shape))
        self.register_buffer("bias", torch.zeros(*self.out_shape))
        # set by parallel/sharding.py apply_tensor_parallel on a
        # row-parallel layer: the partial products meet before the scale
        self.reduce_group = None

    def forward(self, x: torch.Tensor, dtype: Optional[torch.dtype] = None) -> torch.Tensor:
        dtype = dtype or self.dtype
        fan_in, fan_out = math.prod(self.in_shape), math.prod(self.out_shape)
        lead = x.shape[: x.dim() - len(self.in_shape)]
        kernel = self.kernel.to(dtype).reshape(fan_in, fan_out)
        y = x.to(dtype).reshape(*lead, fan_in) @ kernel
        if self.reduce_group is not None:
            from ..parallel.distributed import reduce_from_group

            y = reduce_from_group(y, self.reduce_group)
        y = (y.float() * self.kernel_scale.reshape(fan_out)).to(dtype)
        y = y + self.bias.to(dtype).reshape(fan_out)
        return y.reshape(*lead, *self.out_shape)

    @torch.no_grad()
    def load_quantized(self, node: Mapping) -> None:
        """Copy a quantize_params node ({"kernel", "kernel_scale", "bias"})
        into the buffers in place (captured programs keep their
        addresses)."""
        for name in ("kernel", "kernel_scale", "bias"):
            getattr(self, name).copy_(node[name])


def QuantDense(in_features: int, out_features: int, dtype: torch.dtype) -> QuantDenseGeneral:
    """The int8 twin of nn.Linear, in DenseGeneral's layout: kernel [in,
    out]."""
    return QuantDenseGeneral((in_features,), (out_features,), dtype)


def quant_head_projection(hidden: int, num_heads: int, head_dim: int,
                          dtype: torch.dtype) -> QuantDenseGeneral:
    """The int8 twin of ops.attention.head_projection: [..., hidden] ->
    [..., num_heads, head_dim]."""
    return QuantDenseGeneral((hidden,), (num_heads, head_dim), dtype)


def _kernel_tree(kernels: Mapping[str, Tuple[torch.Tensor, torch.Tensor]]) -> dict:
    """{module path: (kernel, bias)} -> the reference's nested params tree."""
    tree: Dict = {}
    for name, (kernel, bias) in kernels.items():
        node = tree
        for part in name.split("."):
            node = node.setdefault(part, {})
        node["kernel"], node["bias"] = kernel, bias
    return tree


def _at(tree: Mapping, name: str) -> Mapping:
    for part in name.split("."):
        tree = tree[part]
    return tree


def projection_params(model: nn.Module) -> dict:
    """The model's projections as the reference's params tree: for every
    nn.Linear (kernel = weight.T, [in, out]) and DenseGeneral (kernel as
    it is), {"kernel", "bias"} at its module path, nested by name."""
    kernels = {}
    for name, module in model.named_modules():
        if isinstance(module, nn.Linear):
            kernels[name] = (module.weight.detach().t(), module.bias.detach())
        elif isinstance(module, DenseGeneral):
            kernels[name] = (module.kernel.detach(), module.bias.detach())
    return _kernel_tree(kernels)


def _twin(module: nn.Module, node: Union[Mapping, None], dtype: torch.dtype) -> nn.Module:
    if isinstance(module, (nn.Linear, DenseGeneral)):
        if isinstance(module, nn.Linear):
            quant = QuantDense(module.in_features, module.out_features, dtype)
        else:
            quant = QuantDenseGeneral(module.in_shape, module.out_shape, module.dtype)
        quant.to(node["kernel"].device)
        quant.load_quantized(node)
        return quant
    if node is None:
        return module  # no projection below: the same module, shared
    clone = copy.copy(module)
    clone._parameters = dict(module._parameters)
    clone._buffers = dict(module._buffers)
    clone._modules = {name: _twin(child, node.get(name), dtype)
                      for name, child in module._modules.items()}
    return clone


@torch.no_grad()
def quantize_model(model: nn.Module) -> nn.Module:
    """The decode path's int8 twin of `model` (a GPT): one quantize_params
    over its projections, each nn.Linear and DenseGeneral replaced by a
    QuantDenseGeneral holding the result; every other module (the
    embeddings, the LayerNorms) is the same object. A model that is
    already int8 is returned as it is."""
    if is_quantized(model):
        return model
    quantized = quantize_params(projection_params(model))
    return _twin(model, quantized, model.cfg.dtype)


@torch.no_grad()
def requantize_into(twin: nn.Module, state: Mapping[str, torch.Tensor]) -> None:
    """Quantize an f32 state dict of the unquantized model (its names and
    layouts) into the twin's tensors in place, so programs captured over
    the twin read the new weights: the projections through one
    quantize_params, everything else copied."""
    quant = {name: module for name, module in twin.named_modules()
             if isinstance(module, QuantDenseGeneral)}
    kernels = {}
    for name in quant:
        weight = state.get(f"{name}.weight")
        kernel = weight.t() if weight is not None else state[f"{name}.kernel"]
        kernels[name] = (kernel, state[f"{name}.bias"])
    quantized = quantize_params(_kernel_tree(kernels))
    for name, module in quant.items():
        module.load_quantized(_at(quantized, name))
    own = twin.state_dict()
    for name, tensor in state.items():
        if name.rpartition(".")[0] not in quant:
            own[name].copy_(tensor)
