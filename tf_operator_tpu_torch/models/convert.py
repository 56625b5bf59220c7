"""Carry a flax param tree across to the port's state_dict: BERT, GPT,
ResNet, the MNIST CNN, the MoE LM and ViT.

The input is the tree as nested dicts of numpy arrays (a caller holding
a JAX tree maps `np.asarray` over it first), so this module never sees
JAX. Keys are the reference's param paths.

Under a mesh the BERT, GPT, ViT and MoE converters take `mesh` (and
`rules`, TRANSFORMER_RULES by default, MOE_RULES for the MoE LM): the
full state dict, then this rank's slice by the rules' tp plan and ep
layout (parallel/sharding.py shard_state_dict), which a model laid out
by the same rules loads. The pipelined MoE LM's converter unstacks the
reference's [S, L/S, ...] blocks and keeps this rank's stage and
experts. So both packages start from the same weights at any mesh.
"""

from __future__ import annotations

import re
from typing import Any, Dict, Mapping

import numpy as np
import torch


def _compile(rules):
    return tuple((re.compile(p), name, layout) for p, name, layout in rules)


def _transformer_rules(prefix: str, head: str):
    """(reference path, port name pattern, layout) for a transformer
    whose embeddings, layer_{i} blocks and ln_final sit under `prefix`
    ("encoder/" in BERT, "" in GPT) beside its `head` Dense. Dense
    kernels are [in, out] in flax and [out, in] in nn.Linear; DenseGeneral
    kernels (query/key/value/attn_out) keep their layouts as the port's
    own parameters; Embed tables and LayerNorm scale/bias map one to
    one."""
    layer = rf"{prefix}layer_\d+"
    norms = rf"{layer}/(?:ln_attn|ln_mlp)|{prefix}ln_final"
    denses = rf"{layer}/(?:mlp_in|mlp_out)|{head}"
    return _compile((
        (rf"({prefix}(?:token_embed|position_embed))/embedding", r"\1.weight", "keep"),
        (rf"({norms})/scale", r"\1.weight", "keep"),
        (rf"({norms})/bias", r"\1.bias", "keep"),
        (rf"({layer}/attention/(?:query|key|value|attn_out))/(kernel|bias)", r"\1.\2", "keep"),
        (rf"({denses})/kernel", r"\1.weight", "t"),
        (rf"({denses})/bias", r"\1.bias", "keep"),
    ))


_BERT_RULES = _transformer_rules("encoder/", "mlm_head")
_GPT_RULES = _transformer_rules("", "lm_head")
# a GPT tree through the reference's quantize_params (ops/quant.py): every
# projection an int8 kernel plus its f32 kernel_scale, both kept as they
# are in the int8 twin's layout (ops/quant.py QuantDenseGeneral: the
# kernel [in..., out...], as flax's), beside the f32 bias
_GPT_INT8_RULES = _compile((
    (r"((?:layer_\d+/attention/(?:query|key|value|attn_out))|layer_\d+/(?:mlp_in|mlp_out)"
     r"|lm_head)/(kernel|kernel_scale|bias)", r"\1.\2", "native"),
)) + _GPT_RULES


def _flatten(tree: Mapping[str, Any], prefix: str = "") -> Dict[str, np.ndarray]:
    flat: Dict[str, np.ndarray] = {}
    for key, value in tree.items():
        path = f"{prefix}{key}"
        if isinstance(value, Mapping):
            flat.update(_flatten(value, path + "/"))
        else:
            flat[path] = np.asarray(value)
    return flat


def _port_name(path: str, rules):
    for pattern, name, layout in rules:
        match = pattern.fullmatch(path)
        if match:
            return match.expand(name).replace("/", "."), layout
    raise KeyError(f"no mapping for flax param {path!r}")


def _for_mesh(state: Dict[str, torch.Tensor], mesh, rules) -> Dict[str, torch.Tensor]:
    """The full state dict, or this rank's slice of it under `mesh`."""
    if mesh is None:
        return state
    from ..parallel import sharding

    return sharding.shard_state_dict(state, mesh, rules or sharding.TRANSFORMER_RULES)


def bert_state_dict_from_flax(
    params: Mapping[str, Any], mesh=None, rules=None,
) -> Dict[str, torch.Tensor]:
    """flax BertForMLM params (nested dicts of numpy arrays) -> a
    state_dict for models.bert.BertForMLM (this rank's slice under
    `mesh`). Raises KeyError on a path it does not map."""
    return _for_mesh(_state_dict(params, _BERT_RULES), mesh, rules)


def gpt_state_dict_from_flax(
    params: Mapping[str, Any], mesh=None, rules=None,
) -> Dict[str, torch.Tensor]:
    """flax GPT params (nested dicts of numpy arrays) -> a state_dict for
    models.gpt.GPT (this rank's slice under `mesh`). Raises KeyError on a
    path it does not map."""
    return _for_mesh(_state_dict(params, _GPT_RULES), mesh, rules)


def gpt_int8_state_dict_from_flax(params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """A quantized flax GPT tree (the reference's quantize_params output:
    int8 kernels beside f32 kernel_scale) -> a state_dict for the int8
    twin of models.gpt.GPT (ops/quant.py quantize_model), the int8
    bytes as they are. Raises KeyError on a path it does not map."""
    return _state_dict(params, _GPT_INT8_RULES)


def _to_tensor(value: np.ndarray, layout: str) -> torch.Tensor:
    """"t" transposes a Dense kernel, "oihw" turns an HWIO conv kernel
    into F.conv2d's layout, "keep" keeps it, each as f32; "native" keeps
    the array and its dtype (bf16 arrives as ml_dtypes' bfloat16, which
    torch does not read: widened to f32, exactly, and rounded back)."""
    if layout == "native":
        if value.dtype.name == "bfloat16":
            return torch.tensor(value.astype(np.float32)).to(torch.bfloat16)
        return torch.tensor(np.ascontiguousarray(value))
    if layout == "oihw":
        value = value.transpose(3, 2, 0, 1)
    elif layout == "t":
        value = value.T
    return torch.tensor(np.ascontiguousarray(value), dtype=torch.float32)


def _state_dict(params: Mapping[str, Any], rules) -> Dict[str, torch.Tensor]:
    state: Dict[str, torch.Tensor] = {}
    for path, value in _flatten(params).items():
        name, layout = _port_name(path, rules)
        state[name] = _to_tensor(value, layout)
    return state


# ResNet: (reference path, port name pattern, layout). Conv kernels are
# HWIO in flax and OIHW for F.conv2d ("oihw"); PallasConv3x3 keeps its
# HWIO kernel ("keep"); the Dense kernel is [in, out] in flax and
# [out, in] in nn.Linear ("t"). BatchNorm scale/bias are parameters,
# mean/var (from batch_stats) buffers of the same module, named
# TpuBatchNorm_i or, under norm_impl="flax", flax's BatchNorm_i.
_BLOCK = r"BottleneckBlock_\d+"
_BN = rf"(?:stem_bn|{_BLOCK}/(?:TpuBatchNorm_[012]|BatchNorm_[012]|proj_bn))"
_RESNET_PARAMS = (
    (r"(stem|stem_s2d)/kernel", r"\1.weight", "oihw"),
    (rf"({_BN})/(scale|bias)", r"\1.\2", "keep"),
    (rf"({_BLOCK})/(Conv_0|Conv_2|proj)/kernel", r"\1.\2.weight", "oihw"),
    (r"(Dense_0)/kernel", r"\1.weight", "t"),
    (r"(Dense_0)/bias", r"\1.bias", "keep"),
)
_RESNET_STATS = ((rf"({_BN})/(mean|var)", r"\1.\2", "keep"),)


def resnet_state_dict_from_flax(
    params: Mapping[str, Any], batch_stats: Mapping[str, Any],
    conv3_impl: str = "xla",
) -> Dict[str, torch.Tensor]:
    """flax ResNet params and batch_stats (nested dicts of numpy arrays)
    -> a state_dict for models.resnet.ResNet built with the same
    `conv3_impl`: its Conv_1 is an F.conv2d Conv (OIHW `weight`) under
    "xla" and a PallasConv3x3 (HWIO `kernel`) under "pallas". Raises
    KeyError on a path it does not map."""
    conv1 = (rf"({_BLOCK})/(Conv_1)/kernel",) + (
        (r"\1.\2.kernel", "keep") if conv3_impl == "pallas" else (r"\1.\2.weight", "oihw")
    )
    return {**_state_dict(params, _compile(_RESNET_PARAMS + (conv1,))),
            **_state_dict(batch_stats, _compile(_RESNET_STATS))}


_MNIST_PARAMS = _compile((
    (r"(Conv_[01])/kernel", r"\1.weight", "oihw"),
    (r"(Dense_[01])/kernel", r"\1.weight", "t"),
    (r"(Conv_[01]|Dense_[01])/bias", r"\1.bias", "keep"),
))


def mnist_state_dict_from_flax(params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """flax MnistCNN params (nested dicts of numpy arrays) -> a state_dict
    for models.mnist.MnistCNN: conv kernels HWIO -> OIHW, Dense kernels
    [in, out] -> [out, in]. Dense_0's rows stay in the reference's NHWC
    flatten order, which the port's forward reproduces. Raises KeyError on
    a path it does not map."""
    return _state_dict(params, _MNIST_PARAMS)


# MoELM: the blocks as GPT's; embed/ and head/ are flax submodules whose
# params sit on the port's root; the router's Dense kernel transposes,
# the expert kernels keep their layout and their dtype (bf16 in MOE_BASE)
_MOE_PARAMS = _transformer_rules("", "lm_head") + _compile((
    (r"embed/(token_embed|position_embed)/embedding", r"\1.weight", "keep"),
    (r"head/(ln_final)/scale", r"\1.weight", "keep"),
    (r"head/(ln_final)/bias", r"\1.bias", "keep"),
    (r"head/(lm_head)/kernel", r"\1.weight", "t"),
    (r"(layer_\d+/moe_mlp/router_gate/router)/kernel", r"\1.weight", "t"),
    (r"(layer_\d+/moe_mlp/(?:expert_in|expert_out))", r"\1", "native"),
))
# ViT: the blocks, ln_final and the Dense head as GPT's; the patch conv
# HWIO -> OIHW, the f32 cls_token and position_embed as they are
_VIT_PARAMS = _transformer_rules("", "head") + _compile((
    (r"patch_embed/kernel", r"patch_embed.weight", "oihw"),
    (r"patch_embed/bias", r"patch_embed.bias", "keep"),
    (r"(cls_token|position_embed)", r"\1", "keep"),
))


def moe_state_dict_from_flax(
    params: Mapping[str, Any], mesh=None, rules=None,
) -> Dict[str, torch.Tensor]:
    """flax MoELM params (nested dicts of numpy arrays) -> a state_dict
    for models.moe.MoELM (this rank's slice by MOE_RULES, or `rules`,
    under `mesh`). The expert kernels keep their dtype. Raises KeyError on
    a path it does not map."""
    state = _state_dict(params, _MOE_PARAMS)
    if mesh is None:
        return state
    from ..parallel import sharding

    return _for_mesh(state, mesh, rules or sharding.MOE_RULES)


def _unstack(tree: Mapping[str, Any], s: int, layer: int) -> Dict[str, Any]:
    return {k: _unstack(v, s, layer) if isinstance(v, Mapping) else np.asarray(v)[s, layer]
            for k, v in tree.items()}


def moe_pipeline_state_dict_from_flax(
    params: Mapping[str, Any], mesh=None,
) -> Dict[str, torch.Tensor]:
    """The reference's PipelinedMoELM params ({embed, blocks, head}, the
    blocks' leaves [S, L/S, ...] from its stack_layers) -> the full
    MoELM-named state_dict, block (s, l) as layer_{s * L/S + l}; under
    `mesh`, this rank's part of it for models.moe_pipeline.PipelinedMoELM
    (its stage's layers, its ep rank's experts)."""
    stages, per = next(iter(_flatten(params["blocks"]).values())).shape[:2]
    tree = {"embed": params["embed"], "head": params["head"]}
    for s in range(stages):
        for layer in range(per):
            tree[f"layer_{s * per + layer}"] = _unstack(params["blocks"], s, layer)
    state = _state_dict(tree, _MOE_PARAMS)
    if mesh is None:
        return state
    from .moe_pipeline import local_state_dict

    return local_state_dict(state, mesh)


def vit_state_dict_from_flax(
    params: Mapping[str, Any], mesh=None, rules=None,
) -> Dict[str, torch.Tensor]:
    """flax ViT params (nested dicts of numpy arrays) -> a state_dict for
    models.vit.ViT: the patch kernel HWIO -> OIHW, Dense kernels [in,
    out] -> [out, in] (this rank's slice under `mesh`). Raises KeyError
    on a path it does not map."""
    return _for_mesh(_state_dict(params, _VIT_PARAMS), mesh, rules)
