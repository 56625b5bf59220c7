"""Carry a flax param tree across to the port's state_dict: BERT and
ResNet.

The input is the tree as nested dicts of numpy arrays (a caller holding
a JAX tree maps `np.asarray` over it first), so this module never sees
JAX. Keys are the reference's param paths.
"""

from __future__ import annotations

import re
from typing import Any, Dict, Mapping

import numpy as np
import torch

# (reference path, port name pattern, transpose): Dense kernels are
# [in, out] in flax and [out, in] in nn.Linear; DenseGeneral kernels
# (query/key/value/attn_out) keep their layouts as the port's own
# parameters; Embed tables and LayerNorm scale/bias map one to one.
_LAYER = r"encoder/layer_\d+"
_RULES = (
    (rf"(encoder)/(token_embed|position_embed)/embedding", r"\1.\2.weight", False),
    (rf"({_LAYER})/(ln_attn|ln_mlp)/scale", r"\1.\2.weight", False),
    (rf"({_LAYER})/(ln_attn|ln_mlp)/bias", r"\1.\2.bias", False),
    (r"(encoder)/(ln_final)/scale", r"\1.\2.weight", False),
    (r"(encoder)/(ln_final)/bias", r"\1.\2.bias", False),
    (rf"({_LAYER})/attention/(query|key|value|attn_out)/(kernel|bias)",
     r"\1.attention.\2.\3", False),
    (rf"({_LAYER})/(mlp_in|mlp_out)/kernel", r"\1.\2.weight", True),
    (rf"({_LAYER})/(mlp_in|mlp_out)/bias", r"\1.\2.bias", False),
    (r"(mlm_head)/kernel", r"\1.weight", True),
    (r"(mlm_head)/bias", r"\1.bias", False),
)
_COMPILED = tuple((re.compile(p), name, t) for p, name, t in _RULES)


def _flatten(tree: Mapping[str, Any], prefix: str = "") -> Dict[str, np.ndarray]:
    flat: Dict[str, np.ndarray] = {}
    for key, value in tree.items():
        path = f"{prefix}{key}"
        if isinstance(value, Mapping):
            flat.update(_flatten(value, path + "/"))
        else:
            flat[path] = np.asarray(value)
    return flat


def _port_name(path: str, rules=_COMPILED):
    for pattern, name, transpose in rules:
        match = pattern.fullmatch(path)
        if match:
            return match.expand(name).replace("/", "."), transpose
    raise KeyError(f"no mapping for flax param {path!r}")


def bert_state_dict_from_flax(params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """flax BertForMLM params (nested dicts of numpy arrays) -> a
    state_dict for models.bert.BertForMLM. Raises KeyError on a path it
    does not map."""
    state: Dict[str, torch.Tensor] = {}
    for path, value in _flatten(params).items():
        name, transpose = _port_name(path)
        array = value.T if transpose else value
        state[name] = torch.tensor(array, dtype=torch.float32)
    return state


# ResNet: (reference path, port name pattern, layout). Conv kernels are
# HWIO in flax and OIHW for F.conv2d ("oihw"); PallasConv3x3 keeps its
# HWIO kernel ("keep"); the Dense kernel is [in, out] in flax and
# [out, in] in nn.Linear ("t"). BatchNorm scale/bias are parameters,
# mean/var (from batch_stats) buffers of the same module.
_BLOCK = r"BottleneckBlock_\d+"
_BN = rf"(?:stem_bn|{_BLOCK}/(?:TpuBatchNorm_[012]|proj_bn))"
_RESNET_PARAMS = (
    (r"(stem|stem_s2d)/kernel", r"\1.weight", "oihw"),
    (rf"({_BN})/(scale|bias)", r"\1.\2", "keep"),
    (rf"({_BLOCK})/(Conv_0|Conv_2|proj)/kernel", r"\1.\2.weight", "oihw"),
    (r"(Dense_0)/kernel", r"\1.weight", "t"),
    (r"(Dense_0)/bias", r"\1.bias", "keep"),
)
_RESNET_STATS = ((rf"({_BN})/(mean|var)", r"\1.\2", "keep"),)


def _compile(rules):
    return tuple((re.compile(p), name, layout) for p, name, layout in rules)


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
    param_rules = _compile(_RESNET_PARAMS + (conv1,))
    stat_rules = _compile(_RESNET_STATS)
    state: Dict[str, torch.Tensor] = {}
    for tree, rules in ((params, param_rules), (batch_stats, stat_rules)):
        for path, value in _flatten(tree).items():
            name, layout = _port_name(path, rules)
            if layout == "oihw":
                value = value.transpose(3, 2, 0, 1)
            elif layout == "t":
                value = value.T
            state[name] = torch.tensor(np.ascontiguousarray(value), dtype=torch.float32)
    return state
