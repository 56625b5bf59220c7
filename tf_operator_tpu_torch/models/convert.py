"""Carry a flax BERT param tree across to the port's state_dict.

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


def _port_name(path: str):
    for pattern, name, transpose in _COMPILED:
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
