"""Decoder-only transformer (GPT), the causal-LM family. Counterpart of
tf_operator_tpu/models/gpt.py: its training half and its inline,
KV-cached decode.

Training:  logits = GPT(cfg)(input_ids); loss = causal_lm_loss(logits, input_ids)
Decoding:  tokens = generate(model, prompt, max_new_tokens)

The dtype policy and the parameter names are BERT's (models/bert.py):
f32 parameters, compute in `cfg.dtype`, f32 LayerNorm, logits in the
compute dtype, and the reference's param paths (token_embed,
position_embed, layer_{i}, ln_final, lm_head), so a flax tree converted
by models/convert.py loads by name. The blocks are BERT's
TransformerBlock with causal attention, as in the reference.

The decode path runs the same GPT module's parameters (no second copy
of the weights). Its cache is a `KVCache`, a plain object of
preallocated tensors passed explicitly and written in place, where the
reference returns an updated flax "cache" collection. The loop over
positions of `generate` is a Python loop; the reference's one compiled
lax.scan has no counterpart.

Decode modes: an int8 KV cache (kv_quant_int8: int8 keys and values
with per-(position, head) scales) and int8 weights (weights_int8: the
model's int8 twin, ops/quant.py), which compose with each other and with
every entry point; `beam_search`; and `generate_speculative`, prompt-
lookup speculative decoding through a multi-token verify forward.

Serving (serve/engine.py) runs one step over a fixed slot grid:
`SlotDecodeStep` over a dense [n_slots, max_total] cache and
`PagedSlotDecodeStep` over a pool of fixed-size KV blocks addressed
through per-slot block tables (with its prefill chunk, block copy and,
for speculation, its verify program). Each program holds its inputs in
static buffers and, on a CUDA device, runs as one CUDA graph captured at
its first call, where the reference compiles its step once with jax.jit.

Under a mesh (parallel/sharding.py): the tensor-parallel plan splits the
heads, the MLP, the embeddings and the LM head over tp, and the logits
are this rank's vocab columns (`vocab_shard`); under sp a rank's forward
sees a sequence shard whose positions start at `seq_index` x its length.
`generate(mesh=, rules=)` decodes with the tp-sharded weights (int8
ones quantized whole, then laid out): the KV cache holds the rank's
heads, and each step's logits are gathered over tp before the sampler.

Sharded serving (one process driving a ('batch','model') serving mesh,
parallel/mesh.py make_device_mesh): `ShardedPagedSlotDecodeStep` lays the
paged programs out by SERVE_DECODE_RULES and SERVE_CACHE_RULES, each
model shard's heads and pool on its device, the shards' outputs joined
before every full-width contraction (_sharded_block);
`SlotDecodeStep(mesh=)` is the replicated draft step.
"""

from __future__ import annotations

import dataclasses
import math
import threading
from typing import Any, Callable, Dict, List, Optional, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..ops.attention import dot_product_attention
from ..ops.quant import f32_scalar, quantize_model
from .bert import LayerNorm, TransformerBlock, dense, init_like_flax_

# a decode position: one int for every row, or a [batch] tensor of
# each row's own position
Index = Union[int, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class GPTConfig:
    vocab_size: int = 32000
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 6  # head_dim 128
    intermediate_size: int = 3072
    max_seq_len: int = 2048
    dtype: torch.dtype = torch.bfloat16
    # per-block rematerialization (torch.utils.checkpoint)
    remat: bool = False

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads


GPT_SMALL = GPTConfig()
GPT_TINY = GPTConfig(
    vocab_size=512, hidden_size=128, num_layers=2, num_heads=2,
    intermediate_size=256, max_seq_len=128,
)
# the draft twin of GPT_TINY for speculative decoding: the same vocab and
# position range, half the width and one layer
GPT_DRAFT = GPTConfig(
    vocab_size=512, hidden_size=64, num_layers=1, num_heads=2,
    intermediate_size=128, max_seq_len=128,
)
# the serving and training CLIs' --preset names
GPT_PRESETS = {"tiny": GPT_TINY, "small": GPT_SMALL}


def _causal_attention(query, key, value, mask=None):
    """Training-path default: causal attention through the flash seam
    (the Hopper kernels where `flash_attention` takes the shape)."""
    from ..ops.flash_attention import flash_attention

    return flash_attention(query, key, value, mask=mask, causal=True)


def plain_causal_attention(query, key, value, mask=None):
    """`dot_product_attention` under a causal mask: the plain route, as
    the reference bench's attention="xla" twin builds it
    (benchmarks/model_benches.py:335-345)."""
    positions = torch.arange(query.shape[1], device=query.device)
    causal = (positions[:, None] >= positions[None, :])[None, None]
    return dot_product_attention(
        query, key, value, causal if mask is None else mask.bool() & causal
    )


class GPT(nn.Module):
    """Token + position embedding -> decoder stack -> untied LM head.
    forward is the training forward (whole sequence, causal) and returns
    [batch, seq, vocab] logits in the compute dtype. Parameters are f32
    on `device`, drawn from `generator` as BertForMLM's are."""

    def __init__(
        self,
        cfg: GPTConfig,
        attention_fn: Optional[Callable] = None,
        device: Optional[torch.device] = None,
        generator: Optional[torch.Generator] = None,
    ) -> None:
        super().__init__()
        self.cfg = cfg
        self.token_embed = nn.Embedding(cfg.vocab_size, cfg.hidden_size)
        self.position_embed = nn.Embedding(cfg.max_seq_len, cfg.hidden_size)
        for i in range(cfg.num_layers):
            self.add_module(
                f"layer_{i}", TransformerBlock(cfg, attention_fn or _causal_attention)
            )
        self.ln_final = LayerNorm(cfg.hidden_size)
        self.lm_head = nn.Linear(cfg.hidden_size, cfg.vocab_size)
        # set by parallel/sharding.py: the sequence shard under sp, and
        # the head's vocab split under tp
        self.seq_index = 0
        self.vocab_shard = None
        init_like_flax_(self, generator)
        if device is not None:
            self.to(device)

    def blocks(self) -> List[TransformerBlock]:
        return [getattr(self, f"layer_{i}") for i in range(self.cfg.num_layers)]

    def embed(self, input_ids: torch.Tensor, positions: torch.Tensor) -> torch.Tensor:
        """Token plus position embedding in the compute dtype; positions
        broadcast against input_ids."""
        dtype = self.cfg.dtype
        return self.token_embed(input_ids).to(dtype) + self.position_embed(positions).to(dtype)

    def head(self, x: torch.Tensor) -> torch.Tensor:
        """Final f32 LayerNorm, then the head in the compute dtype (this
        rank's vocab columns under tp)."""
        x = self.ln_final(x)
        if self.vocab_shard is not None:
            from ..parallel.distributed import copy_to_group

            x = copy_to_group(x, self.vocab_shard.group)
        return dense(self.lm_head, x, self.cfg.dtype)

    def forward(self, input_ids: torch.Tensor) -> torch.Tensor:
        """Under sp, input_ids are the rank's sequence shard, whose
        positions start at seq_index x its length."""
        offset = self.seq_index * input_ids.shape[-1]
        positions = offset + torch.arange(input_ids.shape[-1], device=input_ids.device)
        x = self.embed(input_ids, positions[None])
        for block in self.blocks():
            if self.cfg.remat and torch.is_grad_enabled():
                x = checkpoint(block, x, None, use_reentrant=False)
            else:
                x = block(x)
        return self.head(x)


def causal_lm_loss(
    logits: torch.Tensor, input_ids: torch.Tensor,
    weights: Optional[torch.Tensor] = None, vocab=None,
) -> torch.Tensor:
    """Next-token cross-entropy: position t predicts token t+1, through
    the fused loss (ops/losses.py); vocab: the logits' split under tp
    (parallel/sharding.py VocabShard)."""
    from ..ops.losses import weighted_mean_xent

    if weights is not None:
        weights = weights[:, 1:]
    return weighted_mean_xent(logits[:, :-1], input_ids[:, 1:], weights, vocab)


def sharded_lm_loss(
    logits: torch.Tensor, next_ids: torch.Tensor, vocab=None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """causal_lm_loss on a sequence shard under sp: next_ids are the ids
    one past each local position, taken from the full row (positions
    [offset + 1, offset + s_local + 1) clipped to the row, so the last
    shard has one fewer and drops its last position). -> (the mean over
    the shard's positions, their count): the trainer weights the shards
    by their counts, so the loss is the global sum over the global count,
    as the one-process [:, :-1] mean."""
    from ..ops.losses import weighted_mean_xent

    n = next_ids.shape[1]
    count = torch.full((), float(next_ids.numel()), device=logits.device)
    return weighted_mean_xent(logits[:, :n], next_ids, None, vocab), count


SUCCESSOR_SEED = 7
CORRUPT_RATE = 0.1


def successor_table(cfg: GPTConfig) -> torch.Tensor:
    """synthetic_batch's fixed Markov successor of each token."""
    generator = torch.Generator().manual_seed(SUCCESSOR_SEED)
    return torch.randint(0, cfg.vocab_size, (cfg.vocab_size,), generator=generator)


def synthetic_batch(
    generator: torch.Generator, batch_size: int, seq_len: int, cfg: GPTConfig
) -> Dict[str, torch.Tensor]:
    """Learnable synthetic LM data on the CPU, as the reference draws
    it: a Markov walk through `successor_table` from random starts, then
    10% of positions replaced by uniform tokens (where and what drawn
    separately). The draws are torch's, not jax.random's."""
    successor = successor_table(cfg).numpy()
    start = torch.randint(0, cfg.vocab_size, (batch_size,), generator=generator)
    walk = np.empty((batch_size, seq_len), dtype=np.int64)
    walk[:, 0] = start.numpy()
    for t in range(1, seq_len):
        walk[:, t] = successor[walk[:, t - 1]]
    corrupt = torch.rand((batch_size, seq_len), generator=generator) < CORRUPT_RATE
    random_tok = torch.randint(0, cfg.vocab_size, (batch_size, seq_len), generator=generator)
    return {"input_ids": torch.where(corrupt, random_tok, torch.from_numpy(walk))}


# -- KV-cached autoregressive decoding ---------------------------------------


@dataclasses.dataclass
class KVCache:
    """Per layer, keys and values [batch, cache_len, heads, head_dim],
    written in place by the decode path: in the model's compute dtype, or
    under kv_quant_int8 as int8 with one f32 scale per (position, head)
    in key_scales / value_scales [batch, cache_len, heads]. A pool of
    blocks has the same layout with blocks for rows."""

    keys: List[torch.Tensor]
    values: List[torch.Tensor]
    key_scales: Optional[List[torch.Tensor]] = None
    value_scales: Optional[List[torch.Tensor]] = None

    @classmethod
    def zeros(
        cls, cfg: GPTConfig, batch: int, cache_len: int,
        device: Optional[torch.device] = None, kv_quant_int8: bool = False,
        heads: Optional[int] = None,
    ) -> "KVCache":
        """heads: the heads a rank holds (its share under tp); all of
        cfg's by default."""
        shape = (batch, cache_len, heads or cfg.num_heads, cfg.head_dim)

        def layers(shape, dtype):
            return [torch.zeros(shape, dtype=dtype, device=device)
                    for _ in range(cfg.num_layers)]

        if not kv_quant_int8:
            return cls(keys=layers(shape, cfg.dtype), values=layers(shape, cfg.dtype))
        return cls(keys=layers(shape, torch.int8), values=layers(shape, torch.int8),
                   key_scales=layers(shape[:-1], torch.float32),
                   value_scales=layers(shape[:-1], torch.float32))

    @property
    def quantized(self) -> bool:
        return self.key_scales is not None

    def tensors(self) -> List[torch.Tensor]:
        """Every tensor of the cache, the scales included."""
        return self.keys + self.values + (self.key_scales or []) + (self.value_scales or [])

    def layers(self) -> List[Tuple]:
        """Per layer (keys, values, key_scale, value_scale); the scales
        None unless quantized."""
        none = [None] * len(self.keys)
        return list(zip(self.keys, self.values, self.key_scales or none,
                        self.value_scales or none))

    def map(self, fn: Callable[[torch.Tensor], torch.Tensor]) -> "KVCache":
        """A new cache of fn(tensor) for every tensor."""
        scaled = self.quantized
        return KVCache(
            keys=[fn(t) for t in self.keys], values=[fn(t) for t in self.values],
            key_scales=[fn(t) for t in self.key_scales] if scaled else None,
            value_scales=[fn(t) for t in self.value_scales] if scaled else None,
        )


def _absmax_quantize(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric int8 over the last axis, in the reference's op order
    (round(x / s * 127) with s = max(absmax, 1e-8), half to even): (int8
    values, s / 127 of shape x.shape[:-1]). The one quantizer of every
    cache write (dense, paged, prefill, decode, verify), so all of them
    store the same bytes for the same vectors."""
    x32 = x.float()
    s = x32.abs().amax(dim=-1).clamp_min(1e-8)
    q = torch.round(x32 / s[..., None] * 127.0).clamp(-127, 127).to(torch.int8)
    # a tensor divisor: a true division on CUDA too (ops/quant.py f32_scalar)
    return q, s / f32_scalar(127.0, s.device)


def _write(cache: torch.Tensor, new: torch.Tensor, index: Index) -> None:
    if isinstance(index, int):
        cache[:, index:index + new.shape[1]] = new
    else:
        rows = torch.arange(cache.shape[0], device=cache.device)
        cache[rows, index] = new[:, 0]


def _store_kv(
    cache: torch.Tensor, new: torch.Tensor, index: Index,
    scale: Optional[torch.Tensor] = None,
) -> None:
    """The cache write of every dense phase, in place: `new` [b, n, h, d]
    at positions [index, index + n) of every row for an int index, or row
    i's one token at index[i] for a [b] tensor. With `scale` (int8 KV)
    the int8 values go to `cache` and their scales to `scale`."""
    if scale is not None:
        new, new_scale = _absmax_quantize(new)
        _write(scale, new_scale, index)
    _write(cache, new.to(cache.dtype), index)


def _kv_attention(
    query: torch.Tensor, keys: torch.Tensor, key_scale: Optional[torch.Tensor],
    values: torch.Tensor, value_scale: Optional[torch.Tensor], mask: torch.Tensor,
) -> torch.Tensor:
    """Attention over a cache as stored: dot_product_attention when it is
    in the compute dtype; over int8 keys and values, the reference's
    factored form (_cache_attention): the products read the int8 values
    converted to the query's dtype, the key scale multiplies the f32
    scores before the mask, the value scale the softmax weights before
    their cast, so no dequantized copy of the cache is made."""
    if key_scale is None:
        return dot_product_attention(query, keys, values, mask)
    dtype = query.dtype
    scale = torch.full((), 1.0 / math.sqrt(query.shape[-1]), dtype=dtype, device=query.device)
    scores = torch.einsum("bqhd,bkhd->bhqk", query * scale, keys.to(dtype))
    scores = scores.float() * key_scale.permute(0, 2, 1)[:, :, None, :]
    scores = torch.where(mask.bool(), scores, torch.finfo(torch.float32).min)
    weights = torch.softmax(scores, dim=-1)
    weights = (weights * value_scale.permute(0, 2, 1)[:, :, None, :]).to(dtype)
    return torch.einsum("bhqk,bkhd->bqhd", weights, values.to(dtype))


def _cache_attention(kv: Tuple, index: Optional[Index]) -> Callable:
    """The attention_fn a block runs in decode (the reference's
    _CachedBlock is its TransformerBlock with this attention) over one
    layer's (keys, values, key_scale, value_scale): with index None,
    PrefillSelfAttention (the whole prompt's keys and values written at
    [0, p), attending over that slice); else one token per row at
    `index` (CachedSelfAttention), or n tokens at the int offset `index`
    (the speculative verify, PrefillSelfAttention's dynamic-offset
    branch), attending over the whole cache under the caller's mask.
    Writes first, then attends over what was stored, so under int8 every
    phase reads the same quantized cache."""
    keys, values, key_scale, value_scale = kv

    def attend(query, key, value, mask):
        at = 0 if index is None else index
        _store_kv(keys, key, at, key_scale)
        _store_kv(values, value, at, value_scale)
        if index is None:
            p = key.shape[1]
            return _kv_attention(
                query, keys[:, :p], None if key_scale is None else key_scale[:, :p],
                values[:, :p], None if value_scale is None else value_scale[:, :p], mask,
            )
        return _kv_attention(query, keys, key_scale, values, value_scale, mask)

    return attend


def model_device(model: nn.Module) -> torch.device:
    """Where a GPT (or its int8 twin) lives: its token table's device."""
    return model.token_embed.weight.device


def local_heads(model: nn.Module) -> int:
    """The attention heads the model's projections hold: all of them, or
    this rank's under tp."""
    return model.blocks()[0].attention.query.out_shape[0]


def full_logits(model: nn.Module, logits: torch.Tensor) -> torch.Tensor:
    """Logits over the whole vocab: under tp, the ranks' vocab columns
    gathered in rank order (a collective over the tp group)."""
    shard = getattr(model, "vocab_shard", None)
    if shard is None:
        return logits
    from ..parallel.distributed import all_gather

    return all_gather(logits, shard.group, dim=-1)


class GPTDecodeStep:
    """One-token forward over a GPT's own parameters: token [b] at
    `index` (an int for every row, or a [b] tensor of each row's
    position) -> logits [b, vocab], writing that position's keys and
    values into `cache`. The cache's length, not cfg.max_seq_len, sets
    how many positions each step attends over; an int8 cache (see
    KVCache) is written and read as int8. weights_int8: run the model's
    int8 twin (quantized here unless it already is)."""

    def __init__(self, model: GPT, weights_int8: bool = False) -> None:
        self.model = quantize_model(model) if weights_int8 else model

    @torch.no_grad()
    def __call__(self, token: torch.Tensor, index: Index, cache: KVCache) -> torch.Tensor:
        model = self.model
        if isinstance(index, int):
            rows = torch.tensor([[index]], device=token.device)
        else:
            rows = index.reshape(-1, 1)
        x = model.embed(token[:, None], rows)
        positions = torch.arange(cache.keys[0].shape[1], device=token.device)
        valid = (positions[None, :] <= rows)[:, None, None, :]
        for block, kv in zip(model.blocks(), cache.layers()):
            x = block(x, valid, _cache_attention(kv, index))
        return full_logits(model, model.head(x)[:, 0])


class GPTPrefill:
    """Whole-prompt forward over a GPT's own parameters: tokens [b, p] ->
    the last position's logits [b, vocab], writing positions [0, p) of
    `cache`, from which GPTDecodeStep continues. weights_int8 as
    GPTDecodeStep's."""

    def __init__(self, model: GPT, weights_int8: bool = False) -> None:
        self.model = quantize_model(model) if weights_int8 else model

    @torch.no_grad()
    def __call__(self, tokens: torch.Tensor, cache: KVCache) -> torch.Tensor:
        model = self.model
        positions = torch.arange(tokens.shape[1], device=tokens.device)
        x = model.embed(tokens, positions[None])
        causal = (positions[:, None] >= positions[None, :])[None, None]
        for block, kv in zip(model.blocks(), cache.layers()):
            x = block(x, causal, _cache_attention(kv, None))
        return full_logits(model, model.head(x[:, -1:])[:, 0])


class GPTVerifyBlock:
    """The speculative verify forward (the reference's GPTVerifyBlock,
    gpt.py:1812): tokens [b, s] at positions [offset, offset + s) ->
    logits for all s positions [b, s, vocab], writing their keys and
    values into `cache`. Each row attends over the whole cache under the
    causal window offset + j (positions past the model's table clamp to
    its last entry; they sit past the commit limit)."""

    def __init__(self, model: GPT) -> None:
        self.model = model

    @torch.no_grad()
    def __call__(self, tokens: torch.Tensor, offset: int, cache: KVCache) -> torch.Tensor:
        model = self.model
        positions = offset + torch.arange(tokens.shape[1], device=tokens.device)
        x = model.embed(tokens, positions.clamp(max=model.cfg.max_seq_len - 1)[None])
        keys_at = torch.arange(cache.keys[0].shape[1], device=tokens.device)
        mask = (keys_at[None, :] <= positions[:, None])[None, None]
        for block, kv in zip(model.blocks(), cache.layers()):
            x = block(x, mask, _cache_attention(kv, int(offset)))
        return model.head(x)


def _filter_logits(logits: torch.Tensor, top_k: int, top_p: float) -> torch.Tensor:
    """Top-k and nucleus filtering: logits outside the keep set become
    -inf. top_k keeps every logit at or above the k-th largest (ties at
    the k-th all stay); top_p keeps each token whose preceding mass in
    descending order is below top_p, the order being the reverse of a
    stable ascending sort, as the reference's argsort(...)[..., ::-1]."""
    if 0 < top_k < logits.shape[-1]:
        kth = torch.topk(logits, top_k, dim=-1).values[..., -1:]
        logits = logits.masked_fill(logits < kth, float("-inf"))
    if 0.0 < top_p < 1.0:
        order = torch.argsort(logits, dim=-1, stable=True).flip(-1)
        probs = torch.softmax(logits.gather(-1, order), dim=-1)
        keep_sorted = (torch.cumsum(probs, dim=-1) - probs) < top_p
        keep = torch.empty_like(keep_sorted).scatter_(-1, order, keep_sorted)
        logits = logits.masked_fill(~keep, float("-inf"))
    return logits


def _categorical(logits: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
    """One draw per row from softmax(logits): the Gumbel-max draw
    jax.random.categorical makes, here in f32 from `generator`."""
    u = torch.rand(logits.shape, generator=generator, device=logits.device)
    u = u.clamp_min_(torch.finfo(torch.float32).tiny)
    return (logits - torch.log(-torch.log(u))).argmax(dim=-1)


def _sampler(
    temperature: float, top_k: int, top_p: float, generator: torch.Generator,
) -> Callable[[torch.Tensor], torch.Tensor]:
    """logits [b, vocab] -> tokens [b]: argmax at temperature 0, else
    temperature first, then the filters, then a categorical draw."""

    def sample(logits: torch.Tensor) -> torch.Tensor:
        if temperature > 0.0:
            return _categorical(_filter_logits(logits.float() / temperature, top_k, top_p),
                                generator)
        return logits.argmax(dim=-1)

    return sample


def _decode(
    model: GPT, prompt: torch.Tensor, lens: torch.Tensor, total: int,
    sample: Callable[[torch.Tensor], torch.Tensor], ragged: bool, kv_quant_int8: bool = False,
) -> torch.Tensor:
    """Positions 1..total-1 of every row. Uniform path: the whole prompt
    in one GPTPrefill, then one GPTDecodeStep per new token. Ragged path
    (ragged=True): every position through GPTDecodeStep, each row's
    token forced to its own next prompt token while inside its prompt
    (lens), so shorter rows start generating at their own boundary."""
    batch, prompt_len = prompt.shape
    cache = KVCache.zeros(model.cfg, batch, total, prompt.device, kv_quant_int8,
                          heads=local_heads(model))
    step = GPTDecodeStep(model)

    def steps(tok: torch.Tensor, indices) -> List[torch.Tensor]:
        out = []
        for index in indices:
            nxt = sample(step(tok, index, cache))
            forced = prompt[:, min(index + 1, prompt_len - 1)]
            tok = torch.where(index + 1 < lens, forced, nxt)
            out.append(tok)
        return out

    if ragged:
        return torch.stack(steps(prompt[:, 0], range(total - 1)), dim=1)
    first = sample(GPTPrefill(model)(prompt, cache))
    generated = [first] + steps(first, range(prompt_len, total - 1))
    return torch.cat([prompt[:, 1:], torch.stack(generated, dim=1)], dim=1)


def _check_lengths(cfg: GPTConfig, prompt_len: int, max_new_tokens: int) -> int:
    """The reference's length checks -> total positions."""
    total = prompt_len + max_new_tokens
    if max_new_tokens < 1:
        raise ValueError(f"max_new_tokens must be >= 1, got {max_new_tokens}")
    if total > cfg.max_seq_len:
        raise ValueError(f"prompt+new = {total} exceeds max_seq_len {cfg.max_seq_len}")
    return total


def _check_filters(top_k: int, top_p: float) -> None:
    if top_k < 0:
        raise ValueError(f"top_k must be >= 0, got {top_k}")
    if not 0.0 < top_p <= 1.0:
        raise ValueError(f"top_p must be in (0, 1], got {top_p}")


@torch.no_grad()
def generate(
    model: GPT,
    prompt: torch.Tensor,
    max_new_tokens: int,
    temperature: float = 0.0,
    generator: Optional[torch.Generator] = None,
    mesh=None,
    rules=None,
    kv_quant_int8: bool = False,
    weights_int8: bool = False,
    prompt_lens: Optional[torch.Tensor] = None,
    top_k: int = 0,
    top_p: float = 1.0,
) -> torch.Tensor:
    """Greedy (temperature 0) or sampled decode on the model's device.
    prompt: [b, p] ints. Returns [b, p + max_new_tokens]: the prompt,
    then the new tokens.

    prompt_lens ([b] ints): a ragged batch, right-padded to p. Row i
    starts generating after its own prompt_lens[i] tokens and its first
    prompt_lens[i] + max_new_tokens positions are its answer; shorter
    rows generate past that, and callers slice. A batch whose lengths
    are all p takes the uniform (prefill) path, whether or not lengths
    were passed.

    top_k / top_p (temperature > 0 only): filtering before the draw; 0
    and 1.0 disable. generator: the sampling stream, on the model's
    device (default: seeded 0).

    kv_quant_int8: an int8 KV cache with per-(position, head) scales.
    weights_int8: int8 kernels with per-feature-slice scales
    (ops/quant.py), quantized once per call unless `model` already is
    the int8 twin (serving quantizes once at load). The two compose.

    mesh (parallel/mesh.py build_mesh's, every rank calling): decode with
    the weights laid out by `rules` (TRANSFORMER_RULES by default): under
    tp each rank holds its heads' KV cache and its vocab columns, which are
    gathered before the sampler (a model already laid out by the plan, such
    as a tp trainer's, is used as it is; a full one is copied and laid out;
    an FSDP2 trainer's is gathered whole first). The prompt's rows split
    over dp x fsdp and the answers are gathered back, as the reference
    shards the prompt over its batch axes (a batch that does not divide
    them is decoded whole by every rank, as the reference replicates it).
    With weights_int8 the whole model is quantized before it is laid out (a
    laid-out one is gathered first), as the reference quantizes after
    placement: a row-parallel kernel's scales (attn_out, mlp_out split
    their contracted axis) are the whole kernel's, and its partial products
    are summed before the scale."""
    cfg = model.cfg
    batch, prompt_len = prompt.shape
    total = _check_lengths(cfg, prompt_len, max_new_tokens)
    _check_filters(top_k, top_p)
    if mesh is not None:
        return _generate_on_mesh(
            model, prompt, mesh, rules, weights_int8, max_new_tokens=max_new_tokens,
            temperature=temperature, generator=generator, kv_quant_int8=kv_quant_int8,
            prompt_lens=prompt_lens, top_k=top_k, top_p=top_p)
    if top_k >= cfg.vocab_size:
        top_k = 0  # keeps everything
    if weights_int8:
        model = quantize_model(model)
    device = model_device(model)
    prompt = prompt.to(device=device, dtype=torch.long)
    ragged = False
    if prompt_lens is None:
        lens = torch.full((batch,), prompt_len, device=device)
    else:
        lens_host = torch.as_tensor(prompt_lens).cpu()
        if tuple(lens_host.shape) != (batch,):
            raise ValueError(f"prompt_lens shape {tuple(lens_host.shape)} != ({batch},)")
        if (lens_host < 1).any() or (lens_host > prompt_len).any():
            raise ValueError(
                f"prompt_lens must be in [1, {prompt_len}], got {lens_host.tolist()}"
            )
        # the path is chosen by the values: a uniform batch prefills
        ragged = bool((lens_host != prompt_len).any())
        lens = lens_host.to(device)
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(0)
    sample = _sampler(float(temperature), int(top_k), float(top_p), generator)
    generated = _decode(model, prompt, lens, total, sample, ragged, kv_quant_int8)
    return torch.cat([prompt[:, :1], generated], dim=1)


def _generate_on_mesh(model: GPT, prompt: torch.Tensor, mesh, rules, weights_int8: bool,
                      **kwargs) -> torch.Tensor:
    """generate() on this rank's rows of the prompt with the model laid
    out for the mesh, the ranks' answers gathered over the batch group."""
    import copy

    from ..ops.quant import is_quantized
    from ..parallel import mesh as mesh_lib
    from ..parallel import sharding

    rules = rules or sharding.TRANSFORMER_RULES
    tp = mesh.shape["tp"] > 1
    if sharding.is_fully_sharded(model):
        # an FSDP2 trainer's model: gathered whole, then laid out below
        model = _gathered(model)
    if weights_int8 and not is_quantized(model):
        if getattr(model, "tensor_parallel", None) is not None:
            model = _gathered(model)
        else:
            model = copy.deepcopy(model)
        # quantized whole, then laid out: the scales are the whole kernels'
        model = quantize_model(model)
        if tp:
            model = sharding.apply_tensor_parallel(model, mesh, rules)
    elif tp and getattr(model, "tensor_parallel", None) is None:
        model = sharding.apply_tensor_parallel(copy.deepcopy(model), mesh, rules)
    lens = kwargs.pop("prompt_lens")
    if mesh.batch_group is None or prompt.shape[0] % mesh_lib.data_shards(mesh):
        # a batch that does not divide the data axes is replicated, as the
        # reference's: every rank decodes every row
        return generate(model, prompt, prompt_lens=lens, **kwargs)
    rows = mesh_lib.local_rows(mesh, prompt.shape[0])
    out = generate(model, prompt[rows], prompt_lens=None if lens is None else lens[rows],
                   **kwargs)
    from ..parallel.distributed import all_gather

    return all_gather(out, mesh.batch_group, dim=0)


def _gathered(model: GPT) -> GPT:
    """A whole GPT from a tensor-parallel or FSDP2-sharded one: its shards
    all-gathered over FSDP2's group and the plan's (a collective: every
    rank of them calls this)."""
    from ..parallel import sharding

    full = GPT(model.cfg, device=model_device(model))
    full.load_state_dict(sharding.gather_state_dict(model.state_dict(), sharding.layouts(model)))
    return full


# -- speculative decoding (prompt-lookup drafting) ---------------------------


def _ngram_draft(buf: torch.Tensor, index: int, k: int, ngram: int) -> torch.Tensor:
    """Prompt-lookup drafter (the reference's _ngram_draft): the k tokens
    that followed the most recent earlier occurrence of the ngram tokens
    ending at `index`. buf: [b, L] whose positions [0, index] are
    committed -> drafts [b, k]; where no earlier occurrence exists, the
    current token repeated. A continuation may read a few provisional
    positions past `index`; that lowers acceptance, never correctness."""
    b, length = buf.shape
    pos = torch.arange(length, device=buf.device)
    tail = buf[:, index - (ngram - 1):index + 1]
    match = torch.ones((b, length), dtype=torch.bool, device=buf.device)
    for j in range(ngram):
        # the token at p + j; shifted-off positions can never match
        shifted = torch.cat([buf[:, j:], buf.new_full((b, j), -1)], dim=1)
        match &= shifted == tail[:, j:j + 1]
    # the continuation must start at committed positions: p + ngram <= index
    match &= (pos <= index - ngram)[None, :]
    p_star = torch.where(match, pos[None, :], -1).amax(dim=1)
    start = (p_star + ngram).clamp(0, length - k)
    cont = buf.gather(1, start[:, None] + torch.arange(k, device=buf.device)[None, :])
    last = buf[:, index:index + 1].expand(b, k)
    return torch.where((p_star >= 0)[:, None], cont, last)


def _accept_or_resample(
    p: torch.Tensor, d: torch.Tensor, u: torch.Tensor, generator: torch.Generator,
) -> torch.Tensor:
    """One position of deterministic-draft speculative sampling (the
    reference's _accept_or_resample). p: [b, V] target probabilities; d:
    [b] proposed tokens (d < 0: no draft, sample from p); u: [b] uniform
    draws. Accept d with probability p[d]; else sample from p with d
    zeroed and renormalized, so the returned token is distributed exactly
    as p. The draws are `generator`'s."""
    vocab = p.shape[1]
    p_draft = p.gather(1, d.clamp(0, vocab - 1)[:, None])[:, 0]
    no_draft = d < 0
    accept = (u < p_draft) & ~no_draft
    zero_at = torch.where(no_draft, -1, d)
    columns = torch.arange(vocab, device=p.device)[None, :]
    target = torch.where(columns == zero_at[:, None], 0.0, p)
    target = target / target.sum(dim=-1, keepdim=True).clamp_min(1e-9)
    sampled = _categorical(torch.log(target + 1e-30), generator)
    return torch.where(accept, d, sampled)


@torch.no_grad()
def generate_speculative(
    model: GPT,
    prompt: torch.Tensor,
    max_new_tokens: int,
    draft_k: int = 4,
    ngram: int = 2,
    kv_quant_int8: bool = False,
    weights_int8: bool = False,
    temperature: float = 0.0,
    generator: Optional[torch.Generator] = None,
    top_k: int = 0,
    top_p: float = 1.0,
    return_rounds: bool = False,
):
    """Decode with prompt-lookup speculative decoding (the reference's
    generate_speculative): each round an ngram match against the
    committed context proposes draft_k tokens, one (draft_k + 1)-wide
    GPTVerifyBlock scores them, and the longest prefix every row accepts
    (the batch minimum) commits with the verify's own next token. ->
    [b, p + max_new_tokens], and with return_rounds the verify rounds
    run as well.

    Greedy (temperature 0): every committed token is the verify
    forward's argmax given the committed prefix, so the chain equals
    generate(temperature=0)'s up to the floating-point equivalence of
    the block and one-token forwards (exact at f32). temperature > 0:
    speculative sampling (_accept_or_resample), distributed exactly as
    plain sampled decode, from `generator`'s stream (not generate's).
    The round loop is a Python loop that reads each round's commit on
    the host, where the reference runs a lax.while_loop."""
    cfg = model.cfg
    batch, prompt_len = prompt.shape
    total = _check_lengths(cfg, prompt_len, max_new_tokens)
    if draft_k < 1:
        raise ValueError(f"draft_k must be >= 1, got {draft_k}")
    if ngram < 1:
        raise ValueError(f"ngram must be >= 1, got {ngram}")
    if prompt_len < ngram:
        raise ValueError(f"prompt_len {prompt_len} must be >= ngram {ngram}")
    if temperature < 0:
        raise ValueError(f"temperature must be >= 0, got {temperature}")
    _check_filters(top_k, top_p)
    if top_k >= cfg.vocab_size:
        top_k = 0
    if weights_int8:
        model = quantize_model(model)
    device = model_device(model)
    prompt = prompt.to(device=device, dtype=torch.long)
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(0)
    sampled = temperature > 0.0
    # the buffer and the cache reach draft_k past `total`: a round entered
    # at index total - 2 writes its k + 1 candidates up to total + k - 1
    width = total + draft_k
    cache = KVCache.zeros(cfg, batch, width, device, kv_quant_int8)
    logits = GPTPrefill(model)(prompt, cache)

    def tempered(logits: torch.Tensor) -> torch.Tensor:
        return _filter_logits(logits.float() / temperature, top_k, top_p)

    first = _categorical(tempered(logits), generator) if sampled else logits.argmax(-1)
    buf = torch.zeros((batch, width), dtype=torch.long, device=device)
    buf[:, :prompt_len] = prompt
    buf[:, prompt_len] = first
    verify = GPTVerifyBlock(model)
    columns = torch.arange(draft_k + 1, device=device)[None, :]
    index, rounds = prompt_len, 0
    while index < total - 1:
        drafts = _ngram_draft(buf, index, draft_k, ngram)
        block = torch.cat([buf[:, index:index + 1], drafts], dim=1)
        logits = verify(block, index, cache)
        if not sampled:
            greedy = logits.argmax(dim=-1)
            ok = (greedy[:, :draft_k] == drafts).long()
            commit = int(torch.cumprod(ok, dim=1).sum(dim=1).min())
            buf[:, index + 1:index + draft_k + 2] = greedy
        else:
            probs = torch.softmax(tempered(logits), dim=-1)  # [b, k+1, V]
            u = torch.rand((batch, draft_k), generator=generator, device=device)
            p_draft = probs[:, :draft_k].gather(2, drafts[..., None])[..., 0]
            commit = int(torch.cumprod((u < p_draft).long(), dim=1).sum(dim=1).min())
            d_pad = torch.cat([drafts, drafts.new_full((batch, 1), -1)], dim=1)
            u_pad = torch.cat([u, u.new_ones((batch, 1))], dim=1)
            tok = _accept_or_resample(probs[:, commit], d_pad[:, commit], u_pad[:, commit],
                                      generator)
            cand = torch.where(columns == commit, tok[:, None], d_pad).clamp_min(0)
            buf[:, index + 1:index + draft_k + 2] = cand
        index += commit + 1
        rounds += 1
    out = buf[:, :total]
    return (out, rounds) if return_rounds else out


# -- beam search --------------------------------------------------------------


def _top_k(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """jax.lax.top_k's order along the last axis: descending, ties to the
    lower index (a stable descending sort)."""
    values, order = torch.sort(x, dim=-1, descending=True, stable=True)
    return values[..., :k], order[..., :k]


@torch.no_grad()
def beam_search(
    model: GPT,
    prompt: torch.Tensor,
    max_new_tokens: int,
    num_beams: int = 4,
    kv_quant_int8: bool = False,
    weights_int8: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Beam-search decode (the reference's beam_search): -> (sequences
    [b, num_beams, p + new], scores [b, num_beams]) best first, a score
    being the sum of the generated tokens' log-probabilities (fixed
    length, no normalization). The prompt is prefilled once at batch
    width and its cache repeated num_beams-fold; beams then ride the
    batch axis through GPTDecodeStep, and each step gathers every cache
    tensor by the surviving beams' parents (an index_select of fixed
    shape). num_beams=1 is greedy decode. Both int8 flags compose."""
    cfg = model.cfg
    batch, prompt_len = prompt.shape
    total = _check_lengths(cfg, prompt_len, max_new_tokens)
    if num_beams < 1:
        raise ValueError(f"num_beams must be >= 1, got {num_beams}")
    if num_beams > cfg.vocab_size:
        raise ValueError(f"num_beams {num_beams} exceeds vocab {cfg.vocab_size}")
    if weights_int8:
        model = quantize_model(model)
    beams = int(num_beams)
    device = model_device(model)
    prompt = prompt.to(device=device, dtype=torch.long)
    cache = KVCache.zeros(cfg, batch, total, device, kv_quant_int8, heads=local_heads(model))
    logits = GPTPrefill(model)(prompt, cache)
    cache = cache.map(lambda t: t.repeat_interleave(beams, dim=0))
    scores, last = _top_k(torch.log_softmax(logits.float(), dim=-1), beams)
    buf = torch.zeros((batch, beams, total), dtype=torch.long, device=device)
    buf[:, :, :prompt_len] = prompt[:, None, :]
    buf[:, :, prompt_len] = last
    step = GPTDecodeStep(model)
    base = torch.arange(batch, device=device)[:, None] * beams
    for index in range(prompt_len, total - 1):
        logits = step(last.reshape(batch * beams), index, cache)
        logp = torch.log_softmax(logits.float(), dim=-1).reshape(batch, beams, -1)
        vocab = logp.shape[-1]
        candidates = (scores[:, :, None] + logp).reshape(batch, beams * vocab)
        scores, idx = _top_k(candidates, beams)
        parent, last = idx // vocab, idx % vocab
        buf = buf.gather(1, parent[:, :, None].expand(-1, -1, total))
        buf[:, :, index + 1] = last
        flat_parent = (base + parent).reshape(batch * beams)
        for t in cache.tensors():
            t.copy_(t.index_select(0, flat_parent))
    return buf, scores


# -- the slot grid of the continuous-batching engine (serve/engine.py) ------


def _mesh_shards(cfg: GPTConfig, mesh, n_slots: int, weights_int8: bool) -> Tuple[int, int]:
    """The sharded decode step's checks of its mesh, in the reference's
    words (gpt.py:1545-1567) -> (batch shards, model shards)."""
    if "batch" not in mesh.shape or "model" not in mesh.shape:
        raise ValueError(
            f"the sharded decode step needs a ('batch','model') mesh, got axes "
            f"{tuple(mesh.shape)}")
    if weights_int8:
        raise ValueError(
            "weights_int8 is not supported on the sharded decode step (the int8 "
            "kernel/scale layout has no 'model'-axis rules yet)"
        )
    batch, model = int(mesh.shape["batch"]), int(mesh.shape["model"])
    if cfg.num_heads % model:
        raise ValueError(
            f"num_heads {cfg.num_heads} must divide over {model} 'model' shards (the KV pool "
            "and qkv projections split on heads)")
    if n_slots % batch:
        raise ValueError(f"n_slots {n_slots} must divide over {batch} 'batch' shards")
    return batch, model


def _kv_bytes(cache: KVCache) -> int:
    return sum(t.numel() * t.element_size() for t in cache.tensors())


def weight_bytes(model: nn.Module) -> int:
    """Bytes of every parameter and buffer a decode reads (the int8
    twin's kernels, scales and biases; the embeddings and norms)."""
    tensors = {id(t): t for t in list(model.parameters()) + list(model.buffers())}
    return sum(t.numel() * t.element_size() for t in tensors.values())


def _forced(
    logits: torch.Tensor, index: torch.Tensor, prompt: torch.Tensor, lens: torch.Tensor,
) -> torch.Tensor:
    """The ragged forcing rule of the slot grid (the reference's
    SlotDecodeStep, gpt.py:910-916): a row still inside its prompt
    (index + 1 < lens) emits its next prompt token, any other row the
    argmax of its logits. logits [n, vocab] with index [n], or [n, k1,
    vocab] with index [n, k1] (a verify window, row j at index + j)."""
    nxt = logits.argmax(dim=-1)
    ahead = (index + 1).clamp(max=prompt.shape[1] - 1)
    if ahead.dim() == 1:
        forced = prompt.gather(1, ahead[:, None])[:, 0]
    else:
        forced = prompt.gather(1, ahead)
        lens = lens[:, None]
    return torch.where(index + 1 < lens, forced, nxt)


# One CUDA graph capture at a time in the process: torch.cuda.graph shares
# one side stream between captures and CUDA allows one capture per stream.
# The serving fleet builds engines (and captures their programs) on
# warm-up threads while other engines in the process replay theirs.
_CAPTURE_LOCK = threading.Lock()


class _Program:
    """One decode program over static input buffers: the port's
    counterpart of a program the reference compiles once with jax.jit.

    The body reads `inputs`; a call copies the caller's values into them
    in place, so their addresses never move. On a CUDA device the first
    call runs the body once on a side stream (warm-up) and then captures
    it as a CUDA graph, as the trainer's _CapturedStep does, and every
    call replays that graph; `output` is what the body returned, the
    graph's own output tensors, overwritten by the next replay. Elsewhere every call runs the body.
    `captures` counts the captures on CUDA and the first call elsewhere:
    the one-compile count. `run_eager` runs the body outside the graph,
    the same work launched op by op.

    The warm-up and capture hold `_CAPTURE_LOCK`, and the capture runs in
    "thread_local" mode: an unsafe call (an allocation, a synchronizing
    copy) from another thread, such as another engine replaying its
    graphs and reading its tokens back, neither fails nor invalidates it.
    The body itself makes no such call, so the capture still raises on one
    of its own."""

    def __init__(self, body: Callable[[], Any], inputs: Dict[str, torch.Tensor]) -> None:
        self.body = body
        self.inputs = inputs
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.output: Any = None
        self.captures = 0

    def _load(self, values) -> None:
        for name, value in values.items():
            self.inputs[name].copy_(torch.as_tensor(value))

    def __call__(self, **values) -> Any:
        self._load(values)
        device = next(iter(self.inputs.values())).device
        if device.type != "cuda":
            self.captures = 1
            return self.body()
        if self.graph is None:
            with _CAPTURE_LOCK:
                current = torch.cuda.current_stream(device)
                side = torch.cuda.Stream(device)
                side.wait_stream(current)
                with torch.cuda.stream(side):
                    self.body()
                current.wait_stream(side)
                graph = torch.cuda.CUDAGraph()
                with torch.cuda.graph(graph, capture_error_mode="thread_local"):
                    self.output = self.body()
                self.graph = graph
                self.captures += 1
        self.graph.replay()
        return self.output

    def run_eager(self, **values) -> Any:
        self._load(values)
        return self.body()


def _slot_inputs(n_slots: int, max_total: int, device) -> Dict[str, torch.Tensor]:
    """The static buffers of a slot step: tok, index and lens [n_slots],
    prompt [n_slots, max_total] (right-padded)."""
    def zeros(*shape):
        return torch.zeros(shape, dtype=torch.long, device=device)

    return {"tok": zeros(n_slots), "index": zeros(n_slots),
            "prompt": zeros(n_slots, max_total), "lens": zeros(n_slots)}


class SlotDecodeStep:
    """One single-token decode over a fixed [n_slots] grid of a dense
    cache, [n_slots, max_total] per layer: the device half of the
    engine's kv_layout="dense" (the reference's SlotDecodeStep,
    gpt.py:846), and the draft model's step under speculate="draft".
    Every row is its own stream at its own position: row i writes its
    keys and values at index[i] of its cache row and attends over
    positions <= index[i] (GPTDecodeStep's per-row path). Prompt
    ingestion rides the same step through the forcing rule (`_forced`),
    so there is no prefill program. Greedy only; sampled requests keep
    the inline `generate`.

    kv_quant_int8: the cache is int8 with its scales; weights_int8: the
    step runs the model's int8 twin (quantized here unless `model`
    already is one; `self.model` is what the step reads).

    mesh (a serving mesh, parallel/mesh.py ServeMesh): the step is
    replicated over it, as the reference's (gpt.py:921-935), the draft
    model's step when a sharded engine speculates with a draft. One
    process computes a replicated step once: on the mesh's first device,
    where the model must live.

    The cache is allocated once, at construction, and the step is one
    `_Program`: on a CUDA device one CUDA graph, captured at the first
    call. `compiles` counts captures (first calls off CUDA). `logits`
    [n_slots, vocab] are the last call's, an output of the same program
    (on a CUDA device the graph's own tensor, overwritten by the next
    replay)."""

    def __init__(
        self, model: GPT, n_slots: int, max_total: int,
        kv_quant_int8: bool = False, weights_int8: bool = False, mesh=None,
    ) -> None:
        cfg = model.cfg
        if max_total > cfg.max_seq_len:
            raise ValueError(f"max_total {max_total} exceeds max_seq_len {cfg.max_seq_len}")
        self.model = quantize_model(model) if weights_int8 else model
        self.cfg = cfg
        self.n_slots = int(n_slots)
        self.max_total = int(max_total)
        self.mesh = mesh
        device = model_device(self.model)
        if mesh is not None and device != mesh.devices[0][0]:
            raise ValueError(f"the replicated step runs on the mesh's first device "
                             f"{mesh.devices[0][0]}; the model is on {device}")
        self.cache = KVCache.zeros(cfg, self.n_slots, self.max_total, device, kv_quant_int8)
        self.kv_bytes_total = _kv_bytes(self.cache)
        decode = GPTDecodeStep(self.model)
        inputs = _slot_inputs(self.n_slots, self.max_total, device)

        def step() -> Tuple[torch.Tensor, torch.Tensor]:
            logits = decode(inputs["tok"], inputs["index"], self.cache)
            return _forced(logits, inputs["index"], inputs["prompt"], inputs["lens"]), logits

        self._step = _Program(step, inputs)
        self.logits: Optional[torch.Tensor] = None

    @property
    def compiles(self) -> int:
        return self._step.captures

    def init_cache(self) -> KVCache:
        """The grid's cache, zeroed in place (a captured step keeps
        reading and writing the same tensors)."""
        for t in self.cache.tensors():
            t.zero_()
        return self.cache

    def __call__(self, tok, index, prompt, lens) -> torch.Tensor:
        """One step for every slot. tok, index, lens: [n_slots] ints;
        prompt: [n_slots, max_total] (right-padded). -> next_tok
        [n_slots] on the device: row i's token at position index[i] + 1
        (forced inside the prompt, greedy after). Overwritten by the next
        call on a CUDA device."""
        nxt, self.logits = self._step(tok=tok, index=index, prompt=prompt, lens=lens)
        return nxt


def _paged_store_kv(
    pool: torch.Tensor, new: torch.Tensor, phys: torch.Tensor, off: torch.Tensor,
    scale: Optional[torch.Tensor] = None,
) -> None:
    """The paged cache write of every phase, in place (the reference's
    _paged_store_kv, gpt.py:969): `new` [n, heads, head_dim] into the
    pool [num_blocks, block_size, heads, head_dim] at the (block, offset)
    pairs (phys, off), through the dense path's quantizer under int8
    (`scale` the [num_blocks, block_size, heads] scale pool), so the two
    layouts hold the same bytes for the same vectors. Rows parked on the
    sentinel block 0 write there with duplicate indices; which write
    lands is unspecified, and every reader masks those positions."""
    if scale is not None:
        new, new_scale = _absmax_quantize(new)
        scale.index_put_((phys, off), new_scale)
    pool.index_put_((phys, off), new.to(pool.dtype))


def _gather_blocks(pool: torch.Tensor, tables: torch.Tensor) -> torch.Tensor:
    """pool[tables] as each table's logical sequence: [..., max_blocks *
    block_size, *pool.shape[2:]] in logical-position order."""
    out = pool[tables]
    return out.reshape(*tables.shape[:-1], -1, *pool.shape[2:])


def _paged_kv(kv: Tuple, key, value, phys, off, query, tables, mask,
              replicas: Tuple = ()) -> torch.Tensor:
    """Write key/value [n, h, d] at (phys, off), then attend `query` over
    the pool gathered through `tables` ([rows, max_blocks]). replicas:
    other pools of the same layer and heads (a sharded step's copies of
    one 'model' shard on other devices), written alike."""
    for target in (kv, *replicas):
        keys, values, key_scale, value_scale = target
        dev = keys.device
        phys_at, off_at = phys.to(dev), off.to(dev)
        _paged_store_kv(keys, key.to(dev), phys_at, off_at, key_scale)
        _paged_store_kv(values, value.to(dev), phys_at, off_at, value_scale)
    keys, values, key_scale, value_scale = kv

    def gather(t):
        return None if t is None else _gather_blocks(t, tables)

    return _kv_attention(query, gather(keys), gather(key_scale), gather(values),
                         gather(value_scale), mask)


def _paged_attention(kv: Tuple, index: torch.Tensor, tables: torch.Tensor,
                     replicas: Tuple = ()) -> Callable:
    """PagedSelfAttention (the reference's gpt.py:1032), as the
    attention_fn of a decoder block: each slot's one token [s, 1, h, d]
    written at logical position index[s] through its block table, then
    attention over the gathered pool[tables] under the caller's mask.
    With max_blocks * block_size equal to the dense grid's max_total the
    einsums see the dense step's shapes, position for position."""

    def attend(query, key, value, mask):
        bs = kv[0].shape[1]
        phys = tables.gather(1, (index // bs)[:, None])[:, 0]
        return _paged_kv(kv, key[:, 0], value[:, 0], phys, index % bs, query, tables, mask,
                         replicas)

    return attend


def _paged_prefill_attention(kv: Tuple, positions: torch.Tensor, table: torch.Tensor,
                             replicas: Tuple = ()) -> Callable:
    """PagedPrefillSelfAttention (the reference's gpt.py:1108), as an
    attention_fn: one slot's chunk [1, c, h, d] at logical `positions`
    [c] written through its table [max_blocks] first, then attention over
    the gathered pool[table], so the chunk's queries read the bytes a
    later decode step reads."""

    def attend(query, key, value, mask):
        bs = kv[0].shape[1]
        return _paged_kv(kv, key[0], value[0], table[positions // bs], positions % bs,
                         query, table[None], mask, replicas)

    return attend


def _paged_verify_attention(kv: Tuple, index: torch.Tensor, tables: torch.Tensor,
                            replicas: Tuple = ()) -> Callable:
    """PagedVerifySelfAttention (the reference's gpt.py:1178), as an
    attention_fn: every slot's window [s, k1, h, d] at logical positions
    index[s] + j, written through its table first, then attention over
    the gathered pool under the caller's per-row causal mask. A position
    past the table's length goes to the sentinel block 0 explicitly,
    never clamped into the table's last entry, which can be a real block
    holding committed keys and values; positions past the slot's
    reservation land on the table's sentinel tail entries."""

    def attend(query, key, value, mask):
        slots, k1 = key.shape[:2]
        bs = kv[0].shape[1]
        max_blocks = tables.shape[1]
        pos = index[:, None] + torch.arange(k1, device=index.device)[None, :]
        phys = tables.gather(1, (pos // bs).clamp(max=max_blocks - 1))
        phys = torch.where(pos <= max_blocks * bs - 1, phys, torch.zeros_like(phys))
        flat = slots * k1
        return _paged_kv(kv, key.reshape(flat, *key.shape[2:]),
                         value.reshape(flat, *value.shape[2:]), phys.reshape(flat),
                         (pos % bs).reshape(flat), query, tables, mask, replicas)

    return attend


class _MeshLayout:
    """A GPT laid out over a serving mesh (parallel/mesh.py ServeMesh) by
    SERVE_DECODE_RULES and SERVE_CACHE_RULES (parallel/sharding.py), for
    the one process that drives every shard. On device devices[b][m]:
    model shard m's query/key/value kernels and biases (its heads) and
    mlp_in rows; on each row's first device devices[b][0], the whole
    model for what stays whole (embeddings, layer norms, attn_out,
    mlp_out, LM head). Each model shard's KV pool [num_blocks,
    block_size, heads / m, head_dim] (and its scale pools) lives once on
    every distinct device of its column: a write reaches each copy, a
    read takes the local one.

    Where a shard's device is the model's own, its tensors are views of
    the model's parameters (a weight swap copied into the model in place
    reaches them); elsewhere they are copies, which `refresh` rewrites.
    With several shards on one device nothing is copied at all."""

    def __init__(self, model: GPT, mesh, num_blocks: int, block_size: int,
                 kv_quant_int8: bool) -> None:
        from ..parallel import sharding

        cfg = model.cfg
        self.mesh = mesh
        self.batch, self.model_shards = mesh.shape["batch"], mesh.shape["model"]
        self.devices = mesh.devices
        self.model = model
        self._whole: Dict[torch.device, GPT] = {}
        self._params: Dict[Tuple, Dict[str, torch.Tensor]] = {}
        self.pools: Dict[Tuple, KVCache] = {}
        params = dict(model.named_parameters())
        planned = [name for name in params
                   if sharding.tp_rule(name, sharding.SERVE_DECODE_RULES.tp) is not None]
        heads = cfg.num_heads // self.model_shards
        for row in self.devices:
            if row[0] not in self._whole:
                self._whole[row[0]] = (model if row[0] == model_device(model)
                                       else _copy_to(model, row[0]))
            for m, dev in enumerate(row):
                if (dev, m) in self._params:
                    continue
                shard = sharding.model_shard({n: params[n] for n in planned},
                                             sharding.SERVE_DECODE_RULES, m, self.model_shards)
                self._params[(dev, m)] = {n: t.detach().to(dev) for n, t in shard.items()}
                self.pools[(dev, m)] = KVCache.zeros(cfg, num_blocks, block_size, dev,
                                                     kv_quant_int8, heads=heads)
        self.device = self.devices[0][0]

    def whole(self, b: int) -> GPT:
        return self._whole[self.devices[b][0]]

    def column(self, m: int) -> List[KVCache]:
        """Model shard m's pools, one a distinct device of its column."""
        return [pool for (dev, shard), pool in self.pools.items() if shard == m]

    def shards(self, b: int, i: int) -> List[Tuple[torch.device, Dict[str, torch.Tensor]]]:
        """Layer i's (device, tensors) of every model shard of row b: the
        tensors named as in the layer (attention.query.kernel, ...)."""
        prefix = f"layer_{i}."
        out = []
        for m, dev in enumerate(self.devices[b]):
            params = self._params[(dev, m)]
            out.append((dev, {n[len(prefix):]: t for n, t in params.items()
                              if n.startswith(prefix)}))
        return out

    def layer_pools(self, b: int, m: int, i: int) -> Tuple[Tuple, Tuple]:
        """Layer i's pool tensors of model shard m as row b reads them,
        and the column's other copies, which its writes also reach."""
        local = self.pools[(self.devices[b][m], m)]
        others = tuple(pool.layers()[i] for pool in self.column(m) if pool is not local)
        return local.layers()[i], others

    def caches(self) -> List[KVCache]:
        return list(self.pools.values())

    @torch.no_grad()
    def refresh(self) -> None:
        """Copy the model's current weights into the copies on other
        devices (a weight swap lays the new version out again)."""
        state = self.model.state_dict()
        for whole in self._whole.values():
            if whole is not self.model:
                for name, t in whole.state_dict().items():
                    t.copy_(state[name])
        params = dict(self.model.named_parameters())
        from ..parallel import sharding

        for (dev, m), tensors in self._params.items():
            full = sharding.model_shard({n: params[n] for n in tensors},
                                        sharding.SERVE_DECODE_RULES, m, self.model_shards)
            for name, t in tensors.items():
                if t.data_ptr() != full[name].data_ptr():
                    t.copy_(full[name])


def _copy_to(model: GPT, device: torch.device) -> GPT:
    import copy

    return copy.deepcopy(model).to(device)


def _shard_projection(params: Dict[str, torch.Tensor], name: str, x: torch.Tensor,
                      dtype: torch.dtype) -> torch.Tensor:
    """One model shard's query, key or value: DenseGeneral's product over
    the shard's heads ([..., hidden] -> [..., heads / m, head_dim])."""
    kernel, bias = params[f"attention.{name}.kernel"], params[f"attention.{name}.bias"]
    hidden, heads, head_dim = kernel.shape
    lead = x.shape[:-1]
    y = x.to(dtype).reshape(*lead, hidden) @ kernel.to(dtype).reshape(hidden, heads * head_dim)
    y = y + bias.to(dtype).reshape(heads * head_dim)
    return y.reshape(*lead, heads, head_dim)


def _sharded_block(block, shards, x: torch.Tensor, attend: Callable) -> torch.Tensor:
    """A TransformerBlock over 'model' shards (the reference's _PagedBlock
    under a mesh): each shard's heads project and attend on its device
    (attend(m, query, key, value) -> [..., heads / m, head_dim]), and each
    shard's mlp_in outputs pass the gelu there. The shards' outputs are
    then joined in shard order on x's device, the explicit all-gather of
    the reference's _gather_model_axis, before attn_out and mlp_out run at
    full width: never a partial contraction summed afterwards, which
    would reorder the floating-point reduction."""
    dtype = block.cfg.dtype
    y = block.ln_attn(x).to(dtype)
    heads = []
    for m, (dev, params) in enumerate(shards):
        part = y.to(dev)
        query, key, value = (_shard_projection(params, name, part, dtype)
                             for name in ("query", "key", "value"))
        heads.append(attend(m, query, key, value).to(x.device))
    x = x + block.attention.attn_out(torch.cat(heads, dim=-2))
    y = block.ln_mlp(x)
    hidden = []
    for dev, params in shards:
        h = F.linear(y.to(dev).to(dtype), params["mlp_in.weight"].to(dtype))
        h = F.gelu(h + params["mlp_in.bias"].to(dtype), approximate="tanh")
        hidden.append(h.to(x.device))
    return x + dense(block.mlp_out, torch.cat(hidden, dim=-1), dtype)


def _run_blocks(model: GPT, x: torch.Tensor, mask: torch.Tensor, pool: Optional[KVCache],
                attention: Callable, layout: Optional[_MeshLayout] = None,
                b: int = 0) -> torch.Tensor:
    """x through every decoder block of a paged program. attention(kv[,
    replicas]) is the attention_fn over one layer's pool tensors `kv`
    (writing `replicas` too). Without a layout: the model's own blocks
    over `pool`. With one: row shard b's sharded blocks, each model
    shard attending over its own pool on its device."""
    if layout is None:
        for block, kv in zip(model.blocks(), pool.layers()):
            x = block(x, mask, attention(kv))
        return x
    for i, block in enumerate(model.blocks()):
        def attend(m, query, key, value, i=i):
            kv, replicas = layout.layer_pools(b, m, i)
            return attention(kv, replicas)(query, key, value, mask.to(query.device))

        x = _sharded_block(block, layout.shards(b, i), x, attend)
    return x


def _over_row_shards(layout: _MeshLayout, fn: Callable, *rows: torch.Tensor) -> torch.Tensor:
    """fn(model, *its rows, b=b) for each batch shard b of the slot rows,
    on the row's first device with its whole model; the outputs joined
    in row order on the mesh's first device."""
    per = rows[0].shape[0] // layout.batch
    out = []
    for b in range(layout.batch):
        model = layout.whole(b)
        dev = model_device(model)
        part = [t[b * per:(b + 1) * per].to(dev) for t in rows]
        out.append(fn(model, *part, b=b).to(layout.device))
    return torch.cat(out)


class PagedDecodeStep:
    """One-token forward over the paged pool with a GPT's own parameters
    (the reference's PagedDecodeStep, gpt.py:1325): token [s] at
    index [s] through tables [s, max_blocks] -> logits [s, vocab].
    With a layout (_MeshLayout) the slot rows split over its batch
    shards and each block over its model shards; `pool` is then unused."""

    def __init__(self, model: GPT, layout: Optional[_MeshLayout] = None) -> None:
        self.model = model
        self.layout = layout

    @torch.no_grad()
    def __call__(
        self, token: torch.Tensor, index: torch.Tensor, tables: torch.Tensor,
        pool: Optional[KVCache],
    ) -> torch.Tensor:
        if self.layout is None:
            return self._rows(self.model, token, index, tables, pool=pool)
        return _over_row_shards(self.layout, self._rows, token, index, tables)

    def _rows(self, model, token, index, tables, pool=None, b=0) -> torch.Tensor:
        x = model.embed(token[:, None], index[:, None])
        length = tables.shape[1] * _block_size(pool, self.layout)
        positions = torch.arange(length, device=token.device)
        valid = (positions[None, :] <= index[:, None])[:, None, None, :]
        x = _run_blocks(model, x, valid, pool,
                        lambda kv, *reps: _paged_attention(kv, index.to(kv[0].device),
                                                           tables.to(kv[0].device), *reps),
                        self.layout, b)
        return model.head(x)[:, 0]


def _block_size(pool: Optional[KVCache], layout: Optional[_MeshLayout]) -> int:
    if pool is not None:
        return pool.keys[0].shape[1]
    return next(iter(layout.pools.values())).keys[0].shape[1]


class PagedPrefillChunk:
    """One prefill chunk for one slot (the reference's PagedPrefillChunk,
    gpt.py:1363): tokens [1, c] at logical positions [start, start + c)
    through table [max_blocks], writing every layer's keys and values.
    No ln_final or lm_head: a chunk never emits a token (the prompt's
    last token rides a decode step). -> the last block's output. With a
    layout the chunk runs once, on its first batch row (a chunk is one
    slot, replicated over 'batch' in the reference), over every model
    shard, writing each shard's pool copies."""

    def __init__(self, model: GPT, layout: Optional[_MeshLayout] = None) -> None:
        self.model = model
        self.layout = layout

    @torch.no_grad()
    def __call__(
        self, tokens: torch.Tensor, start: torch.Tensor, table: torch.Tensor,
        pool: Optional[KVCache],
    ) -> torch.Tensor:
        model = self.model if self.layout is None else self.layout.whole(0)
        positions = start + torch.arange(tokens.shape[1], device=tokens.device)
        x = model.embed(tokens, positions[None])
        length = table.shape[0] * _block_size(pool, self.layout)
        keys_at = torch.arange(length, device=tokens.device)
        mask = (keys_at[None, :] <= positions[:, None])[None, None]
        return _run_blocks(
            model, x, mask, pool,
            lambda kv, *reps: _paged_prefill_attention(kv, positions.to(kv[0].device),
                                                       table.to(kv[0].device), *reps),
            self.layout)


class PagedVerifyStep:
    """The speculative verify forward over the paged pool (the
    reference's PagedVerifyStep, gpt.py:1401): tokens [s, k1] at logical
    positions index[s] + j through tables [s, max_blocks] -> logits [s,
    k1, vocab] for every slot in one call, row (i, j) attending over
    positions <= index[i] + j. Row 0 is the single-token step's dataflow;
    the embeddings of positions past the model's table clamp to its last
    entry (those rows sit past the slot's commit limit)."""

    def __init__(self, model: GPT, layout: Optional[_MeshLayout] = None) -> None:
        self.model = model
        self.layout = layout

    @torch.no_grad()
    def __call__(
        self, tokens: torch.Tensor, index: torch.Tensor, tables: torch.Tensor,
        pool: Optional[KVCache],
    ) -> torch.Tensor:
        if self.layout is None:
            return self._rows(self.model, tokens, index, tables, pool=pool)
        return _over_row_shards(self.layout, self._rows, tokens, index, tables)

    def _rows(self, model, tokens, index, tables, pool=None, b=0) -> torch.Tensor:
        pos = index[:, None] + torch.arange(tokens.shape[1], device=tokens.device)[None, :]
        x = model.embed(tokens, pos.clamp(max=model.cfg.max_seq_len - 1))
        length = tables.shape[1] * _block_size(pool, self.layout)
        keys_at = torch.arange(length, device=tokens.device)
        valid = (keys_at[None, None, :] <= pos[:, :, None])[:, None]
        # looked up at each call: a test plants its own verify attention
        x = _run_blocks(model, x, valid, pool,
                        lambda kv, *reps: _paged_verify_attention(
                            kv, index.to(kv[0].device), tables.to(kv[0].device), *reps),
                        self.layout, b)
        return model.head(x)


class PagedSlotDecodeStep:
    """One single-token decode over a fixed [n_slots] grid whose keys
    and values live in a shared pool of fixed-size blocks, [num_blocks,
    block_size, heads, head_dim] per layer and per k/v (with the
    [num_blocks, block_size, heads] scale pools under int8), the
    reference's PagedSlotDecodeStep (gpt.py:1449): the device half of
    the engine's kv_layout="paged". Block 0 is the sentinel: idle rows
    and unused table entries point at it. kv_quant_int8 and weights_int8
    as SlotDecodeStep's.

    mesh (a ('batch','model') serving mesh, parallel/mesh.py
    make_device_mesh; ShardedPagedSlotDecodeStep requires one): every
    program runs over it, laid out by SERVE_DECODE_RULES and
    SERVE_CACHE_RULES (_MeshLayout): slot rows split on 'batch', heads
    and the MLP's hidden units on 'model', each model shard holding its
    heads' pool (`kv_bytes_per_shard` = `kv_bytes_total` / model
    shards); the shards' outputs are joined before every full-width
    contraction (_sharded_block). The checks and their messages are the
    reference's: the axes, weights_int8 (refused), heads % model, n_slots
    % batch. One process drives every shard, so each program stays one
    `_Program` (one CUDA graph on a card) whatever the mesh; the prefill
    chunk, the block copy and the verify run over the same layout, so
    the pool never moves between programs.

    Up to four programs, each a `_Program` (on a CUDA device one CUDA
    graph, captured at its first call) with its own counter:
    - `__call__`: SlotDecodeStep's contract plus `tables` [n_slots,
      max_blocks] (`compiles`);
    - `prefill`: one chunked-prefill chunk for one slot, always the width
      of the first chunk it was given (`prefill_compiles`);
    - `copy_block`: one block copied into another in every layer's k and
      v and their scales, the prefix cache's copy-on-write
      (`copy_compiles`);
    - `verify` (spec_depth > 0): the speculative scorer of every slot's
      window of fixed width spec_depth + 1 (`verify_compiles`).

    `logits` are the last step's, as SlotDecodeStep's (`verify_logits`
    the last verify's). max_total must divide into blocks: the gathered
    attention width max_blocks * block_size then equals the dense
    grid's, and the paged and dense steps run the same einsum shapes."""

    def __init__(
        self, model: GPT, n_slots: int, max_total: int, block_size: int, num_blocks: int,
        kv_quant_int8: bool = False, weights_int8: bool = False, mesh=None,
        spec_depth: int = 0,
    ) -> None:
        cfg = model.cfg
        if max_total > cfg.max_seq_len:
            raise ValueError(f"max_total {max_total} exceeds max_seq_len {cfg.max_seq_len}")
        if block_size < 1:
            raise ValueError(f"block_size must be >= 1, got {block_size}")
        if max_total % block_size:
            raise ValueError(
                f"max_total {max_total} must be a multiple of block_size {block_size} "
                "(the gathered attention width must equal the dense grid's)"
            )
        if num_blocks < 2:
            raise ValueError(f"num_blocks must be >= 2 (sentinel + 1), got {num_blocks}")
        if mesh is not None:
            self.batch_shards, self.model_shards = _mesh_shards(cfg, mesh, n_slots,
                                                                weights_int8)
        self.model = quantize_model(model) if weights_int8 else model
        self.cfg = cfg
        self.n_slots = int(n_slots)
        self.max_total = int(max_total)
        self.block_size = int(block_size)
        self.num_blocks = int(num_blocks)
        self.max_blocks = self.max_total // self.block_size
        self.spec_depth = int(spec_depth)
        self.device = model_device(self.model)
        self.mesh = mesh
        self.layout: Optional[_MeshLayout] = None
        if mesh is None:
            self.batch_shards = self.model_shards = 1
            # the pool has a dense cache's layout with blocks for rows
            self.cache: Optional[KVCache] = KVCache.zeros(
                cfg, self.num_blocks, self.block_size, self.device, kv_quant_int8)
            # each model shard's pool copies (one shard, one copy here)
            self.shard_pools: List[List[KVCache]] = [[self.cache]]
            decode = PagedDecodeStep(self.model)
        else:
            if self.device != mesh.devices[0][0]:
                raise ValueError(f"the model must be on the mesh's first device "
                                 f"{mesh.devices[0][0]}, not {self.device}")
            self.layout = _MeshLayout(self.model, mesh, self.num_blocks, self.block_size,
                                      kv_quant_int8)
            self.cache = None
            self.shard_pools = [self.layout.column(m) for m in range(self.model_shards)]
            decode = PagedDecodeStep(self.model, self.layout)
        self.kv_bytes_per_shard = _kv_bytes(self.shard_pools[0][0])
        self.kv_bytes_total = sum(_kv_bytes(copies[0]) for copies in self.shard_pools)
        inputs = _slot_inputs(self.n_slots, self.max_total, self.device)
        inputs["tables"] = torch.zeros(
            (self.n_slots, self.max_blocks), dtype=torch.long, device=self.device
        )

        def step() -> Tuple[torch.Tensor, torch.Tensor]:
            logits = decode(inputs["tok"], inputs["index"], inputs["tables"], self.cache)
            return _forced(logits, inputs["index"], inputs["prompt"], inputs["lens"]), logits

        self._step = _Program(step, inputs)
        self.logits: Optional[torch.Tensor] = None
        # built at the first prefill call, at that chunk's width
        self._prefill: Optional[_Program] = None
        ends = {name: torch.zeros((1,), dtype=torch.long, device=self.device)
                for name in ("src", "dst")}

        def copy() -> None:
            for pool in self.pool_tensors():
                src, dst = ends["src"].to(pool.device), ends["dst"].to(pool.device)
                pool.index_copy_(0, dst, pool.index_select(0, src))

        self._copy = _Program(copy, ends)
        self._verify: Optional[_Program] = None
        self.verify_logits: Optional[torch.Tensor] = None
        if self.spec_depth > 0:
            scorer = (PagedVerifyStep(self.model) if self.layout is None
                      else PagedVerifyStep(self.model, self.layout))
            window = _slot_inputs(self.n_slots, self.max_total, self.device)
            window["toks"] = window.pop("tok").new_zeros((self.n_slots, self.spec_depth + 1))
            window["tables"] = torch.zeros_like(inputs["tables"])

            def verify() -> Tuple[torch.Tensor, torch.Tensor]:
                logits = scorer(window["toks"], window["index"], window["tables"], self.cache)
                # row j scores position index + j, predicting index + j + 1:
                # a prediction still inside the prompt is the prompt's token
                at = window["index"][:, None] + torch.arange(
                    self.spec_depth + 1, device=self.device)[None, :]
                return _forced(logits, at, window["prompt"], window["lens"]), logits

            self._verify = _Program(verify, window)

    @property
    def compiles(self) -> int:
        return self._step.captures

    @property
    def prefill_compiles(self) -> int:
        return 0 if self._prefill is None else self._prefill.captures

    @property
    def copy_compiles(self) -> int:
        return self._copy.captures

    @property
    def verify_compiles(self) -> int:
        return 0 if self._verify is None else self._verify.captures

    def pool_tensors(self) -> List[torch.Tensor]:
        """Every tensor of every pool copy, the scales included."""
        return [t for copies in self.shard_pools for pool in copies for t in pool.tensors()]

    def init_cache(self) -> Optional[KVCache]:
        """The pool, zeroed in place (captured programs keep reading and
        writing the same tensors); None on a mesh (the shards' pools are
        `shard_pools`)."""
        for t in self.pool_tensors():
            t.zero_()
        return self.cache

    def __call__(self, tok, index, prompt, lens, tables) -> torch.Tensor:
        """One step for every slot: SlotDecodeStep's contract plus
        `tables` [n_slots, max_blocks] (each row's block table; unused
        tail entries point at the sentinel block 0)."""
        nxt, self.logits = self._step(tok=tok, index=index, prompt=prompt, lens=lens,
                                      tables=tables)
        return nxt

    def run_eager(self, tok, index, prompt, lens, tables) -> torch.Tensor:
        """The same step launched op by op, outside the graph."""
        nxt, self.logits = self._step.run_eager(tok=tok, index=index, prompt=prompt, lens=lens,
                                                tables=tables)
        return nxt

    def verify(self, toks, index, prompt, lens, tables) -> torch.Tensor:
        """Score every slot's speculated window: toks [n_slots, spec_depth
        + 1], column 0 each slot's current token, columns 1.. drafts at
        logical positions index + 1, index + 2, ... -> nxt [n_slots,
        spec_depth + 1] on the device, the greedy (or, inside the
        prompt, forced) next token after each window position. The
        caller accepts the longest prefix where nxt[:, j] == toks[:, j +
        1] and rolls the rest back by resetting the slot's cursor (the
        next window rewrites those pool rows before anything reads
        them)."""
        if self._verify is None:
            raise RuntimeError("verify() needs spec_depth > 0 at construction")
        nxt, self.verify_logits = self._verify(toks=toks, index=index, prompt=prompt,
                                               lens=lens, tables=tables)
        return nxt

    def prefill(self, tokens, start: int, table) -> None:
        """Ingest one chunk for one slot: tokens [1, chunk] at logical
        positions [start, start + chunk), mapped through `table`
        [max_blocks]."""
        width = int(np.shape(tokens)[1])
        if self._prefill is None:
            chunk = (PagedPrefillChunk(self.model) if self.layout is None
                     else PagedPrefillChunk(self.model, self.layout))
            inputs = {
                "tokens": torch.zeros((1, width), dtype=torch.long, device=self.device),
                "start": torch.zeros((), dtype=torch.long, device=self.device),
                "table": torch.zeros((self.max_blocks,), dtype=torch.long, device=self.device),
            }

            def prefill() -> None:
                chunk(inputs["tokens"], inputs["start"], inputs["table"], self.cache)

            self._prefill = _Program(prefill, inputs)
        elif width != self._prefill.inputs["tokens"].shape[1]:
            raise ValueError(
                f"prefill chunk of {width} tokens; this step's chunk program takes "
                f"{self._prefill.inputs['tokens'].shape[1]}"
            )
        self._prefill(tokens=tokens, start=int(start), table=table)

    def copy_block(self, src: int, dst: int) -> None:
        """Copy pool block `src` into block `dst` in every layer's k and v
        and their scales (the copy-on-write of a tail block admitted from
        the prefix cache)."""
        self._copy(src=[int(src)], dst=[int(dst)])

    def relayout(self) -> None:
        """Lay the model's current weights out on the mesh again (after a
        weight swap): the shard copies on other devices are rewritten;
        views of the model's own tensors already hold them."""
        if self.layout is not None:
            self.layout.refresh()


class ShardedPagedSlotDecodeStep(PagedSlotDecodeStep):
    """The tensor-parallel PagedSlotDecodeStep (the reference's,
    gpt.py:1771-1809): the same programs (step, prefill, copy_block and,
    with spec_depth > 0, verify), each with its counter, over a required
    ('batch','model') mesh (parallel/mesh.py make_device_mesh, whose
    device list may repeat a device: several shards on one device, as
    the reference's virtual CPU devices). Slot rows shard on 'batch';
    heads and the MLP's hidden units on 'model', the paged pool on its
    heads (`kv_bytes_per_shard` = `kv_bytes_total` / model_shards);
    block tables and scalars are shared. Only output dimensions split,
    and each activation split on 'model' is joined before its
    full-width contraction, so the chains are the single-device step's
    up to the rounding of a narrower product."""

    def __init__(
        self, model: GPT, n_slots: int, max_total: int, block_size: int, num_blocks: int,
        mesh, kv_quant_int8: bool = False, weights_int8: bool = False, spec_depth: int = 0,
    ) -> None:
        if mesh is None:
            raise ValueError(
                "ShardedPagedSlotDecodeStep requires a mesh (parallel/mesh.py make_device_mesh)")
        super().__init__(model, n_slots, max_total, block_size, num_blocks,
                         kv_quant_int8=kv_quant_int8, weights_int8=weights_int8, mesh=mesh,
                         spec_depth=spec_depth)
