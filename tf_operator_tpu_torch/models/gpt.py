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

Serving (serve/engine.py) runs one step over a fixed slot grid:
`SlotDecodeStep` over a dense [n_slots, max_total] cache and
`PagedSlotDecodeStep` over a pool of fixed-size KV blocks addressed
through per-slot block tables (with its prefill chunk and block copy).
Each program holds its inputs in static buffers and, on a CUDA device,
runs as one CUDA graph captured at its first call, where the reference
compiles its step once with jax.jit. Left out: the int8 KV cache, int8
weights and mesh-sharded decode (generate and the slot steps raise
NotImplementedError for each), and the speculative verify programs
(ROADMAP queue 1, items 4-6 and 8).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Tuple, Union

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..ops.attention import dot_product_attention
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
        """Final f32 LayerNorm, then the head in the compute dtype."""
        return dense(self.lm_head, self.ln_final(x), self.cfg.dtype)

    def forward(self, input_ids: torch.Tensor) -> torch.Tensor:
        positions = torch.arange(input_ids.shape[-1], device=input_ids.device)
        x = self.embed(input_ids, positions[None])
        for block in self.blocks():
            if self.cfg.remat and torch.is_grad_enabled():
                x = checkpoint(block, x, None, use_reentrant=False)
            else:
                x = block(x)
        return self.head(x)


def causal_lm_loss(
    logits: torch.Tensor, input_ids: torch.Tensor,
    weights: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Next-token cross-entropy: position t predicts token t+1, through
    the fused loss (ops/losses.py)."""
    from ..ops.losses import weighted_mean_xent

    if weights is not None:
        weights = weights[:, 1:]
    return weighted_mean_xent(logits[:, :-1], input_ids[:, 1:], weights)


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
    """Per layer, keys and values [batch, cache_len, heads, head_dim] in
    the model's compute dtype, written in place by the decode path."""

    keys: List[torch.Tensor]
    values: List[torch.Tensor]

    @classmethod
    def zeros(
        cls, cfg: GPTConfig, batch: int, cache_len: int,
        device: Optional[torch.device] = None,
    ) -> "KVCache":
        shape = (batch, cache_len, cfg.num_heads, cfg.head_dim)

        def layers():
            return [torch.zeros(shape, dtype=cfg.dtype, device=device)
                    for _ in range(cfg.num_layers)]

        return cls(keys=layers(), values=layers())


def _store_kv(cache: torch.Tensor, new: torch.Tensor, index: Index) -> None:
    """The cache write of both phases, in place: `new` [b, n, h, d] at
    positions [index, index + n) of every row for an int index, or row
    i's one token at index[i] for a [b] tensor."""
    new = new.to(cache.dtype)
    if isinstance(index, int):
        cache[:, index:index + new.shape[1]] = new
    else:
        rows = torch.arange(cache.shape[0], device=cache.device)
        cache[rows, index] = new[:, 0]


def _cache_attention(
    keys: torch.Tensor, values: torch.Tensor, index: Optional[Index],
) -> Callable:
    """The attention_fn a block runs in decode (the reference's
    _CachedBlock is its TransformerBlock with this attention): with index
    None, PrefillSelfAttention (the whole prompt's keys and values
    written at [0, p), attending over that slice); else
    CachedSelfAttention (one token's written at `index`, attending over
    the whole cache). Writes first, then attends over what was stored;
    the attention is the unquantized branch of the reference's
    _cache_attention, dot_product_attention under the mask."""

    def attend(query, key, value, mask):
        _store_kv(keys, key, 0 if index is None else index)
        _store_kv(values, value, 0 if index is None else index)
        if index is None:
            return dot_product_attention(
                query, keys[:, :key.shape[1]], values[:, :key.shape[1]], mask
            )
        return dot_product_attention(query, keys, values, mask)

    return attend


class GPTDecodeStep:
    """One-token forward over a GPT's own parameters: token [b] at
    `index` (an int for every row, or a [b] tensor of each row's
    position) -> logits [b, vocab], writing that position's keys and
    values into `cache`. The cache's length, not cfg.max_seq_len, sets
    how many positions each step attends over."""

    def __init__(self, model: GPT) -> None:
        self.model = model

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
        for block, keys, values in zip(model.blocks(), cache.keys, cache.values):
            x = block(x, valid, _cache_attention(keys, values, index))
        return model.head(x)[:, 0]


class GPTPrefill:
    """Whole-prompt forward over a GPT's own parameters: tokens [b, p] ->
    the last position's logits [b, vocab], writing positions [0, p) of
    `cache`, from which GPTDecodeStep continues."""

    def __init__(self, model: GPT) -> None:
        self.model = model

    @torch.no_grad()
    def __call__(self, tokens: torch.Tensor, cache: KVCache) -> torch.Tensor:
        model = self.model
        positions = torch.arange(tokens.shape[1], device=tokens.device)
        x = model.embed(tokens, positions[None])
        causal = (positions[:, None] >= positions[None, :])[None, None]
        for block, keys, values in zip(model.blocks(), cache.keys, cache.values):
            x = block(x, causal, _cache_attention(keys, values, None))
        return model.head(x[:, -1:])[:, 0]


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


def _sampler(
    temperature: float, top_k: int, top_p: float, generator: torch.Generator,
) -> Callable[[torch.Tensor], torch.Tensor]:
    """logits [b, vocab] -> tokens [b]: argmax at temperature 0, else
    temperature first, then the filters, then a categorical draw (the
    Gumbel-max draw jax.random.categorical makes, here in f32 from
    `generator`)."""

    def sample(logits: torch.Tensor) -> torch.Tensor:
        if temperature > 0.0:
            filtered = _filter_logits(logits.float() / temperature, top_k, top_p)
            u = torch.rand(
                filtered.shape, generator=generator, device=filtered.device
            ).clamp_min_(torch.finfo(torch.float32).tiny)
            return (filtered - torch.log(-torch.log(u))).argmax(dim=-1)
        return logits.argmax(dim=-1)

    return sample


def _decode(
    model: GPT, prompt: torch.Tensor, lens: torch.Tensor, total: int,
    sample: Callable[[torch.Tensor], torch.Tensor], ragged: bool,
) -> torch.Tensor:
    """Positions 1..total-1 of every row. Uniform path: the whole prompt
    in one GPTPrefill, then one GPTDecodeStep per new token. Ragged path
    (ragged=True): every position through GPTDecodeStep, each row's
    token forced to its own next prompt token while inside its prompt
    (lens), so shorter rows start generating at their own boundary."""
    batch, prompt_len = prompt.shape
    cache = KVCache.zeros(model.cfg, batch, total, prompt.device)
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

    mesh/rules (sharded decode), kv_quant_int8 and weights_int8 are not
    ported and raise NotImplementedError."""
    if mesh is not None or rules is not None:
        raise NotImplementedError(
            "mesh-sharded decode is not ported (ROADMAP queue 1 item 4)"
        )
    if kv_quant_int8:
        raise NotImplementedError("the int8 KV cache is not ported (ROADMAP queue 1 item 5)")
    if weights_int8:
        raise NotImplementedError("int8 weights are not ported (ROADMAP queue 1 item 8)")
    cfg = model.cfg
    batch, prompt_len = prompt.shape
    total = prompt_len + max_new_tokens
    if max_new_tokens < 1:
        raise ValueError(f"max_new_tokens must be >= 1, got {max_new_tokens}")
    if total > cfg.max_seq_len:
        raise ValueError(f"prompt+new = {total} exceeds max_seq_len {cfg.max_seq_len}")
    if top_k < 0:
        raise ValueError(f"top_k must be >= 0, got {top_k}")
    if not 0.0 < top_p <= 1.0:
        raise ValueError(f"top_p must be in (0, 1], got {top_p}")
    if top_k >= cfg.vocab_size:
        top_k = 0  # keeps everything
    device = model.lm_head.weight.device
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
    generated = _decode(model, prompt, lens, total, sample, ragged)
    return torch.cat([prompt[:, :1], generated], dim=1)


# -- the slot grid of the continuous-batching engine (serve/engine.py) ------


def _refuse_unported(
    kv_quant_int8: bool = False, weights_int8: bool = False, mesh=None,
    spec_depth: int = 0,
) -> None:
    """The decode options the slot steps do not port, each refused
    naming its ROADMAP item."""
    if kv_quant_int8:
        raise NotImplementedError("the int8 KV cache is not ported (ROADMAP queue 1 item 5)")
    if weights_int8:
        raise NotImplementedError("int8 weights are not ported (ROADMAP queue 1 item 8)")
    if mesh is not None:
        raise NotImplementedError("sharded decode is not ported (ROADMAP queue 1 item 6)")
    if spec_depth > 0:
        raise NotImplementedError(
            "the speculative verify program is not ported (ROADMAP queue 1 item 6)"
        )


def _kv_bytes(cache: KVCache) -> int:
    return sum(t.numel() * t.element_size() for t in cache.keys + cache.values)


def _forced(
    logits: torch.Tensor, index: torch.Tensor, prompt: torch.Tensor, lens: torch.Tensor,
) -> torch.Tensor:
    """The ragged forcing rule of the slot grid (the reference's
    SlotDecodeStep, gpt.py:910-916): a row still inside its prompt
    (index + 1 < lens) emits its next prompt token, any other row the
    argmax of its logits."""
    nxt = logits.argmax(dim=-1)
    ahead = (index + 1).clamp(max=prompt.shape[1] - 1)
    forced = prompt.gather(1, ahead[:, None])[:, 0]
    return torch.where(index + 1 < lens, forced, nxt)


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
    the same work launched op by op."""

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
            current = torch.cuda.current_stream(device)
            side = torch.cuda.Stream(device)
            side.wait_stream(current)
            with torch.cuda.stream(side):
                self.body()
            current.wait_stream(side)
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph):
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
    gpt.py:846). Every row is its own stream at its own position: row i
    writes its keys and values at index[i] of its cache row and attends
    over positions <= index[i] (GPTDecodeStep's per-row path). Prompt
    ingestion rides the same step through the forcing rule (`_forced`),
    so there is no prefill program. Greedy only; sampled requests keep
    the inline `generate`.

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
        _refuse_unported(kv_quant_int8, weights_int8, mesh)
        cfg = model.cfg
        if max_total > cfg.max_seq_len:
            raise ValueError(f"max_total {max_total} exceeds max_seq_len {cfg.max_seq_len}")
        self.model = model
        self.cfg = cfg
        self.n_slots = int(n_slots)
        self.max_total = int(max_total)
        device = model.lm_head.weight.device
        self.cache = KVCache.zeros(cfg, self.n_slots, self.max_total, device)
        self.kv_bytes_total = _kv_bytes(self.cache)
        decode = GPTDecodeStep(model)
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
        for t in self.cache.keys + self.cache.values:
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
) -> None:
    """The paged cache write of both phases, in place (the reference's
    _paged_store_kv, gpt.py:969, bf16 branch): `new` [n, heads,
    head_dim] into the pool [num_blocks, block_size, heads, head_dim] at
    the (block, offset) pairs (phys, off). Rows parked on the sentinel
    block 0 write there with duplicate indices; which write lands is
    unspecified, and every reader masks those positions."""
    pool.index_put_((phys, off), new.to(pool.dtype))


def _gather_blocks(pool: torch.Tensor, tables: torch.Tensor) -> torch.Tensor:
    """pool[tables] as each table's logical sequence: [..., max_blocks *
    block_size, heads, head_dim] in logical-position order."""
    out = pool[tables]
    return out.reshape(*tables.shape[:-1], -1, *pool.shape[2:])


def _paged_attention(
    keys: torch.Tensor, values: torch.Tensor, index: torch.Tensor, tables: torch.Tensor,
) -> Callable:
    """PagedSelfAttention (the reference's gpt.py:1032), as the
    attention_fn of a decoder block: each slot's one token [s, 1, h, d]
    written at logical position index[s] through its block table, then
    attention over the gathered pool[tables] under the caller's mask.
    With max_blocks * block_size equal to the dense grid's max_total the
    einsums see the dense step's shapes, position for position."""

    def attend(query, key, value, mask):
        bs = keys.shape[1]
        phys = tables.gather(1, (index // bs)[:, None])[:, 0]
        off = index % bs
        _paged_store_kv(keys, key[:, 0], phys, off)
        _paged_store_kv(values, value[:, 0], phys, off)
        return dot_product_attention(
            query, _gather_blocks(keys, tables), _gather_blocks(values, tables), mask
        )

    return attend


def _paged_prefill_attention(
    keys: torch.Tensor, values: torch.Tensor, positions: torch.Tensor, table: torch.Tensor,
) -> Callable:
    """PagedPrefillSelfAttention (the reference's gpt.py:1108), as an
    attention_fn: one slot's chunk [1, c, h, d] at logical `positions`
    [c] written through its table [max_blocks] first, then attention over
    the gathered pool[table], so the chunk's queries read the bytes a
    later decode step reads."""

    def attend(query, key, value, mask):
        bs = keys.shape[1]
        phys = table[positions // bs]
        off = positions % bs
        _paged_store_kv(keys, key[0], phys, off)
        _paged_store_kv(values, value[0], phys, off)
        return dot_product_attention(
            query, _gather_blocks(keys, table[None]), _gather_blocks(values, table[None]), mask
        )

    return attend


class PagedDecodeStep:
    """One-token forward over the paged pool with a GPT's own parameters
    (the reference's PagedDecodeStep, gpt.py:1325): token [s] at
    index [s] through tables [s, max_blocks] -> logits [s, vocab]."""

    def __init__(self, model: GPT) -> None:
        self.model = model

    @torch.no_grad()
    def __call__(
        self, token: torch.Tensor, index: torch.Tensor, tables: torch.Tensor, pool: KVCache,
    ) -> torch.Tensor:
        model = self.model
        x = model.embed(token[:, None], index[:, None])
        length = tables.shape[1] * pool.keys[0].shape[1]
        positions = torch.arange(length, device=token.device)
        valid = (positions[None, :] <= index[:, None])[:, None, None, :]
        for block, keys, values in zip(model.blocks(), pool.keys, pool.values):
            x = block(x, valid, _paged_attention(keys, values, index, tables))
        return model.head(x)[:, 0]


class PagedPrefillChunk:
    """One prefill chunk for one slot (the reference's PagedPrefillChunk,
    gpt.py:1363): tokens [1, c] at logical positions [start, start + c)
    through table [max_blocks], writing every layer's keys and values.
    No ln_final or lm_head: a chunk never emits a token (the prompt's
    last token rides a decode step). -> the last block's output."""

    def __init__(self, model: GPT) -> None:
        self.model = model

    @torch.no_grad()
    def __call__(
        self, tokens: torch.Tensor, start: torch.Tensor, table: torch.Tensor, pool: KVCache,
    ) -> torch.Tensor:
        model = self.model
        positions = start + torch.arange(tokens.shape[1], device=tokens.device)
        x = model.embed(tokens, positions[None])
        length = table.shape[0] * pool.keys[0].shape[1]
        keys_at = torch.arange(length, device=tokens.device)
        mask = (keys_at[None, :] <= positions[:, None])[None, None]
        for block, keys, values in zip(model.blocks(), pool.keys, pool.values):
            x = block(x, mask, _paged_prefill_attention(keys, values, positions, table))
        return x


class PagedSlotDecodeStep:
    """One single-token decode over a fixed [n_slots] grid whose keys
    and values live in a shared pool of fixed-size blocks, [num_blocks,
    block_size, heads, head_dim] per layer and per k/v (the reference's
    PagedSlotDecodeStep, gpt.py:1449, without verify, the mesh branch
    and int8): the device half of the engine's kv_layout="paged". Block
    0 is the sentinel: idle rows and unused table entries point at it.

    Three programs, each a `_Program` (on a CUDA device one CUDA graph,
    captured at its first call) with its own counter:
    - `__call__`: SlotDecodeStep's contract plus `tables` [n_slots,
      max_blocks] (`compiles`);
    - `prefill`: one chunked-prefill chunk for one slot, always the width
      of the first chunk it was given (`prefill_compiles`);
    - `copy_block`: one block copied into another in every layer's k and
      v, the prefix cache's copy-on-write (`copy_compiles`).

    `logits` are the last step's, as SlotDecodeStep's. max_total must
    divide into blocks: the gathered attention width max_blocks *
    block_size then equals the dense grid's, and the paged and dense
    steps run the same einsum shapes."""

    def __init__(
        self, model: GPT, n_slots: int, max_total: int, block_size: int, num_blocks: int,
        kv_quant_int8: bool = False, weights_int8: bool = False, mesh=None,
        spec_depth: int = 0,
    ) -> None:
        _refuse_unported(kv_quant_int8, weights_int8, mesh, spec_depth)
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
        self.model = model
        self.cfg = cfg
        self.n_slots = int(n_slots)
        self.max_total = int(max_total)
        self.block_size = int(block_size)
        self.num_blocks = int(num_blocks)
        self.max_blocks = self.max_total // self.block_size
        self.device = model.lm_head.weight.device
        # the pool has a dense cache's layout with blocks for rows
        self.cache = KVCache.zeros(cfg, self.num_blocks, self.block_size, self.device)
        self.kv_bytes_total = _kv_bytes(self.cache)
        decode = PagedDecodeStep(model)
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
            for pool in self.cache.keys + self.cache.values:
                pool.index_copy_(0, ends["dst"], pool.index_select(0, ends["src"]))

        self._copy = _Program(copy, ends)

    @property
    def compiles(self) -> int:
        return self._step.captures

    @property
    def prefill_compiles(self) -> int:
        return 0 if self._prefill is None else self._prefill.captures

    @property
    def copy_compiles(self) -> int:
        return self._copy.captures

    def init_cache(self) -> KVCache:
        """The pool, zeroed in place (captured programs keep reading and
        writing the same tensors)."""
        for t in self.cache.keys + self.cache.values:
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

    def prefill(self, tokens, start: int, table) -> None:
        """Ingest one chunk for one slot: tokens [1, chunk] at logical
        positions [start, start + chunk), mapped through `table`
        [max_blocks]."""
        width = int(np.shape(tokens)[1])
        if self._prefill is None:
            chunk = PagedPrefillChunk(self.model)
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
        (the copy-on-write of a tail block admitted from the prefix
        cache)."""
        self._copy(src=[int(src)], dst=[int(dst)])
