"""Mixture-of-Experts decoder LM. Counterpart of
tf_operator_tpu/models/moe.py: its training half and its KV-cached
decode.

Training:  logits, losses = MoELM(cfg)(input_ids, mask)
           loss = lm_loss(logits, labels, mask) + total_aux_loss(losses)
Decoding:  tokens = moe_generate(model, prompt, max_new_tokens)

- GShard-style token-choice top-k routing with a fixed expert capacity,
  as dense one-hot products: dispatch `gtec,gth->egch`, the two expert
  products, combine `gtec,egch->gth`. Every expert gets a gradient at
  every step (DDP needs no find_unused_parameters), nothing reads a
  value back to the host (run_steps' CUDA graph captures the step), and
  a one-hot product is exact.
- The router runs in f32 on the f32 LayerNorm output; dispatch and
  combine are cast to the model dtype before the products, so the gate
  probabilities are rounded there, as in the reference.
- Capacity follows the reference's loop, not its comment: `claims`
  carries whole rounds, so every token's top-1 claim in a group goes
  before any top-2 claim, and a token's top-2 drops before a later
  token's top-1.
- The expert kernels are parameters in the model dtype (bf16 in
  MOE_BASE), as the reference's `self.param(..., cfg.dtype)`; every
  other parameter is f32 and cast at use. torch's AdamW keeps each
  parameter's moments in its dtype, so the experts' moments are bf16 as
  optax's are; fused AdamW (Trainer.init on CUDA) updates them in bf16
  too, one kernel per dtype group.
- The reference sows its router losses into a flax collection. Here
  every forward returns them with the logits, per call (no module state
  outlives a call, so a CUDA graph's replay computes fresh ones):
  `losses` maps "router_aux" (and "router_z" when router_z_weight > 0)
  to one already-weighted scalar per MoE layer. `total_aux_loss` and
  `sum_sown` sum them.
- Under a mesh (parallel/sharding.py parallelize sets `sync_group`) the
  router all-reduces its two per-expert means, and the z-loss's mean,
  over the batch group, differentiably, so that both losses are the
  global batch's, as GSPMD gives the reference, whatever weight the
  trainer gives each rank's loss (a padded batch's ranks carry unequal
  token masses). Inside the pipeline
  (models/moe_pipeline.py) no sync_group is set: each microbatch's means
  are its own, the reference's manual mode under shard_map.
- Expert parallel (the reference's :160-225; parallel/sharding.py
  apply_expert_parallel, and its tp plan for the experts' f): an MoEMlp
  holds experts [start, start + e_local) of f / tp, routes over every
  expert with its replicated router, slices dispatch and combine to its
  experts (capacity from the global count, as the reference's n_exp
  comment says), and sums its partial output over its expert group.
  Every rank sees the same rows and computes the replicated parameters'
  full gradients: the token activations fed to the local experts, and
  the gates that weight their outputs, are copied to the group
  (identity forward, all-reduce backward), so the other ranks' combine
  paths reach the router and dx, while the router's own losses, which
  every rank computes whole, are counted once.

The blocks are BERT's TransformerBlock (the same pre-LN order, names and
tanh GELU): dense layers are that block, MoE layers (`layer_is_moe`: the
odd ones at moe_every 2) are MoEBlock, which keeps its attention half
and replaces the MLP with MoEMlp. Attention is plain
`dot_product_attention` under the causal and padding masks, as the
reference's `attention_fn=None`: no kernel of the port runs here.
Parameter names follow the reference's param paths, so converted
weights (models/convert.py) load by name.

Decode: each decoded and prefilled position routes in its own one-token
group, where capacity is max(4, ...), so decode never drops; it equals
the training forward teacher-forced wherever training dropped nothing.
Sampling draws from a `torch.Generator` where the reference folds the
position into a jax key: greedy chains are equal, sampled ones are the
port's own.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.attention import lecun_normal_
from .bert import LayerNorm, TransformerBlock, init_like_flax_
from .gpt import Index, KVCache, _cache_attention, _sampler

# one already-weighted scalar per MoE layer, by loss name
Losses = Dict[str, List[torch.Tensor]]


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    vocab_size: int = 32000
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: int = 3072
    max_position_embeddings: int = 2048
    num_experts: int = 8
    experts_per_token: int = 2
    capacity_factor: float = 1.25
    # every `moe_every`-th block uses an MoE MLP; 1 = every block
    moe_every: int = 2
    router_aux_weight: float = 0.01
    # ST-MoE router z-loss weight; 0 leaves the loss out
    router_z_weight: float = 0.0
    dtype: torch.dtype = torch.bfloat16

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads


MOE_TINY = MoEConfig(
    vocab_size=512, hidden_size=64, num_layers=2, num_heads=4,
    intermediate_size=128, max_position_embeddings=128, num_experts=4,
    experts_per_token=2, moe_every=1, dtype=torch.float32,
)
MOE_BASE = MoEConfig(router_z_weight=0.001)


def expert_capacity(cfg: MoEConfig, tokens_per_group: int) -> int:
    """The fixed per-expert buffer: tokens past it drop (their residual
    carries them)."""
    ideal = tokens_per_group * cfg.experts_per_token / cfg.num_experts
    return max(4, int(math.ceil(ideal * cfg.capacity_factor)))


def _one_hot(index: torch.Tensor, n: int, dtype: torch.dtype) -> torch.Tensor:
    """jax.nn.one_hot: an index outside [0, n) gives a row of zeros. A
    comparison, so nothing checks the values on the host."""
    return (index[..., None] == torch.arange(n, device=index.device)).to(dtype)


class TopKRouter(nn.Module):
    """Token-choice top-k router: x [groups, tokens, hidden] ->
    (dispatch, combine, losses). dispatch [g, t, experts, capacity] is 1
    where the token holds that slot of that expert; combine carries the
    router probability there."""

    def __init__(self, cfg: MoEConfig) -> None:
        super().__init__()
        self.cfg = cfg
        self.router = nn.Linear(cfg.hidden_size, cfg.num_experts, bias=False)
        # set by parallel/sharding.py parallelize under a mesh: the group
        # the per-expert means are averaged over
        self.sync_group = None
        # set under expert parallel (MoEMlp.expert_parallel): the group
        # whose ranks each combine a slice of the experts; the gates are
        # copied to it, so their gradient sums every rank's slice
        self.combine_group = None

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, Dict[str, torch.Tensor]]:
        cfg = self.cfg
        groups, tokens = x.shape[0], x.shape[1]
        capacity = expert_capacity(cfg, tokens)
        logits = F.linear(x.float(), self.router.weight)
        probs = torch.softmax(logits, dim=-1)  # [g, t, e]

        # iterative top-k: argmax (the first maximum), mask, repeat
        remaining = probs
        expert_masks, gate_probs = [], []
        for _ in range(cfg.experts_per_token):
            onehot = _one_hot(remaining.argmax(dim=-1), cfg.num_experts, probs.dtype)
            expert_masks.append(onehot)
            gate_probs.append((probs * onehot).sum(-1))
            remaining = remaining * (1.0 - onehot)
        if self.combine_group is not None:
            from ..parallel.distributed import copy_to_group

            gate_probs = list(copy_to_group(torch.stack(gate_probs), self.combine_group))

        # each claim's slot: earlier claims on its expert, whole rounds first
        positions = []
        claims = probs.new_zeros((groups, cfg.num_experts))
        for onehot in expert_masks:
            prior = torch.cumsum(onehot, dim=1) - onehot + claims[:, None, :]
            positions.append((prior * onehot).sum(-1))  # [g, t]
            claims = claims + onehot.sum(dim=1)

        dispatch = probs.new_zeros((groups, tokens, cfg.num_experts, capacity))
        combine = torch.zeros_like(dispatch)
        for onehot, gate, pos in zip(expert_masks, gate_probs, positions):
            within = (pos < capacity).to(probs.dtype)
            slot = _one_hot(pos.long(), capacity, probs.dtype)
            mask = onehot[..., None] * slot[..., None, :] * within[..., None, None]
            dispatch = dispatch + mask
            combine = combine + mask * gate[..., None, None]

        # load balancing: num_experts * E[router prob] . E[top-1 share]
        means = [expert_masks[0].mean(dim=(0, 1)), probs.mean(dim=(0, 1))]
        if cfg.router_z_weight > 0:
            means.append(torch.mean(torch.logsumexp(logits, dim=-1) ** 2)[None])
        if self.sync_group is not None:
            means = _global_means(means, self.sync_group)
        top1_frac, prob_frac = means[:2]
        aux = cfg.num_experts * torch.sum(top1_frac * prob_frac)
        losses = {"router_aux": cfg.router_aux_weight * aux}
        if cfg.router_z_weight > 0:
            losses["router_z"] = cfg.router_z_weight * means[2][0]
        return dispatch, combine, losses


def _global_means(means: List[torch.Tensor], group) -> List[torch.Tensor]:
    """Each 1-d mean averaged over `group` (its ranks hold equal shares
    of the batch), in one differentiable all-reduce."""
    import torch.distributed as dist
    from torch.distributed.nn.functional import all_reduce

    summed = all_reduce(torch.cat(means), group=group) / dist.get_world_size(group)
    return list(summed.split([m.shape[0] for m in means]))


def dispatch_tokens(dispatch: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Tokens into the experts' buffers: [g, t, e, c] x [g, t, h] -> [e, g, c, h]."""
    return torch.einsum("gtec,gth->egch", dispatch, x)


def expert_ffn(x: torch.Tensor, w_in: torch.Tensor, w_out: torch.Tensor) -> torch.Tensor:
    """Every expert's GELU MLP over its buffer: [e, g, c, h] -> [e, g, c, h]."""
    h = torch.einsum("egch,ehf->egcf", x, w_in)
    h = F.gelu(h, approximate="tanh")
    return torch.einsum("egcf,efh->egch", h, w_out)


def combine_tokens(combine: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """The experts' outputs back to the tokens, weighted by their gates."""
    return torch.einsum("gtec,egch->gth", combine, h)


class MoEMlp(nn.Module):
    """dispatch -> per-expert GELU MLP -> combine. The expert kernels
    [e, h, f] and [e, f, h] are parameters in cfg.dtype; under expert
    parallel (`expert_parallel`) this rank's [e_local, h, f_local] and
    [e_local, f_local, h]."""

    def __init__(self, cfg: MoEConfig) -> None:
        super().__init__()
        self.cfg = cfg
        self.router_gate = TopKRouter(cfg)
        e, h, f = cfg.num_experts, cfg.hidden_size, cfg.intermediate_size
        self.expert_in = nn.Parameter(torch.zeros(e, h, f, dtype=cfg.dtype))
        self.expert_out = nn.Parameter(torch.zeros(e, f, h, dtype=cfg.dtype))
        # expert parallel: the group the partial outputs are summed over
        # and the global index of this rank's first expert
        self.expert_group = None
        self.expert_start = 0

    def expert_parallel(self, group, start: int) -> None:
        """Hold experts [start, start + local count) of f's local slice
        (the kernels already laid out, parallel/sharding.py) and sum the
        partial outputs over `group`."""
        self.expert_group = group
        self.expert_start = start
        self.router_gate.combine_group = group

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        """flax's lecun_normal with the expert axis as a batch axis (fan_in
        is each expert's input width), drawn in f32 and rounded."""
        with torch.no_grad():
            for w in (self.expert_in, self.expert_out):
                draw = torch.empty(w.shape, dtype=torch.float32)
                w.copy_(lecun_normal_(draw, w.shape[1], generator))

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        dtype = self.cfg.dtype
        dispatch, combine, losses = self.router_gate(x)
        xd = x.to(dtype)
        group = self.expert_group
        if group is not None:
            from ..parallel.distributed import copy_to_group

            mine = slice(self.expert_start, self.expert_start + self.expert_in.shape[0])
            dispatch, combine = dispatch[:, :, mine], combine[:, :, mine]
            xd = copy_to_group(xd, group)
        h = dispatch_tokens(dispatch.to(dtype), xd)
        h = expert_ffn(h, self.expert_in, self.expert_out)
        if group is None:
            return combine_tokens(combine.to(dtype), h), losses
        from ..parallel.distributed import reduce_from_group

        # the ranks' partial outputs summed in f32 and rounded once, as the
        # one process's combine product accumulates every expert's
        y = combine_tokens(combine.to(dtype).float(), h.float())
        return reduce_from_group(y, group).to(dtype), losses


class MoEBlock(TransformerBlock):
    """TransformerBlock's attention half, then MoEMlp in place of its
    dense MLP: forward returns (x, losses)."""

    def __init__(self, cfg: MoEConfig, attention_fn: Optional[Callable] = None) -> None:
        super().__init__(cfg, attention_fn)
        del self.mlp_in, self.mlp_out
        self.moe_mlp = MoEMlp(cfg)

    def forward(
        self, x: torch.Tensor, mask: Optional[torch.Tensor] = None,
        attention_fn: Optional[Callable] = None, token_groups: bool = False,
    ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """token_groups: route every position in its own one-token group
        (the prefill's routing, which is the decode step's)."""
        x = self.attention_half(x, mask, attention_fn)
        y = self.ln_mlp(x)
        if token_groups:
            b, t, h = y.shape
            y, losses = self.moe_mlp(y.reshape(b * t, 1, h))
            return x + y.reshape(b, t, h), losses
        y, losses = self.moe_mlp(y)
        return x + y, losses


def layer_is_moe(cfg: MoEConfig, layer: int) -> bool:
    """Layers 1, 1 + moe_every, ... are MoE; layer 0 stays dense."""
    return cfg.moe_every > 0 and layer % cfg.moe_every == (1 % cfg.moe_every)


def causal_mask(seq_len: int, device=None) -> torch.Tensor:
    """[1, 1, q, k] lower-triangular mask."""
    return torch.tril(torch.ones((seq_len, seq_len), dtype=torch.bool, device=device))[None, None]


class MoELM(nn.Module):
    """Causal decoder LM with alternating dense/MoE blocks. forward ->
    (logits [b, s, vocab] in the compute dtype, losses). Parameters are
    drawn from `generator` (on the CPU) and moved to `device`."""

    def __init__(
        self, cfg: MoEConfig, device: Optional[torch.device] = None,
        generator: Optional[torch.Generator] = None,
    ) -> None:
        super().__init__()
        self.cfg = cfg
        self.token_embed = nn.Embedding(cfg.vocab_size, cfg.hidden_size)
        self.position_embed = nn.Embedding(cfg.max_position_embeddings, cfg.hidden_size)
        for i in range(cfg.num_layers):
            block = MoEBlock(cfg) if layer_is_moe(cfg, i) else TransformerBlock(cfg)
            self.add_module(f"layer_{i}", block)
        self.ln_final = LayerNorm(cfg.hidden_size)
        self.lm_head = nn.Linear(cfg.hidden_size, cfg.vocab_size, bias=False)
        # set by parallel/sharding.py under tp: the head's vocab split
        self.vocab_shard = None
        init_like_flax_(self, generator)
        for module in self.modules():
            if isinstance(module, MoEMlp):
                module.reset_parameters(generator)
        if device is not None:
            self.to(device)

    def blocks(self) -> List[TransformerBlock]:
        return [getattr(self, f"layer_{i}") for i in range(self.cfg.num_layers)]

    def embed(self, input_ids: torch.Tensor, positions: torch.Tensor) -> torch.Tensor:
        dtype = self.cfg.dtype
        return self.token_embed(input_ids).to(dtype) + self.position_embed(positions).to(dtype)

    def head(self, x: torch.Tensor) -> torch.Tensor:
        """ln_final in f32, then the bias-free head in the compute dtype
        (this rank's vocab columns under tp)."""
        dtype = self.cfg.dtype
        x = self.ln_final(x)
        if self.vocab_shard is not None:
            from ..parallel.distributed import copy_to_group

            x = copy_to_group(x, self.vocab_shard.group)
        return F.linear(x.to(dtype), self.lm_head.weight.to(dtype))

    def run_blocks(
        self, x: torch.Tensor, mask: Optional[torch.Tensor],
        attention_fns: Optional[List[Callable]] = None, token_groups: bool = False,
    ) -> Tuple[torch.Tensor, Losses]:
        losses: Losses = {}
        for i, block in enumerate(self.blocks()):
            attend = None if attention_fns is None else attention_fns[i]
            if isinstance(block, MoEBlock):
                x, layer_losses = block(x, mask, attend, token_groups=token_groups)
                for name, value in layer_losses.items():
                    losses.setdefault(name, []).append(value)
            else:
                x = block(x, mask, attend)
        return x, losses

    def forward(
        self, input_ids: torch.Tensor, mask: Optional[torch.Tensor] = None
    ) -> Tuple[torch.Tensor, Losses]:
        seq_len = input_ids.shape[-1]
        positions = torch.arange(seq_len, device=input_ids.device)
        x = self.embed(input_ids, positions[None])
        attn_mask = causal_mask(seq_len, input_ids.device)
        if mask is not None:
            attn_mask = attn_mask & mask[:, None, None, :].bool()
        x, losses = self.run_blocks(x, attn_mask)
        return self.head(x), losses


def lm_loss(
    logits: torch.Tensor, labels: torch.Tensor, weights: Optional[torch.Tensor] = None,
    vocab=None,
) -> torch.Tensor:
    """Next-token cross-entropy (the shift happens here), through the
    fused loss (ops/losses.py); vocab: the logits' split under tp
    (parallel/sharding.py VocabShard)."""
    from ..ops.losses import weighted_mean_xent

    if weights is not None:
        weights = weights[:, 1:]
    return weighted_mean_xent(logits[:, :-1], labels[:, 1:], weights, vocab)


def sum_sown(losses: Losses, name: str) -> torch.Tensor:
    """The losses named `name` ("router_aux" or "router_z"), summed over
    the layers, in f32; 0 (on the losses' device) where there are none."""
    terms = [value.float() for value in losses.get(name, [])]
    if not terms:
        device = next((v.device for vs in losses.values() for v in vs), None)
        return torch.zeros((), dtype=torch.float32, device=device)
    return torch.stack(terms).sum()


def total_aux_loss(losses: Losses) -> torch.Tensor:
    """Every router loss of a forward, summed: the training regularizer."""
    return sum((sum_sown(losses, name) for name in losses), torch.zeros(()))


def synthetic_batch(
    generator: torch.Generator, batch_size: int, seq_len: int, cfg: MoEConfig
) -> Dict[str, torch.Tensor]:
    """Uniform random tokens on the CPU, no padding, as the reference
    draws them (from a torch.Generator, so not its tokens)."""
    input_ids = torch.randint(0, cfg.vocab_size, (batch_size, seq_len), generator=generator)
    return {
        "input_ids": input_ids,
        "labels": input_ids,
        "attention_mask": torch.ones((batch_size, seq_len), dtype=torch.int32),
    }


# -- KV-cached decode --------------------------------------------------------


class MoEDecodeStep:
    """One-token forward over an MoELM's own parameters: token [b] at
    `index` (an int, or a [b] tensor) -> logits [b, vocab], writing that
    position's keys and values into `cache`. Each token routes in its
    own one-token group ([b, 1, hidden])."""

    def __init__(self, model: MoELM) -> None:
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
        attend = [_cache_attention(kv, index) for kv in cache.layers()]
        x, _ = model.run_blocks(x, valid, attend)
        return model.head(x)[:, 0]


class MoEPrefill:
    """Whole-prompt forward: tokens [b, p] -> the last position's logits,
    writing positions [0, p) of `cache`. Every position routes in its own
    one-token group, the decode step's routing."""

    def __init__(self, model: MoELM) -> None:
        self.model = model

    @torch.no_grad()
    def __call__(self, tokens: torch.Tensor, cache: KVCache) -> torch.Tensor:
        model = self.model
        positions = torch.arange(tokens.shape[1], device=tokens.device)
        x = model.embed(tokens, positions[None])
        attend = [_cache_attention(kv, None) for kv in cache.layers()]
        x, _ = model.run_blocks(x, causal_mask(tokens.shape[1], tokens.device), attend,
                                token_groups=True)
        return model.head(x[:, -1:])[:, 0]


@torch.no_grad()
def moe_generate(
    model: MoELM, prompt: torch.Tensor, max_new_tokens: int,
    temperature: float = 0.0, generator: Optional[torch.Generator] = None,
) -> torch.Tensor:
    """KV-cached decode on the model's device: [b, p] -> [b, p +
    max_new_tokens]; the prompt in one MoEPrefill, then one MoEDecodeStep
    per new token. Greedy at temperature 0, else a categorical draw from
    the tempered logits (generator: on the model's device, default
    seeded 0)."""
    cfg = model.cfg
    prompt_len = prompt.shape[1]
    total = prompt_len + max_new_tokens
    if max_new_tokens < 1:
        raise ValueError(f"max_new_tokens must be >= 1, got {max_new_tokens}")
    if total > cfg.max_position_embeddings:
        raise ValueError(
            f"prompt+new = {total} exceeds max_position_embeddings "
            f"{cfg.max_position_embeddings}"
        )
    if temperature < 0:
        raise ValueError(f"temperature must be >= 0, got {temperature}")
    device = model.lm_head.weight.device
    prompt = prompt.to(device=device, dtype=torch.long)
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(0)
    sample = _sampler(float(temperature), 0, 1.0, generator)
    cache = KVCache.zeros(cfg, prompt.shape[0], total, device)
    step = MoEDecodeStep(model)
    tok = sample(MoEPrefill(model)(prompt, cache))
    out = [tok]
    for index in range(prompt_len, total - 1):
        tok = sample(step(tok, index, cache))
        out.append(tok)
    return torch.cat([prompt, torch.stack(out, dim=1)], dim=1)
