"""The workload's parallel seam: the bootstrap from the operator-injected
env and the plans' collectives (`distributed`), the (dp, fsdp, sp, tp)
mesh (`mesh`), the wrap plans that lay a model over it, DDP, FSDP2 and
the Megatron tensor-parallel plan (`sharding`), and the
sequence-parallel attentions (`ring_attention`, `ulysses`, behind
`compat`'s packed-only seam)."""
