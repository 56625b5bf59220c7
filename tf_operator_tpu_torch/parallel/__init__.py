"""The workload's parallel seam: the bootstrap from the operator-injected
env (`distributed`), the (dp, fsdp) mesh (`mesh`) and the wrap plans
that lay a model over it (`sharding`)."""
