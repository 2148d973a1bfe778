"""Tensor parallelism for the port: a tier's device group (``mesh``), the
Megatron split of the weights and the KV (``sharding``), the group's
collectives (``collectives``) and the per-shard layers
(``tp_attention``).  One process drives every shard of a group, as one
JAX process drives a tier's mesh."""
