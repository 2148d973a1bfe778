"""Multi-device serving for the port: a tier's device group (``mesh``),
the Megatron and expert split of the weights and the split of the KV
(``sharding``), the group's collectives (``collectives``), the
per-shard layers (``tp_attention``), ring prefill over a sequence split
(``ring_attention``) and decode over a sequence-split cache
(``sp_attention``).  One process drives every slot of a group, as one
JAX process drives a tier's mesh."""
