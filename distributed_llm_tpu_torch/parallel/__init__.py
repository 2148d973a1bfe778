"""Multi-device serving and training for the port: a group of slots
(``mesh``), the Megatron and expert split of the weights, the split of
the KV and the training placement (``sharding``), the group's
collectives (``collectives``), the per-shard layers (``tp_attention``),
ring prefill over a sequence split (``ring_attention``), decode over a
sequence-split cache (``sp_attention``) and the GPipe schedule
(``pipeline``).  One process drives every slot of a group, as one JAX
process drives a mesh."""
