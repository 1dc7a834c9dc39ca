"""Data and sequence parallelism: the (data, seq) mesh, a batch's rows
for each data shard, and ring attention over the ``seq`` axis (plain,
and through kernel G)."""

from .mesh import Mesh, make_mesh, multihost_shard_batch, shard_batch
from .ring_attention import ring_relative_attention
from .ring_attention_pallas import ring_relative_attention_pallas

__all__ = ["Mesh", "make_mesh", "multihost_shard_batch",
           "ring_relative_attention", "ring_relative_attention_pallas",
           "shard_batch"]
