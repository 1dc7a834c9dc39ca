"""Data, sequence, tensor and pipeline parallelism: the (data, seq, model
[, pipe]) mesh, a batch's rows for each data shard, where each parameter
lives (``param_placements``, ``pipeline_param_shardings``), ring
attention over the ``seq`` axis (plain, and through kernel G), head
shards over the ``model`` axis and the GPipe schedule over ``pipe``."""

from .mesh import (Mesh, Placement, make_mesh, multihost_shard_batch,
                   param_placements, shard_batch)
from .pipeline import make_pipeline_apply, pipeline_param_shardings
from .ring_attention import ring_relative_attention
from .ring_attention_pallas import ring_relative_attention_pallas

__all__ = ["Mesh", "Placement", "make_mesh", "make_pipeline_apply",
           "multihost_shard_batch", "param_placements",
           "pipeline_param_shardings", "ring_relative_attention",
           "ring_relative_attention_pallas", "shard_batch"]
