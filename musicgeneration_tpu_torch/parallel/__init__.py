"""Sequence parallelism: the mesh's ``seq`` axis and ring attention over it
(plain, and through kernel G)."""

from .mesh import Mesh, make_mesh
from .ring_attention import ring_relative_attention
from .ring_attention_pallas import ring_relative_attention_pallas

__all__ = ["Mesh", "make_mesh", "ring_relative_attention",
           "ring_relative_attention_pallas"]
