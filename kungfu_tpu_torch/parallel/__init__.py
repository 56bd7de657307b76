from .ring_attention import full_attention, ring_attention
from .ulysses import ulysses_attention

__all__ = ["full_attention", "ring_attention", "ulysses_attention"]
