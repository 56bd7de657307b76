from .ring_attention import full_attention, ring_attention

__all__ = ["full_attention", "ring_attention"]
