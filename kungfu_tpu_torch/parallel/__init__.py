from .ring_attention import full_attention

__all__ = ["full_attention"]
