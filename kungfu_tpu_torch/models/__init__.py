from .transformer import TransformerConfig, TransformerLM, apply_rope, lm_loss

__all__ = ["TransformerConfig", "TransformerLM", "apply_rope", "lm_loss"]
