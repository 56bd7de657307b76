from .transformer import (TransformerConfig, TransformerLM, apply_rope, lm_loss,
                          lm_loss_chunked, lm_loss_shard)

__all__ = ["TransformerConfig", "TransformerLM", "apply_rope", "lm_loss", "lm_loss_chunked",
           "lm_loss_shard"]
