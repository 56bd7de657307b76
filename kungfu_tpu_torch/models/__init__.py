from .transformer import (TransformerConfig, TransformerLM, apply_rope, lm_loss,
                          lm_loss_chunked, lm_loss_shard, lm_loss_shard_chunked)

__all__ = ["TransformerConfig", "TransformerLM", "apply_rope", "lm_loss", "lm_loss_chunked",
           "lm_loss_shard", "lm_loss_shard_chunked"]
