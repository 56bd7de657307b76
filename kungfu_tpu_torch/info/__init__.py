"""``python -m kungfu_tpu_torch.info``: environment and version dump
(counterpart of kungfu_tpu.info; reference srcs/python/kungfu/info/__main__.py)."""
