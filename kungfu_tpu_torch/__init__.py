"""PyTorch/CUDA port of kungfu_tpu, for one NVIDIA H100 and up.

The JAX package `kungfu_tpu` is the reference: every module here keeps
the name of its counterpart there, and the tests hold the two against
each other on the CPU.  This package imports no JAX and nothing of
`kungfu_tpu`.

What runs so far is the synchronous-SGD training step of the flagship GPT
(`models.transformer.TransformerLM` under `train.DataParallelTrainer` with
`optimizers.synchronous_sgd`), its attention on hand-written CUDA kernels
for Hopper (`ops/flash.py`, sources in `ops/csrc/`).

Entry points run on the card unless the caller passes `device="cpu"`; on
the CPU every kernel wrapper runs its plain PyTorch version instead.
"""
