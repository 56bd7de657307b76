"""PyTorch/CUDA port of kungfu_tpu, for one NVIDIA H100 and up.

The JAX package `kungfu_tpu` is the reference: every module here keeps
the name of its counterpart there, and the tests hold the two against
each other on the CPU.  This package imports no JAX and nothing of
`kungfu_tpu`.

What runs so far is the synchronous-SGD training step of the flagship GPT
and its GQA variant (`models.transformer.TransformerLM` under
`train.DataParallelTrainer` with `optimizers.synchronous_sgd`), on one
card or across ranks started by `python -m kungfu_tpu_torch.run`: its
attention on hand-written CUDA kernels for Hopper (`ops/flash.py`), its
gradient mean on hand-written ring kernels (`ops/ring_collectives.py`),
plain or with int8/fp8 codes on the wire and error feedback
(`compression/`); and the flagship's sequence-parallel step
(`trainer.MeshTrainer` over `plan.make_mesh(dp=..., sp=...)`, ring
attention in `parallel/ring_attention.py` with K/V rotating through a
hand-written shift kernel, `ops/fused_matmul.py`), and its fully sharded
step (`fsdp.FSDPTrainer`).  The model takes the JAX package's memory
levers: the chunked head (`head="hidden"` with `lm_loss_chunked`,
`ops/chunked_ce.py`), dropout and remat "dots".  The kernel sources are in
`ops/csrc/`.

Entry points run on the card unless the caller passes `device="cpu"`; on
the CPU every kernel wrapper runs its plain PyTorch version instead.
"""
