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
`ops/chunked_ce.py`), dropout and remat "dots".  KungFu's adaptive
optimizers run on the same trainer: SMA with a model per rank
(`DataParallelTrainer(per_replica_params=True)` with
`optimizers.synchronous_averaging`), AdaptiveSGD (`optimizers.adaptive_sgd`),
the gradient-noise-scale and variance monitors and noise-driven
compression (`optimizers.gradient_noise_scale`, `gradient_variance`,
`noise_adaptive_compression`), driven by `DataParallelTrainer.fit` with
policies (`policy.py`, `variables.py`), journaled by `monitor/journal.py`
and traced by `utils/trace.py`.  So does KungFu's gossip
(`optimizers.pair_averaging`, the pull through the shift kernel), and its
asynchronous host forms (`optimizers.HostPairAveraging`) over each rank's
p2p blob store (`store.py`, started by `peer.Peer`), averaging with the
native host library (`native.py`, built from the repository's `csrc/`).
The kernel sources are in `ops/csrc/`.  KungFu's collective runtime is
`session.Session` (every collective and strategy, the runtime strategy
and wire swap, its ring strategies on the ring kernels), started by
`peer.Peer`, with the topology planner in `plan/`, the scalar api below
(`api.py`: `init`, `current_rank`, `run_barrier`, `set_strategy`, ...)
and the torch interop of the reference (`kungfu_tpu_torch.torch`:
`all_reduce`, `broadcast_parameters`, `SynchronousSGDOptimizer`).

Entry points run on the card unless the caller passes `device="cpu"` (or
the launcher's `-platform cpu`); on the CPU every kernel wrapper runs its
plain PyTorch version instead.
"""

__version__ = "0.1.0"

# the scalar api (kungfu_tpu/__init__.py exports the same names), loaded on
# first use so that `import kungfu_tpu_torch` stays light
_API = (
    "init", "finalize", "current_rank", "current_cluster", "cluster_size",
    "current_local_rank", "current_local_size", "host_count", "detached", "uid",
    "run_barrier", "propose_new_size", "save_variable", "request_variable", "calc_stats",
    "log_stats", "egress_rates", "check_interference", "get_peer_latencies",
    "minimum_spanning_tree", "set_tree", "set_strategy", "get_variable", "set_variable",
)


def __getattr__(name):
    if name in _API:
        from . import api

        return getattr(api, name)
    if name == "DataParallelTrainer":
        from .train import DataParallelTrainer

        return DataParallelTrainer
    if name == "MeshTrainer":
        from .trainer import MeshTrainer

        return MeshTrainer
    if name == "FSDPTrainer":
        from .fsdp import FSDPTrainer

        return FSDPTrainer
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
