#!/usr/bin/env python3
"""Smoke run of the PyTorch port (kungfu_tpu_torch) on one NVIDIA H100.

    python3 chip_smoke.py [--steps 5] [--batch 8] [--seed 0] [--rank-steps 3]
                          [--bucket-mib 256]

Phases, each of which ends the run with a non-zero exit if it fails:

 1. device   the card's name and power limit (nvidia-smi), torch's view
 2. build    every CUDA kernel of the main path, built from csrc/ with nvcc
             (flash attention and the ring collectives), before any rank
             starts
 3. kernels  each flash kernel against its plain PyTorch version at the
             flagship attention shape (B=8, H=16, L=2048, D=64, bf16,
             causal), plus the ragged L=2000, window=256 and non-causal
             cases, head dims 16, 128 and 8 (in the kernels) and 12
             (padded to 16 by the wrappers) at B=2 (16 and 128 at the GQA
             shape too),
             and the backward (B2, B3) with a non-zero lse
             cotangent, causal and not, against the plain blocked
             backward (ring attention's full hops and merges); times of
             kernel, plain version and the library call
             (scaled_dot_product_attention, a yardstick the port never
             calls), and the least time the card could take (bound); then
             the same at the GQA flagship's shape (Hkv=8): the forward, dq
             and the GQA dk/dv kernel (B4) against the plain versions, a
             planted B4 fault (a 64-wide key block missing half its query
             rows) rejected, and B4's times (library: the GQA backward of
             scaled_dot_product_attention(enable_gqa=True))
 3b. wide    the wide flash family (head dims over 128, csrc/flash_wide.cu)
             against its plain versions (which split the work as its
             blocks do) by the same blockwise check: Gemma 2B's attention
             (B=1, H=8, Hkv=1, L=8192, D=256, bf16, causal: the forward,
             dq and the GQA dk/dv), the same with Hkv=8 (dk/dv without a
             group), D=192 causal, windowed and not; the three kernels'
             times at the Gemma-2B shape, the plain versions', SDPA's
             (a yardstick) and the bound; the Gemma shape in fp16 too;
             then a Gemma-2B-shaped model (d_model 2048, 8 heads of 256,
             one kv head, 2 layers) trains 3 steps on 8192 tokens: each
             wide kernel (and its B row) launched once per layer and
             step; the steady step (median of steps 2-3) beside the wide
             kernels' share of it
 4. check    a small f32 model: flash kernels against full attention on the
             same weights (loss and every gradient); then with dropout 0.1:
             train=False equals the model without dropout, train=True from
             generators of one seed gives one loss twice, another seed
             another loss
 5. main     the flagship GPT (vocab 32000, d_model 1024, 24 layers, 16
             heads, d_ff 4096, seq 2048, bf16, RoPE, causal) training with
             DataParallelTrainer + synchronous_sgd(AdamW(3e-4, (0.9, 0.95),
             wd 1e-4)) for a few steps on one repeated random batch of 8, in
             this process: the loss must be finite and fall, and each
             kernel must launch once per layer per step
 5b. chunked the flagship's row of 8 heads of 128 (config_gpt_mfu (8, False,
             True, 8); otherwise as phase main, batch 8): the dense head
             (2 steps), then head="hidden" with lm_loss_chunked (vocab
             blocks of 1024) under the same trainer for 3 steps, on the
             same weights (checksum) and sequences: loss finite and
             falling, the first step within 1e-3 of the dense head's, the
             peak memory at least 1.95 GiB (one f32 logits tensor) below
             the dense step's, B1-B3 once per layer per step; both step
             times and peaks; then one forward and backward under
             remat=True, remat_policy="dots" against remat=False on the
             same weights: the same loss and gradients (within 1e-6
             normwise; bit-equal expected) and a lower peak
 5c. cut-ref the flagship cut to CUT_LAYERS (8) of its 24 layers, full width,
             the same seed: its loss on phase main's 8 sequences in one
             process (forward only), the first-step reference of phases
             session, elastic, heal and controlplane, which run the flagship
             at that depth (their time is its state's bytes through the
             host and its tensors' count; the whole smoke fits 1200 s)
 6. gqa-ref  the GQA flagship (n_kv_heads=8, otherwise as phase main) with
             the same seed: its loss on the same 8 sequences in one process
             (forward only), its parameter count and gradient shapes
    ef       the error-feedback residual kernel (compression.error_feedback
             .residual_, csrc/ring.cu) against its plain version
             (compression.quant.residual on the card), bit for bit, int8 and
             fp8, at every gradient size of the GQA flagship and a ragged
             1,000,003; then grouped (residual_group_) over all 195 of its
             gradients: one launch, every gradient bit-equal to its own
             launch and to the plain version; the time of the step's
             grouped call, of a launch per gradient and of the largest
             gradient alone, the plain version's, and the bound
 7. ring     4 ranks started by `python -m kungfu_tpu_torch.run`, rank r on
             card r mod count (all four on a machine with one card), each
             running tools/ring_check: the ring reduce-scatter (B5) and
             all-gather (B6) kernels and their all-reduce against the
             stacked plain versions, bit for bit, in f32 at the flagship's
             gradient size, in bf16 at 64M values, in a ragged f32 case
             of 1,000,003 values and at every payload of phase fsdp (each
             flagship parameter padded to a multiple of 4: chunks of 256 to
             8,192,000 values a rank, below one 1024-value tile up to the
             embedding's), with planted faults rejected, and grouped
             (ring_reduce_scatter_group, ring_all_gather_group) at each of
             phase fsdp's 12 buckets, every tensor bit-equal to its stacked
             plain version, one launch a bucket, planted faults (a tensor
             shifted by a vector, a last value wrong, a hop left out)
             rejected; then the
             fused-codec kernels B7 (reduce-scatter) and B8 (all-gather)
             through fused_ring_all_reduce, int8 and fp8, at the GQA
             flagship's gradient size and at 1,000,003 values: bit-equal to
             the stacked plain version on every rank, B7 alone bit-equal
             to its plain reduce-scatter and B8 alone to its plain
             all-gather (planted faults: a stage's record left out, a
             scale wrong), within the JAX
             package's quantization tolerance of the exact sum, planted
             faults (a hop's scales dropped, a block's codes zeroed)
             rejected; their times (median of 5 calls, CUDA events), the
             plain versions' times, NCCL's where every rank has a card of
             its own, and the bound
 8. ranks    slice 2's main path: the same flagship GPT on 4 ranks started by
             the launcher, batch 2 each (the same 8 sequences as phase main),
             synchronous_sgd(adamw(3e-4, b1=0.9, b2=0.95), impl="pallas_ring",
             bucket_bytes=--bucket-mib MiB) for --rank-steps steps: loss
             finite and falling, the first step's loss within 1e-2 of phase
             main's, the replicas bit-identical after the last step (a
             checksum of every parameter's bits, gathered over the group),
             each flash kernel launched once per layer per step and each
             ring kernel once per bucket per step on every rank
 8b. adaptive KungFu's adaptive optimizers on the flagship, 4 ranks
             x batch 2 of phase main's 8 sequences, one launch running
             three runs in turn: (a) DataParallelTrainer(per_replica_params=
             True) with adaptive_sgd(torch.optim.SGD lr ADAPTIVE_SGD_LR,
             switch_step=2, alpha=0.1) under fit(steps=4, policies=[a
             probe]): the ranks' parameter checksums apart after steps 1
             and 2 and bit-identical after 3 and 4, loss finite and
             falling, the first within 1e-2 of phase main's, the probe saw
             4 before/after pairs, kungfu_trained_samples 4 x 8; (b)
             gradient_noise_scale over phase ranks' S-SGD (impl=
             "pallas_ring", --bucket-mib buckets), --rank-steps steps:
             every loss bit-equal to phase ranks', the noise scale finite,
             replicas bit-identical, B5/B6 once a bucket a step; (c)
             noise_adaptive_compression(adamw, int8) for 3 steps
             (compression.all_reduce over gloo on CUDA tensors): compressed
             every step, the noise scale finite from step 2, replicas
             bit-identical, the first loss within 1e-2 of phase main's;
             B1-B3 once a layer a step in every run; each run's steady
             step, tokens/s and peak memory per rank
 8c. gossip KungFu's gossip (AD-PSGD pair averaging) on the flagship, 4
             ranks x batch 2 of phase main's 8 sequences, one launch
             running its runs in turn, per replica
             (DataParallelTrainer(per_replica_params=True)) at SGD lr
             ADAPTIVE_SGD_LR: (a) pair_averaging(SGD), random selector,
             GOSSIP_STEPS steps:
             each step every rank pulls rank + s's parameters, packed into
             chunks of at most 256 MiB, each chunk one B11 call: the ranks'
             parameter checksums distinct after step 1, every received
             buffer bit-equal to what the partner sent (a digest that
             depends on each word's place, made on the card and gathered
             over the group; a planted swap of two 128 KiB blocks changes
             it), the largest chunk the one phase shift holds against
             torch.roll, one shift a step on every rank, loss finite
             and falling, the first within 1e-2 of phase main's, B11
             launched once a chunk a step (the chunks counted from the
             parameters' sizes) and B1-B3 once a layer a step; (b) the
             same with compression="int8": codes and scales, each chunk's
             pair one B11 call, bit-equal to the partner's; (c)
             HostPairAveraging, then OverlappedHostPairAveraging, over the
             ranks' TCP blob stores (peer.Peer, store.py), HOST_GOSSIP_STEPS
             steps each: every pulled
             blob bit-equal (checksum) to a blob its owner published, the
             loss finite, no ring kernel; each run's steady step, tokens/s
             and peak memory per rank
 8d. session KungFu's Session (session.py) on 4 ranks started by `python -m
             kungfu_tpu_torch.run -strategy PALLAS_RING`, so the launcher's
             strategy reaches each rank's Session through env.Config; each
             rank the flagship cut to CUT_LAYERS layers, batch 2 of phase
             main's 8 sequences:
             (a) the torch interop (kungfu_tpu_torch.init, then
             kungfu_tpu_torch.torch.broadcast_parameters of a model made
             from seed + rank): Session.consensus true on every parameter,
             false after a one-bit flip on rank 1; SynchronousSGDOptimizer(
             SGD lr ADAPTIVE_SGD_LR) for SESSION_STEPS steps, one Session
             all_reduce a gradient: the first loss (the ranks' mean) within
             1e-2 of phase cut-ref's, the loss falling, the replicas agreeing
             after every step (consensus on the parameters' position
             digests), B5 and B6 once a gradient a step (195), no B7/B8,
             B1-B3 once a layer a step, every gradient's span tagged
             ring_kernels; (b) set_strategy(PALLAS_RING_FUSED) and
             set_compression("int8") on every rank, SWAP_STEPS more steps:
             B7 and B8 195 times a step, no B5/B6, the replicas agreeing,
             the loss finite, the spans tagged fused_ring_kernels; (c) this
             rank's gradients of one more backward: the embedding, a 1024 x
             1024 projection and a LayerNorm scale each through B5/B6 and
             B7/B8 (int8), bit-equal to the stacked plain versions fed with
             the ranks' inputs gathered by Session.all_gather;
             group_all_reduce of all 195 gradients in 256 MiB buckets
             bit-equal to an all_reduce each, B5 and B6 once a segment_plan
             run; reduce, broadcast, gather, max, min, prod (the one-shot),
             barrier, and cross_all_reduce and the hierarchical all-reduce
             on a 2 x 2 ("dcn", "ici") mesh, on 4 MB tensors, each equal to
             the answer every rank computes from the seed; each part's
             steady step, the ranks' calc_stats()
 8e. elastic KungFu's elastic resize on the flagship cut to CUT_LAYERS
             layers (otherwise phase ranks' model,
             batch 2 a rank of phase main's 8 sequences through
             datasets.ElasticDataAdaptor): `python -m kungfu_tpu_torch.run
             -w -np 4` with its embedded config server runs
             elastic.run_elastic with make_tx = synchronous_sgd(adamw(3e-4,
             b1=0.9, b2=0.95), impl="pallas_ring", bucket_bytes=--bucket-mib
             MiB), schedule ELASTIC_SCHEDULE (4 ranks, then 2: ranks 2 and 3
             detach, then 4: two joiners from fresh init), check_every 2,
             ELASTIC_SAMPLES samples, checkpoints every 3 steps into a
             temporary directory: the launcher exits 0; four RESULT lines
             with trained=40 and final_size=4, the survivors' resizes=2;
             two DETACHED lines; each survivor's two resize events with
             every phase; the joiners' parameter checksums after the grow's
             sync equal to rank 0's; the four ranks' checksums bit-identical
             after the last step; the first loss within 1e-2 of phase
             cut-ref's, every loss finite; B1-B3 once a layer and B5/B6 once a
             bucket in every step on every rank (the first after each
             resize too); no ring workspace left when each new group forms;
             each group's rendezvous at peer.coordinator_port(root port,
             version); then, in this process, restore_latest_verified gives
             the last step with rank 0's final checksum, and a byte flipped
             in a leaf file of that step is demoted and the step before it
             restored and verified; each resize's phase times, each
             joiner's resume from the checkpoints at its start, the steady
             step at 4 ranks and the step after step 3's save at 2 (the
             schedule leaves no steady step there), each save's time
 8f. heal   KungFu's self-healing on the flagship cut to CUT_LAYERS layers
             (otherwise phase ranks' model and
             S-SGD, batch 2 a rank): `python -m kungfu_tpu_torch.run -w
             -heal -np 4 -restart-budget 1` (its restart backoff
             HEAL_BACKOFF_S through this script's launcher wrapper) runs
             elastic.run_elastic under KFT_FAULT_PLAN=HEAL_PLAN (launch
             rank 2 exits 41 at the top of step 4), KFT_RING_TIMEOUT_S
             HEAL_RING_TIMEOUT_S, snapshots every HEAL_SNAPSHOT_EVERY steps
             shipped to the buddy, a checkpoint directory: the survivors'
             B5 gives up on the dead neighbour, they climb the recovery
             ladder, tear the group down without it, rejoin at 3 ranks and
             sync; their second 3-rank step waits for the document of the
             runner's regrow (after the backoff), so the next resize check
             takes it and the victim joins as at 4; the launcher's own
             KFT_INIT_TIMEOUT_S for heal-armed workers. Gates: the victim's exit 41, the runner's one
             heal 4 -> 3 and the regrow; each survivor one heal event with
             every phase, its rung and source, its parameters after the
             heal's sync bit-equal to the source it named and to each
             other; one B5 + B6 all-reduce of an integer-valued f32
             payload on the 3-rank group bit-equal to its stacked plain
             version, no workspace left unreaped; the joiner bit-equal to
             rank 0 after its sync; the replicas bit-identical at the end
             at 4 ranks, HEAL_SAMPLES trained; B1-B3 once a layer and B5/B6
             once a bucket in every completed step; every group at its
             fenced port with no workspace at its rendezvous; losses
             finite, the first within 1e-2 of phase cut-ref's. Prints each
             heal phase, mttr_s, each buddy ship's time or miss, the dead
             group's workspace bytes freed and left mapped, the survivors'
             wait for the regrow, the regrow's times, steady steps, host
             peaks and the phase's time
 9. gqa      slice 3's main path: the GQA flagship on 4 ranks x batch 2,
             synchronous_sgd(adamw(3e-4, b1=0.9, b2=0.95), impl="pallas_ring",
             compression="int8", bucket_bytes=--bucket-mib MiB) with
             error feedback, --rank-steps steps: loss finite and falling, the
             first step's loss within 1e-2 of phase gqa-ref's, the replicas
             bit-identical, B1, B2 and B4 launched once per layer per step,
             B7 and B8 once per bucket per step, the residual kernel once
             a step (one table of the 195 gradients), B3, B5 and B6 never
10. shift    4 ranks through the launcher, each running tools/shift_check:
             the ring shift kernel (B11) bit-equal to its stacked plain
             version (torch.roll over the ranks' payloads) on a K/V pair of
             one ring-attention hop (2 x [2, 2048, 16, 64] bf16, 16.8 MB) at
             shift +1 and -1, on an odd byte count at +1 and +2, on the
             gossip pull's largest chunk (GOSSIP_SHIFT_BYTES of uint8) at
             -1 and -2 and on an int8 pull's pair of that many uint8 codes
             and an f32 scale a block of 256 at -1, then
             interleaved with B5-B8 calls of other sizes; planted faults (a
             pair shifted the wrong way, a 16-byte vector corrupted)
             rejected; the pair on the side stream beside a flash forward
             of ring attention's block shape on the current stream (both
             bit-equal to their results alone) and at grids of 8, 16, 32
             and 66 blocks (bit for bit); its time per call (median of 20),
             the wrapper's issue, at each grid, beside the flash call, the
             plain version's, NCCL's batch_isend_irecv where every rank has
             a card of its own, and the bound
11. sp-ref   the flagship at 8192 positions (max_len 8192) on the 2
             sequences of phase sp, in one process with flash attention
             over the whole sequence, forward only: the first-step loss
12. sp       slice 4's main path: the 8192-position flagship on 4 ranks
             as a mesh of dp=1 x sp=4 (each rank 2048 positions of both
             sequences), attention="ring" (K/V rotating through B11, each
             hop's block on B1-B3), MeshTrainer with adamw(3e-4, b1=0.9,
             b2=0.95) and the gradient sum under impl="pallas_ring" (B5,
             B6, --bucket-mib buckets), 3 steps (SP_STEPS): loss finite and
             falling, the first step's loss within 1e-2 of phase sp-ref's,
             the replicas bit-identical, B11 launched 2 x 3 x 24 = 144 times
             a step on every rank, every one on the workspace's side stream
             (each hop's rotation issued before the previous hop's flash
             block, its backward on the same stream), and B1, B2 and B3 24 x (r + 1) times on
             rank r (the causal ring skips the blocks of later ranks), B5
             and B6 once per bucket; the slowest rank's step time, tokens/s
             and peak memory per rank
12b. ulysses slice 21's sequence-parallel path: the same 8192-position
             flagship on 4 ranks as dp=1 x sp=4 with attention="ulysses"
             (each rank's 2048 positions resharded by all_to_all to 4 of
             the 16 heads over the whole sequence and back: NCCL with a
             card a rank, gloo through the host where the ranks share one;
             the head group's attention on B1-B3), MeshTrainer as phase sp,
             run by phase sp's rank processes after its steps (no second
             start-up). Before (a) and (c) each rank holds one layer's
             attention at their heads (2 x 8192, 16 heads of 64; 8 kv heads
             for (c)) against flash over the gathered sequence: its chunk's
             output and dq, dk, dv within the bf16 gate of the flash kernels
             (tools/ulysses_check). (a) the dense head, 3 steps
             (ULYSSES_STEPS): loss finite and falling, the first within
             1e-2 of phase sp-ref's, the replicas bit-identical, B1, B2 and
             B3 24 times a step on every rank (no B11), B5 and B6 once per
             bucket; (b) head="hidden" (lm_loss_shard_chunked) for one step
             on the same weights: its loss within 1e-3 of (a)'s first; (c)
             GQA (8 kv heads, 2 a rank) for one step: B4 24 times in place
             of B3; each part's step time and peak memory per rank, (a)'s
             tokens/s
13. fused    B9's and B10's product body alone on this card (tools/fused_time:
             `mm_product` at the per-hop and per-rank shapes below, against
             the f32 product, timed beside torch.matmul and the bound), then
             4 ranks through the launcher, each running tools/fused_check:
             the all-gather-matmul (B9) and matmul-reduce-scatter (B10)
             kernels against their stacked plain versions at the flagship
             FSDP step's MLP shapes in bf16 (B9: x [4096, 1024] @ W_in
             [1024, 4096] from shards of [256, 4096]; B10: activations^T
             [1024, 4096] @ dy [4096, 4096], each rank its [256, 4096] rows)
             and in f32 at 24 x (4 x 40) x 72 and 24 x 40 x 72: integer-valued
             operands bit for bit, random ones within the normwise bf16 / f32
             limit; planted faults (a shard consumed twice, a partial
             dropped) rejected; their times (wall time of all ranks' calls on
             a shared card, the event median on cards of their own), the
             plain versions', the unfused NCCL arm where every rank has a
             card, and the bound
14. fsdp     this slice's main path: the flagship on 4 ranks as
             make_mesh(fsdp=4), FSDPTrainer (every parameter chunked 4 ways,
             gathered through the ring all-gather B6 each step and its
             gradient reduce-scattered through B5, one grouped launch a
             bucket of parameters), batch 2 a rank of phase main's 8
             sequences, adamw(3e-4, b1=0.9, b2=0.95), 3 steps (FSDP_STEPS):
             loss finite and falling,
             the first within 1e-2 of phase main's and every step's within
             1e-2 of phase ranks' (the same S-SGD arithmetic), memory after
             init at most 0.3 of a replica's parameters and Adam state and
             after step 1 (AdamW's moments made) at most 0.3 of those and
             its gradients, B6
             and B5 launched once per bucket (12 of the 195 parameters) a
             step, B1-B3 once per layer, no other kernel; the slowest
             rank's step time, tokens/s,
             peak memory per rank
14b. controlplane KungFu's replicated control plane: (a) `python -m
             kungfu_tpu_torch.chaos --coordinator-drill --replicas 3` (CAS
             and KV traffic through a leader SIGKILL and a leader SIGSTOP)
             holds every invariant, its summary printed (started after the
             build, beside the one-process phases); (b) the flagship cut to
             CUT_LAYERS layers (otherwise phase ranks' model and S-SGD, batch
             2 a rank) on 4 ranks under
             `python -m kungfu_tpu_torch.run -w -np 4 -config-replicas 3`
             through this script's launcher wrapper, which holds the
             ensemble: run_elastic with schedule CP_SCHEDULE, the leader
             SIGKILLed once step 2 is done, rank 0's shrink 4 -> 2 proposed
             through the failover client (KFT_CONFIG_URLS) after the next
             leader is up, landing at step 4, the run ending at step 6.
             Gates: the launcher's exit 0, the epoch moved, leader_elected
             and replica_respawned journaled, the respawned replica at the
             leader's commit, rank 0's proposal committed, every rank given
             the 3 URLs, the 2 survivors bit-identical, B1-B3 once a layer
             and B5/B6 once a bucket in every step on every rank, losses
             finite, the first within 1e-2 of phase cut-ref's; the
             election's and the shrink's times
14c. mesh    tensor, expert and pipeline parallelism: the flagship cut to
             CUT_LAYERS layers at full width (weights from the seed as
             phase cut-ref makes them, cut to each rank's shards by the
             rules table, convert.shard_state_dict), phase main's 8
             sequences, MeshTrainer(adamw(3e-4, b1=0.9, b2=0.95),
             impl="pallas_ring", --bucket-mib buckets over the data
             group), one launch of 4 ranks running three parts in turn, 3
             steps each: (a) dp=2 x tp=2 (Megatron: 8 heads, 2048 d_ff
             columns and 16000 vocab rows a rank, the vocab-parallel
             cross entropy); (b) dp=2 x ep=2 with 4 experts (2 a rank),
             every second block MoE, capacity factor 1.25,
             lm_loss_shard_with_aux, after rank 0 computes the
             one-process MoE model's lm_loss_with_aux on all 8 sequences
             (forward only); (c) pp=4, PipelinedLM with R=2 rounds and M=4
             microbatches of 2 sequences, remat.  Gates: losses finite
             and falling, the first within 1e-2 of phase cut-ref's (a, c)
             or of rank 0's MoE model (b), the ranks that hold one shard
             of a parameter bit-identical element by element
             (`initializer.sync_check`: the tp pairs' norm scales, the
             dp pairs' shards, the stages' embedding and head), exact
             launches on every rank: (a), (b) B1-B3 once a layer a step
             and B5/B6 once a bucket a step over the dp group; (c) B1
             twice (remat) and B2, B3 once a layer group a step (R M = 8
             groups of one block a stage), B11 once a hop, 10 hops
             forward and 10 backward a step (11 ticks; no hop after the
             last), no B5/B6.  Printed: each part's steady step, tokens/s
             and peak memory per rank, the tp all-reduces' route, MoE's
             dropped share and aux loss, the pipeline's idle ticks by
             the schedule (3 of 11)
15. report   one JSON line of kernels B1-B11, the wide flash family and the
             residual kernel (launches from rank 0 of the path that runs
             each: phase ranks for B1-B3, B5, B6, phase sp for B11, phase
             fused for B9 and B10, phase wide's model step for the wide
             family, phase gqa for the others; B11's entry also holds its
             launches in phase sp, in phase gossip (a) and (b) and in
             phase mesh, `launches_by_phase`; B5 and B6 theirs in phases
             ranks, session, elastic, heal, ulysses, controlplane and mesh,
             B1-B3 theirs in phases ranks, elastic, heal, ulysses,
             controlplane and mesh, B4
             in phases gqa and ulysses, B7 and B8 in phases gqa and
             session), each
             phase's time and the whole smoke's, then the last line {"ok":
             true, "device": {"platform": "gpu", ...}}

A rank that fails fails the run: the parent prints the ranks' output and
exits non-zero.  f32 products on the card run in full f32: TF32 is switched
off for matmuls and cuDNN in every process.  Imports nothing of JAX, and
every rank checks that too.  Without a CUDA device, or without the package
beside it, it exits non-zero before printing a result.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import re
import statistics
import subprocess
import sys
import time

import torch
import torch.nn.functional as F

HERE = os.path.dirname(os.path.abspath(__file__))

# Published H100 SXM peaks at 700 W (NVIDIA data sheet): dense bf16/fp16
# tensor-core rate and HBM3 bandwidth.
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float16: 989e12, torch.float32: 67e12}
PEAK_BYTES_PER_S = 3.35e12

# Kernel vs plain: each output's normwise relative error, worst over 64-row
# blocks, against kungfu_tpu_torch.utils.compare.REL_LIMIT (bf16 1e-2: a
# few bf16 roundings of P, dS and the output read about 3e-3, a dropped key
# or query block 0.09 or more); lse to LSE_ATOL absolute.
# The f32 model check: same f32 products in another order through two
# layers; loss to 1e-4 absolute, each gradient to a normwise relative
# error of 1e-5.
TOL_MODEL_LOSS = 1e-4
TOL_MODEL_GRAD = 1e-5
# Phase ranks against phase main, first step (no update yet): the same
# weights and sequences, the loss averaged over 4 shards instead of taken
# over one batch of 8, so only bf16 products of other shapes differ.
TOL_RANKS_LOSS = 1e-2
# Phase sp against phase sp-ref, first step: the same weights and
# sequences; ring attention merges four blocks per row in f32 where the
# one-process flash kernel folds them in one pass, the loss a sum of four
# shares, and the bf16 products take other shapes.
TOL_SP_LOSS = 1e-2
# Phase fsdp against phases main (first step) and ranks (every step): the
# same weights, sequences and AdamW; the gradients reduce-scattered per
# parameter chunk instead of all-reduced per bucket, so only the order of
# f32 sums and the shapes of bf16 products differ.
TOL_FSDP_LOSS = 1e-2
# Phase fsdp's memory against a replica's: after init against its f32
# parameters and two Adam moments (sharded 4 ways a rank holds 1/12 of
# those, its parameter chunks), after step 1 against its parameters,
# gradients and moments (sharded: 1/4, the chunks of all four; moments
# that were not sharded would make it 5/8).
FSDP_MEMORY_SHARE = 0.3
# Phase chunked: the chunked head's first-step loss against the dense
# head's on the same weights and sequences (the same f32 log-softmax,
# streamed over 1024-column blocks: f32 sums in another order over 16,376
# positions, about 1e-6); its peak at least one f32 logits tensor
# [8, 2048, 32000] (1.95 GiB) below the dense step's; remat "dots" against
# no remat, loss and every gradient's normwise relative error within 1e-6
# (the recompute repeats the same kernels on the same inputs, so bit-equal
# is expected; a bf16 rounding that differed would read 4e-3).
TOL_CHUNKED_LOSS = 1e-3
CHUNKED_SAVING = int(1.95 * 2**30)
TOL_REMAT = 1e-6
CHUNKED_STEPS = 3
WIDE_STEPS = 3  # phase wide: the Gemma-2B-shaped model's steps (steady: 2 and 3)
# Phase check's dropout: two forwards from generators of one seed, and
# train=False against the model without dropout, repeat the same kernels
# on the same inputs (bit-equal expected; the limit is 1e-6 absolute on a
# loss near log 512); another seed moves the loss by far more than 1e-4.
TOL_DROPOUT_SAME = 1e-6
DROPOUT_MOVES = 1e-4
FSDP_STEPS = 3  # phase fsdp: each step makes 24 ring calls (a card switch each on one card)
N_RANKS = 4
# Phases session, elastic, heal and controlplane: the flagship at full width
# cut to this depth, against phase cut-ref's loss at the same depth (their
# costs are its state's bytes through the host and its tensors' count:
# the whole smoke must fit 1200 s)
CUT_LAYERS = 8
# Phase mesh: the flagship at full width cut to CUT_LAYERS layers on the
# model axes, one launch of N_RANKS ranks running its parts in turn: (a)
# dp=2 x tp=2, (b) dp=2 x ep=2 with MESH_EXPERTS, (c) pp=4 with MESH_PIPE
# (repeats R, microbatches M).  First losses against phase cut-ref's (a,
# c) and rank 0's one-process MoE model (b): the same weights and
# sequences, the bf16 products of other shapes, the loss a sum of shares
# (a: the vocab-parallel cross entropy's max, exponentials and target
# logit reduced over tp in f32; c: the f32 LayerNorm of PipelinedLM).
MESH_LINE = "MESH_RESULT "
MESH_STEPS = 3
MESH_PARTS = (("tp", {"dp": 2, "tp": 2}), ("ep", {"dp": 2, "ep": 2}), ("pp", {"pp": 4}))
MESH_EXPERTS = {"n_experts": 4, "moe_every": 2, "capacity_factor": 1.25}
MESH_PIPE = (2, 4)
TOL_MESH_LOSS = 1e-2
SP_BATCH, SP_SEQ = 2, 8192  # phase sp: 16,384 tokens a step, 2048 positions a rank
SP_STEPS = 3  # phase sp: a few steps at full depth (each shift costs a card switch)
SHIFT_GRIDS = "8,16,32,66"  # phase shift: B11's grids checked and timed
RANKS_LINE = "RANKS_RESULT "
ADAPTIVE_LINE = "ADAPTIVE_RESULT "
# Phase adaptive: run (a)'s AdaptiveSGD, two SMA steps, the switch and one
# S-SGD step, on torch.optim.SGD at a rate at which the flagship's loss
# falls on each replica's rows before the switch and on the global batch
# after it; run (c)'s steps.
ADAPTIVE_STEPS = 4
ADAPTIVE_SWITCH = 2
ADAPTIVE_SGD_LR = 0.1
NAC_STEPS = 2
GOSSIP_LINE = "GOSSIP_RESULT "
# Phase gossip: the steps of runs (a) and (b), at phase adaptive's SGD rate
# (the loss falls on each replica's rows, mixed with its partner's model
# each step), and of each host run (c), 10-18 s a step on one card: cut to
# 2 to keep the whole smoke within 150 s of its length before the phase.
GOSSIP_STEPS = 3
HOST_GOSSIP_STEPS = 2
# Phase gossip: the bytes of the flagship's largest packed chunk of an
# uncompressed pull (phase gossip checks it; phase shift holds B11 there).
GOSSIP_SHIFT_BYTES = 265314304
DIGEST_ROW = 1 << 14  # int32 words a row of a gossip chunk's position digest
SP_LINE = "SP_RESULT "
ULYSSES_LINE = "ULYSSES_RESULT "
ULYSSES_STEPS = 3  # phase ulysses (a): the dense head's steps (steady: 2 and 3)
ULYSSES_GQA_HEADS = 8  # phase ulysses (c): kv heads, split 2 a rank over sp=4
FSDP_LINE = "FSDP_RESULT "
SESSION_LINE = "SESSION_RESULT "
ELASTIC_LINE = "ELASTIC_RESULT "  # a rank that trained to the end
ELASTIC_LEFT = "ELASTIC_LEFT "  # a rank that detached, at its exit
ELASTIC_SCHEDULE = "4:2,2:2,4:2"
ELASTIC_SAMPLES = 40  # 6 steps: 2 at 4 ranks, 2 at 2, 2 at 4 (batch 2 a rank)
ELASTIC_CKPT_EVERY = 3
ELASTIC_TIMEOUT = 540  # the phase's own limit (the launcher's -timeout)
HEAL_LINE = "HEAL_RESULT "  # a worker of phase heal that trained to the end
CP_LINE = "CONTROLPLANE_RESULT "  # a worker of phase controlplane that trained to the end
CP_LEFT = "CONTROLPLANE_LEFT "  # a worker of phase controlplane that detached, at its exit
CP_RUNNER = "CONTROLPLANE_RUNNER: "  # the launcher's record of the ensemble's failover
CP_REPLICAS = 3
CP_SCHEDULE = "4:4,2:2"  # rank 0 proposes the shrink at the top of step 4
CP_SAMPLES = 40  # 6 steps: 4 at 4 ranks, 2 at 2 (batch 2 a rank)
CP_KILL_AT = 2  # the launcher SIGKILLs the ensemble's leader once step 2 is done
CP_SHRINK_AT = 4  # rank 0's proposal (after the election) and the shrink, at step 4
CP_TIMEOUT = 300  # the phase's own limit (the launcher's -timeout)
HEAL_PLAN = "crash@step=4:rank=2"  # launch rank 2 exits 41 at the top of step 4
# KFT_RING_TIMEOUT_S in phase heal, the survivors' detect time: above the
# skew a buddy ship puts between the ranks (6-15 s a 4.11 GiB ship)
HEAL_RING_TIMEOUT_S = 20
# WatchRunner's restart backoff (the JAX package's 2 s has no flag; the
# runner caps a delay at 60 s, with +-20% jitter): the survivors detect the
# crash only when B5 gives up (HEAL_RING_TIMEOUT_S), so at 2 s the regrow's
# document would land first and the heal would go 4 -> 4 with the joiner,
# leaving no 3-rank group; at 60 s they have taken the 3-rank document
HEAL_BACKOFF_S = 60.0
# 4 steps at 4 ranks, 2 at 3 (the survivors' second 3-rank step holds until
# the regrow's document is up, and the check at step 6 takes it), then 4 at 4
HEAL_SAMPLES = 72
HEAL_SNAPSHOT_EVERY = 4  # two snapshots before the crash: the seed and step 4's
HEAL_CKPT_EVERY = 100  # no periodic save: the heal's recovery save and the last one
HEAL_CHECK_EVERY = 3  # the resize checks: step 4, where the crash lands, is none
HEAL_TIMEOUT = 600  # the phase's own limit (the launcher's -timeout)
# Phase session: (a) the interop S-SGD's steps under PALLAS_RING, (b) the
# steps after the swap to PALLAS_RING_FUSED with int8, each at phase
# adaptive's SGD rate; (c)'s bucket and the size of its small collectives
# (4 MB of f32 a rank).
SESSION_STEPS = 2
SWAP_STEPS = 2
SESSION_BUCKET = 256 << 20
SESSION_SMALL = 1 << 20


class SmokeFailure(Exception):
    pass


def check(ok: bool, what: str) -> None:
    if not ok:
        raise SmokeFailure(what)


def time_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean device time of fn() over `iters` back-to-back calls (CUDA events)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def max_err(got, want) -> float:
    return (got.float() - want.float()).abs().max().item()


def tf32_off() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def jax_free() -> bool:
    return not any(m.split(".")[0] in ("jax", "kungfu_tpu") for m in sys.modules)


def spawn_ranks(worker_args, tag: str, timeout: float, launcher_args=(), env=None):
    """This script in rank mode on N_RANKS ranks, started by the launcher
    (`launcher_args` its flags, `env` added to the ranks' environment);
    {rank: its `tag` line}.  A failed rank fails the phase, with the
    ranks' output."""
    from kungfu_tpu_torch.tools import ring_check

    torch.cuda.empty_cache()  # the ranks share the card with this process
    print(f"[{worker_args[0]}] this process holds {torch.cuda.memory_reserved() / 2**30:.2f} GiB "
          f"of the card while {N_RANKS} ranks run")
    # expandable segments: less memory stranded between the ranks' allocations
    env = dict(os.environ, PYTORCH_CUDA_ALLOC_CONF="expandable_segments:True", **(env or {}))
    rc, out, results = ring_check.launch(
        N_RANKS, [*launcher_args, sys.executable, os.path.abspath(__file__), "--rank-phase",
                  *worker_args], env=env, timeout=timeout, tag=tag)
    if rc != 0 or sorted(results) != list(range(N_RANKS)):
        print(out[-12000:], file=sys.stderr)
        raise SmokeFailure(f"rank phase {worker_args[0]}: launcher exit {rc}, "
                           f"results from ranks {sorted(results)}")
    return out, results


# ----------------------------------------------------------------- phases --

def phase_device():
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()
    card = smi[0].strip()
    print(card)
    kind, count = torch.cuda.get_device_name(0), torch.cuda.device_count()
    print(f"[device] torch {torch.__version__} cuda {torch.version.cuda}: {kind} x{count}")
    tf32_off()
    print("[device] tf32 off for matmuls and cuDNN: f32 products run in full f32")
    try:  # where it covers the fixed ports (stores 25000+, rendezvous 30000+), binds wait
        with open("/proc/sys/net/ipv4/ip_local_port_range") as f:
            print(f"[device] ephemeral ports {'-'.join(f.read().split())}")
    except OSError:
        pass
    return card, kind, count


def phase_build():
    from kungfu_tpu_torch.ops import _build

    t0 = time.perf_counter()
    paths = _build.build_all()
    print(f"[build] {len(paths)} sources in {time.perf_counter() - t0:.1f} s "
          f"(per source: {json.dumps({k: round(v, 1) for k, v in _build.build_seconds.items()})})")
    for stem, path in sorted(paths.items()):
        log = open(path + ".log").read() if os.path.exists(path + ".log") else ""
        regs = [int(r) for r in re.findall(r"Used (\d+) registers", log)]
        spills = [int(s) for s in re.findall(r"(\d+) bytes spill stores", log)]
        if regs:
            print(f"[build] {stem}: {len(regs)} kernels, registers {min(regs)}-{max(regs)}, "
                  f"spill stores up to {max(spills or [0])} bytes")
        # the wide family's wgmma forward, kernel by kernel: it holds O across
        # the whole head dim in registers and must not spill
        for entry in log.split("Compiling entry function")[1:]:
            name = re.match(r" '(\S+)'", entry).group(1)
            if "mma10fwd_kernel" not in name:
                continue
            reg = int(re.search(r"Used (\d+) registers", entry).group(1))
            spill = int(re.search(r"(\d+) bytes spill stores", entry).group(1))
            dtype = "bf16" if "bfloat16" in name else "fp16"
            dp = re.search(r"fwd_kernelI\w+?Li(\d+)E", name).group(1)
            print(f"[build] {stem}: wgmma forward {dtype} DP={dp}: registers {reg}, "
                  f"spill stores {spill} bytes")
            check(spill == 0, f"the wgmma wide forward spills ({name}: {spill} bytes)")


def _pairs(L: int, causal: bool, window: int) -> int:
    """(query, key) pairs the attention computes (what this run's masks keep)."""
    if not causal:
        return L * L
    return sum(min(q + 1, window) if window else q + 1 for q in range(L))


def _bound(flops: float, nbytes: float, dtype):
    t_ops = flops / PEAK_FLOPS[dtype]
    t_bytes = nbytes / PEAK_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def phase_kernels(seed: int):
    from kungfu_tpu_torch.ops import flash
    from kungfu_tpu_torch.utils.compare import LSE_ATOL, REL_LIMIT, rel_errs

    B, H, D, dtype = 8, 16, 64, torch.bfloat16
    errs = {k.name: 0.0 for k in flash.KERNELS}
    gen = torch.Generator(device="cuda").manual_seed(seed)
    # (L, window, causal, batch, heads, head dim): the flagship's, then head
    # dims 16, 128 and 8 in the kernels, and 12 padded to 16 by the wrappers,
    # at batch 2; last the shape of phase chunked's row (8 heads of 128, a
    # full causal 2048: every query block over up to 32 key tiles)
    for L, window, causal, nb, h, d in (
            (2048, 0, True, B, H, D), (2000, 0, True, B, H, D), (2048, 256, True, B, H, D),
            (2048, 0, False, B, H, D), (2048, 0, True, 2, H, 16), (2000, 256, True, 2, H, 128),
            (2048, 0, True, 2, H, 8), (2000, 256, True, 2, H, 12), (2048, 0, True, B, 8, 128)):
        scale = d ** -0.5
        q, k, v, do = (torch.randn(nb, L, h, d, generator=gen, device="cuda").to(dtype)
                       for _ in range(4))
        o, lse = flash.flash_fwd(q, k, v, scale, causal, window)
        o_ref, lse_ref = flash._plain_fwd_blhd(q, k, v, scale, causal, window)
        delta = (o.float() * do.float()).sum(-1).transpose(1, 2).contiguous()
        dq = flash.flash_bwd_dq(q, k, v, do, lse, delta, scale, causal, window)
        dk, dv = flash.flash_bwd_dkv(q, k, v, do, lse, delta, scale, causal, window)
        dq_ref, dk_ref, dv_ref = flash._plain_bwd_blhd(q, k, v, do, lse, delta, scale,
                                                       causal, 128, window)
        torch.cuda.synchronize()
        case = f"B={nb} L={L} H={h} D={d} window={window}" + ("" if causal else " non-causal")
        limit = REL_LIMIT[dtype]
        rel = {}
        for name, got, want in (("o", o, o_ref), ("dq", dq, dq_ref), ("dk", dk, dk_ref),
                                ("dv", dv, dv_ref)):
            whole, worst = rel[name] = rel_errs(got, want)
            check(worst <= limit, f"{name} kernel vs plain at {case}: normwise relative "
                  f"error {whole:.3g}, worst 64-row block {worst:.3g} > {limit}")
        e_lse = max_err(lse, lse_ref)
        check(e_lse <= LSE_ATOL, f"lse at {case}: max abs err {e_lse:.4g} > {LSE_ATOL}")
        print(f"[kernels] {case}: normwise relative error (whole, worst 64-row block) "
              + ", ".join(f"{n} {w:.3g} {b:.3g}" for n, (w, b) in rel.items())
              + f" (bf16, limit {limit} on the worst block); lse max abs err {e_lse:.3g}")
        e = {"flash_fwd": max_err(o, o_ref), "flash_bwd_dq": max_err(dq, dq_ref),
             "flash_bwd_dkv": max(max_err(dk, dk_ref), max_err(dv, dv_ref))}
        print(f"[kernels] {case}: max abs err o {e['flash_fwd']:.3g} "
              f"dq {e['flash_bwd_dq']:.3g} dk/dv {e['flash_bwd_dkv']:.3g}")
        for name, x in e.items():
            errs[name] = max(errs[name], x)
        del o_ref, dq_ref, dk_ref, dv_ref

    # the backward with a non-zero lse cotangent, folded into delta (ring
    # attention differentiates its merges through lse): the kernels against
    # the plain blocked backward, both through the autograd dispatcher
    L, scale = 2048, D ** -0.5
    for causal in (True, False):
        q, k, v, do = (torch.randn(B, L, H, D, generator=gen, device="cuda").to(dtype)
                       for _ in range(4))
        g_lse = torch.randn(B, H, L, generator=gen, device="cuda")
        o, lse = flash.flash_fwd(q, k, v, scale, causal)
        got = flash._dispatch_bwd(q, k, v, o, lse, do, scale, causal, 128, g_lse, 0, None)
        want = flash._dispatch_bwd(q, k, v, o, lse, do, scale, causal, 128, g_lse, 0, "xla")
        torch.cuda.synchronize()
        case = f"L={L} lse cotangent" + ("" if causal else " non-causal")
        limit = REL_LIMIT[dtype]
        rel = {}
        for name, g, w in zip(("dq", "dk", "dv"), got, want):
            whole, worst = rel[name] = rel_errs(g, w)
            check(worst <= limit, f"{name} kernel vs plain at {case}: normwise relative "
                  f"error {whole:.3g}, worst 64-row block {worst:.3g} > {limit}")
        errs["flash_bwd_dq"] = max(errs["flash_bwd_dq"], max_err(got[0], want[0]))
        errs["flash_bwd_dkv"] = max(errs["flash_bwd_dkv"], max_err(got[1], want[1]),
                                    max_err(got[2], want[2]))
        print(f"[kernels] {case}: normwise relative error (whole, worst 64-row block) "
              + ", ".join(f"{n} {w:.3g} {b:.3g}" for n, (w, b) in rel.items())
              + f" (bf16, limit {limit}); max abs err dq {max_err(got[0], want[0]):.3g} "
              f"dk/dv {max(max_err(got[1], want[1]), max_err(got[2], want[2])):.3g}")
        del got, want

    # timing at the flagship shape (fresh inputs, causal, no window)
    L, window = 2048, 0
    q, k, v, do = (torch.randn(B, L, H, D, generator=gen, device="cuda").to(dtype)
                   for _ in range(4))
    o, lse = flash.flash_fwd(q, k, v, scale, True, window)
    delta = (o.float() * do.float()).sum(-1).transpose(1, 2).contiguous()
    ms = {
        "flash_fwd": time_ms(lambda: flash.flash_fwd(q, k, v, scale, True, window), 20),
        "flash_bwd_dq": time_ms(
            lambda: flash.flash_bwd_dq(q, k, v, do, lse, delta, scale, True, window), 20),
        "flash_bwd_dkv": time_ms(
            lambda: flash.flash_bwd_dkv(q, k, v, do, lse, delta, scale, True, window), 20),
    }
    plain_fwd = time_ms(lambda: flash._plain_fwd_blhd(q, k, v, scale, True, window), 3, 1)
    plain_bwd = time_ms(lambda: flash._plain_bwd_blhd(q, k, v, do, lse, delta, scale, True,
                                                      128, window), 3, 1)
    plain = {"flash_fwd": plain_fwd, "flash_bwd_dq": plain_bwd, "flash_bwd_dkv": plain_bwd}
    qt, kt, vt, dot = (x.transpose(1, 2).contiguous() for x in (q, k, v, do))
    lib_fwd = time_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True), 20)
    qg, kg, vg = (x.clone().requires_grad_() for x in (qt, kt, vt))
    out = F.scaled_dot_product_attention(qg, kg, vg, is_causal=True)
    lib_bwd = time_ms(lambda: torch.autograd.grad(out, (qg, kg, vg), dot, retain_graph=True),
                      10)
    library = {"flash_fwd": lib_fwd, "flash_bwd_dq": None, "flash_bwd_dkv": None}

    pairs = _pairs(L, True, window) * B * H
    elem = q.element_size()
    act = B * L * H * D * elem  # one [B, L, H, D] operand
    row = B * H * L * 4  # one f32 [B, H, L] vector
    work = {  # (matmul flops, bytes each input read once + each output written once)
        "flash_fwd": (4 * D * pairs, 4 * act + row),
        "flash_bwd_dq": (6 * D * pairs, 5 * act + 2 * row),
        "flash_bwd_dkv": (8 * D * pairs, 6 * act + 2 * row),
    }
    bounds = {n: _bound(f, b, dtype) for n, (f, b) in work.items()}
    for n in ms:
        lib = (f"; library scaled_dot_product_attention forward {lib_fwd:.3f} ms"
               if n == "flash_fwd" else f"; library SDPA backward (dq, dk, dv) {lib_bwd:.3f} ms")
        print(f"[kernels] {n}: {ms[n]:.3f} ms, plain {plain[n]:.3f} ms, bound "
              f"{bounds[n][0]:.4f} ms ({bounds[n][1]}: {work[n][0] / 1e9:.1f} GFLOP, "
              f"{work[n][1] / 1e6:.1f} MB), {work[n][0] / ms[n] / 1e9:.1f} TFLOP/s achieved "
              f"({100 * bounds[n][0] / ms[n]:.1f}% of the bound){lib}")
    print(f"[kernels] library scaled_dot_product_attention: forward {lib_fwd:.3f} ms, "
          f"backward (dq, dk, dv in one call) {lib_bwd:.3f} ms; plain backward computes dq, "
          f"dk and dv in one pass ({plain_bwd:.3f} ms)")
    return errs, ms, plain, library, bounds


def _dkv_fault(q, k, v, do, lse, delta, scale, dk, dv):
    """What a dk/dv kernel that left key block 0's query rows >= L/2 out
    would return: the plain dk, dv of those rows alone replaced."""
    from kungfu_tpu_torch.ops import flash

    L = q.shape[1]
    do, delta = do.clone(), delta.clone()
    do[:, L // 2:] = 0
    delta[:, :, L // 2:] = 0
    dk_late, dv_late = flash._plain_bwd_blhd(q, k, v, do, lse, delta, scale, True, 128, 0)[1:]
    dk_bad, dv_bad = dk.float().clone(), dv.float().clone()
    dk_bad[:, :64], dv_bad[:, :64] = dk_late[:, :64].float(), dv_late[:, :64].float()
    return dk_bad, dv_bad


def phase_kernels_gqa(seed: int):
    """B1, B2 and B4 at the GQA flagship's attention shape (Hkv=8)."""
    from kungfu_tpu_torch.ops import flash
    from kungfu_tpu_torch.utils.compare import LSE_ATOL, REL_LIMIT, rel_errs

    B, H, HKV, D, dtype = 8, 16, 8, 64, torch.bfloat16
    limit = REL_LIMIT[dtype]
    err = 0.0
    gen = torch.Generator(device="cuda").manual_seed(seed + 7)

    def inputs(L, nb=B, d=D):
        def rnd(h):
            return torch.randn(nb, L, h, d, generator=gen, device="cuda").to(dtype)

        return rnd(H), rnd(HKV), rnd(HKV), rnd(H)

    # the GQA flagship's shapes, then head dims 16 and 128 (ROADMAP C.1) at batch 2
    for L, window, nb, d in ((2048, 0, B, D), (2000, 0, B, D), (2048, 256, B, D),
                             (2048, 0, 2, 16), (2000, 256, 2, 128)):
        scale = d ** -0.5
        q, k, v, do = inputs(L, nb, d)
        o, lse = flash.flash_fwd(q, k, v, scale, True, window)
        o_ref, lse_ref = flash._plain_fwd_blhd(q, k, v, scale, True, window)
        delta = (o.float() * do.float()).sum(-1).transpose(1, 2).contiguous()
        dq = flash.flash_bwd_dq(q, k, v, do, lse, delta, scale, True, window)
        dk, dv = flash.flash_bwd_dkv(q, k, v, do, lse, delta, scale, True, window)
        refs = flash._plain_bwd_blhd(q, k, v, do, lse, delta, scale, True, 128, window)
        torch.cuda.synchronize()
        case = f"GQA B={nb} H={H} Hkv={HKV} L={L} D={d} window={window}"
        rel = {}
        for name, got, want in (("o", o, o_ref), ("dq", dq, refs[0]), ("dk", dk, refs[1]),
                                ("dv", dv, refs[2])):
            whole, worst = rel[name] = rel_errs(got, want)
            check(worst <= limit, f"{name} kernel vs plain at {case}: normwise relative "
                  f"error {whole:.3g}, worst 64-row block {worst:.3g} > {limit}")
        e_lse = max_err(lse, lse_ref)
        check(e_lse <= LSE_ATOL, f"lse at {case}: max abs err {e_lse:.4g} > {LSE_ATOL}")
        err = max(err, max_err(dk, refs[1]), max_err(dv, refs[2]))
        print(f"[kernels] {case}: normwise relative error (whole, worst 64-row block) "
              + ", ".join(f"{n} {w:.3g} {b:.3g}" for n, (w, b) in rel.items())
              + f" (bf16, limit {limit}); lse max abs err {e_lse:.3g}; dk/dv max abs err "
              f"{max(max_err(dk, refs[1]), max_err(dv, refs[2])):.3g}")
        if L == 2048 and not window and d == D:
            dk_bad, dv_bad = _dkv_fault(q, k, v, do, lse, delta, scale, refs[1], refs[2])
            worst = max(rel_errs(dk_bad, refs[1])[1], rel_errs(dv_bad, refs[2])[1])
            check(worst > limit, f"the check passed a planted B4 fault ({worst:.3g})")
            print(f"[kernels] {case}: planted B4 fault (key block 0 without query rows "
                  f">= L/2) rejected, worst block {worst:.3g} > {limit}")
        del o_ref, refs

    L, scale = 2048, D ** -0.5
    q, k, v, do = inputs(L)
    o, lse = flash.flash_fwd(q, k, v, scale, True)
    delta = (o.float() * do.float()).sum(-1).transpose(1, 2).contiguous()
    name = flash.FLASH_BWD_DKV_GQA.name
    ms = time_ms(lambda: flash.flash_bwd_dkv(q, k, v, do, lse, delta, scale, True), 20)
    plain = time_ms(lambda: flash._plain_bwd_blhd(q, k, v, do, lse, delta, scale, True, 128, 0),
                    3, 1)
    qt, kt, vt, dot = (x.transpose(1, 2).contiguous() for x in (q, k, v, do))
    qg, kg, vg = (x.clone().requires_grad_() for x in (qt, kt, vt))
    out = F.scaled_dot_product_attention(qg, kg, vg, is_causal=True, enable_gqa=True)
    lib = time_ms(lambda: torch.autograd.grad(out, (qg, kg, vg), dot, retain_graph=True), 10)
    pairs = _pairs(L, True, 0) * B * H
    elem = q.element_size()
    flops = 8 * D * pairs
    nbytes = (2 * B * L * H * D + 4 * B * L * HKV * D) * elem + 2 * B * H * L * 4
    bound = _bound(flops, nbytes, dtype)
    print(f"[kernels] {name} (B4) at B={B} H={H} Hkv={HKV} L={L} D={D} bf16 causal: "
          f"{ms:.3f} ms, plain backward (dq, dk, dv) {plain:.3f} ms, bound {bound[0]:.4f} ms "
          f"({bound[1]}: {flops / 1e9:.1f} GFLOP, {nbytes / 1e6:.1f} MB), "
          f"{flops / ms / 1e9:.1f} TFLOP/s achieved ({100 * bound[0] / ms:.1f}% of the bound); "
          f"library scaled_dot_product_attention"
          f"(enable_gqa=True) backward (dq, dk, dv in one call) {lib:.3f} ms")
    return {name: err}, {name: ms}, {name: plain}, {name: lib}, {name: bound}


def _flash_check(flash, case: str, q, k, v, do, scale, causal, window, limit):
    """Forward, dq and dk/dv against their plain versions at one shape:
    each output's blockwise normwise relative error within `limit`, lse
    within LSE_ATOL.  Returns {kernel name: max abs err} for the wide
    family."""
    from kungfu_tpu_torch.utils.compare import LSE_ATOL, rel_errs

    o, lse = flash.flash_fwd(q, k, v, scale, causal, window)
    o_ref, lse_ref = flash._plain_fwd_blhd(q, k, v, scale, causal, window)
    delta = (o.float() * do.float()).sum(-1).transpose(1, 2).contiguous()
    dq = flash.flash_bwd_dq(q, k, v, do, lse, delta, scale, causal, window)
    dk, dv = flash.flash_bwd_dkv(q, k, v, do, lse, delta, scale, causal, window)
    refs = flash._plain_bwd_blhd(q, k, v, do, lse, delta, scale, causal, 128, window)
    torch.cuda.synchronize()
    rel = {}
    for name, got, want in (("o", o, o_ref), ("dq", dq, refs[0]), ("dk", dk, refs[1]),
                            ("dv", dv, refs[2])):
        whole, worst = rel[name] = rel_errs(got, want)
        check(worst <= limit, f"{name} kernel vs plain at {case}: normwise relative "
              f"error {whole:.3g}, worst 64-row block {worst:.3g} > {limit}")
    e_lse = max_err(lse, lse_ref)
    check(e_lse <= LSE_ATOL, f"lse at {case}: max abs err {e_lse:.4g} > {LSE_ATOL}")
    errs = {flash.FLASH_WIDE_FWD.name: max_err(o, o_ref),
            flash.FLASH_WIDE_DQ.name: max_err(dq, refs[0]),
            flash.FLASH_WIDE_DKV.name: max(max_err(dk, refs[1]), max_err(dv, refs[2]))}
    print(f"[wide] {case}: normwise relative error (whole, worst 64-row block) "
          + ", ".join(f"{n} {w:.3g} {b:.3g}" for n, (w, b) in rel.items())
          + f" (limit {limit}); lse max abs err {e_lse:.3g}; max abs err "
          + ", ".join(f"{n} {e:.3g}" for n, e in errs.items()))
    return errs


def phase_wide(seed: int):
    """The wide flash family (head dims over 128, csrc/flash_wide.cu)
    against its plain versions at the Gemma-2B attention shape and others;
    its times, the plain versions', SDPA's and the bound; then a Gemma-2B-
    shaped model's training steps through the entry points, which must run
    on the wide kernels."""
    from kungfu_tpu_torch.ops import flash
    from kungfu_tpu_torch.tools.flash_time import WIDE_MODEL, wide_steps
    from kungfu_tpu_torch.utils.compare import REL_LIMIT

    dtype = torch.bfloat16
    gen = torch.Generator(device="cuda").manual_seed(seed + 13)
    errs = {kern.name: 0.0 for kern in flash.WIDE_KERNELS}

    def inputs(nb, L, h, hkv, d, dt=dtype):
        def rnd(heads):
            return torch.randn(nb, L, heads, d, generator=gen, device="cuda").to(dt)

        return rnd(h), rnd(hkv), rnd(hkv), rnd(h)

    # (B, L, H, Hkv, D, causal, window, dtype): Gemma 2B's attention (arXiv
    # 2403.08295: 8 heads of 256, one kv head) at 8192 positions, in bf16
    # and fp16, the same without a group (B3's path), then D = 192 causal,
    # windowed and not
    for nb, L, h, hkv, d, causal, window, dt in (
            (1, 8192, 8, 1, 256, True, 0, dtype), (1, 8192, 8, 1, 256, True, 0, torch.float16),
            (1, 8192, 8, 8, 256, True, 0, dtype), (2, 2048, 8, 2, 192, True, 0, dtype),
            (2, 2000, 8, 8, 192, True, 256, dtype), (1, 2048, 8, 1, 192, False, 0, dtype)):
        case = (f"B={nb} L={L} H={h} Hkv={hkv} D={d} window={window}"
                + ("" if causal else " non-causal") + f" {str(dt)[6:]}")
        for name, e in _flash_check(flash, case, *inputs(nb, L, h, hkv, d, dt), d ** -0.5,
                                    causal, window, REL_LIMIT[dt]).items():
            errs[name] = max(errs[name], e)
        torch.cuda.empty_cache()

    # times at the Gemma-2B shape
    nb, L, h, hkv, d = 1, 8192, 8, 1, 256
    scale = d ** -0.5
    q, k, v, do = inputs(nb, L, h, hkv, d)
    o, lse = flash.flash_fwd(q, k, v, scale, True)
    delta = (o.float() * do.float()).sum(-1).transpose(1, 2).contiguous()
    ms = {
        flash.FLASH_WIDE_FWD.name: time_ms(lambda: flash.flash_fwd(q, k, v, scale, True), 10),
        flash.FLASH_WIDE_DQ.name: time_ms(
            lambda: flash.flash_bwd_dq(q, k, v, do, lse, delta, scale, True), 10),
        flash.FLASH_WIDE_DKV.name: time_ms(
            lambda: flash.flash_bwd_dkv(q, k, v, do, lse, delta, scale, True), 10),
    }
    plain_fwd = time_ms(lambda: flash._plain_fwd_blhd(q, k, v, scale, True, 0), 1, 1)
    plain_bwd = time_ms(lambda: flash._plain_bwd_blhd(q, k, v, do, lse, delta, scale, True,
                                                      128, 0), 1, 1)
    plain = {flash.FLASH_WIDE_FWD.name: plain_fwd, flash.FLASH_WIDE_DQ.name: plain_bwd,
             flash.FLASH_WIDE_DKV.name: plain_bwd}
    qt, kt, vt, dot = (x.transpose(1, 2).contiguous() for x in (q, k, v, do))
    lib_fwd = time_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                                             enable_gqa=True), 5)
    qg, kg, vg = (x.clone().requires_grad_() for x in (qt, kt, vt))
    out = F.scaled_dot_product_attention(qg, kg, vg, is_causal=True, enable_gqa=True)
    lib_bwd = time_ms(lambda: torch.autograd.grad(out, (qg, kg, vg), dot, retain_graph=True), 5)
    library = {flash.FLASH_WIDE_FWD.name: lib_fwd, flash.FLASH_WIDE_DQ.name: None,
               flash.FLASH_WIDE_DKV.name: None}
    pairs = _pairs(L, True, 0) * nb * h
    act, kv = nb * L * h * d * 2, nb * L * hkv * d * 2  # bf16 [B, L, H, D], [B, L, Hkv, D]
    row = nb * h * L * 4
    work = {  # (matmul flops, bytes each input read once + each output written once)
        flash.FLASH_WIDE_FWD.name: (4 * d * pairs, 2 * act + 2 * kv + row),
        flash.FLASH_WIDE_DQ.name: (6 * d * pairs, 3 * act + 2 * kv + 2 * row),
        flash.FLASH_WIDE_DKV.name: (8 * d * pairs, 2 * act + 4 * kv + 2 * row),
    }
    bounds = {n: _bound(f, b, dtype) for n, (f, b) in work.items()}
    for n in ms:
        lib = (f"SDPA forward (enable_gqa) {lib_fwd:.3f} ms" if n == flash.FLASH_WIDE_FWD.name
               else f"SDPA backward (dq, dk, dv in one call, enable_gqa) {lib_bwd:.3f} ms")
        print(f"[wide] {n} at B={nb} H={h} Hkv={hkv} L={L} D={d} bf16 causal: {ms[n]:.3f} ms, "
              f"plain {plain[n]:.3f} ms, bound {bounds[n][0]:.4f} ms ({bounds[n][1]}: "
              f"{work[n][0] / 1e9:.1f} GFLOP, {work[n][1] / 1e6:.1f} MB), "
              f"{work[n][0] / ms[n] / 1e9:.1f} TFLOP/s achieved "
              f"({100 * bounds[n][0] / ms[n]:.2f}% of the bound); library {lib}")
    del q, k, v, do, o, lse, delta, qt, kt, vt, dot, qg, kg, vg, out
    torch.cuda.empty_cache()

    # the path: the Gemma-2B-shaped model (flash_time.WIDE_MODEL: Gemma 2B's
    # widths, 2 layers) trains WIDE_STEPS steps on one sequence of 8192 tokens
    for kern in flash.WIDE_KERNELS + flash.KERNELS:
        kern.launches = 0
    steps_ms, losses = wide_steps(WIDE_STEPS, seed)
    launches = {kern.name: kern.launches for kern in flash.WIDE_KERNELS + flash.KERNELS}
    check(all(map(math.isfinite, losses)), f"wide: non-finite loss {losses}")
    layers = WIDE_MODEL["n_layers"]
    want = dict.fromkeys(launches, layers * WIDE_STEPS)
    want[flash.FLASH_BWD_DKV.name] = 0  # one kv head: the dk/dv launches count for B4
    check(launches == want, f"wide: kernel launches {launches}, expected {want}")
    steady = statistics.median(steps_ms[1:])
    bwd = layers * (ms[flash.FLASH_WIDE_DQ.name] + ms[flash.FLASH_WIDE_DKV.name])
    fwd = layers * ms[flash.FLASH_WIDE_FWD.name]
    print(f"[wide] Gemma-2B-shaped model ({json.dumps(WIDE_MODEL)}, bf16), "
          f"{WIDE_STEPS} steps on 1 x {WIDE_MODEL['max_len']} tokens: losses "
          f"{', '.join(f'{x:.4f}' for x in losses)}; step times "
          f"{', '.join(f'{x:.1f}' for x in steps_ms)} ms (the first with its setup); steady step "
          f"{steady:.1f} ms (median of steps 2-{WIDE_STEPS}), of it the wide backward's two "
          f"kernels {bwd:.1f} ms ({100 * bwd / steady:.1f}%) and the wide forward {fwd:.1f} ms "
          f"({100 * fwd / steady:.1f}%) by their own timings; launches {json.dumps(launches)}")
    torch.cuda.empty_cache()
    path = {kern.name: launches[kern.name] for kern in flash.WIDE_KERNELS}
    return (errs, ms, plain, library, bounds), path


def _loss_and_grads(model, tokens):
    """One forward and backward of `lm_step_loss`: (loss, gradients on
    the host, peak device memory in bytes)."""
    from kungfu_tpu_torch.tools.step_profile import lm_step_loss

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    loss = lm_step_loss(model, tokens)
    loss.backward()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    return loss.item(), {n: p.grad.cpu() for n, p in model.named_parameters()}, peak


def phase_chunked(batch: int, seed: int, steps: int = CHUNKED_STEPS):
    """The flagship's row of 8 heads of 128 (config_gpt_mfu (8, False,
    True, 8)) trained with the chunked head (head="hidden",
    lm_loss_chunked) against the dense head on the same weights and
    sequences; then a step under remat_policy="dots" against no remat."""
    from kungfu_tpu_torch.ops import flash
    from kungfu_tpu_torch.tools.step_profile import flagship_model, flagship_step, flagship_tokens

    runs = {}
    for head in ("dense", "hidden"):
        cfg, trainer, state, tokens = flagship_step(batch, seed, n_heads=8, head=head)
        total = sum(p.double().sum().item() for p in state.params.parameters())
        for kern in flash.KERNELS + flash.WIDE_KERNELS:
            kern.launches = 0
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        losses, times = [], []
        for _ in range(steps if head == "hidden" else 2):
            t0 = time.perf_counter()
            state, metrics = trainer.train_step(state, tokens)
            losses.append(metrics["loss"].item())
            times.append(time.perf_counter() - t0)
        runs[head] = dict(losses=losses, step_ms=times[-1] * 1e3, checksum=total,
                          peak=torch.cuda.max_memory_allocated(),
                          launches={k.name: k.launches for k in flash.KERNELS + flash.WIDE_KERNELS})
        print(f"[chunked] head={head}: losses {' '.join(f'{x:.4f}' for x in losses)}, step "
              f"times {' '.join(f'{t * 1e3:.1f}' for t in times)} ms, peak memory "
              f"{runs[head]['peak'] / 2**30:.2f} GiB")
        del cfg, trainer, state, tokens
        torch.cuda.empty_cache()
    dense, chunked = runs["dense"], runs["hidden"]
    losses = chunked["losses"]
    check(dense["checksum"] == chunked["checksum"], "chunked: the two arms' weights differ")
    check(all(math.isfinite(x) for x in losses), f"chunked: non-finite loss {losses}")
    check(losses[-1] < losses[0], f"chunked: loss did not fall: {losses}")
    check(abs(losses[0] - dense["losses"][0]) <= TOL_CHUNKED_LOSS,
          f"chunked: first-step loss {losses[0]} vs the dense head's {dense['losses'][0]}")
    saved = dense["peak"] - chunked["peak"]
    check(saved >= CHUNKED_SAVING, f"chunked: peak {chunked['peak'] / 2**30:.3f} GiB, only "
          f"{saved / 2**30:.3f} GiB below the dense step's (want {CHUNKED_SAVING / 2**30:.2f})")
    want = {k.name: 24 * steps for k in flash.KERNELS + flash.WIDE_KERNELS}
    for kern in (flash.FLASH_BWD_DKV_GQA,) + flash.WIDE_KERNELS:
        want[kern.name] = 0
    check(chunked["launches"] == want, f"chunked: launches {chunked['launches']}, want {want}")
    print(f"[chunked] 8 heads of 128, batch {batch} x 2048: first-step loss {losses[0]:.6f} vs "
          f"the dense head's {dense['losses'][0]:.6f} (same weights, checksum "
          f"{chunked['checksum']:.6f}); steady step {chunked['step_ms']:.1f} ms vs dense "
          f"{dense['step_ms']:.1f} ms; peak {chunked['peak'] / 2**30:.2f} GiB vs dense "
          f"{dense['peak'] / 2**30:.2f} GiB ({saved / 2**30:.2f} GiB less); launches "
          f"{json.dumps(chunked['launches'])}")

    # remat_policy="dots" against no remat: one forward and backward each
    results = {}
    for remat in (False, True):
        extra = dict(remat=True, remat_policy="dots") if remat else {}
        cfg, model = flagship_model(seed, "cuda", n_heads=8, head="hidden", **extra)
        results[remat] = _loss_and_grads(model, flagship_tokens(cfg, batch, seed))
        del model
        torch.cuda.empty_cache()
    (l0, g0, p0), (l1, g1, p1) = results[False], results[True]
    worst = max(((g1[n].float() - g0[n].float()).norm() / g0[n].float().norm().clamp_min(1e-30))
                .item() for n in g0)
    same = all(torch.equal(g1[n], g0[n]) for n in g0)
    check(abs(l1 - l0) <= TOL_REMAT and worst <= TOL_REMAT,
          f"remat dots: loss {l1} vs {l0}, worst gradient normwise relative error {worst:.3g}")
    check(p1 < p0, f"remat dots: peak {p1 / 2**30:.2f} GiB not below no remat's "
          f"{p0 / 2**30:.2f} GiB")
    print(f"[chunked] remat_policy=\"dots\" vs no remat, one step (head=\"hidden\"): loss "
          f"{l1:.6f} vs {l0:.6f}, gradients {'bit-equal' if same else 'not bit-equal'} (worst "
          f"normwise relative error {worst:.3g}, limit {TOL_REMAT}); peak {p1 / 2**30:.2f} GiB "
          f"vs {p0 / 2**30:.2f} GiB")
    return losses


def phase_gqa_reference(batch: int, seed: int):
    """The GQA flagship's loss on phase main's 8 sequences, in one process."""
    from kungfu_tpu_torch import convert
    from kungfu_tpu_torch.models import lm_loss
    from kungfu_tpu_torch.tools.step_profile import flagship_model

    cfg, model = flagship_model(seed, "cuda", n_kv_heads=8)
    gen = torch.Generator(device="cuda").manual_seed(seed + 1)
    tokens = torch.randint(0, cfg.vocab_size, (batch, cfg.max_len), generator=gen,
                           device="cuda")
    with torch.no_grad():
        loss = lm_loss(model(tokens), tokens).item()
    n_params = sum(p.numel() for p in model.parameters())
    shapes = [tuple(p.shape) for p in model.parameters()]
    check(math.isfinite(loss), f"gqa-ref: non-finite loss {loss}")
    # the weights convert to the JAX package's layout and back at full width
    sd = {k: v.float().cpu() for k, v in model.state_dict().items()}
    tree = convert.params_to_flax(sd, cfg)
    kv = tree["block_0"]["attn"]["k"]["kernel"].shape
    check(kv == (cfg.d_model, cfg.kv_heads * cfg.d_model // cfg.n_heads),
          f"gqa-ref: converted k kernel {kv}")
    back = convert.params_from_flax(tree, cfg)
    check(all(torch.equal(back[k], v) for k, v in sd.items()), "gqa-ref: convert round trip")
    del sd, tree, back
    print(f"[gqa-ref] GQA flagship {n_params / 1e6:.1f}M params ({cfg.n_heads} query heads, "
          f"{cfg.kv_heads} kv heads; converts to the JAX layout and back), loss on the {batch} "
          f"sequences in one process {loss:.4f}")
    del model
    torch.cuda.empty_cache()
    return loss, n_params, shapes


def phase_cut_reference(batch: int, seed: int):
    """The flagship cut to CUT_LAYERS layers: its loss on phase main's
    sequences in one process (forward only), phase session's, elastic's,
    heal's and controlplane's reference."""
    from kungfu_tpu_torch.models import lm_loss
    from kungfu_tpu_torch.models.transformer import FLAGSHIP_GPT
    from kungfu_tpu_torch.tools.step_profile import flagship_model, flagship_tokens

    cfg, model = flagship_model(seed, "cuda", n_layers=CUT_LAYERS)
    tokens = flagship_tokens(cfg, batch, seed)
    with torch.no_grad():
        loss = lm_loss(model(tokens), tokens).item()
    check(math.isfinite(loss), f"cut-ref: non-finite loss {loss}")
    print(f"[cut-ref] the flagship at {CUT_LAYERS} of its {FLAGSHIP_GPT['n_layers']} layers, "
          f"{sum(p.numel() for p in model.parameters())} parameters, on phase main's {batch} "
          f"sequences in one process: loss {loss:.4f}")
    del model
    torch.cuda.empty_cache()
    return loss


def phase_ef(shapes, seed: int):
    """The error-feedback residual kernel against its plain version at the
    GQA flagship's gradient sizes; its times and bound."""
    from kungfu_tpu_torch import compression as tc
    from kungfu_tpu_torch.compression import error_feedback as EF

    gen = torch.Generator(device="cuda").manual_seed(seed + 11)

    def gradient(n):  # gradient-like values of mixed magnitude, an all-zero block
        x = torch.randn(n, generator=gen, device="cuda")
        x *= torch.rand(n, generator=gen, device="cuda") * 1e-2
        x[256:512] = 0
        return x

    sizes = sorted({math.prod(s) for s in shapes}) + [1000003]
    err = 0.0
    for scheme in ("int8", "fp8"):
        cfg = tc.resolve(scheme)
        for n in sizes:
            c = gradient(n)
            want = tc.quant.residual(c, cfg)
            got = EF.residual_(c, cfg)
            check(torch.equal(got.view(torch.int32), want.view(torch.int32)),
                  f"ef_residual {scheme} x {n}: not bit-equal to the plain version "
                  f"(max abs err {max_err(got, want):.3g})")
            err = max(err, max_err(got, want))
            del c, want, got
    print(f"[ef] residual kernel bit-equal to the plain version, int8 and fp8, at "
          f"{len(sizes)} sizes from {sizes[0]} to {sizes[-1]} values")
    # one step's gradients, every one of the GQA flagship's, in one grouped call
    bufs = [gradient(math.prod(s)) for s in shapes]
    total = sum(b.numel() for b in bufs)
    tables = len(EF.ef_plan([b.numel() for b in bufs]))
    for scheme in ("int8", "fp8"):
        cfg = tc.resolve(scheme)
        grouped = [b.clone() for b in bufs]
        before = EF.EF_RESIDUAL.launches
        EF.residual_group_(grouped, cfg)
        launched = EF.EF_RESIDUAL.launches - before
        check(launched == tables, f"ef_residual group {scheme}: {launched} launches for "
              f"{len(bufs)} gradients, expected {tables}")
        for i, (b, g) in enumerate(zip(bufs, grouped)):
            one = EF.residual_(b.clone(), cfg)  # a launch for this tensor alone
            check(torch.equal(g.view(torch.int32), one.view(torch.int32)),
                  f"ef_residual group {scheme}: gradient {i} ({b.numel()} values) not "
                  f"bit-equal to its own launch (max abs err {max_err(g, one):.3g})")
            err = max(err, max_err(g, tc.quant.residual(b, cfg)))
            del one
        del grouped
    print(f"[ef] grouped residual of the {len(bufs)} gradients ({total} values) in "
          f"{tables} launch(es), int8 and fp8: every gradient bit-equal to its own launch "
          f"and to the plain version")
    cfg = tc.INT8
    largest = max(bufs, key=lambda b: b.numel())
    n = largest.numel()
    big = time_ms(lambda: EF.residual_(largest, cfg), 20)
    step_ms = time_ms(lambda: EF.residual_group_(bufs, cfg), 10, 2)
    per_tensor_ms = time_ms(lambda: [EF.residual_(b, cfg) for b in bufs], 3, 1)
    plain = time_ms(lambda: [tc.quant.residual(b, cfg) for b in bufs], 2, 1)
    bound = _bound(6 * total, 8 * total, torch.float32)  # read and write 4 bytes a value
    print(f"[ef] int8, one step's {len(bufs)} gradients ({total} values): grouped "
          f"{step_ms:.3f} ms in {tables} launch(es), a launch per gradient "
          f"{per_tensor_ms:.3f} ms, plain {plain:.3f} ms, bound {bound[0]:.4f} ms "
          f"({bound[1]}: {8 * total / 1e6:.1f} MB); the largest gradient ({n} values) alone "
          f"{big:.3f} ms; library: none computes a blockwise quantization residual")
    del bufs, largest
    torch.cuda.empty_cache()
    name = EF.EF_RESIDUAL.name
    return {name: err}, {name: step_ms}, {name: plain}, {name: None}, {name: bound}


def phase_model_check(seed: int):
    """Small f32 model on the card: the flash kernels against plain full
    attention on the same weights, loss and every gradient."""
    from kungfu_tpu_torch.models import TransformerConfig, TransformerLM, lm_loss
    from kungfu_tpu_torch.ops import flash

    common = dict(vocab_size=512, d_model=256, n_layers=2, n_heads=4, d_ff=512, max_len=256,
                  dtype=torch.float32, rope=True)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    tokens = torch.randint(0, 512, (2, 256), generator=gen, device="cuda")
    results = []
    state = None
    for attention in ("flash", "full"):
        model = TransformerLM(TransformerConfig(attention=attention, **common), device="cuda",
                              generator=torch.Generator(device="cuda").manual_seed(seed))
        if state is None:
            state = model.state_dict()
        model.load_state_dict(state)
        before = [k.launches for k in flash.KERNELS]
        loss = lm_loss(model(tokens), tokens)
        loss.backward()
        launched = [k.launches - n for k, n in zip(flash.KERNELS, before)]
        check(launched == ([2, 2, 2, 0] if attention == "flash" else [0, 0, 0, 0]),
              f"model check ({attention}): kernel launches {launched}")
        results.append((loss.item(), {n: p.grad for n, p in model.named_parameters()}))
    (l_flash, g_flash), (l_full, g_full) = results
    check(abs(l_flash - l_full) <= TOL_MODEL_LOSS,
          f"model check: loss flash {l_flash} vs full {l_full}")
    worst = max(((g_flash[n] - g_full[n]).norm() / g_full[n].norm()).item() for n in g_full)
    check(worst <= TOL_MODEL_GRAD, f"model check: gradient normwise rel err {worst:.3g}")
    print(f"[check] f32 2-layer model, flash kernels vs full attention: loss {l_flash:.6f} vs "
          f"{l_full:.6f}, worst gradient normwise relative error {worst:.3g}")

    # dropout 0.1 on the same weights: only under train=True, from the generator
    model = TransformerLM(TransformerConfig(attention="flash", dropout=0.1, **common),
                          device="cuda")
    model.load_state_dict(state)
    with torch.no_grad():
        def loss_of(**kw):
            return lm_loss(model(tokens, **kw), tokens).item()

        l_eval = loss_of()
        seeded = [loss_of(train=True, generator=torch.Generator(device="cuda").manual_seed(s))
                  for s in (seed + 1, seed + 1, seed + 2)]
    check(abs(l_eval - l_flash) <= TOL_DROPOUT_SAME,
          f"dropout: train=False loss {l_eval} vs the model without dropout {l_flash}")
    check(abs(seeded[0] - seeded[1]) <= TOL_DROPOUT_SAME,
          f"dropout: one seed gave losses {seeded[0]} and {seeded[1]}")
    check(abs(seeded[2] - seeded[0]) > DROPOUT_MOVES,
          f"dropout: another seed gave the same loss {seeded[2]} vs {seeded[0]}")
    print(f"[check] dropout 0.1: train=False loss {l_eval:.6f} (without dropout {l_flash:.6f}); "
          f"train=True, one seed twice {seeded[0]:.6f} {seeded[1]:.6f}, another seed "
          f"{seeded[2]:.6f}")


def phase_main(steps: int, batch: int, seed: int):
    from kungfu_tpu_torch import distributed
    from kungfu_tpu_torch.fsdp import bucket_plan
    from kungfu_tpu_torch.ops import flash
    from kungfu_tpu_torch.tools.step_profile import flagship_step

    world = distributed.init_distributed(device="cuda")
    cfg, trainer, state, tokens = flagship_step(batch, seed)
    n_params = sum(p.numel() for p in state.params.parameters())
    # every parameter zero-padded to a multiple of N_RANKS: the payloads of
    # phase fsdp's ring calls, one chunk of size / N_RANKS a rank
    fsdp_sizes = sorted({-(-p.numel() // N_RANKS) * N_RANKS for p in state.params.parameters()})
    # phase fsdp's buckets: its grouped ring calls, as ring_check --groups
    chunks = [torch.empty(-(-p.numel() // N_RANKS), dtype=p.dtype, device="meta")
              for p in state.params.parameters()]
    names = {torch.float32: "f32", torch.bfloat16: "bf16"}
    fsdp_groups = ";".join(f"{names[chunks[a].dtype]}:" + "+".join(str(c.numel())
                                                                   for c in chunks[a:b])
                           for a, b in bucket_plan(chunks))
    print(f"[main] flagship GPT {n_params / 1e6:.1f}M params, world {world}, batch {batch} x "
          f"{cfg.max_len}, {cfg.n_layers} layers, attention={cfg.attention}")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for kern in flash.KERNELS:
        kern.launches = 0
    losses, times = [], []
    for step in range(steps):
        t0 = time.perf_counter()
        state, metrics = trainer.train_step(state, tokens)
        loss = metrics["loss"].item()  # waits for the step
        times.append(time.perf_counter() - t0)
        losses.append(loss)
        print(f"[main] step {step + 1}: loss {loss:.4f}, {times[-1] * 1e3:.1f} ms")
    launches = {k.name: k.launches for k in flash.KERNELS}
    check(all(math.isfinite(x) for x in losses), f"non-finite loss {losses}")
    check(losses[-1] < losses[0], f"loss did not fall: {losses}")
    want = {k.name: cfg.n_layers * steps for k in flash.KERNELS}
    want[flash.FLASH_BWD_DKV_GQA.name] = 0  # the flagship is MHA
    check(launches == want, f"kernel launches {launches}, expected {want}")
    step_s = statistics.median(times[1:]) if steps > 1 else times[0]
    print(f"[main] steady step {step_s * 1e3:.1f} ms (median of steps 2-{steps}), "
          f"{batch * cfg.max_len / step_s:.0f} tokens/s, peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, launches {json.dumps(launches)}")
    return losses, n_params, fsdp_sizes, fsdp_groups


def phase_ring(n_params: int, gqa_params: int, fsdp_sizes, fsdp_groups: str, seed: int):
    """B5 and B6, then B7 and B8, on N_RANKS ranks against their stacked
    plain versions; B5 and B6 also at every payload of phase fsdp, and
    grouped at each of its buckets."""
    from kungfu_tpu_torch.ops import ring_collectives as RC

    # the fused cases first: the plain slots of the 367.6M-value case stay
    # allocated for the rest of the phase, and four ranks share the card
    cases = (f"int8:{gqa_params},fp8:{gqa_params},int8:1000003,fp8:1000003,"
             f"f32:{n_params},bf16:{64 << 20},f32:1000003,"
             + ",".join(f"f32:{size}" for size in fsdp_sizes))
    _, res = spawn_ranks(["ring", "--cases", cases, "--groups", fsdp_groups, "--iters", "5",
                          "--seed", str(seed), "--faults"], "RING_CHECK ", 600)
    for r, rr in sorted(res.items()):
        for case in rr["cases"]:
            what = (f"group of {case['segments']}" if "group" in case
                    else f"x {case['size']}")
            check(all(case["ok"].values()), f"ring rank {r} {case['dtype']} {what}: "
                  f"{json.dumps(case['ok'])}, max abs err {json.dumps(case['max_abs_err'])}")
    r0 = res[0]
    print(f"[ring] {N_RANKS} ranks, backend {r0['backend']}, {r0['card']}: every rank's "
          f"reduce-scatter, all-gather and all-reduce (sum, mean) equal the stacked plain "
          f"versions bit for bit, and so do the fused int8/fp8 all-reduces (sum, mean), "
          f"their reduce-scatter (B7) alone and their all-gather (B8) alone, "
          f"within the reference's tolerance of the exact sum, and the grouped "
          f"reduce-scatter and all-gather at phase fsdp's buckets, each in the launches of "
          f"its segment plan; planted faults rejected")
    singles = [c for c in r0["cases"] if "group" not in c]
    for i, case in enumerate(r0["cases"]):
        if "group" not in case:
            continue
        slowest = {k: max(rr["cases"][i]["ms"][k] for rr in res.values()) for k in case["ms"]}
        print(f"[ring] group {case['dtype']} of {case['segments']} tensors "
              f"({case['chunk_bytes']} bytes a rank): kernel ms (slowest rank's median) rs "
              f"{slowest['rs']:.3f} ag {slowest['ag']:.3f} in {case['launches']['rs']} launch(es) "
              f"each; plain ms {json.dumps(case['plain_ms'])}; bound ms "
              f"{json.dumps(case['bound_ms'])} ({case['bound_note']}); library ms "
              f"{json.dumps(case['library_ms'])}")
    for i, case in enumerate(r0["cases"]):
        if "group" in case:
            continue
        slowest = {k: max(rr["cases"][i]["ms"][k] for rr in res.values()) for k in case["ms"]}
        lib = case["library_ms"]
        lib = ({k: max(rr["cases"][i]["library_ms"][k] for rr in res.values()) for k in lib}
               if lib else None)
        extra = ""
        if "tolerance" in case:
            worst = max(rr["cases"][i]["max_abs_err"]["fused_sum vs exact"] for rr in res.values())
            extra = f"; error vs exact sum {worst:.4g} (tolerance {case['tolerance']:.4g})"
        if case.get("nccl_f32_ms"):
            extra += f"; NCCL f32 at this size (context) {json.dumps(case['nccl_f32_ms'])}"
        if case.get("device_ms"):
            dev = {k: max(rr["cases"][i]["device_ms"][k] for rr in res.values())
                   for k in case["device_ms"]}
            extra += f"; device ms, the host's issue out (slowest rank) {json.dumps(dev)}"
        print(f"[ring] {case['dtype']} x {case['size']} (chunk {case['chunk']}): kernel ms "
              f"(slowest rank's median) rs {slowest['rs']:.3f} ag {slowest['ag']:.3f} "
              f"all-reduce {slowest['ar']:.3f}; plain ms {json.dumps(case['plain_ms'])}; "
              f"bound ms {json.dumps(case['bound_ms'])} ({case['bound_note']}); library ms "
              f"{json.dumps(lib) if lib else 'null: ' + case['library_note']}{extra}")
        case["slowest_ms"], case["library_slowest_ms"] = slowest, lib
    by_case = {(c["dtype"], c["size"]): c for c in singles}
    big, fused = by_case[("f32", n_params)], by_case[("int8", gqa_params)]
    keys = {RC.RING_RS.name: (big, "rs"), RC.RING_AG.name: (big, "ag"),
            RC.FUSED_RS.name: (fused, "rs"), RC.FUSED_AG.name: (fused, "ag")}

    def worst(fused_cases: bool, names) -> float:
        """Largest error against the stacked plain version, every rank and case."""
        return max(v for rr in res.values() for c in rr["cases"]
                   if (c["dtype"] in ("int8", "fp8")) == fused_cases
                   for e, v in c["max_abs_err"].items() if e in names)

    # B7 and B8 each alone and together (the fused all-reduce) against
    # their plain versions
    errs = {RC.RING_RS.name: worst(False, ("rs",)), RC.RING_AG.name: worst(False, ("ag",)),
            RC.FUSED_RS.name: worst(True, ("rs", "fused_sum", "fused_mean")),
            RC.FUSED_AG.name: worst(True, ("ag", "fused_sum", "fused_mean"))}
    ms = {name: case["slowest_ms"][k] for name, (case, k) in keys.items()}
    # the stacked plain fused all-reduce computes both kernels' work at once
    plain = {name: case["plain_ms"][k if case is big else "ar"]
             for name, (case, k) in keys.items()}
    library = {name: (case["library_slowest_ms"][k] if case["library_slowest_ms"] else None)
               for name, (case, k) in keys.items()}
    bounds = {name: (case["bound_ms"][k], "bytes") for name, (case, k) in keys.items()}
    return errs, ms, plain, library, bounds


def phase_ranks(steps: int, batch: int, seed: int, bucket_mib: int, ref_loss1: float,
                compression=None):
    """The flagship S-SGD step on N_RANKS ranks through the ring kernels;
    with `compression`, the GQA flagship through the fused-codec kernels."""
    label = "gqa" if compression else "ranks"
    extra = ["--n-kv-heads", "8", "--compression", compression] if compression else []
    out, res = spawn_ranks(["train", "--steps", str(steps), "--batch", str(batch), "--seed",
                            str(seed), "--bucket-mib", str(bucket_mib), *extra], RANKS_LINE, 900)
    for line in out.splitlines():
        if "[ranks]" in line:
            print(line.replace("[ranks]", f"[{label}]"))
    for r, rr in sorted(res.items()):
        check(rr["ok"], f"{label}: rank {r} failed its checks: {json.dumps(rr['checks'])}")
    r0 = res[0]
    loss1 = r0["losses"][0]
    ref = "phase gqa-ref" if compression else "phase main"
    check(abs(loss1 - ref_loss1) <= TOL_RANKS_LOSS,
          f"{label}: first-step loss {loss1} vs {ref}'s {ref_loss1}")
    step_s = max(rr["step_s"] for rr in res.values())
    peaks = " ".join(f"{rr['peak_gib']:.2f}" for rr in res.values())
    print(f"[{label}] {N_RANKS} ranks x batch {batch // N_RANKS} ({r0['backend']}, "
          f"{r0['kv_heads']} kv heads, compression {compression}, {r0['buckets']} buckets of "
          f"at most {bucket_mib} MiB): losses {' '.join(f'{x:.4f}' for x in r0['losses'])}, "
          f"first step {loss1:.4f} vs {ref}'s {ref_loss1:.4f}; replicas bit-identical; "
          f"steady step {step_s * 1e3:.1f} ms (slowest rank), {batch * 2048 / step_s:.0f} "
          f"tokens/s, peak memory per rank {peaks} GiB; rank 0 launches "
          f"{json.dumps(r0['launches'])}")
    return r0["launches"], r0["losses"]


def phase_adaptive(card: str, steps: int, batch: int, seed: int, bucket_mib: int,
                   main_loss1: float, ranks_losses):
    """KungFu's adaptive optimizers on the flagship, N_RANKS ranks x batch 2:
    (a) AdaptiveSGD per replica under fit with a policy, (b) the GNS monitor
    over phase ranks' S-SGD, (c) noise-driven int8 compression."""
    out, res = spawn_ranks(["adaptive", "--steps", str(steps), "--batch", str(batch), "--seed",
                            str(seed), "--bucket-mib", str(bucket_mib)], ADAPTIVE_LINE, 900)
    for line in out.splitlines():
        if "[adaptive]" in line:
            print(line)
    for r, rr in sorted(res.items()):
        for name, run in rr["runs"].items():
            check(run["ok"], f"adaptive ({name}): rank {r} failed its checks: "
                  f"{json.dumps(run['checks'])}; launches {json.dumps(run['launches'])}, "
                  f"expected {json.dumps(run['expected_launches'])}")
    runs = res[0]["runs"]
    a, b, c = runs["a"], runs["b"], runs["c"]
    check(abs(a["losses"][0] - main_loss1) <= TOL_RANKS_LOSS,
          f"adaptive (a): first-step loss {a['losses'][0]} vs phase main's {main_loss1}")
    check(b["losses"] == ranks_losses,
          f"adaptive (b): losses {b['losses']} vs phase ranks' {ranks_losses} (bit-equal)")
    check(abs(c["losses"][0] - main_loss1) <= TOL_RANKS_LOSS,
          f"adaptive (c): first-step loss {c['losses'][0]} vs phase main's {main_loss1}")
    for name, what in (("a", f"AdaptiveSGD (SGD lr {ADAPTIVE_SGD_LR}, switch at step "
                              f"{ADAPTIVE_SWITCH}) per replica under fit"),
                       ("b", "gradient_noise_scale over phase ranks' S-SGD"),
                       ("c", "noise_adaptive_compression(adamw, int8)")):
        run = runs[name]
        step_s = max(rr["runs"][name]["step_s"] for rr in res.values())
        peaks = " ".join(f"{res[r]['runs'][name]['peak_gib']:.2f}" for r in sorted(res))
        extra = ""
        if "noise_scale" in run:
            extra += f", noise scale {' '.join(f'{x:.6g}' for x in run['noise_scale'])}"
        if "compressed" in run:
            extra += f", compressed {run['compressed']}"
        if "distinct_sums" in run:
            extra += (f", ranks' distinct parameter checksums after each step "
                      f"{run['distinct_sums']}")
        if "final_loss" in run:
            extra += f", the final parameters' loss {run['final_loss']:.4f}"
        print(f"[adaptive] ({name}) {what}, {run['layers']} layers, {card}: losses "
              f"{' '.join(f'{x:.4f}' for x in run['losses'])}{extra}; steady step "
              f"{step_s * 1e3:.1f} ms (slowest rank), {batch * 2048 / step_s:.0f} tokens/s, "
              f"peak memory per rank {peaks} GiB; rank 0 launches {json.dumps(run['launches'])}")


def phase_gossip(card: str, batch: int, seed: int, main_loss1: float):
    """KungFu's gossip on the flagship, N_RANKS ranks x batch 2: (a)
    pair_averaging(SGD) with its pull through B11, (b) the same with an
    int8 pull, (c) HostPairAveraging and OverlappedHostPairAveraging over
    the TCP blob stores.  Returns rank 0's B11 launches in (a) and (b)."""
    out, res = spawn_ranks(["gossip", "--batch", str(batch), "--seed", str(seed)],
                           GOSSIP_LINE, 900)
    for line in out.splitlines():
        if "[gossip]" in line:
            print(line)
    for r, rr in sorted(res.items()):
        for name, run in rr["runs"].items():
            check(run["ok"], f"gossip ({name}): rank {r} failed its checks: "
                  f"{json.dumps(run['checks'])}; launches {json.dumps(run['launches'])}, "
                  f"expected {json.dumps(run['expected_launches'])}")
    runs = res[0]["runs"]
    for name in ("a", "b"):
        check(abs(runs[name]["losses"][0] - main_loss1) <= TOL_RANKS_LOSS,
              f"gossip ({name}): first-step loss {runs[name]['losses'][0]} vs phase main's "
              f"{main_loss1}")
    whats = {"a": "pair_averaging(SGD lr %g), random selector, the pull through B11",
             "b": "pair_averaging(SGD lr %g, compression int8), codes and scales through B11",
             "c-host": "HostPairAveraging over the TCP blob stores, then SGD lr %g",
             "c-overlapped": "OverlappedHostPairAveraging over the TCP blob stores, then SGD "
                             "lr %g"}
    for name, run in runs.items():
        step_s = max(rr["runs"][name]["step_s"] for rr in res.values())
        peaks = " ".join(f"{res[r]['runs'][name]['peak_gib']:.2f}" for r in sorted(res))
        extra = ""
        if "shifts" in run:
            extra += (f", shifts {run['shifts']}, {run['chunks']} packed chunks a step (the "
                      f"largest {run['largest_chunk']} bytes, its position digest "
                      f"{run['digest_ms']:.1f} ms, made of every sent and received buffer "
                      f"inside the step), ranks' "
                      f"distinct parameter checksums after each step {run['distinct_sums']}")
        if "pulls" in run:
            extra += f", {run['pulls']} pulls of {run['pull_misses'] + run['pulls']} found a blob"
        print(f"[gossip] ({name}) {whats[name] % ADAPTIVE_SGD_LR}, {run['layers']} layers, "
              f"{card}: losses {' '.join(f'{x:.4f}' for x in run['losses'])}{extra}; steady "
              f"step {step_s * 1e3:.1f} ms (slowest rank), {batch * 2048 / step_s:.0f} tokens/s, "
              f"peak memory per rank {peaks} GiB; rank 0 launches {json.dumps(run['launches'])}")
    from kungfu_tpu_torch.ops import fused_matmul as FM

    return runs["a"]["launches"][FM.SHIFT.name] + runs["b"]["launches"][FM.SHIFT.name]


def phase_session(card: str, batch: int, seed: int, cut_loss1: float):
    """KungFu's Session on N_RANKS ranks started with the launcher's
    -strategy PALLAS_RING: (a) the torch interop's S-SGD on the flagship
    cut to CUT_LAYERS layers,
    (b) the runtime swap to PALLAS_RING_FUSED with an int8 wire, (c) the
    rest of the Session on CUDA tensors.  Returns rank 0's B5-B8 launches
    in (a) and (b)."""
    from kungfu_tpu_torch.ops import ring_collectives as RC

    out, res = spawn_ranks(["session", "--batch", str(batch), "--seed", str(seed)], SESSION_LINE,
                           900, launcher_args=["-strategy", "PALLAS_RING"],
                           env={"KFT_CONFIG_ENABLE_TRACE": "1", "KFT_CONFIG_LOG_LEVEL": "warning"})
    for line in out.splitlines():
        if "[session]" in line:
            print(line)
    for r, rr in sorted(res.items()):
        check(rr["ok"], f"session: rank {r} failed its checks: "
              f"{json.dumps({k: v for k, v in rr['checks'].items() if not v})}; launches "
              f"{json.dumps(rr['launches'])}, expected {json.dumps(rr['expected_launches'])}")
    r0 = res[0]
    check(abs(r0["losses"]["a"][0] - cut_loss1) <= TOL_RANKS_LOSS,
          f"session (a): first-step loss {r0['losses']['a'][0]} vs phase cut-ref's {cut_loss1}")
    whats = {"a": f"SynchronousSGDOptimizer(SGD lr {ADAPTIVE_SGD_LR}) under PALLAS_RING, one "
                  "Session all_reduce a gradient (B5 + B6)",
             "b": "after set_strategy(PALLAS_RING_FUSED) and set_compression('int8') (B7 + B8)"}
    for part, what in whats.items():
        step_s = max(rr["step_s"][part] for rr in res.values())
        print(f"[session] ({part}) {what}, {r0['layers']} layers, {card}: losses "
              f"{' '.join(f'{x:.4f}' for x in r0['losses'][part])}; replicas agree after every "
              f"step (consensus); steady step {step_s * 1e3:.1f} ms (slowest rank), "
              f"{batch * 2048 / step_s:.0f} tokens/s; span tags {json.dumps(r0['tags'][part])}; "
              f"rank 0 launches {json.dumps(r0['launches'][part])}")
    slowest = {k: max(rr["c_ms"][k] for rr in res.values()) for k in r0["c_ms"]}
    peaks = " ".join(f"{rr['peak_gib']:.2f}" for rr in res.values())
    print(f"[session] (c) on CUDA tensors, every check held on every rank; slowest rank's ms: "
          f"{json.dumps({k: round(v, 1) for k, v in slowest.items()})}; grouped B5/B6 "
          f"launches {r0['group_launches']} for {r0['group_expected']} segment_plan runs; "
          f"peak memory per rank {peaks} GiB")
    print(f"[session] rank 0 calc_stats() (bytes/s): "
          f"{json.dumps({k: round(v) for k, v in r0['stats'].items()})}")
    a, b = r0["launches"]["a"], r0["launches"]["b"]
    return {k.name: a[k.name] + b[k.name] for k in RC.KERNELS}


def state_checksum(sd) -> list:
    """The bits of every tensor of a state dict, one int64 sum each (the
    checksum of phase ranks, for any element size)."""
    ints = {1: torch.int8, 2: torch.int16, 4: torch.int32, 8: torch.int64}
    return [t.detach().reshape(-1).view(ints[t.element_size()]).to(torch.int64).sum().item()
            for t in sd.values()]


def phase_elastic(card: str, batch: int, seed: int, bucket_mib: int, cut_loss1: float):
    """KungFu's elastic resize on N_RANKS ranks of the flagship (cut to
    CUT_LAYERS layers) under the
    launcher's watch mode, then the checkpoints it left, read back and
    faulted in this process.  Returns rank 0's launches in the run."""
    import shutil
    import tempfile

    from kungfu_tpu_torch.checkpoint import CheckpointManager
    from kungfu_tpu_torch.ops import flash
    from kungfu_tpu_torch.ops import ring_collectives as RC

    t_phase = time.perf_counter()
    ckpt_dir = tempfile.mkdtemp(prefix="kft-elastic-")
    try:
        out, res = spawn_ranks(["elastic", "--batch", str(batch), "--seed", str(seed),
                                "--bucket-mib", str(bucket_mib), "--ckpt-dir", ckpt_dir],
                               ELASTIC_LINE, ELASTIC_TIMEOUT + 60,
                               launcher_args=["-w", "-timeout", str(ELASTIC_TIMEOUT)])
        lines = out.splitlines()
        for line in lines:
            if "[elastic]" in line:
                print(line)
        results = [line for line in lines if re.match(r"^\[\d+\] RESULT: elastic ", line)]
        detached = [line for line in lines if "DETACHED:" in line]
        left = {}
        for line in lines:
            m = re.match(r"^\[(\d+)\] " + re.escape(ELASTIC_LEFT) + r"(.*)$", line)
            if m:
                left[len(left)] = json.loads(m.group(2))
        check(len(results) == N_RANKS and all("trained=40 " in x and "final_size=4 " in x
                                               for x in results),
              f"elastic: RESULT lines {results}")
        check(len(detached) == 2 and len(left) == 2,
              f"elastic: {len(detached)} DETACHED lines, {len(left)} detached ranks' records")
        r0 = res[0]
        for r, rr in sorted(res.items()):
            check(rr["ok"], f"elastic: rank {r} failed its checks: "
                  f"{json.dumps({k: v for k, v in rr['checks'].items() if not v})}")
        for who, rr in [*(("rank %d" % r, rr) for r, rr in res.items()),
                        *(("a detached rank", rr) for rr in left.values())]:
            check(all(st["launches"] == st["want"] for st in rr["steps"]),
                  f"elastic: {who}'s launches in its steps "
                  f"{json.dumps([(st['step'], st['launches']) for st in rr['steps']])}")
            check(all(i["workspaces"] == 0 and i["port"] == i["fenced_port"]
                      for i in rr["inits"]), f"elastic: {who}'s groups {rr['inits']}")
        check([i["version"] for i in r0["inits"]] == [0, 1, 2]
              and len({i["port"] for i in r0["inits"]}) == 3,
              f"elastic: rank 0's groups {r0['inits']}, expected versions 0, 1 and 2 at ports "
              f"of their own")
        survivors = [r for r, rr in res.items() if rr["resizes"] == 2]
        joiners = [r for r, rr in res.items() if rr["resizes"] == 0]
        check(sorted(survivors) == [0, 1] and sorted(joiners) == [2, 3],
              f"elastic: survivors {survivors}, joiners {joiners}")
        for r in survivors:
            evs = res[r]["resize_events"]
            want = {"snapshot", "ckpt_release", "teardown", "reinit", "rebuild", "sync",
                    "first_step"}
            check(len(evs) == 2 and all(set(e["phases"]) == want for e in evs),
                  f"elastic: rank {r}'s resize events {evs}")
        grow = max(s["version"] for s in r0["syncs"])
        sync0 = next(s["checksum"] for s in r0["syncs"] if s["version"] == grow)
        for r in joiners:
            check([s["checksum"] for s in res[r]["syncs"]] == [sync0],
                  f"elastic: joiner {r}'s parameters after the grow's sync differ from rank 0's")
        check(all(rr["final_checksum"] == r0["final_checksum"] for rr in res.values()),
              "elastic: the ranks' parameters differ after the last step")
        losses = [st["loss"] for st in r0["steps"]]
        check(all(math.isfinite(x) for rr in [*res.values(), *left.values()]
                  for x in (st["loss"] for st in rr["steps"])), "elastic: a non-finite loss")
        check(abs(losses[0] - cut_loss1) <= TOL_RANKS_LOSS,
              f"elastic: first-step loss {losses[0]} vs phase cut-ref's {cut_loss1}")

        # the checkpoints the run left: the last step restores and verifies
        # with rank 0's final parameters; a flipped byte demotes it
        mgr = CheckpointManager(ckpt_dir, is_primary=False)
        t0 = time.perf_counter()
        got = mgr.restore_latest_verified()
        restore_s = time.perf_counter() - t0
        last = r0["steps"][-1]["step"]
        check(got is not None and got[2] == last and not got[3],
              f"elastic: restore_latest_verified gave step {got and got[2]}, expected {last}")
        check(state_checksum(got[0]["params"]) == r0["final_checksum"],
              "elastic: the restored parameters differ from rank 0's final ones")
        steps = mgr.all_steps()
        check(steps == list(range(ELASTIC_CKPT_EVERY, last + 1, ELASTIC_CKPT_EVERY)),
              f"elastic: checkpoint steps {steps}: the save at 2 ranks (step 3), released by "
              f"the grow, and the last")
        del got
        leaf = os.path.join(ckpt_dir, str(last), "state", "0.bin")
        with open(leaf, "r+b") as f:
            f.seek(os.path.getsize(leaf) // 2)
            byte = f.read(1)
            f.seek(-1, os.SEEK_CUR)
            f.write(bytes([byte[0] ^ 0x10]))
        got = mgr.restore_latest_verified()
        check(got is not None and got[2] == steps[-2] and len(got[3]) == 1
              and got[3][0]["candidate"] == f"step:{last}"
              and "checksum mismatch" in got[3][0]["reason"],
              f"elastic: the planted fault gave {got and (got[2], got[3])}, expected step "
              f"{steps[-2]} after demoting {last}")
        del got
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)

    for r in survivors:
        for ev in res[r]["resize_events"]:
            print(f"[elastic] rank {r} resize v{ev['version']} {ev['old_size']} -> "
                  f"{ev['new_size']} on {card}: {ev['total_s']:.2f} s, phases (s) "
                  f"{json.dumps(ev['phases'])}, propose to done "
                  f"{ev.get('propose_to_done_s', 'n/a')} s")
    # the grow's sync: the survivors wait for the joiners, then rank 0 sends
    enter = {r: next(s["t0"] for s in rr["syncs"] if s["version"] == grow)
             for r, rr in res.items()}
    leave = max(next(s["t1"] for s in rr["syncs"] if s["version"] == grow)
                for rr in res.values())
    for r in joiners:
        rr = res[r]
        restores = ", ".join(f"step {x['step']} in {x['s']:.2f} s" for x in rr["restores"])
        print(f"[elastic] joiner rank {r}: worker start to its group "
              f"{rr['inits'][0]['t_joined'] - rr['t_start']:.2f} s, to its sync "
              f"{enter[r] - rr['t_start']:.2f} s; of it the resume from the checkpoint "
              f"directory (restore_latest_verified) {restores or 'none'}")
    peaks = " ".join(f"{rr['host_peak_gib']:.2f}" for rr in res.values())
    print(f"[elastic] grow v{grow}: the survivors waited {max(enter.values()) - enter[0]:.2f} s "
          f"in the sync for the joiners, then the broadcast of rank 0's state took "
          f"{leave - max(enter.values()):.2f} s; host peak per rank {peaks} GiB")
    # a step is steady if it is not the first on its group and does not
    # follow a save (rank 0's writer thread then copies and writes 4 GiB)
    for size in (2, 4):
        for label, after_save in (("steady step", False), ("step after a save", True)):
            times = [st["s"] for rr in res.values() for st in rr["steps"]
                     if st["world"] == size and not st["first"]
                     and ((st["step"] - 1) % ELASTIC_CKPT_EVERY == 0) == after_save]
            if times:
                print(f"[elastic] {label} at {size} ranks on {card}: slowest rank "
                      f"{max(times) * 1e3:.1f} ms, median "
                      f"{statistics.median(times) * 1e3:.1f} ms ({len(times)} rank-steps)")
            elif not after_save:
                print(f"[elastic] no steady step at {size} ranks in {ELASTIC_SCHEDULE}: each "
                      f"step there is the first on its group or follows a save")
    for sv in r0["saves"]:
        print(f"[elastic] checkpoint step {sv['step']} on {card}: save() (host copy) "
              f"{sv['save_s']:.2f} s, write + manifest {sv['write_s']:.2f} s, "
              f"{sv['gib']:.2f} GiB")
    print(f"[elastic] {N_RANKS} -> 2 -> {N_RANKS} ranks ({ELASTIC_SCHEDULE}), losses "
          f"{' '.join(f'{x:.4f}' for x in losses)}, first {losses[0]:.4f} vs phase cut-ref's "
          f"{cut_loss1:.4f}; joiners synced bit-equal to rank 0; replicas bit-identical at the "
          f"end; restore_latest_verified step {last} in {restore_s:.2f} s, a flipped byte "
          f"demoted it to step {steps[-2]}; rank 0 launches {json.dumps(r0['launches'])}; "
          f"the phase {time.perf_counter() - t_phase:.1f} s")
    return {k.name: r0["launches"][k.name] for k in (*flash.KERNELS, RC.RING_RS, RC.RING_AG)}


def _heal_gates(res, runner, lines, cut_loss1: float):
    """Phase heal's gates over the ranks' records ({self spec: record}) and
    the runner's heal events; (rank 0's record, the survivors, the
    victim)."""
    final = {rr["final_rank"]: rr for rr in res.values()}
    r0 = final.get(0)
    check(sorted(final) == list(range(N_RANKS)), f"heal: final ranks {sorted(final)}")
    for who, rr in res.items():
        check(rr["ok"], f"heal: {who} failed its checks: "
              f"{json.dumps({k: v for k, v in rr['checks'].items() if not v})}")
        check(rr["trained"] >= HEAL_SAMPLES and rr["final_size"] == N_RANKS,
              f"heal: {who} trained {rr['trained']} samples, final size {rr['final_size']}")
        check(all(st["launches"] == st["want"] for st in rr["steps"]),
              f"heal: {who}'s launches in its steps "
              f"{json.dumps([(st['step'], st['launches']) for st in rr['steps']])}")
        check(all(i["workspaces"] == 0 and i["port"] == i["fenced_port"] for i in rr["inits"]),
              f"heal: {who}'s groups {rr['inits']}")
        check(all(math.isfinite(st["loss"]) for st in rr["steps"]), f"heal: {who}: a "
              "non-finite loss")
    # the runner: the victim's exit 41 healed 4 -> 3, one restart
    check(len(runner) == 1 and runner[0]["rc"] == 41 and runner[0]["old_size"] == N_RANKS
          and runner[0]["new_size"] == N_RANKS - 1,
          f"heal: the runner's heal events {runner}, expected one 4 -> 3 after exit 41")
    victim = runner[0]["peer"]
    check(any(f"RESTART: re-grew {victim}" in line for line in lines),
          f"heal: no regrow of {victim} in the runner's log")
    survivors = [who for who in res if who != victim]
    check(len(survivors) == N_RANKS - 1 and victim in res, f"heal: survivors {survivors}, "
          f"the regrown joiner {victim in res}")
    phases = {"detect_s", "teardown_s", "re_rendezvous_s", "resync_s", "state_source_s"}
    for who in survivors:
        rr = res[who]
        evs = rr["heal_events"]
        check(len(evs) == 1 and phases <= set(evs[0]["phases"]) and evs[0]["old_size"] == N_RANKS
              and evs[0]["new_size"] == N_RANKS - 1 and "mttr_s" in evs[0]
              and evs[0].get("recovery_rung") and evs[0].get("recovery_source"),
              f"heal: {who}'s heal events {evs}")
        heal_syncs = [s for s in rr["syncs"] if s["kind"] == "heal"]
        check(len(heal_syncs) == 1 and heal_syncs[0]["out"] == heal_syncs[0]["in"],
              f"heal: {who}'s parameters after the heal's sync differ from the source it named "
              f"({evs[0].get('recovery_source')})")
        check(rr["ring3"] is not None and rr["ring3"]["equal"] and rr["ring3"]["world"] == 3
              and rr["ring3"]["orphans"] == 0,
              f"heal: {who}'s B5 + B6 check on the healed group: {rr['ring3']}")
        check(rr["held_s"] is not None, f"heal: {who} never waited for the regrow's document")
    heal_out = {tuple(s["out"]) for who in survivors for s in res[who]["syncs"]
                if s["kind"] == "heal"}
    check(len(heal_out) == 1, "heal: the survivors' parameters differ after the heal's sync")
    joiner = res[victim]
    grow_v = joiner["inits"][0]["version"]
    r0_grow = next(s["out"] for s in r0["syncs"] if s["version"] == grow_v)
    check(joiner["syncs"][0]["out"] == r0_grow and joiner["resizes"] == 0,
          "heal: the regrown joiner's parameters after its sync differ from rank 0's")
    check(all(rr["final_checksum"] == r0["final_checksum"] for rr in res.values()),
          "heal: the ranks' parameters differ after the last step")
    first = r0["steps"][0]["loss"]
    check(abs(first - cut_loss1) <= TOL_RANKS_LOSS,
          f"heal: first-step loss {first} vs phase cut-ref's {cut_loss1}")

    return r0, survivors, victim


def phase_heal(card: str, batch: int, seed: int, bucket_mib: int, cut_loss1: float):
    """KungFu's self-healing on N_RANKS ranks of the flagship (cut to
    CUT_LAYERS layers): the launcher's
    healer (`run -w -heal -restart-budget 1`), a scripted crash of launch
    rank 2, the survivors' recovery to 3 ranks, the regrow to 4.  Returns
    rank 0's launches in its completed steps."""
    import shutil
    import tempfile

    from kungfu_tpu_torch.ops import flash, peer_memory
    from kungfu_tpu_torch.ops import ring_collectives as RC

    t_phase = time.perf_counter()
    ckpt_dir = tempfile.mkdtemp(prefix="kft-heal-")
    env = dict(os.environ, PYTORCH_CUDA_ALLOC_CONF="expandable_segments:True",
               KFT_FAULT_PLAN=HEAL_PLAN, KFT_RING_TIMEOUT_S=str(HEAL_RING_TIMEOUT_S))
    env.pop("KFT_INIT_TIMEOUT_S", None)  # the launcher's own for heal-armed workers
    env["PYTHONPATH"] = HERE + (os.pathsep + env["PYTHONPATH"] if env.get("PYTHONPATH") else "")
    torch.cuda.empty_cache()  # the ranks share the card with this process
    print(f"[heal] this process holds {torch.cuda.memory_reserved() / 2**30:.2f} GiB of the "
          f"card while {N_RANKS} ranks run; plan {HEAL_PLAN!r}, KFT_RING_TIMEOUT_S="
          f"{HEAL_RING_TIMEOUT_S} (the default is {peer_memory._timeout_ns() / 1e9:g} s), "
          f"restart backoff {HEAL_BACKOFF_S:g} s, KFT_INIT_TIMEOUT_S the launcher's")
    try:
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--rank-phase", "heal-launcher",
             "-w", "-heal", "-np", str(N_RANKS), "-restart-budget", "1", "-timeout",
             str(HEAL_TIMEOUT), "--", sys.executable, os.path.abspath(__file__),
             "--rank-phase", "heal", "--batch", str(batch), "--seed", str(seed),
             "--bucket-mib", str(bucket_mib), "--ckpt-dir", ckpt_dir],
            cwd=HERE, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            timeout=HEAL_TIMEOUT + 120)
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    out = proc.stdout
    lines = out.splitlines()
    res = {}
    for line in lines:
        m = re.match(r"^\[\d+\] " + re.escape(HEAL_LINE) + r"(.*)$", line)
        if m:
            rr = json.loads(m.group(1))
            res[rr["self"]] = rr
    runner = next((json.loads(line.split("RUNNER_HEAL_EVENTS:", 1)[1]) for line in lines
                   if line.startswith("RUNNER_HEAL_EVENTS:")), [])
    if proc.returncode != 0 or len(res) != N_RANKS:
        print("\n".join(line for line in lines if HEAL_LINE not in line), file=sys.stderr)
        raise SmokeFailure(f"heal: launcher exit {proc.returncode}, results from "
                           f"{sorted(res)}")
    for line in lines:  # the ranks' and the runner's heal lines, not every step's
        if (("[heal]" in line and " step " not in line) or "CHAOS" in line or "HEAL:" in line
                or "RESTART:" in line or "healed" in line or "dirty distributed" in line
                or "suspected peer failure" in line or "recovery ladder" in line
                or "recovery attempt" in line or "resizing to version" in line
                or "joined at" in line or "buddy ship" in line):
            print(line)
    try:
        r0, survivors, victim = _heal_gates(res, runner, lines, cut_loss1)
    except Exception:  # the ranks' records, for the post-mortem
        for line in lines:
            if HEAL_LINE in line:
                print(line, file=sys.stderr)
        raise
    joiner, first = res[victim], r0["steps"][0]["loss"]
    for who in survivors:
        ev = res[who]["heal_events"][0]
        print(f"[heal] {who} healed {ev['old_size']} -> {ev['new_size']} at v{ev['version']} on "
              f"{card}: mttr_s {ev['mttr_s']:.2f}, rung {ev['recovery_rung']}/"
              f"{ev['recovery_source']} ({ev['recovery_demotions']} demotions), phases (s) "
              f"{json.dumps(ev['phases'])}, dead group's ring workspaces freed "
              f"{ev['workspace_bytes_freed'] / 2**20:.1f} MiB, left mapped "
              f"{ev['workspace_bytes_leaked'] / 2**20:.1f} MiB")
    for who, rr in sorted(res.items()):
        ships = ", ".join(f"step {s['step']} {'shipped' if s['shipped'] else 'MISSED'} "
                          f"{s['gib']:.2f} GiB in {s['s']:.2f} s" for s in rr["ships"])
        print(f"[heal] {who} buddy snapshots: {ships or 'none'}")
    held = " ".join(f"{res[who]['held_s']:.2f}" for who in survivors)
    print(f"[heal] the survivors' second {N_RANKS - 1}-rank step held {held} s for the "
          f"regrow's document")
    enter = next(s["t0"] for s in joiner["syncs"])
    print(f"[heal] the regrow: the joiner {victim} from its start to its group "
          f"{joiner['inits'][0]['t_joined'] - joiner['t_start']:.2f} s, to its sync "
          f"{enter - joiner['t_start']:.2f} s; restart to the end of the run on rank 0 "
          f"{r0['t_end'] - enter:.2f} s")
    peaks = " ".join(f"{rr['host_peak_gib']:.2f}" for rr in res.values())
    for size in (N_RANKS - 1, N_RANKS):
        times = [st["s"] for rr in res.values() for st in rr["steps"]
                 if st["world"] == size and not st["first"]]
        if times:
            print(f"[heal] steady step at {size} ranks on {card}: slowest rank "
                  f"{max(times) * 1e3:.1f} ms, median {statistics.median(times) * 1e3:.1f} ms "
                  f"({len(times)} rank-steps)")
    losses = [st["loss"] for st in r0["steps"]]
    print(f"[heal] {N_RANKS} -> {N_RANKS - 1} -> {N_RANKS} ranks, losses "
          f"{' '.join(f'{x:.4f}' for x in losses)}, first {first:.4f} vs phase cut-ref's "
          f"{cut_loss1:.4f}; survivors bit-equal to their source after the heal's sync, B5 + "
          f"B6 on the healed group bit-equal to the plain version, the joiner bit-equal to rank "
          f"0, replicas bit-identical at the end; host peak per rank {peaks} GiB; rank 0 "
          f"launches {json.dumps(r0['launches'])}; the phase "
          f"{time.perf_counter() - t_phase:.1f} s")
    return {k.name: r0["launches"][k.name] for k in (*flash.KERNELS, RC.RING_RS, RC.RING_AG)}


def start_coordinator_drill():
    """Phase controlplane (a) in the background: `python -m
    kungfu_tpu_torch.chaos --coordinator-drill --replicas 3`, host traffic
    against an ensemble of its own; (its process, its directory, its
    start).  The smoke starts it beside the one-process phases, whose
    host is mostly idle while the card works."""
    import tempfile

    tmp = tempfile.mkdtemp(prefix="kft-drill-")
    env = dict(os.environ)
    env["PYTHONPATH"] = HERE + (os.pathsep + env["PYTHONPATH"] if env.get("PYTHONPATH") else "")
    env.pop("KFT_JOURNAL_DIR", None)
    proc = subprocess.Popen(
        [sys.executable, "-m", "kungfu_tpu_torch.chaos", "--coordinator-drill", "--replicas",
         str(CP_REPLICAS), "--json", os.path.join(tmp, "drill.json")],
        cwd=HERE, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return proc, tmp, time.perf_counter()


def phase_controlplane(card: str, batch: int, seed: int, bucket_mib: int, cut_loss1: float,
                       drill=None):
    """KungFu's replicated control plane: (a) the coordinator drill, `python
    -m kungfu_tpu_torch.chaos --coordinator-drill --replicas 3` (`drill`,
    from start_coordinator_drill, or started here); (b) the flagship (cut
    to CUT_LAYERS layers) on N_RANKS ranks under `run -w -config-replicas 3` (this
    script's launcher wrapper holds the ensemble): the leader SIGKILLed
    after step CP_KILL_AT, the shrink to 2 proposed by rank 0 through the
    failover client once the next leader is up, landing at step 4.
    Returns rank 0's launches in (b)."""
    import glob
    import shutil
    import tempfile

    from kungfu_tpu_torch.monitor.journal import read_journal_segments
    from kungfu_tpu_torch.ops import flash
    from kungfu_tpu_torch.ops import ring_collectives as RC

    t_phase = time.perf_counter()
    drill = drill if drill is not None else start_coordinator_drill()
    tmp = tempfile.mkdtemp(prefix="kft-controlplane-")
    env = dict(os.environ)
    env["PYTHONPATH"] = HERE + (os.pathsep + env["PYTHONPATH"] if env.get("PYTHONPATH") else "")
    try:
        # (a) the drill: host traffic against an ensemble of its own
        proc, drill_dir, t_drill0 = drill
        try:
            out_a = proc.communicate(timeout=300)[0]
            with open(os.path.join(drill_dir, "drill.json")) as f:
                summary = json.load(f)
        finally:
            shutil.rmtree(drill_dir, ignore_errors=True)
        if proc.returncode != 0:
            print(out_a[-6000:], file=sys.stderr)
            raise SmokeFailure(f"controlplane: the coordinator drill exited {proc.returncode}")
        check(summary["ok"], f"controlplane: the drill's failures {summary['failures']}")
        t_drill = time.perf_counter() - t_drill0
        print("[controlplane] (a) " + out_a.strip().splitlines()[-1])
        print(f"[controlplane] (a) drill summary {json.dumps(summary)}")

        # (b) the flagship under the launcher's ensemble
        jdir = os.path.join(tmp, "journal")
        torch.cuda.empty_cache()  # the ranks share the card with this process
        t_b0 = time.time()
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--rank-phase", "controlplane-launcher",
             tmp, "-w", "-np", str(N_RANKS), "-config-replicas", str(CP_REPLICAS), "-timeout",
             str(CP_TIMEOUT), "--", sys.executable, os.path.abspath(__file__), "--rank-phase",
             "controlplane", "--batch", str(batch), "--seed", str(seed), "--bucket-mib",
             str(bucket_mib), "--drill-dir", tmp],
            cwd=HERE, env=dict(env, KFT_JOURNAL_DIR=jdir,
                               PYTORCH_CUDA_ALLOC_CONF="expandable_segments:True"),
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, timeout=CP_TIMEOUT + 60)
        t_b1 = time.time()
        events = [e for path in sorted(glob.glob(os.path.join(jdir, "journal-*.jsonl")))
                  for e in read_journal_segments(path)]
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    lines = proc.stdout.splitlines()
    res, left = {}, []
    for line in lines:
        m = re.match(r"^\[(\d+)\] (" + re.escape(CP_LINE) + "|" + re.escape(CP_LEFT) + r")(.*)$",
                     line)
        if m:
            rec = json.loads(m.group(3))
            if m.group(2) == CP_LINE:
                res[rec["rank"]] = rec
            else:
                left.append(rec)
    runner = next((json.loads(line.split(CP_RUNNER, 1)[1]) for line in lines
                   if line.startswith(CP_RUNNER)), None)
    if proc.returncode != 0 or sorted(res) != [0, 1] or len(left) != 2 or runner is None:
        print(proc.stdout[-12000:], file=sys.stderr)
        raise SmokeFailure(f"controlplane: launcher exit {proc.returncode}, results from ranks "
                           f"{sorted(res)}, {len(left)} detached ranks' records, runner record "
                           f"{runner is not None}")
    for line in lines:
        if "[controlplane]" in line and " step " not in line:
            print(line)
    r0 = res[0]
    results = [line for line in lines if re.match(r"^\[\d+\] RESULT: controlplane ", line)]
    check(len(results) == 2 and all(f"trained={CP_SAMPLES} " in x and "final_size=2 " in x
                                     for x in results),
          f"controlplane: RESULT lines {results}")
    check(runner["epoch1"] is not None and runner["epoch1"] > runner["epoch0"],
          f"controlplane: the leader's epoch did not move: {runner}")
    check(runner["converged"], f"controlplane: the respawned replica {runner['killed']} did not "
          f"converge to the leader's commit: {runner['statuses']}")
    kinds = {}
    for e in events:
        kinds.setdefault(e.get("event"), []).append(e)
    epochs = {e["leader_epoch"] for e in kinds.get("leader_elected", [])}
    check(len(epochs) >= 2 and runner["epoch1"] in epochs,
          f"controlplane: leader_elected epochs journaled {sorted(epochs)}")
    check([e["replica"] for e in kinds.get("replica_respawned", [])] == [runner["killed"]],
          f"controlplane: replica_respawned events {kinds.get('replica_respawned')}")
    check(r0["proposals"] == [True], f"controlplane: rank 0's CAS proposals {r0['proposals']}")
    for who, rr in [*(("rank %d" % r, rr) for r, rr in res.items()),
                    *(("a detached rank", rr) for rr in left)]:
        check(rr["urls"] == CP_REPLICAS, f"controlplane: {who} saw {rr['urls']} config URLs")
        check(all(st["launches"] == st["want"] for st in rr["steps"]),
              f"controlplane: {who}'s launches in its steps "
              f"{json.dumps([(st['step'], st['launches']) for st in rr['steps']])}")
        check(all(math.isfinite(st["loss"]) for st in rr["steps"]), f"controlplane: {who}'s loss")
    check([(st["step"], st["world"]) for st in r0["steps"]]
          == [(i, N_RANKS if i <= CP_SHRINK_AT else 2) for i in range(1, 7)],
          f"controlplane: rank 0's steps {[(st['step'], st['world']) for st in r0['steps']]}: "
          f"the shrink must land at step {CP_SHRINK_AT}")
    check(res[1]["final_checksum"] == r0["final_checksum"],
          "controlplane: the survivors' parameters differ after the last step")
    losses = [st["loss"] for st in r0["steps"]]
    check(abs(losses[0] - cut_loss1) <= TOL_RANKS_LOSS,
          f"controlplane: first-step loss {losses[0]} vs phase cut-ref's {cut_loss1}")
    ev = r0["resize_events"][0]
    print(f"[controlplane] (b) on {card}: replica {runner['killed']} (the leader of epoch "
          f"{runner['epoch0']}) SIGKILLed after step {CP_KILL_AT}; replica {runner['leader1']} "
          f"led epoch {runner['epoch1']} {runner['elect_s']:.2f} s later; the respawned replica "
          f"at the leader's commit {runner['converge_s']:.2f} s after the kill; rank 0's "
          f"proposal {'committed' if r0['proposals'] == [True] else 'FAILED'}, held "
          f"{r0['held_s']:.2f} s for the election; the shrink {ev['old_size']} -> "
          f"{ev['new_size']} in {ev['total_s']:.2f} s, phases (s) {json.dumps(ev['phases'])}")
    t_end = time.time()
    print(f"[controlplane] (b) timeline on {card} (s from the launcher's start): ranks started "
          f"{min(rr['t_start'] for rr in res.values()) - t_b0:.1f}, first step done "
          f"{r0['steps'][0]['t'] - t_b0:.1f}, step {CP_SHRINK_AT} done "
          f"{r0['steps'][CP_SHRINK_AT - 1]['t'] - t_b0:.1f}, last step done "
          f"{r0['steps'][-1]['t'] - t_b0:.1f}, run_elastic returned {r0['t_done'] - t_b0:.1f}, "
          f"launcher exited {t_b1 - t_b0:.1f} (records read {t_end - t_b0:.1f})")
    for size in (N_RANKS, 2):
        times = [st["s"] for rr in res.values() for st in rr["steps"]
                 if st["world"] == size and not st["first"]]
        times += [st["s"] for rr in left for st in rr["steps"]
                  if st["world"] == size and not st["first"]]
        if times:
            print(f"[controlplane] steady step at {size} ranks on {card}: slowest rank "
                  f"{max(times) * 1e3:.1f} ms, median {statistics.median(times) * 1e3:.1f} ms")
    print(f"[controlplane] {N_RANKS} -> 2 ranks through a leader kill, losses "
          f"{' '.join(f'{x:.4f}' for x in losses)}, first {losses[0]:.4f} vs phase cut-ref's "
          f"{cut_loss1:.4f}; survivors bit-identical; journal {len(epochs)} leader_elected "
          f"epochs, {len(kinds.get('replica_respawned', []))} replica_respawned; rank 0 launches "
          f"{json.dumps(r0['launches'])}; (a) {t_drill:.1f} s from its start, the phase "
          f"{time.perf_counter() - t_phase:.1f} s")
    return {k.name: r0["launches"][k.name] for k in (*flash.KERNELS, RC.RING_RS, RC.RING_AG)}


def phase_mesh(batch: int, seed: int, bucket_mib: int, cut_loss1: float):
    """The flagship (cut to CUT_LAYERS layers) on the model axes: one
    launch of N_RANKS ranks running MESH_PARTS in turn (`mesh_part`).
    Gates: each rank's own checks (loss finite and falling, the ranks that
    hold one shard of a parameter bit-identical, exact launches), the
    first losses of (a) and (c) within TOL_MESH_LOSS of phase cut-ref's and
    (b)'s of rank 0's one-process MoE model.  Returns rank 0's launches
    by part."""
    out, res = spawn_ranks(["mesh", "--batch", str(batch), "--seed", str(seed),
                            "--bucket-mib", str(bucket_mib)], MESH_LINE, 600)
    for line in out.splitlines():
        if "[mesh]" in line:
            print(line)
    for r, rr in sorted(res.items()):
        for part, pr in rr["parts"].items():
            check(all(pr["checks"].values()),
                  f"mesh: rank {r} part {part} failed "
                  f"{json.dumps({k: v for k, v in pr['checks'].items() if not v})}; launches "
                  f"{json.dumps(pr['launches'])}, expected {json.dumps(pr['expected_launches'])}")
    parts = res[0]["parts"]
    refs = {"tp": (cut_loss1, "phase cut-ref's"), "pp": (cut_loss1, "phase cut-ref's"),
            "ep": (parts["ep"]["reference_loss"], "the one-process MoE model's")}
    for name, pr in parts.items():
        ref, what = refs[name]
        loss1 = pr["losses"][0]
        check(abs(loss1 - ref) <= TOL_MESH_LOSS,
              f"mesh: part {name}'s first-step loss {loss1} vs {what} {ref}")
        step_s = max(res[r]["parts"][name]["step_s"] for r in res)
        peaks = " ".join(f"{res[r]['parts'][name]['peak_gib']:.2f}" for r in sorted(res))
        extra = ""
        if name == "tp":
            extra = f"; the tp all-reduces {pr['tp_route']}"
        if name == "ep":
            extra = (f"; moe_dropped by step and MoE layer {json.dumps(pr['dropped'])}, the aux "
                     f"loss (summed over the MoE layers) by step "
                     f"{' '.join(f'{x:.5f}' for x in pr['aux'])}")
        if name == "pp":
            extra = (f"; the schedule leaves {pr['idle_ticks']} of {pr['ticks']} ticks idle "
                     f"on each stage (bubble share {pr['idle_ticks'] / pr['ticks']:.3f})")
        print(f"[mesh] part {name} ({json.dumps(pr['mesh'])}): losses "
              f"{' '.join(f'{x:.4f}' for x in pr['losses'])}, first step {loss1:.4f} vs {what} "
              f"{ref:.4f}; shards bit-identical where held alike; launches exact on every "
              f"rank; steady step {step_s * 1e3:.1f} ms (slowest rank, median of steps "
              f"2-{MESH_STEPS}), {batch * 2048 / step_s:.0f} tokens/s, peak memory per rank "
              f"{peaks} GiB; rank 0 launches {json.dumps(pr['launches'])}{extra}")
    return {name: pr["launches"] for name, pr in parts.items()}


def phase_shift(seed: int):
    """B11 on N_RANKS ranks against its stacked plain version, interleaved
    with B5-B8; its time, the plain version's and the bound."""
    from kungfu_tpu_torch.ops import fused_matmul as FM

    _, res = spawn_ranks(["shift", "--gossip", str(GOSSIP_SHIFT_BYTES), "--interleave",
                          "--faults", "--beside-flash", "--grid", SHIFT_GRIDS, "--iters", "20",
                          "--seed", str(seed)], "SHIFT_CHECK ", 600)
    for r, rr in sorted(res.items()):
        bad = [k for k, v in rr["ok"].items() if not v]
        check(rr["ok_all"], f"shift rank {r}: failed {bad}, max abs err "
              f"{json.dumps(rr['max_abs_err'])}")
    r0 = res[0]
    t0 = r0["timing"]
    ms = max(rr["timing"]["ms"] for rr in res.values())
    lib = (max(rr["timing"]["library_ms"] for rr in res.values())
           if t0["library_ms"] is not None else None)
    err = max(v for rr in res.values() for v in rr["max_abs_err"].values())
    print(f"[shift] {N_RANKS} ranks, backend {r0['backend']}, {r0['card']}: every rank's "
          f"shifts ({', '.join(k for k in r0['ok'] if 'rejects' not in k)}) equal the stacked "
          f"plain version bit for bit; planted faults rejected; launches on rank 0 "
          f"{json.dumps(r0['launches'])}")
    print(f"[shift] K/V pair {r0['kv']} bf16 x 2 ({t0['bytes'] / 1e6:.1f} MB) at +1: kernel "
          f"{ms:.3f} ms (slowest rank; {r0['timing']['how']}; grid {FM.SHIFT_GRID}), "
          + (f"device alone {max(rr['timing']['device_ms'] for rr in res.values()):.3f} ms, "
             if "device_ms" in t0 else "") + f"host issue "
          f"{max(rr['timing']['host_ms'] for rr in res.values()):.3f} ms, plain "
          f"{t0['plain_ms']:.3f} ms (all ranks in one "
          f"process), bound {t0['bound_ms']:.4f} ms ({t0['bound_note']}), library "
          f"{f'{lib:.3f} ms (NCCL batch_isend_irecv)' if lib is not None else 'null: ' + t0['library_note']}")
    grid = {g: max(rr["grid_ms"][g] for rr in res.values()) for g in r0["grid_ms"]}
    print(f"[shift] grid sweep, the pair bit-equal at every grid, ms (slowest rank): "
          + ", ".join(f"{g} blocks {t:.3f}" for g, t in grid.items()))
    side = {k: max(rr["beside_flash_ms"][k] for rr in res.values())
            for k in ("flash", "shift", "both")}
    print(f"[shift] beside a flash forward on the current stream (both bit-equal to their "
          f"results alone), ms (slowest rank): flash {side['flash']:.3f}, shift "
          f"{side['shift']:.3f}, both {side['both']:.3f} ({r0['beside_flash_ms']['how']})")
    name = FM.SHIFT.name
    return ({name: err}, {name: ms}, {name: t0["plain_ms"]}, {name: lib},
            {name: (t0["bound_ms"], "bytes")})


def phase_sp_reference(seed: int):
    """The 8192-position flagship's loss on phase sp's sequences, one process."""
    from kungfu_tpu_torch.models import lm_loss
    from kungfu_tpu_torch.tools.step_profile import flagship_model, flagship_tokens

    cfg, model = flagship_model(seed, "cuda", max_len=SP_SEQ)
    tokens = flagship_tokens(cfg, SP_BATCH, seed)
    with torch.no_grad():
        loss = lm_loss(model(tokens), tokens).item()
    check(math.isfinite(loss), f"sp-ref: non-finite loss {loss}")
    print(f"[sp-ref] flagship at {SP_SEQ} positions, {SP_BATCH} sequences, flash attention over "
          f"the whole sequence in one process: loss {loss:.4f}")
    del model
    torch.cuda.empty_cache()
    return loss


def phase_sp(steps: int, seed: int, bucket_mib: int, ref_loss: float):
    """The sequence-parallel flagship step on N_RANKS ranks (dp=1 x sp=4),
    ring attention, then phase ulysses in the same ranks.  Returns rank
    0's launches of phase sp and of phase ulysses by part."""
    out, res = spawn_ranks(["sp", "--steps", str(steps), "--seed", str(seed), "--bucket-mib",
                            str(bucket_mib)], SP_LINE, 900)
    for line in out.splitlines():
        if "[sp]" in line:
            print(line)
    for r, rr in sorted(res.items()):
        check(rr["ok"], f"sp: rank {r} failed its checks: {json.dumps(rr['checks'])}; "
              f"launches {json.dumps(rr['launches'])}, expected "
              f"{json.dumps(rr['expected_launches'])}")
    r0 = res[0]
    loss1 = r0["losses"][0]
    check(abs(loss1 - ref_loss) <= TOL_SP_LOSS,
          f"sp: first-step loss {loss1} vs phase sp-ref's {ref_loss}")
    step_s = max(rr["step_s"] for rr in res.values())
    peaks = " ".join(f"{res[r]['peak_gib']:.2f}" for r in sorted(res))
    print(f"[sp] {N_RANKS} ranks as dp=1 x sp=4 ({r0['backend']}, {r0['buckets']} buckets of at "
          f"most {bucket_mib} MiB), {SP_BATCH} x {SP_SEQ} tokens a step: losses "
          f"{' '.join(f'{x:.4f}' for x in r0['losses'])}, first step {loss1:.4f} vs phase "
          f"sp-ref's {ref_loss:.4f}; replicas bit-identical; launches exact on every rank; "
          f"steady step {step_s * 1e3:.1f} ms (slowest rank), {SP_BATCH * SP_SEQ / step_s:.0f} "
          f"tokens/s, peak memory per rank {peaks} GiB; launches per rank "
          + "; ".join(f"{r}: {json.dumps(res[r]['launches'])}" for r in sorted(res)))
    return r0["launches"], phase_ulysses(ref_loss, out)


def phase_ulysses(ref_loss: float, out: str):
    """The flagship at SP_SEQ positions on N_RANKS ranks (dp=1 x sp=4) with
    Ulysses attention: (a) the dense head, (b) head="hidden", (c) GQA, run
    by phase sp's ranks after its own steps (`out`, their output: no
    second start-up).  Returns rank 0's launches by part."""
    from kungfu_tpu_torch.utils.compare import REL_LIMIT

    res = {}
    for line in out.splitlines():
        m = re.match(r"^\[(\d+)\] " + re.escape(ULYSSES_LINE) + r"(.*)$", line)
        if m:
            res[int(m.group(1))] = json.loads(m.group(2))
    check(sorted(res) == list(range(N_RANKS)),
          f"ulysses: results from ranks {sorted(res)} in phase sp's output")
    for line in out.splitlines():
        if "[ulysses]" in line:
            print(line)
    for r, rr in sorted(res.items()):
        for part, pr in rr["parts"].items():
            check(all(pr["checks"].values()),
                  f"ulysses: rank {r} part {part} failed "
                  f"{json.dumps({k: v for k, v in pr['checks'].items() if not v})}; launches "
                  f"{json.dumps(pr['launches'])}, expected {json.dumps(pr['expected_launches'])}")
    parts = res[0]["parts"]
    dense, hidden, gqa = parts["dense"], parts["hidden"], parts["gqa"]
    loss1 = dense["losses"][0]
    check(abs(loss1 - ref_loss) <= TOL_SP_LOSS,
          f"ulysses: first-step loss {loss1} vs phase sp-ref's {ref_loss}")
    check(abs(hidden["losses"][0] - loss1) <= TOL_CHUNKED_LOSS,
          f"ulysses: the chunked head's loss {hidden['losses'][0]} vs the dense head's {loss1}")
    step_s = max(rr["parts"]["dense"]["step_s"] for rr in res.values())
    for name, pr in parts.items():
        peaks = " ".join(f"{res[r]['parts'][name]['peak_gib']:.2f}" for r in sorted(res))
        slowest = max(res[r]["parts"][name]["step_s"] for r in res)
        which = "median of steps 2-n" if len(pr["losses"]) > 1 else "its one step"
        print(f"[ulysses] part {name}: losses {' '.join(f'{x:.4f}' for x in pr['losses'])}; "
              f"step {slowest * 1e3:.1f} ms (slowest rank, {which}), peak memory per rank "
              f"{peaks} GiB; rank 0 launches {json.dumps(pr['launches'])}")
        if "against_flash" in pr:
            worst = {k: max(res[r]["parts"][name]["against_flash"][k] for r in res)
                     for k in pr["against_flash"]}
            print(f"[ulysses] part {name}: one layer's attention ({SP_BATCH} x {SP_SEQ}, "
                  f"{pr['heads']} heads, {pr['kv_heads']} kv heads, bf16) against flash over the "
                  f"gathered sequence, worst block's normwise relative error over the ranks "
                  + ", ".join(f"{k} {v:.3g}" for k, v in worst.items())
                  + f" (limit {REL_LIMIT[torch.bfloat16]})")
    print(f"[ulysses] {N_RANKS} ranks as dp=1 x sp=4 ({res[0]['backend']}), {SP_BATCH} x {SP_SEQ} "
          f"tokens a step, the all_to_all {res[0]['exchange']}: first step {loss1:.4f} vs phase "
          f"sp-ref's {ref_loss:.4f}, the chunked head's {hidden['losses'][0]:.4f}, GQA "
          f"{gqa['losses'][0]:.4f}; replicas bit-identical; launches exact on every rank; "
          f"steady step {step_s * 1e3:.1f} ms (slowest rank), {SP_BATCH * SP_SEQ / step_s:.0f} "
          f"tokens/s")
    return {name: pr["launches"] for name, pr in parts.items()}


def phase_fused(seed: int):
    """B9 and B10's product body alone on this card against the f32
    product, with its times beside torch.matmul's; then B9 and B10 on
    N_RANKS ranks against their stacked plain versions: their times, the
    plain versions', the library arm's and the bounds."""
    from kungfu_tpu_torch.ops import fused_matmul as FM
    from kungfu_tpu_torch.tools import fused_time

    body = fused_time.measure(fused_time.shapes((4096, 1024, 4096), N_RANKS), 20, 2, seed,
                              torch.device("cuda"))
    for name, r in body.items():
        check(r["ok"], f"fused: the product body at {name} {r['shape']}: integer operands "
              f"exact {r['int_exact']}, worst 64-row block {r['rand_worst_block']:.3g}")
    def ms(v):
        return "not measured" if v is None else f"{v:.4f}"

    print("[fused] product body alone (mm_product, bf16, no peers) against the f32 product "
          "(integer operands bit for bit, normal ones within the bf16 limit), ms (mean of 20 "
          "calls between CUDA events, best of 2; device time from the profiler): " + "; ".join(
              f"{name} {r['shape']}: kernel {ms(min(r['kernel_ms']))} (device "
              f"{ms(r['kernel_device_ms'])}), torch.matmul {ms(min(r['library_ms']))} (device "
              f"{ms(r['library_device_ms'])}), bound {ms(r['bound_ms'])} ({r['bound_by']})"
              for name, r in body.items()))
    _, res = spawn_ranks(["fused", "--faults", "--iters", "5", "--seed", str(seed)],
                         "FUSED_CHECK ", 600)
    for r, rr in sorted(res.items()):
        bad = [k for k, v in rr["ok"].items() if not v]
        check(rr["ok_all"], f"fused rank {r}: failed {bad}, max abs err "
              f"{json.dumps(rr['max_abs_err'])}")
    r0 = res[0]
    print(f"[fused] {N_RANKS} ranks, backend {r0['backend']}, {r0['card']}: every rank's "
          f"all-gather-matmul and matmul-reduce-scatter at {json.dumps(r0['shapes'])} equal the "
          f"stacked plain versions (integer operands bit for bit; random ones, worst 64-row "
          f"block {max(max(rr['worst_block_rel_err'].values()) for rr in res.values()):.3g}); "
          f"planted faults rejected; launches on rank 0 {json.dumps(r0['launches'])}")
    out = tuple({} for _ in range(5))
    for kind, kern in (("b9", FM.AG_MATMUL), ("b10", FM.MATMUL_RS)):
        t0 = r0["timing"][kind]
        ms = max(rr["timing"][kind]["ms"] for rr in res.values())
        lib = (max(rr["timing"][kind]["library_ms"] for rr in res.values())
               if t0["library_ms"] is not None else None)
        err = max(v for rr in res.values() for k, v in rr["max_abs_err"].items()
                  if k.startswith(kind + " "))
        print(f"[fused] {kern.name} ({kind.upper()}) at {t0['shapes']} bf16: kernel {ms:.3f} ms "
              f"(slowest rank; {t0['how']}), plain {t0['plain_ms']:.3f} ms (all ranks in one "
              f"process), bound {t0['bound_ms']:.4f} ms ({t0['bound_by']}), library "
              f"{f'{lib:.3f} ms (NCCL unfused arm)' if lib is not None else 'null: ' + t0['library_note']}")
        for d, v in zip(out, (err, ms, t0["plain_ms"], lib, (t0["bound_ms"], t0["bound_by"]))):
            d[kern.name] = v
    return out, r0["launches"]


def phase_fsdp(steps: int, batch: int, seed: int, main_loss1: float, ranks_losses):
    """The flagship's FSDP step on N_RANKS ranks (fsdp=4) through B6/B5."""
    out, res = spawn_ranks(["fsdp", "--steps", str(steps), "--batch", str(batch), "--seed",
                            str(seed)], FSDP_LINE, 900)
    for line in out.splitlines():
        if "[fsdp]" in line:
            print(line)
    for r, rr in sorted(res.items()):
        check(rr["ok"], f"fsdp: rank {r} failed its checks: {json.dumps(rr['checks'])}; "
              f"launches {json.dumps(rr['launches'])}, expected "
              f"{json.dumps(rr['expected_launches'])}")
    r0 = res[0]
    losses = r0["losses"]
    check(abs(losses[0] - main_loss1) <= TOL_FSDP_LOSS,
          f"fsdp: first-step loss {losses[0]} vs phase main's {main_loss1}")
    worst = max(abs(a - b) for a, b in zip(losses, ranks_losses))
    check(worst <= TOL_FSDP_LOSS, f"fsdp: losses {losses} vs phase ranks' {ranks_losses}")
    step_s = max(rr["step_s"] for rr in res.values())
    peaks = " ".join(f"{res[r]['peak_gib']:.2f}" for r in sorted(res))
    held = " ".join(f"{res[r]['init_gib']:.2f}" for r in sorted(res))
    held1 = " ".join(f"{res[r]['step1_gib']:.2f}" for r in sorted(res))
    print(f"[fsdp] {N_RANKS} ranks as fsdp=4 ({r0['backend']}), {batch} x 2048 tokens a step: "
          f"losses {' '.join(f'{x:.4f}' for x in losses)}, first step {losses[0]:.4f} vs phase "
          f"main's {main_loss1:.4f}, every step within {worst:.4f} of phase ranks'; launches "
          f"exact on every rank (B5 and B6 once a bucket a step: {r0['buckets']} buckets of "
          f"{r0['leaves']} parameters); memory after init {held} GiB a rank (limit "
          f"{r0['limit_gib']:.2f}: {FSDP_MEMORY_SHARE} of a replica's parameters and Adam "
          f"state), after step 1 {held1} (limit {r0['step1_limit_gib']:.2f}: with its "
          f"gradients); steady step {step_s * 1e3:.1f} ms (slowest rank), "
          f"{batch * 2048 / step_s:.0f} tokens/s, peak memory per rank {peaks} GiB; rank 0 "
          f"launches {json.dumps(r0['launches'])}")


def rank_train(argv) -> int:
    """One rank of phase ranks (run by the launcher)."""
    import torch.distributed as dist

    from kungfu_tpu_torch import distributed
    from kungfu_tpu_torch.compression import error_feedback as EF
    from kungfu_tpu_torch.ops import flash
    from kungfu_tpu_torch.ops import ring_collectives as RC
    from kungfu_tpu_torch.optimizers.sync import _pack_buckets
    from kungfu_tpu_torch.tools.step_profile import flagship_step

    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--bucket-mib", type=int, default=256)
    ap.add_argument("--n-kv-heads", type=int, default=0)
    ap.add_argument("--compression", default=None)
    args = ap.parse_args(argv)
    tf32_off()
    world = distributed.init_distributed(device="cuda")
    rank = dist.get_rank()
    bucket = args.bucket_mib << 20
    cfg, trainer, state, tokens = flagship_step(args.batch, args.seed, impl="pallas_ring",
                                                bucket_bytes=bucket or None,
                                                compression=args.compression,
                                                n_kv_heads=args.n_kv_heads)
    per = args.batch // world
    batch = tokens[rank * per:(rank + 1) * per]
    params = list(state.params.parameters())
    buckets = len(_pack_buckets(params, bucket)) if bucket else len(params)
    kernels = flash.KERNELS + RC.KERNELS + EF.KERNELS
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for kern in kernels:
        kern.launches = 0
    losses, times = [], []
    for step in range(args.steps):
        t0 = time.perf_counter()
        state, metrics = trainer.train_step(state, batch)
        losses.append(metrics["loss"].item())  # waits for the step
        times.append(time.perf_counter() - t0)
        print(f"[ranks] rank {rank} step {step + 1}: loss {losses[-1]:.4f}, "
              f"{times[-1] * 1e3:.1f} ms", flush=True)
    launches = {k.name: k.launches for k in kernels}
    sums = [p.detach().view(torch.int32).to(torch.int64).sum().item() for p in params]
    every = [None] * world
    dist.all_gather_object(every, sums)
    gqa = cfg.kv_heads < cfg.n_heads
    per_layer = {flash.FLASH_FWD: True, flash.FLASH_BWD_DQ: True,
                 flash.FLASH_BWD_DKV: not gqa, flash.FLASH_BWD_DKV_GQA: gqa}
    per_bucket = {RC.RING_RS: not args.compression, RC.RING_AG: not args.compression,
                  RC.FUSED_RS: bool(args.compression), RC.FUSED_AG: bool(args.compression)}
    want = {k.name: cfg.n_layers * args.steps * on for k, on in per_layer.items()}
    want.update({k.name: buckets * args.steps * on for k, on in per_bucket.items()})
    # the residuals of a step's gradients: one grouped launch a table
    want[EF.EF_RESIDUAL.name] = (len(EF.ef_plan([p.numel() for p in params])) * args.steps
                                 * bool(args.compression))
    checks = {
        "loss finite": all(math.isfinite(x) for x in losses),
        "loss falls": losses[-1] < losses[0],
        "replicas bit-identical": all(s == every[0] for s in every),
        "launches": launches == want,
        "no JAX": jax_free(),
    }
    result = {"rank": rank, "backend": dist.get_backend(), "losses": losses,
              "step_s": statistics.median(times[1:]) if args.steps > 1 else times[0],
              "peak_gib": torch.cuda.max_memory_allocated() / 2**30, "buckets": buckets,
              "kv_heads": cfg.kv_heads,
              "launches": launches, "expected_launches": want, "checks": checks,
              "ok": all(checks.values())}
    print(RANKS_LINE + json.dumps(result), flush=True)
    distributed.shutdown_distributed()
    return 0 if result["ok"] else 1


def rank_adaptive(argv) -> int:
    """One rank of phase adaptive (run by the launcher): runs (a)-(c) in turn."""
    import gc

    import torch.distributed as dist

    from kungfu_tpu_torch import distributed
    from kungfu_tpu_torch import variables as V
    from kungfu_tpu_torch.compression import error_feedback as EF
    from kungfu_tpu_torch.ops import flash
    from kungfu_tpu_torch.ops import ring_collectives as RC
    from kungfu_tpu_torch.optimizers import (adamw, adaptive_sgd, get_compression_state,
                                             get_noise_scale, gradient_noise_scale,
                                             noise_adaptive_compression, synchronous_sgd)
    from kungfu_tpu_torch.optimizers.sync import _pack_buckets
    from kungfu_tpu_torch.policy import BasePolicy
    from kungfu_tpu_torch.tools.step_profile import (flagship_model, flagship_tokens,
                                                     lm_step_loss)
    from kungfu_tpu_torch.train import DataParallelTrainer

    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--bucket-mib", type=int, default=256)
    args = ap.parse_args(argv)
    tf32_off()
    world = distributed.init_distributed(device="cuda")
    rank = dist.get_rank()
    per = args.batch // world
    bucket = args.bucket_mib << 20
    kernels = flash.KERNELS + RC.KERNELS + EF.KERNELS

    def run(tx, steps, per_replica=False, read=None, final_loss=False):
        """`steps` steps of fit on this rank's rows of the flagship batch,
        a policy timing each step and taking the parameters' checksum;
        with `final_loss`, the mean over ranks of the final parameters'
        loss on each rank's rows, as the trainer's loss metric is taken."""
        cfg, model = flagship_model(args.seed, "cuda")
        trainer = DataParallelTrainer(lm_step_loss, tx, per_replica_params=per_replica,
                                      device="cuda")
        state = trainer.init(model)
        rows = flagship_tokens(cfg, args.batch, args.seed)[rank * per:(rank + 1) * per]
        params = list(model.parameters())
        opt = state.opt_state
        rec = {"events": [], "losses": [], "times": [], "sums": [], "read": []}

        class Probe(BasePolicy):
            def before_step(self):
                rec["events"].append("before")
                self.t0 = time.perf_counter()

            def after_step(self, metrics=None):
                rec["losses"].append(metrics["loss"].item())  # waits for the step
                rec["times"].append(time.perf_counter() - self.t0)
                rec["events"].append("after")
                # each parameter's checksum, as phase ranks gathers them
                rec["sums"].append(tuple(p.detach().view(torch.int32).to(torch.int64).sum().item()
                                         for p in params))
                if read is not None:
                    rec["read"].append(read(opt))

        V.global_variables().reset()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for kern in kernels:
            kern.launches = 0
        state, _ = trainer.fit(state, iter(lambda: rows, None), steps, log_every=0,
                               policies=[Probe()])
        launches = {k.name: k.launches for k in kernels}
        every = [None] * world
        dist.all_gather_object(every, rec["sums"])
        distinct = [len({sums[i] for sums in every}) for i in range(steps)]
        want = {k.name: 0 for k in kernels}
        for k in (flash.FLASH_FWD, flash.FLASH_BWD_DQ, flash.FLASH_BWD_DKV):
            want[k.name] = cfg.n_layers * steps
        result = {"layers": cfg.n_layers, "losses": rec["losses"],
                  "buckets": len(_pack_buckets(params, bucket)) if bucket else len(params),
                  "step_s": statistics.median(rec["times"][1:]),
                  "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
                  "launches": launches, "distinct_sums": distinct,
                  "trained_samples": V.get_variable(V.TRAINED_SAMPLES),
                  "checks": {"loss finite": all(math.isfinite(x) for x in rec["losses"]),
                             "policy saw every step": rec["events"] == ["before", "after"] * steps}}
        if final_loss:
            with torch.no_grad():
                loss = lm_step_loss(model, rows).float()
            dist.all_reduce(loss)
            result["final_loss"] = loss.item() / world
        del state, trainer, model, params, opt
        gc.collect()
        torch.cuda.empty_cache()
        return result, want, rec["read"]

    runs = {}
    # (a) AdaptiveSGD per replica: SMA, then rank 0's model and S-SGD
    a, want, _ = run(adaptive_sgd(lambda ps: torch.optim.SGD(ps, lr=ADAPTIVE_SGD_LR),
                                       switch_step=ADAPTIVE_SWITCH, alpha=0.1),
                     ADAPTIVE_STEPS, per_replica=True, final_loss=True)
    sums, losses = a["distinct_sums"], a["losses"]
    # Before the switch each replica learns its own rows, taken again each
    # step; after it every rank holds rank 0's model, whose loss on the
    # other ranks' rows is higher: the step after the switch can read more
    # than the step before it, so the loss is held to fall on each side.
    a["checks"].update({
        "loss falls": losses[-1] < losses[0],
        "loss falls on each replica's rows before the switch": all(
            x > y for x, y in zip(losses[:ADAPTIVE_SWITCH + 1], losses[1:ADAPTIVE_SWITCH + 1])),
        "loss falls on the global batch after the switch": all(
            x > y for x, y in zip(losses[ADAPTIVE_SWITCH + 1:],
                                  losses[ADAPTIVE_SWITCH + 2:] + [a["final_loss"]])),
        "replicas apart before the switch": all(d > 1 for d in sums[:ADAPTIVE_SWITCH]),
        "replicas bit-identical from the switch": all(d == 1 for d in sums[ADAPTIVE_SWITCH:]),
        "kungfu_trained_samples": a["trained_samples"] == ADAPTIVE_STEPS * per * world,
    })
    runs["a"] = (a, want)
    # (b) the GNS monitor over phase ranks' S-SGD: the same update, bit for bit
    b, want, ns = run(gradient_noise_scale(
        synchronous_sgd(adamw(3e-4, b1=0.9, b2=0.95), impl="pallas_ring",
                        bucket_bytes=bucket or None), local_batch_size=per),
        args.steps, read=lambda opt: get_noise_scale(opt).item())
    for k in (RC.RING_RS, RC.RING_AG):  # once a bucket a step, as in phase ranks
        want[k.name] = b["buckets"] * args.steps
    b["noise_scale"] = ns
    b["checks"].update({"noise scale finite": all(math.isfinite(x) for x in ns),
                        "replicas bit-identical": all(d == 1 for d in b["distinct_sums"])})
    runs["b"] = (b, want)
    # (c) noise-driven int8 compression: the wire from last step's noise scale
    c, want, read = run(noise_adaptive_compression(
        adamw(3e-4, b1=0.9, b2=0.95), local_batch_size=per, compression="int8"), NAC_STEPS,
        read=lambda opt: (get_compression_state(opt).noise_scale.item(),
                          get_compression_state(opt).compressed))
    c["noise_scale"], c["compressed"] = [x for x, _ in read], [on for _, on in read]
    c["checks"].update({"compressed from step 1": all(c["compressed"]),
                        "noise scale finite after step 2": all(
                            math.isfinite(x) for x in c["noise_scale"][1:]),
                        "replicas bit-identical": all(d == 1 for d in c["distinct_sums"])})
    runs["c"] = (c, want)
    for name, (r, want) in runs.items():
        r["expected_launches"] = want
        r["checks"]["launches"] = r["launches"] == want
        r["checks"]["no JAX"] = jax_free()
        r["ok"] = all(r["checks"].values())
    result = {"rank": rank, "backend": dist.get_backend(),
              "runs": {name: r for name, (r, _) in runs.items()}}
    print(ADAPTIVE_LINE + json.dumps(result), flush=True)
    distributed.shutdown_distributed()
    return 0 if all(r["ok"] for r in result["runs"].values()) else 1


def _wire_chunks(sizes, scheme: str, chunk_bytes: int) -> int:
    """The packed chunks of one gossip pull, from the parameters' (element
    count, element bytes) alone: each tensor's wire (its values; int8: its
    codes padded to whole blocks of 256, then an f32 scale a block), each
    part at a 16-byte-aligned place, grouped in order up to `chunk_bytes`."""
    def up(n):
        return -(-n // 16) * 16

    chunks, size = 0, 0
    for numel, itemsize in sizes:
        if scheme == "int8":
            blocks = -(-numel // 256)
            nb = up(blocks * 256) + up(blocks * 4)
        else:
            nb = up(numel * itemsize)
        if size and size + nb > chunk_bytes:
            chunks, size = chunks + 1, 0
        size += nb
    return chunks + (size > 0)


def position_digest(buf: "torch.Tensor") -> "torch.Tensor":
    """The sum of every DIGEST_ROW-word row of a buffer's int32 words and
    the sum of each word times its place in its row (1 to DIGEST_ROW), rows
    in order, made on the buffer's card: [rows, 2] int64, no sum past
    2^59.  A word moved, dropped, repeated or changed changes it, where a
    plain sum misses any reordering."""
    words = buf.view(torch.int32)
    place = torch.arange(1, DIGEST_ROW + 1, dtype=torch.int64, device=buf.device)
    out = []
    for start in range(0, words.numel(), DIGEST_ROW * 256):  # 32 MiB of int64 at a time
        part = words[start:start + DIGEST_ROW * 256]
        full = part.numel() - part.numel() % DIGEST_ROW
        for rows in (part[:full].view(-1, DIGEST_ROW), part[full:].view(1, -1)):
            if rows.numel():
                x = rows.to(torch.int64)
                out.append(torch.stack([x.sum(1), (x * place[:x.shape[1]]).sum(1)], 1))
    return torch.cat(out)


def rank_gossip(argv) -> int:
    """One rank of phase gossip (run by the launcher): runs (a)-(c) in turn."""
    import gc
    import hashlib

    import numpy as np
    import torch.distributed as dist

    from kungfu_tpu_torch.compression import error_feedback as EF
    from kungfu_tpu_torch.ops import flash
    from kungfu_tpu_torch.ops import fused_matmul as FM
    from kungfu_tpu_torch.ops import ring_collectives as RC
    from kungfu_tpu_torch.optimizers import (HostPairAveraging, OverlappedHostPairAveraging,
                                             gossip, pair_averaging)
    from kungfu_tpu_torch.peer import Peer
    from kungfu_tpu_torch.tools.step_profile import (flagship_model, flagship_tokens,
                                                     lm_step_loss)
    from kungfu_tpu_torch.train import DataParallelTrainer

    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    tf32_off()
    # this rank's blob store first (its port is fixed), then the group
    peer = Peer(device="cuda").start()
    world, rank = dist.get_world_size(), dist.get_rank()
    per = args.batch // world
    kernels = flash.KERNELS + RC.KERNELS + FM.KERNELS + EF.KERNELS

    def sgd(ps):
        return torch.optim.SGD(ps, lr=ADAPTIVE_SGD_LR)

    def blob_sum(arr) -> int:
        return int(np.add.reduce(np.asarray(arr).view(np.uint32), dtype=np.uint64))

    def run(tx, steps, host=None):
        """`steps` steps on this rank's rows, per replica: `tx` the
        optimizer; with `host` (a host gossip class) plain SGD, the host
        gossip's mix before each step and its publish after it."""
        cfg, model = flagship_model(args.seed, "cuda")
        trainer = DataParallelTrainer(lm_step_loss, tx, per_replica_params=True, device="cuda")
        state = trainer.init(model)
        rows = flagship_tokens(cfg, args.batch, args.seed)[rank * per:(rank + 1) * per]
        params = list(model.parameters())
        sizes[:] = [(p.numel(), p.element_size()) for p in params]
        rec = {"losses": [], "times": [], "sums": []}
        g, wire = None, None
        if host is not None:
            wire = {"saves": saves, "pulls": []}

            class Recording:  # the peer, with a checksum of every blob saved or pulled
                rank, size = peer.rank, peer.size

                def save(self, name, arr, version=""):
                    wire["saves"].append(blob_sum(arr))
                    peer.save(name, arr, version)

                def request(self, target, name, version="", wait=True, timeout=30.0):
                    got = peer.request(target, name, version, wait=wait, timeout=timeout)
                    wire["pulls"].append((target, None if got is None else blob_sum(got)))
                    return got

            g = host(Recording(), seed=args.seed)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for kern in kernels:
            kern.launches = 0
        for step in range(steps):
            dist.barrier()
            t0 = time.perf_counter()
            if g is not None:
                g.mix(params)
            state, metrics = trainer.train_step(state, rows)
            if g is not None:
                g.publish(params)
            rec["losses"].append(metrics["loss"].item())  # waits for the step
            rec["times"].append(time.perf_counter() - t0)
            rec["sums"].append(tuple(p.detach().view(torch.int32).to(torch.int64).sum().item()
                                     for p in params))
            print(f"[gossip] rank {rank} step {step + 1}: loss {rec['losses'][-1]:.4f}, "
                  f"{rec['times'][-1] * 1e3:.1f} ms", flush=True)
        if g is not None and host is OverlappedHostPairAveraging:
            g.close()  # flushes the last publish
        launches = {k.name: k.launches for k in kernels}
        every = [None] * world
        dist.all_gather_object(every, rec["sums"])
        want = {k.name: 0 for k in kernels}
        for k in (flash.FLASH_FWD, flash.FLASH_BWD_DQ, flash.FLASH_BWD_DKV):
            want[k.name] = cfg.n_layers * steps
        result = {"layers": cfg.n_layers, "losses": rec["losses"],
                  "step_s": statistics.median(rec["times"][1:]),
                  "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
                  "launches": launches, "expected_launches": want,
                  "distinct_sums": [len({sums[i] for sums in every}) for i in range(steps)],
                  "checks": {"loss finite": all(math.isfinite(x) for x in rec["losses"])}}
        if wire is not None:
            walls = [None] * world
            dist.all_gather_object(walls, wire)
            pulls = [(t, s) for t, s in wire["pulls"] if s is not None]
            result.update(pulls=len(pulls), pull_misses=len(wire["pulls"]) - len(pulls))
            # (a pull may find the blob its owner left in the run before)
            result["checks"]["each pull bit-equal to a blob its owner published"] = all(
                s in walls[t]["saves"] for t, s in pulls)
            result["checks"]["a pull found a blob"] = bool(pulls)
        del state, trainer, model, params, g
        gc.collect()
        torch.cuda.empty_cache()
        return result, want

    def digest_hex(d) -> str:
        return hashlib.sha256(d.cpu().numpy().tobytes()).hexdigest()

    runs, sizes, saves = {}, [], []  # saves: the checksum of every blob this rank published
    shift_wire = gossip.shift_wire
    for name, scheme in (("a", None), ("b", "int8")):
        pulled, planted, largest = [], [], []

        def recording(sent, group, shift):  # each chunk's buffers, digested on the card
            received = shift_wire(sent, group, shift)
            if not pulled:  # a swap of two 128 KiB blocks of the first chunk shows
                blk, got = 128 << 10, received[0]
                bad = got.clone()
                bad[:blk], bad[blk:2 * blk] = got[blk:2 * blk], got[:blk]
                planted.append(got.numel() >= 2 * blk and not torch.equal(
                    position_digest(bad), position_digest(got)))
                del bad
            largest.append(max(b.numel() for b in sent))
            pulled.append((-shift, [position_digest(b) for b in sent],
                           [position_digest(b) for b in received]))
            return received

        gossip.shift_wire = recording  # pull_mix_ shifts each chunk through it
        try:
            r, want = run(pair_averaging(sgd, seed=args.seed, compression=scheme), GOSSIP_STEPS)
        finally:
            gossip.shift_wire = shift_wire
        buf = torch.randint(0, 256, (max(largest),), dtype=torch.uint8, device="cuda")
        dist.barrier()  # every rank at once, as in the steps
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(3):
            position_digest(buf)
        torch.cuda.synchronize()
        digest_ms = (time.perf_counter() - t0) / 3 * 1e3
        del buf
        pulled = [(s, [digest_hex(x) for x in a], [digest_hex(x) for x in b])
                  for s, a, b in pulled]
        every = [None] * world
        dist.all_gather_object(every, pulled)
        chunks = len(pulled) // GOSSIP_STEPS
        shifts = [pulled[i * chunks][0] for i in range(GOSSIP_STEPS)]
        expect = _wire_chunks(sizes, scheme or "none", gossip.CHUNK_BYTES)
        want[FM.SHIFT.name] = expect * GOSSIP_STEPS
        r.update(shifts=shifts, chunks=chunks, largest_chunk=max(largest), digest_ms=digest_ms)
        r["checks"].update({
            "loss falls": r["losses"][-1] < r["losses"][0],
            "checksums distinct after step 1": r["distinct_sums"][0] == world,
            "one shift a step on every rank": all(
                [p[0] for p in e] == [p[0] for p in pulled] for e in every),
            "chunks a step": chunks == expect and len(pulled) == expect * GOSSIP_STEPS,
            "the digest rejects two blocks swapped": planted == [True],
            "largest chunk as phase shift holds it": scheme is not None
            or max(largest) == GOSSIP_SHIFT_BYTES,
            # what rank d received is what rank d + s sent, buffer by buffer
            "pulled bit-equal to the partner's sent": all(
                every[d][i][2] == every[(d + every[d][i][0]) % world][i][1]
                for d in range(world) for i in range(len(pulled))),
        })
        runs[name] = (r, want)
    runs["c-host"] = run(sgd, HOST_GOSSIP_STEPS, host=HostPairAveraging)
    runs["c-overlapped"] = run(sgd, HOST_GOSSIP_STEPS, host=OverlappedHostPairAveraging)
    for name, (r, want) in runs.items():
        r["checks"]["launches"] = r["launches"] == want
        r["checks"]["no JAX"] = jax_free()
        r["ok"] = all(r["checks"].values())
    result = {"rank": rank, "backend": dist.get_backend(),
              "runs": {name: r for name, (r, _) in runs.items()}}
    print(GOSSIP_LINE + json.dumps(result), flush=True)
    dist.barrier()
    peer.close()  # the store, then the group
    return 0 if all(r["ok"] for r in result["runs"].values()) else 1


def rank_session(argv) -> int:
    """One rank of phase session (run by the launcher with -strategy
    PALLAS_RING): (a) the interop S-SGD, (b) the strategy swap, (c) the
    rest of the Session on CUDA tensors."""
    import collections

    import kungfu_tpu_torch as kf
    from kungfu_tpu_torch import torch as kt
    from kungfu_tpu_torch.compression import resolve
    from kungfu_tpu_torch.ops import collective as C
    from kungfu_tpu_torch.ops import flash, peer_memory
    from kungfu_tpu_torch.ops import ring_collectives as RC
    from kungfu_tpu_torch.plan import Strategy, make_hierarchical_mesh
    from kungfu_tpu_torch.session import Session
    from kungfu_tpu_torch.tools.step_profile import (flagship_model, flagship_tokens,
                                                     lm_step_loss)
    from kungfu_tpu_torch.utils import trace as T

    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    tf32_off()
    peer = kf.init()  # on the card; the launcher's -strategy reaches the Session
    sess = peer.current_session()
    world, rank = kf.cluster_size(), kf.current_rank()
    per = args.batch // world
    kernels = flash.KERNELS + RC.KERNELS
    checks = {"the launcher's strategy": sess.strategy is Strategy.PALLAS_RING,
              "on the card": sess.device.type == "cuda"}

    # (a) a model of its own a rank, then rank 0's everywhere
    cfg, model = flagship_model(args.seed + rank, "cuda", n_layers=CUT_LAYERS)
    rows = flagship_tokens(cfg, args.batch, args.seed)[rank * per:(rank + 1) * per]
    params = list(model.parameters())
    kt.broadcast_parameters(model.state_dict())
    checks["consensus on the parameters after the broadcast"] = all(
        sess.consensus(p.detach()) for p in params)
    flipped = next(p for p in params if p.dim() == 1).detach().clone()  # a LayerNorm scale
    if rank == 1:
        flipped.view(torch.int32)[0] ^= 1
    checks["consensus false after a one-bit flip on rank 1"] = not sess.consensus(flipped)

    def digest():
        """Every parameter's position digest: one small int64 tensor."""
        return torch.cat([position_digest(p.detach()).reshape(-1) for p in params])

    losses, step_s, launches, expected, tags = {}, {}, {}, {}, {}

    def train(part, opt, steps, ring):
        """`steps` interop S-SGD steps on this rank's rows: the launches,
        the mean loss over the ranks, the replicas' consensus a step."""
        for kern in kernels:
            kern.launches = 0
        T.global_trace_buffer().clear()
        rec, times, agree = [], [], []
        for _ in range(steps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            loss = lm_step_loss(model, rows)
            opt.zero_grad()
            loss.backward()
            opt.step()
            # the loss's mean over the ranks: the one-shot, at full precision
            rec.append(sess.all_reduce(loss.detach().float(), op="mean", strategy=Strategy.STAR,
                                       compression="none").item())
            times.append(time.perf_counter() - t0)
            agree.append(sess.consensus(digest()))
            print(f"[session] rank {rank} ({part}) step {len(rec)}: loss {rec[-1]:.4f}, "
                  f"{times[-1] * 1e3:.1f} ms", flush=True)
        launches[part] = {k.name: k.launches for k in kernels}
        want = {k.name: 0 for k in kernels}
        for k in (flash.FLASH_FWD, flash.FLASH_BWD_DQ, flash.FLASH_BWD_DKV):
            want[k.name] = cfg.n_layers * steps
        for k in ring:  # one all_reduce a gradient a step, each B5 + B6 or B7 + B8
            want[k.name] = len(params) * steps
        expected[part] = want
        tags[part] = dict(collections.Counter(
            sp.args["collective_impl"] for sp in T.global_trace_buffer().spans()
            if sp.name == "collective:all_reduce"))
        losses[part], step_s[part] = rec, statistics.median(times[1:])
        checks[f"({part}) replicas agree after every step"] = all(agree)
        checks[f"({part}) loss finite"] = all(math.isfinite(x) for x in rec)
        checks[f"({part}) launches"] = launches[part] == want

    opt = kt.SynchronousSGDOptimizer(torch.optim.SGD(model.parameters(), lr=ADAPTIVE_SGD_LR))
    torch.cuda.reset_peak_memory_stats()
    train("a", opt, SESSION_STEPS, (RC.RING_RS, RC.RING_AG))
    checks["(a) loss falls"] = losses["a"][-1] < losses["a"][0]
    checks["(a) spans name B5/B6"] = tags["a"] == {"ring_kernels": len(params) * SESSION_STEPS,
                                                   "one_shot": SESSION_STEPS}
    # (b) the runtime swap, on every rank
    kf.set_strategy("PALLAS_RING_FUSED")
    sess.set_compression("int8")
    train("b", opt, SWAP_STEPS, (RC.FUSED_RS, RC.FUSED_AG))
    checks["(b) spans name B7/B8"] = tags["b"] == {"fused_ring_kernels": len(params) * SWAP_STEPS,
                                                   "one_shot": SWAP_STEPS}
    sess.set_strategy(Strategy.PALLAS_RING)
    sess.set_compression(None)

    # (c) this rank's own gradients, then the rest of the Session
    c_ms = {}

    def timed(name, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        c_ms[name] = (time.perf_counter() - t0) * 1e3
        return out

    opt.zero_grad()
    lm_step_loss(model, rows).backward()
    grads = [p.grad for p in params]
    int8 = resolve("int8")
    picks = {"embedding": grads[0],
             "projection": next(g for g in grads if tuple(g.shape) == (1024, 1024)),
             "ln_scale": next(g for g in grads if g.dim() == 1)}
    for name, g in picks.items():
        xs = list(timed(f"all_gather {name}", lambda: sess.all_gather(g)))
        ring = timed(f"B5+B6 {name}", lambda: sess.all_reduce(g, strategy=Strategy.PALLAS_RING))
        fused = timed(f"B7+B8 {name}", lambda: sess.all_reduce(
            g, strategy=Strategy.PALLAS_RING_FUSED, compression="int8"))
        checks[f"(c) {name} B5/B6 bit-equal"] = torch.equal(
            ring, C._plain_ring_all_reduce(xs)[rank])
        checks[f"(c) {name} B7/B8 bit-equal"] = torch.equal(
            fused, C._plain_fused_ring_all_reduce(xs, int8)[rank])
        del xs
    one = timed(f"all_reduce x{len(grads)}", lambda: [
        sess.all_reduce(g, strategy=Strategy.PALLAS_RING) for g in grads])
    for kern in RC.KERNELS:
        kern.launches = 0
    group = timed(f"group_all_reduce x{len(grads)}", lambda: sess.group_all_reduce(
        grads, strategy=Strategy.PALLAS_RING, bucket_bytes=SESSION_BUCKET))
    ws = peer_memory.workspace(sess._group, grads[0].device)
    runs = {kind: sum(len(RC.segment_plan(
        [(RC._chunk_elems(grads[i].numel(), world), torch.float32) for i in bucket],
        ws.slot_bytes[kind])) for bucket in Session.pack_buckets(
        [g.numel() * g.element_size() for g in grads], SESSION_BUCKET)) for kind in ("rs", "ag")}
    group_launches = [RC.RING_RS.launches, RC.RING_AG.launches]
    checks["(c) group bit-equal to an all_reduce a tensor"] = all(
        torch.equal(a, b) for a, b in zip(group, one))
    checks["(c) group: B5 and B6 once a segment_plan run"] = (
        group_launches == [runs["rs"], runs["ag"]] and RC.FUSED_RS.launches == 0)
    del one, group

    # small collectives, every rank's tensor made here from the seed
    gens = [torch.Generator(device="cuda").manual_seed(args.seed * 1000 + r) for r in range(world)]
    xs = [torch.randint(-3, 4, (SESSION_SMALL,), generator=g, device="cuda").float() for g in gens]
    mine, stacked = xs[rank], torch.stack(xs)
    zeros = torch.zeros_like(mine)
    want = {
        "reduce": stacked.sum(0) if rank == 1 else zeros,
        "broadcast": xs[2],
        "gather": stacked if rank == 3 else torch.zeros_like(stacked),
        "max": stacked.amax(0), "min": stacked.amin(0), "prod": stacked.prod(0),
    }
    got = {"reduce": timed("reduce", lambda: sess.reduce(mine, root=1)),
           "broadcast": timed("broadcast", lambda: sess.broadcast(mine, root=2)),
           "gather": timed("gather", lambda: sess.gather(mine, root=3))}
    for op in ("max", "min", "prod"):
        checks[f"(c) {op} takes the one-shot"] = sess.route(mine, op) == "one_shot"
        got[op] = timed(op, lambda: sess.all_reduce(mine, op=op))
    for name, w in want.items():
        checks[f"(c) {name}"] = torch.equal(got[name], w)
    timed("barrier", sess.barrier)
    checks["(c) cross_all_reduce on one host is the identity"] = sess.cross_all_reduce(mine) is mine
    hier = Session(make_hierarchical_mesh(2), strategy=Strategy.BINARY_TREE_STAR, host_count=2,
                   device="cuda")
    local = rank % 2  # ranks 0-1 and 2-3 stand for two hosts: dcn pairs {0, 2}, {1, 3}
    checks["(c) cross_all_reduce over dcn"] = torch.equal(
        timed("cross_all_reduce", lambda: hier.cross_all_reduce(mine)), xs[local] + xs[local + 2])
    checks["(c) hierarchical all_reduce"] = torch.equal(
        timed("hierarchical all_reduce", lambda: hier.all_reduce(mine)), stacked.sum(0))
    checks["no JAX"] = jax_free()
    result = {"rank": rank, "layers": cfg.n_layers, "losses": losses, "step_s": step_s,
              "launches": launches, "expected_launches": expected, "tags": tags,
              "group_launches": group_launches, "group_expected": [runs["rs"], runs["ag"]],
              "c_ms": c_ms, "stats": sess.calc_stats(),
              "peak_gib": torch.cuda.max_memory_allocated() / 2**30, "checks": checks,
              "ok": all(checks.values())}
    print(SESSION_LINE + json.dumps(result), flush=True)
    sess.barrier()
    kf.finalize()  # the store, the ring workspaces, then the group
    return 0 if result["ok"] else 1


def rank_elastic(argv) -> int:
    """One worker of phase elastic (run by the launcher in watch mode): the
    flagship under elastic.run_elastic, instrumented to record each step's
    loss, time and launches, each group's rendezvous, each sync's
    parameters and each checkpoint save."""
    import atexit
    import resource

    import numpy as np
    import torch.distributed as dist

    from kungfu_tpu_torch import checkpoint as CK
    from kungfu_tpu_torch import distributed, train
    from kungfu_tpu_torch import peer as peer_mod
    from kungfu_tpu_torch.datasets import ElasticDataAdaptor
    from kungfu_tpu_torch.elastic import trainer as ET
    from kungfu_tpu_torch.env import parse_config_from_env
    from kungfu_tpu_torch.ops import flash, peer_memory
    from kungfu_tpu_torch.ops import ring_collectives as RC
    from kungfu_tpu_torch.optimizers import adamw, synchronous_sgd
    from kungfu_tpu_torch.optimizers.sync import _pack_buckets
    from kungfu_tpu_torch.models.transformer import FLAGSHIP_GPT, TransformerConfig
    from kungfu_tpu_torch.tools.step_profile import flagship_model, flagship_tokens, lm_step_loss

    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--bucket-mib", type=int, default=256)
    ap.add_argument("--ckpt-dir", required=True)
    args = ap.parse_args(argv)
    tf32_off()
    bucket = args.bucket_mib << 20
    kernels = flash.KERNELS + RC.KERNELS
    # wall-clock stamps (time.time(): the ranks share a host) split a
    # resize's sync into the wait for the joiners and the broadcast
    rec = {"steps": [], "inits": [], "syncs": [], "saves": [], "restores": [],
           "t_start": time.time()}
    first = {"flag": True}

    # each group's rendezvous: its port, and the ring workspaces left then
    init_distributed, init_process_group = distributed.init_distributed, dist.init_process_group

    def init_pg(*a, **kw):
        rec["inits"][-1]["port"] = int(kw["init_method"].rsplit(":", 1)[1])
        return init_process_group(*a, **kw)

    def init_rec(config=None, device=None):
        cfg = config if config is not None else parse_config_from_env()
        rec["inits"].append({"version": cfg.cluster_version, "world": len(cfg.peers),
                             "workspaces": len(peer_memory._WORKSPACES),
                             "fenced_port": peer_mod.coordinator_port(cfg.peers[0].port,
                                                                      cfg.cluster_version)})
        out = init_distributed(cfg, device)
        rec["inits"][-1]["t_joined"] = time.time()
        return out

    distributed.init_distributed, dist.init_process_group = init_rec, init_pg

    # each step: its loss (the group's mean), time and kernel launches
    train_step = train.DataParallelTrainer.train_step
    n_buckets = []

    def step_rec(self, state, batch):
        if not n_buckets:
            n_buckets.append(len(_pack_buckets(list(state.params.parameters()), bucket)))
        before = {k.name: k.launches for k in kernels}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, metrics = train_step(self, state, batch)
        loss = metrics["loss"].item()
        dt = time.perf_counter() - t0
        launches = {k.name: k.launches - before[k.name] for k in kernels}
        want = {k.name: 0 for k in kernels}
        want.update({k.name: state.params.cfg.n_layers for k in
                     (flash.FLASH_FWD, flash.FLASH_BWD_DQ, flash.FLASH_BWD_DKV)})
        want.update({k.name: n_buckets[0] for k in (RC.RING_RS, RC.RING_AG)})
        rec["steps"].append({"step": state.step, "world": self.world, "loss": loss, "s": dt,
                             "first": first["flag"], "launches": launches, "want": want})
        first["flag"] = False
        print(f"[elastic] rank {dist.get_rank()}/{self.world} step {state.step}: loss "
              f"{loss:.4f}, {dt * 1e3:.1f} ms", flush=True)
        return state, metrics

    train.DataParallelTrainer.train_step = step_rec

    # each sync: the parameters every rank then holds
    sync_state = ET._GroupPrograms.sync_state

    def sync_rec(self, counters, host_tree):
        t0 = time.time()
        out = sync_state(self, counters, host_tree)
        rec["syncs"].append({"version": peer_mod.default_peer().cluster_version, "t0": t0,
                             "t1": time.time(), "checksum": state_checksum(out[1]["params"])})
        first["flag"] = True  # the next step is the first on the new group
        return out

    ET._GroupPrograms.sync_state = sync_rec

    # each checkpoint: save()'s host copy, and the writer's time
    save, write_step = CK.CheckpointManager.save, CK.CheckpointManager._write_step

    def save_rec(self, step, state, meta=None, force=False):
        sv = {"step": step}
        rec["saves"].append(sv)  # before the writer can finish with it
        t0 = time.perf_counter()
        ok = save(self, step, state, meta, force)
        sv["save_s"] = time.perf_counter() - t0
        if not ok:
            rec["saves"].remove(sv)
        return ok

    def write_rec(self, step, host_state, meta):
        t0 = time.perf_counter()
        write_step(self, step, host_state, meta)
        sv = next(s for s in rec["saves"] if s["step"] == step)
        sv["write_s"] = time.perf_counter() - t0
        sv["gib"] = sum(os.path.getsize(os.path.join(d, f)) for d, _, fs in
                        os.walk(os.path.join(self.directory, str(step))) for f in fs) / 2**30

    CK.CheckpointManager.save, CK.CheckpointManager._write_step = save_rec, write_rec

    # the resume at start-up: a joiner finds the survivors' checkpoints,
    # restores and verifies the newest, and the sync then replaces it
    restore = CK.CheckpointManager.restore_latest_verified

    def restore_rec(self, *a, **kw):
        t0 = time.perf_counter()
        got = restore(self, *a, **kw)
        rec["restores"].append({"s": time.perf_counter() - t0, "step": got and got[2]})
        return got

    CK.CheckpointManager.restore_latest_verified = restore_rec

    def left_at_exit():
        if not rec.get("done"):  # this rank detached: its record, for the parent
            print(ELASTIC_LEFT + json.dumps(rec), flush=True)

    atexit.register(left_at_exit)

    cfg = TransformerConfig(**FLAGSHIP_GPT)  # the tokens need only its vocab and length
    tokens = flagship_tokens(cfg, args.batch, args.seed, "cuda").cpu().numpy()

    def make_data(rank, size, offset):
        it = iter(ElasticDataAdaptor(tokens, np.zeros(len(tokens), np.int32),
                                     batch_size=args.batch // N_RANKS, rank=rank, size=size,
                                     offset=offset, seed=args.seed))
        return (torch.from_numpy(rows) for rows, _ in it)

    def make_tx(axes=None):
        return synchronous_sgd(adamw(3e-4, b1=0.9, b2=0.95), group=axes, impl="pallas_ring",
                               bucket_bytes=bucket or None)

    for kern in kernels:
        kern.launches = 0
    out = ET.run_elastic(
        lambda: lm_step_loss, lambda: flagship_model(args.seed, "cuda", n_layers=CUT_LAYERS)[1],
        make_tx, make_data,
        ET.ElasticConfig(total_samples=ELASTIC_SAMPLES, batch_size=args.batch // N_RANKS,
                         schedule=ELASTIC_SCHEDULE, check_every=2, checkpoint_dir=args.ckpt_dir,
                         checkpoint_every=ELASTIC_CKPT_EVERY))
    rec["done"] = True
    rank = dist.get_rank()
    rec["final_checksum"] = state_checksum(out["state"].params.state_dict())
    rec["launches"] = {k.name: k.launches for k in kernels}
    rec["resizes"], rec["resize_events"] = out["resizes"], out["resize_events"]
    rec["checks"] = {"no JAX": jax_free()}
    rec["ok"] = all(rec["checks"].values())
    rec["host_peak_gib"] = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20
    print(f"RESULT: elastic trained={out['trained_samples']} resizes={out['resizes']} "
          f"final_size={out['final_size']} loss={out['loss']:.4f} rank={rank}", flush=True)
    print(ELASTIC_LINE + json.dumps(rec), flush=True)
    peer_mod.finalize_default_peer()
    return 0 if rec["ok"] else 1


def launch_heal(argv) -> int:
    """Phase heal's launcher: `python -m kungfu_tpu_torch.run` with the
    healer's restart backoff set to HEAL_BACKOFF_S (WatchRunner's
    `restart_backoff_s`, which the CLI does not expose, as the JAX
    package's does not); every other setting is the CLI's."""
    import functools

    from kungfu_tpu_torch.run import __main__ as cli
    from kungfu_tpu_torch.run import launcher

    launcher.WatchRunner.__init__ = functools.partialmethod(launcher.WatchRunner.__init__,
                                                            restart_backoff_s=HEAL_BACKOFF_S)
    return cli.main(argv)


def launch_controlplane(argv) -> int:
    """Phase controlplane's launcher: `python -m kungfu_tpu_torch.run` (its
    flags argv[1:]) holding its ensemble.  Once rank 0 has written
    `<argv[0]>/kill` (after step CP_KILL_AT) it SIGKILLs the leader, waits
    for the next epoch's leader, writes `<argv[0]>/elected`, then waits for
    the respawned replica to reach the leader's commit after the shrink;
    prints its record as the CP_RUNNER line."""
    import threading

    from kungfu_tpu_torch.elastic import ensemble as EN
    from kungfu_tpu_torch.run import __main__ as cli

    drill_dir, argv = argv[0], argv[1:]
    rec = {"killed": None, "epoch0": None, "epoch1": None, "leader1": None, "elect_s": None,
           "converged": False, "converge_s": None, "statuses": None}

    def wait_file(name: str, timeout_s: float) -> bool:
        deadline = time.monotonic() + timeout_s
        while not os.path.exists(os.path.join(drill_dir, name)):
            if time.monotonic() > deadline:
                return False
            time.sleep(0.05)
        return True

    def drill(ens) -> None:
        if not wait_file("kill", CP_TIMEOUT):
            return
        led = ens.leader(wait_s=5.0)
        rec["epoch0"] = ens.raft_status(led)["epoch"]
        t0 = time.monotonic()
        rec["killed"] = ens.kill_leader()
        while time.monotonic() - t0 < 30:
            new = ens.leader()
            st = ens.raft_status(new) if new is not None else None
            if st is not None and st["epoch"] > rec["epoch0"]:
                rec.update(epoch1=st["epoch"], leader1=new, elect_s=time.monotonic() - t0)
                break
            time.sleep(0.02)
        with open(os.path.join(drill_dir, "elected"), "w"):
            pass
        while time.monotonic() - t0 < 120:  # the shrink committed, the respawned caught up
            sts = ens.statuses()
            lead = ens.leader()
            if (ens.respawns >= 1 and lead is not None and all(sts)
                    and (ens.client().get_health() or {}).get("version", 0) >= 1
                    and sts[rec["killed"]]["commit"] == sts[lead]["commit"]):
                rec.update(converged=True, converge_s=time.monotonic() - t0, statuses=sts)
                break
            time.sleep(0.1)
        rec["statuses"] = rec["statuses"] or ens.statuses()

    start = EN.ConfigEnsemble.start

    def start_and_drill(self, *a, **kw):
        out = start(self, *a, **kw)
        threading.Thread(target=drill, args=(self,), daemon=True).start()
        return out

    EN.ConfigEnsemble.start = start_and_drill
    rc = cli.main(argv)
    print(CP_RUNNER + json.dumps(rec), flush=True)
    return rc


def rank_controlplane(argv) -> int:
    """One worker of phase controlplane (run by the launcher in watch mode
    with a config ensemble): the flagship under elastic.run_elastic
    (schedule CP_SCHEDULE), instrumented to record each step's loss, time
    and launches and rank 0's proposals; rank 0 writes the kill trigger
    after step CP_KILL_AT and holds after step 4 until the next leader is
    up, so its proposal comes after the election."""
    import atexit

    import numpy as np
    import torch.distributed as dist

    from kungfu_tpu_torch import peer as peer_mod
    from kungfu_tpu_torch import train
    from kungfu_tpu_torch.datasets import ElasticDataAdaptor
    from kungfu_tpu_torch.elastic import trainer as ET
    from kungfu_tpu_torch.ops import flash
    from kungfu_tpu_torch.ops import ring_collectives as RC
    from kungfu_tpu_torch.optimizers import adamw, synchronous_sgd
    from kungfu_tpu_torch.optimizers.sync import _pack_buckets
    from kungfu_tpu_torch.models.transformer import FLAGSHIP_GPT, TransformerConfig
    from kungfu_tpu_torch.tools.step_profile import flagship_model, flagship_tokens, lm_step_loss

    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--bucket-mib", type=int, default=256)
    ap.add_argument("--drill-dir", required=True)
    args = ap.parse_args(argv)
    tf32_off()
    bucket = args.bucket_mib << 20
    kernels = flash.KERNELS + RC.KERNELS
    rec = {"steps": [], "proposals": [], "held_s": None, "t_start": time.time(),
           "urls": len(os.environ.get("KFT_CONFIG_URLS", "").split(","))}
    first = {"flag": True}
    train_step = train.DataParallelTrainer.train_step
    n_buckets = []

    def step_rec(self, state, batch):
        if not n_buckets:
            n_buckets.append(len(_pack_buckets(list(state.params.parameters()), bucket)))
        before = {k.name: k.launches for k in kernels}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, metrics = train_step(self, state, batch)
        loss = metrics["loss"].item()
        dt = time.perf_counter() - t0
        launches = {k.name: k.launches - before[k.name] for k in kernels}
        want = {k.name: 0 for k in kernels}
        want.update({k.name: state.params.cfg.n_layers for k in
                     (flash.FLASH_FWD, flash.FLASH_BWD_DQ, flash.FLASH_BWD_DKV)})
        want.update({k.name: n_buckets[0] for k in (RC.RING_RS, RC.RING_AG)})
        rec["steps"].append({"step": state.step, "world": self.world, "loss": loss, "s": dt,
                             "first": first["flag"], "launches": launches, "want": want,
                             "t": time.time()})
        first["flag"] = False
        rank = dist.get_rank()
        print(f"[controlplane] rank {rank}/{self.world} step {state.step}: loss {loss:.4f}, "
              f"{dt * 1e3:.1f} ms", flush=True)
        if rank == 0 and state.step == CP_KILL_AT:
            with open(os.path.join(args.drill_dir, "kill"), "w"):
                pass
        if rank == 0 and state.step == CP_SHRINK_AT:  # the shrink is proposed next
            t_hold = time.monotonic()
            while not os.path.exists(os.path.join(args.drill_dir, "elected")):
                if time.monotonic() - t_hold > 60:
                    raise RuntimeError("no new leader 60 s after the kill")
                time.sleep(0.05)
            rec["held_s"] = time.monotonic() - t_hold
        return state, metrics

    train.DataParallelTrainer.train_step = step_rec
    propose = ET.propose_new_size

    def propose_rec(peer, new_size):
        ok = propose(peer, new_size)
        rec["proposals"].append(ok)
        return ok

    ET.propose_new_size = propose_rec
    sync_state = ET._GroupPrograms.sync_state

    def sync_rec(self, counters, host_tree):
        first["flag"] = True  # the next step is the first on the new group
        return sync_state(self, counters, host_tree)

    ET._GroupPrograms.sync_state = sync_rec

    def left_at_exit():
        if not rec.get("done"):  # this rank detached: its record, for the parent
            print(CP_LEFT + json.dumps(rec), flush=True)

    atexit.register(left_at_exit)
    cfg = TransformerConfig(**FLAGSHIP_GPT)  # the tokens need only its vocab and length
    tokens = flagship_tokens(cfg, args.batch, args.seed, "cuda").cpu().numpy()

    def make_data(rank, size, offset):
        it = iter(ElasticDataAdaptor(tokens, np.zeros(len(tokens), np.int32),
                                     batch_size=args.batch // N_RANKS, rank=rank, size=size,
                                     offset=offset, seed=args.seed))
        return (torch.from_numpy(rows) for rows, _ in it)

    def make_tx(axes=None):
        return synchronous_sgd(adamw(3e-4, b1=0.9, b2=0.95), group=axes, impl="pallas_ring",
                               bucket_bytes=bucket or None)

    for kern in kernels:
        kern.launches = 0
    out = ET.run_elastic(
        lambda: lm_step_loss, lambda: flagship_model(args.seed, "cuda", n_layers=CUT_LAYERS)[1],
        make_tx, make_data,
        ET.ElasticConfig(total_samples=CP_SAMPLES, batch_size=args.batch // N_RANKS,
                         schedule=CP_SCHEDULE, check_every=2))
    rec["done"] = True
    rank = dist.get_rank()
    rec.update(rank=rank, t_done=time.time(),
               final_checksum=state_checksum(out["state"].params.state_dict()),
               launches={k.name: k.launches for k in kernels},
               resize_events=out["resize_events"], ok=jax_free())
    print(f"RESULT: controlplane trained={out['trained_samples']} resizes={out['resizes']} "
          f"final_size={out['final_size']} loss={out['loss']:.4f} rank={rank}", flush=True)
    print(CP_LINE + json.dumps(rec), flush=True)
    peer_mod.finalize_default_peer()
    return 0 if rec["ok"] else 1


def rank_heal(argv) -> int:
    """One worker of phase heal (run by the healing launcher): the flagship
    under elastic.run_elastic with KFT_HEAL, instrumented to record each
    completed step's loss, time and launches, each group's rendezvous,
    each sync's source and result, each buddy snapshot, and one B5 + B6
    check on the healed 3-rank group."""
    import resource

    import numpy as np
    import torch.distributed as dist

    from kungfu_tpu_torch import distributed, train
    from kungfu_tpu_torch import peer as peer_mod
    from kungfu_tpu_torch.datasets import ElasticDataAdaptor
    from kungfu_tpu_torch.elastic import trainer as ET
    from kungfu_tpu_torch.elastic.config_client import ConfigClient
    from kungfu_tpu_torch.env import parse_config_from_env
    from kungfu_tpu_torch.ops import collective as C
    from kungfu_tpu_torch.ops import flash, peer_memory
    from kungfu_tpu_torch.ops import ring_collectives as RC
    from kungfu_tpu_torch.optimizers import adamw, synchronous_sgd
    from kungfu_tpu_torch.optimizers.sync import _pack_buckets
    from kungfu_tpu_torch.models.transformer import FLAGSHIP_GPT, TransformerConfig
    from kungfu_tpu_torch.resilience import buddy as BD
    from kungfu_tpu_torch.tools.step_profile import flagship_model, flagship_tokens, lm_step_loss

    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--bucket-mib", type=int, default=256)
    ap.add_argument("--ckpt-dir", required=True)
    args = ap.parse_args(argv)
    tf32_off()
    bucket = args.bucket_mib << 20
    kernels = flash.KERNELS + RC.KERNELS
    rec = {"self": os.environ["KFT_SELF_SPEC"], "steps": [], "inits": [], "syncs": [],
           "ships": [], "ring3": None, "held_s": None, "t_start": time.time()}
    first = {"flag": True, "heal": False}

    # each group's rendezvous: its port, and the ring workspaces left then
    init_distributed, init_process_group = distributed.init_distributed, dist.init_process_group

    def init_pg(*a, **kw):
        rec["inits"][-1]["port"] = int(kw["init_method"].rsplit(":", 1)[1])
        return init_process_group(*a, **kw)

    def init_rec(config=None, device=None):
        cfg = config if config is not None else parse_config_from_env()
        rec["inits"].append({"version": cfg.cluster_version, "world": len(cfg.peers),
                             "workspaces": len(peer_memory._WORKSPACES),
                             "fenced_port": peer_mod.coordinator_port(cfg.peers[0].port,
                                                                      cfg.cluster_version)})
        out = init_distributed(cfg, device)
        rec["inits"][-1]["t_joined"] = time.time()
        return out

    distributed.init_distributed, dist.init_process_group = init_rec, init_pg

    # a heal's dirty teardown: the next sync is the heal's
    close = peer_mod.Peer.close

    def close_rec(self, graceful=True):
        if not graceful:
            first["heal"] = True
        return close(self, graceful)

    peer_mod.Peer.close = close_rec

    def ring3_check():
        """One B5 + B6 all-reduce of an integer-valued f32 payload on the
        healed group against the stacked plain version (its launches are
        not the step's)."""
        rank = dist.get_rank()
        x = (torch.arange(1 << 22, device="cuda") % 251 + 3 * rank).float()
        xs = list(C.all_gather(x))
        ring = RC.ring_all_reduce(x, None, "sum")
        peer_memory.check_all()
        rec["ring3"] = {"equal": torch.equal(ring, C._plain_ring_all_reduce(xs)[rank]),
                        "world": dist.get_world_size(), "orphans": len(peer_memory._ORPHANS)}
        print(f"[heal] rank {rank}/{dist.get_world_size()}: B5 + B6 on the healed group "
              f"bit-equal to the plain version: {rec['ring3']['equal']}", flush=True)

    client = ConfigClient(parse_config_from_env().config_server)

    def hold_for_regrow():
        """The survivors' second step on the healed group waits until the
        runner's regrow has put the N_RANKS-worker document, so the resize
        check after it takes the regrow and the run ends at N_RANKS
        whatever the 3-rank steps cost (on 4 cards they finished
        HEAL_SAMPLES before the regrow landed)."""
        t0 = time.time()
        while True:
            got = client.poll_cluster()
            if got is not None and len(got[0].workers) == N_RANKS:
                break
            if time.time() - t0 > HEAL_TIMEOUT:
                raise SmokeFailure(f"heal: no {N_RANKS}-worker document in {HEAL_TIMEOUT} s")
            time.sleep(0.5)
        rec["held_s"] = time.time() - t0
        print(f"[heal] {rec['self']} held its second {N_RANKS - 1}-rank step "
              f"{rec['held_s']:.2f} s for the regrow's document (v{got[1]})", flush=True)

    # each completed step: its loss (the group's mean), time and launches
    train_step = train.DataParallelTrainer.train_step
    n_buckets = []

    def step_rec(self, state, batch):
        if not n_buckets:
            n_buckets.append(len(_pack_buckets(list(state.params.parameters()), bucket)))
        if self.world == N_RANKS - 1 and rec["ring3"] is None:
            ring3_check()
        elif self.world == N_RANKS - 1 and rec["held_s"] is None:
            hold_for_regrow()  # after the heal's first step, which its mttr_s times
        before = {k.name: k.launches for k in kernels}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, metrics = train_step(self, state, batch)
        loss = metrics["loss"].item()
        dt = time.perf_counter() - t0
        launches = {k.name: k.launches - before[k.name] for k in kernels}
        want = {k.name: 0 for k in kernels}
        want.update({k.name: state.params.cfg.n_layers for k in
                     (flash.FLASH_FWD, flash.FLASH_BWD_DQ, flash.FLASH_BWD_DKV)})
        want.update({k.name: n_buckets[0] for k in (RC.RING_RS, RC.RING_AG)})
        rec["steps"].append({"step": state.step, "world": self.world, "loss": loss, "s": dt,
                             "first": first["flag"], "launches": launches, "want": want})
        first["flag"] = False
        print(f"[heal] {rec['self']} rank {dist.get_rank()}/{self.world} step {state.step}: "
              f"loss {loss:.4f}, {dt * 1e3:.1f} ms", flush=True)
        return state, metrics

    train.DataParallelTrainer.train_step = step_rec

    # each sync: the state each rank brought (the heal's source) and got
    sync_state = ET._GroupPrograms.sync_state

    def sync_rec(self, counters, host_tree):
        kind = "heal" if first["heal"] else "sync"
        given = state_checksum(host_tree["params"]) if host_tree["params"] is not None else None
        t0 = time.time()
        out = sync_state(self, counters, host_tree)
        rec["syncs"].append({"version": peer_mod.default_peer().cluster_version, "kind": kind,
                             "t0": t0, "t1": time.time(), "in": given,
                             "out": state_checksum(out[1]["params"])})
        first["flag"], first["heal"] = True, False  # the next step is the first on the group
        return out

    ET._GroupPrograms.sync_state = sync_rec

    # each buddy snapshot: its time, size and whether the ship landed
    update = BD.BuddySnapshots.update

    def update_rec(self, step, offset, params, opt):
        t0 = time.perf_counter()
        update(self, step, offset, params, opt)
        shipped = bool(self.ships and self.ships[-1][3]) if self.buddy_rank >= 0 else False
        rec["ships"].append({"step": int(step), "s": time.perf_counter() - t0,
                             "gib": self._own.nbytes / 2**30, "shipped": shipped})

    BD.BuddySnapshots.update = update_rec

    cfg = TransformerConfig(**FLAGSHIP_GPT)  # the tokens need only its vocab and length
    tokens = flagship_tokens(cfg, args.batch, args.seed, "cuda").cpu().numpy()

    def make_data(rank, size, offset):
        it = iter(ElasticDataAdaptor(tokens, np.zeros(len(tokens), np.int32),
                                     batch_size=args.batch // N_RANKS, rank=rank, size=size,
                                     offset=offset, seed=args.seed))
        return (torch.from_numpy(rows) for rows, _ in it)

    def make_tx(axes=None):
        return synchronous_sgd(adamw(3e-4, b1=0.9, b2=0.95), group=axes, impl="pallas_ring",
                               bucket_bytes=bucket or None)

    for kern in kernels:
        kern.launches = 0
    out = ET.run_elastic(
        lambda: lm_step_loss, lambda: flagship_model(args.seed, "cuda", n_layers=CUT_LAYERS)[1],
        make_tx, make_data,
        ET.ElasticConfig(total_samples=HEAL_SAMPLES, batch_size=args.batch // N_RANKS,
                         check_every=HEAL_CHECK_EVERY, checkpoint_dir=args.ckpt_dir,
                         checkpoint_every=HEAL_CKPT_EVERY, snapshot_every=HEAL_SNAPSHOT_EVERY))
    rec["t_end"] = time.time()
    rec["final_rank"] = dist.get_rank()
    rec["final_checksum"] = state_checksum(out["state"].params.state_dict())
    rec["launches"] = {k.name: sum(st["launches"][k.name] for st in rec["steps"])
                       for k in kernels}
    rec["trained"], rec["final_size"] = out["trained_samples"], out["final_size"]
    rec["resizes"], rec["heal_events"] = out["resizes"], out["heal_events"]
    rec["checks"] = {"no JAX": jax_free()}
    rec["ok"] = all(rec["checks"].values())
    rec["host_peak_gib"] = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20
    print(f"RESULT: heal trained={out['trained_samples']} heals={out['heals']} "
          f"resizes={out['resizes']} final_size={out['final_size']} loss={out['loss']:.4f} "
          f"rank={rec['final_rank']}", flush=True)
    print(HEAL_LINE + json.dumps(rec), flush=True)
    peer_mod.finalize_default_peer()
    return 0 if rec["ok"] else 1


def rank_ring(argv) -> int:
    """One rank of phase ring (run by the launcher)."""
    from kungfu_tpu_torch.tools import ring_check

    tf32_off()
    rc = ring_check.main(argv)
    if not jax_free():
        print("chip_smoke: JAX or the JAX package was imported", file=sys.stderr)
        return 1
    return rc


def rank_shift(argv) -> int:
    """One rank of phase shift (run by the launcher)."""
    from kungfu_tpu_torch.tools import shift_check

    rc = shift_check.main(argv)
    if not jax_free():
        print("chip_smoke: JAX or the JAX package was imported", file=sys.stderr)
        return 1
    return rc


def rank_sp(argv) -> int:
    """One rank of phase sp (run by the launcher), then phase ulysses."""
    import gc

    import torch.distributed as dist

    from kungfu_tpu_torch import distributed
    from kungfu_tpu_torch.compression import error_feedback as EF
    from kungfu_tpu_torch.ops import flash
    from kungfu_tpu_torch.ops import fused_matmul as FM
    from kungfu_tpu_torch.ops import ring_collectives as RC
    from kungfu_tpu_torch.optimizers.sync import _pack_buckets
    from kungfu_tpu_torch.tools.step_profile import flagship_sp_step

    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--bucket-mib", type=int, default=256)
    args = ap.parse_args(argv)
    tf32_off()
    world = distributed.init_distributed(device="cuda")
    rank = dist.get_rank()
    bucket = args.bucket_mib << 20
    cfg, trainer, state, shard = flagship_sp_step(SP_BATCH, SP_SEQ, world, args.seed,
                                                  impl="pallas_ring", bucket_bytes=bucket or None)
    sp_rank = trainer.mesh.coord("sp")
    params = list(state.params.parameters())
    buckets = len(_pack_buckets(params, bucket)) if bucket else len(params)
    kernels = flash.KERNELS + RC.KERNELS + EF.KERNELS + FM.KERNELS
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for kern in kernels:
        kern.launches = 0
    FM.SHIFT.side_launches = 0
    losses, times = [], []
    for step in range(args.steps):
        t0 = time.perf_counter()
        state, metrics = trainer.train_step(state, shard)
        losses.append(metrics["loss"].item())  # waits for the step
        times.append(time.perf_counter() - t0)
        print(f"[sp] rank {rank} step {step + 1}: loss {losses[-1]:.4f}, "
              f"{times[-1] * 1e3:.1f} ms", flush=True)
    launches = {k.name: k.launches for k in kernels}
    side = FM.SHIFT.side_launches
    sums = [p.detach().view(torch.int32).to(torch.int64).sum().item() for p in params]
    every = [None] * world
    dist.all_gather_object(every, sums)
    # per step: rank r runs r + 1 of the 4 blocks of each layer (the causal
    # ring skips the blocks of later ranks), the K/V pair shifts 3 times a
    # layer forward and 3 times backward, and every bucket is summed once
    blocks = cfg.n_layers * (sp_rank + 1) * args.steps
    want = {k.name: 0 for k in kernels}
    want.update({flash.FLASH_FWD.name: blocks, flash.FLASH_BWD_DQ.name: blocks,
                 flash.FLASH_BWD_DKV.name: blocks, RC.RING_RS.name: buckets * args.steps,
                 RC.RING_AG.name: buckets * args.steps,
                 FM.SHIFT.name: cfg.n_layers * 2 * (world - 1) * args.steps})
    checks = {
        "loss finite": all(math.isfinite(x) for x in losses),
        "loss falls": losses[-1] < losses[0],
        "replicas bit-identical": all(s == every[0] for s in every),
        "launches": launches == want,
        "every shift on the side stream": side == launches[FM.SHIFT.name],
        "no JAX": jax_free(),
    }
    result = {"rank": rank, "sp_rank": sp_rank, "backend": dist.get_backend(),
              "side_launches": side,
              "losses": losses,
              "step_s": statistics.median(times[1:]) if args.steps > 1 else times[0],
              "peak_gib": torch.cuda.max_memory_allocated() / 2**30, "buckets": buckets,
              "launches": launches, "expected_launches": want, "checks": checks,
              "ok": all(checks.values())}
    print(SP_LINE + json.dumps(result), flush=True)
    # phase ulysses next, in this process: no second start-up
    del cfg, trainer, state, shard, params, metrics
    gc.collect()
    torch.cuda.empty_cache()
    ok = ulysses_parts(world, args.seed, bucket) and result["ok"]
    distributed.shutdown_distributed()
    return 0 if ok else 1


def ulysses_parts(world: int, seed: int, bucket: int) -> bool:
    """Phase ulysses on this rank of an initialised group: the flagship at
    SP_SEQ positions as dp=1 x sp=4 with attention="ulysses", (a) the
    dense head for ULYSSES_STEPS steps, (b) head="hidden" for one step,
    (c) GQA (ULYSSES_GQA_HEADS kv heads, split over the ranks) for one
    step; each part's losses, times, launches and replica checksums,
    printed as the ULYSSES_LINE.  Before (a) and (c) one layer's attention
    at their heads is held against flash over the gathered sequence
    (tools/ulysses_check).  True if every check held."""
    import gc

    import torch.distributed as dist

    from kungfu_tpu_torch.compression import error_feedback as EF
    from kungfu_tpu_torch.models.transformer import FLAGSHIP_GPT
    from kungfu_tpu_torch.ops import collective as C
    from kungfu_tpu_torch.ops import flash
    from kungfu_tpu_torch.ops import fused_matmul as FM
    from kungfu_tpu_torch.ops import ring_collectives as RC
    from kungfu_tpu_torch.optimizers.sync import _pack_buckets
    from kungfu_tpu_torch.tools import ulysses_check
    from kungfu_tpu_torch.tools.step_profile import flagship_sp_step
    from kungfu_tpu_torch.utils.compare import REL_LIMIT

    rank = dist.get_rank()
    kernels = flash.KERNELS + RC.KERNELS + EF.KERNELS + FM.KERNELS
    probe = torch.zeros(1, device="cuda")
    result = {"rank": rank, "backend": dist.get_backend(), "parts": {},
              "exchange": "staged through the host (gloo)" if C._gloo_card(probe, None)
              else "on the card (NCCL)"}
    for part, steps, kw in (("dense", ULYSSES_STEPS, {}), ("hidden", 1, {"head": "hidden"}),
                            ("gqa", 1, {"n_kv_heads": ULYSSES_GQA_HEADS})):
        errs = None
        if part != "hidden":  # (b)'s attention is (a)'s
            heads = FLAGSHIP_GPT["n_heads"]
            kv_heads = kw.get("n_kv_heads", heads)
            errs = ulysses_check.against_flash(None, SP_BATCH, SP_SEQ, heads, kv_heads,
                                               FLAGSHIP_GPT["d_model"] // heads, seed=seed)
        cfg, trainer, state, shard = flagship_sp_step(
            SP_BATCH, SP_SEQ, world, seed, impl="pallas_ring", bucket_bytes=bucket or None,
            attention="ulysses", **kw)
        params = list(state.params.parameters())
        buckets = len(_pack_buckets(params, bucket)) if bucket else len(params)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for kern in kernels:
            kern.launches = 0
        losses, times = [], []
        for step in range(steps):
            t0 = time.perf_counter()
            state, metrics = trainer.train_step(state, shard)
            losses.append(metrics["loss"].item())  # waits for the step
            times.append(time.perf_counter() - t0)
            print(f"[ulysses] rank {rank} part {part} step {step + 1}: loss {losses[-1]:.4f}, "
                  f"{times[-1] * 1e3:.1f} ms", flush=True)
        launches = {k.name: k.launches for k in kernels}
        sums = [p.detach().view(torch.int32).to(torch.int64).sum().item() for p in params]
        every = [None] * world
        dist.all_gather_object(every, sums)
        # a step: each layer's attention once over the rank's head group on
        # the whole sequence (B4 in place of B3 under GQA), each bucket once
        dkv = flash.FLASH_BWD_DKV_GQA if cfg.kv_heads != cfg.n_heads else flash.FLASH_BWD_DKV
        want = {k.name: 0 for k in kernels}
        want.update({k.name: cfg.n_layers * steps for k in
                     (flash.FLASH_FWD, flash.FLASH_BWD_DQ, dkv)})
        want.update({k.name: buckets * steps for k in (RC.RING_RS, RC.RING_AG)})
        checks = {"loss finite": all(math.isfinite(x) for x in losses),
                  "replicas bit-identical": all(x == every[0] for x in every),
                  "launches": launches == want, "no JAX": jax_free()}
        if steps > 1:
            checks["loss falls"] = losses[-1] < losses[0]
        result["parts"][part] = {
            "losses": losses, "step_s": statistics.median(times[1:]) if steps > 1 else times[0],
            "peak_gib": torch.cuda.max_memory_allocated() / 2**30, "buckets": buckets,
            "launches": launches, "expected_launches": want, "checks": checks}
        if errs is not None:
            checks["attention against flash"] = max(errs.values()) <= REL_LIMIT[torch.bfloat16]
            result["parts"][part].update(against_flash=errs, heads=cfg.n_heads,
                                         kv_heads=cfg.kv_heads)
        del cfg, trainer, state, shard, params, metrics
        gc.collect()
        torch.cuda.empty_cache()
    result["ok"] = all(all(pr["checks"].values()) for pr in result["parts"].values())
    print(ULYSSES_LINE + json.dumps(result), flush=True)
    return result["ok"]


def mesh_part(part: str, sizes, steps: int, batch: int, seed: int, bucket: int) -> dict:
    """One part of phase mesh on this rank of an initialised group of
    N_RANKS: the flagship cut to CUT_LAYERS layers (weights from `seed`
    as phase cut-ref makes them, cut to this rank's shards by the rules
    table) on `make_mesh(**sizes)` under MeshTrainer(adamw(3e-4, b1=0.9,
    b2=0.95), impl="pallas_ring", bucket_bytes=`bucket`) for `steps` steps
    on this rank's shard of the `batch` sequences of phase main.

      tp  TransformerLM (Megatron: 8 of the 16 heads a rank), the
          vocab-parallel lm_loss_shard; a step runs B1-B3 once a layer on
          the rank's heads and B5/B6 once a bucket over the dp group
      ep  TransformerLM with MESH_EXPERTS (experts 2 a rank; every second
          block MoE), lm_loss_shard_with_aux; rank 0 first computes the
          one-process model's lm_loss_with_aux on all the sequences
          (forward only); launches as tp
      pp  PipelinedLM at MESH_PIPE (R=2 rounds, M=4 microbatches of 2
          sequences, remat): each stage applies R M layer groups of
          CUT_LAYERS / (S R) = 1 block a step, B1 twice a group (the
          checkpoint recomputes it in the backward), B2 and B3 once;
          the schedule's R M + S - 1 = 11 ticks make R M + S - 2 = 10 hops
          of B11 (none after the last tick) and the backward 10 more;
          no data group, so no B5/B6

    Returns the part's losses, times, peak memory, launches (and those
    expected), checks and what it prints."""
    import dataclasses

    import torch.distributed as dist

    from kungfu_tpu_torch import convert
    from kungfu_tpu_torch.compression import error_feedback as EF
    from kungfu_tpu_torch.initializer import sync_check
    from kungfu_tpu_torch.models import transformer as tt
    from kungfu_tpu_torch.ops import collective as C
    from kungfu_tpu_torch.ops import flash
    from kungfu_tpu_torch.ops import fused_matmul as FM
    from kungfu_tpu_torch.ops import ring_collectives as RC
    from kungfu_tpu_torch.optimizers import adamw
    from kungfu_tpu_torch.optimizers.sync import _pack_buckets
    from kungfu_tpu_torch.parallel import PipelinedLM, sharding
    from kungfu_tpu_torch.parallel.moe import MoEMLP
    from kungfu_tpu_torch.plan import make_mesh
    from kungfu_tpu_torch.tools.step_profile import flagship_model, flagship_tokens
    from kungfu_tpu_torch.trainer import MeshTrainer

    rank = dist.get_rank()
    cfg, whole = flagship_model(seed, "cuda", n_layers=CUT_LAYERS,
                                **(MESH_EXPERTS if part == "ep" else {}))
    tokens = flagship_tokens(cfg, batch, seed)
    result = {"mesh": sizes}
    if part == "ep" and rank == 0:
        with torch.no_grad():
            result["reference_loss"] = tt.lm_loss_with_aux(whole, tokens).item()
    state_dict = whole.state_dict()
    del whole
    mesh = make_mesh(**sizes)
    cfg = dataclasses.replace(cfg, mesh=mesh)
    if part == "pp":
        repeats, micro = MESH_PIPE
        model = PipelinedLM(cfg, repeats=repeats, microbatches=micro, device="cuda")
        state_dict = convert.stack_pipeline(state_dict, sizes["pp"], repeats)
    else:
        model = tt.TransformerLM(cfg, device="cuda")
    model.load_state_dict(convert.shard_state_dict(state_dict, mesh))
    del state_dict
    if cfg.n_experts:
        def loss_fn(m, b):
            return tt.lm_loss_shard_with_aux(m, b.tokens, b.targets, b.count)
    else:
        def loss_fn(m, b):
            return tt.lm_loss_shard(m(b.tokens), b.targets, b.count, m.vocab_group)
    trainer = MeshTrainer(loss_fn, adamw(3e-4, b1=0.9, b2=0.95), mesh, impl="pallas_ring",
                          bucket_bytes=bucket or None, device="cuda")
    state = trainer.init(model)
    shard = trainer.shard_batch(tokens)
    params = list(model.parameters())
    reduced = dist.get_world_size(trainer.data_group) > 1
    buckets = (len(_pack_buckets(params, bucket)) if bucket else len(params)) * reduced
    moe = [m for m in model.modules() if isinstance(m, MoEMLP)]
    kernels = flash.KERNELS + RC.KERNELS + EF.KERNELS + FM.KERNELS
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for kern in kernels:
        kern.launches = 0
    losses, times, dropped, aux = [], [], [], []
    for step in range(steps):
        t0 = time.perf_counter()
        state, metrics = trainer.train_step(state, shard)
        losses.append(metrics["loss"].item())  # waits for the step
        times.append(time.perf_counter() - t0)
        if moe:
            dropped.append([round(float(m.dropped), 5) for m in moe])
            aux.append(sum(float(m.aux_loss) for m in moe))
        print(f"[mesh] rank {rank} part {part} step {step + 1}: loss {losses[-1]:.4f}, "
              f"{times[-1] * 1e3:.1f} ms", flush=True)
    launches = {k.name: k.launches for k in kernels}
    # the ranks that hold the same shard of a parameter (those that differ
    # only on the axes it is not split over) hold the same bits, element
    # by element
    specs = sharding.param_shardings(mesh, [n for n, _ in model.named_parameters()])
    alike = True
    for n, p in model.named_parameters():
        split = {a for a, _ in sharding.held_splits(specs[n])}
        held = mesh.group(tuple(a for a in mesh.axis_names if a not in split))
        alike = sync_check(p, held) and alike
    want = {k.name: 0 for k in kernels}
    if part == "pp":
        S, (R, M) = sizes["pp"], MESH_PIPE
        groups = R * M * (CUT_LAYERS // (S * R)) * steps
        want.update({flash.FLASH_FWD.name: 2 * groups, flash.FLASH_BWD_DQ.name: groups,
                     flash.FLASH_BWD_DKV.name: groups,
                     FM.SHIFT.name: 2 * (R * M + S - 2) * steps})
        result.update(ticks=R * M + S - 1, idle_ticks=S - 1)
    else:
        want.update({k.name: cfg.n_layers * steps for k in
                     (flash.FLASH_FWD, flash.FLASH_BWD_DQ, flash.FLASH_BWD_DKV)})
        want.update({k.name: buckets * steps for k in (RC.RING_RS, RC.RING_AG)})
    checks = {"loss finite": all(math.isfinite(x) for x in losses),
              "loss falls": losses[-1] < losses[0],
              "shards bit-identical where held alike": alike,
              "launches": launches == want, "no JAX": jax_free()}
    if part == "tp":
        result["tp_route"] = ("staged through the host (gloo)"
                              if C._gloo_card(params[0], mesh.group("tp"))
                              else "on the card (NCCL)")
    if moe:
        result.update(dropped=dropped, aux=aux)
    result.update(losses=losses, step_s=statistics.median(times[1:]),
                  peak_gib=torch.cuda.max_memory_allocated() / 2**30, buckets=buckets,
                  launches=launches, expected_launches=want, checks=checks)
    return result


def rank_mesh(argv) -> int:
    """One rank of phase mesh (run by the launcher): MESH_PARTS in turn."""
    import gc

    import torch.distributed as dist

    from kungfu_tpu_torch import distributed

    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--bucket-mib", type=int, default=256)
    args = ap.parse_args(argv)
    tf32_off()
    distributed.init_distributed(device="cuda")
    result = {"rank": dist.get_rank(), "backend": dist.get_backend(), "parts": {}}
    for part, sizes in MESH_PARTS:
        result["parts"][part] = mesh_part(part, sizes, MESH_STEPS, args.batch, args.seed,
                                          args.bucket_mib << 20)
        gc.collect()
        torch.cuda.empty_cache()
    result["ok"] = all(all(pr["checks"].values()) for pr in result["parts"].values())
    print(MESH_LINE + json.dumps(result), flush=True)
    distributed.shutdown_distributed()
    return 0 if result["ok"] else 1


def rank_fused(argv) -> int:
    """One rank of phase fused (run by the launcher)."""
    from kungfu_tpu_torch.tools import fused_check

    tf32_off()
    rc = fused_check.main(argv)
    if not jax_free():
        print("chip_smoke: JAX or the JAX package was imported", file=sys.stderr)
        return 1
    return rc


def rank_fsdp(argv) -> int:
    """One rank of phase fsdp (run by the launcher)."""
    import torch.distributed as dist

    from kungfu_tpu_torch import distributed
    from kungfu_tpu_torch.compression import error_feedback as EF
    from kungfu_tpu_torch.ops import flash
    from kungfu_tpu_torch.ops import fused_matmul as FM
    from kungfu_tpu_torch.ops import ring_collectives as RC
    from kungfu_tpu_torch.tools.step_profile import flagship_fsdp_step

    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=FSDP_STEPS)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    tf32_off()
    world = distributed.init_distributed(device="cuda")
    rank = dist.get_rank()
    cfg, trainer, state, batch = flagship_fsdp_step(args.batch, world, args.seed)
    torch.cuda.synchronize()
    init_bytes = torch.cuda.memory_allocated()  # the chunks, this rank's rows of the batch
    n_params = sum(math.prod(s) for s in trainer._shapes.values())
    n_leaves, n_buckets = len(trainer._shapes), len(trainer._buckets)
    limit = FSDP_MEMORY_SHARE * n_params * 4 * 3  # f32 parameters and two Adam moments
    limit1 = FSDP_MEMORY_SHARE * n_params * 4 * 4  # and the gradients
    kernels = flash.KERNELS + RC.KERNELS + EF.KERNELS + FM.KERNELS
    torch.cuda.reset_peak_memory_stats()
    for kern in kernels:
        kern.launches = 0
    losses, times = [], []
    for step in range(args.steps):
        t0 = time.perf_counter()
        state, metrics = trainer.train_step(state, batch)
        losses.append(metrics["loss"].item())  # waits for the step
        times.append(time.perf_counter() - t0)
        if step == 0:
            step1_bytes = torch.cuda.memory_allocated()  # with AdamW's moments
        print(f"[fsdp] rank {rank} step {step + 1}: loss {losses[-1]:.4f}, "
              f"{times[-1] * 1e3:.1f} ms", flush=True)
    launches = {k.name: k.launches for k in kernels}
    want = {k.name: 0 for k in kernels}
    want.update({k.name: cfg.n_layers * args.steps
                 for k in (flash.FLASH_FWD, flash.FLASH_BWD_DQ, flash.FLASH_BWD_DKV)})
    # one grouped gather a bucket forward, one grouped reduce-scatter backward
    want.update({RC.RING_AG.name: n_buckets * args.steps,
                 RC.RING_RS.name: n_buckets * args.steps})
    checks = {
        "loss finite": all(math.isfinite(x) for x in losses),
        "loss falls": losses[-1] < losses[0],
        "launches": launches == want,
        "memory after init": init_bytes <= limit,
        "memory after step 1": step1_bytes <= limit1,
        "no JAX": jax_free(),
    }
    result = {"rank": rank, "backend": dist.get_backend(), "losses": losses,
              "step_s": statistics.median(times[1:]) if args.steps > 1 else times[0],
              "init_gib": init_bytes / 2**30, "step1_gib": step1_bytes / 2**30,
              "limit_gib": limit / 2**30, "step1_limit_gib": limit1 / 2**30,
              "peak_gib": torch.cuda.max_memory_allocated() / 2**30, "leaves": n_leaves,
              "buckets": n_buckets,
              "launches": launches, "expected_launches": want, "checks": checks,
              "ok": all(checks.values())}
    print(FSDP_LINE + json.dumps(result), flush=True)
    distributed.shutdown_distributed()
    return 0 if result["ok"] else 1


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(HERE, "kungfu_tpu_torch")):
        print("chip_smoke: kungfu_tpu_torch is not beside this script", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    if sys.argv[1:2] == ["--rank-phase"]:  # one rank of a phase started by the launcher
        phase, rest = sys.argv[2], sys.argv[3:]
        workers = {"ring": rank_ring, "train": rank_train, "shift": rank_shift, "sp": rank_sp,
                   "fused": rank_fused, "fsdp": rank_fsdp, "adaptive": rank_adaptive,
                   "gossip": rank_gossip, "session": rank_session, "elastic": rank_elastic,
                   "heal": rank_heal, "heal-launcher": launch_heal,
                   "controlplane": rank_controlplane,
                   "controlplane-launcher": launch_controlplane, "mesh": rank_mesh}
        return workers[phase](rest)
    t_smoke = time.perf_counter()
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--rank-steps", type=int, default=3)
    ap.add_argument("--bucket-mib", type=int, default=256,
                    help="bucket_bytes of phases ranks, gqa and sp in MiB (0: one ring call "
                    "per gradient)")
    args = ap.parse_args()
    from kungfu_tpu_torch.compression import error_feedback as EF
    from kungfu_tpu_torch.ops import flash
    from kungfu_tpu_torch.ops import fused_matmul as FM
    from kungfu_tpu_torch.ops import ring_collectives as RC

    t_lap = [t_smoke]

    def lap(name: str) -> None:  # each phase's time, host clock
        now = time.perf_counter()
        print(f"[smoke] {name} {now - t_lap[0]:.1f} s")
        t_lap[0] = now

    drill = None
    try:
        card, kind, count = phase_device()
        phase_build()
        lap("build")
        drill = start_coordinator_drill()  # phase controlplane (a), beside the next phases
        results = [phase_kernels(args.seed), phase_kernels_gqa(args.seed)]
        lap("kernels")
        wide, wide_launches = phase_wide(args.seed)
        results.append(wide)
        lap("wide")
        phase_model_check(args.seed)
        lap("check")
        main_losses, n_params, fsdp_sizes, fsdp_groups = phase_main(args.steps, args.batch,
                                                                    args.seed)
        lap("main")
        cut_loss = phase_cut_reference(args.batch, args.seed)
        lap("cut-ref")
        torch.cuda.empty_cache()
        phase_chunked(args.batch, args.seed)
        lap("chunked")
        torch.cuda.empty_cache()  # the ranks need the card's memory
        gqa_loss, gqa_params, gqa_shapes = phase_gqa_reference(args.batch, args.seed)
        results.append(phase_ef(gqa_shapes, args.seed))
        lap("gqa-ref, ef")
        results.append(phase_ring(n_params, gqa_params, fsdp_sizes, fsdp_groups, args.seed))
        lap("ring")
        ranks_launches, ranks_losses = phase_ranks(args.rank_steps, args.batch, args.seed,
                                                   args.bucket_mib, main_losses[0])
        lap("ranks")
        phase_adaptive(card, args.rank_steps, args.batch, args.seed, args.bucket_mib,
                       main_losses[0], ranks_losses)
        lap("adaptive")
        gossip_shifts = phase_gossip(card, args.batch, args.seed, main_losses[0])
        lap("gossip")
        session_launches = phase_session(card, args.batch, args.seed, cut_loss)
        lap("session")
        elastic_launches = phase_elastic(card, args.batch, args.seed, args.bucket_mib, cut_loss)
        lap("elastic")
        heal_launches = phase_heal(card, args.batch, args.seed, args.bucket_mib, cut_loss)
        lap("heal")
        gqa_launches, _ = phase_ranks(args.rank_steps, args.batch, args.seed, args.bucket_mib,
                                      gqa_loss, compression="int8")
        lap("gqa")
        results.append(phase_shift(args.seed))
        lap("shift")
        sp_loss = phase_sp_reference(args.seed)
        sp_launches, ulysses_launches = phase_sp(SP_STEPS, args.seed, args.bucket_mib, sp_loss)
        lap("sp-ref, sp, ulysses (in phase sp's ranks)")
        fused, fused_launches = phase_fused(args.seed)
        results.append(fused)
        lap("fused")
        phase_fsdp(FSDP_STEPS, args.batch, args.seed, main_losses[0],
                   ranks_losses[:FSDP_STEPS])
        lap("fsdp")
        cp_launches = phase_controlplane(card, args.batch, args.seed, args.bucket_mib, cut_loss,
                                         drill)
        lap("controlplane")
        mesh_launches = phase_mesh(args.batch, args.seed, args.bucket_mib, cut_loss)
        lap("mesh")
        # each kernel's launches from the path that runs it
        launches = {name: n or gqa_launches[name] for name, n in ranks_launches.items()}
        launches[FM.SHIFT.name] = sp_launches[FM.SHIFT.name]
        for kern in (FM.AG_MATMUL, FM.MATMUL_RS):
            launches[kern.name] = fused_launches[kern.name]
        launches.update(wide_launches)
        check(all(launches.values()), f"a kernel of the main paths never launched: {launches}")
        check(jax_free(), "JAX or the JAX package was imported")
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    finally:
        if drill is not None and drill[0].poll() is None:  # a phase before it failed
            try:  # the drill stops its own ensemble: let it end
                drill[0].communicate(timeout=300)
            except subprocess.TimeoutExpired:
                drill[0].kill()
                drill[0].communicate()
            import shutil

            shutil.rmtree(drill[1], ignore_errors=True)
    errs, ms, plain, library, bounds = ({k: v for r in results for k, v in r[i].items()}
                                        for i in range(5))
    kernels = [{
        "name": k.name, "route": "cuda", "source": k.source, "replaces": k.replaces,
        "launches": launches[k.name], "max_abs_err": errs[k.name], "ms": ms[k.name],
        "plain_ms": plain[k.name], "bound_ms": bounds[k.name][0],
        "bound_by": bounds[k.name][1], "library_ms": library[k.name],
    } for k in flash.KERNELS + flash.WIDE_KERNELS + RC.KERNELS + FM.KERNELS + EF.KERNELS]
    for k in kernels:  # B11 runs two paths: ring attention's K/V and the gossip pull
        if k["name"] == FM.SHIFT.name:
            k["launches_by_phase"] = {"sp": launches[k["name"]], "gossip": gossip_shifts}
        if k["name"] in session_launches:  # B5-B8 also run under the Session's strategies
            first = "ranks" if k["name"] in (RC.RING_RS.name, RC.RING_AG.name) else "gqa"
            k["launches_by_phase"] = {first: launches[k["name"]],
                                      "session": session_launches[k["name"]]}
        if elastic_launches.get(k["name"]):  # B1-B3, B5 and B6 also run under run_elastic
            k.setdefault("launches_by_phase", {"ranks": launches[k["name"]]})
            k["launches_by_phase"]["elastic"] = elastic_launches[k["name"]]
        if heal_launches.get(k["name"]):  # and across phase heal's crash, heal and regrow
            k.setdefault("launches_by_phase", {"ranks": launches[k["name"]]})
            k["launches_by_phase"]["heal"] = heal_launches[k["name"]]
        ulysses = sum(part.get(k["name"], 0) for part in ulysses_launches.values())
        if ulysses:  # B1-B6 under Ulysses' all_to_all (B4 in its GQA part)
            k.setdefault("launches_by_phase", {"gqa" if k["name"] == flash.FLASH_BWD_DKV_GQA.name
                                               else "ranks": launches[k["name"]]})
            k["launches_by_phase"]["ulysses"] = ulysses
        if cp_launches.get(k["name"]):  # and under run_elastic through a leader failover
            k.setdefault("launches_by_phase", {"ranks": launches[k["name"]]})
            k["launches_by_phase"]["controlplane"] = cp_launches[k["name"]]
        mesh = sum(part.get(k["name"], 0) for part in mesh_launches.values())
        if mesh:  # B1-B3, B5/B6 and B11 on the model axes (tp, ep, pp)
            k.setdefault("launches_by_phase", {"ranks": launches[k["name"]]})
            k["launches_by_phase"]["mesh"] = mesh
    print(f"[smoke] every phase passed in {time.perf_counter() - t_smoke:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
