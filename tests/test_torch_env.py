"""The port's env contract against the JAX package's, and the port's rules:
no JAX in the port, and no quiet move to the CPU without a card."""
from __future__ import annotations

import os
import subprocess
import sys

import pytest
import torch

from _torch_reference import jax_reference
from kungfu_tpu_torch import compat, env as tenv
from kungfu_tpu_torch.distributed import init_distributed, placement
from kungfu_tpu_torch.plan import PeerID, PeerList

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def jenv():
    with jax_reference():
        from kungfu_tpu import env

        yield env


ENVS = {
    "empty": {},
    "single-fallback-strategy": {"KFT_ALLREDUCE_STRATEGY": "ring",
                                 "KFT_CONFIG_SERVER": "http://cfg:9100"},
    "two-workers": {
        "KFT_SELF_SPEC": "10.0.0.2:10001",
        "KFT_INIT_PEERS": "10.0.0.1:10000,10.0.0.2:10001",
        "KFT_INIT_RUNNERS": "10.0.0.1:38080,10.0.0.2:38080",
        "KFT_INIT_CLUSTER_VERSION": "3",
        "KFT_PARENT_ID": "10.0.0.2:38080",
        "KFT_ALLREDUCE_STRATEGY": "BINARY_TREE_STAR",
    },
    "self-only-replicated-config": {
        "KFT_SELF_SPEC": "host-a:10000",
        "KFT_CONFIG_SERVER": "http://a:1",
        "KFT_CONFIG_URLS": "http://a:1,http://b:1",
        "KFT_ALLREDUCE_STRATEGY": "multi-binary-tree-star",
    },
}


def _summary(cfg):
    return (str(cfg.self_id), [str(p) for p in cfg.peers], [str(p) for p in cfg.runners],
            cfg.cluster_version, cfg.strategy.name, cfg.config_server,
            None if cfg.parent is None else str(cfg.parent), cfg.single_machine, cfg.rank,
            cfg.peers.local_rank(cfg.self_id), cfg.peers.host_count(),
            cfg.cluster().digest(), cfg.peers.digest())


@pytest.mark.parametrize("name", list(ENVS))
def test_parse_config_matches_jax(jenv, name):
    assert _summary(tenv.parse_config_from_env(ENVS[name])) == \
        _summary(jenv.parse_config_from_env(ENVS[name]))


def test_bad_env_raises_like_jax(jenv):
    for bad in ({"KFT_SELF_SPEC": "nohostport"}, {"KFT_ALLREDUCE_STRATEGY": "bogus"}):
        with pytest.raises(ValueError):
            jenv.parse_config_from_env(bad)
        with pytest.raises(ValueError):
            tenv.parse_config_from_env(bad)


def test_single_peer_needs_no_group():
    assert init_distributed(tenv.parse_config_from_env({}), device="cpu") == 1


ONE_HOST = "127.0.0.1:10000,127.0.0.1:10001,127.0.0.1:10002,127.0.0.1:10003"
TWO_HOSTS = "a:10000,a:10001,b:10000,b:10001"


@pytest.mark.parametrize("peers,me,device,cards,want", [
    (ONE_HOST, "127.0.0.1:10002", "cuda", 1, (0, "gloo")),  # four ranks share the card
    (ONE_HOST, "127.0.0.1:10003", "cuda", 4, (3, "nccl")),  # a card each
    (ONE_HOST, "127.0.0.1:10003", "cuda", 2, (1, "gloo")),  # two ranks a card
    (ONE_HOST, "127.0.0.1:10001", "cuda", 8, (1, "nccl")),
    (TWO_HOSTS, "b:10001", "cuda", 2, (1, "nccl")),  # local rank 1 of host b
    (TWO_HOSTS, "b:10000", "cuda", 1, (0, "gloo")),
    (ONE_HOST, "127.0.0.1:10002", "cpu", 0, (None, "gloo")),
])
def test_placement_picks_card_and_backend(peers, me, device, cards, want):
    """Card = the peer's port mod the cards a rank sees (the launcher's
    ports from 10000: local rank mod the cards); NCCL only when every
    rank of a host has a card of its own, since NCCL refuses two ranks of
    one communicator on one card."""
    peer_list = PeerList(PeerID.parse(p) for p in peers.split(","))
    assert placement(peer_list, PeerID.parse(me), device, cards) == want


def test_placement_keeps_a_peer_on_its_card_across_a_heal():
    """A heal drops 127.0.0.1:10002 of four ranks on four cards: the
    survivor at 10003 becomes rank 2 and keeps card 3, where its model
    lives; the worker regrown at 10002 (rank 3) takes card 2, the one it
    left, and every rank keeps a card of its own (NCCL)."""
    peers = [PeerID.parse(p) for p in ONE_HOST.split(",")]
    healed = PeerList([peers[0], peers[1], peers[3]])
    regrown = PeerList([*healed, peers[2]])
    assert [placement(healed, p, "cuda", 4) for p in healed] == \
        [(0, "nccl"), (1, "nccl"), (3, "nccl")]
    assert [placement(regrown, p, "cuda", 4)[0] for p in regrown] == [0, 1, 3, 2]


def test_placement_falls_back_to_gloo_when_a_grown_worker_shares_a_card():
    """Ranks launched at 12345-12348 on four cards shrink to two (cards 1
    and 2); the planned grow adds workers at the lowest free ports from
    10000, and 10001 lands on card 1 beside 12345: the group is gloo, as
    NCCL refuses two ranks of one communicator on one card."""
    from kungfu_tpu_torch.plan import Cluster

    launched = Cluster(runners=PeerList([PeerID("127.0.0.1", 38080)]),
                       workers=PeerList(PeerID("127.0.0.1", 12345 + i) for i in range(4)))
    assert {placement(launched.workers, p, "cuda", 4) for p in launched.workers} == \
        {(1, "nccl"), (2, "nccl"), (3, "nccl"), (0, "nccl")}
    shrunk = launched.resize(2)
    assert [placement(shrunk.workers, p, "cuda", 4) for p in shrunk.workers] == \
        [(1, "nccl"), (2, "nccl")]
    grown = shrunk.resize(4)
    assert [p.port for p in grown.workers] == [12345, 12346, 10000, 10001]
    assert [placement(grown.workers, p, "cuda", 4) for p in grown.workers] == \
        [(1, "gloo"), (2, "gloo"), (0, "gloo"), (1, "gloo")]


TIMEOUTS = """
import sys, time
import torch, torch.distributed as dist
from kungfu_tpu_torch.distributed import init_distributed
from kungfu_tpu_torch.env import parse_config_from_env
late_init, late_op = float(sys.argv[1]), float(sys.argv[2])
rank = parse_config_from_env().rank
t0 = time.monotonic()
try:
    if rank == 1:
        time.sleep(late_init)
    init_distributed(device="cpu")
    if rank == 1:
        time.sleep(late_op)
    x = torch.ones(4)
    dist.all_reduce(x)
    print("OK", float(x[0]))
    dist.destroy_process_group()
except Exception as e:
    print("FAILED", type(e).__name__, round(time.monotonic() - t0, 1))
"""


@pytest.mark.parametrize("late_init,late_op,want", [
    (0, 5, ["OK 2.0", "OK 2.0"]),  # a rank 5 s late to an operation
    (15, 0, ["FAILED"]),  # a rank 15 s late to the rendezvous: rank 0 gives up first
])
def test_init_timeout_bounds_the_rendezvous_not_the_operations(late_init, late_op, want):
    """KFT_INIT_TIMEOUT_S (2 s here) bounds the group's rendezvous, as in
    the JAX package; the group's operations get distributed.OP_TIMEOUT."""
    from _torch_ranks import start_ranks, wait_ranks

    outs = wait_ranks(start_ranks(TIMEOUTS, 2, [late_init, late_op],
                                  env={"KFT_INIT_TIMEOUT_S": "2"}), timeout=90)
    got = [outs[r].strip().splitlines()[-1] for r in (0, 1)]
    if want == ["FAILED"]:
        assert got[0].startswith("FAILED") and float(got[0].split()[-1]) < late_init, got
    else:
        assert got == want, outs


def test_placement_needs_a_card_for_cuda():
    with pytest.raises(RuntimeError, match="no CUDA card"):
        placement(PeerList([PeerID("h", 1)]), PeerID("h", 1), "cuda", 0)


PROBE = """
import importlib, pkgutil, sys
import kungfu_tpu_torch
names = [m.name for m in pkgutil.walk_packages(kungfu_tpu_torch.__path__, "kungfu_tpu_torch.")]
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax")
             or m == "kungfu_tpu" or m.startswith("kungfu_tpu."))
print(len(names), bad)
sys.exit(1 if bad or len(names) < 10 else 0)
"""


def test_port_imports_no_jax():
    """Importing every module of the port loads no JAX and nothing of the
    JAX package (checked in a fresh interpreter)."""
    out = subprocess.run([sys.executable, "-c", PROBE], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


def test_default_device_is_the_card():
    """Without CUDA, an entry point called without device= raises; it does
    not move to the CPU on its own."""
    from kungfu_tpu_torch.models import TransformerConfig, TransformerLM
    from kungfu_tpu_torch.optimizers import adamw, synchronous_sgd
    from kungfu_tpu_torch.train import DataParallelTrainer

    if torch.cuda.is_available():
        assert compat.resolve_device().type == "cuda"
        return
    cfg = TransformerConfig(vocab_size=11, d_model=16, n_layers=1, n_heads=2, d_ff=32,
                            max_len=8)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TransformerLM(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DataParallelTrainer(lambda m, b: 0, synchronous_sgd(adamw(1e-3)))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        compat.resolve_device()
    assert compat.kernel_mode("cpu") == "plain"
    with pytest.raises(ValueError):
        compat.kernel_mode("meta")
