"""Print the framework, torch, the CUDA view, the KFT_ environment and a
platform-discovered cluster as JSON.

    python -m kungfu_tpu_torch.info [--device cpu]

With `--device cpu` nothing asks CUDA for a card."""
from __future__ import annotations

import argparse
import json
import os
import sys


def collect(device: str = "cuda", env=None) -> dict:
    """The dump as a dict; `device="cpu"` leaves CUDA untouched."""
    import torch

    from ..platforms import discover

    e = os.environ if env is None else env
    info = {"framework": "kungfu_tpu_torch", "version": "0.1.0", "torch": torch.__version__,
            "cuda": torch.version.cuda}
    if device != "cpu":
        count = torch.cuda.device_count()
        info["devices"] = count
        info["device_names"] = [torch.cuda.get_device_name(i) for i in range(count)]
    info["env"] = {k: v for k, v in sorted(e.items()) if k.startswith("KFT_")}
    got = discover(e)
    if got is not None:
        cluster, self_host = got
        info["platform_cluster"] = {"size": cluster.size(), "self": self_host}
    return info


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    info = collect(ap.parse_args(argv).device)
    try:
        print(json.dumps(info, indent=2))
    except BrokenPipeError:  # a pager or head closed the pipe
        os.dup2(os.open(os.devnull, os.O_WRONLY), sys.stdout.fileno())
    return 0


if __name__ == "__main__":
    sys.exit(main())
