# -*- coding: utf-8 -*-
"""Start ranks: one fresh interpreter per rank, joined in one process group.

``spawn("package.module:function", n, kwargs)`` runs ``function(**kwargs)``
in ``n`` new interpreters (``python -m climsr_tpu_torch.parallel.launch``),
each in a ``torch.distributed`` group over ``tcp://127.0.0.1:<free port>``
with its rank and the world size set. A fresh interpreter imports only the
port and what the function imports, which the ``fork`` or ``spawn`` start
methods of ``multiprocessing`` would not promise (the latter re-imports the
parent's ``__main__``).

- ``backend="gloo"`` works with CPU and CUDA tensors, and lets several ranks
  share one card;
- ``backend="nccl"`` takes one card per rank (``cuda:<rank>``) and raises
  where there are fewer cards than ranks.

The parent waits for every rank and raises if one fails, naming its exit
code; it stops the others then. This is what ``cli.train`` and
``cli.inference`` use to start their ranks. Under ``torchrun`` they join its
group (:func:`init_from_env`), and an entry point called inside an
initialized group takes that group.
"""
from __future__ import annotations

import importlib
import json
import os
import socket
import subprocess
import sys
import time
from typing import Any, Dict, Optional


def free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def spawn(target: str, world_size: int, kwargs: Optional[Dict[str, Any]] = None, backend: str = "gloo",
          timeout: float = 1800.0, env: Optional[Dict[str, str]] = None) -> None:
    """Run ``target`` ("module:function") on ``world_size`` ranks; see the module docstring."""
    if backend == "nccl":
        import torch

        if torch.cuda.device_count() < world_size:
            raise RuntimeError(f"NCCL takes one card per rank: {world_size} ranks, "
                               f"{torch.cuda.device_count()} card(s)")
    port = free_port()
    payload = json.dumps({"target": target, "kwargs": kwargs or {}, "backend": backend})
    procs = []
    for rank in range(world_size):
        child_env = dict(os.environ, **(env or {}))
        child_env.update(RANK=str(rank), WORLD_SIZE=str(world_size), MASTER_ADDR="127.0.0.1",
                         MASTER_PORT=str(port))
        procs.append(subprocess.Popen([sys.executable, "-m", "climsr_tpu_torch.parallel.launch", payload],
                                      env=child_env))
    deadline = time.time() + timeout
    failed = None
    try:
        while any(p.poll() is None for p in procs):
            bad = [(r, p.returncode) for r, p in enumerate(procs) if p.returncode not in (None, 0)]
            if bad:
                failed = bad[0]
                break
            if time.time() > deadline:
                failed = ("all", "timeout")
                break
            time.sleep(0.05)
        else:
            bad = [(r, p.returncode) for r, p in enumerate(procs) if p.returncode != 0]
            failed = bad[0] if bad else None
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
        for p in procs:
            p.wait()
    if failed is not None:
        raise RuntimeError(f"rank {failed[0]} of {target} failed ({failed[1]})")


def init_from_env(device) -> None:
    """Under ``torchrun`` (``WORLD_SIZE`` > 1 in the environment and no group
    yet): join the group, NCCL on ``cuda`` with this rank's card
    (``LOCAL_RANK``), gloo otherwise."""
    import torch
    import torch.distributed as dist

    if dist.is_initialized() or int(os.environ.get("WORLD_SIZE", "1")) <= 1:
        return
    cuda = torch.device(device).type == "cuda"
    if cuda:
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0")))
    dist.init_process_group("nccl" if cuda else "gloo", init_method="env://")


def _main(payload: str) -> None:
    import torch
    import torch.distributed as dist

    spec = json.loads(payload)
    rank, world_size = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    if spec["backend"] == "nccl":
        torch.cuda.set_device(rank)
    dist.init_process_group(spec["backend"], rank=rank, world_size=world_size,
                            init_method=f"tcp://{os.environ['MASTER_ADDR']}:{os.environ['MASTER_PORT']}")
    try:
        module, _, name = spec["target"].partition(":")
        getattr(importlib.import_module(module), name)(**spec["kwargs"])
        dist.barrier()
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    _main(sys.argv[1])
