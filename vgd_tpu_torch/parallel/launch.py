"""Process-group start-up and a launcher of rank processes.

``init_distributed`` starts ``torch.distributed`` in one of two ways:

* ``multihost`` with the JAX package's variables, ``VGD_COORDINATOR``
  (host:port of rank 0), ``VGD_NUM_PROCESSES`` and ``VGD_PROCESS_ID``, as
  ``vgd_tpu/train/loop.py`` passes them to ``jax.distributed.initialize``;
* otherwise from the variables ``torchrun`` sets (``RANK``, ``WORLD_SIZE``,
  ``LOCAL_RANK``, ``MASTER_ADDR`` / ``MASTER_PORT``), PyTorch's
  counterpart of a TPU pod's auto-detection. Without them the run is one
  process and no group starts.

The backend is NCCL when every rank of a host has its own card
(``LOCAL_WORLD_SIZE``, else the world, at most the visible cards), gloo on
the CPU or when there are more ranks than cards (NCCL refuses two ranks on
one device). Each rank's default card is ``cuda:LOCAL_RANK`` (modulo the
visible cards). Rank 0 prints the backend it chose.

``spawn`` runs a function of this package in N fresh processes with
torchrun's variables set (a free localhost port, one torch thread each) and
returns each rank's return value; ``python -m vgd_tpu_torch.parallel.launch
<dir>`` is the body of one such process. The CPU tests start their gloo
ranks with it, and ``chip_smoke.py`` its two processes on one card.
"""
from __future__ import annotations

import datetime
import importlib
import os
import shutil
import socket
import subprocess
import sys
import tempfile
import time
import traceback
from typing import Any, List, Optional

import torch
import torch.distributed as dist

TIMEOUT = datetime.timedelta(minutes=10)


def _env_int(name: str, default: Optional[int] = None) -> Optional[int]:
    v = os.environ.get(name)
    return default if v in (None, "") else int(v)


def local_rank() -> int:
    """This process's rank on its host (0 for one process)."""
    return _env_int("LOCAL_RANK", _env_int("VGD_PROCESS_ID", 0))


def rank_device(device) -> torch.device:
    """``device`` with this rank's card: a bare ``cuda`` becomes
    ``cuda:LOCAL_RANK`` (modulo the visible cards) under a started group."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None and dist.is_available() \
            and dist.is_initialized() and torch.cuda.is_available():
        dev = torch.device("cuda", local_rank() % torch.cuda.device_count())
    return dev


def init_distributed(multihost: bool = False, device="cuda") -> Optional[str]:
    """Start the process group the environment describes (module
    docstring); returns its backend, or None for one process. A started
    group is kept."""
    if dist.is_initialized():
        return dist.get_backend()
    addr = os.environ.get("VGD_COORDINATOR")
    if multihost and addr:
        world = _env_int("VGD_NUM_PROCESSES")
        rank = _env_int("VGD_PROCESS_ID")
        if world is None or rank is None:
            raise RuntimeError("--multihost with VGD_COORDINATOR needs "
                               "VGD_NUM_PROCESSES and VGD_PROCESS_ID")
        init = f"tcp://{addr}"
    elif "WORLD_SIZE" in os.environ and "RANK" in os.environ:
        world, rank = _env_int("WORLD_SIZE"), _env_int("RANK")
        init = "env://"
    elif multihost:
        raise RuntimeError("--multihost needs VGD_COORDINATOR=host:port, "
                           "VGD_NUM_PROCESSES and VGD_PROCESS_ID, or a "
                           "launch by torchrun")
    else:
        return None
    dev = torch.device(device)
    cards = torch.cuda.device_count() if dev.type == "cuda" else 0
    per_host = _env_int("LOCAL_WORLD_SIZE", world)
    backend = "nccl" if dev.type == "cuda" and per_host <= cards else "gloo"
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is visible; pass "
                               "device='cpu' to run on the CPU")
        torch.cuda.set_device(local_rank() % cards)
    dist.init_process_group(backend, init_method=init, world_size=world,
                            rank=rank, timeout=TIMEOUT)
    if rank == 0:
        why = ("a card per rank" if backend == "nccl" else
               f"{per_host} ranks a host on {cards} card(s)"
               if dev.type == "cuda" else "CPU tensors")
        print(f"[setup] torch.distributed backend {backend} world {world} "
              f"({why})", flush=True)
    return backend


def free_port() -> int:
    """A localhost TCP port that was free a moment ago."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def spawn(target: str, nprocs: int, *args, timeout: float = 600.0,
          env: Optional[dict] = None, log_dir: Optional[str] = None,
          **kwargs) -> List[Any]:
    """Run ``target`` ("package.module:function") as ``fn(*args,
    **kwargs)`` in ``nprocs`` fresh processes (torchrun's variables on a
    free localhost port) and return each rank's return value, in rank
    order. The arguments and results travel as ``torch.save`` files. A rank
    that fails, or a run past ``timeout`` seconds, stops every rank and
    raises with the logs' last lines. Each rank's output goes to
    ``<log_dir>/rank<r>.log`` (a temporary directory by default)."""
    work = tempfile.mkdtemp(prefix="vgd_spawn_")
    log_dir = log_dir or work
    os.makedirs(log_dir, exist_ok=True)
    torch.save({"target": target, "args": args, "kwargs": kwargs},
               os.path.join(work, "spec.pt"))
    port = free_port()
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    procs, logs = [], []
    for r in range(nprocs):
        e = dict(os.environ, **(env or {}))
        e.update(RANK=str(r), LOCAL_RANK=str(r), WORLD_SIZE=str(nprocs),
                 LOCAL_WORLD_SIZE=str(nprocs), MASTER_ADDR="127.0.0.1",
                 MASTER_PORT=str(port), OMP_NUM_THREADS="1",
                 PYTHONPATH=os.pathsep.join(
                     [root] + [p for p in [e.get("PYTHONPATH")] if p]))
        log = open(os.path.join(log_dir, f"rank{r}.log"), "w")
        logs.append(log)
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "vgd_tpu_torch.parallel.launch", work],
            env=e, stdout=log, stderr=subprocess.STDOUT))
    failed = []
    deadline = time.monotonic() + timeout
    try:
        while not failed:
            rcs = [p.poll() for p in procs]
            failed = [(r, rc) for r, rc in enumerate(rcs)
                      if rc not in (None, 0)]
            if all(rc == 0 for rc in rcs):
                break
            if not failed and time.monotonic() > deadline:
                failed = [(r, "timeout") for r, rc in enumerate(rcs)
                          if rc is None]
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for log in logs:
            log.close()
    try:
        if failed:
            tails = []
            for r in range(nprocs):
                with open(os.path.join(log_dir, f"rank{r}.log")) as f:
                    tails.append(f"--- rank {r}:\n" + "".join(
                        f.readlines()[-40:]))
            raise RuntimeError(f"{target} on {nprocs} ranks: rank "
                               f"{failed[0][0]} ended with {failed[0][1]}\n"
                               + "\n".join(tails))
        return [torch.load(os.path.join(work, f"result{r}.pt"),
                           weights_only=False) for r in range(nprocs)]
    finally:
        shutil.rmtree(work, ignore_errors=True)


def _child(work: str) -> int:
    torch.set_num_threads(1)
    spec = torch.load(os.path.join(work, "spec.pt"), weights_only=False)
    mod, _, name = spec["target"].partition(":")
    rank = _env_int("RANK", 0)
    try:
        out = getattr(importlib.import_module(mod), name)(
            *spec["args"], **spec["kwargs"])
        torch.save(out, os.path.join(work, f"result{rank}.pt"))
    except Exception:              # noqa: BLE001 - report, fail the rank
        traceback.print_exc()
        sys.stdout.flush()
        return 1
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(_child(sys.argv[1]))
