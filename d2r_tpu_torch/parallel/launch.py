"""Localhost multi-process launch helpers (counterpart of
``d2r_tpu/parallel/launch.py``).

The pieces that the tests and ``chip_smoke.py`` share: a free port for the
coordinator, a rank's environment for a launcher-style start
(``--num_processes -1``), the tiny-geometry command line of the port's CLI,
and :func:`spawn`, which runs one function in ``world`` fresh processes
joined in one process group (the processes import only torch, the port and
the function's own module).
"""

from __future__ import annotations

import datetime
import multiprocessing as mp
import os
import pickle
import queue as queue_mod
import socket
import sys
import time
import traceback
from typing import Callable, Dict, List, Optional, Sequence

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def free_port() -> int:
    """An OS-assigned free TCP port on localhost for the coordinator."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def rank_env(rank: int, world: int, port: int,
             base: Optional[Dict[str, str]] = None) -> Dict[str, str]:
    """The environment of one rank started as a launcher starts it (what
    ``--num_processes -1`` reads): ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
    ``MASTER_ADDR``/``MASTER_PORT`` on localhost, the repository on
    ``PYTHONPATH`` and one intra-op thread."""
    env = dict(base if base is not None else os.environ)
    env.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank),
               MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port), PYTHONPATH=REPO,
               OMP_NUM_THREADS="1")
    return env


def tiny_train_cmd(paths: Dict[str, str], out_dir: str, batch_size: int = 8,
                   extra: Sequence[str] = ()) -> List[str]:
    """The port's CLI at tiny geometry on the CPU (tiny towers, seq 16, one
    epoch, float32, the plain path) on ``write_fake_dataset``'s files."""
    return [sys.executable, "-m", "d2r_tpu_torch.cli",
            "--device", "cpu", "--bert_name", "tiny-bert",
            "--vit_name", "tiny-vit", "--embed_size", "64",
            "--num_head_IMRC", "4", "--hid_IMRC", "64", "--hid_router", "32",
            "--max_seq", "16", "--batch_size", str(batch_size),
            "--num_epochs", "1", "--lr", "3e-4",
            "--compute_dtype", "float32", "--no_pallas",
            "--num_workers", "2",
            "--train_json", paths["train"], "--dev_json", paths["dev"],
            "--test_json", paths["test"], "--img_dir", paths["img_dir"],
            "--save_path", out_dir] + list(extra)


def _rank_main(fn, rank, world, port, backend, args, threads, timeout_s, results):
    import torch
    import torch.distributed as dist
    torch.set_num_threads(threads)
    try:
        dist.init_process_group(backend, init_method=f"tcp://127.0.0.1:{port}",
                                world_size=world, rank=rank,
                                timeout=datetime.timedelta(seconds=timeout_s))
        try:
            out = fn(rank, world, *args)
        finally:
            dist.destroy_process_group()
        # by value: a tensor sent as itself would be shared memory, gone with
        # this process
        results.put((rank, True, pickle.dumps(out)))
    except BaseException:  # noqa: BLE001 - the parent raises it with the traceback
        results.put((rank, False, traceback.format_exc()))


def spawn(fn: Callable, world: int, args: Sequence = (), backend: str = "gloo",
          threads: int = 1, timeout_s: float = 600.0) -> list:
    """``fn(rank, world, *args)`` in ``world`` spawned processes joined in one
    process group of ``backend``; returns their results in rank order.
    ``fn`` must be importable by its module's name and its result
    picklable. A rank that raises makes this raise with its traceback; the
    others are stopped."""
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    port = free_port()
    procs = [ctx.Process(target=_rank_main, daemon=True,
                         args=(fn, r, world, port, backend, tuple(args), threads,
                               timeout_s, results))
             for r in range(world)]
    for p in procs:
        p.start()
    got, deadline = {}, time.monotonic() + timeout_s
    try:
        while len(got) < world:         # drain before joining
            try:
                rank, ok, out = results.get(timeout=max(deadline - time.monotonic(), 0.1))
            except queue_mod.Empty:
                raise TimeoutError(f"ranks {sorted(set(range(world)) - set(got))} gave no "
                                   f"result within {timeout_s} s") from None
            if not ok:
                raise RuntimeError(f"rank {rank} of {world} failed:\n{out}")
            got[rank] = pickle.loads(out)
    finally:
        for p in procs:
            p.join(timeout=30)
            if p.is_alive():
                p.terminate()
                p.join()
    return [got[r] for r in range(world)]
