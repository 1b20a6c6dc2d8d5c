"""Process groups and the collectives of the port's multi-device layouts
(the counterpart of ``chattts_tpu/parallel/mesh.py::initialize_distributed``).

The JAX package runs one controller over every chip and lets XLA move the
bytes.  PyTorch runs one process a rank (SPMD): each builds the same
scheduler, owns its shard of the state and meets the others in explicit
collectives.  Every collective of the port is an ``all_reduce`` (a sum) or a
``broadcast``; a gather is an all_reduce of zero-padded parts, which adds
nothing but zeros to any value and so is exact.  Those two are the ones
gloo takes on CUDA tensors, so one code runs three ways: on NCCL where each
rank has a GPU of its own, on gloo with CUDA tensors where ranks share a
card (NCCL refuses two ranks on one GPU), and on gloo on the CPU.  Nothing
falls back: a backend that refuses a tensor raises.

Training differentiates through three of them (:func:`reduce_sum`,
:func:`copy_to`, :func:`gather_cat`), each a ``torch.autograd.Function``
whose backward is again an all_reduce: the sum (backward the identity), the
copy (the identity, backward the sum) and the gather along a dimension
(backward the sum, then this rank's slice).  Autograd runs a rank's backward
collectives in the order of its graph, which every rank of a mesh builds
alike; ``parallel/pipeline.py``, whose stages build different graphs,
orders its own.  The in-place :func:`all_reduce` is for tensors that need
no gradient.

:func:`spawn` runs a function on ``n`` new processes of one group on this
host (tests, ``graft_entry.dryrun_multichip``, ``chip_smoke.py``); a host
launched with ``torchrun`` calls :func:`initialize_distributed` with no
arguments instead.
"""

from __future__ import annotations

import logging
import multiprocessing
import os
import queue as queue_mod
import socket
import traceback
from datetime import timedelta
from typing import Any, Callable, List, Optional, Sequence

import torch
import torch.distributed as dist

log = logging.getLogger(__name__)

# seconds any collective, and the whole of a spawned run, may take
TIMEOUT_S = 600.0


def choose_backend(world_size: int) -> str:
    """NCCL where every rank has a GPU of its own, gloo otherwise."""
    if (torch.cuda.is_available() and dist.is_nccl_available()
            and torch.cuda.device_count() >= world_size):
        return "nccl"
    return "gloo"


def initialize_distributed(coordinator: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None,
                           backend: Optional[str] = None) -> bool:
    """Join the process group; returns whether this call created it.

    ``coordinator`` ("host:port") is rank 0's TCP store; without it the
    group reads ``MASTER_ADDR``, ``MASTER_PORT``, ``WORLD_SIZE`` and
    ``RANK`` (``torchrun`` sets them).  A no-op when a group exists, and at
    world size 1 unless ``backend`` asks for a group of one.  The backend
    is :func:`choose_backend`'s unless given; an NCCL rank takes GPU
    ``LOCAL_RANK`` (or its rank modulo the GPUs).  Every collective times
    out after :data:`TIMEOUT_S`."""
    if dist.is_initialized():
        return False
    world = (num_processes if num_processes is not None
             else int(os.environ.get("WORLD_SIZE", "1")))
    if world == 1 and backend is None:
        return False
    rank = (process_id if process_id is not None
            else int(os.environ.get("RANK", "0")))
    backend = backend or choose_backend(world)
    if backend == "nccl":
        local = int(os.environ.get("LOCAL_RANK", rank))
        torch.cuda.set_device(local % torch.cuda.device_count())
    init = f"tcp://{coordinator}" if coordinator else "env://"
    dist.init_process_group(backend, init_method=init, world_size=world,
                            rank=rank, timeout=timedelta(seconds=TIMEOUT_S))
    log.info("rank %d of %d joined the process group on %s", rank, world,
             backend)
    return True


def all_reduce(t: torch.Tensor, group) -> torch.Tensor:
    """Sum ``t`` over ``group`` in place; returns it."""
    dist.all_reduce(t, op=dist.ReduceOp.SUM, group=group)
    return t


def broadcast(t: torch.Tensor, src: int, group) -> torch.Tensor:
    """``t`` of global rank ``src`` to every rank of ``group``, in place."""
    dist.broadcast(t, src=src, group=group)
    return t


def gather_padded(part: torch.Tensor, index: int, n: int, group
                  ) -> torch.Tensor:
    """(n, *part.shape): row ``index`` is this rank's ``part``, the others
    those of the ranks at the other indices of ``group``: an all_reduce of
    zero-padded parts, exact."""
    out = torch.zeros((n,) + tuple(part.shape), dtype=part.dtype,
                      device=part.device)
    out[index] = part
    return all_reduce(out, group)


class _ReduceSum(torch.autograd.Function):
    """Forward the sum over ``group``; backward the identity (each rank's
    partial takes the gradient of the sum)."""

    @staticmethod
    def forward(ctx, t, group):
        return all_reduce(t.clone(), group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _CopyTo(torch.autograd.Function):
    """Forward the identity (a tensor every rank of ``group`` holds whole
    enters rank-local work); backward the sum of the ranks' gradients."""

    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g.clone(), ctx.group), None


class _GatherCat(torch.autograd.Function):
    """Forward every rank's part concatenated along ``dim`` in index order
    (:func:`gather_padded`); backward the sum of the ranks' gradients of
    the whole, of which this rank takes its part's slice."""

    @staticmethod
    def forward(ctx, t, dim, index, n, group):
        ctx.dim, ctx.index, ctx.size, ctx.group = dim, index, t.shape[dim], \
            group
        parts = gather_padded(t, index, n, group)
        return torch.cat(parts.unbind(0), dim=dim)

    @staticmethod
    def backward(ctx, g):
        g = all_reduce(g.contiguous().clone(), ctx.group)
        return (g.narrow(ctx.dim, ctx.index * ctx.size, ctx.size),
                None, None, None, None)


def reduce_sum(t: torch.Tensor, group) -> torch.Tensor:
    """A new tensor, the sum of ``t`` over ``group``; differentiable (the
    gradient passes to every rank's ``t`` unchanged)."""
    return _ReduceSum.apply(t, group)


def copy_to(t: torch.Tensor, group) -> torch.Tensor:
    """``t`` unchanged; its gradient is summed over ``group``."""
    return _CopyTo.apply(t, group)


def gather_cat(t: torch.Tensor, dim: int, index: int, n: int, group
               ) -> torch.Tensor:
    """The ``n`` ranks' parts of ``group`` concatenated along ``dim``,
    this rank's at ``index``; differentiable."""
    return _GatherCat.apply(t, dim, index, n, group)


def free_port() -> int:
    """A TCP port free on 127.0.0.1 now."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_main(fn, rank, n, port, backend, threads, args, results):
    """A spawned rank: join the group, run fn, report its result or its
    traceback, leave the group."""
    try:
        if threads is not None:
            torch.set_num_threads(threads)
        initialize_distributed(f"127.0.0.1:{port}", n, rank,
                               backend=backend or choose_backend(n))
        try:
            results.put((rank, True, fn(rank, n, *args)))
        finally:
            dist.destroy_process_group()
    except BaseException:  # reported to the parent, which raises
        results.put((rank, False, traceback.format_exc()))


def spawn(fn: Callable, n: int, args: Sequence[Any] = (),
          backend: Optional[str] = None, threads: Optional[int] = None,
          timeout_s: float = TIMEOUT_S) -> List[Any]:
    """Run ``fn(rank, n, *args)`` on ``n`` new processes (the ``spawn``
    start method) joined in one group on 127.0.0.1; returns their results
    by rank.  ``fn`` and its arguments and result are pickled, so ``fn``
    is a module-level function.  ``threads`` sets each rank's intra-op
    threads.  A rank that raises, dies or outlasts ``timeout_s`` makes this
    raise RuntimeError with what it reported; every process is ended
    before it returns."""
    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    port = free_port()
    procs = [ctx.Process(target=_rank_main,
                         args=(fn, r, n, port, backend, threads, args,
                               results), daemon=True) for r in range(n)]
    for p in procs:
        p.start()
    got, errors = {}, []
    try:
        # drained before any join: a child blocks on a full pipe until read
        while len(got) + len(errors) < n:
            try:
                rank, ok, value = results.get(timeout=timeout_s)
            except queue_mod.Empty:
                errors.append(f"no result within {timeout_s} s from ranks "
                              f"{sorted(set(range(n)) - set(got))}")
                break
            if ok:
                got[rank] = value
            else:
                errors.append(f"rank {rank}:\n{value}")
                break
    finally:
        for p in procs:
            p.join(timeout=30 if not errors else 5)
        for p in procs:
            if p.is_alive():
                p.terminate()
                p.join(timeout=10)
            if p.is_alive():
                p.kill()
                p.join()
    if errors:
        raise RuntimeError("a spawned rank failed: " + "\n".join(errors))
    bad = [r for r, p in enumerate(procs) if p.exitcode != 0]
    if bad:
        raise RuntimeError(f"ranks {bad} exited with codes "
                           f"{[procs[r].exitcode for r in bad]}")
    return [got[r] for r in range(n)]
