"""Process-group bootstrap and the collectives of the sharded trainers
(counterpart of ``srhmm_tpu/parallel/distributed.py``).

JAX drives every device of a host from one process and lets GSPMD insert
the collectives.  The port follows PyTorch's idiom instead: one process per
rank, each holding its own copy of the model and its own slice of the batch
on its own device, launched by ``torchrun`` (or ``spawn`` below), with
explicit ``torch.distributed`` collectives.  Only ``all_reduce``,
``all_gather`` and ``broadcast`` are used: gloo's point-to-point calls on
CUDA tensors are not to be relied on.

The backend follows a static rule (``backend_for``):

* ``nccl`` when every local rank has a card of its own
  (``LOCAL_WORLD_SIZE <= torch.cuda.device_count()``);
* ``gloo`` when ranks share a card or run on the CPU.  Asking for ``nccl``
  when ranks share a card raises.

A rank's device is ``cuda:(LOCAL_RANK % device_count)``, or the CPU only
when the caller asks for it; no path falls back to the CPU when a card was
asked for.  gloo moves CUDA tensors through the host; the collectives below
do that copy explicitly, once per call.

Typical data-parallel training, one process per rank::

    from srhmm_tpu_torch.parallel import distributed, make_mesh
    distributed.initialize()                   # no-op in a single process
    mesh = make_mesh()                         # (data, model) = (world, 1)
    res = train_embedded(models.to(mesh.device), utts, transcripts, mesh=mesh)
    if distributed.is_coordinator():
        write_outputs(res)
"""

from __future__ import annotations

import os
import shutil
import tempfile
import time
from datetime import timedelta
from pathlib import Path

import torch
import torch.distributed as dist


def _env_int(name: str, default: int | None = None) -> int | None:
    v = os.environ.get(name)
    return default if v in (None, "") else int(v)


def world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def local_rank() -> int:
    return _env_int("LOCAL_RANK", rank())


def is_coordinator() -> bool:
    return rank() == 0


def backend_for(device_type: str, local_ranks: int) -> str:
    """The static backend rule: nccl when each of the `local_ranks`
    processes of this host has a card of its own, gloo when ranks share a
    card or run on the CPU."""
    if device_type == "cpu":
        return "gloo"
    return "nccl" if local_ranks <= torch.cuda.device_count() else "gloo"


def local_device(device: str = "cuda") -> torch.device:
    """This rank's device: cuda:(LOCAL_RANK % device_count), or the CPU
    when `device` is "cpu".  Raises when a card is asked for and torch sees
    none."""
    if device == "cpu":
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError("local_device: a CUDA device was asked for, but torch sees none")
    return torch.device("cuda", local_rank() % torch.cuda.device_count())


def initialize(
    backend: str | None = None,
    init_method: str | None = None,
    rank: int | None = None,
    world_size: int | None = None,
    device: str = "cuda",
    timeout_s: float | None = None,
) -> None:
    """Join the process group of this run.

    Reads torchrun's environment (RANK, WORLD_SIZE, LOCAL_RANK,
    LOCAL_WORLD_SIZE, MASTER_ADDR / MASTER_PORT through ``env://``) or
    takes the arguments.  A no-op in a single process (world size 1 and no
    init_method) and when the group is already initialized.  backend None
    applies ``backend_for``; "nccl" for ranks that share a card raises
    ValueError.  Any failure to initialize propagates: a swallowed error
    would leave a multi-rank run secretly single-process (the JAX package's
    bootstrap had exactly that fault)."""
    if dist.is_initialized():
        return
    world = world_size if world_size is not None else _env_int("WORLD_SIZE", 1)
    if world == 1 and init_method is None:
        return
    me = rank if rank is not None else _env_int("RANK")
    if me is None:
        raise ValueError("initialize: no rank (pass rank= or set RANK)")
    local = _env_int("LOCAL_WORLD_SIZE", world)
    rule = backend_for(device, local)
    if backend is None:
        backend = rule
    elif backend == "nccl" and rule != "nccl":
        raise ValueError(
            f"initialize: nccl needs a card per rank, but {local} local ranks share "
            f"{torch.cuda.device_count()} card(s) (device {device!r}); use gloo"
        )
    if backend == "nccl":
        torch.cuda.set_device(local_device(device))
    kw = {} if timeout_s is None else {"timeout": timedelta(seconds=timeout_s)}
    dist.init_process_group(
        backend=backend, init_method=init_method or "env://", rank=me, world_size=world, **kw
    )


def destroy() -> None:
    """Leave the process group, if this process joined one."""
    if dist.is_initialized():
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# collectives (group None: a one-rank axis, the identity)
# ---------------------------------------------------------------------------

_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}


def _through_host(t: torch.Tensor, group) -> bool:
    return t.is_cuda and dist.get_backend(group) == "gloo"


def all_reduce(t: torch.Tensor, group, op: str = "sum") -> torch.Tensor:
    """The reduction of `t` over `group` (a new tensor on t's device)."""
    if group is None:
        return t
    work = t.detach().to("cpu", copy=True) if _through_host(t, group) else t.detach().clone()
    dist.all_reduce(work, op=_OPS[op], group=group)
    return work.to(t.device)


def all_gather(t: torch.Tensor, group) -> torch.Tensor:
    """(n, *t.shape): every rank's `t` over `group`, in the group's rank
    order."""
    if group is None:
        return t[None]
    src = t.detach().to("cpu") if _through_host(t, group) else t.detach()
    src = src.contiguous()
    parts = [torch.empty_like(src) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, src, group=group)
    return torch.stack(parts).to(t.device)


def broadcast(t: torch.Tensor, src_index: int, group) -> torch.Tensor:
    """`t` of the group's member `src_index` (an index into the group)."""
    if group is None:
        return t
    work = t.detach().to("cpu", copy=True) if _through_host(t, group) else t.detach().clone()
    dist.broadcast(work, src=dist.get_global_rank(group, src_index), group=group)
    return work.to(t.device)


# ---------------------------------------------------------------------------
# spawning a group of ranks on one host
# ---------------------------------------------------------------------------


def _rank_main(fn, r: int, n: int, store: str, out: str, device: str, timeout_s, args) -> None:
    if device == "cpu":
        torch.set_num_threads(1)
    os.environ.update(LOCAL_RANK=str(r), LOCAL_WORLD_SIZE=str(n), RANK=str(r), WORLD_SIZE=str(n))
    initialize(init_method=f"file://{store}", rank=r, world_size=n, device=device, timeout_s=timeout_s)
    try:
        result = fn(r, *args)
        torch.save(result, Path(out) / f"rank{r}.pt")
    finally:
        destroy()


def spawn(fn, nprocs: int, args=(), device: str = "cpu", timeout_s: float = 180.0, workdir=None) -> list:
    """Run ``fn(rank, *args)`` on `nprocs` spawned ranks of one process
    group and return their results (torch.save-able), by rank.

    The ranks rendezvous through a file in `workdir` (a fresh temporary
    directory by default), so concurrent groups never share a port; on the
    CPU each rank runs one intra-op thread.  The group is killed when it
    outlives `timeout_s` (TimeoutError), and any rank that exits non-zero
    fails the call (RuntimeError): no rank failure is swallowed.  `fn` must
    be importable by name from a fresh interpreter (``spawn`` re-imports
    its module)."""
    import multiprocessing as mp
    from multiprocessing.connection import wait

    root = Path(tempfile.mkdtemp(prefix="ranks_", dir=workdir))
    store = root / "store"
    ctx = mp.get_context("spawn")
    env_before = os.environ.get("OMP_NUM_THREADS")
    if device == "cpu":
        os.environ["OMP_NUM_THREADS"] = "1"
    try:
        procs = [
            ctx.Process(target=_rank_main,
                        args=(fn, r, nprocs, str(store), str(root), device, timeout_s, tuple(args)))
            for r in range(nprocs)
        ]
        for p in procs:
            p.start()
    finally:
        if device == "cpu":
            if env_before is None:
                os.environ.pop("OMP_NUM_THREADS", None)
            else:
                os.environ["OMP_NUM_THREADS"] = env_before
    deadline = time.monotonic() + timeout_s
    try:
        pending = list(procs)
        # a rank that fails leaves the others blocked in their next
        # collective: stop waiting at the first non-zero exit
        while pending and all(p.exitcode in (None, 0) for p in procs):
            left = deadline - time.monotonic()
            if left <= 0:
                raise TimeoutError(f"spawn: {nprocs} ranks of {fn.__name__} outlived {timeout_s} s")
            wait([p.sentinel for p in pending], timeout=left)
            pending = [p for p in pending if p.exitcode is None]
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
            p.join()
    try:
        codes = [p.exitcode for p in procs]
        if any(c != 0 for c in codes):
            raise RuntimeError(f"spawn: ranks of {fn.__name__} exited {codes}")
        # files the ranks of this call wrote
        return [torch.load(root / f"rank{r}.pt", weights_only=False) for r in range(nprocs)]
    finally:
        shutil.rmtree(root, ignore_errors=True)
