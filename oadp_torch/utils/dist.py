"""Processes of a run: rank, world size, process-group set-up and the
collectives of data-parallel training.

The reference initializes an NCCL process group at the top of every entry
point (``oadp/dp/train.py:61-63``, ``oadp/oake/base.py:122-126``).
:func:`maybe_initialize_distributed` does so when ``torchrun``'s environment
is set (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``): NCCL for
a run on the card, gloo on the CPU. ``oadp_tpu`` calls
``jax.distributed.initialize`` instead.

:func:`rank` and :func:`world_size` come from the process group when one is
initialised, else from ``RANK``/``WORLD_SIZE``, else a single process (0 of
1); the OAKE pipelines shard their image index space by them.

:func:`spawn_ranks` starts the ``n`` processes of such a run on this host
with ``torchrun``'s environment, as the dry run and the multi-process tests
do.

:class:`Collective` holds the sums that make a data-parallel step equal to
one step over the global batch, as ``oadp_tpu``'s one program over its mesh
is: differentiable sums and gathers (the batch-norm statistics, the loss
counts and the Gram matrix of the block distillation span every process),
and the average of the gradients (what ``DistributedDataParallel`` does).
"""

__all__ = ['rank', 'world_size', 'maybe_initialize_distributed', 'spawn_ranks', 'Collective']

import os
import socket
import subprocess
import sys

import torch
import torch.distributed as dist


def _initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def rank() -> int:
    if _initialized():
        return dist.get_rank()
    return int(os.environ.get('RANK', 0))


def world_size() -> int:
    if _initialized():
        return dist.get_world_size()
    return int(os.environ.get('WORLD_SIZE', 1))


def maybe_initialize_distributed(device: torch.device) -> bool:
    """Initialise the default process group from ``torchrun``'s environment
    when it names more than one process (NCCL for ``cuda``, gloo
    otherwise); a CUDA process takes the card ``LOCAL_RANK``. Returns
    whether a process group is initialised."""
    if _initialized():
        return True
    if int(os.environ.get('WORLD_SIZE', 1)) <= 1:
        return False
    if device.type == 'cuda':
        torch.cuda.set_device(int(os.environ.get('LOCAL_RANK', 0)))
    dist.init_process_group('nccl' if device.type == 'cuda' else 'gloo')
    return True


def spawn_ranks(n: int, argv: list[str], cwd, env: dict | None = None,
                timeout: float = 900) -> list[str]:
    """Run ``python argv`` as ``n`` processes of one run on this host
    (``torchrun``'s environment: ``MASTER_ADDR``/``MASTER_PORT`` on a free
    local port, ``WORLD_SIZE``, ``RANK`` and ``LOCAL_RANK``), with ``env``
    over this process's environment. Returns each rank's output (stdout and
    stderr); raises if any rank fails. Kills every rank still running when
    it returns or raises."""
    with socket.socket() as s:
        s.bind(('127.0.0.1', 0))
        port = s.getsockname()[1]
    base = dict(os.environ, MASTER_ADDR='127.0.0.1', MASTER_PORT=str(port),
                WORLD_SIZE=str(n), **(env or {}))
    procs = [subprocess.Popen([sys.executable, *argv], cwd=cwd,
                              env=dict(base, RANK=str(r), LOCAL_RANK=str(r)),
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(n)]
    try:
        outs = [p.communicate(timeout=timeout)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, out) in enumerate(zip(procs, outs)):
        if p.returncode != 0:
            raise RuntimeError(f'rank {r} of {n} failed (rc={p.returncode}):\n{out[-4000:]}')
    return outs


class Collective:
    """The collectives of one data-parallel run over ``world`` processes
    (the default process group); with one process each is the identity."""

    def __init__(self, world: int = 1) -> None:
        self.world = world

    @classmethod
    def of_run(cls) -> 'Collective':
        return cls(world_size() if _initialized() else 1)

    @property
    def all_sum(self):
        """:meth:`sum`, or None when there is nothing to sum over."""
        return self.sum if self.world > 1 else None

    def sum(self, t: torch.Tensor) -> torch.Tensor:
        """The sum of ``t`` over the processes; its gradient is the sum of
        the processes' gradients."""
        if self.world == 1:
            return t
        from torch.distributed.nn.functional import all_reduce
        return all_reduce(t)

    def gather(self, t: torch.Tensor) -> torch.Tensor:
        """Every process's ``t`` concatenated along dim 0 in rank order,
        differentiable. Each process writes its rows into its slot of a zero
        buffer and the buffers are summed, so only ``all_reduce`` is needed
        (gloo has no reduce-scatter for a gather's gradient)."""
        if self.world == 1:
            return t
        if t.dtype == torch.bool:
            return self.gather(t.to(torch.uint8)).bool()
        slots = [torch.zeros_like(t)] * self.world
        slots[rank()] = t
        return self.sum(torch.cat(slots))

    @torch.no_grad()
    def average(self, tensors: list[torch.Tensor]) -> None:
        """Average ``tensors`` (the gradients) over the processes in place,
        as one flat buffer."""
        if self.world == 1 or not tensors:
            return
        flat = torch.cat([t.reshape(-1) for t in tensors])
        dist.all_reduce(flat)
        flat /= self.world
        offset = 0
        for t in tensors:
            t.copy_(flat[offset:offset + t.numel()].view_as(t))
            offset += t.numel()
