"""Data parallelism over processes, one rank per device (counterpart of
latentsplat_tpu/parallel/mesh.py).

The JAX package jits the train step over a device mesh with the batch axis
sharded, and XLA inserts every reduction over that axis. Here each rank is
a process with its own device, its own rows of the global batch and its own
copy of the state, and the step makes each of those reductions itself
(`RankReduce`, through `training.step.make_train_step(reduce=...)`):

  * the generator's and the discriminator's gradients: a flat all-reduce in
    buckets, divided by the world size (the step takes its gradients with
    `torch.autograd.grad` and steps its own optimizers, so
    `DistributedDataParallel`, whose hooks fire on `.backward()`, does not
    apply);
  * the adaptive GAN weight's two probe gradients, averaged before the
    weight is taken, so that every rank weights its GAN term alike;
  * the NaN and spike guards and the discriminator's finite gate, decided
    on the global (mean) losses, so that every rank takes the same branch;
  * the PatchGAN's BatchNorm statistics, all-reduced differentiably over
    the global batch (`model.discriminator.patch_gan.BatchNormTrain`);
  * the logs: means averaged, `diag/max_*` maxima.

Within a collective every rank's result has the same bits, so parameters
that start equal stay equal. `make_mesh` joins the process group;
`spawn` starts one process per device and runs a function on each.
"""

from __future__ import annotations

import json
import os
import re
import socket
import tempfile
import time
import traceback
from dataclasses import dataclass
from datetime import timedelta
from pathlib import Path
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as torch_mp

from ..model.discriminator.patch_gan import set_batch_norm_group
from ..training.step import LocalReduce, make_train_step

BUCKET_BYTES = 25 << 20   # the gradient all-reduce's bucket
DEFAULT_TIMEOUT = timedelta(minutes=30)


@dataclass
class Mesh:
    """One rank of a data-parallel process group: this process's rank and
    device, the world size, and its place on its host (`local_rank` of
    `local_world_size`; hosts = world_size / local_world_size). `group` is
    None for a single process."""

    rank: int
    world_size: int
    device: torch.device
    group: Optional[dist.ProcessGroup] = None
    local_rank: int = 0
    local_world_size: int = 1

    @property
    def is_main(self) -> bool:
        return self.rank == 0

    @property
    def host(self) -> int:
        return self.rank // self.local_world_size

    @property
    def num_hosts(self) -> int:
        return self.world_size // self.local_world_size

    def barrier(self) -> None:
        """Hold this process until every rank arrives (the host too, under
        NCCL); a rank that waits longer than the group's timeout raises."""
        if self.group is not None:
            nccl = dist.get_backend(self.group) == "nccl"
            dist.barrier(group=self.group, device_ids=[self.device.index] if nccl else None)


def single_mesh(device) -> Mesh:
    """The mesh of one process on `device`."""
    return Mesh(0, 1, torch.device(device))


def check_devices(devices: Sequence[torch.device], backend: str) -> None:
    """Raise where `backend` cannot run one rank on each of `devices`: NCCL
    takes CUDA devices only, one rank per card."""
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"unknown process-group backend {backend!r} (nccl or gloo)")
    if backend != "nccl":
        return
    if any(d.type != "cuda" for d in devices):
        raise ValueError(f"the nccl backend takes CUDA devices only, not {[str(d) for d in devices]}")
    indices = [d.index if d.index is not None else 0 for d in devices]
    for index in set(indices):
        if indices.count(index) > 1:
            name = torch.cuda.get_device_name(index) if torch.cuda.is_available() else "a card"
            raise ValueError(
                f"{indices.count(index)} ranks on cuda:{index} ({name}): nccl takes one rank per card; "
                "pass backend='gloo' to run several ranks on one card"
            )


def make_mesh(
    devices: Sequence,
    rank: int = 0,
    backend: str = "nccl",
    init_method: Optional[str] = None,
    timeout: timedelta = DEFAULT_TIMEOUT,
    local_rank: Optional[int] = None,
    local_world_size: Optional[int] = None,
) -> Mesh:
    """Join the process group of len(devices) ranks as `rank`, on
    devices[rank] (the counterpart of `make_mesh` over jax.devices(), and,
    with `init_method` "env://", of jax.distributed.initialize). One device
    starts no group. A collective that waits longer than `timeout` raises."""
    devices = [torch.device(d) for d in devices]
    device = devices[rank]
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    local_rank = rank if local_rank is None else local_rank
    local_world_size = len(devices) if local_world_size is None else local_world_size
    first = rank - local_rank
    check_devices(devices[first : first + local_world_size], backend)   # this host's
    if len(devices) == 1:
        return Mesh(0, 1, device)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    else:
        # The host's ranks share its cores.
        torch.set_num_threads(max(1, torch.get_num_threads() // local_world_size))
    dist.init_process_group(backend, init_method=init_method, world_size=len(devices), rank=rank, timeout=timeout)
    return Mesh(rank, len(devices), device, dist.group.WORLD, local_rank, local_world_size)


def destroy_mesh(mesh: Mesh) -> None:
    if mesh.group is not None and dist.is_initialized():
        dist.destroy_process_group()


# -- the batch ---------------------------------------------------------------------


def batch_sharding(mesh: Mesh, global_batch_size: int) -> slice:
    """This rank's rows of a global batch: the leading axis split into
    world_size contiguous shards, rank r taking shard r."""
    if global_batch_size % mesh.world_size:
        raise ValueError(f"a global batch of {global_batch_size} does not split over {mesh.world_size} ranks")
    per_rank = global_batch_size // mesh.world_size
    return slice(mesh.rank * per_rank, (mesh.rank + 1) * per_rank)


def shard_batch(batch, mesh: Mesh):
    """This rank's rows of every array (numpy or tensor) and list of a
    nested dict whose leaves share their leading axis, tensors on the
    rank's device."""
    def leading(tree):
        if isinstance(tree, dict):
            return next(leading(v) for v in tree.values())
        return len(tree)

    rows = batch_sharding(mesh, leading(batch))

    def take(tree):
        if isinstance(tree, dict):
            return {k: take(v) for k, v in tree.items()}
        if isinstance(tree, list):
            return tree[rows]
        return torch.as_tensor(np.ascontiguousarray(tree[rows]) if isinstance(tree, np.ndarray) else tree[rows],
                               device=mesh.device)

    return take(batch)


# -- collectives over flat buckets -------------------------------------------------


def _buckets(tensors: List[torch.Tensor]) -> List[List[int]]:
    """Indices of `tensors` in order, grouped into runs of one dtype of at
    most BUCKET_BYTES (a larger tensor is a bucket of its own)."""
    buckets, current, size = [], [], 0
    for i, t in enumerate(tensors):
        nbytes = t.numel() * t.element_size()
        if current and (size + nbytes > BUCKET_BYTES or tensors[current[0]].dtype != t.dtype):
            buckets.append(current)
            current, size = [], 0
        current.append(i)
        size += nbytes
    if current:
        buckets.append(current)
    return buckets


def _flat_collective(tensors: List[torch.Tensor], collective: Callable) -> List[torch.Tensor]:
    """Run `collective(flat) -> work` on each bucket's flat copy, all
    started before the first wait; returns the flat copies' pieces, shaped
    like `tensors`."""
    pending = []
    for bucket in _buckets(tensors):
        flat = torch.cat([tensors[i].reshape(-1) for i in bucket])
        pending.append((bucket, flat, collective(flat)))
    out: List[Optional[torch.Tensor]] = [None] * len(tensors)
    for bucket, flat, work in pending:
        work.wait()
        offset = 0
        for i in bucket:
            n = tensors[i].numel()
            out[i] = flat[offset : offset + n].view_as(tensors[i])
            offset += n
    return out


def all_reduce_mean(tensors: Dict[str, torch.Tensor], mesh: Mesh) -> Dict[str, torch.Tensor]:
    """The mean over ranks of each tensor: flat buckets all-reduced (sum),
    then divided by the world size."""
    names = list(tensors)
    summed = _flat_collective(
        [tensors[n] for n in names], lambda flat: dist.all_reduce(flat, group=mesh.group, async_op=True),
    )
    return {n: t.div_(mesh.world_size) for n, t in zip(names, summed)}


def broadcast_(tensors: List[torch.Tensor], mesh: Mesh) -> None:
    """Overwrite each tensor in place with rank 0's."""
    received = _flat_collective(tensors, lambda flat: dist.broadcast(flat, src=0, group=mesh.group, async_op=True))
    with torch.no_grad():
        for t, r in zip(tensors, received):
            t.copy_(r)


def fingerprint(tensors: List[torch.Tensor]) -> torch.Tensor:
    """One int64 per tensor from its bits: a position-weighted sum of its
    32-bit words (wrapping), equal on equal tensors."""
    out = []
    for t in tensors:
        words = t.detach().contiguous().reshape(-1).view(torch.uint8)
        words = torch.nn.functional.pad(words, (0, -words.numel() % 4)).view(torch.int32).to(torch.int64)
        weights = torch.arange(words.numel(), device=words.device) % 65521 + 1
        out.append((words * weights).sum())
    return torch.stack(out) if out else torch.zeros(0, dtype=torch.int64)


def assert_replicated(tensors: Dict[str, torch.Tensor], mesh: Mesh, what: str) -> None:
    """Raise, naming the first differing tensor, unless every rank holds the
    same bits in each of `tensors`."""
    if mesh.group is None:
        return
    names = list(tensors)
    prints = fingerprint([tensors[n] for n in names]).to(mesh.device)
    low, high = prints.clone(), prints.clone()
    dist.all_reduce(low, op=dist.ReduceOp.MIN, group=mesh.group)
    dist.all_reduce(high, op=dist.ReduceOp.MAX, group=mesh.group)
    differ = [n for n, a, b in zip(names, low.tolist(), high.tolist()) if a != b]
    if differ:
        raise AssertionError(f"{what}: {len(differ)} tensors differ across ranks, first {differ[0]}")


def state_tensors(state) -> Dict[str, torch.Tensor]:
    """Every tensor of a training.step.TrainState by a name: parameters and
    buffers of the three nets, both optimizers' counts and moments, the
    spike guard's EMA and skip count."""
    out = {}
    for prefix, module in (("generator", state.model), ("discriminator", state.discriminator), ("lpips", state.lpips)):
        if module is not None:
            out.update({f"{prefix}.{k}": v for k, v in module.state_dict(keep_vars=True).items()})
    for prefix, opt in (("opt_gen", state.opt_gen), ("opt_disc", state.opt_disc)):
        if opt is None:
            continue
        for label, group in opt.state.items():
            out[f"{prefix}.{label}.count"] = group["count"]
            for key in ("mu", "nu"):
                out.update({f"{prefix}.{label}.{key}.{n}": t for n, t in group[key].items()})
    for key in ("gen_loss_ema", "spike_skip_count"):
        if getattr(state, key) is not None:
            out[key] = getattr(state, key)
    return {k: v.data if isinstance(v, torch.nn.Parameter) else v for k, v in out.items()}


def replicate_state(state, mesh: Mesh) -> None:
    """Broadcast every tensor of `state` from rank 0 (after an init or a
    resume on each rank), then check that all ranks hold the same bits: the
    counterpart of placing the state with the JAX package's
    `replicate_sharding`."""
    if mesh.group is None:
        return
    tensors = state_tensors(state)
    broadcast_(list(tensors.values()), mesh)
    assert_replicated(tensors, mesh, "the state after its broadcast")


# -- the step ------------------------------------------------------------------------


class RankReduce(LocalReduce):
    """The train step's reductions over the global batch as collectives of
    `mesh`'s group (see the module docstring)."""

    def __init__(self, mesh: Mesh):
        self.mesh = mesh

    def mean(self, x: torch.Tensor) -> torch.Tensor:
        x = x.detach().clone()
        dist.all_reduce(x, group=self.mesh.group)
        return x.div_(self.mesh.world_size)

    def mean_grads(self, grads: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        return all_reduce_mean(grads, self.mesh)

    def logs(self, logs: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        out = dict(logs)
        for op, keys in (
            (dist.ReduceOp.SUM, [k for k in logs if not k.startswith("diag/max_")]),
            (dist.ReduceOp.MAX, [k for k in logs if k.startswith("diag/max_")]),
        ):
            if not keys:
                continue
            values = torch.stack([torch.as_tensor(logs[k]).detach().float().to(self.mesh.device) for k in keys])
            dist.all_reduce(values, op=op, group=self.mesh.group)
            if op == dist.ReduceOp.SUM:
                values = values / self.mesh.world_size
            out.update(zip(keys, values.unbind()))
        return out


def make_parallel_train_step(
    losses, mesh: Mesh, skip_loss_spike_factor: Optional[float] = None, skip_loss_spike_patience: int = 10,
):
    """`training.step.make_train_step` over `mesh`: train_step(state, batch,
    step, generator=None, noise=None, timer=None) on this rank's rows of the
    batch (and of the noise), with every reduction over the global batch
    made across ranks and the PatchGAN's BatchNorm synchronized."""
    train_step = make_train_step(
        losses, skip_loss_spike_factor, skip_loss_spike_patience,
        reduce=RankReduce(mesh) if mesh.group is not None else LocalReduce(),
    )

    def parallel_step(state, batch, step, generator=None, noise=None, timer=None):
        if state.discriminator is not None:
            set_batch_norm_group(state.discriminator, mesh.group)
        return train_step(state, batch, step, generator=generator, noise=noise, timer=timer)

    return parallel_step


# -- processes -----------------------------------------------------------------------


def free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


_COLLECTIVE_MESSAGES = re.compile(r"Connection (reset|closed) by peer|Read error")
_JOIN_GRACE_S = 2.0   # how long a failed run waits for the other ranks' error files


def _is_collective_error(exc: BaseException) -> bool:
    """True when `exc` was raised inside a torch.distributed call or a
    `Mesh` method, or is gloo's message for a peer that went away: the
    error a rank sees when another rank fails, not a cause of its own."""
    if isinstance(exc, RuntimeError) and _COLLECTIVE_MESSAGES.search(str(exc)):
        return True
    mesh_methods = {f.__code__ for f in vars(Mesh).values() if callable(f) and hasattr(f, "__code__")}
    distributed = os.path.dirname(dist.__file__) + os.sep
    return any(
        frame.f_code in mesh_methods or frame.f_code.co_filename.startswith(distributed)
        for frame, _ in traceback.walk_tb(exc.__traceback__)
    )


def _write_rank_error(out_dir, rank: int, exc: BaseException) -> None:
    """rank_{rank}.err: the rank's formatted traceback, the time.monotonic()
    at which it raised and whether it came from a collective (written whole,
    then renamed, so that a reader never sees a part of it)."""
    record = {
        "rank": rank, "time": time.monotonic(), "collective": _is_collective_error(exc),
        "traceback": "".join(traceback.format_exception(exc)),
    }
    path = Path(out_dir) / f"rank_{rank}.err"
    path.with_suffix(".tmp").write_text(json.dumps(record))
    path.with_suffix(".tmp").replace(path)


def read_rank_errors(out_dir) -> List[dict]:
    """The rank_*.err records in `out_dir`, earliest first."""
    records = [json.loads(p.read_text()) for p in Path(out_dir).glob("rank_*.err")]
    return sorted(records, key=lambda r: r["time"])


def first_cause(records: List[dict]) -> Optional[dict]:
    """The error a failed run reports: the earliest that is not a collective
    error (a rank's own cause), else the earliest of all; None without any."""
    own = [r for r in records if not r["collective"]]
    return min(own or records, key=lambda r: r["time"], default=None)


def _rank_entry(rank, fn, devices, backend, init_method, args, out_dir, timeout):
    mesh = make_mesh(devices, rank, backend, init_method, timeout)
    try:
        result = fn(mesh, *args)
        torch.save(result, Path(out_dir) / f"rank_{rank}.pt")
    except Exception as exc:
        # Written before the group is destroyed below, which is what fails
        # the other ranks' collectives.
        _write_rank_error(out_dir, rank, exc)
        raise
    finally:
        destroy_mesh(mesh)


def spawn(
    fn: Callable,
    devices: Sequence,
    backend: str,
    args: tuple = (),
    join_timeout: Optional[float] = None,
    timeout: timedelta = DEFAULT_TIMEOUT,
) -> list:
    """Run `fn(mesh, *args)` in one spawned process per device, rank r on
    devices[r], in a fresh process group on localhost; returns each rank's
    result (saved with torch.save). A rank that raises or dies fails the
    run, and the others are stopped; so does a run that outlasts
    `join_timeout` seconds, and a collective that waits longer than
    `timeout` raises in its rank. A failed run raises a
    ProcessRaisedException with the traceback of its cause (`first_cause`):
    the rank whose own code raised, not a rank whose collective lost its
    peer. `fn` must be importable by name."""
    devices = [torch.device(d) for d in devices]
    check_devices(devices, backend)
    init_method = f"tcp://localhost:{free_port()}"
    with tempfile.TemporaryDirectory(prefix="ranks-") as out_dir:
        context = torch_mp.start_processes(
            _rank_entry, args=(fn, devices, backend, init_method, args, out_dir, timeout),
            nprocs=len(devices), join=False, start_method="spawn",
        )
        deadline = None if join_timeout is None else time.monotonic() + join_timeout
        try:
            while not context.join(timeout=1.0, grace_period=_JOIN_GRACE_S):
                if deadline is not None and time.monotonic() > deadline:
                    raise TimeoutError(f"{len(devices)} ranks did not finish within {join_timeout} s")
        except (torch_mp.ProcessRaisedException, torch_mp.ProcessExitedException) as exc:
            cause = first_cause(read_rank_errors(out_dir))
            if cause is None or (cause["collective"] and isinstance(exc, torch_mp.ProcessExitedException)):
                raise   # no rank raised, or one died without raising and the others lost it
            raise torch_mp.ProcessRaisedException(
                f"\n\n-- Process {cause['rank']:d} terminated with the following error:\n{cause['traceback']}",
                cause["rank"], context.processes[cause["rank"]].pid,
            ) from None
        finally:
            for process in context.processes:
                if process.is_alive():
                    process.kill()
                    process.join()
        return [torch.load(Path(out_dir) / f"rank_{r}.pt", weights_only=False) for r in range(len(devices))]


def torchrun_env() -> Optional[Dict[str, int]]:
    """RANK, WORLD_SIZE, LOCAL_RANK and LOCAL_WORLD_SIZE as torchrun sets
    them, or None outside torchrun."""
    if "RANK" not in os.environ or "WORLD_SIZE" not in os.environ:
        return None
    world = int(os.environ["WORLD_SIZE"])
    return {
        "rank": int(os.environ["RANK"]),
        "world_size": world,
        "local_rank": int(os.environ.get("LOCAL_RANK", os.environ["RANK"])),
        "local_world_size": int(os.environ.get("LOCAL_WORLD_SIZE", world)),
    }
