"""Data parallelism over devices and ranks (port of yololite_tpu/parallel/mesh.py).

The JAX package shards a batch over a 1-D device mesh and lets XLA partition
one program. Here a mesh is the ordered list of devices on the data axis of
this process, plus the process group when the process is one rank of several:

- inference (predictor, validator) runs in one process: the fused weights get
  one replica per device (`replicate_tree`), a batch that divides is split by
  `shard_batch`, each shard runs on its replica on its own device (launches
  are asynchronous, so the cards overlap) and the outputs are gathered in
  order on the first device;
- training runs one rank per device (`launch`, over `torch.distributed`): each
  rank takes its slice of the same global batch, and the trainer's cross-rank
  BN, global loss normalization and summed gradients make the step the
  one-device step on the global batch.

A leading dimension that does not divide the data axis runs unsharded, on the
first device (or whole on every rank), as the JAX package's tail rule does.
"""

from __future__ import annotations

import os
import shutil
import sys
import tempfile
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Callable, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist


@dataclass
class Mesh:
    """The devices on the data axis of this process; `group` is set when the process is one rank of several."""

    devices: List[torch.device]
    axis: str = "data"
    group: Optional[Any] = field(default=None, repr=False)

    @property
    def size(self) -> int:
        """The data axis' length: this process' devices times the ranks."""
        return len(self.devices) * (dist.get_world_size(self.group) if self.group is not None else 1)

    @property
    def rank(self) -> int:
        return dist.get_rank(self.group) if self.group is not None else 0


def _visible_cards() -> List[torch.device]:
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())] if torch.cuda.is_available() else []


def make_mesh(n_devices: Optional[int] = None, axis: str = "data", devices: Optional[Sequence] = None,
              group=None) -> Mesh:
    """1-D mesh over the first n devices (default: every visible card; none visible raises)."""
    devs = [torch.device(d) for d in devices] if devices is not None else _visible_cards()
    if not devs:
        raise RuntimeError("make_mesh needs a CUDA card and none is visible; pass devices=['cpu', ...] for the CPU")
    if n_devices is not None:
        devs = devs[:n_devices]
    return Mesh(devs, axis, group)


def select_device(device="", batch: int = 0, newline: bool = False, verbose: bool = True) -> List[torch.device]:
    """Parse a reference-style device string into a list of torch devices.

    Accepts '', 'cpu', an index '0', a comma list '0,1,2,3' and 'cuda:'-prefixed
    forms (a list or tuple of devices is taken as it is). '' means every
    visible card, and raises when none is visible: 'cpu' is the only way to
    the CPU. An explicit list of more than one device must come with a batch
    that is a positive multiple of its length. Logs a device summary line.
    """
    from yololite_tpu_torch.utils import LOGGER

    s = f"YOLOLite-torch 🚀 Python-{sys.version.split()[0]} torch-{torch.__version__} "
    if isinstance(device, torch.device):
        device = str(device)
    if isinstance(device, (list, tuple)):
        devs = [torch.device(f"cuda:{d}" if str(d).isdigit() else str(d)) for d in device]
        explicit = True
    else:
        dev = str(device).lower()
        for remove in ("cuda:", "tpu:", "none", "(", ")", "[", "]", "'", " "):
            dev = dev.replace(remove, "")
        explicit = False
        if dev == "cpu":
            devs = [torch.device("cpu")]
        else:
            devs = _visible_cards()
            if not devs:
                raise RuntimeError(f"device={device!r} needs a CUDA card and none is visible; "
                                   "pass device='cpu' to run on the CPU")
            if dev and dev not in ("tpu", "cuda", "gpu"):
                explicit = True
                idx = [int(x) for x in dev.split(",") if x]
                if max(idx) >= len(devs):
                    raise ValueError(
                        f"Invalid 'device={device}' requested: only {len(devs)} device(s) visible. "
                        f"Use 'device=cpu' or valid indices, i.e. 'device=0' or 'device=0,1,2,3'."
                    )
                devs = [devs[i] for i in idx]
    n = len(devs)
    # the reference's multi-device batch rules, for an explicit list ('' is the whole mesh, which
    # inference handles at any batch)
    if n > 1 and explicit:
        if batch < 1:
            raise ValueError("batch<1 is not supported for multi-device training; specify a valid batch size.")
        if batch % n != 0:
            raise ValueError(
                f"'batch={batch}' must be a multiple of device count {n}. Try 'batch={batch // n * n}' or "
                f"'batch={batch // n * n + n}', the nearest batch sizes evenly divisible by {n}."
            )
    space = " " * (len(s) + 1)
    for i, d in enumerate(devs):
        kind = torch.cuda.get_device_name(d) if d.type == "cuda" else "cpu"
        s += f"{'' if i == 0 else space}{d.type.upper()}:{d.index or 0} ({kind})\n"
    if verbose:
        LOGGER.info(s if newline else s.rstrip())
    return devs


def resolve_devices(device) -> List[torch.device]:
    """An engine's `device` argument -> its devices.

    None or '' is every visible card when more than one is, else the one
    card; a comma string or a list names several; anything else is one
    device, resolved as `utils.select_device` does (a missing card raises).
    """
    from yololite_tpu_torch.utils import select_device as select_one

    if isinstance(device, (list, tuple)):
        return [select_one(f"cuda:{d}" if str(d).isdigit() else d) for d in device]
    if isinstance(device, str) and ("," in device or device.isdigit()):
        return [select_one(d) for d in select_device(device, verbose=False)]
    if device in (None, "") and torch.cuda.is_available() and torch.cuda.device_count() > 1:
        return _visible_cards()
    return [select_one(device)]


def batch_sharding(mesh: Optional[Mesh], n: int) -> Optional[List[Tuple[torch.device, slice]]]:
    """The (device, rows) each shard of a leading dimension n takes on this process, or None when n does
    not divide the data axis (the tail rule)."""
    size = mesh_size(mesh)
    if mesh is None or n % size:
        return None
    rows = n // size
    first = mesh.rank * len(mesh.devices)
    return [(d, slice((first + i) * rows, (first + i + 1) * rows)) for i, d in enumerate(mesh.devices)]


def replicated(mesh: Optional[Mesh]) -> List[torch.device]:
    """The devices that each hold a whole copy of a replicated tree on this process."""
    return list(mesh.devices) if mesh is not None else []


def _tree_map(fn: Callable, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def _tree_leaves(tree) -> list:
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _tree_leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _tree_leaves(v)]
    return [tree]


def _as_tensor(x) -> torch.Tensor:
    return x if isinstance(x, torch.Tensor) else torch.as_tensor(x)


def shard_batch(mesh: Optional[Mesh], tree) -> list:
    """Split a batch tree (tensors or arrays, leading dim = batch) over the mesh -> a list of per-device trees.

    Without a mesh, or when a leading dimension does not divide the data axis
    (the last loader batch, say), the result is the whole tree as one shard
    on the mesh's first device: the stragglers run unsharded. A rank gets
    only its own slice.
    """
    leaves = _tree_leaves(tree)
    if mesh is None:
        return [_tree_map(_as_tensor, tree)]
    plan = batch_sharding(mesh, _as_tensor(leaves[0]).shape[0]) if leaves else None
    if plan is None or any(_as_tensor(x).shape[0] != _as_tensor(leaves[0]).shape[0] for x in leaves):
        return [_tree_map(lambda x: _as_tensor(x).to(mesh.devices[0], non_blocking=True), tree)]
    return [_tree_map(lambda x: _as_tensor(x)[rows].to(d, non_blocking=True), tree) for d, rows in plan]


def replicate_tree(mesh: Optional[Mesh], tree) -> list:
    """One copy of a module (or tensor tree) per device of the mesh; a module's first copy is the module itself,
    moved to the first device. On ranks, every rank's tensors are first overwritten with rank 0's (broadcast)."""
    import copy

    if mesh is None:
        return [tree]
    if mesh.group is not None:
        tensors = list(tree.state_dict().values()) if isinstance(tree, torch.nn.Module) else _tree_leaves(tree)
        with torch.no_grad():
            for t in tensors:
                dist.broadcast(t, src=0, group=mesh.group)
    if isinstance(tree, torch.nn.Module):
        return [tree.to(mesh.devices[0])] + [copy.deepcopy(tree).to(d) for d in mesh.devices[1:]]
    return [_tree_map(lambda x: _as_tensor(x).to(d), tree) for d in mesh.devices]


def mesh_size(mesh: Optional[Mesh]) -> int:
    return 1 if mesh is None else mesh.size


# ---- ranks ----

def torchrun_env() -> bool:
    """This process was started by torchrun (RANK, WORLD_SIZE and LOCAL_RANK are set)."""
    return all(k in os.environ for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK"))


def _rank_main(rank: int, fn: Callable, devices: List[str], backend: str, init_file: str, args: tuple,
               ret_dir: str, threads: int):
    """One spawned rank: join the group through the file store, run fn, write its return value."""
    device = torch.device(devices[rank])
    if device.type == "cuda":
        torch.cuda.set_device(device)
    else:
        torch.set_num_threads(threads)  # the parent's budget, so CPU ranks do not oversubscribe the host
    dist.init_process_group(backend, init_method=f"file://{init_file}", rank=rank, world_size=len(devices))
    try:
        out = fn(rank, len(devices), device, *args)
    finally:
        dist.destroy_process_group()
    torch.save(out, Path(ret_dir) / f"rank{rank}.pt")


def launch(fn: Callable, devices: Sequence, backend: Optional[str] = None, init_file=None, args: tuple = ()) -> list:
    """Run fn(rank, world, device, *args) on one rank per device and return each rank's value, in rank order.

    The ranks are spawned with torch.multiprocessing and join one process
    group through a `file://` store at `init_file` (default: a fresh file
    in a temporary directory). Under torchrun (RANK, WORLD_SIZE and
    LOCAL_RANK set), this process is one rank already: it joins the group
    that the environment names, runs fn on devices[LOCAL_RANK % len(devices)]
    and returns [its value]. The backend defaults to NCCL for distinct cards and gloo
    otherwise (the CPU, or several ranks on one card). A rank that raises
    fails the whole launch.
    """
    devices = [str(d) for d in devices]
    if backend is None:
        cards = [torch.device(d) for d in devices]
        distinct = len({(d.type, d.index) for d in cards}) == len(cards)
        backend = "nccl" if distinct and all(d.type == "cuda" for d in cards) else "gloo"
    if torchrun_env():
        rank, world, local = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"]), int(os.environ["LOCAL_RANK"])
        device = torch.device(devices[local % len(devices)])
        if device.type == "cuda":
            torch.cuda.set_device(device)
        joined = not dist.is_initialized()
        if joined:
            dist.init_process_group(backend, init_method="env://", rank=rank, world_size=world)
        try:
            return [fn(rank, world, device, *args)]
        finally:
            if joined:
                dist.destroy_process_group()
    import torch.multiprocessing as mp

    work = Path(tempfile.mkdtemp(prefix="yololite_launch_"))
    try:
        store = str(Path(init_file).resolve()) if init_file is not None else str(work / "store")
        mp.spawn(_rank_main, args=(fn, devices, backend, store, tuple(args), str(work), torch.get_num_threads()),
                 nprocs=len(devices), join=True)
        return [torch.load(work / f"rank{r}.pt", weights_only=False) for r in range(len(devices))]
    finally:
        shutil.rmtree(work, ignore_errors=True)
