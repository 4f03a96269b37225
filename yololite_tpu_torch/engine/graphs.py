"""Compiled steps: each step captured once as a CUDA graph, then replayed.

The port's counterpart of `jax.jit` on the JAX package's inference functions
(yololite_tpu/engine/predictor.py:168-200 `_infer` and `_infer_device_preproc`,
yololite_tpu/engine/validator.py:51-86 `_infer`) and on its trainer's
`grad_step`, `apply_step` and `fused_step` (yololite_tpu/engine/trainer.py:
313-361): letterbox, forward and NMS of one call, or the forward, loss and
backward of a train step, are enqueued by one `cudaGraphLaunch` instead of
some six hundred (predict) or 2,660 (a train step) kernel launches from
Python. Plain `torch.cuda.CUDAGraph`, not `torch.compile`.

`GraphCache` holds captured graphs, one per key. For an inference step
(`GraphCache.__call__`, one tensor in and one out) the key is the input's
device, shape and dtype, the module the step runs, and the caller's own part
(imgsz, half, int8, augment, end2end, ensemble, the NMS settings). A train
step (`GraphCache.step`, several tensors in and out, or none) gives its own
key (engine/trainer.py `_step_key`: the kind of step, the batch's shape and
dtype, the GT bucket, amp, the momentum). A graph pays off only
for a key that repeats, so the first call of a key runs the step eagerly and
only remembers the key; its second call captures the step into the
process's one graph memory pool (`pool`) and replays it, and later calls
replay. A key that never repeats (a val bucket with one batch, a frame
size seen once, a warmup iteration's momentum) costs nothing over the eager
call. The capture does not go through `torch.cuda.graph`, whose entry
synchronizes the whole card and empties the caching allocator's cache, so
that the eager steps after it allocate anew. Each cache holds at most
`MAX_GRAPHS` graphs (or the bound it is given) and forgets the least
recently replayed first, so a stream of ever new frame sizes holds a bounded
pool. A replay copies the inputs into the graph's static inputs and clones
the static outputs before it returns them, since a caller
(`InferencePipeline`, the mesh's gather, the trainer's running loss) may
hold them past the next replay. Whatever else a step reads or writes
(weights, gradients, optimizer state, the EMA, BN statistics, the step's
lr and decay scalars) it reaches through its closure, and must be allocated
outside any capture: a tensor made during a capture lives in the pool, where
another graph's capture may place its own intermediates (`in_pool` finds
such tensors; the trainer checks its own after each capture). A CPU tensor,
or a call inside `eager()`, runs the step directly and caches nothing. On
the card a failed capture raises; there is no quiet eager fallback.

All graphs share the pool, so a later capture may place its static output in
blocks that an earlier graph uses for its intermediates: graphs of the pool
must never run concurrently, and an output must be cloned before another
graph runs. Every capture and every replay-and-clone of the process holds
one lock, and each replay's stream waits for the previous replay's clone on
its device (an event), so callers on other threads or streams are ordered
too.

Hazards, each met here or by the callers named:
1. Build and set-up before capture. The first, eager call of a key runs,
   outside any capture, the first nvcc build (`cuda_build.load`), K1's and
   K4's `cudaFuncSetAttribute`, K8's requant tables
   (`ops.kernels._requant_table` refuses to build inside a capture), the
   letterbox's interpolation matrices (`ops.kernels._interp_on`, an H2D
   copy) and cuDNN's algorithm choice for that shape. cuDNN's and cuBLAS's
   handles, though, are per thread, and the key's first call may have run
   on another thread than its capture (`InferencePipeline` warms up on the
   caller's thread and steps on its dispatch thread; a capture there failed
   in cuDNN with CUDNN_STATUS_INTERNAL_ERROR_DEVICE_ALLOCATION_FAILED on the
   card). So a capture on another thread than the first call's first runs
   the step once eagerly on a side stream (`warmups` counts these; their
   launches are counted). A train step changes the weights, so it must be
   seen first and captured on one thread, the training loop's: it is never
   warmed up. K1, K4 and K8 launch on
   `torch.cuda.current_stream()`, which during the capture is the capture
   stream.
2. Launch counters. The `.launches` counters of `ops.kernels.COUNTED` (the
   loss tail's K5-K7 and their backwards included, and K3's counts by
   route, `select_decode.by_route`) are Python-side: the
   capture advances them though it launches nothing, and a replay runs no
   Python. So the capture's advance is taken back and added
   again at every replay.
3. Weights replaced after warm-up. `Predictor.warmup` runs before
   `_maybe_quantize` swaps the net for its int8 copy, and `setup_model` and
   `replicate_tree` make new modules. The key holds the module it ran (so
   its id is never reused while the graph lives), and the predictor clears
   its cache whenever it replaces its net.
4. Shapes. One graph per input shape: the predictor pads every batch to its
   batch size, but takes raw frames of any size on its uint8 path; val's
   rect buckets and its tail batch each get their own. `MAX_GRAPHS` bounds
   what a cache holds.
5. Numerics. The step is captured inside the caller's `fp32_convs` (TF32 off)
   and replayed under it, so a graph replays exactly the kernels the eager
   call ran, and a graphed call equals the eager call bit for bit (a train
   step in deterministic mode: eager runs of it differ where cuDNN or an
   atomic sum picks its order at run time).
6. Host syncs. A captured step may not wait for the card: no `.item()`, no
   pageable host-to-device copy, no shape that depends on the data. A train
   step's scalars (lr, momentum, the EMA decay) are device tensors written
   before the replay; the optimizer's step advances on the device.
"""

from __future__ import annotations

import contextlib
import gc
import threading
from collections import OrderedDict
from typing import Callable, Dict, Hashable, List, Sequence

import torch

from yololite_tpu_torch.ops.kernels import COUNTED, SELECT_ROUTES, select_decode

# (object, attribute) of each Python-side counter that a replay must advance as the capture did (hazard 2)
COUNTERS = tuple((w, "launches") for w in COUNTED) + tuple((select_decode.by_route, r) for r in SELECT_ROUTES)

MAX_GRAPHS = 8  # graphs one cache holds; the least recently replayed goes first
MAX_SEEN = 64  # keys seen once that one cache remembers

_pool = None  # the one graph memory pool of the process
_anchors: Dict[str, tuple] = {}  # device -> a graph (and its tensor) that holds the device's share of the pool
_eager = 0  # > 0 inside eager()
_lock = threading.Lock()  # held by every capture and every replay-and-clone: the graphs share one pool
_done: Dict[str, "torch.cuda.Event"] = {}  # device -> recorded after the last replay's output was cloned
_streams: Dict[str, "torch.cuda.Stream"] = {}  # device -> the stream every capture there runs on


def pool(device: torch.device):
    """The graph memory pool every GraphCache of this process captures into (`torch.cuda.graph_pool_handle()`).

    The caching allocator counts the graphs that use a pool on each device and
    retires the pool when the last of them is destroyed; a later capture into
    the same handle then fails an internal assertion (`use_count > 0`). So the
    first use on a device captures a one-element anchor graph into the pool
    and keeps it for the life of the process: caches may come and go.
    """
    global _pool
    if _pool is None:
        _pool = torch.cuda.graph_pool_handle()
    if str(device) not in _anchors:
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, pool=_pool, capture_error_mode="thread_local"):
            anchor = torch.zeros(1, device=device)
        _anchors[str(device)] = (graph, anchor)
    return _pool


def _pool_segments() -> List[dict]:
    """The graph pool's segments in the caching allocator's snapshot (none before its first use)."""
    if _pool is None:
        return []
    return [seg for seg in torch.cuda.memory_snapshot() if tuple(seg.get("segment_pool_id", ())) == tuple(_pool)]


def in_pool(tensors: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """The tensors of `tensors` whose memory lies in the graph pool: made during a capture, so another graph's
    capture may reuse it while they still hold state."""
    spans = [(seg["address"], seg["address"] + seg["total_size"]) for seg in _pool_segments()]
    return [t for t in tensors if t.is_cuda and any(a <= t.data_ptr() < b for a, b in spans)]


def pool_reserved_bytes() -> int:
    """Bytes the card has reserved for the graph pool (its segments in the caching allocator's snapshot)."""
    return sum(seg["total_size"] for seg in _pool_segments())


def pool_allocated_bytes() -> int:
    """Bytes of the graph pool held by live blocks: the static outputs of the graphs alive (the rest of the
    reserved bytes are free blocks that the next capture may reuse)."""
    return sum(seg["allocated_size"] for seg in _pool_segments())


@contextlib.contextmanager
def eager():
    """Within the block every GraphCache runs its step directly: the eager call, to hold a graphed call against."""
    global _eager
    _eager += 1
    try:
        yield
    finally:
        _eager -= 1


class _Graph:
    __slots__ = ("graph", "static_in", "static_out", "launches", "module")

    def __init__(self, graph, static_in, static_out, launches, module):
        self.graph, self.static_in, self.static_out = graph, static_in, static_out
        self.launches = launches  # per counter of COUNTERS: its advance in one replay
        self.module = module  # held, so that the id in the key stays this module's


class GraphCache:
    """Captured CUDA graphs of steps, one per key (see the module's notes).

    `calls`, `replays`, `captures` and `warmups` count the calls on the
    card: a call that is no replay ran eagerly (a key's first sight).
    It holds at most `max_graphs` graphs.
    """

    def __init__(self, max_graphs: int = MAX_GRAPHS):
        self.max_graphs = max_graphs
        self._graphs: "OrderedDict[Hashable, _Graph]" = OrderedDict()
        self._seen: "OrderedDict[Hashable, int]" = OrderedDict()  # key -> the thread of its first call
        self.calls = self.replays = self.captures = self.warmups = 0

    def __len__(self) -> int:
        return len(self._graphs)

    def clear(self):
        """Drop every graph and every key seen (the caller's module changed)."""
        with _lock:
            self._graphs.clear()
            self._seen.clear()

    def key(self, x: torch.Tensor, module, extra: tuple = ()) -> tuple:
        return (str(x.device), id(module), tuple(x.shape), x.dtype, *extra)

    def __call__(self, fn: Callable[[torch.Tensor], torch.Tensor], x: torch.Tensor, module,
                 extra: tuple = ()) -> torch.Tensor:
        """fn(x) -> a tensor: eagerly at the key's first call, then replayed from its graph, captured at the second."""
        if x.device.type != "cuda" or _eager:
            return fn(x)
        return self.step(fn, (x,), self.key(x, module, extra), x.device, module)

    def step(self, fn: Callable, inputs: Sequence[torch.Tensor], key: Hashable, device: torch.device, holds=None):
        """fn(*inputs) -> None, a tensor or a tuple of tensors, run on `device`: eagerly at the key's first call (and
        off the card, or inside `eager()`), then replayed from its graph, captured at the second. The outputs of a
        replay are clones. `holds` is kept alive with the graph (the module whose id the key holds)."""
        if device.type != "cuda" or _eager:
            return fn(*inputs)
        with _lock, torch.cuda.device(device):
            self.calls += 1
            g = self._lookup(key, lambda warm: _capture(fn, tuple(inputs), device, holds, warm))
            if g is not None:
                self.replays += 1
                return _replay(g, inputs, device)
        return fn(*inputs)  # the key's first sight: eagerly, outside the lock

    def _lookup(self, key, capture: Callable[[bool], "_Graph"]):
        """The graph of `key`, made by `capture(warm)` at the key's second sight (`warm`: this thread did not run
        its first); None at its first (run it eagerly). The caller holds the lock."""
        g = self._graphs.get(key)
        if g is not None:
            self._graphs.move_to_end(key)
            return g
        thread = threading.get_ident()
        if key not in self._seen:
            self._seen[key] = thread
            if len(self._seen) > MAX_SEEN:
                self._seen.popitem(last=False)
            return None
        warm = self._seen.pop(key) != thread
        g = self._graphs[key] = capture(warm)
        self.captures += 1
        self.warmups += warm
        if len(self._graphs) > self.max_graphs:
            for done in _done.values():  # no replay may still read the static input of the graph dropped
                done.synchronize()
            self._graphs.popitem(last=False)
        return g


def _clone(out):
    return out.clone() if isinstance(out, torch.Tensor) else None if out is None else tuple(o.clone() for o in out)


def _replay(g: _Graph, inputs: Sequence[torch.Tensor], device: torch.device):
    """inputs through g's graph; the outputs cloned before any other graph of the pool can run. Under the lock."""
    key = str(device)
    stream = torch.cuda.current_stream(device)
    if key in _done:
        stream.wait_event(_done[key])
    for s, x in zip(g.static_in, inputs):
        s.copy_(x)
    g.graph.replay()
    out = _clone(g.static_out)
    done = torch.cuda.Event()
    done.record(stream)
    _done[key] = done
    for (obj, attr), n in zip(COUNTERS, g.launches):
        setattr(obj, attr, getattr(obj, attr) + n)
    return out


def _capture(fn, inputs: tuple, device: torch.device, module, warm: bool) -> _Graph:
    """fn's step on the inputs' shapes captured into the pool, after one eager run on a side stream if `warm`
    (hazard 1). Under the lock."""
    static_in = tuple(x.clone() for x in inputs)
    current = torch.cuda.current_stream(device)
    # one stream per device: the caching allocator hands a free block of the pool only to the stream it was
    # allocated on, so a new stream for each capture grew the pool to 9,564 MiB reserved after chip_smoke.py's
    # val phase, against 1,836 MiB on torch.cuda.graph's one capture stream (NVIDIA H100 80GB HBM3)
    if str(device) not in _streams:
        _streams[str(device)] = torch.cuda.Stream(device)
    side = _streams[str(device)]
    side.wait_stream(current)
    if warm:
        with torch.cuda.stream(side):
            fn(*static_in)
    side.synchronize()  # the capture begins on a stream with no work pending
    handle = pool(device)
    before = [getattr(obj, attr) for obj, attr in COUNTERS]
    graph = torch.cuda.CUDAGraph()
    # no garbage collection during the capture: collecting another cache's dropped graph destroys it
    # (cudaGraphDestroy), which a capture forbids; it invalidated a train step's capture on the card
    collecting = gc.isenabled()
    gc.disable()
    try:
        with torch.cuda.stream(side):
            graph.capture_begin(handle, capture_error_mode="thread_local")
            try:
                static_out = fn(*static_in)
            finally:
                graph.capture_end()
    finally:
        if collecting:
            gc.enable()
    current.wait_stream(side)
    if not (static_out is None or isinstance(static_out, torch.Tensor) or
            (isinstance(static_out, tuple) and all(isinstance(o, torch.Tensor) for o in static_out))):
        raise TypeError(f"a graphed step must return None, a tensor or a tuple of tensors, got "
                        f"{type(static_out).__name__}")
    recorded = tuple(getattr(obj, attr) - b for (obj, attr), b in zip(COUNTERS, before))
    for (obj, attr), b in zip(COUNTERS, before):  # hazard 2: the capture launched nothing
        setattr(obj, attr, b)
    return _Graph(graph, static_in, static_out, recorded, module)
