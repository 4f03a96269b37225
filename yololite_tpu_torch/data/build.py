"""Source dispatch, the host prefetcher and the feed to the device (port of yololite_tpu/data/build.py, predict
part, and of the asynchronous `jax.device_put` its callers feed the device with).

The JAX package's trainer, predictor and validator hand each batch to the
device with `jnp.asarray` or `jax.device_put`, which return before the
transfer ends: the runtime stages the batch and copies it on a transfer
stream of its own while the step in flight runs. `DeviceFeed` is the port's
counterpart. Its thread takes each host batch in order, has it written into
(or copies it into) a page-locked host buffer of a `PinnedRing`, and issues
the host-to-device copies on the card's one copy stream (`copy_stream`),
with an event after them. The consumer's stream waits on that event before
any kernel reads the batch, so batch i + 1's copy runs on a copy engine
while the card runs step i. A host buffer goes back to the ring only once
its copy's event has completed. On the CPU (`device="cpu"`) the same thread
and ring run with plain buffers and no streams; the "copy" is a clone.
"""

from __future__ import annotations

import contextlib
import queue
import threading
import time
from pathlib import Path
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from yololite_tpu_torch.data.loaders import (
    IMG_FORMATS,
    VID_FORMATS,
    LoadImagesAndVideos,
    LoadPilAndNumpy,
    LoadScreenshots,
    LoadStreams,
    LoadTensor,
    SourceTypes,
    autocast_list,
)


def check_source(source):
    """Classify a source -> (source, stream, screenshot, from_img, in_memory, tensor)."""
    webcam, screenshot, from_img, in_memory, tensor = False, False, False, False, False
    if isinstance(source, (str, int, Path)):
        s = str(source)
        is_file = s.rpartition(".")[-1].lower() in (IMG_FORMATS | VID_FORMATS)
        is_url = s.lower().startswith(("https://", "http://", "rtsp://", "rtmp://", "tcp://"))
        webcam = s.isnumeric() or s.endswith(".streams") or (is_url and not is_file)
        screenshot = s.lower().startswith("screen")
    elif isinstance(source, (list, tuple)):
        if not all(isinstance(x, (str, Path)) for x in source):
            source = autocast_list(source)
            from_img = True
    elif isinstance(source, np.ndarray):
        # a batched float array is a pre-normalized NHWC tensor source
        if source.ndim == 4 and np.issubdtype(source.dtype, np.floating):
            tensor = True
        elif source.ndim == 4:
            source = list(source)  # uint8 (B,H,W,3) batch -> list of HWC images
            from_img = True
        else:
            from_img = True
    elif type(source).__module__.startswith("torch"):  # a torch tensor: NHWC float, as a numpy float source
        source = source.detach().cpu().numpy()
        tensor = True
    else:  # PIL image or anything array-like
        from_img = True
    return source, webcam, screenshot, from_img, in_memory, tensor


def load_inference_source(source, batch: int = 1, vid_stride: int = 1, buffer: bool = False):
    """Build the right loader for the given source; attaches .source_type flags."""
    source, stream, screenshot, from_img, _, tensor = check_source(source)
    if tensor:
        dataset = LoadTensor(source)
    elif stream:
        dataset = LoadStreams(source, vid_stride=vid_stride, buffer=buffer)
    elif screenshot:
        dataset = LoadScreenshots(source)
    elif from_img:
        dataset = LoadPilAndNumpy(source)
    else:
        dataset = LoadImagesAndVideos(source, batch=batch, vid_stride=vid_stride)
    dataset.source_type = SourceTypes(stream=stream, screenshot=screenshot, from_img=from_img, tensor=tensor)
    return dataset


class Prefetcher:
    """Background-thread batch prefetcher (double buffering of the host feed).

    Items are made on one thread, in order, at most `depth` ahead of the
    consumer. An exception of the source surfaces in the consumer. Leaving
    the loop early (a `break`, a closed generator) stops the thread, closes
    the source's iterator on it and waits for it to end. `wait_s` is the
    consumer's time getting items (blocked on the queue, and `_take`).
    """

    _DONE = object()

    def __init__(self, iterable, depth: int = 2):
        self.iterable = iterable
        self.q: queue.Queue = queue.Queue(maxsize=depth)
        self.thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self.wait_s = 0.0

    def _produce(self):
        """The items to queue, made on the thread."""
        return iter(self.iterable)

    def _take(self, item):
        """The consumer's side of an item."""
        return item

    def _put(self, item) -> bool:
        """Queue an item; False, without queueing it, once the consumer has stopped."""
        while not self._stop.is_set():
            try:
                self.q.put(item, timeout=0.05)
                return True
            except queue.Full:
                pass
        return False

    def _work(self):
        items = self._produce()
        try:
            for item in items:
                if not self._put(item):
                    break
        except BaseException as e:  # surfaced in the consumer, not swallowed
            self._put(e)
        finally:
            close = getattr(items, "close", None)
            if close is not None:
                close()
            self._put(self._DONE)

    def __iter__(self):
        self._stop.clear()
        self.thread = threading.Thread(target=self._work, daemon=True)
        self.thread.start()
        try:
            while True:
                t0 = time.perf_counter()
                item = self.q.get()
                if item is self._DONE:
                    break
                if isinstance(item, BaseException):
                    raise item
                item = self._take(item)
                self.wait_s += time.perf_counter() - t0
                yield item
        finally:
            self.close()

    def close(self):
        """Stop the thread and wait for it to end; the items still queued are dropped."""
        self._stop.set()
        if self.thread is not None:
            self.thread.join()
            self.thread = None
        while not self.q.empty():
            self.q.get_nowait()


# ---- the feed to the device ----

RING_BYTES = 1 << 30  # a ring's host buffers, idle and in use, past which idle ones are dropped
_COPY_STREAMS: Dict[str, "torch.cuda.Stream"] = {}
_COPY_STREAMS_LOCK = threading.Lock()


def copy_stream(device) -> "torch.cuda.Stream":
    """The card's one host-to-device copy stream, made at its first use."""
    key = str(torch.device(device))
    with _COPY_STREAMS_LOCK:
        if key not in _COPY_STREAMS:
            _COPY_STREAMS[key] = torch.cuda.Stream(torch.device(device))
        return _COPY_STREAMS[key]


def size_class(nbytes: int) -> int:
    """A buffer's capacity for nbytes: rounded up to an eighth of its power of two, at least 64 KiB, so that
    batches of nearby shapes (val's rect buckets, multi-scale sizes, predict's frame sizes) share buffers."""
    n = max(int(nbytes), 1 << 16)
    step = 1 << ((n - 1).bit_length() - 4)
    return -(-n // step) * step


def _torch_dtype(dtype) -> torch.dtype:
    return torch.from_numpy(np.empty(0, dtype)).dtype


class HostBuffer:
    """One buffer of a `PinnedRing`: a uint8 tensor (page-locked for a card) and its bytes as numpy, viewed in each
    batch's shape. `event` is the copy out of it while one is in flight."""

    __slots__ = ("host", "array", "event")

    def __init__(self, host: torch.Tensor):
        self.host = host
        self.array = host.numpy()
        self.event = None

    @property
    def capacity(self) -> int:
        return self.host.numel()

    @property
    def address(self) -> int:
        return self.host.data_ptr()

    def view(self, shape, dtype) -> np.ndarray:
        """The buffer's first bytes as a writable C-contiguous array of `shape` and `dtype`."""
        dtype = np.dtype(dtype)
        n = int(np.prod(shape, dtype=np.int64)) * dtype.itemsize
        return self.array[:n].view(dtype).reshape(shape)

    def tensor(self, shape, dtype) -> torch.Tensor:
        """The same bytes as a view of the pinned tensor itself (never a `from_numpy` of a view of it)."""
        dtype = np.dtype(dtype)
        n = int(np.prod(shape, dtype=np.int64)) * dtype.itemsize
        return self.host[:n].view(_torch_dtype(dtype)).view(tuple(shape))


class PinnedRing:
    """Host staging buffers of a feed, page-locked where the feed copies to a card, reused across batches.

    Pinned allocation is slow, so a buffer is allocated once per size class
    (`size_class`) and viewed in each batch's shape. `take` hands out an
    idle buffer of the class; else, with `depth` buffers of the class in
    use and a copy out of one in flight, it waits for the oldest such copy
    to end; else it allocates one. It never waits for a buffer that a writer
    holds (a loader's batch in flight): only the feed's own progress frees
    those. `release(buffers, event)` returns buffers once `event` (their
    copy) has completed; None returns them at once. Idle buffers past
    `RING_BYTES` in all are dropped, other classes' first. The ring keeps its
    own events and never relies on the caching host allocator to guard a
    buffer's reuse. On a card, a buffer that cannot be pinned raises:
    nothing falls back to pageable memory.
    """

    def __init__(self, device, depth: int = 4):
        self.device = torch.device(device)
        self.pinned = self.device.type == "cuda"
        self.depth = depth
        self._idle: Dict[int, List[HostBuffer]] = {}
        self._used: Dict[int, List[HostBuffer]] = {}
        self._lock = threading.Lock()
        self.bytes = 0  # capacity held, idle and in use
        self.bytes_in_use = 0
        self.peak_in_use = 0  # the most buffers of one class in use at once
        self.allocations = 0

    def take(self, nbytes: int) -> HostBuffer:
        """A buffer of at least nbytes, marked in use."""
        cap = size_class(nbytes)
        while True:
            with self._lock:
                self._reap()
                used = self._used.setdefault(cap, [])
                idle = self._idle.get(cap)
                copying = [b.event for b in used if b.event is not None]
                if idle or len(used) < self.depth or not copying:
                    buf = idle.pop() if idle else self._allocate(cap)
                    used.append(buf)
                    self.bytes_in_use += cap
                    self.peak_in_use = max(self.peak_in_use, len(used))
                    return buf
            copying[0].synchronize()  # outside the lock: the oldest copy out of a buffer of this class

    def _allocate(self, cap: int) -> HostBuffer:
        """Under the lock: a new buffer, after dropping idle ones that would put the ring past RING_BYTES."""
        for c in sorted(self._idle, key=lambda c: c == cap):
            while self._idle[c] and self.bytes + cap > RING_BYTES:
                self._idle[c].pop()
                self.bytes -= c
        # under the ring's card: a loader's or a feed's thread starts on card 0
        with torch.cuda.device(self.device) if self.pinned else contextlib.nullcontext():
            host = torch.empty(cap, dtype=torch.uint8, pin_memory=self.pinned)
        if self.pinned and not host.is_pinned():
            raise RuntimeError(f"a host buffer of {cap} bytes was not page-locked")
        self.bytes += cap
        self.allocations += 1
        return HostBuffer(host)

    def _reap(self):
        """Under the lock: buffers whose copy has completed become idle."""
        for cap, used in self._used.items():
            for buf in [b for b in used if b.event is not None and b.event.query()]:
                self._return(cap, buf)

    def _return(self, cap: int, buf: HostBuffer):
        self._used[cap].remove(buf)
        buf.event = None
        self._idle.setdefault(cap, []).append(buf)
        self.bytes_in_use -= cap

    def release(self, buffers, event=None):
        """Give buffers back: idle once `event` has completed (at once for None)."""
        with self._lock:
            for buf in buffers:
                if event is None:
                    self._return(buf.capacity, buf)
                else:
                    buf.event = event

    def in_use(self) -> int:
        """Buffers held by a writer or with a copy out of them in flight."""
        with self._lock:
            self._reap()
            return sum(len(u) for u in self._used.values())


class Upload:
    """The upload of host arrays to one device through a `PinnedRing`: staged on a producer thread, handed over on
    the consumer's.

    `stage(arrays, held)` sends a dict of numpy arrays: an array that is a
    buffer of the ring already (a loader wrote the batch into it) is copied
    as it lies, any other is first copied into one on the host. The copies
    run on the card's copy stream, an event after them; `held` (the buffers
    the batch was built in) and the staging buffers go back to the ring once
    that event has completed. The device tensors are marked as used on
    `consumer`, the stream the consumer will read them on (when it is
    known), for the caching allocator. On the CPU each array is cloned
    instead. The consumer's `hand_over(staged)` makes its current stream
    wait for the copies (and marks the tensors on that stream if it is not
    `consumer`), then returns them.
    """

    def __init__(self, device, ring: Optional[PinnedRing] = None):
        self.device = torch.device(device)
        self.cuda = self.device.type == "cuda"
        self.ring = ring or PinnedRing(self.device)
        self.stream = copy_stream(self.device) if self.cuda else None
        self.consumer = None  # the stream the consumer reads the batches on, set by the consumer
        self.batches = 0
        self.bytes = 0  # sent to the device
        self.staged_bytes = 0  # copied into the ring on the host first
        self.handover_s = 0.0  # the consumer's host time handing batches over
        self.sizes = set()  # the byte sizes of the arrays sent

    def stage(self, arrays: Dict[str, np.ndarray], held=()):
        held = list(held)
        by_address = {b.address: b for b in held}
        buffers, host = list(held), {}
        for k, a in arrays.items():
            buf = by_address.get(a.__array_interface__["data"][0]) if a.flags.c_contiguous else None
            if buf is None:
                buf = self.ring.take(a.nbytes)
                buffers.append(buf)
                np.copyto(buf.view(a.shape, a.dtype), a)
                self.staged_bytes += a.nbytes
            host[k] = buf.tensor(a.shape, a.dtype)
            self.sizes.add(a.nbytes)
        nbytes = sum(a.nbytes for a in arrays.values())
        if self.cuda:
            end = torch.cuda.Event()
            with torch.cuda.device(self.device), torch.cuda.stream(self.stream):
                out = {k: torch.empty(h.shape, dtype=h.dtype, device=self.device) for k, h in host.items()}
                for k, h in host.items():
                    out[k].copy_(h, non_blocking=True)
                end.record(self.stream)
            if self.consumer is not None:
                for t in out.values():
                    t.record_stream(self.consumer)
        else:
            out, end = {k: h.clone() for k, h in host.items()}, None
        self.ring.release(buffers, end)
        self.batches += 1
        self.bytes += nbytes
        return out, end

    def hand_over(self, staged) -> Dict[str, torch.Tensor]:
        t0 = time.perf_counter()
        out, end = staged
        if end is not None:
            stream = torch.cuda.current_stream(self.device)
            stream.wait_event(end)
            if stream != self.consumer:
                for t in out.values():
                    t.record_stream(stream)
        self.handover_s += time.perf_counter() - t0
        return out


def _whole_batch(batch, take):
    """A loader batch's images are what the device needs; the batch itself goes along for the host's use (its "img"
    lies in a ring buffer, reused once copied: read its shape, not its pixels)."""
    return {"img": batch["img"]}, batch


class DeviceFeed(Prefetcher):
    """Host batches -> device tensors, the copy of one overlapping the step on the one before (depth 2).

    Iterating yields `(tensors, meta)` per item of `source`, in order:
    `prepare(item, take)` runs on the feed's one thread, in order, and
    returns the dict of numpy arrays to send and the `meta` to pass along
    (default: a loader batch's "img", and the batch). `take(shape, dtype)`
    gives it an array in a buffer of the ring to write into, so that no
    host copy follows. A source with an `iterate(alloc)` method (the
    `DataLoader`) is iterated with that `take`, so each item's pixel work
    writes its row straight into the buffer that is copied. Exceptions of
    the source or of `prepare` surface in the consumer. Leaving the loop
    early stops the thread, closes the source's iterator and returns every
    buffer taken through the feed to the ring. `upload` holds the counters
    (batches, bytes, the hand-over's host time).
    """

    def __init__(self, source, device, prepare: Optional[Callable] = None, ring: Optional[PinnedRing] = None):
        super().__init__(source, depth=2)
        self.upload = Upload(device, ring)
        self.prepare = prepare or _whole_batch
        self._held: Dict[int, HostBuffer] = {}  # taken through this feed and not yet sent
        self._held_lock = threading.Lock()

    def _alloc(self, shape, dtype) -> np.ndarray:
        dtype = np.dtype(dtype)
        buf = self.upload.ring.take(int(np.prod(shape, dtype=np.int64)) * dtype.itemsize)
        with self._held_lock:
            self._held[buf.address] = buf
        return buf.view(shape, dtype)

    def _claim(self, values) -> List[HostBuffer]:
        """The buffers of this feed that these arrays start, no longer held by the feed."""
        out = []
        with self._held_lock:
            for v in values:
                if isinstance(v, np.ndarray):
                    buf = self._held.pop(v.__array_interface__["data"][0], None)
                    if buf is not None:
                        out.append(buf)
        return out

    def _produce(self):
        src = self.iterable
        items = src.iterate(self._alloc) if hasattr(src, "iterate") else iter(src)
        try:
            for item in items:
                values = item.values() if isinstance(item, dict) else item if isinstance(item, (list, tuple)) else ()
                held = self._claim(values)
                arrays, meta = self.prepare(item, self._alloc)
                held += self._claim(arrays.values())
                yield self.upload.stage(arrays, held), meta
        finally:
            close = getattr(items, "close", None)
            if close is not None:
                close()
            with self._held_lock:  # the batches the loop left unsent: no writer is left once the source closed
                left, self._held = list(self._held.values()), {}
            self.upload.ring.release(left)

    def _take(self, item):
        staged, meta = item
        return self.upload.hand_over(staged), meta

    def __iter__(self):
        if self.upload.cuda:  # the consumer's stream, for the copies' record_stream on the feed's thread
            self.upload.consumer = torch.cuda.current_stream(self.upload.device)
        return super().__iter__()
