"""Batched data loader and the prefetch onto the device: the port's copy of
flownet2_tpu/data/loader.py, with ``device_prefetch`` in PyTorch.

``DataLoader`` decodes samples on a thread pool (or a whole batch in one
call of the native decoders) and yields numpy batches; with
``process_count``/``process_index`` each rank reads a disjoint stripe of
every global batch.  ``device_prefetch`` moves them onto the device ahead of
the consumer: a background thread runs the loader, stages each batch into
one of a ring of reused pinned host buffers and copies it to the device
without blocking on a side stream, so that neither decoding, staging nor a
pinned allocation runs on the thread that enqueues the steps.
"""

from __future__ import annotations

import collections
import concurrent.futures as cf
import contextlib
import queue
import threading
from typing import Iterable, Iterator, Optional

import numpy as np
import torch

from ..utils.device import resolve_device

# n_valid: the number of real samples in the *global* batch.  The tail batch
# of a drop_last=False loader is padded back to full size by wrapping around
# to the start of the index, so shapes stay static; consumers mask by
# position.
Batch = collections.namedtuple("Batch", ["images", "flow", "n_valid"])
Batch.__new__.__defaults__ = (None,)


class DataLoader:
    def __init__(self, dataset, batch_size: int, shuffle: bool = False,
                 drop_last: bool = True, num_workers: int = 4, seed: int = 0,
                 process_count: int = 1, process_index: int = 0,
                 use_native: bool = True):
        if batch_size % process_count:
            raise ValueError(
                f"batch_size {batch_size} must divide over {process_count} "
                "ranks")
        self.dataset = dataset
        self.global_batch = batch_size
        self.local_batch = batch_size // process_count
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.num_workers = max(1, num_workers)
        self.seed = seed
        self.process_count = process_count
        self.process_index = process_index
        self._epoch = 0
        self.use_native = use_native and self._native_ok()

    def _native_ok(self) -> bool:
        if not hasattr(self.dataset, "batch_plan"):
            return False
        from .. import native
        return native.available()

    def _native_batch(self, idxs: np.ndarray) -> Optional[Batch]:
        """Whole-batch decode and crop in one native call (its thread pool
        decodes every frame and flow in parallel, writing float32 straight
        into the batch buffers)."""
        from .. import native
        plan = self.dataset.batch_plan(idxs)
        if plan is None:
            return None
        th, tw = plan["crop"]
        imgs, flows_part = native.batch_load(
            plan["img_paths"], plan["img_offsets"],
            plan["flo_paths"], plan["flo_offsets"], th, tw,
            flip_flow_vertical=plan["flip_flow_vertical"],
            n_threads=self.num_workers)
        n = len(idxs)
        images = imgs.reshape(n, 2, th, tw, 3)
        if len(plan["flo_slots"]) == n:
            flow = flows_part
        else:
            flow = np.zeros((n, th, tw, 2), np.float32)
            if plan["flo_slots"]:
                flow[np.asarray(plan["flo_slots"])] = flows_part
        return Batch(images, flow)

    def __len__(self):
        n = len(self.dataset) // self.global_batch
        if not self.drop_last and len(self.dataset) % self.global_batch:
            n += 1
        return n

    def set_epoch(self, epoch: int) -> None:
        self._epoch = epoch
        if hasattr(self.dataset, "set_epoch"):
            self.dataset.set_epoch(epoch)  # the crop stream

    def _index_order(self) -> np.ndarray:
        order = np.arange(len(self.dataset))
        if self.shuffle:
            # the same permutation on every rank; ranks take disjoint stripes
            np.random.RandomState(self.seed + self._epoch).shuffle(order)
        return order

    def __iter__(self) -> Iterator[Batch]:
        order = self._index_order()
        n_batches = len(self)
        with cf.ThreadPoolExecutor(self.num_workers) as pool:
            for b in range(n_batches):
                start = b * self.global_batch
                idxs = order[start:start + self.global_batch]
                n_valid = len(idxs)
                if n_valid < self.global_batch:
                    if self.drop_last:
                        return
                    # pad to full size; consumers mask positions >= n_valid
                    idxs = np.concatenate(
                        [idxs, order[:self.global_batch - n_valid]])
                # this rank's stripe of the global batch
                lo = self.process_index * self.local_batch
                local = idxs[lo:lo + self.local_batch]
                if self.use_native:
                    batch = self._native_batch(local)
                    if batch is not None:
                        yield batch._replace(n_valid=n_valid)
                        continue
                samples = list(pool.map(self.dataset.__getitem__, local))
                images = np.stack([s[0] for s in samples])  # (B, 2, H, W, 3)
                flow = np.stack([s[1] for s in samples])    # (B, H, W, 2)
                yield Batch(images, flow, n_valid)


def _indexed(dev: torch.device) -> torch.device:
    """``dev`` with its index: a CUDA device named without one is the
    calling thread's current device (the rank's, once it is set), which
    the background thread must not read as its own."""
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return dev


class _Failure:
    """An exception of the background thread, handed to the consumer."""

    def __init__(self, error: Exception):
        self.error = error


_END = object()


class _PinnedRing:
    """``slots`` pairs of pinned host buffers for (images, flow), reused in
    turn.  Each slot keeps the event recorded after its last host-to-device
    copy, and is refilled only once that event has completed."""

    def __init__(self, slots: int):
        self.buffers: list = [None] * slots
        self.events: list = [None] * slots
        self.next = 0

    def stage(self, batch: Batch, device: torch.device,
              stream: "torch.cuda.Stream"):
        """Copy ``batch`` into the next slot and, on ``stream``, from there
        onto ``device``; returns the device batch and the copy's event."""
        k = self.next
        self.next = (k + 1) % len(self.buffers)
        sources = [np.asarray(x) for x in (batch.images, batch.flow)]
        if self.events[k] is not None:
            self.events[k].synchronize()  # its last copy has finished
        pinned = self.buffers[k]
        if pinned is None or any(
                tuple(p.shape) != s.shape or p.numpy().dtype != s.dtype
                for p, s in zip(pinned, sources)):
            pinned = self.buffers[k] = [
                torch.empty_like(torch.from_numpy(s), pin_memory=True)
                for s in sources]
        # numpy's copy: one thread (torch's copy_ takes its intra-op threads
        # from the cores that the host-bound step's thread runs on)
        for p, s in zip(pinned, sources):
            np.copyto(p.numpy(), s)
        with torch.cuda.stream(stream):
            on_device = [p.to(device, non_blocking=True) for p in pinned]
            event = torch.cuda.Event()
            event.record(stream)
        self.events[k] = event
        return Batch(*on_device, batch.n_valid), event


def device_prefetch(iterator: Iterable[Batch], size: int = 2,
                    device=None) -> Iterator[Batch]:
    """Yield the batches of ``iterator`` as tensors on ``device`` (None:
    the current CUDA device, which raises without one; in a data-parallel
    run, the rank's device), up to ``size`` batches ahead of the consumer.

    A background thread runs ``iterator`` (the decoding), stages each batch
    into a ring of ``size + 1`` reused pinned buffers and copies it to the
    card on a side stream without blocking; an event guards each buffer, so
    that none is refilled before its copy has finished.  The consumer's
    stream waits on each batch's copy, and its tensors are recorded on that
    stream.  On the CPU the batches are the loader's arrays as tensors.  An
    exception of the loader is raised in the consumer.
    """
    if size < 1:
        raise ValueError(f"size must be at least 1, got {size}")
    dev = _indexed(resolve_device(device))
    cuda = dev.type == "cuda"
    ready: queue.Queue = queue.Queue(maxsize=size)
    stop = threading.Event()

    def put(item) -> bool:
        while not stop.is_set():
            try:
                ready.put(item, timeout=0.05)
                return True
            except queue.Full:
                pass
        return False

    def produce():
        it = iter(iterator)
        try:
            # a new thread's current device is the first one: make the
            # batches' device current, so that the side stream, its events
            # and the pinned buffers belong to it
            with (torch.cuda.device(dev) if cuda
                  else contextlib.nullcontext()):
                stream = torch.cuda.Stream(dev) if cuda else None
                ring = _PinnedRing(size + 1) if cuda else None
                for batch in it:
                    if cuda:
                        item = ring.stage(batch, dev, stream)
                    else:
                        item = (Batch(torch.as_tensor(batch.images),
                                      torch.as_tensor(batch.flow),
                                      batch.n_valid), None)
                    if not put(item):
                        return
        except Exception as e:  # handed to the consumer, which raises it
            put(_Failure(e))
            return
        finally:
            close = getattr(it, "close", None)
            if close is not None:
                close()
        put(_END)

    worker = threading.Thread(target=produce, name="device_prefetch",
                              daemon=True)
    worker.start()
    try:
        while True:
            item = ready.get()
            if item is _END:
                return
            if isinstance(item, _Failure):
                raise item.error
            batch, event = item
            if event is not None:
                consumer = torch.cuda.current_stream(dev)
                consumer.wait_event(event)
                batch.images.record_stream(consumer)
                batch.flow.record_stream(consumer)
            yield batch
    finally:
        stop.set()
        worker.join(timeout=60)


class DeviceLoader:
    """``loader`` as the Trainer iterates it: ``len`` and ``set_epoch`` are
    the loader's, and each ``iter`` (one an epoch) runs it through
    ``device_prefetch`` onto ``device`` (None: the CUDA device, which
    raises without one)."""

    def __init__(self, loader, size: int = 2, device=None):
        self.loader = loader
        self.size = size
        self.device = resolve_device(device)

    def __len__(self):
        return len(self.loader)

    def set_epoch(self, epoch: int) -> None:
        if hasattr(self.loader, "set_epoch"):
            self.loader.set_epoch(epoch)

    def __iter__(self) -> Iterator[Batch]:
        return device_prefetch(self.loader, self.size, self.device)
