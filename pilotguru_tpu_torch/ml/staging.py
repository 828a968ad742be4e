"""The training loop's host-to-device staging (ml/training.py:
``train_models``): each batch's rows gathered on the host and sent to the
devices that hold the ensemble's blocks.

``open_staging`` chooses by the devices it is given. Where every block's
device is CUDA, ``PinnedStaging`` runs a pipeline: a worker thread gathers
the rows of the batches ahead into a ring of page-locked buffers, and each
batch's copies run on one copy stream a device, which the compute stream
waits for (``Staged.wait``) just before the step that reads the batch. The
host never waits for the compute stream; it waits only for the worker's
gather or for a buffer's earlier copies to finish before the buffer is
written again, and tallies each such wait. Elsewhere (the CPU)
``PageableStaging`` gathers on the calling thread with numpy and copies on
the compute stream.

Both send the same rows in the same order and the same dtypes, so a step
reads the same values either way. The caller plans the batches (index
arrays) in the order it will send them, then sends them one at a time; a
training batch comes with its per-net weights [N, B] and use mask [N],
a validation batch without.

Tallies (``utils.profiling.count``): ``train.h2d_bytes``, the bytes handed
to the devices (inputs and labels once a device, weights once, and under
``PinnedStaging`` the use mask once); under ``PinnedStaging`` also
``train.h2d_pinned_bytes``, the bytes copied from page-locked buffers on the
copy streams, and ``train.staging_waits``, the times the host waited for a
staged batch.
"""

from __future__ import annotations

import collections
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from pilotguru_tpu_torch.utils import profiling

# Page-locked buffers in the ring: the batch being sent and two gathered
# ahead of it.
RING_DEPTH = 3


class Staged(NamedTuple):
    """One batch on the devices: ``batch`` {device: (inputs {name: [B,
    ...]}, labels [B, L])}; for a training batch ``weights`` and ``masks``,
    one [hi - lo, B] float32 and one [hi - lo] bool tensor a block (None for
    a validation batch); ``events`` {device: the event after its copies},
    empty where the copies ran on the compute stream."""

    batch: Dict
    weights: Optional[List[torch.Tensor]]
    masks: Optional[List[torch.Tensor]]
    events: Dict

    def wait(self) -> None:
        """Each device's current (compute) stream waits for the batch's
        copies; the host does not."""
        for dev, event in self.events.items():
            torch.cuda.current_stream(dev).wait_event(event)


def _labels(dataset, label_name, idx) -> np.ndarray:
    """The labels of rows ``idx`` as float32 [B, L]."""
    labels = np.asarray(dataset[label_name][idx], np.float32)
    return labels[:, None] if labels.ndim == 1 else labels


class PageableStaging:
    """The batch gathered on the calling thread into pageable memory and
    copied on the compute stream: each copy from pageable memory waits for
    the stream to drain. Skipped batches are staged too."""

    stages_skipped = True

    def __init__(self, input_names: Sequence[str], label_name: str,
                 blocks: Sequence[Tuple[int, int, object]]):
        self.input_names, self.label_name, self.blocks = list(input_names), label_name, blocks
        self.devices = list(dict.fromkeys(dev for _, _, dev in blocks))
        self._planned = collections.deque()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def close(self) -> None:
        pass

    def plan(self, dataset: Dict[str, np.ndarray], batches: Sequence[np.ndarray]) -> None:
        """``batches`` (index arrays into ``dataset``) will be sent next, in
        order."""
        self._planned.extend((dataset, idx) for idx in batches)

    def send(self, weights: Optional[np.ndarray] = None,
             use_mask: Optional[np.ndarray] = None) -> Staged:
        """The next planned batch on every device (one copy a device), with
        ``weights`` [N, B] and ``use_mask`` [N] sliced by block. Frame images
        stay uint8 through the copy; the steps convert them on the device."""
        dataset, idx = self._planned.popleft()
        inputs = {name: torch.as_tensor(dataset[name][idx]) for name in self.input_names}
        labels = torch.as_tensor(_labels(dataset, self.label_name, idx))
        profiling.count("train.h2d_bytes", len(self.devices) * (
            labels.nbytes + sum(v.nbytes for v in inputs.values())))
        batch = {dev: ({k: v.to(dev, non_blocking=True) for k, v in inputs.items()},
                       labels.to(dev, non_blocking=True)) for dev in self.devices}
        if weights is None:
            return Staged(batch, None, None, {})
        profiling.count("train.h2d_bytes", weights.nbytes)
        return Staged(batch,
                      [torch.as_tensor(weights[lo:hi]).to(dev, non_blocking=True)
                       for lo, hi, dev in self.blocks],
                      [torch.as_tensor(use_mask[lo:hi], device=dev) for lo, hi, dev in self.blocks],
                      {})


def _pinned(shape, dtype) -> torch.Tensor:
    """An uninitialised page-locked host tensor, from PyTorch's caching
    pinned allocator (a later call reuses the blocks an earlier one freed)."""
    return torch.empty(shape, dtype=dtype, pin_memory=True)


class _Slot:
    """One page-locked buffer set of the ring: a [batch_size, ...] buffer an
    input and one for the labels, the weights [N * batch_size] and the use
    mask [N]; ``events``, each device's event after the copies last made
    from it."""

    def __init__(self, num_nets: int, batch_size: int):
        self.rows: Dict[str, torch.Tensor] = {}
        self.weights = _pinned((num_nets * batch_size,), torch.float32)
        self.mask = _pinned((num_nets,), torch.bool)
        self.events: List[torch.cuda.Event] = []

    def buffer(self, name: str, like: np.ndarray, batch_size: int) -> torch.Tensor:
        """The buffer for rows of ``like`` (made anew if the rows' shape or
        dtype changed)."""
        dtype = torch.from_numpy(np.empty(0, like.dtype)).dtype
        buf = self.rows.get(name)
        if buf is None or buf.shape[1:] != like.shape[1:] or buf.dtype != dtype:
            buf = self.rows[name] = _pinned((batch_size,) + like.shape[1:], dtype)
        return buf


def _gather(sources: Dict[str, np.ndarray], idx: np.ndarray,
            out: Dict[str, np.ndarray]) -> None:
    """The rows ``idx`` of each source into its buffer, on the worker
    thread: ``np.take`` runs on one core without the interpreter lock (with
    ``mode="clip"`` it writes ``out`` directly; the indices are the
    permutation's, in range)."""
    for name, src in sources.items():
        np.take(src, idx, axis=0, out=out[name], mode="clip")


class PinnedStaging:
    """The pipeline of the module docstring. Batches no net trains on are
    left out of the plan by the caller (``stages_skipped`` False)."""

    stages_skipped = False

    def __init__(self, input_names: Sequence[str], label_name: str,
                 blocks: Sequence[Tuple[int, int, object]], batch_size: int):
        self.input_names, self.label_name, self.blocks = list(input_names), label_name, blocks
        self.devices = list(dict.fromkeys(dev for _, _, dev in blocks))
        self.batch_size = batch_size
        self.streams = {dev: torch.cuda.Stream(device=dev) for dev in self.devices}
        num_nets = max(hi for _, hi, _ in blocks)
        self.slots = [_Slot(num_nets, batch_size) for _ in range(RING_DEPTH)]
        self._submitted = 0
        self._planned = collections.deque()  # (dataset, idx) not yet gathering
        self._gathering = collections.deque()  # (slot, idx, out, future), not yet sent
        self._sources: Dict[int, Dict[str, np.ndarray]] = {}
        self._pool = ThreadPoolExecutor(1, thread_name_prefix="batch-gather")

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def close(self) -> None:
        self._pool.shutdown(wait=True, cancel_futures=True)

    def _rows_of(self, dataset) -> Dict[str, np.ndarray]:
        """The dataset's inputs and its labels as float32 [n, L], made once
        a dataset."""
        key = id(dataset)
        if key not in self._sources:
            arrays = {name: np.asarray(dataset[name]) for name in self.input_names}
            arrays[self.label_name] = _labels(dataset, self.label_name, slice(None))
            self._sources[key] = arrays
        return self._sources[key]

    def plan(self, dataset: Dict[str, np.ndarray], batches: Sequence[np.ndarray]) -> None:
        """``batches`` (index arrays into ``dataset``) will be sent next, in
        order; their gathers start as buffers come free."""
        self._planned.extend((dataset, idx) for idx in batches)
        self._fill_ring()

    def _fill_ring(self) -> None:
        """Hands the worker the planned batches that a buffer is free for:
        one whose batch was sent in an earlier call, after that batch's
        copies have finished (a wait, tallied, if they have not)."""
        while self._planned and len(self._gathering) < RING_DEPTH:
            dataset, idx = self._planned.popleft()
            slot = self.slots[self._submitted % RING_DEPTH]
            self._submitted += 1
            if not all(event.query() for event in slot.events):
                profiling.count("train.staging_waits")
                for event in slot.events:
                    event.synchronize()
            sources = self._rows_of(dataset)
            rows = len(idx)
            out = {name: slot.buffer(name, src, self.batch_size)[:rows]
                   for name, src in sources.items()}
            future = self._pool.submit(_gather, sources, np.asarray(idx),
                                       {name: t.numpy() for name, t in out.items()})
            self._gathering.append((slot, idx, out, future))

    def send(self, weights: Optional[np.ndarray] = None,
             use_mask: Optional[np.ndarray] = None) -> Staged:
        """The next planned batch on every device, its copies queued on the
        devices' copy streams; with ``weights`` [N, B] and ``use_mask`` [N]
        sliced by block. Frame images stay uint8 through the copy."""
        self._fill_ring()
        slot, idx, out, future = self._gathering.popleft()
        if not future.done():
            profiling.count("train.staging_waits")
        future.result()
        host = {name: out[name] for name in self.input_names}
        labels = out[self.label_name]
        nbytes = len(self.devices) * (labels.nbytes + sum(v.nbytes for v in host.values()))
        dev_weights = dev_masks = None
        if weights is not None:
            host_weights = slot.weights[:weights.size].view(weights.shape)
            host_weights.copy_(torch.from_numpy(weights))
            slot.mask.copy_(torch.from_numpy(use_mask))
            nbytes += host_weights.nbytes + slot.mask.nbytes
            dev_weights, dev_masks = [None] * len(self.blocks), [None] * len(self.blocks)
        batch, events = {}, {}

        def to(dev, t):
            # A new tensor on the device (never the ring's buffer itself).
            return t.to(dev, non_blocking=True, copy=True)

        for dev in self.devices:
            compute = torch.cuda.current_stream(dev)
            with torch.cuda.stream(self.streams[dev]):
                inputs = {k: to(dev, v) for k, v in host.items()}
                batch[dev] = (inputs, to(dev, labels))
                sent = list(inputs.values()) + [batch[dev][1]]
                if dev_weights is not None:
                    for b, (lo, hi, block_dev) in enumerate(self.blocks):
                        if block_dev == dev:
                            dev_weights[b] = to(dev, host_weights[lo:hi])
                            dev_masks[b] = to(dev, slot.mask[lo:hi])
                            sent += [dev_weights[b], dev_masks[b]]
                events[dev] = torch.cuda.Event()
                events[dev].record()
            for t in sent:
                t.record_stream(compute)
        slot.events = list(events.values())
        profiling.count("train.h2d_bytes", nbytes)
        profiling.count("train.h2d_pinned_bytes", nbytes)
        return Staged(batch, dev_weights, dev_masks, events)


def open_staging(input_names: Sequence[str], label_name: str,
                 blocks: Sequence[Tuple[int, int, object]], batch_size: int):
    """``PinnedStaging`` where every block's device (``blocks``: (lo, hi,
    device)) is CUDA, else ``PageableStaging``."""
    if all(torch.device(dev).type == "cuda" for _, _, dev in blocks):
        return PinnedStaging(input_names, label_name, blocks, batch_size)
    return PageableStaging(input_names, label_name, blocks)
