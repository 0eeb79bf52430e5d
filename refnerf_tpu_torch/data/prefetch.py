"""The host-to-device batch pipeline (counterpart of
refnerf_tpu/data/prefetch.py:23-125, without a mesh).

The host samples batches (on the caller's thread, or on a background
thread with `ThreadedSampler`), and `device_prefetch` copies each to the
card `buffer_size` batches ahead: from pinned memory, with
`non_blocking=True`, on a side stream, so that the copy of batch N+1
overlaps the compute of batch N. When it hands a batch over,
the consumer's stream waits for the side stream, and each tensor is recorded
on the consumer's stream, so that the allocator does not hand its memory to
a later copy while that stream still reads it. Without either, the step
would read a batch that is still being copied, with no error.
"""

from __future__ import annotations

import queue
import threading

import torch

# Queue sentinel: the producer thread is done (source exhausted or errored).
_DONE = object()


def _check_device(device) -> torch.device:
  device = torch.device(device)
  if device.type == 'cuda' and not torch.cuda.is_available():
    raise RuntimeError(
        f'device {device} asked for, but no CUDA device is available; pass '
        "device='cpu' to keep the batches on the CPU")
  return device


def device_prefetch(iterator, device='cuda', buffer_size: int = 2):
  """Batches from `iterator` (each a `rays.Batch` of CPU tensors) moved to
  `device`, `buffer_size` ahead. Closing the generator closes the
  underlying iterator (stops a ThreadedSampler's thread)."""
  device = _check_device(device)
  return _prefetch(iterator, device, buffer_size)


def _prefetch(iterator, device, buffer_size):
  stream = (torch.cuda.Stream(device) if device.type == 'cuda' else None)

  def put(batch):
    if stream is None:
      return batch.map(lambda x: x.to(device))
    with torch.cuda.stream(stream):
      return batch.map(
          lambda x: x.pin_memory().to(device, non_blocking=True))

  def hand_over(batch):
    if stream is not None:
      compute = torch.cuda.current_stream(device)
      compute.wait_stream(stream)
      batch.map(lambda x: x.record_stream(compute) or x)
    return batch

  try:
    buf = []
    for batch in iterator:
      buf.append(put(batch))
      if len(buf) >= buffer_size:
        yield hand_over(buf.pop(0))
    while buf:
      yield hand_over(buf.pop(0))
  finally:
    close = getattr(iterator, 'close', None)
    if close is not None:
      close()


class ThreadedSampler:
  """Run a dataset's batch sampling on a background thread.

  A bounded queue of host batches; the consumer pops, copies to the card,
  and steps. The producer signals exhaustion AND errors through the queue: a
  dataset exception re-raises in the consumer (instead of the consumer
  deadlocking on a dead producer), and a finite source ends with
  StopIteration. close() stops the thread; device_prefetch calls it when
  the consumer generator is closed or garbage-collected.
  """

  def __init__(self, dataset, capacity: int = 3):
    self._dataset = dataset
    self._queue: queue.Queue = queue.Queue(capacity)
    self._stop = threading.Event()
    self._thread = threading.Thread(target=self._run, daemon=True)
    self._thread.start()

  def _put(self, item) -> bool:
    """Blocking put that aborts on close(); True if enqueued."""
    while not self._stop.is_set():
      try:
        self._queue.put(item, timeout=0.1)
        return True
      except queue.Full:
        continue
    return False

  def _run(self):
    while not self._stop.is_set():
      try:
        batch = next(self._dataset)
      except StopIteration:
        self._put(_DONE)
        return
      except BaseException as e:  # noqa: BLE001 - relayed to the consumer
        self._put((_DONE, e))
        return
      if not self._put(batch):
        return

  def __iter__(self):
    return self

  def __next__(self):
    if self._stop.is_set():
      raise StopIteration
    item = self._queue.get()
    if item is _DONE:
      self._stop.set()
      raise StopIteration
    if isinstance(item, tuple) and len(item) == 2 and item[0] is _DONE:
      self._stop.set()
      raise item[1]
    return item

  def close(self):
    self._stop.set()


def training_batches(dataset, device='cuda', threaded: bool = False,
                     buffer_size: int = 2):
  """The standard train input pipeline: the dataset's batches copied to
  `device` by `device_prefetch`, `buffer_size` ahead.

  By default the batches are sampled on the caller's thread: a sampler
  thread (`threaded=True`, as the JAX package runs it) holds the GIL while
  it samples, and the step's host code, which bounds a bf16 step, waits for
  it (0.6-3.5 ms a step more on an H100, never less, against 0.5-0.8 host
  ms a batch of sampling; PERF.md section 5). Raises at once, before any thread starts,
  when `device` is CUDA and there is no card. The returned generator owns
  the sampler thread, if any: `.close()` it (or let it be garbage-collected)
  to stop background sampling; exhausting it (finite sources) stops the
  thread automatically.
  """
  _check_device(device)
  source = ThreadedSampler(dataset) if threaded else dataset
  return device_prefetch(source, device, buffer_size)
