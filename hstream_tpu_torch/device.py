"""Device resolution: the port runs on the card unless told otherwise.

`resolve(None)` is `cuda`. Only an explicit `"cpu"` (what the CPU tests
pass) selects the plain PyTorch versions of the kernels. Asking for the
card where there is none raises; nothing falls back to the CPU.
The kernels themselves are built on first CUDA use by
engine/kernels/build.py.
"""

from __future__ import annotations

import torch

from hstream_tpu_torch.common.errors import DeviceUnavailable


def resolve(device: str | torch.device | None = None) -> torch.device:
    """The torch device an entry point runs on (default: the card)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise DeviceUnavailable(
                "hstream_tpu_torch runs on a CUDA card and none is "
                "available; pass device='cpu' to run the plain PyTorch "
                "versions of the kernels")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}")
    return dev


def handoff(tensors) -> "torch.cuda.Event | None":
    """Mark the end of this thread's work on `tensors` for a consumer on
    another thread: an event recorded on the current stream of their
    card (None when none of them is on a card). The consumer passes it
    to `receive` before it reads them."""
    for t in tensors:
        if isinstance(t, torch.Tensor) and t.device.type == "cuda":
            mark = torch.cuda.Event()
            mark.record(torch.cuda.current_stream(t.device))
            return mark
    return None


def receive(mark, tensors) -> None:
    """The consumer's side of `handoff`: its current stream waits on the
    producer's event, and the caching allocator learns that the tensors
    are used on that stream (so it does not hand their memory out while
    the consumer's reads are queued)."""
    if mark is None:
        return
    waiting = set()
    for t in tensors:
        if isinstance(t, torch.Tensor) and t.device.type == "cuda":
            cur = torch.cuda.current_stream(t.device)
            if cur not in waiting:
                cur.wait_event(mark)
                waiting.add(cur)
            t.record_stream(cur)
