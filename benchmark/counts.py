"""Operation and byte counts that the per-layer metrics divide by: the bytes
of the pool-with-mask and unpool ops from their shapes, and the peak
rate of a configuration's precision on the card.

Pool bytes count each input byte read once and each output byte written
once, whatever a kernel reads again (``chip_smoke.py``'s phase-2
arithmetic). Of a full-resolution tensor of X elements (NHWC) and its
pooled quarter:

* pool with mask: x read (X), pooled (X/4) and mask (X) written;
* its gradient: x (X) and the pooled gradient (X/4) read, the input
  gradient (X) written;
* unpool through the mask: y (X/4) and the mask (X) read, the output (X)
  written;
* its gradient: the output gradient (X) and the mask (X) read, y's
  gradient (X/4) written.

So each of the four moves 2.25·X elements. Where a configuration runs the
pool kernels, its file lists the full-resolution tensors that a pass of
its net pools and unpools under ``pool_sites``, each by its stride from
the input image and its channels: ENet pools the initial block's output
(13 + in_channels channels at stride 2) and the first stage's (64 at
stride 4), and unpools at the same two shapes.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional, Sequence

from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry


def pool_bytes(passes: Sequence[int], height: int, width: int,
               sites: Sequence[Dict[str, int]], element_bytes: int) -> int:
    """Bytes of one iteration's pool and unpool ops and their gradients: one
    forward and one backward pass of the net over ``n`` images of
    ``height`` × ``width`` for each ``n`` of ``passes``, at each of the
    configuration's ``sites`` ({"stride", "channels"})."""
    per_image = sum((height // s["stride"]) * (width // s["stride"]) * s["channels"]
                    for s in sites)
    ops = 4          # pool, pool gradient, unpool, unpool gradient
    return int(sum(passes) * per_image * ops * 2.25 * element_bytes)


def peak(table: Dict[str, Dict[str, float]], device_name: str, precision: str) -> Optional[float]:
    """The dense peak of ``precision`` on the card, None for a card or a
    precision that the configuration's table does not hold."""
    return table.get(device_name, {}).get(precision)


class _FlopCount(TorchDispatchMode):
    """Counts the FLOPs of every operation that ``torch.utils.flop_counter``
    has a formula for (convolutions, their gradients, matrix products), as
    ``FlopCounterMode`` does without its module tracker, whose hooks refuse
    the ``torch.autograd.grad`` that FGSM and VAT call."""

    def __init__(self) -> None:
        super().__init__()
        self.total = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        formula = flop_registry.get(func._overloadpacket)
        if formula is not None:
            self.total += formula(*args, **kwargs, out_val=out)
        return out


def count_flops(fn: Callable[[], object]) -> float:
    """FLOPs of the operations ``fn`` runs."""
    with _FlopCount() as counter:
        fn()
    return float(counter.total)
