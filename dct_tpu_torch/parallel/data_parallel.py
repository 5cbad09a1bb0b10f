"""One rank's chunk of a data-parallel batch, and what the steps need to
make its share of the global step (dct_tpu's GSPMD data parallelism,
whose partitioned step equals the single-device one).

On a data-only mesh every rank runs the single-process step on its chunk
of the batch, with three changes that make the sum over ranks the
single-process step exactly, up to the order of reductions:

* BatchNorm normalises with the statistics of the **global** batch
  (``Segmentator.set_data_parallel``);
* each loss is the rank's **share** of the global loss (``loss``,
  ``mean``): its local numerator over the denominator summed over the
  ranks, so a weighted cross-entropy stays the global weighted mean, which
  a mean of per-rank weighted means is not once the class weights differ;
* after the backward each model's gradients are **summed** over the ranks
  in one flat buffer (``sync_grads``), not averaged as DDP does.

Random tensors are drawn for the global batch from the same generator
state on every rank and sliced (``draw``), so the run draws what one
process draws. ``DataShard()`` is the single process: every method is
then the identity.
"""
from __future__ import annotations

from functools import partial
from typing import Callable, Iterable, Sequence

import torch

from ..losses import cross_entropy2d, dice_loss, partial_cross_entropy2d
from . import comm


class DataShard:
    """Chunk ``index`` of ``n`` equal contiguous chunks of the batch axis,
    reduced over ``group``."""

    def __init__(self, group=None, index: int = 0, n: int = 1) -> None:
        self.group, self.index, self.n = group, int(index), int(n)

    @classmethod
    def of(cls, mesh) -> "DataShard":
        """The data chunk of ``mesh`` (None: the single process)."""
        if mesh is None:
            return cls()
        return cls(mesh.data_group, mesh.data_index, mesh.shape["data"])

    def rows(self, n_local: int) -> slice:
        """This rank's rows of a global batch of ``n_local · n`` rows."""
        return slice(self.index * n_local, (self.index + 1) * n_local)

    def stream_rows(self, sizes: Sequence[int], streams: Iterable[int]) -> torch.Tensor:
        """This rank's rows of a global batch made of streams of the local
        ``sizes`` (each ``n`` times larger globally) laid end to end, for the
        streams in ``streams``: a co-training theta draw is K labeled
        streams then the unlabeled one."""
        starts = [0]
        for s in sizes:
            starts.append(starts[-1] + s * self.n)
        return torch.cat([torch.arange(starts[i] + self.index * sizes[i],
                                       starts[i] + (self.index + 1) * sizes[i])
                          for i in streams])

    def draw(self, draw_fn: Callable[[int], torch.Tensor], n_local: int) -> torch.Tensor:
        """``draw_fn(n_global)`` cut to this rank's rows."""
        return draw_fn(n_local * self.n)[self.rows(n_local)]

    def loss(self, loss_fn: Callable) -> Callable:
        """``loss_fn`` as this rank's share of its value on the global
        batch: the cross-entropies divide by the weight summed over the
        ranks; a mean over pixels or images divides by ``n`` (the chunks
        are equal); ``dice_loss`` with ``size_average`` False is a sum."""
        if self.n == 1:
            return loss_fn
        base = loss_fn.func if isinstance(loss_fn, partial) else loss_fn
        keywords = loss_fn.keywords if isinstance(loss_fn, partial) else {}
        if base in (cross_entropy2d, partial_cross_entropy2d):
            return partial(loss_fn, den_reduce=self.total)
        if base is dice_loss and not keywords.get("size_average", True):
            return loss_fn
        return lambda *args, **kw: loss_fn(*args, **kw) / self.n

    def mean(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's share of the global mean of a sharded ``x``."""
        return x.mean() / self.n

    def total(self, x: torch.Tensor) -> torch.Tensor:
        """The sum over the ranks of a value that needs no gradient (a
        loss share's value, a denominator)."""
        return comm.all_reduce_(x.detach().clone(), self.group)

    def whole(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """A sharded batch axis ``dim`` made whole (metrics)."""
        return comm.gather_rows(x, self.group, dim)

    def sync_grads(self, params) -> None:
        """Sum the gradients over the ranks."""
        comm.flat_all_reduce_grads(params, self.group)
