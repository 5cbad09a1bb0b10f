"""What the step drivers share: the program's models built from a cell's
configuration and given the benchmark's weights, the three checked steps
that set-up drives through the window's own call, the readings taken from
them, the faults a test plants, and the reference's three steps on the
same inputs.

A driver (``drivers/<step>.py``) subclasses :class:`Driver` with the shapes
of one iteration's inputs, the program's epoch function and how to call
it, and the reference step that follows it.
"""
from __future__ import annotations

import gc
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from . import weights
from .counts import count_flops
from .feed import Feed
from .reference import train as ref

CHECKED_STEPS = 3


class Readings:
    """What one side's three checked steps produced: each step's losses
    (steps × terms, the first ``sup_terms`` of them the supervised loss
    of each model), and by leaf ("m<k>.<name>") the norm of the first
    gradient as the optimizer takes it (L2 included), of each parameter's
    change over the three steps, and of each running statistic's change
    after the first step and after the three. ``vectors`` holds by leaf
    the first gradient and the parameter's change themselves, as
    {"first_grad": {leaf: tensor}, "change": {leaf: tensor}}, for the
    angles between the two sides."""

    def __init__(self, losses: torch.Tensor, first_grad: Dict[str, float],
                 change: Dict[str, float], stats_change1: Dict[str, float],
                 stats_change: Dict[str, float], sup_terms: int,
                 vectors: Optional[Dict[str, Dict[str, torch.Tensor]]] = None) -> None:
        self.losses = losses
        self.sup_terms = sup_terms
        self.first_grad = first_grad
        self.change = change
        self.stats_change1 = stats_change1
        self.stats_change = stats_change
        self.vectors = vectors or {"first_grad": {}, "change": {}}

    def as_dict(self) -> dict:
        return {"losses": self.losses.tolist(), "first_grad": self.first_grad,
                "change": self.change, "stats_change1": self.stats_change1,
                "stats_change": self.stats_change, "sup_terms": self.sup_terms}


def _norms(tensors: Dict[str, torch.Tensor]) -> Dict[str, float]:
    if not tensors:
        return {}
    vals = torch.stack([t.detach().double().norm() for t in tensors.values()]).cpu()
    return dict(zip(tensors, vals.tolist()))


@torch.no_grad()
def _changes(nets, initial, keep: Optional[torch.device] = None
             ) -> Tuple[Dict[str, float], Dict[str, float], Dict[str, torch.Tensor]]:
    """By leaf, the norms of the parameters' and of the running statistics'
    change from ``initial``; with ``keep``, the parameters' changes
    themselves on that device (float32), else {}."""
    params, stats, kept = {}, {}, {}
    for k, net in enumerate(nets):
        names = {n for n, _ in net.named_parameters()}
        for name, t in net.state_dict().items():
            d = t.double() - initial[k][name].to(t.device).double()
            (params if name in names else stats)[f"m{k}.{name}"] = d.norm()
            if keep is not None and name in names:
                kept[f"m{k}.{name}"] = d.float().to(keep)
    return _norms(params), _norms(stats), kept


class Driver:
    """One cell's program and reference. ``ctx`` carries ``cfg``, ``traffic``,
    ``seed``, ``device``, ``fault`` (None or a fault's name, for the tests
    and the calibration) and ``compute_dtype`` (None: the configuration's)."""

    def __init__(self, ctx) -> None:
        self.ctx = ctx
        self.cfg, self.traffic, self.device = ctx.cfg, ctx.traffic, ctx.device
        self.K = int(self.traffic["models"])
        self.T = int(self.traffic["iterations_per_call"])
        self.feed = Feed(self.cfg, self.traffic, int(ctx.seed), self.device)
        self.flops_per_iteration: Optional[float] = None

    # -- what a driver defines ----------------------------------------------
    def blocks(self) -> Sequence[Tuple[int, ...]]:
        """Shapes of one iteration's index arrays, in the order of
        :meth:`inputs`' ``rows``."""
        raise NotImplementedError

    def extra_inputs(self, iterations: int) -> Dict[str, object]:
        """Per-iteration inputs beyond the rows, each with a leading T axis."""
        raise NotImplementedError

    def make_epoch(self, segs, sup_loss):
        raise NotImplementedError

    def invoke(self, epoch, inputs: Dict[str, object]) -> Dict[str, torch.Tensor]:
        raise NotImplementedError

    def losses(self, out: Dict[str, torch.Tensor]) -> torch.Tensor:
        """(T, terms) of a call's returned losses."""
        raise NotImplementedError

    def reference_step(self, models: List[ref.Model], batch: Dict[str, object],
                       loss_fn) -> torch.Tensor:
        """One reference iteration on ``batch``; its losses as (terms,)."""
        raise NotImplementedError

    @property
    def images_per_iteration(self) -> int:
        raise NotImplementedError

    def passes(self) -> List[int]:
        """Images of each pass of a net (a forward with its backward) in one
        iteration, for the pool kernels' byte count; [] where the driver
        does not count them."""
        return []

    # -- shared ---------------------------------------------------------------
    def distinct_blocks(self) -> int:
        """How many leading blocks of :meth:`blocks` the checked steps take
        on rows that differ across all three steps (-1: all)."""
        return -1

    def inputs(self, iterations: int, distinct: bool) -> Dict[str, object]:
        rows = self.feed.rows(iterations, self.blocks(), distinct, self.distinct_blocks())
        out: Dict[str, object] = {"rows": rows}
        out.update(self.extra_inputs(iterations))
        return out

    @staticmethod
    def sliced(inputs: Dict[str, object], a: int, b: int) -> Dict[str, object]:
        return {k: ([r[a:b] for r in v] if k == "rows" else v[a:b])
                for k, v in inputs.items()}

    def build_program(self) -> None:
        from dct_tpu_torch.losses import get_loss_fn
        from dct_tpu_torch.models import Segmentator

        arch = dict(self.cfg["arch"])
        arch["compute_dtype"] = self.ctx.compute_dtype or self.cfg["precision"]["compute_dtype"]
        self.segs = [Segmentator(arch, self.cfg["optim"], self.cfg["scheduler"],
                                 torch.Generator().manual_seed(k), device=self.device,
                                 in_channels=int(self.cfg["in_channels"]))
                     for k in range(self.K)]
        layout = {n: tuple(t.shape) for n, t in self.segs[0].net.state_dict().items()}
        states = weights.draw(layout, self.K, int(self.ctx.seed), self.device)
        for seg, sd in zip(self.segs, states):
            seg.net.load_state_dict(sd)
        # the initial state, kept on the host for the reference
        self.initial = [{n: t.detach().cpu().clone() for n, t in sd.items()} for sd in states]
        del states
        loss_cfg = dict(self.cfg["loss"])
        sup_loss = get_loss_fn(loss_cfg.pop("name"), **loss_cfg)
        if self.ctx.fault == "half_batch":
            inner = sup_loss

            def sup_loss(logits, gt):
                n = max(logits.shape[0] // 2, 1)
                return inner(logits[:n], gt[:n])
        if self.ctx.fault == "frozen_state":
            for seg in self.segs:
                seg.optimizer.step = lambda *a, **k: None
        self.epoch = self.make_epoch(self.segs, sup_loss)
        self.img_u8, self.gt_u8 = self.feed.dataset()
        self.check_inputs = self.inputs(CHECKED_STEPS, distinct=True)
        n_pool = int(self.traffic["pool_calls"])
        self.pool = [self.inputs(self.T, distinct=False) for _ in range(n_pool)]

    def setup(self) -> None:
        """Build the program and drive the three checked steps through the
        window's own call."""
        self.build_program()
        first = self.invoke(self.epoch, self.sliced(self.check_inputs, 0, 1))
        grads = {}
        for k, seg in enumerate(self.segs):
            b1 = seg.optimizer.param_groups[0]["betas"][0]
            for name, p in seg.net.named_parameters():
                st = seg.optimizer.state.get(p, {})
                if "exp_avg" in st:
                    grads[f"m{k}.{name}"] = st["exp_avg"] / (1 - b1)
                else:
                    grads[f"m{k}.{name}"] = torch.zeros_like(p)
        first_grad = _norms(grads)
        # the vectors wait on the host, off the card, for the reference
        host = torch.device("cpu")
        grads = {n: g.to(host) for n, g in grads.items()}
        _, stats1, _ = self.changes()
        rest = self.invoke(self.epoch, self.sliced(self.check_inputs, 1, CHECKED_STEPS))
        losses = torch.cat([self.losses(first), self.losses(rest)]).double().cpu()
        change, stats, change_vectors = self.changes(keep=host)
        self.program = Readings(losses, first_grad, change, stats1, stats, self.K,
                                {"first_grad": grads, "change": change_vectors})

    def changes(self, keep: Optional[torch.device] = None):
        """By leaf, the norms of the parameters' and of the running
        statistics' change from the initial state, and with ``keep`` the
        parameters' changes themselves (see ``_changes``)."""
        return _changes([seg.net for seg in self.segs], self.initial, keep)

    def count_flops(self) -> None:
        """FLOPs of a window iteration: those of one whole window call (it
        trains T steps more), over its T iterations, so that a mix drawn
        per call (the Cityscapes FGSM/VAT flags) is counted as the window
        runs it."""
        self.flops_per_iteration = count_flops(
            lambda: self.invoke(self.epoch, self.pool[0])) / self.T

    def call(self, i: int, iterations: Optional[int] = None) -> Dict[str, torch.Tensor]:
        """Window call ``i``: the pool's call i mod its size, all its T
        iterations or the first ``iterations``."""
        inputs = self.pool[i % len(self.pool)]
        if iterations is not None:
            inputs = self.sliced(inputs, 0, iterations)
        return self.invoke(self.epoch, inputs)

    def release(self) -> None:
        """Free the program's state before the reference runs."""
        for name in ("epoch", "segs", "pool"):
            if hasattr(self, name):
                delattr(self, name)
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def run_reference(self) -> Readings:
        """The reference's three steps from the same weights on the same
        inputs, in plain float32 (TF32 off)."""
        if self.device.type == "cuda":
            torch.backends.cudnn.allow_tf32 = False
            torch.backends.cuda.matmul.allow_tf32 = False
        models = [ref.Model(self.cfg, {n: t.to(self.device) for n, t in sd.items()}, self.device)
                  for sd in self.initial]
        loss_fn = ref.loss_of(self.cfg)
        losses = []
        for t in range(CHECKED_STEPS):
            batch = self.reference_batch(self.sliced(self.check_inputs, t, t + 1))
            losses.append(self.reference_step(models, batch, loss_fn).double().cpu())
            if t == 0:
                _, stats1, _ = _changes([m.net for m in models], self.initial)
        grads = {f"m{k}.{n}": g for k, m in enumerate(models) for n, g in m.first_grad.items()}
        change, stats, change_vectors = _changes([m.net for m in models], self.initial,
                                                 keep=self.device)
        return Readings(torch.stack(losses), _norms(grads), change, stats1, stats, self.K,
                        {"first_grad": grads, "change": change_vectors})

    def reference_batch(self, inputs: Dict[str, object]) -> Dict[str, object]:
        """One iteration's inputs as the reference step takes them."""
        raise NotImplementedError


def index_tensor(a, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a), device=device).long()
