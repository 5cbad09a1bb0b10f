"""The supervised cell: ``dct_tpu_torch.train.steps.make_supervised_epoch``,
one model on batches of B, augmentation thetas given; the reference follows
it with ``reference.train.supervised_step``."""
from __future__ import annotations

from typing import Dict

from benchmark.program import Driver, index_tensor
from benchmark.reference import train as ref


class Supervised(Driver):
    def blocks(self):
        return [(int(self.traffic["batch"]),)]

    @property
    def images_per_iteration(self) -> int:
        return int(self.traffic["batch"])

    def extra_inputs(self, iterations: int) -> Dict[str, object]:
        if not self.traffic["augment"]:
            return {}
        return {"thetas": self.feed.thetas(iterations, self.images_per_iteration)}

    def make_epoch(self, segs, sup_loss):
        from dct_tpu_torch.train.steps import make_supervised_epoch

        return make_supervised_epoch(segs[0], sup_loss, int(self.cfg["arch"]["num_classes"]),
                                     augment=bool(self.traffic["augment"]))

    def invoke(self, epoch, inputs):
        (idx,) = inputs["rows"]
        return epoch(self.img_u8, self.gt_u8, idx, None, float(self.cfg["optim"]["lr"]),
                     thetas=inputs.get("thetas"))

    def losses(self, out):
        return out["loss"][:, None]

    def passes(self):
        return [int(self.traffic["batch"])]

    def reference_batch(self, inputs):
        (idx,) = inputs["rows"]
        th = inputs.get("thetas")
        return {"img_u8": self.img_u8, "gt_u8": self.gt_u8,
                "idx": index_tensor(idx[0], self.device),
                "theta": None if th is None else th[0]}

    def reference_step(self, models, batch, loss_fn):
        return ref.supervised_step(models[0], batch, loss_fn)["loss"][None]


def build(ctx) -> Driver:
    return Supervised(ctx)
