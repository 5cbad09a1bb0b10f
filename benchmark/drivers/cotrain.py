"""The co-training cell: ``dct_tpu_torch.train.steps.make_cotrain_epoch`` over
K models, its labeled batches (K, B), the shared unlabeled batch (Bu), the
augmentation thetas of all K·B + Bu images, with JSD and FGSM at the
traffic's weights; the reference follows it with
``reference.train.cotrain_step``."""
from __future__ import annotations

from typing import Dict

import torch

from benchmark.program import Driver, index_tensor
from benchmark.reference import train as ref


class Cotrain(Driver):
    def blocks(self):
        t = self.traffic
        return [(self.K, int(t["batch"])), (int(t["unlabeled_batch"]),)]

    @property
    def images_per_iteration(self) -> int:
        t = self.traffic
        return self.K * int(t["batch"]) + int(t["unlabeled_batch"])

    def extra_inputs(self, iterations: int) -> Dict[str, object]:
        if not self.traffic["augment"]:
            return {}
        return {"thetas": self.feed.thetas(iterations, self.images_per_iteration)}

    def make_epoch(self, segs, sup_loss):
        from dct_tpu_torch.train.steps import make_cotrain_epoch

        t = self.traffic
        return make_cotrain_epoch(segs, int(self.cfg["arch"]["num_classes"]), sup_loss,
                                  train_jsd=bool(t["train_jsd"]), train_adv=bool(t["train_adv"]),
                                  augment_labeled=bool(t["augment"]),
                                  augment_unlabeled=bool(t["augment"]),
                                  eps_fgsm=float(t["eps_fgsm"]),
                                  fuse_forward=bool(t["fuse_forward"]))

    def invoke(self, epoch, inputs):
        t = self.traffic
        idx_lab, idx_unlab = inputs["rows"]
        return epoch(self.img_u8, self.gt_u8, idx_lab, idx_unlab, None, None,
                     float(self.cfg["optim"]["lr"]), float(t["lam_cot"]),
                     float(t["lam_adv"]), thetas=inputs.get("thetas"))

    def losses(self, out):
        return torch.cat([out["sup_loss"], out["jsd_loss"][:, None],
                          out["adv_loss"][:, None]], dim=1)

    def passes(self):
        t = self.traffic
        n = int(t["batch"]) + int(t["unlabeled_batch"])
        # each model's fused labeled + unlabeled forward, FGSM's forward on
        # model 1 and the adversarial forward on model 0, each with a backward
        return [n] * (self.K + 2)

    def reference_batch(self, inputs):
        idx_lab, idx_unlab = inputs["rows"]
        th = inputs.get("thetas")
        return {"img_u8": self.img_u8, "gt_u8": self.gt_u8,
                "idx_lab": index_tensor(idx_lab[0], self.device),
                "idx_unlab": index_tensor(idx_unlab[0], self.device),
                "theta": None if th is None else th[0]}

    def reference_step(self, models, batch, loss_fn):
        t = self.traffic
        out = ref.cotrain_step(models, batch, loss_fn, float(t["lam_cot"]),
                               float(t["lam_adv"]), float(t["eps_fgsm"]))
        return torch.cat([out["sup_loss"], out["jsd_loss"][None], out["adv_loss"][None]])


def build(ctx) -> Driver:
    return Cotrain(ctx)
