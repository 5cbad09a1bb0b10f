"""The Cityscapes co-training cell: ``dct_tpu_torch.train.city.
make_city_cotrain_epoch`` over 2 models, with the configuration's
augmentations, and per direction FGSM on a labeled draw or VAT on an
unlabeled one as the flags say, VAT's starting noise given; the reference
follows it with ``reference.train.city_cotrain_step``."""
from __future__ import annotations

from typing import Dict

import torch

from benchmark.program import Driver, index_tensor
from benchmark.reference import train as ref


class CityCotrain(Driver):
    def blocks(self):
        t = self.traffic
        b, bu, ba = int(t["batch"]), int(t["unlabeled_batch"]), int(t["adversarial_batch"])
        return [(self.K, b), (bu,), (2, ba), (2, ba)]

    def distinct_blocks(self) -> int:
        # the labeled and unlabeled batches differ across the checked steps;
        # the adversarial draws differ from them and within their step
        return 2

    @property
    def images_per_iteration(self) -> int:
        t = self.traffic
        return self.K * int(t["batch"]) + int(t["unlabeled_batch"])

    def extra_inputs(self, iterations: int) -> Dict[str, object]:
        t = self.traffic
        out: Dict[str, object] = {
            "flags": self.feed.flags(iterations, float(t["fsgm_ratio"])),
            "noise": self.feed.noise((iterations, 2, int(t["adversarial_batch"]),
                                      int(self.cfg["height"]), int(self.cfg["width"]),
                                      int(self.cfg["in_channels"])))}
        if t["augment"]:
            out["thetas"] = self.feed.thetas(iterations, self.images_per_iteration)
        return out

    def make_epoch(self, segs, sup_loss):
        from dct_tpu_torch.data.city_augment import get_composed_augmentations
        from dct_tpu_torch.train.city import make_city_cotrain_epoch

        t = self.traffic
        aug = None
        if t["augment"]:
            aug = get_composed_augmentations(self.cfg["augmentations"],
                                             int(self.cfg["loss"].get("ignore_index", 250)))
        return make_city_cotrain_epoch(segs, int(self.cfg["arch"]["num_classes"]), sup_loss,
                                       bool(t["train_jsd"]), bool(t["train_adv"]),
                                       float(t["eps_fgsm"]), float(t["eps_vat"]),
                                       augment_fn=aug)

    def invoke(self, epoch, inputs):
        t = self.traffic
        idx_lab, idx_unlab, adv_lab, adv_unlab = inputs["rows"]
        return epoch(self.img_u8, self.gt_u8, idx_lab, idx_unlab, adv_lab, adv_unlab,
                     inputs["flags"], None, float(self.cfg["optim"]["lr"]),
                     float(t["lam_cot"]), float(t["lam_adv"]), vat_noise=inputs["noise"],
                     thetas=inputs.get("thetas"))

    def losses(self, out):
        return torch.cat([out["sup_loss"], out["jsd_loss"][:, None],
                          out["adv_loss"][:, None]], dim=1)

    def reference_batch(self, inputs):
        idx_lab, idx_unlab, adv_lab, adv_unlab = inputs["rows"]
        th = inputs.get("thetas")
        dev = self.device
        return {"img_u8": self.img_u8, "gt_u8": self.gt_u8,
                "idx_lab": index_tensor(idx_lab[0], dev),
                "idx_unlab": index_tensor(idx_unlab[0], dev),
                "idx_adv_lab": index_tensor(adv_lab[0], dev),
                "idx_adv_unlab": index_tensor(adv_unlab[0], dev),
                "flags": inputs["flags"][0], "noise": inputs["noise"][0],
                "theta": None if th is None else th[0]}

    def reference_step(self, models, batch, loss_fn):
        t = self.traffic
        out = ref.city_cotrain_step(models, batch, loss_fn, float(t["lam_cot"]),
                                    float(t["lam_adv"]), float(t["eps_fgsm"]),
                                    float(t["eps_vat"]),
                                    int(self.cfg["loss"].get("ignore_index", 250)))
        return torch.cat([out["sup_loss"], out["jsd_loss"][None], out["adv_loss"][None]])


def build(ctx) -> Driver:
    return CityCotrain(ctx)
