"""VAT trainer (``dct_tpu/train/vat.py``).

Per iteration: supervised CE on a labeled batch; while λ_adv > 0, a VAT
perturbation of an unlabeled batch (``adversarial.vat_perturbation``) and
the consistency KL(pred(adv) ‖ pred(clean).detach()). When λ_adv is 0 the
epoch runs the variant without the adversarial term, as dct_tpu selects
its compiled variant.

BatchNorm's running statistics update in dct_tpu's order, four times an
iteration with the term on: labeled, VAT-clean, real, adversarial; the
power iteration's perturbed forward updates none. The VAT-clean and real
forwards, whose outputs dct_tpu stop-gradients, build no graph.

Host draws follow dct_tpu: the labeled ``InfiniteBatcher`` draws its first
permutation at construction, then the unlabeled one; each epoch takes T
batches from the labeled stream, then T from the unlabeled one, T =
len(labeled) // B. Labeled and unlabeled slices share one device array,
unlabeled indices offset by ``len(labeled)``. Epoch e's augmentation and
VAT noise draw from a torch generator seeded with ``fold_in(seed, e)``.

With a data-only ``mesh`` each rank trains on its data chunk the share of
the data-parallel step (``parallel/data_parallel.py``): BatchNorm over the
global batch, thetas and VAT noise drawn for the global batch and sliced,
gradients summed over the ranks; rank 0 alone evaluates and writes.
"""
from __future__ import annotations

import time
from pathlib import Path
from typing import Callable, Dict, List, Optional, Union

import numpy as np
import torch

from ..adversarial import vat_perturbation
from ..checkpoint import load_checkpoint, save_checkpoint
from ..data.dataset import MedicalImageDataset
from ..data.pipeline import (DeviceDataset, InfiniteBatcher, PatientBuckets,
                             gather_augment_u8, normalize_gather)
from ..losses import kl_div_2d
from ..models.segmentator import Segmentator
from ..optim import set_lr
from ..parallel.data_parallel import DataShard
from ..parallel.mesh import dp_shard_idx, is_main
from ..schedules import get_weight_scheduler
from ..utils.general import check_finite_losses
from ..utils.logging import resume_records
from .steps import _dice_rows, make_eval_all_step, shard_thetas
from .trainer import (DEFAULT_GRP_REGEX, check_data_mesh, check_device, concat_streams,
                      epoch_generator, eval_dice, make_save_dir, write_csv)


def make_vat_epoch(seg: Segmentator, sup_loss: Callable, C: int,
                   train_adv: bool, augment_labeled: bool,
                   augment_unlabeled: bool, eps: float, xi: float,
                   ip: int, mesh=None) -> Callable:
    """``epoch(img_u8, gt_u8, idx_lab (T,B), idx_unlab (T,Bu), generator,
    lr, lam_adv, thetas_lab=None, thetas_unlab=None, noise=None)`` trains
    ``seg`` in place and returns {sup_loss (T,), adv_loss (T,), dice
    (T,B,C)} on the device. ``thetas_lab`` (T,B,2,3), ``thetas_unlab``
    (T,Bu,2,3) and the VAT starting noise ``noise`` (T,Bu,H,W,1), when
    given, replace the draws from ``generator``. Given a data-only
    ``mesh``, the indices are this rank's data chunk and the injected draws
    the global batch's."""
    shard = DataShard.of(mesh)
    seg.set_data_parallel(shard)
    sup_share = shard.loss(sup_loss)

    def one_step(img_u8, gt_u8, idx_l, idx_u, generator, lam_adv, th_l, th_u, d):
        if augment_labeled:
            th_l = shard_thetas(shard, generator, idx_l.shape[0], img_u8, th_l)
            img, gt = gather_augment_u8(img_u8, gt_u8, idx_l, generator, thetas=th_l)
        else:
            img, gt = normalize_gather(img_u8, gt_u8, idx_l)
        logits = seg.apply_train(img)
        sup = sup_share(logits, gt)
        total, adv = sup, torch.zeros((), device=img.device)
        if train_adv:
            if augment_unlabeled:
                th_u = shard_thetas(shard, generator, idx_u.shape[0], img_u8, th_u)
                u_img, _ = gather_augment_u8(img_u8, gt_u8, idx_u, generator, thetas=th_u)
            else:
                u_img, _ = normalize_gather(img_u8, gt_u8, idx_u)
            if shard.n > 1:     # the global batch's noise, this rank's rows
                d = shard.draw(lambda n: torch.randn(
                    (n,) + u_img.shape[1:], generator=generator, device=u_img.device,
                    dtype=u_img.dtype), u_img.shape[0]) if d is None \
                    else d[shard.rows(u_img.shape[0])]
            adv_img, _ = vat_perturbation(seg, u_img, xi, eps, ip, d=d,
                                          generator=generator, mean=shard.mean)
            with torch.no_grad():
                real_probs = torch.softmax(seg.apply_train(u_img), dim=-1)
            adv_probs = torch.softmax(seg.apply_train(adv_img), dim=-1)
            adv = shard.mean(kl_div_2d(adv_probs, real_probs))
            total = sup + lam_adv * adv
        seg.optimizer.zero_grad(set_to_none=True)
        total.backward()
        shard.sync_grads(seg.net.parameters())
        seg.optimizer.step()
        return {"sup_loss": shard.total(sup), "adv_loss": shard.total(adv),
                "dice": _dice_rows(logits.detach(), gt, C)}

    def epoch(img_u8: torch.Tensor, gt_u8: torch.Tensor, idx_lab, idx_unlab,
              generator: Optional[torch.Generator], lr: float, lam_adv: float,
              thetas_lab: Optional[torch.Tensor] = None,
              thetas_unlab: Optional[torch.Tensor] = None,
              noise: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
        dev = img_u8.device
        idx_lab = torch.as_tensor(np.asarray(idx_lab), device=dev).long()
        idx_unlab = torch.as_tensor(np.asarray(idx_unlab), device=dev).long()
        set_lr(seg.optimizer, lr)

        def at(x, t):
            return None if x is None else x[t].to(dev)
        steps = [one_step(img_u8, gt_u8, idx_lab[t], idx_unlab[t], generator, lam_adv,
                          at(thetas_lab, t), at(thetas_unlab, t), at(noise, t))
                 for t in range(idx_lab.shape[0])]
        out = {k: torch.stack([m[k] for m in steps]) for k in steps[0]}
        out["dice"] = shard.whole(out["dice"], dim=1)
        return out

    return epoch


class VatTrainer:
    def __init__(self, segmentator: Segmentator,
                 labeled_dataset: MedicalImageDataset,
                 unlabeled_dataset: MedicalImageDataset,
                 val_dataset: MedicalImageDataset,
                 criterion: Callable,
                 max_epoch: int = 100,
                 save_dir: Union[str, Path] = "tmp",
                 axises: Optional[List[int]] = None,
                 checkpoint: Optional[str] = None,
                 metricname: str = "metrics.csv",
                 adv_scheduler_dict: Optional[dict] = None,
                 adv_training_dict: Optional[dict] = None,
                 batch_size: int = 4,
                 grp_regex: str = DEFAULT_GRP_REGEX,
                 seed: int = 1234,
                 whole_config: Optional[dict] = None,
                 nan_policy: str = "warn",
                 device=None,
                 mesh=None) -> None:
        self.device = check_device(device, [segmentator])
        self.segmentator = segmentator
        self.criterion = criterion
        self.max_epoch = max_epoch
        self.mesh = check_data_mesh(mesh, batch_size)
        self.is_main = is_main()
        self.save_dir = make_save_dir(save_dir, whole_config, "config.yml",
                                      write=self.is_main)
        self.C = segmentator.arch_dict["num_classes"]
        self.axises = axises if axises is not None else [1, 2, 3]
        self.metricname = metricname
        self.best_score = -1.0
        self.start_epoch = 0
        self.seed = seed
        self.rs = np.random.RandomState(seed)
        self.nan_policy = nan_policy
        self.adv_scheduler = get_weight_scheduler(
            adv_scheduler_dict or {"name": "ConstantScheduler", "begin_epoch": 0,
                                   "max_value": 0.0})
        adv_cfg = adv_training_dict or {}
        self.eps = float(adv_cfg.get("eplision", 0.05))
        self.xi = float(adv_cfg.get("xi", 1e-6))
        self.ip = int(adv_cfg.get("ip", 1))

        self._img_cat, self._gt_cat = concat_streams(labeled_dataset, unlabeled_dataset,
                                                     self.device)
        self._unlab_offset = len(labeled_dataset)
        self.val_set = val_dataset
        self.val_dev = DeviceDataset(val_dataset, self.device)
        self.lab_batcher = InfiniteBatcher(len(labeled_dataset), batch_size, self.rs)
        self.unlab_batcher = InfiniteBatcher(len(unlabeled_dataset), batch_size, self.rs)
        self.iters_per_epoch = max(len(labeled_dataset) // batch_size, 1)
        self.val_buckets = PatientBuckets(val_dataset, grp_regex)
        self.eval_all = make_eval_all_step(segmentator, self.C)

        if checkpoint is not None:
            self._load_checkpoint(checkpoint)

    def start_training(self, train_adv: bool = False,
                       augment_labeled_data: bool = False,
                       augment_unlabeled_data: bool = False,
                       save_train: bool = False, save_val: bool = False) -> List[dict]:
        """Train from ``start_epoch`` to ``max_epoch``; returns the CSV's
        rows. ``save_train`` and ``save_val`` are accepted and unused, as
        in dct_tpu."""
        records = resume_records(self.save_dir / self.metricname, self.start_epoch) \
            if self.is_main else []
        for epoch in range(self.start_epoch, self.max_epoch):
            t0 = time.perf_counter()
            lam = self.adv_scheduler.value
            adv_on = bool(train_adv and lam > 0)
            idx_lab, idx_unlab = self.draw_indices()
            epoch_fn = make_vat_epoch(self.segmentator, self.criterion, self.C, adv_on,
                                      augment_labeled_data, augment_unlabeled_data,
                                      self.eps, self.xi, self.ip, mesh=self.mesh)
            local = (idx_lab, idx_unlab) if self.mesh is None else \
                (dp_shard_idx(self.mesh, idx_lab), dp_shard_idx(self.mesh, idx_unlab))
            metrics = epoch_fn(self._img_cat, self._gt_cat, *local,
                               epoch_generator(self.device, self.seed, epoch),
                               self.segmentator.lr(epoch), lam)
            m = {k: v.cpu().numpy() for k, v in metrics.items()}
            t_train = time.perf_counter() - t0
            if not self.is_main:
                check_finite_losses({"sup": m["sup_loss"], "adv": m["adv_loss"]},
                                    epoch, self.nan_policy)
                self.segmentator.scheduler_step()
                self.adv_scheduler.step()
                continue
            t_eval0 = time.perf_counter()
            val = eval_dice(self.eval_all, self.val_dev, self.val_buckets)
            t_eval = time.perf_counter() - t_eval0
            self.segmentator.scheduler_step()
            self.adv_scheduler.step()

            check_finite_losses({"sup": m["sup_loss"], "adv": m["adv_loss"]},
                                epoch, self.nan_policy)
            tra_dice = m["dice"].reshape(-1, self.C).mean(0)
            row = {"epoch": epoch,
                   "sup_loss": float(np.mean(m["sup_loss"])),
                   "adv_loss": float(np.mean(m["adv_loss"])),
                   **{f"tra_dice_{i}": tra_dice[i] for i in self.axises},
                   **{f"val_dice_{i}": val["dice2d"][i] for i in self.axises},
                   **{f"val_batch_dice_{i}": val["dice3d"][i] for i in self.axises},
                   "images_per_sec": (idx_lab.size + (idx_unlab.size if adv_on else 0))
                   / max(t_train, 1e-9),
                   "t_train": t_train, "t_eval": t_eval}
            records.append(row)
            write_csv(self.save_dir / self.metricname, records)
            current = float(np.mean([val["dice2d"][i] for i in self.axises]))
            self.checkpoint(current, epoch)
            print(f">> VAT epoch {epoch}: val 2D {current:.4f} λ_adv={lam:.4f} "
                  f"[{time.perf_counter() - t0:.1f}s]", flush=True)
        return records

    def draw_indices(self):
        """The epoch's labeled (T,B) and offset unlabeled (T,B) indices."""
        T = self.iters_per_epoch
        idx_lab = self.lab_batcher.take(T).astype(np.int32)
        idx_unlab = (self._unlab_offset + self.unlab_batcher.take(T)).astype(np.int32)
        return idx_lab, idx_unlab

    def checkpoint(self, metric: float, epoch: int) -> None:
        payload = {"segmentator": self.segmentator.state_dict,
                   "best_score": float(self.best_score), "best_epoch": epoch,
                   "adv_scheduler": self.adv_scheduler.state_dict()}
        save_checkpoint(self.save_dir / "last.ckpt", payload)
        if metric > self.best_score:
            self.best_score = metric
            save_checkpoint(self.save_dir / "best.ckpt", {**payload, "best_score": metric})

    def _load_checkpoint(self, checkpoint: str) -> None:
        sd = load_checkpoint(checkpoint)
        self.segmentator.load_state_dict(sd["segmentator"])
        self.best_score = float(sd["best_score"])
        self.start_epoch = int(sd["best_epoch"]) + 1
        self.adv_scheduler.load_state_dict(sd["adv_scheduler"])
        if self.is_main:
            print(f">>> {checkpoint} loaded (best {self.best_score:.3f})")
