"""Mean-Teacher trainer (``dct_tpu/train/mean_teacher.py``).

Per iteration, as dct_tpu runs it:

* the student sees a **bilinear** warp of the normalised labeled batch and
  of an unlabeled batch; the labels are warped **nearest** through float32;
* the teacher, in train mode and without a graph, forwards the *original*
  views (its running statistics evolve only through these two forwards),
  and its probabilities are re-warped bilinearly with the student's thetas;
* loss = CE(student, warped labels) + λ_con · (MSE on the labeled view +
  MSE on the unlabeled view); the student steps Adam; then the teacher's
  parameters (not its BatchNorm buffers) follow the student by EMA,
  ``t ← α·t + (1 − α)·s`` with α = 0.99.

The student's train dice is scored against the warped labels, the
teacher's against the original ones. Eval, the best checkpoint and the CSV
use the teacher. The thetas of iteration t draw from the epoch's torch
generator, labeled view first; host draws and the shared device array are
as in ``vat.py``.

With a data-only ``mesh`` each rank trains on its data chunk the share of
the data-parallel step (``parallel/data_parallel.py``): the student's and
the teacher's BatchNorm over the global batch, thetas and dropout masks
drawn for the global batch and sliced, the student's gradients summed over
the ranks; rank 0 alone evaluates and writes.
"""
from __future__ import annotations

import time
from pathlib import Path
from typing import Callable, Dict, List, Optional, Union

import numpy as np
import torch

from ..checkpoint import load_checkpoint, save_checkpoint
from ..data.augment import apply_thetas, sample_aug_thetas
from ..data.dataset import MedicalImageDataset
from ..data.pipeline import (DeviceDataset, InfiniteBatcher, PatientBuckets,
                             normalize_gather)
from ..losses import mse_probs
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


def make_mean_teacher_epoch(student: Segmentator, teacher: Segmentator,
                            sup_loss: Callable, C: int,
                            ema_alpha: float = 0.99, mesh=None) -> Callable:
    """``epoch(img_u8, gt_u8, idx_lab (T,B), idx_unlab (T,Bu), generator,
    lr, lam_con, thetas=None, thetas_u=None)`` trains the student and
    moves the teacher in place; returns {sup_loss (T,), con_loss (T,),
    student_dice (T,B,C), teacher_dice (T,B,C)} on the device. ``thetas``
    (T,B,2,3) and ``thetas_u`` (T,Bu,2,3), when given, replace the draws
    from ``generator``. Given a data-only ``mesh``, the indices are this
    rank's data chunk and the injected thetas the global batch's."""
    s_params = list(student.net.parameters())
    t_params = list(teacher.net.parameters())
    shard = DataShard.of(mesh)
    student.set_data_parallel(shard)
    teacher.set_data_parallel(shard)
    sup_share, mse_share = shard.loss(sup_loss), shard.loss(mse_probs)

    def one_step(img_u8, gt_u8, idx_l, idx_u, generator, t, lam_con, th, th_u):
        img_o, gt_o = normalize_gather(img_u8, gt_u8, idx_l)
        b, h, w = gt_o.shape
        th = shard_thetas(shard, generator, b, img_u8, th)
        if th is None:
            th = sample_aug_thetas(generator, b, h, w)
        img_s = apply_thetas(img_o, th, "bilinear")
        gt_s = apply_thetas(gt_o.float(), th, "nearest").long()
        u_img_o, _ = normalize_gather(img_u8, gt_u8, idx_u)
        th_u = shard_thetas(shard, generator, u_img_o.shape[0], img_u8, th_u)
        if th_u is None:
            th_u = sample_aug_thetas(generator, u_img_o.shape[0], h, w)
        u_img_s = apply_thetas(u_img_o, th_u, "bilinear")

        with torch.no_grad():
            t_logits = teacher.apply_train(img_o)
            t_probs_aug = apply_thetas(torch.softmax(t_logits, dim=-1), th, "bilinear")
            tu_probs = torch.softmax(teacher.apply_train(u_img_o), dim=-1)
            tu_probs_aug = apply_thetas(tu_probs, th_u, "bilinear")

        # the student's dropout streams (dct_tpu's fold_in(k, 2) and (k, 3));
        # the teacher's forwards pass none, so an arch with dropout raises
        # there, as in dct_tpu
        s_logits = student.apply_train(
            img_s, dropout_generator=student.dropout_generator(generator, t, 2))
        sup = sup_share(s_logits, gt_s)
        su_logits = student.apply_train(
            u_img_s, dropout_generator=student.dropout_generator(generator, t, 3))
        con = (mse_share(torch.softmax(s_logits, dim=-1), t_probs_aug)
               + mse_share(torch.softmax(su_logits, dim=-1), tu_probs_aug))
        total = sup + lam_con * con
        student.optimizer.zero_grad(set_to_none=True)
        total.backward()
        shard.sync_grads(s_params)
        student.optimizer.step()
        with torch.no_grad():          # EMA after the student's step
            torch._foreach_mul_(t_params, ema_alpha)
            torch._foreach_add_(t_params, s_params, alpha=1 - ema_alpha)
        return {"sup_loss": shard.total(sup), "con_loss": shard.total(con),
                "student_dice": _dice_rows(s_logits.detach(), gt_s, C),
                "teacher_dice": _dice_rows(t_logits, gt_o, C)}

    def epoch(img_u8: torch.Tensor, gt_u8: torch.Tensor, idx_lab, idx_unlab,
              generator: Optional[torch.Generator], lr: float, lam_con: float,
              thetas: Optional[torch.Tensor] = None,
              thetas_u: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
        dev = img_u8.device
        idx_lab = torch.as_tensor(np.asarray(idx_lab), device=dev).long()
        idx_unlab = torch.as_tensor(np.asarray(idx_unlab), device=dev).long()
        set_lr(student.optimizer, lr)
        steps = [one_step(img_u8, gt_u8, idx_lab[t], idx_unlab[t], generator, t, lam_con,
                          None if thetas is None else thetas[t].to(dev),
                          None if thetas_u is None else thetas_u[t].to(dev))
                 for t in range(idx_lab.shape[0])]
        out = {k: torch.stack([m[k] for m in steps]) for k in steps[0]}
        for k in ("student_dice", "teacher_dice"):
            out[k] = shard.whole(out[k], dim=1)
        return out

    return epoch


class MeanTeacherTrainer:
    def __init__(self, student_segmentator: Segmentator,
                 teacher_segmentator: Segmentator,
                 labeled_dataset: MedicalImageDataset,
                 unlabeled_dataset: MedicalImageDataset,
                 val_dataset: MedicalImageDataset,
                 criterions: Dict[str, Callable],
                 max_epoch: int = 100,
                 save_dir: Union[str, Path] = "tmp",
                 axises: Optional[List[int]] = None,
                 cot_scheduler_dict: Optional[dict] = None,
                 checkpoint: Optional[str] = None,
                 metricname: str = "metrics.csv",
                 batch_size: int = 4,
                 grp_regex: str = DEFAULT_GRP_REGEX,
                 ema_alpha: float = 0.99,
                 seed: int = 1234,
                 whole_config: Optional[dict] = None,
                 nan_policy: str = "warn",
                 device=None,
                 mesh=None) -> None:
        self.device = check_device(device, [student_segmentator, teacher_segmentator])
        self.student = student_segmentator
        self.teacher = teacher_segmentator
        self.criterions = criterions
        self.max_epoch = max_epoch
        self.mesh = check_data_mesh(mesh, batch_size)
        self.is_main = is_main()
        self.save_dir = make_save_dir(save_dir, whole_config, "mt_config.yml",
                                      write=self.is_main)
        self.C = student_segmentator.arch_dict["num_classes"]
        self.axises = axises if axises is not None else [1, 2, 3]
        self.metricname = metricname
        self.best_score = -1.0
        self.start_epoch = 0
        self.seed = seed
        self.rs = np.random.RandomState(seed)
        self.nan_policy = nan_policy
        self.con_scheduler = get_weight_scheduler(
            cot_scheduler_dict or {"name": "RampScheduler", "begin_epoch": 0,
                                   "max_epoch": 80, "max_value": 1.0,
                                   "ramp_mult": -5})

        self._img_cat, self._gt_cat = concat_streams(labeled_dataset, unlabeled_dataset,
                                                     self.device)
        self._unlab_offset = len(labeled_dataset)
        self.val_set = val_dataset
        self.val_dev = DeviceDataset(val_dataset, self.device)
        self.lab_batcher = InfiniteBatcher(len(labeled_dataset), batch_size, self.rs)
        self.unlab_batcher = InfiniteBatcher(len(unlabeled_dataset), batch_size, self.rs)
        self.iters_per_epoch = max(len(labeled_dataset) // batch_size, 1)
        self.val_buckets = PatientBuckets(val_dataset, grp_regex)
        self.eval_all = make_eval_all_step(self.teacher, self.C)
        self.epoch_fn = make_mean_teacher_epoch(self.student, self.teacher,
                                                criterions["sup"], self.C, ema_alpha,
                                                mesh=self.mesh)
        if checkpoint is not None:
            self._load_checkpoint(checkpoint)

    def start_training(self) -> List[dict]:
        """Train from ``start_epoch`` to ``max_epoch``; returns the CSV's rows."""
        records = resume_records(self.save_dir / self.metricname, self.start_epoch) \
            if self.is_main else []
        for epoch in range(self.start_epoch, self.max_epoch):
            t0 = time.perf_counter()
            idx_lab, idx_unlab = self.draw_indices()
            local = (idx_lab, idx_unlab) if self.mesh is None else \
                (dp_shard_idx(self.mesh, idx_lab), dp_shard_idx(self.mesh, idx_unlab))
            metrics = self.epoch_fn(self._img_cat, self._gt_cat, *local,
                                    epoch_generator(self.device, self.seed, epoch),
                                    self.student.lr(epoch), self.con_scheduler.value)
            m = {k: v.cpu().numpy() for k, v in metrics.items()}
            t_train = time.perf_counter() - t0
            if not self.is_main:
                check_finite_losses({"sup": m["sup_loss"], "con": m["con_loss"]},
                                    epoch, self.nan_policy)
                self.student.scheduler_step()
                self.teacher.scheduler_step()
                self.con_scheduler.step()
                continue
            t_eval0 = time.perf_counter()
            val = eval_dice(self.eval_all, self.val_dev, self.val_buckets)
            t_eval = time.perf_counter() - t_eval0
            self.student.scheduler_step()
            self.teacher.scheduler_step()
            self.con_scheduler.step()

            check_finite_losses({"sup": m["sup_loss"], "con": m["con_loss"]},
                                epoch, self.nan_policy)
            s_dice = m["student_dice"].reshape(-1, self.C).mean(0)
            t_dice = m["teacher_dice"].reshape(-1, self.C).mean(0)
            row = {"epoch": epoch,
                   "tra_student_loss": float(np.mean(m["sup_loss"])),
                   "tra_con_loss": float(np.mean(m["con_loss"])),
                   **{f"tra_student_dice_{i}": s_dice[i] for i in self.axises},
                   **{f"tra_teacher_dice_{i}": t_dice[i] for i in self.axises},
                   **{f"val_teacher_2d_dice_{i}": val["dice2d"][i] for i in self.axises},
                   **{f"val_teacher_3d_dice_{i}": val["dice3d"][i] for i in self.axises},
                   "images_per_sec": (idx_lab.size + idx_unlab.size) / max(t_train, 1e-9),
                   "t_train": t_train, "t_eval": t_eval}
            records.append(row)
            write_csv(self.save_dir / self.metricname, records)
            save_criterion = float(np.mean([val["dice2d"][i] for i in self.axises]))
            self.save_checkpoint(save_criterion, epoch)
            print(f">> MT epoch {epoch}: teacher val 2D {save_criterion:.4f} "
                  f"(3D {np.mean([val['dice3d'][i] for i in self.axises]):.4f}) "
                  f"[{time.perf_counter() - t0:.1f}s]", flush=True)
        return records

    def draw_indices(self):
        """The epoch's labeled (T,B) and offset unlabeled (T,B) indices."""
        T = self.iters_per_epoch
        idx_lab = self.lab_batcher.take(T).astype(np.int32)
        idx_unlab = (self._unlab_offset + self.unlab_batcher.take(T)).astype(np.int32)
        return idx_lab, idx_unlab

    def save_checkpoint(self, metric: float, epoch: int) -> None:
        """``last.ckpt`` every epoch and ``best_{metric:.4f}_{epoch}.ckpt``
        (replacing the previous ``best_*``) when the teacher's val 2D dice
        improves; dct_tpu's payload: the student with its optimizer state, the
        teacher without one. Called after the epoch's scheduler step, so
        each Segmentator's epoch is ``epoch + 1``."""
        teacher = self.teacher.state_dict
        del teacher["optim_state_dict"]
        payload = {"student": self.student.state_dict, "teacher": teacher,
                   "metric": metric, "epoch": epoch,
                   "con_scheduler": self.con_scheduler.state_dict()}
        save_checkpoint(self.save_dir / "last.ckpt", payload)
        if metric > self.best_score:
            self.best_score = metric
            for p in self.save_dir.glob("best_*.ckpt"):
                p.unlink()
            save_checkpoint(self.save_dir / f"best_{metric:.4f}_{epoch}.ckpt", payload)

    def _load_checkpoint(self, checkpoint: str) -> None:
        sd = load_checkpoint(checkpoint)
        self.student.load_state_dict(sd["student"])
        self.teacher.load_state_dict(sd["teacher"])
        self.best_score = float(sd["metric"])
        self.start_epoch = int(sd["epoch"]) + 1
        self.con_scheduler.load_state_dict(sd["con_scheduler"])
        if self.is_main:
            print(f">>> {checkpoint} loaded (best {self.best_score:.3f})")
