"""The Cityscapes trainers: supervised ``TrainerCity`` and ``CoTrainerCity``
(``dct_tpu/train/city.py``).

What differs from the medical CoTrainer:

* the losses ignore label 250 (void pixels), with the config's 19 class
  weights;
* validation is IoU from a confusion matrix counted on the device, one
  (C,C) fetch a batch (``make_city_eval_step``), over val batches of the
  training batch size in file order, the last batch padded with the first
  indices (``EpochBatcher(drop_last=False)``), so those images count twice,
  as in dct_tpu;
* the adversarial term draws fresh batches and, per direction (attack
  model 0 and score model 1, then the reverse), takes FGSM on a labeled
  batch or VAT on an unlabeled one, as a host-drawn flag says
  (``rand(T, 2) <= fsgm_ratio``). None of those forwards keeps its running
  statistics, and only the chosen branch runs: dct_tpu computes both and
  selects, and neither branch feeds a gradient or a statistic;
* the labeled and unlabeled forwards always run fused when the JSD term is
  on and B == Bu (one two-group forward per model, ``layers.BatchNorm``);
* every 10th epoch with ``save_val``, each model's val class maps go to
  ``save_dir/iter{epoch}/eval/{model}/`` as PNGs.

Host draws, all from one ``RandomState(seed)``, in dct_tpu's order: at
construction each labeled batcher's first pass, then the unlabeled one's;
per epoch each labeled stream's T batches, the unlabeled stream's T, the
adversarial labeled draws (one T-batch take per labeled stream), K
adversarial unlabeled takes, then the (T, 2) flags. So the same seed gives
dct_tpu's index arrays and flags. Epoch e's augmentation and VAT noise come
from a torch generator seeded with ``fold_in(seed, e)``.

Checkpoints are dct_tpu's city payloads (``last_{i}.ckpt`` every epoch,
``best_{i}.ckpt`` on a better mean IoU), without Adam state. A resume, as
in dct_tpu, reloads the weights and best scores, restarts Adam and the λ
schedulers from scratch, and starts at the last file's ``best_epoch`` + 1.

With a data-only ``mesh`` (both trainers) each rank trains on its data
chunk of every index array, the adversarial ones included, the share of
the data-parallel step (``parallel/data_parallel.py``); the flags stay
whole; thetas and VAT noise are drawn for the global batch and sliced;
rank 0 alone evaluates and writes.
"""
from __future__ import annotations

import time
from pathlib import Path
from typing import Callable, Dict, List, Optional, Union

import numpy as np
import torch

from ..adversarial import fgsm, vat_perturbation
from ..checkpoint import load_checkpoint, save_checkpoint
from ..data.cityscapes import IGNORE_INDEX, CityscapesDataset
from ..data.city_augment import get_composed_augmentations
from ..data.pipeline import DeviceDataset, EpochBatcher, InfiniteBatcher, normalize_gather
from ..losses import jsd_2d, kl_div_2d
from ..metrics import iou_from_confusion
from ..models.segmentator import Segmentator
from ..optim import build_optimizer, set_lr
from ..parallel.data_parallel import DataShard
from ..parallel.mesh import dp_shard_idx, is_main
from ..schedules import get_weight_scheduler
from ..utils.general import check_finite_losses, save_images
from ..utils.logging import resume_records
from .trainer import check_data_mesh, check_device, epoch_generator, make_save_dir, write_csv


def make_city_eval_step(seg: Segmentator, C: int) -> Callable:
    """``step(img_u8, gt_u8, idx (B,))`` → (C,C) int64 confusion counts on
    the device, rows ground truth, columns the eval-mode argmax; void pixels
    and labels ≥ C are dropped on the device."""

    @torch.inference_mode()
    def step(img_u8, gt_u8, idx) -> torch.Tensor:
        idx = torch.as_tensor(np.asarray(idx), device=img_u8.device).long()
        img, gt = normalize_gather(img_u8, gt_u8, idx)
        pred = torch.argmax(seg.apply_eval(img), dim=-1)
        valid = (gt != IGNORE_INDEX) & (gt < C)
        flat = torch.where(valid, gt * C + pred, C * C)       # void → one extra bin
        return torch.bincount(flat.flatten(), minlength=C * C + 1)[:C * C].reshape(C, C)

    return step


def make_city_pred_step(seg: Segmentator) -> Callable:
    """``step(img_u8, gt_u8, idx (B,))`` → (B,H,W) eval-mode argmax class
    maps, for the prediction dumps."""

    @torch.inference_mode()
    def step(img_u8, gt_u8, idx) -> torch.Tensor:
        idx = torch.as_tensor(np.asarray(idx), device=img_u8.device).long()
        img, _ = normalize_gather(img_u8, gt_u8, idx)
        return torch.argmax(seg.apply_eval(img), dim=-1)

    return step


def make_city_cotrain_epoch(segs: List[Segmentator], C: int, sup_loss: Callable,
                            train_jsd: bool, train_adv: bool, eps_fgsm: float,
                            eps_vat: float, augment_fn=None, mesh=None) -> Callable:
    """The Cityscapes co-training epoch over the K models ``segs``.

    ``epoch(img_u8, gt_u8, idx_lab (T,K,B), idx_unlab (T,Bu), idx_adv_lab
    (T,2,B), idx_adv_unlab (T,2,B'), fsgm_flags (T,2) bools, generator, lr,
    lam_cot, lam_adv, vat_noise=None, thetas=None)`` trains the models in
    place and returns {sup_loss (T,K), jsd_loss (T,), adv_loss (T,)} on the
    device. A flag True picks FGSM (ε ``eps_fgsm``) on the labeled draw,
    False VAT (ε ``eps_vat``) on the unlabeled one, for direction 0 (attack
    model 0, score model 1) and 1 (the reverse). ``augment_fn`` (a
    ``city_augment.ComposedAugment``) warps the labeled and unlabeled
    batches. ``vat_noise`` (T,2,B',H,W,3) and ``thetas`` (T, K·B+Bu, 2, 3),
    when given, replace the draws from ``generator``. Given a data-only
    ``mesh``, the indices are this rank's data chunks and the injected
    draws the global batch's.
    """
    K = len(segs)
    assert not train_adv or K == 2, "the city adversarial term needs 2 models"
    shard = DataShard.of(mesh)
    for s in segs:
        s.set_data_parallel(shard)
    sup_share = shard.loss(sup_loss)

    def one_step(img_u8, gt_u8, idx_l, idx_u, idx_al, idx_au, flags, generator,
                 lam_cot, lam_adv, noise, th) -> Dict[str, torch.Tensor]:
        B, Bu = idx_l.shape[1], idx_u.shape[0]
        img_all, gt_all = normalize_gather(img_u8, gt_u8,
                                           torch.cat([idx_l.reshape(-1), idx_u]))
        if augment_fn is not None:
            if th is None:
                th = torch.cat([shard.draw(lambda m: augment_fn.sample(
                    generator, m, *img_u8.shape[1:3]), n) for n in [B] * K + [Bu]])
            elif shard.n > 1:
                th = th[shard.stream_rows([B] * K + [Bu], range(K + 1)).to(th.device)]
            gt_all[K * B:] = 0              # the unlabeled labels are not used
            img_all, gt_all = augment_fn.warp(img_all, gt_all, th)
        lab_img = img_all[:K * B].reshape((K, B) + img_all.shape[1:])
        lab_gt = gt_all[:K * B].reshape((K, B) + gt_all.shape[1:])
        unlab_img = img_all[K * B:]

        zero = torch.zeros((), device=img_all.device)
        jsd_loss, adv_loss = zero, zero
        if train_jsd and B == Bu and all(s.bn_momentum is not None for s in segs):
            both = [s.apply_train(torch.cat([lab_img[k], unlab_img]), groups=2)
                    for k, s in enumerate(segs)]
            lab_logits, unlab_logits = [lg[:B] for lg in both], [lg[B:] for lg in both]
        else:
            lab_logits = [segs[k].apply_train(lab_img[k]) for k in range(K)]
            unlab_logits = [s.apply_train(unlab_img) for s in segs] if train_jsd else None
        sup_each = torch.stack([sup_share(lab_logits[k], lab_gt[k]) for k in range(K)])
        total = sup_each.sum()
        if train_jsd:
            probs = torch.stack([torch.softmax(lg, dim=-1) for lg in unlab_logits])
            jsd_loss = shard.mean(jsd_2d(probs))
            total = total + lam_cot * jsd_loss
        if train_adv:
            losses = []
            for direction, (atk, tgt) in enumerate(((0, 1), (1, 0))):
                if flags[direction]:
                    clean, gt = normalize_gather(img_u8, gt_u8, idx_al[direction])
                    adv, _, _ = fgsm(segs[atk], clean, gt, sup_share, eps_fgsm,
                                     update_stats=False)
                else:
                    clean, _ = normalize_gather(img_u8, gt_u8, idx_au[direction])
                    d = None if noise is None else noise[direction].to(clean)
                    if shard.n > 1:     # the global batch's noise, this rank's rows
                        d = shard.draw(lambda n: torch.randn(
                            (n,) + clean.shape[1:], generator=generator,
                            device=clean.device, dtype=clean.dtype), clean.shape[0]) \
                            if d is None else d[shard.rows(clean.shape[0])]
                    adv, _ = vat_perturbation(
                        segs[atk], clean, epsilon=eps_vat, generator=generator, d=d,
                        update_stats=False, mean=shard.mean)
                with torch.no_grad():
                    real = torch.softmax(segs[atk].apply_train(clean, update_stats=False), -1)
                adv_logits = segs[tgt].apply_train(adv, update_stats=False)
                losses.append(shard.mean(kl_div_2d(torch.softmax(adv_logits, -1), real)))
            adv_loss = sum(losses) / len(losses)
            total = total + lam_adv * adv_loss

        for s in segs:
            s.optimizer.zero_grad(set_to_none=True)
        total.backward()
        for s in segs:
            shard.sync_grads(s.net.parameters())
            s.optimizer.step()
        if shard.n > 1:
            losses = shard.total(torch.cat([sup_each, jsd_loss[None], adv_loss[None]]))
            sup_each, jsd_loss, adv_loss = losses[:K], losses[K], losses[K + 1]
        return {"sup_loss": sup_each.detach(), "jsd_loss": jsd_loss.detach(),
                "adv_loss": adv_loss.detach()}

    def epoch(img_u8: torch.Tensor, gt_u8: torch.Tensor, idx_lab, idx_unlab,
              idx_adv_lab, idx_adv_unlab, fsgm_flags, generator: Optional[torch.Generator],
              lr: float, lam_cot: float, lam_adv: float,
              vat_noise: Optional[torch.Tensor] = None,
              thetas: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
        dev = img_u8.device

        def as_idx(a):
            return torch.as_tensor(np.asarray(a), device=dev).long()
        idx_lab, idx_unlab = as_idx(idx_lab), as_idx(idx_unlab)
        idx_adv_lab, idx_adv_unlab = as_idx(idx_adv_lab), as_idx(idx_adv_unlab)
        flags = np.asarray(fsgm_flags, bool)
        if idx_lab.shape[1] != K:
            raise ValueError(f"idx_lab must be (T, K={K}, B), got {tuple(idx_lab.shape)}")
        for s in segs:
            set_lr(s.optimizer, lr)
        steps = [one_step(img_u8, gt_u8, idx_lab[t], idx_unlab[t], idx_adv_lab[t],
                          idx_adv_unlab[t], flags[t], generator, lam_cot, lam_adv,
                          None if vat_noise is None else vat_noise[t],
                          None if thetas is None else thetas[t].to(dev))
                 for t in range(idx_lab.shape[0])]
        return {k: torch.stack([m[k] for m in steps]) for k in steps[0]}

    return epoch


class CoTrainerCity:
    def __init__(self, segmentators: List[Segmentator],
                 labeled_datasets: List[CityscapesDataset],
                 unlabeled_dataset: CityscapesDataset,
                 val_dataset: CityscapesDataset,
                 criterions: Dict[str, Callable],
                 max_epoch: int = 100,
                 save_dir: Union[str, Path] = "tmp",
                 checkpoint: Optional[str] = None,
                 metricname: str = "metrics.csv",
                 cot_scheduler_dict: Optional[dict] = None,
                 adv_scheduler_dict: Optional[dict] = None,
                 adv_training_dict: Optional[dict] = None,
                 batch_size: int = 2,
                 iters_per_epoch: Optional[int] = None,
                 seed: int = 1234,
                 augmentations: Optional[dict] = None,
                 whole_config: Optional[dict] = None,
                 nan_policy: str = "warn",
                 device=None,
                 mesh=None) -> None:
        assert len(segmentators) == len(labeled_datasets)
        self.device = check_device(device, segmentators)
        self.K = len(segmentators)
        self.segmentators = segmentators
        self.seg = segmentators[0]
        self.criterions = criterions
        self.max_epoch = max_epoch
        self.mesh = check_data_mesh(mesh, batch_size)
        self.is_main = is_main()
        self.save_dir = make_save_dir(save_dir, whole_config, "config.yml",
                                      write=self.is_main)
        self.C = self.seg.arch_dict["num_classes"]
        self.metricname = metricname
        self.batch_size = batch_size
        self.best_scores = np.zeros(self.K)
        self.start_epoch = 0
        self.seed = seed
        self.rs = np.random.RandomState(seed)
        self.nan_policy = nan_policy
        const0 = {"name": "ConstantScheduler", "begin_epoch": 0, "max_value": 0.0}
        self.cot_scheduler = get_weight_scheduler(cot_scheduler_dict or const0)
        self.adv_scheduler = get_weight_scheduler(adv_scheduler_dict or const0)
        self.augment_fn = get_composed_augmentations(augmentations)
        adv_cfg = adv_training_dict or {}
        self.eps_fgsm = float(adv_cfg.get("eplision", 0.03))
        self.eps_vat = float(adv_cfg.get("vat_eplision", adv_cfg.get("eplision", 10.0)))
        self.fsgm_ratio = float(adv_cfg.get("fsgm_ratio", 0.5))

        # one uint8 array on the device: the K labeled streams, then the
        # unlabeled one; a stream's batch indices are offset into it
        streams = list(labeled_datasets) + [unlabeled_dataset]
        self._offsets = np.cumsum([0] + [len(d) for d in streams[:-1]]).tolist()
        self._img_cat = torch.from_numpy(
            np.concatenate([d.data["img"] for d in streams])).to(self.device)
        self._gt_cat = torch.from_numpy(
            np.concatenate([d.data["gt"] for d in streams])).to(self.device)
        self.val_set = val_dataset
        self.val_dev = DeviceDataset(val_dataset, self.device)
        self.lab_batchers = [InfiniteBatcher(len(d), batch_size, self.rs)
                             for d in labeled_datasets]
        self.unlab_batcher = InfiniteBatcher(len(unlabeled_dataset), batch_size, self.rs)
        self.iters_per_epoch = iters_per_epoch or max(
            min(len(d) for d in labeled_datasets) // batch_size, 1)
        self.val_batcher = EpochBatcher(len(val_dataset), batch_size, shuffle=False,
                                        drop_last=False)
        self.eval_steps = [make_city_eval_step(s, self.C) for s in segmentators]
        self.pred_steps = [make_city_pred_step(s) for s in segmentators]
        if checkpoint is not None:
            self._load_checkpoint(checkpoint)

    def draw_indices(self, T: int):
        """One epoch's host draws, in dct_tpu's order: (idx_lab (T,K,B),
        idx_unlab (T,B), idx_adv_lab (T,K,B), idx_adv_unlab (T,K,B), flags
        (T,2)), the indices offset into the concatenated device array."""
        def lab_take():
            return np.stack([off + b.take(T) for off, b in
                             zip(self._offsets[:-1], self.lab_batchers)], axis=1).astype(np.int32)
        idx_lab = lab_take()
        idx_unlab = (self._offsets[-1] + self.unlab_batcher.take(T)).astype(np.int32)
        idx_adv_lab = lab_take()
        idx_adv_unlab = np.stack([self._offsets[-1] + self.unlab_batcher.take(T)
                                  for _ in range(self.K)], axis=1).astype(np.int32)
        flags = self.rs.rand(T, 2) <= self.fsgm_ratio
        return idx_lab, idx_unlab, idx_adv_lab, idx_adv_unlab, flags

    def start_training(self, train_jsd: bool = False, train_adv: bool = False,
                       save_val: bool = False, **_ignored) -> List[dict]:
        """Train from ``start_epoch`` to ``max_epoch``; returns the CSV's rows."""
        epoch_fn = make_city_cotrain_epoch(
            self.segmentators, self.C, self.criterions["sup"], train_jsd, train_adv,
            self.eps_fgsm, self.eps_vat, augment_fn=self.augment_fn, mesh=self.mesh)
        records = resume_records(self.save_dir / self.metricname, self.start_epoch) \
            if self.is_main else []
        for epoch in range(self.start_epoch, self.max_epoch):
            t0 = time.perf_counter()
            T = self.iters_per_epoch
            idx_lab, idx_unlab, *adv_draws = self.draw_indices(T)
            local = [idx_lab, idx_unlab] + adv_draws
            if self.mesh is not None:       # the flags stay whole
                local = [dp_shard_idx(self.mesh, a) for a in local[:4]] + local[4:]
            metrics = epoch_fn(self._img_cat, self._gt_cat, *local,
                               epoch_generator(self.device, self.seed, epoch),
                               self.seg.lr(epoch), self.cot_scheduler.value,
                               self.adv_scheduler.value)
            # the fetch waits for the device, so the clock stops after it
            m = {k: v.cpu().numpy() for k, v in metrics.items()}
            t_train = time.perf_counter() - t0
            if not self.is_main:
                for s in self.segmentators:
                    s.scheduler_step()
                self.cot_scheduler.step()
                self.adv_scheduler.step()
                check_finite_losses({"sup": m["sup_loss"], "jsd": m["jsd_loss"],
                                     "adv": m["adv_loss"]}, epoch, self.nan_policy)
                continue
            t_eval0 = time.perf_counter()
            val = self._eval_epoch()
            t_eval = time.perf_counter() - t_eval0
            if save_val and epoch % 10 == 0:
                self._save_val_predictions(epoch)
            for s in self.segmentators:
                s.scheduler_step()
            self.cot_scheduler.step()
            self.adv_scheduler.step()

            check_finite_losses({"sup": m["sup_loss"], "jsd": m["jsd_loss"],
                                 "adv": m["adv_loss"]}, epoch, self.nan_policy)
            row = {"epoch": epoch,
                   **{f"val_mIoU_{s}": val[s]["Mean_IoU"] for s in range(self.K)},
                   **{f"val_acc_{s}": val[s]["Overall_Acc"] for s in range(self.K)},
                   **{f"sup_loss_{s}": float(m["sup_loss"].mean(0)[s]) for s in range(self.K)},
                   "jsd_loss": float(np.mean(m["jsd_loss"])),
                   "adv_loss": float(np.mean(m["adv_loss"])),
                   "images_per_sec": (idx_lab.size + idx_unlab.size) / max(t_train, 1e-9),
                   "t_train": t_train, "t_eval": t_eval}
            records.append(row)
            write_csv(self.save_dir / self.metricname, records)
            current = np.array([val[s]["Mean_IoU"] for s in range(self.K)])
            self.checkpoint(current, epoch)
            print(f">> city epoch {epoch}: mIoU "
                  + " ".join(f"S{s}:{current[s]:.4f}" for s in range(self.K))
                  + f" [{time.perf_counter() - t0:.1f}s]", flush=True)
        return records

    def _val_batches(self) -> np.ndarray:
        return self.val_batcher.epoch(np.random.RandomState(0))

    def _eval_epoch(self) -> List[Dict]:
        out = []
        for step in self.eval_steps:
            hist = np.zeros((self.C, self.C), np.int64)
            for idx in self._val_batches():
                hist += step(self.val_dev.img, self.val_dev.gt, idx).cpu().numpy()
            out.append(iou_from_confusion(hist))
        return out

    def _save_val_predictions(self, epoch: int) -> None:
        """Every model's val class maps as PNGs under
        save_dir/iter{epoch}/eval/{model}/."""
        for s, step in enumerate(self.pred_steps):
            for idx in self._val_batches():
                preds = step(self.val_dev.img, self.val_dev.gt, idx)
                save_images(preds, [self.val_dev.filenames[i] for i in idx],
                            self.save_dir, "eval", epoch, seg_num=str(s))

    def checkpoint(self, metric: np.ndarray, epoch: int) -> None:
        """``last_{i}.ckpt`` every epoch and ``best_{i}.ckpt`` on a better
        mean IoU, in dct_tpu's city payload: weights, configs and the LR
        epoch (``epoch`` + 1), without Adam state."""
        for i, seg in enumerate(self.segmentators):
            seg_sd = seg.state_dict
            seg_sd.pop("optim_state_dict")
            seg_sd["scheduler_state_dict"] = {"epoch": epoch + 1}
            payload = {"segmentator": seg_sd, "best_score": float(self.best_scores[i]),
                       "best_epoch": epoch}
            save_checkpoint(self.save_dir / f"last_{i}.ckpt", payload)
            if metric[i] > self.best_scores[i]:
                self.best_scores[i] = float(metric[i])
                save_checkpoint(self.save_dir / f"best_{i}.ckpt",
                                {**payload, "best_score": float(metric[i])})

    def _load_checkpoint(self, checkpoint_dir: str) -> None:
        paths = sorted(Path(checkpoint_dir).glob("last_*.ckpt"))
        assert paths, f"no last_*.ckpt under {checkpoint_dir}"
        for i, p in enumerate(paths):
            sd = load_checkpoint(p)
            seg = self.segmentators[i]
            seg.load_state_dict(sd["segmentator"])
            seg.optimizer = build_optimizer(seg.optim_dict, seg.net.parameters())
            self.best_scores[i] = sd["best_score"]
            self.start_epoch = int(sd["best_epoch"]) + 1


class TrainerCity:
    """The supervised Cityscapes baseline: a 1-model CoTrainerCity with both
    semi-supervised terms off. As in dct_tpu, ``start_training`` ignores its
    arguments, ``save_val`` included."""

    def __init__(self, segmentator: Segmentator, labeled_dataset, unlabeled_dataset,
                 val_dataset, criterion, **kwargs) -> None:
        self.inner = CoTrainerCity([segmentator], [labeled_dataset], unlabeled_dataset,
                                   val_dataset, {"sup": criterion, "jsd": None, "adv": None},
                                   **kwargs)

    def start_training(self, **_ignored) -> List[dict]:
        return self.inner.start_training(train_jsd=False, train_adv=False)
