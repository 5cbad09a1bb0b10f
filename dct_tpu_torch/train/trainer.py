"""Supervised Trainer: one ENet, CE on the whole train folder
(``dct_tpu/train/trainer.py``).

Per epoch: one shuffled, drop-last pass over the train set (batch indices
from the trainer's ``RandomState``, one permutation an epoch, as dct_tpu
draws them; augmentation draws from a torch generator seeded with
``fold_in(seed, epoch)``), then the per-patient val dice, one CSV row in
dct_tpu's columns, the val/train dice histories as .npy, and ``last.ckpt``
plus ``best.ckpt`` keyed on mean foreground 2D val dice. A checkpoint
resumes the weights, the optimizer, the LR epoch and the best score.

With a data-only ``mesh`` (``parallel.mesh``) every rank makes the same
host draws, trains on its data chunk of each batch (``dp_shard_idx``) the
share of the data-parallel step (``steps.make_supervised_epoch(mesh=)``),
and rank 0 alone evaluates, prints and writes files, as in the
co-training trainer.

The helpers at the bottom are shared with the VAT and Mean-Teacher
trainers.
"""
from __future__ import annotations

import time
from pathlib import Path
from typing import Callable, Dict, List, Optional, Union

import numpy as np
import torch

from .. import ModelMode, resolve_device
from ..checkpoint import load_checkpoint, save_checkpoint
from ..config import save_yaml
from ..data.dataset import MedicalImageDataset
from ..data.pipeline import DeviceDataset, EpochBatcher, PatientBuckets
from ..models.segmentator import Segmentator
from ..parallel.mesh import dp_shard_idx, is_main
from ..utils.general import check_finite_losses, fold_in, save_images
from ..utils.logging import resume_records, write_metrics_csv
from .steps import make_eval_all_step, make_eval_patient_step, make_supervised_epoch

# patient id of an ACDC slice stem
DEFAULT_GRP_REGEX = r"(patient\d+_\d+)_\d+"


class Trainer:
    def __init__(self, segmentator: Segmentator,
                 datasets: Dict[str, MedicalImageDataset],
                 criterion: Callable,
                 max_epoch: int = 100,
                 save_dir: Union[str, Path] = "tmp",
                 axises: Optional[List[int]] = None,
                 checkpoint: Optional[str] = None,
                 metricname: str = "metrics.csv",
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
        self.axises = axises if axises is not None else list(range(1, self.C))
        self.metricname = metricname
        self.batch_size = batch_size
        self.best_score = -1.0
        self.start_epoch = 0
        self.seed = seed
        self.rs = np.random.RandomState(seed)
        self.nan_policy = nan_policy

        self.train_set = datasets["train"]
        self.val_set = datasets["val"]
        self.train_dev = DeviceDataset(self.train_set, self.device)
        self.val_dev = DeviceDataset(self.val_set, self.device)
        self.batcher = EpochBatcher(len(self.train_set), batch_size)
        self.val_buckets = PatientBuckets(self.val_set, grp_regex)
        self.eval_step = make_eval_patient_step(segmentator, self.C)
        self.eval_all = make_eval_all_step(segmentator, self.C)

        if checkpoint is not None:
            self._load_checkpoint(checkpoint)

    def start_training(self, save_train: bool = False, save_val: bool = False,
                       augment_labeled_data: bool = False) -> List[dict]:
        """Train from ``start_epoch`` to ``max_epoch``; returns the CSV's
        rows. ``save_train`` is accepted and unused, as in dct_tpu."""
        epoch_fn = make_supervised_epoch(self.segmentator, self.criterion, self.C,
                                         augment_labeled_data, mesh=self.mesh)
        records = resume_records(self.save_dir / self.metricname, self.start_epoch) \
            if self.is_main else []
        for epoch in range(self.start_epoch, self.max_epoch):
            t0 = time.perf_counter()
            train_m = self._train_epoch(epoch, epoch_fn)
            check_finite_losses({"train": train_m["loss"]}, epoch, self.nan_policy)
            if not self.is_main:
                self.segmentator.scheduler_step()
                continue
            t_eval0 = time.perf_counter()
            val_m = self._eval_epoch(epoch, save_val)
            t_eval = time.perf_counter() - t_eval0
            self.segmentator.scheduler_step()
            step_time = time.perf_counter() - t0

            row = {"epoch": epoch,
                   **{f"train_dice_{i}": train_m["dice_per_class"][i] for i in self.axises},
                   **{f"val_dice_{i}": val_m["dice2d"][i] for i in self.axises},
                   **{f"val_batch_dice_{i}": val_m["dice3d"][i] for i in self.axises},
                   "train_loss": train_m["loss"],
                   "val_loss": val_m["loss"],
                   "images_per_sec": train_m["n_images"] / max(train_m["train_time"], 1e-9),
                   "t_train": train_m["train_time"],
                   "t_eval": t_eval}
            records.append(row)
            columns = write_csv(self.save_dir / self.metricname, records)
            for name, prefix in (("val_dice.npy", "val_dice"), ("train_dice.npy", "train_dice")):
                np.save(self.save_dir / name,
                        np.array([[r[c] for c in columns if prefix in c] for r in records]))

            current = float(np.mean([val_m["dice2d"][i] for i in self.axises]))
            self.checkpoint(current, epoch)
            print(f">> epoch {epoch}: val fg 2D dice {current:.4f}  "
                  f"(3D {np.mean([val_m['dice3d'][i] for i in self.axises]):.4f})  "
                  f"loss {val_m['loss']:.4f}  [{step_time:.1f}s]", flush=True)
        return records

    def draw_indices(self) -> np.ndarray:
        """The epoch's (T,B) batch indices: one permutation of the train
        set from the trainer's ``RandomState``, cut to whole batches."""
        return self.batcher.epoch(self.rs)

    def _train_epoch(self, epoch: int, epoch_fn: Callable) -> Dict:
        idx = self.draw_indices()
        n_images = idx.size
        if self.mesh is not None:
            idx = dp_shard_idx(self.mesh, idx)
        generator = epoch_generator(self.device, self.seed, epoch)
        lr = self.segmentator.lr(epoch)
        t0 = time.perf_counter()
        metrics = epoch_fn(self.train_dev.img, self.train_dev.gt, idx, generator, lr)
        # the fetch waits for the device, so the clock stops after it
        m = {k: v.cpu().numpy() for k, v in metrics.items()}
        train_time = time.perf_counter() - t0
        return {"dice_per_class": m["dice"].reshape(-1, self.C).mean(0),
                "loss": float(np.mean(m["loss"])), "n_images": n_images,
                "train_time": train_time}

    def _eval_epoch(self, epoch: int, save: bool = False) -> Dict:
        if save:
            for p in range(len(self.val_buckets)):
                idx = self.val_buckets.indices[p]
                mask = self.val_buckets.mask[p]
                out = self.eval_step(self.val_dev.img, self.val_dev.gt, idx, mask)
                preds = out["pred"].cpu().numpy()[mask]
                names = [self.val_set.filenames[i] for i in idx[mask]]
                save_images(preds, names, self.save_dir,
                            ModelMode.EVAL.value.lower(), iter=epoch)
        return eval_dice(self.eval_all, self.val_dev, self.val_buckets)

    def checkpoint(self, metric: float, epoch: int, filename: str = "best.ckpt") -> None:
        """``last.ckpt`` every epoch, ``filename`` when ``metric`` beats the
        best score; payloads in dct_tpu's layout."""
        seg_sd = self.segmentator.state_dict
        save_checkpoint(self.save_dir / "last.ckpt",
                        {"segmentator": seg_sd, "best_score": self.best_score,
                         "best_epoch": epoch})
        if metric <= self.best_score:
            return
        self.best_score = metric
        save_checkpoint(self.save_dir / filename,
                        {"segmentator": seg_sd, "best_score": metric, "best_epoch": epoch})

    def _load_checkpoint(self, checkpoint: str) -> None:
        sd = load_checkpoint(checkpoint)
        self.segmentator.load_state_dict(sd["segmentator"])
        self.best_score = float(sd["best_score"])
        self.start_epoch = int(sd["best_epoch"]) + 1
        if self.is_main:
            print(f">>> {checkpoint} loaded. Best {self.best_score:.3f} "
                  f"@ epoch {sd['best_epoch']}")


def check_data_mesh(mesh, *batch_sizes):
    """A single-model trainer's mesh: data-only, every batch divisible
    into its data chunks."""
    if mesh is not None:
        assert mesh.shape["model"] == 1, "a single-model trainer takes a data-only mesh"
        for b in batch_sizes:
            assert b % mesh.shape["data"] == 0, (b, mesh.shape)
    return mesh


def check_device(device, segmentators: List[Segmentator]) -> torch.device:
    """The trainer's device; every segmentator must already live on it."""
    dev = resolve_device(device)
    for s in segmentators:
        if s.device != dev:
            raise ValueError(f"segmentator on {s.device}, trainer on {dev}")
    return dev


def make_save_dir(save_dir: Union[str, Path], whole_config: Optional[dict],
                  config_name: str, write: bool = True) -> Path:
    """Create the run directory and save the run's config in it (unless
    ``write`` is False: a rank other than 0 only names it)."""
    path = Path(save_dir)
    if write:
        path.mkdir(parents=True, exist_ok=True)
        if whole_config:
            save_yaml(whole_config, path / config_name)
    return path


def epoch_generator(device: torch.device, seed: int, epoch: int) -> torch.Generator:
    """Epoch ``epoch``'s augmentation and noise draws, the same in a resumed
    run as in an unbroken one."""
    return torch.Generator(device=device).manual_seed(fold_in(seed, epoch))


def concat_streams(labeled: MedicalImageDataset, unlabeled: MedicalImageDataset,
                   device: torch.device):
    """One uint8 (img, gt) pair on the device, labeled slices first: an
    unlabeled index is offset by ``len(labeled)``."""
    return tuple(torch.from_numpy(np.concatenate([labeled.data[k], unlabeled.data[k]])
                                  ).to(device) for k in ("img", "gt"))


def eval_dice(eval_all: Callable, val_dev: DeviceDataset,
              buckets: PatientBuckets) -> Dict:
    """Per-class val dice of one model: 2D over every valid slice, 3D over
    patients, and the mean masked CE."""
    out = eval_all(val_dev.img, val_dev.gt, buckets.indices, buckets.mask)
    return {"dice2d": out["dice2d"].cpu().numpy()[buckets.mask].mean(0),
            "dice3d": out["dice3d"].cpu().numpy().mean(0),
            "loss": float(out["loss"].mean())}


def write_csv(path: Path, records: List[dict]) -> List[str]:
    """The metrics CSV of all columns in first-seen order; returns them."""
    columns = list(dict.fromkeys(k for r in records for k in r if k != "epoch"))
    write_metrics_csv(path, records, columns)
    return columns
