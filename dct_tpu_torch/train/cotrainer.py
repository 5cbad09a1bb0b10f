"""CoTrainer: K-model deep co-training around the step of ``steps.py``
(``dct_tpu/train/cotrainer.py``).

K segmentators (shared architecture), K labeled streams, one unlabeled and
one patient-grouped val stream. Per iteration: supervised CE per model, JSD
across all models on the unlabeled batch, FGSM diversity on a model pair.
Per epoch: λ_cot / λ_adv from their schedulers and lr from the
Segmentator's schedule (schedulers step after eval), the per-patient val
dice, one CSV row, per-model best/last checkpoints keyed on mean foreground
3D val dice, and the optimizer state for an exact resume.

Host draws follow dct_tpu's order, so batch indices and pairs equal
dct_tpu's for the same datasets and seed: at construction each labeled
batcher, then the unlabeled one, draws its first permutation from the
trainer's ``RandomState``; per epoch each labeled batcher takes T batches,
then the unlabeled one, then one ``rs.choice(K, 2)`` pair per iteration
(drawn for K=2 too, where the step always takes (0, 1)). The labeled and
unlabeled streams live in one uint8 array on the device, indexed with
per-stream offsets as in dct_tpu. Epoch e's augmentation draws come from a
torch generator seeded with ``fold_in(seed, e)``, so a resumed run draws
what an unbroken run would have drawn.

With a ``mesh`` (``parallel.mesh``) the trainer runs on every rank of a
``torch.distributed`` group: a data-only mesh runs the data-parallel step
(``steps.make_cotrain_epoch(mesh=)``, equal to the single-process step), a
model axis above 1 the model-parallel one (``parallel.shard_cotrain``).
Every rank makes the same host draws and takes its slice
(``place_batches``). After each epoch of the model-parallel step rank 0
receives the models it does not own from their owners; rank 0 alone
evaluates, prints and writes files. A resume loads the same files on
every rank.
"""
from __future__ import annotations

import math
import pickle
import time
from pathlib import Path
from typing import Callable, Dict, List, Optional, Union

import numpy as np
import torch

from ..checkpoint import load_checkpoint, save_checkpoint
from ..data.dataset import MedicalImageDataset
from ..data.pipeline import DeviceDataset, InfiniteBatcher, PatientBuckets
from ..models.segmentator import Segmentator
from ..optim import build_optimizer
from ..parallel.mesh import gather_models, is_main, place_batches
from ..parallel.shard_cotrain import make_shard_cotrain_epoch
from ..schedules import get_weight_scheduler
from ..utils.convert import load_optim_state, stack_optim_states, unstack_optim_state
from ..utils.general import check_finite_losses, save_images
from ..utils.logging import RateMeter, ScalarWriter, resume_records, write_metrics_csv
from .steps import (make_cotrain_epoch, make_eval_all_models_step,
                    make_eval_patient_step)
from .trainer import (DEFAULT_GRP_REGEX, check_device, epoch_generator, make_save_dir,
                      write_csv)

ITERS_PER_EPOCH = 300


class CoTrainer:
    def __init__(self, segmentators: List[Segmentator],
                 labeled_datasets: List[MedicalImageDataset],
                 unlabeled_dataset: MedicalImageDataset,
                 val_dataset: MedicalImageDataset,
                 criterions: Dict[str, Callable],
                 max_epoch: int = 100,
                 save_dir: Union[str, Path] = "tmp",
                 axises: Optional[List[int]] = None,
                 checkpoint: Optional[str] = None,
                 metricname: str = "metrics.csv",
                 cot_scheduler_dict: Optional[dict] = None,
                 adv_scheduler_dict: Optional[dict] = None,
                 adv_training_dict: Optional[dict] = None,
                 batch_size: int = 4,
                 unlab_batch_size: Optional[int] = None,
                 grp_regex: str = DEFAULT_GRP_REGEX,
                 iters_per_epoch: int = ITERS_PER_EPOCH,
                 seed: int = 1234,
                 nan_policy: str = "warn",
                 whole_config: Optional[dict] = None,
                 fuse_forward: bool = True,
                 adv_dtype: Optional[str] = None,
                 device=None,
                 mesh=None) -> None:
        assert len(segmentators) == len(labeled_datasets)
        assert len(segmentators) >= 1
        assert len({id(s) for s in segmentators}) == len(segmentators)
        assert set(criterions.keys()) == {"sup", "jsd", "adv"}, criterions.keys()
        self.device = check_device(device, segmentators)

        self.K = len(segmentators)
        self.segmentators = segmentators
        self.seg = segmentators[0]
        self.criterions = criterions
        self.max_epoch = max_epoch
        self.is_main = is_main()
        self.save_dir = make_save_dir(save_dir, whole_config, "config.yml",
                                      write=self.is_main)
        self.rate_meter = RateMeter()     # built, and not read, as in dct_tpu
        self.C = self.seg.arch_dict["num_classes"]
        self.axises = axises if axises is not None else [1, 2, 3]
        self.metricname = metricname
        self.iters_per_epoch = iters_per_epoch
        self.nan_policy = nan_policy
        self.batch_size = batch_size
        self.unlab_batch_size = unlab_batch_size or batch_size
        self.mesh = mesh
        self.sharded = mesh is not None and mesh.shape["model"] > 1
        if mesh is not None:
            assert self.K % mesh.shape["model"] == 0, \
                f"K={self.K} not divisible by mesh model axis {mesh.shape['model']}"
            assert self.batch_size % mesh.shape["data"] == 0 and \
                self.unlab_batch_size % mesh.shape["data"] == 0, \
                (self.batch_size, self.unlab_batch_size, mesh.shape)
        self.best_scores = np.zeros(self.K)
        self.start_epoch = 0
        self.seed = seed
        self.rs = np.random.RandomState(seed)

        self.cot_scheduler = get_weight_scheduler(
            cot_scheduler_dict or {"name": "ConstantScheduler", "begin_epoch": 0,
                                   "max_value": 0.0})
        self.adv_scheduler = get_weight_scheduler(
            adv_scheduler_dict or {"name": "ConstantScheduler", "begin_epoch": 0,
                                   "max_value": 0.0})
        self.adv_training_dict = adv_training_dict or {}
        self.eps_fgsm = float(self.adv_training_dict.get("eplision", 0.03))
        # the fused two-group forward (taken when train_jsd and B == Bu) and
        # the FGSM segment's own dtype: Trainer.fuse_forward, Trainer.adv_dtype
        self.fuse_forward = bool(fuse_forward)
        self.adv_dtype = adv_dtype

        # one uint8 array on the device: the K labeled streams, then the
        # unlabeled one; a stream's batch indices are offset into it
        streams = list(labeled_datasets) + [unlabeled_dataset]
        self._offsets = np.cumsum([0] + [len(d) for d in streams[:-1]]).tolist()
        self._stream_names = [d.filenames for d in streams]
        self._img_cat = torch.from_numpy(
            np.concatenate([d.data["img"] for d in streams])).to(self.device)
        self._gt_cat = torch.from_numpy(
            np.concatenate([d.data["gt"] for d in streams])).to(self.device)
        self.val_set = val_dataset
        self.val_dev = DeviceDataset(val_dataset, self.device)
        self.lab_batchers = [InfiniteBatcher(len(d), batch_size, self.rs)
                             for d in labeled_datasets]
        self.unlab_batcher = InfiniteBatcher(len(unlabeled_dataset),
                                             self.unlab_batch_size, self.rs)
        self.val_buckets = PatientBuckets(val_dataset, grp_regex)
        self.eval_steps = [make_eval_patient_step(s, self.C) for s in segmentators]
        self.eval_all_models = make_eval_all_models_step(segmentators, self.C)

        if checkpoint is not None:
            self._load_checkpoint(checkpoint)

    def start_training(self, train_jsd: bool = False, train_adv: bool = False,
                       save_train: bool = False, save_val: bool = False,
                       augment_labeled_data: bool = False,
                       augment_unlabeled_data: bool = False) -> List[dict]:
        """Train from ``start_epoch`` to ``max_epoch``; returns the CSV's rows."""
        if self.sharded:
            # dct_tpu's shard path takes the labeled flag for both streams
            epoch_fn = make_shard_cotrain_epoch(
                self.segmentators, self.mesh, self.C, self.criterions["sup"],
                train_jsd, train_adv, augment_labeled_data, self.eps_fgsm,
                fuse_forward=self.fuse_forward, adv_dtype=self.adv_dtype)
        else:
            epoch_fn = make_cotrain_epoch(
                self.segmentators, self.C, self.criterions["sup"], train_jsd,
                train_adv, augment_labeled_data, augment_unlabeled_data, self.eps_fgsm,
                fuse_forward=self.fuse_forward, adv_dtype=self.adv_dtype,
                mesh=self.mesh)
        records = resume_records(self.save_dir / self.metricname, self.start_epoch) \
            if self.is_main else []
        self.writer = ScalarWriter(self.save_dir) if self.is_main else None
        try:
            for epoch in range(self.start_epoch, self.max_epoch):
                self._run_epoch(epoch, epoch_fn, records, train_jsd, train_adv,
                                save_train, save_val)
        finally:
            if self.writer is not None:
                self.writer.close()
        return records

    def _run_epoch(self, epoch, epoch_fn, records, train_jsd, train_adv,
                   save_train, save_val) -> None:
        t0 = time.perf_counter()
        train_m = self._train_epoch(epoch, epoch_fn, train_jsd, train_adv)
        check_finite_losses({"sup": train_m["sup_loss"],
                             "jsd": train_m["jsd_loss"],
                             "adv": train_m["adv_loss"]},
                            epoch, self.nan_policy)
        if self.sharded:
            gather_models(self.segmentators, self.mesh)
        if not self.is_main:
            self._scheduler_step()
            return
        if save_train:
            self._save_train_predictions(epoch, train_jsd)
        t_eval0 = time.perf_counter()
        val_m = self._eval_epoch(epoch, save_val)
        t_eval = time.perf_counter() - t_eval0
        self._scheduler_step()
        elapsed = time.perf_counter() - t0

        row = {"epoch": epoch}
        for s in range(self.K):
            for i in self.axises:
                row[f"tra_dice_{s}_{i}"] = float(train_m["lab_dice"][s][i])
                row[f"val_dice_{s}_{i}"] = float(val_m["dice2d"][s][i])
                row[f"val_batch_dice_{s}_{i}"] = float(val_m["dice3d"][s][i])
            row[f"sup_loss_{s}"] = float(train_m["sup_loss"][s])
        row["jsd_loss"] = train_m["jsd_loss"]
        row["adv_loss"] = train_m["adv_loss"]
        row["images_per_sec"] = train_m["n_images"] / max(train_m["train_time"], 1e-9)
        row["t_train"] = train_m["train_time"]
        row["t_eval"] = t_eval
        records.append(row)
        self._write_metrics(records)

        for s in range(self.K):
            self.writer.add_scalars(
                f"val/S{s}", {f"DSC{i}": float(val_m["dice3d"][s][i])
                              for i in self.axises}, epoch)
            self.writer.add_scalar(f"loss/sup_{s}", float(train_m["sup_loss"][s]), epoch)
        self.writer.add_scalar("loss/jsd", train_m["jsd_loss"], epoch)
        self.writer.add_scalar("loss/adv", train_m["adv_loss"], epoch)
        self.writer.add_scalar("perf/images_per_sec", row["images_per_sec"], epoch)

        current = np.array([np.mean([val_m["dice3d"][s][i] for i in self.axises])
                            for s in range(self.K)])
        self.checkpoint(current, epoch)
        print(f">> epoch {epoch}: val fg 3D dice "
              + " ".join(f"S{s}:{current[s]:.4f}" for s in range(self.K))
              + f"  jsd {train_m['jsd_loss']:.4f} adv {train_m['adv_loss']:.4f}"
              + f"  [{elapsed:.1f}s = train {train_m['train_time']:.1f}"
              + f" + eval {t_eval:.1f} + host "
              + f"{elapsed - train_m['train_time'] - t_eval:.1f}; "
              + f"{row['images_per_sec']:.0f} img/s]", flush=True)

    def _write_metrics(self, records: List[dict]) -> None:
        """metrics.csv (all columns), metrics_{s}.csv (model s's columns)
        and the val dice histories as .npy."""
        columns = write_csv(self.save_dir / self.metricname, records)
        for s in range(self.K):
            cols = [c for c in columns if c.endswith(tuple(
                f"_{s}_{i}" for i in self.axises)) or c == f"sup_loss_{s}"]
            write_metrics_csv(self.save_dir / self.metricname.replace(
                ".csv", f"_{s}.csv"), records, cols)

        def history(cols):
            return np.array([[r.get(c, math.nan) for c in cols] for r in records])
        np.save(self.save_dir / "val_batch_dice.npy",
                history([c for c in columns if "val_batch_dice" in c]))
        np.save(self.save_dir / "val_dice.npy",
                history([c for c in columns if c.startswith("val_dice")]))

    def _train_epoch(self, epoch: int, epoch_fn, train_jsd, train_adv) -> Dict:
        T = self.iters_per_epoch
        idx_lab = np.stack([off + b.take(T) for off, b in
                            zip(self._offsets[:-1], self.lab_batchers)], axis=1
                           ).astype(np.int32)                      # (T,K,B)
        idx_unlab = (self._offsets[-1]
                     + self.unlab_batcher.take(T)).astype(np.int32)  # (T,Bu)
        pairs = np.stack([np.sort(self.rs.choice(self.K, 2, replace=self.K < 2))
                          for _ in range(T)]).astype(np.int32)
        generator = epoch_generator(self.device, self.seed, epoch)
        lr = self.seg.lr(epoch)
        lam_cot = self.cot_scheduler.value
        lam_adv = self.adv_scheduler.value

        n_images = idx_lab.size + (idx_unlab.size if (train_jsd or train_adv) else 0)
        if self.mesh is not None:
            idx_lab, idx_unlab, pairs = place_batches(self.mesh, idx_lab, idx_unlab, pairs)

        t0 = time.perf_counter()
        metrics = epoch_fn(self._img_cat, self._gt_cat, idx_lab, idx_unlab,
                           pairs, generator, lr, lam_cot, lam_adv)
        # the device runs asynchronously: the fetch below waits for it, so
        # the clock stops after it
        m = {k: v.cpu().numpy() for k, v in metrics.items()}
        train_time = time.perf_counter() - t0
        # the model-parallel adv slots hold KL / K_local: their sum over K is
        # the iteration's KL
        adv = np.sum(m["adv_loss"], 1) if self.sharded else m["adv_loss"]
        return {"lab_dice": m["lab_dice"].transpose(1, 0, 2, 3).reshape(
                    self.K, -1, self.C).mean(1),
                "sup_loss": m["sup_loss"].mean(0),
                "jsd_loss": float(np.mean(m["jsd_loss"])),
                "adv_loss": float(np.mean(adv)),
                "n_images": n_images, "train_time": train_time}

    _DUMP_CHUNK = 16   # padded slice-chunk length for whole-stream dumps

    def _dump_stream(self, stream: int, epoch: int, mode: str, models) -> None:
        """PNG class maps of one data stream by the given models, with the
        epoch's final weights, in padded chunks of eval-mode forwards."""
        names = self._stream_names[stream]
        off, n, L = self._offsets[stream], len(names), self._DUMP_CHUNK
        for start in range(0, n, L):
            idx = np.arange(start, start + L)
            mask = idx < n
            idx = np.minimum(idx, n - 1)
            for i in models:
                out = self.eval_steps[i](self._img_cat, self._gt_cat, off + idx, mask)
                preds = out["pred"].cpu().numpy()[mask]
                save_images(preds, [names[j] for j in idx[mask]], self.save_dir,
                            mode, iter=epoch, seg_num=str(i))

    def _save_train_predictions(self, epoch: int, train_jsd: bool) -> None:
        """``save_train``: model i dumps its own labeled stream (mode
        'train'); with the JSD term on, every model dumps the unlabeled
        stream (mode 'unlab')."""
        for i in range(self.K):
            self._dump_stream(i, epoch, "train", models=[i])
        if train_jsd:
            self._dump_stream(self.K, epoch, "unlab", models=range(self.K))

    def _eval_epoch(self, epoch: int, save: bool = False) -> Dict:
        if save:
            for p in range(len(self.val_buckets)):
                idx = self.val_buckets.indices[p]
                mask = self.val_buckets.mask[p]
                for i, step in enumerate(self.eval_steps):
                    out = step(self.val_dev.img, self.val_dev.gt, idx, mask)
                    preds = out["pred"].cpu().numpy()[mask]
                    names = [self.val_set.filenames[j] for j in idx[mask]]
                    save_images(preds, names, self.save_dir, "eval",
                                iter=epoch, seg_num=str(i))
        out = self.eval_all_models(self.val_dev.img, self.val_dev.gt,
                                   self.val_buckets.indices, self.val_buckets.mask)
        d2 = out["dice2d"].cpu().numpy()            # (P,K,L,C)
        mask = self.val_buckets.mask                # (P,L) bool
        dice2d = np.stack([d2[:, s][mask].mean(0) for s in range(self.K)])
        dice3d = out["dice3d"].cpu().numpy().mean(0)  # (P,K,C) → (K,C)
        return {"dice2d": dice2d, "dice3d": dice3d}

    def _scheduler_step(self) -> None:
        for s in self.segmentators:
            s.scheduler_step()
        self.cot_scheduler.step()
        self.adv_scheduler.step()

    def checkpoint(self, metric: np.ndarray, epoch: int) -> None:
        """Per-model best/last checkpoints in dct_tpu's payload layout, and
        every model's optimizer state, stacked over K in dct_tpu's tree
        layout (flat with ``Optim.fused``), in ``opt_state.ckpt``. Called
        after the epoch's scheduler step, so each Segmentator's epoch is
        ``epoch + 1``."""
        opt_states = []
        for i, seg in enumerate(self.segmentators):
            seg_sd = seg.state_dict
            opt_states.append(seg_sd.pop("optim_state_dict"))
            payload = {"segmentator": seg_sd,
                       "best_score": float(self.best_scores[i]),
                       "best_epoch": epoch,
                       "cot_scheduler": self.cot_scheduler.state_dict(),
                       "adv_scheduler": self.adv_scheduler.state_dict()}
            save_checkpoint(self.save_dir / f"last_{i}.ckpt", payload)
            if metric[i] > self.best_scores[i]:
                self.best_scores[i] = float(metric[i])
                payload = {**payload, "best_score": float(metric[i])}
                save_checkpoint(self.save_dir / f"best_{i}.ckpt", payload)
        save_checkpoint(self.save_dir / "opt_state.ckpt",
                        {"opt_state": stack_optim_states(
                            opt_states, self.segmentators[0].net,
                            self.segmentators[0].optim_dict)})

    def _load_checkpoint(self, checkpoint_dir: str) -> None:
        paths = sorted(Path(checkpoint_dir).glob("last_*.ckpt"))
        assert paths, f"no last_*.ckpt under {checkpoint_dir}"
        for i, p in enumerate(paths):
            sd = load_checkpoint(p)
            self.segmentators[i].load_state_dict(sd["segmentator"])
            self.best_scores[i] = sd["best_score"]
            self.start_epoch = int(sd["best_epoch"]) + 1
            self.cot_scheduler.load_state_dict(sd["cot_scheduler"])
            self.adv_scheduler.load_state_dict(sd["adv_scheduler"])
            self.segmentators[i].epoch = self.start_epoch
            if self.is_main:
                print(f">>> {p} loaded (best {self.best_scores[i]:.3f})")
        opt_path = Path(checkpoint_dir) / "opt_state.ckpt"
        if not opt_path.exists():
            return
        try:
            seg0 = self.segmentators[0]
            states = unstack_optim_state(load_checkpoint(opt_path)["opt_state"], self.K,
                                         seg0.net, seg0.optim_dict)
            per_leaf = {**seg0.optim_dict, "fused": False}   # unstacked is per-leaf
            for seg, st in zip(self.segmentators, states):
                load_optim_state(seg.optimizer, seg.net, st, per_leaf)
        except (pickle.UnpicklingError, EOFError, KeyError, TypeError,
                ValueError) as e:
            # a truncated file, or a state this bridge does not map (another
            # optimizer or architecture, the fused layout under a per-leaf
            # config or the reverse): the optimizers start afresh, as
            # dct_tpu does with an unreadable file
            for seg in self.segmentators:
                seg.optimizer = build_optimizer(seg.optim_dict, seg.net.parameters())
            if self.is_main:
                print(f">>> opt_state.ckpt unreadable ({e}); reinitializing optimizer")
