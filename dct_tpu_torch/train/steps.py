"""The supervised epoch (``dct_tpu/train/steps.py:make_supervised_epoch``),
the K-model co-training epoch (``make_cotrain_epoch``, with its fused
two-group forward and ``adv_dtype``), the per-patient eval steps
(``make_eval_patient_step``, ``make_eval_all_step``,
``make_eval_all_models_step``) and the ensemble evaluation
(``make_summary_step``).

A supervised iteration gathers its batch, warps it (nearest, image and
labels together) when augmenting, runs one train-mode forward (with
dropout, for an arch that has it), and steps the optimizer on the loss.

One iteration, in dct_tpu's order:

1. gather the K labeled batches and the shared unlabeled batch from the
   device-resident uint8 dataset, normalise, and warp each image with its
   own affine theta (one merged gather + warp over all K·B+Bu images, the
   thetas ordered as dct_tpu orders them: K labeled streams, then the
   unlabeled one);
2. forward each model on its labeled batch → supervised loss per model;
3. forward each model on the unlabeled batch → JSD across models;
4. FGSM: model b's gradient with respect to its *input only*
   (``torch.autograd.grad``; no parameter gradient) on its labeled batch
   concatenated with the unlabeled one — the unlabeled rows labeled with
   b's own argmax — steps the input by ε·sign; model a forwards the result,
   scored by KL against b's detached prediction;
5. backpropagate sup + λ_cot·JSD + λ_adv·KL once and step each model's Adam.

With ``fuse_forward`` (the default, as in dct_tpu; taken when the JSD term
is on, B == Bu and the arch has a BatchNorm momentum), steps 2 and 3 are
one forward per model over its labeled batch stacked on the unlabeled one
(2B images): the convolutions and the pool kernels run once over both,
and BatchNorm normalises each half with its own statistics and updates
the running ones labeled first, then unlabeled (``layers.BatchNorm``), so
the result equals the unfused step's up to float reassociation.
``adv_dtype`` runs the FGSM segment (the generation forward, its input
gradient, the sign step and the adversarial forward) in its own dtype;
the main pass keeps the arch's ``compute_dtype``.

All forwards run BatchNorm in train mode, so running statistics update in
dct_tpu's order: labeled per model, unlabeled, FGSM generation on model b,
adversarial forward on model a. For K=2 the pair is always (a, b) = (0, 1).
Per-iteration metrics stay on the device and are stacked once per epoch.

The eval steps run each model in eval mode (running BatchNorm statistics,
so a patient's padded slices change none of its valid ones) on one padded
patient bucket at a time, under ``torch.inference_mode``; dct_tpu maps over
patients and vmaps over models in one jit call. Padded slices enter the
forward as in dct_tpu and are masked out of every dice and loss.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional, Sequence

import numpy as np
import torch

from ..adversarial import fgsm
from ..data.augment import augment_batch_with_thetas, sample_aug_thetas
from ..data.pipeline import gather_augment_u8, normalize_gather
from ..losses import jsd_2d, kl_div_2d
from ..models.segmentator import Segmentator, as_dtype
from ..optim import set_lr
from ..parallel.data_parallel import DataShard
from ..utils.general import class2one_hot, dice_coef, probs2one_hot


def _masked_ce(logits: torch.Tensor, gt: torch.Tensor, mask: torch.Tensor,
               weight: Optional[torch.Tensor] = None) -> torch.Tensor:
    """CE over the valid slices of a padded patient bucket: logits (L,H,W,C),
    gt (L,H,W), mask (L,) float; each pixel weighted by its class's entry
    of ``weight`` (C,) when given, the sum divided by the weights' sum."""
    logp = torch.log_softmax(logits, dim=-1)
    onehot = gt[..., None] == torch.arange(logits.shape[-1], device=gt.device)
    nll = -torch.sum(torch.where(onehot, logp, 0.0), dim=-1)
    if weight is None:
        w = torch.ones_like(nll)
    else:
        w = torch.sum(torch.where(onehot, weight.to(logits.dtype), 0.0), dim=-1)
    w = w * mask[:, None, None]
    return torch.sum(nll * w) / torch.clamp_min(torch.sum(w), 1e-12)


def _class_weight(loss_weight, device) -> Optional[torch.Tensor]:
    """The eval CE's class weights as a tensor on the device, made once when
    a step is built (None: unweighted)."""
    if loss_weight is None:
        return None
    return torch.as_tensor(loss_weight, dtype=torch.float32, device=device)


def _dice_rows(logits: torch.Tensor, gt: torch.Tensor, C: int) -> torch.Tensor:
    """(B,C) hard 2D dice rows, on the device."""
    pred_oh = probs2one_hot(torch.softmax(logits, dim=-1))
    return dice_coef(class2one_hot(gt, C), pred_oh)


def make_supervised_epoch(seg: Segmentator, loss_fn: Callable, C: int,
                          augment: bool, mesh=None) -> Callable:
    """``epoch(img_u8, gt_u8, idx (T,B), generator, lr, thetas=None)`` trains
    ``seg`` in place and returns {loss (T,), dice (T,B,C)} on the device.
    ``thetas`` (T,B,2,3), when given, replaces the augmentation draws from
    ``generator``. An arch with dropout draws step t's masks from a
    generator seeded from ``generator``'s seed, t and 1 (dct_tpu's
    ``fold_in(k, 1)``); the only one of the port's training steps that
    passes one, with the Mean-Teacher student, as in dct_tpu. Given a
    data-only ``mesh``, ``idx`` is this rank's data chunk and the epoch is
    its share of the data-parallel epoch, as in ``make_cotrain_epoch``
    (``thetas`` in the global layout)."""
    shard = DataShard.of(mesh)
    seg.set_data_parallel(shard)
    loss_share = shard.loss(loss_fn)

    def epoch(img_u8: torch.Tensor, gt_u8: torch.Tensor, idx,
              generator: Optional[torch.Generator], lr: float,
              thetas: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
        idx = torch.as_tensor(np.asarray(idx), device=img_u8.device).long()
        set_lr(seg.optimizer, lr)
        steps = []
        for t in range(idx.shape[0]):
            if augment:
                th = shard_thetas(shard, generator, idx.shape[1], img_u8,
                                  None if thetas is None else thetas[t])
                img, gt = gather_augment_u8(img_u8, gt_u8, idx[t], generator, thetas=th)
            else:
                img, gt = normalize_gather(img_u8, gt_u8, idx[t])
            logits = seg.apply_train(
                img, dropout_generator=seg.dropout_generator(generator, t, 1))
            loss = loss_share(logits, gt)
            seg.optimizer.zero_grad(set_to_none=True)
            loss.backward()
            shard.sync_grads(seg.net.parameters())
            seg.optimizer.step()
            steps.append({"loss": shard.total(loss), "dice": _dice_rows(logits.detach(), gt, C)})
        out = {k: torch.stack([m[k] for m in steps]) for k in steps[0]}
        out["dice"] = shard.whole(out["dice"], dim=1)
        return out

    return epoch


def shard_thetas(shard: DataShard, generator, n_local: int, img_u8: torch.Tensor,
                 thetas: Optional[torch.Tensor] = None) -> Optional[torch.Tensor]:
    """One stream's augmentation thetas for this rank's ``n_local`` rows:
    ``thetas`` (the global batch's) or a draw for the global batch, cut to
    the rank's rows. In one process, ``thetas`` as given (None: the caller
    draws)."""
    if shard.n == 1:
        return thetas
    if thetas is None:
        return shard.draw(lambda n: sample_aug_thetas(generator, n, img_u8.shape[1],
                                                      img_u8.shape[2]), n_local)
    return thetas[shard.rows(n_local)]


def make_cotrain_epoch(segs: Sequence[Segmentator], C: int,
                       sup_loss: Callable, train_jsd: bool, train_adv: bool,
                       augment_labeled: bool, augment_unlabeled: bool,
                       eps_fgsm: float = 0.03, fuse_forward: bool = True,
                       adv_dtype=None, mesh=None) -> Callable:
    """Build the co-training epoch over the K models ``segs``.

    ``epoch(img_u8, gt_u8, idx_lab (T,K,B), idx_unlab (T,Bu), pairs (T,2)
    or None, generator, lr, lam_cot, lam_adv, thetas=None)`` trains the
    models in place and returns the metrics {sup_loss (T,K), jsd_loss (T,),
    adv_loss (T,), lab_dice (T,K,B,C), unlab_dice (T,K,Bu,C)} as tensors on
    the device. ``pairs`` (host ints) picks (a, b) per iteration for K>2.
    ``thetas`` (T, K·B+Bu, 2, 3), when given, replaces the augmentation
    draws from ``generator``. ``fuse_forward`` and ``adv_dtype`` (a dtype
    or its name) are dct_tpu's, as the module docstring says.

    Given a data-only ``mesh`` (``parallel.mesh``), the epoch is this
    rank's share of the data-parallel epoch, equal to the single-process
    one up to the order of reductions (``parallel/data_parallel.py``): it
    takes this rank's data chunk of the indices (``place_batches``), the
    thetas in the global layout (drawn for the global batch when not
    given), sets the models' BatchNorm to the global batch, sums the
    gradients over the data ranks, and returns the global metrics.
    """
    K = len(segs)
    adv_dtype = as_dtype(adv_dtype)
    if adv_dtype == segs[0].compute_dtype:
        adv_dtype = None
    if mesh is not None and mesh.shape["model"] > 1:
        raise ValueError("a model axis above 1 runs parallel.shard_cotrain")
    shard = DataShard.of(mesh)
    for s in segs:
        s.set_data_parallel(shard)
    sup_share = shard.loss(sup_loss)

    def one_step(img_u8, gt_u8, idx_l, idx_u, pair, generator, lam_cot,
                 lam_adv, th) -> Dict[str, torch.Tensor]:
        B, Bu = idx_l.shape[1], idx_u.shape[0]
        img_all, gt_all = normalize_gather(
            img_u8, gt_u8, torch.cat([idx_l.reshape(-1), idx_u]))
        if augment_labeled or augment_unlabeled:
            if th is None:
                th = sample_aug_thetas(generator, (K * B + Bu) * shard.n,
                                       img_u8.shape[1], img_u8.shape[2])
            if shard.n > 1:
                th = th[shard.stream_rows([B] * K + [Bu], range(K + 1)).to(th.device)]
            rows = slice(0 if augment_labeled else K * B,
                         None if augment_unlabeled else K * B)
            img_all[rows], gt_all[rows] = augment_batch_with_thetas(
                img_all[rows], gt_all[rows], th[rows].to(img_all.device))
        lab_img = img_all[:K * B].reshape((K, B) + img_all.shape[1:])
        lab_gt = gt_all[:K * B].reshape((K, B) + gt_all.shape[1:])
        unlab_img, unlab_gt = img_all[K * B:], gt_all[K * B:]

        zero = torch.zeros((), device=img_all.device)
        jsd_loss, adv_loss, unlab_logits = zero, zero, None
        if train_jsd and fused(B, Bu):
            # (1)+(2) fused: one two-group forward per model over its
            # labeled batch stacked on the unlabeled one
            both = [s.apply_train(torch.cat([lab_img[k], unlab_img]), groups=2)
                    for k, s in enumerate(segs)]
            lab_logits = [lg[:B] for lg in both]
            unlab_logits = [lg[B:] for lg in both]
        else:
            # (1) supervised, per model on its own labeled batch
            lab_logits = [segs[k].apply_train(lab_img[k]) for k in range(K)]
            if train_jsd:
                # (2) the unlabeled batch through every model
                unlab_logits = [s.apply_train(unlab_img) for s in segs]
        sup_each = torch.stack([sup_share(lab_logits[k], lab_gt[k])
                                for k in range(K)])
        total = sup_each.sum()
        if train_jsd:
            # JSD across models on the shared unlabeled batch
            probs = torch.stack([torch.softmax(lg, dim=-1) for lg in unlab_logits])
            jsd_loss = shard.mean(jsd_2d(probs))
            total = total + lam_cot * jsd_loss
        if train_adv:
            # (3) FGSM diversity: attack model b, feed the result to model a
            a, b = (0, 1) if K == 2 else (int(pair[0]), int(pair[1]))
            adv_img, _, real_probs = fgsm(
                segs[b], torch.cat([lab_img[b], unlab_img], dim=0), lab_gt[b],
                sup_share, eps_fgsm, dtype=adv_dtype)
            adv_logits = segs[a].apply_train(adv_img, dtype=adv_dtype)
            adv_loss = shard.mean(kl_div_2d(torch.softmax(adv_logits, dim=-1), real_probs))
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

        lab_dice = torch.stack([_dice_rows(lab_logits[k].detach(), lab_gt[k], C)
                                for k in range(K)])
        if unlab_logits is not None:
            unlab_dice = torch.stack([_dice_rows(lg.detach(), unlab_gt, C)
                                      for lg in unlab_logits])
        else:
            unlab_dice = torch.zeros((K, Bu, C), device=img_all.device)
        return {"sup_loss": sup_each.detach(), "jsd_loss": jsd_loss.detach(),
                "adv_loss": adv_loss.detach(), "lab_dice": lab_dice,
                "unlab_dice": unlab_dice}

    def fused(B: int, Bu: int) -> bool:
        """dct_tpu's condition for the two-group forward."""
        return fuse_forward and B == Bu and all(s.bn_momentum is not None for s in segs)

    def epoch(img_u8: torch.Tensor, gt_u8: torch.Tensor, idx_lab, idx_unlab,
              pairs, generator: Optional[torch.Generator], lr: float,
              lam_cot: float, lam_adv: float,
              thetas: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
        dev = img_u8.device
        idx_lab = torch.as_tensor(np.asarray(idx_lab), device=dev).long()
        idx_unlab = torch.as_tensor(np.asarray(idx_unlab), device=dev).long()
        if idx_lab.shape[1] != K:
            raise ValueError(f"idx_lab must be (T, K={K}, B), got {tuple(idx_lab.shape)}")
        if train_adv and K > 2 and pairs is None:
            raise ValueError("K > 2 needs the per-iteration pairs")
        for s in segs:
            set_lr(s.optimizer, lr)
        steps = [one_step(img_u8, gt_u8, idx_lab[t], idx_unlab[t],
                          None if pairs is None else pairs[t], generator,
                          lam_cot, lam_adv,
                          None if thetas is None else thetas[t])
                 for t in range(idx_lab.shape[0])]
        out = {k: torch.stack([m[k] for m in steps]) for k in steps[0]}
        for k in ("lab_dice", "unlab_dice"):          # rows (T, K, B, C)
            out[k] = shard.whole(out[k], dim=2)
        return out

    return epoch


def _map_dice(pred: torch.Tensor, gt_oh: torch.Tensor, m4: torch.Tensor, C: int):
    """Hard dice of class maps pred (..., L,H,W) against the masked one-hot
    gt (L,H,W,C): 2D (..., L,C) and 3D (..., C) over the valid slices."""
    pred_oh = class2one_hot(pred, C) * m4
    inter2 = torch.sum(gt_oh * pred_oh, dim=(-3, -2))
    sums2 = torch.sum(gt_oh, dim=(-3, -2)) + torch.sum(pred_oh, dim=(-3, -2))
    inter3 = torch.sum(inter2, dim=-2)
    sums3 = torch.sum(sums2, dim=-2)
    return (2 * inter2 + 1e-8) / (sums2 + 1e-8), (2 * inter3 + 1e-8) / (sums3 + 1e-8)


def _patient_metrics(logits: torch.Tensor, gt: torch.Tensor,
                     gt_oh: torch.Tensor, maskf: torch.Tensor,
                     weight: Optional[torch.Tensor] = None
                     ) -> Dict[str, torch.Tensor]:
    """dice2d (L,C), dice3d (C,) over the valid slices, masked CE."""
    loss = _masked_ce(logits, gt, maskf.to(logits.dtype), weight)
    pred = torch.argmax(torch.softmax(logits, dim=-1), dim=-1)
    dice2d, dice3d = _map_dice(pred, gt_oh, maskf[:, None, None, None], logits.shape[-1])
    return {"dice2d": dice2d, "dice3d": dice3d, "loss": loss}


def _bucket(img_u8, gt_u8, idx, mask, C):
    """Gather one patient bucket: (img (L,H,W,1), gt, one-hot gt × mask,
    mask as float)."""
    dev = img_u8.device
    idx = torch.as_tensor(np.asarray(idx), device=dev).long()
    maskf = torch.as_tensor(np.asarray(mask), device=dev).float()
    img, gt = normalize_gather(img_u8, gt_u8, idx)
    return img, gt, class2one_hot(gt, C) * maskf[:, None, None, None], maskf


def make_eval_patient_step(seg: Segmentator, C: int, loss_weight=None) -> Callable:
    """``step(img_u8, gt_u8, idx (L,), mask (L,))`` → per-slice 2D dice
    (L,C), whole-volume 3D dice (C,) over the valid slices, masked CE loss
    (class-weighted by ``loss_weight`` (C,) when given), argmax prediction
    map (L,H,W), as tensors on the device."""
    weight = _class_weight(loss_weight, seg.device)

    @torch.inference_mode()
    def step(img_u8, gt_u8, idx, mask) -> Dict[str, torch.Tensor]:
        img, gt, gt_oh, maskf = _bucket(img_u8, gt_u8, idx, mask, C)
        logits = seg.apply_eval(img)
        out = _patient_metrics(logits, gt, gt_oh, maskf, weight)
        out["pred"] = torch.argmax(logits, dim=-1)
        return out

    return step


def make_eval_all_step(seg: Segmentator, C: int, loss_weight=None) -> Callable:
    """One model × all patients: ``make_eval_all_models_step`` with the
    model axis dropped → {dice2d (P,L,C), dice3d (P,C), loss (P,)}."""
    step_all = make_eval_all_models_step([seg], C, loss_weight)

    def step(img_u8, gt_u8, indices, masks) -> Dict[str, torch.Tensor]:
        return {k: v[:, 0] for k, v in step_all(img_u8, gt_u8, indices, masks).items()}

    return step


def make_eval_all_models_step(segs: Sequence[Segmentator], C: int,
                              loss_weight=None) -> Callable:
    """All K models × all patients: ``step(img_u8, gt_u8, indices (P,L),
    masks (P,L))`` → {dice2d (P,K,L,C), dice3d (P,K,C), loss (P,K)} on the
    device, the loss class-weighted by ``loss_weight`` (C,) when given. Each
    patient's gather and one-hot gt are shared by the K models."""
    weight = _class_weight(loss_weight, segs[0].device)

    @torch.inference_mode()
    def step(img_u8, gt_u8, indices, masks) -> Dict[str, torch.Tensor]:
        per_patient = []
        for idx, mask in zip(np.asarray(indices), np.asarray(masks)):
            img, gt, gt_oh, maskf = _bucket(img_u8, gt_u8, idx, mask, C)
            per_model = [_patient_metrics(s.apply_eval(img), gt, gt_oh, maskf, weight)
                         for s in segs]
            per_patient.append({k: torch.stack([m[k] for m in per_model])
                                for k in per_model[0]})
        return {k: torch.stack([p[k] for p in per_patient]) for k in per_patient[0]}

    return step


def make_summary_step(segs: Sequence[Segmentator], C: int,
                      ensemble: str = "soft") -> Callable:
    """The ensemble evaluation of ``summary.py``: ``step(img_u8, gt_u8,
    indices (P,L), masks (P,L))`` → {pred (P,K,L,H,W) uint8, ens (P,L,H,W)
    uint8, dice2d (P,K,L,C), dice3d (P,K,C), ens_dice2d (P,L,C), ens_dice3d
    (P,C)} on the device. Each patient's bucket runs one eval forward per
    model; the model maps are the argmax of the softmax. The soft vote is
    the argmax of the mean probabilities, the hard vote the argmax of the
    per-class vote counts, a tie going to the smallest class id as in
    dct_tpu. The probabilities never leave the device."""
    if ensemble not in ("soft", "hard"):
        raise ValueError(f"ensemble must be 'soft' or 'hard', got {ensemble!r}")

    @torch.inference_mode()
    def step(img_u8, gt_u8, indices, masks) -> Dict[str, torch.Tensor]:
        per_patient = []
        for idx, mask in zip(np.asarray(indices), np.asarray(masks)):
            img, _, gt_oh, maskf = _bucket(img_u8, gt_u8, idx, mask, C)
            m4 = maskf[:, None, None, None]
            probs = torch.stack([torch.softmax(s.apply_eval(img), dim=-1) for s in segs])
            model_pred = torch.argmax(probs, dim=-1)                  # (K,L,H,W)
            if ensemble == "soft":
                ens_pred = torch.argmax(torch.mean(probs, dim=0), dim=-1)
            else:
                votes = torch.sum(class2one_hot(model_pred, C, torch.int32), dim=0)
                ens_pred = torch.argmax(votes, dim=-1)
            d2m, d3m = _map_dice(model_pred, gt_oh, m4, C)
            d2e, d3e = _map_dice(ens_pred, gt_oh, m4, C)
            per_patient.append({"pred": model_pred.to(torch.uint8),
                                "ens": ens_pred.to(torch.uint8),
                                "dice2d": d2m, "dice3d": d3m,
                                "ens_dice2d": d2e, "ens_dice3d": d3e})
        return {k: torch.stack([p[k] for p in per_patient]) for k in per_patient[0]}

    return step
