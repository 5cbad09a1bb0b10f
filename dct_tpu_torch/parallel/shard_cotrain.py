"""Model-parallel co-training (``dct_tpu/parallel/shard_cotrain.py``),
computed as dct_tpu's ``shard_map`` step computes it.

K models over a (model, data) mesh: each row of ranks owns K_local =
K / n_model models (``place_stacked_state``), each rank of the row a data
chunk of their batches (``place_batches``). Per iteration, per rank:

* the supervised forwards run the local models on the local chunk, and
  BatchNorm normalises over that chunk alone (per-shard statistics, as in
  dct_tpu; the data-parallel step of ``train/steps.py`` uses the global
  batch instead). After the step the float running statistics are
  averaged over the data ranks;
* the JSD all-gathers the K models' unlabeled probabilities over the
  model group and enters each rank's total as λ_cot·JSD / n_model: the
  all-gather's backward sums the n_model cotangents, which restores the
  joint gradient;
* FGSM: model b's owner attacks with b on its labeled chunk stacked on
  the unlabeled one and broadcasts the adversarial batch and b's clean
  probabilities within its model group (dct_tpu computes the attack on
  every rank and selects the owner's: the same values); only model a's
  owner runs the adversarial forward and pays the KL. The pair is (0, 1)
  for K = 2, else the host's; running statistics advance only on the
  owners;
* each local loss is a mean over the local chunk, and the gradients are
  averaged over the data ranks (dct_tpu's ``pmean``) in one flat buffer a
  model.

With ``augment`` (dct_tpu passes its labeled flag for both streams) the
thetas are drawn for the global batch in the co-training layout (K
labeled streams, then the unlabeled one) and cut to this rank's models and
chunk. The fused two-group forward and ``adv_dtype`` behave as in
``train/steps.py:make_cotrain_epoch``.

Metrics keep dct_tpu's layout: sup_loss (T,K) and the dice rows (T,K,B_l,C)
averaged over the data ranks, jsd_loss (T,K) the JSD in every slot,
adv_loss (T,K) the KL over K_local in each slot of a's owner (the host sums
over K).
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from ..adversarial import fgsm
from ..data.augment import augment_batch_with_thetas, sample_aug_thetas
from ..data.pipeline import normalize_gather
from ..losses import jsd_2d, kl_div_2d
from ..models.segmentator import Segmentator, as_dtype
from ..optim import set_lr
from ..train.steps import _dice_rows
from . import comm
from .data_parallel import DataShard
from .mesh import Mesh, place_stacked_state


def make_shard_cotrain_epoch(segs: List[Segmentator], mesh: Mesh, C: int,
                             sup_loss: Callable, train_jsd: bool, train_adv: bool,
                             augment: bool, eps_fgsm: float = 0.03,
                             fuse_forward: bool = True, adv_dtype=None) -> Callable:
    """The model-parallel epoch over all K models ``segs`` (every rank
    holds all K; it trains its own). ``epoch(img_u8, gt_u8, idx_lab
    (T,K_local,B_l), idx_unlab (T,Bu_l), pairs (T,2) or None, generator, lr,
    lam_cot, lam_adv, thetas=None)``: the indices are this rank's
    ``place_batches``, ``thetas`` (T, (K·B + Bu), 2, 3) the global batch's."""
    K = len(segs)
    n_model, n_data = mesh.shape["model"], mesh.shape["data"]
    assert K % n_model == 0, f"K={K} not divisible into {n_model} model groups"
    K_local = K // n_model
    first = mesh.model_index * K_local
    own = list(range(first, first + K_local))
    local = place_stacked_state(mesh, list(segs), K)
    shard = DataShard.of(mesh)
    for s in segs:
        s.set_data_parallel(None)            # BatchNorm over the local chunk
    adv_dtype = as_dtype(adv_dtype)
    if adv_dtype == segs[0].compute_dtype:
        adv_dtype = None
    bn_stats = [[t for name, t in s.net.named_buffers()
                 if name.endswith(("running_mean", "running_var"))] for s in local]

    def one_step(img_u8, gt_u8, idx_l, idx_u, pair, generator, lam_cot, lam_adv,
                 th) -> Dict[str, torch.Tensor]:
        B, Bu = idx_l.shape[1], idx_u.shape[0]
        img_all, gt_all = normalize_gather(img_u8, gt_u8,
                                           torch.cat([idx_l.reshape(-1), idx_u]))
        if augment:
            if th is None:
                th = sample_aug_thetas(generator, (K * B + Bu) * n_data,
                                       img_u8.shape[1], img_u8.shape[2])
            th = th[shard.stream_rows([B] * K + [Bu], own + [K]).to(th.device)]
            img_all, gt_all = augment_batch_with_thetas(img_all, gt_all,
                                                        th.to(img_all.device))
        lab_img = img_all[:K_local * B].reshape((K_local, B) + img_all.shape[1:])
        lab_gt = gt_all[:K_local * B].reshape((K_local, B) + gt_all.shape[1:])
        unlab_img, unlab_gt = img_all[K_local * B:], gt_all[K_local * B:]

        zero = torch.zeros((), device=img_all.device)
        jsd_loss, adv_loss, unlab_logits = zero, zero, None
        if (train_jsd and fuse_forward and B == Bu
                and all(s.bn_momentum is not None for s in local)):
            both = [s.apply_train(torch.cat([lab_img[j], unlab_img]), groups=2)
                    for j, s in enumerate(local)]
            lab_logits = [lg[:B] for lg in both]
            unlab_logits = [lg[B:] for lg in both]
        else:
            lab_logits = [s.apply_train(lab_img[j]) for j, s in enumerate(local)]
            if train_jsd:
                unlab_logits = [s.apply_train(unlab_img) for s in local]
        sup_each = torch.stack([sup_loss(lab_logits[j], lab_gt[j])
                                for j in range(K_local)])
        total = sup_each.sum()
        if train_jsd:
            mine = torch.stack([torch.softmax(lg, dim=-1) for lg in unlab_logits])
            every = comm.all_gather(mine, mesh.model_group)
            jsd_loss = jsd_2d(every.reshape((K,) + mine.shape[1:])).mean()
            total = total + lam_cot * jsd_loss / n_model
        if train_adv:
            a, b = (0, 1) if K == 2 else (int(pair[0]), int(pair[1]))
            a_own, b_own = mesh.owner(a, K), mesh.owner(b, K)
            if mesh.model_index == b_own:
                adv_img, _, real = fgsm(
                    segs[b], torch.cat([lab_img[b - first], unlab_img], dim=0),
                    lab_gt[b - first], sup_loss, eps_fgsm, dtype=adv_dtype)
            else:
                adv_img = torch.empty((B + Bu,) + unlab_img.shape[1:],
                                      dtype=unlab_img.dtype, device=unlab_img.device)
                real = torch.empty((B + Bu,) + lab_logits[0].shape[1:],
                                   dtype=lab_logits[0].dtype, device=unlab_img.device)
            src = mesh.model_rank(b_own)
            comm.broadcast_(adv_img, src, mesh.model_group)
            comm.broadcast_(real, src, mesh.model_group)
            if mesh.model_index == a_own:
                adv_logits = segs[a].apply_train(adv_img, dtype=adv_dtype)
                adv_loss = kl_div_2d(torch.softmax(adv_logits, dim=-1), real).mean()
                total = total + lam_adv * adv_loss

        for s in local:
            s.optimizer.zero_grad(set_to_none=True)
        total.backward()
        for s, stats in zip(local, bn_stats):
            if n_data > 1:
                comm.flat_all_reduce_grads(s.net.parameters(), mesh.data_group,
                                           scale=1.0 / n_data)
            s.optimizer.step()
            average_(stats, mesh.data_group, n_data)

        lab_dice = torch.stack([_dice_rows(lab_logits[j].detach(), lab_gt[j], C)
                                for j in range(K_local)])
        if unlab_logits is not None:
            unlab_dice = torch.stack([_dice_rows(lg.detach(), unlab_gt, C)
                                      for lg in unlab_logits])
        else:
            unlab_dice = torch.zeros((K_local, Bu, C), device=img_all.device)
        dt = sup_each.dtype            # a rank that skips a term has its zero
        return {"sup_loss": sup_each.detach(),
                "jsd_loss": jsd_loss.detach().to(dt).expand(K_local),
                "adv_loss": (adv_loss.detach().to(dt) / K_local).expand(K_local),
                "lab_dice": lab_dice, "unlab_dice": unlab_dice}

    def epoch(img_u8: torch.Tensor, gt_u8: torch.Tensor, idx_lab, idx_unlab,
              pairs, generator: Optional[torch.Generator], lr: float,
              lam_cot: float, lam_adv: float,
              thetas: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
        dev = img_u8.device
        idx_lab = torch.as_tensor(np.asarray(idx_lab), device=dev).long()
        idx_unlab = torch.as_tensor(np.asarray(idx_unlab), device=dev).long()
        if idx_lab.shape[1] != K_local:
            raise ValueError(f"idx_lab must be (T, K_local={K_local}, B), "
                             f"got {tuple(idx_lab.shape)}")
        if train_adv and K > 2 and pairs is None:
            raise ValueError("K > 2 needs the per-iteration pairs")
        for s in local:
            set_lr(s.optimizer, lr)
        steps = [one_step(img_u8, gt_u8, idx_lab[t], idx_unlab[t],
                          None if pairs is None else pairs[t], generator,
                          lam_cot, lam_adv, None if thetas is None else thetas[t])
                 for t in range(idx_lab.shape[0])]
        out = {}
        for k in steps[0]:
            x = torch.stack([m[k] for m in steps])            # (T, K_local, ...)
            x = comm.all_reduce_(x.contiguous(), mesh.data_group) / n_data
            out[k] = comm.gather_rows(x, mesh.model_group, dim=1)
        return out

    return epoch


def average_(tensors, group, n: int) -> None:
    """Average float ``tensors`` in place over ``group`` (``n`` ranks), in
    one flat buffer."""
    if n == 1:
        return
    flat = torch.cat([t.reshape(-1) for t in tensors])
    comm.all_reduce_(flat, group)
    flat.div_(n)
    offset = 0
    for t in tensors:
        t.copy_(flat[offset:offset + t.numel()].view(t.shape))
        offset += t.numel()

