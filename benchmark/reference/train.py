"""The plain training steps that the benchmark holds the program's against:
data gather and scaling, the nearest affine warps, cross-entropy, JSD and
KL, FGSM and VAT, Adam with L2, and the supervised, co-training and
Cityscapes co-training iterations built from them. float32 throughout,
stock PyTorch operations only; frozen copies of the semantics of the
configurations the benchmark runs.

Every input that is random (rows, warps, FGSM/VAT choices, VAT's starting
noise) comes from the benchmark and is handed to the program and to this
file alike. Images are NHWC, labels (N,H,W) int64.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import torch

from .nets import build, keep_stats

EPS_KL = 1e-10
EPS_ENT = 1e-16


# ------------------------------------------------------------------- data

def gather(img_u8: torch.Tensor, gt_u8: torch.Tensor, idx: torch.Tensor):
    """Rows ``idx`` of a uint8 set as a [0, 1] float32 NHWC batch and int64
    labels; a grayscale (N,H,W) set gains a channel axis."""
    img = (img_u8[idx].to(torch.float64) / 255.0).to(torch.float32)
    if img.dim() == 3:
        img = img[..., None]
    return img, gt_u8[idx].long()


def warp_nearest(x: torch.Tensor, theta: torch.Tensor) -> torch.Tensor:
    """Nearest warp of (B,H,W,C) by (B,2,3) thetas mapping centred output
    (y, x) to centred input coordinates, rounded half to even; 0 outside."""
    b, h, w, _ = x.shape
    yy = (torch.arange(h, dtype=torch.float32, device=x.device) - (h - 1) / 2.0)[:, None]
    xx = (torch.arange(w, dtype=torch.float32, device=x.device) - (w - 1) / 2.0)[None, :]
    t = theta.float()[:, :, :, None, None]
    sy = torch.round(t[:, 0, 0] * yy + t[:, 0, 1] * xx + t[:, 0, 2] + (h - 1) / 2.0).long()
    sx = torch.round(t[:, 1, 0] * yy + t[:, 1, 1] * xx + t[:, 1, 2] + (w - 1) / 2.0).long()
    ok = (sy >= 0) & (sy < h) & (sx >= 0) & (sx < w)
    bi = torch.arange(b, device=x.device)[:, None, None]
    vals = x[bi, sy.clamp(0, h - 1), sx.clamp(0, w - 1)]
    return torch.where(ok[..., None], vals, torch.zeros((), dtype=x.dtype, device=x.device))


def warp_shear(x: torch.Tensor, theta: torch.Tensor) -> torch.Tensor:
    """The Cityscapes warp: theta = L·D·U (lower shear, scale, upper shear)
    applied as three nearest-rounded stages, L onto a (2H, 3W/2) canvas, D
    rescaling its rows and columns to (2H, W), U back to (H, W), each
    rounded half to even in float32; 0 outside. Composed here into one
    gather per output pixel."""
    b, h, w, _ = x.shape
    dev = x.device
    th = theta.float()
    m00, m01, t0 = th[:, 0, 0], th[:, 0, 1], th[:, 0, 2]
    m10, m11, t1 = th[:, 1, 0], th[:, 1, 1], th[:, 1, 2]
    low, d0, d1, up = m10 / m00, m00, m11 - m10 * m01 / m00, m01 / m00
    cy, cx = (h - 1) / 2.0, (w - 1) / 2.0
    h1, w1 = 2 * h, (3 * w) // 2
    c1y, c1x = (h1 - 1) / 2.0, (w1 - 1) / 2.0

    def ar(n):
        return torch.arange(n, dtype=torch.float32, device=dev)

    def rescale(n_out, n_in, s):
        src = torch.round(s[:, None] * (ar(n_out) - (n_out - 1) / 2.0) + (n_in - 1) / 2.0).long()
        return src, (src >= 0) & (src < n_in)

    v_c = ar(h1) - c1y
    y_idx = (torch.round(v_c + t0[:, None] + cy).long() + h).clamp(0, 3 * h - 1)
    x0 = (torch.round(low[:, None] * v_c + t1[:, None] + cx - c1x).long() + w).clamp(0, 3 * w - w1)
    sy, vy = rescale(h1, h1, d0)
    sx, vx = rescale(w, w1, d1)
    y0 = torch.round(up[:, None] * (ar(w) - cx) + (c1y - cy)).long().clamp(0, h1 - h)
    rows = y0[:, None, :] + torch.arange(h, device=dev)[None, :, None]
    bi = torch.arange(b, device=dev)[:, None, None]
    r = sy.clamp(0, h1 - 1)[bi, rows]
    ok = vy[bi, rows] & vx[:, None, :]
    cols = x0[bi, r] + sx.clamp(0, w1 - 1)[:, None, :]
    py, px = y_idx[bi, r] - h, cols - w
    ok = ok & (py >= 0) & (py < h) & (px >= 0) & (px < w)
    vals = x[bi, py.clamp(0, h - 1), px.clamp(0, w - 1)]
    return torch.where(ok[..., None], vals, torch.zeros((), dtype=x.dtype, device=dev))


def augment_medical(img: torch.Tensor, gt: torch.Tensor, theta: torch.Tensor):
    """Image and labels warped together by the nearest warp."""
    out = warp_nearest(torch.cat([img, gt[..., None].float()], dim=-1), theta)
    return out[..., :-1], out[..., -1].long()


def augment_city(img: torch.Tensor, gt: torch.Tensor, theta: torch.Tensor,
                 ignore_index: int = 250):
    """Image, labels and a validity channel through the shear warp; labels
    from outside the canvas become ``ignore_index``."""
    b, h, w = img.shape[:3]
    ones = torch.ones((b, h, w, 1), dtype=img.dtype, device=img.device)
    out = warp_shear(torch.cat([img, gt[..., None].float(), ones], dim=-1), theta)
    gt_a = torch.where(out[..., -1] > 0.5, out[..., -2].long(),
                       torch.full((), ignore_index, dtype=torch.long, device=img.device))
    return out[..., :-2], gt_a


# ----------------------------------------------------------------- losses

def cross_entropy(logits: torch.Tensor, target: torch.Tensor,
                  weight: Optional[Sequence[float]] = None,
                  ignore_index: int = 255) -> torch.Tensor:
    """sum(w[y]·nll) / sum(w[y]) over the pixels not ``ignore_index``."""
    logp = torch.log_softmax(logits, dim=-1)
    valid = target != ignore_index
    safe = torch.where(valid, target, torch.zeros_like(target))
    nll = -torch.gather(logp, -1, safe[..., None])[..., 0]
    w = valid.float() if weight is None else \
        torch.as_tensor(weight, dtype=torch.float32, device=logits.device)[safe] * valid
    return (nll * w).sum() / w.sum().clamp_min(1e-12)


def entropy(p: torch.Tensor) -> torch.Tensor:
    return -(p * torch.log(p + EPS_ENT)).sum(-1)


def jsd(probs: torch.Tensor) -> torch.Tensor:
    """Jensen-Shannon map over the leading (model) axis."""
    return entropy(probs.mean(0)) - entropy(probs).mean(0)


def kl(p: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """KL(y ‖ p) map, probabilities in."""
    return (y * torch.log(y + EPS_KL)).sum(-1) - (y * torch.log(p + EPS_KL)).sum(-1)


def kl_logits(p_logit: torch.Tensor, y_logit: torch.Tensor) -> torch.Tensor:
    logp, logy = torch.log_softmax(p_logit, -1), torch.log_softmax(y_logit, -1)
    return (logy.exp() * (logy - logp)).sum(-1)


# --------------------------------------------------------------- the model

class Model:
    """A reference net with its Adam state (L2 folded into the gradient
    ahead of the moments, bias-corrected, ε outside the square root)."""

    def __init__(self, cfg: dict, state: Dict[str, torch.Tensor], device) -> None:
        self.net = build(cfg["arch"], cfg["in_channels"]).to(device)
        self.net.load_state_dict(state, strict=True)
        o = cfg["optim"]
        if o["name"] != "Adam":
            raise KeyError(f"the reference has Adam only, not {o['name']!r}")
        self.lr, self.wd = float(o["lr"]), float(o.get("weight_decay", 0.0))
        self.b1, self.b2 = (float(b) for b in o.get("betas", (0.9, 0.999)))
        self.eps = float(o.get("eps", 1e-8))
        self.t = 0
        self.m = {n: torch.zeros_like(p) for n, p in self.net.named_parameters()}
        self.v = {n: torch.zeros_like(p) for n, p in self.net.named_parameters()}
        self.first_grad: Optional[Dict[str, torch.Tensor]] = None

    def __call__(self, x: torch.Tensor, update_stats: bool = True):
        self.net.train()
        keep_stats(self.net, update_stats)
        try:
            return self.net(x)
        finally:
            keep_stats(self.net, True)

    def zero_grad(self) -> None:
        for p in self.net.parameters():
            p.grad = None

    @torch.no_grad()
    def step(self) -> None:
        self.t += 1
        bc1, bc2 = 1 - self.b1 ** self.t, 1 - self.b2 ** self.t
        grads = {}
        for n, p in self.net.named_parameters():
            g = torch.zeros_like(p) if p.grad is None else p.grad
            g = g + self.wd * p
            grads[n] = g
            self.m[n] = self.b1 * self.m[n] + (1 - self.b1) * g
            self.v[n] = self.b2 * self.v[n] + (1 - self.b2) * g * g
            p -= self.lr * (self.m[n] / bc1) / ((self.v[n] / bc2).sqrt() + self.eps)
        if self.first_grad is None:
            self.first_grad = grads


def fgsm(model: Model, img: torch.Tensor, gt: torch.Tensor, loss_fn, eps: float,
         update_stats: bool = True):
    """img + ε·sign(∇_img loss); rows beyond ``gt`` take the model's argmax
    as labels. Returns (adversarial image, softmax of the clean logits)."""
    x = img.detach().requires_grad_(True)
    logits = model(x, update_stats)
    if gt.shape[0] < x.shape[0]:
        gt = torch.cat([gt, logits[gt.shape[0]:].detach().argmax(-1)], dim=0)
    (g,) = torch.autograd.grad(loss_fn(logits, gt), [x])
    return (img + eps * torch.sign(g)).detach(), torch.softmax(logits.detach(), -1)


def _unit(d: torch.Tensor) -> torch.Tensor:
    n = torch.sqrt((d.reshape(d.shape[0], -1) ** 2).sum(1) + 1e-16)
    return d / n.reshape((-1,) + (1,) * (d.dim() - 1))


def vat(model: Model, img: torch.Tensor, d: torch.Tensor, eps: float, xi: float = 1e-6):
    """One power iteration from the noise ``d``; the result clamped to [0, 1].
    None of its forwards keeps its running statistics."""
    with torch.no_grad():
        clean = model(img, update_stats=False)
    dd = (xi * _unit(_unit(d))).requires_grad_(True)
    (g,) = torch.autograd.grad(kl_logits(model(img + dd, update_stats=False), clean).mean(), [dd])
    return torch.clamp(img + eps * _unit(g), 0.0, 1.0).detach()


# --------------------------------------------------------------- the steps

def supervised_step(model: Model, batch: dict, loss_fn) -> Dict[str, torch.Tensor]:
    img, gt = gather(batch["img_u8"], batch["gt_u8"], batch["idx"])
    if batch.get("theta") is not None:
        img, gt = augment_medical(img, gt, batch["theta"])
    loss = loss_fn(model(img), gt)
    model.zero_grad()
    loss.backward()
    model.step()
    return {"loss": loss.detach()}


def cotrain_step(models: List[Model], batch: dict, loss_fn, lam_cot: float,
                 lam_adv: float, eps: float) -> Dict[str, torch.Tensor]:
    """One co-training iteration: each model on its labeled batch and on the
    shared unlabeled batch (two forwards, each with its own statistics, the
    running ones folded labeled first), supervised CE, JSD over the
    unlabeled predictions, FGSM on model 1's labeled + unlabeled batch (its
    own argmax labels the unlabeled rows) scored by model 0 against model
    1's clean prediction with KL, one backward of the sum, Adam."""
    K = len(models)
    idx_l, idx_u = batch["idx_lab"], batch["idx_unlab"]
    B = idx_l.shape[1]
    img, gt = gather(batch["img_u8"], batch["gt_u8"], torch.cat([idx_l.reshape(-1), idx_u]))
    if batch.get("theta") is not None:
        img, gt = augment_medical(img, gt, batch["theta"])
    lab_img = img[:K * B].reshape(K, B, *img.shape[1:])
    lab_gt = gt[:K * B].reshape(K, B, *gt.shape[1:])
    unlab = img[K * B:]
    lab_logits = [models[k](lab_img[k]) for k in range(K)]
    unlab_logits = [m(unlab) for m in models]
    sup = torch.stack([loss_fn(lab_logits[k], lab_gt[k]) for k in range(K)])
    jsd_loss = jsd(torch.stack([torch.softmax(lg, -1) for lg in unlab_logits])).mean()
    a, b = 0, 1
    adv_img, real = fgsm(models[b], torch.cat([lab_img[b], unlab]), lab_gt[b], loss_fn, eps)
    adv_loss = kl(torch.softmax(models[a](adv_img), -1), real).mean()
    total = sup.sum() + lam_cot * jsd_loss + lam_adv * adv_loss
    for m in models:
        m.zero_grad()
    total.backward()
    for m in models:
        m.step()
    return {"sup_loss": sup.detach(), "jsd_loss": jsd_loss.detach(),
            "adv_loss": adv_loss.detach()}


def city_cotrain_step(models: List[Model], batch: dict, loss_fn, lam_cot: float,
                      lam_adv: float, eps_fgsm: float, eps_vat: float,
                      ignore_index: int = 250) -> Dict[str, torch.Tensor]:
    """The Cityscapes iteration: the labeled and unlabeled batches warped
    (unlabeled labels unused), each model on its labeled and on the
    unlabeled batch, CE and JSD as in :func:`cotrain_step`; then for each
    direction (attack 0, score 1; attack 1, score 0) FGSM on a labeled draw
    or VAT on an unlabeled draw as the flag says, the target model's
    softmax on the adversarial batch scored by KL against the attacker's
    clean softmax, none of these forwards keeping statistics; the mean of
    the two KLs; one backward; Adam."""
    K = len(models)
    u8, g8 = batch["img_u8"], batch["gt_u8"]
    idx_l, idx_u = batch["idx_lab"], batch["idx_unlab"]
    B = idx_l.shape[1]
    img, gt = gather(u8, g8, torch.cat([idx_l.reshape(-1), idx_u]))
    if batch.get("theta") is not None:
        gt = gt.clone()
        gt[K * B:] = 0
        img, gt = augment_city(img, gt, batch["theta"], ignore_index)
    lab_img = img[:K * B].reshape(K, B, *img.shape[1:])
    lab_gt = gt[:K * B].reshape(K, B, *gt.shape[1:])
    unlab = img[K * B:]
    lab_logits = [models[k](lab_img[k]) for k in range(K)]
    unlab_logits = [m(unlab) for m in models]
    sup = torch.stack([loss_fn(lab_logits[k], lab_gt[k]) for k in range(K)])
    jsd_loss = jsd(torch.stack([torch.softmax(lg, -1) for lg in unlab_logits])).mean()
    kls = []
    for direction, (atk, tgt) in enumerate(((0, 1), (1, 0))):
        if bool(batch["flags"][direction]):
            clean, g = gather(u8, g8, batch["idx_adv_lab"][direction])
            adv, _ = fgsm(models[atk], clean, g, loss_fn, eps_fgsm, update_stats=False)
        else:
            clean, _ = gather(u8, g8, batch["idx_adv_unlab"][direction])
            adv = vat(models[atk], clean, batch["noise"][direction], eps_vat)
        with torch.no_grad():
            real = torch.softmax(models[atk](clean, update_stats=False), -1)
        kls.append(kl(torch.softmax(models[tgt](adv, update_stats=False), -1), real).mean())
    adv_loss = sum(kls) / len(kls)
    total = sup.sum() + lam_cot * jsd_loss + lam_adv * adv_loss
    for m in models:
        m.zero_grad()
    total.backward()
    for m in models:
        m.step()
    return {"sup_loss": sup.detach(), "jsd_loss": jsd_loss.detach(),
            "adv_loss": adv_loss.detach()}


def loss_of(cfg: dict):
    """The configuration's supervised loss as a callable (logits, labels)."""
    spec = dict(cfg["loss"])
    if spec.pop("name") != "cross_entropy":
        raise KeyError("the reference has cross_entropy only")
    return lambda logits, gt: cross_entropy(logits, gt, spec.get("weight"),
                                            int(spec.get("ignore_index", 255)))

