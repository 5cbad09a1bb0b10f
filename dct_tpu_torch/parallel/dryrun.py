"""Multi-process dry run of the parallel paths on the CPU, and the worker
functions the parallel tests and ``chip_smoke.py`` spawn:

    python -m dct_tpu_torch.parallel.dryrun --n 8

spawns ``n`` gloo ranks on the CPU and runs, at 16², the data-parallel
co-training epoch (mesh 1 × n, held against the same epoch in one
process), the model-parallel one at K = 4 (mesh 2 × n/2) and a Cityscapes
data-parallel epoch (1 × n), and prints one OK line each (the
counterpart of dct_tpu's ``__graft_entry__.py:dryrun_multichip``).

``spawn`` starts the ranks with the spawn method (each re-imports this
module, which imports only torch and the port), joins them through a
``FileStore`` in a temporary directory (no port is opened), sets one
torch thread a rank, and fails, never hangs, when a rank dies or the
deadline passes: it then kills the rest.
"""
from __future__ import annotations

import argparse
import math
import multiprocessing as mp
import tempfile
import time
import traceback
from datetime import timedelta
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch
import torch.distributed as dist

from ..data.augment import sample_aug_thetas
from ..losses import get_loss_fn
from ..models import Segmentator
from .mesh import make_mesh, place_batches


def _entry(fn: Callable, rank: int, world: int, store: str, out: str,
           timeout_s: float, args: tuple) -> None:
    torch.set_num_threads(1)
    try:
        dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank,
                                world_size=world, timeout=timedelta(seconds=timeout_s))
        result = fn(rank, world, *args)
        torch.save(result, f"{out}/{rank}.pt")
        dist.destroy_process_group()
    except BaseException:
        Path(f"{out}/{rank}.err").write_text(traceback.format_exc())
        raise


def spawn(fn: Callable, world: int, args: tuple = (), timeout: float = 120.0) -> List[Any]:
    """Run ``fn(rank, world, *args)`` on ``world`` gloo ranks; returns each
    rank's result, in rank order. Raises, after killing every rank, when a
    rank fails or ``timeout`` seconds pass."""
    ctx = mp.get_context("spawn")
    with tempfile.TemporaryDirectory() as tmp:
        store, out = f"{tmp}/store", f"{tmp}/out"
        Path(out).mkdir()
        procs = [ctx.Process(target=_entry, args=(fn, r, world, store, out, timeout, args),
                             daemon=True) for r in range(world)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout
        failed = None
        try:
            while any(p.is_alive() for p in procs):
                bad = [r for r, p in enumerate(procs) if p.exitcode not in (None, 0)]
                if bad:
                    failed = f"rank {bad[0]} exited with {procs[bad[0]].exitcode}"
                    break
                if time.monotonic() > deadline:
                    failed = f"ranks still running after {timeout:.0f} s"
                    break
                time.sleep(0.05)
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
            for p in procs:
                p.join(5)
        bad = [r for r, p in enumerate(procs) if p.exitcode != 0]
        if failed or bad:
            errs = "".join(Path(f"{out}/{r}.err").read_text()
                           for r in range(world) if Path(f"{out}/{r}.err").exists())
            raise RuntimeError(f"{failed or f'ranks {bad} failed'}\n{errs}")
        return [torch.load(f"{out}/{r}.pt", weights_only=False) for r in range(world)]


# ---- the co-training case ---------------------------------------------------

CASE = {"K": 2, "B": 4, "Bu": 4, "H": 16, "N": 24, "T": 2, "C": 4, "seed": 0,
        "arch": {"name": "enet", "num_classes": 4},
        "optim": {"name": "Adam", "lr": 1e-3, "weight_decay": 1e-4, "eps": 1e-3},
        "sched": {"name": "StepLR", "step_size": 90, "gamma": 0.1},
        "loss": {"name": "cross_entropy"}, "jsd": True, "adv": True,
        "augment": True, "fuse": True, "lam_cot": 0.5, "lam_adv": 0.05,
        "lr": 1e-3, "n_model": None, "device": "cpu", "compute": None,
        "tf32": True}


def case_inputs(case: Dict) -> Dict[str, np.ndarray]:
    """The host draws of a case, from its seed: uint8 images and labels
    (random, or the first N slices of the case's ``tree``, an ACDC-style
    tree of H² PNGs), (T,K,B) and (T,Bu) indices, pairs and the global
    batch's thetas (the case's ``thetas`` when it has them)."""
    c = {**CASE, **case}
    rs = np.random.RandomState(c["seed"])
    K, B, Bu, H, N, T = (c[k] for k in ("K", "B", "Bu", "H", "N", "T"))
    gen = torch.Generator().manual_seed(c["seed"])
    if c.get("tree"):
        from PIL import Image
        names = sorted(p.name for p in (Path(c["tree"]) / "train" / "img").iterdir())[:N]
        img, gt = (np.stack([np.asarray(Image.open(Path(c["tree"]) / "train" / sub / n))
                             for n in names]) for sub in ("img", "gt"))
    else:
        img = rs.randint(0, 255, (N, H, H), dtype=np.uint8)
        gt = rs.randint(0, c["C"], (N, H, H)).astype(np.uint8)
    return {"img": img, "gt": gt,
            "idx_lab": rs.randint(0, N, (T, K, B)).astype(np.int32),
            "idx_unlab": rs.randint(0, N, (T, Bu)).astype(np.int32),
            "pairs": np.stack([np.sort(rs.choice(K, 2, replace=False))
                               for _ in range(T)]).astype(np.int32),
            "thetas": c["thetas"] if c.get("thetas") is not None else
            torch.stack([sample_aug_thetas(gen, K * B + Bu, H, H) for _ in range(T)]).numpy()}


def case_models(case: Dict, device) -> List[Segmentator]:
    c = {**CASE, **case}
    segs = [Segmentator(c["arch"], c["optim"], c["sched"],
                        torch.Generator().manual_seed(c["seed"] * 100 + k), device=device)
            for k in range(c["K"])]
    if c["compute"]:
        for s in segs:
            s.compute_dtype = getattr(torch, c["compute"])
    if c.get("weights") is not None:
        for s, sd in zip(segs, c["weights"]):
            s.net.load_state_dict(sd)
    return segs


def cotrain_case(rank: int, world: int, case: Dict) -> Dict:
    """One co-training epoch of ``case`` on this rank (world 1 and
    ``n_model`` None: the single process, no mesh). Returns the metrics,
    the state of the models this rank owns when its data index is 0, and
    the pool kernels' launches of the epoch."""
    from ..ops import pool_kernels as pk
    from ..train.steps import make_cotrain_epoch
    from .shard_cotrain import make_shard_cotrain_epoch
    c = {**CASE, **case}
    device = torch.device(c["device"])
    if device.type == "cuda":
        torch.cuda.set_device(device)
        torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = c["tf32"]
        torch.backends.cudnn.deterministic = c.get("deterministic", False)
    inp = case_inputs(c)
    segs = case_models(c, device)
    K = c["K"]
    mesh = None if c["n_model"] is None else make_mesh(world, c["n_model"])
    loss_cfg = dict(c["loss"])
    sup = get_loss_fn(loss_cfg.pop("name"), **loss_cfg)
    idx_lab, idx_unlab, pairs = inp["idx_lab"], inp["idx_unlab"], inp["pairs"]
    args = (sup, c["jsd"], c["adv"])
    if mesh is not None and mesh.shape["model"] > 1:
        epoch = make_shard_cotrain_epoch(segs, mesh, c["C"], *args, c["augment"],
                                         fuse_forward=c["fuse"])
    else:
        epoch = make_cotrain_epoch(segs, c["C"], *args, c["augment"], c["augment"],
                                   fuse_forward=c["fuse"], mesh=mesh)
    if mesh is not None:
        idx_lab, idx_unlab, pairs = place_batches(mesh, idx_lab, idx_unlab, pairs)
    img = torch.from_numpy(inp["img"]).to(device)
    gt = torch.from_numpy(inp["gt"]).to(device)
    pk.reset_launch_counts()
    t0 = time.perf_counter()
    metrics = epoch(img, gt, idx_lab, idx_unlab, pairs, None, c["lr"], c["lam_cot"],
                    c["lam_adv"], thetas=torch.from_numpy(inp["thetas"]))
    out = {k: v.cpu().numpy() for k, v in metrics.items()}
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    seconds = time.perf_counter() - t0
    launches = dict(pk.LAUNCHES)
    owned = range(K) if mesh is None else [
        k for k in range(K) if mesh.owner(k, K) == mesh.model_index]
    models = {}
    if mesh is None or mesh.data_index == 0:
        models = {k: {n: t.detach().cpu().clone() for n, t in segs[k].net.state_dict().items()}
                  for k in owned}
    return {"metrics": out, "models": models, "launches": launches, "seconds": seconds,
            "rank": rank}


def merge_models(results: List[Dict]) -> Dict[int, Dict]:
    """The K models' states from every rank's result."""
    models = {}
    for r in results:
        models.update(r["models"])
    return dict(sorted(models.items()))


def max_rel_diff(a: Dict[int, Dict], b: Dict[int, Dict], stats: bool) -> float:
    """Largest difference of the parameters (``stats`` False) or the
    running statistics, relative to each leaf's scale (at least 1)."""
    worst = 0.0
    for k in a:
        for n in a[k]:
            if ("running" in n) != stats or not a[k][n].is_floating_point():
                continue
            x, y = a[k][n].double(), b[k][n].double()
            worst = max(worst, float((x - y).abs().max()) / max(1.0, float(y.abs().max())))
    return worst


# ---- the Cityscapes case ----------------------------------------------------

def city_case(rank: int, world: int, case: Dict) -> Dict:
    """One Cityscapes co-training epoch (ENet, K = 2, RGB 16×32, the FGSM/VAT
    mix) on this rank; world 1 with ``n_model`` None is the single process."""
    from ..data.city_augment import get_composed_augmentations
    from ..train.city import make_city_cotrain_epoch
    c = {"K": 2, "B": 2, "H": 16, "W": 32, "N": 16, "T": 2, "C": 19, "seed": 3,
         "n_model": None, **case}
    K, B, H, W, N, T, C = (c[k] for k in ("K", "B", "H", "W", "N", "T", "C"))
    rs = np.random.RandomState(c["seed"])
    img = torch.from_numpy(rs.randint(0, 255, (N, H, W, 3), dtype=np.uint8))
    gt = torch.from_numpy(rs.choice([*range(C), 250], (N, H, W)).astype(np.uint8))
    idx = [rs.randint(0, N, shape).astype(np.int32)
           for shape in ((T, K, B), (T, B), (T, 2, B), (T, 2, B))]
    flags = np.array([[True, False]] * T)
    noise = torch.from_numpy(rs.standard_normal((T, 2, B, H, W, 3)).astype(np.float32))
    segs = [Segmentator({"name": "enet", "num_classes": C}, CASE["optim"], CASE["sched"],
                        torch.Generator().manual_seed(40 + k), device="cpu", in_channels=3)
            for k in range(K)]
    for s in segs:
        s.compute_dtype = getattr(torch, c.get("compute") or "float32")
    mesh = None if c["n_model"] is None else make_mesh(world, 1)
    weights = rs.uniform(1.0, 10.0, C).tolist()
    aug = get_composed_augmentations({"rotate": 10})
    th = torch.cat([aug.sample(torch.Generator().manual_seed(5), n, H, W)
                    for n in [B] * K + [B]])
    epoch = make_city_cotrain_epoch(segs, C, get_loss_fn("cross_entropy", weight=weights,
                                                         ignore_index=250),
                                    True, True, 0.03, 10.0, augment_fn=aug, mesh=mesh)
    if mesh is not None:
        from .mesh import dp_shard_idx
        idx = [dp_shard_idx(mesh, a) for a in idx]
    metrics = epoch(img, gt, *idx, flags, None, 1e-3, 1.0, 0.005, vat_noise=noise,
                    thetas=th[None].expand(T, *th.shape))
    return {"metrics": {k: v.numpy() for k, v in metrics.items()},
            "models": {k: {n: t.clone() for n, t in s.net.state_dict().items()}
                       for k, s in enumerate(segs)} if rank == 0 else {}}


# ---- overlap-tile eval -------------------------------------------------------

class TwoConv(torch.nn.Module):
    """Two 3×3 convolutions with a ReLU between (half receptive field 2),
    NHWC in and out."""

    def __init__(self, cin: int = 1, width: int = 8, cout: int = 4) -> None:
        super().__init__()
        self.a = torch.nn.Conv2d(cin, width, 3, padding=1)
        self.b = torch.nn.Conv2d(width, cout, 3, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.b(torch.relu(self.a(x.permute(0, 3, 1, 2))))
        return y.permute(0, 2, 3, 1)


def spatial_case(rank: int, world: int, case: Dict) -> Dict:
    """Overlap-tile eval over a data-only mesh of ``world`` ranks: the
    two-conv net (``net`` "twoconv") or an eval-mode ENet (``net`` "enet",
    ``weights`` its state_dict when given) on a seeded (B,H,W,1) image.
    Returns the tiled output and, on rank 0, the full-image output."""
    from .spatial import make_spatial_eval
    c = {"net": "twoconv", "B": 1, "H": 16, "W": 64, "halo": 8, "seed": 0,
         "device": "cpu", "weights": None, **case}
    device = torch.device(c["device"])
    if device.type == "cuda":
        torch.cuda.set_device(device)
        torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator().manual_seed(c["seed"])
    img = torch.rand((c["B"], c["H"], c["W"], 1), generator=gen).to(device)
    if c["net"] == "twoconv":
        torch.manual_seed(c["seed"])
        net = TwoConv().to(device).eval()

        def apply(x):
            return net(x)
    else:
        seg = Segmentator({"name": "enet", "num_classes": 4}, CASE["optim"], CASE["sched"],
                          torch.Generator().manual_seed(c["seed"]), device=device)
        if c["weights"] is not None:
            seg.net.load_state_dict(c["weights"])
        if c.get("compute"):
            seg.compute_dtype = getattr(torch, c["compute"])
        apply = seg.apply_eval
    step = make_spatial_eval(apply, make_mesh(world, 1), c["halo"])
    tiled = step(img).cpu()
    full = None
    if rank == 0:
        with torch.inference_mode():
            full = apply(img).cpu()
    return {"tiled": tiled, "full": full}


def run_cases(rank: int, world: int, cases: List) -> Dict:
    """Several ``(worker name, case)`` pairs of this module on one set of
    ranks, in order; also whether a gloo collective staged a CUDA tensor
    through the host."""
    from . import comm
    out = [globals()[name](rank, world, case) for name, case in cases]
    return {"results": out, "host_staged": comm.HOST_STAGED}


# ---- the dry run ------------------------------------------------------------

def _check_close(name: str, got: Dict, ref: Dict, tol: float) -> float:
    worst = 0.0
    for k in ("sup_loss", "jsd_loss", "adv_loss"):
        worst = max(worst, float(np.abs(got[k] - ref[k]).max()))
    if not worst <= tol:
        raise AssertionError(f"{name}: losses differ from one process by {worst}")
    return worst


def main(argv: Optional[List[str]] = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--n", type=int, default=8, help="ranks (gloo, CPU)")
    parser.add_argument("--timeout", type=float, default=600.0)
    n = parser.parse_args(argv).n
    timeout = parser.parse_args(argv).timeout
    t0 = time.perf_counter()
    # float64 arithmetic: in fp32 FGSM's sign flips where the input
    # gradient rounds differently, which moves the adversarial term
    dp = {"B": n, "Bu": n, "n_model": 1, "compute": "float64"}
    got = spawn(cotrain_case, n, (dp,), timeout)
    ref = cotrain_case(0, 1, {**dp, "n_model": None})
    gap = _check_close("data parallel", got[0]["metrics"], ref["metrics"], 1e-4)
    print(f"OK data-parallel co-training, mesh {{'model': 1, 'data': {n}}}, K=2, "
          f"B=Bu={n}, 16², 2 iterations: losses within {gap:.2e} of one process, "
          f"params within {max_rel_diff(merge_models(got), ref['models'], False):.2e} "
          f"[{time.perf_counter() - t0:.1f} s]", flush=True)

    t0 = time.perf_counter()
    n_model = math.gcd(2, n)
    mp_case = {"K": 4, "B": n // n_model, "Bu": n // n_model, "n_model": n_model}
    got = spawn(cotrain_case, n, (mp_case,), timeout)
    sup = got[0]["metrics"]["sup_loss"]
    if sup.shape != (CASE["T"], 4) or not np.isfinite(sup).all():
        raise AssertionError(f"model parallel: sup_loss {sup}")
    print(f"OK model-parallel co-training, mesh {{'model': {n_model}, 'data': "
          f"{n // n_model}}}, K=4, 16², 2 iterations: sup "
          f"{' '.join(f'{x:.4f}' for x in sup[-1])} "
          f"[{time.perf_counter() - t0:.1f} s]", flush=True)

    t0 = time.perf_counter()
    city = {"B": n, "n_model": 1, "compute": "float64"}
    got = spawn(city_case, n, (city,), timeout)
    ref = city_case(0, 1, {**city, "n_model": None})
    gap = _check_close("city", got[0]["metrics"], ref["metrics"], 1e-4)
    print(f"OK Cityscapes data-parallel co-training, mesh {{'model': 1, 'data': {n}}}, "
          f"K=2, B={n}, 16×32, 2 iterations: losses within {gap:.2e} of one process "
          f"[{time.perf_counter() - t0:.1f} s]", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
