"""dct_tpu's side of the parallel tests (no tests of its own): its
co-training epochs (the vmapped step alone, under a data-only mesh, or
``make_shard_cotrain_epoch`` over a (model, data) mesh) on the weights the
port's ``dryrun.case_models`` draws, carried over by ``params_to_jax``,
with the network in float64 (parameters, SGD state and logits fp32), on
the conftest's 8 virtual CPU devices.

The port's side runs in spawned gloo ranks (``dct_tpu_torch.parallel.
dryrun``, which imports no JAX), so these helpers stay out of the
workers' import path.
"""
import jax
import jax.numpy as jnp
import numpy as np

from dct_tpu.data.augment import sample_aug_thetas as jax_sample_aug_thetas
from dct_tpu.losses import get_loss_fn as jax_get_loss_fn
from dct_tpu.parallel.mesh import make_mesh as jax_make_mesh
from dct_tpu.parallel.mesh import place_batches as jax_place_batches
from dct_tpu.parallel.mesh import place_stacked_state as jax_place_stacked_state
from dct_tpu.parallel.shard_cotrain import make_shard_cotrain_epoch as jax_shard_epoch
from dct_tpu.train.steps import make_cotrain_epoch as jax_make_cotrain_epoch
from dct_tpu_torch.parallel.dryrun import CASE, case_inputs, case_models
from dct_tpu_torch.utils.convert import params_from_jax_stacked, params_to_jax
from test_torch_jaxref import jax_segmentator

SGD = {"name": "SGD", "lr": 1e-2, "weight_decay": 0.0}
KEY = 11


def jax_f64_logits(seg):
    """dct_tpu's Segmentator with its train-mode logits left in float64
    (``test_torch_parallel_workers._apply_train_f64`` says why)."""
    def apply_train(params, batch_stats, x, dropout_rng=None):
        cparams, cx = seg._cast_in(params, x)
        out, mut = seg.model.apply({"params": cparams, "batch_stats": batch_stats},
                                   cx, train=True, mutable=["batch_stats"])
        return out, jax.tree_util.tree_map(lambda a: a.astype(jnp.float32),
                                           mut["batch_stats"])
    seg.apply_train = apply_train
    return seg


def jax_cotrain(case, mesh_shape=None, f64_logits=False):
    """dct_tpu's epoch of ``case`` (float64 network): no mesh, the vmapped
    step under a data-only mesh (``mesh_shape`` (1, n)), or the shard step
    (model axis above 1). Returns its metrics, the new weights as port
    state_dicts and the thetas its key drew (K labeled streams, then the
    unlabeled one, as the port's global layout has them)."""
    c = {**CASE, **case}
    K, B, Bu, H, T = (c[k] for k in ("K", "B", "Bu", "H", "T"))
    inp = case_inputs(c)
    trees = [params_to_jax(s.net.state_dict()) for s in case_models(c, "cpu")]
    loss_cfg = dict(c["loss"])
    with jax.enable_x64(True):
        params = jax.tree_util.tree_map(lambda *a: jnp.asarray(np.stack(a)),
                                        *[t[0] for t in trees])
        stats = jax.tree_util.tree_map(lambda *a: jnp.asarray(np.stack(a)),
                                       *[t[1] for t in trees])
        seg = jax_segmentator(trees[0][0], trees[0][1], optim=c["optim"], arch=c["arch"],
                              sched=c["sched"])
        if f64_logits:
            jax_f64_logits(seg)
        state = {"params": params, "batch_stats": stats, "opt_state": seg.tx.init(params)}
        sup = jax_get_loss_fn(loss_cfg.pop("name"), **loss_cfg)
        args = (c["jsd"], c["adv"])
        idx_lab, idx_unlab, pairs = inp["idx_lab"], inp["idx_unlab"], inp["pairs"]
        img, gt = jnp.asarray(inp["img"]), jnp.asarray(inp["gt"])
        mesh = None if mesh_shape is None else jax_make_mesh(
            mesh_shape[0] * mesh_shape[1], n_model=mesh_shape[0])
        if mesh is not None and mesh_shape[0] > 1:
            epoch = jax_shard_epoch(seg, mesh, K, c["C"], sup, *args, c["augment"],
                                    0.03, state_template=state, fuse_forward=c["fuse"])
        else:
            epoch = jax_make_cotrain_epoch(
                seg, K, c["C"], sup, *args, c["augment"], c["augment"], 0.03,
                fuse_aug="split" if mesh is not None else "merged",
                fuse_forward=c["fuse"])
            if mesh is not None:
                state = jax_place_stacked_state(mesh, state, K)
                idx_lab, idx_unlab, pairs = jax_place_batches(mesh, idx_lab, idx_unlab,
                                                              pairs)
        key = jax.random.PRNGKey(KEY)
        args = (state, img, gt, idx_lab, idx_unlab, pairs, key, c["lr"], c["lam_cot"],
                c["lam_adv"])
        # XLA's cheapest compile: the epoch runs once, at 16²
        new, metrics = epoch.lower(*args).compile(compiler_options={
            "xla_backend_optimization_level": 0,
            "xla_llvm_disable_expensive_passes": True})(*args)
        keys = jax.random.split(key, T)
        thetas = np.stack([np.concatenate(
            [np.asarray(jax_sample_aug_thetas(jax.random.fold_in(keys[t], i), B, H, H))
             for i in range(K)]
            + [np.asarray(jax_sample_aug_thetas(jax.random.fold_in(keys[t], 101), Bu, H, H))])
            for t in range(T)])
        models = params_from_jax_stacked(jax.tree_util.tree_map(np.asarray, new["params"]),
                                         jax.tree_util.tree_map(np.asarray,
                                                                new["batch_stats"]), K)
        return {"metrics": jax.tree_util.tree_map(np.asarray, metrics),
                "models": dict(enumerate(models)), "thetas": thetas}


def loss_gaps(ref, got, sum_adv=False):
    """Largest absolute difference of each loss (the shard layout's adv
    slots summed over K and its jsd slots averaged when ``sum_adv``)."""
    out = {}
    for k in ("sup_loss", "jsd_loss", "adv_loss"):
        a, b = np.asarray(got["metrics"][k]), np.asarray(ref["metrics"][k])
        if a.ndim != b.ndim:
            a = a.sum(1) if k == "adv_loss" else a.mean(1)
        out[k] = float(np.abs(a - b).max())
    return out
