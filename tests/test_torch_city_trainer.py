"""The Cityscapes co-training epoch (``train/city.py:make_city_cotrain_epoch``)
against ``dct_tpu.train.city.make_city_cotrain_epoch``, on the CPU.

Two iterations, K=2, B=Bu=2, 16×32 RGB images (non-square), 19 classes
with the config's class weights and void pixels (250) in the labels, jsd
on (so both sides run the fused two-group forward) and the adversarial
term on, the flags [FGSM, VAT] then [VAT, FGSM], λ_cot 1.0 and λ_adv
0.005 (the configs' maxima).
Both models start from the port's own init (seeds 0 and 1), carried to
dct_tpu by ``utils/convert.py:params_to_jax``; both sides get the same
batch indices and flags, and the port gets the VAT noise dct_tpu draws
(``normal(fold_in(k_t, 7 + direction))``), which its generator cannot
reproduce.

Precision: parameters, Adam state and images are fp32; the networks
compute in float64 and, on both sides, hand their logits on in float64
(each casts them to fp32 as shipped): VAT's power iteration moves the
logits by ~1e-8 of themselves (ξ = 1e-6), below fp32's resolution, so with
fp32 logits its direction is each framework's rounding
(``test_torch_jaxref.py:float64_logits``). Adam's eps is 1e-3, as in
``test_torch_slice.py``.

What still differs is fp32 rounding of the images: jitted, XLA divides
dct_tpu's uint8 images by 255 as a multiply by the fp32 reciprocal, which
is one ulp off the true quotient for 126 of the 256 values; the port
divides (as dct_tpu does un-jitted, where the two agree to 1e-14). VAT adds
ξ·d = 1e-6·d to those fp32 images and FGSM takes a sign, so the ulp moves
the adversarial images, and through them the losses and updates of
iteration 1; the tolerances below say by how much.

One dct_tpu epoch is compiled (~40 s of tracing and ~100 s of XLA
compilation here), at XLA's lowest backend optimisation level, which
halves the compile and changes no operation.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dct_tpu.losses import get_loss_fn as jax_get_loss_fn
from dct_tpu.train.city import make_city_cotrain_epoch as jax_make_city_epoch
from dct_tpu_torch.losses import get_loss_fn
from dct_tpu_torch.models import Segmentator
from dct_tpu_torch.train.city import make_city_cotrain_epoch
from dct_tpu_torch.utils.convert import params_from_jax_stacked, params_to_jax
from test_torch_jaxref import float64_logits, jax_segmentator, one_torch_thread  # noqa: F401

K, B, H, W, T, N, C = 2, 2, 16, 32, 2, 12, 19
LR, LAM_COT, LAM_ADV, EPS = 1e-3, 1.0, 0.005, 0.03
ARCH = {"name": "enet", "num_classes": C, "in_channels": 3}
ADAM = {"name": "Adam", "lr": LR, "weight_decay": 2e-4, "eps": 1e-3}
STEP = {"name": "StepLR", "step_size": 100, "gamma": 0.1}
WEIGHT = [3.3632, 14.0408, 4.9860, 39.2617, 36.5217, 32.8975, 46.2848, 40.6888, 6.6957,
          33.5658, 18.4602, 32.9788, 47.6773, 12.7070, 45.2075, 45.7849, 45.8268,
          48.4074, 42.7600]
FLAGS = np.array([[True, False], [False, True]])


def port_models():
    return [Segmentator(ARCH, ADAM, STEP, torch.Generator().manual_seed(i), device="cpu")
            for i in range(K)]


@pytest.fixture(scope="module")
def data():
    rs = np.random.RandomState(0)
    trees = [params_to_jax(s.net.state_dict()) for s in port_models()]
    gt = rs.randint(0, C, (N, H, W))
    gt[rs.rand(N, H, W) < 0.2] = 250                     # void pixels
    return {"params": jax.tree_util.tree_map(lambda *a: np.stack(a), *[t[0] for t in trees]),
            "batch_stats": jax.tree_util.tree_map(lambda *a: np.stack(a),
                                                  *[t[1] for t in trees]),
            "img": rs.randint(0, 256, (N, H, W, 3)).astype(np.uint8),
            "gt": gt.astype(np.uint8),
            "idx": [rs.randint(0, N, shape).astype(np.int32)
                    for shape in ((T, K, B), (T, B), (T, 2, B), (T, 2, B))]}


@pytest.fixture(scope="module")
def jax_seg(data):
    """dct_tpu's Segmentator around model 0's weights (its apply functions
    serve the stacked state)."""
    with jax.enable_x64(True):
        seg = jax_segmentator(jax.tree_util.tree_map(lambda a: a[0], data["params"]),
                              jax.tree_util.tree_map(lambda a: a[0], data["batch_stats"]),
                              optim=ADAM, arch=ARCH, sched=STEP)
    float64_logits(seg)
    return seg


@pytest.fixture(scope="module")
def jax_run(data, jax_seg):
    with jax.enable_x64(True):
        seg = jax_seg
        params = jax.tree_util.tree_map(jnp.asarray, data["params"])
        state = {"params": params,
                 "batch_stats": jax.tree_util.tree_map(jnp.asarray, data["batch_stats"]),
                 "opt_state": seg.tx.init(params)}
        key = jax.random.PRNGKey(5)
        epoch = jax_make_city_epoch(seg, K, C, jax_get_loss_fn(
            "cross_entropy", ignore_index=250, weight=WEIGHT), True, True, EPS, EPS)
        args = (state, jnp.asarray(data["img"]), jnp.asarray(data["gt"]), *data["idx"], FLAGS,
                key, LR, LAM_COT, LAM_ADV)
        compiled = epoch.lower(*args).compile(compiler_options={
            "xla_backend_optimization_level": 0, "xla_llvm_disable_expensive_passes": True})
        new, metrics = compiled(*args)
        keys = jax.random.split(key, T)
        noise = np.stack([np.stack([np.asarray(jax.random.normal(
            jax.random.fold_in(keys[t], 7 + d), (B, H, W, 3), jnp.float32))
            for d in range(2)]) for t in range(T)])
        return {"metrics": jax.tree_util.tree_map(np.asarray, metrics), "noise": noise,
                "new": params_from_jax_stacked(
                    jax.tree_util.tree_map(np.asarray, new["params"]),
                    jax.tree_util.tree_map(np.asarray, new["batch_stats"]), K)}


@pytest.fixture(scope="module")
def torch_run(data, jax_seg, jax_run):
    segs = port_models()
    for s, sd in zip(segs, params_from_jax_stacked(data["params"], data["batch_stats"], K)):
        s.net.load_state_dict(sd)
    float64_logits(jax_seg, *segs)
    epoch = make_city_cotrain_epoch(segs, C, get_loss_fn(
        "cross_entropy", ignore_index=250, weight=WEIGHT), True, True, EPS, EPS)
    metrics = epoch(torch.from_numpy(data["img"]), torch.from_numpy(data["gt"]),
                    *data["idx"], FLAGS, None, LR, LAM_COT, LAM_ADV,
                    vat_noise=torch.from_numpy(jax_run["noise"]))
    return {"metrics": {k: v.numpy() for k, v in metrics.items()},
            "new": [{k: v.clone() for k, v in s.net.state_dict().items()} for s in segs]}


# The losses, absolute: float64 and fp32-image rounding at iteration 0
# (measured: sup 2.2e-8, jsd 1.8e-9, adv 2.0e-8); iteration 1 after the
# moved adversarial images (measured: sup 3.0e-7, jsd 4.4e-9, adv 1.9e-6)
LOSS_TOL = {"sup_loss": (1e-7, 2e-6), "jsd_loss": (1e-8, 1e-7), "adv_loss": (1e-7, 1e-5)}


@pytest.mark.parametrize("name", sorted(LOSS_TOL))
def test_city_losses(jax_run, torch_run, name):
    ref, got = jax_run["metrics"][name], torch_run["metrics"][name]
    assert ref.shape == got.shape and ref.shape[0] == T
    for t, tol in enumerate(LOSS_TOL[name]):
        np.testing.assert_allclose(got[t], ref[t], rtol=0, atol=tol,
                                   err_msg=f"{name} at iteration {t}")
    if name == "adv_loss":
        assert (got > 0).all()


@pytest.mark.parametrize("model", range(K))
def test_city_parameters(jax_run, torch_run, model):
    """Each model's parameters after two Adam steps, relative to each
    parameter's magnitude (at least 1): a few fp32 ulps, and what the
    image ulps above move through FGSM's sign and VAT. Both sides repeat
    themselves to the bit: dct_tpu's compiled epoch rerun and recompiled
    in one process, the port's epoch rerun at 1 and at 8 torch threads
    (within 2.4e-15 of each other). Five fresh processes read the same
    values: 6.5e-7 (model 0, ``bottleneck_1_1.mid_conv``) and 1.39e-5
    (model 1, ``bottleneck_2_15.proj_out``)."""
    ref, got = jax_run["new"][model], torch_run["new"][model]
    for k in (k for k in ref if "running" not in k):
        err = float(((got[k].double() - ref[k].double()).abs()
                     / ref[k].double().abs().clamp_min(1.0)).max())
        assert err < 2e-5, (k, err)


@pytest.mark.parametrize("model", range(K))
def test_city_running_statistics(jax_run, torch_run, model):
    """Only the fused forward's two updates (labeled, then unlabeled) of
    each iteration reach the running statistics: none of the FGSM, VAT,
    clean or adversarial forwards do, in dct_tpu as in the port. fp32
    statistics, dct_tpu's composed in fp32 (m·kg_lab + kg_unlab − m·r0),
    the port's sequentially: a few ulps of each leaf's scale (measured
    1.2e-6)."""
    ref, got = jax_run["new"][model], torch_run["new"][model]
    for k in (k for k in ref if "running" in k):
        scale = max(1.0, float(ref[k].abs().max()))
        assert float((got[k] - ref[k]).abs().max()) <= 5e-6 * scale, k
