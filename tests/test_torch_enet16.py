"""One ENet at 16² against dct_tpu, on the CPU, in float64 on both sides
(parameters fp32, the network and its logits float64): FGSM's pool masks,
input gradient and sign against dct_tpu's un-jitted apply; the
``FSGMGenerator`` shim, the eval steps' ``loss_weight`` and
``Segmentator.predict(logit=False)`` against dct_tpu's jitted functions.
(The ``VATGenerator`` shim is held in ``test_torch_vat.py``, in the
compile of dct_tpu's ``vat_perturbation`` there.)

The weights are the port's init of the co-training parity case's model b
(``parallel/dryrun.py:CASE``, seed 1), carried to dct_tpu by
``utils/convert.py:params_to_jax``; the input is that case's first FGSM
batch: model b's 4 labeled and the 4 unlabeled 16² images, warped by the
case's thetas (zero-filled corners included), the labeled rows' labels,
and argmax pseudo-labels for the rest.

At 16², ENet's second pool (``bottleneck_2_0``) works on 4×4 maps. The two
frameworks' pool masks agree there exactly, their input gradients to
float64 rounding, and FGSM's signs everywhere: nothing of FGSM parts at 16²
(ROADMAP §3, closed item a). dct_tpu runs that one forward and backward
un-jitted, op by op (its compiled float64 steps round otherwise and flip
signs on warped images; ROADMAP's traps): it compiles each of ~770
operations, most of this file's time.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dct_tpu.models.enet as jax_enet
import dct_tpu_torch.models.enet as port_enet
from dct_tpu.adversarial import FSGMGenerator as JaxFSGMGenerator
from dct_tpu.losses import get_loss_fn as jax_get_loss_fn
from dct_tpu.train.steps import _masked_ce as jax_masked_ce
from dct_tpu.train.steps import make_eval_patient_step as jax_make_eval_patient_step
from dct_tpu_torch.adversarial import FSGMGenerator
from dct_tpu_torch.data.augment import augment_batch_with_thetas
from dct_tpu_torch.data.pipeline import normalize_gather
from dct_tpu_torch.losses import get_loss_fn
from dct_tpu_torch.models import Segmentator
from dct_tpu_torch.parallel.dryrun import CASE, case_inputs
from dct_tpu_torch.train.steps import (_masked_ce, make_eval_all_models_step,
                                       make_eval_all_step, make_eval_patient_step)
from dct_tpu_torch.utils.convert import params_to_jax
from test_torch_jaxref import ADAM, ARCH, STEP, float64_logits, jax_segmentator
from test_torch_jaxref import one_torch_thread  # noqa: F401  (autouse)

H, B, K, b = 16, 4, 2, 1
EPS_FGSM = 0.03
LOSS_WEIGHT = [0.5, 2.0, 1.0, 4.0]
MASKS = ["bottleneck_1_0", "bottleneck_2_0"]


def port_model():
    seg = Segmentator(ARCH, ADAM, STEP, torch.Generator().manual_seed(b), device="cpu")
    seg.compute_dtype = torch.float64
    return seg


@pytest.fixture(scope="module")
def inputs():
    inp = case_inputs({**CASE, "H": H})
    img_u8, gt_u8 = torch.from_numpy(inp["img"]), torch.from_numpy(inp["gt"])
    th = torch.from_numpy(inp["thetas"][0])
    lab = augment_batch_with_thetas(
        *normalize_gather(img_u8, gt_u8, torch.from_numpy(inp["idx_lab"][0, b]).long()),
        th[b * B:(b + 1) * B])
    unlab = augment_batch_with_thetas(
        *normalize_gather(img_u8, gt_u8, torch.from_numpy(inp["idx_unlab"][0]).long()),
        th[K * B:])
    return {"x": torch.cat([lab[0], unlab[0]]), "gt": lab[1], "img_u8": inp["img"],
            "gt_u8": inp["gt"], "weights": params_to_jax(port_model().net.state_dict())}


def recording(fn, seen):
    """``fn``, a pool returning (pooled, mask), that also keeps each mask."""
    def pool(v):
        pooled, mask = fn(v)
        seen.append(np.asarray(mask))
        return pooled, mask
    return pool


@pytest.fixture(scope="module")
def eager(inputs):
    """Both sides' FGSM pass, one train-mode forward and the CE input
    gradient (labels for the labeled rows, argmax pseudo-labels for the
    rest): pool masks, gradient and logits; dct_tpu's un-jitted."""
    x, gt = inputs["x"], inputs["gt"]
    params, batch_stats = inputs["weights"]
    p, r = {"masks": []}, {"masks": []}

    seg = port_model()
    float64_logits(jax_segmentator(params, batch_stats), seg)
    ce = get_loss_fn("cross_entropy")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(port_enet, "max_pool_2x2_with_mask_kernel",
                   recording(port_enet.max_pool_2x2_with_mask_kernel, p["masks"]))
        xx = x.double().requires_grad_(True)
        logits = seg.apply_train(xx)
        target = torch.cat([gt, torch.argmax(logits[B:].detach(), dim=-1)])
        (g,) = torch.autograd.grad(ce(logits, target), [xx])
    p["grad"], p["logits"] = g.numpy(), logits.detach().numpy()

    with jax.enable_x64(True), jax.disable_jit():
        jseg = jax_segmentator(params, batch_stats)
        float64_logits(jseg)
        jce = jax_get_loss_fn("cross_entropy")
        st = jseg.state
        gtj = jnp.asarray(gt.numpy().astype(np.int32))

        def loss(v):
            out_, _ = jseg.apply_train(st["params"], st["batch_stats"], v)
            pseudo = jnp.argmax(jax.lax.stop_gradient(out_[B:]), axis=-1)
            return jce(out_, jnp.concatenate([gtj, pseudo])), out_
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(jax_enet, "max_pool_2x2_with_mask",
                       recording(jax_enet.max_pool_2x2_with_mask, r["masks"]))
            gj, lj = jax.grad(loss, has_aux=True)(jnp.asarray(x.numpy(), jnp.float64))
    r["grad"], r["logits"] = np.asarray(gj), np.asarray(lj)
    return {"port": p, "jax": r}


@pytest.fixture(scope="module")
def runs(inputs):
    """Both sides' FSGMGenerator, eval steps and ``predict``, dct_tpu's
    jitted."""
    x, gt = inputs["x"], inputs["gt"]
    params, batch_stats = inputs["weights"]
    bucket = {"idx": np.arange(3, 11).astype(np.int32), "mask": np.arange(8) < 5}
    img_u8, gt_u8 = inputs["img_u8"], inputs["gt_u8"]
    p, r = {}, {}

    with jax.enable_x64(True):
        jseg = jax_segmentator(params, batch_stats)
        float64_logits(jseg)
        jce = jax_get_loss_fn("cross_entropy")
        st = jseg.state
        xj, gtj = jnp.asarray(x.numpy()), jnp.asarray(gt.numpy().astype(np.int32))
        r["fgsm"] = [np.asarray(t) for t in jax.jit(
            lambda pr, bs, v, t: JaxFSGMGenerator(jseg.apply_train, EPS_FGSM)(
                pr, bs, v, t, jce)[:3])(st["params"], st["batch_stats"], xj, gtj)]
        r["eval"] = {w is None: {k: np.asarray(v) for k, v in jax_make_eval_patient_step(
            jseg, 4, w)(st["params"], st["batch_stats"], jnp.asarray(img_u8),
                        jnp.asarray(gt_u8), jnp.asarray(bucket["idx"]),
                        jnp.asarray(bucket["mask"])).items()} for w in (None, LOSS_WEIGHT)}
        r["probs"] = np.asarray(jax.jit(lambda v: jseg.predict(v, logit=False))(xj))

    seg = port_model()
    float64_logits(jax_segmentator(params, batch_stats), seg)
    ce = get_loss_fn("cross_entropy")
    p["fgsm"] = [t.numpy() for t in FSGMGenerator(seg, EPS_FGSM)(x, gt, ce)]
    fresh = port_model()
    u8 = torch.from_numpy(img_u8), torch.from_numpy(gt_u8)
    p["eval"] = {w is None: {k: v.numpy() for k, v in make_eval_patient_step(fresh, 4, w)(
        *u8, bucket["idx"], bucket["mask"]).items()} for w in (None, LOSS_WEIGHT)}
    p["eval_all"] = {k: v.numpy() for k, v in make_eval_all_step(fresh, 4, LOSS_WEIGHT)(
        *u8, bucket["idx"][None], bucket["mask"][None]).items()}
    p["eval_all_models"] = {k: v.numpy() for k, v in make_eval_all_models_step(
        [fresh, fresh], 4, LOSS_WEIGHT)(*u8, bucket["idx"][None], bucket["mask"][None]).items()}
    p["probs"] = fresh.predict(x, logit=False).numpy()
    p["logits_eval"] = fresh.predict(x).numpy()
    return {"port": p, "jax": r}


def test_fgsm_pool_masks_equal_at_16(eager):
    """Each downsampling bottleneck's argmax mask of the FGSM forward, bit
    for bit."""
    got, ref = eager["port"]["masks"], eager["jax"]["masks"]
    assert len(got) == len(ref) == len(MASKS)
    for name, m, r in zip(MASKS, got, ref):
        assert m.shape == r.shape, (name, m.shape, r.shape)
        np.testing.assert_array_equal(m, r, err_msg=name)
    assert got[1].shape == (2 * B, H // 4, H // 4, 64)       # 4×4 maps at bottleneck_2_0


def test_fgsm_input_gradient_and_sign_at_16(eager):
    """The float64 input gradient to float64 rounding (measured 1.0e-13
    of scale; the logits 3.8e-13), no exact zero, and FGSM's sign equal at
    every pixel: its smallest magnitude lies far above that rounding
    (measured 7.8e-6 of scale), so no tie and no zero gradient decides a
    sign here."""
    g, r = eager["port"]["grad"], eager["jax"]["grad"]
    scale = np.abs(r).max()
    assert np.abs(g - r).max() <= 1e-11 * scale
    np.testing.assert_allclose(eager["port"]["logits"], eager["jax"]["logits"], rtol=0, atol=1e-11)
    assert (g != 0).all() and (r != 0).all()
    assert np.abs(r).min() > 1e-9 * scale
    np.testing.assert_array_equal(np.sign(g), np.sign(r))


def test_fsgm_generator_matches_dct_tpu(runs):
    """FSGMGenerator's (adversarial image, noise, softmax probabilities):
    the noise ±ε and the image equal, the probabilities of the float64
    logits within 1e-12 (measured 6.5e-14)."""
    (adv, noise, probs), (r_adv, r_noise, r_probs) = runs["port"]["fgsm"], runs["jax"]["fgsm"]
    np.testing.assert_array_equal(noise, r_noise)
    assert set(np.unique(np.abs(noise))) == {np.float32(EPS_FGSM)}
    np.testing.assert_array_equal(adv, r_adv)
    np.testing.assert_allclose(probs, r_probs, rtol=0, atol=1e-12)


@pytest.mark.parametrize("unweighted", [True, False])
def test_eval_patient_step_loss_weight_matches_dct_tpu(runs, unweighted):
    """The eval step with and without class weights: the masked CE within
    5e-6 relative (the fp32 logits of a float64 net; measured 4.3e-7
    unweighted, 6.9e-7 weighted), dice and class maps exactly."""
    got, ref = runs["port"]["eval"][unweighted], runs["jax"]["eval"][unweighted]
    np.testing.assert_allclose(got["loss"], ref["loss"], rtol=5e-6)
    for k in ("dice2d", "dice3d", "pred"):
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
    assert runs["port"]["eval"][True]["loss"] != runs["port"]["eval"][False]["loss"]


def test_eval_all_steps_take_the_loss_weight(runs):
    """``make_eval_all_step`` and ``make_eval_all_models_step`` weight the
    CE as the patient step does."""
    one = runs["port"]["eval"][False]
    for k in ("loss", "dice2d", "dice3d"):
        np.testing.assert_array_equal(runs["port"]["eval_all"][k][0], one[k])
        for m in range(2):
            np.testing.assert_array_equal(runs["port"]["eval_all_models"][k][0, m], one[k])


def test_masked_ce_weight_matches_dct_tpu():
    rs = np.random.RandomState(9)
    logits = rs.randn(5, 6, 7, 4)
    gt = rs.randint(0, 4, (5, 6, 7))
    mask = (np.arange(5) < 3).astype(np.float64)
    with jax.enable_x64(True):
        for w in (None, LOSS_WEIGHT):
            ref = float(jax_masked_ce(jnp.asarray(logits), jnp.asarray(gt), jnp.asarray(mask), w))
            got = float(_masked_ce(torch.from_numpy(logits), torch.from_numpy(gt),
                                   torch.from_numpy(mask),
                                   None if w is None else torch.tensor(w)))
            assert abs(got - ref) <= 1e-14 * abs(ref), (w, got, ref)


def test_predict_softmax_matches_dct_tpu(runs):
    """``predict(logit=False)``: the softmax over the class axis of the
    eval logits, within 1e-6 of dct_tpu's (measured 6.0e-8); rows sum to 1
    within 1e-5."""
    probs = runs["port"]["probs"]
    np.testing.assert_allclose(probs, runs["jax"]["probs"], rtol=0, atol=1e-6)
    np.testing.assert_allclose(probs.sum(-1), 1.0, rtol=0, atol=1e-5)
    np.testing.assert_allclose(
        probs, torch.softmax(torch.from_numpy(runs["port"]["logits_eval"]), -1).numpy(),
        rtol=0, atol=0)
