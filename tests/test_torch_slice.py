"""The first slice of dct_tpu_torch as a whole against dct_tpu, on the CPU:
ENet through the weight bridge, and two co-training iterations held against
``dct_tpu.train.steps.make_cotrain_epoch`` (K=2, B=Bu=2, 32×32, jsd + FGSM +
augmentation, ``fuse_forward=False``), fed the same weights, batch indices
and dct_tpu's own augmentation thetas.

Precision. Parameters, optimizer state, images, logits and losses are fp32
on both sides; the networks compute in float64 (``compute_dtype``, JAX in
64-bit mode). In fp32 compute the comparison would measure rounding, not
the port: at this size dct_tpu's own fp32 CPU forward puts its input
gradient ~4 % of the gradient's scale off its float64 value (the port's is
~0.4 %), and FGSM's sign and the pseudo-labels' argmax turn that into
discrete flips. With float64 compute the ENet checks agree to 1e-9, and the
co-training losses of iteration 0 to fp32 rounding. Discontinuities remain:
at iteration 1 one pseudo-label near-tie flips, which moves the FGSM input
gradient by ~1 % near that pixel and flips the sign of a few pixels; the
iteration-1 adv loss, model a's update and its adversarial BatchNorm
statistics carry that, and their tolerances say so.

A second case holds the parallel tests' co-training case at its 16²
(``parallel/dryrun.py:CASE``) against dct_tpu's compiled epoch, with
dct_tpu's thetas and float64 logits on both sides.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dct_tpu.data.augment import sample_aug_thetas as jax_sample_aug_thetas
from dct_tpu.losses import get_loss_fn as jax_get_loss_fn
from dct_tpu.models import Segmentator as JaxSegmentator
from dct_tpu.models.enet import Enet as JaxEnet
from dct_tpu.train.steps import make_cotrain_epoch as jax_make_cotrain_epoch
from dct_tpu.utils.torch_convert import convert_enet
from dct_tpu_torch.losses import get_loss_fn
from dct_tpu_torch.models import Segmentator
from dct_tpu_torch.models.enet import Enet
from dct_tpu_torch.models.layers import init_weights_
from dct_tpu_torch.parallel.dryrun import cotrain_case, max_rel_diff
from dct_tpu_torch.train.steps import make_cotrain_epoch
from dct_tpu_torch.utils.convert import params_from_jax, params_from_jax_stacked
from test_torch_parallel_ref import jax_cotrain, loss_gaps
from test_torch_parallel_workers import _apply_train_f64

K, B, H, T, N, C = 2, 2, 32, 2, 16, 4
LR = 1e-3
ARCH = {"name": "enet", "num_classes": C}
# eps 1e-3 instead of Adam's 1e-8: conv biases ahead of a train-mode
# BatchNorm have an exactly-zero gradient, which each framework computes as
# rounding noise; with eps 1e-8 Adam would turn that noise into ±lr steps
ADAM = {"name": "Adam", "lr": LR, "weight_decay": 1e-4, "eps": 1e-3}
STEP = {"name": "StepLR", "step_size": 90, "gamma": 0.1}


def to_numpy(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def jax_run():
    """dct_tpu's side: two ENets (the second a numpy-seeded perturbation of
    the first), one compiled two-iteration co-training epoch."""
    with jax.enable_x64(True):
        return _jax_run()


def _jax_run():
    seg = JaxSegmentator({**ARCH, "compute_dtype": "float64"}, ADAM, STEP,
                         jax.random.PRNGKey(0), input_shape=(1, H, H, 1))
    rs = np.random.RandomState(0)
    p0 = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32),
                                seg.state["params"])
    p1 = jax.tree_util.tree_map(
        lambda a: (a * rs.uniform(0.8, 1.2, a.shape)).astype(np.float32), p0)
    bs = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32),
                                seg.state["batch_stats"])
    params = jax.tree_util.tree_map(lambda a, b: np.stack([a, b]), p0, p1)
    batch_stats = jax.tree_util.tree_map(lambda a: np.stack([a, a]), bs)
    state = {"params": jax.tree_util.tree_map(jnp.asarray, params),
             "batch_stats": jax.tree_util.tree_map(jnp.asarray, batch_stats)}
    state["opt_state"] = seg.tx.init(state["params"])

    img = rs.randint(0, 255, (N, H, H), dtype=np.uint8)
    gt = rs.randint(0, C, (N, H, H)).astype(np.uint8)
    idx_lab = rs.randint(0, N, (T, K, B)).astype(np.int32)
    idx_unlab = rs.randint(0, N, (T, B)).astype(np.int32)
    pairs = np.tile(np.array([0, 1], np.int32), (T, 1))
    key = jax.random.PRNGKey(11)
    epoch = jax_make_cotrain_epoch(seg, K, C, jax_get_loss_fn("cross_entropy"),
                                   True, True, True, True, 0.03,
                                   fuse_forward=False)
    new_state, metrics = epoch(state, jnp.asarray(img), jnp.asarray(gt),
                               idx_lab, idx_unlab, pairs, key, LR, 0.5, 0.05)
    # the thetas the epoch drew (steps.py: fold_in(k_t, i) per labeled
    # stream, fold_in(k_t, 101) for the unlabeled one)
    keys = jax.random.split(key, T)
    thetas = np.stack([np.concatenate(
        [np.asarray(jax_sample_aug_thetas(jax.random.fold_in(keys[t], i), B, H, H))
         for i in range(K)]
        + [np.asarray(jax_sample_aug_thetas(jax.random.fold_in(keys[t], 101), B, H, H))])
        for t in range(T)])
    return {"params": params, "batch_stats": batch_stats, "img": img, "gt": gt,
            "idx_lab": idx_lab, "idx_unlab": idx_unlab, "thetas": thetas,
            "metrics": to_numpy(metrics),
            "new": params_from_jax_stacked(to_numpy(new_state["params"]),
                                           to_numpy(new_state["batch_stats"]), K)}


@pytest.fixture(scope="module")
def torch_run(jax_run):
    """The port's side: the same weights through the bridge, the same
    indices and thetas."""
    segs = [Segmentator(ARCH, ADAM, STEP, torch.Generator().manual_seed(0),
                        device="cpu") for _ in range(K)]
    initial = params_from_jax_stacked(jax_run["params"], jax_run["batch_stats"], K)
    for s, sd in zip(segs, initial):
        s.net.load_state_dict(sd)
        s.compute_dtype = torch.float64     # the network arithmetic only
    epoch = make_cotrain_epoch(segs, C, get_loss_fn("cross_entropy"),
                               True, True, True, True, 0.03, fuse_forward=False)
    metrics = epoch(torch.from_numpy(jax_run["img"]), torch.from_numpy(jax_run["gt"]),
                    jax_run["idx_lab"], jax_run["idx_unlab"], None, None, LR,
                    0.5, 0.05, thetas=torch.from_numpy(jax_run["thetas"]))
    return {"metrics": {k: v.numpy() for k, v in metrics.items()},
            "initial": initial,
            "new": [{k: v.clone() for k, v in s.net.state_dict().items()} for s in segs]}


# (iteration 0, iteration 1) absolute tolerances: fp32 rounding of the
# losses, except the iteration-1 adv term, which sees the flipped pixels
# (measured 1.1e-3 on a loss of 0.16).
LOSS_TOL = {"sup_loss": (1e-5, 1e-5), "jsd_loss": (1e-5, 1e-5),
            "adv_loss": (1e-5, 5e-3)}


@pytest.mark.parametrize("name", sorted(LOSS_TOL))
def test_cotrain_losses(jax_run, torch_run, name):
    ref, got = jax_run["metrics"][name], torch_run["metrics"][name]
    assert ref.shape == got.shape
    for t, tol in enumerate(LOSS_TOL[name]):
        np.testing.assert_allclose(got[t], ref[t], rtol=0, atol=tol,
                                   err_msg=f"{name} at iteration {t}")


@pytest.mark.parametrize("name", ["lab_dice", "unlab_dice"])
def test_cotrain_dice(jax_run, torch_run, name):
    """Hard dice rows: an argmax flip at a near-tied pixel moves a row by
    ~1/(pixels of that class); 0.02 admits a few flips per row."""
    ref, got = jax_run["metrics"][name], torch_run["metrics"][name]
    assert ref.shape == got.shape == (T, K, B, C)
    np.testing.assert_allclose(got, ref, rtol=0, atol=0.02)


# model b (1) sees no flip in its gradient: its update agrees to fp32
# rounding. Model a (0) takes the adversarial term at iteration 1 (measured:
# cosine 0.99998, largest element 3.4e-4 = 0.34·lr).
PARAM_TOL = {0: (0.9999, 0.5 * LR), 1: (0.999999, 1e-6)}


@pytest.mark.parametrize("model", range(K))
def test_cotrain_parameters(jax_run, torch_run, model):
    """Each model's two-step parameter update (new − initial), flattened:
    cosine similarity to dct_tpu's and the largest element difference."""
    ref_new = jax_run["new"][model]
    got_new, start = torch_run["new"][model], torch_run["initial"][model]
    keys = [k for k in ref_new if "running" not in k]
    ref_upd = torch.cat([(ref_new[k] - start[k]).flatten() for k in keys])
    got_upd = torch.cat([(got_new[k] - start[k]).flatten() for k in keys])
    min_cos, max_diff = PARAM_TOL[model]
    cos = float(torch.nn.functional.cosine_similarity(ref_upd, got_upd, dim=0))
    assert cos > min_cos, cos
    assert float((ref_upd - got_upd).abs().max()) < max_diff


# Running statistics after six train-mode forwards in dct_tpu's order,
# relative to each leaf's scale: model b agrees to fp32 rounding; model a's
# adversarial forward at iteration 1 sees the flipped pixels (measured 0.026
# on a running variance of ~10).
BS_TOL = {0: 1e-2, 1: 1e-5}


@pytest.mark.parametrize("model", range(K))
def test_cotrain_batch_stats(jax_run, torch_run, model):
    ref, got = jax_run["new"][model], torch_run["new"][model]
    for k in (k for k in ref if "running" in k):
        scale = max(1.0, float(ref[k].abs().max()))
        assert float((got[k] - ref[k]).abs().max()) <= BS_TOL[model] * scale, k


@pytest.fixture(scope="module")
def enet_ref(jax_run):
    """dct_tpu's ENet (model 0's weights) in float64, both ``fast_paths``,
    on a tie-dense input; plus the bf16 forward dct_tpu's Segmentator runs."""
    variables = {"params": jax.tree_util.tree_map(lambda a: a[0], jax_run["params"]),
                 "batch_stats": jax.tree_util.tree_map(lambda a: a[0], jax_run["batch_stats"])}
    rs = np.random.RandomState(1)
    x = rs.randint(0, 4, (2, H, H, 1)) / 3.0            # dense in ties
    gt = rs.randint(0, C, (2, H, H))
    ce = jax_get_loss_fn("cross_entropy")

    def run(v, v_bf16, xx):
        out = {}
        for fast in (True, False):
            net = JaxEnet(num_classes=C, fast_paths=fast)
            logits, mut = net.apply(v, xx, train=True, mutable=["batch_stats"])
            out[f"train_{fast}"] = logits
            out[f"stats_{fast}"] = mut["batch_stats"]
            out[f"eval_{fast}"] = net.apply(v, xx, train=False)
        out["input_grad"] = jax.grad(lambda t: ce(JaxEnet(num_classes=C).apply(
            v, t, train=True, mutable=["batch_stats"])[0], gt))(xx)
        out["train_bf16"] = JaxEnet(num_classes=C).apply(
            v_bf16, xx.astype(jnp.bfloat16), train=True,
            mutable=["batch_stats"])[0].astype(jnp.float32)
        return out

    with jax.enable_x64(True):
        v64 = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64), variables)
        v_bf16 = {"params": jax.tree_util.tree_map(
            lambda a: jnp.asarray(a, jnp.bfloat16), variables["params"]),
            "batch_stats": jax.tree_util.tree_map(jnp.asarray, variables["batch_stats"])}
        out = to_numpy(jax.jit(run)(v64, v_bf16, jnp.asarray(x, jnp.float64)))
    return {"variables": variables, "x": x, "gt": gt, "out": out}


def port_enet(variables, dtype):
    net = Enet(C).to(dtype)
    net.load_state_dict(params_from_jax(
        jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64 if dtype == torch.float64
                                                    else np.float32), variables["params"]),
        jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64 if dtype == torch.float64
                                                    else np.float32), variables["batch_stats"])))
    return net.to(memory_format=torch.channels_last)


def test_enet_float64_matches_dct_tpu(enet_ref):
    """Eval logits, train logits, running statistics after one forward and
    the CE input gradient, in float64: equal to 1e-9 (rounding only). Input
    gradients are held to ``fast_paths=True`` only: the two dct_tpu forms
    split a tie in the initial pool's gradient differently."""
    out = enet_ref["out"]
    net = port_enet(enet_ref["variables"], torch.float64)
    x = torch.from_numpy(enet_ref["x"])
    net.eval()
    with torch.no_grad():
        eval_logits = net(x).numpy()
    for fast in (True, False):
        np.testing.assert_allclose(eval_logits, out[f"eval_{fast}"], rtol=0, atol=1e-9)
    net.train()
    xr = x.clone().requires_grad_(True)
    logits = net(xr)
    (grad,) = torch.autograd.grad(
        get_loss_fn("cross_entropy")(logits, torch.from_numpy(enet_ref["gt"])), [xr])
    for fast in (True, False):
        np.testing.assert_allclose(logits.detach().numpy(), out[f"train_{fast}"],
                                   rtol=0, atol=1e-9)
    np.testing.assert_allclose(grad.numpy(), out["input_grad"], rtol=0, atol=1e-12)
    stats = params_from_jax({}, out["stats_True"])
    sd = net.state_dict()
    for k, v in stats.items():
        np.testing.assert_allclose(sd[k].numpy(), v.numpy(), rtol=0, atol=1e-9, err_msg=k)


def test_enet_bf16_close_to_dct_tpu(enet_ref):
    """bf16 forwards round at different places (dct_tpu also normalises in
    bf16, the port in fp32), so the two are not held to each other but to
    the float64 forward: the port's bf16 logits may deviate from it by at
    most 1.5× dct_tpu's own bf16 deviation (mean absolute error)."""
    exact, ref = enet_ref["out"]["train_True"], enet_ref["out"]["train_bf16"]
    net = port_enet(enet_ref["variables"], torch.float32).train()
    with torch.no_grad():
        got = net(torch.from_numpy(enet_ref["x"]).to(torch.bfloat16)).float().numpy()
    assert np.isfinite(got).all()
    assert np.abs(got - exact).mean() <= 1.5 * np.abs(ref - exact).mean()


def _reference_key(key: str) -> str:
    """Port state_dict key → the reference torch ENet's key, the layout that
    ``dct_tpu.utils.torch_convert.convert_enet`` reads."""
    block, rest = key.split(".", 1)
    if block == "initial":
        sub, leaf = rest.split(".")
        sub = {"Conv_0": "conv", "BatchNorm_0": "batch_norm", "PReLU_0": "prelu"}[sub]
        return f"encoder.initial.{sub}.{'weight' if leaf == 'alpha' else leaf}"
    if block == "fullconv":
        return f"decoder.layers.5.{rest}"
    stage, idx = int(block.split("_")[1]), int(block.split("_")[2])
    if stage in (1, 2):
        prefix = (f"encoder.bottleneck_3_{idx - 8}" if stage == 2 and idx > 8
                  else f"encoder.{block}")
    else:
        prefix = "decoder.layers." + str({(4, 0): 0, (4, 1): 1, (4, 2): 2,
                                          (5, 0): 3, (5, 1): 4}[(stage, idx)])
    sub, leaf = rest.split(".")
    sub = {"proj_in": "block1x1_1.0", "bn_in": "block1x1_1.1", "act_in": "block1x1_1.2",
           "proj_out": "block1x1_2.0", "bn_out": "block1x1_2.1", "act_out": "block1x1_2.2",
           "unpool_proj": "conv_before_unpool.0", "bn_unpool": "conv_before_unpool.1",
           "mid_conv": "middle_block.0", "mid_deconv": "middle_block.0",
           "mid_conv_a": "middle_block.0.0", "mid_conv_b": "middle_block.0.1",
           "bn_mid": "middle_block.1", "act_mid": "middle_block.2"}[sub]
    return f"{prefix}.{sub}.{'weight' if leaf == 'alpha' else leaf}"


def test_bridge_round_trip_through_convert_enet(jax_run):
    """flax trees → port state_dict → (reference torch names) →
    ``convert_enet`` → the same flax trees, leaf for leaf, exactly."""
    params = jax.tree_util.tree_map(lambda a: a[1], jax_run["params"])
    stats = jax.tree_util.tree_map(lambda a: a[1], jax_run["batch_stats"])
    sd = params_from_jax(params, stats)
    back = convert_enet({_reference_key(k): v for k, v in sd.items()})
    flat = dict(jax.tree_util.tree_leaves_with_path(back["params"]))
    ref = dict(jax.tree_util.tree_leaves_with_path(params))
    assert flat.keys() == ref.keys()
    for path, leaf in ref.items():
        np.testing.assert_array_equal(np.asarray(flat[path]), leaf, err_msg=str(path))
    for path, leaf in jax.tree_util.tree_leaves_with_path(stats):
        got = dict(jax.tree_util.tree_leaves_with_path(back["batch_stats"]))[path]
        np.testing.assert_array_equal(np.asarray(got), leaf)


def test_init_matches_dct_tpu_distribution(jax_run):
    """The port's own init (xavier-normal kernels, BN scale N(1, 0.02)) draws
    from dct_tpu's distributions: per-leaf std within 15 % for leaves of
    ≥ 1000 elements, BN scales centred on 1 with std ≈ 0.02."""
    net = Enet(C)
    init_weights_(net, torch.Generator().manual_seed(0))
    ref = params_from_jax(jax.tree_util.tree_map(lambda a: a[0], jax_run["params"]), {})
    sd = net.state_dict()
    for k, v in ref.items():
        assert sd[k].shape == v.shape, k
        if k.endswith("weight") and v.dim() == 4 and v.numel() >= 1000:
            assert abs(float(sd[k].std()) / float(v.std()) - 1) < 0.15, k
    scales = torch.cat([sd[k] for k in sd if ".bn" in k and k.endswith("weight")])
    assert abs(float(scales.mean()) - 1) < 0.01
    assert abs(float(scales.std()) - 0.02) < 0.005


# ---- the 16² case -------------------------------------------------------------
# The co-training parity case of the parallel tests at its own 16²
# (``parallel/dryrun.py:CASE``: K = 2, B = Bu = 4, Adam, JSD, FGSM and both
# augmentations, the fused forward), float64 logits on both sides, the
# port fed dct_tpu's thetas. At 16² ENet's second pool works on 4×4 maps;
# the FGSM terms agree there (``test_torch_enet16.py``), and so does the
# whole epoch: measured 4.0e-8 (sup), 1.3e-8 (jsd) and 1.1e-8 (adv) on the
# losses, 3.7e-7 (params) and 7.4e-7 (statistics) of scale. Bounds as the
# data-parallel tests' against dct_tpu (fp32 parameters and rounding).
CASE16_TOL = {"sup_loss": 1e-6, "jsd_loss": 1e-6, "adv_loss": 1e-6, "params": 1e-5,
              "stats": 1e-5}


@pytest.fixture(scope="module")
def runs16():
    ref = jax_cotrain({}, f64_logits=True)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(Segmentator, "apply_train", _apply_train_f64)
        got = cotrain_case(0, 1, {"compute": "float64", "thetas": ref["thetas"]})
    return ref, got


@pytest.mark.parametrize("quantity", sorted(CASE16_TOL))
def test_cotrain_16_matches_dct_tpu(runs16, quantity):
    ref, got = runs16
    if quantity in ("params", "stats"):
        gap = max_rel_diff(got["models"], ref["models"], stats=quantity == "stats")
    else:
        gap = loss_gaps(ref, got)[quantity]
    assert gap <= CASE16_TOL[quantity], gap
