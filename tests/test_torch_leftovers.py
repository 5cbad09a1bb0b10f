"""The port's host tools and leftovers against dct_tpu, on the CPU, on
inputs made from numpy seeds: ``RateMeter`` and ``trace_epoch``
(``utils/logging.py``), ``PatientBuckets(round_to)``, the data and warp API
(``augment_batch``, ``augment_u8_with_thetas``, ``warp_gather_normalize``,
``make_affine``), the meters of ``metrics.py``, the helpers of
``utils/general.py`` and ``utils/decorators.py``, and ``data/metainfo.py``.

dct_tpu's functions run un-jitted here: jitted, XLA turns the division of
uint8 images by 255 into a multiply by the fp32 reciprocal, one ulp off the
quotient for 126 of the 256 values, while the port and un-jitted dct_tpu
divide. The warps are then held bit-equal, ``make_affine`` within one
float32 ulp (the two frameworks' float32 ``cos`` and ``sin`` may round
differently), and the meters, helpers and metainfo exactly. The port draws
augmentation thetas from a ``torch.Generator`` and dct_tpu from a key, so
both sides warp by the port's thetas.
"""
import json
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dct_tpu.data.augment as jax_augment
import dct_tpu.data.metainfo as jax_metainfo
import dct_tpu.metrics as jax_metrics
import dct_tpu.utils.decorators as jax_decorators
import dct_tpu.utils.general as jax_general
import dct_tpu.utils.logging as jax_logging
from dct_tpu.data.pipeline import PatientBuckets as JaxPatientBuckets
from dct_tpu.data.pipeline import warp_gather_normalize as jax_warp_gather_normalize
from dct_tpu.ops.warp import make_affine as jax_make_affine
from dct_tpu_torch import metrics
from dct_tpu_torch.data import augment, metainfo
from dct_tpu_torch.data.pipeline import PatientBuckets, normalize_gather, warp_gather_normalize
from dct_tpu_torch.ops.warp import make_affine
from dct_tpu_torch.utils import decorators, general
from dct_tpu_torch.utils.logging import RateMeter, trace_epoch

N, H, W, B = 10, 24, 20, 6


@pytest.fixture(scope="module")
def data():
    rs = np.random.RandomState(0)
    img = rs.randint(0, 256, (N, H, W)).astype(np.uint8)
    gt = rs.randint(0, 4, (N, H, W)).astype(np.uint8)
    idx = rs.randint(0, N, B).astype(np.int32)
    thetas = augment.sample_aug_thetas(torch.Generator().manual_seed(3), B, H, W)
    return {"img": img, "gt": gt, "idx": idx, "thetas": thetas}


# ---- utils/logging.py ---------------------------------------------------------

def test_rate_meter_matches_dct_tpu(monkeypatch):
    """The same readings under the same clock: instant rates and the
    smoothed rate after each stop."""
    ticks = [0.0, 0.5, 1.0, 1.25, 2.0, 4.0, 4.0, 4.1]
    seen = []
    for meter in (jax_logging.RateMeter(alpha=0.8), RateMeter(alpha=0.8)):
        clock = iter(ticks)
        monkeypatch.setattr(time, "perf_counter", lambda: next(clock))
        out = []
        for n in (8, 12, 4, 20):
            meter.start()
            out.append((meter.stop(n), meter.rate))
        seen.append(out)
    assert seen[0] == seen[1]
    with pytest.raises(AssertionError):
        RateMeter().stop(1)


def test_trace_epoch_writes_a_cpu_trace(tmp_path):
    """On the CPU the trace lands under ``logdir`` in the TensorBoard
    profiler's layout and names the aten ops that ran."""
    x = torch.randn(64, 64)
    with trace_epoch(tmp_path / "trace", device="cpu") as prof:
        (x @ x).relu().sum()
    assert prof is not None
    files = list((tmp_path / "trace").glob("*.pt.trace.json"))
    assert len(files) == 1, files
    names = {e.get("name", "") for e in json.loads(files[0].read_text())["traceEvents"]}
    assert {"aten::mm", "aten::relu"} <= names, sorted(names)[:20]


def test_trace_epoch_none_is_a_no_op_and_cuda_is_the_default(monkeypatch, tmp_path):
    with trace_epoch(None) as prof:
        pass
    assert prof is None
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        with trace_epoch(tmp_path):
            pass
    assert not any(tmp_path.iterdir())


# ---- data/pipeline.py: PatientBuckets(round_to) ------------------------------

class _Stems:
    def __init__(self, stems):
        self.filenames = stems


@pytest.mark.parametrize("round_to", [1, 4, 8, 16])
def test_patient_buckets_round_to(round_to):
    rs = np.random.RandomState(round_to)
    stems = [f"patient{p:03d}_00_0_{s}" for p in range(5) for s in range(rs.randint(3, 14))]
    ds = _Stems([stems[i] for i in rs.permutation(len(stems))])
    ref = JaxPatientBuckets(ds, r"(patient\d+)_\d+_\d+", round_to=round_to)
    got = PatientBuckets(ds, r"(patient\d+)_\d+_\d+", round_to=round_to)
    assert got.bucket_len == ref.bucket_len and got.bucket_len % round_to == 0
    assert got.patients == ref.patients
    np.testing.assert_array_equal(got.indices, ref.indices)
    np.testing.assert_array_equal(got.mask, ref.mask)


# ---- the data and warp API ----------------------------------------------------

def test_warp_gather_normalize_matches_dct_tpu(data):
    img, gt = warp_gather_normalize(torch.from_numpy(data["img"]), torch.from_numpy(data["gt"]),
                                    torch.from_numpy(data["idx"]), data["thetas"])
    ref_img, ref_gt = jax_warp_gather_normalize(
        jnp.asarray(data["img"]), jnp.asarray(data["gt"]), jnp.asarray(data["idx"]),
        jnp.asarray(data["thetas"].numpy()))
    assert img.shape == (B, H, W, 1) and img.dtype == torch.float32
    np.testing.assert_array_equal(img.numpy(), np.asarray(ref_img))
    np.testing.assert_array_equal(gt.numpy(), np.asarray(ref_gt))
    assert (gt.numpy() == 0).any() and (img.numpy() == 0).any()       # filled corners


def test_augment_u8_with_thetas_matches_dct_tpu(data):
    u8 = [torch.from_numpy(a[data["idx"]]) for a in (data["img"], data["gt"])]
    img, gt = augment.augment_u8_with_thetas(*u8, data["thetas"])
    ref_img, ref_gt = jax_augment.augment_u8_with_thetas(
        *(jnp.asarray(a.numpy()) for a in u8), jnp.asarray(data["thetas"].numpy()))
    np.testing.assert_array_equal(img.numpy(), np.asarray(ref_img))
    np.testing.assert_array_equal(gt.numpy(), np.asarray(ref_gt))


def test_the_three_warp_paths_agree(data):
    """``warp_gather_normalize``, ``augment_u8_with_thetas`` and the
    two-step ``normalize_gather`` → ``augment_batch_with_thetas`` give the
    same bits (dct_tpu pins its own three the same way)."""
    img_u8, gt_u8 = torch.from_numpy(data["img"]), torch.from_numpy(data["gt"])
    idx = torch.from_numpy(data["idx"]).long()
    two_step = augment.augment_batch_with_thetas(*normalize_gather(img_u8, gt_u8, idx),
                                                 data["thetas"])
    for got in (warp_gather_normalize(img_u8, gt_u8, idx, data["thetas"]),
                augment.augment_u8_with_thetas(img_u8[idx], gt_u8[idx], data["thetas"])):
        for a, b in zip(got, two_step):
            assert a.dtype == b.dtype and torch.equal(a, b)


@pytest.mark.parametrize("fast,impl", [(True, "gather"), (True, "shear"), (False, "gather")])
def test_augment_batch_matches_dct_tpu(data, fast, impl):
    """``augment_batch`` warps by the thetas its generator draws: equal to
    ``augment_batch_with_thetas`` on the same draw, and to dct_tpu's warp
    of those thetas (the shear warp and the bilinear image path too)."""
    img, gt = normalize_gather(torch.from_numpy(data["img"]), torch.from_numpy(data["gt"]),
                               torch.from_numpy(data["idx"]).long())
    got = augment.augment_batch(img, gt, torch.Generator().manual_seed(3), fast=fast, impl=impl)
    again = augment.augment_batch_with_thetas(img, gt, data["thetas"], fast=fast, impl=impl)
    ref = jax_augment.augment_batch_with_thetas(
        jnp.asarray(img.numpy()), jnp.asarray(gt.numpy().astype(np.int32)),
        jnp.asarray(data["thetas"].numpy()), fast=fast, impl=impl)
    for a, b, r in zip(got, again, ref):
        assert torch.equal(a, b)
        np.testing.assert_array_equal(a.numpy(), np.asarray(r))


MAKE_AFFINE_CASES = [
    {},
    {"angle_deg": 30.0},
    {"angle_deg": -44.5, "zoom_y": 1.13, "zoom_x": 0.91, "shift_y": 2.5, "shift_x": -3.25},
    {"angle_deg": 12.0, "flip_ud": True},
    {"angle_deg": 7.0, "zoom_y": 1.07, "flip_lr": True, "flip_ud": True, "shift_x": 1.0},
    {"angle_deg": 90.0, "zoom_x": 1.2},
]


@pytest.mark.parametrize("kw", MAKE_AFFINE_CASES)
def test_make_affine_within_one_ulp(kw):
    got = make_affine(**kw, device="cpu")
    ref = np.asarray(jax_make_affine(**kw))
    assert got.dtype == torch.float32 and got.shape == (2, 3) and ref.dtype == np.float32
    ulps = np.abs(got.numpy().view(np.int32).astype(np.int64) - ref.view(np.int32)) \
        * (np.sign(got.numpy()) == np.sign(ref))
    assert np.abs(got.numpy() - ref).max() <= np.spacing(np.abs(ref)).max(), (got, ref)
    assert (ulps <= 1).all(), (got, ref)


def test_make_affine_drives_the_warp(data):
    """A rotation of 90° built by ``make_affine`` warps a square image as
    ``torch.rot90`` does."""
    x = torch.from_numpy(data["img"][:2, :20, :20]).float()
    theta = make_affine(90.0, device="cpu")[None].expand(2, 2, 3)
    out = augment.apply_thetas(x, theta, "nearest")
    assert torch.equal(out, torch.rot90(x, 1, dims=(1, 2))) or torch.equal(
        out, torch.rot90(x, -1, dims=(1, 2)))


# ---- metrics.py: the meters --------------------------------------------------

def test_average_value_meter_matches_dct_tpu():
    ref, got = jax_metrics.AverageValueMeter(), metrics.AverageValueMeter()
    assert np.isnan(got.value()).all() and np.isnan(ref.value()).all()
    for v, n in ((0.5, 1), (1.5, 3), (-2.0, 2), (np.float32(0.1), 4)):
        ref.add(v, n)
        got.add(v, n)
    assert got.value() == ref.value()
    got.reset()
    assert got.n == 0


@pytest.mark.parametrize("method,axes", [("2d", "all"), ("2d", [1, 2, 3]), ("3d", [1])])
def test_dice_meter_matches_dct_tpu(method, axes):
    rs = np.random.RandomState(1)
    ref = jax_metrics.DiceMeter(method, axes, C=4)
    got = metrics.DiceMeter(method, axes, C=4)
    assert got.summary() == ref.summary()                     # the empty log
    for _ in range(3):
        rows = rs.rand(4).astype(np.float32) if method == "3d" else rs.rand(5, 4)
        ref.add(rows)
        got.add(torch.from_numpy(np.asarray(rows)))
    np.testing.assert_array_equal(got.log, ref.log)
    (m, s), (cm, cs) = got.value()
    (rm, rsd), (rcm, rcs) = ref.value()
    assert (m, s) == (rm, rsd)
    np.testing.assert_array_equal(cm, rcm)
    np.testing.assert_array_equal(cs, rcs)
    assert got.summary() == ref.summary()
    assert got.summary(detailed=True) == ref.summary(detailed=True)
    assert got.detailed_summary() == ref.detailed_summary()


@pytest.mark.parametrize("considered", [(1, 2, 3), None])
def test_kappa2annotator_matches_dct_tpu(considered):
    rs = np.random.RandomState(2)
    ref, got = jax_metrics.Kappa2Annotator(), metrics.Kappa2Annotator()
    for _ in range(3):
        p1, p2, gt = (rs.randint(0, 4, (2, 8, 8)) for _ in range(3))
        ref.add(p1, p2, gt, considered)
        got.add(torch.from_numpy(p1), p2, torch.from_numpy(gt), considered)
    assert got.kappa == ref.kappa and got.value() == ref.value()


def test_aggregated_meters_match_dct_tpu(tmp_path):
    import pandas as pd
    rs = np.random.RandomState(3)
    names = ["train", "val"]
    ref = jax_metrics.ListAggregatedMeter(names, [jax_metrics.AggregatedMeter() for _ in names])
    got = metrics.ListAggregatedMeter(names, [metrics.AggregatedMeter() for _ in names])
    for _ in range(4):
        for r, g in zip(ref.meters, got.meters):
            row = {"mDSC": float(rs.rand()), "DSC1": float(rs.rand())}
            r.add(row)
            g.add(row)
    pd.testing.assert_frame_equal(got.summary(), ref.summary())
    pd.testing.assert_frame_equal(got.meters[0].summary(), ref.meters[0].summary())
    ref.to_csv(tmp_path / "ref.csv")
    got.to_csv(tmp_path / "got.csv")
    assert (tmp_path / "got.csv").read_bytes() == (tmp_path / "ref.csv").read_bytes()
    again = metrics.ListAggregatedMeter(names, [metrics.AggregatedMeter() for _ in names])
    again.load_state_dict(got.state_dict())
    assert again.state_dict() == ref.state_dict()


# ---- utils/general.py and utils/decorators.py ---------------------------------

def test_debug_flag_and_map():
    assert not general.debug_enabled()
    general.set_debug(True)
    try:
        assert general.debug_enabled()
    finally:
        general.set_debug(False)
    assert general.map_(lambda v: v * 2, range(4)) == jax_general.map_(lambda v: v * 2, range(4))


def _probabilities(seed):
    rs = np.random.RandomState(seed)
    p = rs.rand(2, 5, 6, 4).astype(np.float32)
    return p / p.sum(-1, keepdims=True)


@pytest.mark.parametrize("seed", [0, 1])
def test_predicates_match_dct_tpu(seed):
    probs = _probabilities(seed)
    onehot = np.eye(4, dtype=np.float32)[probs.argmax(-1)]
    cases = [probs, onehot, probs * 1.01, onehot[..., :3], np.zeros((3, 4), np.float32)]
    for arr in cases:
        t, j = torch.from_numpy(arr), jnp.asarray(arr)
        assert general.simplex(t) == jax_general.simplex(j)
        assert general.simplex(t, 1) == jax_general.simplex(j, 1)
        assert general.sset(t, [0, 1]) == jax_general.sset(j, [0, 1])
        assert general.one_hot(t) == jax_general.one_hot(j)


def test_assert_simplex_acts_in_debug_mode_only():
    bad = torch.full((2, 3, 3, 4), 0.5)
    general.assert_simplex(bad)                      # debug off: no check
    general.set_debug(True)
    try:
        general.assert_simplex(torch.from_numpy(_probabilities(0)))
        with pytest.raises(AssertionError, match="simplex"):
            general.assert_simplex(bad, name="probs")
        # a value torch.fx or torch.jit is tracing is not checked

        def double(x):
            general.assert_simplex(x)
            return x * 2
        torch.fx.symbolic_trace(double)
        torch.jit.trace(double, bad, check_trace=False)
    finally:
        general.set_debug(False)


def test_class_maps_and_dice_match_dct_tpu():
    probs = _probabilities(4)
    t, j = torch.from_numpy(probs), jnp.asarray(probs)
    np.testing.assert_array_equal(general.probs2class(t).numpy(), np.asarray(jax_general.probs2class(j)))
    np.testing.assert_array_equal(general.pred2class(t).numpy(), np.asarray(jax_general.pred2class(j)))
    label = np.eye(4, dtype=np.float32)[np.random.RandomState(5).randint(0, 4, (2, 5, 6))]
    pred = np.eye(4, dtype=np.float32)[probs.argmax(-1)]
    for axes in ((1, 2), (0, 1, 2), (1,)):
        np.testing.assert_array_equal(
            general.meta_dice(axes, torch.from_numpy(label), torch.from_numpy(pred)).numpy(),
            np.asarray(jax_general.meta_dice(axes, jnp.asarray(label), jnp.asarray(pred))))


@pytest.mark.parametrize("n", [4, 22, 256])
def test_colormap_and_colorize_match_dct_tpu(n):
    np.testing.assert_array_equal(general.colormap(n), jax_general.colormap(n))
    seg = np.random.RandomState(n).randint(0, min(n, 22), (7, 9))
    np.testing.assert_array_equal(general.colorize(torch.from_numpy(seg), n),
                                  jax_general.colorize(seg, n))


def _decorated(mod):
    @mod.accepts
    def f(a: int, b: "list", c=None):
        return a

    @mod.onehot("label")
    def g(label, other=None):
        return 1
    return f, g


def test_decorators_match_dct_tpu():
    """``accepts`` and ``onehot`` pass and refuse the same calls as
    dct_tpu's."""
    onehot = np.eye(3, dtype=np.float32)[np.random.RandomState(6).randint(0, 3, (2, 4))]
    calls = [("f", (1, [2]), True), ("f", (1.5, [2]), False), ("f", (1, (2,)), False),
             ("g", (onehot,), True), ("g", (onehot * 0.5,), False), ("g", (None,), True)]
    for (name, args, ok) in calls:
        outcomes = []
        for mod, conv in ((jax_decorators, jnp.asarray), (decorators, torch.from_numpy)):
            fn = dict(zip("fg", _decorated(mod)))[name]
            args_ = tuple(conv(a) if isinstance(a, np.ndarray) else a for a in args)
            try:
                fn(*args_)
                outcomes.append(True)
            except AssertionError:
                outcomes.append(False)
        assert outcomes == [ok, ok], (name, args, outcomes)


def test_onehot_skips_traced_values():
    _, g = _decorated(decorators)

    def scaled(x):
        return x * g(x)
    torch.fx.symbolic_trace(scaled)
    torch.jit.trace(scaled, torch.full((2, 3), 0.5), check_trace=False)


# ---- data/metainfo.py ---------------------------------------------------------

def test_metainfo_matches_dct_tpu():
    gt = np.random.RandomState(7).randint(0, 5, (16, 16)).astype(np.uint8)
    for C in (3, 5, 7):
        np.testing.assert_array_equal(metainfo.classSizeCalulator(C)(torch.from_numpy(gt)),
                                      jax_metainfo.classSizeCalulator(C)(gt))
    ref = jax_metainfo.get_metainfo_generator("classSizeCalulator", C=4, foldernames=["gt"])
    got = metainfo.get_metainfo_generator("classSizeCalulator", C=4, foldernames=["gt"])
    assert got.foldernames == ref.foldernames == ["gt"]
    np.testing.assert_array_equal(got(gt), ref(gt))
    pair = (gt, gt)
    assert metainfo.get_metainfo_generator("getImage_GT")(pair) is pair
    with pytest.raises(KeyError):
        metainfo.get_metainfo_generator("nope")
