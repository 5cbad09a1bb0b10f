"""The Cityscapes program around the step, on the CPU: the eval step's
confusion counts, ``iou_from_confusion``, ``ConfusionMatrix`` and ``IoU``
against dct_tpu's (exactly), the batchers' ``shuffle``/``drop_last``,
``CoTrainerCity``'s host draws and CSV header against dct_tpu's, the
``deeplabenet`` registry entry, and both city CLIs on a synthetic tree:
one epoch, then a resume, with the CSV columns, checkpoint payloads and
prediction dumps in dct_tpu's layout; ``Trainer.coco_init_pth`` loaded
into a DeepLabV3+ trunk by the co-training CLI (or its failure printed),
and ignored by the supervised one, as in dct_tpu.

The eval comparison compiles one dct_tpu eval step (float64 network
arithmetic on both sides, so the argmax sees no rounding); dct_tpu's
CoTrainerCity is built around dct_tpu Segmentators without their eager
flax init (``test_torch_jaxref.py:jax_segmentator``) and its epoch, eval
and checkpoints are stubs: the draws do not depend on the weights.
"""
import csv
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dct_tpu import metrics as ref_metrics
from dct_tpu.data.cityscapes import get_cityscapes_split as jax_get_cityscapes_split
from dct_tpu.data.pipeline import EpochBatcher as JaxEpochBatcher
from dct_tpu.data.pipeline import InfiniteBatcher as JaxInfiniteBatcher
from dct_tpu.models import get_arch as jax_get_arch
from dct_tpu.train.city import CoTrainerCity as JaxCoTrainerCity
from dct_tpu.train.city import iou_from_confusion as jax_iou_from_confusion
from dct_tpu.train.city import make_city_eval_step as jax_make_city_eval_step
from dct_tpu_torch import metrics
from dct_tpu_torch.checkpoint import load_checkpoint
from dct_tpu_torch.data.cityscapes import get_cityscapes_split
from dct_tpu_torch.data.pipeline import EpochBatcher, InfiniteBatcher
from dct_tpu_torch.models import BN_MOMENTUM, Segmentator, get_arch
from dct_tpu_torch.train import city as city_mod
from dct_tpu_torch.train.city import CoTrainerCity, make_city_eval_step
from dct_tpu_torch.train_cotraining_city import main as cotrain_main
from dct_tpu_torch.train_sup_city import main as sup_main
from dct_tpu_torch.utils.convert import params_to_jax
from test_torch_jaxref import jax_segmentator, one_torch_thread  # noqa: F401  (autouse)
from test_torch_trees import write_city_tree

C, SIZE = 19, (16, 32)
ARCH = {"name": "enet", "num_classes": C, "in_channels": 3}
ADAM = {"name": "Adam", "lr": 5e-4, "weight_decay": 2e-4}
STEP = {"name": "StepLR", "step_size": 100, "gamma": 0.1}
RAMP = {"name": "RampScheduler", "begin_epoch": 0, "max_epoch": 3, "max_value": 1.0,
        "ramp_mult": -5}


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    """3 cities × 6 train and 2 val images at 40×88, loaded at 16×32."""
    return write_city_tree(tmp_path_factory.mktemp("city"), counts={"train": 6, "val": 2})


def port_seg(seed=0):
    return Segmentator(ARCH, ADAM, STEP, torch.Generator().manual_seed(seed), device="cpu")


# -- eval and metrics ------------------------------------------------------

def test_eval_confusion_counts_equal_dct_tpu(root):
    """Per val batch (file order, the last one padded with the first
    indices, as the trainers draw them), float64 network arithmetic."""
    val = get_cityscapes_split(split_config(root))[2]
    seg = port_seg(3)
    seg.compute_dtype = torch.float64
    params, batch_stats = params_to_jax(seg.net.state_dict())
    batches = EpochBatcher(len(val), 4, shuffle=False, drop_last=False).epoch(
        np.random.RandomState(0))
    assert batches.shape == (2, 4) and list(batches[-1, 2:]) == [0, 1]
    step = make_city_eval_step(seg, C)
    with jax.enable_x64(True):
        jseg = jax_segmentator(params, batch_stats, arch=ARCH, optim=ADAM, sched=STEP)
        jstep = jax_make_city_eval_step(jseg, C)
        img, gt = jnp.asarray(val.data["img"]), jnp.asarray(val.data["gt"])
        hist = np.zeros((C, C), np.int64)
        for idx in batches:
            want = np.asarray(jstep(jseg.state["params"], jseg.state["batch_stats"], img, gt,
                                    idx.astype(np.int32)))
            got = step(torch.from_numpy(val.data["img"]), torch.from_numpy(val.data["gt"]), idx)
            np.testing.assert_array_equal(got.numpy(), want)
            hist += got.numpy()
    valid = val.data["gt"][batches.flatten()] != 250
    assert hist.sum() == valid.sum() and 0 < hist.sum() < valid.size
    assert_iou_equal(metrics.iou_from_confusion(hist), jax_iou_from_confusion(hist))


def assert_iou_equal(got, want):
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(want[k]), err_msg=k)


@pytest.mark.parametrize("normalized,ignore_index", [(False, 255), (True, 255), (False, 250),
                                                     (False, None)])
def test_confusion_matrix_and_iou_equal_dct_tpu(normalized, ignore_index):
    """Scores and class maps, targets with void (250), 255, −1 and ≥ C, and
    a class that never occurs, added in three batches."""
    rs = np.random.RandomState(7)
    got, want = (metrics.IoU(C, normalized, ignore_index),
                 ref_metrics.IoU(C, normalized, ignore_index))
    for i in range(3):
        target = rs.choice(list(range(C - 1)) + [250, 255, -1, C + 3], (2, 8, 12))
        pred = rs.rand(2, 8, 12, C) if i == 0 else rs.randint(0, C, (2, 8, 12))
        got.add(torch.from_numpy(pred) if i == 1 else pred, target)
        want.add(pred, target)
    np.testing.assert_array_equal(got.conf_metric.value(), want.conf_metric.value())
    assert_iou_equal(got.value(), want.value())
    got.reset()
    assert not got.conf_metric.value().any()


def test_iou_of_empty_classes_is_a_nanmean():
    hist = np.zeros((C, C), np.int64)
    hist[0, 0], hist[1, 0], hist[2, 2] = 5, 3, 4
    out = metrics.iou_from_confusion(hist)
    assert_iou_equal(out, jax_iou_from_confusion(hist))
    assert np.isnan(out["Class_IoU"][5]) and out["Mean_IoU"] == pytest.approx(
        np.mean([5 / 8, 0.0, 1.0]))


@pytest.mark.parametrize("n,bs,shuffle,drop_last", [(10, 4, True, True), (10, 4, False, False),
                                                    (10, 4, True, False), (8, 4, False, False)])
def test_epoch_batcher_equals_dct_tpu(n, bs, shuffle, drop_last):
    got = EpochBatcher(n, bs, shuffle, drop_last).epoch(np.random.RandomState(3))
    want = JaxEpochBatcher(n, bs, shuffle, drop_last).epoch(np.random.RandomState(3))
    np.testing.assert_array_equal(got, want)
    a = InfiniteBatcher(n, bs, np.random.RandomState(1), shuffle=shuffle)
    b = JaxInfiniteBatcher(n, bs, np.random.RandomState(1), shuffle=shuffle)
    np.testing.assert_array_equal(a.take(7), b.take(7))


def test_deeplabenet_is_a_three_channel_enet():
    net = get_arch("deeplabenet", {"num_classes": C})
    assert net.in_channels == 3 and net.num_classes == C
    assert get_arch("deeplabenet", {"num_classes": 4, "in_channels": 1}).in_channels == 1
    assert BN_MOMENTUM["deeplabenet"] == 0.9
    seg = Segmentator({"name": "deeplabenet", "num_classes": C}, ADAM, STEP,
                      torch.Generator().manual_seed(0), device="cpu")
    assert seg.bn_momentum == 0.9
    want = params_to_jax(port_seg().net.state_dict())
    got = params_to_jax(seg.net.state_dict())
    assert (jax.tree_util.tree_map(np.shape, got) == jax.tree_util.tree_map(np.shape, want))


# -- host draws ------------------------------------------------------------

def split_config(root, k=2):
    return {"Dataset": {"name": "cityscapes", "root_dir": str(root),
                        "image_size": list(SIZE), "subsample": 1},
            "Lab_Partitions": {"num_models": k, "partition_sets": 0.5,
                               "partition_overlap": 0.9},
            "Seed": 1234}


def test_host_draws_equal_dct_tpu(root, tmp_path, monkeypatch):
    """Both CoTrainerCity on the same datasets and seed, epochs, eval and
    checkpoints stubbed to record what the host hands the step: two epochs
    of every index array, the FGSM/VAT flags, lr and λ; and the CSV header
    each writes."""
    T, B = 3, 2
    ref_lab, ref_unlab, ref_val = jax_get_cityscapes_split(split_config(root))
    lab, unlab, val = get_cityscapes_split(split_config(root))
    kw = dict(max_epoch=2, cot_scheduler_dict=RAMP,
              adv_scheduler_dict={**RAMP, "begin_epoch": 1, "max_value": 0.005},
              adv_training_dict={"eplision": 0.03, "fsgm_ratio": 0.5},
              batch_size=B, iters_per_epoch=T, seed=77)
    crit = {"sup": None, "jsd": None, "adv": None}
    params, batch_stats = params_to_jax(port_seg().net.state_dict())
    jsegs = [jax_segmentator(params, batch_stats, arch=ARCH, optim=ADAM, sched=STEP)
             for _ in range(2)]
    ref = JaxCoTrainerCity(jsegs, ref_lab, ref_unlab, ref_val, crit,
                           save_dir=tmp_path / "jax", **kw)
    tr = CoTrainerCity([port_seg(0), port_seg(1)], lab, unlab, val, crit,
                       save_dir=tmp_path / "port", device="cpu", **kw)
    calls = {"jax": [], "port": []}
    zeros = {"sup_loss": np.zeros((T, 2), np.float32), "jsd_loss": np.zeros(T, np.float32),
             "adv_loss": np.zeros(T, np.float32)}

    def ref_epoch(state, img, gt, *args):
        calls["jax"].append([np.asarray(a) for a in args[:5]] + [float(a) for a in args[6:]])
        return state, zeros

    def port_epoch(img, gt, *args):
        calls["port"].append([np.asarray(a) for a in args[:5]] + [float(a) for a in args[6:]])
        return {k: torch.from_numpy(v) for k, v in zeros.items()}

    ref._epoch_fn = lambda *a: ref_epoch
    monkeypatch.setattr(city_mod, "make_city_cotrain_epoch", lambda *a, **k: port_epoch)
    iou = [{"Mean_IoU": 0.25, "Overall_Acc": 0.5}] * 2
    for trainer in (ref, tr):
        trainer._eval_epoch = lambda: iou
        trainer.checkpoint = lambda *a: None
        trainer.start_training(train_jsd=True, train_adv=True)
    np.testing.assert_array_equal(tr._img_cat.numpy(), np.asarray(ref._img_cat))
    assert tr._offsets == ref._offsets
    assert len(calls["port"]) == len(calls["jax"]) == 2
    for got, want in zip(calls["port"], calls["jax"]):
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
    assert calls["port"][1][-1] > 0 == calls["port"][0][-1]      # λ_adv ramps up
    flags = np.concatenate([c[4] for c in calls["port"]])
    assert flags.shape == (2 * T, 2) and flags.any() and not flags.all()
    headers = [next(csv.reader(open(tmp_path / d / "metrics.csv"))) for d in ("jax", "port")]
    assert headers[0] == headers[1] == CSV_HEADER


CSV_HEADER = ["epoch", "val_mIoU_0", "val_mIoU_1", "val_acc_0", "val_acc_1", "sup_loss_0",
              "sup_loss_1", "jsd_loss", "adv_loss", "images_per_sec", "t_train", "t_eval"]


# -- the CLIs --------------------------------------------------------------

def cli_args(root, run, config, *extra):
    return ["--device", "cpu", "--config", f"configs/{config}.yaml",
            f"Dataset.root_dir={root}", f"Dataset.image_size=[{SIZE[0]},{SIZE[1]}]",
            "Dataset.subsample=1", f"Trainer.save_dir={run}", *extra]


def dct_tpu_payload_layout(sd):
    """A checkpoint's keys and its parameter tree's structure, shapes and
    dtypes."""
    seg = sd["segmentator"]
    return sorted(sd), sorted(seg), leaves({"params": seg["net_state_dict"],
                                            "batch_stats": seg["batch_stats"]})


def leaves(tree):
    """(path, shape, dtype) of every leaf, sorted."""
    return sorted((jax.tree_util.keystr(path), tuple(np.shape(a)), np.dtype(a.dtype).name)
                  for path, a in jax.tree_util.tree_flatten_with_path(tree)[0])


@pytest.fixture(scope="module")
def flax_tree():
    """dct_tpu's ENet variables (3 channels, 19 classes) as shapes, traced
    without running the init."""
    model = jax_get_arch("enet", {"num_classes": C, "in_channels": 3})
    shapes = jax.eval_shape(lambda: model.init(jax.random.PRNGKey(0),
                                               jnp.zeros((1,) + SIZE + (3,)), train=False))
    return leaves({"params": shapes["params"], "batch_stats": shapes["batch_stats"]})


@pytest.mark.parametrize("which", ["cotraining", "supervised"])
def test_city_cli_epoch_and_resume(root, tmp_path, flax_tree, which):
    """As shipped (fp32, batch 4, the 19 class weights), one epoch, then a
    resume to a second: the CSV's dct_tpu columns for epochs 0 and 1,
    last/best checkpoints in dct_tpu's city payload (no Adam state),
    Adam restarted by the resume, and the epoch-0 prediction dumps (the
    co-training config sets save_val; dct_tpu's TrainerCity never dumps)."""
    main, config, K = ((cotrain_main, "cityscapes_cotraining", 2) if which == "cotraining"
                       else (sup_main, "cityscapes_supervised", 1))
    run = tmp_path / "run"
    first = main(cli_args(root, run, config, "Trainer.max_epoch=1"))
    inner = first if K == 2 else first.inner
    T = inner.iters_per_epoch
    resumed = main(cli_args(root, run, config, "Trainer.max_epoch=2", f"Trainer.checkpoint={run}"))
    inner2 = resumed if K == 2 else resumed.inner
    assert inner2.start_epoch == 1
    steps = {float(st["step"]) for s in inner2.segmentators for st in s.optimizer.state.values()}
    assert steps == {float(T)}, steps                   # Adam restarted at the resume
    with open(run / "metrics.csv", newline="") as f:
        rows = list(csv.DictReader(f))
    header = ["epoch"] + [f"{p}_{s}" for p in ("val_mIoU", "val_acc") for s in range(K)] + [
        f"sup_loss_{s}" for s in range(K)] + CSV_HEADER[-5:]
    assert list(rows[0]) == header and [r["epoch"] for r in rows] == ["0", "1"]
    for r in rows:
        assert all(np.isfinite(float(r[c])) for c in header if c != "epoch"), r
        assert all(0 <= float(r[f"val_mIoU_{s}"]) <= 1 for s in range(K))
    for s in range(K):
        sd = load_checkpoint(run / f"last_{s}.ckpt")
        keys, seg_keys, tree = dct_tpu_payload_layout(sd)
        assert keys == ["best_epoch", "best_score", "segmentator"]
        assert seg_keys == sorted(["arch_dict", "optim_dict", "scheduler_dict", "net_state_dict",
                                   "batch_stats", "scheduler_state_dict"])
        assert tree == flax_tree
        assert sd["best_epoch"] == 1 and sd["segmentator"]["scheduler_state_dict"] == {"epoch": 2}
        assert (run / f"best_{s}.ckpt").is_file()
        # dct_tpu reads the file as its own
        with open(run / f"last_{s}.ckpt", "rb") as f:
            assert set(pickle.load(f)) == set(sd)
    dumps = sorted(p.relative_to(run).as_posix() for p in run.rglob("*.png"))
    val = inner.val_set.filenames
    want = (sorted(f"iter000/eval/{s}/{stem}.png" for s in range(K) for stem in val)
            if K == 2 else [])
    assert dumps == want


def test_city_clis_refuse_what_is_not_ported(root, tmp_path):
    """``Trainer.parallel`` is dct_tpu's ``data_parallel_mesh(world)`` in
    both city CLIs: in one process no mesh, and the plain path trains."""
    for main, config in ((cotrain_main, "cityscapes_cotraining"),
                         (sup_main, "cityscapes_supervised")):
        run = tmp_path / config
        tr = main(cli_args(root, run, config, "Trainer.parallel=auto", "Trainer.max_epoch=1"))
        assert getattr(tr, "inner", tr).mesh is None
        assert (run / "metrics.csv").exists()


DEEPLAB = ("Arch.name=deeplabv3plus", "Arch.n_blocks=[1,1,1,1]", "Arch.grids=[1]")


def reference_deeplabv2_state_dict(num_classes=21, seed=0):
    """A torch state_dict in the reference DeepLabV2's key layout (its
    ``scale.`` prefix, the trunk's ``conv``/``bn`` pairs, the ASPP's
    ``stages``, ``num_batches_tracked``), random values from a seed, at the
    port's trunk of ``n_blocks`` (1, 1, 1, 1) and a COCO-sized head."""
    net = get_arch("deeplabv2", {"num_classes": num_classes, "n_blocks": [1, 1, 1, 1],
                                 "in_channels": 3})
    rs = np.random.RandomState(seed)
    sd = {}
    for key, t in net.state_dict().items():
        parts = key.split(".")
        if parts[0] == "aspp":
            name = f"aspp.stages.{parts[1]}.{parts[2]}"
        else:
            trunk = "layer1.conv1" if parts[1] == "layer1_conv1" else ".".join(parts[1:-2])
            sub = "conv" if parts[-2] == "Conv_0" else "bn"
            name = f"{trunk}.{sub}.{parts[-1]}"
        sd["scale." + name] = torch.from_numpy(rs.standard_normal(tuple(t.shape))
                                               .astype(np.float32))
        if name.endswith("bn.running_var"):
            sd["scale." + name] = sd["scale." + name].abs() + 0.5
            sd["scale." + name.replace("running_var", "num_batches_tracked")] = \
                torch.tensor(7)
    return sd


@pytest.fixture(scope="module")
def coco_pth(tmp_path_factory):
    path = tmp_path_factory.mktemp("coco") / "deeplabv2_coco.pth"
    torch.save(reference_deeplabv2_state_dict(), path)
    return path


def test_cotraining_city_loads_coco_init_into_the_deeplab_trunk(root, tmp_path, coco_pth,
                                                                capsys, monkeypatch):
    """``Trainer.coco_init_pth`` with ``deeplabv3plus``: every model takes
    the trunk's tensors (dct_tpu's line: loaded N, skipped 0), the ASPP keeps
    its init (ASPP-v3's names are not the .pth's), and training goes on."""
    seen = []
    monkeypatch.setattr(city_mod.CoTrainerCity, "start_training",
                        lambda self, **kw: seen.append(
                            [{k: v.clone() for k, v in s.net.state_dict().items()}
                             for s in self.segmentators]))
    cotrain_main(cli_args(root, tmp_path, "cityscapes_cotraining", *DEEPLAB,
                          f"Trainer.coco_init_pth={coco_pth}", "Trainer.max_epoch=1"))
    out = capsys.readouterr().out
    ref = torch.load(coco_pth)
    n_trunk = sum(1 for k in ref if not k.startswith("scale.aspp")
                  and not k.endswith("num_batches_tracked"))
    assert out.count(f">> torch init: loaded {n_trunk} tensors, skipped 0 "
                     "(shape mismatch)") == 2
    assert "Coco pretrained model loaded" in out
    for sd in seen[0]:
        assert torch.equal(sd["trunk.layer1_conv1.Conv_0.weight"],
                           ref["scale.layer1.conv1.conv.weight"])
        assert torch.equal(sd["trunk.layer5.block1.proj.BatchNorm_0.running_var"],
                           ref["scale.layer5.block1.proj.bn.running_var"])


@pytest.mark.parametrize("arch,pth", [(("Arch.name=enet",), "coco"),
                                      (DEEPLAB, "missing")],
                         ids=["enet_nothing_matches", "missing_file"])
def test_cotraining_city_warns_and_trains_on(root, tmp_path, coco_pth, capsys, arch, pth):
    """Nothing of an ENet matches the .pth (dct_tpu's assert), or the file
    is missing: the CLI prints dct_tpu's failure line and trains one epoch
    from its init."""
    path = coco_pth if pth == "coco" else tmp_path / "missing.pth"
    run = tmp_path / "run"
    cotrain_main(cli_args(root, run, "cityscapes_cotraining", *arch,
                          f"Trainer.coco_init_pth={path}", "Trainer.max_epoch=1"))
    out = capsys.readouterr().out
    assert "Loading coco pretrained model failed with:" in out
    assert "Coco pretrained model loaded" not in out
    with open(run / "metrics.csv", newline="") as f:
        assert [r["epoch"] for r in csv.DictReader(f)] == ["0"]


def test_sup_city_ignores_coco_init(root, tmp_path, capsys):
    """dct_tpu's ``train_sup_city`` never reads ``Trainer.coco_init_pth``."""
    sup_main(cli_args(root, tmp_path, "cityscapes_supervised",
                      f"Trainer.coco_init_pth={tmp_path / 'missing.pth'}",
                      "Trainer.max_epoch=1"))
    out = capsys.readouterr().out
    assert "torch init" not in out and "coco pretrained" not in out.lower()
    with open(tmp_path / "metrics.csv", newline="") as f:
        assert [r["epoch"] for r in csv.DictReader(f)] == ["0"]


@pytest.mark.parametrize("main", [cotrain_main, sup_main])
def test_city_clis_need_cuda_or_explicit_cpu(root, tmp_path, main, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        main([f"Dataset.root_dir={root}", f"Trainer.save_dir={tmp_path}"])
    assert not any(tmp_path.iterdir())
