"""The port's trainers through their CLIs on 2 gloo ranks (the ranks
spawned by ``dct_tpu_torch.parallel.dryrun.spawn``, the worker in
``test_torch_parallel_workers.py``) against the same CLI in one process,
float64 networks and train-mode logits on both sides (parameters and
optimizer state fp32):

* ``train_sup``, ``train_vat``, ``train_mean_teacher``,
  ``train_cotraining_city`` and ``train_sup_city`` with
  ``Trainer.parallel=auto`` (dct_tpu's ``data_parallel_mesh``: 1 × 2);
* ``train_cotraining`` with ``Trainer.parallel=1`` (``make_mesh(2,
  n_model=1)``: the data-parallel step) and with ``auto``
  (``choose_parallel_mesh(2, 2)``: model axis 2, the model-parallel step,
  which at data 1 is the joint step), each one epoch and a resume to a
  second from its checkpoints; rank 0 alone writes the run directory.

Every λ ramp starts at epoch 0 so that each semi-supervised term acts.
Each run takes 2 iterations (batches of 50 supervised, 10 + 10 for VAT
and Mean-Teacher; the co-training epochs one iteration each): on these
ring images training is chaotic enough that an ulp of an fp32 parameter
grows 10–25× an iteration (measured on ``train_sup``: 5e-10, 1e-9, 3e-8
in the losses of iterations 2–4, 1.4e-2 on a running variance after 10).
Adam's eps is 1e-3 (``Optim.eps``): with its default 1e-8 Adam's first
steps scale a gradient that is zero up to rounding (a bias before a
BatchNorm) to ±lr, so the two runs' rounding noise, not their arithmetic,
would set the difference (measured 2.6e-3 on ``train_sup``).
Each model's parameters and running statistics after the run must equal
the single process's within 1e-5 of their scale (measured at most
2.4e-7; the parallel runs differ by the order of their reductions).
"""

import pytest

from dct_tpu_torch.parallel.dryrun import spawn
from helpers import make_synthetic_acdc
from test_torch_jaxref import one_torch_thread  # noqa: F401  (autouse)
from test_torch_parallel_workers import cli_case
from test_torch_trees import write_city_tree

H, CITY_SIZE = 16, (16, 32)
TOL = 1e-5


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    root = tmp_path_factory.mktemp("parallel_trees")
    return {"acdc": make_synthetic_acdc(root / "acdc", n_train_patients=100,
                                        n_val_patients=2, slices_per_patient=1, size=H),
            "city": write_city_tree(root / "city", size=CITY_SIZE)}


def acdc_args(config, tree, run, *extra):
    return ["--device", "cpu", "--config", f"configs/{config}.yaml",
            f"Dataset.root_dir={tree}", f"Dataset.transform=segment_transform(({H},{H}))",
            f"Trainer.save_dir={run}", "Trainer.max_epoch=1", "Optim.eps=0.001", *extra]


def city_args(config, tree, run, *extra):
    return ["--device", "cpu", "--config", f"configs/{config}.yaml",
            f"Dataset.root_dir={tree}", f"Dataset.image_size=[{CITY_SIZE[0]},{CITY_SIZE[1]}]",
            "Dataset.subsample=1", f"Trainer.save_dir={run}", "Trainer.max_epoch=1",
            "Optim.eps=0.001", *extra]


SEMI = ["Lab_Dataloader.batch_size=10", "Unlab_Dataloader.batch_size=10"]
CLIS = {
    "sup": ("dct_tpu_torch.train_sup", "acdc", acdc_args, "acdc_supervised",
            ["Dataloader.batch_size=50"]),
    "vat": ("dct_tpu_torch.train_vat", "acdc", acdc_args, "acdc_vat", SEMI),
    "mean_teacher": ("dct_tpu_torch.train_mean_teacher", "acdc", acdc_args,
                     "acdc_meanteacher", SEMI),
    "city_cotraining": ("dct_tpu_torch.train_cotraining_city", "city", city_args,
                        "cityscapes_cotraining",
                        ["Lab_Dataloader.batch_size=2", "Unlab_Dataloader.batch_size=2",
                         "Cot_Scheduler.begin_epoch=0", "Adv_Scheduler.begin_epoch=0",
                         "StartTraining.save_val=False"]),
    "city_sup": ("dct_tpu_torch.train_sup_city", "city", city_args,
                 "cityscapes_supervised", ["Dataloader.batch_size=2"]),
}


def run_cli(module, world, runs):
    return spawn(cli_case, world, ({"module": module, "runs": runs},), timeout=240)[0]


def largest_difference(ref, got):
    """Largest difference of any model's float leaf, relative to the
    leaf's scale (at least 1)."""
    worst = 0.0
    for r, g in zip(ref["models"], got["models"]):
        for k, v in r.items():
            if v.is_floating_point():
                d = float((g[k].double() - v.double()).abs().max())
                worst = max(worst, d / max(1.0, float(v.double().abs().max())))
    return worst


@pytest.mark.parametrize("name", list(CLIS))
def test_data_parallel_trainer_equals_one_process(trees, tmp_path, name):
    module, tree, args, config, extra = CLIS[name]
    one = run_cli(module, 1, [args(config, trees[tree], tmp_path / "one", *extra)])
    two = run_cli(module, 2, [args(config, trees[tree], tmp_path / "two", *extra,
                                   "Trainer.parallel=auto")])
    assert one["mesh"] is None and two["mesh"] == {"model": 1, "data": 2}
    assert largest_difference(one, two) <= TOL
    assert (sorted(p.name for p in (tmp_path / "two").iterdir())
            == sorted(p.name for p in (tmp_path / "one").iterdir()))


COTRAIN = ["Trainer.iters_per_epoch=1", "Lab_Dataloader.batch_size=2",
           "Unlab_Dataloader.batch_size=2", "StartTraining.train_jsd=True",
           "StartTraining.train_adv=True", "Adv_Scheduler.begin_epoch=0"]


def cotrain_runs(tree, run, *extra):
    return [acdc_args("acdc_cotraining", tree, run, *COTRAIN, *extra),
            acdc_args("acdc_cotraining", tree, run, *COTRAIN, *extra, "Trainer.max_epoch=2",
                      f"Trainer.checkpoint={run}")]


@pytest.fixture(scope="module")
def cotrain_one(trees, tmp_path_factory):
    run = tmp_path_factory.mktemp("cotrain_one") / "run"
    return run, run_cli("dct_tpu_torch.train_cotraining", 1, cotrain_runs(trees["acdc"], run))


@pytest.mark.parametrize("parallel,mesh", [("1", {"model": 1, "data": 2}),
                                           ("auto", {"model": 2, "data": 1})])
def test_cotraining_cli_on_two_ranks_with_a_resume(trees, tmp_path, cotrain_one, parallel,
                                                   mesh):
    one_run, one = cotrain_one
    run = tmp_path / "run"
    two = run_cli("dct_tpu_torch.train_cotraining", 2,
                  cotrain_runs(trees["acdc"], run, f"Trainer.parallel={parallel}"))
    assert two["mesh"] == mesh
    assert largest_difference(one, two) <= TOL
    # rank 0 alone wrote: the single process's files, one event log a run
    assert sorted(p.name for p in run.iterdir() if "tfevents" not in p.name) == \
        sorted(p.name for p in one_run.iterdir() if "tfevents" not in p.name)
    assert len(list(run.glob("*tfevents*"))) == len(list(one_run.glob("*tfevents*")))
    lines = (run / "metrics.csv").read_text().splitlines()
    assert [line.split(",")[0] for line in lines[1:]] == ["0", "1"]
