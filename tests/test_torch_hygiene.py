"""Rules of the dct_tpu_torch package: it never imports JAX or dct_tpu (nor
does the parallel tests' worker module, which spawned ranks import), it
imports where JAX cannot be imported, its CLIs (the trainers, the summary
and the report) need no pandas, and its entry points (the trainers, the
summary and the bench) refuse to run on the CPU unless asked to."""
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from dct_tpu_torch import train

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted(p.relative_to(ROOT).as_posix()
                    for p in (ROOT / "dct_tpu_torch").rglob("*.py")) + ["chip_smoke.py"]
# `import jax`, `from jax.x import`, `import dct_tpu.x`, `from dct_tpu import`
# — dct_tpu followed by "." or whitespace, since the port's own name starts
# with it
FORBIDDEN = re.compile(r"^\s*(import|from)\s+(jax|flax|optax|dct_tpu)(\.|\s|$)", re.M)


def test_port_has_files():
    assert len(PORT_FILES) > 10, PORT_FILES
    for name in ("summary", "bench", "metrics", "postprocessing/report"):
        assert f"dct_tpu_torch/{name}.py" in PORT_FILES, name


@pytest.mark.parametrize("path", PORT_FILES)
def test_no_jax_or_dct_tpu_imports(path):
    hits = FORBIDDEN.findall((ROOT / path).read_text())
    assert not hits, (path, hits)


def test_parallel_modules_are_checked():
    """The parallel package is among the files scanned above, and the
    module the parallel tests' spawned ranks re-import (their workers)
    imports no JAX or dct_tpu either."""
    for name in ("mesh", "comm", "data_parallel", "shard_cotrain", "spatial", "dryrun"):
        assert f"dct_tpu_torch/parallel/{name}.py" in PORT_FILES, name
    workers = ROOT / "tests" / "test_torch_parallel_workers.py"
    assert not FORBIDDEN.findall(workers.read_text())
    code = ("import sys\n"
            "for name in ('jax', 'flax', 'optax', 'dct_tpu'):\n"
            "    sys.modules[name] = None\n"
            "sys.path.insert(0, 'tests')\n"
            "import test_torch_parallel_workers\n"
            "import dct_tpu_torch.parallel.dryrun\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr


def test_leftover_modules_are_checked():
    """The modules of the last slice (the host tools and leftovers) are
    among the files the no-JAX check scans."""
    for name in ("utils/logging", "utils/general", "utils/decorators", "data/metainfo",
                 "data/augment", "data/pipeline", "ops/warp", "adversarial", "metrics",
                 "datapreprocessing/__init__", "datapreprocessing/slicers",
                 "datapreprocessing/cityscapes_tools", "postprocessing/plot",
                 "postprocessing/viewer"):
        assert f"dct_tpu_torch/{name}.py" in PORT_FILES, name


def test_offline_tools_import_without_pandas_or_matplotlib():
    """The slicers, the Cityscapes tools, the plot and the viewer import
    where pandas, matplotlib, nibabel and JAX cannot be imported: each
    imports what it needs inside the function that needs it."""
    code = ("import sys\n"
            "for name in ('pandas', 'matplotlib', 'nibabel', 'jax', 'dct_tpu'):\n"
            "    sys.modules[name] = None\n"
            "import dct_tpu_torch.datapreprocessing.slicers\n"
            "import dct_tpu_torch.datapreprocessing.cityscapes_tools\n"
            "import dct_tpu_torch.postprocessing.plot\n"
            "import dct_tpu_torch.postprocessing.viewer\n"
            "import dct_tpu_torch.metrics\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr


def test_port_imports_with_jax_blocked():
    """Import every module of the port (and chip_smoke) in a fresh process
    in which importing jax, flax, optax or dct_tpu raises."""
    code = (
        "import sys, importlib, pkgutil\n"
        "for name in ('jax', 'flax', 'optax', 'dct_tpu'):\n"
        "    sys.modules[name] = None\n"
        "import dct_tpu_torch\n"
        "mods = [m.name for m in pkgutil.walk_packages(dct_tpu_torch.__path__, 'dct_tpu_torch.')]\n"
        "for m in mods:\n"
        "    importlib.import_module(m)\n"
        "import chip_smoke\n"
        "assert not any(k == 'jax' or k.startswith(('jax.', 'dct_tpu.'))\n"
        "               for k in sys.modules if sys.modules[k] is not None)\n"
        "print(len(mods))\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert int(proc.stdout.strip()) >= 15


def test_chip_smoke_fails_without_cuda(tmp_path):
    """No CUDA device (as here), or chip_smoke.py alone in a directory:
    non-zero exit and no result line."""
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    proc = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
    alone = tmp_path / "chip_smoke.py"
    alone.write_text((ROOT / "chip_smoke.py").read_text())
    proc = subprocess.run([sys.executable, str(alone)], cwd=tmp_path,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_resolve_device(no_cuda):
    from dct_tpu_torch import resolve_device
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device("cuda")
    assert resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(ValueError):
        resolve_device("meta")


def test_segmentator_needs_cuda_or_explicit_cpu(no_cuda):
    from dct_tpu_torch.models import Segmentator
    cfg = ({"name": "enet", "num_classes": 4}, {"name": "Adam", "lr": 1e-3},
           {"name": "StepLR", "step_size": 90})
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Segmentator(*cfg, torch.Generator().manual_seed(0))
    seg = Segmentator(*cfg, torch.Generator().manual_seed(0), device="cpu")
    assert next(seg.net.parameters()).device.type == "cpu"
    x = torch.rand(1, 16, 16, 1)
    assert seg.apply_eval(x).shape == (1, 16, 16, 4)
    with pytest.raises(AssertionError, match="is not found"):
        Segmentator({"name": "no_such_arch", "num_classes": 4}, *cfg[1:],
                    torch.Generator().manual_seed(0), device="cpu")


def test_enet_rejects_sizes_not_divisible_by_8():
    from dct_tpu_torch.models.enet import Enet
    with pytest.raises(ValueError, match="divisible by 8"):
        Enet(4)(torch.rand(1, 12, 16, 1))


def test_cpu_path_builds_nothing():
    """CPU tensors take the plain path: no nvcc, no library, no launch."""
    from dct_tpu_torch.ops import pool_kernels
    before = dict(pool_kernels.LAUNCHES)
    pooled, mask = pool_kernels.max_pool_2x2_with_mask_kernel(torch.rand(1, 4, 4, 2))
    pool_kernels.mask_unpool_2x2_kernel(pooled, mask)
    assert pool_kernels._lib is None
    assert pool_kernels.LAUNCHES == before


# each entry point: its trainer built with a segmentator on the CPU but no
# device (the datasets are never reached), the CLI's own overrides for one
# tiny epoch, the checkpoint it writes first and the line it prints
CLIS = {
    "train_cotraining": (
        lambda seg, d: train.CoTrainer([seg], [None], None, None,
                                       {"sup": None, "jsd": None, "adv": None}, save_dir=d),
        ["Trainer.iters_per_epoch=1", "Lab_Dataloader.batch_size=2",
         "Unlab_Dataloader.batch_size=2", "StartTraining.train_jsd=True"],
        "best_0.ckpt", ">> epoch 0:"),
    "train_sup": (lambda seg, d: train.Trainer(seg, {}, None, save_dir=d),
                  [], "best.ckpt", ">> epoch 0:"),
    "train_vat": (lambda seg, d: train.VatTrainer(seg, None, None, None, None, save_dir=d),
                  ["Lab_Dataloader.batch_size=2"], "best.ckpt", ">> VAT epoch 0:"),
    "train_mean_teacher": (
        lambda seg, d: train.MeanTeacherTrainer(seg, seg, None, None, None, {"sup": None},
                                                save_dir=d),
        ["Lab_Dataloader.batch_size=2"], "best_*.ckpt", ">> MT epoch 0:"),
}


@pytest.mark.parametrize("cli", sorted(CLIS))
def test_cli_and_cotrainer_need_cuda_or_explicit_cpu(no_cuda, tmp_path, cli):
    """The CLI and its trainer raise without a card unless told to run on
    the CPU, before they write anything."""
    import importlib
    from dct_tpu_torch.models import Segmentator
    main = importlib.import_module(f"dct_tpu_torch.{cli}").main
    with pytest.raises(RuntimeError, match="device='cpu'"):
        main([f"Trainer.save_dir={tmp_path}"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        main(["--device", "cuda", f"Trainer.save_dir={tmp_path}"])
    seg = Segmentator({"name": "enet", "num_classes": 4}, {"name": "Adam", "lr": 1e-3},
                      {"name": "StepLR", "step_size": 90},
                      torch.Generator().manual_seed(0), device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        CLIS[cli][0](seg, tmp_path)
    assert not any(tmp_path.iterdir())


@pytest.mark.parametrize("cli", sorted(CLIS))
def test_cli_runs_without_pandas(tmp_path, cli):
    """In a process where importing pandas (and JAX, flax, optax, dct_tpu)
    raises: write a tiny PNG tree, then one epoch of the CLI on the CPU with
    its shipped config. TensorFlow is blocked too: TensorBoard's event
    writer imports it where it is installed, which takes longer than the
    run itself, and falls back to its own writer without it."""
    _, overrides, ckpt, line = CLIS[cli]
    code = (
        "import sys\n"
        "for name in ('pandas', 'jax', 'flax', 'optax', 'dct_tpu', 'tensorflow'):\n"
        "    sys.modules[name] = None\n"
        "from pathlib import Path\n"
        "import numpy as np\n"
        "import torch\n"
        "from PIL import Image\n"
        f"from dct_tpu_torch.{cli} import main\n"
        "torch.set_num_threads(1)   # 16² tensors; the test workers share the cores\n"
        "root = Path(sys.argv[1])\n"
        "rs = np.random.RandomState(0)\n"
        "for mode, n in (('train', 100), ('val', 2)):\n"
        "    for sub in ('img', 'gt'):\n"
        "        (root / mode / sub).mkdir(parents=True)\n"
        "    for p in range(1, n + 1):\n"
        "        stem = f'patient{p:03d}_01_0_0.png'\n"
        "        Image.fromarray(rs.randint(0, 256, (16, 16)).astype(np.uint8)).save(root / mode / 'img' / stem)\n"
        "        Image.fromarray(rs.randint(0, 4, (16, 16)).astype(np.uint8)).save(root / mode / 'gt' / stem)\n"
        "main(['--device', 'cpu', f'Dataset.root_dir={root}',\n"
        "      'Dataset.transform=segment_transform((16,16))',\n"
        "      f'Trainer.save_dir={root / \"run\"}', 'Trainer.max_epoch=1',\n"
        f"      *{overrides!r}])\n"
        f"assert list((root / 'run').glob({ckpt!r}))\n"
        "assert not any(k.split('.')[0] in ('pandas', 'jax')\n"
        "               for k in sys.modules if sys.modules[k] is not None)\n")
    proc = subprocess.run([sys.executable, "-c", code, str(tmp_path / "tree")],
                          cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert line in proc.stdout


def test_trace_epoch_and_make_affine_need_cuda_or_explicit_cpu(no_cuda, tmp_path):
    """``trace_epoch`` and ``make_affine`` resolve their device as the entry
    points do: the card unless the caller asks for the CPU."""
    from dct_tpu_torch.ops.warp import make_affine
    from dct_tpu_torch.utils.logging import trace_epoch
    with pytest.raises(RuntimeError, match="device='cpu'"):
        with trace_epoch(tmp_path):
            pass
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_affine(10.0)
    assert make_affine(10.0, device="cpu").device.type == "cpu"
    assert not any(tmp_path.iterdir())


@pytest.mark.parametrize("entry", ["summary", "bench"])
def test_summary_and_bench_need_cuda_or_explicit_cpu(no_cuda, tmp_path, entry):
    """``python -m dct_tpu_torch.summary`` and ``.bench`` raise without a card
    unless told to run on the CPU, before they read or write anything."""
    import importlib
    main = importlib.import_module(f"dct_tpu_torch.{entry}").main
    args = ["--input_dir", str(tmp_path)] if entry == "summary" else []
    for device in ([], ["--device", "cuda"]):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            main(args + device)
    assert not any(tmp_path.iterdir())


def test_summary_and_report_run_without_pandas(tmp_path):
    """In a process where importing pandas (and JAX, flax, optax, dct_tpu)
    raises: ``python -m dct_tpu_torch.summary --device cpu`` on a copy of
    results/ACDC_cotrain_r3's checkpoints and a 16² val tree, then
    ``python -m dct_tpu_torch.postprocessing.report`` on its folder."""
    run = tmp_path / "runs" / "r3"
    run.mkdir(parents=True)
    for name in ("best_0.ckpt", "best_1.ckpt", "config.yml"):
        (run / name).write_bytes((ROOT / "results" / "ACDC_cotrain_r3" / name).read_bytes())
    code = (
        "import runpy, sys\n"
        "for name in ('pandas', 'jax', 'flax', 'optax', 'dct_tpu', 'tensorflow'):\n"
        "    sys.modules[name] = None\n"
        "from pathlib import Path\n"
        "import numpy as np\n"
        "import torch\n"
        "from PIL import Image\n"
        "torch.set_num_threads(1)\n"
        "tree, run = Path(sys.argv[1]), Path(sys.argv[2])\n"
        "rs = np.random.RandomState(0)\n"
        "for sub in ('img', 'gt'):\n"
        "    (tree / 'val' / sub).mkdir(parents=True)\n"
        "for p in (1, 2):\n"
        "    for s in range(3):\n"
        "        stem = f'patient{p:03d}_01_0_{s}.png'\n"
        "        Image.fromarray(rs.randint(0, 256, (16, 16)).astype(np.uint8)).save(tree / 'val' / 'img' / stem)\n"
        "        Image.fromarray(rs.randint(0, 4, (16, 16)).astype(np.uint8)).save(tree / 'val' / 'gt' / stem)\n"
        "import yaml\n"
        "cfg = yaml.safe_load((run / 'config.yml').read_text())\n"
        "cfg['Dataset']['transform'] = 'segment_transform((16,16))'\n"
        "(run / 'config.yml').write_text(yaml.safe_dump(cfg))\n"
        "sys.argv = ['summary', '--device', 'cpu', '--input_dir', str(run), '--dataset_root', str(tree)]\n"
        "runpy.run_module('dct_tpu_torch.summary', run_name='__main__')\n"
        "sys.argv = ['report', '--folder', str(run.parent)]\n"
        "runpy.run_module('dct_tpu_torch.postprocessing.report', run_name='__main__')\n"
        "assert not any(k.split('.')[0] in ('pandas', 'jax')\n"
        "               for k in sys.modules if sys.modules[k] is not None)\n")
    proc = subprocess.run([sys.executable, "-c", code, str(tmp_path / "tree"), str(run)],
                          cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    for name in ("summary.csv", "bsummary.csv", "div.csv", "summary_std.csv",
                 "bsummary_std.csv", "log_2Ddice_ensemble.csv", "log_3Ddice_model_1.csv"):
        assert (run / name).is_file(), name
    assert len(list((run / "iter1000" / "val" / "voting").glob("*.png"))) == 6
    for name in ("ensemble_results.csv", "mean_score_results.csv"):
        assert (run.parent / name).read_text().splitlines()[1].startswith("r3,")
