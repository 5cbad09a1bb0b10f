"""Rules of the dct_tpu_torch package: it never imports JAX or dct_tpu, it
imports where JAX cannot be imported, its CLI needs no pandas, and its
entry points refuse to run on the CPU unless asked to."""
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted(p.relative_to(ROOT).as_posix()
                    for p in (ROOT / "dct_tpu_torch").rglob("*.py")) + ["chip_smoke.py"]
# `import jax`, `from jax.x import`, `import dct_tpu.x`, `from dct_tpu import`
# — dct_tpu followed by "." or whitespace, since the port's own name starts
# with it
FORBIDDEN = re.compile(r"^\s*(import|from)\s+(jax|flax|optax|dct_tpu)(\.|\s|$)", re.M)


def test_port_has_files():
    assert len(PORT_FILES) > 10, PORT_FILES


@pytest.mark.parametrize("path", PORT_FILES)
def test_no_jax_or_dct_tpu_imports(path):
    hits = FORBIDDEN.findall((ROOT / path).read_text())
    assert not hits, (path, hits)


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
    with pytest.raises(NotImplementedError, match="later slice"):
        Segmentator({"name": "unet", "num_classes": 4}, *cfg[1:],
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


def test_cli_and_cotrainer_need_cuda_or_explicit_cpu(no_cuda, tmp_path):
    from dct_tpu_torch.models import Segmentator
    from dct_tpu_torch.train import CoTrainer
    from dct_tpu_torch.train_cotraining import main
    with pytest.raises(RuntimeError, match="device='cpu'"):
        main([f"Trainer.save_dir={tmp_path}"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        main(["--device", "cuda", f"Trainer.save_dir={tmp_path}"])
    seg = Segmentator({"name": "enet", "num_classes": 4}, {"name": "Adam", "lr": 1e-3},
                      {"name": "StepLR", "step_size": 90},
                      torch.Generator().manual_seed(0), device="cpu")
    crit = {"sup": None, "jsd": None, "adv": None}
    with pytest.raises(RuntimeError, match="device='cpu'"):
        CoTrainer([seg], [None], None, None, crit, save_dir=tmp_path)
    assert not any(tmp_path.iterdir())


def test_cli_runs_without_pandas(tmp_path):
    """In a process where importing pandas (and JAX, dct_tpu) raises: write
    a tiny PNG tree, then one co-training epoch of one iteration through
    the CLI on the CPU. TensorFlow is blocked too: TensorBoard's event
    writer imports it where it is installed, which takes longer than the
    run itself, and falls back to its own writer without it."""
    code = (
        "import sys\n"
        "for name in ('pandas', 'jax', 'flax', 'optax', 'dct_tpu', 'tensorflow'):\n"
        "    sys.modules[name] = None\n"
        "from pathlib import Path\n"
        "import numpy as np\n"
        "from PIL import Image\n"
        "from dct_tpu_torch.train_cotraining import main\n"
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
        "      'Trainer.iters_per_epoch=1', 'Lab_Dataloader.batch_size=2',\n"
        "      'Unlab_Dataloader.batch_size=2', 'StartTraining.train_jsd=True'])\n"
        "assert (root / 'run' / 'best_0.ckpt').is_file()\n"
        "assert not any(k.split('.')[0] in ('pandas', 'jax')\n"
        "               for k in sys.modules if sys.modules[k] is not None)\n")
    proc = subprocess.run([sys.executable, "-c", code, str(tmp_path / "tree")],
                          cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert ">> epoch 0:" in proc.stdout
