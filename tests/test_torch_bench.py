"""The port's bench (``python -m dct_tpu_torch.bench``) on the CPU at 32²,
T = 2 iterations a call, W = 2 calls: ``bench.py``'s keys and the spread,
the gates (a non-finite loss raises, a launch count other than the
expected raises; on the CPU no kernel launches), and the card-only parts
(the bf16 peak table) without a card. That the entry point needs a card or
``--device cpu`` is in ``test_torch_hygiene.py``."""
import json
import math

import pytest

from dct_tpu_torch import bench
from dct_tpu_torch.ops import pool_kernels
from test_torch_jaxref import one_torch_thread  # noqa: F401  (autouse)

SMALL = dict(device="cpu", N=12, H=32, T=2, windows=2)
BENCH_PY_KEYS = {"metric", "value", "unit", "vs_baseline"}


@pytest.fixture(scope="module")
def result():
    return bench.run(**SMALL)


def test_bench_prints_bench_py_keys(result):
    assert BENCH_PY_KEYS <= set(result)
    assert result["metric"] == "cotrain_images_per_sec_per_chip"
    assert result["unit"] == "images/sec"
    assert result["vs_baseline"] == pytest.approx(result["value"] / 2.727)
    assert json.loads(json.dumps(result)) == result


def test_bench_reports_the_median_and_spread(result):
    ips = result["ips_windows"]
    assert len(ips) == result["windows"] == 2 and result["iterations"] == 2
    assert result["ips_min"] == min(ips) <= result["value"] <= result["ips_max"] == max(ips)
    assert result["value"] == pytest.approx(sum(ips) / 2)     # the median of two
    assert all(v > 0 and math.isfinite(v) for v in ips)


def test_bench_on_the_cpu_launches_no_kernel_and_names_no_card(result):
    assert result["launches"] == dict.fromkeys(pool_kernels.KERNELS, 0)
    assert result["device"] == "cpu"
    assert result["card"] is None and result["mfu_bf16_pct"] is None
    assert result["peak_mem_gib"] is None
    # FlopCounterMode counts the convolutions of one iteration: 6 ENet
    # forwards and their backward
    assert result["flops_per_iteration"] > 1e8


def _tampered(monkeypatch, tamper):
    make = bench.make_cotrain_epoch

    def make_tampered(*args, **kwargs):
        epoch = make(*args, **kwargs)

        def run(*a, **k):
            return tamper(epoch(*a, **k))
        return run
    monkeypatch.setattr(bench, "make_cotrain_epoch", make_tampered)


@pytest.mark.parametrize("loss", ["sup_loss", "jsd_loss", "adv_loss"])
def test_bench_refuses_a_non_finite_loss(monkeypatch, loss):
    def poison(m):
        m[loss] = m[loss].clone()
        m[loss].view(-1)[-1] = float("nan")
        return m
    _tampered(monkeypatch, poison)
    with pytest.raises(FloatingPointError, match=loss):
        bench.run(**{**SMALL, "N": 8, "H": 16, "T": 1, "windows": 1})


def test_bench_refuses_a_wrong_launch_count(monkeypatch):
    def launch(m):
        pool_kernels.LAUNCHES["unpool_bwd"] += 1
        return m
    _tampered(monkeypatch, launch)
    try:
        with pytest.raises(RuntimeError, match="launched"):
            bench.run(**{**SMALL, "N": 8, "H": 16, "T": 1, "windows": 1})
    finally:
        pool_kernels.reset_launch_counts()


def test_bf16_peak_is_known_only_for_named_cards():
    assert bench.bf16_peak_flops("NVIDIA H100 80GB HBM3") == 989.4e12
    with pytest.raises(KeyError, match="no dense bf16 peak"):
        bench.bf16_peak_flops("NVIDIA H100 PCIe")



def test_bench_runs_the_unfused_step_too(result):
    """``fuse_forward=False``: the unfused step, for a comparison in one
    process; the default is the fused step bench.py runs."""
    assert result["fuse_forward"] is True
    unfused = bench.run(**{**SMALL, "N": 8, "H": 16, "T": 1, "windows": 1}, fuse_forward=False)
    assert unfused["fuse_forward"] is False and unfused["value"] > 0
    assert unfused["launches"] == dict.fromkeys(pool_kernels.KERNELS, 0)
    assert bench.LAUNCHES_PER_ITERATION_UNFUSED == 12 and bench.LAUNCHES_PER_ITERATION == 8
