"""The yardstick's counts: pool bytes at the ENet cells' shapes against hand
arithmetic, the FLOP counter against a convolution's formula, and the
trace reader on a hand-made trace."""
from __future__ import annotations

import json

import torch

from benchmark.counts import count_flops, peak, pool_bytes
from benchmark.run import BENCH
from benchmark.trace import WINDOW_SPAN, Trace

ENET_SITES = json.loads((BENCH / "configs" / "enet-acdc.json").read_text())["pool_sites"]


def test_enet_pool_sites():
    # ENet's initial block output (13 + 1 channels at stride 2) and its
    # first stage's (64 channels at stride 4), by the configuration's file
    assert ENET_SITES == [{"stride": 2, "channels": 14}, {"stride": 4, "channels": 64}]


def test_pool_bytes_by_hand():
    # one pass over 128 images at 256², fp32: each of the four ops at each
    # site reads and writes x + x/4 + x elements of 4 bytes
    x1 = 128 * 128 * 128 * 14        # initial block output, 128 images
    x2 = 128 * 64 * 64 * 64          # first stage output
    pool_fwd = 4 * (x1 + x1 // 4 + x1) + 4 * (x2 + x2 // 4 + x2)
    per_pass = 4 * pool_fwd          # pool, its gradient, unpool, its gradient
    # co-training: 4 passes of 128 images (two fused forwards, FGSM's, the
    # adversarial one); supervised: 1 pass of 64
    assert pool_bytes([128] * 4, 256, 256, ENET_SITES, 4) == 4 * per_pass
    assert pool_bytes([64], 256, 256, ENET_SITES, 4) == per_pass // 2
    assert pool_bytes([64], 256, 256, ENET_SITES, 2) == per_pass // 4
    assert pool_bytes([64], 256, 256, [], 4) == 0


def test_flops_of_a_convolution():
    x = torch.randn(2, 3, 16, 16)
    w = torch.randn(8, 3, 3, 3)
    flops = count_flops(lambda: torch.nn.functional.conv2d(x, w, padding=1))
    assert flops == 2 * 2 * 8 * 16 * 16 * 3 * 9


def test_peak_table():
    table = {"NVIDIA H100 80GB HBM3": {"tf32": 494.7e12}}
    assert peak(table, "NVIDIA H100 80GB HBM3", "tf32") == 494.7e12
    assert peak(table, "other card", "tf32") is None


def test_trace_reader():
    ev = [
        {"ph": "X", "cat": "user_annotation", "name": WINDOW_SPAN, "ts": 0, "dur": 100},
        {"ph": "X", "cat": "user_annotation", "name": "Optimizer.step#Adam.step",
         "ts": 50, "dur": 20, "tid": 1},
        {"ph": "X", "cat": "cpu_op", "name": "aten::convolution", "ts": 0, "dur": 40, "tid": 1},
        {"ph": "X", "cat": "cpu_op", "name": "aten::add", "ts": 4, "dur": 3, "tid": 1},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": 5, "dur": 1,
         "args": {"correlation": 1}, "tid": 1},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": 55, "dur": 1,
         "args": {"correlation": 2}, "tid": 1},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": 56, "dur": 1,
         "args": {"correlation": 4}, "tid": 2},
        {"ph": "X", "cat": "kernel", "name": "conv_fprop", "ts": 10, "dur": 20,
         "args": {"correlation": 1}},
        {"ph": "X", "cat": "kernel", "name": "multi_tensor_apply", "ts": 25, "dur": 10,
         "args": {"correlation": 2}},
        {"ph": "X", "cat": "gpu_memset", "name": "Memset", "ts": 80, "dur": 5,
         "args": {"correlation": 3}},
        {"ph": "X", "cat": "kernel", "name": "other_thread", "ts": 86, "dur": 2,
         "args": {"correlation": 4}},
        {"ph": "X", "cat": "kernel", "name": "outside", "ts": 200, "dur": 5},
    ]
    tr = Trace(ev)
    assert abs(tr.window_s - 100e-6) < 1e-12
    assert abs(tr.busy_s() - 32e-6) < 1e-12          # [10, 35], [80, 85], [86, 88]
    # launched inside the span on its own thread; the other thread's is not
    assert abs(tr.device_seconds_under(lambda op: op.startswith("Optimizer.step#")) - 10e-6) < 1e-12
    # launched inside aten::add, itself inside aten::convolution
    assert abs(tr.device_seconds_under(lambda op: "convolution" in op) - 20e-6) < 1e-12
    assert tr.stack[1] == ("aten::convolution", "aten::add")
    assert abs(tr.device_seconds(lambda n: "conv" in n) - 20e-6) < 1e-12
    gaps = tr.longest_gaps()
    assert gaps[0][0] == "Optimizer.step#Adam.step" and abs(gaps[0][1] - 45e-6) < 1e-12
    assert tr.top_device_ops()[0][0] == "conv_fprop"
