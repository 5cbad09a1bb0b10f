"""device.mfu_pct: the whole step's share of the card's dense peak for the
configuration's precision: ``FlopCounterMode``'s FLOPs of one iteration
(convolutions and matrix products, counted in set-up) times the window's
iterations, over the window's seconds and the peak that the
configuration's table gives for the card (NVIDIA's H100 SXM data sheet:
TF32 494.7 TFLOP/s for float32 with TF32 convolutions). Nothing for a card
the table does not hold."""
from benchmark.counts import peak


def read(run):
    rate = peak(run.cfg["peak_flops"], run.device_name, run.cfg["precision"]["peak"])
    flops = run.driver.flops_per_iteration
    if not rate or not flops:
        return None
    return 100.0 * flops * run.iterations / run.window_s / rate
