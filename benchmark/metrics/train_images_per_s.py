"""train_images_per_s: every image the window's completed iterations
consumed (K·B + Bu a co-training iteration, B a supervised one) over the
window's seconds, from the first call's start to the last call's
synchronize (host clock)."""


def read(run):
    return run.images / run.window_s
