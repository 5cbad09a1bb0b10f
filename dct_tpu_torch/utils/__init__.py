"""Helpers: one-hot, predicates and dice (``general``), the flax weight
bridge (``convert``)."""
from .general import (  # noqa: F401
    class2one_hot,
    colormap,
    colorize,
    dice_batch,
    dice_coef,
    fix_all_seed,
    map_,
    meta_dice,
    one_hot,
    pred2class,
    probs2class,
    probs2one_hot,
    save_images,
    simplex,
    sset,
)
