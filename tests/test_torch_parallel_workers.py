"""Worker functions the parallel tests spawn (no tests of its own). A
spawned rank re-imports the module that holds its function, so this one
imports only torch and the port: dct_tpu's side of the tests lives in
``test_torch_parallel_ref.py``."""
import torch

from dct_tpu_torch.models import Segmentator
from dct_tpu_torch.parallel import dryrun


def _apply_train_f64(self, x, update_stats=True, groups=1, dtype=None,
                     dropout_generator=None):
    """``Segmentator.apply_train`` with the float64 logits left as they are
    (the port casts them to fp32, as dct_tpu does): with fp32 logits each
    framework's fp32 rounding of the loss's input gradient flips FGSM's
    sign at the pixels where that gradient is near zero, and the flips, not
    the algorithm, set the difference."""
    self.net.train()
    for m in self._batch_norms:
        m.update_stats, m.groups = update_stats, groups
    for m in self._dropouts:
        m.generator = dropout_generator
    try:
        return self.net(x.to(dtype or self.compute_dtype))
    finally:
        for m in self._batch_norms:
            m.update_stats, m.groups = True, 1
        for m in self._dropouts:
            m.generator = None


def f64_cotrain_case(rank, world, case):
    """``dryrun.cotrain_case`` with float64 logits."""
    Segmentator.apply_train = _apply_train_f64
    return dryrun.cotrain_case(rank, world, case)


def _float64_network():
    """Every Segmentator built from here on computes in float64 and keeps
    its train-mode logits in float64 (parameters and optimizer state stay
    fp32), so that a parallel run and a single process differ by the order
    of their reductions alone: with fp32 logits VAT's power iteration
    (ξ = 1e-6) follows each run's rounding, not the gradient."""
    init = Segmentator.__init__

    def __init__(self, *args, **kwargs):
        init(self, *args, **kwargs)
        self.compute_dtype = torch.float64

    Segmentator.__init__ = __init__
    Segmentator.apply_train = _apply_train_f64


def _models(trainer):
    """The trainer's models, in a fixed order."""
    trainer = getattr(trainer, "inner", trainer)
    if hasattr(trainer, "segmentators"):
        return list(trainer.segmentators)
    if hasattr(trainer, "student"):
        return [trainer.student, trainer.teacher]
    return [trainer.segmentator]


def cli_case(rank, world, case):
    """Run a CLI's ``main(case["args"])`` with float64 networks on this
    rank (``case["runs"]`` lists several argument lists, run in turn: a
    first epoch and its resume). Returns, from rank 0, the models' final
    state and the trainer's mesh."""
    import importlib
    _float64_network()
    mod = importlib.import_module(case["module"])
    for args in case["runs"]:
        trainer = mod.main(args)
    mesh = getattr(getattr(trainer, "inner", trainer), "mesh", None)
    return {"mesh": None if mesh is None else dict(mesh.shape),
            "models": [{k: v.detach().clone() for k, v in s.net.state_dict().items()}
                       for s in _models(trainer)] if rank == 0 else None}
