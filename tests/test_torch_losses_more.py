"""The losses of this slice against dct_tpu's, values and gradients in
float64 (within 1e-10 of scale): ``partial_cross_entropy2d``, ``mse_2d``,
``dice_coefficient`` and ``dice_loss`` with each of its options,
``enet_weighing``, ``get_loss_fn``'s names, and ``dice_batch``.
``dice_loss`` takes a one-hot target, as dct_tpu's does: a class-index
target raises in both packages.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dct_tpu import losses as jax_losses
from dct_tpu.utils import general as jax_general
from dct_tpu_torch import losses
from dct_tpu_torch.utils import general

C = 4
TOL = 1e-10


def _data(seed, shape=(2, 6, 5, C)):
    rs = np.random.RandomState(seed)
    logits = rs.randn(*shape) * 2
    target = rs.randint(0, shape[-1], shape[:-1])
    onehot = np.eye(shape[-1])[target]
    return logits, target, onehot


def _value_and_grad(ref_fn, fn, logits, *args):
    """(value, d sum(value) / d logits) of dct_tpu's ``ref_fn`` and the
    port's ``fn`` on the same float64 inputs."""
    with jax.enable_x64(True):
        f = lambda a: ref_fn(a, *[jnp.asarray(x) for x in args])   # noqa: E731
        v = np.asarray(f(jnp.asarray(logits)))
        g = np.asarray(jax.grad(lambda a: jnp.sum(f(a)))(jnp.asarray(logits)))
    x = torch.from_numpy(logits.copy()).requires_grad_()
    out = fn(x, *[torch.from_numpy(np.asarray(a)) for a in args])
    out.sum().backward()
    return (v, g), (out.detach().numpy(), x.grad.numpy())


def _close(got, ref):
    for a, b in zip(got, ref):
        assert np.shape(a) == np.shape(b)
        assert np.abs(np.asarray(a) - b).max() <= TOL * max(np.abs(b).max(), 1.0)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_partial_cross_entropy(seed):
    logits, target, _ = _data(seed)
    target[0, 0] = 0                    # class 0 is weighted out
    ref, got = _value_and_grad(jax_losses.partial_cross_entropy2d,
                               losses.partial_cross_entropy2d, logits, target)
    _close(got, ref)


@pytest.mark.parametrize("seed", [0, 1])
def test_mse_2d(seed):
    logits, target, _ = _data(seed, (2, 6, 5, 2))
    ref, got = _value_and_grad(jax_losses.mse_2d, losses.mse_2d, logits, target)
    _close(got, ref)


@pytest.mark.parametrize("smooth", [1.0, 1e-3])
def test_dice_coefficient(smooth):
    logits, _, onehot = _data(3)
    ref, got = _value_and_grad(lambda a, t: jax_losses.dice_coefficient(a, t, smooth),
                               lambda a, t: losses.dice_coefficient(a, t, smooth),
                               logits, onehot)
    _close(got, ref)


@pytest.mark.parametrize("kw", [{}, {"optimize_bg": True}, {"weight": [0.5, 1.0, 2.0, 1.5]},
                                {"weight": [0.5, 1.0, 2.0, 1.5], "optimize_bg": True},
                                {"smooth": 0.1}, {"size_average": False},
                                {"reduce": False}],
                         ids=["default", "bg", "weight", "weight_bg", "smooth", "sum",
                              "per_image"])
def test_dice_loss(kw):
    logits, _, onehot = _data(4)
    ref, got = _value_and_grad(lambda a, t: jax_losses.dice_loss(a, t, **kw),
                               lambda a, t: losses.dice_loss(a, t, **kw), logits, onehot)
    _close(got, ref)


def test_dice_loss_raises_on_class_indices_in_both():
    """dct_tpu's ``get_loss_fn("dice_loss")`` takes a one-hot target; the
    class-index maps every trainer passes do not broadcast and raise."""
    logits, target, _ = _data(5)
    with pytest.raises(ValueError, match="Incompatible shapes"):
        jax_losses.get_loss_fn("dice_loss")(jnp.asarray(logits), jnp.asarray(target))
    with pytest.raises(ValueError, match="Incompatible shapes"):
        losses.get_loss_fn("dice_loss")(torch.from_numpy(logits), torch.from_numpy(target))


@pytest.mark.parametrize("name,kw", [("cross_entropy", {"weight": [1, 2, 1, 0.5]}),
                                     ("partial_ce", {}), ("mse_2d", {}),
                                     ("dice_loss", {"optimize_bg": True})])
def test_get_loss_fn_builds_each_name(name, kw):
    logits, target, onehot = _data(6, (2, 6, 5, 2) if name == "mse_2d" else (2, 6, 5, C))
    tgt = onehot if name == "dice_loss" else target
    with jax.enable_x64(True):
        ref = float(jax_losses.get_loss_fn(name, **kw)(jnp.asarray(logits), jnp.asarray(tgt)))
    got = float(losses.get_loss_fn(name, **kw)(torch.from_numpy(logits), torch.from_numpy(tgt)))
    assert abs(got - ref) <= TOL * max(abs(ref), 1.0)


def test_get_loss_fn_jsd_and_unknown():
    probs = torch.softmax(torch.from_numpy(np.random.RandomState(7).randn(2, 3, 4, 4, C)), -1)
    with jax.enable_x64(True):
        ref = np.asarray(jax_losses.get_loss_fn("jsd")(jnp.asarray(probs.numpy())))
    np.testing.assert_allclose(losses.get_loss_fn("jsd")(probs).numpy(), ref, rtol=1e-12)
    with pytest.raises(ValueError, match="unknown loss"):
        losses.get_loss_fn("focal")


@pytest.mark.parametrize("c", [1.02, 1.1])
def test_enet_weighing(c):
    rs = np.random.RandomState(8)
    labels = [rs.randint(-1, C + 1, (5, 7)) for _ in range(3)]   # out-of-range skipped
    np.testing.assert_array_equal(losses.enet_weighing(labels, C, c),
                                  jax_losses.enet_weighing(labels, C, c))


@pytest.mark.parametrize("smooth", [1e-8, 1.0])
def test_dice_batch(smooth):
    rs = np.random.RandomState(9)
    label = np.eye(C, dtype=np.float32)[rs.randint(0, C, (3, 8, 8))]
    pred = np.eye(C, dtype=np.float32)[rs.randint(0, C, (3, 8, 8))]
    pred[..., 3] = 0                     # an absent class: smooth decides it
    got = general.dice_batch(torch.from_numpy(label), torch.from_numpy(pred), smooth)
    ref = jax_general.dice_batch(jnp.asarray(label), jnp.asarray(pred), smooth)
    assert got.shape == (C,)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-6)
