"""The optimizers of this slice against dct_tpu's optax chains, and their
states through dct_tpu's checkpoint layout.

Trajectories: 12 steps of each optimizer setting on ENet's parameter tree
(the committed ``results/ACDC_vat`` weights) with numpy-seeded gradients,
L2 or decoupled decay 1e-2, and an lr that halves after step 6, in
float64: dct_tpu's ``tx.update`` + ``apply_direction`` against the port's
``optimizer.step()``, within 1e-10 of each parameter's scale. dct_tpu's
``fused: true`` (``flatten_tx``) gives its per-leaf update, and the port's
``fused`` the same update as without it.

States: dct_tpu's state after 6 steps, written by dct_tpu's
``save_checkpoint`` and read by the port's ``load_checkpoint`` (optax's
classes and dct_tpu's ``AdaBoundState`` as stand-ins), resumes the port's
optimizer, which then follows dct_tpu's 6 further steps; the state the
port writes back equals dct_tpu's field by field, and dct_tpu resumes from
it. Per-leaf and fused, and stacked over K = 2 as the co-training keeps it.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dct_tpu.checkpoint import save_checkpoint as jax_save_checkpoint
from dct_tpu.optim import apply_direction, build_optimizer as jax_build_optimizer
from dct_tpu_torch.checkpoint import load_checkpoint
from dct_tpu_torch.models import Segmentator
from dct_tpu_torch.optim import build_optimizer, set_lr
from dct_tpu_torch.utils.convert import (_fields, load_optim_state, optim_state_to_jax,
                                         params_from_jax, params_to_jax,
                                         stack_optim_states, unstack_optim_state)
from test_torch_jaxref import one_torch_thread, trained  # noqa: F401  (autouse)

WD = 1e-2
SETTINGS = {
    "Adam": {"name": "Adam", "lr": 1e-2},
    "AdamW": {"name": "AdamW", "lr": 1e-2, "betas": (0.8, 0.99)},
    "SGD": {"name": "SGD", "lr": 1e-2},
    "SGD_momentum": {"name": "SGD", "lr": 1e-2, "momentum": 0.9},
    "SGD_nesterov": {"name": "SGD", "lr": 1e-2, "momentum": 0.9, "nesterov": True},
    "RMSprop": {"name": "RMSprop", "lr": 1e-3, "alpha": 0.9},
    "AdaBound": {"name": "AdaBound", "lr": 1e-3, "final_lr": 0.1},
    "AdaBound_amsbound": {"name": "AdaBound", "lr": 1e-3, "amsbound": True, "gamma": 0.05},
    "AdaBoundW": {"name": "AdaBoundW", "lr": 1e-3, "final_lr": 0.05},
}
STEPS, HALF = 12, 6
TOL = 1e-10


def lr_at(cfg, t):
    return cfg["lr"] * (0.5 if t >= HALF else 1.0)


@pytest.fixture(scope="module")
def tree():
    params, _ = trained()
    rs = np.random.RandomState(0)
    grads = [jax.tree_util.tree_map(lambda a: rs.randn(*a.shape) * (0.1 + t % 3), params)
             for t in range(STEPS)]
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), params), grads


def port_net(params):
    seg = Segmentator({"name": "enet", "num_classes": 4}, {"name": "Adam", "lr": 1e-3},
                      {"name": "StepLR", "step_size": 9}, torch.Generator().manual_seed(0),
                      device="cpu")
    seg.net.double()
    seg.net.load_state_dict(params_from_jax(params, {}), strict=False)
    return seg.net


_JAX_STEP = {}


def _jax_step(cfg):
    """dct_tpu's compiled ``tx.update`` + ``apply_direction`` for ``cfg``."""
    key = repr(sorted(cfg.items()))
    if key not in _JAX_STEP:
        tx = jax_build_optimizer(cfg)

        def step(p, st, g, lr):
            d, st = tx.update(g, st, p)
            return apply_direction(p, d, lr), st
        _JAX_STEP[key] = tx, jax.jit(step)
    return _JAX_STEP[key]


def jax_steps(cfg, params, grads, steps, state=None):
    """dct_tpu's params and optax state after ``steps`` (indices of
    ``grads``), from ``state`` or a fresh one."""
    with jax.enable_x64(True):
        tx, step = _jax_step(cfg)
        p = jax.tree_util.tree_map(jnp.asarray, params)
        st = tx.init(p) if state is None else jax.tree_util.tree_map(jnp.asarray, state)
        for t in steps:
            p, st = step(p, st, grads[t], lr_at(cfg, t))
        return (jax.tree_util.tree_map(np.asarray, p), jax.tree_util.tree_map(np.asarray, st))


def port_steps(cfg, net, opt, grads, steps):
    for t in steps:
        g = params_from_jax(grads[t], {})
        for name, p in net.named_parameters():
            p.grad = g[name]
        set_lr(opt, lr_at(cfg, t))
        opt.step()


def tree_err(got, ref):
    """Largest leaf difference relative to each leaf's scale (at least 1)."""
    errs = []
    for path, v in jax.tree_util.tree_leaves_with_path(ref):
        g = got
        for k in path:
            g = g[k.key]
        errs.append(np.abs(np.asarray(g) - v).max() / max(np.abs(v).max(), 1.0))
    return max(errs)


def config(name, fused):
    cfg = {**SETTINGS[name], "weight_decay": WD}
    return {**cfg, "fused": True} if fused else cfg


@pytest.mark.parametrize("fused", [False, True], ids=["per_leaf", "fused"])
@pytest.mark.parametrize("name", list(SETTINGS))
def test_trajectory(tree, name, fused):
    params, grads = tree
    cfg = config(name, fused)
    ref, _ = jax_steps(cfg, params, grads, range(STEPS))
    net = port_net(params)
    opt = build_optimizer(cfg, net.parameters())
    port_steps(cfg, net, opt, grads, range(STEPS))
    got = params_to_jax({n: p for n, p in net.named_parameters()})[0]
    assert tree_err(got, ref) < TOL


def test_fused_is_the_per_leaf_update(tree):
    """The port's ``fused: true`` and per-leaf runs are bit-identical, as
    dct_tpu's are."""
    params, grads = tree
    finals = []
    for fused in (False, True):
        cfg = config("AdaBound_amsbound", fused)
        net = port_net(params)
        opt = build_optimizer(cfg, net.parameters())
        port_steps(cfg, net, opt, grads, range(4))
        finals.append([p.detach().clone() for p in net.parameters()])
    assert all(torch.equal(a, b) for a, b in zip(*finals))


def test_unknown_optimizer_raises():
    with pytest.raises(KeyError, match="unknown optimizer"):
        build_optimizer({"name": "LBFGS", "lr": 0.1}, [torch.nn.Parameter(torch.zeros(2))])


def _to_optax(state, fields):
    """dct_tpu's chain tuple ``state`` with its non-empty link's fields
    replaced by the port's ``fields``."""
    return tuple(s._replace(**{k: fields[k] for k in s._fields}) if len(s) else s
                 for s in state)


def _fields_err(got, ref):
    errs = [0.0]
    for k, v in ref.items():
        if v is None or k == "count":
            assert (got[k] is None) if v is None else int(got[k]) == int(v)
            continue
        if isinstance(next(iter(v)), str):
            errs.append(tree_err(got[k], v))
        else:                                   # fused: {dtype: vector}
            assert got[k].keys() == v.keys()
            errs += [np.abs(got[k][dt] - v[dt]).max() / max(np.abs(v[dt]).max(), 1.0)
                     for dt in v]
    return max(errs)


@pytest.mark.parametrize("fused", [False, True], ids=["per_leaf", "fused"])
@pytest.mark.parametrize("name", [n for n in SETTINGS if n != "Adam"])
def test_state_round_trip(tree, tmp_path, name, fused):
    params, grads = tree
    cfg = config(name, fused)
    p_half, st_half = jax_steps(cfg, params, grads, range(HALF))
    jax_save_checkpoint(tmp_path / "opt.ckpt", {"optim_state_dict": st_half})
    loaded = load_checkpoint(tmp_path / "opt.ckpt")["optim_state_dict"]

    net = port_net(p_half)
    opt = build_optimizer(cfg, net.parameters())
    load_optim_state(opt, net, loaded, cfg)
    port_steps(cfg, net, opt, grads, range(HALF, STEPS))
    p_ref, st_ref = jax_steps(cfg, p_half, grads, range(HALF, STEPS), state=st_half)
    got = params_to_jax({n: p for n, p in net.named_parameters()})[0]
    assert tree_err(got, p_ref) < TOL

    written = optim_state_to_jax(opt, net, cfg)
    assert _fields_err(written, _fields(st_ref)) < TOL
    # dct_tpu resumes from the state the port wrote
    p_next, _ = jax_steps(cfg, p_ref, grads, [0], state=_to_optax(st_ref, written))
    port_steps(cfg, net, opt, grads, [0])
    got = params_to_jax({n: p for n, p in net.named_parameters()})[0]
    assert tree_err(got, p_next) < TOL


@pytest.mark.parametrize("fused", [False, True], ids=["per_leaf", "fused"])
@pytest.mark.parametrize("name", ["SGD_nesterov", "RMSprop", "AdaBound_amsbound", "AdamW"])
def test_stacked_state_round_trip(tree, tmp_path, name, fused):
    """Two models stacked on a leading K axis, one count (dct_tpu's
    co-training ``opt_state.ckpt``): unstacked, each model's state is its
    slice; stacked again, the port writes dct_tpu's layout back."""
    params, grads = tree
    cfg = config(name, fused)
    stacked = jax.tree_util.tree_map(lambda a: np.stack([a, 0.5 * a]), params)
    sgrads = [jax.tree_util.tree_map(lambda a: np.stack([a, -a]), g) for g in grads]
    _, st = jax_steps(cfg, stacked, sgrads, range(3))
    jax_save_checkpoint(tmp_path / "opt_state.ckpt", {"opt_state": st})
    loaded = load_checkpoint(tmp_path / "opt_state.ckpt")["opt_state"]
    net = port_net(params)
    per_model = unstack_optim_state(loaded, 2, net, cfg)
    per_leaf_cfg = {**cfg, "fused": False}
    for i, (p0, sign) in enumerate([(1.0, 1.0), (0.5, -1.0)]):
        _, st_i = jax_steps(per_leaf_cfg, jax.tree_util.tree_map(lambda a: p0 * a, params),
                            [jax.tree_util.tree_map(lambda a: sign * a, g) for g in grads],
                            range(3))
        assert _fields_err(per_model[i], _fields(st_i)) < TOL
        opt = build_optimizer(per_leaf_cfg, net.parameters())
        load_optim_state(opt, net, per_model[i], per_leaf_cfg)
        per_model[i] = optim_state_to_jax(opt, net, cfg)
    assert _fields_err(stack_optim_states(per_model, net, cfg), _fields(st)) == 0.0


def test_state_of_another_layout_raises(tree):
    """A fused state under a per-leaf config (and the reverse), or another
    optimizer's state, is refused: the co-trainer then restarts the
    optimizers, as dct_tpu does with a state it cannot read."""
    params, grads = tree
    net = port_net(params)
    _, fused_st = jax_steps(config("SGD_momentum", True), params, grads, range(1))
    _, leaf_st = jax_steps(config("SGD_momentum", False), params, grads, range(1))
    opt = build_optimizer(config("SGD_momentum", False), net.parameters())
    with pytest.raises((KeyError, ValueError)):
        load_optim_state(opt, net, fused_st, config("SGD_momentum", False))
    with pytest.raises(ValueError):
        load_optim_state(opt, net, leaf_st, config("SGD_momentum", True))
    with pytest.raises(KeyError):
        load_optim_state(opt, net, leaf_st, config("RMSprop", False))
