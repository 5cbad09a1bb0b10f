"""The port's public surface is complete: every public top-level name of
``dct_tpu/`` (functions, classes, module-level assignments, and the names
each ``__init__.py`` exports) has a counterpart in ``dct_tpu_torch/`` — the
same name in the module of the same path, or the module and name that
``MOVED`` gives — or stands on ``WRITTEN_OFF`` with its reason. The root
scripts of the JAX package map to the port's modules of the same name, or
are written off. Both trees are read with ``ast``: neither package is
imported."""
import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
JAX_PKG, PORT_PKG = ROOT / "dct_tpu", ROOT / "dct_tpu_torch"

# dct_tpu "file:name" → the port's "file:name" that computes it
MOVED = {
    "ops/pallas_pool.py:max_pool_2x2_with_mask_pallas":
        "ops/pool_kernels.py:max_pool_2x2_with_mask_kernel",
    "ops/pallas_pool.py:mask_unpool_2x2_pallas": "ops/pool_kernels.py:mask_unpool_2x2_kernel",
    # dct_tpu vmaps its one-image warp; the port's affine_warp is the batched form
    "ops/warp.py:affine_warp_batch": "ops/warp.py:affine_warp",
    "train/city.py:iou_from_confusion": "metrics.py:iou_from_confusion",
    # flax's BatchNorm factory and initialisers: the port's module and its
    # one-pass init of a net's weights
    "models/layers.py:batch_norm": "models/layers.py:BatchNorm",
    "models/layers.py:bn_scale_init": "models/layers.py:init_weights_",
    "models/layers.py:conv_kernel_init": "models/layers.py:init_weights_",
    # the port's PSP module pools with F.adaptive_avg_pool2d
    "models/pspnet.py:adaptive_avg_pool": "models/pspnet.py:PSPModule",
    # the unpickler's stand-in for dct_tpu's optimizer state class
    "optim.py:AdaBoundState": "checkpoint.py:AdaBoundState",
    # the VGG16 trunk of the FCNs
    "models/backbones.py:VGGStage": "models/vgg.py:VGGStage",
    "models/backbones.py:VGG16Features": "models/vgg.py:VGG16Features",
}

_VMAPPED = ("dct_tpu vmaps K models as one stacked pytree; the port keeps K "
            "Segmentators, each with its own state")
_S2D = ("exact space-to-depth rewrites of ENet's strided convolutions for the "
        "TPU's lanes, pinned equal to the plain forms by tests/test_enet_fast_paths.py; "
        "the port runs the plain convolutions")
_OPTAX = ("optax plumbing: the port's optimizers are torch optimizers and "
          "optim.py:DirectionOptimizer, which compute the same updates")
# dct_tpu "file:name" → why the port has no counterpart
WRITTEN_OFF = {
    "models/segmentator.py:SegState": _VMAPPED,
    "models/segmentator.py:stack_states": _VMAPPED,
    "models/segmentator.py:unstack_states": _VMAPPED,
    "models/__init__.py:SegState": _VMAPPED,
    "models/__init__.py:stack_states": _VMAPPED,
    "models/__init__.py:unstack_states": _VMAPPED,
    "models/enet.py:space_to_depth_2x2": _S2D,
    "ops/pooling.py:IMPL": ("the switch between two lax layouts of the same pool "
                            "(strided slices or one space-to-depth reshape); the port's "
                            "plain pool has one layout and its kernels another"),
    "optim.py:flatten_tx": _OPTAX,
    "optim.py:scale_by_adabound": _OPTAX,
    "optim.py:apply_direction": _OPTAX,
    "models/backbones.py:VGG16_STAGES": ("the stage widths of VGG16Features, which "
                                         "models/vgg.py builds inline"),
}

# the root scripts of the JAX package: the port's module of the same name, or why none
ROOT_SCRIPTS = ["bench.py", "summary.py", "train_cotraining.py", "train_cotraining_city.py",
                "train_mean_teacher.py", "train_sup.py", "train_sup_city.py", "train_vat.py"]
ROOT_MOVED = {
    "summary.py:soft_voting": "train/steps.py:make_summary_step",
    "summary.py:hard_voting": "train/steps.py:make_summary_step",
    "summary.py:dice_from_class_maps": "train/steps.py:make_summary_step",
    "train_cotraining.py:get_models": "cli.py:build_segmentators",
}
_TPU_TUNING = ("measures or gates dct_tpu on the TPU; the port's counterparts are "
               "python -m dct_tpu_torch.bench and python -m dct_tpu_torch.parallel.dryrun")
ROOT_WRITTEN_OFF = {
    "bench_aug_ab.py": _TPU_TUNING, "bench_channel.py": _TPU_TUNING,
    "bench_ops.py": _TPU_TUNING, "bench_scaling.py": _TPU_TUNING,
    "__graft_entry__.py": _TPU_TUNING, "scripts/*.py": _TPU_TUNING,
    "chip_smoke.py": "the port's own smoke run on the card",
}


def public_names(path: Path) -> set:
    """Public top-level definitions and assignments of a module; for an
    ``__init__.py`` also the names it imports (its exports)."""
    names = set()
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            names.add(node.name)
        elif isinstance(node, ast.Assign):
            names.update(t.id for t in node.targets if isinstance(t, ast.Name))
        elif isinstance(node, ast.AnnAssign) and isinstance(node.target, ast.Name):
            names.add(node.target.id)
        elif isinstance(node, ast.ImportFrom) and path.name == "__init__.py":
            names.update(a.asname or a.name for a in node.names)
    return {n for n in names if not n.startswith("_")}


def all_names(pkg: Path) -> dict:
    return {p.relative_to(pkg).as_posix(): public_names(p) for p in sorted(pkg.rglob("*.py"))}


def missing(ref: dict, port: dict, moved: dict, written_off: dict) -> list:
    out = []
    for module, names in ref.items():
        for name in sorted(names):
            key = f"{module}:{name}"
            if key in written_off:
                continue
            target_module, target = moved.get(key, key).split(":")
            if target not in port.get(target_module, set()):
                out.append(key)
    return out


def test_every_public_name_of_dct_tpu_has_a_counterpart():
    gaps = missing(all_names(JAX_PKG), all_names(PORT_PKG), MOVED, WRITTEN_OFF)
    assert not gaps, f"no counterpart in dct_tpu_torch and not written off: {gaps}"


def test_every_root_script_has_a_counterpart():
    port = all_names(PORT_PKG)
    gaps = missing({f: public_names(ROOT / f) for f in ROOT_SCRIPTS}, port, ROOT_MOVED, {})
    assert not gaps, gaps
    scripts = {p.relative_to(ROOT).as_posix() for p in ROOT.glob("*.py")} | {
        p.relative_to(ROOT).as_posix() for p in (ROOT / "scripts").glob("*.py")}
    for script in sorted(scripts):
        written_off = script in ROOT_WRITTEN_OFF or (
            script.startswith("scripts/") and "scripts/*.py" in ROOT_WRITTEN_OFF)
        assert written_off or script in ROOT_SCRIPTS, script


@pytest.mark.parametrize("table", ["MOVED", "WRITTEN_OFF", "ROOT_MOVED"])
def test_tables_name_real_definitions(table):
    """Every entry names a public definition that exists on the dct_tpu
    side (a stale entry would hide a gap), and every counterpart exists in
    the port; every write-off carries a reason."""
    ref = all_names(JAX_PKG) if table != "ROOT_MOVED" else {
        f: public_names(ROOT / f) for f in ROOT_SCRIPTS}
    port = all_names(PORT_PKG)
    entries = globals()[table]
    for key, value in entries.items():
        module, name = key.split(":")
        assert name in ref.get(module, set()), key
        if table == "WRITTEN_OFF":
            assert len(value) > 20, key
            assert name not in port.get(module, set()), f"{key} is ported: drop the entry"
        else:
            target_module, target = value.split(":")
            assert target in port.get(target_module, set()), value


def test_exports_match():
    """Each subpackage's ``__init__.py`` exports the counterparts of the
    names dct_tpu's exports."""
    ref, port = all_names(JAX_PKG), all_names(PORT_PKG)
    for module in (m for m in ref if m.endswith("__init__.py")):
        want = {n for n in ref[module] if f"{module}:{n}" not in WRITTEN_OFF}
        assert want <= port.get(module, set()), (module, sorted(want - port.get(module, set())))
