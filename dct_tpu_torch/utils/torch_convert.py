"""Reference torch state_dicts → dct_tpu's flax-layout trees
(``dct_tpu/utils/torch_convert.py``), kept here as the port's own copy: the
COCO-pretrained DeepLabV2 init of the Cityscapes CLIs, and the reference's
ENet and UNet checkpoints.

The reference initialises its Cityscapes trainers from
``deeplabv2_resnet101_COCO_init.pth`` with ``scale.`` prefixes stripped and
``strict=False``. These functions return nested dicts of numpy arrays in
dct_tpu's layout (``{"params": …, "batch_stats": …}``), which
``utils/convert.py:params_from_jax`` maps onto the port's nets; the module
names of the port's DeepLab mirror the reference's torch names:

    torch  layer1.conv1.conv.weight            → trunk/layer1_conv1/Conv_0/kernel
    torch  layerN.blockM.reduce.bn.weight      → trunk/layerN/blockM/reduce/BatchNorm_0/scale
    torch  layerN.blockM.*.bn.running_mean     → batch_stats …/BatchNorm_0/mean
    torch  aspp.stages.cI.{weight,bias}        → aspp/cI/{kernel,bias}

Conv kernels transpose (O,I,kh,kw) → (kh,kw,I,O); ConvTranspose kernels
are flipped too. Mismatched shapes (a COCO class head against a 19-class
model) are skipped, as the reference's ``strict=False`` load skips them.

    python -m dct_tpu_torch.utils.torch_convert --pth deeplabv2_COCO_init.pth \
        --out coco_init.ckpt

writes the converted trees as a checkpoint (``checkpoint.save_checkpoint``)
that ``Trainer.coco_init_pth`` and dct_tpu's ``load_checkpoint`` read.
"""
from __future__ import annotations

import re
from typing import Any, Dict, Optional, Tuple

import numpy as np

_BN_MAP = {"weight": ("params", "scale"), "bias": ("params", "bias"),
           "running_mean": ("batch_stats", "mean"),
           "running_var": ("batch_stats", "var")}


def _to_numpy(t) -> np.ndarray:
    if hasattr(t, "detach"):          # a torch tensor
        t = t.detach().cpu().numpy()
    return np.asarray(t)


def deeplabv2_key_to_path(key: str) -> Optional[Tuple[str, Tuple[str, ...], bool]]:
    """torch state_dict key → (collection, flax path, transpose_conv).
    Returns None for keys to skip (num_batches_tracked, unknown)."""
    key = key[len("scale."):] if key.startswith("scale.") else key
    if key.endswith("num_batches_tracked"):
        return None

    m = re.fullmatch(r"layer1\.conv1\.(conv|bn)\.(\w+)", key)
    if m:
        base: Tuple[str, ...] = ("trunk", "layer1_conv1")
        sub, leaf = m.group(1), m.group(2)
    else:
        m = re.fullmatch(
            r"(layer[2-5])\.(block\d+)\.(reduce|conv3x3|increase|proj)\.(conv|bn)\.(\w+)",
            key)
        if m:
            base = ("trunk", m.group(1), m.group(2), m.group(3))
            sub, leaf = m.group(4), m.group(5)
        else:
            m2 = re.fullmatch(r"aspp\.stages\.(c\d+)\.(weight|bias)", key)
            if m2:
                leaf = "kernel" if m2.group(2) == "weight" else "bias"
                return ("params", ("aspp", m2.group(1), leaf),
                        m2.group(2) == "weight")
            return None

    if sub == "conv":
        if leaf != "weight":
            return None
        return ("params", base + ("Conv_0", "kernel"), True)
    if leaf not in _BN_MAP:
        return None
    coll, flax_leaf = _BN_MAP[leaf]
    return (coll, base + ("BatchNorm_0", flax_leaf), False)


def convert_deeplabv2(state_dict: Dict[str, Any]) -> Dict[str, Dict]:
    """torch DeepLabV2(-ResNet101) state_dict → {'params': …, 'batch_stats': …}
    nested dicts in dct_tpu's DeepLabV2 layout."""
    out: Dict[str, Dict] = {"params": {}, "batch_stats": {}}
    for key, val in state_dict.items():
        mapped = deeplabv2_key_to_path(key)
        if mapped is None:
            continue
        coll, path, transpose = mapped
        arr = _to_numpy(val)
        if transpose and arr.ndim == 4:
            arr = arr.transpose(2, 3, 1, 0)   # (O,I,kh,kw) → (kh,kw,I,O)
        node = out[coll]
        for p in path[:-1]:
            node = node.setdefault(p, {})
        node[path[-1]] = arr
    return out


# --------------------------------------------------------------------------
# ENet / UNet converters (the reference's generalframework/arch/enet.py and
# network.py layouts)
# --------------------------------------------------------------------------

def _conv_k(arr: np.ndarray) -> np.ndarray:
    """torch Conv2d weight (O,I,kh,kw) → flax (kh,kw,I,O)."""
    return arr.transpose(2, 3, 1, 0)


def _deconv_k(arr: np.ndarray) -> np.ndarray:
    """torch ConvTranspose2d weight (I,O,kh,kw) → flax ConvTranspose kernel
    (kh,kw,I,O), spatially flipped (lax.conv_transpose does not flip)."""
    return arr.transpose(2, 3, 0, 1)[::-1, ::-1]


def _set(out: Dict, coll: str, path: Tuple[str, ...], arr: np.ndarray) -> None:
    node = out[coll]
    for p in path[:-1]:
        node = node.setdefault(p, {})
    node[path[-1]] = arr


def _bn_entry(out: Dict, base: Tuple[str, ...], leaf: str, arr: np.ndarray) -> bool:
    if leaf not in _BN_MAP:
        return leaf == "num_batches_tracked"
    coll, flax_leaf = _BN_MAP[leaf]
    _set(out, coll, base + (flax_leaf,), arr)
    return True


# dct_tpu's Enet (and the port's) flattens the reference's two dilated
# sections into bottleneck_2_1..2_16; torch names them bottleneck_2_1..2_8
# + bottleneck_3_1..3_8
_ENET_DEC_NAMES = {0: "bottleneck_4_0", 1: "bottleneck_4_1", 2: "bottleneck_4_2",
                   3: "bottleneck_5_0", 4: "bottleneck_5_1"}
_ENET_UP = {"bottleneck_4_0", "bottleneck_5_0"}
# decoder bottlenecks are use_relu=True → no PReLU params exist there
_ENET_RELU = set(_ENET_DEC_NAMES.values())


def _enet_block_name(key: str) -> Optional[Tuple[str, str]]:
    """torch 'encoder.bottleneck_3_4.rest' / 'decoder.layers.2.rest' →
    (flax block name, rest)."""
    m = re.fullmatch(r"encoder\.(initial|bottleneck_(\d)_(\d+))\.(.*)", key)
    if m:
        name = m.group(1)
        if name != "initial" and m.group(2) == "3":
            name = f"bottleneck_2_{8 + int(m.group(3))}"
        return name, m.group(4)
    m = re.fullmatch(r"decoder\.layers\.(\d+)\.(.*)", key)
    if m:
        i = int(m.group(1))
        if i == 5:
            return "fullconv", m.group(2)
        return _ENET_DEC_NAMES[i], m.group(2)
    return None


def convert_enet(state_dict: Dict[str, Any]) -> Dict[str, Dict]:
    """Reference torch Enet state_dict → dct_tpu Enet
    {'params','batch_stats'} pytrees."""
    out: Dict[str, Dict] = {"params": {}, "batch_stats": {}}
    for key, val in state_dict.items():
        arr = _to_numpy(val)
        loc = _enet_block_name(key)
        assert loc is not None, f"unmapped ENet key: {key}"
        name, rest = loc
        if name == "initial":
            sub, leaf = rest.split(".", 1)
            if sub == "conv":
                _set(out, "params", ("initial", "Conv_0",
                                     "kernel" if leaf == "weight" else "bias"),
                     _conv_k(arr) if leaf == "weight" else arr)
            elif sub == "batch_norm":
                assert _bn_entry(out, ("initial", "BatchNorm_0"), leaf, arr), key
            else:
                assert (sub, leaf) == ("prelu", "weight"), key
                _set(out, "params", ("initial", "PReLU_0", "alpha"), arr)
            continue
        if name == "fullconv":
            _set(out, "params", ("fullconv",
                                 "kernel" if rest == "weight" else "bias"),
                 _deconv_k(arr) if rest == "weight" else arr)
            continue
        parts = rest.split(".")
        sub = parts[0]
        if sub == "block1x1_1":
            tgt = {"0": "proj_in", "1": "bn_in", "2": "act_in"}[parts[1]]
        elif sub == "block1x1_2":
            tgt = {"0": "proj_out", "1": "bn_out", "2": "act_out"}[parts[1]]
        elif sub == "conv_before_unpool":
            tgt = {"0": "unpool_proj", "1": "bn_unpool"}[parts[1]]
        elif sub == "middle_block":
            if parts[1] == "0":
                if len(parts) == 4:   # asym: middle_block.0.{0,1}.leaf
                    tgt = "mid_conv_a" if parts[2] == "0" else "mid_conv_b"
                    parts = [sub, parts[2], parts[3]]
                else:
                    tgt = "mid_deconv" if name in _ENET_UP else "mid_conv"
            else:
                tgt = {"1": "bn_mid", "2": "act_mid"}[parts[1]]
        else:
            raise AssertionError(f"unmapped ENet key: {key}")
        leaf = parts[-1]
        if tgt.startswith("bn_"):
            # bottleneck BNs are explicitly named (batch_norm(name="bn_x")),
            # so there is no auto "BatchNorm_0" level under them
            assert _bn_entry(out, (name, tgt), leaf, arr), key
        elif tgt.startswith("act_"):
            assert leaf == "weight", key
            _set(out, "params", (name, tgt, "alpha"), arr)
        elif tgt == "mid_deconv":
            _set(out, "params", (name, tgt,
                                 "kernel" if leaf == "weight" else "bias"),
                 _deconv_k(arr) if leaf == "weight" else arr)
        else:
            _set(out, "params", (name, tgt,
                                 "kernel" if leaf == "weight" else "bias"),
                 _conv_k(arr) if leaf == "weight" else arr)
    return out


def convert_unet(state_dict: Dict[str, Any], bn: bool) -> Dict[str, Dict]:
    """Reference torch UNet / UNet_bn state_dict → dct_tpu UNet pytrees.
    ``bn`` selects the sequential-index layout of the _bn variant."""
    # per-module maps: torch sequential index → flax submodule name
    if bn:
        dec = {"0": ("Conv_0", "conv"), "1": ("BatchNorm_0", "bn"),
               "3": ("Conv_1", "conv")}
        center = {"0": ("Conv_0", "conv"), "1": ("BatchNorm_0", "bn"),
                  "3": ("Conv_1", "conv"), "4": ("BatchNorm_1", "bn"),
                  "7": ("__up__", "deconv")}
        enc = {"0": ("_DoubleConv_0/Conv_0", "conv"),
               "1": ("_DoubleConv_0/BatchNorm_0", "bn"),
               "3": ("_DoubleConv_0/Conv_1", "conv"),
               "4": ("_DoubleConv_0/BatchNorm_1", "bn"),
               "6": ("ConvTranspose_0", "deconv")}
        enc1 = dec
    else:
        dec = {"0": ("Conv_0", "conv"), "2": ("Conv_1", "conv")}
        center = {"0": ("Conv_0", "conv"), "2": ("Conv_1", "conv"),
                  "5": ("__up__", "deconv")}
        enc = {"0": ("_DoubleConv_0/Conv_0", "conv"),
               "2": ("_DoubleConv_0/Conv_1", "conv"),
               "4": ("ConvTranspose_0", "deconv")}
        enc1 = dec

    out: Dict[str, Dict] = {"params": {}, "batch_stats": {}}
    for key, val in state_dict.items():
        arr = _to_numpy(val)
        if key.startswith("final."):
            leaf = key.split(".", 1)[1]
            _set(out, "params", ("final", "kernel" if leaf == "weight" else "bias"),
                 _conv_k(arr) if leaf == "weight" else arr)
            continue
        m = re.fullmatch(r"(dec[1-4]|center|enc[1-4])\.(down|up|)\.?(\d+)\.(\w+)", key)
        assert m, f"unmapped UNet key: {key}"
        mod, _seq, idx, leaf = m.groups()
        table = (center if mod == "center" else
                 enc1 if mod == "enc1" else
                 enc if mod.startswith("enc") else dec)
        assert idx in table, f"unmapped UNet key: {key}"
        sub, kind = table[idx]
        if sub == "__up__":
            path: Tuple[str, ...] = ("center_up",)
        else:
            path = (mod,) + tuple(sub.split("/"))
        if kind == "bn":
            assert _bn_entry(out, path, leaf, arr), key
        elif kind == "deconv":
            _set(out, "params", path + ("kernel" if leaf == "weight" else "bias",),
                 _deconv_k(arr) if leaf == "weight" else arr)
        else:
            _set(out, "params", path + ("kernel" if leaf == "weight" else "bias",),
                 _conv_k(arr) if leaf == "weight" else arr)
    return out


def merge_pytree(dst: Dict, src: Dict) -> Tuple[Dict, int, int]:
    """Recursively copy matching-shape leaves of ``src`` onto a copy of
    ``dst``; returns (merged, n_loaded, n_skipped) — strict=False semantics."""
    loaded = skipped = 0

    def rec(d, s):
        nonlocal loaded, skipped
        out = {}
        for k, v in d.items():
            if k in s:
                if isinstance(v, dict) and isinstance(s[k], dict):
                    out[k] = rec(v, s[k])
                    continue
                sv = np.asarray(s[k])
                if hasattr(v, "shape") and tuple(v.shape) == tuple(sv.shape):
                    out[k] = sv.astype(v.dtype)
                    loaded += 1
                else:
                    out[k] = v
                    skipped += 1
            else:
                out[k] = v
        return out

    return rec(dst, src), loaded, skipped


def init_from_torch_deeplab(state: Dict, torch_state_dict: Dict[str, Any],
                            verbose: bool = True) -> Dict:
    """Merge a torch DeepLabV2 checkpoint (raw state_dict, or one already
    converted by ``convert_deeplabv2``/the CLI) into a Segmentator-style
    ``{'params','batch_stats',...}`` state. Returns the new state."""
    if set(torch_state_dict.keys()) == {"params", "batch_stats"}:
        conv = torch_state_dict          # pre-converted payload
    else:
        conv = convert_deeplabv2(torch_state_dict)
    params, n_p, s_p = merge_pytree(state["params"], conv["params"])
    bstats, n_b, s_b = merge_pytree(state["batch_stats"], conv["batch_stats"])
    assert n_p + n_b > 0, "no torch weights matched the flax tree"
    if verbose:
        print(f">> torch init: loaded {n_p + n_b} tensors, "
              f"skipped {s_p + s_b} (shape mismatch)")
    return {**state, "params": params, "batch_stats": bstats}


def main(argv=None) -> None:
    """CLI: convert a .pth into a checkpoint of dct_tpu's layout.

    python -m dct_tpu_torch.utils.torch_convert --pth deeplabv2_COCO_init.pth \
        --out coco_init.ckpt
    """
    import argparse

    import torch

    from ..checkpoint import save_checkpoint

    parser = argparse.ArgumentParser(description="torch → dct_tpu converter")
    parser.add_argument("--pth", required=True)
    parser.add_argument("--out", required=True)
    args = parser.parse_args(argv)

    sd = torch.load(args.pth, map_location="cpu")
    if hasattr(sd, "state_dict"):
        sd = sd.state_dict()
    save_checkpoint(args.out, convert_deeplabv2(sd))
    print(f">> wrote {args.out}")


if __name__ == "__main__":
    main()
