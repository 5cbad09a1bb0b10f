"""The port's ``utils/torch_convert.py`` against dct_tpu's, and the new
nets' checkpoints through dct_tpu's layout, on the CPU.

* ``convert_deeplabv2``, ``convert_enet`` and ``convert_unet`` (both
  layouts) on synthetic state_dicts with the reference's keys (made from
  the port's nets by inverting the key maps) give dct_tpu's trees, leaf for
  leaf, exactly, and those trees load into the port's nets.
* ``init_from_torch_deeplab`` merges a COCO-headed DeepLabV2 state_dict
  into a 5-class DeepLabV2 as dct_tpu's does: the same trees, and the same
  loaded/skipped line; with nothing matching it asserts, as dct_tpu does.
* ``python -m dct_tpu_torch.utils.torch_convert`` writes a checkpoint that
  dct_tpu's ``load_checkpoint`` reads equal to what dct_tpu's own CLI
  writes.
* Every new arch's Segmentator checkpoint (weights and Adam state per
  leaf, the Dense kernels of the classifiers included; JEnet's, CorstemNet's
  and ResNet18's in dct_tpu's flat ``fused`` layout too) round-trips
  through ``save_checkpoint``/``load_checkpoint`` and dct_tpu's unpickler.
"""
import numpy as np
import pytest
import torch

from dct_tpu.checkpoint import load_checkpoint as jax_load_checkpoint
from dct_tpu.utils import torch_convert as jax_tc
from dct_tpu_torch.checkpoint import load_checkpoint, save_checkpoint
from dct_tpu_torch.models import Segmentator, get_arch
from dct_tpu_torch.utils import torch_convert as tc
from dct_tpu_torch.utils.convert import params_from_jax, params_to_jax
from test_torch_archref import _leaves
from test_torch_city_cli import reference_deeplabv2_state_dict
from test_torch_jaxref import one_torch_thread  # noqa: F401  (autouse)
from test_torch_slice import _reference_key as enet_reference_key


def assert_trees_equal(got, ref):
    g, r = dict(_leaves(got)), dict(_leaves(ref))
    assert g.keys() == r.keys()
    for path, v in r.items():
        assert g[path].dtype == v.dtype, path
        np.testing.assert_array_equal(g[path], v, err_msg=str(path))


def _random_state_dict(net, seed):
    rs = np.random.RandomState(seed)
    return {k: torch.from_numpy(rs.standard_normal(tuple(v.shape)).astype(np.float32))
            for k, v in net.state_dict().items()}


def test_convert_deeplabv2_equals_dct_tpu():
    sd = reference_deeplabv2_state_dict(num_classes=5)
    got, ref = tc.convert_deeplabv2(sd), jax_tc.convert_deeplabv2(sd)
    assert_trees_equal(got, ref)
    net = get_arch("deeplabv2", {"num_classes": 5, "n_blocks": [1, 1, 1, 1], "in_channels": 3})
    net.load_state_dict(params_from_jax(got["params"], got["batch_stats"]))


def test_convert_enet_equals_dct_tpu():
    net = get_arch("enet", {"num_classes": 4})
    sd = {enet_reference_key(k): v for k, v in _random_state_dict(net, 1).items()}
    got, ref = tc.convert_enet(sd), jax_tc.convert_enet(sd)
    assert_trees_equal(got, ref)
    net.load_state_dict(params_from_jax(got["params"], got["batch_stats"]))


def _unet_reference_state_dict(bn, seed):
    """The reference UNet's keys (``dec1.down.0.weight``, ``center.3.bias``,
    ``enc4.up.6.weight``, ``final.weight``, …) for every entry of
    dct_tpu's ``convert_unet`` tables, with small random tensors."""
    rs = np.random.RandomState(seed)
    conv = {"0": "conv", "2": "conv"} if not bn else {"0": "conv", "1": "bn", "3": "conv"}
    center = ({"0": "conv", "2": "conv", "5": "deconv"} if not bn else
              {"0": "conv", "1": "bn", "3": "conv", "4": "bn", "7": "deconv"})
    enc = ({"0": "conv", "2": "conv", "4": "deconv"} if not bn else
           {"0": "conv", "1": "bn", "3": "conv", "4": "bn", "6": "deconv"})
    sd = {"final.weight": rs.randn(2, 3, 1, 1), "final.bias": rs.randn(2)}
    modules = [(f"dec{i}.down", conv) for i in range(1, 5)] + [("center", center)] + [
        (f"enc{i}.up", enc) for i in range(2, 5)] + [("enc1.up", conv)]
    for prefix, table in modules:
        for idx, kind in table.items():
            if kind == "bn":
                for leaf in ("weight", "bias", "running_mean", "running_var"):
                    sd[f"{prefix}.{idx}.{leaf}"] = rs.randn(3)
                sd[f"{prefix}.{idx}.num_batches_tracked"] = np.int64(4)
            else:
                sd[f"{prefix}.{idx}.weight"] = rs.randn(3, 3, 2, 2)
                sd[f"{prefix}.{idx}.bias"] = rs.randn(3)
    return {k: torch.from_numpy(np.asarray(v)) for k, v in sd.items()}


@pytest.mark.parametrize("bn", [False, True])
def test_convert_unet_equals_dct_tpu(bn):
    sd = _unet_reference_state_dict(bn, 2)
    got, ref = tc.convert_unet(sd, bn), jax_tc.convert_unet(sd, bn)
    assert_trees_equal(got, ref)
    port = params_from_jax(got["params"], got["batch_stats"])
    want = get_arch("unet_bn" if bn else "unet", {"num_classes": 2}).state_dict()
    assert port.keys() == want.keys()


def _deeplabv2_state(num_classes, seed):
    net = get_arch("deeplabv2", {"num_classes": num_classes, "n_blocks": [1, 1, 1, 1],
                                 "in_channels": 3})
    net.load_state_dict(_random_state_dict(net, seed))
    params, stats = params_to_jax({k: v.clone() for k, v in net.state_dict().items()})
    return {"params": params, "batch_stats": stats}


def test_init_from_torch_deeplab_equals_dct_tpu(capsys):
    """A 21-class COCO head into a 5-class model: the trunk loads, the four
    ASPP heads (kernel and bias each) are skipped."""
    sd = reference_deeplabv2_state_dict(num_classes=21, seed=3)
    target = _deeplabv2_state(5, 4)
    got = tc.init_from_torch_deeplab(target, sd)
    line = capsys.readouterr().out
    ref = jax_tc.init_from_torch_deeplab(target, sd)
    assert capsys.readouterr().out == line
    n_trunk = sum(1 for k in sd if "aspp" not in k and "num_batches" not in k)
    assert line == f">> torch init: loaded {n_trunk} tensors, skipped 8 (shape mismatch)\n"
    assert_trees_equal(got, ref)
    np.testing.assert_array_equal(got["params"]["aspp"]["c0"]["kernel"],
                                  target["params"]["aspp"]["c0"]["kernel"])
    # pre-converted payloads (the CLI's .ckpt) merge the same way
    assert_trees_equal(tc.init_from_torch_deeplab(target, tc.convert_deeplabv2(sd),
                                                  verbose=False), ref)


def test_init_from_torch_deeplab_asserts_when_nothing_matches():
    net = get_arch("enet", {"num_classes": 4})
    params, stats = params_to_jax(net.state_dict())
    state = {"params": params, "batch_stats": stats}
    sd = reference_deeplabv2_state_dict(num_classes=21)
    for fn in (tc.init_from_torch_deeplab, jax_tc.init_from_torch_deeplab):
        with pytest.raises(AssertionError, match="no torch weights matched"):
            fn(state, sd, verbose=False)


def test_cli_writes_what_dct_tpu_reads(tmp_path):
    pth = tmp_path / "coco.pth"
    torch.save(reference_deeplabv2_state_dict(num_classes=21, seed=5), pth)
    tc.main(["--pth", str(pth), "--out", str(tmp_path / "port.ckpt")])
    jax_tc.main(["--pth", str(pth), "--out", str(tmp_path / "ref.ckpt")])
    assert_trees_equal(jax_load_checkpoint(tmp_path / "port.ckpt"),
                       jax_load_checkpoint(tmp_path / "ref.ckpt"))


# every new arch at a small size it accepts, with its data's channel count
NEW_ARCHS = [("deeplabv2", {"n_blocks": [1, 1, 1, 1]}, 3),
             ("deeplabv3", {"n_blocks": [1, 1, 1, 1], "grids": [1]}, 3),
             ("deeplabv3plus", {"n_blocks": [1, 1, 1, 1], "grids": [1]}, 3),
             ("pspnet", {"n_blocks": [1, 1, 1, 1]}, 1), ("jenet", {}, 1), ("cnet", {}, 1),
             ("vgg11", {}, 1), ("resnet18", {}, 1)]


# the per-leaf layout for each, dct_tpu's flat ``fused`` one for the small
# nets (it shares ``utils/convert.py:_template`` with every net's tree)
ROUND_TRIPS = [(*a, False) for a in NEW_ARCHS] + [
    (*a, True) for a in NEW_ARCHS if a[0] in ("jenet", "cnet", "resnet18")]


@pytest.mark.parametrize("name,arch,cin,fused", ROUND_TRIPS,
                         ids=[f"{a[0]}-{'fused' if a[3] else 'per_leaf'}" for a in ROUND_TRIPS])
def test_checkpoint_round_trip(tmp_path, name, arch, cin, fused):
    optim = {"name": "Adam", "lr": 1e-3, "fused": fused}
    step = {"name": "StepLR", "step_size": 90, "gamma": 0.1}
    seg = Segmentator({"name": name, "num_classes": 4, **arch}, optim, step,
                      torch.Generator().manual_seed(0), device="cpu", in_channels=cin)
    gen = torch.Generator().manual_seed(1)
    for p in seg.net.parameters():
        p.grad = torch.randn(p.shape, generator=gen)
    seg.optimizer.step()
    payload = seg.state_dict
    save_checkpoint(tmp_path / "m.ckpt", {"segmentator": payload})
    sd = load_checkpoint(tmp_path / "m.ckpt")["segmentator"]
    assert set(jax_load_checkpoint(tmp_path / "m.ckpt")["segmentator"]) == set(payload)
    back = Segmentator.from_state_dict(sd, device="cpu", in_channels=cin)
    for (k, v), (k2, v2) in zip(seg.net.state_dict().items(), back.net.state_dict().items()):
        assert k == k2 and torch.equal(v, v2), k
    for p, q in zip(seg.net.parameters(), back.net.parameters()):
        for key in ("exp_avg", "exp_avg_sq"):
            assert torch.equal(seg.optimizer.state[p][key], back.optimizer.state[q][key])
        assert float(back.optimizer.state[q]["step"]) == 1.0
