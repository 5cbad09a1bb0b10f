"""The Cityscapes data of the port (``data/cityscapes.py``) against
``dct_tpu.data.cityscapes``, on the CPU: the label encoding and its
picture, the dataset loaded from a synthetic tree whose PNGs (40×88) are
larger than and not shaped like ``image_size`` (24×48), so the bilinear and
nearest resizes run, ``subsample``, ``subset``, ``extract_cities``, the
labeled/unlabeled split and ``get_cityscapes_split``. Every array, file
name, path and city must equal dct_tpu's exactly. No JAX code runs.
"""
import numpy as np
import pytest

from dct_tpu.data import cityscapes as ref
from dct_tpu_torch.data import cityscapes as port
from test_torch_trees import write_city_tree

SIZE = (24, 48)


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return write_city_tree(tmp_path_factory.mktemp("city"),
                           counts={"train": 5, "val": 2, "test": 1})


def assert_same(a, b):
    """Two CityscapesDatasets of the two packages hold the same data."""
    assert a.filenames == b.filenames and a.cities == b.cities
    assert a.img_paths == b.img_paths and a.gt_paths == b.gt_paths
    assert a.image_size == tuple(b.image_size) and len(a) == len(b)
    for key in ("img", "gt"):
        assert a.data[key].dtype == b.data[key].dtype == np.uint8
        np.testing.assert_array_equal(a.data[key], b.data[key])


def test_encode_equals_dct_tpu_on_every_raw_id():
    raw = np.arange(256, dtype=np.uint8).reshape(16, 16)
    np.testing.assert_array_equal(port.encode_segmap(raw), ref.encode_segmap(raw))
    assert port.encode_segmap(raw).dtype == np.uint8
    enc = port.encode_segmap(np.array([[7, 8, 0], [26, 33, 29]]))
    np.testing.assert_array_equal(enc, [[0, 1, 250], [13, 18, 250]])


def test_decode_equals_dct_tpu():
    mask = np.concatenate([np.arange(19), [250, 19, 0]]).reshape(2, 11)
    np.testing.assert_array_equal(port.decode_segmap(mask), ref.decode_segmap(mask))


def test_constants_equal_dct_tpu():
    for name in ("VOID_CLASSES", "VALID_CLASSES", "CLASS_NAMES", "IGNORE_INDEX",
                 "NUM_CLASSES", "CITYSCAPES_MEAN", "CITYSCAPES_STD"):
        assert getattr(port, name) == getattr(ref, name), name


@pytest.mark.parametrize("mode,subsample", [("train", 1), ("train", 4), ("val", 1),
                                            ("test", 1)])
def test_dataset_equals_dct_tpu(root, mode, subsample):
    got = port.CityscapesDataset(root, mode, SIZE, subsample, quite=True)
    want = ref.CityscapesDataset(root, mode, SIZE, subsample, quite=True)
    assert_same(got, want)
    assert got.data["img"].shape == (len(got),) + SIZE + (3,)
    assert set(np.unique(got.data["gt"])) <= set(range(19)) | {250}
    assert 250 in got.data["gt"]          # the void ids of the tree


@pytest.fixture(scope="module")
def both(root):
    return (port.CityscapesDataset(root, "train", SIZE, 1, quite=True),
            ref.CityscapesDataset(root, "train", SIZE, 1, quite=True))


def test_subset_and_extract_cities(both):
    got, want = both
    assert_same(got.subset([3, 0, 7]), want.subset([3, 0, 7]))
    for cities in (["aachen"], ["bremen", "bochum"]):
        sub = got.extract_cities(cities)
        assert_same(sub, want.extract_cities(cities))
        assert set(sub.cities) == set(cities)


@pytest.mark.parametrize("p,seed", [(0.5, 1), (0.3, 1234)])
def test_split_by_proportion(both, p, seed):
    got, want = both
    for a, b in zip(got.split_by_proportion(p, seed), want.split_by_proportion(p, seed)):
        assert_same(a, b)


@pytest.mark.parametrize("k,sets,overlap,seed", [(2, 0.5, 0.9, 1234), (3, 0.6, 0.5, 7)])
def test_get_cityscapes_split(root, k, sets, overlap, seed):
    config = {"Dataset": {"name": "cityscapes", "root_dir": str(root),
                          "image_size": list(SIZE), "subsample": 1},
              "Lab_Partitions": {"num_models": k, "partition_sets": sets,
                                 "partition_overlap": overlap},
              "Seed": seed}
    (lab, unlab, val), (rlab, runlab, rval) = (port.get_cityscapes_split(config),
                                               ref.get_cityscapes_split(config))
    assert len(lab) == len(rlab) == k
    for a, b in zip(lab + [unlab, val], rlab + [runlab, rval]):
        assert_same(a, b)
    assert lab[0].filenames != lab[1].filenames
