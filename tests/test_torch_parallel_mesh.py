"""The port's mesh of ranks (``dct_tpu_torch/parallel/mesh.py``) against
dct_tpu's device mesh on the conftest's 8 virtual CPU devices: the
chooser's shapes and layout, and each rank's placements equal to the
shards dct_tpu's placements put on the device of the same index. Layout
only: no process group is made (each port mesh is seen from one rank)."""
import jax
import numpy as np
import pytest

from dct_tpu.parallel import mesh as jax_mesh
from dct_tpu_torch.parallel import mesh as port_mesh


def ids(mesh):
    return np.vectorize(lambda d: d.id)(mesh.devices)


@pytest.mark.parametrize("K,n", [(2, 8), (3, 8), (4, 4), (2, 1)])
def test_mesh_choice_equals_dct_tpus(K, n):
    for ref, got in ((jax_mesh.choose_parallel_mesh(K, n),
                      port_mesh.choose_parallel_mesh(K, n, rank=0)),
                     (jax_mesh.data_parallel_mesh(n), port_mesh.data_parallel_mesh(n, rank=0))):
        if ref is None:
            assert got is None
            continue
        assert got.shape == dict(ref.shape)
        np.testing.assert_array_equal(got.devices, ids(ref))


def shard_on(arr, rank):
    """The data dct_tpu's placement put on device ``rank``."""
    (shard,) = [s for s in arr.addressable_shards if s.device == jax.devices()[rank]]
    return np.asarray(shard.data)


@pytest.mark.parametrize("n,n_model", [(8, 2), (4, 1), (4, 4), (8, 1)])
def test_placements_equal_dct_tpus_shards(n, n_model):
    n_data = n // n_model
    K, T, B, Bu = 2 * n_model, 3, 2 * n_data, n_data
    rs = np.random.RandomState(n)
    idx_lab = rs.randint(0, 99, (T, K, B)).astype(np.int32)
    idx_unlab = rs.randint(0, 99, (T, Bu)).astype(np.int32)
    pairs = rs.randint(0, K, (T, 2)).astype(np.int32)
    stacked = rs.randn(K, 3).astype(np.float32)
    ref_mesh = jax_mesh.make_mesh(n, n_model)
    ref = jax_mesh.place_batches(ref_mesh, idx_lab, idx_unlab, pairs)
    ref_idx = jax_mesh.dp_shard_idx(ref_mesh, idx_unlab)
    ref_state = jax_mesh.place_stacked_state(ref_mesh, {"w": stacked}, K)["w"]
    for rank in range(n):
        mesh = port_mesh.make_mesh(n, n_model, rank=rank)
        got = port_mesh.place_batches(mesh, idx_lab, idx_unlab, pairs)
        for r, g in zip(ref, got):
            np.testing.assert_array_equal(g, shard_on(r, rank))
        np.testing.assert_array_equal(port_mesh.dp_shard_idx(mesh, idx_unlab),
                                      shard_on(ref_idx, rank))
        np.testing.assert_array_equal(port_mesh.place_stacked_state(mesh, stacked, K),
                                      shard_on(ref_state, rank))
        assert port_mesh.place_replicated(mesh, stacked) is stacked


def test_mesh_groups_a_rank_belongs_to():
    """Rank 5 of a 2 × 4 mesh: row 1 (models), column 1 (data chunk); its
    model group is ranks 1 and 5, its data group 4–7; model 3 of K = 4 is
    owned by row 1."""
    mesh = port_mesh.make_mesh(8, 2, rank=5)
    assert (mesh.model_index, mesh.data_index) == (1, 1)
    assert mesh.devices[:, mesh.data_index].tolist() == [1, 5]
    assert mesh.devices[mesh.model_index].tolist() == [4, 5, 6, 7]
    assert mesh.owner(3, 4) == 1 and mesh.model_rank(0) == 1
    with pytest.raises(AssertionError, match="not divisible"):
        port_mesh.make_mesh(1, 2)
