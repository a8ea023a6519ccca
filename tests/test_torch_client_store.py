"""The port's cohort-resident client store (repro_torch/core/client_store.py)
against the JAX package's (repro/core/client_store.py), on the same numpy
arrays: gather/scatter of a nested [K, ...] tree, the rows outside the
cohort bit-frozen, None fields passed through by identity, the client
count. The cases are the reference's TestClientStateStore
(tests/test_cohort.py)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import client_store as jax_store
from repro_torch.core import ClientStateStore
from repro_torch.core.client_store import gather_rows, scatter_rows


@pytest.fixture(autouse=True)
def x64():
    """f64 arrays stay f64 in the reference."""
    was = jax.config.read("jax_enable_x64")
    jax.config.update("jax_enable_x64", True)
    try:
        yield
    finally:
        jax.config.update("jax_enable_x64", was)


def tree_np(K=6, seed=0):
    """A comm-like nested tree of [K, ...] arrays, f64 and f32."""
    rng = np.random.default_rng(seed)
    return {"a": rng.standard_normal((K, 5)),
            "b": {"c": rng.standard_normal((K, 2, 3)).astype(np.float32)}}


def to_torch(tree):
    if isinstance(tree, dict):
        return {k: to_torch(v) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree))


def to_jax(tree):
    if isinstance(tree, dict):
        return {k: to_jax(v) for k, v in tree.items()}
    return jnp.asarray(tree)


def leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in leaves(tree[k])]
    return [np.asarray(tree)]


def assert_bitwise(port, ref):
    lp, lr = leaves(port), leaves(ref)
    assert len(lp) == len(lr)
    for a, b in zip(lp, lr):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("idx", [[4, 1, 3], [0], [5, 0, 1, 2, 3, 4]])
def test_gather_matches_reference_and_roundtrips(idx):
    """The cohort's rows equal the reference's bit for bit (contiguous, in
    the order of ``idx``), and scattering them back gives the store."""
    tree = tree_np()
    it = torch.tensor(idx)
    rows = gather_rows(to_torch(tree), it)
    assert_bitwise(rows, jax_store.gather_rows(to_jax(tree), jnp.asarray(idx)))
    assert all(r.is_contiguous() and r.shape[0] == len(idx)
               for r in (rows["a"], rows["b"]["c"]))
    assert_bitwise(scatter_rows(to_torch(tree), it, rows), tree)


def test_scatter_matches_reference_and_freezes_other_rows():
    tree = tree_np()
    idx = [0, 5]
    new_rows = {"a": np.full((2, 5), 100.0),
                "b": {"c": np.full((2, 2, 3), -7.0, np.float32)}}
    port = scatter_rows(to_torch(tree), torch.tensor(idx), to_torch(new_rows))
    ref = jax_store.scatter_rows(to_jax(tree), jnp.asarray(idx),
                                 to_jax(new_rows))
    assert_bitwise(port, ref)
    for orig, new in zip(leaves(tree), leaves(port)):
        np.testing.assert_array_equal(new[1:5], orig[1:5])
    np.testing.assert_array_equal(port["a"][idx].numpy(), new_rows["a"])
    # out of place: the store itself is unchanged
    assert_bitwise(to_torch(tree), tree)


def test_store_gather_scatter_match_reference():
    """ClientStateStore with c_k [K, d], carried columns [K, H, d] and a
    comm dict, through gather then scatter of moved rows, against the
    reference's store on the same arrays."""
    K, H, d = 7, 2, 4
    rng = np.random.default_rng(1)
    fields = dict(c_k=rng.standard_normal((K, d)),
                  hist_s=rng.standard_normal((K, H, d)),
                  hist_y=rng.standard_normal((K, H, d)),
                  comm={"grad": {"ef": rng.standard_normal((K, d)),
                                 "ref": rng.standard_normal((K, d))},
                        "delta": {"ef": rng.standard_normal((K, d))}})
    idx = [6, 2, 3]
    ours = ClientStateStore(**{k: to_torch(v) for k, v in fields.items()})
    ref = jax_store.ClientStateStore(**{k: to_jax(v) for k, v in
                                        fields.items()})
    assert ours.num_clients == ref.num_clients == K
    cohort = ours.gather(torch.tensor(idx))
    ref_cohort = ref.gather(jnp.asarray(idx))
    for f in ClientStateStore._fields:
        assert_bitwise(getattr(cohort, f), getattr(ref_cohort, f))
    moved = ClientStateStore(c_k=cohort.c_k * 2.0, hist_s=cohort.hist_s + 1.0,
                             hist_y=None,
                             comm={t: {n: b - 3.0 for n, b in sub.items()}
                                   for t, sub in cohort.comm.items()})
    ref_moved = jax_store.ClientStateStore(
        c_k=ref_cohort.c_k * 2.0, hist_s=ref_cohort.hist_s + 1.0, hist_y=None,
        comm={t: {n: b - 3.0 for n, b in sub.items()}
              for t, sub in ref_cohort.comm.items()})
    new = ours.scatter(torch.tensor(idx), moved)
    ref_new = ref.scatter(jnp.asarray(idx), ref_moved)
    for f in ClientStateStore._fields:
        assert_bitwise(getattr(new, f), getattr(ref_new, f))
    assert new.hist_y is ours.hist_y


def test_none_fields_pass_through_by_identity():
    store = ClientStateStore(c_k=to_torch(tree_np()), comm=None)
    idx = torch.tensor([2, 0])
    cohort = store.gather(idx)
    assert cohort.comm is None and cohort.hist_s is None
    # a field None in the UPDATE is returned as the same object: no op for
    # state the round never advanced
    out = store.scatter(idx, ClientStateStore(c_k=None, comm=None))
    assert out.c_k is store.c_k and out.comm is None


def test_num_clients():
    store = ClientStateStore(c_k=to_torch(tree_np(K=7)))
    assert store.num_clients == 7
    comm_only = ClientStateStore(comm={"g": {"ef": torch.zeros(3, 2)}})
    assert comm_only.num_clients == 3
    with pytest.raises(ValueError):
        _ = ClientStateStore().num_clients
    with pytest.raises(ValueError):
        _ = jax_store.ClientStateStore().num_clients
