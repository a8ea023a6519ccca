"""The paper's NN experiment (App. D.5, Fig. 8): models/mlp.py and
data/synthetic.py::make_mnist_like against the JAX package's, on the CPU
in f32, from the reference's parameters (converted with
``convert.mlp_params``): the data bit for bit, MLP1 (with weight decay)
and MLP3 loss and gradient within 1e-5, one round of FedSVRG and
FedOSAA-SVRG within 1e-4·‖Δw‖, and the training accuracy equal.
"""
import jax
import numpy as np
import pytest
import torch
from torch.func import grad

from repro.core import AlgoHParams as JaxHParams
from repro.core import init_state as jax_init_state
from repro.core import make_round_fn as jax_make_round_fn
from repro.core.problem import ClientBatch as JaxBatch
from repro.data import make_mnist_like as jax_make_mnist_like
from repro.data import partition as jax_partition
from repro.models.mlp import make_mlp_problem as jax_make_mlp
from repro.models.mlp import mlp_accuracy as jax_mlp_accuracy
from repro_torch.core import (AlgoHParams, ClientBatch, convert, init_state,
                              make_round_fn)
from repro_torch.data import make_mnist_like, partition
from repro_torch.models.mlp import make_mlp_problem, mlp_accuracy

from jax_compile import compiled
from torch_threads import one_torch_thread  # noqa: F401

N, K, ETA, L = 400, 4, 0.1, 4
#: test id → (hidden layers, weight decay)
MLPS = {"mlp1": (1, 1e-4), "mlp3": (3, 0.0)}


@pytest.fixture(scope="module")
def data():
    X, y = jax_make_mnist_like(n=N, seed=0)
    return X, y


@pytest.fixture(scope="module", params=list(MLPS))
def mlp(request, data):
    """(name, reference problem, port problem, the reference's init params
    as a dict of numpy arrays and as the port's flat vector)."""
    depth, wd = MLPS[request.param]
    X, y = data
    jc = jax_partition(X, y.astype(np.float32), K, "iid")
    jp = jax_make_mlp(jc, hidden_layers=depth, weight_decay=wd)
    pp = make_mlp_problem(partition(X, y.astype(np.float32), K, "iid", device="cpu"),
                          hidden_layers=depth, weight_decay=wd, device="cpu")
    key = jax.random.PRNGKey(3)
    params = jax.tree.map(np.asarray, compiled(jp.init, key)(key))
    return request.param, jp, pp, params, convert.mlp_params(params, depth, "cpu")


def test_mnist_like_is_the_reference_bit_for_bit(data):
    X, y = make_mnist_like(n=N, seed=0)
    assert X.dtype == np.float32 and y.dtype == np.int32
    np.testing.assert_array_equal(X, data[0])
    np.testing.assert_array_equal(y, data[1])


def test_loss_and_gradient_match_reference(mlp):
    name, jp, pp, params, w = mlp
    c = jp.clients
    batch = JaxBatch(c.x[0], c.y[0], c.mask[0])
    ref_loss, ref_grad = compiled(jax.value_and_grad(jp.loss), params, batch)(params, batch)
    pc = pp.clients
    pbatch = ClientBatch(pc.x[0], pc.y[0], pc.mask[0])
    assert w.shape == (sum(a.size for a in params.values()),)
    np.testing.assert_allclose(float(pp.loss(w, pbatch)), float(ref_loss), rtol=1e-5)
    g = grad(pp.loss)(w, pbatch)
    want = convert.mlp_params(jax.tree.map(np.asarray, ref_grad), MLPS[name][0], "cpu")
    assert float((g - want).abs().max()) <= 1e-5 * float(want.abs().max()), name


@pytest.mark.parametrize("algo", ["fedsvrg", "fedosaa_svrg"])
def test_one_round_matches_reference(mlp, algo):
    name, jp, pp, params, w = mlp
    jhp = JaxHParams(eta=ETA, local_epochs=L, aa_impl="tree", local_impl="tree")
    state = jax_init_state(jp, jax.random.PRNGKey(0), jhp, None, algo)._replace(params=params)
    ref_new, ref_m = compiled(jax_make_round_fn(algo, jp, jhp), state)(state)
    want = convert.mlp_params(jax.tree.map(np.asarray, ref_new.params), MLPS[name][0], "cpu")
    start = init_state(pp, device="cpu", algo=algo)._replace(params=w)
    new, m = make_round_fn(algo, pp, AlgoHParams(eta=ETA, local_epochs=L), device="cpu")(start)
    step = float(torch.linalg.vector_norm(want - w))
    assert float((new.params - want).abs().max()) <= 1e-4 * step, (name, algo)
    np.testing.assert_allclose(float(m.loss), float(ref_m.loss), rtol=1e-5)


def test_accuracy_matches_reference(mlp, data):
    name, jp, pp, params, w = mlp
    X, y = data
    assert mlp_accuracy(pp, w, X, y) == jax_mlp_accuracy(jp, params, X, y)


def test_init_is_he_and_seeded():
    X, y = make_mnist_like(n=64, seed=1)
    pp = make_mlp_problem(partition(X, y.astype(np.float32), 2, "iid", device="cpu"),
                          hidden_layers=3, device="cpu")
    a = pp.init(torch.Generator().manual_seed(0))
    b = pp.init(torch.Generator().manual_seed(0))
    assert torch.equal(a, b) and a.shape == (784 * 256 + 256 + 2 * (256 * 256 + 256)
                                             + 256 * 10 + 10,)
    w0 = a[:784 * 256]
    assert abs(float(w0.std()) / (2.0 / 784) ** 0.5 - 1.0) < 0.05
    assert float(a[784 * 256:784 * 256 + 256].abs().max()) == 0.0
