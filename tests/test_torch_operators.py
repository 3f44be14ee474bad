"""The port's DG operators against the JAX package's, in float64 on
two-tree (acoustic + elastic) materials, on periodic and non-periodic
bricks: ``volume_rhs``, ``surface_rhs`` (including a neighbour table that
carries the -2 cross-partition sentinel) and ``dg_rhs``."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.dg import operators as jops
from repro.dg.basis import diff_matrix, lgl_nodes_weights
from repro.dg.mesh import make_brick as jmake_brick
from repro.dg.mesh import two_tree_materials as jtwo_tree
from repro_torch.dg import operators as ops

# one intra-op thread: the suite runs several pytest workers on one machine,
# and PyTorch's default of a thread per core oversubscribes it
torch.set_num_threads(1)

TOL = dict(rtol=1e-11, atol=1e-11)


def _setup(periodic, order=3, seed=0):
    m = jmake_brick((8, 4, 4), (2.0, 1.0, 1.0), periodic=periodic)
    rho, lam, mu, _ = jtwo_tree(m)
    K, M = m.K, order + 1
    rng = np.random.default_rng(seed)
    x, w = lgl_nodes_weights(order)
    arrs = dict(
        q=rng.standard_normal((K, 9, M, M, M)),
        D=diff_matrix(x),
        rho=rho, lam=lam, mu=mu,
        cp=np.sqrt((lam + 2 * mu) / rho),
        cs=np.sqrt(mu / rho),
    )
    metrics = tuple(m.metric(a) for a in range(3))
    lift = tuple(m.metric(a) / w[0] for a in range(3))
    j = {k: jnp.asarray(v) for k, v in arrs.items()}
    t = {k: torch.as_tensor(v) for k, v in arrs.items()}
    return m, j, t, metrics, lift


@pytest.mark.parametrize("periodic", [False, True])
def test_volume_rhs_matches_reference(periodic):
    _, j, t, metrics, _ = _setup(periodic)
    got = ops.volume_rhs(t["q"], t["D"], metrics, t["rho"], t["lam"], t["mu"])
    want = jops.volume_rhs(j["q"], j["D"], metrics, j["rho"], j["lam"], j["mu"])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("with_skip", [False, True])
@pytest.mark.parametrize("periodic", [False, True])
def test_surface_rhs_matches_reference(periodic, with_skip):
    m, j, t, _, lift = _setup(periodic, seed=1)
    nbr = np.array(m.neighbors)
    if with_skip:
        rng = np.random.default_rng(2)
        nbr[rng.random(nbr.shape) < 0.2] = -2  # cross-partition faces: skipped
    args = ("q", "rho", "lam", "mu", "cp", "cs")
    got = ops.surface_rhs(t["q"], torch.as_tensor(nbr), lift, *(t[k] for k in args[1:]))
    want = jops.surface_rhs(j["q"], jnp.asarray(nbr), lift, *(j[k] for k in args[1:]))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("periodic", [False, True])
def test_dg_rhs_matches_reference(periodic):
    m, j, t, metrics, lift = _setup(periodic, seed=3)
    rest = ("rho", "lam", "mu", "cp", "cs")
    got = ops.dg_rhs(t["q"], t["D"], metrics, lift, torch.as_tensor(m.neighbors),
                     *(t[k] for k in rest))
    want = jops.dg_rhs(j["q"], j["D"], metrics, lift, jnp.asarray(m.neighbors),
                       *(j[k] for k in rest))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_extract_face_is_a_strided_view_and_the_flux_kernel_refuses_it():
    """Face slices are non-contiguous views; the CUDA wrapper's contiguity
    check (run before any pointer is taken) must refuse them."""
    from repro_torch.kernels._checks import check_operands

    q = torch.zeros((2, 9, 3, 3, 3), dtype=torch.float64)
    face = ops.extract_face(q[:, :6], 1)
    assert face.shape == (2, 6, 3, 3) and not face.is_contiguous()
    assert face.data_ptr() == q[:, :, 2].data_ptr()
    with pytest.raises(ValueError, match="contiguous"):
        check_operands("dg_flux", {"Sm": face}, {"Sm": (2, 6, 3, 3)})
