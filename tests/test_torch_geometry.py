"""The port's numpy planners and geometry against the JAX package: LGL
basis, Morton order, face neighbours, bricks, materials, splice and the
nested partition are array-equal."""

import dataclasses

import numpy as np
import pytest

from repro.configs.dg_wave import CONFIG as JCONFIG
from repro.core import morton as jmorton
from repro.core import partition as jpart
from repro.dg import basis as jbasis
from repro.dg import mesh as jmesh
from repro_torch.configs.dg_wave import CONFIG
from repro_torch.core import morton, partition
from repro_torch.dg import basis, mesh


@pytest.mark.parametrize("order", [1, 2, 3, 5, 7])
def test_lgl_nodes_weights_and_diff_matrix(order):
    x, w = basis.lgl_nodes_weights(order)
    jx, jw = jbasis.lgl_nodes_weights(order)
    np.testing.assert_array_equal(x, jx)
    np.testing.assert_array_equal(w, jw)
    np.testing.assert_array_equal(basis.diff_matrix(x), jbasis.diff_matrix(jx))


@pytest.mark.parametrize("grid", [(8, 4, 4), (5, 3, 2), (32, 16, 16)])
def test_morton_order_curve_rank_face_neighbors(grid):
    np.testing.assert_array_equal(morton.morton_order(grid), jmorton.morton_order(grid))
    order = morton.morton_order(grid)
    np.testing.assert_array_equal(morton.curve_rank(order), jmorton.curve_rank(order))
    np.testing.assert_array_equal(partition.face_neighbors(grid), jpart.face_neighbors(grid))


@pytest.mark.parametrize("periodic", [False, True])
@pytest.mark.parametrize("grid,extent", [((8, 4, 4), (2.0, 1.0, 1.0)), ((4, 4, 2), (1.0, 1.0, 0.5))])
def test_make_brick_and_two_tree_materials(grid, extent, periodic):
    m = mesh.make_brick(grid, extent, periodic=periodic)
    jm = jmesh.make_brick(grid, extent, periodic=periodic)
    assert m.grid == jm.grid and m.extent == jm.extent and m.h == jm.h and m.K == jm.K
    assert m.jacobian == jm.jacobian
    assert [m.metric(a) for a in range(3)] == [jm.metric(a) for a in range(3)]
    np.testing.assert_array_equal(m.neighbors, jm.neighbors)
    np.testing.assert_array_equal(m.centers, jm.centers)
    for a, b in zip(mesh.two_tree_materials(m), jmesh.two_tree_materials(jm)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("n,weights", [(100, [1, 1, 1]), (8192, [0.1, 0.5, 0.4]), (7, [3, 0, 1, 2])])
def test_splice(n, weights):
    np.testing.assert_array_equal(partition.splice(n, weights), jpart.splice(n, weights))
    np.testing.assert_array_equal(partition.splice(n, n_parts=len(weights)),
                                  jpart.splice(n, n_parts=len(weights)))


@pytest.mark.parametrize("periodic", [False, True])
@pytest.mark.parametrize("P", [2, 4])
def test_build_nested_partition(periodic, P):
    grid = (8, 4, 4)
    nbr = mesh.make_brick(grid, (2.0, 1.0, 1.0), periodic=periodic).neighbors
    rng = np.random.default_rng(P)
    weights = rng.uniform(0.5, 2.0, P)
    kw = dict(accel_fraction=0.3, node_weights=weights, neighbors=nbr)
    a = partition.build_nested_partition(grid, P, **kw)
    b = jpart.build_nested_partition(grid, P, **kw)
    a.validate()
    for field in ("order", "offsets", "node_of", "boundary_mask", "accel_mask", "neighbors"):
        np.testing.assert_array_equal(getattr(a, field), getattr(b, field))
    for na, nb in zip(a.nodes, b.nodes):
        for field in ("elements", "boundary", "host_interior", "accel", "halo"):
            np.testing.assert_array_equal(getattr(na, field), getattr(nb, field))


def test_dg_paper_config_is_the_reference_one():
    assert dataclasses.asdict(CONFIG) == dataclasses.asdict(JCONFIG)
    assert int(np.prod(CONFIG.grid)) == 8192 and CONFIG.order == 7
