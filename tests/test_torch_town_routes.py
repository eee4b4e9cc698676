"""The port's route XML reader and writer (``scene/routes.py``) against the
JAX package's: the same routes write byte-equal files, and either reader
gives equal ``RouteDef``s from either file. The JAX package is imported
inside the tests only (read-only reference)."""
import math

import numpy as np
import pytest

from gail_carla_tpu_torch.scene import routes as port_routes
from gail_carla_tpu_torch.tools.synthetic_town import (
    grid_graph, start_goal_pairs, training_routes,
)


@pytest.fixture(scope="module")
def route_sets():
    """The synthetic tree's two kinds of route: multi-waypoint routes of a
    town and bare start/goal pairs without a town attribute, plus a route
    whose yaws hit +-pi, 0 and an id out of order."""
    graph = grid_graph()
    odd = port_routes.RouteDef(
        route_id=17, town="Town03",
        waypoints=np.array([[1.5, -2.25, math.pi], [0.1, 1e-7, -math.pi],
                            [-3.0, 4.0, 0.0]]))
    return {"training": training_routes(graph, "Town01", 3),
            "pairs": start_goal_pairs(graph, 3),
            "odd": [odd]}


def _same(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert (x.route_id, x.town) == (y.route_id, y.town)
        assert x.waypoints.dtype == y.waypoints.dtype
        np.testing.assert_array_equal(x.waypoints, y.waypoints)


@pytest.mark.parametrize("kind", ["training", "pairs", "odd"])
def test_route_xml_round_trip_matches_jax(route_sets, kind, tmp_path):
    from gail_carla_tpu.scene import routes as jax_routes

    routes = route_sets[kind]
    port_path, jax_path = tmp_path / "port.xml", tmp_path / "jax.xml"
    port_routes.write_routes_xml(routes, str(port_path))
    jax_routes.write_routes_xml(
        [jax_routes.RouteDef(r.route_id, r.town, r.waypoints)
         for r in routes], str(jax_path))
    assert port_path.read_bytes() == jax_path.read_bytes()
    got = port_routes.parse_routes_xml(str(port_path))
    _same(got, jax_routes.parse_routes_xml(str(port_path)))
    _same(got, port_routes.parse_routes_xml(str(jax_path)))
    # the written yaw is in degrees and comes back in radians
    np.testing.assert_allclose(got[0].waypoints, routes[0].waypoints,
                               rtol=0, atol=1e-12)
