"""Static OBB obstacles in the port against the JAX package:
``scene/town.py::grid_building_obstacles``, ``build_scene(obstacles=)``,
``sim/collisions.py::obstacle_collision`` (a layout collision, penalty
0.65) and the pseudo-cameras' buildings.

- ``tests/test_obstacles.py``'s three cases on the port (the 3x3 grid
  town's 4 blocks filled with buildings; a hard right turn at throttle
  0.8 plows into a block corner; the expert on its route hits none), the
  driven outcome of the hard right turn also against JAX's run.
- The scene's tables equal JAX's array for array.
- The separating-axis test on 4,096 random poses around the blocks,
  batched, against JAX's vmapped one: the booleans equal on every pose
  whose separation margin (float64) is over 1e-3 m. A pose exactly on a
  separating plane may flip on an ulp of the two libraries' sin and cos,
  so those few are left out and counted.
- ``render_camera`` with the buildings in view against JAX's op-by-op
  render: within 1 level, and measured 0 values differ.

The JAX package is imported inside the tests only (read-only reference).
"""
import dataclasses

import numpy as np
import pytest
import torch
from test_torch_expert import one_torch_thread  # noqa: F401 (autouse)

from gail_carla_tpu_torch.agents.autopilot import autopilot_act
from gail_carla_tpu_torch.agents.controllers import make_autopilot
from gail_carla_tpu_torch.config import EnvConfig
from gail_carla_tpu_torch.ops import camera
from gail_carla_tpu_torch.scene.routes import generate_routes
from gail_carla_tpu_torch.scene.scene import STATIC_FIELDS, build_scene
from gail_carla_tpu_torch.scene.town import (
    grid_building_obstacles, make_grid_town,
)
from gail_carla_tpu_torch.sim import env as port_env
from gail_carla_tpu_torch.sim.collisions import obstacle_collision
from gail_carla_tpu_torch.sim.dynamics import DEFAULT_VEHICLE, VehicleState

CFG = EnvConfig(train=False, obs_mode="state")
TOWN = dict(nx=3, ny=3, block=80.0)
MARGIN = 1e-3
N_POSES = 4096


@pytest.fixture(scope="module")
def scenes():
    from gail_carla_tpu.scene.routes import generate_routes as jax_routes
    from gail_carla_tpu.scene.scene import build_scene as jax_build
    from gail_carla_tpu.scene.town import (
        grid_building_obstacles as jax_obstacles,
    )
    from gail_carla_tpu.scene.town import make_grid_town as jax_town

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        graph = make_grid_town(**TOWN)
        routes = generate_routes(graph, n_routes=2, min_length=150.0, seed=3)
        obstacles = grid_building_obstacles(**TOWN)
        port = build_scene(graph, routes, obstacles=obstacles)
    finally:
        torch.set_num_threads(n)
    jgraph = jax_town(**TOWN)
    jax_obs = jax_obstacles(**TOWN)
    assert jax_obs == obstacles
    jax = jax_build(jgraph, jax_routes(jgraph, n_routes=2, min_length=150.0,
                                       seed=3), obstacles=jax_obs)
    return port, jax


def _drive(scene, policy, n_steps):
    """One env on route 0 stepped by ``policy(world) -> action`` (1, 2):
    (any layout collision, the first episode's score_penalty)."""
    gen = torch.Generator().manual_seed(0)
    st, _, _ = port_env.reset_batch(scene, CFG, torch.tensor([0]), gen)
    static = done = False
    penalty = 0.0
    for _ in range(n_steps):
        st, out = port_env.step_batch(scene, CFG, st, policy(st), gen)
        static |= bool(out.info["n_collisions_layout"][0] > 0)
        if bool(out.done[0]) and not done:
            done, penalty = True, float(out.info["score_penalty"][0])
    return static, penalty


def _hard_right(st):
    return torch.tensor([[0.55, 0.8]])


def test_scene_carries_obstacles(scenes):
    scene, _ = scenes
    assert scene.ob_n == 4          # (3-1) x (3-1) blocks
    assert scene.ob_extent.shape == (4, 2)
    # buildings inset from the roads
    assert float(scene.ob_extent.max()) < 40.0


def test_driving_into_block_corner_is_layout_collision(scenes):
    """Hard right off the road plows into the first block's building; the
    JAX package's run (``tests/test_obstacles.py::_run``) latches the
    same."""
    from test_obstacles import _run as jax_run

    scene, jax_scene = scenes
    static, penalty = _drive(scene, _hard_right, 240)
    assert static
    # leaderboard penalty 0.65 applied (score_penalty is x100 in info)
    assert penalty <= 65.0 + 1e-3
    want = jax_run(jax_scene, steer=0.55)
    assert static == bool(want["static"])
    assert abs(penalty - float(want["penalty"])) <= 1e-3


def test_straight_on_road_is_clean(scenes):
    """Obstacles must not fire while the expert keeps to the lane."""
    scene, _ = scenes
    ap = [make_autopilot((1,), "cpu")]

    def expert(st):
        ap[0], act = autopilot_act(scene, ap[0], st)
        return act

    static, _ = _drive(scene, expert, 400)
    assert not static


def test_build_scene_obstacles_matches_jax(scenes):
    scene, jax_scene = scenes
    n = 0
    for name, v in scene.tensors():
        want = getattr(jax_scene, name)
        assert want is not None, name
        np.testing.assert_array_equal(v.numpy(), np.asarray(want),
                                      err_msg=name)
        n += 1
    for name in STATIC_FIELDS:
        assert getattr(scene, name) == getattr(jax_scene, name), name
    assert n >= 40
    # empty slots of a scene without obstacles live far away
    empty = dataclasses.replace(scene, ob_n=0)
    ego = VehicleState(xy=scene.ob_pose[:, :2], yaw=torch.zeros(4),
                       speed=torch.zeros(4))
    assert not obstacle_collision(empty, DEFAULT_VEHICLE, ego).any()


def _margins(scene, xy, yaw):
    """(N,) float64 separating-axis margin of each pose against its
    nearest-to-touching obstacle: > 0 separated, < 0 overlapping."""
    p = scene.ob_pose.numpy().astype(np.float64)
    ext = scene.ob_extent.numpy().astype(np.float64)
    he = np.array([DEFAULT_VEHICLE.half_length, DEFAULT_VEHICLE.half_width])

    def axes(a):
        c, s = np.cos(a), np.sin(a)
        return np.stack([np.stack([c, s], -1), np.stack([-s, c], -1)], -2)

    ego_ax = axes(yaw.astype(np.float64))[:, None]            # (N,1,2,2)
    ob_ax = axes(p[:, 2])[None]                                # (1,O,2,2)
    n, o = len(yaw), len(p)
    all_ax = np.concatenate([np.broadcast_to(ego_ax, (n, o, 2, 2)),
                             np.broadcast_to(ob_ax, (n, o, 2, 2))], 2)
    d = p[None, :, :2] - xy.astype(np.float64)[:, None]
    proj = np.abs(np.einsum("noac,noc->noa", all_ax, d))
    r_ego = np.abs(np.einsum("noac,nbc->noab", all_ax, ego_ax[:, 0])) @ he
    r_ob = np.einsum("noab,ob->noa", np.abs(np.einsum(
        "noac,obc->noab", all_ax, ob_ax[0])), ext)
    sep = (proj - r_ego - r_ob).max(-1)                        # (N, O)
    return sep.min(-1)


def test_obstacle_collision_matches_jax(scenes):
    import jax
    import jax.numpy as jnp
    from gail_carla_tpu.sim.collisions import obstacle_collision as jax_oc
    from gail_carla_tpu.sim.dynamics import DEFAULT_VEHICLE as JAX_VEHICLE
    from gail_carla_tpu.sim.dynamics import VehicleState as JaxVehicle

    scene, jax_scene = scenes
    rng = np.random.default_rng(0)
    # poses around the blocks: a block's building spans [40 +- half] on
    # each axis of each 80 m block, the poses [40 +- (half + 12)]
    half = float(scene.ob_extent[0, 0])
    centre = rng.choice([40.0, 120.0], (N_POSES, 2))
    side = rng.uniform(-1.0, 1.0, (N_POSES, 2)) * (half + 12.0)
    xy = (centre + side).astype(np.float32)
    yaw = rng.uniform(-np.pi, np.pi, N_POSES).astype(np.float32)
    margin = _margins(scene, xy, yaw)
    away = np.abs(margin) > MARGIN

    ego = VehicleState(xy=torch.from_numpy(xy), yaw=torch.from_numpy(yaw),
                       speed=torch.zeros(N_POSES))
    got = obstacle_collision(scene, DEFAULT_VEHICLE, ego).numpy()
    want = np.asarray(jax.vmap(lambda p, a: jax_oc(
        jax_scene, JAX_VEHICLE, JaxVehicle(xy=p, yaw=a, speed=0.0)))(
        jnp.asarray(xy), jnp.asarray(yaw)))
    assert got.shape == (N_POSES,) and got.dtype == np.bool_
    np.testing.assert_array_equal(got[away], want[away])
    np.testing.assert_array_equal(got[away], margin[away] < 0.0)
    near = int((~away).sum())
    print(f"obstacle SAT: {int(away.sum())} poses compared, {near} within "
          f"{MARGIN} m of contact left out, "
          f"{int((got != want).sum())} differ in all")
    assert near < N_POSES // 100
    assert N_POSES // 5 < int(got.sum()) < N_POSES * 4 // 5


def test_render_camera_with_obstacles_matches_jax(scenes):
    """Frames from the routes with the block buildings in view (every
    camera), against JAX's op-by-op render: within 1 level, measured 0
    values differ; the buildings are drawn (the frames differ from the
    same scene's without obstacles)."""
    from test_torch_camera import _jax_camera

    scene, jax_scene = scenes
    xy_all = scene.route_xy.numpy()
    yaw_all = scene.route_yaw.numpy()
    bare = dataclasses.replace(scene, ob_n=0)
    n_vals = n_diff = n_building = 0
    for i, off in enumerate(camera.CAMERAS.values()):
        r, h = i % 2, 10 + 25 * i
        kw = dict(xy=xy_all[r, h][None], yaw=yaw_all[r, h][None])
        if i == 2:
            kw.update(sun_altitude=np.float32([20.0]),
                      sun_azimuth=np.float32([250.0]))
        want = _jax_camera(jax_scene, kw, off, jit=False)
        got = camera.render_camera(
            scene, cam_yaw_offset=off,
            **{k: torch.from_numpy(np.asarray(v)) for k, v in kw.items()}
        )[0].numpy()
        diff = np.abs(got.astype(int) - want)
        assert diff.max() <= 1, diff.max()
        n_vals += diff.size
        n_diff += int((diff > 0).sum())
        without = camera.render_camera(
            bare, cam_yaw_offset=off,
            **{k: torch.from_numpy(np.asarray(v)) for k, v in kw.items()}
        )[0].numpy()
        n_building += int((got != without).any(-1).sum())
    # measured: 0 values differ
    assert n_diff == 0, (n_diff, n_vals)
    assert n_building > 0
