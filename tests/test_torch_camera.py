"""The port's weather (``sim/weather.py``) and pseudo-cameras
(``ops/camera.py``) against the JAX package's.

Weather: ``tests/test_weather.py``'s cases on the port, and the port's
``weather_at`` / ``sun_brightness`` against JAX's at 1e-6 (relative, and
of each readout's 0-100 or 0-360 range), op by op as
``tests/test_weather.py`` runs it; against JAX's jitted run (the
exporter's) within 5 ulps of the storm walk, which XLA fuses into one
multiply-add (the wind's steps at 20 and 70 % clouds excluded).

Cameras: ``render_camera`` on the smoke scene with 40 NPC vehicles and 30
walkers (more than ``MAX_BOXES``, so the nearest-box selection runs),
light heads, low and high sun, fog and night brightness, against JAX's
run op by op (as ``tests/test_tools.py`` calls it) and jitted (as the
JAX exporter calls it). Ground, sky and lane palette pixels are equal;
shaded or fogged values within 1 level (each float-to-uint8 cast
truncates: an ulp of ``exp`` or ``cos`` flips a value). Measured: 0 of
the 1,492,992 values of the six frames differ from either JAX render,
and the test holds that count. The JAX package is imported inside the
tests only (read-only reference).
"""
import math
import random

import numpy as np
import pytest
import torch
from test_torch_expert import one_torch_thread  # noqa: F401 (autouse)

from gail_carla_tpu_torch.ops import camera
from gail_carla_tpu_torch.scene.scene import make_benchmark_scene
from gail_carla_tpu_torch.sim import signals
from gail_carla_tpu_torch.sim import weather as wx
from gail_carla_tpu_torch.train import make_presets

PRESET = make_presets()["smoke"]


def _t(a):
    return torch.from_numpy(np.array(a))


def _jax_wp(wp: wx.WeatherParams):
    from gail_carla_tpu.sim import weather as jwx

    f = lambda v: np.asarray(v, np.float32)  # noqa: E731
    return jwx.WeatherParams(
        dynamic=f(wp.dynamic), speed=f(wp.speed), sun_t0=f(wp.sun_t0),
        az0=f(wp.az0), storm_t0=f(wp.storm_t0), static=f(wp.static))


# --- weather ---------------------------------------------------------------

@pytest.mark.parametrize("name", ["dynamic", "dynamic_50.0", "HardRainSunset",
                                  "NoSuchWeather"])
def test_weather_matches_jax(name):
    """``make_weather`` draws the same preset and sun phase from the same
    seed; ``weather_at`` over 2,000 s (every storm phase and sun
    altitude), ``headlights_on`` and ``sun_brightness`` at 1e-6."""
    import jax
    import jax.numpy as jnp
    from gail_carla_tpu.sim import weather as jwx

    pw = wx.make_weather(name, random.Random(1337))
    jw = jwx.make_weather(name, random.Random(1337))
    for f in ("dynamic", "speed", "sun_t0", "az0", "storm_t0"):
        assert getattr(pw, f) == float(getattr(jw, f)), f
    assert np.array_equal(np.float32(pw.static), jw.static)

    t = np.arange(0, 20000, dtype=np.float32) * np.float32(0.1)
    got = wx.weather_at(pw, _t(t))
    # op by op (tests/test_weather.py's xp=np), and jitted (the JAX
    # exporter's): XLA fuses ``storm_t0 + 250 + 1.3 * s`` into one
    # multiply-add, so that readout moves by an ulp of the storm walk
    # (1.3 s, up to 1.3e5 at speed 50)
    ref = jwx.weather_at(jw, t, xp=np)
    jit = jax.jit(lambda tt: jwx.weather_at(
        jax.tree.map(jnp.asarray, jw), tt))(jnp.asarray(t))
    walk_ulp = float(np.spacing(np.float32(1.3 * pw.speed * t.max() + 250)))
    clouds = got.cloudiness.numpy()
    # wind steps at 20 and 70 % clouds: an ulp there flips it
    steady = ((np.abs(clouds - 20.0) > 5 * walk_ulp)
              & (np.abs(clouds - 70.0) > 5 * walk_ulp))
    for f in ("cloudiness", "precipitation", "precipitation_deposits",
              "wind_intensity", "fog_density", "wetness",
              "sun_azimuth_angle", "sun_altitude_angle"):
        scale = 360.0 if f == "sun_azimuth_angle" else 100.0
        g = getattr(got, f).numpy()
        np.testing.assert_allclose(g, np.asarray(getattr(ref, f)),
                                   rtol=1e-6, atol=1e-6 * scale, err_msg=f)
        sel = steady if f == "wind_intensity" else slice(None)
        np.testing.assert_allclose(g[sel], np.asarray(getattr(jit, f))[sel],
                                   rtol=1e-6, atol=5 * walk_ulp, err_msg=f)
    np.testing.assert_allclose(wx.sun_brightness(got).numpy(),
                               np.asarray(jwx.sun_brightness(ref)),
                               rtol=1e-6, atol=1e-6)
    want = ref
    lights = wx.headlights_on(got).numpy()
    np.testing.assert_array_equal(
        lights[np.abs(got.sun_altitude_angle.numpy()) > 1e-4],
        np.asarray(jwx.headlights_on(want))[
            np.abs(got.sun_altitude_angle.numpy()) > 1e-4])
    if name.startswith("dynamic"):
        assert lights.any() and not lights.all()


def test_weather_cases_of_test_weather():
    """``tests/test_weather.py``'s preset, headlight, fallback and parsing
    cases on the port."""
    wp = wx.make_weather("HardRainSunset")
    w0 = wx.weather_at(wp, torch.tensor(0.0))
    w1 = wx.weather_at(wp, torch.tensor(500.0))
    assert float(w0.precipitation) == 60.0 == float(w1.precipitation)
    assert float(w0.sun_altitude_angle) == 15.0
    assert not bool(wx.headlights_on(w0))
    z = torch.tensor(0.0)
    night = wx.Weather(*[z] * 7, torch.tensor(-20.0))
    assert bool(wx.headlights_on(night))
    assert float(wx.sun_brightness(night)) == 0.25
    assert float(wx.weather_at(wx.make_weather("NoSuchWeather"),
                               z).sun_altitude_angle) == 75.0
    rng = random.Random(7)
    wp = wx.make_weather("dynamic_2.0", rng)
    assert wp.dynamic == 1.0 and wp.speed == 2.0
    assert wx.make_weather("dynamic", rng).speed == 1.0
    t0s = {wx.make_weather("dynamic", rng).sun_t0 for _ in range(4)}
    assert len(t0s) == 4 and all(0.0 <= t < 2.0 * math.pi for t in t0s)


# --- cameras ---------------------------------------------------------------

@pytest.fixture(scope="module")
def scenes():
    from gail_carla_tpu.scene.scene import (
        make_benchmark_scene as make_jax_scene,
    )

    return (make_benchmark_scene(**PRESET["scene"], device="cpu"),
            make_jax_scene(**PRESET["scene"]))


def _frames(port_scene):
    """Per frame: the render kwargs (ego on route 0 or 1, actors around
    it, light phases at a sim time) and the camera offset."""
    rng = np.random.default_rng(3)
    xy_all = port_scene.route_xy.numpy()
    yaw_all = port_scene.route_yaw.numpy()
    out = []
    cases = [  # (sun altitude, sun azimuth, fog, brightness)
        (None, None, None, None), (10.0, 30.0, None, None),
        (40.0, 200.0, 25.0, None), (-15.0, 120.0, 60.0, 0.25),
        (5.0, 300.0, 10.0, 0.7), (70.0, 90.0, 0.0, 1.0)]
    for i, (alt, az, fog, bright) in enumerate(cases):
        r, h = i % 2, 8 + 11 * i
        xy, yaw = xy_all[r, h], yaw_all[r, h]
        lx = rng.uniform(-10, 60, 70)
        ly = rng.uniform(-25, 25, 70)
        poses = np.stack([xy[0] + lx * np.cos(yaw) - ly * np.sin(yaw),
                          xy[1] + lx * np.sin(yaw) + ly * np.cos(yaw),
                          rng.uniform(-np.pi, np.pi, 70)], 1)
        kw = dict(xy=xy[None], yaw=np.float32(yaw)[None],
                  veh_pose=poses[None, :40], walker_pose=poses[None, 40:],
                  tl_states=signals.light_states(
                      port_scene, torch.tensor([2.5 * i])).numpy())
        for k, v in (("sun_altitude", alt), ("sun_azimuth", az),
                     ("fog_density", fog), ("brightness", bright)):
            if v is not None:
                kw[k] = np.float32([v])
        kw = {k: np.asarray(v, np.int32 if k == "tl_states" else np.float32)
              for k, v in kw.items()}
        out.append((kw, list(camera.CAMERAS.values())[i % 3]))
    return out


def _jax_camera(jax_scene, kw, off, jit):
    import jax
    import jax.numpy as jnp
    from gail_carla_tpu.ops.camera import render_camera as jax_camera

    one = {k: jnp.asarray(v[0]) for k, v in kw.items()}
    xy, yaw = one.pop("xy"), one.pop("yaw")
    fn = lambda a, b, o: jax_camera(jax_scene, a, b, off, **o)  # noqa
    return np.asarray((jax.jit(fn) if jit else fn)(xy, yaw, one))


def _palette_mask(img):
    """Pixels whose value is one of the flat palette colours (ground,
    road, lane markings, the two ends of the sky gradient)."""
    flat = [camera.GROUND, camera.ROAD, camera.LANE_SOLID,
            camera.LANE_BROKEN]
    return np.any([(img == np.asarray(c)).all(-1) for c in flat], 0)


def test_render_camera_matches_jax(scenes):
    port_scene, jax_scene = scenes
    n_vals = n_diff = n_jit_diff = n_palette = 0
    for kw, off in _frames(port_scene):
        want = _jax_camera(jax_scene, kw, off, jit=False)
        got = camera.render_camera(
            port_scene, cam_yaw_offset=off,
            **{k: _t(v) for k, v in kw.items()})[0].numpy()
        assert got.shape == (camera.CAM_H, camera.CAM_W, 3)
        diff = np.abs(got.astype(int) - want)
        # flat pixels: no fog or brightness scaled them
        flat = "fog_density" not in kw and "brightness" not in kw
        if flat:
            pal = _palette_mask(want)
            n_palette += int(pal.sum())
            np.testing.assert_array_equal(got[pal], want[pal])
            sky = np.zeros(want.shape[:2], bool)
            sky[:camera.CAM_H // 2] = True
            sky &= ~(want[..., 0] == 0)   # not behind a box
            np.testing.assert_array_equal(got[sky & ~pal], want[sky & ~pal])
        assert diff.max() <= 1, diff.max()
        n_vals += diff.size
        n_diff += int((diff > 0).sum())
        jit = _jax_camera(jax_scene, kw, off, jit=True)
        n_jit_diff += int((np.abs(got.astype(int) - jit) > 0).sum())
    # measured: 0 of 1,492,992 values differ from either JAX render
    assert n_diff == n_jit_diff == 0, (n_diff, n_jit_diff, n_vals)
    assert n_palette > 0


def test_camera_draws_actors_lights_and_weather(scenes):
    """``tests/test_tools.py``'s camera checks on the port: the sky
    gradient and the road ahead, vehicle and walker hues, light heads,
    sun-side shading brighter than the shadow side, fog converging to
    the horizon tint and night darkening the frame."""
    port_scene, _ = scenes
    xy = port_scene.route_xy[0, 5][None]
    yaw = port_scene.route_yaw[0, 5][None]
    img = camera.render_camera(port_scene, xy, yaw)[0].numpy()
    assert np.abs(img[0, 0].astype(int) - camera.SKY_ZENITH).max() <= 2
    assert np.abs(img[106, 0].astype(int) - camera.SKY).max() <= 3
    assert (img[140:] == np.asarray(camera.ROAD)).all(-1).any()

    fwd = torch.stack([torch.cos(yaw), torch.sin(yaw)], 1)
    veh = torch.cat([xy + 12.0 * fwd, yaw[:, None]], 1)[:, None]

    def blue(alt, az):
        im = camera.render_camera(
            port_scene, xy, yaw, veh_pose=veh, sun_altitude=torch.tensor(
                [alt]), sun_azimuth=torch.tensor([az]))[0].numpy()
        m = (im[..., 0] == 0) & (im[..., 1] == 0) & (im[..., 2] > 50)
        assert m.any()
        return im[..., 2][m].max()

    deg = math.degrees(float(yaw))
    assert blue(10.0, deg + 180.0) > blue(10.0, deg) + 40
    foggy = camera.render_camera(port_scene, xy, yaw,
                                 fog_density=torch.tensor([60.0]))[0].numpy()
    row = 112
    d_clear = np.abs(img[row].astype(int) - camera.SKY).mean()
    d_foggy = np.abs(foggy[row].astype(int) - camera.SKY).mean()
    assert d_foggy < d_clear - 10
    night = camera.render_camera(port_scene, xy, yaw,
                                 brightness=torch.tensor([0.25]))[0].numpy()
    assert night.mean() < 0.35 * img.mean()
    assert (night <= np.ceil(img * 0.2505)).all()
