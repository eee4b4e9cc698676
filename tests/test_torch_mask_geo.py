"""The port's mask geometry (``scene/mask_geo.py``) against the JAX
package's: each of the town importers' functions on the same synthetic
masks gives equal arrays (0 difference: the same numpy code), and the
JAX package's own CPU tests of them (``tests/test_h5_fidelity.py``,
``tests/test_town_import.py``) hold for the port. The JAX package is
imported inside the tests only (read-only reference)."""
import math

import numpy as np
import pytest
import torch

from gail_carla_tpu_torch.scene import mask_geo


def _random_mask(seed, shape=(96, 96)):
    """Six random discs with a hole punched in (tests/test_h5_fidelity.py's
    masks)."""
    rng = np.random.default_rng(seed)
    m = np.zeros(shape, bool)
    yy, xx = np.mgrid[: shape[0], : shape[1]]
    for _ in range(6):
        cy, cx = rng.integers(10, shape[0] - 10, 2)
        r = rng.integers(4, 18)
        m |= (yy - cy) ** 2 + (xx - cx) ** 2 <= r * r
    cy, cx = rng.integers(20, shape[0] - 20, 2)
    m &= ~((yy - cy) ** 2 + (xx - cx) ** 2 <= 36)
    return m


def _ring_mask(w=160, outer=60, inner=48):
    """A 12-pixel-wide ring (a sidewalk around a block) plus a spur."""
    yy, xx = np.mgrid[:w, :w]
    r2 = (yy - w // 2) ** 2 + (xx - w // 2) ** 2
    m = (r2 <= outer ** 2) & (r2 > inner ** 2)
    m[w // 2 - 4:w // 2 + 4, 5:w // 2 - outer + 2] = True
    return m


def _strokes_mask():
    """Thin strokes: a 1-px line, a 2-px line, a dashed line, a diagonal."""
    m = np.zeros((80, 80), bool)
    m[10, 5:70] = True
    m[20:22, 5:70] = True
    for x0 in range(5, 70, 12):
        m[40, x0:x0 + 6] = True
    idx = np.arange(50, 78)
    m[idx, idx - 45] = True
    return m


def _corridor_edges(mod):
    m = np.zeros((40, 120), bool)
    m[14:26, 4:116] = True
    return mod.mask_boundary_edges(m, np.zeros(2), 2.0, max_err_px=0.2)


def _gap_mask():
    """tests/test_town_import.py's U of road: two arms and a bottom bar."""
    w = 300
    mask = np.zeros((w, w), bool)
    mask[20:260, 20:40] = True
    mask[240:260, 20:260] = True
    mask[20:260, 240:260] = True
    return mask


def _pts(seed, n=500, lo=-5.0, hi=55.0):
    return np.random.default_rng(seed).uniform(lo, hi, (n, 2))


def _case_nearest_edge_robust(mod):
    edges, _ = mod.mask_boundary_edges(_random_mask(0), np.array([3.0, -7.0]),
                                       2.0, max_err_px=0.3)
    p = _pts(1)[:, None, :]
    a = edges[None, :, :2].astype(np.float64)
    ab = (edges[None, :, 2:] - edges[None, :, :2]).astype(np.float64)
    inv = 1.0 / (np.sum(ab * ab, -1) + 1e-12)
    return mod._nearest_edge_robust(edges, p, a, ab, inv)


def _case_points_inside(mod):
    edges, dmax = mod.mask_boundary_edges(
        _random_mask(1), np.array([3.0, -7.0]), 2.0, max_err_px=0.3)
    return mod.points_inside(edges, dmax, _pts(2), chunk=128)


def _case_boundary_project(mod):
    edges, _ = mod.mask_boundary_edges(_ring_mask(), np.array([-4.0, 2.0]),
                                       2.0, max_err_px=0.49)
    return mod.boundary_project(edges, _pts(3, lo=-10.0, hi=80.0), chunk=100)


def _case_boundary_signed_distance(mod):
    edges, _ = mod.mask_boundary_edges(_random_mask(2), np.zeros(2), 2.0,
                                       max_err_px=0.3)
    empty = mod.boundary_signed_distance(np.zeros((0, 4), np.float32),
                                         _pts(4, n=5))
    return mod.boundary_signed_distance(edges, _pts(4), chunk=64), empty


def _case_thin_mask(mod):
    return mod.thin_mask(_ring_mask()), mod.thin_mask(_random_mask(3))


def _case_skeleton_paths(mod):
    return mod.skeleton_paths(mod.thin_mask(_ring_mask())) + \
        mod.skeleton_paths(mod.thin_mask(_strokes_mask()), min_len=2)


def _case_mask_stroke_capsules(mod):
    return mod.mask_stroke_capsules(_strokes_mask(), np.array([1.0, 2.0]),
                                    5.0, 120.0)


def _case_mask_ribbon_paths(mod):
    return mod.mask_ribbon_paths(_ring_mask(), np.array([-3.0, 1.0]), 5.0,
                                 min_len_m=4.0)


def _case_plan_on_mask(mod):
    a, b = np.array([6.0, 5.0]), np.array([50.0, 5.0])
    return mod.plan_on_mask(_gap_mask(), np.zeros(2), 5.0, a, b)


def _case_resample_span(mod):
    rng = np.random.default_rng(5)
    out = np.cumsum(rng.uniform(0.0, 1.5, (40, 2)), axis=0)
    out[10:14] = out[10]          # a pile-up
    return mod._resample_span(out, 3)


def _case_refine_polyline_inside(mod):
    edges, _ = _corridor_edges(mod)
    xs = np.arange(4.0, 56.0, 1.0)
    ys = 11.6 + 0.45 * (np.arange(len(xs)) % 2)
    xy = np.stack([xs, ys], axis=1)
    return mod.refine_polyline_inside(edges, xy, clearance=0.75)


CASES = {
    "_nearest_edge_robust": _case_nearest_edge_robust,
    "points_inside": _case_points_inside,
    "boundary_project": _case_boundary_project,
    "boundary_signed_distance": _case_boundary_signed_distance,
    "thin_mask": _case_thin_mask,
    "skeleton_paths": _case_skeleton_paths,
    "mask_stroke_capsules": _case_mask_stroke_capsules,
    "mask_ribbon_paths": _case_mask_ribbon_paths,
    "plan_on_mask": _case_plan_on_mask,
    "_resample_span": _case_resample_span,
    "refine_polyline_inside": _case_refine_polyline_inside,
}


def _assert_same(got, want, where):
    if isinstance(want, (tuple, list)):
        assert isinstance(got, (tuple, list)) and len(got) == len(want), where
        for i, (g, w) in enumerate(zip(got, want)):
            _assert_same(g, w, f"{where}[{i}]")
        return
    if want is None or isinstance(want, (int, float)):
        assert got == want, where
        return
    assert got.dtype == want.dtype, where
    np.testing.assert_array_equal(got, want, err_msg=where)


@pytest.mark.parametrize("name", sorted(CASES))
def test_mask_geo_matches_jax(name):
    """Each function of the town importers on the same synthetic masks and
    points: equal arrays, dtype and all."""
    from gail_carla_tpu.scene import mask_geo as jax_mask_geo

    _assert_same(CASES[name](mask_geo), CASES[name](jax_mask_geo), name)


# --- the JAX package's CPU tests of these functions, on the port ----------

@pytest.mark.parametrize("seed", [0, 1, 2])
def test_contour_inside_test_exact(seed):
    m = _random_mask(seed)
    off = np.array([3.0, -7.0])
    edges, dmax = mask_geo.mask_boundary_edges(m, off, 2.0, max_err_px=0.3)
    ys, xs = np.mgrid[: m.shape[0], : m.shape[1]]
    pts = np.stack([xs.ravel(), ys.ravel()], 1) / 2.0 + off[None, :]
    inside = mask_geo.points_inside(edges, dmax, pts)
    assert (inside == m.ravel()).all()


def test_contour_orientation_interior_positive():
    m = np.zeros((20, 20), bool)
    m[5:15, 4:16] = True
    edges, _ = mask_geo.mask_boundary_edges(m, np.zeros(2), 1.0,
                                            max_err_px=0.2)
    assert mask_geo.boundary_signed_distance(
        edges, np.array([[10.0, 10.0]]))[0] > 0
    assert mask_geo.boundary_signed_distance(
        edges, np.array([[1.0, 1.0]]))[0] < 0


def test_stroke_capsules_cover_thin_lines():
    m = np.zeros((64, 64), bool)
    m[10, 5:60] = True
    m[20:55, 30] = True
    ab, _, _ = mask_geo.mask_stroke_capsules(m, np.zeros(2), 1.0, 255.0)
    assert len(ab) >= 2
    ys, xs = np.nonzero(m)
    pts = np.stack([xs, ys], 1).astype(float)
    a = ab[None, :, :2]
    d = (ab[:, 2:] - ab[:, :2])[None]
    t = np.clip(np.sum((pts[:, None, :] - a) * d, -1)
                / (np.sum(d * d, -1) + 1e-12), 0, 1)
    dist = np.linalg.norm(pts[:, None, :] - (a + t[..., None] * d), axis=-1)
    assert (dist.min(axis=1) <= 1.0).mean() > 0.97


def test_boundary_sign_robust_in_vertex_cones():
    """A diamond hole makes every interior diagonal a vertex tie cone: the
    host tests and the port's renderer test (``ops/bev.py::
    boundary_inside``, in torch where JAX's test runs XLA) match the raw
    mask."""
    from gail_carla_tpu_torch.ops.bev import boundary_inside

    w = 160
    m = np.zeros((w, w), bool)
    m[10:150, 10:150] = True
    yy, xx = np.mgrid[:w, :w]
    m &= ~(np.abs(yy - 80) + np.abs(xx - 80) <= 25)
    ppm = 2.0
    edges, dmax = mask_geo.mask_boundary_edges(m, np.zeros(2), ppm,
                                               max_err_px=0.2)
    pts, truth = [], []
    rng = np.random.default_rng(0)
    for _ in range(400):
        px = rng.integers(12, 148, 2)
        d_h = np.abs(px[0] - 80) + np.abs(px[1] - 80)
        if 23 <= d_h <= 27:
            continue
        pts.append([(px[1] + 0.0) / ppm, (px[0] + 0.0) / ppm])
        truth.append(bool(m[px[0], px[1]]))
    pts = np.asarray(pts, np.float64)
    truth = np.asarray(truth)
    got = mask_geo.points_inside(edges, dmax, pts)
    assert (got == truth).all(), np.flatnonzero(got != truth)[:10]
    assert ((mask_geo.boundary_signed_distance(edges, pts) > 0)
            == truth).all()
    dev = boundary_inside(torch.from_numpy(pts.astype(np.float32)),
                          torch.from_numpy(edges.astype(np.float32)), dmax)
    assert (dev.numpy() == truth).all(), np.flatnonzero(dev.numpy()
                                                        != truth)[:10]


def _max_turn(p):
    seg = np.diff(p, axis=0)
    g = np.linalg.norm(seg, axis=1) > 1e-9
    hdg = np.arctan2(seg[g][:, 1], seg[g][:, 0])
    return float(np.abs((np.diff(hdg) + np.pi) % (2 * np.pi) - np.pi).max())


def test_refine_polyline_inside_smooths_and_clears():
    edges, _ = _corridor_edges(mask_geo)
    xs = np.arange(4.0, 56.0, 1.0)
    ys = 11.6 + 0.45 * (np.arange(len(xs)) % 2)
    xy = np.stack([xs, ys], axis=1)
    xy[:3, 1] = 9.5
    xy[-3:, 1] = 9.5
    out = mask_geo.refine_polyline_inside(edges, xy, clearance=0.75)
    assert out.shape == xy.shape
    np.testing.assert_allclose(out[:3], xy[:3])
    np.testing.assert_allclose(out[-3:], xy[-3:])
    sd = mask_geo.boundary_signed_distance(edges, out[3:-3])
    assert float(sd.min()) >= 0.6, float(sd.min())
    assert _max_turn(out) < 0.5 * _max_turn(xy)


def test_refine_polyline_no_median_zigzag():
    m = np.zeros((60, 200), bool)
    m[10:50, 4:196] = True
    m[28:32, 40:160] = False
    edges, _ = mask_geo.mask_boundary_edges(m, np.zeros(2), 2.0,
                                            max_err_px=0.2)
    xs = np.arange(4.0, 96.0, 1.0)
    ys = np.full(len(xs), 12.0)
    ys[30:60] = 14.6
    xy = np.stack([xs, ys], axis=1)
    xy[:3, 1] = 12.0
    xy[-3:, 1] = 12.0
    out = mask_geo.refine_polyline_inside(edges, xy, clearance=0.75)
    assert out.shape == xy.shape
    assert float(out[:, 1].max()) < 14.5, float(out[:, 1].max())
    step = np.linalg.norm(np.diff(out, axis=0), axis=1)
    assert float(step.min()) > 0.2 and float(step.max()) < 2.5
    assert float(np.degrees(_max_turn(out))) < 30.0
    sd = mask_geo.boundary_signed_distance(edges, out[3:-3])
    assert float(sd.min()) >= 0.6, float(sd.min())


def test_plan_on_mask_routes_around_gaps():
    ppm, w = 5.0, 300
    mask = _gap_mask()
    off = np.zeros(2)
    a, b = np.array([6.0, 5.0]), np.array([50.0, 5.0])
    path = mask_geo.plan_on_mask(mask, off, ppm, a, b)
    assert path is not None
    xi = np.clip((path[:, 0] * ppm).round().astype(int), 0, w - 1)
    yi = np.clip((path[:, 1] * ppm).round().astype(int), 0, w - 1)
    assert mask[yi, xi].mean() > 0.95
    assert np.linalg.norm(path[0] - a) < 1e-6
    assert np.linalg.norm(path[-1] - b) < 1e-6
    assert np.linalg.norm(np.diff(path, axis=0), axis=1).sum() > 80.0
    mask2 = np.zeros((w, w), bool)
    mask2[20:260, 20:40] = True
    mask2[20:260, 240:260] = True
    assert mask_geo.plan_on_mask(mask2, off, ppm, a, b) is None


def test_uturn_teardrop_is_drivable():
    """Anti-parallel waypoint pairs densify into a Dubins teardrop within
    the hero vehicle's steering envelope, not a sub-metre hairpin."""
    from gail_carla_tpu_torch.scene.town import _sample_uturn
    from gail_carla_tpu_torch.scene.town_import import densify_leg

    p0 = np.array([197.6, 58.8])
    p1 = np.array([197.6, 62.1])
    pts = _sample_uturn(p0, math.pi, p1, 0.0)
    assert np.allclose(pts[0], p0) and np.allclose(pts[-1], p1, atol=0.2)
    seg = np.diff(pts, axis=0)
    good = np.linalg.norm(seg, axis=1) > 1e-6
    hdg = np.arctan2(seg[good][:, 1], seg[good][:, 0])
    turn = np.abs((np.diff(hdg) + np.pi) % (2 * np.pi) - np.pi)
    assert float(np.degrees(turn.max())) < 16.0
    assert abs((hdg[0] - math.pi + math.pi) % (2 * math.pi) - math.pi) < 0.2
    pieces = densify_leg(p0, math.pi, p1, 0.0)
    assert len(pieces) == 1
    assert len(pieces[0].pts) > 20
    from gail_carla_tpu.scene.town import _sample_uturn as jax_uturn

    np.testing.assert_array_equal(pts, jax_uturn(p0, math.pi, p1, 0.0))
