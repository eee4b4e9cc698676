"""The port's host tools against the JAX package's: ``tools/export_map``
(the H5 map pack of a grid town) and ``tools/plot_results`` (training
curves from ``metrics.jsonl``). Both packages write their files from the
same arguments; the packs must hold byte-equal datasets and equal
attributes, and the plots' decoded pixels must be equal (read with the
port's PNG codec). The JAX package is imported inside the tests only
(read-only reference).
"""
import numpy as np
import pytest
import torch

from gail_carla_tpu_torch.tools import export_map as port_export
from gail_carla_tpu_torch.tools import plot_results as port_plot
from gail_carla_tpu_torch.utils.logging import MetricsWriter
from gail_carla_tpu_torch.utils.png import read_png


@pytest.mark.parametrize("args", [dict(nx=3, ny=3, block=80.0),
                                  dict(nx=4, ny=4, block=100.0, ppm=4.0)])
def test_export_map_matches_jax(tmp_path, args):
    """tests/test_utils.py::test_export_map_h5_roundtrip on both packages:
    equal datasets and attributes, ``check_h5_map`` on each pack (and a
    wrong pixel density refused)."""
    import h5py
    from gail_carla_tpu.tools import export_map as jax_export

    want = jax_export.export_map(str(tmp_path / "jax.h5"), **args)
    got = port_export.export_map(str(tmp_path / "port.h5"), **args)
    ppm = args.get("ppm", 5.0)
    with h5py.File(want) as hw, h5py.File(got) as hg:
        assert sorted(hg.keys()) == sorted(hw.keys()) == sorted(
            port_export.LAYERS)
        for key in hw:
            a, b = hg[key][:], hw[key][:]
            assert a.dtype == b.dtype == np.uint8, key
            np.testing.assert_array_equal(a, b, err_msg=key)
        assert sorted(hg.attrs) == sorted(hw.attrs)
        for key in hw.attrs:
            np.testing.assert_array_equal(hg.attrs[key], hw.attrs[key])
        road = hg["road"][:]
        assert road.max() == 255 and (road > 0).mean() > 0.02
        assert hg["lane_marking_white_broken"][:].max() == 255
    for path in (want, got):
        assert port_export.check_h5_map(path, ppm)
        assert jax_export.check_h5_map(path, ppm)
        assert not port_export.check_h5_map(path, ppm + 1.0)


def test_export_map_cli(tmp_path, capsys):
    """``main`` makes the output's directory and prints the pack's path."""
    out = tmp_path / "maps" / "GridTown.h5"
    port_export.main(["--out", str(out), "--nx", "2", "--ny", "2",
                      "--block", "60"])
    assert capsys.readouterr().out.strip() == str(out)
    assert port_export.check_h5_map(str(out))


def _write_log(log_dir):
    """Three updates of metrics through the port's ``MetricsWriter``: the
    training keys as tensors, the evaluation's on the first and last."""
    rng = np.random.default_rng(0)
    w = MetricsWriter(str(log_dir), use_tensorboard=False)
    for step in (1, 2, 3):
        m = {k: torch.tensor(float(rng.normal()))
             for k in ("ep_reward_mean", "disc/pre_val_wd",
                       "disc/post_val_wd", "ppo/value_loss",
                       "ppo/action_loss", "gail_reward_mean")}
        m["n_episodes"] = torch.tensor(step, dtype=torch.int64)
        if step != 2:
            m["eval/reward"] = float(rng.normal())
        w.write(step, m)
    w.close()


def test_plot_results_matches_jax(tmp_path, capsys):
    """``load_metrics`` equals JAX's on a log the port wrote; both ``main``s
    write ``training_curves.png`` with equal pixels (the wall times are
    not plotted)."""
    from gail_carla_tpu.tools import plot_results as jax_plot

    log = tmp_path / "log"
    _write_log(log)
    rows = port_plot.load_metrics(str(log))
    assert rows == jax_plot.load_metrics(str(log))
    assert [r["step"] for r in rows] == [1, 2, 3]
    assert "eval/reward" not in rows[1] and "eval/reward" in rows[2]
    assert port_plot.PANELS == jax_plot.PANELS

    port_plot.main(["--log-dir", str(log), "--out", str(tmp_path / "port")])
    jax_plot.main(["--log-dir", str(log), "--out", str(tmp_path / "jax")])
    printed = capsys.readouterr().out.split()
    assert printed == [str(tmp_path / d / "training_curves.png")
                       for d in ("port", "jax")]
    got, want = (read_png(p) for p in printed)
    assert got.shape == want.shape == (840, 1320, 3)
    np.testing.assert_array_equal(got, want)
    assert (got != 255).any()   # something was drawn
