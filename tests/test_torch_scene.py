"""The port's host scene compiler against the JAX package's: the same
``make_benchmark_scene`` arguments give equal arrays, field for field.

The JAX package is imported inside the tests only (read-only reference).
"""
import dataclasses

import numpy as np
import pytest
import torch

from gail_carla_tpu_torch.scene.scene import TorchScene, make_benchmark_scene
from gail_carla_tpu_torch.train import make_presets

SHAPES = {
    name: make_presets()[name]["scene"] for name in ("smoke", "reference")
}


@pytest.mark.parametrize("preset", sorted(SHAPES))
def test_scene_matches_jax(preset):
    from gail_carla_tpu.scene.scene import (
        make_benchmark_scene as make_jax_scene,
    )

    kw = SHAPES[preset]
    ref = make_jax_scene(**kw)
    port = make_benchmark_scene(**kw, device="cpu")
    names = {f.name for f in dataclasses.fields(TorchScene)}
    assert names == {f.name for f in dataclasses.fields(ref)}
    for name in sorted(names):
        a, b = getattr(ref, name), getattr(port, name)
        if a is None:
            assert b is None, name
        elif isinstance(b, torch.Tensor):
            a = np.asarray(a)
            assert b.numpy().dtype == a.dtype, name
            np.testing.assert_array_equal(b.numpy(), a, err_msg=name)
        else:
            assert a == b, name


def test_scene_to_moves_every_table():
    scene = make_benchmark_scene(**SHAPES["smoke"], device="cpu")
    moved = scene.to("meta")
    for name, t in moved.tensors():
        assert t.device.type == "meta", name
        assert t.shape == getattr(scene, name).shape, name
    assert moved.bnd_dmax == scene.bnd_dmax
