"""Guards of the port's packaging: it reaches neither JAX nor the JAX
package, its CUDA sources are text, its files are small, and its entry
points refuse to run on a card that is not there."""
import ast
import os
import subprocess
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "gail_carla_tpu_torch")
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "gail_carla_tpu",
             "PIL", "threading", "multiprocessing", "concurrent")
# the port reads and writes PNG files with its own codec (utils/png.py):
# the card's machine has no imaging package; h5py and matplotlib (the
# host tools export_map and plot_results) are imported inside functions
BLOCKED = ("jax", "jaxlib", "flax", "optax", "orbax", "gail_carla_tpu",
           "PIL", "h5py", "matplotlib")
TEXT_SOURCES = (".cu", ".cuh", ".h", ".hpp", ".cpp", ".cc")
MAX_FILE_BYTES = 200 * 1024
ENV_API_MODULES = (
    "gail_carla_tpu_torch.envs", "gail_carla_tpu_torch.envs.spaces",
    "gail_carla_tpu_torch.envs.suites", "gail_carla_tpu_torch.envs.gym_env",
    "gail_carla_tpu_torch.envs.vec_env", "gail_carla_tpu_torch.envs.registry",
    "gail_carla_tpu_torch.sim.observations",
    "gail_carla_tpu_torch.utils.monitor",
    "gail_carla_tpu_torch.tools.benchmark_policy",
    "gail_carla_tpu_torch.tools.nocrash_bench",
    "gail_carla_tpu_torch.tools.corl_bench",
)
# the state-vector observation path (obs_mode="state")
STATE_MODULES = ("gail_carla_tpu_torch.ops.state_obs",)
# training on more than one GPU, the GPS expert and the host tools (their
# h5py and matplotlib are imported inside their functions)
PARALLEL_AND_TOOL_MODULES = (
    "gail_carla_tpu_torch.parallel", "gail_carla_tpu_torch.parallel.mesh",
    "gail_carla_tpu_torch.parallel.collectives",
    "gail_carla_tpu_torch.agents.gps_autopilot",
    "gail_carla_tpu_torch.tools.export_map",
    "gail_carla_tpu_torch.tools.plot_results",
)
# the town importers and their tools (h5py is imported inside the one pack
# reader, scene/h5_maps.py::read_pack, and the synthetic tree's writer)
TOWN_MODULES = (
    "gail_carla_tpu_torch.scene.h5_maps",
    "gail_carla_tpu_torch.scene.town_import",
    "gail_carla_tpu_torch.tools.synthetic_town",
    "gail_carla_tpu_torch.tools.town_fidelity",
)


def _port_files():
    """Every file the port adds to the tree (build outputs and caches
    excluded)."""
    out = [os.path.join(ROOT, "chip_smoke.py")]
    for d, dirs, files in os.walk(PKG):
        dirs[:] = [x for x in dirs if x not in ("_build", "__pycache__")]
        out += [os.path.join(d, f) for f in files]
    tests = os.path.join(ROOT, "tests")
    out += [os.path.join(tests, f) for f in os.listdir(tests)
            if f.startswith("test_torch_")]
    return sorted(out)


def _port_modules():
    mods = []
    for path in _port_files():
        rel = os.path.relpath(path, ROOT)
        if rel.startswith("gail_carla_tpu_torch") and rel.endswith(".py"):
            mod = rel[:-3].replace(os.sep, ".")
            mods.append(mod[:-len(".__init__")]
                        if mod.endswith(".__init__") else mod)
    return mods


def _imported_roots(path):
    tree = ast.parse(open(path).read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield node.lineno, a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.lineno, node.module.split(".")[0]


def test_port_sources_import_no_jax():
    bad = []
    for path in _port_files():
        if not path.endswith(".py") or "/tests/" in path:
            continue
        for line, root in _imported_roots(path):
            if root in FORBIDDEN:
                bad.append(f"{os.path.relpath(path, ROOT)}:{line} {root}")
    assert _port_modules(), "no port modules found"
    assert not bad, bad


def test_port_imports_with_jax_blocked():
    """Import every port module and chip_smoke (without running it) in a
    fresh interpreter where JAX and the JAX package cannot be imported;
    the env API, the policy benchmarks, the state observation, the
    data-parallel learner, the GPS expert, the host tools and the town
    importers are among them."""
    assert set(ENV_API_MODULES + STATE_MODULES + PARALLEL_AND_TOOL_MODULES
               + TOWN_MODULES) <= set(_port_modules())
    code = "\n".join([
        "import importlib, sys",
        f"for name in {BLOCKED!r}:",
        "    sys.modules[name] = None",
        f"for mod in {_port_modules()!r} + ['chip_smoke']:",
        "    importlib.import_module(mod)",
        "print('imported', len(sys.modules))",
    ])
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True,
        text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "imported" in proc.stdout


def test_csrc_holds_text_sources_only():
    csrc = os.path.join(PKG, "csrc")
    names = sorted(os.listdir(csrc))
    assert names, "no CUDA sources"
    for name in names:
        path = os.path.join(csrc, name)
        assert os.path.isfile(path) and name.endswith(TEXT_SOURCES), name
        data = open(path, "rb").read()
        data.decode("utf-8")   # text, not an object file
        assert b"\0" not in data, name


def test_port_files_are_small():
    big = [(os.path.relpath(p, ROOT), os.path.getsize(p))
           for p in _port_files() if os.path.getsize(p) > MAX_FILE_BYTES]
    assert not big, big


def test_entry_points_refuse_a_missing_card():
    """Without ``device="cpu"`` the entry points ask for the card, and
    raise when there is none: nothing falls back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from gail_carla_tpu_torch.config import ModelConfig
    from gail_carla_tpu_torch.convert import init_policy
    from gail_carla_tpu_torch.device import resolve_device
    from gail_carla_tpu_torch.scene.scene import make_benchmark_scene
    from gail_carla_tpu_torch.scene.town_import import make_town_scene

    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_benchmark_scene(n_routes=1, nx=2, ny=2, block=60.0,
                             min_length=50.0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_town_scene("Town01")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_policy(ModelConfig(conv_channels=(4,), hidden_size=8,
                                head_size=4), (3, 16, 16))
    assert resolve_device("cpu").type == "cpu"
