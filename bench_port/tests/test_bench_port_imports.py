"""What the benchmark loads: neither JAX nor the JAX package anywhere
(top-level module names compared whole: the program's name,
gail_carla_tpu_torch, begins with the JAX package's), nor the root's
bench.py or chip_smoke.py; and the plain reference, with the nets
modules (bench_port/nets/), nothing of the program."""
import ast
import os
import subprocess
import sys

from bench_port.harness.result import BANNED, banned_modules
from bench_port.harness.spec import BENCH_DIR, ROOT

STDLIB = set(sys.stdlib_module_names)


def imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def sources(sub=""):
    for d, _, files in os.walk(os.path.join(BENCH_DIR, sub)):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def test_nothing_imports_jax_or_the_jax_package():
    for path in sources():
        for mod in imports(path):
            top = mod.split(".")[0]
            assert top not in BANNED, (path, mod)
            assert top not in ("bench", "chip_smoke"), (path, mod)


def test_reference_imports_nothing_of_the_program():
    # scipy: the frozen scene compiler's mask geometry (ndimage)
    allowed = STDLIB | {"torch", "numpy", "scipy", "__future__"}
    for path in [*sources("plain_reference"), *sources("nets")]:
        for mod in imports(path):
            top = mod.split(".")[0]
            if top == "bench_port":
                assert mod.startswith(("bench_port.plain_reference",
                                       "bench_port.nets")), (path, mod)
            else:
                assert top in allowed, (path, mod)


def test_loading_the_reference_loads_no_program():
    code = ("import sys; sys.path.insert(0, %r)\n"
            "import bench_port.plain_reference.follow, "
            "bench_port.plain_reference.check, bench_port.nets.cnn4\n"
            "tops = {m.split('.')[0] for m in sys.modules}\n"
            "print(sorted(tops & {'gail_carla_tpu_torch', 'gail_carla_tpu',"
            " 'jax'}))" % ROOT)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True)
    assert out.stdout.strip() == "[]"


def test_guard_compares_whole_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "gail_carla_tpu_torch_x", sys)
    assert "gail_carla_tpu" not in banned_modules()
    monkeypatch.setitem(sys.modules, "jax.numpy", sys)
    assert "jax" in banned_modules()
