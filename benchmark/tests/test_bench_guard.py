"""The import guard compares top-level module names whole, and nothing the
benchmark's run imports loads JAX or the JAX package."""
import subprocess
import sys

from benchmark.harness import guard


def test_whole_names():
    assert guard.loaded(["spatialvla_tpu_torch", "spatialvla_tpu_torch.models.zoe",
                         "jaxtyping", "flaxen", "numpy"]) == []
    assert guard.loaded(["spatialvla_tpu.models", "jax._src.core", "jaxlib", "flax.linen"]) == [
        "flax", "jax", "jaxlib", "spatialvla_tpu"]


def test_benchmark_modules_load_no_jax():
    code = (
        "import sys, glob, os, importlib\n"
        "sys.path.insert(0, '.')\n"
        "import benchmark.run, benchmark.calibrate\n"
        "from benchmark.harness import cells, guard, roofline, trace, traffic, weights\n"
        "from benchmark.drivers import serve_engine\n"
        "from benchmark.reference import model, quant, serve_check\n"
        "for p in glob.glob('benchmark/metrics/*.py'):\n"
        "    cells.reader(os.path.basename(p)[:-3])\n"
        "import spatialvla_tpu_torch.serve, spatialvla_tpu_torch.inference\n"
        "print(guard.loaded())\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=300,
                         env={"PATH": "/usr/bin:/bin", "HOME": "/tmp"})
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"
