"""The port's CLI (python -m bcd_tpu_torch.cli) end to end on the CPU, its
error paths, and the port's independence from JAX."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from bcd_tpu.io import image_io
from bcd_tpu_torch import cli
from tests.test_torch_engine import prefilter_scene

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(*args, **env):
    return subprocess.run(
        [sys.executable, "-m", "bcd_tpu_torch.cli", *args], cwd=ROOT,
        capture_output=True, text=True, timeout=300,
        env={**os.environ, **env})


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    """The pipeline test's scene as the CLI's three EXR files."""
    d = tmp_path_factory.mktemp("torch_cli")
    (color, nb, histo, cov), _ = prefilter_scene()
    image_io.write_exr(color, str(d / "in.exr"))
    image_io.write_multi_channels_exr(
        image_io.merge_histogram_and_nb_of_samples(histo, nb),
        str(d / "in_hist.exr"))
    image_io.write_multi_channels_exr(cov, str(d / "in_cov.exr"))
    return d


def test_cli_cpu_matches_jax_pipeline(scene):
    out_path = str(scene / "out.exr")
    proc = _run("-i", str(scene / "in.exr"), "-o", out_path, "-b", "3",
                "--device", "cpu")
    assert proc.returncode == 0, proc.stdout + proc.stderr
    got = image_io.load_exr(out_path)
    # the JAX pipeline (-p 1 -s 3 -b 3) on the same inputs, which the EXR
    # files hold exactly; the output file is half precision
    _, ref = prefilter_scene()
    ref = ref.astype(np.float16).astype(np.float32)
    assert got.shape == ref.shape
    assert np.sqrt(np.mean((got - ref) ** 2)) < 2e-4


@pytest.mark.parametrize("args", [
    (),                                   # no arguments: usage
    ("-i", "x.exr", "-o", "y.exr", "-r", "2"),  # bad 0/1 value
    ("-i", "/nonexistent/x.exr", "-o", "y.exr", "--device", "cpu"),
    ("-i", "x.exr", "-o", "y.exr", "-w", "2", "--device", "cpu"),
    ("-i", "x.exr", "-o", "y.exr", "--stats", "--device", "cpu"),
])
def test_cli_error_paths(args):
    # main() returns what `python -m bcd_tpu_torch.cli` exits with
    assert cli.main(list(args)) == 1


def test_cli_default_device_needs_a_card(scene, capsys):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    rc = cli.main(["-i", str(scene / "in.exr"), "-o", str(scene / "x.exr")])
    assert rc == 1
    assert "no CUDA device" in capsys.readouterr().out
    assert not os.path.exists(scene / "x.exr")


def test_port_imports_no_jax():
    """Neither JAX nor the JAX package bcd_tpu: the card's machine has neither."""
    code = (
        "import pkgutil, importlib, sys, bcd_tpu_torch\n"
        "for m in pkgutil.walk_packages(bcd_tpu_torch.__path__, "
        "'bcd_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'bcd_tpu')]\n"
        "assert not bad, bad\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
