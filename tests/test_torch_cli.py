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
from tests.torch_workers import share_cores

share_cores()

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


def test_cli_radius2_matches_engine(tmp_path):
    """``-w 2 --device cpu`` (the default -p 1 -s 3 pipeline at b = 5) on
    the r = 2 scene, against the port's pipeline on the same arrays."""
    from bcd_tpu_torch import params as tparams
    from bcd_tpu_torch.core.pipeline import denoise_pipeline
    from tests.test_torch_stack import R2_THRESHOLD, scene20

    color, nb, histo, cov = scene20()
    image_io.write_exr(color, str(tmp_path / "in.exr"))
    image_io.write_multi_channels_exr(
        image_io.merge_histogram_and_nb_of_samples(histo, nb),
        str(tmp_path / "in_hist.exr"))
    image_io.write_multi_channels_exr(cov, str(tmp_path / "in_cov.exr"))
    out_path = str(tmp_path / "out.exr")
    assert cli.main(["-i", str(tmp_path / "in.exr"), "-o", out_path, "-w",
                     "2", "-b", "5", "-d", str(R2_THRESHOLD),
                     "--device", "cpu"]) == 0
    p = tparams.PipelineParameters()
    mono = p.denoiser.monoscale
    mono.patch_radius, mono.search_window_radius = 2, 5
    mono.histogram_distance_threshold = R2_THRESHOLD
    ref = denoise_pipeline(color, nb, histo, cov, torch.device("cpu"), p)
    ref = ref.numpy().astype(np.float16).astype(np.float32)
    got = image_io.load_exr(out_path)
    assert got.shape == ref.shape == (20, 20, 3)
    assert np.sqrt(np.mean((got - ref) ** 2)) < 1e-5


@pytest.mark.parametrize("args", [
    (),                                   # no arguments: usage
    ("-i", "x.exr", "-o", "y.exr", "-r", "2"),  # bad 0/1 value
    ("-i", "/nonexistent/x.exr", "-o", "y.exr", "--device", "cpu"),
    # --skip-stride out of [1, 2r + 1], whatever the flags' order
    ("-i", "x.exr", "-o", "y.exr", "-w", "2", "--skip-stride", "6",
     "--device", "cpu"),
    ("-i", "x.exr", "-o", "y.exr", "--device", "xyz"),  # no such device
])
def test_cli_error_paths(args):
    # main() returns what `python -m bcd_tpu_torch.cli` exits with
    assert cli.main(list(args)) == 1


def test_cli_stats_report(tmp_path, capsys):
    """``--stats`` (once refused), -s 2 -b 3 on the golden crop: the same
    output bit for bit, then the report; main + fallback = managed = the
    interior pixels of both scales (14x14 and 7x7 at r = 1)."""
    from tests.test_torch_stats import golden_crop

    color, nb, histo, cov = golden_crop()
    image_io.write_exr(color, str(tmp_path / "in.exr"))
    image_io.write_multi_channels_exr(
        image_io.merge_histogram_and_nb_of_samples(histo, nb),
        str(tmp_path / "in_hist.exr"))
    image_io.write_multi_channels_exr(cov, str(tmp_path / "in_cov.exr"))
    argv = ["-i", str(tmp_path / "in.exr"), "-b", "3", "-s", "2",
            "--device", "cpu"]
    assert cli.main(argv + ["-o", str(tmp_path / "plain.exr")]) == 0
    capsys.readouterr()
    assert cli.main(argv + ["-o", str(tmp_path / "stats.exr"), "--stats"]) == 0
    out = capsys.readouterr().out
    np.testing.assert_array_equal(
        image_io.load_exr(str(tmp_path / "stats.exr")),
        image_io.load_exr(str(tmp_path / "plain.exr")))
    counters = dict(line.rsplit(": ", 1) for line in out.splitlines()
                    if line.startswith("pixels: "))
    main, fb, managed = (int(counters[f"pixels: {k}"]) for k in (
        "main-path solves", "fallback (mean patch)", "managed"))
    assert main + fb == managed == 12 * 12 + 5 * 5
    assert main > 0
    assert "Chronometers:" in out and "denoise 14x14" in out


@pytest.mark.parametrize("flags,msg", [
    (("--skip-stride", "4"), "--skip-stride must be in [1, 3]"),
    (("--skip-stride", "0"), "--skip-stride must be in [1, 3]"),
    (("--skip-stride", "6", "-w", "2"), "--skip-stride must be in [1, 5]"),
    (("-w", "0"), "patch radius 0 must be >= 1"),
])
def test_cli_refuses_out_of_range_options(flags, msg, capsys):
    """Refused while the arguments are parsed, before any file is read."""
    assert cli.main(["-i", "/nonexistent/x.exr", "-o", "y.exr", *flags,
                     "--device", "cpu"]) == 1
    assert msg in capsys.readouterr().out


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
