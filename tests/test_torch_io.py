"""The port's own EXR I/O and parameters (bcd_tpu_torch/io,
bcd_tpu_torch/params.py) against the JAX package's, and the port's and
chip_smoke.py's independence from the JAX package."""

import ast
import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest

from bcd_tpu import params as jparams
from bcd_tpu.io import exr as jexr
from bcd_tpu.io import image_io as jio
from bcd_tpu_torch import params as tparams
from bcd_tpu_torch.io import exr as texr
from bcd_tpu_torch.io import image_io as tio
from tests.torch_workers import share_cores

share_cores()

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _planes(rng, h=37, w=23):
    """Mixed HALF / FLOAT channels; 37 rows leave a partial ZIP chunk."""
    planes = {f"Bin_{z:04d}": rng.standard_normal((h, w)).astype(np.float32)
              for z in range(3)}
    planes["R"] = rng.random((h, w)).astype(np.float32)
    planes["Z"] = np.zeros((h, w), np.float32)  # compresses well
    return planes, {"R": jexr.HALF}


@pytest.mark.parametrize("compression", [
    jexr.NO_COMPRESSION, jexr.RLE_COMPRESSION, jexr.ZIPS_COMPRESSION,
    jexr.ZIP_COMPRESSION])
def test_reads_what_the_jax_codec_writes(tmp_path, compression):
    planes, types = _planes(np.random.default_rng(compression))
    path = str(tmp_path / "a.exr")
    jexr.write_exr(path, planes, pixel_types=types, compression=compression)
    got, info = texr.read_exr(path)
    ref, _ = jexr.read_exr(path)
    assert (info["height"], info["width"]) == (37, 23)
    assert sorted(got) == sorted(ref)
    for name in ref:
        assert got[name].dtype == np.float32
        np.testing.assert_array_equal(got[name], ref[name])


@pytest.mark.parametrize("kind", ["color", "gray", "multi"])
def test_writes_the_jax_codecs_bytes(tmp_path, kind):
    rng = np.random.default_rng(5)
    img = rng.random((19, 34, 1 if kind == "gray" else 3)).astype(np.float32)
    if kind == "multi":
        img = rng.standard_normal((19, 34, 61)).astype(np.float32)
    paths = [str(tmp_path / f"{side}.exr") for side in ("jax", "torch")]
    for io, path in zip((jio, tio), paths):
        (io.write_multi_channels_exr if kind == "multi" else io.write_exr)(
            img, path)
    with open(paths[0], "rb") as a, open(paths[1], "rb") as b:
        assert a.read() == b.read()
    load = "load_multi_channels_exr" if kind == "multi" else "load_exr"
    np.testing.assert_array_equal(getattr(tio, load)(paths[0]),
                                  getattr(jio, load)(paths[0]))


def test_histogram_split_and_merge():
    buf = np.arange(2 * 3 * 61, dtype=np.float32).reshape(2, 3, 61)
    histo, nb = tio.separate_nb_of_samples_from_histogram(buf)
    for got, ref in zip((histo, nb),
                        jio.separate_nb_of_samples_from_histogram(buf)):
        np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(
        tio.merge_histogram_and_nb_of_samples(histo, nb[..., 0]), buf)


def test_refuses_what_it_does_not_carry(tmp_path):
    path = str(tmp_path / "a.exr")
    jexr.write_exr(path, _planes(np.random.default_rng(0))[0])
    with open(path, "r+b") as f:  # set the version field's "tiled" bit
        f.seek(4)
        f.write((2 | 0x200).to_bytes(4, "little"))
    with pytest.raises(texr.ExrError, match="ROADMAP"):
        texr.read_exr(path)
    with open(str(tmp_path / "b.exr"), "wb") as f:
        f.write(b"not an exr")
    with pytest.raises(texr.ExrError, match="not an EXR"):
        texr.read_exr(str(tmp_path / "b.exr"))


def test_parameter_defaults_match_jax():
    assert (dataclasses.asdict(tparams.PipelineParameters())
            == dataclasses.asdict(jparams.PipelineParameters()))


def test_preset_loads_like_jax(tmp_path):
    p = jparams.PipelineParameters()
    p.input_file_names = jparams.InputFileNames(
        str(tmp_path / "c.exr"), str(tmp_path / "h.exr"),
        str(tmp_path / "v.exr"))
    p.prefiltering = jparams.PrefilteringParameters(False, 3.5)
    p.denoiser.nb_of_scales = 2
    p.denoiser.monoscale = jparams.DenoiserParameters(
        0.75, 1, 4, 1e-6, False, 0.5, 3, False)
    path = str(tmp_path / "preset.bcd.json")
    assert jparams.save_pipeline_json(p, path)
    assert (dataclasses.asdict(tparams.load_pipeline_json(path))
            == dataclasses.asdict(jparams.load_pipeline_json(path)))


def test_chip_smoke_imports_nothing_of_jax():
    with open(os.path.join(ROOT, "chip_smoke.py")) as f:
        tree = ast.parse(f.read())
    names = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import)
             for a in n.names]
    names += [n.module for n in ast.walk(tree)
              if isinstance(n, ast.ImportFrom) and n.module]
    assert names
    assert not [m for m in names
                if m.split(".")[0] in ("jax", "jaxlib", "bcd_tpu")]


def test_chip_smoke_fails_without_a_card():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
