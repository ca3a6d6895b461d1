"""The port's renderer-facing surface against the JAX package, on the CPU:
the in-memory API (bcd_tpu_torch/core/api.py), batches of frames
(parallel/frames.py) and the renderfarm batch CLI (batch_cli.py).

The scene is the engine tests' 14x14 crop of the golden inputs at b = 3,
where the main path runs."""

import functools
import json
import os

import numpy as np
import pytest
import torch

from bcd_tpu import batch_cli as jbatch
from bcd_tpu.core import api as japi
from bcd_tpu.io import image_io
from bcd_tpu.params import DenoiserParameters as JParams
from bcd_tpu_torch import batch_cli as tbatch
from bcd_tpu_torch.convert import to_device
from bcd_tpu_torch.core import api as tapi
from bcd_tpu_torch.core import monoscale as tmono
from bcd_tpu_torch.params import DenoiserParameters as TParams
from bcd_tpu_torch.parallel.frames import denoise_frames
from tests.test_torch_stats import golden_crop
from tests.torch_workers import share_cores

share_cores()

CPU = torch.device("cpu")
# the port (twins, float32) against JAX's XLA engine: the engine tests' bound
RMS = 2e-4


def rms(a, b):
    return float(np.sqrt(np.mean((np.asarray(a, np.float64) - b) ** 2)))


def _run(den, params, inputs_cls, args, progress=True):
    seen = []
    den.set_inputs(inputs_cls(*args))
    den.set_parameters(params)
    den.set_progress_callback(seen.append if progress else None)
    assert den.denoise()
    return den.get_outputs().denoised_colors, seen


@functools.lru_cache(maxsize=None)
def jax_outputs():
    """JAX's Denoiser and MultiscaleDenoiser (2 scales), one tile a scale;
    the multiscale one without a progress callback, so that its finer
    scale runs the Denoiser's compiled engine (in-jit progress would
    compile it again, 3 s)."""
    p = JParams(search_window_radius=3)
    return (_run(japi.Denoiser(tile=14), p, japi.DenoiserInputs,
                 golden_crop())[0],
            _run(japi.MultiscaleDenoiser(2, tile=14), p, japi.DenoiserInputs,
                 golden_crop(), progress=False)[0])


@pytest.mark.parametrize("scales", [1, 2])
def test_denoisers_match_jax(scales):
    den = (tapi.Denoiser(tile=16, device=CPU) if scales == 1
           else tapi.MultiscaleDenoiser(2, tile=16, device=CPU))
    args = golden_crop()
    if scales == 2:  # the API takes tensors too
        args = [torch.from_numpy(a) for a in args]
    out, seen = _run(den, TParams(search_window_radius=3),
                     tapi.DenoiserInputs, args)
    assert isinstance(out, np.ndarray) and out.dtype == np.float32
    assert out.shape == (14, 14, 3)
    assert rms(out, jax_outputs()[scales - 1]) < RMS
    assert seen == sorted(seen) and seen[0] == 0.0 and seen[-1] == 1.0


def _inputs_with(**change):
    args = dict(zip(("colors", "nb_of_samples", "histograms",
                     "sample_covariances"), golden_crop()))
    args.update(change)
    return args


@pytest.mark.parametrize("change,error", [
    ({}, None),
    ({"colors": torch.from_numpy(golden_crop()[0])}, None),
    ({"histograms": None}, "missing"),
    ({"colors": torch.zeros((0, 14, 3))}, "empty"),
    ({"nb_of_samples": np.zeros((14, 0, 1), np.float32)}, "empty"),
    ({"sample_covariances": torch.zeros((14, 13, 6))}, "13x14"),
    ({"sample_covariances": np.zeros((14, 14, 5), np.float32)}, "6 channels"),
])
def test_validate_numpy_and_tensors(change, error):
    inputs = tapi.DenoiserInputs(**_inputs_with(**change))
    if error is None:
        inputs.validate()
        return
    with pytest.raises(ValueError, match=error):
        inputs.validate()
    den = tapi.Denoiser(device=CPU)
    den.set_inputs(inputs)
    assert den.denoise() is False  # refused, as JAX's: no output
    assert den.get_outputs().denoised_colors is None
    if not any(isinstance(v, torch.Tensor) for v in change.values()):
        with pytest.raises(ValueError, match=error):  # JAX refuses it too
            japi.DenoiserInputs(**_inputs_with(**change)).validate()


def test_api_needs_a_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    for make in (tapi.Denoiser, tapi.MultiscaleDenoiser):
        with pytest.raises(ValueError, match="no CUDA device"):
            make()


def test_denoise_frames_blocks_over_devices():
    """Two frames over two (host) devices, each the engine on its frame
    with no prefilter; frames that do not split evenly are refused."""
    a = golden_crop()
    b = [x[::-1].copy() for x in a]
    stacked = [np.stack([x, y]) for x, y in zip(a, b)]
    params = TParams(search_window_radius=3)
    out = denoise_frames(*stacked, params, [CPU, "cpu"], tile=16)
    cfg = tmono.auto_engine_config(params, tile=16)
    for i, frame in enumerate((a, b)):
        ref = tmono.denoise_image(cfg, *to_device(*frame, CPU), 1.0, 1e-8)
        assert torch.equal(out[i], ref)
    with pytest.raises(ValueError, match="split evenly"):
        denoise_frames(*(np.stack([x, x, x]) for x in a), params, [CPU, CPU])


# ---------------------------------------------------------------------------
# the batch CLI
# ---------------------------------------------------------------------------


def _write_frame(folder, name, args):
    stem = str(folder / name)
    color, nb, histo, cov = args
    image_io.write_exr(color, stem + ".exr")
    image_io.write_multi_channels_exr(
        image_io.merge_histogram_and_nb_of_samples(histo, nb),
        stem + "_hist.exr")
    image_io.write_multi_channels_exr(cov, stem + "_cov.exr")
    return stem + ".exr"


def _preset(folder, **keys):
    path = str(folder / "p.bcd.json")
    with open(path, "w") as f:
        json.dump({"nbOfScales": 1, "searchWindowRadius": 3, **keys}, f)
    return path


def jax_batch(folder):
    """JAX's batch CLI, sequential, on one good frame and one without its
    covariance file: its output and its exit code."""
    good = _write_frame(folder, "j0", golden_crop())
    bad = _write_frame(folder, "j1", golden_crop())
    os.remove(bad[:-4] + "_cov.exr")
    preset = _preset(folder, performSpikeRemovalPrefiltering=False)
    out = str(folder / "jout")
    rc = jbatch.main([good, bad, "-a", preset, "-o", out, "--tile", "14"])
    return rc, image_io.load_exr(os.path.join(out, "j0_BCDfiltered.exr"))


@pytest.fixture(scope="module")
def frames(tmp_path_factory):
    folder = tmp_path_factory.mktemp("torch_batch")
    jax_rc, jax_out = jax_batch(folder)
    good = [_write_frame(folder, f"f{i}", golden_crop()) for i in range(2)]
    odd = _write_frame(folder, "odd", [x[:12] for x in golden_crop()])
    bad = _write_frame(folder, "bad", golden_crop())
    os.remove(bad[:-4] + "_cov.exr")
    return folder, good, odd, bad, jax_rc, jax_out


def _out(folder, outdir, frame):
    stem = os.path.basename(frame)[:-4]
    return image_io.load_exr(os.path.join(folder, outdir,
                                          stem + "_BCDfiltered.exr"))


def test_batch_sequential_isolation_and_resume(frames, capsys):
    """A preset (no prefilter), two good frames and one without its
    covariance file: rc 1 as JAX's, each good output JAX's within the
    engine bound; --resume then skips both good frames."""
    folder, good, _, bad, jax_rc, jax_out = frames
    preset = _preset(folder, performSpikeRemovalPrefiltering=False)
    argv = [*good, bad, "-a", preset, "-o", str(folder / "seq"),
            "--tile", "16", "--device", "cpu"]
    assert tbatch.main(argv) == 1 == jax_rc
    assert "2/3 frames" in capsys.readouterr().out
    for frame in good:
        out = _out(folder, "seq", frame)
        assert rms(out, jax_out) < RMS
    assert tbatch.main(argv + ["--resume"]) == 1  # the bad frame again
    log = capsys.readouterr().out
    assert "resume: skipping 2 already-denoised frames" in log
    assert "0/1 frames" in log


def test_batch_mode_groups_and_skips_the_prefilter(frames, capsys):
    """--batch: the two 14x14 frames go as one group, the 12x14 frame as
    another; as JAX's --batch it skips the preset's prefilter (on here), so
    its outputs are the sequential run's without the prefilter, bit for
    bit."""
    folder, good, odd, _, _, _ = frames
    preset = _preset(folder)  # performSpikeRemovalPrefiltering: default on
    assert tbatch.main([*good, odd, "-a", preset, "-o", str(folder / "bat"),
                        "--tile", "16", "--batch", "--device", "cpu"]) == 0
    plain = _preset(folder, performSpikeRemovalPrefiltering=False)
    assert tbatch.main([*good, odd, "-a", plain, "-o", str(folder / "nopf"),
                        "--tile", "16", "--device", "cpu"]) == 0
    for frame in (*good, odd):
        np.testing.assert_array_equal(_out(folder, "bat", frame),
                                      _out(folder, "nopf", frame))
    assert "3/3 frames" in capsys.readouterr().out


def test_batch_default_device_needs_a_card(frames, capsys):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    folder, good, _, _, _, _ = frames
    assert tbatch.main([good[0], "-o", str(folder / "nocard")]) == 1
    assert "no CUDA device" in capsys.readouterr().out
    assert not os.path.exists(folder / "nocard")
