"""The port's ingest side against the JAX package and the float64 oracle:
the sample accumulator (bcd_tpu_torch/ops/accumulator.py), the raw dump
format (io/raw.py), raw2bcd, and the carried numpy-only helpers
(chrono.py, image.py). The port runs on CPU tensors here."""

import os

import numpy as np
import pytest
import torch

from bcd_tpu import chrono as jchrono
from bcd_tpu import image as jimage
from bcd_tpu import raw2bcd_cli as jraw2bcd
from bcd_tpu.io import image_io as jio
from bcd_tpu.io import raw as jraw
from bcd_tpu.ops import accumulator as jacc
from bcd_tpu.params import HistogramParameters as JHist
from bcd_tpu_torch import chrono as tchrono
from bcd_tpu_torch import image as timage
from bcd_tpu_torch import raw2bcd_cli as traw2bcd
from bcd_tpu_torch.io import raw as traw
from bcd_tpu_torch.ops import accumulator as tacc
from bcd_tpu_torch.params import HistogramParameters as THist
from tests import reference_impl as oracle
from tests.torch_workers import share_cores

share_cores()

CPU = torch.device("cpu")
NAMES = ("nb", "mean", "cov", "histo")
# float32 sums of 8 samples against JAX's float32 and the float64 oracle:
# (rtol, atol) per statistic; nb (integer weight sums) is exact
TOL = {"mean": (1e-5, 1e-6), "cov": (1e-4, 1e-5), "histo": (1e-4, 1e-4)}


def _samples(rng, h=12, w=10, spp=8, channels=3):
    base = rng.random((h, w, 1, channels)) * 1.5
    return np.abs(base + 0.3 * rng.standard_normal((h, w, spp, channels))
                  ).astype(np.float32)


def _oracle(samples, params, weights=None):
    o = oracle.accumulate_samples(samples, params.nb_of_bins, params.gamma,
                                  params.max_value, weights=weights)
    return [o[k] for k in ("nb_of_samples", "mean", "cov", "histo")]


def _assert_stats(got, ref, exact_nb=True):
    for name, g, r in zip(NAMES, got, ref):
        g, r = np.asarray(g), np.asarray(r)
        assert g.shape == r.shape, name
        if name == "nb" and exact_nb:
            np.testing.assert_array_equal(g, r)
        else:
            rtol, atol = TOL.get(name, (1e-6, 0.0))
            np.testing.assert_allclose(g, r, rtol=rtol, atol=atol,
                                       err_msg=name)


def _case(name):
    """(samples, weights, histogram parameters as (bins, gamma, max))."""
    rng = np.random.default_rng(len(name))
    if name == "plain":
        return _samples(rng), None, (20, 2.2, 2.5)
    if name == "weights":
        return (_samples(rng),
                (rng.random((12, 10, 8)) + 0.5).astype(np.float32),
                (20, 2.2, 2.5))
    if name == "rgba":  # the alpha channel is ignored
        return _samples(rng, channels=4), None, (20, 2.2, 2.5)
    if name == "no_gamma_no_max":  # gamma <= 1 and max <= 0: neither applies
        return _samples(rng), None, (16, 1.0, 0.0)
    # samples on the saturation boundary: v = 1 (the last in-range bin
    # edge), v = 2 (the saturation level), beyond it, and just below 1
    s = _samples(rng)
    edge = np.float32(2.5 ** 2.2)  # (x^(1 / gamma)) / max = 1
    s[0, :, :4, 0] = edge
    s[1, :, :4, 1] = np.float32(5.0 ** 2.2)  # = 2
    s[2, :, :4, 2] = 1e3
    s[3, :, :4, 0] = np.nextafter(edge, np.float32(0))
    return s, None, (20, 2.2, 2.5)


CASES = ("plain", "weights", "rgba", "no_gamma_no_max", "saturation")


@pytest.mark.parametrize("name", CASES)
def test_accumulator_matches_jax_and_oracle(name):
    samples, weights, (bins, gamma, max_value) = _case(name)
    got = tacc.accumulate_samples(samples, THist(bins, gamma, max_value),
                                  weights=weights, device=CPU)
    ref = jacc.accumulate_samples(samples, JHist(bins, gamma, max_value),
                                  weights=weights)
    _assert_stats(got, ref)
    _assert_stats(got, _oracle(samples, JHist(bins, gamma, max_value),
                               weights), exact_nb=weights is None)
    if name == "saturation":  # 4 samples a pixel at or past saturation
        top = got[3].reshape(12, 10, 3, bins)[..., -1]
        assert bool((top[1, :, 1] > 3.99).all())
        assert bool((top[2, :, 2] == 4.0).all())


def test_streaming_chunks_in_any_order_with_repeats():
    """Chunks out of order, one row range added twice, and weights: the
    same sums as JAX's accumulator given the same chunk sequence."""
    rng = np.random.default_rng(3)
    samples = _samples(rng, h=9)
    weights = (rng.random((9, 10, 8)) + 0.5).astype(np.float32)
    chunks = [(6, 9), (0, 3), (3, 6), (2, 5)]
    port = tacc.SamplesAccumulator(9, 10, device=CPU)
    ref = jacc.SamplesAccumulator(9, 10, JHist())
    for a, b in chunks:
        port.add_samples(samples[a:b], row0=a, weights=weights[a:b])
        ref.add_samples(samples[a:b], row0=a, weights=weights[a:b])
    got = port.get_samples_statistics()  # copy semantics: still usable
    _assert_stats(got, ref.extract_samples_statistics())
    _assert_stats(port.extract_samples_statistics(), got)
    # in the float64 oracle: rows 2:5 saw their samples twice
    expected = _oracle(samples, JHist(), weights)
    doubled = _oracle(np.concatenate([samples[2:5]] * 2, axis=2), JHist(),
                      np.concatenate([weights[2:5]] * 2, axis=2))
    for e, d in zip(expected, doubled):
        e[2:5] = d
    _assert_stats(got, expected, exact_nb=False)


def test_inf_and_nan_where_jax_has_them():
    """One sample a pixel (bias 1/0) and pixels of zero weight (nb = 0)."""
    rng = np.random.default_rng(4)
    one = _samples(rng, h=4, w=5, spp=1)
    samples = _samples(rng, h=4, w=5, spp=3)
    weights = np.ones((4, 5, 3), np.float32)
    weights[1, 2] = 0.0
    for args in ((one, None), (samples, weights)):
        got = tacc.accumulate_samples(*args[:1], weights=args[1], device=CPU)
        ref = jacc.accumulate_samples(*args[:1], weights=args[1])
        for name, g, r in zip(NAMES, got, ref):
            g, r = g.numpy(), np.asarray(r)
            np.testing.assert_array_equal(np.isnan(g), np.isnan(r), name)
            np.testing.assert_array_equal(np.isinf(g), np.isinf(r), name)
            fin = np.isfinite(r)
            rtol, atol = TOL.get(name, (1e-6, 0.0))
            np.testing.assert_allclose(g[fin], r[fin], rtol=rtol, atol=atol)
    assert bool(got[1][1, 2].isnan().all())  # the zero-weight pixel


def test_accumulator_copy_move_and_refusals():
    acc = tacc.SamplesAccumulator(4, 5, device=CPU)
    chunk = np.ones((2, 5, 2, 3), np.float32)
    with pytest.raises(ValueError):
        acc.add_samples(chunk, row0=3)  # rows 3..4 of a 4-row image
    with pytest.raises(ValueError):
        acc.add_samples(np.ones((2, 6, 2, 3), np.float32))  # width 6
    acc.add_samples(chunk, row0=2)
    copy = [x.clone() for x in acc.get_samples_statistics()]
    got = acc.get_samples_statistics()
    acc.add_samples(chunk, row0=2)  # a copy does not follow the state
    # rows 2:4 hold samples (rows 0:2 are NaN: no weight)
    assert all(torch.equal(a[2:], b[2:]) for a, b in zip(got, copy))
    assert float(acc.extract_samples_statistics()[0][2, 0, 0]) == 4.0
    with pytest.raises(RuntimeError, match="move semantics"):
        acc.add_samples(chunk)
    with pytest.raises(RuntimeError, match="move semantics"):
        acc.get_samples_statistics()
    if not torch.cuda.is_available():  # the default device is the card
        with pytest.raises(ValueError, match="no CUDA device"):
            tacc.SamplesAccumulator(4, 5)
        with pytest.raises(ValueError, match="no CUDA device"):
            tacc.accumulate_samples(chunk)


# ---------------------------------------------------------------------------
# the raw dump and raw2bcd
# ---------------------------------------------------------------------------


def test_raw_dump_matches_jax(tmp_path):
    samples = _samples(np.random.default_rng(5), h=7, w=6, spp=3,
                       channels=4)
    a, b = str(tmp_path / "a.raw"), str(tmp_path / "b.raw")
    jraw.write_raw(a, samples)
    traw.write_raw(b, samples, version=1)
    with open(a, "rb") as fa, open(b, "rb") as fb:
        assert fa.read() == fb.read()
    assert traw.read_header(a).__dict__ == jraw.read_header(a).__dict__
    np.testing.assert_array_equal(traw.read_raw(a)[1], samples)
    blocks = list(traw.iter_raw_row_blocks(a, 3))
    assert [r for r, _ in blocks] == [0, 3, 6]
    for (r0, x), (j0, y) in zip(blocks, jraw.iter_raw_row_blocks(a, 3)):
        assert r0 == j0
        np.testing.assert_array_equal(x, y)


def test_raw2bcd_matches_jax(tmp_path, capsys):
    """The three EXRs of a 12x10 RGBA dump (8 spp), port on the CPU
    against JAX's raw2bcd: the histogram and covariance files (FLOAT)
    within the accumulator's tolerances, the sample counts exact, the
    color file (HALF) within half an ulp of HALF."""
    samples = _case("rgba")[0]
    dump = str(tmp_path / "s.raw")
    traw.write_raw(dump, samples)
    assert jraw2bcd.main([dump, str(tmp_path / "j")]) == 0
    jax_out = capsys.readouterr().out
    assert traw2bcd.main([dump, str(tmp_path / "t"), "--device", "cpu"]) == 0
    assert capsys.readouterr().out == jax_out  # the same prints
    hist_t, nb_t = jio.separate_nb_of_samples_from_histogram(
        jio.load_multi_channels_exr(str(tmp_path / "t_hist.exr")))
    hist_j, nb_j = jio.separate_nb_of_samples_from_histogram(
        jio.load_multi_channels_exr(str(tmp_path / "j_hist.exr")))
    cov_t, cov_j = (jio.load_multi_channels_exr(str(tmp_path / f"{p}_cov.exr"))
                    for p in "tj")
    col_t, col_j = (jio.load_exr(str(tmp_path / f"{p}.exr")) for p in "tj")
    _assert_stats([nb_t, col_t, cov_t, hist_t],
                  [nb_j, col_j.astype(np.float32), cov_j, hist_j])
    np.testing.assert_allclose(col_t, col_j, rtol=2 ** -10, atol=0)


@pytest.mark.parametrize("argv", [
    (), ("only-one",), ("a.raw", "p", "--device"),
    ("/nonexistent.raw", "p", "--device", "xyz")])
def test_raw2bcd_usage_errors(argv, capsys):
    assert traw2bcd.main(list(argv)) == 1


def test_raw2bcd_default_device_needs_a_card(tmp_path, capsys):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    dump = str(tmp_path / "s.raw")
    traw.write_raw(dump, _samples(np.random.default_rng(6), h=3, w=2))
    assert traw2bcd.main([dump, str(tmp_path / "t")]) == 1
    assert "no CUDA device" in capsys.readouterr().out
    assert not os.path.exists(tmp_path / "t.exr")


# ---------------------------------------------------------------------------
# carried helpers
# ---------------------------------------------------------------------------


def test_chrono_matches_jax():
    for s in (0.0123, 1.5, 75.25, 4000.0):
        assert tchrono.format_time(s) == jchrono.format_time(s)
    port, ref = tchrono.PhaseStats(), jchrono.PhaseStats()
    for st in (port, ref):
        st.timers["denoise 20x20"] += 0.25
        st.timers["scale/merge"] += 1.5
        st.count("pixels: managed", 7)
        st.count("pixels: managed", 3)
        with st.phase("pyramid build"):
            pass
    port.timers["pyramid build"] = ref.timers["pyramid build"] = 0.001
    assert port.report() == ref.report()
    assert port.merge(port).counters == {"pixels: managed": 20}
    chrono = tchrono.Chronometer()
    chrono.start()
    chrono.stop()
    assert chrono.elapsed >= 0 and str(chrono).endswith("ms")
    with tchrono.trace("a range"):
        pass


def test_image_helpers_match_jax():
    assert timage.glue_indices(7, 3, 2, 5, 1) == jimage.glue_indices(
        7, 3, 2, 5, 1)
    assert timage.split_index(7, 3, 50) == jimage.split_index(7, 3, 50)
    assert timage.clamp_position(4, 5, -1, 9) == jimage.clamp_position(
        4, 5, -1, 9)
    assert timage.window_bounds(10, 12, 1, 11, 3, 1) == jimage.window_bounds(
        10, 12, 1, 11, 3, 1)
    x = np.arange(24).reshape(2, 3, 4)
    np.testing.assert_array_equal(timage.planar_to_interleaved(x),
                                  jimage.planar_to_interleaved(x))
    np.testing.assert_array_equal(timage.interleaved_to_planar(x),
                                  jimage.interleaved_to_planar(x))
    assert (timage.COV_XX, timage.COV_XY) == (jimage.COV_XX, jimage.COV_XY)
