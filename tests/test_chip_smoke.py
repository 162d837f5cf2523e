"""chip_smoke.py's phases at a tiny size on the CPU.

The script runs these functions at the reference's full size on a GPU; here
the same code runs at ``SIZES["tiny"]`` so a broken phase shows up before a
chip run. The four-card body runs on 4 of the suite's 8 virtual CPU devices.
"""

import numpy as np
import pytest

import chip_smoke

TINY = chip_smoke.SIZES["tiny"]


@pytest.fixture(scope="module")
def phase2_result():
    return chip_smoke.phase2_main_path(TINY)


def test_phase1_statistics(capsys):
    chip_smoke.phase1_statistics(TINY, "cpu")
    out = capsys.readouterr().out
    assert out.startswith("[1 statistics] ok:")
    assert "us/object (chip_smoke reading, cpu)" in out
    assert "of which compile" in out


def test_phase2_main_path(phase2_result, capsys):
    fused, labels = phase2_result
    assert fused.features.shape == (TINY["p2_images"], 69)
    assert len(labels) == TINY["p2_images"]
    assert int(np.argmax(fused.channel_result.total)) == 0


def test_phase3_cytometry(capsys):
    chip_smoke.phase3_cytometry(TINY)
    assert "donor sets disjoint yes" in capsys.readouterr().out


def test_phase4_streaming(tmp_path, capsys):
    chip_smoke.phase4_streaming(TINY, tmp_path)
    out = capsys.readouterr().out
    assert "second call recomputed none yes" in out
    assert (tmp_path / "stream" / "manifest.json").exists()


def test_phase5_cnn(capsys):
    pytest.importorskip("flax")
    chip_smoke.phase5_cnn(TINY)
    assert "[5 cnn] ok:" in capsys.readouterr().out


def test_phase6_forest(phase2_result, capsys):
    pytest.importorskip("sklearn")
    chip_smoke.phase6_forest(TINY, *phase2_result)
    assert "differing predictions 0" in capsys.readouterr().out


def test_four_card_body_on_four_cpu_devices(tmp_path, capsys):
    import jax

    devices = jax.devices()[:4]
    assert len(devices) == 4
    chip_smoke.four_card(TINY, devices, tmp_path)
    out = capsys.readouterr().out
    assert out.startswith("[four-card] ok:")
    assert "fit_scaler_sharded vs MinMaxScaler max |diff| 0" in out


def test_feature_parity_splits_integer_and_float_columns():
    names = ["mean_intensity_Ch1", "skew_intensity_Ch1", "contrast_Ch1"]
    a = np.array([[1.0, 0.001, 5.0], [2.0, 1.0, 6.0]])
    b = a.copy()
    b[0, 1] += 1e-5  # a float32-summed column: relative to its column
    assert chip_smoke._feature_parity(a, b, names) == pytest.approx((1e-5, 0))
    b[1, 2] += 1e-9  # an integer-derived column: any change counts
    assert chip_smoke._feature_parity(a, b, names)[1] == 1
    nan = a.copy()
    nan[0, 1] = np.nan
    assert chip_smoke._feature_parity(nan, nan, names)[1] == 0


def test_ranking_breaks_ignores_ties():
    assert chip_smoke._ranking_breaks([0.7, 0.001, 0.003], [0.7, 0.004, 0.0]) == 0
    assert chip_smoke._ranking_breaks([0.7, 0.1, 0.0], [0.05, 0.1, 0.0]) == 1
