"""``chip_smoke.py`` on the CPU: it must refuse to run, and its pieces work.

The card-only phases run on the GPU (``python chip_smoke.py``); here the
script is imported, its device check must fail, and the main-path helper
tracks a small sequence through ``app.main`` without PyYAML or OpenCV.
"""

import sys

import jax
import numpy as np
import pytest

import chip_smoke


def test_phase0_exits_nonzero_without_gpu(capsys):
    with pytest.raises(SystemExit) as e:
        chip_smoke.phase0(1)
    assert e.value.code != 0
    assert "no GPU" in capsys.readouterr().err


def test_main_prints_no_result_without_gpu(capsys):
    with pytest.raises(SystemExit) as e:
        chip_smoke.main([])
    assert e.value.code != 0
    assert '"ok"' not in capsys.readouterr().out


@pytest.mark.parametrize("err, bound, passes", [
    (0.0, 0.0, True), (1e-5, 1e-4, True), (1e-4, 1e-4, True),
    (2e-4, 1e-4, False), (float("nan"), 1.0, False),
])
def test_check_gates_on_bound(err, bound, passes):
    if passes:
        chip_smoke.check("x", err, bound, "why")
    else:
        with pytest.raises(SystemExit):
            chip_smoke.check("x", err, bound, "why")


def test_x64_restores_flag():
    was = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", False)
    try:
        with pytest.raises(RuntimeError):
            with chip_smoke.x64():
                assert jax.config.jax_enable_x64
                raise RuntimeError
        assert not jax.config.jax_enable_x64
    finally:
        jax.config.update("jax_enable_x64", was)


def test_rel_fro():
    b = np.asarray([3.0, 4.0])
    assert chip_smoke.rel_fro(b, b) == 0.0
    assert chip_smoke.rel_fro(b + [0.0, 0.5], b) == pytest.approx(0.1)


def test_main_path_without_yaml_or_opencv(tmp_path, monkeypatch):
    """The phase-2 path at a small size: JSON config, .npy frames,
    precalculated bootstrap, app.main, track2trajectory, ATE."""
    from dsopp_tpu.testing import render_sequence

    monkeypatch.setitem(sys.modules, "yaml", None)
    monkeypatch.setitem(sys.modules, "cv2", None)
    seq = render_sequence(num_frames=28, height=120, width=160, focal=130.0,
                          advance=0.06)
    tracker = {"type": "monocular", "number_of_desired_points": 600,
               "keyframe_strategy": {"factor": 3.0},
               "marginalization_strategy": {"minimum_size": 3,
                                            "maximum_size": 5}}
    stats, summary = chip_smoke.track_sequence(str(tmp_path), seq, "cpu",
                                               tracker=tracker)
    assert stats["matched"] == 28
    assert stats["rmse"] < 2.2e-2 and stats["max"] < 3.5e-2, stats
    assert summary["frames"] == 20      # 28 frames less the 8 bootstrap ones
    assert summary["keyframes"] >= 3 and summary["fps"] > 0
