"""Config loader tests (parity model: reference test_config_loader.cpp)."""

import numpy as np
import pytest

from dsopp_tpu.config import apply_overrides, build_application, load_config

YAML = """
sensors:
  - id: camera_1
    type: camera
    provider:
      type: image_folder
      folder: "images"
      timestamps: "times.txt"
    model:
      calibration: "calib.txt"
      shutter_time_seconds: 0

time:
  type: no_synchronization

tracker:
  type: monocular
  sensor_id: camera_1
  number_of_desired_points: 1000
  keyframe_strategy:
    strategy: mean_square_optical_flow
    factor: 1.5
  marginalization_strategy:
    strategy: sparse
    minimum_size: 4
    maximum_size: 6
    maximum_percentage_of_marginalized_points_in_frame: 0.9
  photometric_bundle_adjustment:
    solver: eigen
    max_iterations: 7
"""


@pytest.fixture
def dataset(tmp_path):
    import cv2

    (tmp_path / "mono.yaml").write_text(YAML)
    folder = tmp_path / "images"
    folder.mkdir()
    rng = np.random.default_rng(0)
    for i in range(3):
        cv2.imwrite(str(folder / f"{i}.png"),
                    rng.uniform(0, 255, (48, 64)).astype(np.uint8))
    (tmp_path / "times.txt").write_text(
        "".join(f"{i} {0.1*i:.2f}\n" for i in range(3)))
    (tmp_path / "calib.txt").write_text("pinhole\n64 48\n40 40 32 24\n")
    return tmp_path


def test_load_and_build(dataset):
    config = load_config(str(dataset / "mono.yaml"))
    app = build_application(config, str(dataset))
    assert app.tracker.config.desired_points == 1000
    assert app.tracker.config.keyframe_factor == 1.5
    assert app.tracker.config.window_max == 6
    assert app.tracker.config.num_frame_slots == 8  # window_max + 2 (device loop)
    frame = app.camera.next_frame()
    assert frame.frame_id == 0


def test_dot_path_overrides(dataset):
    config = load_config(str(dataset / "mono.yaml"))
    config = apply_overrides(config, [
        "--config.tracker.number_of_desired_points=555",
        "--config.tracker.keyframe_strategy.factor=2.5",
        "--config.sensors.0.provider.start_frame=1",
    ])
    assert config["tracker"]["number_of_desired_points"] == 555
    assert config["tracker"]["keyframe_strategy"]["factor"] == 2.5
    assert config["sensors"][0]["provider"]["start_frame"] == 1
    app = build_application(config, str(dataset))
    assert app.tracker.config.desired_points == 555
    assert app.camera.next_frame().frame_id == 1


def test_override_creates_missing_keys(dataset):
    config = load_config(str(dataset / "mono.yaml"))
    config = apply_overrides(config, ["--config.new_section.value=7"])
    assert config["new_section"]["value"] == 7


@pytest.fixture
def no_yaml(monkeypatch):
    """Make ``import yaml`` fail, as on a machine without PyYAML."""
    import sys

    monkeypatch.setitem(sys.modules, "yaml", None)


def test_load_json_config_without_yaml(tmp_path, no_yaml):
    import json

    tree = {"tracker": {"number_of_desired_points": 2000,
                        "keyframe_strategy": {"factor": 1.25}}}
    (tmp_path / "mono.json").write_text(json.dumps(tree))
    assert load_config(str(tmp_path / "mono.json")) == tree


def test_yaml_config_without_pyyaml_names_json(dataset, no_yaml):
    with pytest.raises(ImportError, match="json"):
        load_config(str(dataset / "mono.yaml"))


@pytest.mark.parametrize("raw, value", [
    ("555", 555), ("-3", -3), ("2.5", 2.5), ("1e-5", 1e-5), (".5", 0.5),
    ("true", True), ("False", False), ("yes", True), ("off", False),
    ("null", None), ("~", None), ("[1, 2]", [1, 2]), ('"a b"', "a b"),
    ("eigen", "eigen"), ("1 2", "1 2"),
])
def test_overrides_parse_scalars_without_yaml(raw, value, no_yaml):
    config = apply_overrides({"a": {"b": 0}}, [f"--config.a.b={raw}"])
    assert config["a"]["b"] == value
    assert type(config["a"]["b"]) is type(value)


def test_opencv_uses_names_image_paths():
    from dsopp_tpu.config.loader import opencv_uses

    base = {"sensors": [{"id": "cam", "type": "camera",
                         "provider": {"type": "npy_folder"}}],
            "initializer": {"type": "precalculated"}}
    assert opencv_uses(base) == []
    image = {**base, "sensors": [{"id": "cam", "type": "camera",
                                  "provider": {"type": "image_folder"},
                                  "camera_mask": "mask.png"}]}
    assert opencv_uses(image) == ["cam: provider type 'image_folder'",
                                  "cam: camera_mask"]
    assert opencv_uses({**base, "initializer": {}}) == [
        "feature-based bootstrap initializer"]


def test_opencv_config_fails_early_without_opencv(dataset, monkeypatch):
    import sys

    monkeypatch.setitem(sys.modules, "cv2", None)
    config = load_config(str(dataset / "mono.yaml"))
    with pytest.raises(ImportError, match="image_folder"):
        build_application(config, str(dataset))
