"""Entry-point checks that need no tracking run."""

import jax
import pytest

from dsopp_tpu.app.main import main


@pytest.fixture
def restore_platforms():
    was = jax.config.jax_platforms
    yield
    jax.config.update("jax_platforms", was)


def test_platform_gpu_errors_without_gpu(tmp_path, restore_platforms, capsys):
    # this suite runs on the CPU: requiring the GPU must fail loudly, never
    # fall back to the CPU
    with pytest.raises(SystemExit) as e:
        main(["--config_file_path", str(tmp_path / "none.json"),
              "--platform", "gpu"])
    assert e.value.code != 0
    assert "--platform gpu" in capsys.readouterr().err


@pytest.mark.parametrize("platform", ["rocm", "metal"])
def test_platform_choices(tmp_path, platform):
    with pytest.raises(SystemExit) as e:
        main(["--config_file_path", str(tmp_path / "none.json"),
              "--platform", platform])
    assert e.value.code == 2
