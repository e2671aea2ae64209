"""The port runs on the CUDA card unless the caller asks for the CPU: its
constructors resolve ``device=None`` through ``config.default_device``,
which raises where there is no card instead of quietly building CPU
tensors."""

import numpy as np
import pytest
import torch

from ska_sdp_func_python_torch import config, interop
from ska_sdp_func_python_torch.models import (
    SkyComponents,
    create_named_configuration,
    create_visibility,
)
from ska_sdp_func_python_torch.models.image import create_image


@pytest.fixture
def no_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is the card")


def test_default_device_raises_without_a_card(no_card):
    with pytest.raises(RuntimeError, match="no CUDA device"):
        config.default_device()


def test_constructors_raise_without_a_card(no_card, monkeypatch):
    built = []
    as_tensor = torch.as_tensor
    monkeypatch.setattr(
        torch, "as_tensor", lambda *a, **k: built.append(1) or as_tensor(*a, **k)
    )
    cfg = create_named_configuration("LOW", rmax=300.0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        create_visibility(cfg, np.linspace(-0.1, 0.1, 3), [1e8])
    assert built == []
    with pytest.raises(RuntimeError, match="no CUDA device"):
        create_image(16, 0.001, (0.0, -0.6))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        SkyComponents.from_lists([[0.0, -0.6]], [[[1.0]]], [1e8])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        interop.to_image(create_image(16, 0.001, (0.0, -0.6), device="cpu"))


def test_explicit_cpu_is_the_cpu():
    cfg = create_named_configuration("LOW", rmax=300.0)
    vis = create_visibility(cfg, np.linspace(-0.1, 0.1, 3), [1e8], device="cpu")
    assert vis.vis.device.type == "cpu"
    im = create_image(16, 0.001, (0.0, -0.6), device=torch.device("cpu"))
    assert im.pixels.device.type == "cpu"
    assert config.resolve_device("cpu") == torch.device("cpu")
