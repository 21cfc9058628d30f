"""The rest of ``test_torch_train_settings.py``'s training settings, each
two float64 steps of the port's train step against the JAX package's
``make_train_step`` with JAX's draws (``check_setting_steps`` there, its
tolerances), in a file of their own so that another worker runs them."""

import torch_threads  # noqa: F401  (first: torch's share of the cores)

import pytest

from test_torch_train_settings import check_setting_steps


@pytest.mark.parametrize("setting", ["color_jitter", "grad_accum",
                                     "dense_loss", "basnet_hybrid"])
def test_setting_steps_match_jax(setting, monkeypatch):
    """``check_setting_steps`` of the setting."""
    check_setting_steps(setting, monkeypatch)
