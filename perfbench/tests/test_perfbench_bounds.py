"""The frozen bound functions reproduce the bounds the port's kernel
timing has reported (compulsory bytes over 3.35 TB/s)."""

import sys
from pathlib import Path

import pytest

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from perfbench.harness import roofline as R  # noqa: E402


def test_upsample_int_nine_serving_calls_at_batch_8():
    calls = R.upsample_int_calls(8, 512)
    assert len(calls) == 9
    assert R.upsample_int_bound_ms(calls) == pytest.approx(0.0829, abs=5e-5)


def test_upsample_int_backward_nine_calls_at_batch_16():
    calls = R.upsample_int_calls(16, 512)
    assert R.upsample_int_bwd_bound_ms(calls) == pytest.approx(0.1657,
                                                              abs=5e-5)


def test_bn_stats_53_calls_at_batch_16():
    assert sum(n for _, _, n in R.BN_SHAPES_512) == 53
    assert R.channel_moments_bound_ms(16, 512) == pytest.approx(0.5547,
                                                               abs=5e-5)
    assert R.channel_dual_sums_bound_ms(16, 512) == pytest.approx(1.1094,
                                                                 abs=5e-5)
