"""The ICAL slice (Hogbom) on a support-20 plan, a window wider than 16
(the wide variants of K1 and K3 on the card), against the JAX package's
fused ical at support 20 on tests/test_torch_pipeline.py's observation
and to its bounds.
"""

from test_torch_pipeline import _assert_slice_bounds, _ical_both, obs  # noqa: F401


def test_ical_fused_at_support_20_matches_jax(obs):  # noqa: F811
    _assert_slice_bounds(*_ical_both(obs, algorithm="hogbom", support=20))
