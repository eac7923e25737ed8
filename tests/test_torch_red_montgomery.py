"""The port's fold and fused plans under montgomery on p = 2013265921
(15 * 2^27 + 1, where 'auto' picks montgomery): at (11, 4) against the
reference plan with its Pallas kernels in interpret mode, at (16, 8)
(nested columns of 256 rows) against the reference's XLA engine, both
with the reference's NumPy oracles beside; the negacyclic product at
(11, 4) against the reference's fused plan and at both against its NumPy
oracle. The checks are test_torch_red_plans.py's."""

import pytest

from test_torch_red_plans import CALLABLES, PLANS, check_callable, \
    check_negacyclic, one_thread  # noqa: F401 (an autouse fixture)


# (11, 4): plain columns of 16 and 128 rows, held against the reference
@pytest.mark.parametrize("plan", PLANS)
@pytest.mark.parametrize("fn", CALLABLES)
def test_montgomery_matches_reference_plan(plan, fn):
    check_callable("p2013265921", 11, 4, "montgomery", plan, fn)


# (16, 8): nested columns of 256 rows, held against the reference's XLA
# engine
@pytest.mark.parametrize("plan", PLANS)
@pytest.mark.parametrize("fn", CALLABLES)
def test_montgomery_nested_matches_oracles(plan, fn):
    check_callable("p2013265921", 16, 8, "montgomery", plan, fn, engine="xla")


@pytest.mark.parametrize("log_n,rows_log2", [(11, 4), (16, 8)])
def test_montgomery_negacyclic_matches_reference(log_n, rows_log2):
    check_negacyclic("p2013265921", log_n, rows_log2, "montgomery",
                     reference=(log_n, rows_log2) == (11, 4))
