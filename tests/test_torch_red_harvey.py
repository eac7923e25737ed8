"""The port's fold and fused plans under harvey on p = 998244353 (where
'auto' picks harvey): at (11, 4) against the reference plan with its
Pallas kernels in interpret mode, at (16, 8) (nested columns of 256 rows)
against the reference's XLA engine, both with the reference's NumPy
oracles beside; the negacyclic product against the reference's NumPy
oracle. The checks are test_torch_red_plans.py's. Outputs are canonical,
so harvey's DIT raw lazy bits, which differ from the reference's
lazy-subtree network, do not reach the comparison."""

import pytest

from test_torch_red_plans import CALLABLES, PLANS, check_callable, \
    check_negacyclic, one_thread  # noqa: F401 (an autouse fixture)


# (11, 4): plain columns of 16 and 128 rows, held against the reference
@pytest.mark.parametrize("plan", PLANS)
@pytest.mark.parametrize("fn", CALLABLES)
def test_harvey_matches_reference_plan(plan, fn):
    check_callable("p998244353", 11, 4, "harvey", plan, fn)


# (16, 8): nested columns of 256 rows, held against the reference's XLA
# engine
@pytest.mark.parametrize("plan", PLANS)
@pytest.mark.parametrize("fn", CALLABLES)
def test_harvey_nested_matches_oracles(plan, fn):
    check_callable("p998244353", 16, 8, "harvey", plan, fn, engine="xla")


@pytest.mark.parametrize("log_n,rows_log2", [(11, 4), (16, 8)])
def test_harvey_negacyclic_matches_oracle(log_n, rows_log2):
    check_negacyclic("p998244353", log_n, rows_log2, "harvey",
                     reference=False)
