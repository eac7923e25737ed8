"""The port's fold and fused plans under barrett on Kyber's p = 3329
(where 'auto' picks barrett) against the reference plan in interpret
mode; the check is test_torch_red_plans.py's. n = 256 on the pinned
16 x 16 split (the flat split is not ported). The negacyclic product needs
a 2n-th root: p - 1 = 2^8 * 13 gives one up to n = 128, so it runs at
n = 128 (16 x 8)."""

import pytest

from test_torch_red_plans import CALLABLES, PLANS, check_callable, \
    check_negacyclic, one_thread  # noqa: F401 (an autouse fixture)


@pytest.mark.parametrize("plan", PLANS)
@pytest.mark.parametrize("fn", CALLABLES)
def test_barrett_matches_reference_plan(plan, fn):
    check_callable("kyber", 8, 4, "barrett", plan, fn)


def test_barrett_negacyclic_matches_reference():
    check_negacyclic("kyber", 7, 4, "barrett")
