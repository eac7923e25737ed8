"""The port's inverse fused transform against the reference Pallas kernel
(interpret mode) at the plain-network splits; see test_torch_fused.py,
whose check this file runs."""

import pytest

from test_torch_fused import OPERANDS, PLAIN_SHAPES, \
    check_plain_against_reference


@pytest.mark.parametrize("B", [1, 2])
@pytest.mark.parametrize("operands", OPERANDS)
@pytest.mark.parametrize("n1,n2", PLAIN_SHAPES)
def test_plain_fused_inverse_matches_pallas(n1, n2, operands, B):
    check_plain_against_reference(n1, n2, True, operands, B)
