"""The CUDA column pass against its plain PyTorch version, on the card.

Needs an NVIDIA GPU and nvcc: every test here skips without CUDA. The file
imports no jax, so it runs where only the port is installed:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

import ntt_aie_tpu_torch as T
from ntt_aie_tpu_torch import reference as ref
from ntt_aie_tpu_torch.ops import colpass as C
from ntt_aie_tpu_torch.plan import fold_passes

pytestmark = pytest.mark.cuda
P = T.P_469762049.p


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU route)")
    return torch.device("cuda")


@pytest.mark.parametrize("B", [1, 3])
@pytest.mark.parametrize("n1,n2", [(16, 128), (128, 512), (256, 512),
                                   (1024, 1024)])
def test_kernel_matches_plain(cuda, n1, n2, B):
    g = torch.Generator(device=cuda).manual_seed(n1 + n2 + B)
    for name, cp in fold_passes(T.P_469762049, n1, n2, device=cuda).items():
        rows, cols = (n1, n2) if name in ("cp1", "icp1") else (n2, n1)
        x = torch.randint(0, 4 * P, (B, rows, cols), dtype=torch.int64,
                          device=cuda, generator=g).to(torch.int32)
        before = C.colpass.launches
        got = C.colpass(x, cp)
        torch.cuda.synchronize()
        assert C.colpass.launches == before + 1
        assert torch.equal(got, C.colpass_plain(x, cp)), name


def test_kernel_plan_matches_oracle(cuda):
    cfg = T.NTTConfig(field=T.P_469762049, log_n=16, rows_log2=8)
    plan = T.build_plan(cfg, device=cuda)
    rng = np.random.default_rng(5)
    a, b = rng.integers(0, P, (2, cfg.n))
    C.colpass.launches = 0
    f = plan.fwd(a)
    assert C.colpass.launches == 2
    assert f.device.type == "cuda"
    got = f.cpu().numpy().astype(np.int64)
    assert np.array_equal(got[plan.spectral_to_natural],
                          ref.ntt_forward(a, T.P_469762049))
    assert np.array_equal(plan.inv(f).cpu().numpy(), a)
    assert np.array_equal(plan.polymul(a, b).cpu().numpy(),
                          ref.cyclic_polymul(a, b, T.P_469762049))


def test_kernel_rejects_non_contiguous(cuda):
    cp = fold_passes(T.P_469762049, 16, 128, device=cuda)["cp2"]
    x = torch.zeros(2, 16, 128, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError):
        C.colpass(x.transpose(1, 2), cp)
