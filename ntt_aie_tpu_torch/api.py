"""High-level API: NTTContext on one device.

Port of ``ntt_aie_tpu.api.NTTContext`` for a single device: the context
builds its plan lazily on first use and delegates to it; the host-oracle
paths run the NumPy oracles in the plan's output order.
"""

from __future__ import annotations

import numpy as np

from ntt_aie_tpu_torch import reference as ref
from ntt_aie_tpu_torch import twiddles as tw
from ntt_aie_tpu_torch.config import NTTConfig
from ntt_aie_tpu_torch.plan import ITEM_DISTRIBUTED
from ntt_aie_tpu_torch.utils.device import resolve_device


class NTTContext:
    """A plan on one device: forward / inverse / polymul.

    Usage:
        ctx = NTTContext(NTTConfig(field=P_469762049, log_n=20))
        A = ctx.forward(a)           # flat spectral-order NTT
        c = ctx.polymul(a, b)        # NTT -> pointwise -> INTT

    With NTTConfig(negacyclic=True), ctx.negacyclic_polymul(a, b) is the
    product mod X^n + 1 (on a four-step fold plan the column passes ncp1
    and nicp1 carry psi^i and psi^-i as 'pre' and 'post' operands).
    A flat configuration (split (n, 1), the default up to n = 2^16, 2^14
    for Goldilocks) has forward/inverse/polymul/negacyclic_polymul and no
    matrix-form callables, as the reference's. The reference-parity
    convention (table_convention='reference') has forward and
    forward_host only: the reference device's network is not a DFT.

    Plan keyword arguments (fused, wmat_factored, wmat_fold) forward to
    build_plan, for the 32-bit plans and Goldilocks alike (wmat_fold=False:
    the four-step multiply at the second pass's entry; wmat_factored=True:
    from the factored tables, with rank-1 psi in the 32-bit negacyclic
    product). device=None is the card, and raises RuntimeError without
    one; device="cpu" runs the plain PyTorch version.
    """

    _PLAN_KWARGS = {"fused", "wmat_factored", "wmat_fold"}

    def __init__(self, config: NTTConfig, *, device=None, mesh=None,
                 **plan_kwargs):
        if mesh is not None:
            raise NotImplementedError(
                "mesh= (the distributed four-step plan) is not ported yet: "
                f"ROADMAP.md {ITEM_DISTRIBUTED}")
        bad = sorted(set(plan_kwargs) - self._PLAN_KWARGS)
        if bad:
            raise TypeError(f"unknown plan kwargs {bad}; a single-device "
                            f"context accepts {sorted(self._PLAN_KWARGS)}")
        self.config = config
        self.device = resolve_device(device)
        self._plan_kwargs = plan_kwargs
        self._plan = None

    @property
    def plan(self):
        if self._plan is None:
            from ntt_aie_tpu_torch.plan import build_plan

            self._plan = build_plan(self.config, device=self.device,
                                    **self._plan_kwargs)
        return self._plan

    # ---- host oracle paths (NumPy, any machine) ----

    def forward_host(self, a) -> np.ndarray:
        """NumPy forward transform in the plan's output order: natural for
        ordering='natural', else the four-step spectral order; under the
        reference-parity convention the reference device's network with
        the natural-order power table, its blocks placed as the device
        places them with ordering='reference'."""
        cfg = self.config
        if cfg.table_convention == "reference":
            out = ref.reference_network(
                a, tw.power_table(cfg.field, cfg.n), cfg.field.p)
            if cfg.ordering == "reference":
                out = ref.block_permute(out)
            return out
        natural = ref.ntt_forward(np.asarray(a), cfg.field)
        if cfg.ordering == "natural":
            return natural
        out = np.empty_like(natural)
        out[tw.spectral_positions(*cfg.split)] = natural
        return out

    def inverse_host(self, a) -> np.ndarray:
        cfg = self.config
        if cfg.table_convention == "reference":
            raise NotImplementedError(
                "reference table convention has no inverse (not a DFT; "
                "SURVEY.md §0)")
        a = np.asarray(a)
        if cfg.ordering != "natural":
            a = a[tw.spectral_positions(*cfg.split)]  # -> natural order
        return ref.ntt_dit(a[tw.bit_reverse_indices(cfg.n)], cfg.field,
                           inverse=True)

    # ---- device paths ----

    def make_batched(self, batch: int) -> dict:
        """Batched callables over a leading batch axis: fwd/inv/polymul
        (flat (B, n)) and the matrix-form fwd_mat/inv_mat/polymul_mat."""
        return self.plan.make_batched(batch)

    def _mat(self, name):
        fn = getattr(self.plan, name)
        if fn is None:
            raise NotImplementedError(
                f"this plan has no {name} (a flat plan, split (n, 1), has "
                "no matrix-form twins, as the reference's has none; the "
                "fwd/inv twins need the default spectral ordering; the "
                "negacyclic twin needs NTTConfig(negacyclic=True))")
        return fn

    def forward_mat(self, a):
        """(n1, n2) natural layout -> (n2, n1) spectral."""
        return self._mat("fwd_mat")(a)

    def inverse_mat(self, s):
        return self._mat("inv_mat")(s)

    def polymul_mat(self, a, b):
        return self._mat("polymul_mat")(a, b)

    def negacyclic_polymul_mat(self, a, b):
        return self._mat("negacyclic_polymul_mat")(a, b)

    def forward(self, a):
        return self.plan.fwd(a)

    def inverse(self, a):
        return self.plan.inv(a)

    def polymul(self, a, b):
        return self.plan.polymul(a, b)

    def negacyclic_polymul(self, a, b):
        """a * b in Z_p[X]/(X^n + 1) (RLWE-style). Requires
        NTTConfig(negacyclic=True) so the psi tables were planned."""
        if not self.config.negacyclic:
            raise ValueError(
                "negacyclic_polymul needs NTTConfig(negacyclic=True)")
        return self.plan.negacyclic_polymul(a, b)
